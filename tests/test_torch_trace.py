"""mmhand_torch.utils.trace: spans off and on, their tree in the port's
steps and loader, their clock against the profiler's, the bounded buffer,
and the counter registry."""

from __future__ import annotations

import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from mmhand_torch import config as tcfg
from mmhand_torch.data import HostLoader, build_dataset
from mmhand_torch.hand3d import Hand3DSystem, make_hand3d_train_step
from mmhand_torch.hand3d.system import TRAIN_PARA_POSENET
from mmhand_torch.hpe import HPESystem, make_hpe_train_step
from mmhand_torch.parallel.dryrun import hpe_batch, rank_slice
from mmhand_torch.parallel.sharding import collective_launches
from mmhand_torch.scripts.train import kernel_launches
from mmhand_torch.train.state import build_generator, build_system
from mmhand_torch.train.step import make_eval_step, make_train_step
from mmhand_torch.utils import trace
from mmhand_torch.utils.png import write_png
from test_torch_threads import two_threads  # noqa: F401


@pytest.fixture
def recording():
    """The process's tracer on, its buffer empty, for one test."""
    trace.clear()
    trace.enable()
    try:
        yield trace.TRACER
    finally:
        trace.disable()
        trace.clear()


def _config(**data):
    return tcfg.Config(
        model=tcfg.ModelConfig(fine_size=32, ngf=8, ndf=8, g_n_blocks=1,
                               n_layers_d=1),
        loss=tcfg.LossConfig(l1_type="origin"),
        optim=tcfg.OptimConfig(pool_size=3),
        data=tcfg.DataConfig(dataset="synthetic", batch_size=2,
                             max_dataset_size=8, **data),
        precision=tcfg.PrecisionConfig(compute_dtype="float32"))


def _batch(seed=3):
    r = np.random.RandomState(seed)
    return {k: torch.from_numpy(r.uniform(-1, 1, (2, 32, 32, c))
                                .astype(np.float32))
            for k, c in [("H1", 3), ("P1", 21), ("D1", 3), ("H2", 3),
                         ("P2", 21), ("D2", 3)]}


def test_off_records_nothing():
    t = trace.Tracer()
    assert not torch.autograd.profiler._is_profiler_enabled
    first = t.span("a", torch.device("cpu"))
    assert first is trace.NOOP and t.span("b") is first
    with t.span("a"):
        with t.span("b"):
            pass
    assert t.spans() == []
    assert trace.span("x") is trace.NOOP


def test_nesting_parents_and_steps():
    t = trace.Tracer()
    t.enable()
    assert t.begin_step() == 1
    with t.span("a") as a:
        with t.span("b") as b:
            pass
        with t.span("c") as c:
            pass
    assert t.begin_step() == 2
    with t.span("d") as d:
        pass
    t.disable()
    with t.span("e"):
        pass
    assert [s.name for s in t.spans()] == ["b", "c", "a", "d"]
    assert a.parent is None and d.parent is None
    assert b.parent == c.parent == a.id
    assert (a.step, b.step, c.step, d.step) == (1, 1, 1, 2)
    assert a.start_ns <= b.start_ns <= b.end_ns <= c.start_ns <= c.end_ns \
        <= a.end_ns <= d.start_ns
    assert all(s.thread == threading.get_ident() for s in t.spans())
    assert a.device_ms is None and a.host_ms >= 0
    assert set(a.as_dict()) == {"name", "id", "parent", "thread", "step",
                                "start_ns", "end_ns", "device_ms"}


def test_spans_are_on_the_unix_clock():
    t = trace.Tracer()
    t.enable()
    before = time.time_ns()
    with t.span("a") as a:
        pass
    after = time.time_ns()
    # the anchor's two clock reads lie a few microseconds apart at most
    assert before - 1e6 <= a.start_ns <= a.end_ns <= after + 1e6


def test_train_step_records_its_span_tree(recording):
    torch.manual_seed(0)
    system = build_system(_config(), "cpu")
    step = make_train_step(system)
    step(_batch(), 2e-4)
    spans = recording.spans()
    by_id = {s.id: s for s in spans}
    (root,) = [s for s in spans if s.parent is None]
    assert root.name == "step"

    def children(span):
        return [s.name for s in sorted(spans, key=lambda s: s.start_ns)
                if s.parent == span.id]

    assert children(root) == ["g_phase", "replay", "d_phase", "replay",
                              "d_phase"]
    for s in spans:
        if s.name in ("g_phase", "d_phase"):
            assert children(s) == ["backward", "adam"]
        if s.parent is not None:
            parent = by_id[s.parent]
            assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
    assert len({s.step for s in spans}) == 1 and root.step is not None
    assert len(spans) == 12


def _tree(spans, parent=None):
    """The spans under ``parent`` in the order they began, each as (name,
    the tree under it)."""
    return [(s.name, _tree(spans, s.id))
            for s in sorted(spans, key=lambda s: s.start_ns)
            if s.parent == parent]


UPDATE = [("backward", []), ("adam", [])]


def _train_step_case(kind):
    """One train step of ``kind`` as a function of nothing, the optimizers
    it updates, the learning rate each must hold after it, and the step's
    span tree."""
    lr = 3e-4  # not any optimizer's initial rate
    if kind == "gan":
        torch.manual_seed(0)
        system = build_system(_config(), "cpu")
        step = make_train_step(system)
        tree = [("step", [("g_phase", UPDATE), ("replay", []),
                          ("d_phase", UPDATE), ("replay", []),
                          ("d_phase", UPDATE)])]
        return (lambda: step(_batch(), lr),
                (system.opt_g, system.opt_d_pp, system.opt_d_pb), lr, tree)
    if kind in ("hpm", "hpm3d"):
        cfg = tcfg.Config(model=tcfg.ModelConfig(fine_size=32),
                          precision=tcfg.PrecisionConfig(
                              compute_dtype="float32"))
        system = HPESystem(cfg, kind, "cpu")
        step = make_hpe_train_step(system)
        batch = rank_slice(hpe_batch(2), 0)
        opts = [o for o in (system.opt2d, system.opt3d) if o is not None]
        return (lambda: step(batch, lr), opts, lr,
                [("step", UPDATE * len(opts))])
    # posenet from the step where its schedule first lowers the rate
    system = Hand3DSystem("posenet", crop_size=32, device="cpu", seed=1)
    system.step = TRAIN_PARA_POSENET["lr_iter"][0]
    step = make_hand3d_train_step(system)
    r = np.random.RandomState(5)
    batch = {"image": torch.from_numpy(
                 r.uniform(-0.5, 0.5, (2, 32, 32, 3)).astype(np.float32)),
             "scoremap": torch.from_numpy(
                 r.uniform(0, 1, (2, 32, 32, 21)).astype(np.float32)),
             "keypoint_vis21": torch.from_numpy(r.uniform(size=(2, 21)) > 0.2)}
    return (lambda: step(batch), (system.opt,), TRAIN_PARA_POSENET["lr"][1],
            [("step", [("hand3d.forward", [])] + UPDATE)])


@pytest.mark.parametrize("kind", ["gan", "hpm", "hpm3d", "posenet"])
def test_each_train_step_updates_through_the_shared_spans(recording, kind):
    """The GAN, HPE and posenet steps each begin one step and update every
    net through ``train.state.backward_and_step`` (``backward``, then
    ``adam``; ``allreduce`` only over several ranks), and leave each
    optimizer at the step's learning rate."""
    step, opts, lr, tree = _train_step_case(kind)
    metrics = step()
    assert all(np.isfinite(float(v)) for v in (
        metrics.values() if isinstance(metrics, dict) else [metrics]))
    spans = recording.spans()
    assert _tree(spans) == tree
    assert len({s.step for s in spans}) == 1
    assert [g["lr"] for o in opts for g in o.param_groups] == [lr] * sum(
        len(o.param_groups) for o in opts)


def test_eval_step_and_png_encode(recording, tmp_path):
    cfg = _config()
    g = build_generator(cfg, "cpu")
    eval_step = make_eval_step(g)
    fakes = eval_step(_batch())
    img = ((fakes[0] + 1) * 127.5).clamp(0, 255).to(torch.uint8).numpy()
    write_png(str(tmp_path / "a.png"), img)
    write_png(str(tmp_path / "b.png"), img)
    names = [(s.name, s.step) for s in recording.spans()]
    step = names[0][1]
    assert names == [("gen.forward", step), ("png.encode", step),
                     ("png.encode", step)]


def test_loader_assembles_each_batch_on_a_worker_thread(recording):
    cfg = _config()
    loader = HostLoader(build_dataset(cfg), 2, num_threads=4,
                        max_items=8)
    batches = list(loader.epoch(0))
    spans = [s for s in recording.spans() if s.name == "loader.assemble"]
    assert len(batches) == 4 and len(spans) == 4
    assert all(s.thread != threading.get_ident() and s.parent is None
               for s in spans)


def test_spans_record_under_a_profiler_on_its_clock():
    """A span around a ``record_function`` encloses the profiler's event of
    it, after conversion, within 1 ms; the span opens a profiler range of
    its own name around itself, and records without ``enable()``."""
    trace.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with trace.span("outer") as outer:
                with record_function("inner"):
                    torch.ones(64).sum()
        assert trace.span("after") is trace.NOOP
        (got,) = trace.spans()
    finally:
        trace.clear()
    assert got is outer
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    inner, ranged = events["inner"], events["outer"]
    slack = 1_000_000
    assert outer.start_ns - slack <= inner.start_ns() <= inner.end_ns() \
        <= outer.end_ns + slack
    # the span's own range opens before its start and closes after its end
    assert ranged.start_ns() <= outer.start_ns + slack
    assert outer.end_ns - slack <= ranged.end_ns()


def test_buffer_bound_counts_dropped_spans():
    t = trace.Tracer(capacity=3)
    t.enable()
    for i in range(5):
        with t.span(f"s{i}"):
            pass
    assert [s.name for s in t.spans()] == ["s0", "s1", "s2"]
    assert t.counters() == {trace.DROPPED: 2}
    t.clear()
    with t.span("s5"):
        pass
    assert [s.name for s in t.spans()] == ["s5"]


def test_counters_and_timed():
    t = trace.Tracer()
    t.count("a")
    t.count("a", 2)
    t.count("b", 0.5)
    with t.timed("setup.x_s"):
        time.sleep(0.01)
    got = t.counters()
    assert got["a"] == 3 and got["b"] == 0.5
    assert 0.01 <= got["setup.x_s"] < 5
    got["a"] = 10  # a copy
    assert t.counters()["a"] == 3
    t.reset()
    assert t.counters() == {}


def test_counters_and_spans_from_many_threads():
    """16 threads, switching every microsecond: no count and no span lost,
    and each thread's spans parented on its own stack."""
    t = trace.Tracer()
    t.enable()
    n_threads, n = 16, 300
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work():
        t.begin_step()
        for _ in range(n):
            with t.span("outer"):
                with t.span("inner"):
                    t.count("c")

    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(saved)
    spans = t.spans()
    assert t.counters() == {"c": n_threads * n}
    assert len(spans) == 2 * n_threads * n
    by_id = {s.id: s for s in spans}
    for s in spans:
        if s.name == "inner":
            assert by_id[s.parent].name == "outer"
            assert by_id[s.parent].thread == s.thread
        else:
            assert s.parent is None
        assert s.step == 1


def test_setup_and_launch_counters_read_the_registry():
    before = trace.counters().get("setup.init_weights_s", 0)
    build_generator(_config(), "cpu")
    assert trace.counters()["setup.init_weights_s"] > before
    trace.count("k2.launches", 3)
    trace.count("collectives.any_rank", 2)
    trace.count("collectives.gather_ranks")
    try:
        assert kernel_launches()["bn_sums"] >= 3
        assert collective_launches() >= 3
        trace.reset()
        assert kernel_launches() == {"gaussian_heatmaps": 0, "bn_sums": 0,
                                     "bn_sums_backward": 0, "bn_apply": 0,
                                     "bn_apply_backward": 0,
                                     "reflect_pad": 0,
                                     "reflect_pad_backward": 0}
        assert collective_launches() == 0
    finally:
        trace.reset()
