"""The hand3d path's spans and counters in ``mmhand_torch.utils.trace``:
one posenet step of the ``train_hand3d`` loop (8 records read from a
packed GAN DB, ``derive_batch``, ``make_hand3d_train_step``) records its
spans under one step number, counts its records, and records nothing with
the tracer off; building a ``Hand3DSystem`` counts its weight draw."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from mmhand_torch.data.hand3d_binary import Hand3dBinaryDataset, write_gan_db
from mmhand_torch.hand3d import (
    Hand3DSystem,
    derive_batch,
    make_hand3d_train_step,
)
from mmhand_torch.scripts.train_hand3d import (
    pipeline_config_for,
    records_to_pipeline_batch,
)
from mmhand_torch.utils import trace
from test_torch_threads import two_threads  # noqa: F401

SIZE = 32
BATCH = 8
STEP_SPANS = ("step", "hand3d.forward", "backward", "adam")


@pytest.fixture(scope="module")
def loop(tmp_path_factory):
    """One step of the loop, as a function of nothing."""
    path = tmp_path_factory.mktemp("hand3d_trace") / "db.bin"
    rng = np.random.RandomState(3)
    write_gan_db(str(path), (
        {"image": rng.randint(0, 256, (SIZE, SIZE, 3)).astype(np.uint8),
         "uv": rng.uniform(4, SIZE - 4, (21, 2)),
         "xyz": rng.uniform(-0.1, 0.6, (21, 3)),
         "K": np.eye(3) * SIZE} for _ in range(12)))
    ds = Hand3dBinaryDataset(str(path), SIZE, SIZE)
    system = Hand3DSystem("posenet", crop_size=SIZE, device="cpu", seed=1)
    step = make_hand3d_train_step(system)
    cfg = pipeline_config_for("posenet", (SIZE, SIZE), SIZE)
    noise = torch.Generator().manual_seed(2)
    idx_rng = np.random.RandomState(4)

    def one() -> float:
        idx = idx_rng.randint(0, len(ds), BATCH)
        raw = records_to_pipeline_batch([ds[int(i)] for i in idx])
        return float(step(derive_batch(raw, cfg, noise, "cpu")))

    return one


@pytest.fixture
def recording():
    trace.clear()
    trace.enable()
    try:
        yield
    finally:
        trace.disable()
        trace.clear()


def test_one_step_records_its_spans_under_one_step(loop, recording):
    loop()
    spans = trace.spans()
    names = [s.name for s in spans]
    for name in STEP_SPANS + ("hand3d.derive",):
        assert names.count(name) == 1, (name, names)
    assert names.count("hand3d.read") == BATCH
    assert "allreduce" not in names        # one rank
    by_name = {s.name: s for s in spans}
    steps = {by_name[n].step for n in STEP_SPANS}
    assert len(steps) == 1 and None not in steps
    # the forward, backward and Adam lie inside the step's host span
    outer = by_name["step"]
    for name in STEP_SPANS[1:]:
        inner = by_name[name]
        assert inner.parent == outer.id
        assert outer.start_ns <= inner.start_ns <= inner.end_ns \
            <= outer.end_ns
    # the reads and the derivation come before the step begins
    for s in spans:
        if s.name in ("hand3d.read", "hand3d.derive"):
            assert s.end_ns <= outer.start_ns
            assert s.parent is None


def test_each_step_takes_the_next_number(loop, recording):
    loop()
    loop()
    steps = [s.step for s in trace.spans() if s.name == "step"]
    assert len(steps) == 2 and steps[1] == steps[0] + 1
    for name in STEP_SPANS[1:]:
        assert [s.step for s in trace.spans() if s.name == name] == steps


def test_cpu_spans_have_no_device_time(loop, recording):
    loop()
    for s in trace.spans():
        assert s.device_ms is None
        assert s.host_ms >= 0.0


def test_records_counter_counts_each_read(loop):
    before = trace.counters().get("hand3d.records", 0)
    loop()
    assert trace.counters()["hand3d.records"] - before == BATCH


def test_building_a_system_counts_its_weight_draw():
    before = trace.counters().get("setup.init_weights_s", 0.0)
    Hand3DSystem("posenet", crop_size=SIZE, device="cpu", seed=0)
    after = trace.counters()["setup.init_weights_s"]
    assert after > before


def test_off_the_spans_are_the_noop_and_record_nothing(loop):
    trace.clear()
    assert not torch.autograd.profiler._is_profiler_enabled
    assert trace.span("hand3d.derive", torch.device("cpu")) is trace.NOOP
    assert trace.span("hand3d.read") is trace.NOOP
    loop()
    assert trace.spans() == []
