"""The cell ``hand3d_posenet.train``: it resolves, its tiny cut runs set-up,
steps and the check on the CPU with ``correct`` true, each of its readers
gives a number on a traced tiny run (None where the CPU has no device
trace), and its reference loads nothing of the program or of JAX."""

from __future__ import annotations

import subprocess
import sys
from types import SimpleNamespace

import pytest
from tiny_cells import tiny_cell

from benchmark import run
from benchmark.reference import compare

CELL = "hand3d_posenet.train"
SEED = 2_147_483_659
NEW = ("read_ms.hand3d", "derive_ms.hand3d", "forward_ms.hand3d",
       "backward_ms.hand3d", "adam_ms.hand3d", "step_host_ms.hand3d",
       "device_idle_pct.hand3d", "mfu_pct.hand3d")
# the readers of device time, which a CPU run has none of
DEVICE = ("forward_ms.hand3d", "backward_ms.hand3d", "adam_ms.hand3d",
          "device_idle_pct.hand3d")


def test_cell_resolves():
    c = run.load_cell(CELL)
    assert c.chips == 1
    assert c.traffic["driver"] == "hand3d_train"
    assert c.config["batch_size"] == 8
    assert c.config["model"]["fine_size"] == 256
    assert c.config["precision"]["compute_dtype"] == "float32"
    assert c.config["reduced"] == []
    numbers = compare.train_gaps(
        {"losses": [{"loss": 1.0}], "grad_norms": {"posenet.a": 1.0},
         "change_norms": {"posenet.a": 1.0}},
        {"losses": [{"loss": 1.0}], "grad_norms": {"posenet.a": 1.0},
         "change_norms": {"posenet.a": 1.0}})
    assert set(c.limits) <= set(numbers)
    e2e = {m["name"] for m in c.metrics("end_to_end")}
    assert e2e == {"hpe_images_per_s", "setup_s"}
    assert {m["name"] for m in c.metrics("per_layer")} == set(NEW) | {
        "init_weights_s"}


@pytest.fixture(scope="module")
def traced():
    """A traced tiny run on the CPU, the program's tracer on."""
    from mmhand_torch.utils import trace

    trace.clear()
    trace.enable()
    try:
        result = run.run_cell(tiny_cell(CELL), SEED, 2.0, True,
                              device="cpu")
        yield result
    finally:
        trace.disable()
        trace.clear()


def test_tiny_run_is_correct(traced):
    assert traced["correct"], traced["checks"]
    assert traced["attempted"] > 0
    for name, c in traced["checks"].items():
        assert c["value"] <= c["limit"], name


def test_tiny_run_reports_the_readers(traced):
    got = traced["metrics"]
    for name in NEW:
        if name in DEVICE:
            assert name not in got, name
        else:
            assert got[name]["value"] > 0.0, name
    assert got["init_weights_s"]["value"] > 0.0


def _span(name, step, host_ms, device_ms=None):
    return SimpleNamespace(name=name, step=step, host_ms=host_ms,
                           device_ms=device_ms)


@pytest.mark.parametrize("metric,span,clock", [
    ("read_ms.hand3d", "hand3d.read", "host"),
    ("derive_ms.hand3d", "hand3d.derive", "host"),
    ("step_host_ms.hand3d", "step", "host"),
    ("forward_ms.hand3d", "hand3d.forward", "device"),
    ("backward_ms.hand3d", "backward", "device"),
    ("adam_ms.hand3d", "adam", "device")])
def test_span_reader_sums_per_step(metric, span, clock, monkeypatch):
    from mmhand_torch.utils import trace

    def s(step, v):
        return (_span(span, step, v, v + 100.0) if clock == "host"
                else _span(span, step, v + 100.0, v))

    spans = [s(1, 2.0), _span("other", 1, 50.0, 50.0), s(1, 4.0), s(2, 9.0)]
    monkeypatch.setattr(trace, "spans", lambda: spans)
    reading = run.Reading(cell=None, run=None, setup_s=1.0)
    assert run.load_reader(metric)(reading) == pytest.approx(7.5)
    monkeypatch.setattr(trace, "spans", lambda: spans[1:2])
    assert run.load_reader(metric)(reading) is None


def test_mfu_reader_uses_the_tf32_peak():
    reading = run.Reading(cell=None, run=SimpleNamespace(
        flops_per_step=494.7e9), setup_s=1.0, steps=4,
        step_ms=[1.0, 1.0, 1.0, 1.0])
    # 494.7 GFLOP a ms is the peak itself
    assert run.load_reader("mfu_pct.hand3d")(reading) == pytest.approx(100.0)


def test_reference_loads_nothing_of_the_program_or_jax():
    code = ("import sys; import benchmark.reference.hand3d; "
            "print(' '.join(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout.split()
    tops = {name.split(".", 1)[0] for name in out}
    assert "torch" in tops
    assert not tops & {"mmhand_torch", "jax", "jaxlib", "flax",
                       "mmhand_tpu"}
    text = (run.BENCHMARK_DIR / "reference" / "hand3d.py").read_text()
    assert "mmhand_torch" not in text and "jax" not in text
