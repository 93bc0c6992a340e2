"""The readers of the program's spans and counters
(``mmhand_torch.utils.trace``) on made-up records: the number each gives,
and None where it finds nothing or the program has no tracer."""

from __future__ import annotations

import sys
from types import SimpleNamespace

import pytest

from benchmark import run

# each span metric: its span, the clock it reads, and whether it averages
# per step (the step's spans summed) or per span
SPAN_METRICS = {
    "g_phase_ms.train": ("g_phase", "device", "step"),
    "backward_ms.train": ("backward", "device", "step"),
    "adam_ms.train": ("adam", "device", "step"),
    "step_host_ms.train": ("step", "host", "step"),
    "loader_decode_ms.train": ("loader.assemble", "host", "span"),
    "decode_ms.hpe": ("hpe.decode", "host", "span"),
    "backward_ms.hpe": ("backward", "device", "step"),
    "adam_ms.hpe": ("adam", "device", "step"),
    "step_host_ms.hpe": ("step", "host", "step"),
    "g_forward_ms.gen": ("gen.forward", "device", "step"),
    "png_encode_ms.gen": ("png.encode", "host", "step"),
}


def _span(name, step, host_ms, device_ms=None):
    return SimpleNamespace(name=name, step=step, host_ms=host_ms,
                           device_ms=device_ms)


def _made_up(name: str) -> list:
    """Two steps: step 1 holds ``name`` twice (2 and 4 ms on its clock),
    step 2 once (9 ms), beside spans of other names."""
    _, clock, _ = SPAN_METRICS[name]
    span = SPAN_METRICS[name][0]

    def ms(v):
        return (v, v + 100.0) if clock == "host" else (v + 100.0, v)

    return [_span(span, 1, *ms(2.0)), _span("other", 1, 50.0, 50.0),
            _span(span, 1, *ms(4.0)), _span(span, 2, *ms(9.0)),
            _span("other", 2, 70.0, 70.0)]


@pytest.fixture
def program(monkeypatch):
    """The program's tracer, its records replaced by the test's."""
    from mmhand_torch.utils import trace

    def use(spans=(), counters=None):
        monkeypatch.setattr(trace, "spans", lambda: list(spans))
        monkeypatch.setattr(trace, "counters", lambda: dict(counters or {}))

    return use


def _reading():
    return run.Reading(cell=None, run=None, setup_s=1.0)


@pytest.mark.parametrize("metric", sorted(SPAN_METRICS))
def test_span_reader_on_made_up_spans(metric, program):
    program(_made_up(metric))
    per = SPAN_METRICS[metric][2]
    # per step: (2 + 4) and 9 -> 7.5; per span: (2 + 4 + 9) / 3 -> 5
    want = 7.5 if per == "step" else 5.0
    assert run.load_reader(metric)(_reading()) == pytest.approx(want)


@pytest.mark.parametrize("metric", sorted(SPAN_METRICS) + ["init_weights_s"])
def test_reader_finds_nothing(metric, program, monkeypatch):
    program([_span("other", 1, 3.0, 3.0)], {"k1.launches": 4})
    assert run.load_reader(metric)(_reading()) is None
    # a program without the tracer, as before it had one
    import mmhand_torch.utils

    monkeypatch.setitem(sys.modules, "mmhand_torch.utils.trace", None)
    monkeypatch.delattr(mmhand_torch.utils, "trace")
    assert run.load_reader(metric)(_reading()) is None


def test_init_weights_reader(program):
    program([], {"setup.init_weights_s": 4.25, "k1.launches": 4})
    assert run.load_reader("init_weights_s")(_reading()) == 4.25


def test_every_new_metric_is_declared_for_its_cells():
    declared = {m["name"]: m for m in run.load_cell(
        "mmhand_flagship.train").spec["per_layer"]}
    for name in list(SPAN_METRICS) + ["init_weights_s"]:
        m = declared[name]
        suffix = name.rsplit(".", 1)[-1]
        cells = {"train": ["mmhand_flagship.train"],
                 "hpe": ["hpe_hpm.train"],
                 "gen": ["mmhand_flagship.generate"]}.get(suffix)
        assert m["workloads"] == (cells or ["mmhand_flagship.train",
                                            "hpe_hpm.train",
                                            "mmhand_flagship.generate"])
