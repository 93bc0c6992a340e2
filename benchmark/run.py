"""One run of one benchmark cell of mmhand_torch on the card.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace 0|1

The cell is found by name in BENCHMARK.json; its configuration, traffic,
driver, limits and metric readers are files found by name under
``benchmark/``:

    configs/<config>.json      the model configuration as it is run
    traffic/<traffic>.json     the traffic's parameters and its driver
    drivers/<driver>.py        the loop of that kind of traffic
    workloads/<cell>.json      the limits of the cell's correctness check
    metrics/<metric>.py        one reader per metric, ``read(r)``

The run sets up the cell (its set-up time is ``setup_s``), measures for
``--seconds``, checks what the timed path produced against the plain
reference under ``benchmark/reference``, and prints one JSON line as the
last line of its standard output.  With ``--trace 1`` a profiler window of
a few steps inside the measured window gives the per-layer metrics and the
breakdown; with ``--trace 0`` the line holds the end-to-end metrics.
"""

from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Optional  # noqa: E402

BENCHMARK_DIR = Path(__file__).resolve().parent
ROOT = BENCHMARK_DIR.parent
CACHE_DIR = BENCHMARK_DIR / ".cache"
# top-level module names that must not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "mmhand_tpu")
# what a driver counted in set-up, printed beside the result
COUNTED = ("flops_per_step", "k1_s", "k2_s", "k2b_s")


def forbidden_modules() -> list[str]:
    """The loaded modules whose top-level name, compared whole, is one of
    FORBIDDEN."""
    return sorted({name for name in sys.modules
                   if name.split(".", 1)[0] in FORBIDDEN})


def pin_cache_dirs() -> None:
    """Every build and kernel cache in fixed directories of the checkout."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE_DIR / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE_DIR / "triton")
    os.environ["USE_FLAX"] = "0"


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    spec: dict                     # the whole BENCHMARK.json

    def metrics(self, kind: str) -> list[dict]:
        """The ``end_to_end`` or ``per_layer`` entries this cell reports."""
        return [m for m in self.spec[kind]
                if "workloads" not in m or self.name in m["workloads"]]


def _read_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_cell(name: str, root: Path = ROOT) -> Cell:
    spec = _read_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no cell {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = _read_json(root / configs[w["config"]]["file"])
    bench = root / spec["paths"][0]
    traffic = _read_json(bench / "traffic" / f"{w['traffic']}.json")
    limits = _read_json(bench / "workloads" / f"{name}.json")["limits"]
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, limits=limits, spec=spec)


def load_reader(metric: str, bench: Path = BENCHMARK_DIR):
    """``read`` of ``metrics/<metric>.py``."""
    path = bench / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + metric.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def load_driver(name: str):
    return importlib.import_module(f"benchmark.drivers.{name}")


@dataclass
class Reading:
    """What the readers read: the cell, the driver's run, the set-up and
    window seconds, the units of work done in the window, each step's
    device-clock milliseconds, the host spans and the profiler window."""

    cell: Cell
    run: object
    setup_s: float
    window_s: float = 0.0
    units: int = 0
    steps: int = 0
    step_ms: list = field(default_factory=list)
    spans: object = None
    profile: Optional[object] = None


def measure(run, seconds: float, spans, trace: bool, reading: Reading,
            device) -> None:
    """The measured window: ``run.step()`` until ``seconds`` have passed,
    a CUDA event after each step, one synchronization at the end.  With
    ``trace`` a profiler window of ``run.trace_steps`` steps opens after
    ``run.trace_after`` steps; its steps are left out of ``units`` and
    ``step_ms``."""
    import torch

    from benchmark.trace import profile_window

    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    def mark():
        if not cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def elapsed_ms(a, b) -> float:
        return a.elapsed_time(b) if cuda else (b - a) * 1e3

    sync()
    t0 = time.perf_counter()
    reading.setup_s = t0 - PROCESS_START
    spans.records.clear()
    prev, pairs, units = mark(), [], 0
    while time.perf_counter() - t0 < seconds:
        if trace and reading.profile is None and len(pairs) == run.trace_after:
            reading.profile = profile_window(run.step, run.trace_steps, spans,
                                             cuda)
            prev = mark()
            continue
        units += run.step()
        ev = mark()
        pairs.append((prev, ev))
        prev = ev
    sync()
    reading.window_s = time.perf_counter() - t0
    reading.step_ms = [elapsed_ms(a, b) for a, b in pairs]
    reading.units = units
    reading.steps = len(pairs)


def card_power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device="cuda") -> dict:
    """Set up, measure, check and read one run of ``cell``: the result's
    JSON object."""
    import torch

    from benchmark.trace import Spans

    device = torch.device(device)
    spans = Spans()
    driver = load_driver(cell.traffic["driver"])
    run = driver.Run(cell, seed, spans, device=device)
    reading = Reading(cell=cell, run=run, setup_s=0.0, spans=spans)
    measure(run, seconds, spans, trace, reading, device)
    peak = (max(torch.cuda.max_memory_allocated(d)
                for d in range(cell.chips)) if device.type == "cuda" else 0)
    run.release()
    try:
        checks = run.check()
    except Exception:  # a check that cannot finish has not passed
        traceback.print_exc()
        checks = {"check_finished": (float("inf"), 0.0)}
    correct = all(math.isfinite(v) and v <= lim
                  for v, lim in checks.values())
    metrics = {}
    for m in cell.metrics("per_layer" if trace else "end_to_end"):
        value = load_reader(m["name"])(reading)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": reading.units,
              "failed": 0 if correct else reading.units, "metrics": metrics}
    if device.type == "cuda":
        result["device"] = {
            "platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": cell.chips, "memory_peak_bytes": int(peak),
            "power_limit": card_power_limit()}
    else:
        result["device"] = {"platform": "cpu", "kind": "cpu", "count": 1,
                            "memory_peak_bytes": 0}
    if trace and reading.profile is not None:
        result["device"]["busy_s"] = reading.profile.busy_s
        result["device"]["window_s"] = reading.profile.window_s
        result["breakdown"] = {"device_ops": reading.profile.top_ops(),
                               "idle_gaps": reading.profile.top_gaps()}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    result["counted"] = {k: getattr(run, k) for k in COUNTED
                         if hasattr(run, k)}
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    pin_cache_dirs()
    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card only",
              file=sys.stderr)
        return 5
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} cards, torch sees "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 5
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"loaded in the run: {', '.join(found)}", file=sys.stderr)
        return 6
    print("counted: " + json.dumps(result.pop("counted")), file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
