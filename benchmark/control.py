"""The readings that the limits of ``correct`` are set from, on the card:
for each seed, one process builds the cell and runs its checked steps
(and, for a generation cell, ``--steps`` batches), then prints the check's
numbers for the program, for the plain reference in float8 put in the
program's place (the control) and, for a training cell, for its faults
(half of the batch left out; a step that leaves the state unchanged).

    python3 -m benchmark.control --workload <cell> --seeds 1 2 3 [--steps N]

Each seed's readings are one JSON line on standard output, and all of them
``chiprun_out/control_<cell>.json``.  The benchmark's own runs do not run
this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from benchmark.run import ROOT, load_cell, load_driver, pin_cache_dirs


def readings(cell, seed: int, steps: int, device="cuda") -> dict:
    from benchmark.trace import Spans

    run = load_driver(cell.traffic["driver"]).Run(cell, seed, Spans(),
                                                  device=device)
    for _ in range(steps):
        run.step()
    run.release()
    return run.control_readings()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--steps", type=int, default=0)
    parser.add_argument("--f32-witness", action="store_true",
                        help="run the program in float32 with TF32 off, a "
                             "witness beside the reference")
    args = parser.parse_args(argv)
    pin_cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 5
    cell = load_cell(args.workload)
    if args.f32_witness:
        cell.config["precision"]["compute_dtype"] = "float32"
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    rows = []
    for seed in args.seeds:
        row = {"seed": seed, **readings(cell, seed, args.steps)}
        rows.append(row)
        print(json.dumps(row), flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    tag = "_f32" if args.f32_witness else ""
    Path(out / f"control_{cell.name}{tag}.json").write_text(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
