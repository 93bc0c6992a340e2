"""Kill-and-resume demo of the GAN trainer (counterpart of
tools/longrun_demo.py).

    python -m mmhand_torch.scripts.longrun_demo [--device cuda] \\
        [--items 64 --kill_after_prints 45 --steps2 1000 --print_freq 20 \\
         --save_every 800]

1. Writes a ``--items`` RHD-layout crop tree of ``--fineSize`` px images a
   GAN can learn (``data.rhd_tree.write_block_tree``: blocks and a textured
   centre, the tree of mmhand_tpu's bench.py).
2. Leg 1: ``python -m mmhand_torch.scripts.train`` over it (batch 16 and
   256 px unless asked otherwise, the live plot on, ``state_latest.pt``
   every ``--save_every`` steps), killed with SIGKILL once the loss log
   holds ``--kill_after_prints`` lines: a crash mid-run, not a clean exit.
   Choose the two so that the kill comes past a save point; leg 2 then
   resumes from a checkpoint older than leg 1's last logged losses.
3. Leg 2: the same command with ``--continue_train --max_steps --steps2``.
4. The checks of the JAX tool, at its thresholds: continuity across the
   kill (the first resumed pair_L1loss below 1.6 x the last one before the
   kill + 0.5: a re-initialized G starts near twice the trained loss),
   descent (the mean of the last tenth of the logged pair_L1loss below 0.7
   x the first tenth's), and the live plot's data holding both legs (at
   least half as many points as logged lines).  Then SSIM of the trained
   generator's fakes against their targets over the training pairs, with
   ``ops.ssim`` and the Generator of ``state_latest.pt``.

Prints one JSON line: the checks, the losses they read, each leg's seconds,
leg 1's return code (-9 for SIGKILL), the step leg 2 resumed at and the
step it ended at, the first logged step whose pair_L1loss lies below the
descent check's 0.7 x the first tenth's mean, and the SSIM.  Exits 2 when a check fails.  Each leg's
output goes to ``<dir>/leg1.out`` and ``leg2.out``.  ``--fineSize``,
``--batchSize``, ``--ngf``, ``--ndf`` and ``--n_blocks`` pass through to
the trainer, so that a test can run the demo small on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

from mmhand_torch.scripts.train import LAUNCHES_LINE

REPO = Path(__file__).resolve().parents[2]
_LINE = re.compile(r"\(epoch: (\d+), iters: (\d+), time: [\d.]+\)(.*)")


def parse_loss_log(path) -> list[tuple[int, int, dict]]:
    """The loss lines of a loss_log.txt, '(epoch: E, iters: I, time: T) key:
    v key: v ...', as (epoch, iters, {key: value})."""
    rows = []
    with open(path) as fh:
        for line in fh:
            m = _LINE.match(line.strip())
            if not m:
                continue
            kv = dict(re.findall(r"(\w+): ([-\d.naninf]+)", m.group(3)))
            rows.append((int(m.group(1)), int(m.group(2)),
                         {k: float(v) for k, v in kv.items()}))
    return rows


def loss_checks(rows: list, n_before_kill: int) -> dict:
    """tools/longrun_demo.py's continuity and descent checks on the whole
    log ``rows``, whose first ``n_before_kill`` lines are leg 1's."""
    l1 = [r[2]["pair_L1loss"] for r in rows]
    k = max(1, len(l1) // 10)
    start, floor = sum(l1[:k]) / k, sum(l1[-k:]) / k
    before, after = l1[n_before_kill - 1], l1[n_before_kill]
    return {"pair_L1_start": start, "pair_L1_floor": floor,
            "pair_L1_before_kill": before, "pair_L1_after_resume": after,
            "continuity_ok": after < before * 1.6 + 0.5,
            "descent_ok": floor < 0.7 * start}


def descent_step(rows: list, n_before_kill: int, resumed: int,
                 start: float):
    """The first logged step whose pair_L1loss lies below 0.7 x ``start``
    (the descent check's bar), None if none does.  The log's iters restart
    in leg 2, which began at step ``resumed``."""
    for i, (_, it, losses) in enumerate(rows):
        if losses["pair_L1loss"] < 0.7 * start:
            return it if i < n_before_kill else resumed + it
    return None


def plot_check(plot_path, n_rows: int) -> bool:
    """The live plot's data holds at least half as many points as the log
    has lines (tools/longrun_demo.py)."""
    with open(plot_path) as fh:
        return len(json.load(fh)["Y"]) >= n_rows // 2


def saved_step(path) -> int:
    import torch

    return int(torch.load(path, map_location="cpu", weights_only=True,
                          mmap=True)["step"])


def ssim_on_train_pairs(args, data: str, state_path: str) -> float:
    """SSIM of the saved generator's fakes against their targets over the
    training pairs, images scaled to [0, 1] (the reference's convention),
    the mean over batches."""
    import numpy as np
    import torch

    from mmhand_torch.config import Config, DataConfig, ModelConfig
    from mmhand_torch.data import HostLoader, build_dataset, make_prepare_batch
    from mmhand_torch.ops.ssim import ssim
    from mmhand_torch.train.state import build_generator
    from mmhand_torch.train.step import make_eval_step

    blocks = {} if args.n_blocks is None else {"g_n_blocks": args.n_blocks}
    model = ModelConfig(fine_size=args.fineSize, ngf=args.ngf, ndf=args.ndf,
                        padding_type=args.padding_type, **blocks)
    cfg = Config(model=model, data=DataConfig(
        dataset="RHD", dataroot=data, batch_size=args.batchSize,
        serial_batches=True))
    generator = build_generator(cfg, args.device)
    generator.load_state_dict(torch.load(
        state_path, map_location="cpu", weights_only=True,
        mmap=True)["generator"])
    eval_step = make_eval_step(generator)
    prepare = make_prepare_batch(cfg.data.sigma, args.device)
    loader = HostLoader(build_dataset(cfg), args.batchSize, shuffle=False,
                        drop_last=False)
    vals = []
    for raw in loader.epoch(0):
        batch = prepare({k: v for k, v in raw.items()
                         if not k.endswith("paths")})
        fake = eval_step(batch)
        vals.append(float(ssim((fake + 1) / 2, (batch["H2"] + 1) / 2)))
    return float(np.mean(vals))


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--dir", default=os.path.join(
        os.environ.get("TMPDIR", "/tmp"), "mmhand_torch_longrun"))
    ap.add_argument("--name", default="longrun")
    ap.add_argument("--items", type=int, default=64)
    ap.add_argument("--kill_after_prints", type=int, default=45,
                    help="SIGKILL leg 1 once the loss log holds this many "
                         "lines (step kill_after_prints x print_freq)")
    ap.add_argument("--t1_max", type=float, default=3600,
                    help="seconds leg 1 may take before the demo gives up")
    ap.add_argument("--steps2", type=int, default=1000,
                    help="steps of the resumed leg")
    ap.add_argument("--padding_type", default="reflect",
                    choices=("reflect", "zero"))
    ap.add_argument("--print_freq", type=int, default=20)
    ap.add_argument("--save_every", type=int, default=800)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fineSize", type=int, default=256)
    ap.add_argument("--batchSize", type=int, default=16)
    ap.add_argument("--ngf", type=int, default=64)
    ap.add_argument("--ndf", type=int, default=64)
    ap.add_argument("--n_blocks", type=int, default=None)
    return ap.parse_args(argv)


def _tail(path, n: int = 3000) -> str:
    with open(path, errors="replace") as fh:
        return fh.read()[-n:]


def demo(argv=None) -> dict:
    """Both legs and the checks; prints the summary's JSON line and
    returns it.  Raises if leg 1 was not killed or leg 2 failed."""
    from mmhand_torch.data.rhd_tree import write_block_tree

    args = parse(argv)
    os.makedirs(args.dir, exist_ok=True)
    data = write_block_tree(
        os.path.join(args.dir, f"tree{args.items}_{args.fineSize}"),
        args.items, args.fineSize)
    ckpt_dir = os.path.join(args.dir, "ckpt")
    name = f"{args.name}_{args.padding_type}"
    run_dir = os.path.join(ckpt_dir, name)
    shutil.rmtree(run_dir, ignore_errors=True)  # leg 2 appends to leg 1 only
    common = ["--dataset", "RHD", "--dataroot", data,
              "--batchSize", str(args.batchSize),
              "--fineSize", str(args.fineSize), "--ngf", str(args.ngf),
              "--ndf", str(args.ndf), "--name", name,
              "--checkpoints_dir", ckpt_dir,
              "--padding_type", args.padding_type,
              "--display_id", "1", "--print_freq", str(args.print_freq),
              "--display_freq", "100000",
              "--save_latest_freq", str(args.save_every),
              "--save_epoch_freq", "100000", "--seed", "49",
              "--device", args.device]
    if args.n_blocks is not None:
        common += ["--n_blocks", str(args.n_blocks)]
    train = [sys.executable, "-m", "mmhand_torch.scripts.train"]
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        filter(None, [str(REPO), os.environ.get("PYTHONPATH")]))}
    log = os.path.join(run_dir, "loss_log.txt")
    state_path = os.path.join(run_dir, "state_latest.pt")

    # leg 1: SIGKILL once real progress is in the log
    out1 = os.path.join(args.dir, "leg1.out")
    start = time.perf_counter()
    with open(out1, "w") as fh:
        proc = subprocess.Popen(train + common, env=env, stdout=fh,
                                stderr=subprocess.STDOUT)
    killed = False
    try:
        while time.perf_counter() - start < args.t1_max:
            if proc.poll() is not None:
                break
            if (os.path.exists(log)
                    and len(parse_loss_log(log)) >= args.kill_after_prints):
                os.kill(proc.pid, signal.SIGKILL)
                killed = True
                break
            time.sleep(0.05)
    finally:
        if proc.poll() is None and not killed:
            proc.kill()
        proc.wait()
    leg1_s = time.perf_counter() - start
    if not killed:
        raise RuntimeError(
            f"leg 1 ended on its own (rc {proc.returncode}) or outlived "
            f"--t1_max before {args.kill_after_prints} loss lines:\n"
            f"{_tail(out1)}")
    rows1 = parse_loss_log(log)
    if not os.path.exists(state_path):
        raise RuntimeError("leg 1 was killed before its first save point")
    resumed = saved_step(state_path)

    # leg 2: resume from the latest checkpoint
    out2 = os.path.join(args.dir, "leg2.out")
    start = time.perf_counter()
    with open(out2, "w") as fh:
        rc2 = subprocess.run(train + common + ["--continue_train",
                                               "--max_steps", str(args.steps2)],
                             env=env, stdout=fh, stderr=subprocess.STDOUT
                             ).returncode
    leg2_s = time.perf_counter() - start
    if rc2 != 0:
        raise RuntimeError(f"leg 2 exited {rc2}:\n{_tail(out2)}")
    rows = parse_loss_log(log)
    if len(rows) <= len(rows1):
        raise RuntimeError("leg 2 appended no loss lines")
    with open(out2) as fh:
        launches = [json.loads(line[len(LAUNCHES_LINE):]) for line in fh
                    if line.startswith(LAUNCHES_LINE)]

    out = {"metric": "longrun_stability", "padding_type": args.padding_type,
           "device": args.device, "steps_logged": len(rows) * args.print_freq,
           "leg1_seconds": leg1_s, "leg2_seconds": leg2_s,
           "leg1_returncode": proc.returncode,
           "leg1_last_logged_step": rows1[-1][1],
           "resumed_step": resumed, "final_step": saved_step(state_path),
           "leg2_lines": len(rows) - len(rows1),
           "leg2_launches": launches[-1] if launches else None}
    out.update(loss_checks(rows, len(rows1)))
    out["descent_first_step"] = descent_step(rows, len(rows1), resumed,
                                             out["pair_L1_start"])
    out["plot_ok"] = plot_check(os.path.join(run_dir, "web",
                                             "plot_data.json"), len(rows))
    out["ssim_train_pairs"] = ssim_on_train_pairs(args, data, state_path)
    print(json.dumps(out), flush=True)
    return out


def main(argv=None) -> dict:
    out = demo(argv)
    if not (out["continuity_ok"] and out["descent_ok"] and out["plot_ok"]):
        raise SystemExit(2)
    return out


if __name__ == "__main__":
    main()
