"""mmhand_torch.scripts.longrun_demo, the port's twin of
tools/longrun_demo.py: a training process killed by SIGKILL and resumed.

The demo runs here on the CPU at toy size (32 px, ngf/ndf 8, 2 blocks,
batch 2, 8 items): leg 1 saves every 6 steps and is killed once its log
holds 8 lines, leg 2 resumes with --continue_train for 12 steps.  Too few
steps for the descent check, which the card's run holds at full width
(chip_smoke.py); the three checks themselves are held here on written
logs, one of them with a re-initialization jump.
"""

import json
import os
import pickle
import shutil
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from mmhand_torch.data.rhd_tree import write_block_tree
from mmhand_torch.scripts import longrun_demo as demo

REPO = Path(__file__).resolve().parent.parent


def _row(epoch, it, l1):
    return (f"(epoch: {epoch}, iters: {it}, time: 0.071) pair_L1loss: "
            f"{l1:.3f} pair_GANloss: 3.900 D_PP: 4.100 D_PB: 4.000 \n")


def _log(tmp_path, *legs):
    """A loss_log.txt of ``legs``, each a list of pair_L1loss values logged
    at iters 1, 2, ... after its own header (as each run appends)."""
    path = tmp_path / "loss_log.txt"
    with open(path, "w") as fh:
        for losses in legs:
            fh.write("================ Training Loss (Sat) ================\n")
            for i, l1 in enumerate(losses):
                fh.write(_row(1 + i // 4, i + 1, l1))
    return demo.parse_loss_log(path)


def test_loss_checks_on_written_logs(tmp_path):
    """A log that falls and resumes where it was passes both checks; a
    resume that starts over at the initial loss fails continuity; a flat
    log fails descent (the JAX tool's 1.6 x + 0.5 and 0.7 x)."""
    falling = [8.0 - 0.25 * i for i in range(20)]
    rows = _log(tmp_path, falling[:12], falling[12:])
    assert len(rows) == 20 and rows[12][1] == 1  # leg 2 counts from 1
    ok = demo.loss_checks(rows, 12)
    assert ok["continuity_ok"] and ok["descent_ok"]
    assert ok["pair_L1_before_kill"] == pytest.approx(5.25)
    assert ok["pair_L1_after_resume"] == pytest.approx(5.0)
    assert ok["pair_L1_start"] == pytest.approx((8.0 + 7.75) / 2)
    assert ok["pair_L1_floor"] == pytest.approx((3.5 + 3.25) / 2)

    jump = _log(tmp_path, [8.0 - 0.5 * i for i in range(12)],
                [8.0] + [2.0] * 7)
    checked = demo.loss_checks(jump, 12)
    assert 8.0 >= 1.6 * 2.5 + 0.5 and not checked["continuity_ok"]
    assert checked["descent_ok"]

    flat = demo.loss_checks(_log(tmp_path, [4.0] * 10, [3.9] * 10), 10)
    assert flat["continuity_ok"] and not flat["descent_ok"]


def test_descent_step_on_written_logs(tmp_path):
    """The first logged step below 0.7 x the start: in leg 1 by its own
    iters, in leg 2 counted on from the step it resumed at; None when the
    loss never gets there."""
    falling = [8.0 - 0.25 * i for i in range(20)]
    rows = _log(tmp_path, falling[:12], falling[12:])
    start = demo.loss_checks(rows, 12)["pair_L1_start"]
    assert falling[10] < 0.7 * start <= falling[9]
    assert demo.descent_step(rows, 12, 10, start) == 11

    late = _log(tmp_path, [8.0] * 10, [8.0, 7.0, 3.0, 2.0])
    assert demo.descent_step(late, 10, 7, 8.0) == 7 + 3

    flat = _log(tmp_path, [8.0] * 10, [7.9] * 4)
    assert demo.descent_step(flat, 10, 7, 8.0) is None


def test_plot_check(tmp_path):
    path = tmp_path / "plot_data.json"
    path.write_text(json.dumps({"X": [[0.5]] * 5, "Y": [[1.0]] * 5,
                                "legend": ["pair_L1loss"]}))
    assert demo.plot_check(path, 10) and not demo.plot_check(path, 12)


def test_block_tree_is_bench_tree(tmp_path, monkeypatch):
    """The port's tree writer writes mmhand_tpu's bench.py tree: the same
    pixels, depth planes and annotations.  bench.py sets up mmhand_tpu's
    runtime when imported; the environment keeps JAX's PRNG and compile
    cache as the other tests of this process have them."""
    monkeypatch.setenv("MMHAND_STRICT_PRNG", "1")
    monkeypatch.setenv("MMHAND_COMPILE_CACHE", "0")
    monkeypatch.syspath_prepend(str(REPO))
    import bench

    bench._ensure_e2e_tree(str(tmp_path / "jax"), 3, 64)
    root = write_block_tree(tmp_path / "port", 3, 64)
    assert (Path(root) / ".complete_3_64").exists()
    for sub in ("color", "depth"):
        for i in range(3):
            a = np.asarray(Image.open(tmp_path / "jax" / sub / f"{i:05d}.png"))
            b = np.asarray(Image.open(Path(root) / sub / f"{i:05d}.png"))
            np.testing.assert_array_equal(a, b)
    with open(tmp_path / "jax" / "annotation.pickle", "rb") as fh:
        want = pickle.load(fh)
    with open(Path(root) / "annotation.pickle", "rb") as fh:
        got = pickle.load(fh)
    assert set(got) == set(want) == {"color", "depth", "mask"}
    for kind in want:
        assert set(got[kind]) == set(want[kind])
        for name, rec in want[kind].items():
            for k, v in rec.items():
                np.testing.assert_array_equal(got[kind][name][k], v)


def test_demo_kills_and_resumes_on_the_cpu(tmp_path, monkeypatch, capsys):
    """Leg 1 ends by SIGKILL (-9) past its save at step 6; leg 2 exits 0,
    resumes at that checkpoint's step and appends 12 lines; the saved state
    ends 12 steps on; plot_data.json holds a point for every line of both
    legs but perhaps leg 1's last (SIGKILL may land between the log line
    and the plot's write); the trainer ran no kernel (the CPU's plain
    versions)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    out = demo.demo(["--dir", str(tmp_path), "--device", "cpu",
                     "--items", "8", "--fineSize", "32", "--batchSize", "2",
                     "--ngf", "8", "--ndf", "8", "--n_blocks", "2",
                     "--print_freq", "1", "--save_every", "6",
                     "--kill_after_prints", "8", "--steps2", "12"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    assert out["leg1_returncode"] == -9
    assert out["leg1_last_logged_step"] >= 8
    assert out["resumed_step"] % 6 == 0
    assert 6 <= out["resumed_step"] <= out["leg1_last_logged_step"]
    assert out["final_step"] == out["resumed_step"] + 12
    assert out["leg2_lines"] == 12
    assert out["leg2_launches"] == {"gaussian_heatmaps": 0, "bn_sums": 0,
                                    "bn_sums_backward": 0, "bn_apply": 0,
                                    "bn_apply_backward": 0, "reflect_pad": 0,
                                    "reflect_pad_backward": 0}
    run = tmp_path / "ckpt" / "longrun_reflect"
    text = (run / "loss_log.txt").read_text()
    assert text.count("Training Loss") == 2  # each leg appended
    rows = demo.parse_loss_log(run / "loss_log.txt")
    n1 = len(rows) - 12
    assert n1 == out["leg1_last_logged_step"]
    assert [r[1] for r in rows[n1:]] == list(range(1, 13))
    with open(run / "web" / "plot_data.json") as fh:
        # the kill may land between leg 1's last log line and its point
        assert len(rows) - 1 <= len(json.load(fh)["Y"]) <= len(rows)
    assert out["plot_ok"] and out["continuity_ok"]
    assert out["descent_first_step"] is None or (
        0 < out["descent_first_step"] <= out["final_step"])
    assert -1.0 <= out["ssim_train_pairs"] <= 1.0
    assert out["steps_logged"] == len(rows)
    for name in ("leg1.out", "leg2.out"):
        assert os.path.getsize(tmp_path / name) > 0
    shutil.rmtree(tmp_path / "ckpt")
