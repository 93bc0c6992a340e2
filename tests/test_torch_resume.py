"""mmhand_torch's train-state checkpoint and --continue_train (counterpart
of mmhand_tpu/utils/checkpoint.py and mmhand_tpu/train/loop.py:86-133;
reference models/base_model.py:60-80).

On the CPU a resumed run is the same computation as an unbroken one, so
these tests hold it bit for bit: dropout and pools on, the pool generator's
and the global generator's states restored, Adam's state on the same
parameter order, the step counter continued."""

import json
import os

import numpy as np
import pytest
import torch

from mmhand_torch import config as tcfg
from mmhand_torch.train.loop import train
from mmhand_torch.train.precision import LossScaleState
from mmhand_torch.train.state import build_system
from mmhand_torch.train.step import LRSchedule, make_train_step
from mmhand_torch.utils.checkpoint import CheckpointManager
from test_torch_threads import two_threads  # noqa: F401


def _config(tmp_path=None, scaling=False, **run):
    return tcfg.Config(
        model=tcfg.ModelConfig(fine_size=32, ngf=8, ndf=8, g_n_blocks=1,
                               n_layers_d=1),
        loss=tcfg.LossConfig(l1_type="origin"),
        optim=tcfg.OptimConfig(pool_size=3, lr_policy=run.pop("policy",
                                                               "lambda")),
        data=tcfg.DataConfig(dataset="synthetic", batch_size=2,
                             max_dataset_size=8),
        precision=tcfg.PrecisionConfig(compute_dtype="float32",
                                       loss_scaling=scaling),
        run=tcfg.RunConfig(checkpoints_dir=str(tmp_path), name="res",
                           print_freq=1000, **run))


def _batches(n, seed=3):
    r = np.random.RandomState(seed)
    return [{k: torch.from_numpy(r.uniform(-1, 1, (2, 32, 32, c))
                                 .astype(np.float32))
             for k, c in [("H1", 3), ("P1", 21), ("D1", 3), ("H2", 3),
                          ("P2", 21), ("D2", 3)]} for _ in range(n)]


def _assert_same(got, want, where="state"):
    """Two state trees equal, every tensor bit for bit."""
    if isinstance(want, dict):  # a state_dict is an OrderedDict
        assert isinstance(got, dict) and set(got) == set(want), where
        for k in want:
            _assert_same(got[k], want[k], f"{where}.{k}")
        return
    assert type(got) is type(want), where
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_same(a, b, f"{where}[{i}]")
    elif isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and got.shape == want.shape, where
        assert torch.equal(got, want), where
    else:
        assert got == want, where


def test_checkpoint_round_trip_restores_everything(tmp_path):
    """Nets (running statistics included), three Adams, both pools, step,
    the pool and global random streams and the loss scales come back
    exactly in a fresh system."""
    cfg = _config(tmp_path, scaling=True)
    system = build_system(cfg, "cpu")
    step = make_train_step(system)
    for b in _batches(2):
        step(b, 2e-4)
    system.scales["g"] = LossScaleState(torch.tensor(512.0),
                                        torch.tensor(7, dtype=torch.int32))
    torch.rand(5)  # move the global stream past build_system's seed
    ckpt = CheckpointManager(str(tmp_path), "res")
    ckpt.save(system, "latest")
    want = system.state_dict()
    assert system.pool_pb.num == 3 and bool(want["rank"]["pool_pb"].any())

    fresh = build_system(cfg, "cpu")
    assert fresh.step == 0
    ckpt.restore(fresh, "latest")
    _assert_same(fresh.state_dict(), want)
    assert fresh.step == 2 and fresh.opt_g.state
    saved = torch.load(ckpt.path("latest"), weights_only=True)
    assert saved["world"] == 1
    assert saved["rank"]["pool_pb"].shape == (1, 3, 32, 32, 24)
    assert ckpt.available_labels() == ["latest"]


@pytest.mark.parametrize("scaling", [False, True])
def test_resumed_run_equals_uninterrupted_run(tmp_path, scaling):
    """3 steps, a save, a fresh build_system and a restore, 3 more steps:
    the metrics of every step and the final state equal those of 6 steps
    without a break, bit for bit, with dropout and pools on."""
    cfg = _config(tmp_path, scaling=scaling)
    batches = _batches(6)
    whole = build_system(cfg, "cpu")
    step = make_train_step(whole)
    want = [step(b, 2e-4) for b in batches]

    part = build_system(cfg, "cpu")
    step = make_train_step(part)
    got = [step(b, 2e-4) for b in batches[:3]]
    ckpt = CheckpointManager(str(tmp_path), "res")
    ckpt.save(part, "latest")
    part = build_system(cfg, "cpu")
    torch.rand(3)  # a stray draw between build and restore changes nothing
    ckpt.restore(part, "latest")
    step = make_train_step(part)
    got += [step(b, 2e-4) for b in batches[3:]]

    _assert_same(got, want, "metrics")
    _assert_same(part.state_dict(), whole.state_dict())
    assert part.step == 6


def test_save_replaces_the_file_whole(tmp_path, monkeypatch):
    """A save that fails while writing leaves the last good checkpoint as
    it was: the new state goes to a temporary file first."""
    system = build_system(_config(tmp_path), "cpu")
    ckpt = CheckpointManager(str(tmp_path), "res")
    ckpt.save(system, "latest")
    good = open(ckpt.path("latest"), "rb").read()
    make_train_step(system)(_batches(1)[0], 2e-4)

    def torn(obj, path):
        with open(path, "wb") as f:
            f.write(b"torn")
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", torn)
    with pytest.raises(OSError, match="disk full"):
        ckpt.save(system, "latest")
    assert open(ckpt.path("latest"), "rb").read() == good


def test_restore_refuses_another_setup(tmp_path):
    """A checkpoint of another world size, or without the loss scales that
    the config asks for, raises instead of half restoring."""
    system = build_system(_config(tmp_path), "cpu")
    ckpt = CheckpointManager(str(tmp_path), "res")
    ckpt.save(system, "latest")
    with pytest.raises(ValueError, match="loss scaling"):
        ckpt.restore(build_system(_config(tmp_path, scaling=True), "cpu"))
    state = torch.load(ckpt.path("latest"), weights_only=True)
    state["world"] = 2
    state["rank"] = {k: torch.cat([v, v]) for k, v in state["rank"].items()}
    torch.save(state, ckpt.path("two"))
    with pytest.raises(ValueError, match="saved by 2 ranks"):
        ckpt.restore(system, "two")
    with pytest.raises(FileNotFoundError):
        ckpt.restore(system, "nope")


def test_gan_loop_continue_train(tmp_path):
    """tests/test_resume.py:17 for the port: the step counter continues,
    the metrics are finite and the plateau sidecar is written."""
    r1 = train(_config(tmp_path, policy="plateau"), device="cpu", max_steps=1)
    assert r1.steps == 1 and r1.system.step == 1
    r2 = train(_config(tmp_path, policy="plateau", continue_train=True),
               device="cpu", max_steps=1)
    assert np.isfinite(list(r2.last_metrics.values())).all()
    assert r2.system.step == r1.system.step + 1
    assert os.path.exists(tmp_path / "res" / "lr_sched.json")


def test_plateau_sidecar_is_restored(tmp_path):
    """lr_sched.json holds LRSchedule's state after every epoch; a resumed
    run reads it back, so the plateau's cut rate carries over."""
    train(_config(tmp_path, policy="plateau"), device="cpu", total_epochs=2)
    path = tmp_path / "res" / "lr_sched.json"
    state = json.loads(path.read_text())
    assert set(state) == {"lr", "best", "num_bad"}
    assert state["num_bad"] == 0 and np.isfinite(state["best"])
    path.write_text(json.dumps({"lr": 1.25e-5, "best": 0.5, "num_bad": 2}))
    r = train(_config(tmp_path, policy="plateau", continue_train=True),
              device="cpu", max_steps=1)
    assert r.system.opt_g.param_groups[0]["lr"] == 1.25e-5
    sched = LRSchedule(_config(tmp_path, policy="plateau"))
    sched.load_state_dict(json.loads(path.read_text()))
    assert sched.state_dict() == {"lr": 1.25e-5, "best": 0.5, "num_bad": 2}


def test_continue_train_without_checkpoint_starts_fresh(tmp_path):
    fresh = train(_config(tmp_path / "a"), device="cpu", max_steps=2)
    resumed = train(_config(tmp_path / "b", continue_train=True),
                    device="cpu", max_steps=2)
    assert resumed.system.step == 2
    assert resumed.last_metrics == fresh.last_metrics


def test_saves_write_state_and_network_files(tmp_path):
    """Each save cadence writes state_<label>.pt beside the three
    <label>_net_*.pth files that aug and evaluate_gan read."""
    train(_config(tmp_path, save_epoch_freq=1), device="cpu", total_epochs=2)
    run = tmp_path / "res"
    ckpt = CheckpointManager(str(tmp_path), "res")
    assert ckpt.available_labels() == ["1", "2", "latest"]
    for label in ("1", "2", "latest"):
        for net in ("netG", "netD_PB", "netD_PP"):
            assert (run / f"{label}_net_{net}.pth").exists()
    assert not list(run.glob("*.tmp"))
    g = torch.load(run / "latest_net_netG.pth", weights_only=True)
    state = torch.load(ckpt.path("latest"), weights_only=True)
    _assert_same(g, state["generator"])
    assert state["step"] == 8  # 2 epochs of 4 steps
