"""The evaluation slice against mmhand_tpu: SSIM, the metrics, the
Evaluator, and both CLIs end to end on the CPU at 32 px.

Both sides get the same weights: the Inception and CPM nets through npz
dumps of the port's random nets (with drawn BatchNorm statistics), the
MM-Hand generator through a saved port state_dict, the baselines through
``convert.py`` from mmhand_tpu's own random init.  Everything runs in
float32.  Tolerances: SSIM 1e-5 (per image, conv taps summed in another
order); IS rtol 1e-4; pool features and FID inputs rtol/atol 1e-4; FID rtol
1e-3 (a 2048-d sqrtm of rank-deficient covariances amplifies 1e-6 feature
differences); PCK AUCs atol 1e-4 (equal argmax decodes).  The CLIs print
scores rounded to 4 decimals, so their comparisons add 5e-5.

scipy's sqrtm of a 2048-d covariance takes ~15 s on the CPU, so the
end-to-end tests record the FID inputs on both sides and compare those;
``test_evaluator_matches_jax`` computes both FIDs in full.
"""

import argparse
import dataclasses
import importlib
import json
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmhand_torch import config as tcfg
from mmhand_torch.convert import (
    resnet_generator_state_dict_from_jax,
    unet_generator_state_dict_from_jax,
)
from mmhand_torch.eval import evaluator as tev
from mmhand_torch.eval import metrics as tmetrics
from mmhand_torch.models import cpm as tcpm
from mmhand_torch.models import inception as tinc
from mmhand_torch.ops import ssim as tssim
from mmhand_torch.scripts import bench_baselines as port_bench
from mmhand_torch.scripts import evaluate_gan as port_eval
from mmhand_torch.train.state import build_generator
from mmhand_torch.utils import checkpoint as tckpt
from mmhand_tpu import config as jcfg
from mmhand_tpu.eval import evaluator as jev
from mmhand_tpu.eval import metrics as jmetrics
from mmhand_tpu.models import baselines as jbase
from mmhand_tpu.models import cpm as jcpm
from mmhand_tpu.models.inception import load_inception_npz
from mmhand_tpu.ops.ssim import _gaussian_window as jax_window
from mmhand_tpu.ops.ssim import ssim as jax_ssim
from mmhand_tpu.train.state import NetState

REPO = Path(__file__).resolve().parent.parent
SIZE = 32
ARGV = ["--dataset", "synthetic", "--fineSize", str(SIZE), "--ngf", "8",
        "--max_dataset_size", "4", "--seed", "3"]
SCORES = ("IS_avg", "IS_std", "SSIM_avg", "SSIM_std", "pck2d_auc", "pck3d_auc")


def _draw_bn(net, rng, mean=0.2, var=(0.5, 2.0)):
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.running_mean.copy_(torch.from_numpy(
                    rng.normal(0, mean, n).astype(np.float32)))
                m.running_var.copy_(torch.from_numpy(
                    rng.uniform(*var, n).astype(np.float32)))


def _save_npz(net, path, prefix=""):
    np.savez(path, **{prefix + k: v.numpy() for k, v in net.state_dict().items()})
    return str(path)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """npz dumps of a random Inception (drawn statistics) and CPM pair."""
    root = tmp_path_factory.mktemp("eval_weights")
    gen = torch.Generator().manual_seed(0)
    inc = tinc.init_fan_in(tinc.Inception3(), gen)
    _draw_bn(inc, np.random.RandomState(0))
    hpm2d = tinc.init_fan_in(tcpm.Hpm2d(), gen)
    hpm3d = tinc.init_fan_in(tcpm.Hpm3d(size=SIZE), gen)
    return types.SimpleNamespace(
        inception=_save_npz(inc, root / "inception.npz"),
        hpm2d=_save_npz(hpm2d, root / "hpm2d.npz", "module."),
        hpm3d=_save_npz(hpm3d, root / "hpm3d.npz", "module."))


def _batches(n_batches=2, batch=2, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_batches):
        gt = rng.uniform(-1, 1, (batch, SIZE, SIZE, 3)).astype(np.float32)
        pred = np.clip(gt + rng.normal(0, 0.3, gt.shape), -1, 1).astype(np.float32)
        xyz = np.concatenate([rng.uniform(0, SIZE, (batch, 21, 2)),
                              rng.uniform(300, 700, (batch, 21, 1))], -1)
        out.append((pred, gt, xyz))
    return out


def _port_evaluator(weights, **kw):
    hpm2d, hpm3d = tcpm.Hpm2d(), tcpm.Hpm3d(size=SIZE)
    hpm2d.load_state_dict(tcpm.load_cpm_npz(weights.hpm2d))
    hpm3d.load_state_dict(tcpm.load_cpm_npz(weights.hpm3d))
    judge = tev.HPEJudge(hpm2d, hpm3d, device="cpu")
    return tev.Evaluator(tinc.load_inception_npz(weights.inception), judge,
                         device="cpu", **kw)


def _jax_evaluator(weights, **kw):
    judge = jev.HPEJudge(jcpm.load_cpm_npz(weights.hpm2d),
                         jcpm.load_cpm_npz(weights.hpm3d))
    return jev.Evaluator(load_inception_npz(weights.inception), judge, **kw)


def _assert_scores(got, want, extra_atol=0.0):
    for k in SCORES:
        atol = (1e-5 if k.startswith("SSIM") else 1e-4) + extra_atol
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=atol,
                                   err_msg=k)


def test_ssim_matches_jax():
    rng = np.random.RandomState(1)
    a = rng.uniform(0, 1, (3, 40, 36, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.2, a.shape), 0, 1).astype(np.float32)
    got = tssim.ssim(torch.from_numpy(a), torch.from_numpy(b), size_average=False)
    want = np.asarray(jax_ssim(a, b, size_average=False))
    assert got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        float(tssim.ssim(torch.from_numpy(a), torch.from_numpy(b))),
        float(jax_ssim(a, b)), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tssim.gaussian_window().numpy(),
                               np.asarray(jax_window()),
                               rtol=1e-6, atol=0)
    same = tssim.ssim(torch.from_numpy(a), torch.from_numpy(a), size_average=False)
    np.testing.assert_allclose(same.numpy(), 1.0, atol=1e-5)


def test_metrics_equal_jax():
    """The port's copies of the numpy metrics give mmhand_tpu's numbers
    exactly on the same inputs."""
    rng = np.random.RandomState(2)
    ev_t, ev_j = tmetrics.EvalUtil(21), jmetrics.EvalUtil(21)
    for _ in range(3):
        gt, pred = rng.uniform(0, 64, (2, 21, 3))
        vis = rng.uniform(size=21) > 0.2
        ev_t.feed(gt, vis, pred)
        ev_j.feed(gt, vis, pred)
    got, want = ev_t.get_measures(0, 30, 20), ev_j.get_measures(0, 30, 20)
    assert got[:3] == want[:3]
    np.testing.assert_array_equal(got[3], want[3])
    logits = rng.normal(0, 3, (40, 1000))
    for splits in (1, 4):
        assert (tmetrics.inception_score_from_logits(logits, splits)
                == jmetrics.inception_score_from_logits(logits, splits))
    big = rng.normal(size=(300, 16)), rng.normal(size=(300, 16)) + 0.5
    assert tmetrics.fid_from_features(*big) == jmetrics.fid_from_features(*big)
    small = rng.normal(size=(8, 64)), rng.normal(size=(6, 64))
    with pytest.warns(UserWarning, match="eps ridge"):
        fid = tmetrics.fid_from_features(*small)
    with pytest.warns(UserWarning, match="eps ridge"):
        assert fid == jmetrics.fid_from_features(*small)


def test_evaluator_matches_jax(weights):
    """Two batches through both Evaluators: IS, SSIM, PCK and FID, then the
    SSIM range quirk."""
    port, jax_ev = _port_evaluator(weights), _jax_evaluator(weights)
    for pred, gt, xyz in _batches():
        port.feed(torch.from_numpy(pred), torch.from_numpy(gt), xyz)
        jax_ev.feed(pred, gt, xyz)
    got, want = port.evaluate(), jax_ev.evaluate()
    _assert_scores(got, want)
    np.testing.assert_allclose(got["fid"], want["fid"], rtol=1e-3)
    assert got["weights"] == want["weights"] == "loaded"
    assert got["IS_avg"] > 1.0 and 0.0 < got["pck2d_auc"] < 1.0
    np.testing.assert_allclose(np.concatenate(port._pool_fake),
                               np.concatenate(jax_ev._pool_fake),
                               rtol=1e-4, atol=1e-4)

    quirk = _port_evaluator(weights, ssim_quirk=True, compute_fid=False)
    jax_quirk = _jax_evaluator(weights, ssim_quirk=True, compute_fid=False)
    quirk.judge = jax_quirk.judge = None
    for pred, gt, _ in _batches(1, seed=5):
        quirk.feed(torch.from_numpy(pred), torch.from_numpy(gt))
        jax_quirk.feed(pred, gt)
    got, want = quirk.evaluate(), jax_quirk.evaluate()
    assert "fid" not in got and "pck2d_auc" not in got
    np.testing.assert_allclose(got["SSIM_avg"], want["SSIM_avg"], atol=1e-5)
    quirk.clean()
    assert not quirk._ssim and not quirk._logits_fake


@pytest.fixture
def fid_inputs(monkeypatch):
    """Both evaluators' FID replaced by a recorder of its inputs, which
    returns the mean term ||mu_r - mu_f||^2."""
    seen = {"port": [], "jax": []}

    def recorder(side):
        def fid(real, fake, eps=1e-6):
            seen[side].append((np.asarray(real), np.asarray(fake)))
            return float(((real.mean(0) - fake.mean(0)) ** 2).sum())
        return fid

    monkeypatch.setattr(tev, "fid_from_features", recorder("port"))
    monkeypatch.setattr(jev, "fid_from_features", recorder("jax"))
    return seen


def _assert_fid_inputs(seen):
    (port_real, port_fake), = seen["port"]
    (jax_real, jax_fake), = seen["jax"]
    assert port_real.shape == port_fake.shape == (4, 2048)
    np.testing.assert_allclose(port_real, jax_real, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(port_fake, jax_fake, rtol=1e-4, atol=1e-4)


def _jax_script(monkeypatch, name):
    """scripts/<name>.py, imported as tests/test_torch_aug.py imports
    scripts/aug.py (threefry kept for later tests in the worker)."""
    monkeypatch.setenv("MMHAND_STRICT_PRNG", "1")
    monkeypatch.syspath_prepend(str(REPO / "scripts"))
    return importlib.import_module(name)


def _config(module, argv):
    parser = argparse.ArgumentParser()
    module.add_cli_args(parser)
    cfg = module.from_cli_args(parser.parse_args(argv),
                               module.Config(is_train=False))
    return cfg.replace(precision=module.PrecisionConfig(compute_dtype="float32"))


def test_evaluate_gan_matches_jax(weights, fid_inputs, tmp_path, monkeypatch):
    jax_script = _jax_script(monkeypatch, "evaluate_gan")
    jax_aug = _jax_script(monkeypatch, "aug")
    argv = ARGV + ["--checkpoints_dir", str(tmp_path / "ckpt"), "--name", "run"]
    port_cfg, jax_cfg = _config(tcfg, argv), _config(jcfg, argv)
    port_cfg = port_cfg.replace(model=dataclasses.replace(port_cfg.model,
                                                          g_n_blocks=2))
    jax_cfg = jax_cfg.replace(model=dataclasses.replace(jax_cfg.model,
                                                        g_n_blocks=2))
    g = build_generator(port_cfg, "cpu", seed=0)
    _draw_bn(g, np.random.RandomState(1), mean=0.05, var=(0.005, 0.05))
    pth = tckpt.save_network(g, str(tmp_path / "ckpt"), "run")
    variables = jax_aug.load_torch_generator(pth)
    state = types.SimpleNamespace(
        g=NetState(variables["params"], variables["batch_stats"]))
    npz = dict(inception_npz=weights.inception, hpm2d_npz=weights.hpm2d,
               hpm3d_npz=weights.hpm3d)

    got = port_eval.evaluate(port_cfg, batch_size=2, device="cpu", **npz)
    want = jax_script.evaluate(jax_cfg, batch_size=2, state=state, **npz)
    _assert_scores(got, want)
    _assert_fid_inputs(fid_inputs)
    assert got["images"] == want["images"] == 4
    assert got["images_per_sec"] > 0 and got["images_per_sec_steady"] > 0
    assert got["weights"] == "loaded"

    class NoPairs(port_eval.HostLoader):
        def epoch(self, epoch):
            return iter(())

    monkeypatch.setattr(port_eval, "HostLoader", NoPairs)
    with pytest.raises(SystemExit, match="no eval pairs"):
        port_eval.evaluate(port_cfg, device="cpu", **npz)


def test_evaluate_gan_cli(weights, fid_inputs, tmp_path, capsys):
    """The CLI with its defaults (bf16 generator, random judge): one JSON
    line of finite scores."""
    cfg = _config(tcfg, ARGV)
    pth = tckpt.save_network(build_generator(cfg, "cpu", seed=2),
                             str(tmp_path), "cli")
    with pytest.warns(UserWarning, match="RANDOM CPM"):
        scores = port_eval.main(ARGV + ["--torch_netG", pth, "--device", "cpu",
                                        "--eval_batch", "3",
                                        "--inception_npz", weights.inception])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed["images"] == scores["images"] == 4
    assert printed["weights"] == "random:cpm"
    for k in SCORES + ("fid", "images_per_sec", "images_per_sec_steady"):
        assert np.isfinite(scores[k]) and k in printed, k


def _drawn(base):
    """``base`` (a mmhand_tpu baseline class) whose ``init`` returns its own
    random init with drawn running statistics, computed once: the variables
    both sides of the bench test run with (``Drawn.drawn``)."""

    class Drawn(base):
        drawn = {}

        def init(self, rngs, *args, **kwargs):
            if not Drawn.drawn:
                v = jax.jit(lambda r: base.init(self, r, *args, **kwargs))(rngs)
                rng = np.random.RandomState(3)
                stats = jax.tree_util.tree_map_with_path(
                    lambda path, a: (rng.uniform(0.005, 0.05, a.shape)
                                     if path[-1].key == "var"
                                     else rng.normal(0, 0.05, a.shape)
                                     ).astype(np.float32), v["batch_stats"])
                Drawn.drawn.update(params=v["params"], batch_stats=stats)
            return Drawn.drawn

    return Drawn


@pytest.mark.parametrize("arch", ["resnet", "unet"])
def test_bench_baselines_matches_jax(arch, weights, fid_inputs, tmp_path,
                                     monkeypatch, capsys):
    """scripts/bench_baselines.py with its baseline cut to the test's size
    (resnet: 2 blocks, ngf 8; unet: 5 downs, ngf 8), its random init given
    drawn running statistics and its random CPM judge replaced by the npz
    one, against the port fed the same weights through convert.py."""
    jax_script = _jax_script(monkeypatch, "bench_baselines")
    if arch == "resnet":
        net = _drawn(jbase.ResnetGenerator)(ngf=8, n_blocks=2, dtype=jnp.float32)
        monkeypatch.setattr(jbase, "ResnetGenerator", lambda **_: net)
        to_port, shape = resnet_generator_state_dict_from_jax, {"n_blocks": 2}
    else:
        net = _drawn(jbase.UnetGenerator)(ngf=8, num_downs=5, dtype=jnp.float32)
        monkeypatch.setattr(jbase, "UnetGenerator", lambda **_: net)
        to_port, shape = unet_generator_state_dict_from_jax, {"num_downs": 5}
    judge = jev.HPEJudge(jcpm.load_cpm_npz(weights.hpm2d),
                         jcpm.load_cpm_npz(weights.hpm3d))
    monkeypatch.setattr(jev.HPEJudge, "random_init",
                        classmethod(lambda cls, **_: judge))

    jax_script.main(ARGV + ["--arch", arch, "--eval_batch", "2",
                            "--inception_npz", weights.inception])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    pth = str(tmp_path / "port.pth")
    torch.save(to_port(type(net).drawn), pth)
    got = port_bench.bench(_config(tcfg, ARGV), arch, batch_size=2,
                           device="cpu", ckpt=pth,
                           inception_npz=weights.inception,
                           hpm2d_npz=weights.hpm2d, hpm3d_npz=weights.hpm3d,
                           **shape)
    assert want["arch"] == arch
    _assert_scores(got, want, extra_atol=5e-5)
    _assert_fid_inputs(fid_inputs)
    assert got["images"] == 4


def test_bench_baselines_cli_and_patn2(weights, fid_inputs, capsys):
    with pytest.warns(UserWarning, match="RANDOM generator"):
        scores = port_bench.main(ARGV + ["--arch", "resnet",
                                         "--eval_batch", "4", "--device", "cpu",
                                         "--no_pck", "--inception_npz",
                                         weights.inception])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed["arch"] == "resnet" and printed["images"] == 4
    assert "pck2d_auc" not in scores and np.isfinite(scores["fid"])
    with pytest.warns(UserWarning, match="RANDOM generator"):
        scores = port_bench.main(ARGV + ["--arch", "patn2", "--device", "cpu",
                                         "--eval_batch", "4", "--no_pck",
                                         "--inception_npz", weights.inception])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed["arch"] == "patn2" and printed["images"] == 4
    assert np.isfinite(scores["fid"]) and np.isfinite(scores["SSIM_avg"])


def test_baseline_checkpoints_load_in_reference_layout(tmp_path):
    """A port state_dict saved under the reference's wrapper keys
    (``model.`` around the Sequential; DataParallel's ``module.``) loads."""
    cfg = _config(tcfg, ARGV)
    for arch, kw in (("resnet", {"n_blocks": 2}), ("unet", {"num_downs": 5})):
        with pytest.warns(UserWarning, match="RANDOM generator"):
            net = port_bench.build_baseline(cfg, arch, "cpu", **kw)
        sd = net.state_dict()
        path = tmp_path / f"{arch}.pth"
        prefix = "module.model." if arch == "resnet" else "module."
        torch.save({prefix + k: v for k, v in sd.items()}, path)
        again = port_bench.build_baseline(cfg, arch, "cpu", ckpt=str(path), **kw)
        for k, v in again.state_dict().items():
            assert torch.equal(v, sd[k]), k
