"""The generation slice end to end on the CPU, and the host modules under it.

mmhand_torch.scripts.aug and scripts/aug.py ``--torch_netG`` run the same
saved generator over the same synthetic split, both in float32; the two PNG
trees must agree to one uint8 level (f32 rounding can cross a truncation
boundary).  The host modules (config, dataset, loader, split, PNG codec,
checkpoints) are held against their mmhand_tpu twins exactly.
"""

import argparse
import dataclasses
import importlib
import os
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from mmhand_torch import config as tcfg
from mmhand_torch.data import annotations as tann
from mmhand_torch.data import datasets as tds
from mmhand_torch.data import loader as tloader
from mmhand_torch.models.layers import BatchNorm2d
from mmhand_torch.scripts import aug as port_aug
from mmhand_torch.train.state import build_generator
from mmhand_torch.utils import checkpoint as tckpt
from mmhand_torch.utils import png
from mmhand_tpu import config as jcfg
from mmhand_tpu.data import annotations as jann
from mmhand_tpu.data import datasets as jds
from mmhand_tpu.data import loader as jloader

REPO = Path(__file__).resolve().parent.parent

ARGV = ["--dataset", "synthetic", "--fineSize", "32", "--ngf", "8",
        "--max_dataset_size", "8", "--seed", "3", "--L1_type", "origin"]


def _config(module, argv, compute_dtype="float32"):
    parser = argparse.ArgumentParser()
    module.add_cli_args(parser)
    cfg = module.from_cli_args(parser.parse_args(argv),
                               module.Config(is_train=False))
    return cfg.replace(precision=module.PrecisionConfig(
        compute_dtype=compute_dtype))


def _saved_generator(cfg, tmp_path, seed=0):
    """A random-init port generator, saved under
    <tmp>/ckpt/run/latest_net_netG.pth.  Its running statistics are drawn on
    the scale of N(0, .02)-weight activations, so that eval-mode batch norm
    lifts them and the fakes are not one flat level."""
    g = build_generator(cfg, "cpu", seed=seed)
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for m in g.modules():
            if isinstance(m, BatchNorm2d):
                m.running_mean.copy_(torch.from_numpy(
                    rng.normal(0, 0.05, m.num_features).astype(np.float32)))
                m.running_var.copy_(torch.from_numpy(
                    rng.uniform(0.005, 0.05, m.num_features).astype(np.float32)))
    return tckpt.save_network(g, str(tmp_path / "ckpt"), "run")


def _jax_aug(monkeypatch):
    """scripts/aug.py, imported as tests/test_interchange.py does.  Its
    import-time setup_runtime() would switch the process to the 'rbg' PRNG,
    which later tests in the same worker do not expect: keep threefry."""
    monkeypatch.setenv("MMHAND_STRICT_PRNG", "1")
    monkeypatch.syspath_prepend(str(REPO / "scripts"))
    return importlib.import_module("aug")


def _png_tree(root):
    return sorted(str(p.relative_to(root)) for p in Path(root).rglob("*.png"))


def test_aug_slice_matches_jax_aug(tmp_path, monkeypatch):
    jax_aug = _jax_aug(monkeypatch)
    port_cfg = _config(tcfg, ARGV + ["--checkpoints_dir",
                                     str(tmp_path / "ckpt"), "--name", "run"])
    jax_cfg = _config(jcfg, ARGV)
    pth = _saved_generator(port_cfg, tmp_path)

    n_port = port_aug.generate(port_cfg, str(tmp_path / "port"), batch_size=4,
                               device="cpu")
    n_jax = jax_aug.generate(jax_cfg, str(tmp_path / "jax"), batch_size=4,
                             torch_netG=pth)
    assert n_port == n_jax == 8
    tree = _png_tree(tmp_path / "port")
    assert tree == _png_tree(tmp_path / "jax")
    assert tree == [f"tgt/{i:05d}.png" for i in range(8)]
    spread = 0
    for rel in tree:
        a = np.asarray(Image.open(tmp_path / "port" / rel)).astype(int)
        b = np.asarray(Image.open(tmp_path / "jax" / rel)).astype(int)
        assert a.shape == (32, 32, 3)
        assert np.abs(a - b).max() <= 1, rel
        spread = max(spread, int(a.max() - a.min()))
    assert spread >= 64  # the fakes carry a signal, not one flat level


def test_aug_main_cli_on_cpu(tmp_path, capsys):
    """The CLI with its default bf16 autocast, from --torch_netG."""
    cfg = _config(tcfg, ARGV)
    pth = _saved_generator(cfg, tmp_path, seed=1)
    written = port_aug.main(ARGV + ["--dst", str(tmp_path / "out"),
                                    "--gen_batch", "3", "--device", "cpu",
                                    "--torch_netG", pth])
    assert written == 8
    assert len(_png_tree(tmp_path / "out")) == 8
    assert "images/s after the first batch" in capsys.readouterr().out


def test_generate_never_falls_back_to_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = _config(tcfg, ARGV)
    with pytest.raises(RuntimeError, match="cuda"):
        port_aug.generate(cfg, str(tmp_path / "out"), device="cuda",
                          state_dict={})


def test_config_matches_jax():
    argv = ARGV + ["--batchSize", "5", "--no_dropout", "--serial_batches",
                   "--norm", "instance", "--percep_is_l1", "0", "--no_lsgan"]
    port = dataclasses.asdict(_config(tcfg, argv))
    want = dataclasses.asdict(_config(jcfg, argv))
    assert port == want


def test_synthetic_dataset_and_loader_match_jax():
    port_cfg, jax_cfg = _config(tcfg, ARGV), _config(jcfg, ARGV)
    a, b = tds.build_dataset(port_cfg), jds.build_dataset(jax_cfg)
    for x, y in zip(a.load_pair(5), b.load_pair(5)):
        for field in ("image", "depth", "uv", "z", "path"):
            np.testing.assert_array_equal(getattr(x, field), getattr(y, field))
    la = tloader.HostLoader(a, 3, seed=3, max_items=8, drop_last=False)
    lb = jloader.HostLoader(b, 3, seed=3, max_items=8, drop_last=False)
    batches_a, batches_b = list(la.epoch(1)), list(lb.epoch(1))
    assert len(batches_a) == len(batches_b) == 3
    for ra, rb in zip(batches_a, batches_b):
        assert ra.keys() == rb.keys()
        for k in ra:
            np.testing.assert_array_equal(np.asarray(ra[k]), np.asarray(rb[k]))


@pytest.mark.parametrize("is_train,root", [(True, "rhd"), (False, "rhd"),
                                           (False, "rhd_test")])
def test_split_src_tgt_matches_jax(is_train, root):
    data = [f"/d/{root}/color/{i}.png" for i in range(10)]
    got = tann.split_src_tgt(data, 0.7, is_train=is_train,
                             root_dir=f"/d/{root}",
                             rng=np.random.default_rng(4))
    want = jann.split_src_tgt(data, 0.7, is_train=is_train,
                              root_dir=f"/d/{root}",
                              rng=np.random.default_rng(4))
    assert got == want


def test_png_codec(tmp_path):
    img = np.random.RandomState(9).randint(0, 256, (5, 7, 3)).astype(np.uint8)
    path = str(tmp_path / "x.png")
    png.write_png(path, img)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
    np.testing.assert_array_equal(png.read_png(path), img)
    with pytest.raises(ValueError):
        png.encode_png(img.astype(np.float32))


def test_checkpoint_naming_and_prefixes(tmp_path):
    assert tckpt.network_path("ck", "run", "7") == os.path.join(
        "ck", "run", "7_net_netG.pth")
    path = tmp_path / "ref.pth"
    torch.save({"module.model.stream1_down.1.weight": torch.ones(2)}, path)
    assert list(tckpt.load_state_dict(str(path))) == ["stream1_down.1.weight"]
    assert tckpt.network_path("ck", "run", "latest", "netD_PB") == os.path.join(
        "ck", "run", "latest_net_netD_PB.pth")
    np.savez(tmp_path / "ref.npz", **{"model.att.0.x": np.zeros(3, np.float32)})
    assert list(tckpt.load_state_dict(str(tmp_path / "ref.npz"))) == ["att.0.x"]
