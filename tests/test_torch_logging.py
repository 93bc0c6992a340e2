"""mmhand_torch's Visualizer, snapshot strip, live plot and gallery against
mmhand_tpu's: the same inputs give the same bytes on disk and on the
console.  Then the train loop's use of them on the CPU at toy size."""

import json

import numpy as np
import pytest

from mmhand_torch import config as tcfg
from mmhand_torch.train.loop import train
from mmhand_torch.utils import html as thtml
from mmhand_torch.utils import liveplot as tplot
from mmhand_torch.utils import logging as tlog
from mmhand_torch.utils import visualize as tvis
from mmhand_tpu.utils import html as jhtml
from mmhand_tpu.utils import liveplot as jplot
from mmhand_tpu.utils import logging as jlog
from mmhand_tpu.utils import visualize as jvis

ERRORS = [{"pair_L1loss": 8.5199, "pair_GANloss": 4.1052, "origin_L1": 5.3771,
           "perceptual": 3.1436, "D_PP": 5.1591, "D_PB": 5.1083},
          {"pair_L1loss": 1.0e-4, "pair_GANloss": -0.0004, "origin_L1": 123.456,
           "perceptual": 0.0, "D_PP": float("nan"), "D_PB": 7.0}]


def _files(root):
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.fixture
def fixed_clock(monkeypatch):
    """The loss log's header carries time.strftime('%c'): one value for
    both packages."""
    monkeypatch.setattr("time.strftime", lambda fmt, *a: "Fri Oct 16 2026")


def test_loss_lines_and_log_match_jax(tmp_path, capsys, fixed_clock):
    printed = {}
    for name, module in (("jax", jlog), ("port", tlog)):
        vis = module.Visualizer(str(tmp_path / name), "run")
        for i, errors in enumerate(ERRORS):
            vis.print_current_errors(1 + i, 100 * (i + 1), errors, 0.0123)
        printed[name] = capsys.readouterr().out
    assert printed["port"] == printed["jax"]
    assert printed["port"].count("(epoch: ") == 2
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    log = (tmp_path / "port" / "run" / "loss_log.txt").read_text()
    assert log.startswith("================ Training Loss (Fri Oct 16 2026)")


def test_options_snapshot_matches_jax(tmp_path):
    cfg = tcfg.Config(run=tcfg.RunConfig(name="opts", continue_train=True))
    for name, module in (("jax", jlog), ("port", tlog)):
        module.Visualizer(str(tmp_path / name), "run").save_options(cfg)
    got = (tmp_path / "port" / "run" / "opt.txt").read_text()
    assert got == (tmp_path / "jax" / "run" / "opt.txt").read_text()
    assert "run.continue_train: True" in got


def _heatmaps(seed, batch=1, size=32, faint=()):
    r = np.random.RandomState(seed)
    uv = r.uniform(2, size - 3, (batch, 21, 2))
    ys, xs = np.mgrid[:size, :size]
    d2 = ((xs[None, :, :, None] - uv[:, None, None, :, 0]) ** 2
          + (ys[None, :, :, None] - uv[:, None, None, :, 1]) ** 2)
    hm = np.exp(-d2 / 18.0).astype(np.float32)
    hm[..., list(faint)] *= 0.05  # peaks below the 0.1 threshold
    return hm


@pytest.mark.parametrize("faint", [(), (0, 4, 13, 20)])
def test_draw_pose_from_map_matches_jax(faint):
    hm = _heatmaps(3, faint=faint)
    got = tvis.draw_pose_from_map(hm)
    np.testing.assert_array_equal(got, jvis.draw_pose_from_map(hm))
    assert got.shape == (32, 32, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(tvis.map_to_cords(hm),
                                  jvis.map_to_cords(hm))


def test_seven_tile_strip_matches_jax():
    r = np.random.RandomState(5)
    img = lambda: r.uniform(-1.2, 1.2, (2, 32, 32, 3)).astype(np.float32)
    args = (img(), _heatmaps(6, 2), img(), img(), _heatmaps(7, 2), img(),
            img())
    got = tvis.seven_tile_strip(*args)
    np.testing.assert_array_equal(got, jvis.seven_tile_strip(*args))
    assert got.shape == (32, 7 * 32, 3)


def test_loss_plot_files_match_jax(tmp_path):
    for name, module in (("jax", jplot), ("port", tplot)):
        plot = module.LossPlot(str(tmp_path / name / "web"), title="run")
        for i, errors in enumerate(ERRORS * 3):
            plot.add(1 + i / 4, errors)
        # a restart reloads the curve and continues it
        plot = module.LossPlot(str(tmp_path / name / "web"), title="run")
        plot.add(3.0, ERRORS[0])
    got = _files(tmp_path / "port")
    assert set(got) == {"web/losses.svg", "web/losses.html",
                        "web/plot_data.json"}
    assert got == _files(tmp_path / "jax")
    assert len(json.loads(got["web/plot_data.json"])["X"]) == 7


def test_html_gallery_matches_jax(tmp_path):
    for name, module in (("jax", jhtml), ("port", thtml)):
        gallery = module.HTMLGallery(str(tmp_path / name), title="a <run>")
        gallery.add_header("epoch 1 & 2")
        gallery.add_images(["a.png", "b.png"], ["fake", "<real>"], width=256)
        gallery.save()
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")


def test_saved_image_and_gallery_match_jax(tmp_path, fixed_clock):
    strip = (np.random.RandomState(8).uniform(0, 255, (32, 224, 3))
             .astype(np.uint8))
    for name, module in (("jax", jlog), ("port", tlog)):
        vis = module.Visualizer(str(tmp_path / name), "run")
        vis.save_image(strip, "epoch001_step5.png")
        vis.save_image(strip[:, ::-1].copy(), "epoch002_step9.png")
    got = _files(tmp_path / "port")
    assert {"run/web/images/epoch001_step5.png", "run/web/index.html"} <= set(got)
    assert got == _files(tmp_path / "jax")


def test_rank_other_than_master_writes_nothing(tmp_path, capsys):
    vis = tlog.Visualizer(str(tmp_path), "run", master=False)
    vis.save_options(tcfg.Config())
    vis.print_current_errors(1, 1, ERRORS[0], 0.1)
    vis.plot_current_errors(1, 0.5, ERRORS[0])
    vis.save_image(np.zeros((4, 4, 3), np.uint8), "x.png")
    with vis.profile():
        pass
    assert not tmp_path.joinpath("run").exists()
    assert capsys.readouterr().out == ""


def _toy_config(tmp_path, **run):
    return tcfg.Config(
        model=tcfg.ModelConfig(fine_size=32, ngf=8, ndf=8, g_n_blocks=1,
                               n_layers_d=1),
        loss=tcfg.LossConfig(l1_type="origin"),
        optim=tcfg.OptimConfig(pool_size=2),
        data=tcfg.DataConfig(dataset="synthetic", batch_size=2,
                             max_dataset_size=8),
        precision=tcfg.PrecisionConfig(compute_dtype="float32"),
        run=tcfg.RunConfig(checkpoints_dir=str(tmp_path), name="vis", **run))


def test_train_writes_log_plot_and_snapshots(tmp_path, capsys):
    """print_freq 1 with display_id 1: a loss line per step in the console
    and loss_log.txt, the live plot; display_freq 2: snapshots at steps 2
    and 4, each a 7-tile strip, and their gallery."""
    result = train(_toy_config(tmp_path, print_freq=1, display_id=1,
                               display_freq=2),
                   device="cpu", max_steps=4)
    assert result.steps == 4
    out = capsys.readouterr().out
    run = tmp_path / "vis"
    log = (run / "loss_log.txt").read_text().splitlines()
    lines = [ln for ln in log if ln.startswith("(epoch: ")]
    assert len(lines) == 4 and out.count("(epoch: 1, iters: ") == 4
    assert all(ln in out for ln in lines)
    assert "model.ngf: 8" in (run / "opt.txt").read_text()
    names = sorted(p.name for p in (run / "web" / "images").iterdir())
    assert names == ["epoch001_step2.png", "epoch001_step4.png"]
    from PIL import Image
    with Image.open(run / "web" / "images" / names[0]) as im:
        assert im.size == (7 * 32, 32)
    assert "epoch001_step4.png" in (run / "web" / "index.html").read_text()
    data = json.loads((run / "web" / "plot_data.json").read_text())
    assert len(data["X"]) == 4 and data["legend"][0] == "pair_L1loss"


def test_profile_writes_a_trace(tmp_path):
    vis = tlog.Visualizer(str(tmp_path), "run")
    with vis.profile():
        import torch
        torch.ones(8).sum()
    trace = json.loads((tmp_path / "run" / "trace" / "trace.json").read_text())
    assert trace["traceEvents"]
