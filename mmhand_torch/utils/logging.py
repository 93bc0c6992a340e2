"""Console and file logging in the reference's formats (counterpart of
mmhand_tpu/utils/logging.py).

* loss lines ``(epoch: E, iters: I, time: T) k1: v1 k2: v2 ...`` appended to
  ``checkpoints/<name>/loss_log.txt`` (reference util/visualizer.py:27-30,
  116-123);
* the options snapshot ``opt.txt`` (reference options/base_options.py:
  209-217);
* the live loss plot (reference visdom ``vis.line``, util/visualizer.py:
  100-113) as the serverless SVG/HTML pair of ``utils/liveplot.py``, when
  --display_id > 0 as in the reference;
* snapshots under ``web/images`` with an HTML gallery;
* a ``torch.profiler`` trace of one scope under ``<name>/trace``.

Only the master rank writes; on the others every method does nothing.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time


class Visualizer:
    def __init__(self, checkpoints_dir: str, name: str, *, master: bool = True):
        self.master = master
        self.dir = os.path.join(checkpoints_dir, name)
        if master:
            os.makedirs(self.dir, exist_ok=True)
            self.log_name = os.path.join(self.dir, "loss_log.txt")
            with open(self.log_name, "a") as f:
                f.write(f"================ Training Loss ({time.strftime('%c')}) ================\n")

    def save_options(self, cfg) -> None:
        """opt.txt snapshot (reference base_options.py:209-217)."""
        if not self.master:
            return
        lines = ["------------ Options -------------"]
        for section in dataclasses.fields(cfg):
            val = getattr(cfg, section.name)
            if dataclasses.is_dataclass(val):
                for f in dataclasses.fields(val):
                    lines.append(f"{section.name}.{f.name}: {getattr(val, f.name)}")
            else:
                lines.append(f"{section.name}: {val}")
        lines.append("-------------- End ----------------")
        with open(os.path.join(self.dir, "opt.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")

    def print_current_errors(self, epoch: int, iters: int, errors: dict,
                             t: float) -> None:
        """reference util/visualizer.py:116-123 format."""
        if not self.master:
            return
        message = f"(epoch: {epoch}, iters: {iters}, time: {t:.3f}) "
        for k, v in errors.items():
            message += f"{k}: {float(v):.3f} "
        print(message)
        with open(self.log_name, "a") as f:
            f.write(message + "\n")

    def plot_current_errors(self, epoch: int, counter_ratio: float,
                            errors: dict) -> None:
        """Live loss chart (reference plot_current_errors,
        util/visualizer.py:100-113): X = epoch + within-epoch ratio, one
        series per loss key, written as web/losses.{svg,html}."""
        if not self.master:
            return
        if not hasattr(self, "_plot"):
            from mmhand_torch.utils.liveplot import LossPlot
            self._plot = LossPlot(os.path.join(self.dir, "web"),
                                  title=os.path.basename(self.dir))
        self._plot.add(epoch + counter_ratio, errors)

    def save_image(self, image, name: str) -> None:
        """Save a uint8 snapshot into web/images and refresh the HTML gallery
        (reference util/visualizer.py:78-97)."""
        if not self.master:
            return
        import numpy as np
        from PIL import Image
        img_dir = os.path.join(self.dir, "web", "images")
        os.makedirs(img_dir, exist_ok=True)
        Image.fromarray(np.asarray(image)).save(os.path.join(img_dir, name))
        self._update_gallery()

    def _update_gallery(self) -> None:
        from mmhand_torch.utils.html import HTMLGallery
        web_dir = os.path.join(self.dir, "web")
        img_dir = os.path.join(web_dir, "images")
        gallery = HTMLGallery(web_dir, title=os.path.basename(self.dir))
        names = sorted(os.listdir(img_dir), reverse=True)
        for name in names:
            gallery.add_header(name)
            gallery.add_images([name], [name])
        gallery.save()

    @contextlib.contextmanager
    def profile(self, enable: bool = True, subdir: str = "trace"):
        """``profile_trace`` of the scope into ``<name>/<subdir>``."""
        if not (enable and self.master):
            yield
            return
        with profile_trace(os.path.join(self.dir, subdir)):
            yield


@contextlib.contextmanager
def profile_trace(trace_dir: str):
    """A torch.profiler trace of the scope, host and (with a card) device
    activity, written as ``<trace_dir>/trace.json`` (Chrome trace format)
    when the scope ends.  A failing profiler raises."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
