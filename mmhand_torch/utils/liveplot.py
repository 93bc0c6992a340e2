"""Live loss plotting without a server: SVG line chart + auto-refresh HTML
(counterpart of mmhand_tpu/utils/liveplot.py, the same files byte for byte).

Replaces the reference's visdom `vis.line` live plot (reference
util/visualizer.py:100-113, gated by --display_id>0), which needs a running
server.  The plot is a self-contained artifact tree under
`checkpoints/<name>/web/`:

* ``losses.svg`` — the multi-series line chart, regenerated per update;
* ``losses.html`` — wraps the SVG with ``<meta http-equiv=refresh>`` so an
  open browser tab live-updates like a visdom window (serve the directory
  with ``python -m http.server`` or open the file directly);
* ``plot_data.json`` — the accumulated (X, Y, legend) series, reloaded on
  resume so the curve continues across restarts (the reference's visdom
  plot resets on every relaunch).

Pure stdlib: no matplotlib in the hot path, safe on headless hosts.
"""

from __future__ import annotations

import json
import math
import os

# categorical series colors (Okabe-Ito, colorblind-safe)
COLORS = ["#0072B2", "#E69F00", "#009E73", "#D55E00",
          "#CC79A7", "#56B4E9", "#F0E442", "#000000"]


def _ticks(lo: float, hi: float, n: int = 5):
    """~n round tick positions covering [lo, hi]."""
    if not math.isfinite(lo) or not math.isfinite(hi):
        return [0.0, 1.0]
    if hi <= lo:
        hi = lo + 1.0
    raw = (hi - lo) / n
    mag = 10.0 ** math.floor(math.log10(raw))
    step = min(s * mag for s in (1, 2, 5, 10) if s * mag >= raw)
    t0 = math.floor(lo / step) * step
    out = []
    t = t0
    while t <= hi + step * 1e-9:
        out.append(round(t, 10))
        t += step
    return out


def _fmt(v: float) -> str:
    if v == 0:
        return "0"
    if abs(v) >= 1000 or abs(v) < 0.01:
        return f"{v:.1e}"
    return f"{v:g}"


def render_svg(xs, ys, legend, title="loss over time",
               width=760, height=420) -> str:
    """Multi-series line chart.  xs: [N] floats; ys: [N][K] floats
    (NaN/None = gap); legend: [K] series names."""
    ml, mr, mt, mb = 56, 150, 34, 40  # margins (legend lives right)
    pw, ph = width - ml - mr, height - mt - mb

    flat = [v for row in ys for v in row
            if v is not None and math.isfinite(v)]
    x_lo, x_hi = (min(xs), max(xs)) if xs else (0.0, 1.0)
    y_lo, y_hi = (min(flat), max(flat)) if flat else (0.0, 1.0)
    if x_hi <= x_lo:
        x_hi = x_lo + 1.0
    if y_hi <= y_lo:
        y_hi = y_lo + 1.0
    pad = 0.05 * (y_hi - y_lo)
    y_lo, y_hi = y_lo - pad, y_hi + pad

    def sx(x):
        return ml + (x - x_lo) / (x_hi - x_lo) * pw

    def sy(y):
        return mt + ph - (y - y_lo) / (y_hi - y_lo) * ph

    parts = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
        f'height="{height}" font-family="sans-serif" font-size="12">',
        f'<rect width="{width}" height="{height}" fill="white"/>',
        f'<text x="{ml + pw / 2}" y="20" text-anchor="middle" '
        f'font-size="14">{title}</text>',
    ]
    # gridlines + axis labels
    for t in _ticks(y_lo, y_hi):
        if y_lo <= t <= y_hi:
            y = sy(t)
            parts.append(f'<line x1="{ml}" y1="{y:.1f}" x2="{ml + pw}" '
                         f'y2="{y:.1f}" stroke="#ddd"/>')
            parts.append(f'<text x="{ml - 6}" y="{y + 4:.1f}" '
                         f'text-anchor="end">{_fmt(t)}</text>')
    for t in _ticks(x_lo, x_hi):
        if x_lo <= t <= x_hi:
            x = sx(t)
            parts.append(f'<line x1="{x:.1f}" y1="{mt}" x2="{x:.1f}" '
                         f'y2="{mt + ph}" stroke="#eee"/>')
            parts.append(f'<text x="{x:.1f}" y="{mt + ph + 16}" '
                         f'text-anchor="middle">{_fmt(t)}</text>')
    parts.append(f'<text x="{ml + pw / 2}" y="{height - 6}" '
                 f'text-anchor="middle">epoch</text>')
    parts.append(f'<rect x="{ml}" y="{mt}" width="{pw}" height="{ph}" '
                 f'fill="none" stroke="#888"/>')

    for k, name in enumerate(legend):
        color = COLORS[k % len(COLORS)]
        pts = []
        segs = []
        for x, row in zip(xs, ys):
            v = row[k] if k < len(row) else None
            if v is None or not math.isfinite(v):
                if pts:
                    segs.append(pts)
                pts = []
            else:
                pts.append(f"{sx(x):.1f},{sy(v):.1f}")
        if pts:
            segs.append(pts)
        for seg in segs:
            if len(seg) == 1:
                cx, cy = seg[0].split(",")
                parts.append(f'<circle cx="{cx}" cy="{cy}" r="2" '
                             f'fill="{color}"/>')
            else:
                parts.append(f'<polyline points="{" ".join(seg)}" '
                             f'fill="none" stroke="{color}" '
                             f'stroke-width="1.5"/>')
        ly = mt + 14 + 18 * k
        lx = ml + pw + 12
        parts.append(f'<line x1="{lx}" y1="{ly - 4}" x2="{lx + 18}" '
                     f'y2="{ly - 4}" stroke="{color}" stroke-width="3"/>')
        parts.append(f'<text x="{lx + 24}" y="{ly}">{name}</text>')
    parts.append("</svg>")
    return "\n".join(parts)


class LossPlot:
    """Accumulates (epoch+ratio, errors) points and regenerates the SVG +
    refresh-HTML pair; series set is fixed at the first call (reference
    plot_data['legend'] semantics, util/visualizer.py:101-104)."""

    def __init__(self, web_dir: str, title: str, refresh_s: int = 5):
        self.web_dir = web_dir
        self.title = title
        self.refresh_s = refresh_s
        self.data_path = os.path.join(web_dir, "plot_data.json")
        self.xs: list = []
        self.ys: list = []
        self.legend: list = []
        if os.path.exists(self.data_path):  # resume the curve
            try:
                with open(self.data_path) as f:
                    d = json.load(f)
                self.xs, self.ys = d["X"], d["Y"]
                self.legend = d["legend"]
            except (json.JSONDecodeError, KeyError, OSError):
                pass

    def add(self, x: float, errors: dict) -> None:
        if not self.legend:
            self.legend = list(errors.keys())
        self.xs.append(float(x))
        self.ys.append([float(errors.get(k, float("nan")))
                        for k in self.legend])
        self._write()

    def _write(self) -> None:
        os.makedirs(self.web_dir, exist_ok=True)
        svg = render_svg(self.xs, self.ys, self.legend,
                         title=f"{self.title} loss over time")
        with open(os.path.join(self.web_dir, "losses.svg"), "w") as f:
            f.write(svg)
        html = (
            "<!DOCTYPE html><html><head>"
            f'<meta http-equiv="refresh" content="{self.refresh_s}">'
            f"<title>{self.title} losses</title></head>"
            f'<body style="margin:0">{svg}</body></html>')
        with open(os.path.join(self.web_dir, "losses.html"), "w") as f:
            f.write(html)
        # whole or not at all: a run killed mid-write resumes its curve
        with open(f"{self.data_path}.tmp", "w") as f:
            json.dump({"X": self.xs, "Y": self.ys, "legend": self.legend}, f)
        os.replace(f"{self.data_path}.tmp", self.data_path)
