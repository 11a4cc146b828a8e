"""Weight/activation plotting and filter rendering.

Reference parity: ``plot/NeuralNetPlotter.java:46`` (plotActivations:235 —
writes matrices to temp CSVs then shells out to
``resources/scripts/plot.py``/``render.py`` matplotlib subprocesses) and
``plot/FilterRenderer.java`` (PNG grids of first-layer filters).

Here matplotlib is called in-process with the Agg backend (no subprocess,
no display); every function degrades to writing the raw arrays as .npy
next to the requested path if matplotlib is unavailable.

Port of ``deeplearning4j_tpu/plot/plotter.py``: the histograms, filter grids and pages of the
reference; it reads the port's ``MultiLayerNetwork`` (tensors on any
device come to the host once) and ``runtime/metrics.ScalarsLogger``.
"""

from __future__ import annotations

import logging
import math
import os
from typing import Dict, Optional, Sequence

import numpy as np

log = logging.getLogger(__name__)


def _host(a) -> np.ndarray:
    """A tensor on any device (or an array) as a host numpy array."""
    if hasattr(a, "detach"):
        return a.detach().float().cpu().numpy()
    return np.asarray(a)


def _mpl():
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        return plt
    except Exception:  # matplotlib is optional: the writers fall back
        return None


class NeuralNetPlotter:
    """Histograms of weights/gradients/activations per layer."""

    def plot_network_gradient(self, net, path: str) -> str:
        """Panel of per-layer weight + bias histograms (plotWeights
        equivalent).  ``net`` is a MultiLayerNetwork with params set."""
        params = net._require_params()
        panels: Dict[str, np.ndarray] = {}
        for i, layer_params in enumerate(params):
            for name, arr in layer_params.items():
                panels[f"layer{i}/{name}"] = _host(arr).ravel()
        return self.histograms(panels, path)

    def plot_activations(self, net, x, path: str) -> str:
        """Histogram of each layer's activations on a batch
        (plotActivations:235 equivalent)."""
        import torch

        params = net._require_params()
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.asarray(x, np.float32))
        x = x.to(net.device)
        with torch.no_grad():
            acts = net.feed_forward(params, x)
        panels = {f"layer{i}": _host(a).ravel()
                  for i, a in enumerate(acts[1:])}
        return self.histograms(panels, path)

    def histograms(self, panels: Dict[str, np.ndarray], path: str) -> str:
        plt = _mpl()
        if plt is None:  # pragma: no cover
            alt = path + ".npz"
            np.savez(alt, **panels)
            return alt
        n = max(len(panels), 1)
        cols = min(n, 3)
        rows = math.ceil(n / cols)
        fig, axes = plt.subplots(rows, cols, figsize=(4 * cols, 3 * rows),
                                 squeeze=False)
        for ax in axes.ravel():
            ax.axis("off")
        for ax, (name, vals) in zip(axes.ravel(), panels.items()):
            ax.axis("on")
            ax.hist(vals, bins=50)
            ax.set_title(name, fontsize=8)
        fig.tight_layout()
        fig.savefig(path)
        plt.close(fig)
        return path


class FilterRenderer:
    """PNG grid of filters (FilterRenderer.java parity): each row of W
    (or conv kernel) rendered as a small image tile."""

    def render_filters(self, weights, path: str,
                       patch_shape: Optional[tuple] = None,
                       max_filters: int = 100) -> str:
        w = _host(weights)
        if w.ndim == 4:                       # conv [kh, kw, cin, cout]
            kh, kw, cin, cout = w.shape
            tiles = [w[:, :, 0, i] for i in range(min(cout, max_filters))]
        else:                                 # dense [n_in, n_out]
            n_in, n_out = w.shape
            if patch_shape is None:
                side = int(round(math.sqrt(n_in)))
                if side * side != n_in:
                    raise ValueError(
                        f"n_in={n_in} is not square; pass patch_shape")
                patch_shape = (side, side)
            tiles = [w[:, i].reshape(patch_shape)
                     for i in range(min(n_out, max_filters))]

        n = len(tiles)
        cols = int(math.ceil(math.sqrt(n)))
        rows = int(math.ceil(n / cols))
        th, tw = tiles[0].shape
        grid = np.zeros((rows * (th + 1) - 1, cols * (tw + 1) - 1))
        for i, t in enumerate(tiles):
            r, c = divmod(i, cols)
            lo, hi = t.min(), t.max()
            norm = (t - lo) / (hi - lo) if hi > lo else t * 0
            grid[r * (th + 1):r * (th + 1) + th,
                 c * (tw + 1):c * (tw + 1) + tw] = norm

        plt = _mpl()
        if plt is None:  # pragma: no cover
            alt = path + ".npy"
            np.save(alt, grid)
            return alt
        fig, ax = plt.subplots(figsize=(cols, rows))
        ax.imshow(grid, cmap="gray")
        ax.axis("off")
        fig.savefig(path, bbox_inches="tight", dpi=120)
        plt.close(fig)
        return path


def render_embedding_html(words: Sequence[str], coords_2d,
                          path: str, title: str = "embeddings") -> str:
    """Standalone-HTML scatter of 2-D embeddings (t-SNE output) — the
    file-based replacement for the reference's Dropwizard render webapp
    (nlp/.../plot/dropwizard/RenderApplication.java + render.ftl): open the
    file in a browser, no server process."""
    pts = _host(coords_2d).astype(float)
    if pts.shape[0] != len(words) or pts.shape[1] != 2:
        raise ValueError(f"need [{len(words)}, 2] coords, got {pts.shape}")
    data = [{"w": w, "x": float(x), "y": float(y)}
            for w, (x, y) in zip(words, pts)]
    import json as _json
    html = f"""<!doctype html><html><head><meta charset="utf-8">
<title>{title}</title></head><body>
<h3>{title}</h3><svg id="plot" width="900" height="700"
 style="border:1px solid #ccc"></svg>
<script>
const data = {_json.dumps(data)};
const svg = document.getElementById('plot');
const xs = data.map(d=>d.x), ys = data.map(d=>d.y);
const minx=Math.min(...xs), maxx=Math.max(...xs);
const miny=Math.min(...ys), maxy=Math.max(...ys);
const sx = x => 40 + (x-minx)/(maxx-minx||1)*820;
const sy = y => 660 - (y-miny)/(maxy-miny||1)*620;
for (const d of data) {{
  const c = document.createElementNS('http://www.w3.org/2000/svg','circle');
  c.setAttribute('cx', sx(d.x)); c.setAttribute('cy', sy(d.y));
  c.setAttribute('r', 3); c.setAttribute('fill', '#4878d0');
  svg.appendChild(c);
  const t = document.createElementNS('http://www.w3.org/2000/svg','text');
  t.setAttribute('x', sx(d.x)+4); t.setAttribute('y', sy(d.y)-4);
  t.setAttribute('font-size', '9'); t.textContent = d.w;
  svg.appendChild(t);
}}
</script></body></html>"""
    with open(path, "w") as fh:
        fh.write(html)
    return path


def render_scalars_html(scalars_path: str, path: str,
                        title: str = "training scalars") -> str:
    """Line charts from a runtime/metrics.ScalarsLogger JSONL file — the
    scalars-dashboard half of the render webapp."""
    from deeplearning4j_tpu_torch.runtime.metrics import ScalarsLogger

    rows = ScalarsLogger.read(scalars_path)
    keys = sorted({k for r in rows for k in r if k != "step"})
    plt = _mpl()
    if plt is None:  # pragma: no cover
        raise RuntimeError("matplotlib unavailable")
    n = max(len(keys), 1)
    fig, axes = plt.subplots(n, 1, figsize=(8, 3 * n), squeeze=False)
    for ax, k in zip(axes.ravel(), keys):
        steps = [r["step"] for r in rows if k in r]
        vals = [r[k] for r in rows if k in r]
        ax.plot(steps, vals)
        ax.set_title(k, fontsize=9)
        ax.set_xlabel("step")
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
    return path
