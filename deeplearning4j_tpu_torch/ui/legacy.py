"""Legacy visualization listeners (port of ``deeplearning4j_tpu/ui/
legacy.py``).

The equivalents of the reference's ``deeplearning4j-ui`` module (the
pre-Play, Dropwizard-era listeners):

- :class:`HistogramIterationListener` samples the score and per-parameter
  weight and update histograms every N iterations and renders them to a
  self-contained HTML report built from :mod:`.components`.
- :class:`ConvolutionalIterationListener` runs a probe batch through the
  network every N iterations and writes every convolutional activation
  map of its first example as a channel-grid PNG.

Both work on the host: the histogram listener reads ``param_table()``
(float32 numpy) and the convolutional listener copies each 4-D
``feed_forward`` output of the probe's first example to the host once.
The PNG writer and the grid are the JAX package's byte for byte.

Difference from the JAX package: under ``mixed_bf16`` the JAX
``param_table`` hands bfloat16 arrays, whose ``np.histogram`` computes its
bin edges and bin indices in bfloat16; the port's ``param_table`` hands
the same values as float32, and its histograms are float32 ones of them
(``tests/test_torch_ui_components.py`` pins the difference).
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..optimize.listeners.listeners import IterationListener
from . import components as comp


# ------------------------------------------------------------- PNG writing
def write_png_gray(arr: np.ndarray, path: str) -> str:
    """Write a (H, W) uint8 array as a grayscale PNG using stdlib only."""
    if arr.ndim != 2:
        raise ValueError(f"expected 2-D image, got shape {arr.shape}")
    arr = np.ascontiguousarray(arr, np.uint8)
    h, w = arr.shape

    def chunk(tag: bytes, data: bytes) -> bytes:
        body = tag + data
        return struct.pack(">I", len(data)) + body \
            + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)  # 8-bit grayscale
    raw = b"".join(b"\x00" + arr[i].tobytes() for i in range(h))
    png = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
           + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)
    return path


def activation_grid(act: np.ndarray, pad: int = 1) -> np.ndarray:
    """Tile a (H, W, C) activation map into one (rows*H, cols*W) uint8
    grid, per-channel min-max normalized (the reference's conv-activation
    grid rendering)."""
    if act.ndim != 3:
        raise ValueError(f"expected (H, W, C) activations, got {act.shape}")
    H, W, C = act.shape
    cols = int(np.ceil(np.sqrt(C)))
    rows = int(np.ceil(C / cols))
    grid = np.zeros((rows * (H + pad) - pad, cols * (W + pad) - pad),
                    np.uint8)
    for c in range(C):
        a = act[:, :, c].astype(np.float64)
        lo, hi = a.min(), a.max()
        img = np.zeros_like(a) if hi <= lo else (a - lo) / (hi - lo)
        r, col = divmod(c, cols)
        grid[r * (H + pad):r * (H + pad) + H,
             col * (W + pad):col * (W + pad) + W] = (img * 255).astype(
                 np.uint8)
    return grid


def host_map(act: torch.Tensor) -> np.ndarray:
    """One activation map on the host as a numpy array (float32 where the
    network computed below it)."""
    act = act.detach()
    if act.dtype in (torch.bfloat16, torch.float16):
        act = act.float()
    return act.cpu().numpy()


# --------------------------------------------------------------- listeners
class HistogramIterationListener(IterationListener):
    """Score + parameter/update histograms -> HTML report (reference
    ``deeplearning4j-ui/.../HistogramIterationListener.java``)."""

    def __init__(self, frequency: int = 10, bins: int = 20,
                 output_file: Optional[str] = None):
        self.frequency = max(1, frequency)
        self.bins = bins
        self.output_file = output_file
        self.scores: List[Tuple[int, float]] = []
        # name -> (iteration, bin_edges, counts)
        self.histograms: Dict[str, Tuple[int, np.ndarray, np.ndarray]] = {}
        self.update_histograms: Dict[
            str, Tuple[int, np.ndarray, np.ndarray]] = {}
        self._last_params: Optional[Dict[str, np.ndarray]] = None

    def iteration_done(self, model, iteration: int) -> None:
        if iteration % self.frequency != 0:
            return
        self.scores.append((iteration, float(model.score())))
        tables = model.param_table() if hasattr(model, "param_table") else {}
        prev = self._last_params or {}
        for name, arr in tables.items():
            counts, edges = np.histogram(arr, bins=self.bins)
            self.histograms[name] = (iteration, edges, counts)
            if name in prev:
                upd = arr - prev[name]
                ucounts, uedges = np.histogram(upd, bins=self.bins)
                self.update_histograms[name] = (iteration, uedges, ucounts)
        self._last_params = {k: np.array(v) for k, v in tables.items()}
        if self.output_file:
            self.render(self.output_file)

    # ---- rendering -------------------------------------------------------
    def _hist_chart(self, title: str,
                    entry: Tuple[int, np.ndarray, np.ndarray]
                    ) -> comp.ChartHistogram:
        it, edges, counts = entry
        chart = comp.ChartHistogram(f"{title} (iter {it})")
        for i, n in enumerate(counts):
            chart.add_bin(edges[i], edges[i + 1], float(n))
        return chart

    def components(self) -> List[comp.Component]:
        out: List[comp.Component] = []
        if self.scores:
            line = comp.ChartLine("Score vs iteration")
            line.add_series("score", [s[0] for s in self.scores],
                            [s[1] for s in self.scores])
            out.append(line)
        for name, entry in sorted(self.histograms.items()):
            out.append(self._hist_chart(f"param {name}", entry))
        for name, entry in sorted(self.update_histograms.items()):
            out.append(self._hist_chart(f"update {name}", entry))
        return out

    def render(self, path: str) -> str:
        return comp.render_to_file(self.components(), path,
                                   title="Histogram listener")


class ConvolutionalIterationListener(IterationListener):
    """Conv activation grids -> PNG files (reference
    ``deeplearning4j-ui/.../ConvolutionalIterationListener.java``).

    ``probe`` is a fixed input batch; every N iterations the network's
    activations are computed (``feed_forward``), the first probe example
    of every 4-D activation (batch, H, W, C) is copied to the host and
    tiled into a channel grid, and written as
    ``{output_dir}/conv_layer{i}_iter{n}.png``."""

    def __init__(self, probe, frequency: int = 25,
                 output_dir: str = "conv_activations"):
        self.probe = probe
        self.frequency = max(1, frequency)
        self.output_dir = output_dir
        self.written: List[str] = []

    def iteration_done(self, model, iteration: int) -> None:
        if iteration % self.frequency != 0:
            return
        if not hasattr(model, "feed_forward"):
            return
        os.makedirs(self.output_dir, exist_ok=True)
        acts = model.feed_forward(self.probe)
        for i, act in enumerate(acts):
            if act.ndim != 4:      # only conv-shaped (batch, H, W, C) maps
                continue
            grid = activation_grid(host_map(act[0]))
            path = os.path.join(self.output_dir,
                                f"conv_layer{i}_iter{iteration}.png")
            self.written.append(write_png_gray(grid, path))
