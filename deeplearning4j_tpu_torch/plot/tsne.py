"""t-SNE embedding on the device (port of ``deeplearning4j_tpu/plot/tsne.py``;
van der Maaten & Hinton 2008).

Reference: ``deeplearning4j-core/.../plot/BarnesHutTsne.java:848``: the
Builder surface (perplexity, theta, learningRate, maxIter, the momentum
switch, early exaggeration), the per-point sigma search to the target
perplexity (``computeGaussianPerplexity``), the gradient loop with
momentum and per-dimension gains, and ``saveCoordinates``.

Two paths, as in the JAX package, each a loop of torch ops on the device:

- **exact** (``n <= tile_threshold``, :func:`tsne_exact`): the (N, N)
  affinities, the exact KL gradient (``theta`` is accepted for the
  surface only);
- **tiled** (:func:`tsne_tiled`): P sparsified to the ``3 * perplexity``
  nearest neighbours (:func:`knn`, (block, N) tiles and ``torch.topk``),
  the attraction edge-wise through ``index_add_``, the repulsion exact in
  (block, N) tiles.  Peak device memory is O(N * k + block * N); no
  (N, N) tensor exists on this path.

The JAX package runs each path as one XLA program; here a Python loop
enqueues every iteration's operations and reads nothing back until the
final coordinates and KL (two host reads a fit, ``host_reads``).

Initial coordinates: the JAX package draws them from
``jax.random.normal(PRNGKey(seed))``, which torch cannot reproduce.  The
port draws them from a CPU ``torch.Generator`` seeded by ``seed`` (the
same draws whatever the device, scaled by 1e-2 as the JAX package scales
its own) unless ``fit`` is given ``y0``; tests give it the JAX draws.
"""

from __future__ import annotations

import inspect
import math
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..clustering.kmeans import ieee_f32_matmul
from ..device import DeviceLike, resolve_device

Tensor = torch.Tensor


def _block_sq_dists(xb: Tensor, x: Tensor) -> Tensor:
    """(B, N) squared distances from a row block to all points."""
    n2b = torch.sum(xb * xb, dim=1)
    n2 = torch.sum(x * x, dim=1)
    d = n2b[:, None] + n2[None, :] - 2.0 * xb @ x.T
    return torch.clamp(d, min=0.0)


def _sq_dists(x: Tensor) -> Tensor:
    return _block_sq_dists(x, x)


def _opt_step(it: int, y, vel, gains, g, learning_rate: float,
              switch_momentum: int):
    """One gradient-descent step shared by both paths: the momentum
    switch and the per-dimension gains (JAX ``_opt_step``)."""
    momentum = 0.5 if it < switch_momentum else 0.8
    same_sign = torch.sign(g) == torch.sign(vel)
    gains = torch.where(same_sign, gains * 0.8, gains + 0.2)
    gains = torch.clamp(gains, min=0.01)
    vel = momentum * vel - learning_rate * gains * g
    return y + vel, vel, gains


def _log_perplexity(perplexity: float, like: Tensor) -> Tensor:
    """log(perplexity) computed in the data's dtype (float32 in ``fit``),
    as the JAX package does."""
    return torch.log(torch.tensor(perplexity, dtype=like.dtype,
                                  device=like.device))


def perplexity_search(d: Tensor, target_entropy: Tensor,
                      iters: int = 50) -> Tensor:
    """Per-row bisection on beta = 1/(2 sigma^2) so that each row's
    Shannon entropy matches log(perplexity), all rows at once (JAX
    ``_perplexity_search``: a fixed count of steps; beta doubles while
    the upper bound is infinite).  ``d`` is (N, M): dense distances or
    (N, k) neighbour distances; entries to exclude are +inf."""
    n = d.shape[0]
    d_safe = torch.where(torch.isfinite(d), d, torch.zeros_like(d))
    beta = torch.ones(n, dtype=d.dtype, device=d.device)
    lo = torch.zeros(n, dtype=d.dtype, device=d.device)
    hi = torch.full((n,), math.inf, dtype=d.dtype, device=d.device)
    for _ in range(iters):
        p = torch.exp(-d * beta[:, None])
        psum = torch.clamp(p.sum(1), min=1e-12)
        h = torch.log(psum) + beta * torch.sum(d_safe * p, 1) / psum
        too_high = h > target_entropy       # entropy too big: raise beta
        new_lo = torch.where(too_high, beta, lo)
        new_hi = torch.where(too_high, hi, beta)
        beta = torch.where(
            too_high,
            torch.where(torch.isinf(new_hi), beta * 2.0,
                        (beta + new_hi) / 2.0),
            (new_lo + beta) / 2.0)
        lo, hi = new_lo, new_hi
    return beta


def exact_affinities(x: Tensor, perplexity: float) -> Tensor:
    """The symmetrised (N, N) P of the exact path."""
    n = x.shape[0]
    eye_mask = 1.0 - torch.eye(n, dtype=x.dtype, device=x.device)
    d = torch.where(eye_mask > 0, _sq_dists(x),
                    torch.tensor(math.inf, dtype=x.dtype, device=x.device))
    beta = perplexity_search(d, _log_perplexity(perplexity, x))
    p = torch.exp(-torch.where(eye_mask > 0, d, torch.zeros_like(d))
                  * beta[:, None]) * eye_mask
    p = p / torch.clamp(p.sum(1, keepdim=True), min=1e-12)
    p = (p + p.T) / (2.0 * n)                      # symmetrise
    return torch.clamp(p, min=1e-12)


def tsne_exact(x: Tensor, y0: Tensor, perplexity: float, max_iter: int,
               learning_rate: float, switch_momentum: int,
               stop_lying_iteration: int, exaggeration: float,
               on_affinities: Optional[Callable[[], None]] = None):
    """The exact path (JAX ``_tsne_run``): returns ``(y, kl)`` on the
    device.  ``on_affinities`` is called once P is enqueued."""
    n = x.shape[0]
    eye_mask = 1.0 - torch.eye(n, dtype=x.dtype, device=x.device)
    p = exact_affinities(x, perplexity)
    if on_affinities is not None:
        on_affinities()

    def grad_kl(y, p_eff, with_kl=False):
        dy = _sq_dists(y)
        num = eye_mask / (1.0 + dy)                # student-t kernel
        q = num / torch.clamp(num.sum(), min=1e-12)
        q = torch.clamp(q, min=1e-12)
        w = (p_eff - q) * num                      # (N, N)
        # dC/dy_i = 4 sum_j w_ij (y_i - y_j)
        g = (4.0 * (torch.diag(w.sum(1)) - w)) @ y
        kl = torch.sum(p_eff * torch.log(p_eff / q)) if with_kl else None
        return g, kl

    y, vel, gains = y0, torch.zeros_like(y0), torch.ones_like(y0)
    p_lying = p * exaggeration
    for it in range(max_iter):
        g, _ = grad_kl(y, p_lying if it < stop_lying_iteration else p)
        y, vel, gains = _opt_step(it, y, vel, gains, g, learning_rate,
                                  switch_momentum)
        y = y - y.mean(0, keepdim=True)            # recentre
    _, kl = grad_kl(y, p, with_kl=True)
    return y, kl


def knn(x: Tensor, mask: Tensor, k: int, block: int):
    """Blocked k nearest neighbours (JAX ``_knn``): (N, k) squared
    distances and indices without an (N, N) tensor.  Self and padding
    columns are +inf, so they never make the top k."""
    n = x.shape[0]
    inf = torch.tensor(math.inf, dtype=x.dtype, device=x.device)
    pad_cols = mask[None, :] <= 0
    dists, idxs = [], []
    for start in range(0, n, block):
        d = _block_sq_dists(x[start:start + block], x)
        d[:, start:start + block].diagonal().fill_(math.inf)
        d = torch.where(pad_cols, inf, d)
        neg_d, idx = torch.topk(-d, k, dim=1)
        dists.append(-neg_d)
        idxs.append(idx)
    return torch.cat(dists), torch.cat(idxs)


def tiled_affinities(x: Tensor, mask: Tensor, n_real: int,
                     perplexity: float, k: int, block: int):
    """The sparse P of the tiled path as directed edges ``(src, dst,
    pval)``: each edge gives ``pval`` to both endpoints' attraction,
    which is (P + P^T) / 2N without the union pattern."""
    n = x.shape[0]
    knn_d, knn_idx = knn(x, mask, k, block)
    beta = perplexity_search(knn_d, _log_perplexity(perplexity, x))
    p = torch.exp(-knn_d * beta[:, None]) * mask[:, None]
    p = p / torch.clamp(p.sum(1, keepdim=True), min=1e-12)
    p = p * mask[:, None]                     # pad rows contribute nothing
    src = torch.arange(n, device=x.device).repeat_interleave(k)
    dst = knn_idx.reshape(-1)
    pval = p.reshape(-1) / (2.0 * n_real)
    return src, dst, pval


def tsne_tiled(x: Tensor, mask: Tensor, n_real: int, y0: Tensor,
               perplexity: float, max_iter: int, learning_rate: float,
               switch_momentum: int, stop_lying_iteration: int,
               exaggeration: float, k: int, block: int,
               on_affinities: Optional[Callable[[], None]] = None):
    """The tiled path (JAX ``_tsne_run_tiled``): ``x`` padded to a
    multiple of ``block`` rows, ``mask`` 1 on the real rows.  Returns
    ``(y, kl)`` on the device.  ``on_affinities`` is called once the
    sparse P is enqueued."""
    n = x.shape[0]
    padded = n_real < n
    src, dst, pval = tiled_affinities(x, mask, n_real, perplexity, k,
                                      block)
    if on_affinities is not None:
        on_affinities()

    def repulsion(y):
        """Tiled exact repulsion: (sum_j num_ij^2 (y_i - y_j), Z)."""
        reps, z_parts = [], []
        for start in range(0, n, block):
            yb = y[start:start + block]
            num = 1.0 / (1.0 + _block_sq_dists(yb, y))
            num[:, start:start + block].diagonal().zero_()
            if padded:
                num = num * mask[None, :] * mask[start:start + block, None]
            z_parts.append(num.sum())
            n2 = num * num
            reps.append(n2.sum(1, keepdim=True) * yb - n2 @ y)
        return torch.cat(reps), torch.stack(z_parts).sum()

    def grad_kl(y, exagger, with_kl=False):
        ys, yd = y[src], y[dst]
        w = 1.0 / (1.0 + torch.sum((ys - yd) ** 2, dim=1))
        pe = pval * exagger
        attr_edge = (pe * w)[:, None] * (ys - yd)
        attr = (torch.zeros_like(y).index_add_(0, src, attr_edge)
                .index_add_(0, dst, -attr_edge))
        rep, z = repulsion(y)
        zc = torch.clamp(z, min=1e-12)
        g = 4.0 * (attr - rep / zc)
        kl = None
        if with_kl:
            # KL over the sparse support, on the exact path's scale
            q = torch.clamp(w / zc, min=1e-12)
            p_sym = 2.0 * pval
            kl = torch.sum(p_sym * torch.log(
                torch.clamp(p_sym, min=1e-12) / q))
        return g, kl

    m = mask[:, None]
    y = y0 * m
    vel, gains = torch.zeros_like(y0), torch.ones_like(y0)
    for it in range(max_iter):
        g, _ = grad_kl(y, exaggeration if it < stop_lying_iteration
                       else 1.0)
        y, vel, gains = _opt_step(it, y, vel, gains, g, learning_rate,
                                  switch_momentum)
        mean = torch.sum(y * m, 0, keepdim=True) / float(n_real)
        y = (y - mean) * m
    _, kl = grad_kl(y, 1.0, with_kl=True)
    return y, kl


def host_draws(shape: Tuple[int, int], seed: int) -> np.ndarray:
    """The port's default initial draws: a CPU ``torch.Generator`` seeded
    by ``seed``, so the card and the CPU start from the same points."""
    gen = torch.Generator().manual_seed(int(seed))
    return torch.randn(shape, generator=gen, dtype=torch.float32).numpy()


class Tsne:
    """Reference ``BarnesHutTsne`` Builder surface.  At most
    ``tile_threshold`` points take the exact path, more the tiled one
    (module docstring).  ``device`` (default the card) is where the
    optimisation runs.  After ``fit``: ``coords``, ``kl_divergence``,
    ``host_reads`` and ``phase_ms`` (host clock, the device synchronized
    at each end: ``affinities`` up to the first iteration, ``iterations``
    the loop and the final KL)."""

    def __init__(self, n_dims: int = 2, perplexity: float = 30.0,
                 theta: float = 0.5, learning_rate: float = 200.0,
                 max_iter: int = 1000, switch_momentum_iteration: int = 250,
                 stop_lying_iteration: int = 250,
                 exaggeration: float = 12.0, seed: int = 42,
                 normalize: bool = True, tile_threshold: int = 4096,
                 block_size: int = 1024, device: DeviceLike = None):
        self.n_dims = n_dims
        self.perplexity = perplexity
        self.theta = theta
        self.learning_rate = learning_rate
        self.max_iter = max_iter
        self.switch_momentum_iteration = switch_momentum_iteration
        self.stop_lying_iteration = stop_lying_iteration
        self.exaggeration = exaggeration
        self.seed = seed
        self.normalize = normalize
        self.tile_threshold = int(tile_threshold)
        self.block_size = int(block_size)
        self.device = resolve_device(device)
        self.coords: Optional[np.ndarray] = None
        self.kl_divergence: float = float("nan")
        self.host_reads = 0
        self.phase_ms: dict = {}

    class Builder:
        """Reference ``BarnesHutTsne.Builder`` fluent surface: any
        constructor parameter as a chainable setter (``set_max_iter`` maps
        to ``max_iter``; unknown knobs from the reference surface, e.g.
        ``use_pca``, are accepted and ignored)."""

        def __init__(self):
            self._kw = {}

        def __getattr__(self, name):
            if name.startswith("_"):
                raise AttributeError(name)

            def setter(value):
                key = name[4:] if name.startswith("set_") else name
                self._kw[key] = value
                return self
            return setter

        def build(self) -> "Tsne":
            valid = set(inspect.signature(Tsne.__init__).parameters)
            return Tsne(**{k: v for k, v in self._kw.items()
                           if k in valid})

    def _initial(self, rows: int, y0) -> Tensor:
        if y0 is None:
            y0 = host_draws((rows, self.n_dims), self.seed) * np.float32(
                1e-2)
        y0 = torch.as_tensor(np.asarray(y0, np.float32))
        if y0.shape[0] < rows:
            y0 = torch.cat([y0, y0.new_zeros(rows - y0.shape[0],
                                              y0.shape[1])])
        return y0.to(self.device)

    def _sync(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def fit(self, x, y0=None) -> "Tsne":
        """Embed (reference ``BarnesHutTsne.fit``); the coordinates land
        in ``coords`` / ``get_coordinates()``.  ``y0``: the initial
        coordinates, (n, n_dims) (the tiled path pads them with zeros),
        instead of the seeded draws."""
        x = np.asarray(x, np.float32)
        if x.ndim != 2 or x.shape[0] < 2:
            raise ValueError("fit expects an (n>=2, d) matrix")
        if self.perplexity * 3.0 > x.shape[0] - 1:
            raise ValueError(
                f"perplexity {self.perplexity} too large for n={x.shape[0]}"
                " (need n-1 >= 3*perplexity)")
        if self.normalize:
            x = (x - x.mean(0)) / np.maximum(x.std(0), 1e-12)
        n = x.shape[0]
        hyper = dict(perplexity=float(self.perplexity),
                     max_iter=int(self.max_iter),
                     learning_rate=float(self.learning_rate),
                     switch_momentum=int(self.switch_momentum_iteration),
                     stop_lying_iteration=int(self.stop_lying_iteration),
                     exaggeration=float(self.exaggeration),
                     on_affinities=lambda: marks.append(self._sync()))
        marks = [self._sync()]
        with ieee_f32_matmul():
            if n <= self.tile_threshold:
                y, kl = tsne_exact(torch.as_tensor(x, device=self.device),
                                   self._initial(n, y0), **hyper)
            else:
                block = min(self.block_size, n)
                n_pad = ((n + block - 1) // block) * block
                xp = np.concatenate(
                    [x, np.zeros((n_pad - n, x.shape[1]), x.dtype)])
                mask = np.concatenate([np.ones(n, np.float32),
                                       np.zeros(n_pad - n, np.float32)])
                k = min(int(3 * self.perplexity), n - 1)
                y, kl = tsne_tiled(
                    torch.as_tensor(xp, device=self.device),
                    torch.as_tensor(mask, device=self.device), n,
                    self._initial(n_pad, y0), k=k, block=block, **hyper)
            self.coords = y[:n].cpu().numpy()
            self.kl_divergence = float(kl)
        marks.append(self._sync())
        self.host_reads = 2
        self.phase_ms = {"affinities": (marks[1] - marks[0]) * 1e3,
                         "iterations": (marks[2] - marks[1]) * 1e3}
        return self

    def fit_transform(self, x, y0=None) -> np.ndarray:
        return self.fit(x, y0).get_coordinates()

    def get_coordinates(self) -> np.ndarray:
        if self.coords is None:
            raise RuntimeError("call fit() first")
        return self.coords

    def save_coordinates(self, path: str, labels=None) -> None:
        """CSV of embedded coordinates, one row per point with optional
        trailing label (reference ``BarnesHutTsne.saveCoordsForPlot``)."""
        coords = self.get_coordinates()
        with open(path, "w", encoding="utf-8") as f:
            for i in range(coords.shape[0]):
                row = [f"{v:.6f}" for v in coords[i]]
                if labels is not None:
                    row.append(str(labels[i]))
                f.write(",".join(row) + "\n")
