"""Line-search solvers: L-BFGS, conjugate gradient and line gradient
descent over Armijo backtracking (port of
``deeplearning4j_tpu/optimize/solvers.py``).

Equivalents of the reference's ``optimize/Solver.java`` and
``BaseOptimizer`` (gradient, search direction, line search, step),
``LBFGS`` (the two-loop recursion over m = 4 pairs), ``ConjugateGradient``
(Polak-Ribiere with restart), ``LineGradientDescent`` and
``BackTrackLineSearch`` (Armijo, c1 1e-4, halving).

The solver works on the flat parameter vector in the JAX package's
``ravel_pytree`` order: layer by layer (a ComputationGraph's layer
vertices by sorted name, not in topological order), each layer's params
by sorted name, in their storage dtype.  The JAX package runs a whole
iteration as one compiled program with the backtracking in a
``lax.while_loop``; here
the backtracking is a Python loop that stops at the first accepted trial,
with one host read per trial.  Both accept the same step.  The host reads
of one iteration (``Solver.host_syncs`` counts them): one for the sign of
the slope of each line search, one per trial, one for L-BFGS's curvature
test (sy > 1e-10) and one for the returned score.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional

import torch

Tensor = torch.Tensor

SGD = "stochastic_gradient_descent"
LINE_GRADIENT_DESCENT = "line_gradient_descent"
CONJUGATE_GRADIENT = "conjugate_gradient"
LBFGS = "lbfgs"

LINE_SEARCH_ALGOS = (LINE_GRADIENT_DESCENT, CONJUGATE_GRADIENT, LBFGS)
ALL_ALGOS = (SGD,) + LINE_SEARCH_ALGOS

_LBFGS_M = 4  # history size (reference LBFGS.java `private int m = 4`)


def _read(t: Tensor, counter: Optional[List[int]]) -> bool:
    """One host read of a 0-d boolean tensor, counted in ``counter``."""
    if counter is not None:
        counter[0] += 1
    return bool(t)


def _backtrack(loss_fn, w, f0, g0, direction, max_iterations, initial_step,
               c1, backtrack, syncs):
    """(accepted step, whether a trial was accepted)."""
    slope = torch.dot(g0, direction)
    a = torch.as_tensor(initial_step, dtype=w.dtype, device=w.device)
    zero = torch.zeros((), dtype=w.dtype, device=w.device)
    if not _read(slope < 0, syncs):
        return zero, False   # the JAX package runs its trials and returns 0
    with torch.no_grad():
        for _ in range(max_iterations):
            f_new = loss_fn(w + a * direction)
            if _read(f_new <= f0 + c1 * a * slope, syncs):
                return a, True
            a = a * backtrack
    return zero, False


def backtrack_line_search(loss_fn: Callable[[Tensor], Tensor], w: Tensor,
                          f0: Tensor, g0: Tensor, direction: Tensor,
                          max_iterations: int = 5,
                          initial_step=1.0, c1: float = 1e-4,
                          backtrack: float = 0.5) -> Tensor:
    """Armijo backtracking (reference ``BackTrackLineSearch.optimize``):
    start at ``initial_step`` and halve until ``f(w + a d) <= f0 + c1 a
    g0.d`` or ``max_iterations`` trials are spent.  Returns the accepted
    step as a 0-d tensor of ``w``'s dtype, 0 on failure or when ``d`` is
    not a descent direction."""
    return _backtrack(loss_fn, w, f0, g0, direction, max_iterations,
                      initial_step, c1, backtrack, None)[0]


class SolverState(NamedTuple):
    """The search state carried between iterations (reference
    ``BaseOptimizer.searchState``).  Unused slots stay zero for the
    simpler algorithms; ``count`` and ``step_num`` live on the host."""
    prev_grad: Tensor       # CG and L-BFGS
    prev_dir: Tensor        # CG
    prev_w: Tensor          # L-BFGS
    s_buf: Tensor           # L-BFGS (m, n) param differences
    y_buf: Tensor           # L-BFGS (m, n) gradient differences
    rho_buf: Tensor         # L-BFGS (m,)
    count: int              # L-BFGS pairs stored so far
    step_num: int           # iterations completed (0: no history yet)


def init_solver_state(n: int, dtype=torch.float32,
                      device=None) -> SolverState:
    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)
    return SolverState(prev_grad=z(n), prev_dir=z(n), prev_w=z(n),
                       s_buf=z(_LBFGS_M, n), y_buf=z(_LBFGS_M, n),
                       rho_buf=z(_LBFGS_M), count=0, step_num=0)


def _cg_direction(g: Tensor, state: SolverState) -> Tensor:
    """Polak-Ribiere conjugate direction with restart (reference
    ``ConjugateGradient.preProcessLine``: beta = max(0, g.(g - g_prev) /
    g_prev.g_prev)); steepest descent where that is not a descent
    direction."""
    denom = torch.dot(state.prev_grad, state.prev_grad)
    ratio = torch.dot(g, g - state.prev_grad) / torch.clamp_min(denom,
                                                                1e-30)
    beta = torch.where(denom > 0, torch.clamp_min(ratio, 0.0),
                       torch.zeros_like(denom))
    d = -g + beta * state.prev_dir
    return torch.where(torch.dot(d, g) < 0, d, -g)


def _lbfgs_direction(g: Tensor, state: SolverState) -> Tensor:
    """Two-loop recursion (Nocedal & Wright 7.2; reference
    ``LBFGS.postStep``) over the stored pairs, newest first; slots not
    filled yet are skipped (in the JAX package they add exact zeros)."""
    q = g
    alphas = []
    for k in range(min(state.count, _LBFGS_M)):
        idx = (state.count - 1 - k) % _LBFGS_M
        alpha = state.rho_buf[idx] * torch.dot(state.s_buf[idx], q)
        q = q - alpha * state.y_buf[idx]
        alphas.append((alpha, idx))
    if state.count > 0:
        # initial Hessian scaling gamma = s.y / y.y of the newest pair
        newest = (state.count - 1) % _LBFGS_M
        sy = torch.dot(state.s_buf[newest], state.y_buf[newest])
        yy = torch.dot(state.y_buf[newest], state.y_buf[newest])
        gamma = torch.where(yy > 0, sy / torch.clamp_min(yy, 1e-30),
                            torch.ones_like(yy))
        r = gamma * q
    else:
        r = q
    for alpha, idx in reversed(alphas):
        beta = state.rho_buf[idx] * torch.dot(state.y_buf[idx], r)
        r = r + (alpha - beta) * state.s_buf[idx]
    d = -r
    return torch.where(torch.dot(d, g) < 0, d, -g)


def _update_lbfgs_history(state: SolverState, w: Tensor, g: Tensor,
                          syncs: Optional[List[int]]) -> SolverState:
    """Push (s, y, 1/s.y) of the completed step into the ring (reference
    ``LBFGS.postStep``); a pair with s.y <= 1e-10 is skipped, to keep the
    inverse-Hessian approximation positive definite."""
    s = w - state.prev_w
    y = g - state.prev_grad
    sy = torch.dot(s, y)
    if not _read(sy > 1e-10, syncs):
        return state
    slot = state.count % _LBFGS_M      # the ring is the solver's own
    state.s_buf[slot], state.y_buf[slot], state.rho_buf[slot] = s, y, 1 / sy
    return state._replace(count=state.count + 1)


class Solver:
    """Line-search solver over a network's full-batch loss (reference
    ``optimize/Solver.java`` and ``BaseOptimizer.optimize``).

    The configured updater is not applied: the line search picks the step
    (the reference's step-function path); regularization enters through
    the loss as on the SGD path.  Params of frozen layers get a zero
    gradient, so no direction, trial or step moves them.  A layer's
    ``direct_update_params`` (the center-loss centers) stay out of the
    search and step by ``p -= g`` at the step's start point, as on the
    updater path (the JAX package's solvers search them with the rest).  After each step
    one train-mode forward at the new params refreshes ``net_state``
    (batch-norm statistics), as the SGD path does; the fp32 masters
    follow the new params."""

    def __init__(self, net, algo: str,
                 max_line_search_iterations: int = 10):
        algo = algo.lower()
        if algo not in LINE_SEARCH_ALGOS:
            raise ValueError(
                f"Unknown/unsupported optimization_algo {algo!r}; expected "
                f"one of {ALL_ALGOS}")
        self.net = net
        self.algo = algo
        self.max_ls = max_line_search_iterations
        self._state: Optional[SolverState] = None
        self.host_syncs = 0       # host reads so far (see module docstring)
        self.iterations = 0

    # ------------------------------------------------ flat parameter view
    def _keys(self, params):
        """The per-layer trees in ``ravel_pytree`` order: by layer index,
        or by sorted vertex name for a graph's dict."""
        return sorted(params) if isinstance(params, dict) else \
            range(len(params))

    def _leaves(self, params):
        from ..nn.multilayer import _sorted_leaves
        return [list(_sorted_leaves(params[key]))
                for key in self._keys(params)]

    def _ravel(self, params) -> Tensor:
        return torch.cat([p.reshape(-1) for leaves in self._leaves(params)
                          for p in leaves])

    def _unravel(self, flat: Tensor):
        """Per-layer dicts of views into ``flat``, in the container and
        key order of the net's params (autograd flows through them)."""
        params = self.net.params
        out, offset = {}, 0
        for key in self._keys(params):
            tree, layer = params[key], {}
            for name in sorted(tree):
                p = tree[name]
                layer[name] = flat[offset:offset + p.numel()].view(p.shape)
                offset += p.numel()
            out[key] = {k: layer[k] for k in tree}
        return self.net._trees([(key, out[key])
                                for key, _ in self.net._items(params)])

    def _masks(self, flat: Tensor):
        """``(searched, direct)``: 1 in ``searched`` for each param the
        line search moves, 1 in ``direct`` for each of a layer's
        ``direct_update_params`` (stepped by ``p -= g`` instead); both 0
        for a param of a frozen layer."""
        net = self.net
        searched, direct = [], []
        for key in self._keys(net.params):
            layer = net._layer_at(key)
            frozen = getattr(layer, "frozen", False)
            own = set(layer.direct_update_params())
            for name in sorted(net.params[key]):
                n = net.params[key][name].numel()
                is_direct = not frozen and name in own
                for chunks, on in ((searched, not frozen and not is_direct),
                                   (direct, is_direct)):
                    chunks.append(torch.full((n,), float(on),
                                             dtype=flat.dtype,
                                             device=flat.device))
        return torch.cat(searched), torch.cat(direct)

    def _flat_loss(self, features, labels, fmask, lmask):
        """loss(flat_w) on the current batch, test-mode forward (the line
        search compares trials, so the loss must be free of dropout
        noise)."""
        net = self.net
        net_state = net.net_state

        def loss(flat_w):
            params = self._unravel(flat_w)
            data_loss, _, _ = net._loss_fn(params, net_state, features,
                                           labels, fmask, lmask, None, False)
            return data_loss + net._reg_score(params)

        return loss

    # ----------------------------------------------------------- iteration
    def _step(self, flat_w: Tensor, features, labels, fmask, lmask):
        syncs = [0]
        state = self._state
        loss = self._flat_loss(features, labels, fmask, lmask)
        w = flat_w.detach().requires_grad_(True)
        f0 = loss(w)
        g_all, = torch.autograd.grad(f0, w)
        f0 = f0.detach()
        searched, direct = self._masks(flat_w)
        g = g_all * searched
        # a scale-free first trial for steepest-descent searches: a unit
        # step along a large raw gradient overshoots every backtrack level
        sd_init = torch.clamp_max(
            1.0 / torch.clamp_min(torch.linalg.vector_norm(g), 1e-12), 1.0)
        if self.algo == LBFGS:
            if state.step_num > 0:
                state = _update_lbfgs_history(state, flat_w, g, syncs)
            direction = _lbfgs_direction(g, state)
        elif self.algo == CONJUGATE_GRADIENT:
            direction = (-g if state.step_num == 0
                         else _cg_direction(g, state))
        else:
            direction = -g
        alpha, accepted = _backtrack(
            loss, flat_w, f0, g, direction, self.max_ls,
            sd_init if self.algo == LINE_GRADIENT_DESCENT else 1.0,
            1e-4, 0.5, syncs)
        if accepted or self.algo == LINE_GRADIENT_DESCENT:
            step_vec, used_dir = alpha * direction, direction
        else:
            # Armijo failed along the curved direction: a steepest-descent
            # search instead, so every accepted step is monotone
            alpha_sd, _ = _backtrack(loss, flat_w, f0, g, -g, self.max_ls,
                                     sd_init, 1e-4, 0.5, syncs)
            step_vec, used_dir = -alpha_sd * g, -g
        new_w = flat_w + step_vec - g_all * direct
        self._state = state._replace(prev_grad=g, prev_dir=used_dir,
                                     prev_w=flat_w,
                                     step_num=state.step_num + 1)
        self.host_syncs += syncs[0]
        return new_w, f0

    def _refresh_state(self, flat_w: Tensor, features, labels, fmask,
                       lmask) -> None:
        """One train-mode forward at the accepted params, for layers that
        keep state (batch-norm running statistics); skipped when none
        does."""
        net = self.net
        if not any(len(s) for _, s in net._items(net.net_state)):
            return
        with torch.no_grad():
            _, new_state, _ = net._loss_fn(self._unravel(flat_w),
                                           net.net_state, features, labels,
                                           fmask, lmask, net._rng, True)
        net.net_state = net._stored_state(new_state)

    def optimize(self, features, labels, fmask, lmask,
                 iterations: int = 1) -> float:
        """Run solver iterations on one batch; writes ``net.params`` (and
        the fp32 masters) and returns the last pre-step score."""
        net = self.net
        with torch.no_grad():
            flat_w = self._ravel(net.params)
        if (self._state is None
                or self._state.prev_grad.numel() != flat_w.numel()):
            self._state = init_solver_state(flat_w.numel(), flat_w.dtype,
                                            flat_w.device)
        score = None
        for _ in range(iterations):
            flat_w, score = self._step(flat_w, features, labels, fmask,
                                       lmask)
            self._refresh_state(flat_w, features, labels, fmask, lmask)
            self.iterations += 1
        net.params = net._trees(
            [(key, {k: v.clone() for k, v in tree.items()})
             for key, tree in net._items(self._unravel(flat_w.detach()))])
        net._sync_masters_from_params()
        self.host_syncs += 1
        return float("nan") if score is None else float(score)
