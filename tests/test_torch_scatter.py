"""The port's ``ops/scatter.py`` against the JAX package's.

Same seeded inputs through both: ``aggregate_rows`` (destinations equal,
sentinels included; segment sums), ``scatter_add_agg`` on both routes
(with duplicate rows, an index grid, and zero-payload rows), and
``fused_adagrad_dual`` against the JAX one and against the naive
two-scatter sequence it replaces; ``pack_dual``/``unpack_dual`` bitwise.
Tolerance fp32, rtol 1e-5, atol 1e-6 element by element (on the CPU both
packages add in index order, so the sums agree far more closely).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_tpu.ops import scatter as J
from deeplearning4j_tpu_torch.ops import scatter as P

RTOL, ATOL = 1e-5, 1e-6


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def _case(seed, V=12, B=40, D=5, grid=False):
    rng = np.random.RandomState(seed)
    shape = (B // 4, 4) if grid else (B,)
    idx = rng.randint(0, V, shape)
    vals = rng.randn(*shape, D).astype(np.float32)
    # inert rows: zero payload, any index (as the trainers mask them)
    dead = rng.rand(*shape) < 0.25
    vals[dead] = 0.0
    table = rng.randn(V, D).astype(np.float32)
    return table, idx, vals


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_aggregate_rows_matches_jax(seed):
    _, idx, vals = _case(seed)
    jd, js = J.aggregate_rows(jnp.asarray(idx), jnp.asarray(vals))
    pd, ps = P.aggregate_rows(torch.from_numpy(idx), torch.from_numpy(vals))
    np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
    assert (pd.numpy() == P.SENTINEL).sum() == len(idx) - len(set(idx))
    _close(ps, js)
    # the sentinel slots carry exactly zero payload
    assert not ps[pd == P.SENTINEL].any()


@pytest.mark.parametrize("aggregate", [False, True])
@pytest.mark.parametrize("grid", [False, True])
@pytest.mark.parametrize("seed", [0, 3])
def test_scatter_add_agg_matches_jax(seed, grid, aggregate):
    table, idx, vals = _case(seed, grid=grid)
    want = J.scatter_add_agg(jnp.asarray(table), jnp.asarray(idx),
                             jnp.asarray(vals), aggregate=aggregate)
    t = torch.from_numpy(table.copy())
    got = P.scatter_add_agg(t, torch.from_numpy(idx), torch.from_numpy(vals),
                            aggregate=aggregate)
    assert got is t                      # in place
    _close(got, want)


def test_both_routes_agree_and_only_touch_their_rows():
    table, idx, vals = _case(5, V=30)
    idx = np.minimum(idx, 27)            # rows 28, 29 untouched
    plain = P.scatter_add_agg(torch.from_numpy(table.copy()),
                              torch.from_numpy(idx), torch.from_numpy(vals),
                              aggregate=False)
    agg = P.scatter_add_agg(torch.from_numpy(table.copy()),
                            torch.from_numpy(idx), torch.from_numpy(vals),
                            aggregate=True)
    _close(agg, plain)
    untouched = np.setdiff1d(np.arange(30), idx)
    # the last row takes the sentinels' zero payload and keeps its value
    assert 29 in untouched
    np.testing.assert_array_equal(agg.numpy()[untouched], table[untouched])


@pytest.mark.parametrize("width", [1, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_fused_adagrad_dual_matches_jax_and_the_naive_pair(seed, width):
    rng = np.random.RandomState(seed)
    V, B = 10, 48
    w = rng.randn(V, width).astype(np.float32)
    h = rng.rand(V, width).astype(np.float32)
    idx = rng.randint(0, V - 3, B)       # rows V-3.. untouched
    g = rng.randn(B, width).astype(np.float32)
    g[rng.rand(B) < 0.2] = 0.0
    lr = np.float32(0.05)
    jw, jh = (w[:, 0], h[:, 0]) if width == 1 else (w, h)
    want = J.fused_adagrad_dual(J.pack_dual(jnp.asarray(jw),
                                            jnp.asarray(jh)),
                                jnp.asarray(idx), jnp.asarray(g),
                                jnp.asarray(lr))
    pw, ph = torch.from_numpy(jw.copy()), torch.from_numpy(jh.copy())
    state = P.pack_dual(pw, ph)
    got = P.fused_adagrad_dual(state, torch.from_numpy(idx),
                               torch.from_numpy(g), torch.tensor(lr))
    assert got is state
    _close(got, want)
    # the naive sequence: batch-summed bump, then the read-after-batch
    # accumulator scales every duplicate's delta
    ti, tg = torch.from_numpy(idx), torch.from_numpy(g)
    hw, ww = torch.from_numpy(h.copy()), torch.from_numpy(w.copy())
    hw.index_add_(0, ti, tg * tg)
    ww.index_add_(0, ti, -torch.tensor(lr) * tg / torch.sqrt(hw[ti] + 1e-8))
    nw, nh = P.unpack_dual(got)
    _close(nw, ww)
    _close(nh, hw)


def test_pack_and_unpack_match_jax_bitwise():
    rng = np.random.RandomState(4)
    for shape in [(6,), (6, 3)]:
        w = rng.randn(*shape).astype(np.float32)
        h = rng.rand(*shape).astype(np.float32)
        jp = J.pack_dual(jnp.asarray(w), jnp.asarray(h))
        pp = P.pack_dual(torch.from_numpy(w), torch.from_numpy(h))
        np.testing.assert_array_equal(pp.numpy(), np.asarray(jp))
        squeeze = len(shape) == 1
        for a, b in zip(P.unpack_dual(pp, squeeze=squeeze),
                        J.unpack_dual(jp, squeeze=squeeze)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_aggregation_gate(monkeypatch):
    monkeypatch.delenv("DL4J_TPU_SCATTER_AGG", raising=False)
    # the CPU keeps it off, as the JAX package does off the TPU
    assert P.aggregation_enabled() is False
    assert P.aggregation_enabled(device="cpu") is False
    assert J.aggregation_enabled() is False
    assert P.aggregation_enabled(device="cuda") is P.CARD_AGGREGATES
    assert P.aggregation_enabled(True, device="cpu") is True
    assert P.aggregation_enabled(False, device="cuda") is False
    for env, on in [("1", True), ("0", False), ("off", False),
                    ("false", False), ("yes", True)]:
        monkeypatch.setenv("DL4J_TPU_SCATTER_AGG", env)
        assert P.aggregation_enabled(device="cpu") is on
        assert P.aggregation_enabled(device="cuda") is on
        assert J.aggregation_enabled() is on
        assert P.aggregation_enabled(not on) is (not on)
