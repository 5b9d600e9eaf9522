"""The port's CUDA kernels (K1-K4, K2/K3 also in segment form) and the
ring flash attention on the card, held against their plain PyTorch
versions and against float64 math.  Marked ``gpu``: without a CUDA device
every test skips (the decision is made inside the fixture).  This file
imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_kernels_gpu.py

Tolerances: 1e-4 of max|reference| for f32 results (both sides
accumulate in f32, in another order); a bf16 output element by element
within rtol 2^-7, atol 1e-5 (both sides round nearly the same f32 value,
so they differ by at most one bf16 ulp); 1e-5 of max|reference| against
float64 for f32 inputs.
"""

import pytest
import torch

from deeplearning4j_tpu_torch.ops import attention as A
from deeplearning4j_tpu_torch.parallel.sequence import SequenceParallel

pytestmark = pytest.mark.gpu

SHAPES = [(1, 50, 2, 8), (1, 130, 2, 24), (2, 200, 2, 64), (1, 70, 1, 128)]
# (q shape, Tk): K4 and the segment backward on every shape above with
# Tk = Tq, and on ragged K/V segments shorter and longer than q
SEGMENTS = ([(s, s[1]) for s in SHAPES]
            + [((1, 50, 2, 8), 24), ((2, 200, 2, 64), 130),
               ((1, 70, 1, 128), 190)])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def other_card():
    """The last CUDA card, which is not the current one; the decision to
    skip (fewer than two cards) is made inside the test."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    return torch.device("cuda", torch.cuda.device_count() - 1)


def _rel(got, want):
    got, want = got.double(), want.double()
    return ((got - want).abs().max() / want.abs().max()).item()


def _inputs(shape, dtype, device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=device).to(dtype)
            for _ in range(4)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=str)
def test_kernels_match_plain(cuda, shape, causal, dtype):
    q, k, v, g = _inputs(shape, dtype, cuda)
    s = shape[-1] ** -0.5
    out, lse = A.flash_forward(q, k, v, causal=causal, sm_scale=s,
                               with_lse=True)
    out_n = A.flash_forward(q, k, v, causal=causal, sm_scale=s,
                            with_lse=False)
    p_out, p_lse = A.flash_forward_plain(q, k, v, causal, s,
                                         "normalized_lse")
    assert out.dtype == out_n.dtype == dtype
    for got in (out, out_n):
        if dtype == torch.bfloat16:
            torch.testing.assert_close(got.float(), p_out.float(),
                                       rtol=2.0 ** -7, atol=1e-5)
        else:
            assert _rel(got, p_out) <= 1e-4
    assert _rel(lse, p_lse) <= 1e-4
    D = (g.float() * out.float()).sum(-1).contiguous()
    dk, dv = A.flash_dkdv(q, k, v, g, lse, D, causal=causal, sm_scale=s)
    dq = A.flash_dq(q, k, v, g, lse, D, causal=causal, sm_scale=s)
    pdk, pdv = A.flash_dkdv_plain(q, k, v, g, lse, D, causal, s)
    pdq = A.flash_dq_plain(q, k, v, g, lse, D, causal, s)
    for got, want in ((dk, pdk), (dv, pdv), (dq, pdq)):
        assert got.dtype == torch.float32
        assert _rel(got, want) <= 1e-4


@pytest.mark.parametrize("d", [24, 64])
def test_autograd_matches_float64_math(cuda, d):
    """Kernel gradients against dense float64 attention: an oracle that
    shares no code or summation order with either side."""
    q, k, v, g = _inputs((2, 100, 2, d), torch.float32, cuda, seed=1)
    qs = [x.clone().requires_grad_() for x in (q, k, v)]
    out = A.flash_attention(*qs, causal=True)
    out.backward(g)
    _assert_float64_agrees(out, qs, g, causal=True)


def _assert_float64_agrees(out, qs, g, causal):
    """``out`` and the grads of ``qs`` (q, k, v) within 1e-5 of
    max|reference| of dense float64 attention with cotangent ``g``."""
    ref = [x.detach().double().clone().requires_grad_() for x in qs]
    qd, kd, vd = (x.transpose(1, 2) for x in ref)
    sc = (qd @ kd.transpose(-1, -2)) * qd.shape[-1] ** -0.5
    if causal:
        t = qd.shape[2]
        mask = torch.ones(t, t, dtype=torch.bool, device=g.device).tril()
        sc = sc.masked_fill(~mask, float("-inf"))
    o = (torch.softmax(sc, -1) @ vd).transpose(1, 2)
    o.backward(g.double())
    assert _rel(out, o) <= 1e-5
    for got, want in zip(qs, ref):
        assert _rel(got.grad, want.grad) <= 1e-5


def test_launch_counts_one_per_kernel_per_step(cuda):
    q, k, v = (x.requires_grad_() for x in _inputs((1, 64, 2, 32),
                                                    torch.bfloat16,
                                                    cuda)[:3])
    A.reset_launches()
    A.flash_attention(q, k, v, causal=True).float().sum().backward()
    assert A.LAUNCHES == {"flash_fwd": 1, "flash_fwd_partials": 0,
                          "flash_bwd_dkdv": 1, "flash_bwd_dq": 1}
    with torch.no_grad():
        A.flash_attention(q, k, v, causal=True)
    assert A.LAUNCHES["flash_fwd"] == 2


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    q = torch.zeros(1, 16, 2, 8, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        A.flash_forward(q, q, q, causal=True, sm_scale=0.3, with_lse=False)
    q = torch.zeros(1, 16, 2, 160, device=cuda)
    with pytest.raises(ValueError):
        A.flash_forward(q, q, q, causal=True, sm_scale=0.3, with_lse=False)
    q = torch.zeros(1, 2, 16, 8, device=cuda).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        A.flash_forward(q, q, q, causal=True, sm_scale=0.3, with_lse=False)


def _segment_inputs(shape, tk, dtype, device, seed=2):
    gen = torch.Generator(device=device).manual_seed(seed)
    b, tq, h, d = shape
    q, g = (torch.randn(shape, generator=gen, device=device).to(dtype)
            for _ in range(2))
    k, v = (torch.randn((b, tk, h, d), generator=gen, device=device)
            .to(dtype) for _ in range(2))
    return q, k, v, g


@pytest.mark.parametrize("shape,tk", SEGMENTS, ids=str)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=str)
def test_partials_kernel_matches_plain(cuda, shape, tk, causal, dtype):
    """K4: acc, m and l (all f32) against the plain partials mode."""
    q, k, v, _ = _segment_inputs(shape, tk, dtype, cuda)
    s = shape[-1] ** -0.5
    got = A.flash_attention_partial(q, k, v, causal=causal, sm_scale=s)
    want = A.flash_forward_plain(q, k, v, causal, s, "partials")
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and a.shape == b.shape
        assert _rel(a, b) <= 1e-4


@pytest.mark.parametrize("shape,tk", SEGMENTS, ids=str)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype,do_dtype",
                         [(torch.float32, torch.float32),
                          (torch.bfloat16, torch.bfloat16),
                          (torch.bfloat16, torch.float32)], ids=str)
def test_segment_backward_matches_plain(cuda, shape, tk, causal, dtype,
                                        do_dtype):
    """K2/K3 with Tk != Tq and the segment's L and D, dO in q's dtype or
    f32, against the plain versions."""
    q, k, v, g = _segment_inputs(shape, tk, dtype, cuda)
    g = g.to(do_dtype)
    s = shape[-1] ** -0.5
    acc, m, l = A.flash_attention_partial(q, k, v, causal=causal,
                                          sm_scale=s)
    L = (m + torch.log(l)).contiguous()
    D = (g.float() * acc / l[..., None]).sum(-1).contiguous()
    dk, dv = A.flash_dkdv(q, k, v, g, L, D, causal=causal, sm_scale=s)
    dq = A.flash_dq(q, k, v, g, L, D, causal=causal, sm_scale=s)
    pdk, pdv = A.flash_dkdv_plain(q, k, v, g, L, D, causal, s)
    pdq = A.flash_dq_plain(q, k, v, g, L, D, causal, s)
    for got, want in ((dk, pdk), (dv, pdv), (dq, pdq)):
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert _rel(got, want) <= 1e-4


@pytest.mark.parametrize("causal", [True, False])
def test_ring_on_one_card_matches_float64(cuda, causal):
    """A 4-shard ring flash attention on one card, forward and fused ring
    backward, against dense float64 attention."""
    q, k, v, g = _inputs((2, 256, 2, 32), torch.float32, cuda, seed=3)
    qs = [x.clone().requires_grad_() for x in (q, k, v)]
    out = SequenceParallel(devices=["cuda"] * 4).attention(
        *qs, causal=causal, impl="ring_flash")
    out.backward(g)
    _assert_float64_agrees(out, qs, g, causal)


@pytest.mark.parametrize("causal,steps", [(True, 10), (False, 16)])
def test_ring_launch_counts(cuda, causal, steps):
    """One 4-shard fwd+bwd: K4 and K2/K3 once per ring step that sees a
    key (causal: 4 diagonal + 6 visible), K1 never."""
    q, k, v = (x.requires_grad_() for x in _inputs((1, 256, 2, 32),
                                                    torch.bfloat16,
                                                    cuda)[:3])
    A.reset_launches()
    SequenceParallel(devices=["cuda"] * 4).attention(
        q, k, v, causal=causal, impl="ring_flash").float().sum().backward()
    assert A.LAUNCHES == {"flash_fwd": 0, "flash_fwd_partials": steps,
                          "flash_bwd_dkdv": steps, "flash_bwd_dq": steps}


def test_kernels_on_a_card_that_is_not_current(other_card):
    """Each kernel launched on the last card while card 0 is current, held
    against its plain version on that card: the launch must go to the
    tensors' card and its stream, and leave card 0 current."""
    q, k, v, g = _inputs((2, 200, 2, 64), torch.bfloat16, other_card)
    s = 0.125
    out, lse = A.flash_forward(q, k, v, causal=True, sm_scale=s,
                               with_lse=True)
    p_out, p_lse = A.flash_forward_plain(q, k, v, True, s, "normalized_lse")
    torch.testing.assert_close(out.float(), p_out.float(), rtol=2.0 ** -7,
                               atol=1e-5)
    assert _rel(lse, p_lse) <= 1e-4
    for got, want in zip(
            A.flash_attention_partial(q, k, v, causal=True, sm_scale=s),
            A.flash_forward_plain(q, k, v, True, s, "partials")):
        assert got.device == other_card and _rel(got, want) <= 1e-4
    D = (g.float() * out.float()).sum(-1).contiguous()
    dk, dv = A.flash_dkdv(q, k, v, g, lse, D, causal=True, sm_scale=s)
    dq = A.flash_dq(q, k, v, g, lse, D, causal=True, sm_scale=s)
    pdk, pdv = A.flash_dkdv_plain(q, k, v, g, lse, D, True, s)
    pdq = A.flash_dq_plain(q, k, v, g, lse, D, True, s)
    for got, want in ((dk, pdk), (dv, pdv), (dq, pdq)):
        assert got.device == other_card and _rel(got, want) <= 1e-4
    assert torch.cuda.current_device() == 0


@pytest.mark.parametrize("layout", ["one shard per card", "4 on the last"])
@pytest.mark.parametrize("causal", [True, False])
def test_ring_on_other_cards_matches_float64(other_card, layout, causal):
    """The ring flash attention with shards on cards other than the
    current one, forward and fused ring backward, against dense float64
    attention: one shard per card (``devices=None``, blocks copied between
    cards on every hop), or four shards on the last card."""
    sp = (SequenceParallel() if layout == "one shard per card"
          else SequenceParallel(devices=[other_card] * 4))
    q, k, v, g = _inputs((2, 64 * sp.n, 2, 32), torch.float32, other_card,
                         seed=4)
    qs = [x.clone().requires_grad_() for x in (q, k, v)]
    out = sp.attention(*qs, causal=causal, impl="ring_flash")
    assert out.device == other_card
    out.backward(g)
    _assert_float64_agrees(out, qs, g, causal)
    assert torch.cuda.current_device() == 0
