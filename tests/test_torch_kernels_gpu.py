"""The port's CUDA kernels on the card, held against their plain PyTorch
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

pytestmark = pytest.mark.gpu

SHAPES = [(1, 50, 2, 8), (1, 130, 2, 24), (2, 200, 2, 64), (1, 70, 1, 128)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


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
    p_out, p_lse = A.flash_forward_plain(q, k, v, causal, s, True)
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
    ref = [x.double().clone().requires_grad_() for x in (q, k, v)]
    qd, kd, vd = (x.transpose(1, 2) for x in ref)
    sc = (qd @ kd.transpose(-1, -2)) * d ** -0.5
    mask = torch.ones(100, 100, dtype=torch.bool, device=cuda).tril()
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
    assert A.LAUNCHES == {"flash_fwd": 1, "flash_bwd_dkdv": 1,
                          "flash_bwd_dq": 1}
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
