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

With bf16 q/k/v all four kernels run on the tensor cores: K1/K4 round P
to bf16 as the operand of O += P V, K2/K3 (with a bf16 dO) round P and dS
as operands of the gradient products.  All four take their Hopper bodies
(wgmma fed by TMA) where TMA can address the rows, else the mma.sync
bodies; the rounding twin runs over the key tile of the body that ran
(``attention.fwd_key_tile``, ``attention.bwd_key_tile``), since the
running max, and so the rounding of P, depends on where K1/K4's key tiles
start, and K3's f32 sum follows its key tiles.  So they have two references: the
plain twin that rounds the same way (``operand_dtype=torch.bfloat16``),
held tightly (a bf16 ``out`` element by element as above; f32 results,
and the softmax statistics lse, m, l, at 1e-4 of max|reference|), and the
all-f32 twin, where the rounded results (``out``, ``acc``, the gradients)
are held at ``TC_F32_GAP`` of max|reference| and the statistics, which
rounding P does not touch (l sums the unrounded p), stay at 1e-4.  One
round-to-nearest moves each P and dS element by at most 2^-8 of itself,
independently, so an output or gradient element (a sum of such terms
against unit-scale random operands) moves by about 2^-8/sqrt(3) = 2.3e-3
of its own size; 1e-2 of the largest element leaves a factor of 4 for the
tail over all elements.  The tight hold needs both sides to round the same
f32 P: from continuous random inputs the kernel's S and the twin's, summed
in another order, straddle a bf16 rounding point now and then and round
one ulp apart, which moves a result by up to 2^-7 of one of its terms, far
above 1e-4 of max|reference| at these shapes.  So bf16 inputs here lie on
a grid of 1/8 in [-4, 4], where every S and dP is exact in f32 whatever
the order.
"""

import re
import subprocess
from pathlib import Path

import pytest
import torch

from deeplearning4j_tpu_torch.ops import attention as A
from deeplearning4j_tpu_torch.ops import kernel_build
from deeplearning4j_tpu_torch.parallel.sequence import SequenceParallel

TC_F32_GAP = 1e-2

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


def _assert_backward_matches_plain(got, q, k, v, g, L, D, causal, s):
    """K2/K3's (dk, dv, dq) against the plain twins: the twin that rounds
    P and dS to bf16 when q and dO are bf16 (the tensor-core route), at
    1e-4, and then the all-f32 twin at ``TC_F32_GAP``; else the f32 twin
    at 1e-4."""
    tensor_core = q.dtype == g.dtype == torch.bfloat16
    twins = [torch.bfloat16, None] if tensor_core else [None]
    block = A.bwd_key_tile(q.shape[-1], A.bwd_route(q, k, v, g))
    for operands, tol in zip(twins, (1e-4, TC_F32_GAP)):
        pdk, pdv = A.flash_dkdv_plain(q, k, v, g, L, D, causal, s,
                                      operand_dtype=operands)
        pdq = A.flash_dq_plain(q, k, v, g, L, D, causal, s, block=block,
                               operand_dtype=operands)
        for a, b in zip(got, (pdk, pdv, pdq)):
            assert a.dtype == torch.float32 and a.shape == b.shape
            assert a.device == q.device
            assert _rel(a, b) <= tol


def _assert_forward_matches_plain(got, q, k, v, causal, s, mode):
    """K1/K4's results in ``mode`` (a tensor or tuple as the wrapper gives
    them) against the plain twins: for bf16 q/k/v (the tensor-core route)
    the twin that rounds P to bf16, tightly, then the all-f32 twin, with
    the first result (out or acc) at ``TC_F32_GAP`` and the statistics at
    1e-4; for f32 inputs the f32 twin, tightly.  Both twins run over the
    key tile of the body that these inputs take."""
    got = got if isinstance(got, tuple) else (got,)
    tensor_core = q.dtype == torch.bfloat16
    block = A.fwd_key_tile(q.shape[-1], A.fwd_route(q, k, v))
    for operands in ([torch.bfloat16, None] if tensor_core else [None]):
        want = A.flash_forward_plain(q, k, v, causal, s, mode, block=block,
                                     operand_dtype=operands)
        want = want if isinstance(want, tuple) else (want,)
        gap = tensor_core and operands is None
        for i, (a, b) in enumerate(zip(got, want)):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.device == q.device
            if gap and i == 0:
                assert _rel(a, b) <= TC_F32_GAP
            elif a.dtype == torch.bfloat16:
                torch.testing.assert_close(a.float(), b.float(),
                                           rtol=2.0 ** -7, atol=1e-5)
            else:
                assert _rel(a, b) <= 1e-4


def _randn(shape, gen, device, dtype):
    """Normal values; for bf16 rounded to the exact-sum grid of 1/8 in
    [-4, 4] (see the module docstring)."""
    x = torch.randn(shape, generator=gen, device=device)
    if dtype == torch.bfloat16:
        x = (x * 8).round().clamp(-32, 32) / 8
    return x.to(dtype)


def _inputs(shape, dtype, device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    return [_randn(shape, gen, device, dtype) for _ in range(4)]


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
    assert out.dtype == out_n.dtype == dtype
    _assert_forward_matches_plain((out, lse), q, k, v, causal, s,
                                  "normalized_lse")
    _assert_forward_matches_plain(out_n, q, k, v, causal, s, "normalized")
    D = (g.float() * out.float()).sum(-1).contiguous()
    dk, dv = A.flash_dkdv(q, k, v, g, lse, D, causal=causal, sm_scale=s)
    dq = A.flash_dq(q, k, v, g, lse, D, causal=causal, sm_scale=s)
    _assert_backward_matches_plain((dk, dv, dq), q, k, v, g, lse, D, causal,
                                   s)


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
    assert A.BODY_LAUNCHES["flash_fwd"] == {"scalar": 0, "tc": 0, "sm90": 2}
    for name in ("flash_bwd_dkdv", "flash_bwd_dq"):
        assert A.BODY_LAUNCHES[name] == {"scalar": 0, "tc": 0, "sm90": 1}


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
    q, g = (_randn(shape, gen, device, dtype) for _ in range(2))
    k, v = (_randn((b, tk, h, d), gen, device, dtype) for _ in range(2))
    return q, k, v, g


@pytest.mark.parametrize("shape,tk", SEGMENTS, ids=str)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=str)
def test_partials_kernel_matches_plain(cuda, shape, tk, causal, dtype):
    """K4: acc, m and l (all f32) against the plain partials mode (bf16:
    both twins)."""
    q, k, v, _ = _segment_inputs(shape, tk, dtype, cuda)
    s = shape[-1] ** -0.5
    got = A.flash_attention_partial(q, k, v, causal=causal, sm_scale=s)
    assert all(a.dtype == torch.float32 for a in got)
    _assert_forward_matches_plain(got, q, k, v, causal, s, "partials")


@pytest.mark.parametrize("shape,tk", SEGMENTS, ids=str)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype,do_dtype",
                         [(torch.float32, torch.float32),
                          (torch.bfloat16, torch.bfloat16),
                          (torch.bfloat16, torch.float32)], ids=str)
def test_segment_backward_matches_plain(cuda, shape, tk, causal, dtype,
                                        do_dtype):
    """K2/K3 with Tk != Tq and the segment's L and D, dO in q's dtype or
    f32, against the plain versions (bf16 dO: the tensor-core route, held
    to both twins)."""
    q, k, v, g = _segment_inputs(shape, tk, dtype, cuda)
    g = g.to(do_dtype)
    s = shape[-1] ** -0.5
    L, D = _segment_stats(q, k, v, g, causal, s)
    dk, dv = A.flash_dkdv(q, k, v, g, L, D, causal=causal, sm_scale=s)
    dq = A.flash_dq(q, k, v, g, L, D, causal=causal, sm_scale=s)
    _assert_backward_matches_plain((dk, dv, dq), q, k, v, g, L, D, causal, s)


def _segment_stats(q, k, v, g, causal, s):
    """L and D of q against the K/V segment alone, from K4's partials."""
    acc, m, l = A.flash_attention_partial(q, k, v, causal=causal,
                                          sm_scale=s)
    L = (m + torch.log(l)).contiguous()
    D = (g.float() * acc / l[..., None]).sum(-1).contiguous()
    return L, D


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("tk", [1100, 700])
def test_bf16_backward_long_ragged_causal(cuda, d, tk):
    """The tensor-core K2/K3 at T = 1100 (a multiple of neither 64 nor
    128), causal, where the heaviest-first grid order and the ragged last
    tile both matter; K/V as long as q, or a shorter segment."""
    q, k, v, g = _segment_inputs((2, 1100, 3, d), tk, torch.bfloat16, cuda,
                                 seed=5)
    s = d ** -0.5
    L, D = _segment_stats(q, k, v, g, True, s)
    dk, dv = A.flash_dkdv(q, k, v, g, L, D, causal=True, sm_scale=s)
    dq = A.flash_dq(q, k, v, g, L, D, causal=True, sm_scale=s)
    _assert_backward_matches_plain((dk, dv, dq), q, k, v, g, L, D, True, s)


def _off_16_bytes(x):
    """A contiguous copy of ``x`` one element into its storage, so that its
    rows are not 16-byte aligned."""
    y = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:]
    return y.view(x.shape).copy_(x)


@pytest.mark.parametrize("case", ["d=20", "rows off 16-byte boundaries"])
def test_bf16_backward_stages_element_by_element(cuda, case):
    """Tiles that 16-byte copies cannot stage (d not a multiple of 8, or
    rows not 16-byte aligned) are loaded element by element into the same
    bf16 tiles of the mma.sync bodies (TMA cannot address them); the
    results are the same."""
    d = 20 if case == "d=20" else 64
    q, k, v, g = _segment_inputs((2, 150, 2, d), 130, torch.bfloat16, cuda,
                                 seed=7)
    if case != "d=20":
        q, k, v, g = (_off_16_bytes(x) for x in (q, k, v, g))
        assert q.is_contiguous() and q.data_ptr() % 16 != 0
    assert A.bwd_route(q, k, v, g) == "tc"
    s = d ** -0.5
    L, D = _segment_stats(q, k, v, g, True, s)
    dk, dv = A.flash_dkdv(q, k, v, g, L, D, causal=True, sm_scale=s)
    dq = A.flash_dq(q, k, v, g, L, D, causal=True, sm_scale=s)
    _assert_backward_matches_plain((dk, dv, dq), q, k, v, g, L, D, True, s)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("tk", [1100, 700, 1300])
def test_bf16_backward_takes_the_hopper_body(cuda, causal, tk):
    """At the main path's d = 64 with T = 1100 (a multiple of neither 64
    nor 128), K/V as long as q, shorter or longer: every K2/K3 launch takes
    the Hopper body (``BODY_LAUNCHES``), held to the twins (K3's over its
    128-key tiles); an f32 dO takes the scalar body."""
    q, k, v, g = _segment_inputs((2, 1100, 3, 64), tk, torch.bfloat16, cuda,
                                 seed=12)
    assert A.bwd_route(q, k, v, g) == "sm90"
    assert A.bwd_route(q, k, v, g.float()) == "scalar"
    assert A.bwd_key_tile(64, "sm90") == 128
    L, D = _segment_stats(q, k, v, g, causal, 0.125)
    A.reset_launches()
    dk, dv = A.flash_dkdv(q, k, v, g, L, D, causal=causal, sm_scale=0.125)
    dq = A.flash_dq(q, k, v, g, L, D, causal=causal, sm_scale=0.125)
    for name in ("flash_bwd_dkdv", "flash_bwd_dq"):
        assert A.BODY_LAUNCHES[name] == {"scalar": 0, "tc": 0, "sm90": 1}
    _assert_backward_matches_plain((dk, dv, dq), q, k, v, g, L, D, causal,
                                   0.125)


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_backward_is_deterministic(cuda, causal):
    """Two launches give bit-equal gradients: no atomics, dQ in its own
    kernel."""
    q, k, v, g = _segment_inputs((2, 1100, 3, 64), 1100, torch.bfloat16,
                                 cuda, seed=6)
    L, D = _segment_stats(q, k, v, g, causal, 0.125)
    runs = [(*A.flash_dkdv(q, k, v, g, L, D, causal=causal, sm_scale=0.125),
             A.flash_dq(q, k, v, g, L, D, causal=causal, sm_scale=0.125))
            for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def _assert_bf16_forward(q, k, v, causal, s):
    """K1 in both modes (Tk = Tq only) and K4 against their twins."""
    if k.shape == q.shape:
        _assert_forward_matches_plain(
            A.flash_forward(q, k, v, causal=causal, sm_scale=s,
                            with_lse=True), q, k, v, causal, s,
            "normalized_lse")
        _assert_forward_matches_plain(
            A.flash_forward(q, k, v, causal=causal, sm_scale=s,
                            with_lse=False), q, k, v, causal, s,
            "normalized")
    _assert_forward_matches_plain(
        A.flash_attention_partial(q, k, v, causal=causal, sm_scale=s),
        q, k, v, causal, s, "partials")


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("tk", [1100, 700])
def test_bf16_forward_long_ragged_causal(cuda, d, tk):
    """The tensor-core K1/K4 at T = 1100 (not a multiple of 64), causal,
    where the heaviest-first grid order and the ragged last tile both
    matter; K/V as long as q (K1 and K4), or a shorter segment (K4)."""
    q, k, v, _ = _segment_inputs((2, 1100, 3, d), tk, torch.bfloat16, cuda,
                                 seed=8)
    _assert_bf16_forward(q, k, v, True, d ** -0.5)


@pytest.mark.parametrize("case", ["d=20", "rows off 16-byte boundaries"])
def test_bf16_forward_stages_element_by_element(cuda, case):
    """K/V and Q tiles that 16-byte copies cannot stage (d not a multiple
    of 8, or rows not 16-byte aligned) are loaded element by element into
    the same bf16 tiles; the results are the same."""
    d = 20 if case == "d=20" else 64
    q, k, v, _ = _segment_inputs((2, 150, 2, d), 150, torch.bfloat16, cuda,
                                 seed=9)
    if case != "d=20":
        q, k, v = (_off_16_bytes(x) for x in (q, k, v))
        assert q.is_contiguous() and q.data_ptr() % 16 != 0
    assert A.fwd_route(q, k, v) == "tc"           # TMA cannot address these
    for causal in (True, False):
        _assert_bf16_forward(q, k, v, causal, d ** -0.5)
        _assert_bf16_forward(q, k[:, :130].contiguous(),
                             v[:, :130].contiguous(), causal, d ** -0.5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("tk", [1100, 700, 1300])
def test_bf16_forward_takes_the_hopper_body(cuda, causal, tk):
    """At the main path's d = 64 with T = 1100 (a multiple of neither 64
    nor 128), K/V as long as q, shorter or longer: every K1/K4 launch
    takes the Hopper body (``BODY_LAUNCHES``), held to the twin over its
    128-key tiles."""
    q, k, v, _ = _segment_inputs((2, 1100, 3, 64), tk, torch.bfloat16, cuda,
                                 seed=11)
    assert A.fwd_route(q, k, v) == "sm90"
    assert A.fwd_key_tile(64, "sm90") == 128
    A.reset_launches()
    _assert_bf16_forward(q, k, v, causal, 0.125)
    k1 = 2 if tk == 1100 else 0
    assert A.BODY_LAUNCHES == {
        "flash_fwd": {"scalar": 0, "tc": 0, "sm90": k1},
        "flash_fwd_partials": {"scalar": 0, "tc": 0, "sm90": 1},
        "flash_bwd_dkdv": {"scalar": 0, "tc": 0, "sm90": 0},
        "flash_bwd_dq": {"scalar": 0, "tc": 0, "sm90": 0}}


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_forward_is_deterministic(cuda, causal):
    """Two launches of K1 and of K4 give bit-equal results."""
    q, k, v, _ = _segment_inputs((2, 1100, 3, 64), 1100, torch.bfloat16,
                                 cuda, seed=10)
    for run in (lambda: A.flash_forward(q, k, v, causal=causal,
                                        sm_scale=0.125, with_lse=True),
                lambda: A.flash_attention_partial(q, k, v, causal=causal,
                                                  sm_scale=0.125)):
        for a, b in zip(run(), run()):
            assert torch.equal(a, b)


def _cuobjdump_by_kernel(library: Path, flag: str, header: str) -> dict:
    """``cuobjdump <flag>`` of ``library`` cut at each kernel's ``header``
    (a regex whose group is the mangled name), by demangled name without
    namespace and parameters, e.g. ``flash_bwd_dq_kernel<float,float,64>``.
    """
    bin_dir = Path(kernel_build.nvcc_path()).parent
    dump = subprocess.run([str(bin_dir / "cuobjdump"), flag, str(library)],
                          capture_output=True, text=True, check=True).stdout
    parts = re.split(header, dump)
    mangled, bodies = parts[1::2], parts[2::2]
    names = subprocess.run([str(bin_dir / "cu++filt")],
                           input="\n".join(mangled), capture_output=True,
                           text=True, check=True).stdout.split("\n")
    short = [n.replace("(int)", "").split("(")[0].split("::")[-1]
             for n in names[:len(mangled)]]
    return {n.replace(" ", ""): body for n, body in zip(short, bodies)}


def test_bf16_backward_runs_on_tensor_cores(cuda):
    """The Hopper instances of K2 and K3 (the d <= 64 and d = 128
    buckets) issue wgmma (HGMMA) fed by TMA loads (UTMALDG) and spill
    nothing to local memory; the bf16 instances of the mma.sync bodies
    issue HMMA (tensor-core) instructions and spill nothing; the f32 and
    f32-dO instances stay scalar: among those the route is fixed at compile
    time by the operand types."""
    library = kernel_build.build(A._SOURCE)
    sass = _cuobjdump_by_kernel(library, "--dump-sass", r"Function : (\S+)")
    usage = _cuobjdump_by_kernel(library, "--dump-resource-usage",
                                 r"Function (\S+):")
    for kernel in ("flash_bwd_dkdv_sm90_kernel", "flash_bwd_dq_sm90_kernel"):
        hopper = [n for n in sass if n.startswith(f"{kernel}<")]
        assert sorted(hopper) == [f"{kernel}<128>", f"{kernel}<64>"], \
            sorted(sass)
        for name in hopper:
            assert "HGMMA" in sass[name] and "UTMALDG" in sass[name], name
            assert re.search(r"\bLOCAL:0\b", usage[name]), name
    bf16 = "__nv_bfloat16"
    for kernel in ("flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel"):
        for dm in (32, 64, 128):
            tensor_core = f"{kernel}<{bf16},{bf16},{dm}>"
            assert "HMMA" in sass[tensor_core]
            assert "HGMMA" not in sass[tensor_core]
            assert re.search(r"\bLOCAL:0\b", usage[tensor_core])
            for types in ("float,float", f"{bf16},float"):
                assert "HMMA" not in sass[f"{kernel}<{types},{dm}>"]


def test_bf16_forward_runs_on_tensor_cores(cuda):
    """The Hopper instances of K1/K4 (the d <= 64 and d = 128 buckets, each
    mode) issue wgmma (HGMMA) fed by TMA loads (UTMALDG) and spill nothing
    to local memory; the bf16 instances of the mma.sync body (every bucket
    and mode) issue HMMA and spill nothing; the f32 instances issue
    neither."""
    library = kernel_build.build(A._SOURCE)
    sass = _cuobjdump_by_kernel(library, "--dump-sass", r"Function : (\S+)")
    usage = _cuobjdump_by_kernel(library, "--dump-resource-usage",
                                 r"Function (\S+):")
    hopper = [n for n in sass if n.startswith("flash_fwd_sm90_kernel<")]
    assert len(hopper) == 6, sorted(sass)      # 2 buckets x 3 modes
    for name in hopper:
        assert "HGMMA" in sass[name] and "UTMALDG" in sass[name], name
        assert re.search(r"\bLOCAL:0\b", usage[name]), name
    for types, tensor_core in (("__nv_bfloat16", True), ("float", False)):
        names = [n for n in sass
                 if n.startswith(f"flash_fwd_kernel<{types},")]
        assert len(names) == 9, sorted(sass)   # 3 buckets x 3 modes
        for name in names:
            assert ("HMMA" in sass[name]) == tensor_core, name
            assert "HGMMA" not in sass[name], name
            if tensor_core:
                assert re.search(r"\bLOCAL:0\b", usage[name]), name


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
    _assert_forward_matches_plain((out, lse), q, k, v, True, s,
                                  "normalized_lse")
    _assert_forward_matches_plain(
        A.flash_attention_partial(q, k, v, causal=True, sm_scale=s), q, k,
        v, True, s, "partials")
    D = (g.float() * out.float()).sum(-1).contiguous()
    dk, dv = A.flash_dkdv(q, k, v, g, lse, D, causal=True, sm_scale=s)
    dq = A.flash_dq(q, k, v, g, lse, D, causal=True, sm_scale=s)
    _assert_backward_matches_plain((dk, dv, dq), q, k, v, g, lse, D, True, s)
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


# ---- decode and serving on the card ---------------------------------------
# The serving path rides dense ``kv_ring_attention`` (no flash kernel, as
# in the JAX package).  fp32 on both sides: 1e-5 on probabilities, f32
# sums in another order on the card and on the CPU.

def _decode_nets(cuda):
    """The same small fp32 decode network on the card and on the CPU."""
    from deeplearning4j_tpu_torch.nn.conf import inputs
    from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import \
        NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers.attention import \
        CausalSelfAttention
    from deeplearning4j_tpu_torch.nn.layers.recurrent import RnnOutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    def build(device):
        conf = (NeuralNetConfiguration.builder().seed(5)
                .compute_dtype("float32").list()
                .layer(CausalSelfAttention(n_out=16, n_heads=4,
                                           cache_len=32))
                .layer(RnnOutputLayer(n_out=4, activation="softmax",
                                      loss="mcxent"))
                .set_input_type(inputs.recurrent(8, 16)).build())
        return MultiLayerNetwork(conf, device=device).init()

    card, cpu = build(cuda), build("cpu")
    cpu.set_flat_params(card.get_flat_params())
    return card, cpu


def test_decode_session_on_the_card_matches_the_cpu(cuda):
    import numpy as np
    from deeplearning4j_tpu_torch.serving import SessionCache
    card, cpu = _decode_nets(cuda)
    xs = np.random.RandomState(0).randn(2, 16, 8).astype(np.float32)
    A.reset_launches()
    outs = []
    for net in (card, cpu):
        cache = SessionCache(net, name=f"gpu-dec-{net.device.type}")
        steps = [cache.step("s", xs[:, :10])]
        steps += [cache.step("s", xs[:, t])[:, None] for t in range(10, 16)]
        outs.append(np.concatenate(steps, 1))
        assert cache.session_capacity("s") == 16
        assert cache.get_carries("s")[0][0].device.type == net.device.type
    assert not any(A.LAUNCHES.values())
    np.testing.assert_allclose(outs[0], outs[1], rtol=0, atol=1e-5)
    np.testing.assert_allclose(outs[1], cpu.output(xs).numpy(), rtol=0,
                               atol=1e-6)


def test_engine_predict_on_the_card_returns_host_rows(cuda):
    import numpy as np
    from deeplearning4j_tpu_torch.serving import InferenceEngine
    card, cpu = _decode_nets(cuda)
    xs = np.random.RandomState(1).randn(3, 12, 8).astype(np.float32)
    with InferenceEngine(card, max_batch_size=4, timestep_buckets=(16,),
                         name="gpu-engine") as eng:
        got = eng.predict(xs, timeout=120.0)
    assert isinstance(got, np.ndarray) and got.shape == (3, 12, 4)
    np.testing.assert_allclose(got, cpu.output(xs).numpy(), rtol=0,
                               atol=1e-5)


# ---- feed-forward and convolutional families on the card ------------------
# No hand kernel on this path (cuDNN/cuBLAS through torch, as XLA lowerings
# in the JAX package).  fp32 on both sides, the card's convs in IEEE f32
# (TF32 off): 1e-5 of max|CPU|, f32 sums in another order.  The golden's
# bf16 default at 5e-3 on probabilities: one bf16 rounding per operand and
# activation moves them by under 1e-3 under the mixed policy on the CPU
# (test_torch_model_serializer.py), and the golden's signal
# max|p - 1/classes| is 0.14.

def _card_vs_cpu(cuda, fn, *arrays):
    """``fn`` on the card and on the CPU from the same f32 inputs: the
    outputs and the input gradients against a fixed random cotangent."""
    import numpy as np
    results = []
    for device in (cuda, torch.device("cpu")):
        xs = [torch.tensor(a, device=device, requires_grad=True)
              for a in arrays]
        out = fn(*xs)
        out = out[0] if isinstance(out, tuple) else out
        g = torch.as_tensor(np.random.RandomState(9).randn(*out.shape)
                            .astype(np.float32), device=device)
        grads = torch.autograd.grad(out, xs, g)
        results.append([t.detach().cpu() for t in (out,) + grads])
    for got, want in zip(*results):
        assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("case", ["conv same s2", "conv truncate dilated",
                                  "max same", "avg same", "pnorm",
                                  "batch norm", "lrn"])
def test_conv_pool_bn_on_the_card_match_the_cpu(cuda, case):
    import numpy as np
    from deeplearning4j_tpu_torch.ops import convolution as C
    rng = np.random.RandomState(0)
    x = rng.randn(4, 29, 27, 8).astype(np.float32)
    k = rng.randn(3, 3, 8, 16).astype(np.float32)
    g, b = rng.rand(8).astype(np.float32) + 0.5, rng.randn(8).astype(
        np.float32)
    fn, args = {
        "conv same s2": (lambda a, w: C.conv2d(a, w, (2, 2), (0, 0), "same"),
                         (x, k)),
        "conv truncate dilated": (lambda a, w: C.conv2d(
            a, w, (1, 1), (1, 1), "truncate", (2, 2)), (x, k)),
        "max same": (lambda a: C.pool2d(a, "max", (3, 3), (2, 2), (0, 0),
                                        "same"), (x,)),
        "avg same": (lambda a: C.pool2d(a, "avg", (3, 3), (2, 2), (0, 0),
                                        "same"), (x,)),
        "pnorm": (lambda a: C.pool2d(a, "pnorm", (2, 2), (2, 2)), (x,)),
        "batch norm": (lambda a, ga, be: C.batch_norm_train(
            a, ga, be, (0, 1, 2), 1e-5), (x, g, b)),
        "lrn": (lambda a: C.local_response_normalization(a, 2.0, 5, 1e-2,
                                                         0.75), (x,)),
    }[case]
    _card_vs_cpu(cuda, fn, *args)


def test_cnn_adam_restores_on_the_card(cuda):
    """The golden under the card's default policy, and an fp32 copy built
    from the zip's configuration with ``compute_dtype="float32"``."""
    import copy
    from pathlib import Path
    import numpy as np
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.utils import model_serializer as ms
    fixtures = Path(__file__).resolve().parent / "fixtures" / "regression"
    golden = np.load(fixtures / "cnn_adam_golden.npz")
    x = golden["input"]
    net = ms.restore_multi_layer_network(fixtures / "cnn_adam.zip")
    assert net.device.type == "cuda" and net._pol().name == "mixed_bf16"
    np.testing.assert_allclose(net.output(x).cpu().numpy(),
                               golden["prediction"], rtol=0, atol=5e-3)
    cpu = ms.restore_multi_layer_network(fixtures / "cnn_adam.zip",
                                         device="cpu")
    conf = copy.deepcopy(cpu.conf)
    conf.conf.compute_dtype = "float32"
    net32 = MultiLayerNetwork(conf, device=cuda).init()
    net32.set_flat_params(cpu.get_flat_params())
    net32.set_flat_updater_state(cpu.get_flat_updater_state())
    net32.iteration = cpu.iteration
    assert net32.params[0]["W"].dtype == torch.float32
    np.testing.assert_allclose(net32.output(x).cpu().numpy(),
                               golden["prediction"], rtol=1e-5, atol=1e-7)
    y = np.eye(2, dtype=np.float32)[[0, 1, 0]]
    for n in (net, net32, cpu):
        n.fit(DataSet(x, y))
    assert net.iteration == 2 and np.isfinite(net.score())
    assert _rel(torch.as_tensor(net32.get_flat_params()),
                torch.as_tensor(cpu.get_flat_params())) <= 1e-5


# ---- the recurrent slice --------------------------------------------------
# No hand kernel on this path (cuBLAS and elementwise kernels through
# torch, where the JAX package has XLA's lowering of lax.scan).  fp32 on
# both sides (IEEE f32 matmuls): 1e-5 of max|CPU| for outputs and params
# and 1e-5 relative for scores, f32 sums in another order; SGD, so that
# the step does not amplify differences in small gradients.  The LSTM
# golden as the cnn_adam one above; its fit is 2 tBPTT windows.

def _lstm_net(device):
    from deeplearning4j_tpu_torch.nn.conf import inputs
    from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import \
        NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers.recurrent import (
        GravesLSTM, RnnOutputLayer)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    conf = (NeuralNetConfiguration.builder().seed(3).updater("sgd")
            .learning_rate(0.1).activation("tanh").compute_dtype("float32")
            .list()
            .layer(GravesLSTM(n_out=16)).layer(GravesLSTM(n_out=12))
            .layer(RnnOutputLayer(n_out=5))
            .set_input_type(inputs.recurrent(7, 19))
            .backprop_type("tbptt").t_bptt_forward_length(8)
            .t_bptt_backward_length(5).build())
    return MultiLayerNetwork(conf, device=device).init()


def test_lstm_tbptt_on_the_card_matches_the_cpu(cuda):
    """Forward and one tBPTT fit (windows of 8, back 5: the leading steps
    of each full window run without gradient) on ragged masked rows."""
    import numpy as np
    from deeplearning4j_tpu_torch.datasets import DataSet
    card, cpu = _lstm_net(cuda), _lstm_net("cpu")
    cpu.set_flat_params(card.get_flat_params())
    rng = np.random.RandomState(4)
    x = rng.randn(5, 19, 7).astype(np.float32)
    fm = (np.arange(19)[None, :] < np.array([19, 6, 12, 19, 15])[:, None]
          ).astype(np.float32)
    y = np.eye(5, dtype=np.float32)[rng.randint(0, 5, (5, 19))]
    outs = [net.output(x, features_mask=fm).cpu() for net in (card, cpu)]
    assert _rel(*outs) <= 1e-5
    for net in (card, cpu):
        net.fit(DataSet(x, y, features_mask=fm, labels_mask=fm))
    assert card.iteration == cpu.iteration == 3
    assert abs(card.score() - cpu.score()) <= 1e-5 * abs(cpu.score())
    assert _rel(torch.as_tensor(card.get_flat_params()),
                torch.as_tensor(cpu.get_flat_params())) <= 1e-5


def test_lstm_golden_restores_on_the_card(cuda):
    import copy
    from pathlib import Path
    import numpy as np
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.utils import model_serializer as ms
    fixtures = Path(__file__).resolve().parent / "fixtures" / "regression"
    golden = np.load(fixtures / "lstm_rmsprop_tbptt_golden.npz")
    x = golden["input"]
    zip_path = fixtures / "lstm_rmsprop_tbptt.zip"
    net = ms.restore_multi_layer_network(zip_path)
    assert net.device.type == "cuda" and net._pol().name == "mixed_bf16"
    np.testing.assert_allclose(net.output(x).cpu().numpy(),
                               golden["prediction"], rtol=0, atol=5e-3)
    cpu = ms.restore_multi_layer_network(zip_path, device="cpu")
    conf = copy.deepcopy(cpu.conf)
    conf.conf.compute_dtype = "float32"
    net32 = MultiLayerNetwork(conf, device=cuda).init()
    net32.set_flat_params(cpu.get_flat_params())
    net32.set_flat_updater_state(cpu.get_flat_updater_state())
    net32.iteration = cpu.iteration
    np.testing.assert_allclose(net32.output(x).cpu().numpy(),
                               golden["prediction"], rtol=1e-5, atol=1e-7)
    y = np.eye(5, dtype=np.float32)[
        np.random.RandomState(3).randint(0, 5, (2, 6))]
    for n in (net, net32, cpu):
        n.fit(DataSet(x, y))
    assert net.iteration == net32.iteration == 4
    assert np.isfinite(net.score())
    assert _rel(torch.as_tensor(net32.get_flat_params()),
                torch.as_tensor(cpu.get_flat_params())) <= 1e-5


# ---- the training harness -------------------------------------------------
# evaluate() on the card against the CPU port: a small LeNet in fp32 from
# the same weights gives the same confusion matrix, and the top-1 route
# moves 4 bytes a row (int32 class indices).  The data are seeded images
# labelled by a fixed linear map (the procedural MNIST is held in
# tests/test_torch_datasets.py).

def _small_lenet(device):
    from deeplearning4j_tpu_torch.nn.conf import inputs
    from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import \
        NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers.convolution import (
        ConvolutionLayer, SubsamplingLayer)
    from deeplearning4j_tpu_torch.nn.layers.core import (DenseLayer,
                                                         OutputLayer)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    conf = (NeuralNetConfiguration.builder().seed(123).updater("adam")
            .learning_rate(1e-3).weight_init("xavier")
            .activation("identity").compute_dtype("float32").list()
            .layer(ConvolutionLayer(n_out=4, kernel_size=(5, 5)))
            .layer(SubsamplingLayer(pooling_type="max"))
            .layer(ConvolutionLayer(n_out=8, kernel_size=(5, 5)))
            .layer(SubsamplingLayer(pooling_type="max"))
            .layer(DenseLayer(n_out=32, activation="relu"))
            .layer(OutputLayer(n_out=10, activation="softmax",
                               loss="mcxent"))
            .set_input_type(inputs.convolutional_flat(28, 28, 1)).build())
    return MultiLayerNetwork(conf, device=device).init()


def test_evaluate_on_the_card_matches_the_cpu(cuda):
    import numpy as np
    from deeplearning4j_tpu_torch import monitor
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.datasets.iterators import \
        ListDataSetIterator
    card, cpu = _small_lenet(cuda), _small_lenet("cpu")
    cpu.set_flat_params(card.get_flat_params())
    rng = np.random.RandomState(5)
    x = rng.rand(300, 784).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[np.argmax(
        (x - 0.5) @ rng.randn(784, 10), axis=1)]
    evs = []
    for net in (card, cpu):
        evs.append(net.evaluate(ListDataSetIterator(DataSet(x, y), 64)))
        moved = monitor.registry().get("eval_bytes_transferred").value(
            path="indices")
        assert moved == 300 * 4
    np.testing.assert_array_equal(evs[0].confusion.matrix,
                                  evs[1].confusion.matrix)
    assert evs[0].stats() == evs[1].stats()


# ---- the ComputationGraph -------------------------------------------------
# No hand kernel of its own (cuDNN/cuBLAS and elementwise kernels through
# torch); an attention vertex trains through K1-K3 like the
# MultiLayerNetwork's layer.  The golden as the cnn_adam one above; the
# graph of every vertex type card vs CPU in fp32 at 1e-5 of max|CPU| (f32
# sums in another order; nesterovs passes differences on without
# normalizing them); the attention graph against its MultiLayerNetwork
# twin exactly (the same operations in the same order).

def test_graph_golden_restores_on_the_card(cuda):
    import copy
    from pathlib import Path
    import numpy as np
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn.computation_graph import \
        ComputationGraph
    from deeplearning4j_tpu_torch.utils import model_serializer as ms
    fixtures = Path(__file__).resolve().parent / "fixtures" / "regression"
    golden = np.load(fixtures / "graph_merge_nesterovs_golden.npz")
    x = golden["input"]
    zip_path = fixtures / "graph_merge_nesterovs.zip"
    net = ms.restore_computation_graph(zip_path)
    assert net.device.type == "cuda" and net._pol().name == "mixed_bf16"
    np.testing.assert_allclose(net.output(x).cpu().numpy(),
                               golden["prediction"], rtol=0, atol=5e-3)
    cpu = ms.restore_computation_graph(zip_path, device="cpu")
    conf = copy.deepcopy(cpu.conf)
    conf.conf.compute_dtype = "float32"
    net32 = ComputationGraph(conf, device=cuda).init()
    net32.set_flat_params(cpu.get_flat_params())
    net32.set_flat_updater_state(cpu.get_flat_updater_state())
    np.testing.assert_allclose(net32.output(x).cpu().numpy(),
                               golden["prediction"], rtol=1e-5, atol=1e-7)
    y = np.eye(3, dtype=np.float32)[[0, 1, 2, 0]]
    for n in (net, net32, cpu):
        n.fit(DataSet(x, y))
    assert net.iteration == 2 and np.isfinite(net.score())
    assert _rel(torch.as_tensor(net32.get_flat_params()),
                torch.as_tensor(cpu.get_flat_params())) <= 1e-5


def _all_vertex_graph(device):
    from deeplearning4j_tpu_torch.nn.computation_graph import \
        ComputationGraph
    from deeplearning4j_tpu_torch.nn.conf import computation_graph as cg
    from deeplearning4j_tpu_torch.nn.conf import inputs
    from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import \
        NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.preprocessors import \
        FeedForwardToCnnPreProcessor
    from deeplearning4j_tpu_torch.nn.layers.core import (DenseLayer,
                                                         OutputLayer)
    from deeplearning4j_tpu_torch.nn.layers.recurrent import (
        GravesLSTM, RnnOutputLayer)
    g = (NeuralNetConfiguration.builder().seed(3).updater("nesterovs")
         .learning_rate(0.0625).activation("tanh").l2(1e-3)
         .compute_dtype("float32").graph_builder().add_inputs("seq", "vec")
         .add_layer("lstm", GravesLSTM(n_out=6), "seq")
         .add_vertex("last", cg.LastTimeStepVertex(mask_input="seq"), "lstm")
         .add_layer("dv", DenseLayer(n_out=6), "vec"))
    for op in ("add", "subtract", "product", "average", "max"):
        g.add_vertex(op, cg.ElementWiseVertex(op=op), "last", "dv")
    conf = (g.add_vertex("merge", cg.MergeVertex(), "add", "subtract",
                         "product", "average", "max")
            .add_vertex("subset", cg.SubsetVertex(from_index=2, to_index=13),
                        "merge")
            .add_vertex("scale", cg.ScaleVertex(scale_factor=0.5), "subset")
            .add_vertex("shift", cg.ShiftVertex(shift_factor=0.1), "scale")
            .add_vertex("l2n", cg.L2NormalizeVertex(), "shift")
            .add_vertex("stack", cg.StackVertex(), "l2n", "shift")
            .add_layer("shared", DenseLayer(n_out=5), "stack")
            .add_vertex("u0", cg.UnstackVertex(from_index=0, stack_size=2),
                        "shared")
            .add_vertex("u1", cg.UnstackVertex(from_index=1, stack_size=2),
                        "shared")
            .add_vertex("l2", cg.L2Vertex(), "u0", "u1")
            .add_vertex("img", cg.PreprocessorVertex(
                preprocessor=FeedForwardToCnnPreProcessor(2, 2, 3)), "shift")
            .add_layer("flat", DenseLayer(n_out=4), "img")
            .add_vertex("head_in", cg.MergeVertex(), "l2", "u1", "flat")
            .add_layer("ffout", OutputLayer(n_out=2), "head_in")
            .add_vertex("dup", cg.DuplicateToTimeSeriesVertex(
                reference_input="seq"), "flat")
            .add_vertex("seqm", cg.MergeVertex(), "lstm", "dup")
            .add_layer("rnnout", RnnOutputLayer(n_out=3), "seqm")
            .set_outputs("rnnout", "ffout")
            .set_input_types(inputs.recurrent(3, 7), inputs.feed_forward(4))
            .build())
    return ComputationGraph(conf, device=device).init()


def test_all_vertex_graph_on_the_card_matches_the_cpu(cuda):
    import numpy as np
    from deeplearning4j_tpu_torch.datasets import MultiDataSet
    card, cpu = _all_vertex_graph(cuda), _all_vertex_graph("cpu")
    cpu.set_flat_params(card.get_flat_params())
    rng = np.random.RandomState(6)
    x1 = rng.randn(8, 7, 3).astype(np.float32)
    x2 = rng.randn(8, 4).astype(np.float32)
    fm = (np.arange(7)[None] < rng.randint(1, 8, 8)[:, None]).astype(
        np.float32)
    mds = MultiDataSet([x1, x2], [
        np.eye(3, dtype=np.float32)[rng.randint(0, 3, (8, 7))],
        np.eye(2, dtype=np.float32)[rng.randint(0, 2, 8)]], [fm, None],
        [fm, None])
    for a, b in zip(card.output(x1, x2, features_masks=[fm, None]),
                    cpu.output(x1, x2, features_masks=[fm, None])):
        assert _rel(a.cpu(), b) <= 1e-5
    for _ in range(3):
        card.fit(mds)
        cpu.fit(mds)
    assert abs(card.score() - cpu.score()) <= 1e-5 * abs(cpu.score())
    assert _rel(torch.as_tensor(card.get_flat_params()),
                torch.as_tensor(cpu.get_flat_params())) <= 1e-5


def test_attention_graph_equals_its_multilayer_twin_on_the_card(cuda):
    """CausalSelfAttention -> RnnOutputLayer as a graph and as a list, on
    the same weights under the card's mixed_bf16: the same params and
    scores after 2 steps, and K1-K3 once a step each on the graph."""
    import numpy as np
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn.computation_graph import \
        ComputationGraph
    from deeplearning4j_tpu_torch.nn.conf import inputs
    from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import \
        NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers.attention import \
        CausalSelfAttention
    from deeplearning4j_tpu_torch.nn.layers.recurrent import RnnOutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    def builder():
        return (NeuralNetConfiguration.builder().seed(4).updater("adam")
                .learning_rate(1e-3))

    attn = dict(n_out=64, n_heads=2, cache_len=256)
    head = dict(n_out=8, activation="softmax", loss="mcxent")
    twin = MultiLayerNetwork(
        builder().list().layer(CausalSelfAttention(**attn))
        .layer(RnnOutputLayer(**head))
        .set_input_type(inputs.recurrent(16, 256)).build()).init()
    graph = ComputationGraph(
        builder().graph_builder().add_inputs("in")
        .add_layer("attn", CausalSelfAttention(**attn), "in")
        .add_layer("out", RnnOutputLayer(**head), "attn")
        .set_outputs("out").set_input_types(inputs.recurrent(16, 256))
        .build()).init()
    graph.set_flat_params(twin.get_flat_params())
    rng = np.random.RandomState(7)
    ds = DataSet(rng.randn(2, 256, 16).astype(np.float32),
                 np.eye(8, dtype=np.float32)[rng.randint(0, 8, (2, 256))])
    for _ in range(2):
        twin.fit(ds)
    A.reset_launches()
    for _ in range(2):
        graph.fit(ds)
    assert A.LAUNCHES == {"flash_fwd": 2, "flash_fwd_partials": 0,
                          "flash_bwd_dkdv": 2, "flash_bwd_dq": 2}
    assert graph.score() == twin.score()
    np.testing.assert_array_equal(graph.get_flat_params(),
                                  twin.get_flat_params())


@pytest.mark.parametrize("model", ["lenet", "attention"])
def test_the_captured_cache_path_equals_the_eager_steps(cuda, model):
    """The epoch cache on the card replays one captured CUDA graph a step
    (``nn/step_graph.py``): 4 steps of it equal 4 eager per-batch steps
    over the same batches bit for bit (fp32 LeNet with cuDNN's
    deterministic algorithms; the attention network under mixed_bf16,
    where K1-K3 launch inside the graph).  A replay runs no wrapper, so
    the wrapper counts of a fit of replays are 0; the profiler's kernel
    names count K1-K3 there, as many as the eager steps' wrappers."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    import numpy as np
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.datasets.iterators import \
        ListDataSetIterator
    from deeplearning4j_tpu_torch.models.lenet import lenet
    from deeplearning4j_tpu_torch.nn.conf import inputs
    from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import \
        NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers.attention import \
        CausalSelfAttention
    from deeplearning4j_tpu_torch.nn.layers.recurrent import RnnOutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    rng = np.random.RandomState(9)
    if model == "lenet":
        def build():
            return MultiLayerNetwork(lenet(compute_dtype="float32")).init()
        ds = DataSet(rng.rand(4 * 32, 784).astype(np.float32),
                     np.eye(10, dtype=np.float32)[rng.randint(0, 10, 128)])
        batch = 32
    else:
        def build():
            return MultiLayerNetwork(
                NeuralNetConfiguration.builder().seed(4).updater("adam")
                .learning_rate(1e-3).list()
                .layer(CausalSelfAttention(n_out=64, n_heads=2,
                                           cache_len=256))
                .layer(RnnOutputLayer(n_out=8, activation="softmax",
                                      loss="mcxent"))
                .set_input_type(inputs.recurrent(16, 256)).build()).init()
        ds = DataSet(rng.randn(8, 256, 16).astype(np.float32),
                     np.eye(8, dtype=np.float32)[rng.randint(0, 8,
                                                             (8, 256))])
        batch = 2
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        eager, captured = build(), build()
        eager.fit(ListDataSetIterator(ds, batch), ingest="batch")
        captured.fit(ListDataSetIterator(ds, batch), ingest="cache")
        assert captured._graphs
        A.reset_launches()
        eager.fit(ListDataSetIterator(ds, batch), ingest="batch")
        eager_launches = dict(A.LAUNCHES)
        for counter in ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq"):
            assert A.BODY_LAUNCHES[counter]["sm90"] == \
                eager_launches[counter]
        A.reset_launches()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            captured.fit(ListDataSetIterator(ds, batch), ingest="cache")
            torch.cuda.synchronize()
        assert set(A.LAUNCHES.values()) == {0}
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = flags
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    # K1-K3 on the Hopper bodies (mixed_bf16 q/k/v), in the replays as
    # eagerly
    for counter, kernel in (("flash_fwd", "flash_fwd_sm90_kernel"),
                            ("flash_bwd_dkdv", "flash_bwd_dkdv_sm90_kernel"),
                            ("flash_bwd_dq", "flash_bwd_dq_sm90_kernel")):
        assert sum(1 for n in names if kernel in n) == \
            eager_launches[counter]
        assert A.BODY_LAUNCHES[counter]["sm90"] == 0   # no wrapper ran
    for kernel in ("flash_fwd_kernel", "flash_bwd_dkdv_kernel",
                   "flash_bwd_dq_kernel"):
        assert not any(kernel in n for n in names)
    if model == "attention":
        assert eager_launches["flash_fwd"] == 4
    np.testing.assert_array_equal(captured.get_flat_params(),
                                  eager.get_flat_params())
    np.testing.assert_array_equal(captured.get_flat_updater_state(),
                                  eager.get_flat_updater_state())
    assert captured.score() == eager.score()


@pytest.mark.parametrize("container", ["mln", "graph"])
def test_fit_scan_equals_the_per_batch_steps(cuda, container):
    """``fit_scan`` stages its stacked batches on a side stream and waits
    for the copy's event before its steps: 4 steps of it equal 4
    per-batch ``fit`` steps on the card bit for bit (fp32 LeNet under
    cuDNN's deterministic algorithms; the attention graph under
    mixed_bf16, K1-K3 once a step)."""
    import numpy as np
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.models.lenet import lenet
    from deeplearning4j_tpu_torch.nn.computation_graph import \
        ComputationGraph
    from deeplearning4j_tpu_torch.nn.conf import inputs
    from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import \
        NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers.attention import \
        CausalSelfAttention
    from deeplearning4j_tpu_torch.nn.layers.recurrent import RnnOutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    rng = np.random.RandomState(11)
    if container == "mln":
        def build():
            return MultiLayerNetwork(lenet(compute_dtype="float32")).init()
        batches = [DataSet(rng.rand(64, 784).astype(np.float32),
                           np.eye(10, dtype=np.float32)[
                               rng.randint(0, 10, 64)]) for _ in range(4)]
    else:
        def build():
            return ComputationGraph(
                NeuralNetConfiguration.builder().seed(4).updater("adam")
                .learning_rate(1e-3).graph_builder().add_inputs("in")
                .add_layer("attn", CausalSelfAttention(
                    n_out=64, n_heads=2, cache_len=256), "in")
                .add_layer("out", RnnOutputLayer(
                    n_out=8, activation="softmax", loss="mcxent"), "attn")
                .set_outputs("out")
                .set_input_types(inputs.recurrent(16, 256)).build()).init()
        batches = [DataSet(rng.randn(2, 256, 16).astype(np.float32),
                           np.eye(8, dtype=np.float32)[
                               rng.randint(0, 8, (2, 256))])
                   for _ in range(4)]
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        scanned, eager = build(), build()
        A.reset_launches()
        scores = scanned.fit_scan(batches)
        scan_launches = dict(A.LAUNCHES)
        eager_scores = []
        for ds in batches:
            eager.fit(ds)
            eager_scores.append(eager.score())
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = flags
    if container == "graph":
        assert scan_launches == {"flash_fwd": 4, "flash_fwd_partials": 0,
                                 "flash_bwd_dkdv": 4, "flash_bwd_dq": 4}
    np.testing.assert_array_equal(scores, np.asarray(eager_scores,
                                                     scores.dtype))
    np.testing.assert_array_equal(scanned.get_flat_params(),
                                  eager.get_flat_params())
    np.testing.assert_array_equal(scanned.get_flat_updater_state(),
                                  eager.get_flat_updater_state())


def test_a_frozen_lenet_trunk_stays_bitwise_in_the_captured_cache(cuda):
    """A LeNet-5 fine-tune with its convolutional trunk frozen (layers
    0-3) and a new 5-class head, trained through fit(iterator)'s default:
    the epoch cache replays one captured CUDA graph a step, the trunk
    stays bit for bit, and the params equal the eager per-batch steps
    over the same batches (fp32, cuDNN's deterministic algorithms)."""
    import numpy as np
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.datasets.iterators import \
        ListDataSetIterator
    from deeplearning4j_tpu_torch.models.lenet import lenet
    from deeplearning4j_tpu_torch.nn.layers.core import OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.transfer import TransferLearning
    src = MultiLayerNetwork(lenet(compute_dtype="float32")).init()

    def tuned():
        return (TransferLearning.builder(src).set_feature_extractor(3)
                .remove_output_layer()
                .add_layer(OutputLayer(n_in=src.layers[-1].n_in, n_out=5))
                .build())

    rng = np.random.RandomState(3)
    ds = DataSet(rng.rand(4 * 32, 784).astype(np.float32),
                 np.eye(5, dtype=np.float32)[rng.randint(0, 5, 128)])
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        captured, eager = tuned(), tuned()
        eager.set_flat_params(captured.get_flat_params())
        trunk = [{k: v.clone() for k, v in captured.params[i].items()}
                 for i in range(4)]
        captured.fit(ListDataSetIterator(ds, 32), epochs=2)
        eager.fit(ListDataSetIterator(ds, 32), epochs=2, ingest="batch")
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = flags
    assert captured._graphs and captured.iteration == 8
    for i, tree in enumerate(trunk):
        assert captured.layers[i].frozen
        for k, v in tree.items():
            assert torch.equal(captured.params[i][k], v), (i, k)
            assert torch.equal(src.params[i][k], v), (i, k)
    np.testing.assert_array_equal(captured.get_flat_params(),
                                  eager.get_flat_params())


# Embeddings: one device-pipeline pass on the card against the same pass
# on the CPU, from the same tables and the same draws (host_draws).  On
# the card index_add_ accumulates duplicate rows by atomics and the
# einsums run on cuBLAS, so the sums come in another order: the tables
# are held to 2e-5 of max|CPU| (fp32; on the CPU a reordering of the
# duplicate sums alone, the aggregated route against the plain one, moves
# these one-pass tables by up to 2.5e-6 of their largest entry).  Under
# torch.use_deterministic_algorithms(True) two passes on the card are
# bitwise equal.
EMB_REF_RTOL = 2e-5
EMB_CASES = {
    "skipgram_ns": dict(use_hierarchic_softmax=False, negative=4),
    "skipgram_hs": dict(use_hierarchic_softmax=True, negative=0),
    "cbow_hs_ns": dict(use_hierarchic_softmax=True, negative=3,
                       elements_learning_algorithm="cbow"),
}


def _emb_pass(device, case):
    import numpy as np
    from deeplearning4j_tpu_torch.nlp.device_corpus import host_draws
    from deeplearning4j_tpu_torch.nlp.word2vec import SequenceVectors
    rng = np.random.RandomState(0)
    zipf = np.minimum(rng.zipf(1.3, 6000) - 1, 47)
    seqs = [["w%d" % w for w in zipf[i:i + 30]] for i in range(0, 6000, 30)]
    sv = SequenceVectors(layer_size=16, window_size=3, epochs=1,
                         batch_size=256, seed=5, sampling=2e-2,
                         pair_generation="device", device=device,
                         **EMB_CASES[case])
    sv.draw_source = host_draws(7)
    sv.fit(seqs)
    lt = sv.lookup_table
    return {n: getattr(lt, n).cpu() for n in ("syn0", "syn1", "syn1neg")
            if getattr(lt, n) is not None}, sv._device_pipeline_stats


@pytest.mark.parametrize("case", sorted(EMB_CASES))
def test_device_corpus_pass_on_the_card_matches_the_cpu(cuda, case):
    import os
    card, card_stats = _emb_pass("cuda", case)
    cpu, cpu_stats = _emb_pass("cpu", case)
    assert card_stats["pairs_trained"] == cpu_stats["pairs_trained"] > 0
    for name, want in cpu.items():
        err = (card[name] - want).abs().max().item()
        assert err <= EMB_REF_RTOL * want.abs().max().item(), (name, err)
    env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        first, _ = _emb_pass("cuda", case)
        second, _ = _emb_pass("cuda", case)
    finally:
        torch.use_deterministic_algorithms(False)
        if env is None:
            del os.environ["CUBLAS_WORKSPACE_CONFIG"]
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = env
    for name in first:
        assert torch.equal(first[name], second[name]), name


# DeepWalk: one device-walk epoch and one host-walk epoch of a small
# two-community graph on the card against the same epochs on the CPU,
# from the same tables and, for the device walks, the same draws
# (graph.deepwalk.host_walk_draws).  The walks and the pair grid are
# integer work and must be bitwise equal; the tables are held to
# EMB_REF_RTOL of max|CPU| (atomic index_add_ order, cuBLAS einsums), and
# two epochs on the card under deterministic algorithms are bitwise equal.
def _two_communities(size=150, intra=1500, cross=20, seed=0):
    import numpy as np
    from deeplearning4j_tpu_torch.graph import Graph
    rng = np.random.RandomState(seed)
    g = Graph(2 * size)
    for c in (0, size):
        a = rng.randint(0, size, intra) + c
        b = rng.randint(0, size, intra) + c
        for i, j in zip(a, b):
            if i != j:
                g.add_edge(int(i), int(j))
    for i, j in zip(rng.randint(0, size, cross),
                    rng.randint(size, 2 * size, cross)):
        g.add_edge(int(i), int(j))
    return g


def _dw_epoch(device, route, monkeypatch):
    from deeplearning4j_tpu_torch.graph.deepwalk import (DeepWalk,
                                                         host_walk_draws)
    g = _two_communities()
    dw = DeepWalk(vector_size=32, window_size=2, learning_rate=0.05, seed=7,
                  batch_size=512, device=device)
    dw.initialize(g)
    dw.draw_source = host_walk_draws(11)
    monkeypatch.setenv("DL4J_TPU_DEVICE_WALKS",
                       "1" if route == "device" else "0")
    dw.fit(g, walk_length=20, epochs=1)
    assert dw._walk_stats["route"] == route
    return {"syn0": dw.syn0.cpu(), "syn1": dw.syn1.cpu()}, dw._cum_loss


def test_device_walks_on_the_card_equal_the_cpu(cuda):
    import numpy as np
    from deeplearning4j_tpu_torch.graph.deepwalk import (device_walks,
                                                         host_walk_draws,
                                                         walk_pair_grid)
    g = _two_communities()
    indptr, indices, _ = g.csr()
    starts, u = host_walk_draws(11)(g.num_vertices(), 20, 0)
    out = {}
    for key, dev in (("cpu", "cpu"), ("card", cuda)):
        walks = device_walks(
            torch.from_numpy(indptr.astype(np.int32)).to(dev),
            torch.from_numpy(indices.astype(np.int32)).to(dev),
            starts.to(dev), u.to(dev))
        out[key] = [walks.cpu()] + [t.cpu() for t in
                                    walk_pair_grid(walks, 2, 512)]
    for a, b in zip(out["cpu"], out["card"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("route", ["device", "host"])
def test_deepwalk_epoch_on_the_card_matches_the_cpu(cuda, route,
                                                    monkeypatch):
    import os
    card, card_loss = _dw_epoch("cuda", route, monkeypatch)
    cpu, cpu_loss = _dw_epoch("cpu", route, monkeypatch)
    for name, want in cpu.items():
        err = (card[name] - want).abs().max().item()
        assert err <= EMB_REF_RTOL * want.abs().max().item(), (name, err)
    assert abs(card_loss - cpu_loss) <= EMB_REF_RTOL * abs(cpu_loss)
    env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        first, _ = _dw_epoch("cuda", route, monkeypatch)
        second, _ = _dw_epoch("cuda", route, monkeypatch)
    finally:
        torch.use_deterministic_algorithms(False)
        if env is None:
            del os.environ["CUBLAS_WORKSPACE_CONFIG"]
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = env
    for name in first:
        assert torch.equal(first[name], second[name]), name


def test_deepwalk_defaults_to_the_card(cuda):
    from deeplearning4j_tpu_torch.graph import DeepWalk
    dw = DeepWalk(vector_size=8)
    assert dw.device.type == "cuda"
    dw.fit(_two_communities(size=20, intra=80, cross=2), walk_length=6)
    assert dw.syn0.device.type == "cuda" and dw._walk_stats["route"] == \
        "device"
    assert DeepWalk.Builder().build().device.type == "cuda"


def _pretrain_pair(build, seed=21):
    """``build(device)`` on the card and on the CPU, the CPU net on the
    card's weights, both drawing from one CPU stream."""
    from deeplearning4j_tpu_torch.nn.layers.pretrain import \
        host_pretrain_draws
    card, cpu = build("cuda"), build("cpu")
    cpu.set_flat_params(card.get_flat_params())
    for net in (card, cpu):
        net.pretrain_draw_source = host_pretrain_draws(seed)
    return card, cpu


@pytest.mark.parametrize("case", ["autoencoder", "rbm_gaussian",
                                  "vae_composite", "graph"])
def test_pretraining_on_the_card_matches_the_cpu(cuda, case):
    """The pretraining layers, fp32, card against CPU on the same draws:
    params within 1e-5 of max|CPU| after a few pretrain steps (and, for
    the graph, a pretrain(True) fit)."""
    import numpy as np
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn.computation_graph import \
        ComputationGraph
    from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import \
        NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import pretrain as P
    from deeplearning4j_tpu_torch.nn.layers import variational as V
    from deeplearning4j_tpu_torch.nn.layers.core import OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    rng = np.random.RandomState(5)
    x = rng.rand(32, 12).astype(np.float32)
    x[:, 8:] = x[:, 8:] > 0.5
    y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, 32)]
    layers = {
        "autoencoder": P.AutoEncoder(n_in=12, n_out=6, corruption_level=0.3,
                                     sparsity=0.1),
        "rbm_gaussian": P.RBM(n_in=12, n_out=6, visible_unit="gaussian",
                              k=2),
        "vae_composite": V.VariationalAutoencoder(
            n_in=12, n_out=3, encoder_layer_sizes=(8,),
            decoder_layer_sizes=(8,), num_samples=2,
            reconstruction_distribution=V.CompositeReconstructionDistribution(
                parts=((8, V.GaussianReconstructionDistribution()),
                       (4, V.BernoulliReconstructionDistribution())))),
    }

    def build(device):
        # sgd: Adam's normalised step would magnify the f32 sums' order
        # into the update of a near-zero gradient; sigmoid: the
        # AutoEncoder's xent reconstruction clamps p at 1e-7, so a tanh
        # output near 0 would flip between clamped and a 1/p gradient
        b = (NeuralNetConfiguration.builder().seed(3).updater("sgd")
             .learning_rate(0.1).activation("sigmoid")
             .compute_dtype("float32"))
        if case == "graph":
            conf = (b.graph_builder().add_inputs("in")
                    .add_layer("ae", P.AutoEncoder(n_in=12, n_out=6),
                               "in")
                    .add_layer("out", OutputLayer(n_in=6, n_out=3), "ae")
                    .set_outputs("out").pretrain(True).build())
            return ComputationGraph(conf, device=device).init()
        return MultiLayerNetwork(b.list().layer(layers[case]).build(),
                                 device=device).init()

    card, cpu = _pretrain_pair(build)
    for net in (card, cpu):
        if case == "graph":
            net.fit(DataSet(x, y), epochs=2)
        else:
            net.pretrain(DataSet(x, y), epochs=4)
    want = cpu.get_flat_params()
    assert card.iteration == cpu.iteration > 0
    np.testing.assert_allclose(card.get_flat_params(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_center_loss_captured_step_equals_the_eager_steps(cuda):
    """A center-loss MLP, fp32: 4 steps from the epoch cache (captured) equal
    4 eager per-batch steps bit for bit, and one step moves cL by the
    reference delta on both paths."""
    import numpy as np
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.datasets.iterators import \
        ListDataSetIterator
    from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import \
        NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers.core import DenseLayer
    from deeplearning4j_tpu_torch.nn.layers.training import \
        CenterLossOutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    def build():
        return MultiLayerNetwork(
            NeuralNetConfiguration.builder().seed(2).updater("adam")
            .learning_rate(0.01).activation("relu").compute_dtype("float32")
            .list().layer(DenseLayer(n_in=10, n_out=16))
            .layer(CenterLossOutputLayer(n_in=16, n_out=4, alpha=0.2,
                                         lambda_=0.01)).build()).init()

    rng = np.random.RandomState(1)
    ds = DataSet(rng.randn(64, 10).astype(np.float32),
                 np.eye(4, dtype=np.float32)[rng.randint(0, 4, 64)])
    first = DataSet(ds.features[:16], ds.labels[:16])
    for path in ("batch", "cache"):
        net = build()
        feats = net.feed_forward(first.features)[-2].double().cpu().numpy()
        c0 = net.params[-1]["cL"].double().cpu().numpy()
        net.fit(ListDataSetIterator(first, 16), ingest=path)
        lab = first.labels.astype(np.float64)
        counts = lab.sum(0)
        want = c0 + 0.2 * (lab.T @ feats - counts[:, None] * c0) / (
            counts[:, None] + 1.0)
        np.testing.assert_allclose(net.params[-1]["cL"].double().cpu()
                                   .numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    eager, captured = build(), build()
    eager.fit(ListDataSetIterator(ds, 16), ingest="batch")
    captured.fit(ListDataSetIterator(ds, 16), ingest="cache")
    assert captured._graphs
    np.testing.assert_array_equal(captured.get_flat_params(),
                                  eager.get_flat_params())
    np.testing.assert_array_equal(captured.get_flat_updater_state(),
                                  eager.get_flat_updater_state())


def test_chaos_harness_on_the_card(cuda, tmp_path):
    """The kill/resume harness with its children on the card
    (deterministic algorithms): the victim killed, every score bitwise,
    the same final params."""
    from deeplearning4j_tpu_torch.resilience import chaos
    report = chaos.run_chaos(workdir=str(tmp_path), device="cuda")
    assert report["victim_returncode"] == -9, report
    assert report["score_mismatches"] == 0 and report["coverage_ok"], report
    assert report["params_match"] and report["parity"], report
    assert report["device"].startswith("cuda")


# ---- serving v2 and deployment on the card (chip_smoke.py phase 18) -------

def _dense_net(seed, device, width=256, dtype="float32"):
    from deeplearning4j_tpu_torch.nn.conf import inputs
    from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import \
        NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers.core import DenseLayer, \
        OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    conf = (NeuralNetConfiguration.builder().seed(seed)
            .compute_dtype(dtype).list()
            .layer(DenseLayer(n_out=width)).layer(OutputLayer(n_out=10))
            .set_input_type(inputs.feed_forward(64)).build())
    return MultiLayerNetwork(conf, device=device).init()


def test_int8_decode_on_the_card_is_the_host_twin(cuda):
    """The three-op decode on the card is bitwise numpy's wire decode,
    and the int8 engine on the card answers within 1e-5 of the int8
    engine on the CPU (the same uint8 weights; f32 sums in another
    order)."""
    import numpy as np
    from deeplearning4j_tpu_torch.serving import InferenceEngine
    from deeplearning4j_tpu_torch.serving import quantize as Q
    card = _dense_net(3, "cuda")
    cpu = _dense_net(3, "cpu")
    cpu.set_flat_params(card.get_flat_params())
    qtree, specs = Q.quantize_tree(card.params)
    dev = Q._leaves(Q.dequantize_tree(qtree, specs))
    host = Q._leaves(Q.dequantize_host(qtree, specs))
    for got, want in zip(dev, host):
        np.testing.assert_array_equal(got.cpu().numpy(), want)
    x = np.random.RandomState(0).randn(4, 64).astype(np.float32)
    with InferenceEngine(card, max_batch_size=4, quantize="int8",
                         name="q-card") as ec, \
            InferenceEngine(cpu, max_batch_size=4, quantize="int8",
                            name="q-cpu") as eh:
        got, want = ec.predict(x), eh.predict(x)
        assert ec._placed_params(0)[0][0]["W"].device.type == "cuda"
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_registry_paging_on_the_card_frees_the_evicted_bytes(cuda):
    """Two nets under a budget of one and a half: every request pages one
    in and evicts the other, each evict drops memory_allocated by its
    model_bytes, and every answer is bitwise the answer before paging."""
    import numpy as np
    from deeplearning4j_tpu_torch.serving import (InferenceEngine,
                                                  ModelRegistry)
    torch.backends.cudnn.deterministic = True
    engines = {f"m{s}": InferenceEngine(_dense_net(s, "cuda", 2048),
                                        max_batch_size=2, name=f"m{s}")
               for s in (1, 2)}
    x = np.random.RandomState(1).randn(2, 64).astype(np.float32)
    refs = {}
    for n, e in engines.items():
        e.start()
        refs[n] = e.predict(x)
        e.release_device_buffers()
    per = engines["m1"].model_bytes()
    reg = ModelRegistry(hbm_budget_bytes=per + per // 2)
    try:
        for n, e in engines.items():
            reg.register(n, e, start=False)
        for i in range(4):
            n = f"m{1 + i % 2}"
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            got = reg.predict(n, x)
            torch.cuda.synchronize()
            np.testing.assert_array_equal(got, refs[n])
            # one copy paged in, one released: the net change is ~0, and
            # never a second resident copy
            assert abs(torch.cuda.memory_allocated() - before) < 0.1 * per
            assert reg.resident_bytes() <= per + per // 2
        other = engines["m1"]
        before = torch.cuda.memory_allocated()
        freed = other.release_device_buffers()
        assert before - torch.cuda.memory_allocated() >= 0.9 * freed
    finally:
        reg.stop_all()


def test_pinned_session_and_rollout_on_the_card(cuda, tmp_path):
    """A session opened before a promote keeps stepping its version,
    bitwise an engine holding the old weights; the rollout controller
    promotes a good version from the store and rolls back a garbage one
    with its bundle."""
    import os

    import numpy as np
    from deeplearning4j_tpu_torch.deploy import (RolloutController,
                                                 VersionedWeightStore)
    from deeplearning4j_tpu_torch.nn.conf import inputs
    from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import \
        NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers.recurrent import (
        GravesLSTM, RnnOutputLayer)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.serving import (InferenceEngine,
                                                  ModelRegistry)
    os.environ["DL4J_TPU_FLIGHT_DIR"] = str(tmp_path / "flight")

    def lstm(seed):
        conf = (NeuralNetConfiguration.builder().seed(seed)
                .compute_dtype("float32").list()
                .layer(GravesLSTM(n_out=32, activation="tanh"))
                .layer(RnnOutputLayer(n_out=5, activation="softmax",
                                      loss="mcxent"))
                .set_input_type(inputs.recurrent(8, 6)).build())
        return MultiLayerNetwork(conf, device="cuda").init()

    server, old, new = lstm(1), lstm(1), lstm(2)
    old.set_flat_params(server.get_flat_params())
    xs = np.random.RandomState(0).randn(2, 6, 8).astype(np.float32)
    store = VersionedWeightStore(str(tmp_path / "store"))
    reg = ModelRegistry()
    eng = reg.register("pin", InferenceEngine(server, max_batch_size=2,
                                              name="pin"))
    try:
        with InferenceEngine(old, max_batch_size=2, name="pin-old") as ref:
            for t in range(2):
                np.testing.assert_array_equal(
                    eng.predict_session("s", xs[:, t]),
                    ref.predict_session("s", xs[:, t]))
            store.publish(new.get_flat_params())
            ctl = RolloutController(reg, "pin", store, eval_features=xs,
                                    min_agreement=0.0, min_probe_rounds=1)
            assert [ctl.step(), ctl.step()] == ["push", "promote"]
            for t in range(2, 6):
                np.testing.assert_array_equal(
                    eng.predict_session("s", xs[:, t]),
                    ref.predict_session("s", xs[:, t]))
        assert eng.sessions.session_version("s") == 0
        with InferenceEngine(new, max_batch_size=2, name="pin-new") as ne:
            np.testing.assert_array_equal(eng.predict(xs), ne.predict(xs))
        store.publish(np.random.RandomState(3).randn(
            new.num_params()).astype(np.float32) * 100)
        ctl.min_agreement = 0.98
        assert [ctl.step(), ctl.step()] == ["push", "rollback"]
        assert "rollout_rollback" in ctl.last_bundle
        assert eng.active_version == 1
    finally:
        reg.stop_all()
        os.environ.pop("DL4J_TPU_FLIGHT_DIR", None)
