// Flash attention for Hopper (sm_90a): forward (K1) and its partials mode
// (K4), dK/dV backward (K2) and dQ backward (K3), hand-written CUDA behind
// a plain C interface.
//
// Replaces the Pallas TPU kernels of deeplearning4j_tpu/ops/attention.py:
//   K1 flash_fwd_kernel      <- _make_flash_kernel (modes "normalized" and
//                               "normalized_lse"), launched by _flash_forward
//   K4 flash_fwd_kernel      <- the same body in mode "partials", launched
//                               by flash_attention_partial
//   K2 flash_bwd_dkdv_kernel <- _make_dkdv_kernel + _bwd_tile, launched by
//                               flash_attention_bwd
//   K3 flash_bwd_dq_kernel   <- _make_dq_kernel + _bwd_tile, launched by
//                               flash_attention_bwd
// (bf16 calls whose rows TMA can address run the Hopper kernels
// flash_fwd_sm90_kernel, flash_bwd_dkdv_sm90_kernel and
// flash_bwd_dq_sm90_kernel instead; see below.)
//
// What bounds them on the H100: all four are bound by operations.  At the
// training shape (B=2, T=8192, H=4, d=64, causal) K1 does two T x T x d
// products over the causal half and moves ~34 MB, so its operations take
// ~7x longer than its bytes even at the bf16 tensor-core peak (0.069 ms);
// K2 does four such products (0.139 ms at the peak), K3 three (0.104 ms).
// K4 on one ring step of that shape does K1's two products over the whole
// Tq x Tk block (no causal half off the diagonal; 0.139 ms).
//
// What the design does about it.  In all four the (Tq, Tk) score matrix
// never reaches device memory: a thread block owns one tile of one
// (batch, head) slice and loops over the other side's tiles inside the
// block (the TPU's sequential third grid axis and its VMEM scratch become
// that loop and registers); causal blocks stop at the diagonal, halving
// the work.  K2 owns one k-tile per block, so dK and dV need no atomics,
// and dQ has its own kernel (K3): results are deterministic.
//
// - K1/K4 with bf16 q/k/v whose rows TMA can address (d a multiple of 8,
//   16-byte aligned bases and strides: every K1/K4 call of the training
//   path, the ring and the captured graphs) run the Hopper body of
//   flash_fwd_sm90.cuh: wgmma fed by TMA, one producer and two consumer
//   warpgroups; its note says what bounds K1/K4 and what it does about
//   it.  K2/K3 with bf16 q/k/v and dO whose rows TMA can address (every
//   K2/K3 call of those paths) run the Hopper bodies of
//   flash_bwd_sm90.cuh, built the same way.  dl4j_flash_fwd_route and
//   dl4j_flash_bwd_route export these choices, made by dtype, shape and
//   alignment only; the wrapper counts each body's launches by them.
// - For bf16 q/k/v (and a bf16 dO in K2/K3) on rows TMA cannot address
//   (d not a multiple of 8, rows off 16 bytes), the other bf16 bodies run
//   on the tensor cores: mma.sync
//   m16n8k16 bf16 x bf16 with f32 accumulation, operands from bf16 tiles in
//   shared memory through ldmatrix.  Each warp owns 16 rows of the block's
//   tile.  The score-side products leave P (and dS) in the accumulator
//   fragments, which, packed to bf16 pairs, are the A operand of the next
//   product (O += P V in K1/K4, the gradient products in K2/K3), so P and
//   dS never touch shared memory.  The streamed tiles (K/V in K1/K4 and
//   K3, Q/dO with their L and D rows in K2) arrive by 16-byte cp.async
//   copies, double buffered: the next tile is in flight while the current
//   one is computed.  Causal blocks start heaviest first (b*h on the
//   fastest grid axis, the q-tiles of K1/K4 and K3 in reverse), so the
//   longest blocks do not form the tail.  P and dS are rounded to bf16 as
//   operands, as the TPU kernel's default precision rounds P for its P V
//   dot and every GPU flash kernel does; S and dP are bf16 x bf16 products
//   summed in f32, and the softmax statistics (m, l, the logsumexp) stay
//   f32: l sums the unrounded p.
// - f32 inputs, and K2/K3 with an f32 dO and bf16 q (a cotangent that must
//   not be rounded), keep the scalar body: tiles staged in shared memory as
//   f32 and every product a scalar f32 FMA on a 16x16 thread grid where
//   each thread owns a 4x4 micro-tile.  That is the exact-f32 contract of
//   the fp32 reference network and of the f32 ring, which a bf16 operand
//   would break.  The choice is made at compile time (if constexpr on the
//   operand types), never at run time.
//
// Semantics kept from the TPU kernels: the -1e30 sentinel for masked
// scores with the `alive` guard (a row with no visible key yet contributes
// exact zeros), the 1e-30 clamp of the softmax denominator, the per-row
// logsumexp m + log(l) in the lse mode, the unnormalized f32 acc, m and l
// in the partials mode (a row that sees no key ends with 0, -1e30, 0), the
// backward's p = exp(s * scale - L) and ds = p * (dp - D) * scale under the
// mask (k < Tk) & (q < Tq) & (!causal || q >= k) (one device function,
// bwd_elem, for every backward body), and f32 gradients.  The q side (q,
// out, dO, dq; Tq rows) and the K/V side (k, v, dk, dv; Tk rows) carry
// their own length and strides, so one K/V segment of a longer sequence
// can be attended; causal masking then compares local positions (row i
// sees column j <= i), which is right on the diagonal step of a ring where
// both sides share their global offset.  Ragged lengths are masked in the
// kernels (no padding to block multiples), and the (B, T, H, d) strides
// are read directly (no transposes).

#include <cuda.h>             // CUtensorMap (the encode is reached at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

namespace {

constexpr int TILE = 64;        // rows of a q-tile and of a k-tile
constexpr int THREADS = 256;    // a 16 x 16 thread grid
constexpr int SUB = 4;          // each thread owns a 4 x 4 micro-tile
constexpr int PLD = TILE + 1;   // padded row length of a score tile
constexpr float NEG_INF = -1e30f;

using bf16 = __nv_bfloat16;

// One side of the attention: its rows and the element strides of its
// (B, T, H, d) tensors (stride 1 along d).
struct Side {
  int T;
  long long sb, st, sh;
};

struct Geom {
  int B, H, d;
  Side q;                       // q, out/acc, dO, dq; row statistics (B, Tq, H)
  Side k;                       // k, v, dk, dv
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ long long offset(const Side& s, int b, int t,
                                            int h) {
  return (long long)b * s.sb + (long long)t * s.st + (long long)h * s.sh;
}

// Rows [r0, r0 + TILE) of one (b, h) slice of a tensor of side `s` into a
// [TILE][DM + 1] f32 tile, zero beyond s.T and beyond d (zero rows and
// columns are inert in every product below).
template <typename T, int DM>
__device__ void load_tile(float* dst, const T* src, int r0, const Side& s,
                          int d, int b, int h) {
  for (int idx = threadIdx.x; idx < TILE * DM; idx += THREADS) {
    const int r = idx / DM, c = idx % DM, t = r0 + r;
    float val = 0.f;
    if (t < s.T && c < d) val = to_f32(src[offset(s, b, t, h) + c]);
    dst[r * (DM + 1) + c] = val;
  }
}

__device__ __forceinline__ long long row_index(const Geom& g, int b, int t,
                                               int h) {
  return ((long long)b * g.q.T + t) * g.H + h;
}

// Per-row statistics (B, Tq, H) f32 for q rows [r0, r0 + TILE).
__device__ void load_rows(float* dst, const float* src, int r0,
                          const Geom& g, int b, int h) {
  for (int r = threadIdx.x; r < TILE; r += THREADS) {
    const int t = r0 + r;
    dst[r] = t < g.q.T ? src[row_index(g, b, t, h)] : 0.f;
  }
}

// s[i][j] = sum_c A[ty + 16 i][c] * Bt[tx + 16 j][c]: one 4 x 4 micro-tile
// of A . Bt^T for two [TILE][DM + 1] tiles.
template <int DM>
__device__ __forceinline__ void product_tile(const float* A, const float* Bt,
                                             int ty, int tx,
                                             float s[SUB][SUB]) {
#pragma unroll
  for (int i = 0; i < SUB; ++i)
#pragma unroll
    for (int j = 0; j < SUB; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int c = 0; c < DM; ++c) {
    float a[SUB], bv[SUB];
#pragma unroll
    for (int i = 0; i < SUB; ++i) a[i] = A[(ty + 16 * i) * (DM + 1) + c];
#pragma unroll
    for (int j = 0; j < SUB; ++j) bv[j] = Bt[(tx + 16 * j) * (DM + 1) + c];
#pragma unroll
    for (int i = 0; i < SUB; ++i)
#pragma unroll
      for (int j = 0; j < SUB; ++j) s[i][j] = fmaf(a[i], bv[j], s[i][j]);
  }
}

// Reductions over the 16 threads (tx = 0..15) that share a row; they are
// one half of a warp.
__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ------------------------------------------------------ K1 / K4, scalar
// The forward's modes, as _make_flash_kernel names them; only the finalize
// differs.
enum FwdMode { NORMALIZED = 0, NORMALIZED_LSE = 1, PARTIALS = 2 };

// f32 q/k/v, q-tile qt of slice bh.  NORMALIZED writes out = acc / l in T;
// NORMALIZED_LSE also writes the logsumexp m + log(l) to `stat_a`;
// PARTIALS writes the unnormalized acc to `out` (f32) and m, l to
// `stat_a`, `stat_b`.
template <typename T, int DM, int MODE>
__device__ void fwd_scalar(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           std::conditional_t<MODE == PARTIALS, float, T>*
                               __restrict__ out,
                           float* __restrict__ stat_a,
                           float* __restrict__ stat_b, const Geom& g,
                           float scale, int causal, int bh, int qt,
                           float* smem) {
  constexpr int LD = DM + 1, DC = DM / 16;
  float* Qs = smem;
  float* Ks = Qs + TILE * LD;
  float* Vs = Ks + TILE * LD;
  float* Ps = Vs + TILE * LD;                  // [TILE][PLD]
  const int b = bh / g.H, h = bh % g.H;
  const int q0 = qt * TILE;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile<T, DM>(Qs, q, q0, g.q, g.d, b, h);
  float m[SUB], l[SUB], acc[SUB][DC];
#pragma unroll
  for (int i = 0; i < SUB; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }
  int nk = (g.k.T + TILE - 1) / TILE;
  if (causal) nk = min(nk, (q0 + TILE - 1) / TILE + 1);  // stop at diagonal

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * TILE;
    __syncthreads();                           // previous tile fully read
    load_tile<T, DM>(Ks, k, k0, g.k, g.d, b, h);
    load_tile<T, DM>(Vs, v, k0, g.k, g.d, b, h);
    __syncthreads();
    float s[SUB][SUB];
    product_tile<DM>(Qs, Ks, ty, tx, s);
#pragma unroll
    for (int i = 0; i < SUB; ++i) {
      const int qp = q0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < SUB; ++j) {
        const int kp = k0 + tx + 16 * j;
        const bool keep = kp < g.k.T && (!causal || qp >= kp);
        s[i][j] = keep ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = row_max16(mx);
      const float m_new = fmaxf(m[i], mx);
      const bool alive = m_new > NEG_INF * 0.5f;
      const float corr = alive ? expf(m[i] - m_new) : 0.f;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < SUB; ++j) {
        const float p = alive ? expf(s[i][j] - m_new) : 0.f;
        Ps[(ty + 16 * i) * PLD + tx + 16 * j] = p;
        rs += p;
      }
      rs = row_sum16(rs);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();                           // P tile complete
#pragma unroll 4
    for (int c = 0; c < TILE; ++c) {
      float vv[DC];
#pragma unroll
      for (int jd = 0; jd < DC; ++jd) vv[jd] = Vs[c * LD + tx + 16 * jd];
#pragma unroll
      for (int i = 0; i < SUB; ++i) {
        const float p = Ps[(ty + 16 * i) * PLD + c];
#pragma unroll
        for (int jd = 0; jd < DC; ++jd) acc[i][jd] = fmaf(p, vv[jd], acc[i][jd]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < SUB; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= g.q.T) continue;                 // ragged q rows: not written
    const long long base = offset(g.q, b, qp, h);
    const long long row = row_index(g, b, qp, h);
    if constexpr (MODE == PARTIALS) {
#pragma unroll
      for (int jd = 0; jd < DC; ++jd) {
        const int c = tx + 16 * jd;
        if (c < g.d) out[base + c] = acc[i][jd];
      }
      if (tx == 0) {
        stat_a[row] = m[i];
        stat_b[row] = l[i];
      }
    } else {
      const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int jd = 0; jd < DC; ++jd) {
        const int c = tx + 16 * jd;
        if (c < g.d) out[base + c] = from_f32<T>(acc[i][jd] / denom);
      }
      if (MODE == NORMALIZED_LSE && tx == 0) stat_a[row] = m[i] + logf(denom);
    }
  }
}

// ---------------------------------------------------- K2/K3 elementwise
// The backward's elementwise core (TPU _bwd_tile), one function for every
// body of K2 and K3: the mask in local positions, then
// p = exp(s * scale - L), exactly 0 where masked, and
// ds = p * (dp - D) * scale.  s * scale is rounded before L is taken away
// (no fused multiply-add), as the plain twin computes it, so that from the
// same S both round P and dS to bf16 alike.
__device__ __forceinline__ bool bwd_keep(int qp, int kp, const Geom& g,
                                         int causal) {
  return kp < g.k.T && qp < g.q.T && (!causal || qp >= kp);
}
__device__ __forceinline__ void bwd_elem(float s, float dp, float L, float D,
                                         bool keep, float scale, float& p,
                                         float& ds) {
  const float pv = keep ? expf(__fmul_rn(s, scale) - L) : 0.f;
  p = pv;
  ds = pv * (dp - D) * scale;
}

// ------------------------------------------------- K2/K3, scalar bodies
// f32 inputs, or bf16 q/k/v with an f32 dO.  For the (q-tile q0, k-tile
// k0) pair, this thread's 4 x 4 micro-tile of P and dS.
template <int DM>
__device__ __forceinline__ void bwd_tile(const float* Qs, const float* Ks,
                                         const float* Vs, const float* dOs,
                                         const float* Ls, const float* Ds,
                                         int q0, int k0, const Geom& g,
                                         float scale, int causal, int ty,
                                         int tx, float p[SUB][SUB],
                                         float ds[SUB][SUB]) {
  float s[SUB][SUB], dp[SUB][SUB];
  product_tile<DM>(Qs, Ks, ty, tx, s);
  product_tile<DM>(dOs, Vs, ty, tx, dp);
#pragma unroll
  for (int i = 0; i < SUB; ++i) {
    const int r = ty + 16 * i, qp = q0 + r;
#pragma unroll
    for (int j = 0; j < SUB; ++j)
      bwd_elem(s[i][j], dp[i][j], Ls[r], Ds[r],
               bwd_keep(qp, k0 + tx + 16 * j, g, causal), scale, p[i][j],
               ds[i][j]);
  }
}

// K2, k-tile kt of slice bh: dV += P^T dO and dK += dS^T Q over the
// q-tiles at or below the diagonal.  TO is dO's type: q's, or f32 when the
// cotangent arrives in f32 (it is never rounded below that).
template <typename T, typename TO, int DM>
__device__ void dkdv_scalar(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const TO* __restrict__ dout,
                            const float* __restrict__ L,
                            const float* __restrict__ Drow,
                            float* __restrict__ dk, float* __restrict__ dv,
                            const Geom& g, float scale, int causal, int bh,
                            int kt, float* smem) {
  constexpr int LD = DM + 1, DC = DM / 16;
  float* Ks = smem;
  float* Vs = Ks + TILE * LD;
  float* Qs = Vs + TILE * LD;
  float* dOs = Qs + TILE * LD;
  float* Ps = dOs + TILE * LD;                 // [TILE][PLD]
  float* dSs = Ps + TILE * PLD;                // [TILE][PLD]
  float* Ls = dSs + TILE * PLD;
  float* Ds = Ls + TILE;
  const int b = bh / g.H, h = bh % g.H;
  const int k0 = kt * TILE;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile<T, DM>(Ks, k, k0, g.k, g.d, b, h);
  load_tile<T, DM>(Vs, v, k0, g.k, g.d, b, h);
  float dk_acc[SUB][DC], dv_acc[SUB][DC];
#pragma unroll
  for (int i = 0; i < SUB; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;
  const int nq = (g.q.T + TILE - 1) / TILE;
  const int qt0 = causal ? k0 / TILE : 0;     // first q-tile on the diagonal

  for (int qt = qt0; qt < nq; ++qt) {
    const int q0 = qt * TILE;
    __syncthreads();
    load_tile<T, DM>(Qs, q, q0, g.q, g.d, b, h);
    load_tile<TO, DM>(dOs, dout, q0, g.q, g.d, b, h);
    load_rows(Ls, L, q0, g, b, h);
    load_rows(Ds, Drow, q0, g, b, h);
    __syncthreads();
    float p[SUB][SUB], ds[SUB][SUB];
    bwd_tile<DM>(Qs, Ks, Vs, dOs, Ls, Ds, q0, k0, g, scale, causal, ty, tx,
                 p, ds);
#pragma unroll
    for (int i = 0; i < SUB; ++i)
#pragma unroll
      for (int j = 0; j < SUB; ++j) {
        Ps[(ty + 16 * i) * PLD + tx + 16 * j] = p[i][j];
        dSs[(ty + 16 * i) * PLD + tx + 16 * j] = ds[i][j];
      }
    __syncthreads();
    // this thread: k rows ty + 16 i, columns tx + 16 jd
#pragma unroll 2
    for (int r = 0; r < TILE; ++r) {
      float qv[DC], dov[DC];
#pragma unroll
      for (int jd = 0; jd < DC; ++jd) {
        qv[jd] = Qs[r * LD + tx + 16 * jd];
        dov[jd] = dOs[r * LD + tx + 16 * jd];
      }
#pragma unroll
      for (int i = 0; i < SUB; ++i) {
        const float pp = Ps[r * PLD + ty + 16 * i];
        const float dd = dSs[r * PLD + ty + 16 * i];
#pragma unroll
        for (int jd = 0; jd < DC; ++jd) {
          dv_acc[i][jd] = fmaf(pp, dov[jd], dv_acc[i][jd]);
          dk_acc[i][jd] = fmaf(dd, qv[jd], dk_acc[i][jd]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < SUB; ++i) {
    const int kp = k0 + ty + 16 * i;
    if (kp >= g.k.T) continue;
    const long long base = offset(g.k, b, kp, h);
#pragma unroll
    for (int jd = 0; jd < DC; ++jd) {
      const int c = tx + 16 * jd;
      if (c < g.d) {
        dk[base + c] = dk_acc[i][jd];
        dv[base + c] = dv_acc[i][jd];
      }
    }
  }
}

// K3, q-tile qt of slice bh: dQ += dS K over the k-tiles up to the
// diagonal.
template <typename T, typename TO, int DM>
__device__ void dq_scalar(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const TO* __restrict__ dout,
                          const float* __restrict__ L,
                          const float* __restrict__ Drow,
                          float* __restrict__ dq, const Geom& g, float scale,
                          int causal, int bh, int qt, float* smem) {
  constexpr int LD = DM + 1, DC = DM / 16;
  float* Qs = smem;
  float* dOs = Qs + TILE * LD;
  float* Ks = dOs + TILE * LD;
  float* Vs = Ks + TILE * LD;
  float* dSs = Vs + TILE * LD;                 // [TILE][PLD]
  float* Ls = dSs + TILE * PLD;
  float* Ds = Ls + TILE;
  const int b = bh / g.H, h = bh % g.H;
  const int q0 = qt * TILE;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile<T, DM>(Qs, q, q0, g.q, g.d, b, h);
  load_tile<TO, DM>(dOs, dout, q0, g.q, g.d, b, h);
  load_rows(Ls, L, q0, g, b, h);
  load_rows(Ds, Drow, q0, g, b, h);
  float dq_acc[SUB][DC];
#pragma unroll
  for (int i = 0; i < SUB; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dq_acc[i][c] = 0.f;
  int nk = (g.k.T + TILE - 1) / TILE;
  if (causal) nk = min(nk, (q0 + TILE - 1) / TILE + 1);

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * TILE;
    __syncthreads();
    load_tile<T, DM>(Ks, k, k0, g.k, g.d, b, h);
    load_tile<T, DM>(Vs, v, k0, g.k, g.d, b, h);
    __syncthreads();
    float p[SUB][SUB], ds[SUB][SUB];
    bwd_tile<DM>(Qs, Ks, Vs, dOs, Ls, Ds, q0, k0, g, scale, causal, ty, tx,
                 p, ds);
#pragma unroll
    for (int i = 0; i < SUB; ++i)
#pragma unroll
      for (int j = 0; j < SUB; ++j)
        dSs[(ty + 16 * i) * PLD + tx + 16 * j] = ds[i][j];
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < TILE; ++c) {
      float kv[DC];
#pragma unroll
      for (int jd = 0; jd < DC; ++jd) kv[jd] = Ks[c * LD + tx + 16 * jd];
#pragma unroll
      for (int i = 0; i < SUB; ++i) {
        const float dd = dSs[(ty + 16 * i) * PLD + c];
#pragma unroll
        for (int jd = 0; jd < DC; ++jd)
          dq_acc[i][jd] = fmaf(dd, kv[jd], dq_acc[i][jd]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < SUB; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= g.q.T) continue;
    const long long base = offset(g.q, b, qp, h);
#pragma unroll
    for (int jd = 0; jd < DC; ++jd) {
      const int c = tx + 16 * jd;
      if (c < g.d) dq[base + c] = dq_acc[i][jd];
    }
  }
}

// ------------------------------------------------- tensor-core bodies
// bf16 q/k/v (and dO in K2/K3).  A block of TC_THREADS = 4 warps owns
// TC_ROWS = 64 rows (queries in K1/K4 and K3, keys in K2), 16 per warp,
// and streams the other side in tiles of FWD_BK (K1/K4) or TcCfg::BS
// (K2/K3) rows.
//
// Fragments of mma.sync.m16n8k16.row.col, for lane l of the warp with
// gr = l / 4 and gc = 2 * (l % 4):
//   A (16 x 16, row-major), 4 regs of 2 bf16:
//     a0 (row gr, cols gc, gc+1)     a1 (row gr+8, cols gc, gc+1)
//     a2 (row gr, cols gc+8, gc+9)   a3 (row gr+8, cols gc+8, gc+9)
//   B (16 x 8, "col"), 2 regs: b0 (k gc, gc+1; n gr), b1 (k gc+8, gc+9; n gr)
//   C (16 x 8 f32), 4 floats: c0, c1 (row gr, cols gc, gc+1),
//                             c2, c3 (row gr+8, cols gc, gc+1)
// So the C fragments of two neighbouring n-tiles, 2m (cols 16m..16m+7) and
// 2m+1 (cols 16m+8..16m+15), packed pairwise to bf16, ARE the A fragment
// of k-step m (k = 16m..16m+15) of the next product:
//   a0 = (C[2m].c0, C[2m].c1)    a1 = (C[2m].c2, C[2m].c3)
//   a2 = (C[2m+1].c0, C[2m+1].c1) a3 = (C[2m+1].c2, C[2m+1].c3)
// K1/K4's S = Q K^T gives P as the A operand of O += P V; K2's S^T = K Q^T
// and dP^T = V dO^T give P^T and dS^T (key rows, query columns) as the A
// operand of dV += P^T dO and dK += dS^T Q; K3's S = Q K^T and
// dP = dO V^T give dS as the A operand of dQ += dS K.
constexpr int TC_THREADS = 128;
constexpr int TC_ROWS = 64;
// keys of a K/V tile streamed by K1/K4 at every d: the forward holds no
// gradient accumulators, so a 16 x 128 f32 O and a 16 x 64 f32 S fit the
// registers; equal to the plain twin's block, since the running max, and
// so the rounding of P, depend on where the tiles start
constexpr int FWD_BK = TILE;

template <int DM>
struct TcCfg {
  // bf16 row length in shared memory: 16 bytes of pad put the 8 rows that
  // one ldmatrix phase reads on distinct banks
  static constexpr int LDS = DM + 8;
  static constexpr int KD = DM / 16;          // k-steps over d
  static constexpr int ND = DM / 8;           // n-tiles over d
  // rows of a streamed tile; the d=128 bucket takes 32 so that K2's two
  // 16 x 128 f32 accumulators, S and dP fit the registers without spills
  static constexpr int BS = DM <= 64 ? 64 : 32;
  // the owned rows' A fragments (K2: K, V; K3: Q, dO) held in registers
  // for the whole loop, else read again from shared memory per tile
  static constexpr bool REGS = DM <= 64;
  static constexpr size_t tiles = sizeof(bf16) * (2 * TC_ROWS + 4 * BS) * LDS;
  static constexpr size_t dkdv_smem = tiles + sizeof(float) * 4 * BS;
  static constexpr size_t dq_smem = tiles + sizeof(float) * 2 * TC_ROWS;
  // K1/K4: compiled for FWD_MINB blocks an SM.  At d <= 64 that is 4: 128
  // registers a thread and 16 warps an SM to hide the latency of the
  // max/exp chain between the two products (on an H100 clearly faster
  // than the 3 blocks that an unbounded build's registers allow), which
  // leaves no room to hold the Q fragments in registers: they are read
  // again from shared memory per tile.  d = 128 is held to 2 blocks an SM
  // by its shared memory anyway.  Shared memory: Q, then K and V
  // double-buffered.
  static constexpr int FWD_MINB = DM <= 64 ? 4 : 1;
  static constexpr size_t fwd_smem =
      sizeof(bf16) * (TC_ROWS + 4 * FWD_BK) * LDS;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async copies of `bytes` (the cp-size, or 0: zero fill) bytes.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Waits until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [r0, r0 + R) of one (b, h) slice of a bf16 tensor of side `s` into
// a [R][LDS] bf16 tile, zero past s.T and past d: 16-byte cp.async copies
// when `vec` (d % 8 == 0 and every row 16-byte aligned), else element by
// element.
template <int R, int DM>
__device__ __forceinline__ void stage_tile(bf16* dst,
                                           const bf16* __restrict__ src,
                                           int r0, const Side& s, int d,
                                           int b, int h, int vec) {
  constexpr int LDS = TcCfg<DM>::LDS;
  if (vec) {
    constexpr int CPR = DM / 8;                // 16-byte chunks per row
    for (int i = threadIdx.x; i < R * CPR; i += TC_THREADS) {
      const int r = i / CPR, c = (i % CPR) * 8, t = r0 + r;
      const bool in = t < s.T && c < d;
      cp_async16(dst + r * LDS + c, in ? src + offset(s, b, t, h) + c : src,
                 in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < R * DM; i += TC_THREADS) {
      const int r = i / DM, c = i % DM, t = r0 + r;
      dst[r * LDS + c] = (t < s.T && c < d) ? src[offset(s, b, t, h) + c]
                                            : __float2bfloat16(0.f);
    }
  }
}

// Per-row statistics (B, Tq, H) f32 for q rows [r0, r0 + R), zero past Tq.
template <int R>
__device__ __forceinline__ void stage_rows(float* dst,
                                           const float* __restrict__ src,
                                           int r0, const Geom& g, int b,
                                           int h) {
  for (int r = threadIdx.x; r < R; r += TC_THREADS) {
    const int t = r0 + r;
    const bool in = t < g.q.T;
    cp_async4(dst + r, in ? src + row_index(g, b, t, h) : src, in ? 4 : 0);
  }
}

// ldmatrix x4: lane l names one 16-byte row, lanes 8i..8i+7 the rows of
// 8 x 8 matrix i, which lands in r[i] (lane: row l/4, cols 2(l%4), +1; with
// .trans the transposed element pair).
__device__ __forceinline__ void ldsm4(uint32_t r[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm4_trans(uint32_t r[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// The A fragment at (row0, k0) of a row-major [row][k] tile.
template <int LDS>
__device__ __forceinline__ void frag_a(uint32_t a[4], const bf16* tile,
                                       int row0, int k0, int lane) {
  ldsm4(a, tile + (row0 + (lane & 15)) * LDS + k0 + (lane >> 4) * 8);
}
// B fragments of the n-tiles n0 and n0 + 8 at k-step k0, from a tile
// stored [n][k]: {b0, b1} of n0 in r[0], r[1], of n0 + 8 in r[2], r[3].
template <int LDS>
__device__ __forceinline__ void frag_b_nk(uint32_t r[4], const bf16* tile,
                                          int n0, int k0, int lane) {
  ldsm4(r, tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * LDS + k0 +
               ((lane >> 3) & 1) * 8);
}
// The same from a tile stored [k][n], through ldmatrix.trans.
template <int LDS>
__device__ __forceinline__ void frag_b_kn(uint32_t r[4], const bf16* tile,
                                          int k0, int n0, int lane) {
  ldsm4_trans(r, tile + (k0 + (lane & 15)) * LDS + n0 + (lane >> 4) * 8);
}

// c += a . b on the tensor cores, f32 accumulation.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 rounded to a bf16 pair, `lo` in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// k-step m's A fragment from the accumulators of n-tiles 2m, 2m + 1.
__device__ __forceinline__ void acc_to_a(uint32_t a[4], const float c0[4],
                                         const float c1[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Does the (q0, BQ) x (k0, BK) tile need the mask anywhere: a ragged edge,
// or a causal tile that reaches above the diagonal.
__device__ __forceinline__ bool tile_edge(int q0, int bq, int k0, int bk,
                                          const Geom& g, int causal) {
  return q0 + bq > g.q.T || k0 + bk > g.k.T || (causal && q0 < k0 + bk - 1);
}

// K1/K4 on the tensor cores, q-tile qt of slice bh.  Warp w owns query
// rows 16w..16w+15; per K/V tile it forms S = Q K^T, runs the streaming
// softmax on the accumulator fragments, packs P to bf16 pairs in
// registers as soon as it is formed (P never touches shared memory; the
// f32 S dies early, which keeps the body within 128 registers) and
// accumulates O += P V.  Lane l holds parts of rows gr and gr + 8
// (index hf = 0, 1); a row's 64 scores of a tile lie in the 4 lanes of its
// quad, so the row max is reduced over the quad (xor 1, 2) per tile.  The
// denominator l is kept per lane, over the lane's own columns (each step
// rescales every lane of a row by the same correction), and summed over
// the quad once, at the end.  The mask is (k < Tk) && (!causal || q >= k)
// in local positions; s * scale is rounded before the max is taken away
// (no fused multiply-add) and l sums the f32 p, as the plain twin computes
// them, so that from the same S both round the same P to bf16.  Only the
// finalize differs between the modes.
template <int DM, int MODE>
__device__ void fwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       std::conditional_t<MODE == PARTIALS, float, bf16>*
                           __restrict__ out,
                       float* __restrict__ stat_a, float* __restrict__ stat_b,
                       const Geom& g, float scale, int causal, int vec,
                       int bh, int qt, unsigned char* smem) {
  using C = TcCfg<DM>;
  constexpr int LDS = C::LDS, BK = FWD_BK, NK = BK / 8;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + TC_ROWS * LDS;               // [2][BK][LDS]
  bf16* Vs = Ks + 2 * BK * LDS;                // [2][BK][LDS]
  const int b = bh / g.H, h = bh % g.H;
  const int q0 = qt * TC_ROWS;
  const int lane = threadIdx.x & 31, wr = (threadIdx.x >> 5) * 16;
  const int gr = lane >> 2, gc = 2 * (lane & 3);
  int nk = (g.k.T + BK - 1) / BK;
  if (causal) nk = min(nk, (q0 + TC_ROWS - 1) / BK + 1);   // to the diagonal

  auto stage = [&](int kt, int buf) {
    stage_tile<BK, DM>(Ks + buf * BK * LDS, k, kt * BK, g.k, g.d, b, h, vec);
    stage_tile<BK, DM>(Vs + buf * BK * LDS, v, kt * BK, g.k, g.d, b, h, vec);
  };
  stage_tile<TC_ROWS, DM>(Qs, q, q0, g.q, g.d, b, h, vec);
  if (nk > 0) stage(0, 0);
  cp_async_commit();

  float oa[C::ND][4] = {};
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1, k0 = kt * BK;
    if (kt + 1 < nk) stage(kt + 1, buf ^ 1);   // next tile in flight
    cp_async_commit();
    cp_async_wait<1>();                        // this tile (and Q) landed
    __syncthreads();
    const bf16* Kb = Ks + buf * BK * LDS;
    const bf16* Vb = Vs + buf * BK * LDS;

    float s[NK][4] = {};                       // S: queries x keys
#pragma unroll
    for (int kd = 0; kd < C::KD; ++kd) {
      uint32_t aq[4];
      frag_a<LDS>(aq, Qs, wr, kd * 16, lane);
#pragma unroll
      for (int j = 0; j < NK; j += 2) {
        uint32_t bk[4];
        frag_b_nk<LDS>(bk, Kb, j * 8, kd * 16, lane);
        mma_bf16(s[j], aq, bk[0], bk[1]);
        mma_bf16(s[j + 1], aq, bk[2], bk[3]);
      }
    }
    // scale and mask; element c of n-tile j: query row wr + gr + 8 (c / 2),
    // key column 8 j + gc + c % 2
    const bool edge = tile_edge(q0, TC_ROWS, k0, BK, g, causal);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int hf = c >> 1, kp = k0 + j * 8 + gc + (c & 1);
        const bool keep =
            !edge || (kp < g.k.T && (!causal || q0 + wr + gr + 8 * hf >= kp));
        s[j][c] = keep ? __fmul_rn(s[j][c], scale) : NEG_INF;
        mx[hf] = fmaxf(mx[hf], s[j][c]);
      }
    bool alive[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
      const float m_new = fmaxf(m[hf], mx[hf]);
      alive[hf] = m_new > NEG_INF * 0.5f;
      const float corr = alive[hf] ? expf(m[hf] - m_new) : 0.f;
      m[hf] = m_new;
      l[hf] *= corr;
#pragma unroll
      for (int n = 0; n < C::ND; ++n) {
        oa[n][2 * hf] *= corr;
        oa[n][2 * hf + 1] *= corr;
      }
    }
    // P = exp(s - m), packed to bf16 pairs as the A operand, then O += P V
    uint32_t ap[BK / 16][4];
#pragma unroll
    for (int mm = 0; mm < BK / 16; ++mm) {
#pragma unroll
      for (int j = 2 * mm; j < 2 * mm + 2; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int hf = c >> 1;
          s[j][c] = alive[hf] ? expf(s[j][c] - m[hf]) : 0.f;
          l[hf] += s[j][c];
        }
      acc_to_a(ap[mm], s[2 * mm], s[2 * mm + 1]);
    }
#pragma unroll
    for (int mm = 0; mm < BK / 16; ++mm) {
#pragma unroll
      for (int n = 0; n < C::ND; n += 2) {
        uint32_t bv[4];
        frag_b_kn<LDS>(bv, Vb, mm * 16, n * 8, lane);
        mma_bf16(oa[n], ap[mm], bv[0], bv[1]);
        mma_bf16(oa[n + 1], ap[mm], bv[2], bv[3]);
      }
    }
    __syncthreads();                           // tile read: buf is free
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 1);
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 2);
    const int qp = q0 + wr + gr + 8 * hf;
    if (qp >= g.q.T) continue;                 // ragged q rows: not written
    const long long base = offset(g.q, b, qp, h);
    const long long row = row_index(g, b, qp, h);
    const bool writes_row = (lane & 3) == 0;
    if constexpr (MODE == PARTIALS) {
#pragma unroll
      for (int n = 0; n < C::ND; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n * 8 + gc + e;
          if (col < g.d) out[base + col] = oa[n][2 * hf + e];
        }
      if (writes_row) {
        stat_a[row] = m[hf];
        stat_b[row] = l[hf];
      }
    } else {
      const float denom = fmaxf(l[hf], 1e-30f);
#pragma unroll
      for (int n = 0; n < C::ND; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n * 8 + gc + e;
          if (col < g.d)
            out[base + col] = __float2bfloat16(oa[n][2 * hf + e] / denom);
        }
      if (MODE == NORMALIZED_LSE && writes_row)
        stat_a[row] = m[hf] + logf(denom);
    }
  }
}

// K1/K4 on wgmma and TMA (Hopper): flash_fwd_sm90_kernel, its tensor maps
// and the route predicate.
#include "flash_fwd_sm90.cuh"

// K2 on the tensor cores, k-tile kt of slice bh.  Warp w owns key rows
// 16w..16w+15; per q-tile it forms S^T = K Q^T and dP^T = V dO^T, turns
// them into P^T and dS^T in place, and accumulates dV += P^T dO and
// dK += dS^T Q in f32 registers, written once at the end.
template <int DM>
__device__ void dkdv_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ L,
                        const float* __restrict__ Drow,
                        float* __restrict__ dk, float* __restrict__ dv,
                        const Geom& g, float scale, int causal, int vec,
                        int bh, int kt, unsigned char* smem) {
  using C = TcCfg<DM>;
  constexpr int LDS = C::LDS, BQ = C::BS, NQ = BQ / 8;
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + TC_ROWS * LDS;
  bf16* Qs = Vs + TC_ROWS * LDS;               // [2][BQ][LDS]
  bf16* dOs = Qs + 2 * BQ * LDS;               // [2][BQ][LDS]
  float* Ls = reinterpret_cast<float*>(dOs + 2 * BQ * LDS);  // [2][BQ]
  float* Ds = Ls + 2 * BQ;                     // [2][BQ]
  const int b = bh / g.H, h = bh % g.H;
  const int k0 = kt * TC_ROWS;
  const int lane = threadIdx.x & 31, wr = (threadIdx.x >> 5) * 16;
  const int gr = lane >> 2, gc = 2 * (lane & 3);
  const int nq = (g.q.T + BQ - 1) / BQ;
  const int qt0 = causal ? k0 / BQ : 0;       // first q-tile on the diagonal

  auto stage = [&](int qt, int buf) {
    stage_tile<BQ, DM>(Qs + buf * BQ * LDS, q, qt * BQ, g.q, g.d, b, h, vec);
    stage_tile<BQ, DM>(dOs + buf * BQ * LDS, dout, qt * BQ, g.q, g.d, b, h,
                       vec);
    stage_rows<BQ>(Ls + buf * BQ, L, qt * BQ, g, b, h);
    stage_rows<BQ>(Ds + buf * BQ, Drow, qt * BQ, g, b, h);
  };
  stage_tile<TC_ROWS, DM>(Ks, k, k0, g.k, g.d, b, h, vec);
  stage_tile<TC_ROWS, DM>(Vs, v, k0, g.k, g.d, b, h, vec);
  if (qt0 < nq) stage(qt0, 0);
  cp_async_commit();

  float dka[C::ND][4] = {}, dva[C::ND][4] = {};
  uint32_t kf[C::REGS ? C::KD : 1][4], vf[C::REGS ? C::KD : 1][4];
  for (int qt = qt0; qt < nq; ++qt) {
    const int buf = (qt - qt0) & 1, q0 = qt * BQ;
    if (qt + 1 < nq) stage(qt + 1, buf ^ 1);   // next tile in flight
    cp_async_commit();
    cp_async_wait<1>();                        // this tile (and K, V) landed
    __syncthreads();
    if constexpr (C::REGS) {
      if (qt == qt0) {
#pragma unroll
        for (int kd = 0; kd < C::KD; ++kd) {
          frag_a<LDS>(kf[kd], Ks, wr, kd * 16, lane);
          frag_a<LDS>(vf[kd], Vs, wr, kd * 16, lane);
        }
      }
    }
    const bf16* Qb = Qs + buf * BQ * LDS;
    const bf16* dOb = dOs + buf * BQ * LDS;
    const float* Lb = Ls + buf * BQ;
    const float* Db = Ds + buf * BQ;

    float st[NQ][4] = {}, dpt[NQ][4] = {};     // S^T, dP^T: keys x queries
#pragma unroll
    for (int kd = 0; kd < C::KD; ++kd) {
      uint32_t ak[4], av[4];
      if constexpr (C::REGS) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ak[i] = kf[kd][i];
          av[i] = vf[kd][i];
        }
      } else {
        frag_a<LDS>(ak, Ks, wr, kd * 16, lane);
        frag_a<LDS>(av, Vs, wr, kd * 16, lane);
      }
#pragma unroll
      for (int j = 0; j < NQ; j += 2) {
        uint32_t bq[4], bo[4];
        frag_b_nk<LDS>(bq, Qb, j * 8, kd * 16, lane);
        mma_bf16(st[j], ak, bq[0], bq[1]);
        mma_bf16(st[j + 1], ak, bq[2], bq[3]);
        frag_b_nk<LDS>(bo, dOb, j * 8, kd * 16, lane);
        mma_bf16(dpt[j], av, bo[0], bo[1]);
        mma_bf16(dpt[j + 1], av, bo[2], bo[3]);
      }
    }
    // P^T and dS^T in place; element c of n-tile j: key row
    // wr + gr + 8 (c / 2), query column 8 j + gc + c % 2
    const bool edge = tile_edge(q0, BQ, k0, TC_ROWS, g, causal);
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int qi = j * 8 + gc + (c & 1);
        const bool keep =
            !edge || bwd_keep(q0 + qi, k0 + wr + gr + 8 * (c >> 1), g, causal);
        bwd_elem(st[j][c], dpt[j][c], Lb[qi], Db[qi], keep, scale, st[j][c],
                 dpt[j][c]);
      }
    // dV += P^T dO, dK += dS^T Q, 16 queries (one k-step) at a time
#pragma unroll
    for (int m = 0; m < BQ / 16; ++m) {
      uint32_t ap[4], as[4];
      acc_to_a(ap, st[2 * m], st[2 * m + 1]);
      acc_to_a(as, dpt[2 * m], dpt[2 * m + 1]);
#pragma unroll
      for (int n = 0; n < C::ND; n += 2) {
        uint32_t bo[4], bq[4];
        frag_b_kn<LDS>(bo, dOb, m * 16, n * 8, lane);
        mma_bf16(dva[n], ap, bo[0], bo[1]);
        mma_bf16(dva[n + 1], ap, bo[2], bo[3]);
        frag_b_kn<LDS>(bq, Qb, m * 16, n * 8, lane);
        mma_bf16(dka[n], as, bq[0], bq[1]);
        mma_bf16(dka[n + 1], as, bq[2], bq[3]);
      }
    }
    __syncthreads();                           // tile read: buf is free
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int kp = k0 + wr + gr + 8 * hf;
    if (kp >= g.k.T) continue;
    const long long base = offset(g.k, b, kp, h);
#pragma unroll
    for (int n = 0; n < C::ND; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n * 8 + gc + e;
        if (col < g.d) {
          dk[base + col] = dka[n][2 * hf + e];
          dv[base + col] = dva[n][2 * hf + e];
        }
      }
  }
}

// K3 on the tensor cores, q-tile qt of slice bh.  Warp w owns query rows
// 16w..16w+15 (their L and D in registers); per k-tile it forms S = Q K^T
// and dP = dO V^T, turns dP into dS in place and accumulates dQ += dS K.
template <int DM>
__device__ void dq_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ L,
                      const float* __restrict__ Drow, float* __restrict__ dq,
                      const Geom& g, float scale, int causal, int vec, int bh,
                      int qt, unsigned char* smem) {
  using C = TcCfg<DM>;
  constexpr int LDS = C::LDS, BK = C::BS, NK = BK / 8;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + TC_ROWS * LDS;
  bf16* Ks = dOs + TC_ROWS * LDS;              // [2][BK][LDS]
  bf16* Vs = Ks + 2 * BK * LDS;                // [2][BK][LDS]
  float* Ls = reinterpret_cast<float*>(Vs + 2 * BK * LDS);   // [TC_ROWS]
  float* Ds = Ls + TC_ROWS;                    // [TC_ROWS]
  const int b = bh / g.H, h = bh % g.H;
  const int q0 = qt * TC_ROWS;
  const int lane = threadIdx.x & 31, wr = (threadIdx.x >> 5) * 16;
  const int gr = lane >> 2, gc = 2 * (lane & 3);
  int nk = (g.k.T + BK - 1) / BK;
  if (causal) nk = min(nk, (q0 + TC_ROWS - 1) / BK + 1);   // to the diagonal

  auto stage = [&](int kt, int buf) {
    stage_tile<BK, DM>(Ks + buf * BK * LDS, k, kt * BK, g.k, g.d, b, h, vec);
    stage_tile<BK, DM>(Vs + buf * BK * LDS, v, kt * BK, g.k, g.d, b, h, vec);
  };
  stage_tile<TC_ROWS, DM>(Qs, q, q0, g.q, g.d, b, h, vec);
  stage_tile<TC_ROWS, DM>(dOs, dout, q0, g.q, g.d, b, h, vec);
  stage_rows<TC_ROWS>(Ls, L, q0, g, b, h);
  stage_rows<TC_ROWS>(Ds, Drow, q0, g, b, h);
  if (nk > 0) stage(0, 0);
  cp_async_commit();

  float dqa[C::ND][4] = {};
  uint32_t qf[C::REGS ? C::KD : 1][4], of[C::REGS ? C::KD : 1][4];
  float Lr[2], Dr[2];
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1, k0 = kt * BK;
    if (kt + 1 < nk) stage(kt + 1, buf ^ 1);   // next tile in flight
    cp_async_commit();
    cp_async_wait<1>();                        // this tile (and Q, dO) landed
    __syncthreads();
    if (kt == 0) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        Lr[hf] = Ls[wr + gr + 8 * hf];
        Dr[hf] = Ds[wr + gr + 8 * hf];
      }
      if constexpr (C::REGS) {
#pragma unroll
        for (int kd = 0; kd < C::KD; ++kd) {
          frag_a<LDS>(qf[kd], Qs, wr, kd * 16, lane);
          frag_a<LDS>(of[kd], dOs, wr, kd * 16, lane);
        }
      }
    }
    const bf16* Kb = Ks + buf * BK * LDS;
    const bf16* Vb = Vs + buf * BK * LDS;

    float s[NK][4] = {}, dp[NK][4] = {};       // S, dP: queries x keys
#pragma unroll
    for (int kd = 0; kd < C::KD; ++kd) {
      uint32_t aq[4], ao[4];
      if constexpr (C::REGS) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          aq[i] = qf[kd][i];
          ao[i] = of[kd][i];
        }
      } else {
        frag_a<LDS>(aq, Qs, wr, kd * 16, lane);
        frag_a<LDS>(ao, dOs, wr, kd * 16, lane);
      }
#pragma unroll
      for (int j = 0; j < NK; j += 2) {
        uint32_t bk[4], bv[4];
        frag_b_nk<LDS>(bk, Kb, j * 8, kd * 16, lane);
        mma_bf16(s[j], aq, bk[0], bk[1]);
        mma_bf16(s[j + 1], aq, bk[2], bk[3]);
        frag_b_nk<LDS>(bv, Vb, j * 8, kd * 16, lane);
        mma_bf16(dp[j], ao, bv[0], bv[1]);
        mma_bf16(dp[j + 1], ao, bv[2], bv[3]);
      }
    }
    // dS in place of dP; element c of n-tile j: query row
    // wr + gr + 8 (c / 2), key column 8 j + gc + c % 2
    const bool edge = tile_edge(q0, TC_ROWS, k0, BK, g, causal);
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int hf = c >> 1;
        const bool keep =
            !edge || bwd_keep(q0 + wr + gr + 8 * hf, k0 + j * 8 + gc + (c & 1),
                              g, causal);
        bwd_elem(s[j][c], dp[j][c], Lr[hf], Dr[hf], keep, scale, s[j][c],
                 dp[j][c]);
      }
    // dQ += dS K, 16 keys (one k-step) at a time
#pragma unroll
    for (int m = 0; m < BK / 16; ++m) {
      uint32_t a[4];
      acc_to_a(a, dp[2 * m], dp[2 * m + 1]);
#pragma unroll
      for (int n = 0; n < C::ND; n += 2) {
        uint32_t bk[4];
        frag_b_kn<LDS>(bk, Kb, m * 16, n * 8, lane);
        mma_bf16(dqa[n], a, bk[0], bk[1]);
        mma_bf16(dqa[n + 1], a, bk[2], bk[3]);
      }
    }
    __syncthreads();                           // tile read: buf is free
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int qp = q0 + wr + gr + 8 * hf;
    if (qp >= g.q.T) continue;
    const long long base = offset(g.q, b, qp, h);
#pragma unroll
    for (int n = 0; n < C::ND; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n * 8 + gc + e;
        if (col < g.d) dq[base + col] = dqa[n][2 * hf + e];
      }
  }
}

// ------------------------------------------------------------- kernels
// bf16 q/k/v (with a bf16 dO in K2/K3) go to the tensor cores, anything
// else to the scalar body; fixed at compile time.
template <typename T, typename TO = T>
constexpr bool tensor_core_v =
    std::is_same_v<T, bf16> && std::is_same_v<TO, bf16>;

// K1 and K4: one block per (b*h, q-tile), b*h fastest; causal q-tiles in
// reverse, so the last, which sees every k-tile, starts first for every
// head.
template <typename T, int DM, int MODE>
__global__ void __launch_bounds__(tensor_core_v<T> ? TC_THREADS : THREADS,
                                  tensor_core_v<T> ? TcCfg<DM>::FWD_MINB : 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v,
                 std::conditional_t<MODE == PARTIALS, float, T>* __restrict__ out,
                 float* __restrict__ stat_a, float* __restrict__ stat_b,
                 Geom g, float scale, int causal, int vec) {
  extern __shared__ __align__(16) unsigned char smem_fwd[];
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  if constexpr (tensor_core_v<T>)
    fwd_tc<DM, MODE>(q, k, v, out, stat_a, stat_b, g, scale, causal, vec,
                     blockIdx.x, qt, smem_fwd);
  else
    fwd_scalar<T, DM, MODE>(q, k, v, out, stat_a, stat_b, g, scale, causal,
                            blockIdx.x, qt, reinterpret_cast<float*>(smem_fwd));
}

// One block per (b*h, k-tile), b*h on the fastest grid axis: k-tile 0,
// which sees every q-tile when causal, starts first for every head.
template <typename T, typename TO, int DM>
__global__ void __launch_bounds__(tensor_core_v<T, TO> ? TC_THREADS : THREADS)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const TO* __restrict__ dout,
                      const float* __restrict__ L,
                      const float* __restrict__ Drow,
                      float* __restrict__ dk, float* __restrict__ dv, Geom g,
                      float scale, int causal, int vec) {
  extern __shared__ __align__(16) unsigned char smem_bwd[];
  if constexpr (tensor_core_v<T, TO>)
    dkdv_tc<DM>(q, k, v, dout, L, Drow, dk, dv, g, scale, causal, vec,
                blockIdx.x, blockIdx.y, smem_bwd);
  else
    dkdv_scalar<T, TO, DM>(q, k, v, dout, L, Drow, dk, dv, g, scale, causal,
                           blockIdx.x, blockIdx.y,
                           reinterpret_cast<float*>(smem_bwd));
}

// One block per (b*h, q-tile), b*h fastest; causal q-tiles in reverse, so
// the last, which sees every k-tile, starts first for every head.
template <typename T, typename TO, int DM>
__global__ void __launch_bounds__(tensor_core_v<T, TO> ? TC_THREADS : THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const TO* __restrict__ dout,
                    const float* __restrict__ L,
                    const float* __restrict__ Drow, float* __restrict__ dq,
                    Geom g, float scale, int causal, int vec) {
  extern __shared__ __align__(16) unsigned char smem_bwd[];
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  if constexpr (tensor_core_v<T, TO>)
    dq_tc<DM>(q, k, v, dout, L, Drow, dq, g, scale, causal, vec, blockIdx.x,
              qt, smem_bwd);
  else
    dq_scalar<T, TO, DM>(q, k, v, dout, L, Drow, dq, g, scale, causal,
                         blockIdx.x, qt, reinterpret_cast<float*>(smem_bwd));
}

// ----------------------------------------------------------- launching
template <typename T, int DM>
struct Cfg {
  using type = T;
  static constexpr int dm = DM;
  static constexpr size_t tile_bytes = sizeof(float) * TILE * (DM + 1);
  static constexpr size_t score_bytes = sizeof(float) * TILE * PLD;
  static constexpr size_t rows_bytes = sizeof(float) * TILE;
};

// Calls f(Cfg<T, DM>{}) for the input dtype and the smallest head-dim
// bucket that holds d.  Returns cudaErrorInvalidValue for d > 128.
template <typename F>
cudaError_t dispatch(int bf16_in, int d, F&& f) {
  if (bf16_in) {
    if (d <= 32) return f(Cfg<bf16, 32>{});
    if (d <= 64) return f(Cfg<bf16, 64>{});
    if (d <= 128) return f(Cfg<bf16, 128>{});
  } else {
    if (d <= 32) return f(Cfg<float, 32>{});
    if (d <= 64) return f(Cfg<float, 64>{});
    if (d <= 128) return f(Cfg<float, 128>{});
  }
  return cudaErrorInvalidValue;
}

// Dynamic shared memory above 48 KB must be opted into per kernel.
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

Geom make_geom(int B, int Tq, int Tk, int H, int d, long long qsb,
               long long qst, long long qsh, long long ksb, long long kst,
               long long ksh) {
  return Geom{B, H, d, Side{Tq, qsb, qst, qsh}, Side{Tk, ksb, kst, ksh}};
}

// Can the bf16 tiles of `ptrs` be staged by 16-byte copies: d a multiple
// of 8 and every row 16-byte aligned (aligned bases, strides a multiple of
// 8 elements).
int rows_16b(const Geom& g, std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return 0;
  const Side& sq = g.q;
  const Side& sk = g.k;
  return g.d % 8 == 0 && sq.sb % 8 == 0 && sq.st % 8 == 0 &&
         sq.sh % 8 == 0 && sk.sb % 8 == 0 && sk.st % 8 == 0 &&
         sk.sh % 8 == 0;
}

// The body a K1/K4 call takes: FWD_SM90 (flash_fwd_sm90_kernel), FWD_TC
// (fwd_tc) or FWD_SCALAR (fwd_scalar).
enum FwdRoute { FWD_SCALAR = 0, FWD_TC = 1, FWD_SM90 = 2 };

int fwd_route(const Geom& g, int bf16_in, const void* q, const void* k,
              const void* v) {
  if (sm90_route(g, bf16_in, {q, k, v})) return FWD_SM90;
  return bf16_in ? FWD_TC : FWD_SCALAR;
}

// Returns a cudaError_t, or TMA_ENCODE_FAILED + a CUresult.
template <int MODE>
int launch_fwd(const void* q, const void* k, const void* v, void* out,
               void* stat_a, void* stat_b, const Geom& g, float scale,
               int causal, int bf16_in, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fwd_route(g, bf16_in, q, k, v) == FWD_SM90)
    return g.d <= 64 ? launch_fwd_sm90<64, MODE>(q, k, v, out, stat_a, stat_b,
                                                 g, scale, causal, s)
                     : launch_fwd_sm90<128, MODE>(q, k, v, out, stat_a,
                                                  stat_b, g, scale, causal, s);
  return (int)dispatch(bf16_in, g.d, [&](auto cfg) -> cudaError_t {
    using C = decltype(cfg);
    using T_ = typename C::type;
    using O_ = std::conditional_t<MODE == PARTIALS, float, T_>;
    constexpr bool tc = tensor_core_v<T_>;
    const size_t smem =
        tc ? TcCfg<C::dm>::fwd_smem : 3 * C::tile_bytes + C::score_bytes;
    auto kern = &flash_fwd_kernel<T_, C::dm, MODE>;
    cudaError_t e = allow_smem(kern, smem);
    if (e != cudaSuccess) return e;
    const int rows = tc ? TC_ROWS : TILE;
    const dim3 grid(g.B * g.H, (g.q.T + rows - 1) / rows);
    kern<<<grid, tc ? TC_THREADS : THREADS, smem, s>>>(
        static_cast<const T_*>(q), static_cast<const T_*>(k),
        static_cast<const T_*>(v), static_cast<O_*>(out),
        static_cast<float*>(stat_a), static_cast<float*>(stat_b), g, scale,
        causal, tc ? rows_16b(g, {q, k, v}) : 0);
    return cudaGetLastError();
  });
}

struct BwdArgs {
  const void *q, *k, *v, *dout, *L, *Drow;
  void *dk, *dv, *dq;
  Geom g;
  float scale;
  int causal;
};

// K2/K3 on wgmma and TMA (Hopper): flash_bwd_dkdv_sm90_kernel,
// flash_bwd_dq_sm90_kernel and their launchers.
#include "flash_bwd_sm90.cuh"

// The body a K2/K3 call takes: BWD_SM90 (the kernels of
// flash_bwd_sm90.cuh) for bf16 q/k/v and dO whose rows TMA can address,
// BWD_TC (dkdv_tc, dq_tc) for other bf16 q/k/v and dO, BWD_SCALAR for f32
// inputs or an f32 dO.
enum BwdRoute { BWD_SCALAR = 0, BWD_TC = 1, BWD_SM90 = 2 };

int bwd_route(const BwdArgs& a, int bf16_in, int do_f32) {
  const int tc = bf16_in && !do_f32;
  if (sm90_route(a.g, tc, {a.q, a.k, a.v, a.dout})) return BWD_SM90;
  return tc ? BWD_TC : BWD_SCALAR;
}

template <typename T, typename TO, int DM>
cudaError_t launch_dkdv(const BwdArgs& a, cudaStream_t s) {
  using C = Cfg<T, DM>;
  constexpr bool tc = tensor_core_v<T, TO>;
  const size_t smem =
      tc ? TcCfg<DM>::dkdv_smem
         : 4 * C::tile_bytes + 2 * C::score_bytes + 2 * C::rows_bytes;
  auto kern = &flash_bwd_dkdv_kernel<T, TO, DM>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  const int rows = tc ? TC_ROWS : TILE;
  const dim3 grid(a.g.B * a.g.H, (a.g.k.T + rows - 1) / rows);
  kern<<<grid, tc ? TC_THREADS : THREADS, smem, s>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const TO*>(a.dout),
      static_cast<const float*>(a.L), static_cast<const float*>(a.Drow),
      static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.g, a.scale,
      a.causal, tc ? rows_16b(a.g, {a.q, a.k, a.v, a.dout}) : 0);
  return cudaGetLastError();
}

template <typename T, typename TO, int DM>
cudaError_t launch_dq(const BwdArgs& a, cudaStream_t s) {
  using C = Cfg<T, DM>;
  constexpr bool tc = tensor_core_v<T, TO>;
  const size_t smem =
      tc ? TcCfg<DM>::dq_smem
         : 4 * C::tile_bytes + C::score_bytes + 2 * C::rows_bytes;
  auto kern = &flash_bwd_dq_kernel<T, TO, DM>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  const int rows = tc ? TC_ROWS : TILE;
  const dim3 grid(a.g.B * a.g.H, (a.g.q.T + rows - 1) / rows);
  kern<<<grid, tc ? TC_THREADS : THREADS, smem, s>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const TO*>(a.dout),
      static_cast<const float*>(a.L), static_cast<const float*>(a.Drow),
      static_cast<float*>(a.dq), a.g, a.scale, a.causal,
      tc ? rows_16b(a.g, {a.q, a.k, a.v, a.dout}) : 0);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Every entry point: q (and out/acc, dO, dq) is (B, Tq, H, d) with element
// strides qsb, qst, qsh; k and v (and dk, dv) are (B, Tk, H, d) with
// strides ksb, kst, ksh (stride 1 along d); row statistics are contiguous
// (B, Tq, H) f32.  bf16 != 0 selects __nv_bfloat16 q/k/v, else float.
// Each returns the CUDA error of the launch (0 on success), or
// TMA_ENCODE_FAILED (100000) + the CUresult when a tensor map of a Hopper
// body cannot be encoded.

// The body that dl4j_flash_fwd / dl4j_flash_fwd_partials launch for these
// arguments: 2 the Hopper body (wgmma, TMA), 1 the mma.sync body, 0 the
// scalar f32 body.  Decided by dtype, shape and alignment only.
int dl4j_flash_fwd_route(const void* q, const void* k, const void* v, int B,
                         int Tq, int Tk, int H, int d, long long qsb,
                         long long qst, long long qsh, long long ksb,
                         long long kst, long long ksh, int bf16) {
  return fwd_route(make_geom(B, Tq, Tk, H, d, qsb, qst, qsh, ksb, kst, ksh),
                   bf16, q, k, v);
}

// K1: out in q's dtype; lse written when with_lse != 0.
int dl4j_flash_fwd(const void* q, const void* k, const void* v, void* out,
                   void* lse, int B, int Tq, int Tk, int H, int d,
                   long long qsb, long long qst, long long qsh,
                   long long ksb, long long kst, long long ksh, float scale,
                   int causal, int bf16, int with_lse, void* stream) {
  const Geom g = make_geom(B, Tq, Tk, H, d, qsb, qst, qsh, ksb, kst, ksh);
  return with_lse
             ? launch_fwd<NORMALIZED_LSE>(q, k, v, out, lse, nullptr, g,
                                          scale, causal, bf16, stream)
             : launch_fwd<NORMALIZED>(q, k, v, out, nullptr, nullptr, g,
                                      scale, causal, bf16, stream);
}

// K4: acc (B, Tq, H, d) f32, m and l (B, Tq, H) f32.
int dl4j_flash_fwd_partials(const void* q, const void* k, const void* v,
                            void* acc, void* m, void* l, int B, int Tq,
                            int Tk, int H, int d, long long qsb,
                            long long qst, long long qsh, long long ksb,
                            long long kst, long long ksh, float scale,
                            int causal, int bf16, void* stream) {
  const Geom g = make_geom(B, Tq, Tk, H, d, qsb, qst, qsh, ksb, kst, ksh);
  return launch_fwd<PARTIALS>(q, k, v, acc, m, l, g, scale, causal, bf16,
                              stream);
}

// The body that dl4j_flash_bwd_dkdv / dl4j_flash_bwd_dq launch for these
// arguments: 2 the Hopper bodies (wgmma, TMA), 1 the mma.sync bodies, 0
// the scalar f32 bodies.  Decided by dtype, shape and alignment only.
int dl4j_flash_bwd_route(const void* q, const void* k, const void* v,
                         const void* dout, int B, int Tq, int Tk, int H,
                         int d, long long qsb, long long qst, long long qsh,
                         long long ksb, long long kst, long long ksh,
                         int bf16, int do_f32) {
  const BwdArgs a{q, k, v, dout, nullptr, nullptr, nullptr, nullptr, nullptr,
                  make_geom(B, Tq, Tk, H, d, qsb, qst, qsh, ksb, kst, ksh),
                  0.f, 0};
  return bwd_route(a, bf16, do_f32);
}

// K2: dk, dv f32 with k's strides; L, Drow the (global) logsumexp and
// rowsum(dO * O); dout has q's dtype, or f32 when do_f32 != 0.
int dl4j_flash_bwd_dkdv(const void* q, const void* k, const void* v,
                        const void* dout, const void* L, const void* Drow,
                        void* dk, void* dv, int B, int Tq, int Tk, int H,
                        int d, long long qsb, long long qst, long long qsh,
                        long long ksb, long long kst, long long ksh,
                        float scale, int causal, int bf16, int do_f32,
                        void* stream) {
  const BwdArgs a{q, k, v, dout, L, Drow, dk, dv, nullptr,
                  make_geom(B, Tq, Tk, H, d, qsb, qst, qsh, ksb, kst, ksh),
                  scale, causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bwd_route(a, bf16, do_f32) == BWD_SM90)
    return d <= 64 ? launch_dkdv_sm90<64>(a, s) : launch_dkdv_sm90<128>(a, s);
  return (int)dispatch(bf16, d, [&](auto cfg) -> cudaError_t {
    using C = decltype(cfg);
    using T_ = typename C::type;
    return do_f32 ? launch_dkdv<T_, float, C::dm>(a, s)
                  : launch_dkdv<T_, T_, C::dm>(a, s);
  });
}

// K3: dq f32 with q's strides; the rest as K2.
int dl4j_flash_bwd_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* L, const void* Drow,
                      void* dq, int B, int Tq, int Tk, int H, int d,
                      long long qsb, long long qst, long long qsh,
                      long long ksb, long long kst, long long ksh,
                      float scale, int causal, int bf16, int do_f32,
                      void* stream) {
  const BwdArgs a{q, k, v, dout, L, Drow, nullptr, nullptr, dq,
                  make_geom(B, Tq, Tk, H, d, qsb, qst, qsh, ksb, kst, ksh),
                  scale, causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bwd_route(a, bf16, do_f32) == BWD_SM90)
    return d <= 64 ? launch_dq_sm90<64>(a, s) : launch_dq_sm90<128>(a, s);
  return (int)dispatch(bf16, d, [&](auto cfg) -> cudaError_t {
    using C = decltype(cfg);
    using T_ = typename C::type;
    return do_f32 ? launch_dq<T_, float, C::dm>(a, s)
                  : launch_dq<T_, T_, C::dm>(a, s);
  });
}

}  // extern "C"
