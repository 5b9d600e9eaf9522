// Flash attention for Hopper (sm_90a): forward (K1), dK/dV backward (K2)
// and dQ backward (K3), hand-written CUDA behind a plain C interface.
//
// Replaces the Pallas TPU kernels of deeplearning4j_tpu/ops/attention.py:
//   K1 flash_fwd_kernel      <- _make_flash_kernel (modes "normalized" and
//                               "normalized_lse"), launched by _flash_forward
//   K2 flash_bwd_dkdv_kernel <- _make_dkdv_kernel + _bwd_tile, launched by
//                               flash_attention_bwd
//   K3 flash_bwd_dq_kernel   <- _make_dq_kernel + _bwd_tile, launched by
//                               flash_attention_bwd
//
// What bounds them on the H100: all three are compute-bound.  At the
// training shape (B=2, T=8192, H=4, d=64, causal) K1 does two T x T x d
// products over the causal half and moves ~34 MB, so its operations take
// ~7x longer than its bytes even at the bf16 tensor-core peak; K2 does four
// such products, K3 three.
//
// What the design does about it, in this first version: the (T, T) score
// matrix never reaches device memory.  A thread block owns one 64-row tile
// of one (batch, head) slice and loops over the other side's 64-row tiles
// inside the block (the TPU's sequential third grid axis and its VMEM
// scratch become that loop and registers); causal blocks stop at the
// diagonal, halving the work.  Tiles are staged in shared memory as f32
// (bf16 inputs are widened with __bfloat162float) and every product is a
// scalar f32 FMA on a 16x16 thread grid where each thread owns a 4x4
// micro-tile, so the kernels run on the CUDA cores, far below the tensor
// core bound.  Moving the products to wgmma with TMA-fed tiles is the
// next step.  K2 owns one k-tile per block and loops over q-tiles, so dK
// and dV need no atomics.
//
// Semantics kept from the TPU kernels: the -1e30 sentinel for masked
// scores with the `alive` guard (a row with no visible key yet contributes
// exact zeros), the 1e-30 clamp of the softmax denominator, the per-row
// logsumexp m + log(l) in the lse mode, the backward mask
// (k < T) & (q < T) & causal, and f32 gradients.  Ragged T is masked in the
// kernels (no padding to block multiples), and the (B, T, H, d) strides
// are read directly (no transposes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;        // rows of a q-tile and of a k-tile
constexpr int THREADS = 256;    // a 16 x 16 thread grid
constexpr int SUB = 4;          // each thread owns a 4 x 4 micro-tile
constexpr int PLD = TILE + 1;   // padded row length of a score tile
constexpr float NEG_INF = -1e30f;

struct Geom {
  int B, T, H, d;
  long long sb, st, sh;         // element strides of batch, time, head
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ long long offset(const Geom& g, int b, int t,
                                            int h) {
  return (long long)b * g.sb + (long long)t * g.st + (long long)h * g.sh;
}

// Rows [r0, r0 + TILE) of one (b, h) slice into a [TILE][DM + 1] f32 tile,
// zero beyond T and beyond d (zero rows and columns are inert in every
// product below).
template <typename T, int DM>
__device__ void load_tile(float* dst, const T* src, int r0, const Geom& g,
                          int b, int h) {
  for (int idx = threadIdx.x; idx < TILE * DM; idx += THREADS) {
    const int r = idx / DM, c = idx % DM, t = r0 + r;
    float val = 0.f;
    if (t < g.T && c < g.d) val = to_f32(src[offset(g, b, t, h) + c]);
    dst[r * (DM + 1) + c] = val;
  }
}

// Per-row statistics (B, T, H) f32 for rows [r0, r0 + TILE).
__device__ void load_rows(float* dst, const float* src, int r0,
                          const Geom& g, int b, int h) {
  for (int r = threadIdx.x; r < TILE; r += THREADS) {
    const int t = r0 + r;
    dst[r] = t < g.T ? src[((long long)b * g.T + t) * g.H + h] : 0.f;
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

// ---------------------------------------------------------------- K1
// One block per (q-tile, b*h).  LSE selects the "normalized_lse" mode: the
// same body also writes the per-row logsumexp.
template <typename T, int DM, bool LSE>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, Geom g, float scale, int causal) {
  extern __shared__ float smem[];
  constexpr int LD = DM + 1, DC = DM / 16;
  float* Qs = smem;
  float* Ks = Qs + TILE * LD;
  float* Vs = Ks + TILE * LD;
  float* Ps = Vs + TILE * LD;                  // [TILE][PLD]
  const int b = blockIdx.y / g.H, h = blockIdx.y % g.H;
  const int q0 = blockIdx.x * TILE;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile<T, DM>(Qs, q, q0, g, b, h);
  float m[SUB], l[SUB], acc[SUB][DC];
#pragma unroll
  for (int i = 0; i < SUB; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }
  int nk = (g.T + TILE - 1) / TILE;
  if (causal) nk = min(nk, (q0 + TILE - 1) / TILE + 1);  // stop at diagonal

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * TILE;
    __syncthreads();                           // previous tile fully read
    load_tile<T, DM>(Ks, k, k0, g, b, h);
    load_tile<T, DM>(Vs, v, k0, g, b, h);
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
        const bool keep = kp < g.T && (!causal || qp >= kp);
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
    if (qp >= g.T) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    const long long base = offset(g, b, qp, h);
#pragma unroll
    for (int jd = 0; jd < DC; ++jd) {
      const int c = tx + 16 * jd;
      if (c < g.d) out[base + c] = from_f32<T>(acc[i][jd] / denom);
    }
    if (LSE && tx == 0)
      lse[((long long)b * g.T + qp) * g.H + h] = m[i] + logf(denom);
  }
}

// --------------------------------------------------------- K2/K3 tile
// The shared P-rebuild of both backward kernels (TPU _bwd_tile): for the
// (q-tile q0, k-tile k0) pair, this thread's 4 x 4 micro-tile of
// P = exp(S - L) and dS = P * (dO . V^T - D) * scale, masked.
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
    const float L = Ls[r], D = Ds[r];
#pragma unroll
    for (int j = 0; j < SUB; ++j) {
      const int kp = k0 + tx + 16 * j;
      const bool keep = kp < g.T && qp < g.T && (!causal || qp >= kp);
      const float pij = keep ? expf(s[i][j] * scale - L) : 0.f;
      p[i][j] = pij;
      ds[i][j] = pij * (dp[i][j] - D) * scale;
    }
  }
}

// ---------------------------------------------------------------- K2
// One block per (k-tile, b*h): dV += P^T dO and dK += dS^T Q over the
// q-tiles at or below the diagonal.  Each block owns its dK/dV rows, so
// there are no atomics.
template <typename T, int DM>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ L,
                      const float* __restrict__ Drow,
                      float* __restrict__ dk, float* __restrict__ dv, Geom g,
                      float scale, int causal) {
  extern __shared__ float smem[];
  constexpr int LD = DM + 1, DC = DM / 16;
  float* Ks = smem;
  float* Vs = Ks + TILE * LD;
  float* Qs = Vs + TILE * LD;
  float* dOs = Qs + TILE * LD;
  float* Ps = dOs + TILE * LD;                 // [TILE][PLD]
  float* dSs = Ps + TILE * PLD;                // [TILE][PLD]
  float* Ls = dSs + TILE * PLD;
  float* Ds = Ls + TILE;
  const int b = blockIdx.y / g.H, h = blockIdx.y % g.H;
  const int k0 = blockIdx.x * TILE;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile<T, DM>(Ks, k, k0, g, b, h);
  load_tile<T, DM>(Vs, v, k0, g, b, h);
  float dk_acc[SUB][DC], dv_acc[SUB][DC];
#pragma unroll
  for (int i = 0; i < SUB; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;
  const int nq = (g.T + TILE - 1) / TILE;
  const int qt0 = causal ? k0 / TILE : 0;     // first q-tile on the diagonal

  for (int qt = qt0; qt < nq; ++qt) {
    const int q0 = qt * TILE;
    __syncthreads();
    load_tile<T, DM>(Qs, q, q0, g, b, h);
    load_tile<T, DM>(dOs, dout, q0, g, b, h);
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
    if (kp >= g.T) continue;
    const long long base = offset(g, b, kp, h);
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

// ---------------------------------------------------------------- K3
// One block per (q-tile, b*h): dQ += dS K over the k-tiles up to the
// diagonal.
template <typename T, int DM>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ L,
                    const float* __restrict__ Drow, float* __restrict__ dq,
                    Geom g, float scale, int causal) {
  extern __shared__ float smem[];
  constexpr int LD = DM + 1, DC = DM / 16;
  float* Qs = smem;
  float* dOs = Qs + TILE * LD;
  float* Ks = dOs + TILE * LD;
  float* Vs = Ks + TILE * LD;
  float* dSs = Vs + TILE * LD;                 // [TILE][PLD]
  float* Ls = dSs + TILE * PLD;
  float* Ds = Ls + TILE;
  const int b = blockIdx.y / g.H, h = blockIdx.y % g.H;
  const int q0 = blockIdx.x * TILE;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile<T, DM>(Qs, q, q0, g, b, h);
  load_tile<T, DM>(dOs, dout, q0, g, b, h);
  load_rows(Ls, L, q0, g, b, h);
  load_rows(Ds, Drow, q0, g, b, h);
  float dq_acc[SUB][DC];
#pragma unroll
  for (int i = 0; i < SUB; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dq_acc[i][c] = 0.f;
  int nk = (g.T + TILE - 1) / TILE;
  if (causal) nk = min(nk, (q0 + TILE - 1) / TILE + 1);

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * TILE;
    __syncthreads();
    load_tile<T, DM>(Ks, k, k0, g, b, h);
    load_tile<T, DM>(Vs, v, k0, g, b, h);
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
    if (qp >= g.T) continue;
    const long long base = offset(g, b, qp, h);
#pragma unroll
    for (int jd = 0; jd < DC; ++jd) {
      const int c = tx + 16 * jd;
      if (c < g.d) dq[base + c] = dq_acc[i][jd];
    }
  }
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
cudaError_t dispatch(int bf16, int d, F&& f) {
  if (bf16) {
    if (d <= 32) return f(Cfg<__nv_bfloat16, 32>{});
    if (d <= 64) return f(Cfg<__nv_bfloat16, 64>{});
    if (d <= 128) return f(Cfg<__nv_bfloat16, 128>{});
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

}  // namespace

extern "C" {

// q, k, v, out: (B, T, H, d) with element strides sb, st, sh (stride 1
// along d); lse: (B, T, H) f32, written when with_lse != 0.  bf16 != 0
// selects __nv_bfloat16 inputs/outputs, else float.  Returns the CUDA
// error of the launch (0 on success).
int dl4j_flash_fwd(const void* q, const void* k, const void* v, void* out,
                   void* lse, int B, int T, int H, int d, long long sb,
                   long long st, long long sh, float scale, int causal,
                   int bf16, int with_lse, void* stream) {
  const Geom g{B, T, H, d, sb, st, sh};
  const dim3 grid((T + TILE - 1) / TILE, B * H);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)dispatch(bf16, d, [&](auto cfg) -> cudaError_t {
    using C = decltype(cfg);
    using T_ = typename C::type;
    const size_t smem = 3 * C::tile_bytes + C::score_bytes;
    auto kern = with_lse ? &flash_fwd_kernel<T_, C::dm, true>
                         : &flash_fwd_kernel<T_, C::dm, false>;
    cudaError_t e = allow_smem(kern, smem);
    if (e != cudaSuccess) return e;
    kern<<<grid, THREADS, smem, s>>>(
        static_cast<const T_*>(q), static_cast<const T_*>(k),
        static_cast<const T_*>(v), static_cast<T_*>(out),
        static_cast<float*>(lse), g, scale, causal);
    return cudaGetLastError();
  });
}

// dk, dv: (B, T, H, d) f32 with the same strides as q; L, Drow: (B, T, H)
// f32 (logsumexp and rowsum(dO * O)); dout has q's dtype and strides.
int dl4j_flash_bwd_dkdv(const void* q, const void* k, const void* v,
                        const void* dout, const void* L, const void* Drow,
                        void* dk, void* dv, int B, int T, int H, int d,
                        long long sb, long long st, long long sh,
                        float scale, int causal, int bf16, void* stream) {
  const Geom g{B, T, H, d, sb, st, sh};
  const dim3 grid((T + TILE - 1) / TILE, B * H);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)dispatch(bf16, d, [&](auto cfg) -> cudaError_t {
    using C = decltype(cfg);
    using T_ = typename C::type;
    const size_t smem =
        4 * C::tile_bytes + 2 * C::score_bytes + 2 * C::rows_bytes;
    auto kern = &flash_bwd_dkdv_kernel<T_, C::dm>;
    cudaError_t e = allow_smem(kern, smem);
    if (e != cudaSuccess) return e;
    kern<<<grid, THREADS, smem, s>>>(
        static_cast<const T_*>(q), static_cast<const T_*>(k),
        static_cast<const T_*>(v), static_cast<const T_*>(dout),
        static_cast<const float*>(L), static_cast<const float*>(Drow),
        static_cast<float*>(dk), static_cast<float*>(dv), g, scale, causal);
    return cudaGetLastError();
  });
}

// dq: (B, T, H, d) f32 with q's strides.
int dl4j_flash_bwd_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* L, const void* Drow,
                      void* dq, int B, int T, int H, int d, long long sb,
                      long long st, long long sh, float scale, int causal,
                      int bf16, void* stream) {
  const Geom g{B, T, H, d, sb, st, sh};
  const dim3 grid((T + TILE - 1) / TILE, B * H);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)dispatch(bf16, d, [&](auto cfg) -> cudaError_t {
    using C = decltype(cfg);
    using T_ = typename C::type;
    const size_t smem = 4 * C::tile_bytes + C::score_bytes + 2 * C::rows_bytes;
    auto kern = &flash_bwd_dq_kernel<T_, C::dm>;
    cudaError_t e = allow_smem(kern, smem);
    if (e != cudaSuccess) return e;
    kern<<<grid, THREADS, smem, s>>>(
        static_cast<const T_*>(q), static_cast<const T_*>(k),
        static_cast<const T_*>(v), static_cast<const T_*>(dout),
        static_cast<const float*>(L), static_cast<const float*>(Drow),
        static_cast<float*>(dq), g, scale, causal);
    return cudaGetLastError();
  });
}

}  // extern "C"
