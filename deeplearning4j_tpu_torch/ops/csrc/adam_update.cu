// The updater's Adam step over fp32 masters for Hopper (sm_90a), one pass
// a leaf, hand-written CUDA behind a plain C interface.
//
// Replaces no TPU kernel: the JAX package leaves Adam's update to XLA,
// which fuses the elementwise chain itself.  The port's torch ops ran it
// as about fourteen full-size f32 passes a leaf (the gradient's f32 cast,
// each product, sum, square, root and quotient, the new master, its bf16
// recast), then a copy of every result into a captured step's static
// trees.  This kernel computes the same step
// (nn/updaters.py compute_update's "adam" branch and apply_layer_updates'
// master write) in one pass, bit for bit: per element it reads the
// gradient (bf16 or f32), the master, m and v, and writes the new m, v,
// master and the storage param, the master's round-to-nearest-even cast
// (bf16, or f32 where the leaf is f32).
//
// What bounds it on the H100: bytes.  A bf16 leaf moves 28 bytes a
// parameter (reads 2 + 3 x 4, writes 3 x 4 + 2) for ~10 flops, so at
// 3.35 TB/s 3.33e9 parameters take 27.8 ms.  The design streams: a
// grid-stride loop, 8 elements a thread iteration through 16-byte vector
// loads and stores, as many blocks as the card holds at once; a scalar
// loop takes the tail, and every element of a leaf one of whose pointers
// is off 16 bytes.  In place (a captured step's static trees) each
// thread reads an element before it writes it, so no pointer is
// restrict-qualified.
//
// Same mathematics as the torch ops, bitwise: every operation is a
// correctly rounded f32 intrinsic in the ops' order (no FMA contraction,
// whatever -fmad says), the host scalars come rounded to f32 as PyTorch
// rounds a Python scalar for an f32 tensor (b1, 1 - b1, b2, 1 - b2, eps),
// and alpha is either such a host scalar or the f64 entry of a captured
// step's device table, rounded to f32 on the card (a graph cannot take a
// host float that changes from replay to replay).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 8;        // elements a thread iteration on the vector path

struct AdamScalars {
  float b1, omb1, b2, omb2, eps;
};

__device__ __forceinline__ float bf16_bits_to_float(uint32_t bits16) {
  return __uint_as_float(bits16 << 16);
}

__device__ __forceinline__ uint32_t float_to_bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// m' = b1 m + (1 - b1) g;  v' = b2 v + (1 - b2) g^2;
// w' = w - (alpha m') / (sqrt(v') + eps)
__device__ __forceinline__ void adam_element(float g, float& w, float& m,
                                             float& v, float alpha,
                                             const AdamScalars& s) {
  m = __fadd_rn(__fmul_rn(s.b1, m), __fmul_rn(s.omb1, g));
  v = __fadd_rn(__fmul_rn(s.b2, v), __fmul_rn(s.omb2, __fmul_rn(g, g)));
  const float u =
      __fdiv_rn(__fmul_rn(alpha, m), __fadd_rn(__fsqrt_rn(v), s.eps));
  w = __fsub_rn(w, u);
}

// ---- 8 elements through 16-byte accesses (pointers 16-byte aligned)
__device__ __forceinline__ void load8(const float* p, float (&x)[VEC]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&x)[VEC]) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = bf16_bits_to_float(w[i] & 0xffffu);
    x[2 * i + 1] = bf16_bits_to_float(w[i] >> 16);
  }
}

__device__ __forceinline__ void store8(float* p, const float (&x)[VEC]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p,
                                       const float (&x)[VEC]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = float_to_bf16_bits(x[2 * i]) |
           (float_to_bf16_bits(x[2 * i + 1]) << 16);
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// ---- one element
__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// g: the gradient (G = bf16 or float); w, m, v: f32 master and moments;
// w1, m1, v1: their new values (the same pointers in place); p1: the
// storage param (P = bf16 or float), or null where the param is the
// master itself.  alpha_dev: a device f64, or null for alpha_host.
template <typename G, typename P>
__global__ void __launch_bounds__(THREADS) adam_master_step_kernel(
    const G* g, const float* w, const float* m, const float* v, float* w1,
    float* m1, float* v1, P* p1, long long n, AdamScalars s,
    const double* alpha_dev, float alpha_host, int vec) {
  const float alpha =
      alpha_dev != nullptr ? __double2float_rn(*alpha_dev) : alpha_host;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long done = 0;
  if (vec) {
    const long long chunks = n / VEC;
    for (long long c = tid; c < chunks; c += stride) {
      const long long i = c * VEC;
      float gx[VEC], wx[VEC], mx[VEC], vx[VEC];
      load8(g + i, gx);
      load8(w + i, wx);
      load8(m + i, mx);
      load8(v + i, vx);
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        adam_element(gx[j], wx[j], mx[j], vx[j], alpha, s);
      store8(m1 + i, mx);
      store8(v1 + i, vx);
      store8(w1 + i, wx);
      if (p1 != nullptr) store8(p1 + i, wx);
    }
    done = chunks * VEC;
  }
  for (long long i = done + tid; i < n; i += stride) {
    float wx = w[i], mx = m[i], vx = v[i];
    adam_element(load1(g + i), wx, mx, vx, alpha, s);
    m1[i] = mx;
    v1[i] = vx;
    w1[i] = wx;
    if (p1 != nullptr) store1(p1 + i, wx);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename G, typename P>
int launch(const void* g, const void* w, const void* m, const void* v,
           void* w1, void* m1, void* v1, void* p1, long long n,
           AdamScalars s, const double* alpha_dev, float alpha_host,
           int vec, cudaStream_t stream) {
  auto kernel = adam_master_step_kernel<G, P>;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      THREADS, 0);
  if (e != cudaSuccess) return (int)e;
  const long long items = vec ? n / VEC + n % VEC : n;
  long long blocks = (items + THREADS - 1) / THREADS;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > resident) blocks = resident;
  kernel<<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const G*>(g), static_cast<const float*>(w),
      static_cast<const float*>(m), static_cast<const float*>(v),
      static_cast<float*>(w1), static_cast<float*>(m1),
      static_cast<float*>(v1), static_cast<P*>(p1), n, s, alpha_dev,
      alpha_host, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One Adam step over n contiguous elements.  g_bf16 / p_bf16 != 0 select
// bf16 for g and the storage param p1 (else f32; p1 may be null).
// alpha_dev, when not null, points at a device f64 read in place of
// alpha_host.  Returns the CUDA error of the launch (0 on success).
int dl4j_adam_master_step(const void* g, int g_bf16, const void* w,
                          const void* m, const void* v, void* w1, void* m1,
                          void* v1, void* p1, int p_bf16, long long n,
                          float b1, float omb1, float b2, float omb2,
                          float eps, const void* alpha_dev, float alpha_host,
                          void* stream) {
  if (n <= 0) return 0;
  const AdamScalars s{b1, omb1, b2, omb2, eps};
  const double* a = static_cast<const double*>(alpha_dev);
  // the vector path where every pointer is 16-byte aligned
  const int vec = aligned16(g) && aligned16(w) && aligned16(m) &&
                  aligned16(v) && aligned16(w1) && aligned16(m1) &&
                  aligned16(v1) && (p1 == nullptr || aligned16(p1));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (g_bf16)
    return p_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(
                        g, w, m, v, w1, m1, v1, p1, n, s, a, alpha_host,
                        vec, st)
                  : launch<__nv_bfloat16, float>(g, w, m, v, w1, m1, v1, p1,
                                                 n, s, a, alpha_host, vec,
                                                 st);
  return p_bf16 ? launch<float, __nv_bfloat16>(g, w, m, v, w1, m1, v1, p1, n,
                                               s, a, alpha_host, vec, st)
                : launch<float, float>(g, w, m, v, w1, m1, v1, p1, n, s, a,
                                       alpha_host, vec, st);
}

}  // extern "C"
