// K1 / K4 for Hopper: the bf16 flash forward on wgmma, fed by TMA, with
// warp specialisation.  Included by flash_attention.cu inside its anonymous
// namespace, after the helpers it shares with the other bodies (Geom, Side,
// offset, row_index, tile_edge, pack_bf16, smem_addr, NEG_INF, the modes).
//
// What bounds K1/K4 on the H100: operations.  At B=2, T=8192, H=4, d=64 K1
// (causal) does 68.7 GFLOP and K4 (a full ring step) 137.4 GFLOP, 0.07 ms
// and 0.14 ms at the bf16 tensor peak, against ~34 MB of traffic (0.01
// ms).  The mma.sync body (fwd_tc) reached 13 % of that peak: 16 query rows
// a warp, so every K/V fragment that ldmatrix brings in feeds one m16
// tile, the Q fragments re-read per tile, a softmax serialized between the
// products, and every thread busy copying.
//
// What this body does about it (FlashAttention-3's forward shape):
// - A block is 3 warpgroups (384 threads, one block an SM).  Warpgroup 0
//   is the producer: one thread issues every load by TMA, and the group
//   gives its registers back (setmaxnreg.dec to 40).  Warpgroups 1 and 2
//   are the consumers (setmaxnreg.inc to 232), each owning 64 query rows of
//   the block's BQ = 128.
// - Q is loaded once by TMA; K and V stream through a ring of STAGES tiles
//   of BK = 128 keys in shared memory, each tile loaded by TMA with the
//   128-byte swizzle that wgmma reads, behind `full` mbarriers (K and V
//   apart, so S can start before V lands) and released through one `empty`
//   mbarrier a stage.  One 4-D tensor map a tensor, over the (B, T, H, d)
//   layout: dims {d, H, T, B}, box {64, 1, rows, 1}; a row of the d = 128
//   bucket is two 64-column panels (the swizzle caps a box row at 128
//   bytes).  TMA's zero fill replaces explicit padding for rows past T and
//   columns past d, so the d <= 32 bucket runs the d = 64 instance.
// - S = Q K^T is one wgmma m64n128k16 a k-step, both operands from shared
//   memory; O += P V is wgmma m64n64k16 a panel and k-step with P from
//   registers (the S accumulators packed pairwise to bf16: the m64
//   accumulator gives each warp 16 rows in the m16n8 fragment pattern,
//   which is the register A operand's) and V read [key][d] as the
//   transposed B operand.
// - Overlap: inside a warpgroup S_kt and P_{kt-1} V are issued together
//   and the softmax of S_kt runs while P_{kt-1} V is in flight; between
//   the two consumers, named barriers make them take turns issuing their
//   products, so one's softmax runs under the other's tensor-core work.
// - The epilogue of the normalized modes writes bf16 O into the block's
//   (by then dead) Q tile and stores it with TMA, which clips rows past Tq
//   and columns past d; partials write f32 acc, m and l as fwd_tc does.
//
// What bounds it now: the softmax's issue slots.  The contract below costs
// ~14 instructions a score on the FP32 pipe (the exact scale product, the
// max, s - m, expf's range reduction around its one MUFU.EX2, l, the bf16
// pack) against ~4 for an exp2 with the scale folded into one FMA; at d =
// 64 a 128 x 128 tile's two softmaxes take more issue slots than its four
// products take tensor-core cycles, and the softmax of S_kt waits for S_kt.
// An S kept two deep (S_{kt+1} issued before the softmax of S_kt) fits the
// registers at d <= 64, but the compiler then serializes the products
// (C7514/C7520).  The tiles were chosen by ptxas -v and measurement on an
// H100 (tools/flash_fwd_variants.py, PERF.md): 128-key tiles and two
// consumers at every d; three consumers (160 registers) spill, and 64-key
// tiles, with two consumers or three, ran slower.  Branches must stay out
// of the per-score code: `alive ? expf(x) : 0` compiled to a branch a
// score and doubled the time.
//
// The numerical contract is fwd_tc's, so the kernel is held to the same
// rounding twin at the same tolerances (with block = SM90_BK): s * scale
// rounded before the max (no FMA), expf, the -1e30 sentinel with `alive`,
// l summed per lane over the unrounded p and reduced over the quad once at
// the end, P rounded to bf16 only as the operand of P V, the 1e-30 clamp,
// lse = m + log(denom), (0, -1e30, 0) partials for a row that sees no key,
// the mask only on edge tiles, the causal stop at the diagonal and the
// heaviest-first q-tile order.

constexpr int SM90_BK = 128;        // keys of a streamed K/V tile, every d
constexpr int SM90_PANEL = 64;      // bf16 columns of one 128-byte box row

template <int DM>
struct Sm90Cfg {
  // consumer warpgroups, 64 query rows each (three, at 160 registers a
  // thread, spill and ran slower on an H100)
  static constexpr int NC = 2;
  static constexpr int BQ = 64 * NC;                  // query rows a block
  static constexpr int THREADS = 128 * (NC + 1);      // + the producer
  // registers a thread after the split: the producer gives back, the
  // consumers take (128 x 40 + 256 x 232 = 64,512 of the SM's 65,536)
  static constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
  static constexpr int NP = DM / SM90_PANEL;          // panels of a row
  static constexpr int STAGES = DM <= 64 ? 4 : 2;     // K/V ring depth
  static constexpr int Q_BYTES = NP * BQ * 128;
  static constexpr int KV_BYTES = NP * SM90_BK * 128; // one K or V tile
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  // q_full, k_full[STAGES], v_full[STAGES], empty[STAGES]
  static constexpr int BAR_BYTES = 8 * (1 + 3 * STAGES);
  // + 1024: the dynamic base is rounded up to the swizzle's 1024 bytes
  static constexpr size_t smem = BAR_OFF + BAR_BYTES + 1024;
};

// ------------------------------------------------------------- PTX
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(bar)
      : "memory");
}
// Waits until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 4-D tensor map, coordinates {col, head, row, batch}, into
// shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2, int c3,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// A wgmma shared-memory descriptor of a tile written by TMA with the
// 128-byte swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart (the
// stride offset).  K-major operands (Q, K) step along k by moving the
// start 32 bytes inside the row; V, read as the transposed (MN-major) B
// operand, steps along k by 16 rows (2048 bytes) and never crosses a
// 64-column panel inside one instruction, so the leading offset is unused
// in both; it is set to the same 1024.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed wgmma groups are in flight.
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pins registers at this point of the instruction stream, so the compiler
// moves no access of them across an issue or a wait of wgmma.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

#define DL4J_F8(d, i)                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// S = Q K^T a k-step, the instruction chosen by the tile's width (its
// accumulator's size): d (64 x 128 or 64 x 64 f32) (+)= A (64 x 16) .
// B (128 or 64 x 16)^T, both K-major in shared memory; d is overwritten
// when `accumulate` is 0.  m64n128k16:
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : DL4J_F8(d, 0), DL4J_F8(d, 8), DL4J_F8(d, 16), DL4J_F8(d, 24),
        DL4J_F8(d, 32), DL4J_F8(d, 40), DL4J_F8(d, 48), DL4J_F8(d, 56)
      : "l"(da), "l"(db), "r"(accumulate));
}

// m64n64k16:
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : DL4J_F8(d, 0), DL4J_F8(d, 8), DL4J_F8(d, 16), DL4J_F8(d, 24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64 f32) += A (64 x 16 bf16, registers) . B (16 x 64), B stored
// [k][n] in shared memory (MN-major: the transposed operand).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : DL4J_F8(d, 0), DL4J_F8(d, 8), DL4J_F8(d, 16), DL4J_F8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef DL4J_F8

// ----------------------------------------------------------- the body
// Named barriers: 0 is __syncthreads; 1.. NC the consumers' turns to issue
// products, then one a consumer for its epilogue.
constexpr int BAR_TURN = 1;

// S = Q K^T of one consumer: its 64 rows of the Q tile at sQc against the
// K tile at sKt, DM / 16 k-steps of m64n{SM90_BK}k16; the caller commits.
template <int DM, int BQ>
__device__ __forceinline__ void issue_s(float (&s)[SM90_BK / 2],
                                        uint32_t sQc, uint32_t sKt) {
  pin(s);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < DM / 16; ++kk) {
    const int p = kk / 4, kb = (kk % 4) * 32;
    wgmma_ss(s, sw128_desc(sQc + p * BQ * 128 + kb),
             sw128_desc(sKt + p * SM90_BK * 128 + kb), kk > 0);
  }
  pin(s);
}

// O += P V: for each 64-column panel of the V tile at sVt, BK / 16 k-steps
// of m64n64k16 with P from registers.
template <int NP>
__device__ __forceinline__ void issue_pv(float (&o)[NP][32],
                                         uint32_t (&pa)[SM90_BK / 16][4],
                                         uint32_t sVt) {
#pragma unroll
  for (int p = 0; p < NP; ++p) pin(o[p]);
  pin(pa);
  wg_fence();
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int mm = 0; mm < SM90_BK / 16; ++mm)
      wgmma_rs_n64(o[p], pa[mm],
                   sw128_desc(sVt + p * SM90_BK * 128 + mm * 16 * 128));
  wg_commit();
#pragma unroll
  for (int p = 0; p < NP; ++p) pin(o[p]);
  pin(pa);
}

// The streaming softmax of the tile at key k0 on s, in place: scale and
// mask (element e of n-tile j: query row `row` + 8 (e / 2), key
// k0 + 8 j + gc + e % 2; the mask only where `edge`), the running max over
// the quad, corr, p = exp(s - m) in place of s, l per lane.  Branch-free:
// a row that is not alive (m still -1e30) takes its exps against +inf
// instead of m, so p and corr come out exactly 0 as `alive` demands
// (exp(-inf) = 0) with no select or branch an element; the SFU's exps stay
// in flight together.  The row max is a tree over the n-tiles (fmax is
// exact in any order).
__device__ __forceinline__ void softmax_tile(float (&s)[SM90_BK / 2],
                                             float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             int k0, int row, int gc,
                                             bool edge, const Geom& g,
                                             float scale, int causal) {
  if (edge) {
#pragma unroll
    for (int j = 0; j < SM90_BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + j * 8 + gc + (e & 1);
        const bool keep =
            kp < g.k.T && (!causal || row + 8 * (e >> 1) >= kp);
        s[4 * j + e] = keep ? __fmul_rn(s[4 * j + e], scale) : NEG_INF;
      }
  } else {
#pragma unroll
    for (int i = 0; i < SM90_BK / 2; ++i) s[i] = __fmul_rn(s[i], scale);
  }
  float m_exp[2];                       // m, or +inf for a row not alive
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    // elements 4 j + 2 hf + {0, 1} are this half's (rows +0, +8): four
    // running maxes, then a tree
    float mx[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      mx[i] = fmaxf(s[4 * i + 2 * hf], s[4 * i + 2 * hf + 1]);
#pragma unroll
    for (int j = 4; j < SM90_BK / 8; ++j)
      mx[j % 4] = fmaxf(mx[j % 4],
                        fmaxf(s[4 * j + 2 * hf], s[4 * j + 2 * hf + 1]));
    float x = fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[2], mx[3]));
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
    const float m_new = fmaxf(m[hf], x);
    m_exp[hf] = m_new > NEG_INF * 0.5f ? m_new : __int_as_float(0x7f800000);
    corr[hf] = expf(m[hf] - m_exp[hf]);
    m[hf] = m_new;
    l[hf] *= corr[hf];
  }
#pragma unroll
  for (int j = 0; j < SM90_BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int hf = e >> 1;
      s[4 * j + e] = expf(s[4 * j + e] - m_exp[hf]);
      l[hf] += s[4 * j + e];
    }
}

// P (in s) packed to bf16 pairs: k-step mm's A fragment is n-tiles 2 mm
// and 2 mm + 1 of the accumulator (acc_to_a's pattern).
__device__ __forceinline__ void pack_p(uint32_t (&pa)[SM90_BK / 16][4],
                                       const float (&s)[SM90_BK / 2]) {
#pragma unroll
  for (int mm = 0; mm < SM90_BK / 16; ++mm) {
    pa[mm][0] = pack_bf16(s[8 * mm + 0], s[8 * mm + 1]);
    pa[mm][1] = pack_bf16(s[8 * mm + 2], s[8 * mm + 3]);
    pa[mm][2] = pack_bf16(s[8 * mm + 4], s[8 * mm + 5]);
    pa[mm][3] = pack_bf16(s[8 * mm + 6], s[8 * mm + 7]);
  }
}

template <int NP>
__device__ __forceinline__ void rescale(float (&o)[NP][32],
                                        const float (&corr)[2]) {
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      o[p][4 * j + 0] *= corr[0];
      o[p][4 * j + 1] *= corr[0];
      o[p][4 * j + 2] *= corr[1];
      o[p][4 * j + 3] *= corr[1];
    }
}

template <int DM, int MODE>
__global__ void __launch_bounds__(Sm90Cfg<DM>::THREADS, 1)
flash_fwd_sm90_kernel(__grid_constant__ const CUtensorMap map_q,
                      __grid_constant__ const CUtensorMap map_k,
                      __grid_constant__ const CUtensorMap map_v,
                      __grid_constant__ const CUtensorMap map_out,
                      std::conditional_t<MODE == PARTIALS, float, bf16>*
                          __restrict__ out,
                      float* __restrict__ stat_a, float* __restrict__ stat_b,
                      Geom g, float scale, int causal) {
  using C = Sm90Cfg<DM>;
  constexpr int BK = SM90_BK, BQ = C::BQ, NP = C::NP, ST = C::STAGES;
  constexpr int NC = C::NC, BAR_EPI = BAR_TURN + NC;
  extern __shared__ __align__(16) unsigned char smem_sm90[];
  const uint32_t raw = smem_addr(smem_sm90);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t sQ = base, sK = base + C::K_OFF, sV = base + C::V_OFF;
  // barriers: q_full, then k_full, v_full and empty of each stage
  const uint32_t q_full = base + C::BAR_OFF;
  const uint32_t k_full = q_full + 8, v_full = k_full + 8 * ST;
  const uint32_t empty = v_full + 8 * ST;

  const int bh = blockIdx.x;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int b = bh / g.H, h = bh % g.H;
  const int q0 = qt * BQ;
  int nk = (g.k.T + BK - 1) / BK;               // >= 1: Tk > 0 on this route
  if (causal) nk = min(nk, (q0 + BQ - 1) / BK + 1);   // to the diagonal

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * NC);         // each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        C::PRODUCER_REGS));
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, C::Q_BYTES);
      for (int p = 0; p < NP; ++p)
        tma_load(sQ + p * BQ * 128, &map_q, p * SM90_PANEL, h, q0, b,
                 q_full);
      for (int kt = 0; kt < nk; ++kt) {
        const int st = kt % ST;
        if (kt >= ST) mbar_wait(empty + 8 * st, ((kt / ST) - 1) & 1);
        mbar_expect_tx(k_full + 8 * st, C::KV_BYTES);
        for (int p = 0; p < NP; ++p)
          tma_load(sK + st * C::KV_BYTES + p * BK * 128, &map_k,
                   p * SM90_PANEL, h, kt * BK, b, k_full + 8 * st);
        mbar_expect_tx(v_full + 8 * st, C::KV_BYTES);
        for (int p = 0; p < NP; ++p)
          tma_load(sV + st * C::KV_BYTES + p * BK * 128, &map_v,
                   p * SM90_PANEL, h, kt * BK, b, v_full + 8 * st);
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        C::CONSUMER_REGS));
    const int c = threadIdx.x / 128 - 1;        // consumer 0 .. NC - 1
    const int t = threadIdx.x % 128;
    const int lane = t & 31, wr = (t >> 5) * 16;
    const int gr = lane >> 2, gc = 2 * (lane & 3);
    const int r0 = q0 + c * 64;                 // this consumer's first row
    const int row = r0 + wr + gr;               // this lane's rows: +0, +8
    const uint32_t sQc = sQ + c * 64 * 128;
    // the turns, round robin: consumer 0 issues first; each hands the
    // turn to the next, the last one back to consumer 0 after every tile
    // but its last, so every barrier phase completes
    const int my_turn = BAR_TURN + c, next_turn = BAR_TURN + (c + 1) % NC;
    const bool last = c == NC - 1;

    float o[NP][32];
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[p][i] = 0.f;
    float s[BK / 2];                            // S: 64 rows x BK keys
    uint32_t pa[BK / 16][4];
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, corr[2];

    // Tile kt lives in stage kt % ST of the ring; its barriers' phase has
    // parity (kt / ST) & 1.  Step kt issues S_kt and P_{kt-1} V in this
    // consumer's turn, then the softmax of S_kt runs under P_{kt-1} V (and
    // under the other consumer's products).  Tile 0 is peeled off, so that
    // every wgmma issue and every wait count in the loop is unconditional
    // (else the compiler serializes the products).
    if (last) bar_arrive(BAR_TURN, 256);
    mbar_wait(q_full, 0);
    bar_sync(my_turn, 256);
    mbar_wait(k_full, 0);
    issue_s<DM, BQ>(s, sQc, sK);
    wg_commit();
    if (!last || nk > 1) bar_arrive(next_turn, 256);
    wg_wait<0>();
    pin(s);
    softmax_tile(s, m, l, corr, 0, row, gc, tile_edge(r0, 64, 0, BK, g, causal),
                 g, scale, causal);
    pack_p(pa, s);
    for (int kt = 1; kt < nk; ++kt) {
      const int st = kt % ST, prev = (kt - 1) % ST;
      bar_sync(my_turn, 256);
      mbar_wait(k_full + 8 * st, (kt / ST) & 1);
      issue_s<DM, BQ>(s, sQc, sK + st * C::KV_BYTES);
      wg_commit();
      rescale(o, corr);
      mbar_wait(v_full + 8 * prev, ((kt - 1) / ST) & 1);
      issue_pv(o, pa, sV + prev * C::KV_BYTES);
      if (!last || kt + 1 < nk) bar_arrive(next_turn, 256);
      wg_wait<1>();                             // S_kt landed
      pin(s);
      softmax_tile(s, m, l, corr, kt * BK, row, gc,
                   tile_edge(r0, 64, kt * BK, BK, g, causal), g, scale,
                   causal);
      wg_wait<0>();                             // P_{kt-1} V done
#pragma unroll
      for (int p = 0; p < NP; ++p) pin(o[p]);
      if (lane == 0) mbar_arrive(empty + 8 * prev);   // stage prev is free
      pack_p(pa, s);
    }
    rescale(o, corr);
    mbar_wait(v_full + 8 * ((nk - 1) % ST), ((nk - 1) / ST) & 1);
    issue_pv(o, pa, sV + ((nk - 1) % ST) * C::KV_BYTES);
    wg_wait<0>();
#pragma unroll
    for (int p = 0; p < NP; ++p) pin(o[p]);

    // ---------------------------------------------------- epilogue
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 1);
      l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 2);
    }
    const bool writes_row = (lane & 3) == 0;
    if constexpr (MODE == PARTIALS) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int qp = row + 8 * hf;
        if (qp >= g.q.T) continue;              // ragged q rows: not written
        const long long base_o = offset(g.q, b, qp, h);
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = p * SM90_PANEL + j * 8 + gc;
            if (col < g.d)
              *reinterpret_cast<float2*>(out + base_o + col) =
                  make_float2(o[p][4 * j + 2 * hf], o[p][4 * j + 2 * hf + 1]);
          }
        if (writes_row) {
          const long long ri = row_index(g, b, qp, h);
          stat_a[ri] = m[hf];
          stat_b[ri] = l[hf];
        }
      }
    } else {
      // bf16 O = acc / denom into this consumer's 64 rows of the Q tile,
      // in the 128-byte swizzle the output map stores from
      unsigned char* sQc_ptr = smem_sm90 + (sQc - raw);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = wr + gr + 8 * hf;         // row within the 64
        const float denom = fmaxf(l[hf], 1e-30f);
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            *reinterpret_cast<uint32_t*>(
                sQc_ptr + p * BQ * 128 + r * 128 +
                ((j ^ (r & 7)) << 4) + gc * 2) =
                pack_bf16(o[p][4 * j + 2 * hf] / denom,
                          o[p][4 * j + 2 * hf + 1] / denom);
        if (MODE == NORMALIZED_LSE && writes_row && r0 + r < g.q.T)
          stat_a[row_index(g, b, r0 + r, h)] = m[hf] + logf(denom);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bar_sync(BAR_EPI + c, 128);
      if (t == 0 && r0 < g.q.T) {
        for (int p = 0; p < NP; ++p)
          tma_store(&map_out, sQc + p * BQ * 128, p * SM90_PANEL, h, r0,
                    b);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      }
    }
  }
}

// ------------------------------------------------------------ the host
// cuTensorMapEncodeTiled is a driver function: reached through the
// runtime's driver entry point, so the library links no libcuda.
using EncodeTiledFn = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// Returned by the entry points when a tensor map cannot be encoded (the
// CUresult is added); above every cudaError_t.
constexpr int TMA_ENCODE_FAILED = 100000;

// The 4-D map of a bf16 tensor of side `s`: dims {d, H, T, B}, byte
// strides {2 sh, 2 st, 2 sb}, box {64, 1, rows, 1}, 128-byte swizzle,
// zero fill out of bounds.  Returns 0 or TMA_ENCODE_FAILED + CUresult.
int encode_map(CUtensorMap* map, const void* ptr, const Geom& g,
               const Side& s, int rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return TMA_ENCODE_FAILED;
  const cuuint64_t dims[4] = {(cuuint64_t)g.d, (cuuint64_t)g.H,
                              (cuuint64_t)s.T, (cuuint64_t)g.B};
  const cuuint64_t strides[3] = {(cuuint64_t)s.sh * 2, (cuuint64_t)s.st * 2,
                                 (cuuint64_t)s.sb * 2};
  const cuuint32_t box[4] = {SM90_PANEL, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : TMA_ENCODE_FAILED + (int)r;
}

// Does the Hopper body take these inputs: bf16, d a multiple of 8 (16-byte
// box rows and strides), every base 16-byte aligned, every stride a
// multiple of 8 elements, and both sides non-empty.  Shape and alignment
// only: the same answer for the same call every time.
bool sm90_route(const Geom& g, int bf16_in,
                std::initializer_list<const void*> ptrs) {
  if (!bf16_in || g.d <= 0 || g.d > 128 || g.d % 8 != 0) return false;
  if (g.B <= 0 || g.H <= 0 || g.q.T <= 0 || g.k.T <= 0) return false;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  for (const Side* s : {&g.q, &g.k})
    if (s->sb % 8 != 0 || s->st % 8 != 0 || s->sh % 8 != 0) return false;
  return true;
}

template <int DM, int MODE>
int launch_fwd_sm90(const void* q, const void* k, const void* v, void* out,
                    void* stat_a, void* stat_b, const Geom& g, float scale,
                    int causal, cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mo;
  int rc = encode_map(&mq, q, g, g.q, Sm90Cfg<DM>::BQ);
  if (rc == 0) rc = encode_map(&mk, k, g, g.k, SM90_BK);
  if (rc == 0) rc = encode_map(&mv, v, g, g.k, SM90_BK);
  // the output map (normalized modes): out has q's shape and strides, 64
  // rows a consumer; partials store acc without one
  mo = mq;
  if (rc == 0 && MODE != PARTIALS) rc = encode_map(&mo, out, g, g.q, 64);
  if (rc != 0) return rc;
  using O_ = std::conditional_t<MODE == PARTIALS, float, bf16>;
  auto kern = &flash_fwd_sm90_kernel<DM, MODE>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Sm90Cfg<DM>::smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(g.B * g.H, (g.q.T + Sm90Cfg<DM>::BQ - 1) / Sm90Cfg<DM>::BQ);
  kern<<<grid, Sm90Cfg<DM>::THREADS, Sm90Cfg<DM>::smem, stream>>>(
      mq, mk, mv, mo, static_cast<O_*>(out), static_cast<float*>(stat_a),
      static_cast<float*>(stat_b), g, scale, causal);
  return (int)cudaGetLastError();
}
