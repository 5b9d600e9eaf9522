// K2 / K3 for Hopper: the bf16 flash backward on wgmma, fed by TMA, with
// warp specialisation.  Included by flash_attention.cu inside its anonymous
// namespace, after flash_fwd_sm90.cuh, whose PTX helpers (mbar_*,
// tma_load, bar_sync/bar_arrive, sw128_desc, wg_*, pin, wgmma_ss,
// wgmma_rs_n64), tensor-map encoding (encode_map) and route predicate
// (sm90_route) it reuses, and after BwdArgs.
//
// What bounds K2/K3 on the H100: operations.  At B=2, T=8192, H=4, d=64,
// causal, K2 does four T x T x d products over the causal half (S^T, dP^T,
// dV, dK: 137.5 GFLOP, 0.139 ms at the bf16 tensor peak) and K3 three (S,
// dP, dQ: 0.104 ms), against ~50 MB of traffic (0.015 ms).  The mma.sync
// bodies (dkdv_tc, dq_tc) reached 20 % of that peak: 16 rows a warp, every
// operand fragment brought in by ldmatrix per product, every thread busy
// copying tiles by cp.async.
//
// What these bodies do about it (the shape of flash_fwd_sm90_kernel):
// - A block is 3 warpgroups (384 threads, one block an SM).  Warpgroup 0
//   is the producer (setmaxnreg.dec to 40): one thread issues every TMA
//   load; warpgroups 1 and 2 are the consumers (setmaxnreg.inc to 232),
//   each owning 64 rows of the block's 128 (keys in K2, queries in K3).
// - K2 (flash_bwd_dkdv_sm90_kernel): K and V of the block's 128 keys are
//   loaded once; Q and dO stream through a ring of STAGES tiles of BQ
//   queries behind `full`/`empty` mbarriers, and with them the tile's L
//   and D rows, which the producer's first warp copies by 4-byte cp.async
//   whose completion arrives on the stage's `full` barrier (a TMA box needs
//   16 bytes along its inner dimension, and L and D have stride H along t;
//   plain loads held the producer up by their latency every tile, 7 %
//   of K2).  S^T = K Q^T and dP^T = V dO^T are wgmma with K / V as the A
//   operand and the Q / dO tile read K-major as B (as K is in the
//   forward's S); at d <= 64 the consumer's K and V rows are held in
//   registers as that A operand (KV_REGS): from shared memory both
//   operands of an m64n64k16 ask for the SM's whole 128 bytes a cycle of
//   shared memory at the tensor cores' rate (measured 4 % faster in
//   registers).  P^T and dS^T are formed in the
//   accumulator registers and, packed to bf16 pairs, are the register A
//   operand of dV += P^T dO and dK += dS^T Q (wgmma RS), the same Q / dO
//   tile read as the transposed B operand (as V is in the forward's P V).
//   P and dS never touch shared memory; dK and dV are summed in f32
//   registers and written once.
// - K3 (flash_bwd_dq_sm90_kernel): Q and dO of the block's 128 queries are
//   loaded once, with each row's L and D into registers; K and V stream as
//   in the forward.  S = Q K^T and dP = dO V^T are SS, dS is formed in
//   registers, dQ += dS K is RS with K read as the transposed B: the
//   forward's pipeline without the running max.
// - Overlap: in a consumer, tile i's score products and tile i - 1's
//   gradient products are issued together, and tile i's elementwise math
//   runs while the latter are in flight; the two consumers take turns
//   issuing (named barriers), as in the forward.  Tile 0 is peeled off, so
//   every wgmma issue and wait count in the loop is unconditional.
// - Two kernels and no atomics: K2 sums over q-tiles and K3 over k-tiles,
//   each in a fixed order inside one block, so a repeat is bitwise.
// - Tiles, chosen by the registers (ptxas -v: no spills) and by
//   measurement (PERF.md): K2 streams 64-query tiles at d <= 64 (dK, dV
//   64 f32 registers, S^T and dP^T 64, their bf16 operands 32) and
//   32-query tiles at d = 128, where dK and dV alone take 128; K3 streams
//   128-key tiles at d <= 64 and 64-key tiles at d = 128.  At 128 keys S
//   and dP take 128 registers: with dQ and the previous tile's dS operand
//   (in flight) live as well the d <= 64 instance spilled 68 bytes, so
//   there the elementwise math waits for the previous dQ product too
//   (Sm90DqCfg::WAIT), which frees the operand; measured 5 % faster than
//   64-key tiles with the overlap.  The d <= 32 bucket runs the d = 64
//   instances: TMA's zero fill stands in for columns past d, and rows
//   past T.
//
// What bounds them now (tools/flash_bwd_variants.py on an H100, PERF.md):
// at the shape above K3 takes ~2.4x its bound, and its products and
// pipeline alone (no_elementwise) about the bound: its time is the
// elementwise math under the contract below (expf's range reduction
// around one MUFU.EX2, ~14 issue slots a score).  K2 takes ~2.3x, its
// products alone ~1.5x: a consumer's step of 64 queries waits on the turn
// barrier and on its own score products before its elementwise math, ~500
// cycles a step beside ~1,060 of tensor work, and larger steps need more
// registers than dK, dV, S^T, dP^T and their operands leave.

// The numerical contract is bwd_elem's, so the kernels are held to the
// same rounding twins at the same tolerances (K3's twin over its key tile,
// attention.bwd_key_tile): s * scale rounded before L is taken away (no
// FMA), expf, ds = p (dp - D) scale from the unrounded p, P and dS rounded
// to bf16 only as operands, the mask (q < Tq, k < Tk, causal q >= k) only
// on edge tiles, the causal stop at the diagonal and the heaviest-first
// block order.  A masked score's argument becomes NEG_INF, whose expf is
// exactly 0, instead of `keep ? expf(x) : 0`, which compiles to a branch
// around every score.

constexpr int SM90_DKDV_BQ_D64 = 64;    // K2: queries of a streamed tile
constexpr int SM90_DKDV_BQ_D128 = 32;
constexpr int SM90_DQ_BK_D64 = 128;     // K3: keys of a streamed tile
constexpr int SM90_DQ_BK_D128 = 64;

template <int DM>
struct Sm90DkdvCfg {
  static constexpr int NC = 2;                        // consumer warpgroups
  static constexpr int BK = 64 * NC;                  // keys a block
  static constexpr int BQ = DM <= 64 ? SM90_DKDV_BQ_D64 : SM90_DKDV_BQ_D128;
  // K and V rows held in registers as the A operand of the score products
  // (32 registers at d <= 64; at d = 128 dK and dV leave no room for 64)
  static constexpr bool KV_REGS = DM <= 64;
  static constexpr int THREADS = 128 * (NC + 1);
  static constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
  static constexpr int NP = DM / SM90_PANEL;
  static constexpr int STAGES = 4;                    // Q/dO ring depth
  static constexpr int KV_BYTES = NP * BK * 128;      // K or V
  static constexpr int T_BYTES = NP * BQ * 128;       // one Q or dO tile
  static constexpr int V_OFF = KV_BYTES;
  static constexpr int Q_OFF = 2 * KV_BYTES;
  static constexpr int DO_OFF = Q_OFF + STAGES * T_BYTES;
  static constexpr int ROW_OFF = DO_OFF + STAGES * T_BYTES;   // L, D
  static constexpr int BAR_OFF = ROW_OFF + STAGES * 2 * BQ * 4;
  // kv_full, full[STAGES], empty[STAGES]
  static constexpr int BAR_BYTES = 8 * (1 + 2 * STAGES);
  static constexpr size_t smem = BAR_OFF + BAR_BYTES + 1024;
};

template <int DM>
struct Sm90DqCfg {
  static constexpr int NC = 2;
  static constexpr int BQ = 64 * NC;                  // queries a block
  static constexpr int BK = DM <= 64 ? SM90_DQ_BK_D64 : SM90_DQ_BK_D128;
  // wgmma groups still in flight when a tile's elementwise math starts: 1
  // (the previous tile's dQ product) unless S and dP take 128 registers
  static constexpr int WAIT = BK == 128 ? 0 : 1;
  static constexpr int THREADS = 128 * (NC + 1);
  static constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
  static constexpr int NP = DM / SM90_PANEL;
  static constexpr int STAGES = 4;                    // K/V ring depth
  static constexpr int Q_BYTES = NP * BQ * 128;       // Q or dO
  static constexpr int KV_BYTES = NP * BK * 128;      // one K or V tile
  static constexpr int DO_OFF = Q_BYTES;
  static constexpr int K_OFF = 2 * Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  // qdo_full, full[STAGES], empty[STAGES]
  static constexpr int BAR_BYTES = 8 * (1 + 2 * STAGES);
  static constexpr size_t smem = BAR_OFF + BAR_BYTES + 1024;
};

// ------------------------------------------------------------- PTX
// m64n32k16, both operands from shared memory (K2's score products at
// d = 128, 32-query tiles):
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

#define DL4J_F8(d, i)                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 64 f32) (+)= A (64 x 16 bf16, registers) . B (64 x 16)^T, B
// K-major in shared memory (K2's score products with K and V in
// registers); d is overwritten when `accumulate` is 0.
__device__ __forceinline__ void wgmma_rs_kmajor(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : DL4J_F8(d, 0), DL4J_F8(d, 8), DL4J_F8(d, 16), DL4J_F8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

#undef DL4J_F8

// ----------------------------------------------------------- the bodies
// The two score-side products of one consumer, issued together (the caller
// commits): x = A1 . B1^T and y = A2 . B2^T, DM / 16 k-steps each of
// m64n{N}k16, both operands K-major in shared memory.  A1 / A2 are the
// consumer's 64 rows of tiles of ROWS_A rows a panel, B1 / B2 tiles of N
// rows a panel.
template <int DM, int ROWS_A, int N>
__device__ __forceinline__ void issue_scores(float (&x)[N / 2],
                                             float (&y)[N / 2], uint32_t sA1,
                                             uint32_t sB1, uint32_t sA2,
                                             uint32_t sB2) {
  pin(x);
  pin(y);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < DM / 16; ++kk) {
    const int p = kk / 4, kb = (kk % 4) * 32;
    wgmma_ss(x, sw128_desc(sA1 + p * ROWS_A * 128 + kb),
             sw128_desc(sB1 + p * N * 128 + kb), kk > 0);
  }
#pragma unroll
  for (int kk = 0; kk < DM / 16; ++kk) {
    const int p = kk / 4, kb = (kk % 4) * 32;
    wgmma_ss(y, sw128_desc(sA2 + p * ROWS_A * 128 + kb),
             sw128_desc(sB2 + p * N * 128 + kb), kk > 0);
  }
  pin(x);
  pin(y);
}

// The same with the A operands in registers (K2's K and V rows, a1 / a2:
// k-step kk's fragment), N = 64.
template <int DM>
__device__ __forceinline__ void issue_scores(float (&x)[32], float (&y)[32],
                                             const uint32_t (&a1)[DM / 16][4],
                                             uint32_t sB1,
                                             const uint32_t (&a2)[DM / 16][4],
                                             uint32_t sB2) {
  pin(x);
  pin(y);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < DM / 16; ++kk)
    wgmma_rs_kmajor(x, a1[kk],
                    sw128_desc(sB1 + (kk / 4) * 64 * 128 + (kk % 4) * 32),
                    kk > 0);
#pragma unroll
  for (int kk = 0; kk < DM / 16; ++kk)
    wgmma_rs_kmajor(y, a2[kk],
                    sw128_desc(sB2 + (kk / 4) * 64 * 128 + (kk % 4) * 32),
                    kk > 0);
  pin(x);
  pin(y);
}

// The A fragments of one consumer's 64 rows of a tile written by TMA with
// the 128-byte swizzle (`tile` the rows' first byte, ROWS rows a panel):
// k-step kk's a[i] is row wr + gr + 8 (i % 2), columns 16 kk + gc + 8 (i /
// 2) and +1, in 16-byte chunk (2 kk + i / 2) ^ (row % 8) of its 128-byte
// row (the forward's epilogue writes the same pattern).
template <int DM, int ROWS>
__device__ __forceinline__ void load_a_operand(uint32_t (&a)[DM / 16][4],
                                               const unsigned char* tile,
                                               int wr, int gr, int gc) {
#pragma unroll
  for (int kk = 0; kk < DM / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = wr + gr + 8 * (i & 1);
      const int chunk = 2 * (kk % 4) + (i >> 1);
      a[kk][i] = *reinterpret_cast<const uint32_t*>(
          tile + (kk / 4) * ROWS * 128 + r * 128 + ((chunk ^ (r & 7)) << 4) +
          gc * 2);
    }
}

// acc (64 x DM as NP panels of 64 columns) += A (64 x KR, bf16 pairs in
// registers) . B (KR x DM), B the tile at sB (KR rows a panel) read [k][n]
// as the transposed operand: KR / 16 k-steps of m64n64k16 a panel; the
// caller commits.
template <int NP, int KR>
__device__ __forceinline__ void issue_grad(float (&acc)[NP][32],
                                           uint32_t (&a)[KR / 16][4],
                                           uint32_t sB) {
#pragma unroll
  for (int p = 0; p < NP; ++p) pin(acc[p]);
  pin(a);
  wg_fence();
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int mm = 0; mm < KR / 16; ++mm)
      wgmma_rs_n64(acc[p], a[mm], sw128_desc(sB + p * KR * 128 + mm * 2048));
#pragma unroll
  for (int p = 0; p < NP; ++p) pin(acc[p]);
  pin(a);
}

// An m64nN accumulator packed to bf16 pairs: k-step mm's A fragment is
// n-tiles 2 mm and 2 mm + 1 (acc_to_a's pattern).
template <int N>
__device__ __forceinline__ void pack_operand(uint32_t (&a)[N / 16][4],
                                             const float (&x)[N / 2]) {
#pragma unroll
  for (int mm = 0; mm < N / 16; ++mm)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[mm][i] = pack_bf16(x[8 * mm + 2 * i], x[8 * mm + 2 * i + 1]);
}

// K2's elementwise core on one tile, in place: S^T -> P^T in s,
// dP^T -> dS^T in dp.  Element e of n-tile j is key row `krow` + 8 (e / 2)
// and query q0 + 8 j + gc + e % 2, whose L and D are read from the stage's
// rows (Ls, Ds).  The argument s * scale - L of a masked score (only on an
// edge tile) becomes NEG_INF, so expf gives exactly 0 with no branch.
template <int BQ>
__device__ __forceinline__ void dkdv_scores(float (&s)[BQ / 2],
                                            float (&dp)[BQ / 2],
                                            const float* Ls, const float* Ds,
                                            int q0, int krow, int gc,
                                            bool edge, const Geom& g,
                                            float scale, int causal) {
#pragma unroll
  for (int j = 0; j < BQ / 8; ++j) {
    const float2 L2 = *reinterpret_cast<const float2*>(Ls + 8 * j + gc);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[4 * j + e] = __fmul_rn(s[4 * j + e], scale) - ((e & 1) ? L2.y : L2.x);
  }
  if (edge) {
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[4 * j + e] = bwd_keep(q0 + 8 * j + gc + (e & 1), krow + 8 * (e >> 1),
                                g, causal)
                           ? s[4 * j + e]
                           : NEG_INF;
  }
#pragma unroll
  for (int j = 0; j < BQ / 8; ++j) {
    const float2 D2 = *reinterpret_cast<const float2*>(Ds + 8 * j + gc);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = expf(s[4 * j + e]);
      s[4 * j + e] = p;
      dp[4 * j + e] = p * (dp[4 * j + e] - ((e & 1) ? D2.y : D2.x)) * scale;
    }
  }
}

// K3's elementwise core on one tile, in place: S -> P in s, dP -> dS in
// dp.  Element e of n-tile j is query row `qrow` + 8 (e / 2), with L and D
// in Lr, Dr [e / 2], and key k0 + 8 j + gc + e % 2; masked as K2's.
template <int BK>
__device__ __forceinline__ void dq_scores(float (&s)[BK / 2],
                                          float (&dp)[BK / 2],
                                          const float (&Lr)[2],
                                          const float (&Dr)[2], int k0,
                                          int qrow, int gc, bool edge,
                                          const Geom& g, float scale,
                                          int causal) {
#pragma unroll
  for (int i = 0; i < BK / 2; ++i)
    s[i] = __fmul_rn(s[i], scale) - Lr[(i >> 1) & 1];
  if (edge) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[4 * j + e] = bwd_keep(qrow + 8 * (e >> 1), k0 + 8 * j + gc + (e & 1),
                                g, causal)
                           ? s[4 * j + e]
                           : NEG_INF;
  }
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const float p = expf(s[i]);
    s[i] = p;
    dp[i] = p * (dp[i] - Dr[(i >> 1) & 1]) * scale;
  }
}

// f32 rows of a (B, T, H, d) output from an m64n64 accumulator per panel:
// this lane's rows `row` + 8 hf (those below `T`), columns below d.
template <int NP>
__device__ __forceinline__ void store_rows(float* __restrict__ out,
                                           const float (&acc)[NP][32],
                                           const Side& side, int row, int gc,
                                           int b, int h, int d) {
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int t = row + 8 * hf;
    if (t >= side.T) continue;
    float* base = out + offset(side, b, t, h);
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = p * SM90_PANEL + j * 8 + gc;
        if (col < d)
          *reinterpret_cast<float2*>(base + col) =
              make_float2(acc[p][4 * j + 2 * hf], acc[p][4 * j + 2 * hf + 1]);
      }
  }
}

// K2, the block's 128 keys (k-tile blockIdx.y, heaviest first when causal)
// of slice blockIdx.x: dV = P^T dO and dK = dS^T Q over the q-tiles from
// the diagonal on.
template <int DM>
__global__ void __launch_bounds__(Sm90DkdvCfg<DM>::THREADS, 1)
flash_bwd_dkdv_sm90_kernel(__grid_constant__ const CUtensorMap map_q,
                           __grid_constant__ const CUtensorMap map_k,
                           __grid_constant__ const CUtensorMap map_v,
                           __grid_constant__ const CUtensorMap map_do,
                           const float* __restrict__ L,
                           const float* __restrict__ Drow,
                           float* __restrict__ dk, float* __restrict__ dv,
                           Geom g, float scale, int causal) {
  using C = Sm90DkdvCfg<DM>;
  constexpr int BK = C::BK, BQ = C::BQ, NP = C::NP, ST = C::STAGES;
  constexpr int NC = C::NC;
  static_assert(!C::KV_REGS || BQ == 64, "the register-A products are N=64");
  extern __shared__ __align__(16) unsigned char smem_dkdv90[];
  const int bh = blockIdx.x, b = bh / g.H, h = bh % g.H;
  const int k0 = blockIdx.y * BK;
  const int nq = (g.q.T + BQ - 1) / BQ;
  const int qt0 = causal ? k0 / BQ : 0;         // first q-tile on the diagonal
  const int n = nq - qt0;                       // q-tiles this block visits
  if (n <= 0) {
    // causal, and no query reaches these keys: zero gradients
    for (int i = threadIdx.x; i < BK * g.d; i += C::THREADS) {
      const int kp = k0 + i / g.d;
      if (kp < g.k.T) {
        const long long o = offset(g.k, b, kp, h) + i % g.d;
        dk[o] = 0.f;
        dv[o] = 0.f;
      }
    }
    return;
  }
  const uint32_t raw = smem_addr(smem_dkdv90);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t sK = base, sV = base + C::V_OFF;
  const uint32_t sQ = base + C::Q_OFF, sdO = base + C::DO_OFF;
  // L then D, BQ floats each, per stage
  float* rows = reinterpret_cast<float*>(smem_dkdv90 + (base - raw) +
                                         C::ROW_OFF);
  const uint32_t kv_full = base + C::BAR_OFF;
  const uint32_t full = kv_full + 8, empty = full + 8 * ST;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + 8 * s, 1 + 32);          // the TMA and the row copies
      mbar_init(empty + 8 * s, 4 * NC);         // each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        C::PRODUCER_REGS));
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_expect_tx(kv_full, 2 * C::KV_BYTES);
        for (int p = 0; p < NP; ++p) {
          tma_load(sK + p * BK * 128, &map_k, p * SM90_PANEL, h, k0, b,
                   kv_full);
          tma_load(sV + p * BK * 128, &map_v, p * SM90_PANEL, h, k0, b,
                   kv_full);
        }
      }
      for (int i = 0; i < n; ++i) {
        const int st = i % ST, q0 = (qt0 + i) * BQ;
        if (i >= ST) mbar_wait(empty + 8 * st, ((i / ST) - 1) & 1);
        if (lane == 0) {
          mbar_expect_tx(full + 8 * st, 2 * C::T_BYTES);
          for (int p = 0; p < NP; ++p) {
            tma_load(sQ + st * C::T_BYTES + p * BQ * 128, &map_q,
                     p * SM90_PANEL, h, q0, b, full + 8 * st);
            tma_load(sdO + st * C::T_BYTES + p * BQ * 128, &map_do,
                     p * SM90_PANEL, h, q0, b, full + 8 * st);
          }
        }
        // the tile's L and D, zero past Tq (masked there on edge tiles);
        // each lane's copies arrive on the barrier when they complete
        float* Ls = rows + st * 2 * BQ;
        for (int r = lane; r < BQ; r += 32) {
          const int t = q0 + r;
          const bool in = t < g.q.T;
          const long long ri = row_index(g, b, in ? t : 0, h);
          cp_async4(Ls + r, L + ri, in ? 4 : 0);
          cp_async4(Ls + BQ + r, Drow + ri, in ? 4 : 0);
        }
        asm volatile(
            "cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                full + 8 * st)
            : "memory");
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
    const int kc0 = k0 + c * 64;                // this consumer's first key
    const int krow = kc0 + wr + gr;             // this lane's keys: +0, +8
    const uint32_t sKc = sK + c * 64 * 128, sVc = sV + c * 64 * 128;
    const int my_turn = BAR_TURN + c, next_turn = BAR_TURN + (c + 1) % NC;
    const bool last = c == NC - 1;

    float dka[NP][32], dva[NP][32];
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int i = 0; i < 32; ++i) dka[p][i] = dva[p][i] = 0.f;
    float s[BQ / 2], dp[BQ / 2];                // S^T, dP^T: 64 keys x BQ
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];    // P^T, dS^T as operands
    uint32_t kf[C::KV_REGS ? DM / 16 : 1][4];   // K, V rows as operands
    uint32_t vf[C::KV_REGS ? DM / 16 : 1][4];

    // Tile i lives in stage i % ST; its barriers' phase has parity
    // (i / ST) & 1.  Step i issues S^T_i, dP^T_i and tile i - 1's dV, dK
    // products in this consumer's turn; the elementwise math of tile i
    // runs under the latter.
    if (last) bar_arrive(BAR_TURN, 256);
    mbar_wait(kv_full, 0);
    if constexpr (C::KV_REGS) {
      const unsigned char* tiles = smem_dkdv90 + (base - raw) + c * 64 * 128;
      load_a_operand<DM, BK>(kf, tiles, wr, gr, gc);
      load_a_operand<DM, BK>(vf, tiles + C::V_OFF, wr, gr, gc);
    }
    bar_sync(my_turn, 256);
    mbar_wait(full, 0);
    if constexpr (C::KV_REGS)
      issue_scores<DM>(s, dp, kf, sQ, vf, sdO);
    else
      issue_scores<DM, BK, BQ>(s, dp, sKc, sQ, sVc, sdO);
    wg_commit();
    if (!last || n > 1) bar_arrive(next_turn, 256);
    wg_wait<0>();
    pin(s);
    pin(dp);
    dkdv_scores<BQ>(s, dp, rows, rows + BQ, qt0 * BQ, krow, gc,
                    tile_edge(qt0 * BQ, BQ, kc0, 64, g, causal), g, scale,
                    causal);
    pack_operand<BQ>(pa, s);
    pack_operand<BQ>(da, dp);
    for (int i = 1; i < n; ++i) {
      const int st = i % ST, prev = (i - 1) % ST, q0 = (qt0 + i) * BQ;
      bar_sync(my_turn, 256);
      mbar_wait(full + 8 * st, (i / ST) & 1);
      if constexpr (C::KV_REGS)
        issue_scores<DM>(s, dp, kf, sQ + st * C::T_BYTES, vf,
                         sdO + st * C::T_BYTES);
      else
        issue_scores<DM, BK, BQ>(s, dp, sKc, sQ + st * C::T_BYTES, sVc,
                                 sdO + st * C::T_BYTES);
      wg_commit();
      issue_grad<NP, BQ>(dva, pa, sdO + prev * C::T_BYTES);
      issue_grad<NP, BQ>(dka, da, sQ + prev * C::T_BYTES);
      wg_commit();
      if (!last || i + 1 < n) bar_arrive(next_turn, 256);
      wg_wait<1>();                             // S^T_i, dP^T_i landed
      pin(s);
      pin(dp);
      const float* Ls = rows + st * 2 * BQ;
      dkdv_scores<BQ>(s, dp, Ls, Ls + BQ, q0, krow, gc,
                      tile_edge(q0, BQ, kc0, 64, g, causal), g, scale,
                      causal);
      wg_wait<0>();                             // tile i - 1's products done
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        pin(dka[p]);
        pin(dva[p]);
      }
      if (lane == 0) mbar_arrive(empty + 8 * prev);   // stage prev is free
      pack_operand<BQ>(pa, s);
      pack_operand<BQ>(da, dp);
    }
    const int st = (n - 1) % ST;
    issue_grad<NP, BQ>(dva, pa, sdO + st * C::T_BYTES);
    issue_grad<NP, BQ>(dka, da, sQ + st * C::T_BYTES);
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      pin(dka[p]);
      pin(dva[p]);
    }
    store_rows<NP>(dk, dka, g.k, krow, gc, b, h, g.d);
    store_rows<NP>(dv, dva, g.k, krow, gc, b, h, g.d);
  }
}

// K3, the block's 128 queries (q-tile blockIdx.y, in reverse when causal,
// so the last, which sees every k-tile, starts first) of slice
// blockIdx.x: dQ = dS K over the k-tiles up to the diagonal.
template <int DM>
__global__ void __launch_bounds__(Sm90DqCfg<DM>::THREADS, 1)
flash_bwd_dq_sm90_kernel(__grid_constant__ const CUtensorMap map_q,
                         __grid_constant__ const CUtensorMap map_k,
                         __grid_constant__ const CUtensorMap map_v,
                         __grid_constant__ const CUtensorMap map_do,
                         const float* __restrict__ L,
                         const float* __restrict__ Drow,
                         float* __restrict__ dq, Geom g, float scale,
                         int causal) {
  using C = Sm90DqCfg<DM>;
  constexpr int BK = C::BK, BQ = C::BQ, NP = C::NP, ST = C::STAGES;
  constexpr int NC = C::NC;
  extern __shared__ __align__(16) unsigned char smem_dq90[];
  const uint32_t raw = smem_addr(smem_dq90);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t sQ = base, sdO = base + C::DO_OFF;
  const uint32_t sK = base + C::K_OFF, sV = base + C::V_OFF;
  const uint32_t qdo_full = base + C::BAR_OFF;
  const uint32_t full = qdo_full + 8, empty = full + 8 * ST;

  const int bh = blockIdx.x, b = bh / g.H, h = bh % g.H;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BQ;
  int nk = (g.k.T + BK - 1) / BK;               // >= 1: Tk > 0 on this route
  if (causal) nk = min(nk, (q0 + BQ - 1) / BK + 1);   // to the diagonal

  if (threadIdx.x == 0) {
    mbar_init(qdo_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        C::PRODUCER_REGS));
    if (threadIdx.x == 0) {
      mbar_expect_tx(qdo_full, 2 * C::Q_BYTES);
      for (int p = 0; p < NP; ++p) {
        tma_load(sQ + p * BQ * 128, &map_q, p * SM90_PANEL, h, q0, b,
                 qdo_full);
        tma_load(sdO + p * BQ * 128, &map_do, p * SM90_PANEL, h, q0, b,
                 qdo_full);
      }
      for (int kt = 0; kt < nk; ++kt) {
        const int st = kt % ST;
        if (kt >= ST) mbar_wait(empty + 8 * st, ((kt / ST) - 1) & 1);
        mbar_expect_tx(full + 8 * st, 2 * C::KV_BYTES);
        for (int p = 0; p < NP; ++p) {
          tma_load(sK + st * C::KV_BYTES + p * BK * 128, &map_k,
                   p * SM90_PANEL, h, kt * BK, b, full + 8 * st);
          tma_load(sV + st * C::KV_BYTES + p * BK * 128, &map_v,
                   p * SM90_PANEL, h, kt * BK, b, full + 8 * st);
        }
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        C::CONSUMER_REGS));
    const int c = threadIdx.x / 128 - 1;
    const int t = threadIdx.x % 128;
    const int lane = t & 31, wr = (t >> 5) * 16;
    const int gr = lane >> 2, gc = 2 * (lane & 3);
    const int r0 = q0 + c * 64;                 // this consumer's first row
    const int row = r0 + wr + gr;               // this lane's rows: +0, +8
    const uint32_t sQc = sQ + c * 64 * 128, sdOc = sdO + c * 64 * 128;
    const int my_turn = BAR_TURN + c, next_turn = BAR_TURN + (c + 1) % NC;
    const bool last = c == NC - 1;

    float Lr[2], Dr[2];                         // zero past Tq
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const bool in = row + 8 * hf < g.q.T;
      Lr[hf] = in ? L[row_index(g, b, row + 8 * hf, h)] : 0.f;
      Dr[hf] = in ? Drow[row_index(g, b, row + 8 * hf, h)] : 0.f;
    }
    float dqa[NP][32];
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int i = 0; i < 32; ++i) dqa[p][i] = 0.f;
    float s[BK / 2], dp[BK / 2];                // S, dP: 64 queries x BK
    uint32_t da[BK / 16][4];                    // dS as the operand

    if (last) bar_arrive(BAR_TURN, 256);
    mbar_wait(qdo_full, 0);
    bar_sync(my_turn, 256);
    mbar_wait(full, 0);
    issue_scores<DM, BQ, BK>(s, dp, sQc, sK, sdOc, sV);
    wg_commit();
    if (!last || nk > 1) bar_arrive(next_turn, 256);
    wg_wait<0>();
    pin(s);
    pin(dp);
    dq_scores<BK>(s, dp, Lr, Dr, 0, row, gc,
                  tile_edge(r0, 64, 0, BK, g, causal), g, scale, causal);
    pack_operand<BK>(da, dp);
    for (int kt = 1; kt < nk; ++kt) {
      const int st = kt % ST, prev = (kt - 1) % ST;
      bar_sync(my_turn, 256);
      mbar_wait(full + 8 * st, (kt / ST) & 1);
      issue_scores<DM, BQ, BK>(s, dp, sQc, sK + st * C::KV_BYTES, sdOc,
                               sV + st * C::KV_BYTES);
      wg_commit();
      issue_grad<NP, BK>(dqa, da, sK + prev * C::KV_BYTES);
      wg_commit();
      if (!last || kt + 1 < nk) bar_arrive(next_turn, 256);
      wg_wait<C::WAIT>();                       // S_kt, dP_kt landed
      pin(s);
      pin(dp);
      dq_scores<BK>(s, dp, Lr, Dr, kt * BK, row, gc,
                    tile_edge(r0, 64, kt * BK, BK, g, causal), g, scale,
                    causal);
      wg_wait<0>();                             // dQ += dS_{kt-1} K done
#pragma unroll
      for (int p = 0; p < NP; ++p) pin(dqa[p]);
      if (lane == 0) mbar_arrive(empty + 8 * prev);   // stage prev is free
      pack_operand<BK>(da, dp);
    }
    issue_grad<NP, BK>(dqa, da, sK + ((nk - 1) % ST) * C::KV_BYTES);
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int p = 0; p < NP; ++p) pin(dqa[p]);
    store_rows<NP>(dq, dqa, g.q, row, gc, b, h, g.d);
  }
}

// ------------------------------------------------------------ the host
// Returns a cudaError_t, or TMA_ENCODE_FAILED + a CUresult.
template <int DM>
int launch_dkdv_sm90(const BwdArgs& a, cudaStream_t stream) {
  using C = Sm90DkdvCfg<DM>;
  const Geom& g = a.g;
  CUtensorMap mq, mk, mv, mdo;
  int rc = encode_map(&mq, a.q, g, g.q, C::BQ);
  if (rc == 0) rc = encode_map(&mdo, a.dout, g, g.q, C::BQ);
  if (rc == 0) rc = encode_map(&mk, a.k, g, g.k, C::BK);
  if (rc == 0) rc = encode_map(&mv, a.v, g, g.k, C::BK);
  if (rc != 0) return rc;
  auto kern = &flash_bwd_dkdv_sm90_kernel<DM>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(g.B * g.H, (g.k.T + C::BK - 1) / C::BK);
  kern<<<grid, C::THREADS, C::smem, stream>>>(
      mq, mk, mv, mdo, static_cast<const float*>(a.L),
      static_cast<const float*>(a.Drow), static_cast<float*>(a.dk),
      static_cast<float*>(a.dv), g, a.scale, a.causal);
  return (int)cudaGetLastError();
}

template <int DM>
int launch_dq_sm90(const BwdArgs& a, cudaStream_t stream) {
  using C = Sm90DqCfg<DM>;
  const Geom& g = a.g;
  CUtensorMap mq, mk, mv, mdo;
  int rc = encode_map(&mq, a.q, g, g.q, C::BQ);
  if (rc == 0) rc = encode_map(&mdo, a.dout, g, g.q, C::BQ);
  if (rc == 0) rc = encode_map(&mk, a.k, g, g.k, C::BK);
  if (rc == 0) rc = encode_map(&mv, a.v, g, g.k, C::BK);
  if (rc != 0) return rc;
  auto kern = &flash_bwd_dq_sm90_kernel<DM>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(g.B * g.H, (g.q.T + C::BQ - 1) / C::BQ);
  kern<<<grid, C::THREADS, C::smem, stream>>>(
      mq, mk, mv, mdo, static_cast<const float*>(a.L),
      static_cast<const float*>(a.Drow), static_cast<float*>(a.dq), g,
      a.scale, a.causal);
  return (int)cudaGetLastError();
}
