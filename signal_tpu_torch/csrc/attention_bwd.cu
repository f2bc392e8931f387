// Multi-head attention backward, sm_90a.
//
// Replaces the TPU kernel `_attn_bwd_kernel` (signal_tpu/ops/flash_attention.py,
// reached through `_fused_attention_bwd_impl`) and computes what it computes,
// per head h of q, g [B, Lq, D] and k, v [B, Lk, D] (D = H * hd):
//
//   P   = softmax((q_h . k_h^T in fp32) * scale), fp32
//   dV  = round(P)^T . g_h                    (fp32 accumulation)
//   dP  = g_h . v_h^T                         (fp32)
//   dS  = P o (dP - rowsum(dP o P))           (fp32, from the fp32 P)
//   dQ  = (round(dS) . k_h) * scale
//   dK  = (round(dS)^T . q_h) * scale
//
// where round() is a rounding to the operand dtype (identity in fp32) and
// every output is rounded to the operand dtype once. rowsum(dP o P) is
// computed from dP and P themselves: FlashAttention-2's shortcut
// rowsum(dO o O) does not hold here, where P and O are rounded to bf16.
// Heads are column blocks hd wide of the [B, L, D] layout, read by stride:
// there is no transpose.
//
// bf16 up to 160 tokens either way (every shipped shape at 129 tokens; the
// caller routes by length, ops/flash_attention.bwd_route):
// `attention_bwd_fused_kernel`, one kernel on the tensor cores (mma.sync
// m16n8k16, bf16 in, fp32 accumulation). At the flagship step's shape
// ([3B/2 = 192, 129, 768], 12 heads of 64) a launch moves 266 MB and does
// 24.5 GFLOP of the 5 products unpadded, so device memory bounds it (0.080
// ms at 3.35 TB/s); what holds it above that is on-chip latency. One block
// (of up to 4 warps) owns a head, or a thread-block cluster of up to 8
// blocks when the heads are fewer than 2 an SM (pipeline microbatches),
// and sums every output in a fixed order, without atomics or a second
// launch: two launches give the same bits.
//   1. TMA stages the head's Q, K, G and V (box {64, 1, 16, 1} of a 4-D map
//      {hd, H, L, B}, the 128-byte swizzle of tma.cuh, rows past L and
//      columns past hd zero-filled), each operand on its own mbarrier, so S
//      starts once Q and K are in while G and V are in flight. No padding:
//      74 KB at the main shape with the rows' statistics and barriers (76.6
//      KB a block), so three blocks share an SM, and one head's copies run
//      under two others' math.
//   2. Phase 1, query-major: warp w takes query tiles w, w + 4, ... (16
//      rows) and holds S = Q.K^T and dP = G.V^T of its whole key row in
//      registers (17 n-tiles of 8 keys up to 136 keys, the ViT's 129; 20
//      up to 160); the fp32 softmax P = 2^(s - m) . (1 / sum) on logits
//      pre-scaled by scale.log2(e) (ex2.approx.ftz; keys >= Lk masked to
//      -inf by selects; rows >= Lq get 1/sum = 0, so a zero Q row's uniform P
//      cannot leak into dK and dV); delta = rowsum(dP o P) from the fp32
//      dP and P; dS = P o (dP - delta) rounded once into A fragments for dQ
//      = round(dS).K. Each row's max, 1/sum and delta go to shared memory
//      (to every block of a cluster), and the tile's mbarrier is arrived.
//   3. Phase 2, key-major, with no block barrier between the phases: warp
//      w takes key tiles in the reverse order of the workers, so the warps
//      with the fewest query tiles take the most key tiles, and walks the
//      queries two chunks of 16 at a time, waiting on each query tile's
//      barrier as it reaches it. It forms S^T = K.Q^T and dP^T = V.G^T again
//      (the same products, operands swapped), P and dS from the rows'
//      statistics, and feeds round(P)^T and round(dS)^T from its registers
//      as A fragments into dV += round(P)^T.G and dK += round(dS)^T.Q. No P
//      or dS goes through shared memory: 7 products where the TPU kernel
//      does 5, because round(P) and round(dS) of a head (83 KB at 144 x 144)
//      cannot sit beside three heads' operands.
// Every n-tile of the unrolled math is computed: rows past the keys are
// zero in shared memory (TMA's fill, and zeroed rows up to the register
// row), and the masks are selects. A block's registers are allocated by 4
// warps, so three blocks of 4 warps an SM at 168 registers a thread.
// Measured alternatives (scripts/variants_torch_attention.py --bwd;
// PERF.md): a branch per n-tile, expf, one barrier for all operands, two
// blocks an SM, three warps a block, a block barrier between the phases,
// the same tile order in both phases, one chunk a step, a register row of
// 144 keys; the design this one replaces (one block of 9 warps an SM,
// cp.async then the math, round(P) and round(dS) through shared memory)
// ran 1.6x slower. A persistent grid with a producer warp was not built:
// with three resident blocks the copies already hide (1.10x the math-only
// time; scripts/profile_torch_attention.py).
//
// bf16 past 160 tokens (MODEL.STRIDE_SIZE 12 gives L = 211, a 384x128
// input 193): the long route, two tensor-core kernels (mma.sync) with the
// same rounding points as the fused kernel and no atomics. At [192, 211,
// 768] a launch moves 436 MB (0.130 ms at 3.35 TB/s) and its 5 products
// are 65.6 GFLOP unpadded (0.066 ms at 989 TFLOP/s): device memory bounds
// it, and on-chip latency is what holds it above that.
//   attention_bwd_stats_mma_kernel  the rows' statistics in one sweep over
//       the keys: one block per (batch row, head, 128 query rows), 8 warps
//       of 16 rows, the keys through a ring of 2 chunks of 32 (cp.async,
//       the next in flight while this one computes). S = Q.K^T and
//       dP = G.V^T are formed once each; the row max m, sum l = sum e and
//       u = sum dP.e are rescaled as m grows (e = 2^(s - m), the logits
//       times scale.log2(e)). It writes m, 1/l and delta = u/l =
//       rowsum(dP o P) per row to a scratch, [B H][3][Lq rounded up to 32]
//       fp32, the rows past Lq with 1/l = 0.
//   attention_bwd_long_mma_kernel  key-parallel: a head's keys are cut into
//       n blocks of up to 16 warps (8 at hd > 64: the dV and dK
//       accumulators take 64 or 128 registers a thread), one cluster of n
//       blocks per head; n = 1 up to 256 keys at hd 64. Warp w owns 16 keys,
//       stages their K and V once, and keeps their dV and dK in registers
//       for the whole kernel. The queries stream through a ring of 2 chunks
//       of 32 rows of Q, G and their statistics, so shared memory no longer
//       grows with Lq. Per chunk the warp forms S^T = K.Q^T and dP^T =
//       V.G^T once (the statistics kernel's products over hd in the same
//       order, operands swapped), P = 2^(s - m)/l and dS = P o (dP - delta)
//       in fp32, feeds round(P)^T and round(dS)^T from its registers as A
//       fragments into dV += round(P)^T.G and dK += round(dS)^T.Q, and puts
//       round(dS)^T in shared memory. Then the block's warps form dQ =
//       round(dS).K over its keys, 16 x 16 tiles each: a one-block cluster
//       writes it (scaled after the dot, rounded once); a larger cluster
//       keeps fp32 partials, and after a cluster barrier (arrived at once,
//       waited for only a chunk later) block r sums rows r, r + n, ... of
//       the cluster's partials in rank order through distributed shared
//       memory. The same order every call: two calls give the same bits.
// 7 products of [L, L, hd] (2 + 5) against the first long route's 10;
// exp2f once per element in each kernel (the first route ran expf four
// times); every logit is rounded on its own (__fmul_rn, never fused into
// the next subtraction) so that both kernels form the same value. A
// wgmma version of the S and dP products (64-row warpgroup tiles, both
// operands in 128-byte swizzled shared memory) was slower on the card in
// both kernels, and so was one kernel that combines each chunk's row
// statistics across its warps (5 products, no scratch); neither is kept.
// The route takes Lk <= 1024 (clusters of at most 8 blocks, the portable
// size) at any hd <= 128 and any Lq; the wrapper raises beyond.
//
// fp32 (MODEL.COMPUTE_DTYPE float32), at any length: two kernels on the
// tensor cores in 3xTF32 (mma_tf32.cuh: each operand split into a tf32 high
// part and a remainder, three mma.sync.m16n8k8 a product, about 21 bits of
// each product kept), as PyTorch's fp32 SDPA forms its products; TF32
// itself is not turned on. At [192, 129, 768] a launch moves 532.6 MB
// (0.159 ms at 3.35 TB/s) and its 5 products are 24.5 GFLOP (0.149 ms at a
// third of the 495 TFLOP/s TF32 rate): device memory bounds it, and the
// three tensor-core passes a product, the splitting on the CUDA cores and
// the 9 products of two kernels hold it above that. Two kernels, so that
// each stages only two of a head's operands: four fp32 operands of a head
// in one block (the bf16 fused kernel's design) would take 132 KB at 129
// tokens, one block an SM. Each block takes up to kFp32Warps 16-row tiles
// of one head, a warp a tile, its two operands' tiles by TMA; the other two
// operands stream through a ring of kStages chunks of 16 rows by TMA (fp32
// maps, the 128-byte swizzle, zero fill past hd and past L), so every
// length fits; tf32::grid_for sizes the blocks (no idle warp where it can,
// more blocks a head where the heads are few). No atomics, fixed orders:
// two launches give the same bits.
//   attention_bwd_rows_tf32_kernel  dQ and the rows' statistics. Per query
//       tile the key chunks stream twice. Pass 1 forms S = Q.K^T and dP =
//       G.V^T and keeps the row max, sum e and u = sum dP.e, rescaled as
//       the max grows, so that delta = u / sum = rowsum(dP o P) comes from
//       dP and P (as the TPU kernel; FA-2's rowsum(dO o O) is not used).
//       Each row's max, 1/sum (0 past Lq) and delta go to a scratch, [B
//       H][round16(Lq)] of {m, 1/l, delta, 0}. Pass 2 forms S and dP again,
//       P = exp(logit - max) / sum and dS = P o (dP - delta), and dQ += dS.K
//       (each k-step added on the CUDA cores, mma3_add): 5 products. A
//       register row of S and dP (3 products: both kept over up to 144 keys)
//       took 254 registers, two blocks of three warps an SM, and ran 1.38x
//       slower at [192, 129, 768] (scripts/variants_torch_attention.py
//       --fp32; PERF.md).
//   attention_bwd_cols_tf32_kernel  dK and dV. Per 16-key tile the queries
//       stream with their statistics (a bulk copy beside Q and G): S^T =
//       K.Q^T and dP^T = V.G^T (the same products, operands swapped), P and
//       dS from the rows' statistics, and dV += P^T.G, dK += dS^T.Q with P^T
//       and dS^T straight from the accumulators as A fragments: 4 products.
//       dK's query steps are added on the CUDA cores (fresh sums); dV's
//       chain in the tensor core's truncating accumulator up to 160
//       queries (kChainedMaxLq: 2.1x the plain fp32 version's error against
//       fp64 at 129, 3.1x at 211 and 5.2x at 1000 when chained) and are
//       fresh past that, at two blocks an SM. Past hd 64 a block takes
//       half of the head dim (S^T and dP^T formed twice), so that fresh
//       sums fit its registers.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"
#include "tma.cuh"

namespace {

// ---- fp32: 3xTF32 on the tensor cores, operands streamed by TMA -----------

constexpr int kFp32Warps = 4;  // 16-row tiles a block of either kernel, at most

// rows of a (batch row, head) in the fp32 statistics scratch
__host__ __device__ __forceinline__ int fp32_rows(int Lq) { return mma::round16(Lq); }

// Shared memory of a block of either fp32 kernel at HN n-tiles of 8 of the
// head dim and `warps` tiles (dynamic, 1024-aligned by hand), each tile 16
// rows in HN / 4 swizzled slabs of 32 floats: two operands' tiles a warp
// (rows: Q, G; cols: K, V), the ring [kStages] of two operands' chunks
// (rows: K, V; cols: Q, G), the ring's row statistics [kStages][16] (the
// cols kernel's), then the barriers: the warps' tiles', one a stage.
size_t fp32_smem_bytes(int HN, int warps) {
  const size_t tile = (size_t)(HN / 4) * tf32::kRows * tf32::kSlab * sizeof(float);
  return 1024 + tile * 2 * (warps + tf32::kStages) + tf32::kStages * tf32::kRows * 16 +
         sizeof(uint64_t) * (1 + tf32::kStages);
}

template <int HN>
struct Fp32Smem {
  static constexpr int kSlabF = tf32::kRows * tf32::kSlab;  // floats of a slab of a tile
  static constexpr int kTile = (HN / 4) * kSlabF;           // floats of a tile
  static constexpr uint32_t kBox = kSlabF * sizeof(float);  // bytes of a TMA box
  float* own;    // [2][warps] tiles
  float* ring;   // [kStages][2] tiles
  float4* stat;  // [kStages][16]
  uint64_t* bars;
  __device__ __forceinline__ explicit Fp32Smem(unsigned char* raw, int warps) {
    own = reinterpret_cast<float*>(raw + ((1024 - (tma::saddr(raw) & 1023)) & 1023));
    ring = own + 2 * warps * kTile;
    stat = reinterpret_cast<float4*>(ring + 2 * tf32::kStages * kTile);
    bars = reinterpret_cast<uint64_t*>(stat + tf32::kStages * tf32::kRows);
  }
};

template <int HN, int MIN_BLOCKS>
__global__ void __launch_bounds__(kFp32Warps * 32, MIN_BLOCKS)
attention_bwd_rows_tf32_kernel(const __grid_constant__ CUtensorMap qmap,
                               const __grid_constant__ CUtensorMap kmap,
                               const __grid_constant__ CUtensorMap vmap,
                               const __grid_constant__ CUtensorMap gmap, float* __restrict__ dq,
                               float4* __restrict__ stats, int H, int Lq, int Lk, int hd,
                               float scale, int groups) {
  using namespace tf32;
  using S = Fp32Smem<HN>;
  extern __shared__ unsigned char smem_raw[];
  const int warps = blockDim.x >> 5;
  const S sm(smem_raw, warps);
  uint64_t* full = sm.bars + 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tq = lane & 3;
  const int head = blockIdx.x / groups;
  const int grp = blockIdx.x - head * groups;
  const int b = head / H, h = head - b * H;
  const int tiles = (Lq + kRows - 1) / kRows;
  const int tile = grp * warps + warp;
  const bool active = tile < tiles;
  const int loaded = (hd + kSlab - 1) / kSlab;
  const int n = (Lk + kRows - 1) / kRows;  // key chunks of a pass; 2 n in all

  if (threadIdx.x == 0) {
    for (int i = 0; i <= kStages; ++i) tma::mbar_init(sm.bars + i, 1);
    tma::fence_barrier_init();
  }
  zero_unloaded<HN>(sm.own, 2 * warps + 2 * kStages, loaded);
  __syncthreads();

  // chunk i of the sequence: K and V of key chunk i % n (pass i / n); one
  // thread
  auto issue = [&](int i) {
    const int st = i % kStages, c = i % n;
    float* dst = sm.ring + 2 * st * S::kTile;
    tma::mbar_expect_tx(full + st, 2 * loaded * S::kBox);
    for (int s = 0; s < loaded; ++s) {
      tma::load_4d(dst + s * S::kSlabF, &kmap, full + st, s * kSlab, h, c * kRows, b);
      tma::load_4d(dst + S::kTile + s * S::kSlabF, &vmap, full + st, s * kSlab, h, c * kRows, b);
    }
  };
  if (threadIdx.x == 0) {
    const int mine = min(warps, tiles - grp * warps);
    tma::mbar_expect_tx(sm.bars, 2 * mine * loaded * S::kBox);
    for (int w = 0; w < mine; ++w)
      for (int s = 0; s < loaded; ++s) {
        const int row = (grp * warps + w) * kRows;
        tma::load_4d(sm.own + w * S::kTile + s * S::kSlabF, &qmap, sm.bars, s * kSlab, h, row, b);
        tma::load_4d(sm.own + (warps + w) * S::kTile + s * S::kSlabF, &gmap, sm.bars, s * kSlab,
                     h, row, b);
      }
    for (int i = 0; i < kStages && i < 2 * n; ++i) issue(i);
  }

  const uint32_t sQ = tma::saddr(sm.own + warp * S::kTile);
  const uint32_t sG = tma::saddr(sm.own + (warps + warp) * S::kTile);
  const int r0 = tile * kRows;
  // pass 1: the max, sum e and u = sum dP.e, rescaled as the max grows (l
  // and u the lane's parts, summed over the quad at the end); pass 2: dQ
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f}, u[2] = {0.f, 0.f};
  float inv[2], delta[2], acc[HN][4] = {};
  if (active) tma::mbar_wait(sm.bars, 0);
  for (int i = 0; i < 2 * n; ++i) {
    const int st = i % kStages, c = i % n;
    tma::mbar_wait(full + st, (i / kStages) & 1);
    if (i == n) {  // the row statistics, for pass 2 and the cols kernel
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float sum = mma::quad_sum(l[r]);  // every lane shuffles, dead rows too
        // rows >= Lq: P = 0 (a zero Q row's uniform P would leak into dK, dV)
        inv[r] = r0 + gr + 8 * r < Lq ? 1.f / sum : 0.f;
        delta[r] = mma::quad_sum(u[r]) * inv[r];
      }
      if (active && tq == 0) {
        float4* out = stats + (size_t)head * fp32_rows(Lq) + r0 + gr;
        out[0] = make_float4(m[0], inv[0], delta[0], 0.f);
        out[8] = make_float4(m[1], inv[1], delta[1], 0.f);
      }
    }
    if (active) {
      // S = Q.K^T (logits: scaled, masked past Lk) and dP = G.V^T
      const float* Kc = sm.ring + 2 * st * S::kTile;
      float s[2][2][4] = {}, d[2][2][4] = {}, x[2][4], dp[2][4];
      dot_nt<HN>(s, sQ, tma::saddr(Kc), S::kBox, lane);
      dot_nt<HN>(d, sG, tma::saddr(Kc + S::kTile), S::kBox, lane);
      logits(x, s, scale, c * kRows, Lk, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[j][e] = d[0][j][e] + d[1][j][e];
      if (i < n) {
        float nm[2] = {m[0], m[1]};
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) nm[e >> 1] = fmaxf(nm[e >> 1], x[j][e]);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          nm[r] = mma::quad_max(nm[r]);
          const float f = expf(m[r] - nm[r]);  // 0 before the first chunk
          l[r] *= f;
          u[r] *= f;
          m[r] = nm[r];
        }
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = expf(x[j][e] - m[e >> 1]);
            l[e >> 1] += p;
            u[e >> 1] = fmaf(dp[j][e], p, u[e >> 1]);
          }
      } else {
        // P = exp(logit - max) / sum and dS = P o (dP - delta) from the
        // row statistics; dQ += dS.K
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dp[j][e] = expf(x[j][e] - m[e >> 1]) * inv[e >> 1] * (dp[j][e] - delta[e >> 1]);
        dot_cn<HN>(acc, dp[0], Kc, S::kSlabF, 0, lane);
        dot_cn<HN>(acc, dp[1], Kc, S::kSlabF, 8, lane);
      }
    }
    __syncthreads();  // every warp is done with the stage
    if (threadIdx.x == 0 && i + kStages < 2 * n) {
      tma::fence_proxy_async();
      issue(i + kStages);
    }
  }
  if (active)
    store_tile<HN>(dq + ((size_t)b * Lq + r0) * H * hd + (size_t)h * hd, H * hd, 0, Lq - r0, hd,
                   acc, scale, lane);
}

// dK and dV of a block's key tiles, HO of the head dim's HN n-tiles of 8
// (a block a half of the head dim past hd 64: HO = 8 < HN = 16); dK's and,
// with FRESH_V, dV's query steps added on the CUDA cores
template <int HN, int HO, bool FRESH_V, int MIN_BLOCKS>
__global__ void __launch_bounds__(kFp32Warps * 32, MIN_BLOCKS)
attention_bwd_cols_tf32_kernel(const __grid_constant__ CUtensorMap qmap,
                               const __grid_constant__ CUtensorMap kmap,
                               const __grid_constant__ CUtensorMap vmap,
                               const __grid_constant__ CUtensorMap gmap,
                               const float4* __restrict__ stats, float* __restrict__ dk,
                               float* __restrict__ dv, int H, int Lq, int Lk, int hd, float scale,
                               int groups) {
  using namespace tf32;
  using S = Fp32Smem<HN>;
  extern __shared__ unsigned char smem_raw[];
  const int warps = blockDim.x >> 5;
  const S sm(smem_raw, warps);
  uint64_t* full = sm.bars + 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tq = lane & 3;
  const int half = blockIdx.x % (HN / HO);  // the columns 8 HO half ..
  const int head = blockIdx.x / (HN / HO) / groups;
  const int grp = blockIdx.x / (HN / HO) - head * groups;
  const int b = head / H, h = head - b * H;
  const int tiles = (Lk + kRows - 1) / kRows;
  const int tile = grp * warps + warp;
  const bool active = tile < tiles;
  const int loaded = (hd + kSlab - 1) / kSlab;
  const int n = (Lq + kRows - 1) / kRows;  // query chunks
  const float4* head_stats = stats + (size_t)head * fp32_rows(Lq);

  if (threadIdx.x == 0) {
    for (int i = 0; i <= kStages; ++i) tma::mbar_init(sm.bars + i, 1);
    tma::fence_barrier_init();
  }
  zero_unloaded<HN>(sm.own, 2 * warps + 2 * kStages, loaded);
  __syncthreads();

  auto issue = [&](int c) {  // query chunk c of Q, G and their statistics
    const int st = c % kStages;
    float* dst = sm.ring + 2 * st * S::kTile;
    tma::mbar_expect_tx(full + st, 2 * loaded * S::kBox + kRows * sizeof(float4));
    for (int s = 0; s < loaded; ++s) {
      tma::load_4d(dst + s * S::kSlabF, &qmap, full + st, s * kSlab, h, c * kRows, b);
      tma::load_4d(dst + S::kTile + s * S::kSlabF, &gmap, full + st, s * kSlab, h, c * kRows, b);
    }
    tma::load_bulk(sm.stat + st * kRows, head_stats + c * kRows, kRows * sizeof(float4), full + st);
  };
  if (threadIdx.x == 0) {
    const int mine = min(warps, tiles - grp * warps);
    tma::mbar_expect_tx(sm.bars, 2 * mine * loaded * S::kBox);
    for (int w = 0; w < mine; ++w)
      for (int s = 0; s < loaded; ++s) {
        const int row = (grp * warps + w) * kRows;
        tma::load_4d(sm.own + w * S::kTile + s * S::kSlabF, &kmap, sm.bars, s * kSlab, h, row, b);
        tma::load_4d(sm.own + (warps + w) * S::kTile + s * S::kSlabF, &vmap, sm.bars, s * kSlab,
                     h, row, b);
      }
    for (int c = 0; c < kStages && c < n; ++c) issue(c);
  }

  const uint32_t sK = tma::saddr(sm.own + warp * S::kTile);
  const uint32_t sV = tma::saddr(sm.own + (warps + warp) * S::kTile);
  float av[HO][4] = {}, ak[HO][4] = {};
  if (active) tma::mbar_wait(sm.bars, 0);
  for (int c = 0; c < n; ++c) {
    const int st = c % kStages;
    tma::mbar_wait(full + st, (c / kStages) & 1);
    if (active) {
      const float* Qc = sm.ring + 2 * st * S::kTile;
      const float* Gc = Qc + S::kTile;
      // P^T, then dS^T, from the rows' statistics (S^T dead before dP^T
      // is formed: registers); column 2tq + (e & 1) of n-tile j is query 8j
      // + 2tq + (e & 1) of the chunk
      const float4* qs = sm.stat + st * kRows + 2 * tq;
      float p[2][4], ds[2][4];
      {
        float s[2][2][4] = {};
        dot_nt<HN, true>(s, sK, tma::saddr(Qc), S::kBox, lane);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float4 w = qs[8 * j + (e & 1)];
            p[j][e] = expf(__fmul_rn(s[0][j][e] + s[1][j][e], scale) - w.x) * w.y;
          }
      }
      {
        float d[2][2][4] = {};
        dot_nt<HN, true>(d, sV, tma::saddr(Gc), S::kBox, lane);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            ds[j][e] = p[j][e] * (d[0][j][e] + d[1][j][e] - qs[8 * j + (e & 1)].z);
      }
      // dK's query steps added on the CUDA cores (chained in the tensor
      // core, its error against fp64 reached 4.25x the plain fp32
      // version's); dV's too with FRESH_V (chained, 2.2x at 129 queries;
      // fresh, 209 registers and two blocks an SM, 1.18x slower)
      const int c0 = half * (HO / 4) * S::kSlabF;  // the block's first column
      dot_cn<HO, FRESH_V>(av, p[0], Gc + c0, S::kSlabF, 0, lane);
      dot_cn<HO, FRESH_V>(av, p[1], Gc + c0, S::kSlabF, 8, lane);
      dot_cn<HO, true>(ak, ds[0], Qc + c0, S::kSlabF, 0, lane);
      dot_cn<HO, true>(ak, ds[1], Qc + c0, S::kSlabF, 8, lane);
    }
    __syncthreads();  // every warp is done with the stage
    if (threadIdx.x == 0 && c + kStages < n) {
      tma::fence_proxy_async();
      issue(c + kStages);
    }
  }
  if (!active) return;
  const size_t off = ((size_t)b * Lk + tile * kRows) * H * hd + (size_t)h * hd + 8 * HO * half;
  store_tile<HO>(dv + off, H * hd, 0, Lk - tile * kRows, hd - 8 * HO * half, av, 1.f, lane);
  store_tile<HO>(dk + off, H * hd, 0, Lk - tile * kRows, hd - 8 * HO * half, ak, scale, lane);
}

// `split` blocks of each block's tiles (the cols kernel's halves of the
// head dim)
template <typename Kernel, typename... Args>
int launch_tf32_kernel(Kernel kernel, int HN, int split, int heads, int tiles,
                       cudaStream_t stream, Args... args) {
  int device = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = tma::configure_once(reinterpret_cast<const void*>(kernel), device, &limit);
  if (err != cudaSuccess) return (int)err;
  const tf32::Grid grid = tf32::grid_for(device, heads, tiles, kFp32Warps);
  const size_t smem = fp32_smem_bytes(HN, grid.warps);
  kernel<<<(unsigned)(grid.groups * heads * split), grid.warps * 32, smem, stream>>>(
      args..., grid.groups);
  return (int)cudaGetLastError();
}

// the queries up to which the cols kernel chains dV's sums in the tensor
// core (hd <= 64): the train step's 129 tokens, within 2.2x of the plain
// fp32 version's error against fp64; longer sums drift further
constexpr int kChainedMaxLq = 160;

template <int HN, int ROW_BLOCKS, int HO, bool FRESH_V, int COL_BLOCKS>
int launch_fp32_hn(const CUtensorMap (&maps)[4], void* dq, void* dk, void* dv, float* stats,
                   int B, int H, int Lq, int Lk, int hd, float scale, cudaStream_t stream) {
  const int qt = (Lq + tf32::kRows - 1) / tf32::kRows, kt = (Lk + tf32::kRows - 1) / tf32::kRows;
  float4* st = reinterpret_cast<float4*>(stats);
  int err = launch_tf32_kernel(attention_bwd_rows_tf32_kernel<HN, ROW_BLOCKS>, HN, 1, B * H, qt,
                               stream, maps[0], maps[1], maps[2], maps[3],
                               static_cast<float*>(dq), st, H, Lq, Lk, hd, scale);
  if (err) return err;
  return launch_tf32_kernel(attention_bwd_cols_tf32_kernel<HN, HO, FRESH_V, COL_BLOCKS>, HN,
                            HN / HO, B * H, kt, stream, maps[0], maps[1], maps[2], maps[3],
                            static_cast<const float4*>(st), static_cast<float*>(dk),
                            static_cast<float*>(dv), H, Lq, Lk, hd, scale);
}

int launch_fp32(const void* q, const void* k, const void* v, const void* g, void* dq,
                void* dk, void* dv, float* stats, int B, int H, int Lq, int Lk, int hd,
                float scale, cudaStream_t stream) {
  if (hd > 128) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[4];  // q, k, v, g
  int err = tma::encode_heads_f32(&maps[0], q, B, Lq, H, hd, tf32::kRows);
  if (!err) err = tma::encode_heads_f32(&maps[1], k, B, Lk, H, hd, tf32::kRows);
  if (!err) err = tma::encode_heads_f32(&maps[2], v, B, Lk, H, hd, tf32::kRows);
  if (!err) err = tma::encode_heads_f32(&maps[3], g, B, Lq, H, hd, tf32::kRows);
  if (err) return err;
  // three blocks of up to 4 warps an SM: at most 168 registers a thread;
  // fresh dV sums take two
  if (hd <= 64 && Lq <= kChainedMaxLq)
    return launch_fp32_hn<8, 3, 8, false, 3>(maps, dq, dk, dv, stats, B, H, Lq, Lk, hd, scale,
                                             stream);
  if (hd <= 64)
    return launch_fp32_hn<8, 3, 8, true, 2>(maps, dq, dk, dv, stats, B, H, Lq, Lk, hd, scale,
                                            stream);
  return launch_fp32_hn<16, 2, 8, true, 2>(maps, dq, dk, dv, stats, B, H, Lq, Lk, hd, scale,
                                           stream);
}

// ---- bf16 up to 160 tokens: the fused kernel, operands by TMA --------------

using mma::bf16;

constexpr int kFusedMaxLen = 160;   // Lq, Lk the fused kernel takes
// tile workers a block, at most: a block's registers are allocated by 4
// warps, so 3 blocks of 4 warps an SM at 168 registers a thread
constexpr int kFusedMaxWarps = 4;
constexpr int kFusedFill = 2;       // fewer heads than this many an SM: a cluster a head
constexpr int kRows = 16;           // rows of a tile, and of every TMA box
// bytes of 16 rows of one slab: a TMA box, and the step between tiles
constexpr uint32_t kBoxBytes = kRows * tma::kSlab * sizeof(bf16);
// barriers: one for each operand's copies, then one for each query tile's
// statistics (at most kFusedMaxLen / kRows tiles)
enum { kBarQ, kBarK, kBarG, kBarV, kBars, kTileBars = kFusedMaxLen / kRows };

// n-tiles of 8 keys in a warp's register row: 17 up to 136 keys (the
// ViT's 129: no n-tile of padding only), 20 up to 160. A staged tile has
// round16(8 NT) rows (144 or 160), so NT 17 takes Lq <= 144.
__host__ __device__ constexpr int fused_nt(int Lq, int Lk) {
  return Lk <= 136 && mma::round16(Lq) <= 144 ? 17 : 20;
}

// Shared memory of a block (dynamic, 1024-aligned by hand), at offsets
// fixed by the instance (KR = round16(8 NT) rows, HN / 8 slabs of 64
// columns), in this order, each tile in swizzled slabs:
//   Qs, Gs, Ks, Vs  [slabs][KR][64]   rows of K and V past the keys zero
//   stats   [3][KR] fp32     each query row's max of the base-2 logits,
//                            1 / sum e (0 past Lq), delta
//   barriers: Q, K, G, V; the query tiles' statistics
template <int NT, int HN>
struct FusedLayout {
  static constexpr int kRowsStaged = (8 * NT + 15) / 16 * 16;   // KR
  static constexpr int kSlabElems = kRowsStaged * tma::kSlab;   // of one slab of a tile
  static constexpr int kTile = (HN / 8) * kSlabElems;           // elements of a tile
  static constexpr int kStats = kRowsStaged;                    // floats an array
  static constexpr size_t kBytes = 4 * kTile * sizeof(bf16) + 3 * kStats * sizeof(float) +
                                   (kBars + kTileBars) * sizeof(uint64_t);
};

size_t fused_smem_bytes(int Lq, int Lk, int hd) {
  const bool wide = mma::round16(hd) > 64;
  const size_t body = fused_nt(Lq, Lk) == 17
                          ? (wide ? FusedLayout<17, 16>::kBytes : FusedLayout<17, 8>::kBytes)
                          : (wide ? FusedLayout<20, 16>::kBytes : FusedLayout<20, 8>::kBytes);
  return 1024 + body;
}

// logits of a fragment in base 2: s * scale * log2(e), rounded on its own
// (never fused into the next subtraction, so that both phases of the fused
// kernel, and both kernels of the long route, form the same value from the
// same product), masked to -inf where `live` is false
__device__ __forceinline__ float logit2(float s, float scale2, bool live) {
  return live ? __fmul_rn(s, scale2) : -CUDART_INF_F;
}

// acc[2 JP0 .. min(2 JP1, NT)) = A.B^T for one 16-row tile of A (at At:
// its rows in a swizzled tile whose slabs are SLAB elements apart) against
// rows 16 JP0 .. of the swizzled tile Bt: every n-tile, no branch (the
// rows of Bt past its length are zero). HN / 2 k-steps: the columns past
// hd are zero in both tiles.
template <int JP0, int JP1, int HN, int SLAB, int NT>
__device__ __forceinline__ void fused_dot_rows(float (&acc)[NT][4], const bf16* At, const bf16* Bt,
                                               int lane) {
  using namespace mma;
#pragma unroll
  for (int j = 2 * JP0; j < 2 * JP1 && j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll 1  // unrolled, its loads would be hoisted into spilled registers
  for (int kc = 0; kc < HN * 8; kc += 16) {
    uint32_t a[4];
    ldsm_x4(a, tma::swz(At, SLAB, lane & 15, kc + (lane >> 4) * 8));
    // the lane's row of n-tile pair jp is 16 jp on from pair 0's, with the
    // same swizzle (16 jp % 8 == 0): one address, constant offsets
    const bf16* bb = tma::swz(Bt, SLAB, (lane & 7) + (lane >> 4) * 8, kc + ((lane >> 3) & 1) * 8);
#pragma unroll
    for (int jp = JP0; jp < JP1; ++jp) {
      uint32_t b[4];
      ldsm_x4(b, bb + jp * 16 * tma::kSlab);
      mma16816(acc[2 * jp], a, b[0], b[1]);
      if (2 * jp + 1 < NT) mma16816(acc[2 * jp + 1], a, b[2], b[3]);  // an odd NT's last
    }
  }
}

// Byte offset of element (r, c) in a swizzled tile whose slabs are `slab`
// elements apart (tma::swz); c is a multiple of 8. Rows 16 i further on
// lie 16 i * 128 bytes further, with the same swizzle.
__device__ __forceinline__ uint32_t swz_bytes(int slab, int r, int c) {
  return (uint32_t)(2 * ((c >> 6) * slab + r * tma::kSlab + ((((c >> 3) & 7) ^ (r & 7)) << 3)));
}

// A phase-2 lane's offsets into the swizzled tiles, taken once: the A
// fragment of a 16-row tile of K or V at k-step ks, the B fragment of 16
// rows of Q or G (stored [n][k]) at k-step ks, and the B fragment of 16
// rows of G or Q stored [k][n] (ldmatrix.trans) at column step np
template <int HN, int SLAB>
struct KeyLanes {
  uint32_t a[HN / 2], b[HN / 2], t[HN / 2];
  __device__ __forceinline__ explicit KeyLanes(int lane) {
#pragma unroll
    for (int i = 0; i < HN / 2; ++i) {
      a[i] = swz_bytes(SLAB, lane & 15, i * 16 + (lane >> 4) * 8);
      b[i] = swz_bytes(SLAB, (lane & 7) + (lane >> 4) * 8, i * 16 + ((lane >> 3) & 1) * 8);
      t[i] = swz_bytes(SLAB, (lane & 7) + ((lane >> 3) & 1) * 8, i * 16 + (lane >> 4) * 8);
    }
  }
};

// Element offset of row `row` of this block's head in a [B, L, H * hd]
// tensor. Recomputed from blockIdx where a store needs it: kept live through
// the phases, the batch row and head would take registers from the math.
__device__ __forceinline__ size_t fused_head_off(int cluster, int H, int hd, int L, int row) {
  const int head = blockIdx.x / cluster;
  return ((size_t)(head / H) * L + row) * H * hd + (size_t)(head % H) * hd;
}

// Rows `row` and `row + 8` of one statistics array (at st), written by the
// quad's first lane into every block of the cluster
__device__ __forceinline__ void push_stats(float* st, int cluster, int row, const float (&a)[2],
                                           int tq) {
  namespace cg = cooperative_groups;
  if (tq != 0) return;
  for (int r = 0; r < cluster; ++r) {
    float* dst = cluster > 1 ? cg::this_cluster().map_shared_rank(st, r) : st;
    dst[row] = a[0];
    dst[row + 8] = a[1];
  }
}

// Phase 2's step: NC chunks of 16 queries (q0, q0 + 16, ...) against the
// warp's 16 keys (at row k0 of Ks, Vs), interleaved. S^T = K.Q^T and dP^T =
// V.G^T (the same products as phase 1, operands swapped), P = 2^(s - m) /
// l and dS = P o (dP - delta) from the rows' statistics, round(P)^T and
// round(dS)^T from the registers as A fragments: dV += round(P)^T.G, dK +=
// round(dS)^T.Q.
template <int NC, int NT, int HN>
__device__ __forceinline__ void fused_key_step(float (&av)[HN][4], float (&ak)[HN][4],
                                               const KeyLanes<HN, FusedLayout<NT, HN>::kSlabElems>& ln,
                                               uint32_t sQ, uint32_t sG, uint32_t kv_row,
                                               uint32_t sK, uint32_t sV, const float* st_lane,
                                               int q0, const bool (&live)[2], float sl2) {
  using namespace mma;
  using L = FusedLayout<NT, HN>;
  const uint32_t q_row = (uint32_t)q0 / kRows * kBoxBytes;
  float st[NC][2][4] = {}, dt[NC][2][4] = {};
#pragma unroll
  for (int ks = 0; ks < HN / 2; ++ks) {
    // the tile's K and V fragments of the k-step, shared by the NC chunks
    // (held for the whole tile they would take 8 HN more registers)
    uint32_t fk[4], fv[4];
    ldsm_x4(fk, sK + kv_row + ln.a[ks]);
    ldsm_x4(fv, sV + kv_row + ln.a[ks]);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      uint32_t bq[4], bg[4];
      ldsm_x4(bq, sQ + q_row + c * kBoxBytes + ln.b[ks]);
      ldsm_x4(bg, sG + q_row + c * kBoxBytes + ln.b[ks]);
      mma16816(st[c][0], fk, bq[0], bq[1]);
      mma16816(st[c][1], fk, bq[2], bq[3]);
      mma16816(dt[c][0], fv, bg[0], bg[1]);
      mma16816(dt[c][1], fv, bg[2], bg[3]);
    }
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    uint32_t ap[4], as[4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float* stj = st_lane + q0 + 16 * c + 8 * j;  // the lane's two queries
      const float2 mm = *reinterpret_cast<const float2*>(stj);
      const float2 iv = *reinterpret_cast<const float2*>(stj + L::kStats);
      const float2 dl = *reinterpret_cast<const float2*>(stj + 2 * L::kStats);
      float p[4], d[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool hi = e & 1;
        p[e] = ex2_ftz(logit2(st[c][j][e], sl2, live[e >> 1]) - (hi ? mm.y : mm.x)) *
               (hi ? iv.y : iv.x);
        d[e] = p[e] * (dt[c][j][e] - (hi ? dl.y : dl.x));
      }
      ap[2 * j] = pack(p[0], p[1]);
      ap[2 * j + 1] = pack(p[2], p[3]);
      as[2 * j] = pack(d[0], d[1]);
      as[2 * j + 1] = pack(d[2], d[3]);
    }
    // dV += round(P)^T.G, dK += round(dS)^T.Q over the chunk's 16 queries
#pragma unroll
    for (int np = 0; np < HN / 2; ++np) {
      uint32_t bgt[4], bqt[4];
      ldsm_x4_t(bgt, sG + q_row + c * kBoxBytes + ln.t[np]);
      ldsm_x4_t(bqt, sQ + q_row + c * kBoxBytes + ln.t[np]);
      mma16816(av[2 * np], ap, bgt[0], bgt[1]);
      mma16816(av[2 * np + 1], ap, bgt[2], bgt[3]);
      mma16816(ak[2 * np], as, bqt[0], bqt[1]);
      mma16816(ak[2 * np + 1], as, bqt[2], bqt[3]);
    }
  }
}

// One block per (head, rank in the head's cluster), `cluster` blocks a head.
// Worker w = rank * warps + warp takes the head's 16-row query tiles w, w +
// cluster * warps, ... in phase 1 and its key tiles in the reverse order of
// the workers in phase 2. NT: key n-tiles of a phase-1 register row (8 NT
// >= round16(Lq), round16(Lk)); HN: n-tiles of 8 of the head dim (8 up to
// hd 64, 16 up to 128).
template <int NT, int HN, int MIN_BLOCKS>
__global__ void __launch_bounds__(kFusedMaxWarps * 32, MIN_BLOCKS)
attention_bwd_fused_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap,
                           const __grid_constant__ CUtensorMap gmap, bf16* __restrict__ dq,
                           bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Lq, int Lk,
                           int hd, float scale, int cluster) {
  using namespace mma;
  using L = FusedLayout<NT, HN>;
  constexpr int KR = L::kRowsStaged;  // rows of every staged tile
  constexpr int SLAB = L::kSlabElems;
  extern __shared__ unsigned char smem_raw[];
  const int LQP = round16(Lq), LKP = round16(Lk);
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw + ((1024 - (tma::saddr(smem_raw) & 1023)) & 1023));
  bf16* Gs = Qs + L::kTile;
  bf16* Ks = Gs + L::kTile;
  bf16* Vs = Ks + L::kTile;
  float* stats = reinterpret_cast<float*>(Vs + L::kTile);  // m, 1/l, delta
  uint64_t* bars = reinterpret_cast<uint64_t*>(stats + 3 * L::kStats);
  uint64_t* tile_bars = bars + kBars;  // a query tile's statistics are in

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2;
  const int tq = lane & 3;
  const int warps = blockDim.x >> 5;
  const int rank = cluster > 1 ? tma::cluster_rank() : 0;
  const int head = blockIdx.x / cluster;
  const int b = head / H;
  const int h = head - b * H;
  const int D = H * hd;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kBars; ++i) tma::mbar_init(bars + i, 1);
    for (int i = 0; i < kTileBars; ++i) tma::mbar_init(tile_bars + i, 32);  // a warp
    tma::fence_barrier_init();
  }
  // the rows of K and V past the keys, which no copy writes, to zero
  const int pad = (KR - LKP) * (tma::kSlab / 8);  // 16-byte units a slab
  for (int x = threadIdx.x; x < 2 * (HN / 8) * pad; x += blockDim.x) {
    const int slab = x / pad;  // K's slabs, then V's (V follows K)
    *reinterpret_cast<uint4*>(Ks + slab * SLAB + LKP * tma::kSlab + (x - slab * pad) * 8) =
        make_uint4(0, 0, 0, 0);
  }
  __syncthreads();
  // every block of the cluster runs before a peer writes its statistics
  if (cluster > 1) tma::cluster_sync();

  // The head's Q, K, G and V, box by box, each operand on its own barrier:
  // S = Q.K^T starts once Q and K are in, while G and V are in flight.
  // Every box is 16 rows of one slab; rows past L are zero-filled and count.
  const int qboxes = (HN / 8) * (LQP / kRows), kboxes = (HN / 8) * (LKP / kRows);
  if (warp == 0) {
    if (lane == 0) {
      tma::mbar_expect_tx(bars + kBarQ, qboxes * kBoxBytes);
      tma::mbar_expect_tx(bars + kBarK, kboxes * kBoxBytes);
      tma::mbar_expect_tx(bars + kBarG, qboxes * kBoxBytes);
      tma::mbar_expect_tx(bars + kBarV, kboxes * kBoxBytes);
    }
    __syncwarp();
    // boxes in the order Q, K, G, V; lane i issues boxes i, i + 32, ...
    for (int j = lane; j < 2 * (qboxes + kboxes); j += 32) {
      const int op = j < qboxes ? kBarQ : j < qboxes + kboxes ? kBarK
                     : j < 2 * qboxes + kboxes ? kBarG : kBarV;
      const bool is_q = op == kBarQ || op == kBarG;
      const int jj = j - (op == kBarQ ? 0 : op == kBarK ? qboxes
                          : op == kBarG ? qboxes + kboxes : 2 * qboxes + kboxes);
      const int per_slab = (is_q ? LQP : LKP) / kRows;
      const int slab = jj / per_slab;
      const int row = (jj - slab * per_slab) * kRows;
      bf16* dst = op == kBarQ ? Qs : op == kBarK ? Ks : op == kBarG ? Gs : Vs;
      const CUtensorMap* map = op == kBarQ ? &qmap : op == kBarK ? &kmap
                               : op == kBarG ? &gmap : &vmap;
      tma::load_4d(dst + slab * SLAB + row * tma::kSlab, map, bars + op, slab * tma::kSlab, h,
                   row, b);
    }
  }

  const int workers = cluster * warps;
  const int first = rank * warps + warp;
  const float sl2 = scale * 1.4426950408889634f;  // scale log2(e)

  // Phase 1, query-major: warp tile of 16 query rows against all the keys.
  // S and dP of the whole key row in registers; P, delta, dS in fp32; dQ =
  // round(dS).K with round(dS) straight from the registers as A fragments.
  for (int t = first; t < LQP / kRows; t += workers) {
    const int r0 = t * kRows;
    tma::mbar_wait(bars + kBarQ, 0);
    tma::mbar_wait(bars + kBarK, 0);
    float s[NT][4];
    fused_dot_rows<0, (NT + 1) / 2, HN, SLAB>(s, Qs + r0 * tma::kSlab, Ks, lane);
    // P = 2^(s - m) . (1 / sum): exp(logit - max) on the SFU's ex2, keys >=
    // Lk at -inf by selects; rows >= Lq get 1/sum = 0, hence P = 0 (a zero
    // Q row has logits 0, hence a uniform P that would leak into dK, dV)
    const int lim = Lk - 2 * tq;
    float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = logit2(s[j][e], sl2, j * 8 + (e & 1) < lim);
        m[e >> 1] = fmaxf(m[e >> 1], s[j][e]);
      }
    float inv[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) m[i] = quad_max(m[i]);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = ex2_ftz(s[j][e] - m[e >> 1]);
        inv[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      inv[i] = quad_sum(inv[i]);  // every lane shuffles, dead rows too
      inv[i] = r0 + gr + 8 * i < Lq ? 1.f / inv[i] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= inv[e >> 1];
    // the rows' statistics, into every block of the cluster, for phase 2
    // (the max and 1/sum now: their registers are free for dP's)
    push_stats(stats, cluster, r0 + gr, m, tq);
    push_stats(stats + L::kStats, cluster, r0 + gr, inv, tq);

    // dP = G.V^T in fp32; delta = rowsum(dP o P); dS = P o (dP - delta),
    // rounded once into the A fragments of dQ's k-steps
    tma::mbar_wait(bars + kBarG, 0);
    tma::mbar_wait(bars + kBarV, 0);
    float dp[NT][4];
    // in two halves of the keys: fewer fragments in flight beside P
    fused_dot_rows<0, NT / 4, HN, SLAB>(dp, Gs + r0 * tma::kSlab, Vs, lane);
    fused_dot_rows<NT / 4, (NT + 1) / 2, HN, SLAB>(dp, Gs + r0 * tma::kSlab, Vs, lane);
    float delta[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) delta[e >> 1] = fmaf(dp[j][e], s[j][e], delta[e >> 1]);
    delta[0] = quad_sum(delta[0]);
    delta[1] = quad_sum(delta[1]);
    // (an odd NT's last k-step takes zeros for its second n-tile: keys past
    // 8 NT, which K holds as zero rows)
    uint32_t ds[(NT + 1) / 2][4];
#pragma unroll
    for (int kp = 0; kp < (NT + 1) / 2; ++kp)
#pragma unroll
      for (int t2 = 0; t2 < 2; ++t2) {
        const int j = 2 * kp + t2;
        if (j >= NT) {
          ds[kp][2 * t2] = ds[kp][2 * t2 + 1] = 0u;
          continue;
        }
        ds[kp][2 * t2] = pack(s[j][0] * (dp[j][0] - delta[0]), s[j][1] * (dp[j][1] - delta[0]));
        ds[kp][2 * t2 + 1] =
            pack(s[j][2] * (dp[j][2] - delta[1]), s[j][3] * (dp[j][3] - delta[1]));
      }
    // delta (once P and dP are dead); one block a head: the tile's
    // statistics are in, for phase 2's warps
    push_stats(stats + 2 * L::kStats, cluster, r0 + gr, delta, tq);
    __syncwarp();
    if (cluster == 1) tma::mbar_arrive(tile_bars + t);

    // dQ = round(dS).K, scaled after the dot, by output tiles of 64 columns
    bf16* dq_tile = dq + fused_head_off(cluster, H, hd, Lq, r0);
#pragma unroll 1
    for (int c0 = 0; c0 < HN * 8; c0 += kColTile) {
      float acc[kColTile / 8][4] = {};
      uint32_t kb[kColTile / 16];  // K as [k][n] (ldmatrix.trans), key step 0
#pragma unroll
      for (int np = 0; np < kColTile / 16; ++np)
        kb[np] = tma::saddr(Ks) + swz_bytes(SLAB, (lane & 7) + ((lane >> 3) & 1) * 8,
                                            c0 + np * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int kp = 0; kp < (NT + 1) / 2; ++kp)
#pragma unroll
        for (int np = 0; np < kColTile / 16; ++np) {
          uint32_t bb[4];
          ldsm_x4_t(bb, kb[np] + kp * kBoxBytes);
          mma16816(acc[2 * np], ds[kp], bb[0], bb[1]);
          mma16816(acc[2 * np + 1], ds[kp], bb[2], bb[3]);
        }
      store_tile(dq_tile + c0, D, 0, Lq - r0, hd - c0, acc, scale, lane);
    }
  }

  // a cluster: every row's statistics are in every block once all its
  // blocks are here; one block: phase 2 waits on each query tile's barrier
  // as it reaches it, so a warp done with phase 1 goes on at once
  if (cluster > 1) tma::cluster_sync();
  for (int i = 0; i < kBars; ++i) tma::mbar_wait(bars + i, 0);

  // Phase 2, key-major: warp tile of 16 keys against the queries, two
  // chunks of 16 at a time (fused_key_step). No P or dS goes through
  // shared memory. Key tiles in the reverse order of the workers: the warps
  // with fewest query tiles take the most key tiles.
  const KeyLanes<HN, SLAB> lanes(lane);
  const uint32_t sQ = tma::saddr(Qs), sG = tma::saddr(Gs), sK = tma::saddr(Ks),
                 sV = tma::saddr(Vs);
  for (int t = workers - 1 - first; t < LKP / kRows; t += workers) {
    const int k0 = t * kRows;
    const bool live[2] = {k0 + gr < Lk, k0 + gr + 8 < Lk};
    float av[HN][4] = {}, ak[HN][4] = {};
    // up to hd 64 two chunks a step (past it, one: registers; three at hd
    // 64 ran as fast but spilled)
    constexpr int kStep = HN == 8 ? 2 : 1;
    int q0 = 0;
#pragma unroll 1
    for (; q0 + kStep * kRows <= LQP; q0 += kStep * kRows) {
      if (cluster == 1)
        for (int c = 0; c < kStep; ++c) tma::mbar_wait(tile_bars + q0 / kRows + c, 0);
      fused_key_step<kStep, NT, HN>(av, ak, lanes, sQ, sG, t * kBoxBytes, sK, sV,
                                    stats + 2 * tq, q0, live, sl2);
    }
#pragma unroll 1
    for (; q0 < LQP; q0 += kRows) {  // the chunks short of a whole step
      if (cluster == 1) tma::mbar_wait(tile_bars + q0 / kRows, 0);
      fused_key_step<1, NT, HN>(av, ak, lanes, sQ, sG, t * kBoxBytes, sK, sV,
                                stats + 2 * tq, q0, live, sl2);
    }
    const size_t koff = fused_head_off(cluster, H, hd, Lk, k0);
    store_tile(dv + koff, D, 0, Lk - k0, hd, av, 1.f, lane);
    store_tile(dk + koff, D, 0, Lk - k0, hd, ak, scale, lane);
  }
}

struct FusedShape {
  int cluster, warps;
};

// Workers for a launch: up to kFusedMaxWarps a block, each with the same
// number of tiles as far as the tiles allow; one block a head while the
// heads fill the card kFusedFill times over, else a cluster of up to 8
// blocks a head, which share out its query and key tiles.
FusedShape fused_shape(int B, int H, int Lq, int Lk) {
  int device = 0;
  cudaGetDevice(&device);
  static int sms[64] = {};  // per device, read once
  if (device < 64 && !sms[device])
    cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device);
  const int sm_count = device < 64 && sms[device] ? sms[device] : 132;
  const int tiles = mma::round16(Lq > Lk ? Lq : Lk) / kRows;
  const int heads = B * H;
  int cluster = 1;
  if (heads < kFusedFill * sm_count) {
    cluster = (kFusedFill * sm_count + heads - 1) / heads;
    cluster = cluster < 8 ? cluster : 8;
    cluster = cluster < tiles ? cluster : tiles;
  }
  const int per_warp = (tiles + cluster * kFusedMaxWarps - 1) / (cluster * kFusedMaxWarps);
  int warps = (tiles + cluster * per_warp - 1) / (cluster * per_warp);
  cluster = (tiles + warps * per_warp - 1) / (warps * per_warp);
  // the registers of kFusedMaxWarps warps are the block's anyway: as many
  // workers as a block's tiles take, so that more warps hide latency
  const int block_tiles = (tiles + cluster - 1) / cluster;
  warps = block_tiles < kFusedMaxWarps ? block_tiles : kFusedMaxWarps;
  return {cluster, warps};
}

template <int NT, int HN, int MIN_BLOCKS>
int launch_fused_nt(const CUtensorMap (&maps)[4], void* dq, void* dk, void* dv, int B, int H,
                    int Lq, int Lk, int hd, float scale, FusedShape shape, cudaStream_t stream) {
  auto kernel = attention_bwd_fused_kernel<NT, HN, MIN_BLOCKS>;
  const size_t smem = fused_smem_bytes(Lq, Lk, hd);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // all of the SM's 228 KB to shared memory, so that MIN_BLOCKS blocks fit
  // (the attribute stays set: once an instance and device)
  int device = 0;
  cudaGetDevice(&device);
  static bool carveout[64] = {};
  if (device >= 64 || !carveout[device]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    if (device < 64) carveout[device] = true;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)(shape.cluster * B * H));
  config.blockDim = dim3((unsigned)(shape.warps * 32));
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)shape.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, kernel, maps[0], maps[1], maps[2], maps[3],
                           static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                           H, Lq, Lk, hd, scale, shape.cluster);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int launch_fused(const void* q, const void* k, const void* v, const void* g, void* dq, void* dk,
                 void* dv, int B, int H, int Lq, int Lk, int hd, float scale,
                 cudaStream_t stream) {
  if (Lq > kFusedMaxLen || Lk > kFusedMaxLen || hd > 128) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[4];  // q, k, v, g
  int err = tma::encode_heads(&maps[0], q, B, Lq, H, hd, kRows);
  if (!err) err = tma::encode_heads(&maps[1], k, B, Lk, H, hd, kRows);
  if (!err) err = tma::encode_heads(&maps[2], v, B, Lk, H, hd, kRows);
  if (!err) err = tma::encode_heads(&maps[3], g, B, Lq, H, hd, kRows);
  if (err) return err;
  const FusedShape shape = fused_shape(B, H, Lq, Lk);
  const bool wide = mma::round16(hd) > 64;
  if (fused_nt(Lq, Lk) == 17)
    return wide ? launch_fused_nt<17, 16, 1>(maps, dq, dk, dv, B, H, Lq, Lk, hd, scale, shape, stream)
                : launch_fused_nt<17, 8, 3>(maps, dq, dk, dv, B, H, Lq, Lk, hd, scale, shape, stream);
  return wide ? launch_fused_nt<20, 16, 1>(maps, dq, dk, dv, B, H, Lq, Lk, hd, scale, shape, stream)
              : launch_fused_nt<20, 8, 2>(maps, dq, dk, dv, B, H, Lq, Lk, hd, scale, shape, stream);
}

// ---- bf16, past 160 tokens: the long route --------------------------------

constexpr int kLongQ = 32;         // queries a chunk of the dK/dV kernel's ring
constexpr int kLongStages = 2;     // chunks of either kernel's ring
constexpr int kLongMaxKeys = 1024; // Lk the long route takes
constexpr int kLongSq = kLongQ + 8;  // dsT's row stride
constexpr int kStatWarps = 8;      // 16-row tiles a block of the statistics kernel takes
constexpr int kStatKeys = 32;      // keys a chunk of its ring

// rows of a (batch row, head) in the statistics scratch: Lq rounded up to
// whole chunks of kLongQ, the rows past Lq with 1/sum = 0
__host__ __device__ __forceinline__ int long_rows(int Lq) {
  return (Lq + kLongQ - 1) / kLongQ * kLongQ;
}

// most warps a dK/dV block takes: its dV and dK accumulators take 8 HN
// registers a thread, so 16 warps (128 registers a thread) up to hd 64, 8
// (255) up to 128
__host__ __device__ constexpr int long_max_warps(int HN) { return HN <= 8 ? 16 : 8; }

// A head's keys are cut into n blocks of `warps` 16-key tiles, n the fewest
// blocks of at most long_max_warps tiles; each block holds at least one key
// (n <= 8, the portable cluster size, up to kLongMaxKeys).
struct LongShape {
  int n, warps;
};
LongShape long_shape(int Lk, int hd) {
  const int tiles = mma::round16(Lk) / 16;
  const int most = long_max_warps(mma::round16(hd) <= 64 ? 8 : 16);
  const int n = (tiles + most - 1) / most;
  return {n, (tiles + n - 1) / n};
}

// Shared memory (dynamic) of the statistics kernel:
//   Qs, Gs  [16 kStatWarps][padded(hd)] bf16   the block's rows
//   ring    [kLongStages][2][kStatKeys][padded(hd)] bf16   K, V chunks
size_t stat_smem(int hd) {
  return (2 * 16 * kStatWarps + (size_t)kLongStages * 2 * kStatKeys) * mma::padded(hd) *
         sizeof(bf16);
}

// Shared memory (dynamic) of a dK/dV block, in this order, KR = 16 warps:
//   Ks, Vs  [KR][padded(hd)] bf16          the block's keys, staged once
//   ring    [kLongStages] of Q, G [kLongQ][padded(hd)] bf16 and the rows'
//           max, 1/sum, delta [3][kLongQ] fp32
//   dsT     [KR][kLongSq] bf16              round(dS)^T of the chunk
//   qpart   [2][kLongQ][round16(hd) + 4] fp32   the block's dQ partials of
//           two chunks (read by the cluster)
__host__ __device__ size_t long_stage_bytes(int hd) {
  return 2 * (size_t)kLongQ * mma::padded(hd) * sizeof(bf16) + 3 * kLongQ * sizeof(float);
}
size_t long_smem(int Lk, int hd) {
  const size_t KR = 16 * (size_t)long_shape(Lk, hd).warps;
  return 2 * KR * mma::padded(hd) * sizeof(bf16) + kLongStages * long_stage_bytes(hd) +
         KR * kLongSq * sizeof(bf16) + 2 * (size_t)kLongQ * (mma::round16(hd) + 4) * sizeof(float);
}

// stats: per (batch row, head) [3][long_rows(Lq)] fp32 = the row max of
// the base-2 logits, 1 / sum of e, delta = rowsum(dP o P)
__global__ void __launch_bounds__(kStatWarps * 32)
attention_bwd_stats_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                               const bf16* __restrict__ v, const bf16* __restrict__ g,
                               float* __restrict__ stats, int H, int Lq, int Lk, int hd,
                               float scale) {
  using namespace mma;
  constexpr int NK = kStatKeys / 8;  // key n-tiles of a chunk
  extern __shared__ __align__(16) unsigned char smem[];
  const int HDP = round16(hd), so = padded(hd);
  const int QR = 16 * kStatWarps;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Gs = Qs + QR * so;
  bf16* ring = Gs + QR * so;

  const int blocks = (long_rows(Lq) + QR - 1) / QR;
  const int bh = blockIdx.x / blocks;
  const int q0 = (blockIdx.x - bh * blocks) * QR;
  const int b = bh / H;
  const int h = bh - b * H;
  const int D = H * hd;
  const size_t qoff = (size_t)b * Lq * D + (size_t)h * hd + (size_t)q0 * D;
  const size_t koff = (size_t)b * Lk * D + (size_t)h * hd;
  const int nchunks = (Lk + kStatKeys - 1) / kStatKeys;
  auto stage_keys = [&](int c) {
    bf16* Kc = ring + (c % kLongStages) * 2 * kStatKeys * so;
    const size_t off = koff + (size_t)c * kStatKeys * D;
    stage_async(Kc, k + off, Lk - c * kStatKeys, kStatKeys, hd, D);
    stage_async(Kc + kStatKeys * so, v + off, Lk - c * kStatKeys, kStatKeys, hd, D);
  };
  stage_async(Qs, q + qoff, Lq - q0, QR, hd, D);
  stage_async(Gs, g + qoff, Lq - q0, QR, hd, D);
#pragma unroll
  for (int c = 0; c < kLongStages - 1; ++c) {
    if (c < nchunks) stage_keys(c);
    cp_async_commit();
  }

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2;
  const int tq = lane & 3;
  const int r0 = warp * 16;
  const float scale2 = scale * 1.4426950408889634f;
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F}, sum[2] = {0.f, 0.f}, u[2] = {0.f, 0.f};
  for (int c = 0; c < nchunks; ++c) {
    if (c + kLongStages - 1 < nchunks) stage_keys(c + kLongStages - 1);
    cp_async_commit();
    cp_async_wait<kLongStages - 1>();
    __syncthreads();
    const bf16* Kc = ring + (c % kLongStages) * 2 * kStatKeys * so;
    // S = Q.K^T and dP = G.V^T of the warp's rows and the chunk's keys,
    // once each; the row max, sum e and u = sum dP.e rescaled as the max
    // grows (per lane, summed over the quad at the end)
    float s[NK][4], dp[NK][4];
    dot_nt2(s, dp, Qs, Kc, Gs, Kc + kStatKeys * so, so, r0, kStatKeys, HDP, lane);
    float cm[2] = {mx[0], mx[1]};
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = logit2(s[j][e], scale2, c * kStatKeys + j * 8 + 2 * tq + (e & 1) < Lk);
        cm[e >> 1] = fmaxf(cm[e >> 1], s[j][e]);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      cm[i] = quad_max(cm[i]);
      const float f = exp2f(mx[i] - cm[i]);  // 0 before the first chunk
      sum[i] *= f;
      u[i] *= f;
      mx[i] = cm[i];
    }
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = exp2f(s[j][e] - mx[e >> 1]);
        sum[e >> 1] += x;
        u[e >> 1] = fmaf(dp[j][e], x, u[e >> 1]);
      }
    __syncthreads();  // the chunk's stage is free
  }
  const int rows = long_rows(Lq);
  float* out = stats + (size_t)bh * 3 * rows;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    sum[i] = quad_sum(sum[i]);
    u[i] = quad_sum(u[i]);
    const int row = q0 + r0 + gr + 8 * i;
    // rows >= Lq get 1/sum = 0, hence P = 0 (a zero-filled Q row would give
    // a uniform P)
    const float inv = row < Lq ? 1.f / sum[i] : 0.f;
    if (tq == 0 && row < rows) {
      out[row] = mx[i];
      out[rows + row] = inv;
      out[2 * rows + row] = u[i] * inv;
    }
  }
}

// HN: n-tiles of 8 of the head dim that a warp's dV and dK accumulators
// hold (8 up to hd 64, 16 up to 128)
template <int HN>
__global__ void __launch_bounds__(long_max_warps(HN) * 32, 1)
attention_bwd_long_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, const bf16* __restrict__ g,
                              const float* __restrict__ stats, bf16* __restrict__ dq,
                              bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Lq,
                              int Lk, int hd, float scale) {
  using namespace mma;
  namespace cg = cooperative_groups;
  constexpr int NQ = kLongQ / 8;  // query n-tiles of a chunk
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n = (int)cluster.num_blocks();
  const int warps = blockDim.x >> 5;
  const int KR = 16 * warps;
  const int HDP = round16(hd), so = padded(hd), qs = HDP + 4;
  const int stage_bytes = (int)long_stage_bytes(hd);
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + KR * so;
  unsigned char* ring = reinterpret_cast<unsigned char*>(Vs + KR * so);
  bf16* dsT = reinterpret_cast<bf16*>(ring + kLongStages * stage_bytes);
  float* qpart = reinterpret_cast<float*>(dsT + KR * kLongSq);

  const int bh = blockIdx.x / n;
  const int b = bh / H;
  const int h = bh - b * H;
  const int D = H * hd;
  const int rows = long_rows(Lq);
  const size_t qoff = (size_t)b * Lq * D + (size_t)h * hd;
  const size_t koff = (size_t)b * Lk * D + (size_t)h * hd;
  const float* stat_bh = stats + (size_t)bh * 3 * rows;
  const int k0 = rank * KR;
  const int nk = min(KR, Lk - k0);
  const int nchunks = rows / kLongQ;
  auto stage_chunk = [&](int c) {
    bf16* Qc = reinterpret_cast<bf16*>(ring + (c % kLongStages) * stage_bytes);
    const size_t off = qoff + (size_t)c * kLongQ * D;
    stage_async(Qc, q + off, Lq - c * kLongQ, kLongQ, hd, D);
    stage_async(Qc + kLongQ * so, g + off, Lq - c * kLongQ, kLongQ, hd, D);
    float* st = reinterpret_cast<float*>(Qc + 2 * kLongQ * so);
    for (int i = threadIdx.x; i < 3 * kLongQ / 4; i += blockDim.x) {
      const int t = i / (kLongQ / 4), r = (i - t * (kLongQ / 4)) * 4;
      cp_async16(st + t * kLongQ + r, stat_bh + t * rows + c * kLongQ + r, true);
    }
  };
  stage_async(Ks, k + koff + (size_t)k0 * D, nk, KR, hd, D);
  stage_async(Vs, v + koff + (size_t)k0 * D, nk, KR, hd, D);
#pragma unroll
  for (int c = 0; c < kLongStages - 1; ++c) {
    if (c < nchunks) stage_chunk(c);
    cp_async_commit();
  }

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2;
  const int tq = lane & 3;
  const int r0 = warp * 16;  // the warp's keys in Ks, Vs
  const bool live[2] = {k0 + r0 + gr < Lk, k0 + r0 + gr + 8 < Lk};
  const float scale2 = scale * 1.4426950408889634f;
  float av[HN][4] = {}, ak[HN][4] = {};

  // dQ of chunk c: block `rank` sums rows rank, rank + n, ... of the
  // cluster's partials in rank order (the same order every call), then
  // scales and rounds once
  auto reduce_dq = [&](int c) {
    const float* part = qpart + (c & 1) * kLongQ * qs;
    const int vecs = HDP / 4;
    const int mine = (kLongQ - rank + n - 1) / n;
    for (int idx = threadIdx.x; idx < mine * vecs; idx += blockDim.x) {
      const int i = rank + (idx / vecs) * n;
      const int c4 = (idx % vecs) * 4;
      if (c * kLongQ + i >= Lq || c4 >= hd) continue;
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int r = 0; r < n; ++r) {
        const float4 p =
            *reinterpret_cast<const float4*>(cluster.map_shared_rank(part, r) + i * qs + c4);
        sum.x += p.x;
        sum.y += p.y;
        sum.z += p.z;
        sum.w += p.w;
      }
      *reinterpret_cast<uint2*>(dq + qoff + (size_t)(c * kLongQ + i) * D + c4) =
          make_uint2(pack(sum.x * scale, sum.y * scale), pack(sum.z * scale, sum.w * scale));
    }
  };

  for (int c = 0; c < nchunks; ++c) {
    // chunk c + kLongStages - 1 into the stage chunk c - 1 has left
    if (c + kLongStages - 1 < nchunks) stage_chunk(c + kLongStages - 1);
    cp_async_commit();
    cp_async_wait<kLongStages - 1>();
    __syncthreads();
    const bf16* Qc = reinterpret_cast<const bf16*>(ring + (c % kLongStages) * stage_bytes);
    const bf16* Gc = Qc + kLongQ * so;
    const float* st = reinterpret_cast<const float*>(Gc + kLongQ * so);

    // S^T = K.Q^T and dP^T = V.G^T of the warp's keys and the chunk's
    // queries (the statistics kernel's products, operands swapped)
    float s[NQ][4], dp[NQ][4];
    dot_nt2(s, dp, Ks, Qc, Vs, Gc, so, r0, kLongQ, HDP, lane);

    // P = 2^(s - m) / sum and dS = P o (dP - delta) in fp32; round(P)^T and
    // round(dS)^T from the registers as A fragments: dV += round(P)^T.G,
    // dK += round(dS)^T.Q; round(dS)^T to shared memory for dQ
#pragma unroll
    for (int kp = 0; kp < NQ / 2; ++kp) {
      uint32_t ap[4], as[4];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int j = 2 * kp + t;
        const int col = j * 8 + 2 * tq;
        const float2 m = *reinterpret_cast<const float2*>(st + col);
        const float2 inv = *reinterpret_cast<const float2*>(st + kLongQ + col);
        const float2 delta = *reinterpret_cast<const float2*>(st + 2 * kLongQ + col);
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool hi = e & 1;
          p[e] = exp2f(logit2(s[j][e], scale2, live[e >> 1]) - (hi ? m.y : m.x)) *
                 (hi ? inv.y : inv.x);
          ds[e] = p[e] * (dp[j][e] - (hi ? delta.y : delta.x));
        }
        ap[2 * t] = pack(p[0], p[1]);
        ap[2 * t + 1] = pack(p[2], p[3]);
        as[2 * t] = pack(ds[0], ds[1]);
        as[2 * t + 1] = pack(ds[2], ds[3]);
        *reinterpret_cast<uint32_t*>(dsT + (r0 + gr) * kLongSq + col) = as[2 * t];
        *reinterpret_cast<uint32_t*>(dsT + (r0 + gr + 8) * kLongSq + col) = as[2 * t + 1];
      }
      dot_cols_all(av, ap, Gc, so, kp * 16, HDP, lane);
      dot_cols_all(ak, as, Qc, so, kp * 16, HDP, lane);
    }
    __syncthreads();  // dsT is whole

    // dQ of chunk c, round(dS).K over the block's keys, one 16 x 16 unit
    // per warp at a time, two sums over alternate k-steps added at the end.
    // A cluster of one block writes it (scaled, rounded once); a larger
    // one keeps it as the block's fp32 partial, and the cluster's blocks
    // sum the partials of chunk c - 1 first (the barrier of the last chunk,
    // waited for only now)
    if (n > 1 && c > 0) {
      asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
      reduce_dq(c - 1);
    }
    float* part = qpart + (c & 1) * kLongQ * qs;
    const int units = (kLongQ / 16) * (HDP / 16);
    for (int unit = warp; unit < units; unit += warps) {
      const int m0 = (unit % (kLongQ / 16)) * 16, n0 = (unit / (kLongQ / 16)) * 16;
      float acc[2][4] = {}, acc2[2][4] = {};
      int kk = 0;
      for (; kk + 16 < KR; kk += 32) {
        uint32_t a[4], bb[4], a2[4], b2[4];
        ldsm_x4_t(a, a_cols(dsT, kLongSq, kk, m0, lane));
        ldsm_x4_t(bb, b_cols(Ks, so, kk, n0, lane));
        ldsm_x4_t(a2, a_cols(dsT, kLongSq, kk + 16, m0, lane));
        ldsm_x4_t(b2, b_cols(Ks, so, kk + 16, n0, lane));
        mma16816(acc[0], a, bb[0], bb[1]);
        mma16816(acc[1], a, bb[2], bb[3]);
        mma16816(acc2[0], a2, b2[0], b2[1]);
        mma16816(acc2[1], a2, b2[2], b2[3]);
      }
      if (kk < KR) {
        uint32_t a[4], bb[4];
        ldsm_x4_t(a, a_cols(dsT, kLongSq, kk, m0, lane));
        ldsm_x4_t(bb, b_cols(Ks, so, kk, n0, lane));
        mma16816(acc[0], a, bb[0], bb[1]);
        mma16816(acc[1], a, bb[2], bb[3]);
      }
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[t][e] += acc2[t][e];
      if (n == 1) {
        store_tile(dq + qoff + n0, D, c * kLongQ + m0, Lq, hd - n0, acc, scale, lane);
        continue;
      }
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        float* dst = part + (m0 + gr) * qs + n0 + t * 8 + 2 * tq;
        *reinterpret_cast<float2*>(dst) = make_float2(acc[t][0], acc[t][1]);
        *reinterpret_cast<float2*>(dst + 8 * qs) = make_float2(acc[t][2], acc[t][3]);
      }
    }
    // publish them; the barrier completes once every block of the cluster
    // has arrived, and no block writes these partials again before then
    if (n > 1) asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  }
  if (n > 1) {
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
    reduce_dq(nchunks - 1);
  }

  // dV and dK of the block's keys
  store_tile(dv + koff, D, k0 + r0, Lk, hd, av, 1.f, lane);
  store_tile(dk + koff, D, k0 + r0, Lk, hd, ak, scale, lane);
  if (n > 1) cluster.sync();  // no block leaves while the cluster may read its partials
}

int launch_long(const void* q, const void* k, const void* v, const void* g, void* dq, void* dk,
                void* dv, float* stats, int B, int H, int Lq, int Lk, int hd, float scale,
                cudaStream_t stream) {
  const bf16* qq = static_cast<const bf16*>(q);
  const bf16* kk = static_cast<const bf16*>(k);
  const bf16* vv = static_cast<const bf16*>(v);
  const bf16* gg = static_cast<const bf16*>(g);
  const size_t smem_stats = stat_smem(hd);
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_stats_mma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_stats);
  if (err != cudaSuccess) return (int)err;
  const int stat_blocks = (long_rows(Lq) + 16 * kStatWarps - 1) / (16 * kStatWarps);
  attention_bwd_stats_mma_kernel<<<B * H * stat_blocks, kStatWarps * 32, smem_stats, stream>>>(
      qq, kk, vv, gg, stats, H, Lq, Lk, hd, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const LongShape shape = long_shape(Lk, hd);
  const size_t smem = long_smem(Lk, hd);
  auto kernel = mma::round16(hd) <= 64 ? attention_bwd_long_mma_kernel<8>
                                       : attention_bwd_long_mma_kernel<16>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)(shape.n * B * H));
  config.blockDim = dim3((unsigned)(shape.warps * 32));
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = (unsigned)shape.n;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  config.attrs = cluster;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, kernel, qq, kk, vv, gg, static_cast<const float*>(stats),
                           static_cast<bf16*>(dq), static_cast<bf16*>(dk),
                           static_cast<bf16*>(dv), H, Lq, Lk, hd, scale);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The routes of a launch, chosen by the caller (ops/flash_attention.py's
// bwd_route): 0 fp32 (3xTF32, any length), 1 bf16 fused (Lq, Lk <= kFusedMaxLen),
// 2 bf16 long route (up to kLongMaxKeys keys).
int attention_bwd_fused_max_len() { return kFusedMaxLen; }
int attention_bwd_long_max_keys() { return kLongMaxKeys; }

// Shared memory one block of `route` needs, in bytes (the long route: the
// larger of its two kernels').
size_t attention_bwd_smem_bytes(int route, int Lq, int Lk, int hd) {
  if (route == 1) return fused_smem_bytes(Lq, Lk, hd);
  if (route == 2) {
    const size_t a = stat_smem(hd), b = long_smem(Lk, hd);
    return a > b ? a : b;
  }
  return fp32_smem_bytes(hd <= 64 ? 8 : 16, kFp32Warps);
}

// fp32 scratch one launch of `route` needs for its rows' statistics, in
// floats: the fp32 kernels 4 B H Lq rounded up to whole tiles of 16 rows,
// the long route 3 B H Lq rounded up to whole chunks of 32 rows, the fused
// kernel none (they stay on chip).
size_t attention_bwd_stats_floats(int route, int B, int H, int Lq, int Lk) {
  if (route == 0) return 4 * (size_t)B * H * fp32_rows(Lq);
  return route == 2 ? 3 * (size_t)B * H * long_rows(Lq) : 0;
}

// Largest dynamic shared memory a block may opt into on `device`.
int attention_bwd_smem_limit(int device) {
  int bytes = 0;
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return bytes;
}

// q, g, dq [B, Lq, H*hd]; k, v, dk, dv [B, Lk, H*hd]: contiguous, 16-byte
// aligned, hd % 8 == 0, hd <= 128; fp32 for route 0, bf16 for 1 and 2.
// stats: fp32 scratch of attention_bwd_stats_floats floats where that is
// not 0, else unused (may be null).
// Launches on `stream`; returns the first cudaError.
int attention_bwd(const void* q, const void* k, const void* v, const void* g, void* dq,
                  void* dk, void* dv, void* stats, int route, int B, int H, int Lq, int Lk,
                  int hd, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) return launch_fused(q, k, v, g, dq, dk, dv, B, H, Lq, Lk, hd, scale, s);
  if (route == 2) {
    if (hd > 128 || Lk > kLongMaxKeys) return (int)cudaErrorInvalidValue;
    return launch_long(q, k, v, g, dq, dk, dv, static_cast<float*>(stats), B, H, Lq, Lk, hd,
                       scale, s);
  }
  return launch_fp32(q, k, v, g, dq, dk, dv, static_cast<float*>(stats), B, H, Lq, Lk, hd,
                     scale, s);
}

}  // extern "C"
