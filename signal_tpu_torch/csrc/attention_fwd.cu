// Fused multi-head attention forward, sm_90a.
//
// Replaces the TPU kernel `_attn_kernel` (signal_tpu/ops/flash_attention.py,
// reached through `_fused_attention_fwd_impl`) and computes what it
// computes, per head h of q [B, Lq, D], k/v [B, Lk, D] (D = H * hd):
//
//   logits = (q_h . k_h^T in fp32 from operand-dtype values) * scale
//   P      = softmax(logits) in fp32 (row max subtracted, then e / sum e)
//   o_h    = round_to_operand_dtype(P) . v_h, accumulated in fp32
//   o      = o_h in the operand dtype
//
// Heads are column blocks hd wide of the [B, L, D] layout the projections
// write, read by stride: there is no head transpose before or after.
//
// bf16 runs on the tensor cores (mma.sync m16n8k16, bf16 in, fp32
// accumulation) by one of two routes, chosen by the caller from Lk.
//
// Up to 256 keys (every shipped shape: 129, 141, 193, 211, 223 tokens, the
// tensor-parallel and pipeline shapes): `attention_fwd_onepass_kernel`. It
// does tens of operations per byte of q, k, v and o (about 64 at L = 129,
// 105 at 211), under the card's ~295 FLOP/B ridge, so device memory bounds
// it (0.0743 ms at [192, 211, 768]). The design keeps each logit and each
// exponential to one computation and each byte to one trip on chip:
//   - a warp owns a 16-row query tile and keeps the whole key row of its
//     logits in registers (NT n-tiles of 8 keys: 18 for up to 144 keys,
//     28 for 224, 32 for 256), so the softmax is exact in one pass: row
//     max, e = exp(logit - max), P = e . (1 / sum e) in fp32, rounded to
//     bf16 once, straight into the A fragments of O = round(P).V. No
//     online rescaling of an unnormalised P: that would move the TPU
//     kernel's rounding point;
//   - one block (or a thread-block cluster of up to 8) serves all of a
//     head's query tiles, each of its (up to 4) warps walking over
//     several, so the head's K and V come on chip once. TMA
//     (cp.async.bulk.tensor, completing on an mbarrier) copies them box by
//     box; in a cluster each box is multicast into every block, the boxes
//     shared out over the blocks. A cluster a head is used when the heads
//     alone would not give the card kFillBlocksPerSM blocks an SM
//     (pipeline microbatches);
//   - K and V land on separate barriers (the logits start once K is in)
//     and each warp keeps its next query tile in flight while it computes
//     the current one; four blocks share an SM at 129 tokens and three at
//     211, so one block's copies run under the others' math;
//   - TMA writes dense boxes in the 128-byte swizzle (tma.cuh) instead of
//     the padded rows of cp.async staging; its zero fill past hd and past
//     L stands for the padding of the head dim and of the rows;
//   - the math has no branch per n-tile: every n-tile of the NT is
//     computed, the rows of K and V past the keys are zero in shared
//     memory, and keys past Lk are masked by selects. Runtime guards per
//     n-tile split the unrolled code into blocks the compiler cannot
//     interleave, and the warp then waits on each latency in turn.
// Choices, each measured on the card (PERF.md §6;
// scripts/variants_torch_attention.py times each variant against the
// source as it is, scripts/profile_torch_attention.py splits copies from
// math): branch-free math (variant branch_per_tile); exp2f of the scaled
// logit less the max against expf (variant expf); the product and the
// subtraction kept apart (fma_exponent, one fma, is a few per cent faster
// but moves bits enough to turn a discrete choice of the bf16 train step
// that chip_smoke.py's phase 18 holds to one process); three blocks an SM
// at 224 keys at 166 registers against two at up to 255
// (two_blocks_at_224_keys); clusters for few heads (no_cluster); mma.sync
// rather than wgmma, whose 64-row tiles would pad 129 query rows to 192
// against 144 (wgmma was not tried: mma.sync's math already takes the
// kernel under SDPA's time at 129 tokens); several resident blocks rather
// than one persistent block with a producer warp (as built, the kernel
// takes about 1.1x its math-only time: the copies hide). Splitting a row
// over two warps (maxima and sums through shared memory, the P.V partials
// added in warp order) ran slower than one warp at 211 tokens in
// development builds and is not kept.
// Sums are taken in one fixed order with no atomics: two launches on the
// same inputs give the same bits.
//
// Past 256 keys (a 384x128 input at STRIDE_SIZE 12: 311 tokens; cross
// attention): `attention_fwd_long_kernel<SL, ST, MIN_BLOCKS>`, at any
// length. A row of logits no longer fits a warp's registers, and at 1024
// keys a head's K and V (256 KB at hd 64) no longer fit an SM's shared
// memory, so K and V stream through a ring of ST chunks of 64 keys by TMA,
// one producer warp keeping the copies ahead of the math, and the keys are
// swept twice: the first sweep finds each row's max and sum of e (rescaled
// as the max grows, in fp32), the second forms the same logits again, the
// exact normalised P = e . (1 / sum e) rounded to bf16 once, and O =
// round(P).V. So the TPU kernel's rounding point holds, at the cost of a
// third product (Q.K^T twice) and a second exponential per logit: an online
// softmax that rounds e before it knows the sum would save both but moves
// the rounding point. At [192, 311, 768] it does 57 GFLOP of the two
// products (86 with the recomputed one) against 367 MB: about 155 FLOP a
// byte, under the ~295 FLOP/B ridge, so device memory bounds it (0.1095
// ms); what holds it above that is the work on chip. The design, each
// choice measured on the card (scripts/variants_torch_attention.py --long,
// PERF.md §6):
//   - the products are warpgroup products (wgmma): a block's four consumer
//     warps take 64 query rows of one head, S = Q.K^T of a chunk is one
//     m64n64k16 product per 16 columns of hd with Q and K read from shared
//     memory in TMA's swizzle, and O += round(P).V one m64n64k16 product per
//     16 keys and 64 columns with P from registers (the accumulator layout
//     of S is the A layout of the next product). Against mma.sync with a
//     warp a 16-row tile (its K and V fragments through ldmatrix) it took
//     0.32 ms against 0.41 at [192, 311, 768]; two tiles a mma.sync warp
//     ran slower still (registers cost a block an SM). Each product is
//     waited for before the softmax that reads it: issuing the next
//     chunk's before this chunk's softmax (two sets of accumulators)
//     spilled at four blocks an SM, and without spills (hd 128, two
//     blocks) ran 1.4x slower;
//   - the consumer warps release each stage on an mbarrier once read, so a
//     block's copies run ahead under its math; a head's 64-row groups are
//     separate blocks, each streaming K twice and V once, from L2 after the
//     first; as many blocks an SM as the registers allow (four at hd <= 64,
//     three past it) with the stages that still fit: at [192, 311, 768]
//     four blocks of four stages took 0.28 ms, three of six 0.31;
//   - exponentials on the SFU with denormal results flushed
//     (ex2.approx.ftz: exp2f's extra instructions cost 6 to 10 % at 311
//     and 1024 keys), of one fused multiply-add of the dot, scale log2(e)
//     and the row's max in base 2 (the product rounded on its own before
//     the subtraction took 1 to 2 % more); the keys past Lk masked by
//     selects in the last chunk only (in every chunk: 5 % more at 1024
//     keys).
// Sums are taken in one fixed order with no atomics: two launches on the
// same inputs give the same bits.
//
// fp32 (MODEL.COMPUTE_DTYPE float32): `attention_fwd_fp32_kernel`, a
// register-tiled kernel on the CUDA cores, exact to fp32. It forms every
// output in the order of the one-row-a-warp kernel it replaces, and gives
// the same bits: each logit one fmaf chain over hd, times scale;
// each row's max, e = expf(logit - max) and sum e over the lanes' strided
// keys, then a butterfly across the warp; P = e / sum (an IEEE divide); O
// one fmaf chain over the keys in order. 3xTF32 on the tensor cores (each
// operand split into a tf32 high part and a remainder, as PyTorch's fp32
// SDPA forms its products) ran 2.7x faster at [384, 129, 768], within 0.9x
// the plain fp32 version's error against fp64, but moved the gradients of
// five small-tower fp32 train steps (tests/test_torch_cuda.py, kernel path
// against plain path) past their limits; so did an exact streamed kernel
// with an online softmax. This order holds them (PERF.md §6).
// At [384, 129, 768] a launch moves 608.7 MB (0.182 ms at 3.35 TB/s) and
// does 19.6 GFLOP of fp32 products (0.293 ms at the 67 TFLOP/s fp32 rate);
// it takes 1.58 ms (12 TFLOP/s), above SDPA's fp32 1.38: what holds it
// there is not yet measured (PERF.md §7). The design:
//   - a block takes up to kFp32Warps 16-row query tiles of one head, a
//     warp a tile, each out of its own TMA box (fp32 maps, slabs of 32
//     floats in the 128-byte swizzle, zero fill past hd and past L); a head
//     whose tiles are too few to fill the card is cut into more blocks of
//     fewer warps (tf32::grid_for);
//   - K, then V, stream through a ring of kFp32Stages chunks of kChunk keys
//     by TMA, chunk t + kFp32Stages issued once every warp is done with
//     chunk t, so copies run under the math;
//   - a thread holds a 4 x 4 tile of logits (4 rows, keys 8 apart) and of
//     O (4 rows, 4 columns a slab): per 4 steps of hd, 8 conflict-free
//     16-byte shared loads feed 64 fmaf (the swizzle puts the 8 keys or
//     columns a quarter-warp reads in 8 distinct bank groups; Q and P are
//     broadcast); the logits go to a row of shared memory per query, where
//     the softmax reads them by lane, as the one-row-a-warp kernel did;
//   - the logit rows take 64 B a key a warp: a block shrinks to fewer warps
//     for long key rows, up to 3264 keys at hd <= 64 and 2944 at hd <= 128
//     (one warp); past that _guard_smem raises (the one-row-a-warp kernel
//     took about 410 and 210).
// Sums are taken in one fixed order with no atomics: two launches on the
// same inputs give the same bits.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace {

// ---- fp32: a register-tiled kernel on the CUDA cores, operands by TMA ------

constexpr int kFp32Warps = 4;   // 16-row query tiles a block, at most
constexpr int kChunk = 32;      // keys of a chunk of K or V: one TMA box a slab
constexpr int kFp32Stages = 2;  // chunks of the ring
constexpr int kQSlabF = tf32::kRows * tf32::kSlab;  // floats of a slab of a query tile
constexpr int kCSlabF = kChunk * tf32::kSlab;       // floats of a slab of a chunk

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// floats of a query's row of logits (then of P): whole chunks, and 4 more
// so that the rows of a warp's lanes start in two bank groups, not one
__host__ __device__ __forceinline__ int fp32_prow(int Lk) {
  return (Lk + kChunk - 1) / kChunk * kChunk + 4;
}

// Shared memory of a block of `warps` query tiles at HS slabs of 32
// floats of the head dim (dynamic, 1024-aligned by hand): Qs [warps] tiles,
// the ring [kFp32Stages] chunks, the logit rows [warps][16][fp32_prow],
// then the barriers: the Q tiles', one a stage.
size_t fp32_fixed_bytes(int HS) {
  return 1024 + (size_t)kFp32Stages * HS * kCSlabF * sizeof(float) +
         sizeof(uint64_t) * (1 + kFp32Stages);
}
size_t fp32_warp_bytes(int HS, int Lk) {
  return ((size_t)HS * kQSlabF + (size_t)tf32::kRows * fp32_prow(Lk)) * sizeof(float);
}
size_t fp32_smem_bytes(int HS, int warps, int Lk) {
  return fp32_fixed_bytes(HS) + warps * fp32_warp_bytes(HS, Lk);
}

// The logits of a warp's 16 query rows and one chunk of keys (key0 ..):
// lane (rg, x) = (lane / 8, lane % 8) takes rows 4 rg .. 4 rg + 3 and keys
// x + 8 c, c < 4, each one fmaf chain over hd in order (columns past hd
// are zero in Q and K), times scale, into the rows of P (keys < Lk)
template <int HS>
__device__ __forceinline__ void logits_chunk(float* P, int prow, const float* Q, const float* K,
                                             int key0, int Lk, float scale, int rg, int x) {
  float acc[4][4] = {};
#pragma unroll
  for (int s = 0; s < HS; ++s)
#pragma unroll
    for (int ch = 0; ch < 8; ++ch) {
      float4 q[4], k[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = 4 * rg + r;
        q[r] = *reinterpret_cast<const float4*>(Q + s * kQSlabF + row * tf32::kSlab +
                                                ((ch ^ (row & 7)) << 2));
      }
#pragma unroll
      for (int c = 0; c < 4; ++c)  // key x + 8c: its row's swizzle is x
        k[c] = *reinterpret_cast<const float4*>(K + s * kCSlabF + (x + 8 * c) * tf32::kSlab +
                                                ((ch ^ x) << 2));
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[r][c] = fmaf(q[r].x, k[c].x, acc[r][c]);
          acc[r][c] = fmaf(q[r].y, k[c].y, acc[r][c]);
          acc[r][c] = fmaf(q[r].z, k[c].z, acc[r][c]);
          acc[r][c] = fmaf(q[r].w, k[c].w, acc[r][c]);
        }
    }
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int key = key0 + x + 8 * c;
      if (key < Lk) P[(4 * rg + r) * prow + key] = __fmul_rn(acc[r][c], scale);
    }
}

// The softmax of a warp's 16 rows of logits, in place: per row the max,
// e = expf(logit - max) and the sum of e, lane j summing keys j, j + 32,
// ... in order, then a butterfly across the warp, and P = e / sum; the
// keys Lk .. width of each row to 0
__device__ __forceinline__ void softmax_rows(float* P, int prow, int Lk, int width, int lane) {
  for (int r = 0; r < tf32::kRows; ++r) {
    float* row = P + r * prow;
    float mx = -CUDART_INF_F;
    for (int j = lane; j < Lk; j += 32) mx = fmaxf(mx, row[j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < Lk; j += 32) {
      const float e = expf(row[j] - mx);
      row[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < Lk; j += 32) row[j] = row[j] / sum;
    for (int j = Lk + lane; j < width; j += 32) row[j] = 0.f;
  }
}

// O += P.V over one chunk of keys (key0 ..) for a warp's 16 rows: lane
// (rg, x) takes rows 4 rg .. 4 rg + 3 and columns 32 s + 4 x .. 32 s + 4 x
// + 3 of each slab s, one fmaf chain a column over the keys in order (P
// and V are zero past Lk)
template <int HS>
__device__ __forceinline__ void pv_chunk(float4 (&acc)[4][HS], const float* P, int prow,
                                         const float* V, int key0, int rg, int x) {
#pragma unroll 2
  for (int j = 0; j < kChunk; j += 4) {
    float4 p[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      p[r] = *reinterpret_cast<const float4*>(P + (4 * rg + r) * prow + key0 + j);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int key = j + jj;
#pragma unroll
      for (int s = 0; s < HS; ++s) {
        const float4 v = *reinterpret_cast<const float4*>(V + s * kCSlabF + key * tf32::kSlab +
                                                          ((x ^ (key & 7)) << 2));
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float pr = jj == 0 ? p[r].x : jj == 1 ? p[r].y : jj == 2 ? p[r].z : p[r].w;
          acc[r][s].x = fmaf(pr, v.x, acc[r][s].x);
          acc[r][s].y = fmaf(pr, v.y, acc[r][s].y);
          acc[r][s].z = fmaf(pr, v.z, acc[r][s].z);
          acc[r][s].w = fmaf(pr, v.w, acc[r][s].w);
        }
      }
    }
  }
}

template <int HS, int MIN_BLOCKS>
__global__ void __launch_bounds__(kFp32Warps * 32, MIN_BLOCKS)
attention_fwd_fp32_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap, float* __restrict__ o, int H,
                          int Lq, int Lk, int hd, float scale, int groups) {
  extern __shared__ unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw + ((1024 - (tma::saddr(smem_raw) & 1023)) & 1023));
  const int warps = blockDim.x >> 5;
  const int prow = fp32_prow(Lk);
  float* ring = Qs + warps * HS * kQSlabF;
  float* Ps = ring + kFp32Stages * HS * kCSlabF;
  uint64_t* qbar = reinterpret_cast<uint64_t*>(Ps + warps * tf32::kRows * prow);
  uint64_t* full = qbar + 1;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = lane >> 3, x = lane & 7;
  const int head = blockIdx.x / groups;
  const int grp = blockIdx.x - head * groups;
  const int b = head / H, h = head - b * H;
  const int tiles = (Lq + tf32::kRows - 1) / tf32::kRows;
  const int tile = grp * warps + warp;
  const bool active = tile < tiles;
  const int loaded = (hd + tf32::kSlab - 1) / tf32::kSlab;  // slabs the copies write
  const int n = (Lk + kChunk - 1) / kChunk;                 // key chunks, of K then of V

  if (threadIdx.x == 0) {
    for (int i = 0; i <= kFp32Stages; ++i) tma::mbar_init(qbar + i, 1);
    tma::fence_barrier_init();
  }
  // the slabs past hd, which no copy writes, to zero: the Q tiles' and the
  // ring's
  for (int i = threadIdx.x; i < (HS - loaded) * kQSlabF / 4 * warps; i += blockDim.x) {
    const int per = (HS - loaded) * kQSlabF / 4, w = i / per;
    reinterpret_cast<float4*>(Qs + w * HS * kQSlabF + loaded * kQSlabF)[i - w * per] =
        make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int i = threadIdx.x; i < (HS - loaded) * kCSlabF / 4 * kFp32Stages; i += blockDim.x) {
    const int per = (HS - loaded) * kCSlabF / 4, st = i / per;
    reinterpret_cast<float4*>(ring + st * HS * kCSlabF + loaded * kCSlabF)[i - st * per] =
        make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();

  auto issue = [&](int t) {  // chunk t: of K while t < n, then of V; one thread
    const int st = t % kFp32Stages;
    const int c = t < n ? t : t - n;
    float* dst = ring + st * HS * kCSlabF;
    tma::mbar_expect_tx(full + st, loaded * kCSlabF * sizeof(float));
    for (int s = 0; s < loaded; ++s)
      tma::load_4d(dst + s * kCSlabF, t < n ? &kmap : &vmap, full + st, s * tf32::kSlab, h,
                   c * kChunk, b);
  };
  if (threadIdx.x == 0) {
    const int mine = min(warps, tiles - grp * warps);  // the block's query tiles
    tma::mbar_expect_tx(qbar, mine * loaded * kQSlabF * sizeof(float));
    for (int w = 0; w < mine; ++w)
      for (int s = 0; s < loaded; ++s)
        tma::load_4d(Qs + w * HS * kQSlabF + s * kQSlabF, &qmap, qbar, s * tf32::kSlab, h,
                     (grp * warps + w) * tf32::kRows, b);
    for (int t = 0; t < kFp32Stages && t < 2 * n; ++t) issue(t);
  }

  const float* Qw = Qs + warp * HS * kQSlabF;
  float* P = Ps + warp * tf32::kRows * prow;
  float4 acc[4][HS];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int s = 0; s < HS; ++s) acc[r][s] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (active) tma::mbar_wait(qbar, 0);
  for (int t = 0; t < 2 * n; ++t) {
    const int st = t % kFp32Stages;
    const float* C = ring + st * HS * kCSlabF;
    if (active && t == n) {  // every logit is in: the softmax, under V's first copies
      __syncwarp();
      softmax_rows(P, prow, Lk, n * kChunk, lane);
      __syncwarp();
    }
    tma::mbar_wait(full + st, (t / kFp32Stages) & 1);
    if (active) {
      if (t < n)
        logits_chunk<HS>(P, prow, Qw, C, t * kChunk, Lk, scale, rg, x);
      else
        pv_chunk<HS>(acc, P, prow, C, (t - n) * kChunk, rg, x);
    }
    __syncthreads();  // every warp is done with the stage
    if (threadIdx.x == 0 && t + kFp32Stages < 2 * n) {
      tma::fence_proxy_async();
      issue(t + kFp32Stages);
    }
  }
  if (!active) return;
  const int D = H * hd;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = tile * tf32::kRows + 4 * rg + r;
    if (row >= Lq) continue;
    float* dst = o + ((size_t)b * Lq + row) * D + (size_t)h * hd;
#pragma unroll
    for (int s = 0; s < HS; ++s) {
      const int col = s * tf32::kSlab + 4 * x;
      if (col < hd) *reinterpret_cast<float4*>(dst + col) = acc[r][s];
    }
  }
}

template <int HS, int MIN_BLOCKS>
int launch_fp32_hs(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm, void* o,
                   int B, int H, int Lq, int Lk, int hd, float scale, cudaStream_t stream) {
  auto kernel = attention_fwd_fp32_kernel<HS, MIN_BLOCKS>;
  int device = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = tma::configure_once(reinterpret_cast<const void*>(kernel), device, &limit);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (Lq + tf32::kRows - 1) / tf32::kRows;
  tf32::Grid grid = tf32::grid_for(device, B * H, tiles, kFp32Warps);
  // long key rows: fewer warps a block, as many as fit
  const size_t per = fp32_warp_bytes(HS, Lk), fixed = fp32_fixed_bytes(HS);
  if (fixed + grid.warps * per > (size_t)limit) {
    if (fixed + per > (size_t)limit) return (int)cudaErrorInvalidValue;
    grid.warps = (int)(((size_t)limit - fixed) / per);
    grid.groups = (tiles + grid.warps - 1) / grid.warps;
  }
  const size_t smem = fixed + grid.warps * per;
  kernel<<<(unsigned)(grid.groups * B * H), grid.warps * 32, smem, stream>>>(
      qm, km, vm, static_cast<float*>(o), H, Lq, Lk, hd, scale, grid.groups);
  return (int)cudaGetLastError();
}

int launch_fp32(const void* q, const void* k, const void* v, void* o, int B, int H, int Lq,
                int Lk, int hd, float scale, cudaStream_t stream) {
  if (hd > 128) return (int)cudaErrorInvalidValue;
  CUtensorMap qm, km, vm;
  int err = tma::encode_heads_f32(&qm, q, B, Lq, H, hd, tf32::kRows);
  if (!err) err = tma::encode_heads_f32(&km, k, B, Lk, H, hd, kChunk);
  if (!err) err = tma::encode_heads_f32(&vm, v, B, Lk, H, hd, kChunk);
  if (err) return err;
  if (hd <= 64) return launch_fp32_hs<2, 3>(qm, km, vm, o, B, H, Lq, Lk, hd, scale, stream);
  return launch_fp32_hs<4, 2>(qm, km, vm, o, B, H, Lq, Lk, hd, scale, stream);
}

// ---- bf16: the tensor-core kernels ------------------------------------

using mma::bf16;

// ---- bf16 up to 256 keys: one pass, operands by TMA ------------------------

constexpr int kOnePassMaxKeys = 256;
constexpr int kTileRows = 16;        // rows of a query tile, and of every box
constexpr int kMaxWarps = 4;         // query-tile workers in a block, at most
constexpr int kFillBlocksPerSM = 2;  // fewer heads than this many an SM: a cluster a head

// S = Q.K^T for one 16-row query tile against keys 0 .. 8 NT of Ks, from
// swizzled tiles: Qt [16][hd], Ks [8 NT][hd]. Every n-tile is computed,
// with no branch: rows past the keys are zero in shared memory, and the
// softmax masks them.
template <int NT>
__device__ __forceinline__ void dot_qk(float (&acc)[NT][4], const bf16* Qt, int q_slab,
                                       const bf16* Ks, int kv_slab, int HDP, int lane) {
  using namespace mma;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll 1
  for (int kc = 0; kc < HDP; kc += 16) {
    uint32_t a[4];
    ldsm_x4(a, tma::swz(Qt, q_slab, lane & 15, kc + (lane >> 4) * 8));
    // the lane's row of key n-tile pair jp is 16 jp on from pair 0's, with
    // the same swizzle (16 jp % 8 == 0): one address, constant offsets
    const bf16* kb = tma::swz(Ks, kv_slab, (lane & 7) + (lane >> 4) * 8,
                              kc + ((lane >> 3) & 1) * 8);
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp) {
      uint32_t b[4];
      ldsm_x4(b, kb + jp * 16 * tma::kSlab);
      mma16816(acc[2 * jp], a, b[0], b[1]);
      mma16816(acc[2 * jp + 1], a, b[2], b[3]);
    }
  }
}

// The rest of a query tile once its logits s (the dots, keys 0 .. 8 NT)
// are in registers: the fp32 softmax over the whole key row, P rounded to
// bf16 once into A fragments, O = round(P).V from the swizzled Vs by
// output tiles of 64 columns, stored as bf16 at dst (row stride D, rows <
// L, columns < hd). Whole n-tiles with selects, no branch.
template <int NT>
__device__ __forceinline__ void softmax_pv_store(float (&s)[NT][4], const bf16* Vs, int kv_slab,
                                                 int Lk, int hd, float scale, bf16* dst, int D,
                                                 int L, int lane) {
  using namespace mma;
  // logits times sl2 = scale log2(e), keys >= Lk at -inf; then e = 2^(s -
  // max) = exp(logit - max) on the SFU's ex2 (exp2f: 2 ulp), as the
  // backward's long route; P = e . (1 / sum e) in fp32, rounded to bf16
  // once (the TPU kernel's rounding point). A product with the reciprocal
  // differs from the quotient by at most one fp32 ulp and spares a divide.
  const float sl2 = scale * 1.4426950408889634f;
  const int lim = Lk - 2 * (lane & 3);
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = j * 8 + (e & 1) < lim ? s[j][e] * sl2 : -CUDART_INF_F;
      m[e >> 1] = fmaxf(m[e >> 1], s[j][e]);
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) m[i] = quad_max(m[i]);
  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = exp2f(s[j][e] - m[e >> 1]);
      l[e >> 1] += s[j][e];
    }
  const float rl[2] = {1.f / quad_sum(l[0]), 1.f / quad_sum(l[1])};
  uint32_t p[NT / 2][4];
#pragma unroll
  for (int kp = 0; kp < NT / 2; ++kp) {
    p[kp][0] = pack(s[2 * kp][0] * rl[0], s[2 * kp][1] * rl[0]);
    p[kp][1] = pack(s[2 * kp][2] * rl[1], s[2 * kp][3] * rl[1]);
    p[kp][2] = pack(s[2 * kp + 1][0] * rl[0], s[2 * kp + 1][1] * rl[0]);
    p[kp][3] = pack(s[2 * kp + 1][2] * rl[1], s[2 * kp + 1][3] * rl[1]);
  }
  const int HDP = round16(hd);
  for (int c0 = 0; c0 < HDP; c0 += kColTile) {
    float acc[kColTile / 8][4] = {};
    // as in dot_qk: key step kp is 16 kp rows on, with the same swizzle
    const bf16* vb[kColTile / 16];
#pragma unroll
    for (int np = 0; np < kColTile / 16; ++np)
      vb[np] = tma::swz(Vs, kv_slab, (lane & 7) + ((lane >> 3) & 1) * 8,
                        c0 + np * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int kp = 0; kp < NT / 2; ++kp) {
      // columns past hd are zero in the tile (TMA's fill), and dropped
#pragma unroll
      for (int np = 0; np < kColTile / 16; ++np) {
        uint32_t b[4];
        ldsm_x4_t(b, vb[np] + kp * 16 * tma::kSlab);
        mma16816(acc[2 * np], p[kp], b[0], b[1]);
        mma16816(acc[2 * np + 1], p[kp], b[2], b[3]);
      }
    }
    store_tile(dst + c0, D, 0, L, hd - c0, acc, 1.f, lane);
  }
}

// Query tile `tile` of head h of batch row b into stage st of a warp's
// ring Qw (barriers qbar[2]); one lane alone
__device__ __forceinline__ void load_q(bf16* Qw, const CUtensorMap* qmap, uint64_t* qbar, int st,
                                       int slabs, int h, int tile, int b) {
  constexpr int q_slab = kTileRows * tma::kSlab;
  tma::mbar_expect_tx(qbar + st, (uint32_t)(slabs * q_slab * sizeof(bf16)));
  for (int sl = 0; sl < slabs; ++sl)
    tma::load_4d(Qw + (st * slabs + sl) * q_slab, qmap, qbar + st, sl * tma::kSlab, h,
                 tile * kTileRows, b);
}

// Shared memory of a block of `warps` workers whose key rows are 8 NT
// (dynamic, 1024-aligned by hand), in this order, each tile in swizzled
// slabs of 64 columns:
//   Ks [slabs][8 NT][64], Vs [slabs][8 NT][64] (rows past the keys zero),
//   Qs [warps][2 stages][slabs][16][64],
//   barriers: K, V, then [warps][2] for the query stages.
size_t one_pass_smem_bytes(int hd, int NT, int warps) {
  const size_t slab_bytes = (size_t)tma::kSlab * sizeof(bf16);
  const int slabs = (hd + tma::kSlab - 1) / tma::kSlab;
  return 1024 + slab_bytes * slabs * (2 * 8 * NT + warps * 2 * kTileRows) +
         sizeof(uint64_t) * (2 + 2 * warps);
}

// One block per (head, rank in the head's cluster); `cluster` blocks per
// head. Worker w = rank * warps + warp takes the head's query tiles w, w +
// cluster * warps, ... The head's K and V reach every block of the cluster
// from one load each (multicast), box by box, the boxes shared out over
// the cluster's blocks; each warp keeps two of its query tiles in flight.
template <int NT, int MIN_BLOCKS>
__global__ void __launch_bounds__(kMaxWarps * 32, MIN_BLOCKS)
attention_fwd_onepass_kernel(const __grid_constant__ CUtensorMap qmap,
                             const __grid_constant__ CUtensorMap kmap,
                             const __grid_constant__ CUtensorMap vmap, bf16* __restrict__ o,
                             int H, int Lq, int Lk, int hd, float scale, int cluster) {
  using namespace mma;
  extern __shared__ unsigned char smem_raw[];
  const int LKP = round16(Lk);
  const int HDP = round16(hd);
  const int slabs = (hd + tma::kSlab - 1) / tma::kSlab;
  const int warps = blockDim.x >> 5;
  const int kv_slab = 8 * NT * tma::kSlab;    // elements of one slab of K or V
  const int q_slab = kTileRows * tma::kSlab;  // of one slab of a query tile
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw + ((1024 - (tma::saddr(smem_raw) & 1023)) & 1023));
  bf16* Vs = Ks + slabs * kv_slab;
  bf16* Qs = Vs + slabs * kv_slab;
  uint64_t* kbar = reinterpret_cast<uint64_t*>(Qs + warps * 2 * slabs * q_slab);
  uint64_t* vbar = kbar + 1;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rank = cluster > 1 ? tma::cluster_rank() : 0;
  const int head = blockIdx.x / cluster;
  const int b = head / H;
  const int h = head - b * H;
  const int D = H * hd;
  const int tiles = round16(Lq) / kTileRows;
  const int workers = cluster * warps;
  uint64_t* qbar = kbar + 2 + 2 * warp;
  bf16* Qw = Qs + warp * 2 * slabs * q_slab;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2 + 2 * warps; ++i) tma::mbar_init(kbar + i, 1);
    tma::fence_barrier_init();
  }
  // the rows of K and V past the keys, which no copy writes, to zero
  const int pad = (8 * NT - LKP) * (tma::kSlab / 8);  // 16-byte units a slab
  for (int x = threadIdx.x; x < 2 * slabs * pad; x += blockDim.x) {
    const int slab = x / pad;  // K's slabs, then V's (V follows K)
    *reinterpret_cast<uint4*>(Ks + slab * kv_slab + LKP * tma::kSlab + (x - slab * pad) * 8) =
        make_uint4(0, 0, 0, 0);
  }
  __syncthreads();
  if (cluster > 1) tma::cluster_sync();  // every block's barriers exist before a copy lands

  // K and V: LKP / 16 boxes a slab each, box j issued by the block of rank
  // j % cluster into all the cluster's blocks
  const int boxes = slabs * (LKP / kTileRows);
  if (threadIdx.x == 0) {
    const uint32_t bytes = (uint32_t)(slabs * LKP * tma::kSlab * sizeof(bf16));
    tma::mbar_expect_tx(kbar, bytes);
    tma::mbar_expect_tx(vbar, bytes);
  }
  if (warp == 0) {
    for (int j = rank + cluster * lane; j < 2 * boxes; j += 32 * cluster) {
      const bool is_v = j >= boxes;
      const int jj = is_v ? j - boxes : j;
      const int slab = jj / (LKP / kTileRows);
      const int row = (jj - slab * (LKP / kTileRows)) * kTileRows;
      bf16* dst = (is_v ? Vs : Ks) + slab * kv_slab + row * tma::kSlab;
      uint64_t* bar = is_v ? vbar : kbar;
      const CUtensorMap* map = is_v ? &vmap : &kmap;
      if (cluster > 1)
        tma::load_4d_multicast(dst, map, bar, (uint16_t)((1u << cluster) - 1), slab * tma::kSlab,
                               h, row, b);
      else
        tma::load_4d(dst, map, bar, slab * tma::kSlab, h, row, b);
    }
  }

  const int first = rank * warps + warp;
  if (lane == 0) {
    if (first < tiles) load_q(Qw, &qmap, qbar, 0, slabs, h, first, b);
    if (first + workers < tiles) load_q(Qw, &qmap, qbar, 1, slabs, h, first + workers, b);
  }

  int i = 0;
  for (int tile = first; tile < tiles; tile += workers, ++i) {
    const int st = i & 1;
    if (i == 0) tma::mbar_wait(kbar, 0);
    tma::mbar_wait(qbar + st, (i >> 1) & 1);
    float s[NT][4];
    dot_qk(s, Qw + st * slabs * q_slab, q_slab, Ks, kv_slab, HDP, lane);
    __syncwarp();  // the stage is read: the tile after next may land in it
    if (lane == 0 && tile + 2 * workers < tiles) {
      tma::fence_proxy_async();
      load_q(Qw, &qmap, qbar, st, slabs, h, tile + 2 * workers, b);
    }
    if (i == 0) tma::mbar_wait(vbar, 0);
    bf16* dst = o + ((size_t)b * Lq + tile * kTileRows) * D + (size_t)h * hd;
    softmax_pv_store(s, Vs, kv_slab, Lk, hd, scale, dst, D, Lq - tile * kTileRows, lane);
  }
  if (cluster > 1) {
    // no block leaves while a copy it issued may still be landing in another
    tma::mbar_wait(kbar, 0);
    tma::mbar_wait(vbar, 0);
    tma::cluster_sync();
  }
}

struct OnePassShape {
  int cluster, warps;
};

// Workers for a launch: up to kMaxWarps a block, each with the same number
// of tiles as far as the tiles allow; one block a head while the heads fill
// the card kFillBlocksPerSM times over, else a cluster of up to 8 blocks a
// head.
OnePassShape one_pass_shape(int B, int H, int Lq) {
  int device = 0;
  cudaGetDevice(&device);
  static int sms[64] = {};  // per device, read once
  if (device < 64 && !sms[device])
    cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device);
  const int sm_count = device < 64 && sms[device] ? sms[device] : 132;
  const int tiles = mma::round16(Lq) / kTileRows;
  const int heads = B * H;
  int cluster = 1;
  if (heads < kFillBlocksPerSM * sm_count) {
    cluster = (kFillBlocksPerSM * sm_count + heads - 1) / heads;
    cluster = cluster < 8 ? cluster : 8;
    cluster = cluster < tiles ? cluster : tiles;
  }
  const int per_warp = (tiles + cluster * kMaxWarps - 1) / (cluster * kMaxWarps);
  const int warps = (tiles + cluster * per_warp - 1) / (cluster * per_warp);
  cluster = (tiles + warps * per_warp - 1) / (warps * per_warp);
  return {cluster, warps};
}

template <int NT, int MIN_BLOCKS>
int launch_one_pass_nt(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm,
                       void* o, int B, int H, int Lq, int Lk, int hd, float scale,
                       OnePassShape shape, cudaStream_t stream) {
  // not tma::configure_once: this kernel needs the carveout set too, which
  // that helper leaves to the driver
  auto kernel = attention_fwd_onepass_kernel<NT, MIN_BLOCKS>;
  const size_t smem = one_pass_smem_bytes(hd, NT, shape.warps);
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
  err = cudaLaunchKernelEx(&config, kernel, qm, km, vm, static_cast<bf16*>(o), H, Lq, Lk, hd,
                           scale, shape.cluster);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The key n-tiles a warp holds in registers for Lk keys: the nearest
// instance at or above the keys (a longer row costs registers, and the
// blocks an SM holds with them: MIN_BLOCKS below)
int one_pass_nt(int Lk) {
  const int LKP = mma::round16(Lk);
  return LKP <= 64 ? 8 : LKP <= 144 ? 18 : LKP <= 224 ? 28 : 32;
}

int launch_one_pass(const void* q, const void* k, const void* v, void* o, int B, int H, int Lq,
                    int Lk, int hd, float scale, cudaStream_t stream) {
  if (Lk > kOnePassMaxKeys || hd > 128) return (int)cudaErrorInvalidValue;
  CUtensorMap qm, km, vm;
  int err = tma::encode_heads(&qm, q, B, Lq, H, hd, kTileRows);
  if (!err) err = tma::encode_heads(&km, k, B, Lk, H, hd, kTileRows);
  if (!err) err = tma::encode_heads(&vm, v, B, Lk, H, hd, kTileRows);
  if (err) return err;
  const OnePassShape shape = one_pass_shape(B, H, Lq);
  switch (one_pass_nt(Lk)) {
    case 8:
      return launch_one_pass_nt<8, 4>(qm, km, vm, o, B, H, Lq, Lk, hd, scale, shape, stream);
    case 18:
      return launch_one_pass_nt<18, 3>(qm, km, vm, o, B, H, Lq, Lk, hd, scale, shape, stream);
    case 28:
      return launch_one_pass_nt<28, 3>(qm, km, vm, o, B, H, Lq, Lk, hd, scale, shape, stream);
    default:
      return launch_one_pass_nt<32, 2>(qm, km, vm, o, B, H, Lq, Lk, hd, scale, shape, stream);
  }
}

// ---- bf16 past 256 keys: two sweeps over keys streamed by TMA --------------

constexpr int kLongKeys = 64;  // keys of a chunk of K or V: one box of 64 rows a slab
constexpr int kLongWarps = 4;  // consumer warps a block: one warpgroup, 64 query rows

// Shared memory of a block at SL slabs of 64 columns of the head dim and ST
// stages of the ring (dynamic, 1024-aligned by hand): the ring
// [ST][SL][kLongKeys][64], the query rows [SL][64][64], then the barriers:
// full and empty a stage, Q's.
size_t long_smem_bytes(int SL, int ST) {
  return 1024 + (size_t)tma::kSlab * sizeof(bf16) * SL * (ST * kLongKeys + kLongWarps * kTileRows) +
         sizeof(uint64_t) * (2 * ST + 1);
}

// A warp's dots of its 16 rows and a chunk of keys (key0 ..), the keys at
// or past Lk at -inf: the last chunk's selects; a whole chunk takes none
__device__ __forceinline__ void mask_chunk(float (&s)[kLongKeys / 8][4], int key0, int Lk,
                                           int lane) {
  if (key0 + kLongKeys <= Lk) return;
  const int lim = Lk - key0 - 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < kLongKeys / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = j * 8 + (e & 1) < lim ? s[j][e] : -CUDART_INF_F;
}

// One block per (head, 64 query rows): four consumer warps, one warpgroup,
// a warp the 16-row tile it holds in the products' accumulators, and a
// producer warp. One lane of the producer issues the block's query rows,
// then the chunks in the order the consumers take them, K's chunks 0 .. n
// - 1 (the statistics), then K's and V's chunk c in turn, each into the
// next stage of the ring once every consumer warp has released it.
template <int SL, int ST, int MIN_BLOCKS>
__global__ void __launch_bounds__((kLongWarps + 1) * 32, MIN_BLOCKS)
attention_fwd_long_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap, bf16* __restrict__ o, int H,
                          int Lq, int Lk, int hd, float scale, int groups) {
  using namespace mma;
  constexpr int NC = kLongKeys / 8;                            // key n-tiles of a chunk
  constexpr int c_slab = kLongKeys * tma::kSlab;               // elements of a chunk's slab
  constexpr int q_slab = kLongWarps * kTileRows * tma::kSlab;  // of a slab of the 64 rows
  extern __shared__ unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw + ((1024 - (tma::saddr(smem_raw) & 1023)) & 1023));
  bf16* Qs = ring + ST * SL * c_slab;
  uint64_t* full = reinterpret_cast<uint64_t*>(Qs + SL * q_slab);
  uint64_t* empty = full + ST;
  uint64_t* qbar = empty + ST;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int head = blockIdx.x / groups;
  const int grp = blockIdx.x - head * groups;
  const int b = head / H, h = head - b * H;
  const int tiles = round16(Lq) / kTileRows;
  const int tile0 = grp * kLongWarps;                // the block's first query tile
  const int mine = min(kLongWarps, tiles - tile0);   // its tiles; the other slots are zero
  const int n = (Lk + kLongKeys - 1) / kLongKeys;    // chunks of keys

  if (threadIdx.x == 0) {
    for (int i = 0; i < ST; ++i) {
      tma::mbar_init(full + i, 1);
      tma::mbar_init(empty + i, kLongWarps);
    }
    tma::mbar_init(qbar, 1);
    tma::fence_barrier_init();
  }
  // the query rows past the block's tiles, which no copy writes, to zero
  // (the products read them through the async proxy)
  const int per = (kLongWarps - mine) * kTileRows * tma::kSlab / 8;  // 16-byte units a slab
  for (int i = threadIdx.x; i < SL * per; i += blockDim.x) {
    const int sl = i / per;
    reinterpret_cast<uint4*>(Qs + sl * q_slab + mine * kTileRows * tma::kSlab)[i - sl * per] =
        make_uint4(0, 0, 0, 0);
  }
  tma::fence_proxy_async();
  __syncthreads();

  if (warp == kLongWarps) {
    if (lane == 0) {
      tma::mbar_expect_tx(qbar, (uint32_t)(mine * SL * kTileRows * tma::kSlab * sizeof(bf16)));
      for (int t = 0; t < mine; ++t)
        for (int sl = 0; sl < SL; ++sl)
          tma::load_4d(Qs + sl * q_slab + t * kTileRows * tma::kSlab, &qmap, qbar,
                       sl * tma::kSlab, h, (tile0 + t) * kTileRows, b);
      for (int t = 0; t < 3 * n; ++t) {
        const int st = t % ST;
        if (t >= ST) {
          tma::mbar_wait(empty + st, (t / ST - 1) & 1);
          tma::fence_proxy_async();
        }
        const bool is_v = t >= n && ((t - n) & 1);
        const int c = t < n ? t : (t - n) >> 1;
        tma::mbar_expect_tx(full + st, (uint32_t)(SL * c_slab * sizeof(bf16)));
        for (int sl = 0; sl < SL; ++sl)
          tma::load_4d(ring + (st * SL + sl) * c_slab, is_v ? &vmap : &kmap, full + st,
                       sl * tma::kSlab, h, c * kLongKeys, b);
      }
    }
    return;
  }

  const float sl2 = scale * 1.4426950408889634f;
  // S = Q.K^T of the 64 rows against the chunk in stage st (this warp's 16
  // rows in s), one m64n64k16 product per 16 columns of hd, Q and K both
  // K-major in the 128-byte swizzle (a k-step is 32 bytes into the atom);
  // then the stage is released
  auto logits = [&](float (&s)[NC][4], int st) {
    const bf16* C = ring + st * SL * c_slab;
    wg::fence_regs(s);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < SL * 4; ++kk) {
      const int off = (kk & 3) * 16;
      wg::mma_ss(s, wg::desc(Qs + (kk >> 2) * q_slab + off, 16, 1024),
                 wg::desc(C + (kk >> 2) * c_slab + off, 16, 1024), kk > 0);
    }
    wg::commit();
    wg::wait_all();
    wg::fence_regs(s);
    __syncwarp();
    if (lane == 0) tma::mbar_arrive(empty + st);
  };

  // sweep 1: each row's max m of the logits in base 2 (the max of the dots
  // times sl2: rounding keeps the order) and sum l of e = 2^(dot . sl2 -
  // m) over the chunks, l rescaled when m grows; a lane sums its own keys,
  // the quad at the end. The exponent is one fused multiply-add of the
  // dot, sl2 and m, the same instruction in both sweeps, so that both see
  // the same values
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
  tma::mbar_wait(qbar, 0);
  for (int c = 0; c < n; ++c) {
    const int st = c % ST;
    tma::mbar_wait(full + st, (c / ST) & 1);
    float s[NC][4];
    logits(s, st);
    mask_chunk(s, c * kLongKeys, Lk, lane);
    float cm[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int j = 0; j < NC; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) cm[e >> 1] = fmaxf(cm[e >> 1], s[j][e]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float mn = fmaxf(m[i], __fmul_rn(quad_max(cm[i]), sl2));
      l[i] *= ex2_ftz(m[i] - mn);  // 0 . 0 on the first chunk
      m[i] = mn;
    }
#pragma unroll
    for (int j = 0; j < NC; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) l[e >> 1] += ex2_ftz(fmaf(s[j][e], sl2, -m[e >> 1]));
  }
  const float rl[2] = {1.f / quad_sum(l[0]), 1.f / quad_sum(l[1])};

  // sweep 2: S again (the same products, the same bits), P = 2^(dot . sl2 -
  // m) . (1 / l) in fp32 rounded to bf16 once into A fragments (the TPU kernel's
  // rounding point; the accumulator layout of S is the A layout of the next
  // product), O += round(P).V: one m64n64k16 product per 16 keys and 64
  // columns, P from registers, V MN-major (transposed) from the ring
  float acc[SL][8][4];
#pragma unroll
  for (int sl = 0; sl < SL; ++sl)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[sl][j][e] = 0.f;
  for (int c = 0; c < n; ++c) {
    const int tk = n + 2 * c, sk = tk % ST;
    tma::mbar_wait(full + sk, (tk / ST) & 1);
    float s[NC][4];
    logits(s, sk);
    mask_chunk(s, c * kLongKeys, Lk, lane);
    uint32_t p[NC / 2][4];
    auto prob = [&](float x, int i) { return ex2_ftz(fmaf(x, sl2, -m[i])) * rl[i]; };
#pragma unroll
    for (int kp = 0; kp < NC / 2; ++kp) {
      p[kp][0] = pack(prob(s[2 * kp][0], 0), prob(s[2 * kp][1], 0));
      p[kp][1] = pack(prob(s[2 * kp][2], 1), prob(s[2 * kp][3], 1));
      p[kp][2] = pack(prob(s[2 * kp + 1][0], 0), prob(s[2 * kp + 1][1], 0));
      p[kp][3] = pack(prob(s[2 * kp + 1][2], 1), prob(s[2 * kp + 1][3], 1));
    }
    const int tv = tk + 1, sv = tv % ST;
    tma::mbar_wait(full + sv, (tv / ST) & 1);
    const bf16* V = ring + sv * SL * c_slab;
#pragma unroll
    for (int sl = 0; sl < SL; ++sl) wg::fence_regs(acc[sl]);
    wg::fence();
#pragma unroll
    for (int kp = 0; kp < NC / 2; ++kp)
#pragma unroll
      for (int sl = 0; sl < SL; ++sl)
        wg::mma_rs(acc[sl], p[kp],
                   wg::desc(V + sl * c_slab + kp * 16 * tma::kSlab, c_slab * 2, 1024));
    wg::commit();
    wg::wait_all();
#pragma unroll
    for (int sl = 0; sl < SL; ++sl) wg::fence_regs(acc[sl]);
    __syncwarp();
    if (lane == 0) tma::mbar_arrive(empty + sv);
  }
  const int tile = tile0 + warp;
  if (tile < tiles) {
    const int D = H * hd;
    bf16* dst = o + ((size_t)b * Lq + tile * kTileRows) * D + (size_t)h * hd;
#pragma unroll
    for (int sl = 0; sl < SL; ++sl)
      store_tile(dst + sl * tma::kSlab, D, 0, Lq - tile * kTileRows, hd - sl * tma::kSlab,
                 acc[sl], 1.f, lane);
  }
}

template <int SL, int ST, int MIN_BLOCKS>
int launch_long_inst(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm, void* o,
                     int B, int H, int Lq, int Lk, int hd, float scale, cudaStream_t stream) {
  auto kernel = attention_fwd_long_kernel<SL, ST, MIN_BLOCKS>;
  int device = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = tma::configure_once(reinterpret_cast<const void*>(kernel), device, &limit);
  if (err != cudaSuccess) return (int)err;
  const int groups = (mma::round16(Lq) / kTileRows + kLongWarps - 1) / kLongWarps;
  kernel<<<(unsigned)(groups * B * H), (kLongWarps + 1) * 32, long_smem_bytes(SL, ST), stream>>>(
      qm, km, vm, static_cast<bf16*>(o), H, Lq, Lk, hd, scale, groups);
  return (int)cudaGetLastError();
}

// hd <= 64: four stages, four blocks an SM; past it three stages, three
// blocks (the blocks an SM that the registers allow, with the stages that
// still fit their shared memory)
int launch_long(const void* q, const void* k, const void* v, void* o, int B, int H, int Lq,
                int Lk, int hd, float scale, cudaStream_t stream) {
  if (hd > 128) return (int)cudaErrorInvalidValue;
  CUtensorMap qm, km, vm;
  int err = tma::encode_heads(&qm, q, B, Lq, H, hd, kTileRows);
  if (!err) err = tma::encode_heads(&km, k, B, Lk, H, hd, kLongKeys);
  if (!err) err = tma::encode_heads(&vm, v, B, Lk, H, hd, kLongKeys);
  if (err) return err;
  if (hd > tma::kSlab)
    return launch_long_inst<2, 3, 3>(qm, km, vm, o, B, H, Lq, Lk, hd, scale, stream);
  return launch_long_inst<1, 4, 4>(qm, km, vm, o, B, H, Lq, Lk, hd, scale, stream);
}

}  // namespace

extern "C" {

// The routes of a launch, chosen by the caller: 0 fp32 (CUDA cores, up to
// the keys whose logit rows fit one warp's block), 1 bf16 up to
// kOnePassMaxKeys keys (one pass, TMA), 2 bf16 at any length (two sweeps
// over keys streamed by TMA, for more keys).
int attention_fwd_one_pass_max_keys() { return kOnePassMaxKeys; }

// Shared memory one launch of `route` needs, in bytes (fp32: a block of one
// warp, the least it shrinks to).
size_t attention_fwd_smem_bytes(int route, int Lq, int Lk, int hd) {
  if (route == 1) return one_pass_smem_bytes(hd, one_pass_nt(Lk), kMaxWarps);
  if (route == 2)  // the same at any length
    return hd <= tma::kSlab ? long_smem_bytes(1, 4) : long_smem_bytes(2, 3);
  return fp32_smem_bytes(hd <= 64 ? 2 : 4, 1, Lk);
}

// Largest dynamic shared memory a block may opt into on `device`.
int attention_fwd_smem_limit(int device) {
  int bytes = 0;
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return bytes;
}

// q [B, Lq, H*hd], k/v [B, Lk, H*hd], o [B, Lq, H*hd]: contiguous, 16-byte
// aligned, hd % 8 == 0, hd <= 128; fp32 for route 0, bf16 for 1 and 2.
// Launches on `stream`; returns the first cudaError.
int attention_fwd(const void* q, const void* k, const void* v, void* o, int route,
                  int B, int H, int Lq, int Lk, int hd, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) return launch_one_pass(q, k, v, o, B, H, Lq, Lk, hd, scale, s);
  if (route == 2) return launch_long(q, k, v, o, B, H, Lq, Lk, hd, scale, s);
  return launch_fp32(q, k, v, o, B, H, Lq, Lk, hd, scale, s);
}

}  // extern "C"
