// Fused multi-head attention forward for short sequences, sm_90a.
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
// Past 256 keys (cross attention, no shipped shape): the two-pass
// `attention_fwd_mma_kernel`. One block owns one (batch row, head, up to
// kMmaWarps 16-row query tiles) and stages its Q rows and the head's K
// and V with cp.async (rows padded so that ldmatrix is free of bank
// conflicts). A warp holds at most 144 keys of logits in registers, so it
// sweeps the keys twice: the first pass finds each row's max and sum e
// over the key chunks, the second recomputes the logits, forms the exact
// normalised P and accumulates P.V.
//
// fp32: `attention_fwd_kernel`, on the CUDA cores (fp32 on the tensor
// cores would be TF32). One block per (batch row, head, tile of query
// rows) stages K and V; each warp takes one query row, keeps its Lk
// logits in shared memory, lanes take one key each (K rows padded by 16
// bytes against bank conflicts) and walk hd with fmaf: bound by its
// on-chip work, not by device memory.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "tma.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

// two neighbouring elements (the first 2-element aligned)
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__host__ __device__ __forceinline__ int round_up4(int n) { return (n + 3) & ~3; }

// Shared memory (dynamic), in this order, all fp32:
//   Ks   [Lk][hd + 4]             16-byte padded rows
//   Vs   [Lk][hd]
//   qrow [kWarps][hd]             the warp's current query row
//   prow [kWarps][round_up4(Lk)]  the warp's logits, then its P
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     int H, int Lq, int Lk, int hd, int rows_per_block, float scale) {
  constexpr int kVec = 4;  // elements in one 16-byte load
  extern __shared__ __align__(16) unsigned char smem[];
  const int ks_stride = hd + kVec;
  const int p_stride = round_up4(Lk);
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + (size_t)Lk * ks_stride;
  float* qrow_all = reinterpret_cast<float*>(Vs + (size_t)Lk * hd);
  float* prow_all = qrow_all + kWarps * hd;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int D = H * hd;
  const int row0 = blockIdx.y * rows_per_block;
  const int row1 = min(Lq, row0 + rows_per_block);

  // stage this head's K and V, 16 bytes per thread per step
  const int vecs_per_row = hd / kVec;
  const float* kbase = k + (size_t)b * Lk * D + (size_t)h * hd;
  const float* vbase = v + (size_t)b * Lk * D + (size_t)h * hd;
  for (int i = threadIdx.x; i < Lk * vecs_per_row; i += kThreads) {
    const int r = i / vecs_per_row;
    const int c = (i - r * vecs_per_row) * kVec;
    const uint4 kv = *reinterpret_cast<const uint4*>(kbase + (size_t)r * D + c);
    const uint4 vv = *reinterpret_cast<const uint4*>(vbase + (size_t)r * D + c);
    *reinterpret_cast<uint4*>(Ks + (size_t)r * ks_stride + c) = kv;
    *reinterpret_cast<uint4*>(Vs + (size_t)r * hd + c) = vv;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* qrow = qrow_all + warp * hd;
  float* prow = prow_all + (size_t)warp * p_stride;

  for (int row = row0 + warp; row < row1; row += kWarps) {
    const float* qsrc = q + ((size_t)b * Lq + row) * D + (size_t)h * hd;
    for (int d = lane; d < hd; d += 32) qrow[d] = qsrc[d];
    __syncwarp();

    // logits: lane j takes keys j, j + 32, ...; keys past Lk (the tail of
    // the last 32-key step) are never visited
    float mx = -CUDART_INF_F;
    for (int j = lane; j < Lk; j += 32) {
      const float* krow = Ks + (size_t)j * ks_stride;
      float acc = 0.f;
      for (int c = 0; c < hd; c += kVec) {
        const float4 kk = *reinterpret_cast<const float4*>(krow + c);
        const float4 qq = *reinterpret_cast<const float4*>(qrow + c);
        acc = fmaf(qq.x, kk.x, acc);
        acc = fmaf(qq.y, kk.y, acc);
        acc = fmaf(qq.z, kk.z, acc);
        acc = fmaf(qq.w, kk.w, acc);
      }
      const float logit = acc * scale;
      prow[j] = logit;
      mx = fmaxf(mx, logit);
    }
    mx = warp_max(mx);

    float sum = 0.f;
    for (int j = lane; j < Lk; j += 32) {
      const float e = expf(prow[j] - mx);
      prow[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < Lk; j += 32) prow[j] = prow[j] / sum;
    __syncwarp();

    // o = P.V: lane owns the column pairs (2 lane, 2 lane + 1) + 64 t
    float* odst = o + ((size_t)b * Lq + row) * D + (size_t)h * hd;
    for (int d = 2 * lane; d < hd; d += 64) {
      float a0 = 0.f, a1 = 0.f;
      int j = 0;
      for (; j + 4 <= Lk; j += 4) {
        const float4 p = *reinterpret_cast<const float4*>(prow + j);
        const float2 v0 = load2(Vs + (size_t)j * hd + d);
        const float2 v1 = load2(Vs + (size_t)(j + 1) * hd + d);
        const float2 v2 = load2(Vs + (size_t)(j + 2) * hd + d);
        const float2 v3 = load2(Vs + (size_t)(j + 3) * hd + d);
        a0 = fmaf(p.x, v0.x, a0); a1 = fmaf(p.x, v0.y, a1);
        a0 = fmaf(p.y, v1.x, a0); a1 = fmaf(p.y, v1.y, a1);
        a0 = fmaf(p.z, v2.x, a0); a1 = fmaf(p.z, v2.y, a1);
        a0 = fmaf(p.w, v3.x, a0); a1 = fmaf(p.w, v3.y, a1);
      }
      for (; j < Lk; ++j) {
        const float p = prow[j];
        const float2 vv = load2(Vs + (size_t)j * hd + d);
        a0 = fmaf(p, vv.x, a0);
        a1 = fmaf(p, vv.y, a1);
      }
      *reinterpret_cast<float2*>(odst + d) = make_float2(a0, a1);
    }
    __syncwarp();  // qrow and prow are rewritten for the warp's next row
  }
}

size_t smem_bytes(int Lk, int hd) {
  return ((size_t)Lk * (hd + 4) + (size_t)Lk * hd + (size_t)kWarps * hd +
          (size_t)kWarps * round_up4(Lk)) * sizeof(float);
}

int launch_fp32(const void* q, const void* k, const void* v, void* o, int B, int H,
                int Lq, int Lk, int hd, float scale, cudaStream_t stream) {
  // a whole short sequence in one tile, so each block reads K and V once
  const int tiles = (Lq + 255) / 256;
  const int rows_per_block = (Lq + tiles - 1) / tiles;
  const size_t smem = smem_bytes(Lk, hd);
  cudaError_t err = cudaFuncSetAttribute(attention_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(B * H), (unsigned)((Lq + rows_per_block - 1) / rows_per_block));
  attention_fwd_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), H, Lq, Lk, hd, rows_per_block, scale);
  return (int)cudaGetLastError();
}

// ---- bf16: the tensor-core kernel ----------------------------------------

using mma::bf16;

// 16-row query tiles per block, at most: the 9 tiles of L = 129 take 3
// blocks, and 4 blocks (12 warps) fill an SM's registers
constexpr int kMmaWarps = 3;
constexpr int kMmaBlocksPerSM = 4;
constexpr int kRowTiles = 18;   // key n-tiles of 8 in a register row: 144 keys

// query tiles per block: Lq's tiles split evenly over the fewest blocks
int mma_warps(int Lq) {
  const int tiles = mma::round16(Lq) / 16;
  const int blocks = (tiles + kMmaWarps - 1) / kMmaWarps;
  return (tiles + blocks - 1) / blocks;
}

// Shared memory (dynamic), in this order, each row padded(hd) long:
//   Qs [16 mma_warps(Lq)], Ks [round16(Lk)], Vs [round16(Lk)]
size_t mma_smem_bytes(int Lq, int Lk, int hd) {
  return (size_t)(16 * mma_warps(Lq) + 2 * mma::round16(Lk)) * mma::padded(hd) * sizeof(bf16);
}

// O tile = round(P) . V for one chunk of keys (key0 .. key0 + 8 NT) and
// output columns c0 .. c0 + kColTile: P = e / l with e = s if `exps`, else
// exp(s - m), the normalised fp32 probabilities, rounded to bf16 straight
// into A fragments. rl = 1 / l: a product with the reciprocal differs from
// the quotient by at most one fp32 ulp, and spares an IEEE divide (a long
// instruction sequence) per probability
template <int NT>
__device__ __forceinline__ void pv(float (&acc)[mma::kColTile / 8][4], const float (&s)[NT][4],
                                   const float (&m)[2], const float (&rl)[2], const bf16* Vs,
                                   int so, int key0, int LKP, int c0, int HDP, bool exps,
                                   int lane) {
  using namespace mma;
#pragma unroll
  for (int kp = 0; kp < NT / 2; ++kp) {
    if (key0 + kp * 16 >= LKP) continue;
    float p[2][4];
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[t][e] = (exps ? s[2 * kp + t][e] : expf(s[2 * kp + t][e] - m[e >> 1])) * rl[e >> 1];
    const uint32_t a[4] = {pack(p[0][0], p[0][1]), pack(p[0][2], p[0][3]),
                           pack(p[1][0], p[1][1]), pack(p[1][2], p[1][3])};
    dot_cols(acc, a, Vs, so, key0 + kp * 16, c0, HDP, lane);
  }
}

__global__ void __launch_bounds__(kMmaWarps * 32, kMmaBlocksPerSM)
attention_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ o,
                         int H, int Lq, int Lk, int hd, float scale) {
  using namespace mma;
  constexpr int NT = kRowTiles;
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = blockDim.x / 2;     // 16 query rows per warp
  const int LKP = round16(Lk);
  const int HDP = round16(hd);
  const int so = padded(hd);
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + rows * so;
  bf16* Vs = Ks + LKP * so;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int D = H * hd;
  const int row0 = blockIdx.y * rows;
  const size_t qoff = ((size_t)b * Lq + row0) * D + (size_t)h * hd;
  const size_t koff = (size_t)b * Lk * D + (size_t)h * hd;
  stage_async(Qs, q + qoff, Lq - row0, rows, hd, D);
  stage_async(Ks, k + koff, Lk, LKP, hd, D);
  stage_async(Vs, v + koff, Lk, LKP, hd, D);
  cp_async_wait_all();
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * 16;
  if (row0 + r0 >= Lq) return;

  // pass 1: each row's max m and sum l of e = exp(logit - m), over key
  // chunks of 8 NT; at Lk <= 8 NT one chunk, and l is exactly that sum
  const int chunk = NT * 8;
  const int chunks = (LKP + chunk - 1) / chunk;
  float s[NT][4];
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f};
  for (int c = 0; c < chunks; ++c) {
    const int key0 = c * chunk;
    dot_nt(s, Qs, Ks, so, r0, key0, LKP, HDP, lane);
    scale_mask(s, key0, Lk, scale, lane);
    float cm[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (key0 + j * 8 >= LKP) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) cm[e >> 1] = fmaxf(cm[e >> 1], s[j][e]);
    }
    float nm[2], cs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) nm[i] = fmaxf(m[i], quad_max(cm[i]));
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (key0 + j * 8 >= LKP) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = expf(s[j][e] - nm[e >> 1]);
        cs[e >> 1] += x;
        if (chunks == 1) s[j][e] = x;  // pass 2 reuses e
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] = l[i] * expf(m[i] - nm[i]) + quad_sum(cs[i]);
      m[i] = nm[i];
    }
  }

  // pass 2: O = round(P) . V by output tiles of kColTile columns; with
  // more than one chunk the logits are recomputed (exactly: the same dots)
  const float rl[2] = {1.f / l[0], 1.f / l[1]};
  for (int c0 = 0; c0 < HDP; c0 += kColTile) {
    float acc[kColTile / 8][4] = {};
    for (int c = 0; c < chunks; ++c) {
      const int key0 = c * chunk;
      if (chunks > 1) {
        dot_nt(s, Qs, Ks, so, r0, key0, LKP, HDP, lane);
        scale_mask(s, key0, Lk, scale, lane);
      }
      pv(acc, s, m, rl, Vs, so, key0, LKP, c0, HDP, chunks == 1, lane);
    }
    store_tile(o + qoff + c0, D, r0, Lq - row0, hd - c0, acc, 1.f, lane);
  }
}

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

int launch_mma(const void* q, const void* k, const void* v, void* o, int B, int H, int Lq,
               int Lk, int hd, float scale, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes(Lq, Lk, hd);
  const cudaError_t err = cudaFuncSetAttribute(attention_fwd_mma_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int warps = mma_warps(Lq);
  const dim3 grid((unsigned)(B * H), (unsigned)((mma::round16(Lq) / 16 + warps - 1) / warps));
  attention_fwd_mma_kernel<<<grid, warps * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), H, Lq, Lk, hd, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The routes of a launch, chosen by the caller: 0 fp32 (CUDA cores), 1
// bf16 up to kOnePassMaxKeys keys (one pass, TMA), 2 bf16 at any length
// (the two-pass kernel, for more keys).
int attention_fwd_one_pass_max_keys() { return kOnePassMaxKeys; }

// Shared memory one launch of `route` needs, in bytes.
size_t attention_fwd_smem_bytes(int route, int Lq, int Lk, int hd) {
  if (route == 1) return one_pass_smem_bytes(hd, one_pass_nt(Lk), kMaxWarps);
  return route == 2 ? mma_smem_bytes(Lq, Lk, hd) : smem_bytes(Lk, hd);
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
  if (route == 2) {
    if (hd > 128) return (int)cudaErrorInvalidValue;
    return launch_mma(q, k, v, o, B, H, Lq, Lk, hd, scale, s);
  }
  return launch_fp32(q, k, v, o, B, H, Lq, Lk, hd, scale, s);
}

}  // extern "C"
