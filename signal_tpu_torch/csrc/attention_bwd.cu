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
// bf16 up to 160 tokens: `attention_bwd_mma_kernel`, one fused kernel on
// the tensor cores. At the ViT-B shape ([3B/2 = 192, 129, 768], 12 heads of 64) a launch
// moves 266 MB and does 24.5 GFLOP unpadded, so device memory bounds it
// (0.080 ms at 3.35 TB/s). The CUDA-core design it replaces did its dots
// with scalar fmaf, one warp per row, and ran 7 products in two kernels
// with a statistics scratch: 39x its bound. This one is the TPU kernel's
// structure: one block per (batch row, head) owns the whole head, runs the
// 5 products with mma.sync m16n8k16 (bf16 in, fp32 accumulation) and sums
// every output in a fixed order, without atomics or a second launch.
//   1. cp.async stages Q, G (Lq x hd) and K, V (Lk x hd) in shared memory,
//      zero-filled to multiples of 16 rows and columns, rows padded so that
//      ldmatrix is free of bank conflicts.
//   2. Warp w takes query rows 16w .. 16w+15 and holds the fp32 S = Q.K^T
//      and dP = G.V^T of all its keys in registers (16 x 144 each at
//      L = 129, one pass over hd), does the softmax with quad shuffles
//      (keys >= Lk masked to -inf; P = e times the reciprocal of sum e;
//      rows >= Lq zeroed: a zero Q row would give a uniform P), then delta
//      and dS, and dQ = round(dS).K with round(dS) taken straight from the
//      registers as A fragments. Past 144 keys (up to 160) S and dP do not
//      both fit the 168 registers a thread of a 9-10 warp block gets: the
//      warp holds P and computes dP by pairs of key tiles twice, once for
//      delta and once for dS.
//   3. After a barrier, round(P) and round(dS) go to shared memory in the
//      place K and V held, so the peak is Q, G, P and dS (129 KB at the main
//      shape; 190 KB at hd = 128, L = 160).
//   4. Warp w takes key rows 16w .. 16w+15: dV = round(P)^T.G and
//      dK = round(dS)^T.Q, both operands through ldmatrix.trans.
// A warp holds one 16-row tile in each phase and a whole key row in
// registers, so this route takes Lq, Lk <= 16 kMmaWarps (160); its shared
// memory (Q, G, round(P), round(dS) resident together) would not stretch
// far beyond either: 234 KB at L = 193, hd 64, against the 227 KB a block
// may have. One block fills an SM (shared memory and registers), so its
// staging and its math do not overlap: at the main shape the math is most
// of the time. wgmma/TMA and a persistent grid that stages the next head
// during this one's math are later work.
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
// fp32: two CUDA-core kernels that need no atomics and sum in a fixed
// order. fp32 stays off the tensor cores: there they would run TF32.
//
//   rows_kernel  one block per (batch row, head, tile of query rows); it
//                stages the head's K and V in shared memory, and each warp
//                takes one query row: logits, P, dP, the row's
//                delta = rowsum(dP o P), dS, and dQ. It writes dQ and the
//                row's softmax max, sum and delta (fp32) to a scratch.
//   cols_kernel  one block per (batch row, head, tile of key rows); it
//                stages the head's Q and G, and each warp takes one key row:
//                it recomputes the column of P from the row statistics (the
//                same dot products in the same order, so the same P), then
//                dP, dS, dV and dK.
//
// Lanes take rows j, j + 32, ... of the staged operand and stop at its
// length; the staged rows are padded by 16 bytes so that the lanes of a
// warp, each on its own row, read distinct banks. The dots run in fp32 on
// the CUDA cores, so on-chip work bounds these kernels, not memory.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
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

// row x (shared, hd floats) dotted with a staged row, ascending over the
// columns; both kernels use it for the logits and for dP, so the two
// recompute the same values
__device__ __forceinline__ float dot_row(const float* x, const float* row, int hd) {
  float acc = 0.f;
  for (int c = 0; c < hd; c += 4) {
    const float4 rr = *reinterpret_cast<const float4*>(row + c);
    const float4 xx = *reinterpret_cast<const float4*>(x + c);
    acc = fmaf(xx.x, rr.x, acc);
    acc = fmaf(xx.y, rr.y, acc);
    acc = fmaf(xx.z, rr.z, acc);
    acc = fmaf(xx.w, rr.w, acc);
  }
  return acc;
}

// Stage n rows of the head's column block (hd wide, row stride D in src)
// into dst with row stride hd + 4, 16 bytes per thread per step.
__device__ __forceinline__ void stage(float* dst, const float* src, int n, int hd, int D) {
  const int vecs = hd / 4;
  for (int i = threadIdx.x; i < n * vecs; i += kThreads) {
    const int r = i / vecs;
    const int c = (i - r * vecs) * 4;
    *reinterpret_cast<float4*>(dst + (size_t)r * (hd + 4) + c) =
        *reinterpret_cast<const float4*>(src + (size_t)r * D + c);
  }
}

// out[d], out[d + 1] for the lane's column pairs d = 2 lane + 64 t:
// sum_j w[j] * S[j][d], over n staged rows S (row stride `stride`)
__device__ __forceinline__ float2 weighted_rows(const float* w, const float* S, int n, int stride,
                                                int d) {
  float a0 = 0.f, a1 = 0.f;
  int j = 0;
  for (; j + 4 <= n; j += 4) {
    const float4 p = *reinterpret_cast<const float4*>(w + j);
    const float2 s0 = load2(S + (size_t)j * stride + d);
    const float2 s1 = load2(S + (size_t)(j + 1) * stride + d);
    const float2 s2 = load2(S + (size_t)(j + 2) * stride + d);
    const float2 s3 = load2(S + (size_t)(j + 3) * stride + d);
    a0 = fmaf(p.x, s0.x, a0); a1 = fmaf(p.x, s0.y, a1);
    a0 = fmaf(p.y, s1.x, a0); a1 = fmaf(p.y, s1.y, a1);
    a0 = fmaf(p.z, s2.x, a0); a1 = fmaf(p.z, s2.y, a1);
    a0 = fmaf(p.w, s3.x, a0); a1 = fmaf(p.w, s3.y, a1);
  }
  for (; j < n; ++j) {
    const float2 s = load2(S + (size_t)j * stride + d);
    a0 = fmaf(w[j], s.x, a0);
    a1 = fmaf(w[j], s.y, a1);
  }
  return make_float2(a0, a1);
}

// Shared memory of either kernel (dynamic), in this order, all fp32, with
// n the staged length (Lk for rows_kernel, Lq for cols_kernel):
//   A, B  [n][hd + 4]                 (K, V) or (Q, G)
//   x, y  [kWarps][hd]                the warp's current rows
//   s, t  [kWarps][round_up4(n)]      the warp's P and dP / dS
size_t smem_bytes(int n, int hd) {
  return (2 * (size_t)n * (hd + 4) + 2 * (size_t)kWarps * hd +
          2 * (size_t)kWarps * round_up4(n)) * sizeof(float);
}

// stats: [3][B * H * Lq] fp32 = (row max of the logits, sum of exp, delta)
__global__ void __launch_bounds__(kThreads)
rows_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ g, float* __restrict__ dq,
            float* __restrict__ stats, int B, int H, int Lq, int Lk, int hd,
            int rows_per_block, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int stride = hd + 4;
  const int p_stride = round_up4(Lk);
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + (size_t)Lk * stride;
  float* qrow = reinterpret_cast<float*>(Vs + (size_t)Lk * stride);
  float* grow = qrow + kWarps * hd;
  float* prow = grow + kWarps * hd;
  float* srow = prow + (size_t)kWarps * p_stride;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int D = H * hd;
  const int row0 = blockIdx.y * rows_per_block;
  const int row1 = min(Lq, row0 + rows_per_block);
  stage(Ks, k + (size_t)b * Lk * D + (size_t)h * hd, Lk, hd, D);
  stage(Vs, v + (size_t)b * Lk * D + (size_t)h * hd, Lk, hd, D);
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  qrow += warp * hd;
  grow += warp * hd;
  prow += (size_t)warp * p_stride;
  srow += (size_t)warp * p_stride;
  const size_t n_rows = (size_t)B * H * Lq;

  for (int row = row0 + warp; row < row1; row += kWarps) {
    const size_t off = ((size_t)b * Lq + row) * D + (size_t)h * hd;
    for (int d = lane; d < hd; d += 32) {
      qrow[d] = q[off + d];
      grow[d] = g[off + d];
    }
    __syncwarp();

    // logits and dP = g . v_j; lane j takes keys j, j + 32, ...
    float mx = -CUDART_INF_F;
    for (int j = lane; j < Lk; j += 32) {
      const float logit = dot_row(qrow, Ks + (size_t)j * stride, hd) * scale;
      prow[j] = logit;
      srow[j] = dot_row(grow, Vs + (size_t)j * stride, hd);
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
    float delta = 0.f;
    for (int j = lane; j < Lk; j += 32) {
      const float p = prow[j] / sum;
      prow[j] = p;
      delta = fmaf(srow[j], p, delta);
    }
    delta = warp_sum(delta);
    // dS in place of dP
    for (int j = lane; j < Lk; j += 32) srow[j] = prow[j] * (srow[j] - delta);
    __syncwarp();

    float* dst = dq + off;
    for (int d = 2 * lane; d < hd; d += 64) {
      const float2 acc = weighted_rows(srow, Ks, Lk, stride, d);
      store2(dst + d, acc.x * scale, acc.y * scale);
    }
    if (lane == 0) {
      const size_t r = ((size_t)b * H + h) * Lq + row;
      stats[r] = mx;
      stats[n_rows + r] = sum;
      stats[2 * n_rows + r] = delta;
    }
    __syncwarp();  // the warp's rows are rewritten for its next query row
  }
}

__global__ void __launch_bounds__(kThreads)
cols_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ g, float* __restrict__ dk,
            float* __restrict__ dv, const float* __restrict__ stats, int B, int H, int Lq,
            int Lk, int hd, int cols_per_block, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int stride = hd + 4;
  const int p_stride = round_up4(Lq);
  float* Qs = reinterpret_cast<float*>(smem);
  float* Gs = Qs + (size_t)Lq * stride;
  float* krow = reinterpret_cast<float*>(Gs + (size_t)Lq * stride);
  float* vrow = krow + kWarps * hd;
  float* pcol = vrow + kWarps * hd;
  float* scol = pcol + (size_t)kWarps * p_stride;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int D = H * hd;
  const int col0 = blockIdx.y * cols_per_block;
  const int col1 = min(Lk, col0 + cols_per_block);
  stage(Qs, q + (size_t)b * Lq * D + (size_t)h * hd, Lq, hd, D);
  stage(Gs, g + (size_t)b * Lq * D + (size_t)h * hd, Lq, hd, D);
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  krow += warp * hd;
  vrow += warp * hd;
  pcol += (size_t)warp * p_stride;
  scol += (size_t)warp * p_stride;
  const size_t n_rows = (size_t)B * H * Lq;
  const float* row_max = stats + ((size_t)b * H + h) * Lq;
  const float* row_sum = row_max + n_rows;
  const float* row_delta = row_max + 2 * n_rows;

  for (int col = col0 + warp; col < col1; col += kWarps) {
    const size_t off = ((size_t)b * Lk + col) * D + (size_t)h * hd;
    for (int d = lane; d < hd; d += 32) {
      krow[d] = k[off + d];
      vrow[d] = v[off + d];
    }
    __syncwarp();

    // column `col` of P and dS; lane i takes query rows i, i + 32, ...
    for (int i = lane; i < Lq; i += 32) {
      const float logit = dot_row(krow, Qs + (size_t)i * stride, hd) * scale;
      const float p = expf(logit - row_max[i]) / row_sum[i];
      const float dp = dot_row(vrow, Gs + (size_t)i * stride, hd);
      pcol[i] = p;
      scol[i] = p * (dp - row_delta[i]);
    }
    __syncwarp();

    for (int d = 2 * lane; d < hd; d += 64) {
      const float2 acc_v = weighted_rows(pcol, Gs, Lq, stride, d);
      const float2 acc_k = weighted_rows(scol, Qs, Lq, stride, d);
      store2(dv + off + d, acc_v.x, acc_v.y);
      store2(dk + off + d, acc_k.x * scale, acc_k.y * scale);
    }
    __syncwarp();
  }
}

// query (or key) rows per block of the fp32 kernels: a whole short
// sequence in one tile, so each block reads its staged operands once
int rows_per_tile(int n) {
  const int tiles = (n + 255) / 256;
  return (n + tiles - 1) / tiles;
}

int launch_fp32(const void* q, const void* k, const void* v, const void* g, void* dq,
                void* dk, void* dv, float* stats, int B, int H, int Lq, int Lk, int hd,
                float scale, cudaStream_t stream) {
  const int rows_per_block = rows_per_tile(Lq);
  const int cols_per_block = rows_per_tile(Lk);
  const size_t smem_rows = smem_bytes(Lk, hd);
  const size_t smem_cols = smem_bytes(Lq, hd);
  cudaError_t err = cudaFuncSetAttribute(rows_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_rows);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(cols_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_cols);
  if (err != cudaSuccess) return (int)err;
  const float* qq = static_cast<const float*>(q);
  const float* kk = static_cast<const float*>(k);
  const float* vv = static_cast<const float*>(v);
  const float* gg = static_cast<const float*>(g);
  const dim3 grid_rows((unsigned)(B * H), (unsigned)((Lq + rows_per_block - 1) / rows_per_block));
  rows_kernel<<<grid_rows, kThreads, smem_rows, stream>>>(
      qq, kk, vv, gg, static_cast<float*>(dq), stats, B, H, Lq, Lk, hd, rows_per_block, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_cols((unsigned)(B * H), (unsigned)((Lk + cols_per_block - 1) / cols_per_block));
  cols_kernel<<<grid_cols, kThreads, smem_cols, stream>>>(
      qq, kk, vv, gg, static_cast<float*>(dk), static_cast<float*>(dv), stats, B, H, Lq, Lk,
      hd, cols_per_block, scale);
  return (int)cudaGetLastError();
}

// ---- bf16: the fused tensor-core kernel ----------------------------------

using mma::bf16;

constexpr int kMmaWarps = 10;                 // 16-row tiles per block
constexpr int kMmaMaxLen = 16 * kMmaWarps;    // Lq, Lk it takes
// key n-tiles of 8 that a warp holds as S and dP together: 144 keys cover
// the ViT's 129. Up to kMmaMaxLen keys it holds P and recomputes dP.
constexpr int kRowTiles = 18;

// Shared memory (dynamic), in this order:
//   Qs, Gs  [round16(Lq)][padded(hd)]      the whole kernel
//   Ks, Vs  [round16(Lk)][padded(hd)]      phase 1, then in their place
//   Ps, dSs [round16(Lq)][padded(Lk)]      phase 2: round(P), round(dS)
size_t mma_smem_bytes(int Lq, int Lk, int hd) {
  const size_t qg = 2 * (size_t)mma::round16(Lq) * mma::padded(hd);
  const size_t kv = 2 * (size_t)mma::round16(Lk) * mma::padded(hd);
  const size_t pds = 2 * (size_t)mma::round16(Lq) * mma::padded(Lk);
  return (qg + (kv > pds ? kv : pds)) * sizeof(bf16);
}

// NT: key n-tiles of 8 a warp holds in registers (8 NT >= round16(Lk))
template <int NT>
__global__ void __launch_bounds__(kMmaWarps * 32, 1)
attention_bwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ g,
                         bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv,
                         int H, int Lq, int Lk, int hd, float scale) {
  using namespace mma;
  extern __shared__ __align__(16) unsigned char smem[];
  const int LQP = round16(Lq), LKP = round16(Lk), HDP = round16(hd);
  const int so = padded(hd), sp = padded(Lk);
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Gs = Qs + LQP * so;
  bf16* Ks = Gs + LQP * so;
  bf16* Vs = Ks + LKP * so;
  bf16* Ps = Ks;
  bf16* dSs = Ps + LQP * sp;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int D = H * hd;
  const size_t qoff = (size_t)b * Lq * D + (size_t)h * hd;
  const size_t koff = (size_t)b * Lk * D + (size_t)h * hd;
  stage_async(Qs, q + qoff, Lq, LQP, hd, D);
  stage_async(Gs, g + qoff, Lq, LQP, hd, D);
  stage_async(Ks, k + koff, Lk, LKP, hd, D);
  stage_async(Vs, v + koff, Lk, LKP, hd, D);
  cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2;
  const int tq = lane & 3;
  const int nkt = LKP / 16;             // key k-steps of 16
  const int r0 = warp * 16;             // the warp's query rows (phase 1)
  uint32_t pb[NT][2], sb[NT][2];        // round(P), round(dS): rows gr, gr + 8

  if (r0 < LQP) {
    // P: the fp32 softmax of the logits, rows >= Lq zeroed (a zero-filled
    // Q row has logits 0, hence a uniform P that would leak into dK, dV)
    float s[NT][4], dp[NT][4];
    if constexpr (NT <= kRowTiles)
      dot_nt2(s, dp, Qs, Ks, Gs, Vs, so, r0, LKP, HDP, lane);
    else
      dot_nt(s, Qs, Ks, so, r0, 0, LKP, HDP, lane);
    scale_mask(s, 0, Lk, scale, lane);
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j >= 2 * nkt) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    }
    mx[0] = quad_max(mx[0]);
    mx[1] = quad_max(mx[1]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j >= 2 * nkt) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - mx[e >> 1]);
        sum[e >> 1] += s[j][e];
      }
    }
    const bool live[2] = {r0 + gr < Lq, r0 + gr + 8 < Lq};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] = quad_sum(sum[i]);  // every lane shuffles, dead rows too
      sum[i] = live[i] ? 1.f / sum[i] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= sum[e >> 1];

    // dP = G . V^T in fp32, delta = rowsum(dP o P), dS = P o (dP - delta)
    float delta[2] = {0.f, 0.f};
    if constexpr (NT <= kRowTiles) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (j >= 2 * nkt) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) delta[e >> 1] = fmaf(dp[j][e], s[j][e], delta[e >> 1]);
      }
      delta[0] = quad_sum(delta[0]);
      delta[1] = quad_sum(delta[1]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        sb[j][0] = pack(s[j][0] * (dp[j][0] - delta[0]), s[j][1] * (dp[j][1] - delta[0]));
        sb[j][1] = pack(s[j][2] * (dp[j][2] - delta[1]), s[j][3] * (dp[j][3] - delta[1]));
      }
    } else {
      // P and dP together do not fit the registers: dP by pairs of
      // n-tiles, once for delta and once more for dS
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        if (jp >= nkt) continue;
        float d[2][4];
        dot_nt(d, Gs, Vs, so, r0, jp * 16, LKP, HDP, lane);
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            delta[e >> 1] = fmaf(d[t][e], s[2 * jp + t][e], delta[e >> 1]);
      }
      delta[0] = quad_sum(delta[0]);
      delta[1] = quad_sum(delta[1]);
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        if (jp >= nkt) continue;
        float d[2][4];
        dot_nt(d, Gs, Vs, so, r0, jp * 16, LKP, HDP, lane);
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int j = 2 * jp + t;
          sb[j][0] = pack(s[j][0] * (d[t][0] - delta[0]), s[j][1] * (d[t][1] - delta[0]));
          sb[j][1] = pack(s[j][2] * (d[t][2] - delta[1]), s[j][3] * (d[t][3] - delta[1]));
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      pb[j][0] = pack(s[j][0], s[j][1]);
      pb[j][1] = pack(s[j][2], s[j][3]);
    }

    // dQ = round(dS) . K, scaled after the dot: round(dS) straight from the
    // registers as A fragments, K through ldmatrix.trans
    for (int c0 = 0; c0 < HDP; c0 += kColTile) {
      float acc[kColTile / 8][4] = {};
#pragma unroll
      for (int kp = 0; kp < NT / 2; ++kp) {
        if (kp >= nkt) continue;
        const uint32_t a[4] = {sb[2 * kp][0], sb[2 * kp][1], sb[2 * kp + 1][0],
                               sb[2 * kp + 1][1]};
        dot_cols(acc, a, Ks, so, kp * 16, c0, HDP, lane);
      }
      store_tile(dq + qoff + c0, D, r0, Lq, hd - c0, acc, scale, lane);
    }
  }

  __syncthreads();  // K and V are dead: round(P) and round(dS) take their place
  if (r0 < LQP) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j >= 2 * nkt) continue;
      const int col = j * 8 + 2 * tq;
      *reinterpret_cast<uint32_t*>(Ps + (r0 + gr) * sp + col) = pb[j][0];
      *reinterpret_cast<uint32_t*>(Ps + (r0 + gr + 8) * sp + col) = pb[j][1];
      *reinterpret_cast<uint32_t*>(dSs + (r0 + gr) * sp + col) = sb[j][0];
      *reinterpret_cast<uint32_t*>(dSs + (r0 + gr + 8) * sp + col) = sb[j][1];
    }
  }
  __syncthreads();

  // dV = round(P)^T . G and dK = round(dS)^T . Q for the warp's key rows;
  // both operands through ldmatrix.trans
  const int k0 = warp * 16;
  if (k0 >= LKP) return;
  for (int c0 = 0; c0 < HDP; c0 += kColTile) {
    float av[kColTile / 8][4] = {}, ak[kColTile / 8][4] = {};
    for (int kq = 0; kq < LQP; kq += 16) {
      uint32_t ap[4], as[4];
      ldsm_x4_t(ap, a_cols(Ps, sp, kq, k0, lane));
      ldsm_x4_t(as, a_cols(dSs, sp, kq, k0, lane));
      dot_cols(av, ap, Gs, so, kq, c0, HDP, lane);
      dot_cols(ak, as, Qs, so, kq, c0, HDP, lane);
    }
    store_tile(dv + koff + c0, D, k0, Lk, hd - c0, av, 1.f, lane);
    store_tile(dk + koff + c0, D, k0, Lk, hd - c0, ak, scale, lane);
  }
}

template <int NT>
int launch_mma(const void* q, const void* k, const void* v, const void* g, void* dq, void* dk,
               void* dv, int B, int H, int Lq, int Lk, int hd, float scale,
               cudaStream_t stream) {
  const size_t smem = mma_smem_bytes(Lq, Lk, hd);
  const cudaError_t err = cudaFuncSetAttribute(attention_bwd_mma_kernel<NT>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int LP = mma::round16(Lq > Lk ? Lq : Lk);
  attention_bwd_mma_kernel<NT><<<B * H, LP / 16 * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(g), static_cast<bf16*>(dq), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), H, Lq, Lk, hd, scale);
  return (int)cudaGetLastError();
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

// logits of a fragment in base 2: s * scale * log2(e), rounded on its own
// (never fused into the next subtraction, so that both kernels form the
// same value from the same product), masked to -inf where `live` is false
__device__ __forceinline__ float logit2(float s, float scale2, bool live) {
  return live ? __fmul_rn(s, scale2) : -CUDART_INF_F;
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

bool fused_takes(int Lq, int Lk) { return Lq <= kMmaMaxLen && Lk <= kMmaMaxLen; }

int launch_bf16(const void* q, const void* k, const void* v, const void* g, void* dq, void* dk,
                void* dv, float* stats, int B, int H, int Lq, int Lk, int hd, float scale,
                cudaStream_t stream) {
  if (hd > 128) return (int)cudaErrorInvalidValue;
  if (!fused_takes(Lq, Lk)) {
    if (Lk > kLongMaxKeys) return (int)cudaErrorInvalidValue;
    return launch_long(q, k, v, g, dq, dk, dv, stats, B, H, Lq, Lk, hd, scale, stream);
  }
  if (mma::round16(Lk) <= 8 * kRowTiles)
    return launch_mma<kRowTiles>(q, k, v, g, dq, dk, dv, B, H, Lq, Lk, hd, scale, stream);
  return launch_mma<kMmaMaxLen / 8>(q, k, v, g, dq, dk, dv, B, H, Lq, Lk, hd, scale, stream);
}

}  // namespace

extern "C" {

// Shared memory one block needs, in bytes (dtype 0 = fp32: the larger of
// its two kernels; 1 = bf16: the fused kernel, or past its lengths the
// larger of the long route's two).
size_t attention_bwd_smem_bytes(int dtype, int Lq, int Lk, int hd) {
  if (dtype == 1) {
    if (fused_takes(Lq, Lk)) return mma_smem_bytes(Lq, Lk, hd);
    const size_t a = stat_smem(hd), b = long_smem(Lk, hd);
    return a > b ? a : b;
  }
  return smem_bytes(Lq > Lk ? Lq : Lk, hd);
}

// fp32 scratch one launch needs for its rows' statistics, in floats: the
// fp32 kernels 3 B H Lq, the bf16 long route 3 B H Lq rounded up to whole
// chunks of 32 rows, the fused kernel none.
size_t attention_bwd_stats_floats(int dtype, int B, int H, int Lq, int Lk) {
  if (dtype == 0) return 3 * (size_t)B * H * Lq;
  return fused_takes(Lq, Lk) ? 0 : 3 * (size_t)B * H * long_rows(Lq);
}

// Whether a bf16 launch takes the long route, and the most keys it takes
// there.
int attention_bwd_long_route(int dtype, int Lq, int Lk) {
  return dtype == 1 && !fused_takes(Lq, Lk);
}
int attention_bwd_long_max_keys() { return kLongMaxKeys; }

// Largest dynamic shared memory a block may opt into on `device`.
int attention_bwd_smem_limit(int device) {
  int bytes = 0;
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return bytes;
}

// q, g, dq [B, Lq, H*hd]; k, v, dk, dv [B, Lk, H*hd]: contiguous, 16-byte
// aligned, hd % 8 == 0, hd <= 128. stats: fp32 scratch of
// attention_bwd_stats_floats floats where that is not 0, else unused (may
// be null).
// Launches on `stream`; returns the first cudaError.
int attention_bwd(const void* q, const void* k, const void* v, const void* g, void* dq,
                  void* dk, void* dv, void* stats, int dtype, int B, int H, int Lq, int Lk,
                  int hd, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_bf16(q, k, v, g, dq, dk, dv, static_cast<float*>(stats), B, H, Lq, Lk, hd,
                       scale, s);
  return launch_fp32(q, k, v, g, dq, dk, dv, static_cast<float*>(stats), B, H, Lq, Lk, hd,
                     scale, s);
}

}  // extern "C"
