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
// input 193): the long route, two tensor-core kernels in the shape of the
// fp32 pair below, with the same rounding points as the fused kernel and
// no atomics.
//   attention_bwd_rows_mma_kernel  one block per (batch row, head, 128
//       query rows), 8 warps of 16 rows; it stages its Q and G rows and
//       the head's K and V. Each warp walks the keys in chunks of 32:
//       pass 1 the row max and sum of e (rescaled online, per lane, then
//       summed over the quad), pass 2 P and dP for delta = rowsum(dP o P),
//       pass 3 P, dP, dS and dQ = round(dS).K for each 64-column tile of
//       the head. It writes dQ and the row's max, 1/sum and delta (fp32)
//       to a scratch.
//   attention_bwd_cols_mma_kernel  one block per (batch row, head, 128
//       key rows), 8 warps of 16 key rows; it stages its K and V rows, the
//       head's Q and G and the rows' statistics. Each warp walks the
//       queries in chunks of 32 and computes S^T = K.Q^T and dP^T = V.G^T
//       (the same products over hd in the same order as the rows kernel,
//       operands swapped), P^T from the statistics, dS^T, and accumulates
//       dV = round(P)^T.G and dK = round(dS)^T.Q with round(P)^T and
//       round(dS)^T straight from the registers as A fragments.
// Both recompute the products they need instead of keeping [L, L] tiles,
// so the shared memory holds the operands only: 128 rows of two operands
// and the whole head of the other two, (256 + 2 round16(L)) padded(hd)
// bf16 (plus 12 B a query row in the cols kernel): Lq, Lk <= 640 at
// hd 64 and <= 288 at hd 128 on a 227 KB block (the wrapper raises
// beyond). 8 warps a block keep two blocks, 16 warps, on an SM at
// L = 211 (4 warps ran slower on the card, PERF.md). The route does 10
// products of [L, L, hd] (S three times and dP twice in the rows kernel,
// S, dP, dV and dK in the cols kernel) against the fused kernel's 5; a
// simple design first, its time is in PERF.md.
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

// ---- bf16, past 160 tokens: the rows and cols kernels ---------------------

constexpr int kLongWarps = 8;               // 16-row tiles per block
constexpr int kLongRows = 16 * kLongWarps;  // the block's own rows
constexpr int kChunk = 4;                   // n-tiles of 8 a warp takes at once (32 keys)

// Shared memory (dynamic), in this order:
//   rows kernel  Qs, Gs [kLongRows][padded(hd)], Ks, Vs [round16(Lk)][padded(hd)]
//   cols kernel  Ks, Vs [kLongRows][padded(hd)], Qs, Gs [round16(Lq)][padded(hd)],
//                then the rows' max, 1/sum and delta [3][round16(Lq)] fp32
size_t long_rows_smem(int Lk, int hd) {
  return (2 * (size_t)kLongRows + 2 * (size_t)mma::round16(Lk)) * mma::padded(hd) *
         sizeof(bf16);
}
size_t long_cols_smem(int Lq, int hd) {
  return long_rows_smem(Lq, hd) + 3 * (size_t)mma::round16(Lq) * sizeof(float);
}

// logits of a chunk: s * scale (rounded on its own, never fused with the
// next subtraction, so both kernels form the same values), key columns
// >= Lk set to -inf; n-tiles at or past LKP are left as they are
template <int NT>
__device__ __forceinline__ void scale_mask_rn(float (&s)[NT][4], int key0, int Lk, float scale,
                                              int lane) {
  const int LKP = mma::round16(Lk);
  const int tq = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (key0 + j * 8 >= LKP) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = key0 + j * 8 + 2 * tq + (e & 1);
      s[j][e] = col < Lk ? __fmul_rn(s[j][e], scale) : -CUDART_INF_F;
    }
  }
}

// stats: [3][B * H * Lq] fp32 = (row max of the logits, 1 / sum of e, delta)
__global__ void __launch_bounds__(kLongWarps * 32)
attention_bwd_rows_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, const bf16* __restrict__ g,
                              bf16* __restrict__ dq, float* __restrict__ stats, int B, int H,
                              int Lq, int Lk, int hd, float scale) {
  using namespace mma;
  extern __shared__ __align__(16) unsigned char smem[];
  const int LKP = round16(Lk), HDP = round16(hd), so = padded(hd);
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Gs = Qs + kLongRows * so;
  bf16* Ks = Gs + kLongRows * so;
  bf16* Vs = Ks + LKP * so;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int D = H * hd;
  const int q0 = blockIdx.y * kLongRows;
  const size_t qoff = (size_t)b * Lq * D + (size_t)h * hd;
  const size_t koff = (size_t)b * Lk * D + (size_t)h * hd;
  const int nq = min(kLongRows, Lq - q0);
  stage_async(Qs, q + qoff + (size_t)q0 * D, nq, kLongRows, hd, D);
  stage_async(Gs, g + qoff + (size_t)q0 * D, nq, kLongRows, hd, D);
  stage_async(Ks, k + koff, Lk, LKP, hd, D);
  stage_async(Vs, v + koff, Lk, LKP, hd, D);
  cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2;
  const int r0 = warp * 16;  // the warp's rows in Qs, Gs
  if (q0 + r0 >= Lq) return;

  // pass 1: the row max and the sum of e = exp(s - max), rescaled as the
  // max grows
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float sum[2] = {0.f, 0.f};
  for (int kc0 = 0; kc0 < LKP; kc0 += 8 * kChunk) {
    float s[kChunk][4];
    dot_nt(s, Qs, Ks, so, r0, kc0, LKP, HDP, lane);
    scale_mask_rn(s, kc0, Lk, scale, lane);
    float cm[2] = {mx[0], mx[1]};
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (kc0 + j * 8 >= LKP) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) cm[e >> 1] = fmaxf(cm[e >> 1], s[j][e]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      cm[i] = quad_max(cm[i]);
      sum[i] *= expf(mx[i] - cm[i]);  // exp(-inf) = 0 before the first chunk
      mx[i] = cm[i];
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (kc0 + j * 8 >= LKP) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[e >> 1] += expf(s[j][e] - mx[e >> 1]);
    }
  }
  // rows >= Lq get 1/sum = 0, hence P = 0 (a zero-filled Q row would give
  // a uniform P)
  const bool live[2] = {q0 + r0 + gr < Lq, q0 + r0 + gr + 8 < Lq};
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    sum[i] = quad_sum(sum[i]);
    inv[i] = live[i] ? 1.f / sum[i] : 0.f;
  }

  // pass 2: delta = rowsum(dP o P) from the fp32 P and dP
  float delta[2] = {0.f, 0.f};
  for (int kc0 = 0; kc0 < LKP; kc0 += 8 * kChunk) {
    float s[kChunk][4], dp[kChunk][4];
    dot_nt(s, Qs, Ks, so, r0, kc0, LKP, HDP, lane);
    dot_nt(dp, Gs, Vs, so, r0, kc0, LKP, HDP, lane);
    scale_mask_rn(s, kc0, Lk, scale, lane);
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (kc0 + j * 8 >= LKP) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - mx[e >> 1]) * inv[e >> 1];
        delta[e >> 1] = fmaf(dp[j][e], p, delta[e >> 1]);
      }
    }
  }
  delta[0] = quad_sum(delta[0]);
  delta[1] = quad_sum(delta[1]);
  if ((lane & 3) == 0) {
    const size_t n_rows = (size_t)B * H * Lq;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (!live[i]) continue;
      const size_t r = ((size_t)b * H + h) * Lq + q0 + r0 + gr + 8 * i;
      stats[r] = mx[i];
      stats[n_rows + r] = inv[i];
      stats[2 * n_rows + r] = delta[i];
    }
  }

  // pass 3: dS = P o (dP - delta) and dQ = round(dS).K, scaled after the
  // dot, one 64-column tile of the head at a time
  for (int c0 = 0; c0 < HDP; c0 += kColTile) {
    float acc[kColTile / 8][4] = {};
    for (int kc0 = 0; kc0 < LKP; kc0 += 8 * kChunk) {
      float s[kChunk][4], dp[kChunk][4];
      dot_nt(s, Qs, Ks, so, r0, kc0, LKP, HDP, lane);
      dot_nt(dp, Gs, Vs, so, r0, kc0, LKP, HDP, lane);
      scale_mask_rn(s, kc0, Lk, scale, lane);
      uint32_t sb[kChunk][2];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(s[j][e] - mx[e >> 1]) * inv[e >> 1];
          ds[e] = p * (dp[j][e] - delta[e >> 1]);
        }
        sb[j][0] = pack(ds[0], ds[1]);
        sb[j][1] = pack(ds[2], ds[3]);
      }
#pragma unroll
      for (int kp = 0; kp < kChunk / 2; ++kp) {
        if (kc0 + kp * 16 >= LKP) continue;
        const uint32_t a[4] = {sb[2 * kp][0], sb[2 * kp][1], sb[2 * kp + 1][0],
                               sb[2 * kp + 1][1]};
        dot_cols(acc, a, Ks, so, kc0 + kp * 16, c0, HDP, lane);
      }
    }
    store_tile(dq + qoff + c0, D, q0 + r0, Lq, hd - c0, acc, scale, lane);
  }
}

__global__ void __launch_bounds__(kLongWarps * 32)
attention_bwd_cols_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, const bf16* __restrict__ g,
                              bf16* __restrict__ dk, bf16* __restrict__ dv,
                              const float* __restrict__ stats, int B, int H, int Lq, int Lk,
                              int hd, float scale) {
  using namespace mma;
  extern __shared__ __align__(16) unsigned char smem[];
  const int LQP = round16(Lq), HDP = round16(hd), so = padded(hd);
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + kLongRows * so;
  bf16* Qs = Vs + kLongRows * so;
  bf16* Gs = Qs + LQP * so;
  float* row_max = reinterpret_cast<float*>(Gs + LQP * so);
  float* row_inv = row_max + LQP;
  float* row_delta = row_inv + LQP;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int D = H * hd;
  const int k0 = blockIdx.y * kLongRows;
  const size_t qoff = (size_t)b * Lq * D + (size_t)h * hd;
  const size_t koff = (size_t)b * Lk * D + (size_t)h * hd;
  const int nk = min(kLongRows, Lk - k0);
  stage_async(Ks, k + koff + (size_t)k0 * D, nk, kLongRows, hd, D);
  stage_async(Vs, v + koff + (size_t)k0 * D, nk, kLongRows, hd, D);
  stage_async(Qs, q + qoff, Lq, LQP, hd, D);
  stage_async(Gs, g + qoff, Lq, LQP, hd, D);
  {
    // the rows' statistics; query rows >= Lq get 1/sum = 0, hence P = 0
    const size_t n_rows = (size_t)B * H * Lq;
    const float* rs = stats + ((size_t)b * H + h) * Lq;
    for (int i = threadIdx.x; i < LQP; i += blockDim.x) {
      const bool ok = i < Lq;
      row_max[i] = ok ? rs[i] : 0.f;
      row_inv[i] = ok ? rs[n_rows + i] : 0.f;
      row_delta[i] = ok ? rs[2 * n_rows + i] : 0.f;
    }
  }
  cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2;
  const int tq = lane & 3;
  const int r0 = warp * 16;  // the warp's key rows in Ks, Vs
  if (k0 + r0 >= Lk) return;
  const bool live[2] = {k0 + r0 + gr < Lk, k0 + r0 + gr + 8 < Lk};

  for (int c0 = 0; c0 < HDP; c0 += kColTile) {
    float av[kColTile / 8][4] = {}, ak[kColTile / 8][4] = {};
    for (int qc0 = 0; qc0 < LQP; qc0 += 8 * kChunk) {
      // S^T and dP^T of the warp's keys and the chunk's queries
      float s[kChunk][4], dp[kChunk][4];
      dot_nt(s, Ks, Qs, so, r0, qc0, LQP, HDP, lane);
      dot_nt(dp, Vs, Gs, so, r0, qc0, LQP, HDP, lane);
      uint32_t pb[kChunk][2], sb[kChunk][2];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        pb[j][0] = pb[j][1] = sb[j][0] = sb[j][1] = 0u;
        if (qc0 + j * 8 >= LQP) continue;
        const int col = qc0 + j * 8 + 2 * tq;
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = col + (e & 1);
          p[e] = live[e >> 1] ? expf(__fmul_rn(s[j][e], scale) - row_max[c]) * row_inv[c]
                              : 0.f;
          ds[e] = p[e] * (dp[j][e] - row_delta[c]);
        }
        pb[j][0] = pack(p[0], p[1]);
        pb[j][1] = pack(p[2], p[3]);
        sb[j][0] = pack(ds[0], ds[1]);
        sb[j][1] = pack(ds[2], ds[3]);
      }
#pragma unroll
      for (int kp = 0; kp < kChunk / 2; ++kp) {
        if (qc0 + kp * 16 >= LQP) continue;
        const uint32_t ap[4] = {pb[2 * kp][0], pb[2 * kp][1], pb[2 * kp + 1][0],
                                pb[2 * kp + 1][1]};
        const uint32_t as[4] = {sb[2 * kp][0], sb[2 * kp][1], sb[2 * kp + 1][0],
                                sb[2 * kp + 1][1]};
        dot_cols(av, ap, Gs, so, qc0 + kp * 16, c0, HDP, lane);
        dot_cols(ak, as, Qs, so, qc0 + kp * 16, c0, HDP, lane);
      }
    }
    store_tile(dv + koff + c0, D, k0 + r0, Lk, hd - c0, av, 1.f, lane);
    store_tile(dk + koff + c0, D, k0 + r0, Lk, hd - c0, ak, scale, lane);
  }
}

int launch_long(const void* q, const void* k, const void* v, const void* g, void* dq, void* dk,
                void* dv, float* stats, int B, int H, int Lq, int Lk, int hd, float scale,
                cudaStream_t stream) {
  const size_t smem_rows = long_rows_smem(Lk, hd), smem_cols = long_cols_smem(Lq, hd);
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_rows_mma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_rows);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(attention_bwd_cols_mma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_cols);
  if (err != cudaSuccess) return (int)err;
  const bf16* qq = static_cast<const bf16*>(q);
  const bf16* kk = static_cast<const bf16*>(k);
  const bf16* vv = static_cast<const bf16*>(v);
  const bf16* gg = static_cast<const bf16*>(g);
  const dim3 grid_rows((unsigned)(B * H), (unsigned)((Lq + kLongRows - 1) / kLongRows));
  attention_bwd_rows_mma_kernel<<<grid_rows, kLongWarps * 32, smem_rows, stream>>>(
      qq, kk, vv, gg, static_cast<bf16*>(dq), stats, B, H, Lq, Lk, hd, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_cols((unsigned)(B * H), (unsigned)((Lk + kLongRows - 1) / kLongRows));
  attention_bwd_cols_mma_kernel<<<grid_cols, kLongWarps * 32, smem_cols, stream>>>(
      qq, kk, vv, gg, static_cast<bf16*>(dk), static_cast<bf16*>(dv), stats, B, H, Lq, Lk, hd,
      scale);
  return (int)cudaGetLastError();
}

bool fused_takes(int Lq, int Lk) { return Lq <= kMmaMaxLen && Lk <= kMmaMaxLen; }

int launch_bf16(const void* q, const void* k, const void* v, const void* g, void* dq, void* dk,
                void* dv, float* stats, int B, int H, int Lq, int Lk, int hd, float scale,
                cudaStream_t stream) {
  if (hd > 128) return (int)cudaErrorInvalidValue;
  if (!fused_takes(Lq, Lk))
    return launch_long(q, k, v, g, dq, dk, dv, stats, B, H, Lq, Lk, hd, scale, stream);
  if (mma::round16(Lk) <= 8 * kRowTiles)
    return launch_mma<kRowTiles>(q, k, v, g, dq, dk, dv, B, H, Lq, Lk, hd, scale, stream);
  return launch_mma<kMmaMaxLen / 8>(q, k, v, g, dq, dk, dv, B, H, Lq, Lk, hd, scale, stream);
}

}  // namespace

extern "C" {

// Shared memory one launch needs, in bytes (dtype 0 = fp32: the larger of
// its two kernels; 1 = bf16: the fused kernel, or past its lengths the
// larger of the long route's two).
size_t attention_bwd_smem_bytes(int dtype, int Lq, int Lk, int hd) {
  if (dtype == 1) {
    if (fused_takes(Lq, Lk)) return mma_smem_bytes(Lq, Lk, hd);
    const size_t r = long_rows_smem(Lk, hd), c = long_cols_smem(Lq, hd);
    return r > c ? r : c;
  }
  return smem_bytes(Lq > Lk ? Lq : Lk, hd);
}

// Whether a launch needs the fp32 statistics scratch (3 * B * H * Lq):
// the fp32 kernels and the bf16 long route do, the fused kernel does not.
int attention_bwd_needs_stats(int dtype, int Lq, int Lk) {
  return dtype == 0 || !fused_takes(Lq, Lk);
}

// Largest dynamic shared memory a block may opt into on `device`.
int attention_bwd_smem_limit(int device) {
  int bytes = 0;
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return bytes;
}

// q, g, dq [B, Lq, H*hd]; k, v, dk, dv [B, Lk, H*hd]: contiguous, 16-byte
// aligned, hd % 8 == 0, hd <= 128. stats: fp32 scratch of 3 * B * H * Lq
// where attention_bwd_needs_stats says so, else unused (may be null).
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
