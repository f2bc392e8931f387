// Fused multi-head attention backward for short sequences, sm_90a.
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
//
// dQ reduces over keys, dK and dV over query rows. So the work is split in
// two kernels that need no atomics and sum in a fixed order:
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
// Heads are column blocks hd wide of the [B, L, D] layout, read by stride
// with 16-byte loads: there is no transpose. Lanes take rows j, j + 32, ...
// of the staged operand and stop at its length, so the ragged tail (129)
// needs no padding; the staged rows are padded by 16 bytes so that the
// lanes of a warp, each on its own row, read distinct banks. The dot
// products run on the CUDA cores in fp32: this first version is bound by
// its on-chip work, not by device memory (tensor cores are later work).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as XLA's convert
}

// x rounded to the operand dtype and widened again
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  __nv_bfloat162 r;
  r.x = __float2bfloat16(a);
  r.y = __float2bfloat16(b);
  *reinterpret_cast<__nv_bfloat162*>(p) = r;
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

// fp32 row x (shared, hd floats) dotted with a staged operand-dtype row,
// ascending over the columns; both kernels use it for the logits and for
// dP, so the two recompute the same values
template <typename T>
__device__ __forceinline__ float dot_row(const float* x, const T* row, int hd) {
  constexpr int kVec = 16 / sizeof(T);
  float acc = 0.f;
  for (int c = 0; c < hd; c += kVec) {
    const uint4 raw = *reinterpret_cast<const uint4*>(row + c);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int u = 0; u < kVec; u += 4) {
      const float4 xx = *reinterpret_cast<const float4*>(x + c + u);
      acc = fmaf(xx.x, to_float(e[u]), acc);
      acc = fmaf(xx.y, to_float(e[u + 1]), acc);
      acc = fmaf(xx.z, to_float(e[u + 2]), acc);
      acc = fmaf(xx.w, to_float(e[u + 3]), acc);
    }
  }
  return acc;
}

// Stage n rows of the head's column block (hd wide, row stride D in src)
// into dst with row stride hd + kVec.
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* src, int n, int hd, int D) {
  constexpr int kVec = 16 / sizeof(T);
  const int vecs = hd / kVec;
  for (int i = threadIdx.x; i < n * vecs; i += kThreads) {
    const int r = i / vecs;
    const int c = (i - r * vecs) * kVec;
    *reinterpret_cast<uint4*>(dst + (size_t)r * (hd + kVec) + c) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * D + c);
  }
}

// out[d], out[d + 1] for the lane's column pairs d = 2 lane + 64 t:
// sum_j w[j] * S[j][d], over n staged rows S (row stride `stride`)
template <typename T>
__device__ __forceinline__ float2 weighted_rows(const float* w, const T* S, int n, int stride,
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

// Shared memory of either kernel (dynamic), in this order, with n the
// staged length (Lk for rows_kernel, Lq for cols_kernel) and m the other:
//   A, B  [n][hd + kVec]              operand dtype: (K, V) or (Q, G)
//   x, y  [kWarps][hd]                fp32, the warp's current rows
//   s, t  [kWarps][round_up4(n)]      fp32, the warp's P and dP / dS
template <typename T>
size_t smem_bytes(int n, int hd) {
  constexpr int kVec = 16 / sizeof(T);
  return 2 * (size_t)n * (hd + kVec) * sizeof(T) + 2 * (size_t)kWarps * hd * sizeof(float) +
         2 * (size_t)kWarps * round_up4(n) * sizeof(float);
}

// stats: [3][B * H * Lq] fp32 = (row max of the logits, sum of exp, delta)
template <typename T>
__global__ void __launch_bounds__(kThreads)
rows_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ g, T* __restrict__ dq, float* __restrict__ stats,
            int B, int H, int Lq, int Lk, int hd, int rows_per_block, float scale) {
  constexpr int kVec = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  const int stride = hd + kVec;
  const int p_stride = round_up4(Lk);
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + (size_t)Lk * stride;
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
      qrow[d] = to_float(q[off + d]);
      grow[d] = to_float(g[off + d]);
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
    // dS in place of dP, rounded to the operand dtype for the dQ product
    for (int j = lane; j < Lk; j += 32) srow[j] = round_to<T>(prow[j] * (srow[j] - delta));
    __syncwarp();

    T* dst = dq + off;
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
cols_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ g, T* __restrict__ dk, T* __restrict__ dv,
            const float* __restrict__ stats, int B, int H, int Lq, int Lk, int hd,
            int cols_per_block, float scale) {
  constexpr int kVec = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  const int stride = hd + kVec;
  const int p_stride = round_up4(Lq);
  T* Qs = reinterpret_cast<T*>(smem);
  T* Gs = Qs + (size_t)Lq * stride;
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
      krow[d] = to_float(k[off + d]);
      vrow[d] = to_float(v[off + d]);
    }
    __syncwarp();

    // column `col` of P and dS; lane i takes query rows i, i + 32, ...
    for (int i = lane; i < Lq; i += 32) {
      const float logit = dot_row(krow, Qs + (size_t)i * stride, hd) * scale;
      const float p = expf(logit - row_max[i]) / row_sum[i];
      const float dp = dot_row(vrow, Gs + (size_t)i * stride, hd);
      pcol[i] = round_to<T>(p);
      scol[i] = round_to<T>(p * (dp - row_delta[i]));
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

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* g, void* dq, void* dk,
           void* dv, float* stats, int B, int H, int Lq, int Lk, int hd, int rows_per_block,
           int cols_per_block, float scale, cudaStream_t stream) {
  const size_t smem_rows = smem_bytes<T>(Lk, hd);
  const size_t smem_cols = smem_bytes<T>(Lq, hd);
  cudaError_t err = cudaFuncSetAttribute(rows_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_rows);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(cols_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_cols);
  if (err != cudaSuccess) return (int)err;
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  const T* gg = static_cast<const T*>(g);
  const dim3 grid_rows((unsigned)(B * H), (unsigned)((Lq + rows_per_block - 1) / rows_per_block));
  rows_kernel<T><<<grid_rows, kThreads, smem_rows, stream>>>(
      qq, kk, vv, gg, static_cast<T*>(dq), stats, B, H, Lq, Lk, hd, rows_per_block, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_cols((unsigned)(B * H), (unsigned)((Lk + cols_per_block - 1) / cols_per_block));
  cols_kernel<T><<<grid_cols, kThreads, smem_cols, stream>>>(
      qq, kk, vv, gg, static_cast<T*>(dk), static_cast<T*>(dv), stats, B, H, Lq, Lk, hd,
      cols_per_block, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory the larger of the two launches needs, in bytes
// (dtype 0 = fp32, 1 = bf16).
size_t attention_bwd_smem_bytes(int dtype, int Lq, int Lk, int hd) {
  const int n = Lq > Lk ? Lq : Lk;
  return dtype == 1 ? smem_bytes<__nv_bfloat16>(n, hd) : smem_bytes<float>(n, hd);
}

// Largest dynamic shared memory a block may opt into on `device`.
int attention_bwd_smem_limit(int device) {
  int bytes = 0;
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return bytes;
}

// q, g, dq [B, Lq, H*hd]; k, v, dk, dv [B, Lk, H*hd]: contiguous, 16-byte
// aligned, hd % 8 == 0. stats: fp32 scratch of 3 * B * H * Lq. Launches
// the two kernels on `stream`; returns the first cudaError.
int attention_bwd(const void* q, const void* k, const void* v, const void* g, void* dq,
                  void* dk, void* dv, void* stats, int dtype, int B, int H, int Lq, int Lk,
                  int hd, int rows_per_block, int cols_per_block, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(stats);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, g, dq, dk, dv, st, B, H, Lq, Lk, hd, rows_per_block,
                                 cols_per_block, scale, s);
  return launch<float>(q, k, v, g, dq, dk, dv, st, B, H, Lq, Lk, hd, rows_per_block,
                       cols_per_block, scale, s);
}

}  // extern "C"
