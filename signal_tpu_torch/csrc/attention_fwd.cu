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
// What bounds it on an H100: at the ViT-B shape (L = 129, hd = 64, bf16)
// a launch does ~64 operations per byte of q, k, v and o, far under the
// card's ~295 FLOP/B ridge, so the floor is the memory traffic: read
// q, k, v once and write o once. The design keeps everything else on
// chip: one block owns one (batch row, head, tile of query rows), stages
// that head's K and V (Lk x hd each) in shared memory once, and each warp
// takes one query row at a time, keeping the row's Lk logits in shared
// memory; nothing of size [L, L] reaches device memory. K rows are
// padded by 16 bytes so that the lanes of a warp, each on its own key,
// read distinct banks. The dot products run on the CUDA cores in fp32,
// which makes this first version bound by shared-memory reads rather
// than by device memory; wgmma, TMA and an online softmax are later work.

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

// two neighbouring elements (the first 2-element aligned) as floats
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

// Shared memory (dynamic), in this order:
//   Ks   [Lk][hd + kVec]          operand dtype (16-byte padded rows)
//   Vs   [Lk][hd]                 operand dtype
//   qrow [kWarps][hd]             fp32, the warp's current query row
//   prow [kWarps][round_up4(Lk)]  fp32, the warp's logits, then its rounded P
template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     int H, int Lq, int Lk, int hd, int rows_per_block, float scale) {
  constexpr int kVec = 16 / sizeof(T);  // elements in one 16-byte load
  extern __shared__ __align__(16) unsigned char smem[];
  const int ks_stride = hd + kVec;
  const int p_stride = round_up4(Lk);
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + (size_t)Lk * ks_stride;
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
  const T* kbase = k + (size_t)b * Lk * D + (size_t)h * hd;
  const T* vbase = v + (size_t)b * Lk * D + (size_t)h * hd;
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
    const T* qsrc = q + ((size_t)b * Lq + row) * D + (size_t)h * hd;
    for (int d = lane; d < hd; d += 32) qrow[d] = to_float(qsrc[d]);
    __syncwarp();

    // logits: lane j takes keys j, j + 32, ...; keys past Lk (the tail of
    // the last 32-key step) are never visited
    float mx = -CUDART_INF_F;
    for (int j = lane; j < Lk; j += 32) {
      const T* krow = Ks + (size_t)j * ks_stride;
      float acc = 0.f;
      for (int c = 0; c < hd; c += kVec) {
        const uint4 raw = *reinterpret_cast<const uint4*>(krow + c);
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int u = 0; u < kVec; u += 4) {
          const float4 qq = *reinterpret_cast<const float4*>(qrow + c + u);
          acc = fmaf(qq.x, to_float(e[u]), acc);
          acc = fmaf(qq.y, to_float(e[u + 1]), acc);
          acc = fmaf(qq.z, to_float(e[u + 2]), acc);
          acc = fmaf(qq.w, to_float(e[u + 3]), acc);
        }
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
    for (int j = lane; j < Lk; j += 32) {
      // P is rounded to the operand dtype before P.V, as the TPU kernel's
      // probs.astype(v.dtype)
      prow[j] = to_float(from_float<T>(prow[j] / sum));
    }
    __syncwarp();

    // o = P.V: lane owns the column pairs (2 lane, 2 lane + 1) + 64 t
    T* odst = o + ((size_t)b * Lq + row) * D + (size_t)h * hd;
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
      store2(odst + d, a0, a1);
    }
    __syncwarp();  // qrow and prow are rewritten for the warp's next row
  }
}

template <typename T>
size_t smem_bytes(int Lk, int hd) {
  constexpr int kVec = 16 / sizeof(T);
  return (size_t)Lk * (hd + kVec) * sizeof(T) + (size_t)Lk * hd * sizeof(T) +
         (size_t)kWarps * hd * sizeof(float) + (size_t)kWarps * round_up4(Lk) * sizeof(float);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int Lq, int Lk, int hd, int rows_per_block, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(Lk, hd);
  cudaError_t err = cudaFuncSetAttribute(attention_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(B * H), (unsigned)((Lq + rows_per_block - 1) / rows_per_block));
  attention_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, Lq, Lk, hd, rows_per_block, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one launch needs, in bytes (dtype 0 = fp32, 1 = bf16).
size_t attention_fwd_smem_bytes(int dtype, int Lk, int hd) {
  return dtype == 1 ? smem_bytes<__nv_bfloat16>(Lk, hd) : smem_bytes<float>(Lk, hd);
}

// Largest dynamic shared memory a block may opt into on `device`.
int attention_fwd_smem_limit(int device) {
  int bytes = 0;
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return bytes;
}

// q [B, Lq, H*hd], k/v [B, Lk, H*hd], o [B, Lq, H*hd]: contiguous, 16-byte
// aligned, hd % 8 == 0. Launches on `stream`; returns cudaGetLastError().
int attention_fwd(const void* q, const void* k, const void* v, void* o, int dtype,
                  int B, int H, int Lq, int Lk, int hd, int rows_per_block,
                  float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, B, H, Lq, Lk, hd, rows_per_block, scale, s);
  return launch<float>(q, k, v, o, B, H, Lq, Lk, hd, rows_per_block, scale, s);
}

}  // extern "C"
