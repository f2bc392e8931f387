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
// bf16: `attention_fwd_mma_kernel`, on the tensor cores. At the ViT-B
// shape (L = 129, hd = 64) a launch does about 64 operations per byte of
// q, k, v and o, far under the card's ~295 FLOP/B ridge, so device memory
// bounds it (0.091 ms at [384, 129, 768]). What holds it above that is its
// on-chip work (the CUDA-core design it replaces, scalar fmaf with one
// warp per query row, ran at 19x the bound). Here the products run on
// mma.sync m16n8k16 (bf16 in, fp32 accumulation). One block owns one
// (batch row, head, up to kMmaWarps 16-row query tiles): the 9 tiles of
// L = 129 take 3 blocks of 3 warps, and 4 blocks share an SM, so one
// block's staging overlaps the others' math. cp.async stages the block's
// Q rows and the head's K and V in shared memory (zero-filled to multiples
// of 16, rows padded so that ldmatrix is free of bank conflicts; each of
// a head's blocks stages K and V itself). Each warp
//   1. computes S = Q.K^T for its 16 rows into registers, a whole key row
//      of up to 144 keys (L = 129 pads to 144),
//   2. scales it, masks keys >= Lk to -inf, and does the fp32 softmax with
//      quad shuffles: row max, e = exp(s - max), e / sum e (a product with
//      the reciprocal of the sum),
//   3. rounds the normalised P to bf16 straight into A fragments and
//      computes O = P.V with V through ldmatrix.trans.
// No online rescaling of an unnormalised P: that would move the rounding
// point. Keys beyond one register row (Lk > 144, cross attention) take a
// second pass: the first finds each row's max and sum e over the key
// chunks, the second recomputes the logits, forms the exact normalised P
// and accumulates P.V. Shared memory is 48 KB a block at the main shape;
// 168 registers a thread allow 12 warps an SM.
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

// Shared memory one launch needs, in bytes (dtype 0 = fp32, 1 = bf16).
size_t attention_fwd_smem_bytes(int dtype, int Lq, int Lk, int hd) {
  return dtype == 1 ? mma_smem_bytes(Lq, Lk, hd) : smem_bytes(Lk, hd);
}

// Largest dynamic shared memory a block may opt into on `device`.
int attention_fwd_smem_limit(int device) {
  int bytes = 0;
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return bytes;
}

// q [B, Lq, H*hd], k/v [B, Lk, H*hd], o [B, Lq, H*hd]: contiguous, 16-byte
// aligned, hd % 8 == 0, hd <= 128. Launches on `stream`; returns
// cudaGetLastError().
int attention_fwd(const void* q, const void* k, const void* v, void* o, int dtype,
                  int B, int H, int Lq, int Lk, int hd, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (hd > 128) return (int)cudaErrorInvalidValue;
    return launch_mma(q, k, v, o, B, H, Lq, Lk, hd, scale, s);
  }
  return launch_fp32(q, k, v, o, B, H, Lq, Lk, hd, scale, s);
}

}  // extern "C"
