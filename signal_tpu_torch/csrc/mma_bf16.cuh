// Warp-level tensor-core building blocks of the bf16 attention kernels
// (attention_fwd.cu, attention_bwd.cu), sm_90a: 16-byte cp.async with zero
// fill (and its groups, for a ring of stages), ldmatrix (plain and
// transposed), mma.sync m16n8k16 bf16 x bf16 -> fp32, and a row padding
// that keeps ldmatrix free of bank conflicts.
//
// Fragments of mma.sync.m16n8k16.row.col, lane = 4 gr + tq:
//   A 16x16 (m x k), 4 regs of 2 bf16: (gr, 2tq..2tq+1), (gr+8, 2tq..),
//                                      (gr, 8+2tq..), (gr+8, 8+2tq..)
//   B 16x8 (k x n), 2 regs:            (2tq..2tq+1, gr), (8+2tq.., gr)
//   C 16x8 fp32, 4 floats:             (gr, 2tq), (gr, 2tq+1), (gr+8, 2tq),
//                                      (gr+8, 2tq+1)
// So the C tiles of columns 16c .. 16c+15 (two n-tiles), packed to bf16
// pairs, are the A fragment of k-step c: P and dS go from the accumulators
// into the next product without touching shared memory.
//
// The lower column of a bf16 pair sits in the lower 16 bits (pack()).

#pragma once

#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

namespace mma {

using bf16 = __nv_bfloat16;

__host__ __device__ __forceinline__ int round16(int n) { return (n + 15) & ~15; }

// Row stride, in elements, of a staged tile `cols` wide: the columns
// rounded up to a multiple of 16, plus 8. A row is then an odd number of
// 16-byte units long, so the 8 rows that one ldmatrix phase reads fall in
// 8 distinct bank groups.
__host__ __device__ __forceinline__ int padded(int cols) { return round16(cols) + 8; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; ok == false writes 16 zero bytes
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

// A ring of stages: close the thread's pending copies into a group, then
// wait until at most N groups are still in flight.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage rows [0, LP) of a head's column block (hd wide, row stride D in
// src) into dst, row stride padded(hd); rows >= L and columns >= hd are
// zero. cp_async_commit(), cp_async_wait<0>() and __syncthreads() before use.
__device__ __forceinline__ void stage_async(bf16* dst, const bf16* src, int L, int LP, int hd, int D) {
  const int per_row = round16(hd) / 8;
  const int stride = padded(hd);
  for (int i = threadIdx.x; i < LP * per_row; i += blockDim.x) {
    const int r = i / per_row;
    const int c = (i - r * per_row) * 8;
    const bool ok = r < L && c < hd;
    cp_async16(dst + r * stride + c, ok ? src + (size_t)r * D + c : src, ok);
  }
}

// four 8x8 b16 matrices; lanes 8i .. 8i+7 give the row addresses of matrix i
// (a shared-memory byte address, or a pointer into shared memory)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  ldsm_x4(r, smem_addr(p));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  ldsm_x4_t(r, smem_addr(p));
}

// c += a . b, 16x16 by 16x8, fp32 accumulation
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 (nearest even, as XLA's convert), lo first
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Lane addresses for ldmatrix.x4 of a 16x16 block of a row-major tile t
// (row stride `stride`). Each names the block by its first stored row and
// column, and says which fragment the four registers become.
//
// A operand stored [m][k]: registers a0..a3.
__device__ __forceinline__ const bf16* a_rows(const bf16* t, int stride, int m0, int k0, int lane) {
  return t + (m0 + (lane & 15)) * stride + k0 + (lane >> 4) * 8;
}
// A operand stored [k][m] (its transpose), for ldsm_x4_t: a0..a3.
__device__ __forceinline__ const bf16* a_cols(const bf16* t, int stride, int k0, int m0, int lane) {
  return t + (k0 + (lane & 7) + (lane >> 4) * 8) * stride + m0 + ((lane >> 3) & 1) * 8;
}
// B operand of two n-tiles stored [n][k], for ldsm_x4: (b0, b1) of n-tile
// n0 / 8, then (b0, b1) of n-tile n0 / 8 + 1.
__device__ __forceinline__ const bf16* b_rows(const bf16* t, int stride, int n0, int k0, int lane) {
  return t + (n0 + (lane & 7) + (lane >> 4) * 8) * stride + k0 + ((lane >> 3) & 1) * 8;
}
// B operand of two n-tiles stored [k][n], for ldsm_x4_t: as b_rows.
__device__ __forceinline__ const bf16* b_cols(const bf16* t, int stride, int k0, int n0, int lane) {
  return t + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * stride + n0 + (lane >> 4) * 8;
}

// 2^x on the SFU (ex2.approx, 2 ulp, as exp2f), results below 2^-126
// flushed to zero: exp2f's extra instructions for those cost the
// backward's fused kernel about 2 % and the forward's long route about 6 %,
// and a P under 1e-38 is no term of any bf16 output
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// reductions over the 4 lanes (tq) that hold one accumulator row
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Output tiles are at most kColTile columns wide: 8 n-tiles, 32 floats a
// thread, whatever the head dim.
constexpr int kColTile = 64;

// acc = A[m0 .. m0+15].B^T and acc2 = A2[m0 ..].B2^T (A, B staged tiles
// with row stride `stride`, kdim a multiple of 16) for the n-tiles from 0
// below row nend of B and B2, in one pass over the contraction (two passes
// keep more registers live, and the backward's S and dP then spill)
template <int NT>
__device__ __forceinline__ void dot_nt2(float (&acc)[NT][4], float (&acc2)[NT][4], const bf16* A,
                                        const bf16* B, const bf16* A2, const bf16* B2,
                                        int stride, int m0, int nend, int kdim, int lane) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = acc2[j][e] = 0.f;
#pragma unroll 1
  for (int kc = 0; kc < kdim; kc += 16) {
    uint32_t a[4], a2[4];
    ldsm_x4(a, a_rows(A, stride, m0, kc, lane));
    ldsm_x4(a2, a_rows(A2, stride, m0, kc, lane));
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp) {
      if (jp * 16 >= nend) continue;
      uint32_t b[4], b2[4];
      ldsm_x4(b, b_rows(B, stride, jp * 16, kc, lane));
      ldsm_x4(b2, b_rows(B2, stride, jp * 16, kc, lane));
      mma16816(acc[2 * jp], a, b[0], b[1]);
      mma16816(acc[2 * jp + 1], a, b[2], b[3]);
      mma16816(acc2[2 * jp], a2, b2[0], b2[1]);
      mma16816(acc2[2 * jp + 1], a2, b2[2], b2[3]);
    }
  }
}

// acc[0 .. NT) += A . B[k0 .. k0 + 16)[0 .. 8 NT) for one k-step: A a 16x16
// fragment, B staged [k][n] (row stride `stride`), n-tiles at or past ncols
// left untouched
template <int NT>
__device__ __forceinline__ void dot_cols_all(float (&acc)[NT][4], const uint32_t (&a)[4],
                                             const bf16* B, int stride, int k0, int ncols,
                                             int lane) {
#pragma unroll
  for (int np = 0; np < NT / 2; ++np) {
    if (np * 16 >= ncols) continue;
    uint32_t b[4];
    ldsm_x4_t(b, b_cols(B, stride, k0, np * 16, lane));
    mma16816(acc[2 * np], a, b[0], b[1]);
    mma16816(acc[2 * np + 1], a, b[2], b[3]);
  }
}

// Store the warp's 16 x (8 NT) accumulator tile, times `scale` and rounded
// to bf16, at rows r0 .. of dst (row stride D); rows >= L and columns >=
// ncols are dropped.
template <int NT>
__device__ __forceinline__ void store_tile(bf16* dst, int D, int r0, int L, int ncols,
                                           const float (&acc)[NT][4], float scale, int lane) {
  const int gr = lane >> 2;
  const int tq = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = j * 8 + 2 * tq;
    if (col >= ncols) continue;
    if (r0 + gr < L)
      *reinterpret_cast<uint32_t*>(dst + (size_t)(r0 + gr) * D + col) =
          pack(acc[j][0] * scale, acc[j][1] * scale);
    if (r0 + gr + 8 < L)
      *reinterpret_cast<uint32_t*>(dst + (size_t)(r0 + gr + 8) * D + col) =
          pack(acc[j][2] * scale, acc[j][3] * scale);
  }
}

}  // namespace mma
