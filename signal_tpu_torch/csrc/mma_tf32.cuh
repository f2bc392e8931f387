// Warp-level building blocks of the fp32 attention backward
// (attention_bwd.cu), sm_90a: fp32-accurate products on the TF32 tensor
// cores ("3xTF32", the split of CUTLASS's OpMultiplyAddFastF32, which
// PyTorch's fp32 memory-efficient attention uses on sm80+), on fp32 tiles
// that TMA writes in the 128-byte swizzle; and the grid both fp32 kernels
// share (grid_for).
//
// Fragments of mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32, lane = 4 gr + tq:
//   A 16x8 (m x k), 4 regs: (gr, tq), (gr+8, tq), (gr, tq+4), (gr+8, tq+4)
//   B 8x8 (k x n), 2 regs:  (tq, gr), (tq+4, gr)
//   C 16x8 fp32, 4 floats:  (gr, 2tq), (gr, 2tq+1), (gr+8, 2tq), (gr+8, 2tq+1)
// An 8x8 b16 matrix of ldmatrix is an 8x4 fp32 matrix, one word a lane, lane
// 4 gr + tq getting (gr, tq): ldmatrix.x4 serves the A fragment of a [m][k]
// tile and the B fragments of two n-tiles of a [n][k] tile.
//
// A product whose A operand is a C tile (P.V, dS.K, P^T.G, dS^T.Q) runs its
// contraction over the C tile's columns in a permuted order: k = tq and k =
// tq + 4 of k-step j stand for columns 8j + 2tq and 8j + 2tq + 1. The C
// fragment (c0, c1, c2, c3) is then the A fragment (c0, c2, c1, c3), with no
// shuffle, and B's fragment is (row 8j + 2tq, column gr), (8j + 2tq + 1, gr)
// of a [k][n] tile: two 32-bit shared loads a lane (ldmatrix cannot
// transpose 32-bit words), free of bank conflicts in the swizzle (dot_cn).
//
// 3xTF32: each operand a = hi + lo, hi = tf32(a) (to nearest, ties away)
// and lo = a - hi, read by the tensor core truncated to tf32; a.b = lo.hi' +
// hi.lo' + hi.hi' into one fp32 accumulator, the two small products first.
// lo.lo' (about 2^-22 of the product) is dropped, so a product keeps about
// 21 bits against TF32's 11.
//
// Tiles: rows of 32 floats (128 bytes) in slabs, slab s holding columns 32 s
// .. 32 s + 31 of every row; the 16-byte chunk c of row r lies at chunk c ^
// (r % 8) of that row. A slab of a 16-row tile is 2 KB and starts at a
// multiple of 1024 bytes, where the swizzle's pattern starts.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "tma.cuh"

namespace tf32 {

constexpr int kSlab = 32;    // floats of one slab row: 128 bytes
constexpr int kRows = 16;    // rows of a tile: a query tile, a key tile, a chunk, a TMA box
constexpr int kStages = 2;   // chunks of a ring (3 measured no faster: fewer blocks fit)

// tf32(x): to nearest, ties away (cvt.rna's rounding), on the bit pattern:
// two integer instructions at 64 results a clock an SM, where
// cvt.rna.tf32.f32 takes the conversion unit's 16 (kernels 1.35x slower)
__device__ __forceinline__ uint32_t round_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo: hi = tf32(x), and lo = x - hi (exact in fp32) goes in as it
// is: the tensor core reads the top 19 bits of a tf32 operand, a truncation
// of lo whose error stays under 2^-21 |x| (rounding lo as well measured
// slower, with the same errors)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = round_tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

template <int N>
__device__ __forceinline__ void split(const uint32_t (&x)[N], uint32_t (&hi)[N], uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) split(__uint_as_float(x[i]), hi[i], lo[i]);
}

// c += a.b, 16x8 by 8x8, tf32 in, fp32 accumulation
__device__ __forceinline__ void mma1688(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a.b in 3xTF32: the two small products, then the large one, chained
// in the tensor core's accumulator
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ahi)[4],
                                     const uint32_t (&alo)[4], uint32_t bh0, uint32_t bh1,
                                     uint32_t bl0, uint32_t bl1) {
  mma1688(c, alo, bh0, bh1);
  mma1688(c, ahi, bl0, bl1);
  mma1688(c, ahi, bh0, bh1);
}

// c += a.b in 3xTF32 through a fresh accumulator, added to c on the CUDA
// cores (round to nearest): the tensor core's own accumulation truncates,
// and chained over a whole key row (P.V, dS.K) it drifts to about 2.4x the
// plain fp32 version's error against fp64; added this way, to about 1x
// (PERF.md)
__device__ __forceinline__ void mma3_add(float (&c)[4], const uint32_t (&ahi)[4],
                                         const uint32_t (&alo)[4], uint32_t bh0, uint32_t bh1,
                                         uint32_t bl0, uint32_t bl1) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma3(t, ahi, alo, bh0, bh1, bl0, bl1);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += t[e];
}

// acc[k-step parity][j] += A[0, 16)[0, 8 HN) . B[8j, 8j + 8)[0, 8 HN)^T for
// the two n-tiles j of 16 rows of B: A and B swizzled 16-row tiles (byte
// addresses in shared memory; `slab` bytes from one slab to the next).
// Two accumulators by the parity of the k-step give each n-tile two
// independent mma chains of half the length, which the caller adds: one
// chain of 3 HN mma.sync into one accumulator measured up to 1.3x further
// from fp64.
// ROLLED keeps one pair of k-steps in flight (the cols kernel, whose dK and
// dV accumulators leave no registers for the loads of all of them).
// Columns past hd are zero in both tiles.
template <int HN, bool ROLLED = false>
__device__ __forceinline__ void dot_nt(float (&acc)[2][2][4], uint32_t A, uint32_t B, int slab,
                                       int lane) {
  const int r8 = lane & 7;
  const int arow = (r8 + ((lane >> 3) & 1) * 8) * kSlab * 4;
  const int brow = (r8 + (lane >> 4) * 8) * kSlab * 4;
#pragma unroll(ROLLED ? 1 : HN / 2)
  for (int kp = 0; kp < HN / 2; ++kp) {
#pragma unroll
    for (int par = 0; par < 2; ++par) {
      // 16-byte chunk 2 (ks % 4) + 1 holds columns 8 ks + 4 .. 8 ks + 7
      const int ks = 2 * kp + par;
      const int sl = (ks >> 2) * slab;
      uint32_t a[4], b[4], ahi[4], alo[4], bhi[4], blo[4];
      mma::ldsm_x4(a, A + sl + arow + (((2 * (ks & 3) + (lane >> 4)) ^ r8) << 4));
      mma::ldsm_x4(b, B + sl + brow + (((2 * (ks & 3) + ((lane >> 3) & 1)) ^ r8) << 4));
      split(a, ahi, alo);
      split(b, bhi, blo);
      mma3(acc[par][0], ahi, alo, bhi[0], bhi[1], blo[0], blo[1]);
      mma3(acc[par][1], ahi, alo, bhi[2], bhi[3], blo[2], blo[3]);
    }
  }
}

// acc[np] += C . T[kb, kb + 8)[8 np, 8 np + 8) for np < HN: one k-step of a
// product whose A operand is the C fragment c of a 16x8 tile (its columns
// standing for rows kb .. kb + 7 of T, in the permuted order), and T a
// swizzled [k][n] tile (floats; `slab` floats from one slab to the next; kb
// a multiple of 8). FRESH: through mma3_add (a sum over a whole key row);
// else chained in acc (the cols kernel's dV, and its dK past hd 64, where
// the registers allow no more). Lane (gr, tq) reads rows kb + 2tq and kb + 2tq + 1 at
// column 8 np + gr: chunk 2((np % 4) ^ tq) + gr / 4 (and its neighbour ^ 1
// for the odd row), a distinct bank for each of the 32 lanes.
template <int HN, bool FRESH = true>
__device__ __forceinline__ void dot_cn(float (&acc)[HN][4], const float (&c)[4], const float* T,
                                       int slab, int kb, int lane) {
  const int gr = lane >> 2, tq = lane & 3;
  uint32_t ahi[4], alo[4];
  split(c[0], ahi[0], alo[0]);
  split(c[2], ahi[1], alo[1]);
  split(c[1], ahi[2], alo[2]);
  split(c[3], ahi[3], alo[3]);
  const float* row = T + (kb + 2 * tq) * kSlab + (gr & 3);
#pragma unroll
  for (int np = 0; np < HN; ++np) {
    const int ch = 2 * ((np & 3) ^ tq) + (gr >> 2);
    const float* p = row + (np >> 2) * slab;
    uint32_t bh0, bl0, bh1, bl1;
    split(p[ch << 2], bh0, bl0);
    split(p[kSlab + ((ch ^ 1) << 2)], bh1, bl1);
    if constexpr (FRESH)
      mma3_add(acc[np], ahi, alo, bh0, bh1, bl0, bl1);
    else
      mma3(acc[np], ahi, alo, bh0, bh1, bl0, bl1);
  }
}

// logits of a 16x16 product (the sum of dot_nt's two accumulators) times
// `scale`, keys (columns) at or past `lim` to -inf; `key0` the first column
__device__ __forceinline__ void logits(float (&x)[2][4], const float (&s)[2][2][4], float scale,
                                       int key0, int lim, int lane) {
  const int col = key0 + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      x[j][e] = col + 8 * j + (e & 1) < lim ? __fmul_rn(s[0][j][e] + s[1][j][e], scale)
                                            : -CUDART_INF_F;
}

// Store a warp's 16 x 8 HN fp32 tile times `scale` at rows r0 .. of dst (row
// stride D); rows >= L and columns >= ncols are dropped
template <int HN>
__device__ __forceinline__ void store_tile(float* dst, int D, int r0, int L, int ncols,
                                           const float (&acc)[HN][4], float scale, int lane) {
  const int gr = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int np = 0; np < HN; ++np) {
    const int col = np * 8 + 2 * tq;
    if (col >= ncols) continue;
    if (r0 + gr < L)
      *reinterpret_cast<float2*>(dst + (size_t)(r0 + gr) * D + col) =
          make_float2(acc[np][0] * scale, acc[np][1] * scale);
    if (r0 + gr + 8 < L)
      *reinterpret_cast<float2*>(dst + (size_t)(r0 + gr + 8) * D + col) =
          make_float2(acc[np][2] * scale, acc[np][3] * scale);
  }
}

// Zero the slabs `loaded` .. HN / 4 of `tiles` consecutive 16-row tiles
// (the columns past hd, which no copy writes); every thread of the block
template <int HN>
__device__ __forceinline__ void zero_unloaded(float* tiles, int n, int loaded) {
  constexpr int kTile = (HN / 4) * kRows * kSlab;
  const int per = (HN / 4 - loaded) * kRows * kSlab / 4;  // 16-byte units a tile
  for (int x = threadIdx.x; x < n * per; x += blockDim.x) {
    const int t = x / per;
    reinterpret_cast<float4*>(tiles + t * kTile + loaded * kRows * kSlab)[x - t * per] =
        make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// Blocks a head (`groups`) and warps a block for `tiles` 16-row tiles of
// each of `heads` heads, a warp a tile: the most warps, up to `most` and
// down to 2, that leave the fewest warps idle (9 tiles: 3 blocks of 3; 14:
// 7 of 2; an idle warp still waits at every chunk's barrier), then more
// blocks a head of fewer warps while the heads alone would give the card
// fewer than 2 blocks an SM (pipeline microbatches). A head's blocks each
// stream its other operands through their own ring, from L2.
struct Grid {
  int groups, warps;
};

inline Grid grid_for(int device, int heads, int tiles, int most) {
  int sm_count = 0, smem = 0;
  tma::device_limits(device, &sm_count, &smem);
  if (!sm_count) sm_count = 132;
  int warps = tiles < most ? tiles : most;
  for (int w = warps - 1; w >= 2; --w)
    if ((tiles + w - 1) / w * w - tiles < (tiles + warps - 1) / warps * warps - tiles) warps = w;
  int groups = (tiles + warps - 1) / warps;
  if ((long long)heads * groups < 2LL * sm_count) {
    const int want = (int)((2LL * sm_count + heads - 1) / heads);
    groups = want < tiles ? want : tiles;
    warps = (tiles + groups - 1) / groups;
  }
  return {(tiles + warps - 1) / warps, warps};
}

}  // namespace tf32
