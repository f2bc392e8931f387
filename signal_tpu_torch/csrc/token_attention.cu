// T2T's token attention forward, sm_90a: one head of 64 in fp32,
//
//   o = softmax((q . s) . k^T) . v,   q [B, Lq, 64], k, v [B, Lk, 64],
//
// fp32 in and out, fp32-accurate, any Lq and Lk. It replaces no TPU
// kernel: the JAX package leaves this attention to XLA
// (signal_tpu/models/t2t.py, token_transformer). It was added because the
// eager fp32 core (ops/token_attention.py) writes the [B, Lq, Lk] logits
// and probabilities to device memory and reads them back: about 26 GB at
// the gallery batch's [384, 2048, 64], where q, k, v and o are 0.8 GB.
//
// The bound. A launch does 4 . B . Lq . Lk . 64 operations (4.12e11 at
// [384, 2048, 64]) on 4 . 64 . 4 . B . L bytes (0.8 GB): about 500
// operations a byte, above the card's ridge, so the tensor cores bound it.
// fp32 accuracy costs three TF32 products for each (3xTF32, mma_tf32.cuh:
// a = hi + lo, a.b = lo.hi' + hi.lo' + hi.hi'), so the least time is the
// operations at 495/3 TFLOP/s: 2.50 ms at [384, 2048, 64].
//
// The design (the hopper-kernels guide's shape):
//   - a block takes 128 query rows of one batch row: two consumer
//     warpgroups of 64 rows each, and a staging warpgroup;
//   - q is read once, by TMA, scaled by s in fp32 (as the eager core
//     does), split into hi and lo in shared memory by the consumers;
//   - K and V stream by TMA in tiles of 64 keys through a ring of two
//     stages, straight from the strided views of the qkv product (row
//     stride 192 floats: no copy). The staging warpgroup splits each tile
//     for the tensor cores: K in place into hi plus a lo tile; V
//     transposed (tf32 operands are K-major only, and P.V contracts over
//     the keys) into hi and lo tiles whose keys run in the permuted order
//     of mma_tf32.cuh within each 8, so that the accumulators of S are the
//     A fragments of P.V with no shuffle. One of its threads issues the
//     copies, each tile once the consumers have released its stage;
//   - S = Q.K^T is 24 warpgroup products m64n64k8 from shared memory, P.V
//     24 more with P from registers. The tensor core truncates as it
//     accumulates, so each product runs as two chains into fresh
//     accumulators (halves of the head dim for S, of the tile's keys for
//     P.V), each the small products lo.hi' and hi.lo' first, then hi.hi',
//     added on the CUDA cores: one chain of 8 large steps read up to
//     2.0e-6 from float64 at 2,048 keys, two read 1.3e-6 (the fp32 eager
//     core 3.2e-6);
//   - the softmax is online in fp32: per row a running max m and sum l, e
//     = expf(x - m), the output rescaled by expf(m_old - m) as each tile
//     arrives, on the CUDA cores (o = o . alpha + P.V, one rounding), and
//     divided by l at the end;
//   - no [Lq, Lk] tensor exists anywhere: q, k, v are read once from
//     device memory (k and v once a block, from L2 after the first of a
//     batch row's blocks) and o is written once.
// Measured (H100 SXM, PERF.md §6): 4.1-4.2 ms at [384, 2048, 64], about
// 60 % of the bound, 0.32-0.34 ms at [384, 512, 64]; 135 registers, no
// spills. Sums are taken in one fixed order with no atomics: two launches
// on the same inputs give the same bits.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kHd = 64;                    // the head dim, the only one
constexpr int kKeys = 64;                  // keys of a tile
constexpr int kWgRows = 64;                // query rows of a consumer warpgroup
constexpr int kConsumers = 2;              // consumer warpgroups a block
constexpr int kRows = kConsumers * kWgRows;  // query rows a block
constexpr int kStages = 2;                 // tiles of the ring
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kSlabF = tf32::kSlab;        // floats of a slab row (128 bytes)
constexpr int kTileSlab = kKeys * kSlabF;  // floats of a slab of a 64-row tile
constexpr int kTileF = 2 * kTileSlab;      // floats of a 64 x 64 tile
constexpr int kQSlab = kRows * kSlabF;     // floats of a slab of the block's Q
constexpr int kStageF = 4 * kTileF;        // K hi, K lo, V hi, V lo

// Shared memory, dynamic and 1024-aligned by hand: Q hi and lo [2 slabs]
// [128 rows][32], the ring's stages, then the barriers.
constexpr size_t kSmemBytes =
    1024 + (2 * 2 * kQSlab + kStages * kStageF) * sizeof(float) + 14 * sizeof(uint64_t);

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void split4(float4 x, float4& hi, float4& lo) {
  uint32_t h, l;
  tf32::split(x.x, h, l);
  hi.x = __uint_as_float(h), lo.x = __uint_as_float(l);
  tf32::split(x.y, h, l);
  hi.y = __uint_as_float(h), lo.y = __uint_as_float(l);
  tf32::split(x.z, h, l);
  hi.z = __uint_as_float(h), lo.z = __uint_as_float(l);
  tf32::split(x.w, h, l);
  hi.w = __uint_as_float(h), lo.w = __uint_as_float(l);
}

__device__ __forceinline__ float part(const float4& x, int i) {
  return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}

// The staging warpgroup's share of V's tile (t = its thread, 0 .. 127):
// two units, each the 4 keys 8 g + 2 m + par (m < 4) of one group g of 8
// and 4 columns 4 dc .. 4 dc + 3. Read as 4 float4 of the tile [key][col],
// they are written as 4 float4 of the transposed tile [col][key], the 4
// keys being positions 4 par .. 4 par + 3 of their group in the permuted
// order (key 2 i sits at i, key 2 i + 1 at 4 + i). Within a phase of 8
// lanes (par = lane % 2, u = lane % 8 / 2) the groups (u + r) % 4 and the
// column chunks dc0 + 2 u make both the reads and the writes fall in 8
// distinct 16-byte bank groups of the swizzle.
struct VUnit {
  int key, dc, row_chunk;  // the first key, the column chunk, the chunk in a transposed row
  int slab;                // the transposed tile's slab (keys 32 slab ..)
};

__device__ __forceinline__ VUnit v_unit(int t, int unit) {
  const int lane8 = t & 7, par = lane8 & 1, u = lane8 >> 1;
  const int pg = (t >> 3) + 16 * unit;  // 0 .. 31
  const int r = pg & 3, db = (pg >> 2) & 3, slab = pg >> 4;
  const int g4 = (u + r) & 3;
  const int dc = (db & 1) + 8 * (db >> 1) + 2 * u;
  return {32 * slab + 8 * g4 + par, dc, 2 * g4 + par, slab};
}

// One block: 128 query rows (q0 ..) of batch row b. Warps 0-3 and 4-7 are
// the consumer warpgroups, warps 8-11 the staging one.
__global__ void __launch_bounds__(kThreads, 1)
token_attention_fwd_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap, float* __restrict__ o,
                           int Lq, int Lk, float scale, int qblocks) {
  extern __shared__ unsigned char smem_raw[];
  float* Qhi =
      reinterpret_cast<float*>(smem_raw + ((1024 - (tma::saddr(smem_raw) & 1023)) & 1023));
  float* Qlo = Qhi + 2 * kQSlab;
  float* ring = Qlo + 2 * kQSlab;
  uint64_t* qfull = reinterpret_cast<uint64_t*>(ring + kStages * kStageF);
  uint64_t* kfull = qfull + kConsumers;
  uint64_t* vfull = kfull + kStages;
  uint64_t* kready = vfull + kStages;
  uint64_t* vready = kready + kStages;
  uint64_t* kempty = vready + kStages;
  uint64_t* vempty = kempty + kStages;

  const int b = blockIdx.x / qblocks;
  const int q0 = (blockIdx.x - b * qblocks) * kRows;
  const int n = (Lk + kKeys - 1) / kKeys;  // key tiles
  const int wgi = threadIdx.x >> 7, t = threadIdx.x & 127;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kConsumers; ++i) tma::mbar_init(qfull + i, 1);
    for (int i = 0; i < kStages; ++i) {
      tma::mbar_init(kfull + i, 1);
      tma::mbar_init(vfull + i, 1);
      tma::mbar_init(kready + i, 128);
      tma::mbar_init(vready + i, 128);
      tma::mbar_init(kempty + i, 4 * kConsumers);
      tma::mbar_init(vempty + i, 4 * kConsumers);
    }
    tma::fence_barrier_init();
  }
  __syncthreads();

  if (wgi == kConsumers) {
    // ---- staging warpgroup ----------------------------------------------
    auto issue = [&](const CUtensorMap* map, uint64_t* bar, float* dst, int tile) {
      tma::mbar_expect_tx(bar, (uint32_t)(kTileF * sizeof(float)));
      for (int s = 0; s < 2; ++s)
        tma::load_4d(dst + s * kTileSlab, map, bar, s * kSlabF, 0, tile * kKeys, b);
    };
    if (t == 0) {
      for (int w = 0; w < kConsumers; ++w) {
        tma::mbar_expect_tx(qfull + w, (uint32_t)(2 * kWgRows * kSlabF * sizeof(float)));
        for (int s = 0; s < 2; ++s)
          tma::load_4d(Qhi + s * kQSlab + w * kWgRows * kSlabF, &qmap, qfull + w, s * kSlabF, 0,
                       q0 + w * kWgRows, b);
      }
      issue(&kmap, kfull, ring, 0);
      issue(&vmap, vfull, ring + 2 * kTileF, 0);
    }
    __syncwarp();
    for (int c = 0; c < n; ++c) {
      const int st = c & 1, ph = (c >> 1) & 1;
      float* Kh = ring + st * kStageF;
      float* Kl = Kh + kTileF;
      float* Vh = Kl + kTileF;
      float* Vl = Vh + kTileF;
      // K: hi in place, lo beside it (the same swizzled positions)
      tma::mbar_wait(kfull + st, ph);
#pragma unroll
      for (int j = 0; j < kTileF / 4 / 128; ++j) {
        float4* p = reinterpret_cast<float4*>(Kh) + t + 128 * j;
        float4 hi, lo;
        split4(*p, hi, lo);
        *p = hi;
        reinterpret_cast<float4*>(Kl)[t + 128 * j] = lo;
      }
      tma::fence_proxy_async();  // these writes, before the products read them
      tma::mbar_arrive(kready + st);
      // V: read all of this thread's share, then (once the warpgroup has
      // read the tile) write it transposed, hi over the tile and lo beside
      tma::mbar_wait(vfull + st, ph);
      float4 x[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const VUnit vu = v_unit(t, u);
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int key = vu.key + 2 * m;
          x[u][m] = *reinterpret_cast<const float4*>(
              Vh + (vu.dc >> 3) * kTileSlab + key * kSlabF + (((vu.dc & 7) ^ (key & 7)) << 2));
        }
      }
      named_sync(1);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const VUnit vu = v_unit(t, u);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = 4 * vu.dc + i;
          float4 hi, lo;
          split4(make_float4(part(x[u][0], i), part(x[u][1], i), part(x[u][2], i),
                             part(x[u][3], i)),
                 hi, lo);
          const int at = vu.slab * kTileSlab + col * kSlabF + ((vu.row_chunk ^ (col & 7)) << 2);
          *reinterpret_cast<float4*>(Vh + at) = hi;
          *reinterpret_cast<float4*>(Vl + at) = lo;
        }
      }
      tma::fence_proxy_async();
      tma::mbar_arrive(vready + st);
      // the next tile, into the other stage once the consumers are done
      // with the tile before this one: K once its logits are formed, V once
      // its products are
      if (t == 0 && c + 1 < n) {
        const int sn = st ^ 1, pn = ((c - 1) >> 1) & 1;
        float* dst = ring + sn * kStageF;
        if (c >= 1) {
          tma::mbar_wait(kempty + sn, pn);
          tma::fence_proxy_async();
        }
        issue(&kmap, kfull + sn, dst, c + 1);
        if (c >= 1) {
          tma::mbar_wait(vempty + sn, pn);
          tma::fence_proxy_async();
        }
        issue(&vmap, vfull + sn, dst + 2 * kTileF, c + 1);
      }
      __syncwarp();
    }
    return;
  }

  // ---- consumer warpgroup wgi: query rows q0 + 64 wgi .. ------------------
  const int warp = (threadIdx.x >> 5) & 3;
  float* Qh = Qhi + wgi * kWgRows * kSlabF;
  float* Ql = Qlo + wgi * kWgRows * kSlabF;
  // q . s in fp32, then split into hi and lo
  tma::mbar_wait(qfull + wgi, 0);
#pragma unroll
  for (int j = 0; j < 2 * kWgRows * kSlabF / 4 / 128; ++j) {
    const int i = t + 128 * j;  // float4 of the warpgroup's rows: slab i / 512
    const int at = (i >> 9) * kQSlab + ((i & 511) << 2);
    float4 x = *reinterpret_cast<const float4*>(Qh + at);
    x = make_float4(__fmul_rn(x.x, scale), __fmul_rn(x.y, scale), __fmul_rn(x.z, scale),
                    __fmul_rn(x.w, scale));
    float4 hi, lo;
    split4(x, hi, lo);
    *reinterpret_cast<float4*>(Qh + at) = hi;
    *reinterpret_cast<float4*>(Ql + at) = lo;
  }
  tma::fence_proxy_async();
  named_sync(2 + wgi);

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
  // a k-step (8 columns, 32 bytes) of a 64-row operand: its slab, then 32
  // bytes into the swizzle's atom
  auto at_q = [](const float* Q, int kk) {
    return wg::desc(Q + (kk >> 2) * kQSlab + (kk & 3) * 8, 16, 1024);
  };
  auto at_t = [](const float* T, int kk) {
    return wg::desc(T + (kk >> 2) * kTileSlab + (kk & 3) * 8, 16, 1024);
  };

  for (int c = 0; c < n; ++c) {
    const int st = c & 1, ph = (c >> 1) & 1;
    const float* Kh = ring + st * kStageF;
    const float* Kl = Kh + kTileF;
    const float* Vh = Kl + kTileF;
    const float* Vl = Vh + kTileF;

    // S = (Q . s) . K^T in two chains, columns 0-31 and 32-63 of the head
    // dim, each the small products first, then hi . hi', added on the CUDA
    // cores
    float s[8][4], s2[8][4];
    tma::mbar_wait(kready + st, ph);
    wg::fence_regs(s);
    wg::fence_regs(s2);
    wg::fence();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float(&d)[8][4] = h ? s2 : s;
#pragma unroll
      for (int kk = 4 * h; kk < 4 * h + 4; ++kk)
        wg::mma_ss_tf32(d, at_q(Ql, kk), at_t(Kh, kk), kk > 4 * h);
#pragma unroll
      for (int kk = 4 * h; kk < 4 * h + 4; ++kk) wg::mma_ss_tf32(d, at_q(Qh, kk), at_t(Kl, kk), 1);
#pragma unroll
      for (int kk = 4 * h; kk < 4 * h + 4; ++kk) wg::mma_ss_tf32(d, at_q(Qh, kk), at_t(Kh, kk), 1);
    }
    wg::commit();
    wg::wait_all();
    wg::fence_regs(s);
    wg::fence_regs(s2);
    __syncwarp();
    if (lane == 0) tma::mbar_arrive(kempty + st);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] += s2[j][e];

    // keys past Lk (the last tile's) to -inf
    const int key0 = c * kKeys;
    if (key0 + kKeys > Lk) {
      const int lim = Lk - key0 - 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = j * 8 + (e & 1) < lim ? s[j][e] : -CUDART_INF_F;
    }
    // the online softmax: rows gr (i = 0) and gr + 8 (i = 1) of the warp
    float alpha[2], cm[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) cm[e >> 1] = fmaxf(cm[e >> 1], s[j][e]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float mn = fmaxf(m[i], mma::quad_max(cm[i]));
      alpha[i] = expf(m[i] - mn);  // 0 on the first tile
      m[i] = mn;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m[e >> 1]);
        sum[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = fmaf(l[i], alpha[i], sum[i]);

    // O = O . alpha + P.V, in two halves of the keys (32 each), each into a
    // fresh accumulator (the small products first) added on the CUDA cores
    tma::mbar_wait(vready + st, ph);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // the C fragment (p0, p1, p2, p3) of n-tile j is the A fragment (p0,
      // p2, p1, p3) of k-step j, its keys in the permuted order
      uint32_t phi[4][4], plo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float(&p)[4] = s[4 * h + kk];
        tf32::split(p[0], phi[kk][0], plo[kk][0]);
        tf32::split(p[2], phi[kk][1], plo[kk][1]);
        tf32::split(p[1], phi[kk][2], plo[kk][2]);
        tf32::split(p[3], phi[kk][3], plo[kk][3]);
      }
      float pv[8][4];
      wg::fence_regs(pv);
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wg::mma_rs_tf32(pv, plo[kk], at_t(Vh, 4 * h + kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wg::mma_rs_tf32(pv, phi[kk], at_t(Vl, 4 * h + kk), 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wg::mma_rs_tf32(pv, phi[kk], at_t(Vh, 4 * h + kk), 1);
      wg::commit();
      wg::wait_all();
      wg::fence_regs(pv);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[j][e] = h ? acc[j][e] + pv[j][e] : fmaf(acc[j][e], alpha[e >> 1], pv[j][e]);
    }
    __syncwarp();
    if (lane == 0) tma::mbar_arrive(vempty + st);
  }

  const float lt[2] = {mma::quad_sum(l[0]), mma::quad_sum(l[1])};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = acc[j][e] / lt[e >> 1];
  tf32::store_tile<8>(o + (size_t)b * Lq * kHd, kHd, q0 + wgi * kWgRows + warp * 16, Lq, kHd, acc,
                      1.f, lane);
}

// The map of an fp32 [B, L, 64] view with row stride `row` and batch
// stride `batch` (floats), as the port's 4-D maps are laid out: {64, 1, L,
// B}, box {32, 1, 64, 1}, the 128-byte swizzle, zeros outside
int encode_view(CUtensorMap* map, const void* base, int B, int L, long long row,
                long long batch) {
  const tma::EncodeTiled encode = tma::encode_fn();
  if (!encode) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)kHd, 1, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)row * 4, (cuuint64_t)row * 4,
                                 (cuuint64_t)batch * 4};
  const cuuint32_t box[4] = {(cuuint32_t)kSlabF, 1, (cuuint32_t)kKeys, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(base), dims,
                            strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q [B, Lq, 64], k and v [B, Lk, 64], fp32, last stride 1, each with its
// own row and batch strides (floats; multiples of 4, 16-byte aligned
// bases); o [B, Lq, 64] contiguous. Launches on `stream`; returns the first
// cudaError.
int token_attention_fwd(const void* q, const void* k, const void* v, void* o, int B, int Lq,
                        int Lk, long long q_row, long long q_batch, long long k_row,
                        long long k_batch, long long v_row, long long v_batch, float scale,
                        void* stream) {
  if (B <= 0 || Lq <= 0 || Lk <= 0) return (int)cudaErrorInvalidValue;
  CUtensorMap qm, km, vm;
  int err = encode_view(&qm, q, B, Lq, q_row, q_batch);
  if (!err) err = encode_view(&km, k, B, Lk, k_row, k_batch);
  if (!err) err = encode_view(&vm, v, B, Lk, v_row, v_batch);
  if (err) return err;
  int device = 0, limit = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = tma::configure_once(reinterpret_cast<const void*>(token_attention_fwd_kernel), device,
                            &limit);
  if (e != cudaSuccess) return (int)e;
  if ((size_t)limit < kSmemBytes) return (int)cudaErrorInvalidValue;
  const int qblocks = (Lq + kRows - 1) / kRows;
  token_attention_fwd_kernel<<<(unsigned)(B * qblocks), kThreads, kSmemBytes,
                               static_cast<cudaStream_t>(stream)>>>(qm, km, vm,
                                                                   static_cast<float*>(o), Lq,
                                                                   Lk, scale, qblocks);
  return (int)cudaGetLastError();
}

}  // extern "C"
