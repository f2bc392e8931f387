// Hopper's asynchronous copy engine for the attention kernels, sm_90a:
// tensor maps over a head's column block, TMA loads (plain and multicast
// into a thread-block cluster) that complete on an mbarrier, the cluster
// barrier, and the 128-byte swizzle that TMA writes; and the launch helpers
// (device_limits, configure_once).
//
// A tile of rows is stored in slabs of kSlab = 64 bf16 columns (128 bytes,
// one row of the 128-byte swizzle): slab s holds columns 64 s .. 64 s + 63
// of every row, and the 16-byte chunk c of row r lies at chunk c ^ (r % 8)
// of that row. ldmatrix reads one 16-byte chunk of 8 consecutive rows per
// phase, so those 8 chunks fall in 8 distinct bank groups without padding.
// A slab starts at a multiple of 1024 bytes, where the swizzle's pattern
// starts.
//
// The tensor map is 4-D, {hd, H, L, B} innermost first, with a box of
// {64, 1, rows, 1}: one head's column block of `rows` tokens. Columns past
// hd and rows past L are outside the tensor, so the hardware writes zeros
// there: a head dim under 64 (8, 24) reads no column of the next head, and
// a box past the last token reads no token of the next batch row. The fp32
// kernels use the same layout with slabs of 32 floats (encode_heads_f32).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace tma {

using bf16 = __nv_bfloat16;

constexpr int kSlab = 64;  // columns of one slab: 128 bytes of bf16

// the element (r, c) of a swizzled tile whose slabs are `slab` elements
// apart; c is a multiple of 8 (the start of a 16-byte chunk)
__device__ __forceinline__ const bf16* swz(const bf16* tile, int slab, int r, int c) {
  return tile + (c >> 6) * slab + r * kSlab + ((((c >> 3) & 7) ^ (r & 7)) << 3);
}

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(saddr(bar)), "r"(count)
               : "memory");
}

// the barriers' initialisation, visible to the cluster's copies
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// arrive once and expect `bytes` more of copies in this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(saddr(bar)),
               "r"(bytes)
               : "memory");
}

// arrive once (release: this thread's shared-memory writes before it are
// visible to a thread whose wait sees the phase complete)
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(saddr(bar)) : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = saddr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// shared memory read by the threads, next written by a copy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// box {c0, c1, c2, c3} of `map` into this block's shared memory at dst
__device__ __forceinline__ void load_4d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                        int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(saddr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(saddr(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// the same box into the shared memory of every block of the cluster in
// `mask`, at dst's offset; each block's barrier at bar's offset counts its
// bytes
__device__ __forceinline__ void load_4d_multicast(void* dst, const CUtensorMap* map,
                                                  uint64_t* bar, uint16_t mask, int c0, int c1,
                                                  int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%4, %5, %6, %7}], [%2], %3;\n" ::"r"(saddr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(saddr(bar)), "h"(mask), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// `bytes` (a multiple of 16, both ends 16-byte aligned) from global src to
// this block's shared memory at dst, completing on bar
__device__ __forceinline__ void load_bulk(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(saddr(dst)), "l"(src), "r"(bytes), "r"(saddr(bar))
      : "memory");
}

__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}

// every thread of every block of the cluster
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// ---- host -----------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver function: reached through the
// runtime's entry point, so the library needs no -lcuda
inline EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D map {hd, H, L, B} of a [B, L, H * hd] tensor of `elt` bytes an
// element, box {box_cols, 1, rows, 1}, 128-byte swizzle, zeros outside.
// 16-byte row strides and a 16-byte aligned base. Returns a cudaError.
inline int encode_map(CUtensorMap* map, CUtensorMapDataType type, int elt, int box_cols,
                      const void* base, int B, int L, int H, int hd, int rows) {
  const EncodeTiled encode = encode_fn();
  if (!encode) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)H, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * elt, (cuuint64_t)H * hd * elt,
                                 (cuuint64_t)L * H * hd * elt};
  const cuuint32_t box[4] = {(cuuint32_t)box_cols, 1, (cuuint32_t)rows, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, type, 4, const_cast<void*>(base), dims, strides, box, step,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The map of a [B, L, H * hd] bf16 tensor as {hd, H, L, B}, box {64, 1,
// rows, 1}: slabs of kSlab columns. hd % 8 == 0.
inline int encode_heads(CUtensorMap* map, const void* base, int B, int L, int H, int hd,
                        int rows) {
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, kSlab, base, B, L, H, hd, rows);
}

// The same of an fp32 tensor, box {32, 1, rows, 1}: slabs of 32 floats,
// also 128 bytes (tf32::kSlab). hd % 4 == 0.
inline int encode_heads_f32(CUtensorMap* map, const void* base, int B, int L, int H, int hd,
                            int rows) {
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, 32, base, B, L, H, hd, rows);
}

// Launch helpers every kernel of the port shares.
//
// The SMs of `device` and the most dynamic shared memory a block may opt
// into there, read once a device
inline void device_limits(int device, int* sms, int* smem) {
  static int cache[64][2] = {};
  int local[2] = {0, 0};
  int* c = device >= 0 && device < 64 ? cache[device] : local;
  if (!c[0]) {
    cudaDeviceGetAttribute(&c[0], cudaDevAttrMultiProcessorCount, device);
    cudaDeviceGetAttribute(&c[1], cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  }
  *sms = c[0];
  *smem = c[1];
}

// Once a kernel (by its address: each instance of a template apart) and
// device: the most dynamic shared memory the device allows, returned in
// *limit. Launches then set nothing. (The shared-memory carveout is left to
// the driver: setting it to the most measured no faster.)
inline cudaError_t configure_once(const void* kernel, int device, int* limit) {
  constexpr int kSlots = 16;
  static const void* done[64][kSlots] = {};
  int sms = 0;
  device_limits(device, &sms, limit);
  const bool cached = device >= 0 && device < 64;
  if (cached)
    for (int i = 0; i < kSlots && done[device][i]; ++i)
      if (done[device][i] == kernel) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *limit);
  if (err == cudaSuccess && cached)
    for (int i = 0; i < kSlots; ++i)
      if (!done[device][i]) {
        done[device][i] = kernel;
        break;
      }
  return err;
}

}  // namespace tma
