// One pass for each GEMM epilogue of the CLIP tower's blocks at inference,
// sm_90a.
//
// Replaces no TPU kernel: on the TPU, XLA fuses the bias add, the bf16
// rounding, QuickGELU and the residual add into the products' epilogues.
// On the card each block's products write fp32 (torch.mm with out_dtype
// fp32, `ops/attention._MatmulF32`), and the ATen chain that takes them to
// the bf16 tensors their consumers read costs 17 memory passes a block:
// the broadcast bias add, the cast, QuickGELU's three kernels, the residual
// add. Here each chain is one pass, with the ATen chain's rounding points
// and its fp32 arithmetic, so the bits are the same (acc is the fp32
// product, x the bf16 residual stream, bf16() round to nearest even):
//
//   bias_cast      q, k, v in one launch: bf16(acc + bias)
//   bias_gelu      fc: y = bf16(acc + bias),
//                  bf16(y * bf16(1 / (1 + expf(-bf16(1.702f * y)))))
//   bias_residual  out-proj and c_proj: bf16(x + bf16(acc + bias))
//
// Each step is one IEEE fp32 operation rounded to nearest (the _rn
// intrinsics keep nvcc from contracting a multiply and an add into an
// FMA), and expf is the accurate one (no fast math), as ATen's kernels
// compute them; ATen's sigmoid is `1 / (1 + exp(-x))` in fp32 with an IEEE
// division. The reciprocal here is the IEEE one by a cheaper route: over
// [1, 2^126) one Newton step (two FMAs) from the hardware's approximate
// reciprocal, and the library's __frcp_rn, with its slow path, only for a
// group of 8 that holds a larger, infinite or NaN divisor (1/d subnormal
// or 0). y is a bf16 value, so d takes at most 2^16 values, and
// tests/test_torch_cuda.py runs bias_gelu against the ATen chain on every
// one. The division's own guard against such divisors, one branch an
// element, held bias_gelu at 79-80 % of its byte bound; this route at
// 81-83 %.
//
// Memory bounds them: about one operation per byte moved. At the gallery
// shape (49,536 rows of 768 or 3072) a pass moves 685 MB (q, k, v), 913 MB
// (fc) or 304 MB (each residual), read once and written once. The design,
// each choice timed on the card against its alternatives (PERF.md §6):
//   - a thread takes one group of 8 columns: two 16-byte loads of fp32 and
//     one 16-byte store of bf16 (one 16-byte load of the residual), with
//     neighbouring threads on neighbouring groups of a row;
//   - it keeps the group's 8 bias values in registers for the whole launch
//     and walks the rows, kUnroll rows' loads in flight before the first
//     compute;
//   - a block is 256 threads: up to 128 column groups by as many rows as
//     fill it; the grid is persistent: as many blocks as the card holds at
//     once (SMs x resident blocks an SM), shared evenly over the column
//     tiles (grid.y) and the launch's tensors (grid.z: q, k and v), each
//     block striding over the rows. One wave with no tail: 2-4 % faster
//     than a block for each segment of rows;
//   - the fp32 products are read and the bf16 outputs written with
//     streaming hints (each byte is touched once here): 2-3 % faster than
//     plain stores;
//   - each output rounds to bf16 once, in the pack of two values;
//   - rows and column groups past the ends are masked; nothing else is
//     written.
// Loads software-pipelined across rows, 2 or 8 rows in flight, 128 or 512
// threads a block, L2 prefetch hints and integer bf16 rounding were no
// faster. Every kernel's name holds `elementwise`, so a profile sorts them
// with the memory passes they replace.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;    // a block: column groups x rows
constexpr int kMaxGroups = 128;  // column groups of 8 a block spans
constexpr int kUnroll = 4;       // rows whose loads are in flight together

enum Op { kCast, kGelu, kResidual };

// up to three (product, bias, output) triples of one launch, picked by blockIdx.z
struct Tensors {
  const float* acc[3];
  const float* bias[3];
  __nv_bfloat16* out[3];
};

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
  const float4 b = __ldcs(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ float round_bf16(float f) {
  return __bfloat162float(__float2bfloat16_rn(f));
}

// 8 fp32 → 8 bf16, each rounded to nearest even, in memory order
__device__ __forceinline__ uint4 pack8(const float (&v)[8]) {
  uint4 out;
  uint32_t* w = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 two = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&two);
  }
  return out;
}

__device__ __forceinline__ void unpack8(const uint4& in, float (&v)[8]) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(&in);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 two = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = two.x;
    v[2 * i + 1] = two.y;
  }
}

// 1/d rounded to nearest, for 8 divisors d >= 1 (see the note at the top)
__device__ __forceinline__ void reciprocal8(const float (&d)[8], float (&r)[8]) {
  bool rare = false;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float r0;
    asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r0) : "f"(d[j]));
    r[j] = __fmaf_rn(__fmaf_rn(-d[j], r0, 1.0f), r0, r0);
    rare |= !(d[j] < 0x1p126f);
  }
  if (rare) {
#pragma unroll
    for (int j = 0; j < 8; ++j) r[j] = __frcp_rn(d[j]);
  }
}

// The epilogue of one row's 8 values in place: v the fp32 products → the
// outputs before their last rounding (pack8 rounds); b the bias, x the
// residual (kResidual only)
template <int OP>
__device__ __forceinline__ void epilogue8(float (&v)[8], const float (&b)[8], const uint4& x) {
  if (OP == kCast) {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = __fadd_rn(v[j], b[j]);
  } else if (OP == kResidual) {
    float xs[8];
    unpack8(x, xs);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = __fadd_rn(xs[j], round_bf16(__fadd_rn(v[j], b[j])));
  } else {
    // QuickGELU: y * sigmoid(1.702 y), rounded as the three ATen kernels round
    float d[8], s[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      v[j] = round_bf16(__fadd_rn(v[j], b[j]));
      d[j] = __fadd_rn(1.0f, expf(-round_bf16(__fmul_rn(1.702f, v[j]))));
    }
    reciprocal8(d, s);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = __fmul_rn(v[j], round_bf16(s[j]));
  }
}

template <int OP>
__device__ __forceinline__ void run(const Tensors& t, const __nv_bfloat16* __restrict__ res,
                                    int rows, int groups) {
  const int g = blockIdx.y * blockDim.x + threadIdx.x;  // this thread's column group
  if (g >= groups) return;
  const int z = blockIdx.z;
  const float* __restrict__ acc = t.acc[z];
  __nv_bfloat16* __restrict__ out = t.out[z];
  const size_t cols = static_cast<size_t>(groups) * 8;
  float b[8];
  {
    const float4* p = reinterpret_cast<const float4*>(t.bias[z] + 8 * g);
    const float4 lo = p[0], hi = p[1];
    b[0] = lo.x; b[1] = lo.y; b[2] = lo.z; b[3] = lo.w;
    b[4] = hi.x; b[5] = hi.y; b[6] = hi.z; b[7] = hi.w;
  }
  const int step = gridDim.x * blockDim.y;
#pragma unroll 1
  for (int base = blockIdx.x * blockDim.y + threadIdx.y; base < rows; base += kUnroll * step) {
    float v[kUnroll][8];
    uint4 x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = base + u * step;
      if (r < rows) {
        const size_t off = r * cols + 8 * g;
        load8(acc + off, v[u]);
        if (OP == kResidual) x[u] = __ldcs(reinterpret_cast<const uint4*>(res + off));
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = base + u * step;
      if (r < rows) {
        epilogue8<OP>(v[u], b, x[u]);
        __stcs(reinterpret_cast<uint4*>(out + r * cols + 8 * g), pack8(v[u]));
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
tower_bias_cast_elementwise_kernel(Tensors t, int rows, int groups) {
  run<kCast>(t, nullptr, rows, groups);
}

__global__ void __launch_bounds__(kThreads)
tower_bias_gelu_elementwise_kernel(Tensors t, int rows, int groups) {
  run<kGelu>(t, nullptr, rows, groups);
}

__global__ void __launch_bounds__(kThreads)
tower_bias_residual_elementwise_kernel(Tensors t, const __nv_bfloat16* res, int rows,
                                       int groups) {
  run<kResidual>(t, res, rows, groups);
}

// The launch of epilogue `op`'s kernel over rows x cols of n tensors:
// blocks of up to kMaxGroups column groups by as many rows as fill
// kThreads, and a persistent grid of as many blocks as the card holds at
// once, shared over the column tiles and the tensors (fewer when the rows
// run out). The blocks an SM holds are asked once for each kernel and
// block shape (the kernels are built for one architecture).
cudaError_t launch_shape(const void* kernel, int op, int rows, int cols, int n, dim3& grid,
                         dim3& block) {
  static std::atomic<int> held[3][kMaxGroups + 1];  // [op][bx]: blocks an SM, 0 unasked
  const int groups = cols / 8;
  const int bx = groups < kMaxGroups ? groups : kMaxGroups;
  const int by = kThreads / bx;
  const int tiles = (groups + bx - 1) / bx;
  int device = 0, sms = 0, resident = held[op][bx].load(std::memory_order_relaxed);
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess && resident == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel, bx * by, 0);
    held[op][bx].store(resident, std::memory_order_relaxed);
  }
  if (err != cudaSuccess) return err;
  const int fill = sms * resident / (tiles * n);
  const int need = (rows + by * kUnroll - 1) / (by * kUnroll);
  block = dim3(bx, by);
  grid = dim3(fill < 1 ? 1 : need < fill ? need : fill, tiles, n);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Every pointer is to contiguous, 16-byte aligned memory on the current
// device: acc [rows, cols] fp32 (q, k, v for bias_cast), bias [cols] fp32
// (bias_cast: q's, k's and v's packed, [3 cols], as nn.MultiheadAttention's
// in_proj_bias), x and out [rows, cols] bf16; cols % 8 == 0. Launches on
// `stream`; returns the first cudaError.

int tower_bias_cast(const float* q, const float* k, const float* v, const float* bias,
                    void* oq, void* ok, void* ov, int rows, int cols, void* stream) {
  if (rows == 0 || cols == 0) return 0;
  Tensors t = {{q, k, v}, {bias, bias + cols, bias + 2 * cols},
               {static_cast<__nv_bfloat16*>(oq), static_cast<__nv_bfloat16*>(ok),
                static_cast<__nv_bfloat16*>(ov)}};
  dim3 grid, block;
  cudaError_t err = launch_shape(
      reinterpret_cast<const void*>(tower_bias_cast_elementwise_kernel), kCast, rows, cols, 3,
      grid, block);
  if (err != cudaSuccess) return static_cast<int>(err);
  tower_bias_cast_elementwise_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      t, rows, cols / 8);
  return static_cast<int>(cudaGetLastError());
}

int tower_bias_gelu(const float* acc, const float* bias, void* out, int rows, int cols,
                    void* stream) {
  if (rows == 0 || cols == 0) return 0;
  Tensors t = {{acc}, {bias}, {static_cast<__nv_bfloat16*>(out)}};
  dim3 grid, block;
  cudaError_t err = launch_shape(
      reinterpret_cast<const void*>(tower_bias_gelu_elementwise_kernel), kGelu, rows, cols, 1,
      grid, block);
  if (err != cudaSuccess) return static_cast<int>(err);
  tower_bias_gelu_elementwise_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      t, rows, cols / 8);
  return static_cast<int>(cudaGetLastError());
}

int tower_bias_residual(const float* acc, const float* bias, const void* x, void* out,
                        int rows, int cols, void* stream) {
  if (rows == 0 || cols == 0) return 0;
  Tensors t = {{acc}, {bias}, {static_cast<__nv_bfloat16*>(out)}};
  dim3 grid, block;
  cudaError_t err = launch_shape(
      reinterpret_cast<const void*>(tower_bias_residual_elementwise_kernel), kResidual, rows,
      cols, 1, grid, block);
  if (err != cudaSuccess) return static_cast<int>(err);
  tower_bias_residual_elementwise_kernel<<<grid, block, 0,
                                           static_cast<cudaStream_t>(stream)>>>(
      t, static_cast<const __nv_bfloat16*>(x), rows, cols / 8);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
