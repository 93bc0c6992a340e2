// BatchNorm moments (kernels K2 and K2b of the port).
//
// K2 replaces the Pallas kernel mmhand_tpu/ops/bn_stats.py:87
// `_moments_kernel` (reached through `_sums_2d_pallas`): per-channel f32
// (sum x, sum x^2) over the (N = B*H*W, C) row-major view of a channels_last
// activation.  The Pallas grid carries the sums from one row tile to the next
// in a revisited output block; Hopper's blocks run in no order and carry
// nothing, so the reduction is split in two passes:
//
//   pass 1: a grid of (row chunks x channel tiles).  Each thread loads 16
//           bytes (8 bf16 or 4 f32 channels) per row, neighbouring threads on
//           neighbouring addresses, and accumulates in f32 registers; the
//           block then sums its rows in shared memory in a fixed order and
//           writes one (2, C) partial per chunk to an f32 scratch.
//   pass 2: one small kernel sums the chunks' partials in a fixed order.
//
// No atomics, so the result is the same from run to run.  Channels that are
// not a multiple of the vector width, or a misaligned base, take a masked
// scalar load.
//
// K2b is the backward of the same custom_vjp (mmhand_tpu/ops/bn_stats.py:73-77
// `_sums_2d_bwd`): dx = g1[c] + 2 g2[c] x[m, c] in f32, stored in x's type,
// one elementwise pass with 16-byte loads and stores.  The products and the
// sum are rounded one at a time (no FMA), in the order the plain version
// takes, so K2b equals it bit for bit.
//
// What bounds them: HBM bytes.  K2 reads x once (134 MB at the largest site
// of the train step, (16, 64, 256, 256) bf16: >= 0.040 ms at 3.35 TB/s) and
// does 3 f32 operations per element; K2b reads x and writes dx.  The design
// keeps every load 16 bytes wide and coalesced, puts four blocks of 256
// threads on each SM so enough loads are in flight, and keeps pass 2 to a
// few microseconds by bounding the number of chunks.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kVecBytes = 16;
constexpr int kMaxLanes = 64;      // a channel tile is at most 64 vectors wide
constexpr int kBlocksPerSm = 4;    // pass-1 blocks in flight on each SM
constexpr int kFinishCols = 32;    // pass 2: columns per block
constexpr int kFinishLanes = 32;   // pass 2: chunk lanes per block

enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <>
__device__ __forceinline__ float to_f32<__half>(__half v) {
  return __half2float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

// How a (N, C) view is cut: `lanes` threads of a block sit across a tile of
// lanes * vec channels, kThreads / lanes rows at a time.
struct Plan {
  int vec;
  int lanes;
  int rows_per_iter;
  int ctiles;
  int64_t chunks;
  int64_t rows_per_chunk;
};

// SMs of the first device asked; the plan only sizes the grid, so another
// card in the same process is served right, if less evenly.
int sm_count() {
  static const int sms = [] {
    int device = 0;
    int count = 132;
    if (cudaGetDevice(&device) == cudaSuccess) {
      cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device);
    }
    return count;
  }();
  return sms;
}

Plan make_plan(int64_t n, int c, int elem_bytes) {
  Plan p;
  p.vec = kVecBytes / elem_bytes;
  const int vectors = (c + p.vec - 1) / p.vec;
  p.lanes = 1;
  while (p.lanes < vectors && p.lanes < kMaxLanes) p.lanes *= 2;
  p.rows_per_iter = kThreads / p.lanes;
  p.ctiles = (c + p.lanes * p.vec - 1) / (p.lanes * p.vec);
  if (n == 0) {
    p.chunks = 0;
    p.rows_per_chunk = 1;
    return p;
  }
  const int64_t target = (int64_t(kBlocksPerSm) * sm_count() + p.ctiles - 1) / p.ctiles;
  const int64_t most = (n + p.rows_per_iter - 1) / p.rows_per_iter;
  const int64_t chunks = target < most ? target : most;
  p.rows_per_chunk = (n + chunks - 1) / chunks;
  p.chunks = (n + p.rows_per_chunk - 1) / p.rows_per_chunk;
  return p;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % kVecBytes == 0;
}

// Pass 1: block (chunk, channel tile) -> partial[chunk] = (sum, sum_sq) over
// its rows, for its channels.
template <typename T, bool kVector>
__global__ void __launch_bounds__(kThreads)
bn_sums_partial_kernel(const T* __restrict__ x, float* __restrict__ partial,
                       int64_t n, int c, int lanes, int64_t rows_per_chunk) {
  constexpr int kVec = kVecBytes / sizeof(T);
  __shared__ float shared[2 * kThreads * kVec];
  const int lane = threadIdx.x % lanes;
  const int row0 = threadIdx.x / lanes;
  const int rows_per_iter = kThreads / lanes;
  const int tile_w = lanes * kVec;
  const int tile_c0 = blockIdx.y * tile_w;
  const int c0 = tile_c0 + lane * kVec;
  const int64_t m_begin = blockIdx.x * rows_per_chunk;
  const int64_t m_end =
      m_begin + rows_per_chunk < n ? m_begin + rows_per_chunk : n;

  float s1[kVec], s2[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    s1[j] = 0.0f;
    s2[j] = 0.0f;
  }
  if (c0 < c) {
    if (kVector) {  // c % kVec == 0 and x 16-byte aligned
#pragma unroll 4
      for (int64_t m = m_begin + row0; m < m_end; m += rows_per_iter) {
        const uint4 raw = __ldg(reinterpret_cast<const uint4*>(x + m * c + c0));
        const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const float f = to_f32(v[j]);
          s1[j] += f;
          s2[j] = fmaf(f, f, s2[j]);
        }
      }
    } else {
      for (int64_t m = m_begin + row0; m < m_end; m += rows_per_iter) {
        const T* row = x + m * c;
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          if (c0 + j < c) {
            const float f = to_f32(row[c0 + j]);
            s1[j] += f;
            s2[j] = fmaf(f, f, s2[j]);
          }
        }
      }
    }
  }

  // rows of the block -> one value per channel, summed in row order
  float* sh1 = shared;
  float* sh2 = shared + rows_per_iter * tile_w;
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    sh1[row0 * tile_w + lane * kVec + j] = s1[j];
    sh2[row0 * tile_w + lane * kVec + j] = s2[j];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < tile_w; t += kThreads) {
    const int ch = tile_c0 + t;
    if (ch >= c) continue;
    float a = 0.0f, b = 0.0f;
    for (int r = 0; r < rows_per_iter; ++r) {
      a += sh1[r * tile_w + t];
      b += sh2[r * tile_w + t];
    }
    float* out = partial + blockIdx.x * int64_t(2) * c;
    out[ch] = a;
    out[c + ch] = b;
  }
}

// Pass 2: out[col] = sum over chunks of partial[chunk][col], col < 2C, each
// thread summing every kFinishLanes-th chunk, then the lanes in order.
__global__ void __launch_bounds__(kFinishCols * kFinishLanes)
bn_sums_finish_kernel(const float* __restrict__ partial,
                      float* __restrict__ out, int64_t chunks, int width) {
  __shared__ float shared[kFinishLanes][kFinishCols + 1];
  const int col = blockIdx.x * kFinishCols + threadIdx.x;
  float a = 0.0f;
  if (col < width) {
#pragma unroll 4
    for (int64_t k = threadIdx.y; k < chunks; k += kFinishLanes) {
      a += __ldg(partial + k * width + col);
    }
  }
  shared[threadIdx.y][threadIdx.x] = a;
  __syncthreads();
  if (threadIdx.y == 0 && col < width) {
    float s = 0.0f;
    for (int r = 0; r < kFinishLanes; ++r) s += shared[r][threadIdx.x];
    out[col] = s;
  }
}

// K2b: dx[m, c] = g1[c] + (2 g2[c]) x[m, c], each operation rounded alone.
template <typename T, bool kVector>
__global__ void __launch_bounds__(kThreads)
bn_sums_backward_kernel(const T* __restrict__ x, const float* __restrict__ g1,
                        const float* __restrict__ g2, T* __restrict__ dx,
                        int64_t n, int c, int lanes) {
  constexpr int kVec = kVecBytes / sizeof(T);
  const int lane = threadIdx.x % lanes;
  const int row0 = threadIdx.x / lanes;
  const int rows_per_iter = kThreads / lanes;
  const int c0 = blockIdx.y * lanes * kVec + lane * kVec;
  if (c0 >= c) return;
  float a[kVec], b[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const bool in = c0 + j < c;
    a[j] = in ? __ldg(g1 + c0 + j) : 0.0f;
    b[j] = in ? __fmul_rn(2.0f, __ldg(g2 + c0 + j)) : 0.0f;
  }
  const int64_t stride = int64_t(gridDim.x) * rows_per_iter;
  for (int64_t m = int64_t(blockIdx.x) * rows_per_iter + row0; m < n;
       m += stride) {
    if (kVector) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(x + m * c + c0));
      const T* v = reinterpret_cast<const T*>(&raw);
      uint4 packed;
      T* o = reinterpret_cast<T*>(&packed);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        o[j] = from_f32<T>(__fadd_rn(a[j], __fmul_rn(b[j], to_f32(v[j]))));
      }
      *reinterpret_cast<uint4*>(dx + m * c + c0) = packed;
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        if (c0 + j < c) {
          const int64_t e = m * c + c0 + j;
          dx[e] = from_f32<T>(__fadd_rn(a[j], __fmul_rn(b[j], to_f32(x[e]))));
        }
      }
    }
  }
}

template <typename T>
int launch_sums(const void* x, int64_t n, int c, float* partial, float* out,
                cudaStream_t stream) {
  const Plan p = make_plan(n, c, sizeof(T));
  if (p.chunks > 0) {
    const dim3 grid(static_cast<unsigned int>(p.chunks), p.ctiles);
    const T* xt = static_cast<const T*>(x);
    if (c % p.vec == 0 && aligned16(x)) {
      bn_sums_partial_kernel<T, true><<<grid, kThreads, 0, stream>>>(
          xt, partial, n, c, p.lanes, p.rows_per_chunk);
    } else {
      bn_sums_partial_kernel<T, false><<<grid, kThreads, 0, stream>>>(
          xt, partial, n, c, p.lanes, p.rows_per_chunk);
    }
  }
  const int width = 2 * c;
  const dim3 block(kFinishCols, kFinishLanes);
  bn_sums_finish_kernel<<<(width + kFinishCols - 1) / kFinishCols, block, 0,
                          stream>>>(partial, out, p.chunks, width);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_backward(const void* x, const float* g1, const float* g2, void* dx,
                    int64_t n, int c, cudaStream_t stream) {
  const Plan p = make_plan(n, c, sizeof(T));
  if (n == 0) return static_cast<int>(cudaSuccess);
  const int64_t most = (n + p.rows_per_iter - 1) / p.rows_per_iter;
  const int64_t want = (int64_t(kBlocksPerSm) * 2 * sm_count() + p.ctiles - 1) / p.ctiles;
  const dim3 grid(static_cast<unsigned int>(want < most ? want : most), p.ctiles);
  const T* xt = static_cast<const T*>(x);
  T* dxt = static_cast<T*>(dx);
  if (c % p.vec == 0 && aligned16(x) && aligned16(dx)) {
    bn_sums_backward_kernel<T, true><<<grid, kThreads, 0, stream>>>(
        xt, g1, g2, dxt, n, c, p.lanes);
  } else {
    bn_sums_backward_kernel<T, false><<<grid, kThreads, 0, stream>>>(
        xt, g1, g2, dxt, n, c, p.lanes);
  }
  return static_cast<int>(cudaGetLastError());
}

int elem_bytes(int dtype) { return dtype == kF32 ? 4 : 2; }

}  // namespace

// Floats of scratch that mmhand_bn_sums needs for (n, c) of this dtype
// (0 f32, 1 bf16, 2 f16); -1 for an unknown dtype.
extern "C" int64_t mmhand_bn_sums_scratch(int64_t n, int c, int dtype) {
  if (dtype != kF32 && dtype != kBF16 && dtype != kF16) return -1;
  return make_plan(n, c, elem_bytes(dtype)).chunks * 2 * c;
}

// x: (n, c) row-major on the device; partial: mmhand_bn_sums_scratch floats;
// out: (2, c) f32, (sum, sum_sq).  Launches on `stream` and returns
// cudaGetLastError() (0 on success); it does not synchronise.
extern "C" int mmhand_bn_sums(const void* x, int dtype, int64_t n, int c,
                              float* partial, float* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch_sums<float>(x, n, c, partial, out, s);
    case kBF16: return launch_sums<__nv_bfloat16>(x, n, c, partial, out, s);
    case kF16: return launch_sums<__half>(x, n, c, partial, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// x, dx: (n, c) row-major of one dtype; g1, g2: (c,) f32.  Launches on
// `stream` and returns cudaGetLastError(); it does not synchronise.
extern "C" int mmhand_bn_sums_backward(const void* x, int dtype,
                                       const float* g1, const float* g2,
                                       void* dx, int64_t n, int c,
                                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch_backward<float>(x, g1, g2, dx, n, c, s);
    case kBF16: return launch_backward<__nv_bfloat16>(x, g1, g2, dx, n, c, s);
    case kF16: return launch_backward<__half>(x, g1, g2, dx, n, c, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
