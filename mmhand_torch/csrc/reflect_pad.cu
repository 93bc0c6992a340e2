// Reflect padding of a channels_last activation: reflect_pad_kernel and its
// backward, reflect_pad_backward_kernel (ops/reflect_pad.py `reflect_pad`).
//
// They replace no TPU kernel: mmhand_tpu pads with jnp arithmetic before
// each VALID conv (mmhand_tpu/models/layers.py:246-270 `pad2d`, or folds
// the pad into the conv, :273 `PadConv`, ops/reflect_conv.py).  The port
// puts the pad before a cuDNN conv (models/layers.py `pad_conv`), where
// ATen's reflection pad takes NCHW only: each site copied the channels_last
// activation to NCHW, padded, and cuDNN copied the result back; the
// backward copied the gradient to NCHW, zeroed the input's gradient and
// added into it with per-element atomics.  The GAN step pads at ~100 sites
// forward and ~93 backward.
//
// What bounds them: HBM bytes.  The forward reads x (B, H, W, C) and writes
// y (B, H + 2p, W + 2p, C); the backward reads dy, the size of y, and
// writes dx, the size of x.  So each is one pass over the (B, rows, cols,
// C) view in the channels_last layout both sides keep, with no arithmetic
// per element beyond the backward's sums:
//
//   forward   y[b, i, j] = x[b, r(i - p, H), r(j - p, W)], r(k, n) = |k|
//             for k < n, 2 (n - 1) - k beyond: a copy, byte for byte;
//   backward  a gather: input position (h, w) sums, in f32, the gradient
//             of every padded position that copies it.  Along an axis of
//             n those are h + p itself; p - h where 1 <= h <= p (the mirror
//             at the start); 2 (n - 1) - h + p where n - 1 - p <= h <= n -
//             2 (the mirror at the end).  Rows outer, columns inner, each
//             in that order; one rounding to the gradient's type at the
//             end.  No zero fill, no atomics: the same bits on every run.
//             tests/test_torch_reflect_pad.py `backward_by_gather` mirrors
//             the sums in plain PyTorch.
//
// A thread moves one vector of a pixel's C channels: 16 bytes where they
// divide C * element size and the base pointers, else the widest of 8, 4
// and 2 bytes that does (the wrapper chooses, `vector_bytes`), so the f32
// stems' 3, 6 and 42 channels take 4 or 8.  Block (x, row, batch) holds
// 256 consecutive vectors of one row of the output (forward) or of the
// input (backward): neighbouring threads load and store neighbouring
// addresses, and the source row and column come from the reflected index,
// computed once per thread.

#include <cuda_runtime.h>

#include <cstdint>

#include "dtypes.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGrid = 65535;  // gridDim.y and gridDim.z; larger loop

// An unsigned type of N bytes: one load or store of a vector.
template <int N>
struct Bits;
template <>
struct Bits<16> { using type = uint4; };
template <>
struct Bits<8> { using type = uint2; };
template <>
struct Bits<4> { using type = unsigned int; };
template <>
struct Bits<2> { using type = unsigned short; };

// The source of padded index k + p along an axis of n > p.
__device__ __forceinline__ int reflect(int k, int n) {
  k = k < 0 ? -k : k;
  return k < n ? k : 2 * (n - 1) - k;
}

// The padded indices whose gradient input index i sums along an axis of n,
// in order: i + p itself, p - i (the mirror at the start), 2 (n - 1) - i + p
// (the mirror at the end); ok[s] where index s copies i.
__device__ __forceinline__ void sources(int i, int n, int p, int* at,
                                        bool* ok) {
  at[0] = i + p;
  ok[0] = true;
  at[1] = p - i;
  ok[1] = i >= 1 && i <= p;
  at[2] = 2 * (n - 1) - i + p;
  ok[2] = i >= n - 1 - p && i <= n - 2;
}

// y (B, H + 2p, W + 2p, cv vectors of V) from x (B, H, W, cv vectors).
template <typename V>
__global__ void __launch_bounds__(kThreads)
reflect_pad_kernel(const V* __restrict__ x, V* __restrict__ y, int batch,
                   int h, int w, int cv, int p) {
  const int ho = h + 2 * p, wo = w + 2 * p;
  const int row = wo * cv;
  const int k = blockIdx.x * kThreads + threadIdx.x;
  if (k >= row) return;
  const int j = k / cv;
  const int64_t col = int64_t(reflect(j - p, w)) * cv + (k - j * cv);
  for (int b = blockIdx.z; b < batch; b += gridDim.z) {
    for (int i = blockIdx.y; i < ho; i += gridDim.y) {
      const int64_t src = (int64_t(b) * h + reflect(i - p, h)) * w * cv;
      y[(int64_t(b) * ho + i) * row + k] = __ldg(x + src + col);
    }
  }
}

// dx (B, H, W, C) from dy (B, H + 2p, W + 2p, C), kVec elements a thread.
template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads)
reflect_pad_backward_kernel(const T* __restrict__ dy, T* __restrict__ dx,
                            int batch, int h, int w, int cv, int p) {
  using V = typename Bits<sizeof(T) * kVec>::type;
  const V* __restrict__ g = reinterpret_cast<const V*>(dy);
  V* __restrict__ out = reinterpret_cast<V*>(dx);
  const int ho = h + 2 * p, wo = w + 2 * p;
  const int row = w * cv;
  const int k = blockIdx.x * kThreads + threadIdx.x;
  if (k >= row) return;
  const int j = k / cv, v = k - j * cv;
  int cols[3], rows[3];
  bool col_ok[3], row_ok[3];
  sources(j, w, p, cols, col_ok);
  for (int b = blockIdx.z; b < batch; b += gridDim.z) {
    for (int i = blockIdx.y; i < h; i += gridDim.y) {
      sources(i, h, p, rows, row_ok);
      float acc[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[e] = 0.0f;
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        if (!row_ok[r]) continue;
        const int64_t at = (int64_t(b) * ho + rows[r]) * wo;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          if (!col_ok[c]) continue;
          const V raw = __ldg(g + (at + cols[c]) * cv + v);
          const T* t = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int e = 0; e < kVec; ++e) acc[e] += to_f32(t[e]);
        }
      }
      V packed;
      T* o = reinterpret_cast<T*>(&packed);
#pragma unroll
      for (int e = 0; e < kVec; ++e) o[e] = from_f32<T>(acc[e]);
      out[(int64_t(b) * h + i) * row + k] = packed;
    }
  }
}

dim3 grid_of(int row_vectors, int rows, int batch) {
  return dim3(static_cast<unsigned int>((row_vectors + kThreads - 1) /
                                        kThreads),
              static_cast<unsigned int>(rows < kMaxGrid ? rows : kMaxGrid),
              static_cast<unsigned int>(batch < kMaxGrid ? batch : kMaxGrid));
}

template <typename V>
int launch_pad(const void* x, void* y, int batch, int h, int w, int cv, int p,
               cudaStream_t stream) {
  reflect_pad_kernel<V><<<grid_of((w + 2 * p) * cv, h + 2 * p, batch),
                          kThreads, 0, stream>>>(
      static_cast<const V*>(x), static_cast<V*>(y), batch, h, w, cv, p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kVec>
int launch_backward(const void* dy, void* dx, int batch, int h, int w, int cv,
                    int p, cudaStream_t stream) {
  reflect_pad_backward_kernel<T, kVec><<<grid_of(w * cv, h, batch), kThreads,
                                         0, stream>>>(
      static_cast<const T*>(dy), static_cast<T*>(dx), batch, h, w, cv, p);
  return static_cast<int>(cudaGetLastError());
}

// The backward for `vec` bytes a thread: 16 / sizeof(T) elements at most.
template <typename T>
int backward_of(int vec, const void* dy, void* dx, int batch, int h, int w,
                int cv, int p, cudaStream_t s) {
  const int n = vec / static_cast<int>(sizeof(T));
  if constexpr (sizeof(T) == 2) {
    if (n == 8) return launch_backward<T, 8>(dy, dx, batch, h, w, cv, p, s);
  }
  if (n == 4) return launch_backward<T, 4>(dy, dx, batch, h, w, cv, p, s);
  if (n == 2) return launch_backward<T, 2>(dy, dx, batch, h, w, cv, p, s);
  return launch_backward<T, 1>(dy, dx, batch, h, w, cv, p, s);
}

// What the kernels assume; the wrapper's arguments always hold it.  The
// pixel's bytes and both base pointers are multiples of `vec`, itself 2,
// 4, 8 or 16 and at least an element; p < min(H, W); one row's vectors
// fit the grid.
bool fits(int vec, int elem_bytes, int pixel_bytes, const void* a,
          const void* b, int batch, int h, int w, int p) {
  const bool width = vec == 2 || vec == 4 || vec == 8 || vec == 16;
  return width && vec >= elem_bytes && pixel_bytes > 0 &&
         pixel_bytes % vec == 0 &&
         reinterpret_cast<uintptr_t>(a) % vec == 0 &&
         reinterpret_cast<uintptr_t>(b) % vec == 0 && batch >= 0 && p >= 0 &&
         p < h && p < w && int64_t(w + 2 * p) * (pixel_bytes / vec) < (1 << 30);
}

}  // namespace

// x: (batch, h, w) pixels of `pixel_bytes` each, row-major on the device
// (a channels_last (B, C, H, W) tensor); y: (batch, h + 2p, w + 2p) pixels;
// `vec`: the bytes a thread moves, dividing the pixel and both pointers.
// Launches on `stream` and returns cudaGetLastError() (0 on success); it
// does not synchronise.
extern "C" int mmhand_reflect_pad(const void* x, void* y, int batch, int h,
                                  int w, int pixel_bytes, int vec, int p,
                                  void* stream) {
  if (!fits(vec, 1, pixel_bytes, x, y, batch, h, w, p)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cv = pixel_bytes / vec;
  switch (vec) {
    case 16: return launch_pad<uint4>(x, y, batch, h, w, cv, p, s);
    case 8: return launch_pad<uint2>(x, y, batch, h, w, cv, p, s);
    case 4: return launch_pad<unsigned int>(x, y, batch, h, w, cv, p, s);
    default: return launch_pad<unsigned short>(x, y, batch, h, w, cv, p, s);
  }
}

// dy: (batch, h + 2p, w + 2p, c) of dtype 0 f32, 1 bf16, 2 f16, row-major
// on the device; dx: (batch, h, w, c) of the same dtype; `vec` as
// mmhand_reflect_pad's.  Launches on `stream` and returns
// cudaGetLastError(); it does not synchronise.
extern "C" int mmhand_reflect_pad_backward(const void* dy, void* dx, int dtype,
                                           int batch, int h, int w, int c,
                                           int vec, int p, void* stream) {
  const int elem_bytes = dtype == kF32 ? 4 : 2;
  if ((dtype != kF32 && dtype != kBF16 && dtype != kF16) ||
      !fits(vec, elem_bytes, c * elem_bytes, dy, dx, batch, h, w, p)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cv = c * elem_bytes / vec;
  switch (dtype) {
    case kF32: return backward_of<float>(vec, dy, dx, batch, h, w, cv, p, s);
    case kBF16:
      return backward_of<__nv_bfloat16>(vec, dy, dx, batch, h, w, cv, p, s);
    default: return backward_of<__half>(vec, dy, dx, batch, h, w, cv, p, s);
  }
}
