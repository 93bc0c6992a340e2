// BatchNorm moments (kernels K2 and K2b of the port).
//
// K2 replaces the Pallas kernel mmhand_tpu/ops/bn_stats.py:87
// `_moments_kernel` (reached through `_sums_2d_pallas`): per-channel f32
// (sum x, sum x^2) over the (N = B*H*W, C) row-major view of a channels_last
// activation, read as the flat array of T = N*C elements.
//
// What bounds it: HBM bytes, and at the small sites a fixed cost per call.
// K2 reads x once and does 3 f32 operations per element: 134 MB at the
// train step's largest site, (16, 64, 256, 256) bf16, >= 0.040 ms at
// 3.35 TB/s; 2-8 MB at the voxel and depth nets' C=1 sites, under 3 us,
// where the launch, the first loads' latency and the last block's sums
// take most of the time.  So it is one launch of one wave, every load is
// 16 bytes wide and coalesced, and the end of the kernel is short.
//
// Every C gets 16-byte loads.  The plan (ops/bn_stats.py `sums_plan`,
// passed in as SumsPlan) cuts the array as the TPU kernel's lane packing
// (mmhand_tpu/ops/bn_stats.py:119-127) views (N, C) as (N/p, p*C):
//
//   head   the elements before the first 16-byte boundary (fewer than one
//          vector; none when x is aligned, as torch allocates it);
//   body   super-rows of W = lcm(C, vec) elements: k = W / C rows, V = W /
//          vec whole vectors; slot s of every super-row holds channel
//          (head + s) mod C;
//   tail   what follows the last whole super-row (N mod k rows, or fewer
//          than W elements after a head).
//
// At C = 1 f32 a super-row is 4 rows, at C = 21 bf16 8 rows of 21
// channels; the slots fold back into channels at the end, and the head
// and tail are added element by element.
//
// The grid is one wave: one block of 1024 threads per SM.  Block (chunk,
// tile) has `lanes` (<= 8) threads across vectors tile*lanes + lane of a
// super-row (128 contiguous bytes) and 1024 / lanes super-rows in flight,
// kUnroll loads issued before any is used; f32 sums per slot in registers.
// It sums its rows by a fixed tree: shuffles down at offsets >= lanes
// within each warp, then, through shared memory, the 32 warps by the same
// shuffle tree, and stores one partial of 2 x lanes*vec floats.
//
// No second launch: each block then takes a ticket of its tile; the tile's
// last block sums the tile's partials (lane i of a warp sums chunks i, i +
// 32, ... in order, then the lanes by the tree) and writes its channels.
// Where C is no multiple of vec and there is more than one tile, a second
// ticket lets the last tile fold every tile's slots.  Which block is last
// changes who adds, never the order of the additions: the sums are the
// same bits on every run, and no float atomics touch them.
//
// The tickets are an array the caller passes in, one per stream
// (ops/bn_stats.py `_tickets`), zero before the stream's first launch;
// each last block resets its ticket, so the next launch on the stream and
// every replay of a CUDA graph start from zero, with no memset launch.
// The launches of one stream never overlap, and launches on two streams
// take two arrays, so two K2 launches that run at once never share a
// ticket.
//
// K2b is the backward of the same custom_vjp (mmhand_tpu/ops/bn_stats.py:73-77
// `_sums_2d_bwd`): dx = g1[c] + 2 g2[c] x[m, c] in f32, stored in x's type,
// one elementwise pass with 16-byte loads and stores (reads x, writes dx).
// The products and the sum are rounded one at a time (no FMA), in the order
// the plain version takes, so K2b equals it bit for bit.  Channels that are
// not a multiple of the vector width, or a misaligned x or dx, take a
// masked scalar load.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "dtypes.cuh"

namespace {

constexpr int kThreads = 256;      // K2b: threads of a block
constexpr int kVecBytes = 16;
constexpr int kMaxLanes = 64;      // K2b: a channel tile is at most 64 vectors
constexpr int kBlocksPerSm = 4;    // K2b: blocks per SM (times 2)
constexpr int kSumThreads = 1024;  // K2: threads of its one block per SM
constexpr int kSumWarps = kSumThreads / 32;
constexpr int kSumLanes = 8;       // K2: a channel tile is at most 8 vectors
constexpr int kUnroll = 4;         // K2: loads in flight per thread
constexpr int kMaxChunks = 256;    // K2: chunks a tile's last block sums
constexpr int kMaxTickets = 8192;  // K2: tiles + 1 at most

// K2's plan, field for field ops/bn_stats.py `SumsPlan` (int64 each).
struct SumsPlan {
  int64_t n_elems;         // T = N * C
  int64_t c;
  int64_t head;            // elements before the 16-byte boundary
  int64_t width;           // W = k * C, a multiple of vec
  int64_t vectors;         // V = W / vec
  int64_t lanes;           // threads across a tile: a power of two <= 8
  int64_t tiles;           // ceil(V / lanes)
  int64_t super_rows;      // whole super-rows after the head
  int64_t chunks;          // blocks along the rows of each tile
  int64_t rows_per_chunk;
};
constexpr int kPlanFields = sizeof(SumsPlan) / sizeof(int64_t);

template <typename T>
__device__ __forceinline__ void accumulate(const uint4& raw, float* s1,
                                           float* s2) {
  constexpr int kVec = kVecBytes / sizeof(T);
  const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const float f = to_f32(v[j]);
    s1[j] += f;
    s2[j] = fmaf(f, f, s2[j]);
  }
}

// The warp's 32 float4s summed by a fixed tree; lane 0 holds the sum.
__device__ __forceinline__ float4 warp_sum(float4 a) {
#pragma unroll
  for (int off = 16; off >= 1; off /= 2) {
    a.x += __shfl_down_sync(0xffffffffu, a.x, off);
    a.y += __shfl_down_sync(0xffffffffu, a.y, off);
    a.z += __shfl_down_sync(0xffffffffu, a.z, off);
    a.w += __shfl_down_sync(0xffffffffu, a.w, off);
  }
  return a;
}

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// Thread 0 takes a ticket of `count`; true in every thread of the block
// that took the last one, which resets the ticket for the next launch.
// The barrier, then thread 0's acquire-release atomic, release the
// block's stores to the other blocks and acquire theirs, which the last
// block reads past L1 (__ldcg).
__device__ __forceinline__ bool last_to_arrive(unsigned int* ticket,
                                               int64_t count) {
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned int before;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
                 : "=r"(before)
                 : "l"(ticket)
                 : "memory");
    last = before == static_cast<unsigned int>(count - 1);
    if (last) *ticket = 0u;
  }
  __syncthreads();
  return last;
}

// Adds channel ch's elements of the head and of the tail, in order
// (mirrored by ops/bn_stats.py `bn_sums_by_plan`, which the CPU tests hold).
template <typename T>
__device__ __forceinline__ void add_edges(const T* x, const SumsPlan& p,
                                          int64_t ch, float& a, float& b) {
  for (int64_t e = ch; e < p.head; e += p.c) {
    const float f = to_f32(x[e]);
    a += f;
    b = fmaf(f, f, b);
  }
  const int64_t tail = p.head + p.super_rows * p.width;
  for (int64_t e = tail + ((ch - tail) % p.c + p.c) % p.c; e < p.n_elems;
       e += p.c) {
    const float f = to_f32(x[e]);
    a += f;
    b = fmaf(f, f, b);
  }
}

// C not a multiple of vec: channel ch owns slots (ch - head) mod C + m C,
// m < k, of `slots` ([tiles][2][tw]: in shared memory, or in global memory
// that other blocks wrote), summed in m order, then its head and tail.
// ops/bn_stats.py `bn_sums_by_plan` mirrors this arithmetic, the scratch
// layout and, in bn_sums_kernel, the slot-to-channel map of a C that is a
// multiple of vec.
template <typename T>
__device__ void fold(const T* x, const SumsPlan& p, const float* slots,
                     bool global, int tw, bool edges, float* out) {
  const int64_t k = p.width / p.c;
  for (int64_t ch = threadIdx.x; ch < p.c; ch += kSumThreads) {
    const int64_t s0 = p.head ? ((ch - p.head) % p.c + p.c) % p.c : ch;
    float a = 0.0f, b = 0.0f;
    for (int64_t m = 0; m < k; ++m) {
      // slot s of tile s / tw (tw a power of two)
      const int64_t s = s0 + m * p.c;
      const float* at = slots + (s & ~int64_t(tw - 1)) * 2 + (s & (tw - 1));
      a += global ? __ldcg(at) : at[0];
      b += global ? __ldcg(at + tw) : at[tw];
    }
    if (edges) add_edges(x, p, ch, a, b);
    out[ch] = a;
    out[p.c + ch] = b;
  }
}

// K2: block (chunk, tile) of the plan above, one block of kSumThreads per
// SM.  A partial is 2 x tw floats (tw = lanes * vec slots: the sums, then
// the sums of squares).  Scratch: [chunks][tiles] block partials, then
// [tiles] slot sums.  tickets: kMaxTickets, zero, this stream's own.
template <typename T>
__global__ void __launch_bounds__(kSumThreads, 1)
bn_sums_kernel(const T* __restrict__ x, const SumsPlan p,
               float* __restrict__ scratch, float* __restrict__ out,
               unsigned int* __restrict__ tickets) {
  constexpr int kVec = kVecBytes / sizeof(T);
  __shared__ __align__(16) float red[kSumWarps * 2 * kSumLanes * kVec];
  const int lanes = static_cast<int>(p.lanes);
  const int lane = threadIdx.x % lanes;
  const int rows_per_iter = kSumThreads / lanes;
  const int tw = lanes * kVec;
  const int quads = 2 * tw / 4;  // float4 columns of a partial
  const int warp = threadIdx.x / 32;
  const int wlane = threadIdx.x % 32;
  const int64_t tile = blockIdx.y;
  const int64_t chunk = blockIdx.x;
  const int64_t v = tile * lanes + lane;

  float s1[kVec], s2[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    s1[j] = 0.0f;
    s2[j] = 0.0f;
  }
  if (v < p.vectors) {
    // vector v of super-row 0; super-rows are V vectors apart
    const uint4* base = reinterpret_cast<const uint4*>(x + p.head) + v;
    const int64_t begin = chunk * p.rows_per_chunk;
    const int64_t end = begin + p.rows_per_chunk < p.super_rows
                            ? begin + p.rows_per_chunk
                            : p.super_rows;
    // kUnroll rows per step, the loads all issued first; rows past the
    // chunk load as zeros, which add nothing
    for (int64_t r = begin + threadIdx.x / lanes; r < end;
         r += kUnroll * rows_per_iter) {
      uint4 raw[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t at = r + u * rows_per_iter;
        raw[u] = at < end ? __ldg(base + at * p.vectors)
                          : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) accumulate<T>(raw[u], s1, s2);
    }
  }

  // the block's rows -> one partial: shuffles down at offsets >= lanes sum
  // a warp's 32 / lanes row groups; then warp q's lane i sums float4
  // column q of the 32 warps' sums by the same tree
  for (int off = 16; off >= lanes; off /= 2) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      s1[j] += __shfl_down_sync(0xffffffffu, s1[j], off);
      s2[j] += __shfl_down_sync(0xffffffffu, s2[j], off);
    }
  }
  if (wlane < lanes) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      red[warp * 2 * tw + lane * kVec + j] = s1[j];
      red[warp * 2 * tw + tw + lane * kVec + j] = s2[j];
    }
  }
  __syncthreads();
  const int64_t row = p.tiles * 2 * tw;  // floats of one chunk's partials
  for (int q = warp; q < quads; q += kSumWarps) {
    const float4 sum = warp_sum(
        wlane < kSumWarps
            ? reinterpret_cast<const float4*>(red + wlane * 2 * tw)[q]
            : make_float4(0.0f, 0.0f, 0.0f, 0.0f));
    if (wlane == 0) {
      reinterpret_cast<float4*>(scratch + chunk * row + tile * 2 * tw)[q] =
          sum;
    }
  }

  // the tile's last block: lane i of warp q sums float4 column q of chunks
  // i, i + 32, ... in order, then the lanes by the tree, into `red`
  if (!last_to_arrive(&tickets[tile], p.chunks)) return;
  for (int q = warp; q < quads; q += kSumWarps) {
    float4 part[kMaxChunks / 32];
#pragma unroll
    for (int i = 0; i < kMaxChunks / 32; ++i) {
      const int64_t from = wlane + 32 * i;
      part[i] = from < p.chunks
                    ? __ldcg(reinterpret_cast<const float4*>(
                                 scratch + from * row + tile * 2 * tw) + q)
                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int i = 1; i < kMaxChunks / 32; ++i) add4(part[0], part[i]);
    const float4 sum = warp_sum(part[0]);
    if (wlane == 0) reinterpret_cast<float4*>(red)[q] = sum;
  }
  __syncthreads();
  const bool edges = p.head > 0 || p.head + p.super_rows * p.width < p.n_elems;
  if (p.width == p.c) {
    // C a multiple of vec: each channel in one slot of one tile
    for (int c0 = threadIdx.x; c0 < tw && tile * tw + c0 < p.width;
         c0 += kSumThreads) {
      const int64_t s = tile * tw + c0;
      const int64_t ch = p.head ? (p.head + s) % p.c : s;
      float a = red[c0];
      float b = red[tw + c0];
      if (edges) add_edges(x, p, ch, a, b);
      out[ch] = a;
      out[p.c + ch] = b;
    }
    return;
  }
  if (p.tiles == 1) {
    fold(x, p, red, false, tw, edges, out);
    return;
  }
  // more tiles: the last one folds every tile's slots
  float* slots = scratch + p.chunks * row;  // [tiles][2][tw]
  for (int i = threadIdx.x; i < 2 * tw; i += kSumThreads) {
    slots[tile * 2 * tw + i] = red[i];
  }
  if (!last_to_arrive(&tickets[p.tiles], p.tiles)) return;
  fold(x, p, slots, true, tw, edges, out);
}

// K2b's cut of a (N, C) view: `lanes` threads of a block sit across a tile
// of lanes * vec channels, kThreads / lanes rows at a time.
struct Plan {
  int vec;
  int lanes;
  int rows_per_iter;
  int ctiles;
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

Plan make_plan(int c, int elem_bytes) {
  Plan p;
  p.vec = kVecBytes / elem_bytes;
  const int vectors = (c + p.vec - 1) / p.vec;
  p.lanes = 1;
  while (p.lanes < vectors && p.lanes < kMaxLanes) p.lanes *= 2;
  p.rows_per_iter = kThreads / p.lanes;
  p.ctiles = (c + p.lanes * p.vec - 1) / (p.lanes * p.vec);
  return p;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % kVecBytes == 0;
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
int launch_sums(const void* x, const SumsPlan& p, float* scratch, float* out,
                unsigned int* tickets, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned int>(p.chunks),
                  static_cast<unsigned int>(p.tiles));
  bn_sums_kernel<T><<<grid, kSumThreads, 0, stream>>>(
      static_cast<const T*>(x), p, scratch, out, tickets);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_backward(const void* x, const float* g1, const float* g2, void* dx,
                    int64_t n, int c, cudaStream_t stream) {
  const Plan p = make_plan(c, sizeof(T));
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

// What the kernel assumes of a plan; the wrapper's plan always holds it.
// The body's vectors must start at a 16-byte boundary; with no super-row
// (fewer elements than the head, or than one super-row) none is loaded.
bool plan_fits(const SumsPlan& p, const void* x, int elem_bytes) {
  const int vec = kVecBytes / elem_bytes;
  return p.c > 0 && p.lanes > 0 && p.lanes <= kSumLanes &&
         (p.lanes & (p.lanes - 1)) == 0 && p.width % p.c == 0 &&
         p.width == p.vectors * vec && p.tiles * p.lanes >= p.vectors &&
         p.tiles + 1 <= kMaxTickets && p.tiles <= 65535 && p.chunks >= 1 &&
         p.chunks <= kMaxChunks &&
         p.chunks * p.rows_per_chunk >= p.super_rows &&
         p.head + p.super_rows * p.width <= p.n_elems &&
         (p.super_rows == 0 ||
          aligned16(static_cast<const char*>(x) + p.head * elem_bytes));
}


// ---------------------------------------------------------------------------
// The train-mode normalize that follows the moments: bn_apply_kernel and
// bn_apply_backward_kernel (ops/bn_stats.py `bn_apply`).
//
// They replace no TPU kernel: mmhand_tpu's normalize
// (mmhand_tpu/models/layers.py:190-192, `_DotStatsBN`) is jnp arithmetic
// that XLA fuses into one pass each way.  In eager PyTorch the same formula
// is some 40 launches a site, forward and backward, with full-size f32
// temporaries (x - mean, the broadcasts, the casts) and autograd's
// reductions over them: about 94 bytes moved per element of a bf16 input.
//
// What bounds them: HBM bytes.  The forward reads x and writes y (4 bytes
// an element in bf16); the backward reads x and dy and writes dx (6
// bytes).  So each is one pass, with the per-channel work done once per
// thread and not per element:
//
//   forward   y = ((x - mean) * scale) + bias, scale = rsqrt(max(E[x^2] -
//             E[x]^2, 0) + eps) * weight, in f32, each operation rounded
//             alone in the plain version's order (no FMA), stored in x's
//             type;
//   backward  dx = dy * scale in x's type, and the f32 per-channel sums
//             sum dy and sum dy (x - mean), from which the last block
//             finishes d_mean, d_mean_sq, d_weight and d_bias.
//
// Both walk K2's plan with no head (the wrapper passes 16-byte aligned
// tensors): thread (tile, lane) holds vector v = tile * lanes + lane of
// each super-row of its chunk, so the channels of its slots, (v * vec + j)
// mod C, and their mean, scale and bias stay in registers for the whole
// launch, and every load and store of the body is 16 bytes wide at every
// C.  The tail (fewer than W elements) goes element by element: in the
// forward by block (0, 0), in the backward by the threads that finish each
// channel.  The backward reduces as K2 does: shuffles and a fixed tree to
// one partial per block; K2's tickets (the same per-stream array) pick
// each tile's last block, which sums the partials in chunk order into the
// tile's slots; a second ticket picks the last tile, which folds the slots
// into channels.  No float atomics: the gradients are the same bits on
// every run.

// max(E[x^2] - E[x]^2, 0) as torch.clamp takes it (a NaN stays NaN), before
// the clamp (`raw`) and after.
__device__ __forceinline__ float raw_var(float m, float q) {
  return __fsub_rn(q, __fmul_rn(m, m));
}
__device__ __forceinline__ float inv_std(float raw, float eps) {
  return rsqrtf(__fadd_rn(raw < 0.0f ? 0.0f : raw, eps));
}

// scale = rsqrt(var + eps) * weight of channel ch
__device__ __forceinline__ float bn_scale(const float* mean,
                                          const float* mean_sq,
                                          const float* weight, float eps,
                                          int64_t ch) {
  return __fmul_rn(inv_std(raw_var(__ldg(mean + ch), __ldg(mean_sq + ch)),
                           eps),
                   __ldg(weight + ch));
}

// ((x - m) * s) + b, each operation rounded alone
__device__ __forceinline__ float normalize(float x, float m, float s,
                                           float b) {
  return __fadd_rn(__fmul_rn(__fsub_rn(x, m), s), b);
}

// The super-rows of the block's chunk: [begin, end).
__device__ __forceinline__ int64_t chunk_end(const SumsPlan& p,
                                             int64_t begin) {
  return begin + p.rows_per_chunk < p.super_rows ? begin + p.rows_per_chunk
                                                 : p.super_rows;
}

// y[e] = ((x[e] - mean) * scale) + bias, e's channel e mod C.
template <typename T>
__global__ void __launch_bounds__(kSumThreads, 1)
bn_apply_kernel(const T* __restrict__ x, const float* __restrict__ mean,
                const float* __restrict__ mean_sq,
                const float* __restrict__ weight,
                const float* __restrict__ bias, float eps, T* __restrict__ y,
                const SumsPlan p) {
  constexpr int kVec = kVecBytes / sizeof(T);
  const int lanes = static_cast<int>(p.lanes);
  const int rows_per_iter = kSumThreads / lanes;
  const int64_t v = int64_t(blockIdx.y) * lanes + threadIdx.x % lanes;
  if (v < p.vectors) {
    float m[kVec], s[kVec], b[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int64_t ch = (v * kVec + j) % p.c;
      m[j] = __ldg(mean + ch);
      s[j] = bn_scale(mean, mean_sq, weight, eps, ch);
      b[j] = __ldg(bias + ch);
    }
    const int64_t begin = int64_t(blockIdx.x) * p.rows_per_chunk;
    const int64_t end = chunk_end(p, begin);
    for (int64_t r = begin + threadIdx.x / lanes; r < end;
         r += rows_per_iter) {
      const int64_t at = r * p.vectors + v;
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(x) + at);
      const T* in = reinterpret_cast<const T*>(&raw);
      uint4 packed;
      T* out = reinterpret_cast<T*>(&packed);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        out[j] = from_f32<T>(normalize(to_f32(in[j]), m[j], s[j], b[j]));
      }
      reinterpret_cast<uint4*>(y)[at] = packed;
    }
  }
  if (blockIdx.x == 0 && blockIdx.y == 0) {
    for (int64_t e = p.super_rows * p.width + threadIdx.x; e < p.n_elems;
         e += kSumThreads) {
      const int64_t ch = e % p.c;
      y[e] = from_f32<T>(normalize(to_f32(x[e]), mean[ch],
                                   bn_scale(mean, mean_sq, weight, eps, ch),
                                   bias[ch]));
    }
  }
}

// dx[e] = dy[e] * scale; per channel, a = sum dy and b = sum dy (x - mean),
// and from them grads (4, C): d_mean, d_mean_sq, d_weight, d_bias.
// Scratch and tickets as K2's.
template <typename T>
__global__ void __launch_bounds__(kSumThreads, 1)
bn_apply_backward_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                         const float* __restrict__ mean,
                         const float* __restrict__ mean_sq,
                         const float* __restrict__ weight, float eps,
                         T* __restrict__ dx, const SumsPlan p,
                         float* __restrict__ scratch,
                         float* __restrict__ grads,
                         unsigned int* __restrict__ tickets) {
  constexpr int kVec = kVecBytes / sizeof(T);
  __shared__ __align__(16) float red[kSumWarps * 2 * kSumLanes * kVec];
  const int lanes = static_cast<int>(p.lanes);
  const int lane = threadIdx.x % lanes;
  const int rows_per_iter = kSumThreads / lanes;
  const int tw = lanes * kVec;
  const int quads = 2 * tw / 4;  // float4 columns of a partial
  const int warp = threadIdx.x / 32;
  const int wlane = threadIdx.x % 32;
  const int64_t tile = blockIdx.y;
  const int64_t v = tile * lanes + lane;

  float s1[kVec], s2[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    s1[j] = 0.0f;
    s2[j] = 0.0f;
  }
  if (v < p.vectors) {
    float m[kVec], s[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int64_t ch = (v * kVec + j) % p.c;
      m[j] = __ldg(mean + ch);
      s[j] = bn_scale(mean, mean_sq, weight, eps, ch);
    }
    const int64_t begin = int64_t(blockIdx.x) * p.rows_per_chunk;
    const int64_t end = chunk_end(p, begin);
    for (int64_t r = begin + threadIdx.x / lanes; r < end;
         r += rows_per_iter) {
      const int64_t at = r * p.vectors + v;
      const uint4 xr = __ldg(reinterpret_cast<const uint4*>(x) + at);
      const uint4 gr = __ldg(reinterpret_cast<const uint4*>(dy) + at);
      const T* xv = reinterpret_cast<const T*>(&xr);
      const T* gv = reinterpret_cast<const T*>(&gr);
      uint4 packed;
      T* out = reinterpret_cast<T*>(&packed);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float g = to_f32(gv[j]);
        s1[j] += g;
        s2[j] = fmaf(g, __fsub_rn(to_f32(xv[j]), m[j]), s2[j]);
        out[j] = from_f32<T>(__fmul_rn(g, s[j]));
      }
      reinterpret_cast<uint4*>(dx)[at] = packed;
    }
  }

  // the block's rows -> one partial, by K2's tree: shuffles down at offsets
  // >= lanes, then warp q's lane i sums float4 column q of the warps' sums
  for (int off = 16; off >= lanes; off /= 2) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      s1[j] += __shfl_down_sync(0xffffffffu, s1[j], off);
      s2[j] += __shfl_down_sync(0xffffffffu, s2[j], off);
    }
  }
  if (wlane < lanes) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      red[warp * 2 * tw + lane * kVec + j] = s1[j];
      red[warp * 2 * tw + tw + lane * kVec + j] = s2[j];
    }
  }
  __syncthreads();
  const int64_t row = p.tiles * 2 * tw;  // floats of one chunk's partials
  float* part = scratch + tile * 2 * tw;
  for (int q = warp; q < quads; q += kSumWarps) {
    const float4 sum = warp_sum(
        wlane < kSumWarps
            ? reinterpret_cast<const float4*>(red + wlane * 2 * tw)[q]
            : make_float4(0.0f, 0.0f, 0.0f, 0.0f));
    if (wlane == 0) {
      reinterpret_cast<float4*>(part + blockIdx.x * row)[q] = sum;
    }
  }

  // the tile's last block: lane i of warp q sums column q of chunks i,
  // i + 32, ... in order, then the lanes by the tree, into the tile's
  // slots ([tiles][2][tw] after the partials)
  if (!last_to_arrive(&tickets[tile], p.chunks)) return;
  float* slots = scratch + p.chunks * row;
  for (int q = warp; q < quads; q += kSumWarps) {
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int64_t from = wlane; from < p.chunks; from += 32) {
      add4(acc, __ldcg(reinterpret_cast<const float4*>(part + from * row) + q));
    }
    const float4 sum = warp_sum(acc);
    if (wlane == 0) reinterpret_cast<float4*>(slots + tile * 2 * tw)[q] = sum;
  }

  // the last tile: channel ch sums its slots ch + m C, m < k, in m order,
  // then its tail elements, writing their dx; then, with r = rsqrt(var +
  // eps): d_bias = a; d_weight = b r; d_var = -0.5 (b weight) r^3 where the
  // clamp passes (E[x^2] - E[x]^2 >= 0), else 0; d_mean_sq = d_var; d_mean
  // = -(scale a) - 2 mean d_var
  if (!last_to_arrive(&tickets[p.tiles], p.tiles)) return;
  const int64_t k = p.width / p.c;
  const int64_t tail = p.super_rows * p.width;
  for (int64_t ch = threadIdx.x; ch < p.c; ch += kSumThreads) {
    float a = 0.0f, b = 0.0f;
    for (int64_t i = 0; i < k; ++i) {
      // slot s of tile s / tw (tw a power of two)
      const int64_t s = ch + i * p.c;
      const float* at = slots + (s & ~int64_t(tw - 1)) * 2 + (s & (tw - 1));
      a += __ldcg(at);
      b += __ldcg(at + tw);
    }
    const float mu = mean[ch];
    const float w = weight[ch];
    const float raw = raw_var(mu, mean_sq[ch]);
    const float r = inv_std(raw, eps);
    const float scale = __fmul_rn(r, w);
    for (int64_t e = tail + ((ch - tail) % p.c + p.c) % p.c; e < p.n_elems;
         e += p.c) {
      const float g = to_f32(dy[e]);
      a += g;
      b = fmaf(g, __fsub_rn(to_f32(x[e]), mu), b);
      dx[e] = from_f32<T>(__fmul_rn(g, scale));
    }
    const float d_var = raw >= 0.0f
        ? __fmul_rn(__fmul_rn(-0.5f, __fmul_rn(b, w)),
                    __fmul_rn(__fmul_rn(r, r), r))
        : 0.0f;
    grads[ch] = __fsub_rn(-__fmul_rn(scale, a),
                          __fmul_rn(__fmul_rn(2.0f, mu), d_var));
    grads[p.c + ch] = d_var;
    grads[2 * p.c + ch] = __fmul_rn(b, r);
    grads[3 * p.c + ch] = a;
  }
}

// What the normalize's kernels assume: K2's plan with no head, and every
// tensor 16-byte aligned.
bool apply_fits(const SumsPlan& p, int elem_bytes, const void* x,
                const void* y, const void* z = nullptr) {
  return p.head == 0 && plan_fits(p, x, elem_bytes) && aligned16(x) &&
         aligned16(y) && aligned16(z);
}

SumsPlan read_plan(const int64_t* plan) {
  SumsPlan p;
  static_assert(kPlanFields == 10, "SumsPlan has 10 fields");
  std::memcpy(&p, plan, sizeof(p));
  return p;
}

template <typename T>
int launch_apply(const void* x, const float* mean, const float* mean_sq,
                 const float* weight, const float* bias, float eps, void* y,
                 const SumsPlan& p, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned int>(p.chunks),
                  static_cast<unsigned int>(p.tiles));
  bn_apply_kernel<T><<<grid, kSumThreads, 0, stream>>>(
      static_cast<const T*>(x), mean, mean_sq, weight, bias, eps,
      static_cast<T*>(y), p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_apply_backward(const void* x, const void* dy, const float* mean,
                          const float* mean_sq, const float* weight, float eps,
                          void* dx, const SumsPlan& p, float* scratch,
                          float* grads, unsigned int* tickets,
                          cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned int>(p.chunks),
                  static_cast<unsigned int>(p.tiles));
  bn_apply_backward_kernel<T><<<grid, kSumThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), mean, mean_sq,
      weight, eps, static_cast<T*>(dx), p, scratch, grads, tickets);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (n, c) row-major on the device, of dtype 0 f32, 1 bf16, 2 f16; plan:
// a host array of the int64 fields of ops/bn_stats.py `SumsPlan`; scratch:
// its `scratch_floats` f32; out: (2, c) f32, (sum, sum_sq); tickets:
// kMaxTickets int32, zero, used by no launch on another stream.  Launches
// on `stream` and returns cudaGetLastError() (0 on success); it does not
// synchronise.
extern "C" int mmhand_bn_sums(const void* x, int dtype, const int64_t* plan,
                              float* scratch, float* out, void* tickets,
                              void* stream) {
  const SumsPlan p = read_plan(plan);
  const int elem_bytes = dtype == kF32 ? 4 : 2;
  if ((dtype != kF32 && dtype != kBF16 && dtype != kF16) ||
      !plan_fits(p, x, elem_bytes) || tickets == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned int* t = static_cast<unsigned int*>(tickets);
  switch (dtype) {
    case kF32: return launch_sums<float>(x, p, scratch, out, t, s);
    case kBF16: return launch_sums<__nv_bfloat16>(x, p, scratch, out, t, s);
    default: return launch_sums<__half>(x, p, scratch, out, t, s);
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


// x, y: (n, c) row-major of one dtype (0 f32, 1 bf16, 2 f16), 16-byte
// aligned; mean, mean_sq, weight, bias: (c,) f32; plan: a host array of the
// int64 fields of ops/bn_stats.py `SumsPlan`, with no head.  Launches on
// `stream` and returns cudaGetLastError(); it does not synchronise.
extern "C" int mmhand_bn_apply(const void* x, int dtype, const float* mean,
                               const float* mean_sq, const float* weight,
                               const float* bias, float eps, void* y,
                               const int64_t* plan, void* stream) {
  const SumsPlan p = read_plan(plan);
  const int elem_bytes = dtype == kF32 ? 4 : 2;
  if ((dtype != kF32 && dtype != kBF16 && dtype != kF16) ||
      !apply_fits(p, elem_bytes, x, y)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch_apply<float>(x, mean, mean_sq, weight, bias, eps, y, p, s);
    case kBF16:
      return launch_apply<__nv_bfloat16>(x, mean, mean_sq, weight, bias, eps,
                                         y, p, s);
    default:
      return launch_apply<__half>(x, mean, mean_sq, weight, bias, eps, y, p, s);
  }
}

// x, dy, dx: (n, c) row-major of one dtype, 16-byte aligned; mean, mean_sq,
// weight: (c,) f32; plan as mmhand_bn_apply's; scratch: its
// `scratch_floats` f32; grads: (4, c) f32, out; tickets: K2's kMaxTickets
// int32 of this stream, zero.  Launches on `stream` and returns
// cudaGetLastError(); it does not synchronise.
extern "C" int mmhand_bn_apply_backward(const void* x, const void* dy,
                                        int dtype, const float* mean,
                                        const float* mean_sq,
                                        const float* weight, float eps,
                                        void* dx, float* scratch,
                                        float* grads, void* tickets,
                                        const int64_t* plan, void* stream) {
  const SumsPlan p = read_plan(plan);
  const int elem_bytes = dtype == kF32 ? 4 : 2;
  if ((dtype != kF32 && dtype != kBF16 && dtype != kF16) ||
      !apply_fits(p, elem_bytes, x, dy, dx) || tickets == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned int* t = static_cast<unsigned int*>(tickets);
  switch (dtype) {
    case kF32:
      return launch_apply_backward<float>(x, dy, mean, mean_sq, weight, eps,
                                          dx, p, scratch, grads, t, s);
    case kBF16:
      return launch_apply_backward<__nv_bfloat16>(
          x, dy, mean, mean_sq, weight, eps, dx, p, scratch, grads, t, s);
    default:
      return launch_apply_backward<__half>(x, dy, mean, mean_sq, weight, eps,
                                           dx, p, scratch, grads, t, s);
  }
}
