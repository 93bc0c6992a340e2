// Depth-ordered bone-ellipse jointsmap (kernel K3 of the port).
//
// Replaces the Pallas kernel mmhand_tpu/ops/jointsmap.py `_jointsmap_kernel`
// (reached through `generate_jointsmap_pallas`), which keeps one image's
// (H, W) composite in VMEM and walks the 20 bones with a fori_loop, after an
// XLA pass has packed the (B, 20, 7) bone parameters.  Here one launch does
// both: each block computes its image's bone parameters into shared memory
// (20 threads, mmhand_tpu `_bone_params`'s operation order), and each
// thread keeps the nearest depth and its colour for its pixels in registers,
// walking the bones in order:
//
//   u = dx cos + dy sin,  v = -dx sin + dy cos
//   inside = (u / half_len)^2 + (v / 5)^2 <= 1
//   a bone wins where it is inside and avg_depth <= best (later bones win ties)
//
// What bounds it: at B = 8, 256 x 256 it writes 2.1 MB (0.0006 ms of HBM).
// Tested at every pixel, 20 bones cost ~16 f32 operations each, two of them
// IEEE divisions, multi-instruction sequences, and that bound it by
// instruction issue; yet a bone's ellipse covers a few hundred of 65,536
// pixels.  With the cull below, ~4-6% of the (pixel, bone) pairs run the
// test, and what is left is the launch and one block's latency chain: the
// keypoint loads, the parameters' divisions and square roots, a barrier.
// So:
//
// - A conservative cull per tile.  A warp owns 16 x 8 pixels, 4 per lane.
//   A pixel inside has |u| <= half_len and |v| <= 5, and u and v are affine
//   in the pixel: over the tile they stay within its half extents (times
//   |cos| and |sin|) of their value at its centre.  So a bone whose
//   rectangle |u| <= half_len, |v| <= 5, widened by that much and by a
//   relative and an absolute margin that cover every rounding of the test
//   (cull_rel, cull_pad: ops/jointsmap.py culled_tiles), misses the tile's
//   centre has no pixel inside in the tile.  Nothing assumes (cos, sin) is
//   a unit vector: below length 1e-6 it is not, and the ellipse is ~10x
//   larger in pixels.  A zero-length bone (cos = sin = 0, u = v = 0, the
//   whole frame inside) is never culled, nor one with a NaN parameter.
//   Each lane decides one bone, and one ballot gives the warp the bones
//   that may touch its tile, in order.  Skipping a bone that is certainly
//   outside leaves best and value as they were, so the output cannot
//   change.

// Every operation of the test is one IEEE rounding (the _rn intrinsics): an
// FMA formed from dx*cos + dy*sin rounds once where the reference rounds
// twice, and a pixel on an ellipse's boundary then flips.  So the kernel
// equals the plain version (ops/jointsmap.py) and mmhand_tpu bit for bit.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBones = 20;
constexpr int kJoints = 21;
constexpr int kTileCols = 16;  // one warp's pixels: 16 x 8, 4 per lane
constexpr int kTileRows = 8;
constexpr int kPixelsPerLane = kTileCols * kTileRows / 32;
constexpr int kWarpsX = 2;     // a block: 2 x 4 warp tiles, 32 x 32 pixels
constexpr int kWarpsY = 4;
constexpr int kBlockCols = kWarpsX * kTileCols;
constexpr int kBlockRows = kWarpsY * kTileRows;
constexpr int kThreads = kWarpsX * kWarpsY * 32;
constexpr float kBoneRadius = 5.0f;  // reference generic_dataset.py:70
constexpr float kBig = 3.0e38f;

// reference generic_dataset.py:33-54, in mmhand_tpu's HAND_BONES order
__constant__ int kBoneA[kBones] = {0, 0, 0, 0, 0, 17, 18, 19, 1, 2,
                                   3, 5, 6, 7, 9, 10, 11, 13, 14, 15};
__constant__ int kBoneB[kBones] = {17, 1, 5, 9, 13, 18, 19, 20, 2, 3,
                                   4, 6, 7, 8, 10, 11, 12, 14, 15, 16};
__constant__ float kColors[kBones] = {160, 170, 180, 190, 200, 130, 140,
                                      150, 10, 20, 30, 40, 50, 60,
                                      70, 80, 90, 100, 110, 120};

// max(x, lo) that keeps a NaN, as jnp.maximum and torch.maximum do
__device__ __forceinline__ float max_keep_nan(float x, float lo) {
  return x < lo ? lo : x;
}

// grid (blocks of 32 x 32 pixels, B).  Shared: per bone mx, my, cos, sin,
// half_len, avg_depth, colour.
__global__ void __launch_bounds__(kThreads)
jointsmap_kernel(const float* __restrict__ uv, const float* __restrict__ depth,
                 float* __restrict__ out, int height, int width,
                 int blocks_x, float cull_rel, float cull_pad) {
  __shared__ float params[kBones][7];
  const int b = static_cast<int>(blockIdx.y);
  if (threadIdx.x < kBones) {
    const int i = threadIdx.x;
    const float* uv_b = uv + static_cast<int64_t>(b) * kJoints * 2;
    const float* d_b = depth + static_cast<int64_t>(b) * kJoints;
    const int ja = kBoneA[i], jb = kBoneB[i];
    const float ax = uv_b[2 * ja], ay = uv_b[2 * ja + 1];
    const float bx = uv_b[2 * jb], by = uv_b[2 * jb + 1];
    const float dx = __fsub_rn(ax, bx);
    const float dy = __fsub_rn(ay, by);
    const float length =
        __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
    const float safe = max_keep_nan(length, 1e-6f);
    params[i][0] = __fdiv_rn(__fadd_rn(ax, bx), 2.0f);
    params[i][1] = __fdiv_rn(__fadd_rn(ay, by), 2.0f);
    params[i][2] = __fdiv_rn(dx, safe);
    params[i][3] = __fdiv_rn(dy, safe);
    params[i][4] = max_keep_nan(__fdiv_rn(length, 2.0f), 1e-3f);
    params[i][5] = __fdiv_rn(__fadd_rn(d_b[ja], d_b[jb]), 2.0f);
    params[i][6] = kColors[i];
  }
  __syncthreads();

  const int warp = static_cast<int>(threadIdx.x) / 32;
  const int lane = static_cast<int>(threadIdx.x) % 32;
  const int bx0 = (static_cast<int>(blockIdx.x) % blocks_x) * kBlockCols;
  const int by0 = (static_cast<int>(blockIdx.x) / blocks_x) * kBlockRows;
  const int tx0 = bx0 + (warp % kWarpsX) * kTileCols;
  const int ty0 = by0 + (warp / kWarpsX) * kTileRows;
  if (tx0 >= width || ty0 >= height) return;

  // lane i < 20 decides bone i for the tile (ops/jointsmap.py
  // culled_tiles); a NaN anywhere fails both comparisons and culls nothing
  bool live = false;
  if (lane < kBones) {
    constexpr float kHalfX = 0.5f * (kTileCols - 1);
    constexpr float kHalfY = 0.5f * (kTileRows - 1);
    const float cs = params[lane][2], sn = params[lane][3];
    const float half_len = params[lane][4];
    const float ux = static_cast<float>(tx0) + kHalfX - params[lane][0];
    const float uy = static_cast<float>(ty0) + kHalfY - params[lane][1];
    const float ac = fabsf(cs), as = fabsf(sn);
    const float slack = cull_rel * (half_len + kBoneRadius +
                                    (fabsf(ux) + kHalfX) * ac +
                                    (fabsf(uy) + kHalfY) * as) +
                        cull_pad;
    live = !(fabsf(ux * cs + uy * sn) >
                 half_len + kHalfX * ac + kHalfY * as + slack ||
             fabsf(uy * cs - ux * sn) >
                 kBoneRadius + kHalfX * as + kHalfY * ac + slack);
  }
  unsigned int bones = __ballot_sync(0xffffffffu, live);

  // lane -> column tx0 + lane % 16, rows ty0 + lane / 16 + 2 j
  const int c = tx0 + lane % kTileCols;
  const int r0 = ty0 + lane / kTileCols;
  const float col = static_cast<float>(c);
  float best[kPixelsPerLane], value[kPixelsPerLane];
#pragma unroll
  for (int j = 0; j < kPixelsPerLane; ++j) {
    best[j] = kBig;
    value[j] = 0.0f;
  }
  while (bones) {
    const int i = __ffs(bones) - 1;  // in bone order: later bones win ties
    bones &= bones - 1;
    const float cs = params[i][2], sn = params[i][3];
    const float half_len = params[i][4], d = params[i][5];
    const float dx = __fsub_rn(col, params[i][0]);
#pragma unroll
    for (int j = 0; j < kPixelsPerLane; ++j) {
      const float row = static_cast<float>(r0 + 2 * j);
      const float dy = __fsub_rn(row, params[i][1]);
      const float u = __fadd_rn(__fmul_rn(dx, cs), __fmul_rn(dy, sn));
      const float v = __fadd_rn(__fmul_rn(-dx, sn), __fmul_rn(dy, cs));
      const float uh = __fdiv_rn(u, half_len);
      const float vr = __fdiv_rn(v, kBoneRadius);
      const bool inside =
          __fadd_rn(__fmul_rn(uh, uh), __fmul_rn(vr, vr)) <= 1.0f;
      if (inside && d <= best[j]) {
        best[j] = d;
        value[j] = params[i][6];
      }
    }
  }
  if (c >= width) return;
  float* out_b = out + static_cast<int64_t>(b) * height * width;
#pragma unroll
  for (int j = 0; j < kPixelsPerLane; ++j) {
    const int r = r0 + 2 * j;
    if (r < height) out_b[static_cast<int64_t>(r) * width + c] = value[j];
  }
}

}  // namespace

// uv: (batch, 21, 2) f32 (x, y); depth: (batch, 21) f32; out: (batch,
// height, width) f32.  All contiguous on the device; batch * height * width
// < 2^31 and batch < 2^16.  cull_rel, cull_pad: the margins of the tile
// cull (ops/jointsmap.py CULL_REL, CULL_PAD).  Launches on `stream` and
// returns cudaGetLastError() (0 on success); it does not synchronise.
extern "C" int mmhand_jointsmap(const float* uv, const float* depth,
                                float* out, int batch, int height, int width,
                                float cull_rel, float cull_pad, void* stream) {
  if (batch == 0 || height == 0 || width == 0) {
    return static_cast<int>(cudaSuccess);
  }
  const int blocks_x = (width + kBlockCols - 1) / kBlockCols;
  const int blocks_y = (height + kBlockRows - 1) / kBlockRows;
  const dim3 grid(blocks_x * blocks_y, batch);
  jointsmap_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      uv, depth, out, height, width, blocks_x, cull_rel, cull_pad);
  return static_cast<int>(cudaGetLastError());
}
