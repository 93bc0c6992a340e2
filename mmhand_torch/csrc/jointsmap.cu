// Depth-ordered bone-ellipse jointsmap (kernel K3 of the port).
//
// Replaces the Pallas kernel mmhand_tpu/ops/jointsmap.py `_jointsmap_kernel`
// (reached through `generate_jointsmap_pallas`), which keeps one image's
// (H, W) composite in VMEM and walks the 20 bones with a fori_loop, after an
// XLA pass has packed the (B, 20, 7) bone parameters.  Here one launch does
// both: each block computes its image's bone parameters into shared memory
// (20 threads, mmhand_tpu `_bone_params`'s operation order), and then each
// thread owns one pixel and walks the bones in order, keeping the nearest
// depth and its colour in registers:
//
//   u = dx cos + dy sin,  v = -dx sin + dy cos
//   inside = (u / half_len)^2 + (v / 5)^2 <= 1
//   a bone wins where it is inside and avg_depth <= best (later bones win ties)
//
// What bounds it: writes.  At B = 8, 256 x 256 it stores 2.1 MB and reads
// 1.3 KB of keypoints, against 3.35 TB/s of HBM; its ~20 operations per bone
// and pixel are about 10 MFLOP.  At that size the launch itself dominates.
//
// Every operation is one IEEE rounding (the _rn intrinsics): an FMA formed
// from dx*cos + dy*sin rounds once where the reference rounds twice, and a
// pixel on an ellipse's boundary then flips.  So the kernel equals the plain
// version (ops/jointsmap.py) and mmhand_tpu bit for bit.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBones = 20;
constexpr int kJoints = 21;
constexpr int kThreads = 256;
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

// grid (ceil(H*W / kThreads), B): block (x, b) owns kThreads pixels of image b.
__global__ void jointsmap_kernel(const float* __restrict__ uv,
                                 const float* __restrict__ depth,
                                 float* __restrict__ out, int height,
                                 int width) {
  // mx, my, cos, sin, half_len, avg_depth, colour
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

  const int pixels = height * width;
  const int p = static_cast<int>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= pixels) return;
  const float row = static_cast<float>(p / width);
  const float col = static_cast<float>(p % width);
  float best = kBig;
  float value = 0.0f;
#pragma unroll 4
  for (int i = 0; i < kBones; ++i) {
    const float cs = params[i][2], sn = params[i][3];
    const float dx = __fsub_rn(col, params[i][0]);
    const float dy = __fsub_rn(row, params[i][1]);
    const float u = __fadd_rn(__fmul_rn(dx, cs), __fmul_rn(dy, sn));
    const float v = __fadd_rn(__fmul_rn(-dx, sn), __fmul_rn(dy, cs));
    const float uh = __fdiv_rn(u, params[i][4]);
    const float vr = __fdiv_rn(v, kBoneRadius);
    const bool inside = __fadd_rn(__fmul_rn(uh, uh), __fmul_rn(vr, vr)) <= 1.0f;
    const float d = params[i][5];
    if (inside && d <= best) {
      best = d;
      value = params[i][6];
    }
  }
  out[static_cast<int64_t>(b) * pixels + p] = value;
}

}  // namespace

// uv: (batch, 21, 2) f32 (x, y); depth: (batch, 21) f32; out: (batch,
// height, width) f32.  All contiguous on the device; batch * height * width
// < 2^31 and batch < 2^16.  Launches on `stream` and returns
// cudaGetLastError() (0 on success); it does not synchronise.
extern "C" int mmhand_jointsmap(const float* uv, const float* depth,
                                float* out, int batch, int height, int width,
                                void* stream) {
  const int pixels = height * width;
  if (batch == 0 || pixels == 0) {
    return static_cast<int>(cudaSuccess);
  }
  const dim3 grid((pixels + kThreads - 1) / kThreads, batch);
  jointsmap_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      uv, depth, out, height, width);
  return static_cast<int>(cudaGetLastError());
}
