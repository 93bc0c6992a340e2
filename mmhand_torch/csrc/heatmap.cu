// Gaussian keypoint heatmaps (kernel K1 of the port).
//
// Replaces the Pallas kernel mmhand_tpu/ops/heatmap.py `_heatmap_kernel`
// (reached through `gaussian_heatmaps_pallas`), whose grid walks one
// (batch, keypoint) plane at a time.  Here one block writes one row of the
// NHWC (B, H, W, K) output and its threads walk the row's elements, K
// fastest, so a warp's stores land on neighbouring addresses and the planes
// need no transpose afterwards.
//
//   m = exp(-((col - x)^2 + (row - y)^2) / (2 sigma^2)); m = min(m, 1);
//   m = 0 where m < 0.0099
//
// What bounds it: writes.  At B = 16, 256 x 256, K = 21 it stores 88 MB and
// reads 2.7 KB of keypoints (held in L1), against 3.35 TB/s of HBM.  The
// arithmetic keeps the reference's operation order, with no FMA contraction
// and the accurate expf: the 0.0099 clip turns a last-bit difference into a
// jump of 0.0099.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kClipLo = 0.0099f;  // reference generic_dataset.py:215
constexpr int kThreads = 256;

// One block per output row (b, row): its width * keypoints elements are
// contiguous in the output, so the block's stores are one coalesced run.
__global__ void gaussian_heatmaps_kernel(const float* __restrict__ uv,
                                         float* __restrict__ out,
                                         int height, int width, int keypoints,
                                         float denom) {
  const int plane = static_cast<int>(blockIdx.x);  // b * height + row
  const int row = plane % height;
  const float* uv_b = uv + static_cast<int64_t>(plane / height) * keypoints * 2;
  float* out_row = out + static_cast<int64_t>(plane) * width * keypoints;
  const int n = width * keypoints;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int k = e % keypoints;
    const int col = e / keypoints;
    const float dx = static_cast<float>(col) - __ldg(uv_b + 2 * k);
    const float dy = static_cast<float>(row) - __ldg(uv_b + 2 * k + 1);
    // __fmul_rn keeps the products out of an FMA with the add.
    const float d2 = __fmul_rn(dx, dx) + __fmul_rn(dy, dy);
    float m = expf(-d2 / denom);
    m = fminf(m, 1.0f);
    out_row[e] = m < kClipLo ? 0.0f : m;
  }
}

}  // namespace

// uv: (batch, keypoints, 2) f32 (x, y); out: (batch, height, width, keypoints)
// f32.  Both contiguous on the device; batch * height < 2^31 and
// width * keypoints < 2^31.  Launches on `stream` and returns
// cudaGetLastError() (0 on success); it does not synchronise.
extern "C" int mmhand_gaussian_heatmaps(const float* uv, float* out,
                                        int64_t batch, int height, int width,
                                        int keypoints, float sigma,
                                        void* stream) {
  const int64_t planes = batch * height;
  if (planes == 0 || width == 0 || keypoints == 0) {
    return static_cast<int>(cudaSuccess);
  }
  const float denom = 2.0f * sigma * sigma;
  gaussian_heatmaps_kernel<<<static_cast<unsigned int>(planes), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      uv, out, height, width, keypoints, denom);
  return static_cast<int>(cudaGetLastError());
}
