// Split bilateral + pyramid pool prepass over the planar u8 eye pair.
//
// Replaces: vsc_tpu/ops/bilateral_pallas.py  _kernel via
//   bilateral_pool_planar (reached from vsc_tpu/ops/stereo.py under
//   VSC_TPU_PP_SPLIT=1).
// Computes: for eye4 [4, B, H, W] u8 (r, g, b, valid)
//   filtered [4, B, H, W] u8: the bilateral of r, g, b on reflect-101
//     borders (csrc/bilateral.cuh, the same device function the
//     postprocess prep runs), the valid plane passed through;
//   quarter [4, B, H/4, Wq] f32 (when asked for): the two-level 2x2 average
//     ladder of the PRE-bilateral (rgb * valid, valid) stack, computed as
//     the sum of its 16 masked u8 values times 0.0625 (exact: every partial
//     sum is an integer below 2^24), with the mid level's edge column
//     repeated when W/2 is odd (Wq = ceil(W/4) in that case).
// Bound on the H100: at the default smoothing (radius 2, 12 taps) ~20 f32
//   operations and one exp per tap and pixel, against 4 bytes read and 4
//   written per pixel plus 16 bytes per quarter pixel: the operations and
//   the bytes come out close (~0.2 ms each for the [4, 4, 3240, 6090] pair).
// Design: one thread per pixel for the filter (taps through L1), one thread
//   per quarter pixel for the pool, two launches on the caller's stream.
//   The TPU kernel's strip windows, DMA double buffering and roll-based
//   symmetric tap pairing are TPU tiling choices with no use here.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bilateral.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void bilateral_kernel(const uint8_t* __restrict__ eye4,
                                 uint8_t* __restrict__ out, int B, int H,
                                 int W, vsc::BilateralTaps t) {
  const size_t plane = (size_t)B * H * W;
  const size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= plane) return;
  const int x = (int)(i % W);
  const int y = (int)((i / W) % H);
  const size_t b = i / ((size_t)W * H);
  float o[3];
  vsc::bilateral_px(eye4 + b * H * W, plane, H, W, y, x, t, o);
  for (int k = 0; k < 3; ++k) out[k * plane + i] = (uint8_t)o[k];
  out[3 * plane + i] = eye4[3 * plane + i];
}

__global__ void quarter_kernel(const uint8_t* __restrict__ eye4,
                               float* __restrict__ q, int B, int H, int W,
                               int Wq) {
  const int Hq = H / 4, W2 = W / 2;
  const size_t n = (size_t)B * Hq * Wq;
  const size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int xq = (int)(i % Wq);
  const int yq = (int)((i / Wq) % Hq);
  const size_t b = i / ((size_t)Wq * Hq);
  const size_t plane = (size_t)B * H * W;
  const uint8_t* base = eye4 + b * H * W;
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int r = 0; r < 4; ++r) {
    const size_t row = (size_t)(4 * yq + r) * W;
    for (int mid = 2 * xq; mid < 2 * xq + 2; ++mid) {
      const int m = min(mid, W2 - 1);          // the mid level's edge column
      for (int c = 0; c < 2; ++c) {
        const size_t p = row + 2 * m + c;
        const float v = (float)base[3 * plane + p];
        for (int k = 0; k < 3; ++k)
          s[k] += (float)base[k * plane + p] * v;
        s[3] += v;
      }
    }
  }
  const size_t qplane = n;
  for (int k = 0; k < 4; ++k) q[k * qplane + i] = s[k] * 0.0625f;
}

inline unsigned blocks(size_t n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

// space_w: the bilateral's space weights (host floats, the disc's row-major
// order, center excluded); quarter may be null (no pool).
extern "C" int vsc_bilateral_pool(const uint8_t* eye4, uint8_t* out,
                                  float* quarter, const float* space_w,
                                  float inv2sc, int B, int H, int W, int rb,
                                  void* stream) {
  if (rb < 1 || rb > vsc::kMaxBilRadius || B < 1 || H < 4 || W < 2 ||
      H % 4 || W % 2)
    return (int)cudaErrorInvalidValue;
  vsc::BilateralTaps t = {};
  vsc::bilateral_disc(rb, &t);
  for (int j = 0; j < t.n; ++j) t.w[j] = space_w[j];
  t.inv2sc = inv2sc;
  cudaStream_t s = (cudaStream_t)stream;
  bilateral_kernel<<<blocks((size_t)B * H * W), kThreads, 0, s>>>(
      eye4, out, B, H, W, t);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || quarter == nullptr) return (int)err;
  const int W2 = W / 2, Wq = (W2 + (W2 & 1)) / 2;
  quarter_kernel<<<blocks((size_t)B * (H / 4) * Wq), kThreads, 0, s>>>(
      eye4, quarter, B, H, W, Wq);
  return (int)cudaGetLastError();
}
