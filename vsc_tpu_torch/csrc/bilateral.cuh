// The bilateral of one pixel, shared by csrc/postprocess.cu (the fused
// default route, bilateral inside the postprocess tile) and csrc/bilateral.cu
// (the split route, its color weights from a table of color_weight), so
// that both routes round alike bit for bit.
//
// cv2 weight laws as ops/postprocess_cuda.py states them: taps over the disc
// dy^2 + dx^2 <= r^2 (center excluded) in row-major order with space weights
// from the host, color weight exp(inv2sc * d^2) on the L1 distance of the
// three channels, reflect-101 borders; every accumulation in that order with
// unfused IEEE operations, as the plain version (bilateral_plain) runs it.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace vsc {

constexpr int kMaxBilRadius = 7;  // d <= 15
constexpr int kMaxBilTaps = (2 * kMaxBilRadius + 1) * (2 * kMaxBilRadius + 1);

struct BilateralTaps {
  int n;                        // taps, center excluded
  float w[kMaxBilTaps];         // space weights (host, float32)
  float inv2sc;                 // -0.5 / sigma_color^2
};

__device__ __forceinline__ int reflect101(int i, int n) {
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  i %= period;
  if (i < 0) i += period;
  return i < n ? i : period - i;
}

// The color weight of L1 color distance cd.
__device__ __forceinline__ float color_weight(float inv2sc, float cd) {
  return expf(__fmul_rn(inv2sc, __fmul_rn(cd, cd)));
}

// The bilateral sum of one pixel: start from its colors c[3], add each
// tap's colors sh[3] with its space weight in the disc's order, then
// finish to floor(clip(round(num / den), 0, 255)). Both callers read the
// colors from a shared-memory tile that already holds the reflected
// colors, and share this arithmetic.
struct BilateralSum {
  float c[3], num[3], den;

  __device__ __forceinline__ explicit BilateralSum(const float center[3]) {
    for (int k = 0; k < 3; ++k) c[k] = num[k] = center[k];
    den = 1.0f;
  }

  // the L1 distance of a tap's colors to the center's
  __device__ __forceinline__ float distance(const float sh[3]) const {
    return __fadd_rn(__fadd_rn(fabsf(__fsub_rn(sh[0], c[0])),
                               fabsf(__fsub_rn(sh[1], c[1]))),
                     fabsf(__fsub_rn(sh[2], c[2])));
  }

  // a tap of weight wgt (its space weight times its color weight)
  __device__ __forceinline__ void add(float wgt, const float sh[3]) {
    for (int k = 0; k < 3; ++k)
      num[k] = __fadd_rn(num[k], __fmul_rn(wgt, sh[k]));
    den = __fadd_rn(den, wgt);
  }

  __device__ __forceinline__ void tap(float space_w, float inv2sc,
                                      const float sh[3]) {
    add(__fmul_rn(space_w, color_weight(inv2sc, distance(sh))), sh);
  }

  __device__ __forceinline__ void finish(float out[3]) const {
    for (int k = 0; k < 3; ++k)
      out[k] =
          floorf(fminf(fmaxf(rintf(__fdiv_rn(num[k], den)), 0.0f), 255.0f));
  }
};

// Host side: the disc's tap count (center excluded); the kernels unroll
// its taps in row-major order.
inline void bilateral_disc(int r, BilateralTaps* t) {
  t->n = 0;
  for (int a = -r; a <= r; ++a)
    for (int c = -r; c <= r; ++c) t->n += (a || c) && a * a + c * c <= r * r;
}

}  // namespace vsc
