// The bilateral of one pixel, shared by csrc/postprocess.cu (the fused
// default route, bilateral inside the postprocess prep) and csrc/bilateral.cu
// (the split route), so that both routes round alike bit for bit.
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
  signed char dy[kMaxBilTaps], dx[kMaxBilTaps];
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

// Bilateral of image pixel (y, x), 0 <= y < H, 0 <= x < W, of the three u8
// planes at base (plane stride `plane`, row stride W), written to out[3] as
// floor(clip(round(num / den), 0, 255)).
__device__ __forceinline__ void bilateral_px(const uint8_t* __restrict__ base,
                                             size_t plane, int H, int W,
                                             int y, int x,
                                             const BilateralTaps& t,
                                             float out[3]) {
  float c[3];
  for (int k = 0; k < 3; ++k)
    c[k] = (float)base[k * plane + (size_t)y * W + x];
  float num[3] = {c[0], c[1], c[2]};
  float den = 1.0f;
  for (int i = 0; i < t.n; ++i) {
    const int sy = reflect101(y + t.dy[i], H);
    const int sx = reflect101(x + t.dx[i], W);
    float sh[3];
    for (int k = 0; k < 3; ++k)
      sh[k] = (float)base[k * plane + (size_t)sy * W + sx];
    const float cd = __fadd_rn(__fadd_rn(fabsf(__fsub_rn(sh[0], c[0])),
                                         fabsf(__fsub_rn(sh[1], c[1]))),
                               fabsf(__fsub_rn(sh[2], c[2])));
    const float wgt =
        __fmul_rn(t.w[i], expf(__fmul_rn(t.inv2sc, __fmul_rn(cd, cd))));
    for (int k = 0; k < 3; ++k)
      num[k] = __fadd_rn(num[k], __fmul_rn(wgt, sh[k]));
    den = __fadd_rn(den, wgt);
  }
  for (int k = 0; k < 3; ++k)
    out[k] = floorf(fminf(fmaxf(rintf(__fdiv_rn(num[k], den)), 0.0f), 255.0f));
}

// Host side: the disc's taps in row-major order (center excluded).
inline void bilateral_disc(int r, BilateralTaps* t) {
  t->n = 0;
  for (int a = -r; a <= r; ++a)
    for (int c = -r; c <= r; ++c)
      if ((a || c) && a * a + c * c <= r * r) {
        t->dy[t->n] = (signed char)a;
        t->dx[t->n] = (signed char)c;
        ++t->n;
      }
}

}  // namespace vsc
