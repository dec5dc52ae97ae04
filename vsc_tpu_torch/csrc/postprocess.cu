// Per-eye postprocess: bilateral + hole dilation + frontier fill + polish.
//
// Replaces: vsc_tpu/ops/postprocess_pallas.py  _kernel via
//   postprocess_eye_planar_pallas (compat entry postprocess_eye_pallas).
// Computes: the Pallas kernel's semantics over the image plus a margin of
//   M = rb + 1 + 2*kSweeps + 3 pixels (its total stencil reach), with
//   the colors reflect-101 padded and the valid plane zero outside the image
//   (see the docstring of ops/postprocess_cuda.py for the five stages).
//   Weights come from the host in the plain version's order and every
//   accumulation runs in that order with unfused IEEE operations, so the
//   kernel rounds like the plain PyTorch version. A margin pixel takes the
//   bilateral of the image pixel it reflects (csrc/bilateral.cuh, shared
//   with the split route's csrc/bilateral.cu), so the split route, which
//   reflects the filtered image, equals this one bit for bit.
// Form: a short chain of simple kernels instead of one fused tile kernel:
//   prep (bilateral + dilated hole mask + initial known set, over image and
//   margin), one launch per frontier sweep (ping-pong buffers), and finish
//   (interior estimate + radius-3 polish + u8 store, image pixels only).
// Bound on the H100: the bilateral, ~13 taps x (3 abs + exp + 4 FMA) per
//   pixel at the default smoothing (~0.3 G exp for two 1080x2030 eyes of a
//   batch of 2), then memory: each sweep reads and writes the 3-plane f32
//   value buffer (~55 MB per eye), ~5 such passes per eye. Design: one
//   thread per pixel, neighbours through L1; the fused halo-tile form that
//   keeps every stage on chip and skips hole-free tiles is later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bilateral.cuh"

namespace {

using vsc::reflect101;

constexpr int kThreads = 256;
constexpr int kMaxRb = vsc::kMaxBilRadius;
constexpr int kFillR = 2;
constexpr int kSweeps = 3;                        // SWEEPS in the wrapper
constexpr int kPolishR = 3;
constexpr int kMaxFill = (2 * kFillR + 1) * (2 * kFillR + 1);
constexpr int kMaxPolish = (2 * kPolishR + 1) * (2 * kPolishR + 1);

struct Offsets {
  int nf, np;
  signed char fdy[kMaxFill], fdx[kMaxFill];
  signed char pdy[kMaxPolish], pdx[kMaxPolish];
  float fw[kMaxFill], pw[kMaxPolish];
  float wsum;
  vsc::BilateralTaps bil;
};

struct Geom {
  int B, H, W, Hq, Wq, M, Hd, Wd, rb;
};

__device__ __forceinline__ bool in_image(const Geom& g, int yd, int xd) {
  const int y = yd - g.M, x = xd - g.M;
  return y >= 0 && y < g.H && x >= 0 && x < g.W;
}

// prep: bilateral colors, keep mask and initial known/value planes over the
// domain [0, Hd) x [0, Wd) (domain (yd, xd) = image (yd - M, xd - M)).
__global__ void prep_kernel(const uint8_t* __restrict__ eye4, Geom g,
                            Offsets o, uint8_t* __restrict__ chans,
                            uint8_t* __restrict__ keep,
                            uint8_t* __restrict__ known,
                            float* __restrict__ v) {
  const size_t n = (size_t)g.B * g.Hd * g.Wd;
  const size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int xd = (int)(i % g.Wd);
  const int yd = (int)((i / g.Wd) % g.Hd);
  const int b = (int)(i / ((size_t)g.Wd * g.Hd));
  const size_t plane = (size_t)g.B * g.H * g.W;
  const uint8_t* base = eye4 + (size_t)b * g.H * g.W;
  const int y = yd - g.M, x = xd - g.M;
  const int ry = reflect101(y, g.H), rx = reflect101(x, g.W);
  float out[3];
  if (g.rb > 0) {
    vsc::bilateral_px(base, plane, g.H, g.W, ry, rx, o.bil, out);
  } else {
    for (int k = 0; k < 3; ++k)
      out[k] = (float)base[k * plane + (size_t)ry * g.W + rx];
  }
  // 3x3 dilation of the in-image holes
  bool hole = false;
  for (int dy = -1; dy <= 1 && !hole; ++dy)
    for (int dx = -1; dx <= 1; ++dx) {
      const int qy = yd + dy, qx = xd + dx;
      if (!in_image(g, qy, qx)) continue;
      const uint8_t val =
          base[3 * plane + (size_t)(qy - g.M) * g.W + (qx - g.M)];
      if (val == 0) { hole = true; break; }
    }
  const bool inimg = in_image(g, yd, xd);
  const bool kp = !(hole && inimg);
  const bool kn = kp && inimg;
  const size_t dplane = (size_t)g.B * g.Hd * g.Wd;
  for (int k = 0; k < 3; ++k) {
    chans[k * dplane + i] = (uint8_t)out[k];
    v[k * dplane + i] = kn ? out[k] : 0.0f;
  }
  keep[i] = kp;
  known[i] = kn;
}

// one radius-2 frontier sweep over the domain
__global__ void sweep_kernel(Geom g, Offsets o,
                             const float* __restrict__ v_in,
                             const uint8_t* __restrict__ k_in,
                             float* __restrict__ v_out,
                             uint8_t* __restrict__ k_out) {
  const size_t dplane = (size_t)g.B * g.Hd * g.Wd;
  const size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= dplane) return;
  const int xd = (int)(i % g.Wd);
  const int yd = (int)((i / g.Wd) % g.Hd);
  const size_t row0 = i - (size_t)yd * g.Wd - xd;   // (b, 0, 0)
  float acc[3] = {0.0f, 0.0f, 0.0f};
  float acck = 0.0f;
  for (int t = 0; t < o.nf; ++t) {
    const int qy = yd + o.fdy[t], qx = xd + o.fdx[t];
    if (qy < 0 || qy >= g.Hd || qx < 0 || qx >= g.Wd) continue;
    const size_t q = row0 + (size_t)qy * g.Wd + qx;
    if (!k_in[q]) continue;                 // weight * 0 adds exactly 0
    const float wk = o.fw[t];
    for (int k = 0; k < 3; ++k)
      acc[k] = __fadd_rn(acc[k], __fmul_rn(wk, v_in[k * dplane + q]));
    acck = __fadd_rn(acck, wk);
  }
  const bool known = k_in[i] != 0;
  const bool reach = acck > 1e-8f;
  const bool upd = !known && reach;
  const float inv_den = __fdiv_rn(1.0f, fmaxf(acck, 1e-8f));
  for (int k = 0; k < 3; ++k)
    v_out[k * dplane + i] =
        upd ? __fmul_rn(acc[k], inv_den) : v_in[k * dplane + i];
  k_out[i] = known || reach;
}

__device__ __forceinline__ float fill_value(const Geom& g, int k, size_t q,
                                            int qy, int qx, int b,
                                            const uint8_t* chans,
                                            const uint8_t* keep,
                                            const uint8_t* known,
                                            const float* v,
                                            const float* smooth_q,
                                            size_t dplane) {
  if (keep[q]) return (float)chans[k * dplane + q];
  if (known[q]) return v[k * dplane + q];
  int sy = (qy - g.M) >> 2, sx = (qx - g.M) >> 2;   // floor division
  sy = min(max(sy, 0), g.Hq - 1);
  sx = min(max(sx, 0), g.Wq - 1);
  return smooth_q[((size_t)k * g.B + b) * g.Hq * g.Wq + (size_t)sy * g.Wq + sx];
}

// interior estimate + radius-3 polish + u8 store, image pixels only
__global__ void finish_kernel(Geom g, Offsets o,
                              const uint8_t* __restrict__ chans,
                              const uint8_t* __restrict__ keep,
                              const uint8_t* __restrict__ known,
                              const float* __restrict__ v,
                              const float* __restrict__ smooth_q,
                              uint8_t* __restrict__ out) {
  const size_t n = (size_t)g.B * g.H * g.W;
  const size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int x = (int)(i % g.W);
  const int y = (int)((i / g.W) % g.H);
  const int b = (int)(i / ((size_t)g.W * g.H));
  const size_t dplane = (size_t)g.B * g.Hd * g.Wd;
  const size_t row0 = (size_t)b * g.Hd * g.Wd;
  const int yd = y + g.M, xd = x + g.M;
  const size_t p = row0 + (size_t)yd * g.Wd + xd;
  for (int k = 0; k < 3; ++k) {
    float val;
    if (keep[p]) {
      val = (float)chans[k * dplane + p];
    } else {
      float acc = 0.0f;
      for (int t = 0; t < o.np; ++t) {
        const int qy = yd + o.pdy[t], qx = xd + o.pdx[t];
        if (qy < 0 || qy >= g.Hd || qx < 0 || qx >= g.Wd) continue;
        const size_t q = row0 + (size_t)qy * g.Wd + qx;
        acc = __fadd_rn(acc, __fmul_rn(o.pw[t],
                                       fill_value(g, k, q, qy, qx, b, chans,
                                                  keep, known, v, smooth_q,
                                                  dplane)));
      }
      val = __fdiv_rn(acc, o.wsum);
    }
    out[(size_t)k * n + i] = (uint8_t)rintf(fminf(fmaxf(val, 0.0f), 255.0f));
  }
}

void disc(int r, int r2max, int* n, signed char* dy, signed char* dx) {
  *n = 0;
  for (int a = -r; a <= r; ++a)
    for (int c = -r; c <= r; ++c)
      if ((a || c) && a * a + c * c <= r2max) {
        dy[*n] = (signed char)a;
        dx[*n] = (signed char)c;
        ++*n;
      }
}

inline unsigned blocks(size_t n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace

// tables (host floats, in the plain version's order):
//   [fill weights (nf), polish weights (np), wsum, inv2sc,
//    bilateral space weights (nb)]
extern "C" int vsc_postprocess(const uint8_t* eye4, const float* smooth_q,
                               uint8_t* out, uint8_t* chans, float* v0,
                               float* v1, uint8_t* k0, uint8_t* k1,
                               uint8_t* keep, const float* tables, int B,
                               int H, int W, int Hq, int Wq, int M, int rb,
                               void* stream) {
  if (rb < 0 || rb > kMaxRb || B < 1 || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  Offsets o = {};
  disc(kFillR, kFillR * kFillR + 1, &o.nf, o.fdy, o.fdx);
  disc(kPolishR, kPolishR * kPolishR + 1, &o.np, o.pdy, o.pdx);
  vsc::bilateral_disc(rb, &o.bil);
  int t = 0;
  for (int j = 0; j < o.nf; ++j) o.fw[j] = tables[t++];
  for (int j = 0; j < o.np; ++j) o.pw[j] = tables[t++];
  o.wsum = tables[t++];
  o.bil.inv2sc = tables[t++];
  for (int j = 0; j < o.bil.n; ++j) o.bil.w[j] = tables[t++];
  Geom g = {B, H, W, Hq, Wq, M, H + 2 * M, W + 2 * M, rb};
  cudaStream_t s = (cudaStream_t)stream;
  const size_t nd = (size_t)B * g.Hd * g.Wd;
  prep_kernel<<<blocks(nd), kThreads, 0, s>>>(eye4, g, o, chans, keep, k0, v0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  float* v[2] = {v0, v1};
  uint8_t* k[2] = {k0, k1};
  int cur = 0;
  for (int it = 0; it < kSweeps; ++it) {
    sweep_kernel<<<blocks(nd), kThreads, 0, s>>>(g, o, v[cur], k[cur],
                                                 v[1 - cur], k[1 - cur]);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    cur = 1 - cur;
  }
  finish_kernel<<<blocks((size_t)B * H * W), kThreads, 0, s>>>(
      g, o, chans, keep, k[cur], v[cur], smooth_q, out);
  return (int)cudaGetLastError();
}
