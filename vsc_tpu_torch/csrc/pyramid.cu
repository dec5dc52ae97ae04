// Masked push-pull pyramid below the handoff level, one launch.
//
// Replaces: vsc_tpu/ops/pyramid_pallas.py  pyramid_fill_below / _kernel.
// Computes: for every frame n of quarter [4, N, h, w] float32 (img * valid
//   for r, g, b, then the pooled valid), the level ladder down to 1 x 1 and
//   back: each pool edge-pads odd dims and takes ((a + c) + (b + d)) * 0.25
//   (rows first, as the jnp average of averages rounds); the top level is
//   img / max(msk, 1e-8); going up, a level keeps img / max(msk, 1e-8)
//   where msk > 1e-8 and otherwise the nearest 2x expansion of the level
//   above (plain replication: a level is always ceil(parent / 2)). IEEE
//   divides and no FMA contraction, so every level is bit-identical to the
//   torch ladder (ops/inpaint.py _push_pull_hw). Out: [3, N, h, w] float32.
// Bound on the H100: latency. At 1080p super_sampling 3 the input is
//   [4, 4, 203, 381] (5 MB) and the ladder has 9 pool levels, each
//   dependent on the last. Design: one block per frame runs the whole
//   ladder with __syncthreads() between levels; the levels live in a
//   global workspace the wrapper allocates (~1.6 MB per frame, so it stays
//   in L2), level l's four planes at workspace offset sum_{m<l} 4 h_m w_m.
//   Nothing of the ladder goes back to the host and it takes one launch
//   instead of ~50 small ones.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxLevels = 33;   // int dims halve to 1 in <= 31 steps

// ws is read and written across __syncthreads(), so it is not __restrict__
__global__ void __launch_bounds__(kThreads)
    pyramid_kernel(const float* __restrict__ q, float* __restrict__ out,
                   float* ws, int N, int h, int w, size_t ws_per_frame) {
  const int n = blockIdx.x;
  const size_t in_plane = (size_t)N * h * w;
  int lh[kMaxLevels], lw[kMaxLevels];
  size_t loff[kMaxLevels];
  int L = 0;
  lh[0] = h;
  lw[0] = w;
  loff[0] = 0;
  size_t off = 0;
  while (lh[L] > 1 || lw[L] > 1) {
    lh[L + 1] = (lh[L] + 1) / 2;
    lw[L + 1] = (lw[L] + 1) / 2;
    loff[L + 1] = off;
    off += (size_t)4 * lh[L + 1] * lw[L + 1];
    ++L;
  }
  float* frame_ws = ws + (size_t)n * ws_per_frame;
  // plane c of level l
  auto plane = [&](int l, int c) -> float* {
    if (l == 0) return const_cast<float*>(q) + c * in_plane + (size_t)n * h * w;
    return frame_ws + loff[l] + (size_t)c * lh[l] * lw[l];
  };

  // push: pool level l into level l + 1
  for (int l = 0; l < L; ++l) {
    const int ph = lh[l], pw = lw[l], ch = lh[l + 1], cw = lw[l + 1];
    const int area = ch * cw;
    for (int i = threadIdx.x; i < 4 * area; i += kThreads) {
      const int c = i / area, p = i - c * area;
      const int y = p / cw, x = p - y * cw;
      const int y0 = 2 * y, y1 = min(2 * y + 1, ph - 1);
      const int x0 = 2 * x, x1 = min(2 * x + 1, pw - 1);
      const float* s = plane(l, c);
      const float a = s[y0 * pw + x0], b = s[y0 * pw + x1];
      const float cc = s[y1 * pw + x0], d = s[y1 * pw + x1];
      plane(l + 1, c)[p] =
          __fmul_rn(__fadd_rn(__fadd_rn(a, cc), __fadd_rn(b, d)), 0.25f);
    }
    __syncthreads();
  }

  // top level: divide (written in place over its color planes, or out)
  {
    const int area = lh[L] * lw[L];
    const float* msk = plane(L, 3);
    for (int i = threadIdx.x; i < 3 * area; i += kThreads) {
      const int c = i / area, p = i - c * area;
      const float v = plane(L, c)[p] / fmaxf(msk[p], 1e-8f);
      if (L == 0) out[c * in_plane + (size_t)n * h * w + p] = v;
      else plane(L, c)[p] = v;
    }
    __syncthreads();
  }

  // pull: level l from its own img / msk and the filled level l + 1
  for (int l = L - 1; l >= 0; --l) {
    const int hh = lh[l], ww = lw[l], cw = lw[l + 1];
    const int area = hh * ww;
    const float* msk = plane(l, 3);
    for (int i = threadIdx.x; i < 3 * area; i += kThreads) {
      const int c = i / area, p = i - c * area;
      const int y = p / ww, x = p - y * ww;
      const float m = msk[p];
      const float v = m > 1e-8f
          ? plane(l, c)[p] / fmaxf(m, 1e-8f)
          : plane(l + 1, c)[(y / 2) * cw + x / 2];
      if (l == 0) out[c * in_plane + (size_t)n * h * w + p] = v;
      else plane(l, c)[p] = v;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int vsc_pyramid(const float* q, float* out, float* ws, int N,
                           int h, int w, long long ws_per_frame,
                           void* stream) {
  if (N < 1 || h < 1 || w < 1) return (int)cudaErrorInvalidValue;
  pyramid_kernel<<<N, kThreads, 0, (cudaStream_t)stream>>>(
      q, out, ws, N, h, w, (size_t)ws_per_frame);
  return (int)cudaGetLastError();
}
