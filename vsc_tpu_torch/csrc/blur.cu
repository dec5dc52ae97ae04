// Separable gaussian blur (+ optional depth-gamma epilogue).
//
// Replaces: vsc_tpu/ops/blur_pallas.py  gaussian_blur_pallas / _kernel.
// Computes: rows pass then columns pass over a reflect-101 padded plane,
//   taps accumulated in the jnp order (acc = t0*x0; acc = acc + tk*xk), then
//   optionally clip(out, 0.001, 1) ** gamma. Products and sums use
//   __fmul_rn/__fadd_rn so nvcc does not contract them into FMAs: the kernel
//   then rounds exactly like the plain PyTorch version.
// Bound on the H100: memory. A 1080x2030 f32 plane is 8.8 MB read + 8.8 MB
//   written, ~5 us at 3.35 TB/s, against ~2*31 FLOPs per pixel per pass
//   (~0.3 GFLOP). Design: one block per 32x64 output tile stages its haloed
//   window (reflect indices resolved while loading) and the row-pass result
//   in shared memory, so every input byte is read from device memory about
//   (1 + 2r/32)(1 + 2r/64) times instead of k times per pass.

#include <cuda_runtime.h>

namespace {

constexpr int kTileH = 32;
constexpr int kTileW = 64;
constexpr int kMaxR = 15;           // ksize <= 31
constexpr int kThreads = 256;

struct Taps {
  float t[2 * kMaxR + 1];
};

__device__ __forceinline__ int reflect101(int i, int n) {
  // jnp.pad(mode="reflect"), repeated reflection for pads longer than n
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  i %= period;
  if (i < 0) i += period;
  return i < n ? i : period - i;
}

__global__ void blur_kernel(const float* __restrict__ x,
                            float* __restrict__ out, Taps taps, int H, int W,
                            int ksize, float gamma, int has_gamma) {
  __shared__ float win[(kTileH + 2 * kMaxR) * (kTileW + 2 * kMaxR)];
  __shared__ float rows[kTileH * (kTileW + 2 * kMaxR)];
  const int r = ksize / 2;
  const int ww = kTileW + 2 * r;      // window / row-pass row stride
  const int wh = kTileH + 2 * r;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const size_t plane = (size_t)H * W;
  const float* src = x + (size_t)blockIdx.z * plane;

  for (int i = threadIdx.x; i < wh * ww; i += kThreads) {
    const int yy = i / ww, xx = i % ww;
    const int sy = reflect101(y0 - r + yy, H);
    const int sx = reflect101(x0 - r + xx, W);
    win[i] = src[(size_t)sy * W + sx];
  }
  __syncthreads();

  for (int i = threadIdx.x; i < kTileH * ww; i += kThreads) {
    const int yy = i / ww, xx = i % ww;
    float acc = __fmul_rn(taps.t[0], win[yy * ww + xx]);
    for (int k = 1; k < ksize; ++k)
      acc = __fadd_rn(acc, __fmul_rn(taps.t[k], win[(yy + k) * ww + xx]));
    rows[i] = acc;
  }
  __syncthreads();

  float* dst = out + (size_t)blockIdx.z * plane;
  for (int i = threadIdx.x; i < kTileH * kTileW; i += kThreads) {
    const int yy = i / kTileW, xx = i % kTileW;
    const int gy = y0 + yy, gx = x0 + xx;
    if (gy >= H || gx >= W) continue;
    float acc = __fmul_rn(taps.t[0], rows[yy * ww + xx]);
    for (int k = 1; k < ksize; ++k)
      acc = __fadd_rn(acc, __fmul_rn(taps.t[k], rows[yy * ww + xx + k]));
    if (has_gamma) acc = powf(fminf(fmaxf(acc, 0.001f), 1.0f), gamma);
    dst[(size_t)gy * W + gx] = acc;
  }
}

}  // namespace

extern "C" int vsc_blur(const float* x, float* out, const float* taps,
                        int N, int H, int W, int ksize, float gamma,
                        int has_gamma, void* stream) {
  if (ksize < 1 || ksize > 2 * kMaxR + 1 || (ksize & 1) == 0)
    return (int)cudaErrorInvalidValue;
  if (N < 1 || N > 65535) return (int)cudaErrorInvalidValue;
  Taps t = {};
  for (int k = 0; k < ksize; ++k) t.t[k] = taps[k];
  dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, N);
  blur_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      x, out, t, H, W, ksize, gamma, has_gamma);
  return (int)cudaGetLastError();
}
