// Fused finish: unsharp mask + integer-ratio area downscale.
//
// Replaces: vsc_tpu/ops/finish_pallas.py  _kernel via
//   _sharpen_downscale_planes (entries sharpen_downscale_planar, u8 out,
//   and sharpen_downscale, f32 out; the banded box matmuls with bf16 hi/lo
//   splits are not carried over).
// Computes: for each frame n, channel c and output pixel (oy, ox) of
//   [3, N, H, Wf] uint8 planes cropped to the columns [off, off + crop_w)
//   (off = off0 for frames n < nsplit, else off1, so both eyes of the pair
//   are read from the uncropped postprocess output): at each of the
//   ratio x ratio input pixels of the box, the separable 5-tap gaussian
//   (sigma 1) horizontally then vertically, in tap order, over reflect-101
//   borders inside the crop (jnp.pad(mode="reflect")); then
//   sharp = clip(x + s * (x - blur), 0, 255); the box sum over rows, then
//   over columns; division by ratio^2; and for u8 output floor(clip(., 0,
//   255)). __fmul_rn/__fadd_rn/__fdiv_rn keep the plain version's order and
//   rounding (no FMA contraction), so kernel and plain version agree
//   exactly.
// Bound on the H100: memory and L1. The 1080p super_sampling 3 pair reads
//   224 MB of u8 and writes 25 MB; each input pixel needs 10 multiply-adds.
//   Design: one block per 8 x 32 output tile and channel stages the
//   reflected u8 window (reflect indices resolved while loading) and the
//   horizontal pass in shared memory; one thread per output pixel then runs
//   the vertical pass, the sharpen and the box sum of its ratio^2 pixels.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileH = 8;
constexpr int kTileW = 32;
constexpr int kThreads = kTileH * kTileW;
constexpr int kMaxRatio = 8;

struct Taps {
  float t[5];
};

__device__ __forceinline__ int reflect101(int i, int n) {
  if (i >= 0 && i < n) return i;   // the common case: no division
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  i %= period;
  if (i < 0) i += period;
  return i < n ? i : period - i;
}

size_t smem_bytes(int r) {
  const int wr = kTileH * r + 4, wc = kTileW * r + 4;
  const size_t win = ((size_t)wr * wc + 15) / 16 * 16;
  return win + (size_t)wr * kTileW * r * sizeof(float);
}

template <bool kU8>
__global__ void sharpen_downscale_kernel(
    const uint8_t* __restrict__ x, void* __restrict__ out, Taps k, int N,
    int H, int Wf, int crop_w, int off0, int off1, int nsplit, int r,
    float strength, int out_h, int out_w) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int wr = kTileH * r + 4, wc = kTileW * r + 4, hc = kTileW * r;
  uint8_t* win = smem;
  float* hconv = reinterpret_cast<float*>(smem + ((size_t)wr * wc + 15) / 16 * 16);
  const int n = blockIdx.z / 3, c = blockIdx.z - 3 * (blockIdx.z / 3);
  const int off = n < nsplit ? off0 : off1;
  const int y0 = blockIdx.y * kTileH * r, x0 = blockIdx.x * kTileW * r;
  const uint8_t* src = x + ((size_t)c * N + n) * H * Wf + off;

  for (int i = threadIdx.x; i < wr * wc; i += kThreads) {
    const int yy = i / wc, xx = i - yy * wc;
    win[i] = src[(size_t)reflect101(y0 - 2 + yy, H) * Wf
                 + reflect101(x0 - 2 + xx, crop_w)];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < wr * hc; i += kThreads) {
    const int yy = i / hc, xx = i - yy * hc;
    const uint8_t* w = win + yy * wc + xx;
    float acc = __fmul_rn(k.t[0], (float)w[0]);
    for (int t = 1; t < 5; ++t) acc = __fadd_rn(acc, __fmul_rn(k.t[t], (float)w[t]));
    hconv[i] = acc;
  }
  __syncthreads();

  const int ty = threadIdx.x / kTileW, tx = threadIdx.x - ty * kTileW;
  const int oy = blockIdx.y * kTileH + ty, ox = blockIdx.x * kTileW + tx;
  if (oy >= out_h || ox >= out_w) return;
  float total = 0.0f;
  for (int j = 0; j < r; ++j) {
    const int lx = tx * r + j;
    float col = 0.0f;
    for (int i = 0; i < r; ++i) {
      const int ly = ty * r + i;
      float blur = __fmul_rn(k.t[0], hconv[ly * hc + lx]);
      for (int t = 1; t < 5; ++t)
        blur = __fadd_rn(blur, __fmul_rn(k.t[t], hconv[(ly + t) * hc + lx]));
      const float ctr = (float)win[(ly + 2) * wc + lx + 2];
      const float sharp = fminf(fmaxf(
          __fadd_rn(ctr, __fmul_rn(strength, __fsub_rn(ctr, blur))), 0.0f),
          255.0f);
      col = i == 0 ? sharp : __fadd_rn(col, sharp);
    }
    total = j == 0 ? col : __fadd_rn(total, col);
  }
  const float res = __fdiv_rn(total, (float)(r * r));
  const size_t o = (((size_t)c * N + n) * out_h + oy) * out_w + ox;
  if (kU8)
    static_cast<uint8_t*>(out)[o] =
        (uint8_t)floorf(fminf(fmaxf(res, 0.0f), 255.0f));
  else
    static_cast<float*>(out)[o] = res;
}

}  // namespace

extern "C" int vsc_finish(const uint8_t* x, void* out, const float* taps,
                          int N, int H, int Wf, int crop_w, int off0,
                          int off1, int nsplit, int ratio, float strength,
                          int out_h, int out_w, int out_u8, void* stream) {
  if (N < 1 || 3 * N > 65535 || ratio < 1 || ratio > kMaxRatio
      || out_h < 1 || out_w < 1 || out_h * ratio > H
      || out_w * ratio > crop_w || off0 < 0 || off1 < 0
      || off0 + crop_w > Wf || off1 + crop_w > Wf)
    return (int)cudaErrorInvalidValue;
  Taps k;
  for (int t = 0; t < 5; ++t) k.t[t] = taps[t];
  const size_t smem = smem_bytes(ratio);
  dim3 grid((out_w + kTileW - 1) / kTileW, (out_h + kTileH - 1) / kTileH,
            3 * N);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (out_u8) {
    e = cudaFuncSetAttribute(sharpen_downscale_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    sharpen_downscale_kernel<true><<<grid, kThreads, smem, s>>>(
        x, out, k, N, H, Wf, crop_w, off0, off1, nsplit, ratio, strength,
        out_h, out_w);
  } else {
    e = cudaFuncSetAttribute(sharpen_downscale_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    sharpen_downscale_kernel<false><<<grid, kThreads, smem, s>>>(
        x, out, k, N, H, Wf, crop_w, off0, off1, nsplit, ratio, strength,
        out_h, out_w);
  }
  return (int)cudaGetLastError();
}
