// 2x2 / 4x4 average pools of the inpaint pyramid prepass.
//
// Replaces: vsc_tpu/ops/pool_pallas.py  _eye4_pool (entries avgpool2_eye4,
//   avgpool4_eye4) and avgpool2 (the transpose-pool idiom, which exists
//   only because Mosaic cannot lower stride-2 selects).
// Computes:
//   eye4: [4, B, H, W] uint8 (r, g, b, valid) -> [4, B, H/f, W/f] float32,
//     the f x f means of (r * valid, g * valid, b * valid, valid), f = 2
//     or 4; the masked colors are formed in-kernel, so no full-resolution
//     f32 plane exists in device memory. Every partial sum is an integer
//     <= 16 * 255 and the scale a power of two, so the result is exact in
//     any order: bit-identical to avgpool2 applied log2(f) times.
//   f32: [N, H, W] -> [N, H/2, W/2], ((a + c) + (b + d)) * 0.25 with a, b
//     the top row: rows summed first, as the jnp average of averages rounds
//     (its * 0.5 steps are exact), so bit-identical to _avgpool2_hw.
// Bound on the H100: memory. The 1080p super_sampling 3 pair reads 316 MB
//   of u8 and writes 316 MB of f32 (~0.2 ms at 3.35 TB/s). Design: one
//   thread per output pixel, threads along the row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void pool_eye4_kernel(const uint8_t* __restrict__ in,
                                 float* __restrict__ out, int B, int H, int W,
                                 int f, float scale) {
  const int Ho = H / f, Wo = W / f;
  const int x = blockIdx.x * kThreads + threadIdx.x;
  const int y = blockIdx.y;
  const int b = blockIdx.z;
  if (x >= Wo) return;
  const size_t plane = (size_t)B * H * W;
  const uint8_t* base = in + (size_t)b * H * W + (size_t)(y * f) * W + x * f;
  float sum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int dx = 0; dx < f; ++dx) {
    for (int dy = 0; dy < f; ++dy) {
      const size_t off = (size_t)dy * W + dx;
      const float v = (float)base[3 * plane + off];
      sum[3] += v;
      for (int c = 0; c < 3; ++c) sum[c] += (float)base[c * plane + off] * v;
    }
  }
  const size_t oplane = (size_t)B * Ho * Wo;
  const size_t o = (size_t)b * Ho * Wo + (size_t)y * Wo + x;
  for (int c = 0; c < 4; ++c) out[c * oplane + o] = sum[c] * scale;
}

__global__ void pool2_kernel(const float* __restrict__ in,
                             float* __restrict__ out, int H, int W) {
  const int Ho = H / 2, Wo = W / 2;
  const int x = blockIdx.x * kThreads + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= Wo) return;
  const float* r0 = in + (size_t)blockIdx.z * H * W + (size_t)(2 * y) * W + 2 * x;
  const float* r1 = r0 + W;
  const float s = __fadd_rn(__fadd_rn(r0[0], r1[0]), __fadd_rn(r0[1], r1[1]));
  out[(size_t)blockIdx.z * Ho * Wo + (size_t)y * Wo + x] = __fmul_rn(s, 0.25f);
}

}  // namespace

extern "C" int vsc_pool_eye4(const uint8_t* in, float* out, int B, int H,
                             int W, int f, void* stream) {
  if ((f != 2 && f != 4) || B < 1 || B > 65535 || H < f || W < f
      || H % f || W % f || H / f > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((W / f + kThreads - 1) / kThreads, H / f, B);
  pool_eye4_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      in, out, B, H, W, f, 1.0f / (float)(f * f));
  return (int)cudaGetLastError();
}

extern "C" int vsc_pool2(const float* in, float* out, int N, int H, int W,
                         void* stream) {
  if (N < 1 || N > 65535 || H < 2 || W < 2 || H % 2 || W % 2
      || H / 2 > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((W / 2 + kThreads - 1) / kThreads, H / 2, N);
  pool2_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(in, out, H, W);
  return (int)cudaGetLastError();
}
