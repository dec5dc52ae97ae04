// Integer-factor bilinear upsample (half-pixel source mapping, clamped edges).
//
// Replaces: vsc_tpu/ops/upsample_pallas.py  upsample_bilinear_int_pallas /
//   _kernel (banded matmuls on the MXU with bf16 hi/lo operand splits).
// Computes: out[n, f*i + p, f*j + q] from the source rows i + d0[p] and
//   i + d0[p] + 1 and the columns j + d0[q] and j + d0[q] + 1, each clamped
//   into the plane, where d0[p] = floor((2p + 1 - f) / 2f).
//   f32 mode (the depth plane): exactly the plain phase decomposition
//   (ops/resize.py _upsample_axis_int) in its order, rows first and then
//   columns, each as (1 - w1) * a + w1 * b with the per-phase f32 weights the
//   host computed in double and rounded; a phase with w1 == 0 copies a.
//   __fmul_rn/__fadd_rn keep nvcc from contracting into FMAs, so the kernel
//   equals its plain version bit for bit.
//   u8 mode (RGB, the warp's input quantization fused in): the exact rational
//   result floor(sum_rows sum_cols wr * wc * x / (2f)^2) with the integer band
//   weights (2f - k, k), k = (2p + 1 - f) mod 2f, in int32; clamped edge taps
//   hit one source and their weights add. The TPU kernel computes the same
//   value exactly, so kernel, plain version and the JAX kernel agree bit for
//   bit. Input values must be integers in [0, 255].
// Bound on the H100: memory. At 1080p, super_sampling 3, batch 2 the RGB
//   pass writes 118 MB of u8 and the depth pass 158 MB of f32 against 52 MB
//   and 18 MB read (~0.1 ms at 3.35 TB/s). Design: one thread per source
//   pixel loads its clamped 3 x 3 neighbourhood once and writes all f x f
//   outputs that draw from it; threads run along the source row, so each
//   output row of a warp is one contiguous run of 32 f values (one thread
//   per output pixel would spend four loads and two divisions on every byte
//   it writes).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxF = 8;

struct Phases {
  int d0[kMaxF];    // source offset of the first tap, per phase
  int k[kMaxF];     // integer weight of the second tap (first: 2f - k)
  float wa[kMaxF];  // f32 (1 - w1)
  float wb[kMaxF];  // f32 w1 (0: copy the first tap)
};

__device__ __forceinline__ int clampi(int v, int hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

__device__ __forceinline__ float lerp_rn(float a, float b, float wa, float wb) {
  if (wb == 0.0f) return a;
  return __fadd_rn(__fmul_rn(wa, a), __fmul_rn(wb, b));
}

template <bool kU8>
__global__ void upsample_kernel(const float* __restrict__ x,
                                void* __restrict__ out, Phases ph, int H,
                                int W, int f) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  const int i = blockIdx.y;
  const int n = blockIdx.z;
  if (j >= W) return;
  // the clamped 3 x 3 source neighbourhood every phase draws from (d0 is
  // -1 or 0, so the taps are rows i - 1 .. i + 1, columns j - 1 .. j + 1)
  const float* src = x + (size_t)n * H * W;
  float v[3][3];
  for (int a = 0; a < 3; ++a) {
    const float* row = src + (size_t)clampi(i + a - 1, H - 1) * W;
    for (int b = 0; b < 3; ++b) v[a][b] = __ldg(row + clampi(j + b - 1, W - 1));
  }
  const int OW = W * f;
  const int f2 = 2 * f;
  for (int p = 0; p < f; ++p) {
    const bool up = ph.d0[p] < 0;   // first row tap i - 1, else i
    float r0[3], r1[3];
    for (int b = 0; b < 3; ++b) {
      r0[b] = up ? v[0][b] : v[1][b];
      r1[b] = up ? v[1][b] : v[2][b];
    }
    const size_t orow = ((size_t)n * H * f + (size_t)i * f + p) * OW + (size_t)j * f;
    for (int q = 0; q < f; ++q) {
      const bool left = ph.d0[q] < 0;
      const float a00 = left ? r0[0] : r0[1], a01 = left ? r0[1] : r0[2];
      const float a10 = left ? r1[0] : r1[1], a11 = left ? r1[1] : r1[2];
      if (kU8) {
        const int wr0 = f2 - ph.k[p], wr1 = ph.k[p];
        const int wc0 = f2 - ph.k[q], wc1 = ph.k[q];
        const int s = wr0 * (wc0 * (int)a00 + wc1 * (int)a01)
                    + wr1 * (wc0 * (int)a10 + wc1 * (int)a11);
        static_cast<uint8_t*>(out)[orow + q] = (uint8_t)(s / (f2 * f2));
      } else {
        // rows first (the column pass reads the row pass's rounded values)
        const float t0 = lerp_rn(a00, a10, ph.wa[p], ph.wb[p]);
        const float t1 = lerp_rn(a01, a11, ph.wa[p], ph.wb[p]);
        static_cast<float*>(out)[orow + q] = lerp_rn(t0, t1, ph.wa[q], ph.wb[q]);
      }
    }
  }
}

}  // namespace

extern "C" int vsc_upsample(const float* x, void* out, const int* d0,
                            const int* k, const float* wa, const float* wb,
                            int N, int H, int W, int f, int quantize_u8,
                            void* stream) {
  if (f < 2 || f > kMaxF || N < 1 || H < 1 || W < 1 || N > 65535
      || H > 65535)
    return (int)cudaErrorInvalidValue;
  Phases ph = {};
  for (int p = 0; p < f; ++p) {
    ph.d0[p] = d0[p];
    ph.k[p] = k[p];
    ph.wa[p] = wa[p];
    ph.wb[p] = wb[p];
  }
  dim3 grid((W + kThreads - 1) / kThreads, H, N);
  if (quantize_u8)
    upsample_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        x, out, ph, H, W, f);
  else
    upsample_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        x, out, ph, H, W, f);
  return (int)cudaGetLastError();
}
