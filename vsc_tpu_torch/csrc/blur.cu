// Separable gaussian blur (+ optional depth-gamma epilogue).
//
// Replaces: vsc_tpu/ops/blur_pallas.py  gaussian_blur_pallas / _kernel.
// Computes: the vertical pass then the horizontal pass of a k-tap filter
//   (k odd, <= 31) over a reflect-101 padded plane, taps accumulated in the
//   jnp order (acc = t0*x0; acc = acc + tk*xk), then optionally
//   clip(out, 0.001, 1) ** gamma. Products and sums use __fmul_rn /
//   __fadd_rn so nvcc does not contract them into FMAs: the kernel then
//   rounds exactly like the plain PyTorch version.
// Bound on the H100: on paper the bytes (a [2, 3240, 6090] f32 plane pair
//   read and written once: 0.094 ms at 3.35 TB/s). The issue slots come
//   next: without contraction a pixel takes 2k - 1 FP32 instructions a pass
//   (4k - 2 = 122 at k = 31), one SM sub-partition issues one a clock, so
//   those alone take ~0.15 ms at that shape; and the gamma's powf, which
//   the plain version's torch.pow also calls (so the bits agree), costs
//   ~0.1 ms more there (the kernel with the gamma off runs in ~70 % of its
//   time with it).
// Design: one block of 256 threads takes a 32 x 224 output tile and keeps
//   its 32 x (224 + k - 1) vertical-pass result in shared memory.
//   - Vertical pass: a thread per window column runs down 16 rows at a
//     time from values in registers: each input it loads from device
//     memory (coalesced along the row, the window's reflect-101 indices
//     only in border tiles) feeds up to 16 accumulators, so a tap costs no
//     load (16 + k - 1 loads for 16 outputs).
//   - Horizontal pass: a warp takes the tile's 32 rows, a lane each (rows
//     lie an odd pitch apart: no bank conflicts), and runs along them 7
//     outputs at a time, again from registers (7 + k - 1 shared loads for 7
//     outputs). The results wait in registers until the block is done
//     with the vertical result, then go back to its shared memory, and
//     leave it row by row, coalesced, with the gamma.
//   Rows of W = 6090 floats do not start on 16-byte boundaries, so the
//   device-memory loads and stores are 4-byte ones, 128 contiguous bytes a
//   warp.

#include <cuda_runtime.h>

namespace {

constexpr int kTileH = 32;
constexpr int kTileW = 224;         // 32 horizontal runs of 7
constexpr int kRunV = 16;           // vertical-pass outputs a run
constexpr int kRunH = 7;            // horizontal-pass outputs a run
constexpr int kMaxK = 31;
constexpr int kThreads = 256;
static_assert(kTileW == kRunH * 4 * (kThreads / 32), "4 runs a lane");
static_assert(kTileH == 32 && kTileH % kRunV == 0, "a lane a row");

struct Taps {
  float t[kMaxK];
};

__device__ __forceinline__ int reflect101(int i, int n) {
  // jnp.pad(mode="reflect"), repeated reflection for pads longer than n
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  i %= period;
  if (i < 0) i += period;
  return i < n ? i : period - i;
}

// acc[j] (+)= taps[i - j] * x for the outputs j of a run that input i
// reaches, in the jnp order (tap 0 first, a product; then sums)
template <int K, int RUN>
__device__ __forceinline__ void accumulate(float (&acc)[RUN], int i, float x,
                                           const Taps& taps) {
#pragma unroll
  for (int j = 0; j < RUN; ++j) {
    const int t = i - j;
    if (t == 0)
      acc[j] = __fmul_rn(taps.t[0], x);
    else if (t > 0 && t < K)
      acc[j] = __fadd_rn(acc[j], __fmul_rn(taps.t[t], x));
  }
}

// kRunV vertical-pass outputs of one window column: input rows y_in ..
// y_in + kRunV + K - 2 of column gx, reflected when REFLECT
template <int K, bool REFLECT>
__device__ __forceinline__ void vertical_run(const float* __restrict__ src,
                                             int H, int W, int y_in, int gx,
                                             const Taps& taps, float* dst,
                                             int pitch) {
  float acc[kRunV];
#pragma unroll
  for (int i = 0; i < kRunV + K - 1; ++i) {
    const int y = REFLECT ? reflect101(y_in + i, H) : y_in + i;
    accumulate<K>(acc, i, __ldg(src + y * W + gx), taps);
  }
#pragma unroll
  for (int j = 0; j < kRunV; ++j) dst[j * pitch] = acc[j];
}

template <int K>
__global__ void __launch_bounds__(kThreads)
blur_kernel(const float* __restrict__ x, float* __restrict__ out, Taps taps,
            int H, int W, float gamma, int has_gamma) {
  constexpr int R = K / 2;
  constexpr int kWin = kTileW + 2 * R;     // window columns
  constexpr int kPitch = kWin + 1;         // odd: a lane a row, no conflicts
  __shared__ float vert[kTileH * kPitch];
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const size_t plane = (size_t)H * W;
  const float* src = x + (size_t)blockIdx.z * plane;
  const int tid = threadIdx.x;

  // vertical pass: window column tid, rows y0 .. y0 + 31 in runs
  if (tid < kWin) {
    const int cx = x0 - R + tid;
    const bool col_inside = x0 - R >= 0 && x0 + kTileW + R <= W;
    const int gx = col_inside ? cx : reflect101(cx, W);
    const bool rows_inside = y0 - R >= 0 && y0 + kTileH + R <= H;
#pragma unroll 1
    for (int r = 0; r < kTileH; r += kRunV) {
      float* dst = vert + r * kPitch + tid;
      if (rows_inside)
        vertical_run<K, false>(src, H, W, y0 + r - R, gx, taps, dst, kPitch);
      else
        vertical_run<K, true>(src, H, W, y0 + r - R, gx, taps, dst, kPitch);
    }
  }
  __syncthreads();

  // horizontal pass: lane = row, warp w takes runs w, w + 8, w + 16, w + 24
  const int lane = tid & 31, warp = tid >> 5;
  const float* row = vert + lane * kPitch;
  float acc[4][kRunH];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int c0 = kRunH * (warp + 8 * m);
#pragma unroll
    for (int i = 0; i < kRunH + K - 1; ++i)
      accumulate<K>(acc[m], i, row[c0 + i], taps);
  }
  __syncthreads();          // every warp is done with the vertical result
  float* res = vert + lane * kPitch;
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int j = 0; j < kRunH; ++j)
      res[kRunH * (warp + 8 * m) + j] = acc[m][j];
  __syncthreads();

  // out, a row at a time: 224 contiguous floats
  float* dst = out + (size_t)blockIdx.z * plane;
  const int gx = x0 + tid;
  if (tid < kTileW && gx < W) {
#pragma unroll 8
    for (int r = 0; r < kTileH; ++r) {
      if (y0 + r >= H) break;
      float v = vert[r * kPitch + tid];
      if (has_gamma) v = powf(fminf(fmaxf(v, 0.001f), 1.0f), gamma);
      dst[(size_t)(y0 + r) * W + gx] = v;
    }
  }
}

template <int K>
int launch(const float* x, float* out, const Taps& t, int N, int H, int W,
           float gamma, int has_gamma, cudaStream_t s) {
  dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, N);
  blur_kernel<K><<<grid, kThreads, 0, s>>>(x, out, t, H, W, gamma,
                                           has_gamma);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vsc_blur(const float* x, float* out, const float* taps,
                        int N, int H, int W, int ksize, float gamma,
                        int has_gamma, void* stream) {
  if (ksize < 1 || ksize > kMaxK || (ksize & 1) == 0)
    return (int)cudaErrorInvalidValue;
  // a plane's element offsets are 32-bit
  if (N < 1 || N > 65535 || H < 1 || W < 1 ||
      (long long)H * W > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  Taps t = {};
  for (int k = 0; k < ksize; ++k) t.t[k] = taps[k];
  cudaStream_t s = (cudaStream_t)stream;
  switch (ksize) {
#define VSC_K(K) \
    case K: return launch<K>(x, out, t, N, H, W, gamma, has_gamma, s);
    VSC_K(1) VSC_K(3) VSC_K(5) VSC_K(7) VSC_K(9) VSC_K(11) VSC_K(13)
    VSC_K(15) VSC_K(17) VSC_K(19) VSC_K(21) VSC_K(23) VSC_K(25) VSC_K(27)
    VSC_K(29) VSC_K(31)
#undef VSC_K
    default: return (int)cudaErrorInvalidValue;
  }
}
