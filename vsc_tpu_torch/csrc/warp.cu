// Forward stereo warp, both eyes (scatter formulation).
//
// Replaces: vsc_tpu/ops/warp_pallas.py  _warp_kernel via _warp_planes
//   (entries forward_warp_stereo_pallas, channel-last f32 image, and
//   forward_warp_stereo_pallas_planar_u8, planar [B, 3, H, W] u8 image).
// Computes: the gather warp of ops/warp.py, bit for bit. There, every output
//   pixel x and eye scans the shifts s of the disparity window in the
//   reference order (left eye s = 0..D+1, right eye s = -D..1,
//   D = floor(max_disparity) + 1), source x - s. With d = depth *
//   max_disparity * sign, k = floor(d), frac = d - k: a floor candidate
//   (k == s) has key z, a ceil candidate (k == s - 1 and frac > 0.3) key
//   2 + z; the running best is replaced only when key > best (strict, so
//   the first shift, the LARGEST source, wins ties). Sources outside the
//   row never win. The mask is weight > 0.1 (floor: 1 - frac, ceil: frac)
//   of a winner, the colors floor(clip(., 0, 255)) of the winner, written as
//   (r, g, b, valid) uint8 planes per eye.
// Bound on the H100: the bytes. At the default path's shapes (2 x 3240 x
//   6090 planar u8) the depth (158 MB), the image (118 MB) and both eyes'
//   planes (316 MB) take 0.177 ms at 3.35 TB/s; the scatter needs ~40
//   operations a pixel.
// Design: scatter, O(1) work a source where the gather did O(D) a pixel.
//   A source can win only at its floor target x = src + k (key z) and, when
//   frac > 0.3, at its ceil target x = src + k + 1 (key 2 + z), each where
//   x - src lies in the eye's window. The 64-bit word (orderable(key) << 32)
//   | src, reduced with atomicMax in shared memory, is then exactly the
//   gather's winner in any order: the largest key, and among equal keys the
//   largest source. -0.0 is made +0.0 first (the gather ties them; their
//   ordered bits do not). A source whose k is not finite, or out of both
//   windows, writes nothing; a slot left at 0 is empty (colors 0, mask 0).
//   The epilogue recomputes the winner's class (ceil where x - src == k + 1),
//   its weight and mask, and reads its colors. One block takes a segment
//   of one row (at most kSeg outputs; longer rows in equal segments, each
//   reading the D + 1 sources beyond either end that can land in it), so
//   no row width is refused. Both eyes' words: 2 x 8 B an output in shared
//   memory. Every step is one IEEE operation, as in the plain version.
//   The eyes' planes may lie one channel stride apart (the [4, 2B, H, W]
//   pair of both eyes, written in place).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kSeg = 4096;          // outputs a block (64 KB of words)

// image [rows, W, 3] float32, channel last: floor(clip(., 0, 255))
struct ChannelLastF32 {
  const float* img;
  __device__ __forceinline__ uint8_t operator()(int row, int W, int src,
                                                int c) const {
    const float v = img[((size_t)row * W + src) * 3 + c];
    return (uint8_t)floorf(fminf(fmaxf(v, 0.0f), 255.0f));
  }
};

// image [B, 3, H, W] uint8 (the planar-u8 stereo branch)
struct PlanarU8 {
  const uint8_t* img;
  int H;
  __device__ __forceinline__ uint8_t operator()(int row, int W, int src,
                                                int c) const {
    const int b = row / H, y = row - b * H;
    return img[(((size_t)b * 3 + c) * H + y) * W + src];
  }
};

// key -> 32 bits whose unsigned order is the float order (finite keys)
__device__ __forceinline__ unsigned long long word(float key, int src) {
  key = key == 0.0f ? 0.0f : key;   // -0.0 ties +0.0, as in the gather
  uint32_t u = __float_as_uint(key);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (uint32_t)src;
}

// the disparity of a source in one eye: d, k = floor(d), frac = d - k
struct Disp {
  float k, frac;
};
__device__ __forceinline__ Disp disp(float z, float maxd, float sign) {
  const float d = __fmul_rn(__fmul_rn(z, maxd), sign);
  const float k = floorf(d);
  return {k, __fsub_rn(d, k)};
}

// one eye's two candidates of source src into the segment's words
// [x0, x1); the window of x - src is [s_lo, s_hi]
__device__ __forceinline__ void scatter(unsigned long long* words, float z,
                                        Disp dp, int src, int x0, int x1,
                                        float s_lo, float s_hi) {
  if (dp.k >= s_lo && dp.k <= s_hi) {       // floor: x - src = k
    const int x = src + (int)dp.k;
    if (x >= x0 && x < x1) atomicMax(words + (x - x0), word(z, src));
  }
  if (dp.frac > 0.3f && dp.k >= s_lo - 1.0f && dp.k <= s_hi - 1.0f) {
    const int x = src + (int)dp.k + 1;      // ceil: x - src = k + 1
    if (x >= x0 && x < x1)
      atomicMax(words + (x - x0), word(__fadd_rn(2.0f, z), src));
  }
}

template <class Color>
__device__ __forceinline__ void write_eye(const Color& color,
                                          const float* __restrict__ drow,
                                          int row, int W, int x,
                                          unsigned long long w, float maxd,
                                          float sign, uint8_t* eye,
                                          size_t cstride, size_t pix) {
  uint8_t rgb[3] = {0, 0, 0}, valid = 0;
  if (w != 0ull) {
    const int src = (int)(uint32_t)w;
    const Disp dp = disp(__ldg(drow + src), maxd, sign);
    const bool ceil_class = x - src == (int)dp.k + 1;
    const float wgt = ceil_class ? dp.frac : __fsub_rn(1.0f, dp.frac);
    valid = wgt > 0.1f ? 1 : 0;
    for (int c = 0; c < 3; ++c) rgb[c] = color(row, W, src, c);
  }
  for (int c = 0; c < 3; ++c) eye[c * cstride + pix] = rgb[c];
  eye[3 * cstride + pix] = valid;
}

template <class Color>
__global__ void __launch_bounds__(kThreads)
warp_kernel(const float* __restrict__ depth, Color color,
            uint8_t* __restrict__ eye_l, uint8_t* __restrict__ eye_r,
            size_t cstride, int W, int nseg, int seg, float maxd, int D) {
  extern __shared__ unsigned long long words[];   // [2][seg]
  const int row = blockIdx.x / nseg;
  const int x0 = (blockIdx.x % nseg) * seg;
  const int x1 = min(W, x0 + seg);
  const int n = x1 - x0;
  unsigned long long* wl = words;
  unsigned long long* wr = words + seg;
  const float* drow = depth + (size_t)row * W;

  for (int i = threadIdx.x; i < 2 * seg; i += kThreads) words[i] = 0ull;
  __syncthreads();
  // every source that can land in [x0, x1): left eye x - src in [0, D+1],
  // right eye in [-D, 1]
  const int src_lo = max(0, x0 - D - 1), src_hi = min(W, x1 + D);
  for (int src = src_lo + threadIdx.x; src < src_hi; src += kThreads) {
    const float z = __ldg(drow + src);
    scatter(wl, z, disp(z, maxd, 1.0f), src, x0, x1, 0.0f, (float)(D + 1));
    scatter(wr, z, disp(z, maxd, -1.0f), src, x0, x1, (float)(-D), 1.0f);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int x = x0 + i;
    const size_t pix = (size_t)row * W + x;
    write_eye(color, drow, row, W, x, wl[i], maxd, 1.0f, eye_l, cstride,
              pix);
    write_eye(color, drow, row, W, x, wr[i], maxd, -1.0f, eye_r, cstride,
              pix);
  }
}

template <class Color>
int launch(const float* depth, Color color, uint8_t* eye_l, uint8_t* eye_r,
           long long cstride, int rows, int W, float max_disparity,
           void* stream) {
  if (rows < 1 || W < 1 || !(fabsf(max_disparity) <= 1e6f))
    return (int)cudaErrorInvalidValue;
  const int D = (int)floorf(max_disparity) + 1;
  const int nseg = (W + kSeg - 1) / kSeg;
  const int seg = (W + nseg - 1) / nseg;
  if ((long long)rows * nseg > 2147483647LL) return (int)cudaErrorInvalidValue;
  const int smem = 2 * seg * (int)sizeof(unsigned long long);
  const cudaError_t e = cudaFuncSetAttribute(
      warp_kernel<Color>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  warp_kernel<<<rows * nseg, kThreads, smem, (cudaStream_t)stream>>>(
      depth, color, eye_l, eye_r, (size_t)cstride, W, nseg, seg,
      max_disparity, D);
  return (int)cudaGetLastError();
}

}  // namespace

// image [rows, W, 3] f32; each eye [4, rows, W] u8, channel stride cstride
extern "C" int vsc_warp(const float* depth, const float* image,
                        uint8_t* eye_l, uint8_t* eye_r, int rows, int W,
                        long long cstride, float max_disparity,
                        void* stream) {
  return launch(depth, ChannelLastF32{image}, eye_l, eye_r, cstride, rows, W,
                max_disparity, stream);
}

// image [B, 3, H, W] u8; each eye [4, B, H, W] u8 with channel stride
// cstride (B * H * W for separate eyes, 2 * B * H * W for the two halves
// of the [4, 2B, H, W] pair)
extern "C" int vsc_warp_planar_u8(const float* depth, const uint8_t* image,
                                  uint8_t* eye_l, uint8_t* eye_r, int B,
                                  int H, int W, long long cstride,
                                  float max_disparity, void* stream) {
  if (B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  return launch(depth, PlanarU8{image, H}, eye_l, eye_r, cstride, B * H, W,
                max_disparity, stream);
}
