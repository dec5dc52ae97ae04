// Forward stereo warp, both eyes (gather formulation).
//
// Replaces: vsc_tpu/ops/warp_pallas.py  _warp_kernel via _warp_planes
//   (entries forward_warp_stereo_pallas, channel-last f32 image, and
//   forward_warp_stereo_pallas_planar_u8, planar [B, 3, H, W] u8 image).
// Computes: for every output pixel and eye, scan the shifts s of the
//   disparity window in the reference order (left eye s = 0..D+1, right eye
//   s = -D..1, D = floor(max_disparity) + 1), source x - s. With
//   d = depth * max_disparity * sign, k = floor(d), frac = d - k: a floor
//   candidate (k == s) has key z, a ceil candidate (k == s - 1 and
//   frac > 0.3) key 2 + z; the running best is replaced only when
//   key > best (strict, so the first shift wins ties). Sources outside the
//   row never win (the Pallas kernel's -3e4 pad sentinel). The mask is
//   weight > 0.1 and key > -inf, the colors floor(clip(., 0, 255)) of the
//   winner, written as [4, rows, W] uint8 (r, g, b, valid) per eye.
//   Every step is one IEEE operation, so the result is bit-identical to the
//   plain PyTorch version (ops/warp.py). The scan is shared; only the color
//   loader (a template argument) differs between the two image layouts.
// Bound on the H100: the ~2 x 53 candidate tests per pixel and eye (about
//   0.5 G compares/selects for a 2 x 1080 x 2030 batch) against ~40 MB of
//   traffic, so it is instruction-bound. Design: one thread per output
//   pixel runs both eyes; neighbouring threads read neighbouring sources,
//   so the window re-reads of depth hit L1, and device memory sees each
//   input byte about once.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void scan_eye(const float* __restrict__ drow,
                                         int x, int W, float maxd, float sign,
                                         int s_lo, int s_hi, float* best_key,
                                         float* best_wgt, int* best_src) {
  float bk = -INFINITY, bw = 0.0f;
  int bs = -1;
  for (int s = s_lo; s < s_hi; ++s) {
    const int src = x - s;
    if (src < 0 || src >= W) continue;
    const float z = __ldg(drow + src);
    const float d = __fmul_rn(__fmul_rn(z, maxd), sign);
    const float k = floorf(d);
    const float frac = __fsub_rn(d, k);
    const bool is_floor = (k == (float)s);
    const bool is_ceil = (k == (float)(s - 1)) && (frac > 0.3f);
    const float key = is_ceil ? __fadd_rn(2.0f, z) : (is_floor ? z : -INFINITY);
    if (key > bk) {
      bk = key;
      bw = is_ceil ? frac : __fsub_rn(1.0f, frac);
      bs = src;
    }
  }
  *best_key = bk;
  *best_wgt = bw;
  *best_src = bs;
}

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

template <class Color>
__device__ __forceinline__ void write_eye(const Color& color, int row, int W,
                                          uint8_t* eye, size_t plane,
                                          size_t pix, float bk, float bw,
                                          int bs) {
  for (int c = 0; c < 3; ++c)
    eye[c * plane + pix] = bs >= 0 ? color(row, W, bs, c) : (uint8_t)0;
  eye[3 * plane + pix] = (bw > 0.1f && bk > -INFINITY) ? 1 : 0;
}

template <class Color>
__global__ void warp_kernel(const float* __restrict__ depth, Color color,
                            uint8_t* __restrict__ eye_l,
                            uint8_t* __restrict__ eye_r, int rows, int W,
                            float maxd, int D, int blocks_per_row) {
  const int row = blockIdx.x / blocks_per_row;
  const int x = (blockIdx.x % blocks_per_row) * kThreads + threadIdx.x;
  if (x >= W || row >= rows) return;
  const float* drow = depth + (size_t)row * W;
  const size_t plane = (size_t)rows * W;
  const size_t pix = (size_t)row * W + x;
  float bk, bw;
  int bs;
  scan_eye(drow, x, W, maxd, 1.0f, 0, D + 2, &bk, &bw, &bs);
  write_eye(color, row, W, eye_l, plane, pix, bk, bw, bs);
  scan_eye(drow, x, W, maxd, -1.0f, -D, 2, &bk, &bw, &bs);
  write_eye(color, row, W, eye_r, plane, pix, bk, bw, bs);
}

template <class Color>
int launch(const float* depth, Color color, uint8_t* eye_l, uint8_t* eye_r,
           int rows, int W, float max_disparity, void* stream) {
  if (rows < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const int D = (int)floorf(max_disparity) + 1;
  const int bpr = (W + kThreads - 1) / kThreads;
  warp_kernel<<<rows * bpr, kThreads, 0, (cudaStream_t)stream>>>(
      depth, color, eye_l, eye_r, rows, W, max_disparity, D, bpr);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vsc_warp(const float* depth, const float* image,
                        uint8_t* eye_l, uint8_t* eye_r, int rows, int W,
                        float max_disparity, void* stream) {
  return launch(depth, ChannelLastF32{image}, eye_l, eye_r, rows, W,
                max_disparity, stream);
}

extern "C" int vsc_warp_planar_u8(const float* depth, const uint8_t* image,
                                  uint8_t* eye_l, uint8_t* eye_r, int B,
                                  int H, int W, float max_disparity,
                                  void* stream) {
  if (B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  return launch(depth, PlanarU8{image, H}, eye_l, eye_r, B * H, W,
                max_disparity, stream);
}
