// Split bilateral + pyramid pool prepass over the planar u8 eye pair.
//
// Replaces: vsc_tpu/ops/bilateral_pallas.py  _kernel via
//   bilateral_pool_planar (reached from vsc_tpu/ops/stereo.py under
//   VSC_TPU_PP_SPLIT=1).
// Computes: for eye4 [4, B, H, W] u8 (r, g, b, valid)
//   filtered [4, B, H, W] u8: the bilateral of r, g, b on reflect-101
//     borders (csrc/bilateral.cuh, the arithmetic the postprocess's
//     bilateral runs), the valid plane passed through;
//   quarter [4, B, H/4, Wq] f32 (when asked for): the two-level 2x2 average
//     ladder of the PRE-bilateral (rgb * valid, valid) stack, computed as
//     the sum of its 16 masked u8 values times 0.0625 (exact: every partial
//     sum is an integer below 2^24), with the mid level's edge column
//     repeated when W/2 is odd (Wq = ceil(W/4) in that case).
// Bound on the H100: issue. At the default smoothing (radius 2, 12 taps) a
//   tap is ~19 instructions a pixel (3 shared-memory color reads, the L1
//   distance, its color weight, 7 for num and den), every multiply and add
//   on its own (no FMA contraction, so the split route equals the fused
//   route bit for bit); the bytes (4 u8 planes in, 4 out, 16 bytes per
//   quarter pixel) take 0.21 ms for the [4, 4, 3240, 6090] pair.
// Design: one launch, one block of 256 threads per 32 x 64 tile
//   (scripts/probe_kernels.py holds the variants tried).
//   - The tile plus a halo of the radius goes into shared memory as f32,
//     each color converted once; reflect-101 is resolved there, and only
//     for tiles whose halo leaves the image.
//   - One instance per radius (2-7: smoothing > 0 gives a diameter >= 5):
//     the color tile's row stride is a constant, so each tap's offset and
//     space weight (a kernel parameter) are constants of the unrolled
//     disc.
//   - The colors are integers, so a tap's L1 distance cd is an integer in
//     0..765 and its color weight color_weight(inv2sc, cd) one of 766
//     values: each block tabulates them in shared memory with the same
//     expf (no __expf), and a tap looks its weight up: ~10 instructions
//     less a tap than the exp, and the same bits.
//   - The quarter's 4 x 4 groups lie inside a tile (tile sides are
//     multiples of 4; a tile at the right edge of a W/2-odd image ends in
//     a group of two columns, whose sum is doubled), so it comes from the
//     tile on chip: two neighbouring lanes a group, before the bilateral,
//     so every thread of the block has the same work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bilateral.cuh"

namespace {

using vsc::reflect101;

constexpr int kThreads = 256;
constexpr int kTileH = 32;                  // multiple of 4
constexpr int kTileW = 64;                  // multiple of 4
constexpr int kRowStep = kThreads / kTileW;  // a thread's rows lie this apart
constexpr int kDist = 766;                  // L1 color distances 0..765
constexpr int kMinRadius = 2;

struct Geom {
  int B, H, W, Wq;
};

template <int R>
constexpr int smem_bytes() {
  return 3 * (kTileH + 2 * R) * (kTileW + 2 * R) * 4 + kDist * 4 +
         kTileH * kTileW;
}

template <int R>
__global__ void __launch_bounds__(kThreads)
    bilateral_tile_kernel(const uint8_t* __restrict__ eye4,
                          uint8_t* __restrict__ out,
                          float* __restrict__ quarter, Geom g,
                          vsc::BilateralTaps t) {
  constexpr int CW = kTileW + 2 * R, CN = (kTileH + 2 * R) * CW;
  extern __shared__ __align__(16) unsigned char smem[];
  float* colors = reinterpret_cast<float*>(smem);      // [3][CH][CW]
  float* weight = colors + 3 * CN;                     // [kDist]
  uint8_t* valid = reinterpret_cast<uint8_t*>(weight + kDist);  // [TH][TW]

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * kTileH, x0 = blockIdx.x * kTileW;
  const int th = min(kTileH, g.H - y0), tw = min(kTileW, g.W - x0);
  const size_t plane = (size_t)g.B * g.H * g.W;
  const uint8_t* img = eye4 + (size_t)b * g.H * g.W;

  // the colors over the tile + R, reflected only where the halo leaves
  // the image (four rows of loads in flight a thread); the color weights;
  // the tile's valid flags (all eight loads of a thread in flight)
  {
    const int bh = th + 2 * R, bw = tw + 2 * R;
    const bool inside = y0 >= R && x0 >= R && y0 + th + R <= g.H &&
                        x0 + tw + R <= g.W;
#pragma unroll 4
    for (int k = threadIdx.x; k < CN; k += kThreads) {
      const int r = k / CW, c = k - r * CW;
      if (r >= bh || c >= bw) continue;
      int sy = y0 - R + r, sx = x0 - R + c;
      if (!inside) {
        sy = reflect101(sy, g.H);
        sx = reflect101(sx, g.W);
      }
      const uint8_t* src = img + (size_t)sy * g.W + sx;
      for (int ch = 0; ch < 3; ++ch)
        colors[ch * CN + k] = (float)src[ch * plane];
    }
  }
  for (int k = threadIdx.x; k < kDist; k += kThreads)
    weight[k] = vsc::color_weight(t.inv2sc, (float)k);
#pragma unroll 8
  for (int k = threadIdx.x; k < kTileH * kTileW; k += kThreads) {
    const int r = k / kTileW, c = k % kTileW;
    if (r < th && c < tw)
      valid[k] = img[3 * plane + (size_t)(y0 + r) * g.W + x0 + c];
  }
  __syncthreads();

  // the quarter: two threads per 4 x 4 group of the tile (neighbouring
  // lanes, two rows each; the pairs' sums are exact, so their order is
  // free), before the bilateral so that every thread has the same work
  if (quarter != nullptr) {
    constexpr int GW = kTileW / 4, kHalves = 2 * (kTileH / 4) * GW;
    for (int hi = threadIdx.x; hi < kHalves; hi += kThreads) {
      const int grp = hi / 2, half = hi % 2;
      const int gy = grp / GW, gx = grp % GW;
      const bool in = 4 * gy < th && 4 * gx < tw;
      const int nc = in ? min(4, tw - 4 * gx) : 0;  // 2 at a W/2-odd edge
      float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int r = 4 * gy + 2 * half; r < 4 * gy + 2 * half + 2; ++r)
        for (int cc = 4 * gx; cc < 4 * gx + nc; ++cc) {
          const float v = (float)valid[r * kTileW + cc];
          const int p = (r + R) * CW + cc + R;
          for (int k = 0; k < 3; ++k)
            s[k] = __fadd_rn(s[k], __fmul_rn(colors[k * CN + p], v));
          s[3] = __fadd_rn(s[3], v);
        }
      for (int k = 0; k < 4; ++k)
        s[k] = __fadd_rn(s[k], __shfl_xor_sync(0xffffffffu, s[k], 1));
      if (in && half == 0) {
        const int Hq = g.H / 4;
        const size_t qplane = (size_t)g.B * Hq * g.Wq;
        const size_t qi =
            ((size_t)b * Hq + y0 / 4 + gy) * g.Wq + x0 / 4 + gx;
        for (int k = 0; k < 4; ++k)
          quarter[k * qplane + qi] =
              __fmul_rn(nc == 4 ? s[k] : __fmul_rn(s[k], 2.0f), 0.0625f);
      }
    }
  }

  // the bilateral: a thread per column, every kRowStep-th row
  const int c = threadIdx.x % kTileW;
  if (c < tw) {
    for (int py = threadIdx.x / kTileW; py < th; py += kRowStep) {
      const int p = (py + R) * CW + c + R;
      float ctr[3];
      for (int k = 0; k < 3; ++k) ctr[k] = colors[k * CN + p];
      vsc::BilateralSum acc(ctr);
      // the disc in bilateral_disc's order, unrolled: tap i's offset and
      // space weight index are constants
      int i = 0;
#pragma unroll
      for (int dy = -R; dy <= R; ++dy)
#pragma unroll
        for (int dx = -R; dx <= R; ++dx)
          if ((dy || dx) && dy * dy + dx * dx <= R * R) {
            const int q = p + dy * CW + dx;
            float sh[3];
            for (int k = 0; k < 3; ++k) sh[k] = colors[k * CN + q];
            acc.add(__fmul_rn(t.w[i++], weight[(int)acc.distance(sh)]), sh);
          }
      float o[3];
      acc.finish(o);
      const size_t dst =
          (size_t)b * g.H * g.W + (size_t)(y0 + py) * g.W + x0 + c;
      for (int k = 0; k < 3; ++k) out[k * plane + dst] = (uint8_t)o[k];
      out[3 * plane + dst] = valid[py * kTileW + c];
    }
  }
}

template <int R>
int launch(const uint8_t* eye4, uint8_t* out, float* quarter, const Geom& g,
           const vsc::BilateralTaps& t, cudaStream_t s) {
  // (per call: the attribute belongs to the current device)
  cudaError_t err = cudaFuncSetAttribute(
      bilateral_tile_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<R>());
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((g.W + kTileW - 1) / kTileW, (g.H + kTileH - 1) / kTileH,
                  g.B);
  bilateral_tile_kernel<R><<<grid, kThreads, smem_bytes<R>(), s>>>(
      eye4, out, quarter, g, t);
  return (int)cudaGetLastError();
}

}  // namespace

// space_w: the bilateral's space weights (host floats, the disc's row-major
// order, center excluded); quarter may be null (no pool).
extern "C" int vsc_bilateral_pool(const uint8_t* eye4, uint8_t* out,
                                  float* quarter, const float* space_w,
                                  float inv2sc, int B, int H, int W, int rb,
                                  void* stream) {
  if (rb < kMinRadius || rb > vsc::kMaxBilRadius || B < 1 || B > 65535 ||
      H < 4 || W < 2 || H % 4 || W % 2)
    return (int)cudaErrorInvalidValue;
  vsc::BilateralTaps t = {};
  vsc::bilateral_disc(rb, &t);
  for (int j = 0; j < t.n; ++j) t.w[j] = space_w[j];
  t.inv2sc = inv2sc;
  const int W2 = W / 2;
  const Geom g = {B, H, W, (W2 + (W2 & 1)) / 2};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (rb) {
    case 2: return launch<2>(eye4, out, quarter, g, t, s);
    case 3: return launch<3>(eye4, out, quarter, g, t, s);
    case 4: return launch<4>(eye4, out, quarter, g, t, s);
    case 5: return launch<5>(eye4, out, quarter, g, t, s);
    case 6: return launch<6>(eye4, out, quarter, g, t, s);
    default: return launch<7>(eye4, out, quarter, g, t, s);
  }
}
