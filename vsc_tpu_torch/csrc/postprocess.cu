// Per-eye postprocess: bilateral + hole dilation + frontier fill + polish.
//
// Replaces: vsc_tpu/ops/postprocess_pallas.py  _kernel via
//   postprocess_eye_planar_pallas (compat entry postprocess_eye_pallas).
// Computes: the Pallas kernel's semantics as ops/postprocess_cuda.py states
//   them (five stages over the image plus a margin, colors reflect-101, the
//   valid plane zero outside the image, a margin pixel taking the bilateral
//   of the pixel it reflects: csrc/bilateral.cuh, shared with the split
//   route's csrc/bilateral.cu, so the two routes are equal bit for bit).
//   Weights come from the host in the plain version's order and every
//   accumulation runs in that order with unfused IEEE operations, so the
//   kernel rounds like the plain PyTorch version.
// Bound on the H100: the bilateral on every pixel (12 taps x ~20
//   operations at the default smoothing) and, on the pixels near a hole,
//   the fill and polish taps; the bytes (4 u8 planes in, 3 out) are a
//   tenth of that. The chain of five launches it replaces passed f32 value
//   planes of the whole domain through device memory (~2.2 GiB of scratch
//   at the pair's shape) and ran every sweep on every pixel.
// Design: one launch, one block of 512 threads per 48 x 32 output tile
//   (tall and narrow: a horizontal warp's disocclusions are near-vertical
//   curves), nothing in device memory but the output. The output at a
//   pixel depends on the colors within 9 + rb of it and the valid plane
//   within 10 (hole flags and sweep values within 2 * SWEEPS +
//   POLISH_RADIUS = 9). The plain version's margin M = rb + 10 is wider
//   than that, so a block that holds its tile plus a halo of 9 reproduces
//   the chain exactly, and the chain's own domain edge at +-M never
//   reaches an output pixel's dependencies. Per tile:
//     1. the hole test: is an in-image pixel within 1 of the tile not
//        valid (the Pallas kernel's hole_active test)? One read of the
//        valid flags of the tile + 1;
//     2. fast path (no: every pixel keeps its bilateral): the colors over
//        the tile + rb into shared memory as f32 (converted once, not once
//        per tap), the bilateral of each tile pixel, u8 out;
//     3. hole path, in shared memory over the window W9 = tile + 9: colors
//        over W9 + rb (reflected), the valid plane over W9 + 1, keep /
//        known flags, the bilateral of the window (a margin pixel at the
//        window position of the pixel it reflects, which W9 holds), then
//        the three Jacobi sweeps over the shrinking windows W7, W5, W3 on
//        the list of pixels not known at the start (only those can
//        change), ping-pong between two f32 value buffers; then the
//        values the polish reads over W3 (bilateral, swept value or the
//        quarter-resolution estimate) into one buffer, and the radius-3
//        polish on a list of the tile's hole pixels. Lists keep the work
//        dense: most pixels of a hole tile are kept, and per-pixel loops
//        with a branch per tap left most lanes of a warp idle.
//   One instance per bilateral radius (0-7): the color tiles have fixed
//   row strides, so each tap's offset and weight index are constants of
//   the unrolled disc (so are the fill and polish taps). 105,664 bytes of
//   dynamic shared memory (the value buffers alias the color and valid
//   tiles), two blocks an SM.
// Counters: given int64 counters (the wrapper passes them only while
//   tracing is on, else null), thread 0 of each block adds its tile, after
//   the hole test, to "fast tiles" or to "hole tiles" (the tiles that run
//   stages 2-5, a share that depends on the content): one atomic a block.
//   A second atomic for the hole tiles alone, under a branch, made the
//   kernel 4 % slower on an H100 (12.04 -> 12.54 ms on a 1080p batch-8
//   pair); this form 0.3 %. The counters are kCountSlots slots of [fast
//   tiles, hole tiles, 2 unused] (a 32-byte sector a slot), a block adding
//   to slot (its tile index % kCountSlots), and the reader sums the slots.
// Build (nvcc -Xptxas -v, sm_90a, CUDA 12.8): 40-64 registers by radius,
//   no spills.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bilateral.cuh"

namespace {

using vsc::reflect101;

constexpr int kThreads = 512;
constexpr int kTileH = 48;                        // TILE_H in the wrapper
constexpr int kTileW = 32;                        // TILE_W in the wrapper
constexpr int kMaxRb = vsc::kMaxBilRadius;
constexpr int kFillR = 2;
constexpr int kSweeps = 3;                        // SWEEPS in the wrapper
constexpr int kPolishR = 3;
constexpr int kHalo = kSweeps * kFillR + kPolishR;   // 9
constexpr int kMaxFill = (2 * kFillR + 1) * (2 * kFillR + 1);
constexpr int kMaxPolish = (2 * kPolishR + 1) * (2 * kPolishR + 1);
constexpr int kCountSlots = 256;     // COUNTER_SLOTS in ops/_cuda.py
constexpr int kCountStride = 4;      // COUNTER_STRIDE in ops/_cuda.py

// window W9 at its largest, and shared-memory carve (bytes)
constexpr int kWH = kTileH + 2 * kHalo, kWW = kTileW + 2 * kHalo;
constexpr int kWN = kWH * kWW;
constexpr int kColorBytes = 3 * (kWH + 2 * kMaxRb) * (kWW + 2 * kMaxRb) * 4;
constexpr int kValidBytes = (kWH + 2) * (kWW + 2);
constexpr int kValueBytes = 2 * 3 * kWN * 4;      // two f32 [3, W9] buffers
static_assert(kColorBytes + kValidBytes <= kValueBytes,
              "colors and valid plane alias the value buffers");
constexpr int align16(int x) { return (x + 15) / 16 * 16; }
constexpr int kOffChans = align16(kValueBytes);
constexpr int kOffFlags = kOffChans + align16(3 * kWN);
constexpr int kOffKA = kOffFlags + align16(kWN);
constexpr int kOffKB = kOffKA + align16(kWN);
constexpr int kOffList = kOffKB + align16(kWN);
constexpr int kOffCount = kOffList + align16(2 * kWN);
constexpr int kSmem = kOffCount + 16;

struct Offsets {
  int nf, np;                    // fill and polish taps (unrolled in the
  float fw[kMaxFill], pw[kMaxPolish];   // kernel in the discs' order)
  float wsum;
  vsc::BilateralTaps bil;
};

struct Geom {
  int B, H, W, Hq, Wq;
};

__device__ __forceinline__ int clamp_in(int i, int n) {
  return (i < 0 || i >= n) ? reflect101(i, n) : i;
}

// f(r, c) for every (r, c) of an h x w box, w <= WMAX, consecutive
// threads on consecutive pixels of a row (WMAX a constant: the row and
// column of an index come without a division)
template <int WMAX, class F>
__device__ __forceinline__ void for_box(int h, int w, F f) {
  for (int i = threadIdx.x; i < h * WMAX; i += kThreads) {
    const int r = i / WMAX, c = i % WMAX;
    if (c < w) f(r, c);
  }
}

// the three color planes over rows [y0, y0 + h) x cols [x0, x0 + w) of the
// image, reflect-101 outside it, into dst as f32 (row stride `stride`,
// plane stride n): each color is converted once here, not once per tap
// that reads it
template <int STRIDE>
__device__ __forceinline__ void load_colors(const uint8_t* __restrict__ img,
                                            size_t plane, const Geom& g,
                                            int y0, int x0, int h, int w,
                                            int n, float* dst) {
  for_box<STRIDE>(h, w, [&](int r, int c) {
    const size_t src =
        (size_t)clamp_in(y0 + r, g.H) * g.W + clamp_in(x0 + c, g.W);
    for (int k = 0; k < 3; ++k)
      dst[k * n + r * STRIDE + c] = (float)img[k * plane + src];
  });
}

// bilateral of radius R (at 0, the color itself) of the pixel whose colors
// sit at (cy, cx) of a color tile of row stride CW and plane stride n; the
// taps' offsets are compile-time constants
template <int R, int CW>
__device__ __forceinline__ void bilateral_at(const float* ct, int n, int cy,
                                             int cx, const Offsets& o,
                                             float out[3]) {
  const int p = cy * CW + cx;
  float c[3];
  for (int k = 0; k < 3; ++k) c[k] = ct[k * n + p];
  if constexpr (R == 0) {
    for (int k = 0; k < 3; ++k) out[k] = c[k];
  } else {
    // the disc in bilateral_disc's order, unrolled: tap i's offset and
    // weight index are constants
    vsc::BilateralSum acc(c);
    int i = 0;
#pragma unroll
    for (int dy = -R; dy <= R; ++dy)
#pragma unroll
      for (int dx = -R; dx <= R; ++dx)
        if ((dy || dx) && dy * dy + dx * dx <= R * R) {
          const int q = p + dy * CW + dx;
          float sh[3];
          for (int k = 0; k < 3; ++k) sh[k] = ct[k * n + q];
          acc.tap(o.bil.w[i++], o.bil.inv2sc, sh);
        }
    acc.finish(out);
  }
}

// R: the bilateral radius (one instance per radius, 0-7)
template <int R>
__global__ void __launch_bounds__(kThreads, 2)
postprocess_tile_kernel(const uint8_t* __restrict__ eye4,
                        const float* __restrict__ smooth_q,
                        uint8_t* __restrict__ out, Geom g, Offsets o,
                        unsigned long long* __restrict__ counts) {
  extern __shared__ __align__(16) uint8_t sm[];
  float* vbuf = reinterpret_cast<float*>(sm);     // [2][3][W9]
  float* colors = vbuf;                           // aliases vbuf
  uint8_t* valid = sm + kColorBytes;              // aliases vbuf
  uint8_t* chans = sm + kOffChans;                // [3][W9] bilateral
  uint8_t* flags = sm + kOffFlags;                // bit 0 keep, 1 known0
  uint8_t* kbuf[2] = {sm + kOffKA, sm + kOffKB};  // known, ping-pong
  uint16_t* list = reinterpret_cast<uint16_t*>(sm + kOffList);
  int* count = reinterpret_cast<int*>(sm + kOffCount);

  const int b = blockIdx.z;
  const int ty0 = blockIdx.y * kTileH, tx0 = blockIdx.x * kTileW;
  const int th = min(kTileH, g.H - ty0), tw = min(kTileW, g.W - tx0);
  const size_t plane = (size_t)g.B * g.H * g.W;
  const uint8_t* img = eye4 + (size_t)b * g.H * g.W;
  constexpr int rb = R;
  // color tiles: fixed row strides, so the taps' offsets are constants
  constexpr int kFastW = kTileW + 2 * R, kFastN = (kTileH + 2 * R) * kFastW;
  constexpr int kHoleW = kWW + 2 * R, kHoleN = (kWH + 2 * R) * kHoleW;
  // window W9 (image coordinates of its origin, its size)
  const int oy = ty0 - kHalo, ox = tx0 - kHalo;
  const int wh = th + 2 * kHalo, ww = tw + 2 * kHalo, wn = wh * ww;

  // 1. the hole test: is an in-image pixel within 1 of the tile not valid?
  if (threadIdx.x == 0) *count = 0;
  int hole_near = 0;
  {
    const int y0 = max(ty0 - 1, 0), x0 = max(tx0 - 1, 0);
    const int bh = min(ty0 + th + 1, g.H) - y0, bw = min(tx0 + tw + 1, g.W) - x0;
    const uint8_t* vp = img + 3 * plane + (size_t)y0 * g.W + x0;
    for_box<kTileW + 2>(bh, bw, [&](int r, int c) {
      hole_near |= vp[(size_t)r * g.W + c] == 0;
    });
  }
  const bool hole_tile = __syncthreads_or(hole_near);
  if (counts != nullptr && threadIdx.x == 0) {
    const int slot = (blockIdx.y * gridDim.x + blockIdx.x) % kCountSlots;
    atomicAdd(counts + kCountStride * slot + (hole_tile ? 1 : 0), 1ull);
  }
  if (!hole_tile) {
    // 2. fast path: every tile pixel keeps its bilateral
    load_colors<kFastW>(img, plane, g, ty0 - rb, tx0 - rb, th + 2 * rb,
                        tw + 2 * rb, kFastN, colors);
    __syncthreads();
    for_box<kTileW>(th, tw, [&](int py, int px) {
      float v[3];
      bilateral_at<R, kFastW>(colors, kFastN, py + rb, px + rb, o, v);
      const size_t dst =
          (size_t)b * g.H * g.W + (size_t)(ty0 + py) * g.W + tx0 + px;
      for (int k = 0; k < 3; ++k) out[k * plane + dst] = (uint8_t)v[k];
    });
    return;
  }

  // 3. hole path. Colors over W9 + rb, the valid plane over W9 + 1 (zero
  // outside the image); keep / known flags over W9
  load_colors<kHoleW>(img, plane, g, oy - rb, ox - rb, wh + 2 * rb,
                      ww + 2 * rb, kHoleN, colors);
  const int vw = ww + 2;
  for_box<kWW + 2>(wh + 2, vw, [&](int r, int c) {
    const int y = oy - 1 + r, x = ox - 1 + c;
    valid[r * vw + c] = y >= 0 && y < g.H && x >= 0 && x < g.W &&
                        img[3 * plane + (size_t)y * g.W + x] != 0;
  });
  __syncthreads();
  for_box<kWW>(wh, ww, [&](int r, int c) {
    const int y = oy + r, x = ox + c;
    const bool inimg = y >= 0 && y < g.H && x >= 0 && x < g.W;
    bool hole = false;
    for (int dy = -1; dy <= 1; ++dy)
      for (int dx = -1; dx <= 1; ++dx) {
        const int qy = y + dy, qx = x + dx;
        if (qy >= 0 && qy < g.H && qx >= 0 && qx < g.W &&
            !valid[(r + 1 + dy) * vw + c + 1 + dx])
          hole = true;
      }
    const bool keep = !(hole && inimg);
    flags[r * ww + c] = (uint8_t)(keep | ((keep && inimg) << 1));
  });
  __syncthreads();
  // the bilateral of W9; a margin pixel takes that of the pixel it
  // reflects, which lies in W9 too (it is as far inside the image as the
  // margin pixel is outside, and W9 reaches 9 past the tile)
  for_box<kWW>(wh, ww, [&](int r, int c) {
    const int ry = clamp_in(oy + r, g.H) - oy, rx = clamp_in(ox + c, g.W) - ox;
    float v[3];
    bilateral_at<R, kHoleW>(colors, kHoleN, ry + rb, rx + rb, o, v);
    for (int k = 0; k < 3; ++k) chans[k * wn + r * ww + c] = (uint8_t)v[k];
  });
  __syncthreads();    // the colors and the valid plane are dead from here

  // both value buffers and known flags start as v0 = known0 ? chans : 0;
  // the pixels not known at the start (only they can change) are listed,
  // as (row << 8) | column
  for_box<kWW>(wh, ww, [&](int r, int c) {
    const int j = r * ww + c;
    const bool kn = (flags[j] >> 1) & 1;
    for (int k = 0; k < 3; ++k) {
      const float v = kn ? (float)chans[k * wn + j] : 0.0f;
      vbuf[k * wn + j] = v;
      vbuf[(3 + k) * wn + j] = v;
    }
    kbuf[0][j] = kn;
    kbuf[1][j] = kn;
    if (!kn && r >= kFillR && r < wh - kFillR && c >= kFillR &&
        c < ww - kFillR)
      list[atomicAdd(count, 1)] = (uint16_t)((r << 8) | c);
  });
  __syncthreads();
  const int nlist = *count;

  // frontier sweeps: sweep s updates the listed pixels of W(9 - 2s), which
  // is all that sweep s + 1 reads; buffer 0 -> 1 -> 0 -> 1
  for (int s = 1; s <= kSweeps; ++s) {
    const float* vin = vbuf + ((s - 1) & 1) * 3 * wn;
    float* vout = vbuf + (s & 1) * 3 * wn;
    const uint8_t* kin = kbuf[(s - 1) & 1];
    uint8_t* kout = kbuf[s & 1];
    const int e = kFillR * s;
    for (int i = threadIdx.x; i < nlist; i += kThreads) {
      const int r = list[i] >> 8, c = list[i] & 0xff, j = r * ww + c;
      if (r < e || r >= wh - e || c < e || c >= ww - e) continue;
      // taps in the plain version's order, unrolled; an unknown neighbour
      // has weight 0 and adds exactly 0 (its value is finite), as there
      float acc[3] = {0.0f, 0.0f, 0.0f};
      float acck = 0.0f;
      int t = 0;
#pragma unroll
      for (int dy = -kFillR; dy <= kFillR; ++dy)
#pragma unroll
        for (int dx = -kFillR; dx <= kFillR; ++dx)
          if ((dy || dx) && dy * dy + dx * dx <= kFillR * kFillR + 1) {
            const int q = j + dy * ww + dx;
            const float wk = kin[q] ? o.fw[t] : 0.0f;
            ++t;
            for (int k = 0; k < 3; ++k)
              acc[k] = __fadd_rn(acc[k], __fmul_rn(wk, vin[k * wn + q]));
            acck = __fadd_rn(acck, wk);
          }
      const bool known = kin[j] != 0;
      const bool reach = acck > 1e-8f;
      const bool upd = !known && reach;
      const float inv_den = __fdiv_rn(1.0f, fmaxf(acck, 1e-8f));
      for (int k = 0; k < 3; ++k)
        vout[k * wn + j] = upd ? __fmul_rn(acc[k], inv_den) : vin[k * wn + j];
      kout[j] = known || reach;
    }
    __syncthreads();
  }
  static_assert(kSweeps & 1, "the last sweep writes buffer 1");
  const float* vfin = vbuf + 3 * wn;
  const uint8_t* kfin = kbuf[1];

  // the values the polish reads, over W3: kept -> bilateral, reached ->
  // swept value, else the quarter-resolution estimate; into buffer 0 (the
  // last sweep's input, free now). The tile's hole pixels are listed.
  float* val = vbuf;
  if (threadIdx.x == 0) *count = 0;     // every thread read it sweeps ago
  __syncthreads();      // the reset lands before any thread adds to it
  constexpr int e3 = kHalo - kPolishR;
  for_box<kTileW + 2 * kPolishR>(
      th + 2 * kPolishR, tw + 2 * kPolishR, [&](int rr, int cc) {
        const int r = rr + e3, c = cc + e3, j = r * ww + c;
        const bool keep = flags[j] & 1;
        if (keep) {
          for (int k = 0; k < 3; ++k) val[k * wn + j] = (float)chans[k * wn + j];
        } else if (kfin[j]) {
          for (int k = 0; k < 3; ++k) val[k * wn + j] = vfin[k * wn + j];
        } else {
          // floor division of the image coordinates by 4
          const int sy = min(max((oy + r) >> 2, 0), g.Hq - 1);
          const int sx = min(max((ox + c) >> 2, 0), g.Wq - 1);
          for (int k = 0; k < 3; ++k)
            val[k * wn + j] = smooth_q[((size_t)k * g.B + b) * g.Hq * g.Wq +
                                       (size_t)sy * g.Wq + sx];
        }
        if (!keep && r >= kHalo && r < kHalo + th && c >= kHalo &&
            c < kHalo + tw)
          list[atomicAdd(count, 1)] = (uint16_t)((r << 8) | c);
      });
  __syncthreads();
  const int nhole = *count;

  // the kept pixels of the tile: their bilateral
  for_box<kTileW>(th, tw, [&](int py, int px) {
    const int j = (py + kHalo) * ww + px + kHalo;
    if (!(flags[j] & 1)) return;
    const size_t dst = (size_t)b * g.H * g.W + (size_t)(ty0 + py) * g.W +
                       tx0 + px;
    for (int k = 0; k < 3; ++k) out[k * plane + dst] = chans[k * wn + j];
  });
  // the hole pixels: the radius-3 polish over val, taps in the plain
  // version's order, divided by the full weight sum
  for (int i = threadIdx.x; i < nhole; i += kThreads) {
    const int r = list[i] >> 8, c = list[i] & 0xff, j = r * ww + c;
    const size_t dst = (size_t)b * g.H * g.W +
                       (size_t)(ty0 + r - kHalo) * g.W + tx0 + c - kHalo;
    for (int k = 0; k < 3; ++k) {
      const float* vk = val + k * wn;
      float acc = 0.0f;
      int t = 0;
#pragma unroll
      for (int dy = -kPolishR; dy <= kPolishR; ++dy)
#pragma unroll
        for (int dx = -kPolishR; dx <= kPolishR; ++dx)
          if ((dy || dx) && dy * dy + dx * dx <= kPolishR * kPolishR + 1)
            acc = __fadd_rn(acc, __fmul_rn(o.pw[t++], vk[j + dy * ww + dx]));
      const float v = __fdiv_rn(acc, o.wsum);
      out[k * plane + dst] = (uint8_t)rintf(fminf(fmaxf(v, 0.0f), 255.0f));
    }
  }
}

int disc_taps(int r, int r2max) {
  int n = 0;
  for (int a = -r; a <= r; ++a)
    for (int c = -r; c <= r; ++c) n += (a || c) && a * a + c * c <= r2max;
  return n;
}

template <int R>
int launch(const uint8_t* eye4, const float* smooth_q, uint8_t* out,
           const Geom& g, const Offsets& o, unsigned long long* counts,
           cudaStream_t s) {
  // (per call: the attribute belongs to the current device)
  cudaError_t err = cudaFuncSetAttribute(
      postprocess_tile_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((g.W + kTileW - 1) / kTileW, (g.H + kTileH - 1) / kTileH, g.B);
  postprocess_tile_kernel<R><<<grid, kThreads, kSmem, s>>>(eye4, smooth_q,
                                                            out, g, o,
                                                            counts);
  return (int)cudaGetLastError();
}

}  // namespace

// tables (host floats, in the plain version's order):
//   [fill weights (nf), polish weights (np), wsum, inv2sc,
//    bilateral space weights (nb)]
// counts: int64 [kCountSlots][kCountStride] on the device to add to (a
//   slot: fast tiles, hole tiles, 2 unused), or null
extern "C" int vsc_postprocess(const uint8_t* eye4, const float* smooth_q,
                               uint8_t* out, const float* tables, int B,
                               int H, int W, int Hq, int Wq, int rb,
                               long long* counts, void* stream) {
  if (rb < 0 || rb > kMaxRb || B < 1 || B > 65535 || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  Offsets o = {};
  o.nf = disc_taps(kFillR, kFillR * kFillR + 1);
  o.np = disc_taps(kPolishR, kPolishR * kPolishR + 1);
  vsc::bilateral_disc(rb, &o.bil);
  int t = 0;
  for (int j = 0; j < o.nf; ++j) o.fw[j] = tables[t++];
  for (int j = 0; j < o.np; ++j) o.pw[j] = tables[t++];
  o.wsum = tables[t++];
  o.bil.inv2sc = tables[t++];
  for (int j = 0; j < o.bil.n; ++j) o.bil.w[j] = tables[t++];
  const Geom g = {B, H, W, Hq, Wq};
  const cudaStream_t s = (cudaStream_t)stream;
  unsigned long long* c = reinterpret_cast<unsigned long long*>(counts);
  switch (rb) {
    case 0: return launch<0>(eye4, smooth_q, out, g, o, c, s);
    case 1: return launch<1>(eye4, smooth_q, out, g, o, c, s);
    case 2: return launch<2>(eye4, smooth_q, out, g, o, c, s);
    case 3: return launch<3>(eye4, smooth_q, out, g, o, c, s);
    case 4: return launch<4>(eye4, smooth_q, out, g, o, c, s);
    case 5: return launch<5>(eye4, smooth_q, out, g, o, c, s);
    case 6: return launch<6>(eye4, smooth_q, out, g, o, c, s);
    default: return launch<7>(eye4, smooth_q, out, g, o, c, s);
  }
}
