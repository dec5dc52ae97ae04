// Masked push-pull pyramid: the whole level ladder of the quarter.
//
// Replaces: vsc_tpu/ops/pyramid_pallas.py  pyramid_fill_below / _kernel,
//   and the torch glue levels above the TPU kernel's handoff
//   (vsc_tpu/ops/inpaint.py, VSC_TPU_PYR_KMAX): the levels are the same
//   bits wherever the handoff lies, so this kernel takes the quarter
//   itself.
// Computes: for every frame n of quarter [4, N, h, w] float32 (img * valid
//   for r, g, b, then the pooled valid), the level ladder down to 1 x 1 and
//   back: each pool edge-pads odd dims and takes ((a + c) + (b + d)) * 0.25
//   (rows first, as the jnp average of averages rounds); the top level is
//   img / max(msk, 1e-8); going up, a level keeps img / max(msk, 1e-8)
//   where msk > 1e-8 and otherwise the nearest 2x expansion of the level
//   above (plain replication: a level is always ceil(parent / 2)). IEEE
//   divides and no FMA contraction, so every level is bit-identical to the
//   torch ladder (ops/inpaint.py _push_pull_hw). Out: [3, N, h, w] float32.
// Bound on the H100: bytes. At 1080p super_sampling 3 the quarter is
//   [4, 4, 810, 1523] (79 MB) and the ladder has 11 levels, each dependent
//   on the last; reading it once and writing the [3, 4, 810, 1523] output
//   (59 MB) takes 0.041 ms at 3.35 TB/s.
// Design: three launches on the caller's stream.
//   The pool of a 2^K x 2^K aligned region of level 0 is its own business:
//   a child's clamped index min(2i + 1, h - 1) never leaves its parent's
//   region, so levels 1..K of a region come from that region alone, and
//   so does the fill of the region from level K - 1 down to 0, given the
//   filled level K. So
//   1. down (all SMs): one block per 32 x 32 region of level 0 reads it
//      once and pools levels 1-5 in shared memory; level 5 (one value a
//      region, [4, N, ceil(h / 32), ceil(w / 32)]) goes to a workspace;
//   2. top (one block per frame): the ladder from level 5 (26 x 48 at
//      1080p) down to 1 x 1 and back, in the workspace (L2-resident);
//   3. up (all SMs): one block per region reads level 0 again, pools
//      levels 1-4 again (the same bits), fills them down from the region's
//      filled level 5 value, and writes the output once, staged in shared
//      memory so that a warp writes a row of the region as one run (a
//      thread's own 2 x 2 pixels, written in place, took 1.16x as long).
//   Blocks of the up pass run in the reverse order of the down pass's, so
//   the first of them find in L2 the end of level 0 that the down pass
//   read last. A region of an input smaller than 32 x 32 pools past its
//   1 x 1 level; pooling a 1 x 1 level gives the same bits ((a + a) +
//   (a + a)) * 0.25 == a), and so does filling it, so the extra levels
//   change nothing. Indices come from shifts and precomputed level sizes:
//   no per-element division in the wide passes.

#include <cuda_runtime.h>

namespace {

constexpr int kK = 5;                   // levels pooled inside a region
constexpr int kRegion = 1 << kK;        // its side at level 0
constexpr int kSide1 = kRegion / 2;     // its side at level 1
constexpr int kWideThreads = kSide1 * kSide1;   // a thread per level-1 pixel
constexpr int kTopThreads = 1024;
constexpr int kMaxLevels = 33;          // int dims halve to 1 in <= 31 steps
constexpr float kEps = 1e-8f;

struct Dims {
  int N, h[kMaxLevels], w[kMaxLevels];  // level l's size (l <= kK + top)
  int top;                      // pools from level kK down to 1 x 1
  long long off[kMaxLevels];    // per-frame workspace offset of level kK + m
  long long top_frame;          // per-frame workspace floats of levels > kK
};

__device__ __forceinline__ float pool4(float a, float b, float c, float d) {
  return __fmul_rn(__fadd_rn(__fadd_rn(a, c), __fadd_rn(b, d)), 0.25f);
}

__device__ __forceinline__ float fill(float img, float msk, float up) {
  return msk > kEps ? __fdiv_rn(img, fmaxf(msk, kEps)) : up;
}

// The region's levels of side S, S / 2, ..., 2 in shared memory (levels
// 1..kK - 1), each [4][side][side].
template <int S>
struct Region {
  float lv[4][S][S];
  Region<S / 2> below;
};
template <>
struct Region<1> {};

// the valid extents of levels 1..kK in the region (by, bx): rows, columns
struct Extents {
  int e[kK + 1][2];
  __device__ __forceinline__ Extents(const Dims& d, int by, int bx) {
    for (int l = 1; l <= kK; ++l) {
      e[l][0] = min(kRegion >> l, d.h[l] - by * (kRegion >> l));
      e[l][1] = min(kRegion >> l, d.w[l] - bx * (kRegion >> l));
    }
  }
};

// Pools the region's levels below r.lv (level l, side S) down to level kK;
// with `top` non-null, threads 0-3 leave level kK's value in top[plane].
template <int S>
__device__ __forceinline__ void pool_levels(Region<S>& r, const Extents& x,
                                            int l, float* top) {
  const int ph = x.e[l][0], pw = x.e[l][1];
  if constexpr (S == 2) {
    if (top != nullptr && threadIdx.x < 4) {
      const int c = threadIdx.x;
      const int i1 = min(1, ph - 1), j1 = min(1, pw - 1);
      top[c] = pool4(r.lv[c][0][0], r.lv[c][0][j1], r.lv[c][i1][0],
                     r.lv[c][i1][j1]);
    }
  } else {
    constexpr int C = S / 2;
    const int ch = x.e[l + 1][0], cw = x.e[l + 1][1];
    for (int k = threadIdx.x; k < 4 * C * C; k += kWideThreads) {
      const int pl = k / (C * C), i = (k / C) % C, j = k % C;
      if (i < ch && j < cw) {
        const int i1 = min(2 * i + 1, ph - 1), j1 = min(2 * j + 1, pw - 1);
        r.below.lv[pl][i][j] =
            pool4(r.lv[pl][2 * i][2 * j], r.lv[pl][2 * i][j1],
                  r.lv[pl][i1][2 * j], r.lv[pl][i1][j1]);
      }
    }
    __syncthreads();
    pool_levels<C>(r.below, x, l + 1, top);
  }
}

// Fills the region's levels from the innermost (side 2, from the region's
// filled level-kK value top[3]) out to r.lv, each over its color planes
// from the filled level inside it. Entries past a level's valid extent
// hold values no valid pixel reads.
template <int S>
__device__ __forceinline__ void fill_levels(Region<S>& r, const float* top) {
  if constexpr (S > 2) fill_levels<S / 2>(r.below, top);
  for (int k = threadIdx.x; k < 3 * S * S; k += kWideThreads) {
    const int c = k / (S * S), i = (k / S) % S, j = k % S;
    float up;
    if constexpr (S == 2) up = top[c];
    else up = r.below.lv[c][i >> 1][j >> 1];
    r.lv[c][i][j] = fill(r.lv[c][i][j], r.lv[3][i][j], up);
  }
  __syncthreads();
}

// Level 0 of the thread's level-1 pixel (2 x 2, clamped at odd edges) into
// v[plane][4], level 1 into shared memory, then levels 2..kK - 1, and
// unless `top` is null level kK's value into top[4] (threads 0-3).
__device__ __forceinline__ void pool_region(const float* __restrict__ q,
                                            const Dims& d, int n, int by,
                                            int bx, Region<kSide1>& s,
                                            float v[4][4], float* top) {
  const int h = d.h[0], w = d.w[0];
  const size_t plane = (size_t)d.N * h * w;
  const int i = threadIdx.x / kSide1, j = threadIdx.x % kSide1;
  const int gy = by * kSide1 + i, gx = bx * kSide1 + j;
  if (gy < d.h[1] && gx < d.w[1]) {
    const int y0 = 2 * gy, y1 = min(2 * gy + 1, h - 1);
    const int x0 = 2 * gx, x1 = min(2 * gx + 1, w - 1);
    const float* f = q + (size_t)n * h * w;
    for (int c = 0; c < 4; ++c) {
      const float* p = f + c * plane;
      v[c][0] = p[(size_t)y0 * w + x0];
      v[c][1] = p[(size_t)y0 * w + x1];
      v[c][2] = p[(size_t)y1 * w + x0];
      v[c][3] = p[(size_t)y1 * w + x1];
      s.lv[c][i][j] = pool4(v[c][0], v[c][1], v[c][2], v[c][3]);
    }
  }
  __syncthreads();
  pool_levels<kSide1>(s, Extents(d, by, bx), 1, top);
}

// 1. down: level kK of every region into the workspace
__global__ void __launch_bounds__(kWideThreads)
    pyramid_down_kernel(const float* __restrict__ q, float* __restrict__ ws,
                        Dims d) {
  __shared__ Region<kSide1> s;
  const int n = blockIdx.z, by = blockIdx.y, bx = blockIdx.x;
  float v[4][4];
  float top[4];
  pool_region(q, d, n, by, bx, s, v, top);
  if (threadIdx.x < 4) {
    const int hk = d.h[kK], wk = d.w[kK];
    ws[(((size_t)threadIdx.x * d.N + n) * hk + by) * wk + bx] =
        top[threadIdx.x];
  }
}

// 2. top: the ladder of one frame from level kK to 1 x 1 and back, its
// filled level kK over the workspace's level-kK color planes. The levels
// are read and written across __syncthreads(), so not __restrict__.
__global__ void __launch_bounds__(kTopThreads)
    pyramid_top_kernel(float* ws, Dims d) {
  const int n = blockIdx.x;
  const int hk = d.h[kK], wk = d.w[kK];
  const size_t kplane = (size_t)d.N * hk * wk;
  float* frame = ws + 4 * kplane + (size_t)n * d.top_frame;
  // plane c of ladder level m (level kK + m)
  auto plane = [&](int m, int c) -> float* {
    if (m == 0) return ws + c * kplane + (size_t)n * hk * wk;
    return frame + d.off[m] + (size_t)c * d.h[kK + m] * d.w[kK + m];
  };
  for (int m = 0; m < d.top; ++m) {
    const int ph = d.h[kK + m], pw = d.w[kK + m];
    const int cw = d.w[kK + m + 1], area = d.h[kK + m + 1] * cw;
    for (int p = threadIdx.x; p < area; p += kTopThreads) {
      const int y = p / cw, x = p - y * cw;
      const int y0 = 2 * y, y1 = min(2 * y + 1, ph - 1);
      const int x0 = 2 * x, x1 = min(2 * x + 1, pw - 1);
      for (int c = 0; c < 4; ++c) {
        const float* s = plane(m, c);
        plane(m + 1, c)[p] = pool4(s[y0 * pw + x0], s[y0 * pw + x1],
                                   s[y1 * pw + x0], s[y1 * pw + x1]);
      }
    }
    __syncthreads();
  }
  {
    const int area = d.h[kK + d.top] * d.w[kK + d.top];
    const float* msk = plane(d.top, 3);
    for (int p = threadIdx.x; p < area; p += kTopThreads)
      for (int c = 0; c < 3; ++c)
        plane(d.top, c)[p] =
            __fdiv_rn(plane(d.top, c)[p], fmaxf(msk[p], kEps));
    __syncthreads();
  }
  for (int m = d.top - 1; m >= 0; --m) {
    const int ww = d.w[kK + m], area = d.h[kK + m] * ww;
    const int cw = d.w[kK + m + 1];
    const float* msk = plane(m, 3);
    for (int p = threadIdx.x; p < area; p += kTopThreads) {
      const int y = p / ww, x = p - y * ww;
      const int up = (y >> 1) * cw + (x >> 1);
      for (int c = 0; c < 3; ++c)
        plane(m, c)[p] = fill(plane(m, c)[p], msk[p], plane(m + 1, c)[up]);
    }
    __syncthreads();
  }
}

// 3. up: the region's levels 1..kK - 1 again, filled from its level-kK
// value down to level 0, written once
__global__ void __launch_bounds__(kWideThreads)
    pyramid_up_kernel(const float* __restrict__ q,
                      const float* __restrict__ ws, float* __restrict__ out,
                      Dims d) {
  __shared__ Region<kSide1> s;
  __shared__ float top[3];
  __shared__ float o0[3][kRegion][kRegion + 1];   // the filled level 0
  // the reverse of the down pass's block order
  const int n = gridDim.z - 1 - blockIdx.z;
  const int by = gridDim.y - 1 - blockIdx.y;
  const int bx = gridDim.x - 1 - blockIdx.x;
  const int hk = d.h[kK], wk = d.w[kK];
  if (threadIdx.x < 3)
    top[threadIdx.x] =
        ws[(((size_t)threadIdx.x * d.N + n) * hk + by) * wk + bx];
  float v[4][4];
  pool_region(q, d, n, by, bx, s, v, nullptr);
  fill_levels<kSide1>(s, top);
  // level 0 through a staged tile: a thread fills its 2 x 2 pixels, then
  // a warp writes each output row of the region as one coalesced run
  const int h = d.h[0], w = d.w[0];
  {
    const int i = threadIdx.x / kSide1, j = threadIdx.x % kSide1;
    for (int a = 0; a < 2; ++a)
      for (int b = 0; b < 2; ++b)
        for (int c = 0; c < 3; ++c)
          o0[c][2 * i + a][2 * j + b] =
              fill(v[c][2 * a + b], v[3][2 * a + b], s.lv[c][i][j]);
  }
  __syncthreads();
  const int lane = threadIdx.x % kRegion, x = bx * kRegion + lane;
  if (x >= w) return;
  const size_t plane = (size_t)d.N * h * w;
  float* o = out + (size_t)n * h * w + x;
  for (int r = threadIdx.x / kRegion; r < kRegion;
       r += kWideThreads / kRegion) {
    const int y = by * kRegion + r;
    if (y >= h) break;
    for (int c = 0; c < 3; ++c) o[c * plane + (size_t)y * w] = o0[c][r][lane];
  }
}

// the level sizes and the workspace layout; returns the workspace floats
long long layout(int N, int h, int w, Dims* d) {
  d->N = N;
  d->h[0] = h;
  d->w[0] = w;
  for (int l = 1; l <= kK; ++l) {
    d->h[l] = (d->h[l - 1] + 1) / 2;
    d->w[l] = (d->w[l - 1] + 1) / 2;
  }
  int l = kK;
  long long off = 0;
  d->off[0] = 0;
  while (d->h[l] > 1 || d->w[l] > 1) {
    d->h[l + 1] = (d->h[l] + 1) / 2;
    d->w[l + 1] = (d->w[l] + 1) / 2;
    d->off[l + 1 - kK] = off;
    off += 4LL * d->h[l + 1] * d->w[l + 1];
    ++l;
  }
  d->top = l - kK;
  d->top_frame = off;
  return 4LL * N * d->h[kK] * d->w[kK] + (long long)N * off;
}

}  // namespace

// The workspace vsc_pyramid needs for [4, N, h, w], in floats, into *n.
extern "C" int vsc_pyramid_workspace(int N, int h, int w, long long* n) {
  Dims d;
  *n = layout(N, h, w, &d);
  return 0;
}

// ws: vsc_pyramid_workspace's floats, refused if fewer
extern "C" int vsc_pyramid(const float* q, float* out, float* ws, int N,
                           int h, int w, long long ws_floats, void* stream) {
  if (N < 1 || N > 65535 || h < 1 || w < 1) return (int)cudaErrorInvalidValue;
  Dims d;
  if (layout(N, h, w, &d) > ws_floats) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(d.w[kK], d.h[kK], N);
  pyramid_down_kernel<<<grid, kWideThreads, 0, s>>>(q, ws, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  pyramid_top_kernel<<<N, kTopThreads, 0, s>>>(ws, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  pyramid_up_kernel<<<grid, kWideThreads, 0, s>>>(q, ws, out, d);
  return (int)cudaGetLastError();
}
