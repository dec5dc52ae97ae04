// Average pools of the inpaint pyramid prepass.
//
// Replaces: vsc_tpu/ops/pool_pallas.py  _eye4_pool (entries avgpool2_eye4,
//   avgpool4_eye4) and avgpool2 (the transpose-pool idiom, which exists
//   only because Mosaic cannot lower stride-2 selects), and, at frame
//   sizes those kernels refuse, the jnp glue of vsc_tpu/ops/inpaint.py
//   _pyramid_fill_planar_coarse (two edge-padded 2x2 levels in f32).
// Computes:
//   eye4, f = 4: [4, B, H, W] uint8 (r, g, b, valid), any H, W >= 1 ->
//     [4, B, qh, qw] float32, qh = ceil(ceil(H / 2) / 2) and qw likewise:
//     two 2x2 levels of (r * valid, g * valid, b * valid, valid), each
//     edge-padding an odd side first (inpaint._edge_even). Output (y, x)
//     reads rows min(2 min(2y + a, h1 - 1) + b, H - 1), a, b in {0, 1},
//     h1 = ceil(H / 2), and the columns alike; no clamp fires at
//     multiples of 4, and only the last row and column can clamp.
//   eye4, f = 2: even H, W -> [4, B, H/2, W/2] float32.
//   Every partial sum of the eye4 pools is an integer <= 16 * 255 * 255
//   and the scale a power of two, so the result is exact in any order:
//   bit-identical to avgpool2 (with its edge padding) applied log2(f)
//   times. The masked colors are formed in-kernel, so no full-resolution
//   f32 plane exists in device memory.
//   f32: [N, H, W] -> [N, H/2, W/2], ((a + c) + (b + d)) * 0.25 with a, b
//     the top row: rows summed first, as the jnp average of averages rounds
//     (its * 0.5 steps are exact), so bit-identical to _avgpool2_hw.
// Bound on the H100: memory. The 4K batch of 4 pair [4, 8, 6480, 11847]
//   reads 2.46 GB of u8 and writes 0.61 GB of f32 (0.92 ms at 3.35 TB/s).
//   Rows of an odd W start at any byte, so the f = 4 kernel reads each row
//   as aligned 16-byte chunks, one a lane (a warp's 32 chunks are 512
//   contiguous bytes), takes the next lane's chunk by a shuffle and
//   funnel-shifts the pair to its own 16 bytes: four outputs' columns.
//   Lane 31 only loads, so a warp makes 124 outputs a row. Each output's
//   4-column word goes through __dp4a (r * v summed over the 4 columns in
//   one instruction), its last-column clamp through one __byte_perm, and
//   each lane stores a float4 per plane at a 16-byte aligned address (the
//   lanes' columns are shifted by the row's start mod 4). All 16 chunks of
//   a lane are loaded before any is used. The f = 2 kernel and the f32
//   pool (off the path; kept with the JAX kernels they replace) are one
//   thread per output.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kQuarterWarps = 4;                  // warps a block, f = 4
constexpr int kQuarterCols = 4 * 31;              // outputs a warp, f = 4

__device__ __forceinline__ uint4 load_chunk(uintptr_t c, uintptr_t lo,
                                            uintptr_t hi) {
  // The aligned 16 bytes at c if they hold a byte of [lo, hi), else 0:
  // a chunk past the row's ends is never read (it may lie outside the
  // tensor), and its bytes reach no stored output.
  if (c + 16 > lo && c < hi)
    return __ldg(reinterpret_cast<const uint4*>(c));
  return make_uint4(0u, 0u, 0u, 0u);
}

__global__ void __launch_bounds__(32 * kQuarterWarps)
pool_eye4_kernel(const uint8_t* __restrict__ in, float* __restrict__ out,
                 int N, int H, int W, int qh, int qw, unsigned last_sel) {
  const int y = blockIdx.y, n = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const size_t plane = (size_t)N * H * W, oplane = (size_t)N * qh * qw;
  const size_t orow = ((size_t)n * qh + y) * qw;
  // the warp's first output column: shifted left by the row's start mod 4
  // so that every lane's four outputs start 16-byte aligned
  const int o = (int)(orow & 3);
  const int xw = kQuarterCols * (blockIdx.x * kQuarterWarps
                                 + (threadIdx.x >> 5)) - o;
  if (xw >= qw) return;                           // the whole warp is past
  const int x0 = xw + 4 * lane;
  const int h1 = (H + 1) >> 1;

  // every chunk first: [row k][plane c], the row's 16-byte shift beside it
  uint4 cur[4][4];
  unsigned shift[4][4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int r = min(2 * min(2 * y + (k >> 1), h1 - 1) + (k & 1), H - 1);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uintptr_t row = reinterpret_cast<uintptr_t>(
          in + c * plane + ((size_t)n * H + r) * W);
      const uintptr_t span = row + (intptr_t)4 * xw;
      const uintptr_t base = span & ~(uintptr_t)15;
      shift[k][c] = (unsigned)(span - base);
      cur[k][c] = load_chunk(base + 16 * lane, row, row + W);
    }
  }

  unsigned acc[4][4] = {};                        // [plane][output]
  const int il = qw - 1 - x0;                     // the last column, if here
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    unsigned w[4][4];                             // [plane][output] columns
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uint4 a = cur[k][c];
      const unsigned u[8] = {
          a.x, a.y, a.z, a.w, __shfl_down_sync(0xffffffffu, a.x, 1),
          __shfl_down_sync(0xffffffffu, a.y, 1),
          __shfl_down_sync(0xffffffffu, a.z, 1),
          __shfl_down_sync(0xffffffffu, a.w, 1)};
      const unsigned q = shift[k][c] >> 2, bits = 8 * (shift[k][c] & 3);
      unsigned v[5];
#pragma unroll
      for (int i = 0; i < 5; ++i) {
        v[i] = u[i];
#pragma unroll
        for (int t = 1; t < 4; ++t)
          if (q == (unsigned)t) v[i] = u[i + t];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        w[c][i] = __funnelshift_r(v[i], v[i + 1], bits);
        if (i == il) w[c][i] = __byte_perm(w[c][i], 0u, last_sel);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[3][i] = __dp4a(w[3][i], 0x01010101u, acc[3][i]);
#pragma unroll
      for (int c = 0; c < 3; ++c)
        acc[c][i] = __dp4a(w[c][i], w[3][i], acc[c][i]);
    }
  }

  if (lane == 31) return;                         // it only loaded
  const bool vec = (oplane & 3) == 0 && x0 >= 0 && x0 + 3 < qw;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    float* dst = out + (c * oplane + orow);
    float s[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i] = (float)acc[c][i] * 0.0625f;
    if (vec) {
      *reinterpret_cast<float4*>(dst + x0) = make_float4(s[0], s[1], s[2],
                                                         s[3]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (x0 + i >= 0 && x0 + i < qw) dst[x0 + i] = s[i];
    }
  }
}

__global__ void pool2_eye4_kernel(const uint8_t* __restrict__ in,
                                  float* __restrict__ out, int B, int H,
                                  int W) {
  const int Ho = H / 2, Wo = W / 2;
  const int x = blockIdx.x * kThreads + threadIdx.x;
  const int y = blockIdx.y;
  const int b = blockIdx.z;
  if (x >= Wo) return;
  const size_t plane = (size_t)B * H * W;
  const uint8_t* base = in + (size_t)b * H * W + (size_t)(y * 2) * W + x * 2;
  float sum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int dx = 0; dx < 2; ++dx) {
    for (int dy = 0; dy < 2; ++dy) {
      const size_t off = (size_t)dy * W + dx;
      const float v = (float)base[3 * plane + off];
      sum[3] += v;
      for (int c = 0; c < 3; ++c) sum[c] += (float)base[c * plane + off] * v;
    }
  }
  const size_t oplane = (size_t)B * Ho * Wo;
  const size_t o = (size_t)b * Ho * Wo + (size_t)y * Wo + x;
  for (int c = 0; c < 4; ++c) out[c * oplane + o] = sum[c] * 0.25f;
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
  if (f == 2) {
    if (B < 1 || B > 65535 || H < 2 || W < 2 || H % 2 || W % 2
        || H / 2 > 65535)
      return (int)cudaErrorInvalidValue;
    dim3 grid((W / 2 + kThreads - 1) / kThreads, H / 2, B);
    pool2_eye4_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        in, out, B, H, W);
    return (int)cudaGetLastError();
  }
  const int h1 = (H + 1) / 2, w1 = (W + 1) / 2;
  const int qh = (h1 + 1) / 2, qw = (w1 + 1) / 2;
  if (f != 4 || B < 1 || B > 65535 || H < 1 || W < 1 || qh > 65535
      || ((uintptr_t)out & 15))
    return (int)cudaErrorInvalidValue;
  // the last output column's four source columns, as a __byte_perm
  // selector over the word at column 4 (qw - 1); 0x3210 where none clamps
  unsigned last_sel = 0;
  const int x = qw - 1;
  for (int k = 0; k < 4; ++k) {
    const int col = min(2 * min(2 * x + (k >> 1), w1 - 1) + (k & 1), W - 1);
    last_sel |= (unsigned)(col - 4 * x) << (4 * k);
  }
  const int warps = (qw + 3 + kQuarterCols - 1) / kQuarterCols;
  dim3 grid((warps + kQuarterWarps - 1) / kQuarterWarps, qh, B);
  pool_eye4_kernel<<<grid, 32 * kQuarterWarps, 0, (cudaStream_t)stream>>>(
      in, out, B, H, W, qh, qw, last_sel);
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
