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
//   R x R input pixels of the box, the separable 5-tap gaussian (sigma 1)
//   horizontally then vertically, in tap order, over reflect-101 borders
//   inside the crop (jnp.pad(mode="reflect")); then
//   sharp = clip(x + s * (x - blur), 0, 255); the box sum over rows, then
//   over columns; division by R^2; and for u8 output floor(clip(., 0,
//   255)). __fmul_rn/__fadd_rn keep the plain version's order and rounding
//   (no FMA contraction), and the division rounds as IEEE division does, so
//   kernel and plain version agree exactly.
// Bound on the H100: issue. The 1080p super_sampling 3 pair reads 224 MB of
//   u8 and writes 25 MB (0.075 ms at 3.35 TB/s), but without contraction
//   every f32 multiply and add is an instruction of its own: ~26 a cropped
//   input pixel (9 for each 5-tap pass, 5 for the sharpen and its clip, 1
//   for the box, 2 for the byte's conversion), ~0.17 ms at the card's
//   ~33.5 T lane instructions a second, before any address arithmetic.
// Design: R is a template parameter (1..8), so the box loops unroll and
//   every index is a constant. A thread owns one output column, i.e. R
//   input columns, and walks down a tile of 16 output rows (16 R + 4 input
//   rows; blocks of 64 threads). Per input row it loads the R + 4 bytes it
//   needs as aligned 32-bit words (rows of 6090 bytes and arbitrary crop
//   offsets start anywhere in a word, so the words are shifted into place
//   with funnel shifts, and nothing is read at an unaligned address), five
//   rows ahead of their use, from a ring of five slots that is refilled as
//   it is read (the loop is unrolled by five, so no slot ever moves). The
//   horizontal pass of each of its pixels is computed once and kept in
//   registers as its products with the three distinct taps (the 5 taps are
//   symmetric, t3 == t1 and t4 == t0 bit for bit): the vertical pass is then
//   four adds in the plain version's order. The sharpen and the box sums run
//   from registers; sum / R^2 is a double multiply, which rounds as the
//   division does. Tiles whose rows all lie inside the plane walk a row
//   pointer; tiles at the plane's top or bottom reflect each row; the
//   threads whose R + 4 bytes cross a crop border load byte by byte at
//   columns reflected once per thread. Measured against the alternatives
//   by scripts/probe_kernels.py: the bytes convert faster by I2F than by
//   the exponent trick (0x4B0000bb - 2^23); 64 threads by 16 rows beat 128
//   threads and tiles of 8 or 32 rows; each thread loading its own words
//   beats staging the block's rows in shared memory with 16-byte loads
//   (~1.4x slower: the same reads and shifts, from shared memory, plus the
//   staging and its barriers), and a byte store a thread beats packing 4
//   output bytes a store by shuffles.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 64;       // threads a block
constexpr int kTileH = 16;         // output rows a block
constexpr int kMaxRatio = 8;

// the 5 taps are symmetric (t3 == t1 and t4 == t0, which the host checks),
// so tap t is t[tap(t)]: the products of one value and the taps t and
// 4 - t are the same float, and are computed once
struct Taps {
  float t[3];
};

__host__ __device__ constexpr int tap(int t) { return t < 3 ? t : 4 - t; }

__device__ __forceinline__ int reflect101(int i, int n) {
  if (i >= 0 && i < n) return i;   // the common case: no division
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  i %= period;
  if (i < 0) i += period;
  return i < n ? i : period - i;
}

// (float)b of byte k of w
__device__ __forceinline__ float byte_float(uint32_t w, int k) {
  return (float)((w >> (8 * k)) & 0xffu);
}

// the aligned words that hold B input bytes, and where in them the bytes
// start
template <int B>
struct Span {
  static constexpr int kA = (B + 3) / 4;   // aligned words the bytes fill
  uint32_t w[kA + 1];
  int o;
};

// the words of the B bytes from p on; a word that holds none of them is not
// read (it may lie past the tensor), only word kA can be such a word
template <int B>
__device__ __forceinline__ void load_span(const uint8_t* p, Span<B>& sp) {
  constexpr int kA = Span<B>::kA;
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(a & ~uintptr_t(3));
  sp.o = (int)(a & 3);
#pragma unroll
  for (int i = 0; i < kA; ++i) sp.w[i] = __ldg(w + i);
  if (4 * kA > B + 2) sp.w[kA] = 0u;            // never one of ours
  else sp.w[kA] = 4 * kA <= sp.o + B - 1 ? __ldg(w + kA) : 0u;
}

template <int B>
__device__ __forceinline__ void span_floats(const Span<B>& sp, float (&v)[B]) {
  uint32_t a[Span<B>::kA];
#pragma unroll
  for (int i = 0; i < Span<B>::kA; ++i)
    a[i] = __funnelshift_r(sp.w[i], sp.w[i + 1], 8 * sp.o);
#pragma unroll
  for (int m = 0; m < B; ++m) v[m] = byte_float(a[m >> 2], m & 3);
}

// how a tile's columns and rows are read
enum Mode {
  kInside,      // every row inside the plane, the columns inside the crop
  kRowBorder,   // rows reflected at the plane's top or bottom
  kColBorder,   // columns reflected too: one byte load a pixel
};

// one output column (R input columns from c0 on) over a tile of output rows
template <int R, bool kU8, Mode kMode>
__device__ __forceinline__ void finish_column(
    const uint8_t* __restrict__ src, const Taps& k, int H, int Wf, int crop_w,
    float strength, void* __restrict__ out, size_t o0, int out_w, int c0,
    int oy0, int rows_out) {
  // input row i of the tile is plane row y0 + i; rows 0 .. 3 only fill the
  // ring, then each group of five runs the vertical pass of five box rows
  // (rows past the tile's are read, at reflected rows where they leave the
  // plane, and not stored)
  const int y0 = oy0 * R - 2;
  const int groups = (rows_out * R + 4) / 5;
  const uint8_t* base = src + c0 - 2;
  // kInside: the row the ring's loads reach next, walking down the rows
  const uint8_t* next = kMode == kInside ? base + (size_t)y0 * Wf : base;

  // the horizontal pass of a ring of five input rows, as its products
  // with the taps 0 (and 4), 1 (and 3) and 2
  float p0[5][R], p1[5][R], p2[5][R];
  float xr[5][R];     // the rows' own pixels (the sharpen's centre)
  float col[R];       // box sums of the columns so far
#pragma unroll
  for (int j = 0; j < R; ++j) col[j] = -0.0f;   // -0 + s == s exactly
  int rb = 0, oy = 0;
  // the words of input rows i .. i + 4 (row i in slot i mod 5); a slot is
  // refilled with row i + 5 right after row i is read from it
  Span<R + 4> ring[5];
  // kColBorder: the reflected crop columns of the R + 4 bytes
  int cols[kMode == kColBorder ? R + 4 : 1];
  if constexpr (kMode == kColBorder) {
#pragma unroll
    for (int m = 0; m < R + 4; ++m) cols[m] = reflect101(c0 - 2 + m, crop_w);
  }
  auto fill = [&](Span<R + 4>& sp, int i) {
    if constexpr (kMode == kInside) {
      load_span(next, sp);
      next += Wf;
    } else {
      load_span(base + (size_t)reflect101(y0 + i, H) * Wf, sp);
    }
  };
  // the horizontal pass of input row i, into slot S
  auto hpass = [&](auto S, int i) {
    constexpr int s = decltype(S)::value;
    float v[R + 4];
    if constexpr (kMode == kColBorder) {
      const uint8_t* row = src + (size_t)reflect101(y0 + i, H) * Wf;
#pragma unroll
      for (int m = 0; m < R + 4; ++m) v[m] = (float)__ldg(row + cols[m]);
    } else {
      span_floats(ring[s], v);
      fill(ring[s], i + 5);
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      float acc = __fmul_rn(k.t[0], v[j]);
#pragma unroll
      for (int t = 1; t < 5; ++t)
        acc = __fadd_rn(acc, __fmul_rn(k.t[tap(t)], v[j + t]));
      p0[s][j] = __fmul_rn(k.t[0], acc);
      p1[s][j] = __fmul_rn(k.t[1], acc);
      p2[s][j] = __fmul_rn(k.t[2], acc);
      xr[s][j] = v[j + 2];
    }
  };
  // input rows i - 4 .. i sit in slots S + 1 .. S (mod 5): the vertical
  // pass of row i - 2, its sharpen, and its place in the box sums
  auto vpass = [&](auto S) {
    constexpr int s = decltype(S)::value;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      // t0 h[i-4] + t1 h[i-3] + t2 h[i-2] + t3 h[i-1] + t4 h[i], in order
      float blur = __fadd_rn(p0[(s + 1) % 5][j], p1[(s + 2) % 5][j]);
      blur = __fadd_rn(blur, p2[(s + 3) % 5][j]);
      blur = __fadd_rn(blur, p1[(s + 4) % 5][j]);
      blur = __fadd_rn(blur, p0[s][j]);
      const float ctr = xr[(s + 3) % 5][j];
      const float sharp = fminf(fmaxf(
          __fadd_rn(ctr, __fmul_rn(strength, __fsub_rn(ctr, blur))), 0.0f),
          255.0f);
      col[j] = __fadd_rn(col[j], sharp);
    }
    if (++rb == R) {
      float sum = col[0];
#pragma unroll
      for (int j = 1; j < R; ++j) sum = __fadd_rn(sum, col[j]);
      // sum / R^2 correctly rounded, as __fdiv_rn: the double product errs
      // by < 2^-52 of it, and sum / R^2 lies more than 2^-30 of it away from
      // the middle of two floats
      const float res =
          __double2float_rn(__dmul_rn((double)sum, 1.0 / (R * R)));
      if (oy < rows_out) {
        const size_t o = o0 + (size_t)oy * out_w;
        if constexpr (kU8)
          static_cast<uint8_t*>(out)[o] =
              (uint8_t)floorf(fminf(fmaxf(res, 0.0f), 255.0f));
        else
          static_cast<float*>(out)[o] = res;
      }
#pragma unroll
      for (int j = 0; j < R; ++j) col[j] = -0.0f;
      rb = 0;
      ++oy;
    }
  };
  using S0 = std::integral_constant<int, 0>;
  using S1 = std::integral_constant<int, 1>;
  using S2 = std::integral_constant<int, 2>;
  using S3 = std::integral_constant<int, 3>;
  using S4 = std::integral_constant<int, 4>;

  if constexpr (kMode != kColBorder) {
    fill(ring[0], 0);
    fill(ring[1], 1);
    fill(ring[2], 2);
    fill(ring[3], 3);
    fill(ring[4], 4);
  }
  hpass(S0(), 0);
  hpass(S1(), 1);
  hpass(S2(), 2);
  hpass(S3(), 3);
#pragma unroll 1
  for (int g = 0; g < groups; ++g) {
    const int i = 4 + 5 * g;
    hpass(S4(), i);
    vpass(S4());
    hpass(S0(), i + 1);
    vpass(S0());
    hpass(S1(), i + 2);
    vpass(S1());
    hpass(S2(), i + 3);
    vpass(S2());
    hpass(S3(), i + 4);
    vpass(S3());
  }
}

template <int R, bool kU8>
__global__ void sharpen_downscale_kernel(const uint8_t* __restrict__ x,
                         void* __restrict__ out, Taps k, int N, int H,
                         int Wf, int crop_w, int off0, int off1, int nsplit,
                         float strength, int out_h, int out_w) {
  const int ox = blockIdx.x * kThreads + threadIdx.x;
  if (ox >= out_w) return;
  const int plane = blockIdx.z;                 // c * N + n
  const int n = plane % N;
  const int oy0 = blockIdx.y * kTileH;
  const int rows_out = min(kTileH, out_h - oy0);
  const int c0 = ox * R;                        // first input column
  const uint8_t* src = x + (size_t)plane * H * Wf + (n < nsplit ? off0 : off1);
  const size_t o0 = ((size_t)plane * out_h + oy0) * out_w + ox;
  // the rows the tile's ring loads, y0 .. y1 - 1
  const int y0 = oy0 * R - 2, y1 = y0 + (rows_out * R + 4) / 5 * 5 + 9;
  if (c0 < 2 || c0 + R + 2 > crop_w)
    finish_column<R, kU8, kColBorder>(src, k, H, Wf, crop_w, strength, out,
                                      o0, out_w, c0, oy0, rows_out);
  else if (y0 < 0 || y1 > H)
    finish_column<R, kU8, kRowBorder>(src, k, H, Wf, crop_w, strength, out,
                                      o0, out_w, c0, oy0, rows_out);
  else
    finish_column<R, kU8, kInside>(src, k, H, Wf, crop_w, strength, out, o0,
                                   out_w, c0, oy0, rows_out);
}

template <int R>
int launch(const uint8_t* x, void* out, const Taps& k, int N, int H, int Wf,
           int crop_w, int off0, int off1, int nsplit, float strength,
           int out_h, int out_w, int out_u8, cudaStream_t s) {
  dim3 grid((out_w + kThreads - 1) / kThreads, (out_h + kTileH - 1) / kTileH,
            3 * N);
  if (out_u8)
    sharpen_downscale_kernel<R, true><<<grid, kThreads, 0, s>>>(
        x, out, k, N, H, Wf, crop_w, off0, off1, nsplit, strength, out_h,
        out_w);
  else
    sharpen_downscale_kernel<R, false><<<grid, kThreads, 0, s>>>(
        x, out, k, N, H, Wf, crop_w, off0, off1, nsplit, strength, out_h,
        out_w);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vsc_finish(const uint8_t* x, void* out, const float* taps,
                          int N, int H, int Wf, int crop_w, int off0,
                          int off1, int nsplit, int ratio, float strength,
                          int out_h, int out_w, int out_u8, void* stream) {
  // a plane's byte offsets are 32-bit
  if (N < 1 || 3 * N > 65535 || ratio < 1 || ratio > kMaxRatio
      || (out_h + kTileH - 1) / kTileH > 65535
      || out_h < 1 || out_w < 1 || out_h * ratio > H
      || out_w * ratio > crop_w || crop_w < 3 || H < 3 || off0 < 0
      || off1 < 0 || off0 + crop_w > Wf || off1 + crop_w > Wf
      || (long long)H * Wf + 3 > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  if (taps[3] != taps[1] || taps[4] != taps[0])
    return (int)cudaErrorInvalidValue;
  Taps k;
  for (int t = 0; t < 3; ++t) k.t[t] = taps[t];
  cudaStream_t s = (cudaStream_t)stream;
  switch (ratio) {
#define VSC_R(R)                                                          \
    case R:                                                               \
      return launch<R>(x, out, k, N, H, Wf, crop_w, off0, off1, nsplit,   \
                       strength, out_h, out_w, out_u8, s);
    VSC_R(1) VSC_R(2) VSC_R(3) VSC_R(4) VSC_R(5) VSC_R(6) VSC_R(7) VSC_R(8)
#undef VSC_R
    default: return (int)cudaErrorInvalidValue;
  }
}
