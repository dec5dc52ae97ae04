// Integer-factor bilinear upsample (half-pixel source mapping, clamped edges).
//
// Replaces: vsc_tpu/ops/upsample_pallas.py  upsample_bilinear_int_pallas /
//   _kernel (banded matmuls on the MXU with bf16 hi/lo operand splits, not
//   carried over).
// Computes: out[n, F*i + p, F*j + q] from the source rows i + d0(p) and
//   i + d0(p) + 1 and the columns j + d0(q) and j + d0(q) + 1, each clamped
//   into the plane, where d0(p) = floor((2p + 1 - F) / 2F) is -1 or 0.
//   f32 mode (the depth plane): exactly the plain phase decomposition
//   (ops/resize.py _upsample_axis_int) in its order, rows first and then
//   columns, each as (1 - w1) * a + w1 * b with the per-phase f32 weights the
//   host computed in double and rounded; a phase with w1 == 0 copies a.
//   __fmul_rn/__fadd_rn keep nvcc from contracting into FMAs, so the kernel
//   equals its plain version bit for bit.
//   u8 mode (RGB, the warp's input quantization fused in): the exact rational
//   result floor(sum_rows sum_cols wr * wc * x / (2F)^2) with the integer band
//   weights (2F - k, k), k = (2p + 1 - F) mod 2F, in int32 (rows blended
//   first, the same integer); clamped edge taps hit one source and their
//   weights add. The TPU kernel computes the same value exactly, so kernel,
//   plain version and the JAX kernel agree bit for bit. Input values must be
//   integers in [0, 255].
// Bound on the H100: memory, and the stores in particular. At 1080p,
//   super_sampling 3, batch 2 the RGB pass writes 118 MB of u8 and the depth
//   pass 158 MB of f32 against 53 MB and 18 MB read (~0.05 ms each at
//   3.35 TB/s); ~6 operations an output are ~0.02 ms of issue.
// Design: F is a template parameter (2..8), so the phase loops unroll, the
//   taps and integer weights are constants and the division by (2F)^2 is a
//   multiply and a shift. A warp owns 128 source columns (a lane takes
//   columns lane, lane + 32, lane + 64, lane + 96: coalesced loads) and a
//   strip of two source rows, and holds the four source rows they draw from
//   in registers, so each source element is loaded once a warp; the left
//   and right neighbours come from the next lanes by __shfl. Each output
//   row's F * 128 values go to the warp's own stage in shared memory,
//   placed at the output's offset modulo 16 bytes, and leave it as aligned
//   16-byte stores, with the two ends (less than a vector each) stored an
//   element a lane: output rows of 6090 u8 or f32 (1080p) do not start on
//   16-byte boundaries, so the lanes cannot store their own values as
//   vectors (scripts/probe_kernels.py: storing them one by one takes ~1.2x
//   the time in u8 and ~1.5x in f32).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kV = 4;                // source columns a lane, 32 apart
constexpr int kChunk = 32 * kV;      // source columns a warp
constexpr int kStrip = 2;            // source rows a warp
constexpr int kMaxF = 8;

struct Weights {
  float wa[kMaxF];  // f32 (1 - w1) of phase p
  float wb[kMaxF];  // f32 w1 of phase p
};

// phase p's first tap lies one row (column) up: d0(p) = -1
template <int F>
__device__ constexpr bool tap_up(int p) { return 2 * p + 1 - F < 0; }

// the integer weight of phase p's second tap, k = (2p + 1 - F) mod 2F
template <int F>
__device__ constexpr int k_of(int p) {
  return tap_up<F>(p) ? 2 * p + 1 + F : 2 * p + 1 - F;
}

template <bool U8> struct Types;
template <> struct Types<true> { using Acc = int; using Out = uint8_t; };
template <> struct Types<false> { using Acc = float; using Out = float; };

// blend of phase p between a (first tap) and b (second tap)
template <int F, bool U8>
__device__ __forceinline__ typename Types<U8>::Acc blend(
    typename Types<U8>::Acc a, typename Types<U8>::Acc b, int p,
    const Weights& w) {
  if constexpr (U8) {
    return (2 * F - k_of<F>(p)) * a + k_of<F>(p) * b;
  } else {
    if (k_of<F>(p) == 0) return a;
    return __fadd_rn(__fmul_rn(w.wa[p], a), __fmul_rn(w.wb[p], b));
  }
}

template <bool U8>
__device__ __forceinline__ typename Types<U8>::Acc load_src(const float* p) {
  if constexpr (U8) return __float2int_rz(__ldg(p));
  else return __ldg(p);
}

// one source row around the lane's columns: centre, left and right
template <typename A>
struct Row {
  A c[kV], l[kV], r[kV];
};

template <bool U8>
__device__ __forceinline__ void load_row(const float* __restrict__ row,
                                         const int (&col)[kV], int ecol,
                                         int lane,
                                         Row<typename Types<U8>::Acc>& out) {
  using A = typename Types<U8>::Acc;
  A up[kV], dn[kV];
#pragma unroll
  for (int v = 0; v < kV; ++v) out.c[v] = load_src<U8>(row + col[v]);
  // lane 0's column left of the chunk, the other lanes' right of it
  const A e = load_src<U8>(row + ecol);
#pragma unroll
  for (int v = 0; v < kV; ++v) {
    up[v] = __shfl_sync(0xffffffffu, out.c[v], (lane + 31) & 31);
    dn[v] = __shfl_sync(0xffffffffu, out.c[v], (lane + 1) & 31);
  }
#pragma unroll
  for (int v = 0; v < kV; ++v) {
    out.l[v] = lane != 0 ? up[v] : (v > 0 ? up[v - 1] : e);
    out.r[v] = lane != 31 ? dn[v] : (v + 1 < kV ? dn[v + 1] : e);
  }
}

template <int F, bool U8>
__global__ void upsample_kernel(const float* __restrict__ x, void* __restrict__ out,
                Weights w, int H, int W) {
  using A = typename Types<U8>::Acc;
  using T = typename Types<U8>::Out;
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kStage = F * kChunk + kVec;
  __shared__ __align__(16) T stage_all[kWarps][kStage];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = blockIdx.x * kChunk;
  const int i0 = (blockIdx.y * kWarps + warp) * kStrip;
  const int n = blockIdx.z;
  if (i0 >= H) return;          // the warp's strip lies below the plane
  T* stage = stage_all[warp];
  const int OW = F * W;
  const int len = F * min(kChunk, W - c0);   // outputs of a warp row
  const float* src = x + (size_t)n * H * W;
  T* dst = static_cast<T*>(out);

  int col[kV];
#pragma unroll
  for (int v = 0; v < kV; ++v) col[v] = min(c0 + lane + 32 * v, W - 1);
  const int ecol = lane == 0 ? max(c0 - 1, 0) : min(c0 + kChunk, W - 1);

  Row<A> rows[kStrip + 2];      // source rows i0 - 1 .. i0 + kStrip
#pragma unroll
  for (int s = 0; s < kStrip + 2; ++s) {
    const int i = min(max(i0 - 1 + s, 0), H - 1);
    load_row<U8>(src + (size_t)i * W, col, ecol, lane, rows[s]);
  }

#pragma unroll
  for (int s = 0; s < kStrip; ++s) {
    const int i = i0 + s;
    if (i >= H) break;
#pragma unroll
    for (int p = 0; p < F; ++p) {
      // rows i - 1, i (first tap up) or i, i + 1, blended at three columns
      const Row<A>& a = rows[tap_up<F>(p) ? s : s + 1];
      const Row<A>& b = rows[tap_up<F>(p) ? s + 1 : s + 2];
      A tc[kV], tl[kV], tr[kV];
#pragma unroll
      for (int v = 0; v < kV; ++v) {
        tc[v] = blend<F, U8>(a.c[v], b.c[v], p, w);
        tl[v] = blend<F, U8>(a.l[v], b.l[v], p, w);
        tr[v] = blend<F, U8>(a.r[v], b.r[v], p, w);
      }
      const size_t g0 = ((size_t)n * H * F + (size_t)i * F + p) * OW
                        + (size_t)F * c0;
      const int shift = (int)(g0 % kVec);
#pragma unroll
      for (int v = 0; v < kV; ++v) {
#pragma unroll
        for (int q = 0; q < F; ++q) {
          const A lo = tap_up<F>(q) ? tl[v] : tc[v];
          const A hi = tap_up<F>(q) ? tc[v] : tr[v];
          const A r = blend<F, U8>(lo, hi, q, w);
          T o;
          if constexpr (U8)
            o = (uint8_t)((unsigned)r / (unsigned)(4 * F * F));
          else
            o = r;
          stage[shift + F * (lane + 32 * v) + q] = o;
        }
      }
      __syncwarp();
      // the stage's 16-byte vectors sit on the output's 16-byte grid:
      // [v0, v1) in whole vectors, the ends [shift, v0) and [v1, end) (each
      // less than a vector) an element a lane
      T* base = dst + (g0 - shift);
      const int end = shift + len;
      int v0 = shift ? kVec : 0, v1 = end / kVec * kVec;
      if (v0 > v1) v0 = v1 = end;       // no whole vector: all of it an end
      for (int k = v0 + lane * kVec; k < v1; k += 32 * kVec)
        *reinterpret_cast<uint4*>(base + k) =
            *reinterpret_cast<const uint4*>(stage + k);
      const int e = lane < 16 ? shift + lane : v1 + lane - 16;
      if (e < (lane < 16 ? v0 : end)) base[e] = stage[e];
      __syncwarp();
    }
  }
}

template <int F>
int launch(const float* x, void* out, const Weights& w, int N, int H, int W,
           int quantize_u8, cudaStream_t s) {
  const int rows = kWarps * kStrip;
  dim3 grid((W + kChunk - 1) / kChunk, (H + rows - 1) / rows, N);
  if (quantize_u8)
    upsample_kernel<F, true><<<grid, kThreads, 0, s>>>(x, out, w, H, W);
  else
    upsample_kernel<F, false><<<grid, kThreads, 0, s>>>(x, out, w, H, W);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vsc_upsample(const float* x, void* out, const float* wa,
                            const float* wb, int N, int H, int W, int f,
                            int quantize_u8, void* stream) {
  // the output's 16-byte grid is its element offsets from a 16-byte
  // aligned base
  if (f < 2 || f > kMaxF || N < 1 || H < 1 || W < 1 || N > 65535
      || (H + kWarps * kStrip - 1) / (kWarps * kStrip) > 65535
      || ((uintptr_t)out & 15) != 0)
    return (int)cudaErrorInvalidValue;
  Weights w = {};
  for (int p = 0; p < f; ++p) {
    w.wa[p] = wa[p];
    w.wb[p] = wb[p];
  }
  cudaStream_t s = (cudaStream_t)stream;
  switch (f) {
#define VSC_F(F) \
    case F: return launch<F>(x, out, w, N, H, W, quantize_u8, s);
    VSC_F(2) VSC_F(3) VSC_F(4) VSC_F(5) VSC_F(6) VSC_F(7) VSC_F(8)
#undef VSC_F
    default: return (int)cudaErrorInvalidValue;
  }
}
