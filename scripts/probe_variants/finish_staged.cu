// A variant of csrc/finish.cu for scripts/probe_kernels.py: each block
// stages its tile's input rows in shared memory, five rows at a time, with
// aligned 16-byte loads (byte loads at reflected columns in the blocks that
// cross a crop border), and each thread reads the R + 4 bytes of a row it
// needs from there as aligned words. The arithmetic after the loads is a
// copy of the kernel's finish_column, in the same order (the probe checks
// the output bit for bit against the plain version). Every thread of a
// block meets the barriers, so the entry refuses output widths that are
// not a multiple of the block's 64 columns (the defaults' 1920 is). Built
// by the probe with -I vsc_tpu_torch/csrc, for the kernel's helpers.

#define vsc_finish vsc_finish_unstaged
#include "finish.cu"
#undef vsc_finish

namespace {

// the kThreads * R + 4 bytes of an input row that a block's threads read,
// staged from the 16-byte granule that holds the first of them
template <int R>
struct StagedRows {
  static constexpr int kSpan = kThreads * R + 4;       // bytes a row
  static constexpr int kVecs = (kSpan + 14) / 16 + 1;  // granules at most
  static constexpr int kBytes = 16 * kVecs + 16;       // + the word past

  uint8_t (*stage)[kBytes];   // five rows, row i in slot i mod 5
  const uint8_t* src;         // the plane at its crop offset
  int c_first, crop_w, y0, H, Wf;
  bool border;                // the block's columns cross a crop border
  int off[5];                 // where each slot's row starts in it

  __device__ __forceinline__ StagedRows(uint8_t (*stage_)[kBytes],
                                        const uint8_t* src_, int crop_w_,
                                        int y0_, int H_, int Wf_)
      : stage(stage_), src(src_), c_first(blockIdx.x * kThreads * R - 2),
        crop_w(crop_w_), y0(y0_), H(H_), Wf(Wf_) {
    border = c_first < 0 || c_first + kSpan > crop_w;
  }

  // rows i .. i + 4 into the five slots
  __device__ __forceinline__ void stage_rows(int i) {
    __syncthreads();          // every thread has read the last five
    if (border) {
      for (int e = threadIdx.x; e < 5 * kSpan; e += kThreads) {
        const int r = e / kSpan, m = e - r * kSpan;
        stage[r][m] = __ldg(src + (size_t)reflect101(y0 + i + r, H) * Wf
                            + reflect101(c_first + m, crop_w));
      }
#pragma unroll
      for (int r = 0; r < 5; ++r) off[r] = 0;
    } else {
      for (int e = threadIdx.x; e < 5 * kVecs; e += kThreads) {
        const int r = e / kVecs, j = e - r * kVecs;
        const uintptr_t a = reinterpret_cast<uintptr_t>(
            src + (size_t)reflect101(y0 + i + r, H) * Wf + c_first);
        if (j <= (int)(((a + kSpan - 1) >> 4) - (a >> 4)))
          *reinterpret_cast<uint4*>(stage[r] + 16 * j) =
              __ldg(reinterpret_cast<const uint4*>(a & ~uintptr_t(15)) + j);
      }
#pragma unroll
      for (int r = 0; r < 5; ++r)
        off[r] = (int)(reinterpret_cast<uintptr_t>(
                     src + (size_t)reflect101(y0 + i + r, H) * Wf + c_first)
                 & 15);
    }
    __syncthreads();
  }

  template <int S>
  __device__ __forceinline__ void row(int i, float (&v)[R + 4]) {
    if constexpr (S == 0) stage_rows(i);   // i is a multiple of 5
    const int o = off[S] + threadIdx.x * R;
    const uint32_t* w = reinterpret_cast<const uint32_t*>(stage[S] + (o & ~3));
    Span<R + 4> sp;
    sp.o = o & 3;
#pragma unroll
    for (int k = 0; k <= Span<R + 4>::kA; ++k) sp.w[k] = w[k];
    span_floats(sp, v);
  }
};

template <int R, bool kU8>
__global__ void staged_kernel(const uint8_t* __restrict__ x,
                              void* __restrict__ out, Taps k, int N, int H,
                              int Wf, int crop_w, int off0, int off1,
                              int nsplit, float strength, int out_h,
                              int out_w) {
  __shared__ __align__(16) uint8_t stage[5][StagedRows<R>::kBytes];
  const int ox = blockIdx.x * kThreads + threadIdx.x;
  const int plane = blockIdx.z;
  const int n = plane % N;
  const int oy0 = blockIdx.y * kTileH;
  const int rows_out = min(kTileH, out_h - oy0);
  const uint8_t* src = x + (size_t)plane * H * Wf + (n < nsplit ? off0 : off1);
  const size_t o0 = ((size_t)plane * out_h + oy0) * out_w + ox;
  StagedRows<R> rows(stage, src, crop_w, oy0 * R - 2, H, Wf);

  // from here on finish_column's arithmetic, the loads replaced by rows
  float p0[5][R], p1[5][R], p2[5][R];
  float xr[5][R];
  float col[R];
#pragma unroll
  for (int j = 0; j < R; ++j) col[j] = -0.0f;
  int rb = 0, oy = 0;
  auto hpass = [&](auto S, int i) {
    constexpr int s = decltype(S)::value;
    float v[R + 4];
    rows.template row<s>(i, v);
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
  auto vpass = [&](auto S) {
    constexpr int s = decltype(S)::value;
#pragma unroll
    for (int j = 0; j < R; ++j) {
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
  hpass(S0(), 0);
  hpass(S1(), 1);
  hpass(S2(), 2);
  hpass(S3(), 3);
  const int groups = (rows_out * R + 4) / 5;
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

template <int R>
int launch_staged(const uint8_t* x, void* out, const Taps& k, int N, int H,
                  int Wf, int crop_w, int off0, int off1, int nsplit,
                  float strength, int out_h, int out_w, int out_u8,
                  cudaStream_t s) {
  dim3 grid(out_w / kThreads, (out_h + kTileH - 1) / kTileH, 3 * N);
  if (out_u8)
    staged_kernel<R, true><<<grid, kThreads, 0, s>>>(
        x, out, k, N, H, Wf, crop_w, off0, off1, nsplit, strength, out_h,
        out_w);
  else
    staged_kernel<R, false><<<grid, kThreads, 0, s>>>(
        x, out, k, N, H, Wf, crop_w, off0, off1, nsplit, strength, out_h,
        out_w);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vsc_finish(const uint8_t* x, void* out, const float* taps,
                          int N, int H, int Wf, int crop_w, int off0,
                          int off1, int nsplit, int ratio, float strength,
                          int out_h, int out_w, int out_u8, void* stream) {
  if (out_w % kThreads || ratio < 1 || ratio > kMaxRatio
      || taps[3] != taps[1] || taps[4] != taps[0])
    return (int)cudaErrorInvalidValue;
  Taps k;
  for (int t = 0; t < 3; ++t) k.t[t] = taps[t];
  cudaStream_t s = (cudaStream_t)stream;
  switch (ratio) {
#define VSC_R(R)                                                          \
    case R:                                                               \
      return launch_staged<R>(x, out, k, N, H, Wf, crop_w, off0, off1,    \
                              nsplit, strength, out_h, out_w, out_u8, s);
    VSC_R(1) VSC_R(2) VSC_R(3) VSC_R(4) VSC_R(5) VSC_R(6) VSC_R(7) VSC_R(8)
#undef VSC_R
    default: return (int)cudaErrorInvalidValue;
  }
}
