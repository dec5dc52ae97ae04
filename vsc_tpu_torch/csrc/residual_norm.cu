// Residual add + LayerScale + LayerNorm between the ViT's sublayers.
//
// Replaces: no Pallas site. The JAX package leaves this step to XLA, which
//   fuses the LayerNorm into its neighbours (vsc_tpu/models/vit.py:291-297);
//   the port ran it as separate ATen kernels (a LayerScale multiply, a
//   residual add, then the next sublayer's LayerNorm), each a full pass
//   over the [N, T, D] stream.
// Computes, per row of D (ops/residual_norm_cuda.py, residual_norm_plain):
//     x_new = x + gamma * y                rounded once to the dtype
//     h     = LayerNorm(x_new) * w + b     on the stored (rounded) x_new
//   in f32: the product and the sum rounded as two IEEE operations (no FMA
//   contraction, so x_new equals torch's x + y * gamma bit for bit), the
//   mean first, then the biased variance of the deviations, rstd =
//   rsqrt(var + eps), h rounded once. x, y, x_new, h of one dtype (bf16 or
//   f32), D a multiple of 8 up to 4096, every pointer 16-byte aligned.
// Bound on the H100: bytes. Read x and y, write x_new and h: 8 bytes per
//   bf16 element (16 in f32) against ~10 f32 operations, with no reuse. The
//   main path's patch pass, [280, 577, 1024] bf16, moves 1.32 GB a launch:
//   0.395 ms at 3.35 TB/s. The three ATen kernels it replaces move 7 bytes
//   of stream for every 4 this one moves.
// Design: one warp per row, registers only. A row of 1024 bf16 is 2 KB: each
//   lane holds K 16-byte vectors of it (32 values at D = 1024 in bf16),
//   neighbouring lanes on neighbouring addresses, so every load and store is
//   a whole 512-byte line per warp instruction. Up to K = 8 every load of
//   a lane (its K vectors of x and of y) is issued before any arithmetic, so
//   a warp has a whole row of both (4 KB at D = 1024 in bf16) in flight;
//   the mean and the variance are warp-shuffle sums, so no
//   shared memory and no barrier. x_new is kept packed in the dtype (it is
//   the value the LayerNorm takes), which halves its registers in bf16.
//   gamma, w and b (at most 24 KB together) are read through the read-only
//   path and stay in L1 / L2. 8 warps (8 rows) a block: 20,772 blocks for a
//   1080p batch's patch pass, 577 for its image pass, enough to fill 132 SMs.
//   K is a template parameter (1 to 32), so the loops unroll and the vectors
//   stay in registers; lanes past the row's end are masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;           // rows per block
constexpr int kMaxD = 4096;

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;       // elements in 16 bytes
  __device__ __forceinline__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  // bf16 -> f32 is exact: the bf16 bits are the f32's upper half
  __device__ __forceinline__ static void unpack(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      f[2 * j] = __uint_as_float(w[j] << 16);
      f[2 * j + 1] = __uint_as_float(w[j] & 0xFFFF0000u);
    }
  }
  // round to nearest even, as torch's .to(torch.bfloat16)
  __device__ __forceinline__ static uint4 pack(const float* f) {
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
      w[j] = *reinterpret_cast<const uint32_t*>(&h);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int K>
__global__ void __launch_bounds__(kWarps * 32)
vit_residual_norm_kernel(const T* __restrict__ x, const T* __restrict__ y,
                         const T* __restrict__ gamma,
                         const T* __restrict__ weight,
                         const T* __restrict__ bias, T* __restrict__ x_out,
                         T* __restrict__ h_out, long long rows, int D,
                         float eps) {
  using V = Vec<T>;
  constexpr int N = V::N;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const int nvec = D / N;
  const long long off = row * nvec;           // in 16-byte vectors
  const uint4* xr = reinterpret_cast<const uint4*>(x) + off;
  const uint4* yr = reinterpret_cast<const uint4*>(y) + off;
  uint4* xo = reinterpret_cast<uint4*>(x_out) + off;
  uint4* ho = reinterpret_cast<uint4*>(h_out) + off;
  const uint4* gv = reinterpret_cast<const uint4*>(gamma);
  const uint4* wv = reinterpret_cast<const uint4*>(weight);
  const uint4* bv = reinterpret_cast<const uint4*>(bias);

  // up to K = 8 (D = 2048 in bf16, 1024 in f32) every vector of x and y
  // is loaded before any arithmetic; past it y is read as it is used, so
  // the registers stay bounded
  constexpr bool kPreload = K <= 8;
  uint4 xs[K], ys[kPreload ? K : 1];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = lane + 32 * k;
    if (i < nvec) {
      xs[k] = __ldg(xr + i);
      if constexpr (kPreload) ys[k] = __ldg(yr + i);
    }
  }

  // x_new = x + gamma * y, rounded once; the sum of the rounded values
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = lane + 32 * k;
    if (i < nvec) {
      float a[N], b[N], g[N];
      V::unpack(xs[k], a);
      if constexpr (kPreload)
        V::unpack(ys[k], b);
      else
        V::unpack(__ldg(yr + i), b);
      V::unpack(__ldg(gv + i), g);
#pragma unroll
      for (int e = 0; e < N; ++e) a[e] = __fadd_rn(a[e], __fmul_rn(g[e], b[e]));
      xs[k] = V::pack(a);
      xo[i] = xs[k];
      V::unpack(xs[k], a);
#pragma unroll
      for (int e = 0; e < N; ++e) sum += a[e];
    }
  }
  const float mean = warp_sum(sum) / (float)D;

  float sq = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = lane + 32 * k;
    if (i < nvec) {
      float a[N];
      V::unpack(xs[k], a);
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const float d = a[e] - mean;
        sq += d * d;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / (float)D + eps);

#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = lane + 32 * k;
    if (i < nvec) {
      float a[N], w[N], b[N];
      V::unpack(xs[k], a);
      V::unpack(__ldg(wv + i), w);
      V::unpack(__ldg(bv + i), b);
#pragma unroll
      for (int e = 0; e < N; ++e) a[e] = (a[e] - mean) * rstd * w[e] + b[e];
      ho[i] = V::pack(a);
    }
  }
}

template <typename T, int K>
cudaError_t launch(const void* x, const void* y, const void* gamma,
                   const void* weight, const void* bias, void* x_out,
                   void* h_out, long long rows, int D, float eps,
                   cudaStream_t s) {
  const long long blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  vit_residual_norm_kernel<T, K><<<(unsigned)blocks, kWarps * 32, 0, s>>>(
      (const T*)x, (const T*)y, (const T*)gamma, (const T*)weight,
      (const T*)bias, (T*)x_out, (T*)h_out, rows, D, eps);
  return cudaGetLastError();
}

// the least K (a power of two) with 32 K vectors covering a row
template <typename T>
cudaError_t dispatch(const void* x, const void* y, const void* gamma,
                     const void* weight, const void* bias, void* x_out,
                     void* h_out, long long rows, int D, float eps,
                     cudaStream_t s) {
  const int nvec = D / Vec<T>::N;
  constexpr int kMaxK = kMaxD / (32 * Vec<T>::N);   // 16 bf16, 32 f32
#define VSC_RN_CASE(KK)                                                    \
  if constexpr (KK <= kMaxK)                                               \
    if (nvec <= 32 * KK)                                                   \
      return launch<T, KK>(x, y, gamma, weight, bias, x_out, h_out, rows, \
                           D, eps, s);
  VSC_RN_CASE(1)
  VSC_RN_CASE(2)
  VSC_RN_CASE(4)
  VSC_RN_CASE(8)
  VSC_RN_CASE(16)
  VSC_RN_CASE(32)
#undef VSC_RN_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int vsc_residual_norm(const void* x, const void* y,
                                 const void* gamma, const void* weight,
                                 const void* bias, void* x_out, void* h_out,
                                 long long rows, int D, float eps, int bf16,
                                 void* stream) {
  if (rows < 1 || D < 8 || D % 8 || D > kMaxD)
    return (int)cudaErrorInvalidValue;
  const void* ptrs[7] = {x, y, gamma, weight, bias, x_out, h_out};
  for (const void* p : ptrs)
    if ((uintptr_t)p % 16) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(bf16 ? dispatch<__nv_bfloat16>(x, y, gamma, weight, bias,
                                               x_out, h_out, rows, D, eps, s)
                    : dispatch<float>(x, y, gamma, weight, bias, x_out,
                                      h_out, rows, D, eps, s));
}
