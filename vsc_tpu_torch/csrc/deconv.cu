// ConvTranspose 2x2 / stride 2 / no padding.
//
// Replaces: vsc_tpu/ops/deconv_pallas.py  _kernel via deconv2x2_pallas
//   (reached from vsc_tpu/models/depthpro.py ConvT2x2 under
//   VSC_TPU_PALLAS_DECONV=1).
// Computes: out[n, o, 2i+a, 2j+b] = bias[o] + sum_c x[n, c, i, j] w[c, o, a, b]
//   on NCHW x [N, C, H, W] with torch's weight [C, O, 2, 2], accumulated in
//   f32, the bias added in f32, one rounding to the input dtype (f32 or
//   bf16). Each output pixel depends on one input pixel, so per sample the
//   op is one product Y[p, q] = sum_c X[c, p] Wf[c, q] with p = i*W + j
//   (P = H*W pixels) and q = o*4 + a*2 + b (the weight's own memory order,
//   Wf = w viewed as [C, 4*O]), and the epilogue writes Y straight into the
//   interleaved output: the TPU kernel's four phase products and its
//   in-VMEM interleave in one pass.
// Bound on the H100: 2*P*C*4*O operations against (C*P + C*4*O + 4*O*P)
//   elements; at DepthPro's sites (C, O in 128..1024) hundreds of
//   operations per byte, so it is bound by the arithmetic: the bf16 tensor
//   cores for bf16, the f32 CUDA cores for f32.
// Design: a plain register-tiled product on the CUDA cores for both dtypes
//   (tensor cores are later work): 128 pixels x 128 columns of Wf per block
//   of 256 threads, 8-deep slices of C staged in shared memory as f32, an
//   8 x 8 micro-tile per thread with the pixel index on the fast thread
//   axis, so a warp stores both b phases of 16 neighbouring pixels as one
//   contiguous run of the output row. No library call computes the body.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;   // pixels per block
constexpr int kBN = 128;   // columns of Wf per block
constexpr int kBK = 8;     // input channels per slice
constexpr int kThreads = 256;

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&t.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&t.y);
  v[0] = __low2float(lo); v[1] = __high2float(lo);
  v[2] = __low2float(hi); v[3] = __high2float(hi);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
deconv2x2_kernel(const T* __restrict__ x, const T* __restrict__ w,
                 const T* __restrict__ bias, T* __restrict__ out, int C,
                 int H, int W, int O) {
  __shared__ __align__(16) float As[kBK][kBM];
  __shared__ __align__(16) float Bs[kBK][kBN];
  const int P = H * W, N4 = 4 * O;
  const int p0 = blockIdx.x * kBM, q0 = blockIdx.y * kBN;
  const int n = blockIdx.z;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int lk = tid / 32, lc = (tid % 32) * 4;   // this thread's loads
  const T* xn = x + (size_t)n * C * P;
  const bool a_ok = p0 + lc < P;                   // P % 4 == 0

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < C; k0 += kBK) {
    float av[4] = {0.0f, 0.0f, 0.0f, 0.0f}, bv[4];
    if (a_ok) load4(xn + (size_t)(k0 + lk) * P + p0 + lc, av);
    load4(w + (size_t)(k0 + lk) * N4 + q0 + lc, bv);
    __syncthreads();
    *reinterpret_cast<float4*>(&As[lk][lc]) =
        make_float4(av[0], av[1], av[2], av[3]);
    *reinterpret_cast<float4*>(&Bs[lk][lc]) =
        make_float4(bv[0], bv[1], bv[2], bv[3]);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      float a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = As[k][tx + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = Bs[k][ty + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

  const size_t W2 = 2 * (size_t)W, plane = 4 * (size_t)P;
  T* on = out + (size_t)n * O * plane;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int p = p0 + tx + 16 * i;
    if (p >= P) continue;
    const int yi = p / W, xi = p % W;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int q = q0 + ty + 16 * j;
      const int o = q >> 2, a = (q >> 1) & 1, b = q & 1;
      float v = acc[i][j];
      if (bias != nullptr) v += to_f32(bias[o]);
      store(on + o * plane + (2 * yi + a) * W2 + 2 * xi + b, v);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* bias, void* out, int N,
           int C, int H, int W, int O, cudaStream_t s) {
  dim3 grid((H * W + kBM - 1) / kBM, 4 * O / kBN, N);
  deconv2x2_kernel<T><<<grid, kThreads, 0, s>>>(
      (const T*)x, (const T*)w, (const T*)bias, (T*)out, C, H, W, O);
  return (int)cudaGetLastError();
}

}  // namespace

// bias may be null; bf16 selects __nv_bfloat16 for x, w, bias and out
// (else float32).
extern "C" int vsc_deconv2x2(const void* x, const void* w, const void* bias,
                             void* out, int N, int C, int H, int W, int O,
                             int bf16, void* stream) {
  if (N < 1 || N > 65535 || C < kBK || C % kBK || O < 1 || (4 * O) % kBN ||
      H < 1 || W < 1 || (H * W) % 4 || 4 * O / kBN > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? launch<__nv_bfloat16>(x, w, bias, out, N, C, H, W, O, s)
              : launch<float>(x, w, bias, out, N, C, H, W, O, s);
}
