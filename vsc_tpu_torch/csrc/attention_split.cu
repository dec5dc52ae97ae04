// Short-sequence attention on separate q, k, v.
//
// Replaces: vsc_tpu/ops/attention_pallas.py  _kernel via short_seq_attention
//   (reached from vsc_tpu/models/vit.py Attention for head layouts the qkv
//   kernel cannot take; the port sends every dtype and head dim other than
//   its qkv kernel's bf16 / 64 here).
// Computes: per (sample, head), full-row softmax attention with the qkv
//   kernel's semantics: f32 logits (q . k) * scale, minus the row max over
//   the T real keys, p = exp, row sum in f32, p rounded to the input dtype
//   before the PV product, f32 accumulation, out = acc / sum in the input
//   dtype. q, k and v are [B, T, H, Dh] views with a unit last stride and
//   shared batch / token / head strides (strided views of the fused qkv
//   projection, no copies); the output is a contiguous [B, T, H, Dh].
//   float32 or bf16; Dh = 16, 32, ..., 128.
// Bound on the H100: 4*T*T*Dh operations per (sample, head) against
//   4*T*Dh elements; in f32 (no tensor cores: full fp32, no TF32) bound by
//   the CUDA cores' 67 TFLOP/s, and by the same exp/max work per logit as
//   the qkv kernel. The [T, T] logits never reach device memory.
// Design: one block of 256 threads per (64 queries, head, sample); q, k
//   and v staged in shared memory as f32 (dynamic, above 48 KB at large
//   Dh). The exact semantics (p rounded at the FINAL row max) rule out an
//   online softmax, so the block makes two passes over 64-key chunks of K:
//   pass 1 takes the row max, pass 2 recomputes the logits, forms p and the
//   row sum and accumulates PV. Plain FMAs on the CUDA cores for both
//   dtypes, each thread a 4 x 4 tile of the logits (rows ty + 16i, keys
//   tx + 16j) and a 4 x Dh/16 tile of the output; the ragged last chunk is
//   zero-filled and masked. Tensor cores (bf16) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kQ = 64;        // queries per block
constexpr int kK = 64;        // keys per chunk
constexpr int kThreads = 256; // 16 x 16

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
// p as the PV product sees it: rounded to the input dtype
__device__ __forceinline__ float round_to(float v, float) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(v));
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

struct Strides {
  long long b, t, h;   // elements
};

// rows t0 .. t0 + 63 of one head's [T, Dh] slice -> dst (row stride ld),
// zero beyond T
template <typename T, int DH>
__device__ __forceinline__ void stage(const T* __restrict__ src, Strides s,
                                      int Tn, int t0, float* dst, int ld) {
  for (int i = threadIdx.x; i < kK * DH; i += kThreads) {
    const int r = i / DH, d = i % DH;
    const int t = t0 + r;
    dst[r * ld + d] = t < Tn ? to_f32(src[(long long)t * s.t + d]) : 0.0f;
  }
}

// this thread's 4 x 4 logits tile: rows ty + 16i of Qs, keys tx + 16j of Ks
template <int DH>
__device__ __forceinline__ void logits(const float* Qs, const float* Ks,
                                       int tx, int ty, float s[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
  for (int d = 0; d < DH; ++d) {
    float q[4], k[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) q[i] = Qs[(ty + 16 * i) * (DH + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) k[j] = Ks[(tx + 16 * j) * (DH + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(q[i], k[j], s[i][j]);
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
split_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int Tn,
                       int heads, Strides st, float scale) {
  constexpr int kE = DH / 16;        // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                              // [kQ][DH + 1]
  float* Ks = Qs + kQ * (DH + 1);                // [kK][DH + 1]
  float* Vs = Ks + kK * (DH + 1);                // [kK][DH]
  float* Ps = Vs + kK * DH;                      // [kQ][kK + 1]

  const int q0 = blockIdx.x * kQ, h = blockIdx.y, n = blockIdx.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long off = (long long)n * st.b + (long long)h * st.h;
  const T* qb = q + off;
  const T* kb = k + off;
  const T* vb = v + off;

  stage<T, DH>(qb, st, Tn, q0, Qs, DH + 1);

  // pass 1: row max of the scaled logits over the real keys
  float m[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  for (int k0 = 0; k0 < Tn; k0 += kK) {
    __syncthreads();
    stage<T, DH>(kb, st, Tn, k0, Ks, DH + 1);
    __syncthreads();
    float s[4][4];
    logits<DH>(Qs, Ks, tx, ty, s);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (k0 + tx + 16 * j < Tn)
#pragma unroll
        for (int i = 0; i < 4; ++i) m[i] = fmaxf(m[i], __fmul_rn(s[i][j], scale));
  }
  // the 16 lanes of one ty hold one row's partial maxima
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int o = 8; o > 0; o >>= 1)
      m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], o));

  // pass 2: p = exp(l - m) (row sum in f32, p rounded to T), O += P . V
  float l[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float acc[4][kE];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[i][e] = 0.0f;
  for (int k0 = 0; k0 < Tn; k0 += kK) {
    __syncthreads();
    stage<T, DH>(kb, st, Tn, k0, Ks, DH + 1);
    stage<T, DH>(vb, st, Tn, k0, Vs, DH);
    __syncthreads();
    float s[4][4];
    logits<DH>(Qs, Ks, tx, ty, s);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool ok = k0 + tx + 16 * j < Tn;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float p = 0.0f;
        if (ok) {
          p = expf(__fsub_rn(__fmul_rn(s[i][j], scale), m[i]));
          l[i] = __fadd_rn(l[i], p);
        }
        Ps[(ty + 16 * i) * (kK + 1) + tx + 16 * j] = round_to(p, T());
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kK; ++kk) {
      float p[4], vv[kE];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * (kK + 1) + kk];
#pragma unroll
      for (int e = 0; e < kE; ++e) vv[e] = Vs[kk * DH + tx + 16 * e];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < kE; ++e) acc[i][e] = fmaf(p[i], vv[e], acc[i][e]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int o = 8; o > 0; o >>= 1)
      l[i] = __fadd_rn(l[i], __shfl_xor_sync(0xffffffffu, l[i], o));

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= Tn) continue;
    T* orow = out + (((long long)n * Tn + t) * heads + h) * DH;
#pragma unroll
    for (int e = 0; e < kE; ++e)
      store(orow + tx + 16 * e, __fdiv_rn(acc[i][e], l[i]));
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Tn, int heads, Strides st, float scale, cudaStream_t s) {
  const int smem =
      (int)sizeof(float) * (kQ * (DH + 1) + kK * (DH + 1) + kK * DH +
                            kQ * (kK + 1));
  static bool opted_in = false;   // one attribute call per instantiation
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        split_attention_kernel<T, DH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  dim3 grid((Tn + kQ - 1) / kQ, heads, B);
  split_attention_kernel<T, DH><<<grid, kThreads, smem, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, Tn, heads, st, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B,
             int Tn, int heads, int dh, Strides st, float scale,
             cudaStream_t s) {
  switch (dh) {
#define VSC_DH(D) \
    case D: return launch<T, D>(q, k, v, out, B, Tn, heads, st, scale, s);
    VSC_DH(16) VSC_DH(32) VSC_DH(48) VSC_DH(64)
    VSC_DH(80) VSC_DH(96) VSC_DH(112) VSC_DH(128)
#undef VSC_DH
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// strides in elements, shared by q, k and v; bf16 selects __nv_bfloat16
// (else float32) for q, k, v and out
extern "C" int vsc_split_attention(const void* q, const void* k,
                                   const void* v, void* out, int B, int Tn,
                                   int heads, int dh, long long sb,
                                   long long st, long long sh, float scale,
                                   int bf16, void* stream) {
  if (B < 1 || B > 65535 || Tn < 1 || heads < 1 || heads > 65535)
    return (int)cudaErrorInvalidValue;
  const Strides s = {sb, st, sh};
  cudaStream_t cs = (cudaStream_t)stream;
  return bf16 ? dispatch<__nv_bfloat16>(q, k, v, out, B, Tn, heads, dh, s,
                                        scale, cs)
              : dispatch<float>(q, k, v, out, B, Tn, heads, dh, s, scale,
                                cs);
}
