// Short-sequence attention read straight from the fused qkv projection.
//
// Replaces: vsc_tpu/ops/attention_pallas.py  _qkv_kernel via
//   qkv_short_seq_attention (reached from vsc_tpu/models/vit.py Attention).
// Computes: per (sample, head), full-row softmax attention: f32 logits
//   = (q . k) * scale, minus the row max over the T real keys, p = exp, row
//   sum in f32, p cast to bf16 before the PV product, f32 accumulation,
//   out = acc / sum cast to bf16. q, k and v are read out of the
//   [N, T, 3D] projection ([q | k | v] along the last axis, head h at
//   columns h*64 of each part) through strides; the output is [N, T, D].
// Bound on the H100: at DepthPro's shapes (T = 577, 16 heads, Dh = 64) the
//   two products are ~85 MFLOP per (sample, head) against ~0.3 MB of q/k/v,
//   so on the tensor cores it is bound by the per-element softmax work
//   (scale, max, exp, sum, bf16 cast) that runs on the CUDA cores; the
//   [T, T] logits never reach device memory.
// Design: one block of four warps per (64 queries, head, sample). The
//   exact semantics (p rounded to bf16 at the FINAL row max) rule out an
//   online softmax, so the block makes two passes over 64-key chunks of
//   K (staged in shared memory, ragged chunk zero-filled and masked): pass 1
//   takes the row max, pass 2 recomputes the logits, forms p and the row
//   sum, and runs PV. Both products use the bf16 tensor cores through WMMA
//   16x16x16 fragments with f32 accumulators. Each warp walks its 16 rows
//   with the 32 lanes across the columns (conflict-free shared-memory
//   reads, per-row max and sum kept in registers, one shuffle reduction per
//   row at the end of a pass); shared rows are padded so fragment loads do
//   not conflict. ~44 KB of static shared memory, so no opt-in above 48 KB
//   is needed. wgmma/TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int kDh = 64;          // head dim
constexpr int kWarps = 4;
constexpr int kQ = 16 * kWarps;  // queries per block
constexpr int kK = 64;           // keys per chunk
constexpr int kThreads = 32 * kWarps;
constexpr int kLd = kDh + 8;     // padded bf16 row of K, V, P / Q staging
constexpr int kSld = kK + 4;     // padded f32 row of S

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> FragBt;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// copy a [64 rows x 64] bf16 slice (rows t0.., column offset col) into
// shared memory with row stride kLd, zero rows >= T
__device__ __forceinline__ void load_chunk(const __nv_bfloat16* base, int T,
                                           int D3, int t0, int col,
                                           __nv_bfloat16* dst) {
  for (int i = threadIdx.x; i < kK * kDh / 8; i += kThreads) {
    const int r = i / (kDh / 8), c8 = i % (kDh / 8);
    const int t = t0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (t < T)
      v = *reinterpret_cast<const uint4*>(base + (size_t)t * D3 + col + c8 * 8);
    *reinterpret_cast<uint4*>(dst + r * kLd + c8 * 8) = v;
  }
}

// S[16 x 64] = Q[16 x 64] . Kchunk^T for this warp
__device__ __forceinline__ void logits_tile(const FragA* qf,
                                            const __nv_bfloat16* Ks,
                                            float* S) {
#pragma unroll
  for (int j = 0; j < kK / 16; ++j) {
    FragC sf;
    wmma::fill_fragment(sf, 0.0f);
#pragma unroll
    for (int kk = 0; kk < kDh / 16; ++kk) {
      FragBt kf;
      wmma::load_matrix_sync(kf, Ks + (j * 16) * kLd + kk * 16, kLd);
      wmma::mma_sync(sf, qf[kk], kf, sf);
    }
    wmma::store_matrix_sync(S + j * 16, sf, kSld, wmma::mem_row_major);
  }
}

__global__ void __launch_bounds__(kThreads)
qkv_attention_kernel(const __nv_bfloat16* __restrict__ qkv,
                     __nv_bfloat16* __restrict__ out, int T, int heads,
                     float scale) {
  __shared__ __align__(128) __nv_bfloat16 Ks[kK * kLd];
  __shared__ __align__(128) __nv_bfloat16 Vs[kK * kLd];
  __shared__ __align__(128) float Ss[kWarps][16 * kSld];
  __shared__ __align__(128) __nv_bfloat16 Ps[kWarps][16 * kLd];

  const int D = heads * kDh, D3 = 3 * D;
  const int q0 = blockIdx.x * kQ;
  const int h = blockIdx.y;
  const int n = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const __nv_bfloat16* base = qkv + (size_t)n * T * D3;
  float* S = Ss[warp];
  __nv_bfloat16* P = Ps[warp];

  // this warp's 16 query rows -> A fragments (staged through P)
  for (int i = lane; i < 16 * kDh / 8; i += 32) {
    const int r = i / (kDh / 8), c8 = i % (kDh / 8);
    const int t = q0 + warp * 16 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (t < T)
      v = *reinterpret_cast<const uint4*>(base + (size_t)t * D3 + h * kDh +
                                          c8 * 8);
    *reinterpret_cast<uint4*>(P + r * kLd + c8 * 8) = v;
  }
  __syncwarp();
  FragA qf[kDh / 16];
#pragma unroll
  for (int kk = 0; kk < kDh / 16; ++kk)
    wmma::load_matrix_sync(qf[kk], P + kk * 16, kLd);

  // pass 1: row max of the scaled logits over the real keys
  float m[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) m[r] = -INFINITY;
  for (int k0 = 0; k0 < T; k0 += kK) {
    __syncthreads();
    load_chunk(base, T, D3, k0, D + h * kDh, Ks);
    __syncthreads();
    logits_tile(qf, Ks, S);
    __syncwarp();
    const bool ok0 = k0 + lane < T, ok1 = k0 + lane + 32 < T;
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      if (ok0) m[r] = fmaxf(m[r], __fmul_rn(S[r * kSld + lane], scale));
      if (ok1) m[r] = fmaxf(m[r], __fmul_rn(S[r * kSld + lane + 32], scale));
    }
    __syncwarp();
  }
#pragma unroll
  for (int r = 0; r < 16; ++r)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], o));

  // pass 2: p = exp(l - m) (row sum in f32, p -> bf16), O += P . V
  float l[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) l[r] = 0.0f;
  FragC of[kDh / 16];
#pragma unroll
  for (int j = 0; j < kDh / 16; ++j) wmma::fill_fragment(of[j], 0.0f);
  for (int k0 = 0; k0 < T; k0 += kK) {
    __syncthreads();
    load_chunk(base, T, D3, k0, D + h * kDh, Ks);
    load_chunk(base, T, D3, k0, 2 * D + h * kDh, Vs);
    __syncthreads();
    logits_tile(qf, Ks, S);
    __syncwarp();
    const bool ok0 = k0 + lane < T, ok1 = k0 + lane + 32 < T;
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      float p0 = 0.0f, p1 = 0.0f;
      if (ok0) {
        p0 = expf(__fsub_rn(__fmul_rn(S[r * kSld + lane], scale), m[r]));
        l[r] = __fadd_rn(l[r], p0);
      }
      if (ok1) {
        p1 = expf(__fsub_rn(__fmul_rn(S[r * kSld + lane + 32], scale), m[r]));
        l[r] = __fadd_rn(l[r], p1);
      }
      P[r * kLd + lane] = __float2bfloat16(p0);
      P[r * kLd + lane + 32] = __float2bfloat16(p1);
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < kK / 16; ++kk) {
      FragA pf;
      wmma::load_matrix_sync(pf, P + kk * 16, kLd);
#pragma unroll
      for (int j = 0; j < kDh / 16; ++j) {
        FragB vf;
        wmma::load_matrix_sync(vf, Vs + (kk * 16) * kLd + j * 16, kLd);
        wmma::mma_sync(of[j], pf, vf, of[j]);
      }
    }
    __syncwarp();
  }
#pragma unroll
  for (int r = 0; r < 16; ++r)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      l[r] = __fadd_rn(l[r], __shfl_xor_sync(0xffffffffu, l[r], o));

#pragma unroll
  for (int j = 0; j < kDh / 16; ++j)
    wmma::store_matrix_sync(S + j * 16, of[j], kSld, wmma::mem_row_major);
  __syncwarp();
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int t = q0 + warp * 16 + r;
    if (t < T) {
      __nv_bfloat16* orow = out + ((size_t)n * T + t) * D + h * kDh;
      orow[lane] = __float2bfloat16(__fdiv_rn(S[r * kSld + lane], l[r]));
      orow[lane + 32] =
          __float2bfloat16(__fdiv_rn(S[r * kSld + lane + 32], l[r]));
    }
  }
}

}  // namespace

extern "C" int vsc_qkv_attention(const void* qkv, void* out, int N, int T,
                                 int heads, float scale, void* stream) {
  if (N < 1 || N > 65535 || T < 1 || heads < 1 || heads > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((T + kQ - 1) / kQ, heads, N);
  qkv_attention_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)qkv, (__nv_bfloat16*)out, T, heads, scale);
  return (int)cudaGetLastError();
}
