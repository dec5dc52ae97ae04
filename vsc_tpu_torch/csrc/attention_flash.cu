// Long-sequence attention in one pass, read straight from the fused qkv
// projection.
//
// Replaces: no Pallas site of its own. vsc_tpu/models/vit.py sends every
//   token count to its Pallas attention (attention_pallas.py), which keeps
//   a whole row of logits on chip; the port's qkv kernel does the same up
//   to 640 tokens (csrc/attention.cu). Past that, bf16 at head dim 64 (Depth
//   Anything V2's 2,443 tokens at 518 x 924) comes here; float32 and the
//   other head dims stay on the split kernel (csrc/attention_split.cu).
// Computes: per (sample, head), softmax attention with the online softmax:
//   the keys in tiles of 128; per tile f32 logits = (q . k) * scale, the
//   row max m updated to max(m, tile max), the running sum and output
//   scaled by exp(m_old - m_new), p = exp(s - m) summed in f32, p rounded
//   to bf16 for the PV product (f32 accumulation); out = acc / sum cast to
//   bf16. q, k and v are read out of the [N, T, 3D] projection ([q | k |
//   v] along the last axis, head h at columns h*64 of each part) through
//   strides; the output is [N, T, D]. p is rounded at the running max, not
//   the final one: the same function as the qkv kernel's within bf16's
//   rounding of p (ops/attention_cuda.flash_attention_plain repeats this
//   kernel's order).
// Bound on the H100: 4 T^2 Dh operations a (sample, head) on the tensor
//   cores against 8 T Dh bytes of q, k, v and out: at T = 2443 far above
//   the bf16 ridge (0.59 TFLOP a 1080p frame, 0.59 ms at 989 TFLOP/s).
//   Beside the products sit a select, a max, an FFMA, an ex2 and an add a
//   logit on the CUDA cores and the MUFU unit: at head dim 64 the ex2s
//   alone take about as long as the products (16 a clock an SM).
// Design: one block of three warpgroups (384 threads) per 192 query rows
//   of a (sample, head), each warpgroup its own 64 rows, sharing a ring of
//   three K / V tiles (128 keys each, 32 KB a stage) that every thread
//   fills with cp.async two tiles ahead, one barrier a tile. Per tile and
//   warpgroup: S = Q . K^T as four wgmma m64n128k16 (q and k from shared
//   memory, K-major), keys past T to -inf by selects, the row max over
//   the quad, p = ex2(s * scale*log2(e) - m * scale*log2(e)) packed to
//   bf16 straight from the S accumulator registers into the A operand of
//   PV (for bf16 the accumulator and A-fragment layouts match), then
//   O_tile = P . V as eight wgmma m64n64k16 (V from shared memory as an
//   MN-major B) into accumulators of their own, merged into the running
//   output with one FFMA an element: no ordinary instruction writes a
//   wgmma accumulator between products (that makes ptxas serialize the
//   wgmma, warning C7520). Q, K and V sit in the no-swizzle core-matrix
//   layout wgmma reads (8 rows x 16 bytes a core matrix): 24 KB of Q and
//   96 KB of ring, one block an SM (the registers bound it).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kDh = 64;                      // head dim
constexpr int kWG = 3;                       // warpgroups, 64 query rows each
constexpr int kThreads = 128 * kWG;
constexpr int kRows = 64;
constexpr int kBlockRows = kWG * kRows;      // 192
constexpr int kKeys = 128;                   // keys a tile
constexpr int kStages = 3;                   // K / V tiles in the ring

// Core-matrix layout of a [rows x 64] bf16 operand: row r, column group g
// (8 columns) at (r / 8) * 1024 + g * 128 + (r % 8) * 16 bytes.
constexpr uint32_t kGroupBytes = 8 * kDh * 2;
constexpr int kTileBytes = kKeys * kDh * 2;          // one K or V tile
constexpr int kQBytes = kBlockRows * kDh * 2;
constexpr int kSmem = kQBytes + kStages * 2 * kTileBytes;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// wgmma matrix descriptor, no swizzle: start, leading byte offset (between
// core matrices along K), stride byte offset (between 8-row groups along
// M or N), all in 16-byte units
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// make this thread's shared-memory writes visible to wgmma (async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// D[64 x 128] = A[64 x 16] . B[16 x 128] (+ D when sc), both operands
// K-major in shared memory; the first k step passes sc = 0
__device__ __forceinline__ void wgmma_n128_ss(float (&d)[64], uint64_t da,
                                              uint64_t db, int sc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(sc));
}

// D[64 x 64] = A[64 x 16] (registers) . B[16 x 64] (+ D when sc), B
// MN-major (the keys x head-dim rows of V as stored) in shared memory
__device__ __forceinline__ void wgmma_n64_rs(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int sc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(sc));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows [r0, r0 + rows) of one [T, 64] operand (column offset col of the
// projection) into the core-matrix layout at dst; rows >= T are zeroed
// (a V row of NaN would poison 0 * v)
__device__ __forceinline__ void load_rows(const __nv_bfloat16* base, int T,
                                          int D3, int col, int r0, int rows,
                                          uint8_t* dst) {
  for (int i = threadIdx.x; i < rows * (kDh / 8); i += kThreads) {
    const int r = i % 8, g = (i / 8) % 8, grp = i / 64;
    const int row = grp * 8 + r;
    uint8_t* d = dst + grp * kGroupBytes + g * 128 + r * 16;
    if (r0 + row < T)
      cp_async16(smem_u32(d), base + (size_t)(r0 + row) * D3 + col + g * 8);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const __nv_bfloat16* __restrict__ qkv,
                       __nv_bfloat16* __restrict__ out, int T, int heads,
                       float scale) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* Qs = smem;
  uint8_t* ring = smem + kQBytes;            // stage s: K, then V

  const int q0 = blockIdx.x * kBlockRows, h = blockIdx.y, n = blockIdx.z;
  const int D = heads * kDh, D3 = 3 * D;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  const int row0 = 16 * warp + lane / 4;     // this thread's rows: +0, +8
  const int cq = 2 * (lane % 4);             // its column pair in an n8 block
  const __nv_bfloat16* base = qkv + (size_t)n * T * D3;
  const float c = scale * 1.4426950408889634f;   // scale * log2(e)
  const int tiles = (T + kKeys - 1) / kKeys;

  // group 0: the q rows and K / V tile 0; group 1: tile 1 (or nothing)
  load_rows(base, T, D3, h * kDh, q0, kBlockRows, Qs);
  for (int j = 0; j < 2; ++j) {
    if (j < tiles) {
      uint8_t* st = ring + j * 2 * kTileBytes;
      load_rows(base, T, D3, D + h * kDh, j * kKeys, kKeys, st);
      load_rows(base, T, D3, 2 * D + h * kDh, j * kKeys, kKeys,
                st + kTileBytes);
    }
    cp_commit();
  }

  const uint32_t qs = smem_u32(Qs) + wg * (kRows / 8) * kGroupBytes;
  float o[32], l[2] = {0.0f, 0.0f}, m[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.0f;

  for (int j = 0; j < tiles; ++j) {
    // tile j has landed (tile j + 1 may still be in flight); after the
    // barrier every warpgroup is done with tile j - 1, whose stage the
    // copy of tile j + 2 takes
    cp_wait<1>();
    fence_async_smem();
    __syncthreads();
    if (j + 2 < tiles) {
      uint8_t* st = ring + ((j + 2) % kStages) * 2 * kTileBytes;
      load_rows(base, T, D3, D + h * kDh, (j + 2) * kKeys, kKeys, st);
      load_rows(base, T, D3, 2 * D + h * kDh, (j + 2) * kKeys, kKeys,
                st + kTileBytes);
    }
    cp_commit();
    const uint32_t ks = smem_u32(ring + (j % kStages) * 2 * kTileBytes);
    const uint32_t vs = ks + kTileBytes;

    // S = Q . K^T (f32); s[4 jj + e] is column 8 jj + cq + (e & 1) of row
    // row0 + 8 ((e >> 1) & 1)
    float s[64];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDh / 16; ++kk)
      wgmma_n128_ss(s, make_desc(qs + kk * 256, 128, kGroupBytes),
                    make_desc(ks + kk * 256, 128, kGroupBytes), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();

    // keys past T to -inf by selects, the tile's row max, the new max
    const int lim = T - j * kKeys;
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      s[i] = 8 * (i / 4) + cq + (i & 1) < lim ? s[i] : -INFINITY;
      mt[(i >> 1) & 1] = fmaxf(mt[(i >> 1) & 1], s[i]);
    }
    float alpha[2], mc[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mt[hh] = fmaxf(mt[hh], __shfl_xor_sync(0xffffffffu, mt[hh], 1));
      mt[hh] = fmaxf(mt[hh], __shfl_xor_sync(0xffffffffu, mt[hh], 2));
      const float mn = fmaxf(m[hh], mt[hh]);
      alpha[hh] = ex2((m[hh] - mn) * c);     // 0 on the first tile
      m[hh] = mn;
      mc[hh] = mn * c;
    }

    // p at the running max, f32 row sums, bf16 P in A-operand registers
    uint32_t pa[kKeys / 16][4];
    float ls[2] = {0.0f, 0.0f};
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      float* v = s + 8 * kk;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        v[e] = ex2(fmaf(v[e], c, -mc[(e >> 1) & 1]));
        ls[(e >> 1) & 1] += v[e];
      }
      pa[kk][0] = pack_bf16(v[0], v[1]);
      pa[kk][1] = pack_bf16(v[2], v[3]);
      pa[kk][2] = pack_bf16(v[4], v[5]);
      pa[kk][3] = pack_bf16(v[6], v[7]);
    }
    l[0] = fmaf(l[0], alpha[0], ls[0]);
    l[1] = fmaf(l[1], alpha[1], ls[1]);

    // O_tile = P . V (V rows past T are zero), then the running merge
    float ot[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk)
      wgmma_n64_rs(ot, pa[kk], make_desc(vs + 2 * kk * kGroupBytes,
                                         kGroupBytes, 128), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = fmaf(o[i], alpha[(i >> 1) & 1], ot[i]);
  }

  // the quad's partial sums (each scaled by the same alphas), then out
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    l[hh] = __frcp_rn(l[hh]);
  }
#pragma unroll
  for (int jj = 0; jj < 8; ++jj)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = q0 + wg * kRows + row0 + 8 * hh;
      if (r < T)
        *reinterpret_cast<__nv_bfloat162*>(
            out + ((size_t)n * T + r) * D + h * kDh + 8 * jj + cq) =
            __floats2bfloat162_rn(o[4 * jj + 2 * hh] * l[hh],
                                  o[4 * jj + 2 * hh + 1] * l[hh]);
    }
}

}  // namespace

extern "C" int vsc_flash_attention(const void* qkv, void* out, int N, int T,
                                   int heads, float scale, void* stream) {
  if (N < 1 || N > 65535 || T < 1 || heads < 1 || heads > 65535)
    return (int)cudaErrorInvalidValue;
  // (per call: the attribute belongs to the current device)
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + kBlockRows - 1) / kBlockRows, heads, N);
  flash_attention_kernel<<<grid, kThreads, kSmem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)qkv, (__nv_bfloat16*)out, T, heads, scale);
  return (int)cudaGetLastError();
}
