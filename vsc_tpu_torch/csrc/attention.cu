// Short-sequence attention read straight from the fused qkv projection.
//
// Replaces: vsc_tpu/ops/attention_pallas.py  _qkv_kernel via
//   qkv_short_seq_attention (reached from vsc_tpu/models/vit.py Attention).
// Computes: per (sample, head), full-row softmax attention: f32 logits
//   = (q . k) * scale, minus the row max over the T real keys, p = exp, row
//   sum in f32, p rounded to bf16 at that FINAL max before the PV product,
//   f32 accumulation, out = acc / sum cast to bf16. q, k and v are read out
//   of the [N, T, 3D] projection ([q | k | v] along the last axis, head h
//   at columns h*64 of each part) through strides; the output is [N, T, D].
// Bound on the H100: at DepthPro's shapes (T = 577, 16 heads, Dh = 64) the
//   two products are ~85 MFLOP per (sample, head) against ~0.22 MB of
//   q/k/v, far above the bf16 ridge: the tensor cores bound it (0.10 ms at
//   [72, 577, 3072] on paper). Between the two products of a query tile
//   sits the per-logit softmax work on the CUDA cores and the MUFU unit
//   (mask, max, one FFMA + one ex2, row sum, bf16 pack; ~41 K logits a
//   tile), and a block cannot run it under its own products: that
//   serialization, not the bytes, is what the kernel loses to SDPA.
// Design: one block of four warpgroups (512 threads) per (sample, head),
//   T <= 640. The block copies the head's K and V (2 x 577 x 64 bf16) into
//   shared memory ONCE with cp.async (K first, V overlapped with the first
//   tile's QK^T) and walks the head's query tiles of 64 rows; the q tile
//   comes in by cp.async behind the previous tile's softmax. The exact
//   semantics need each row's final max before any p is rounded, so the
//   row stays resident. Of the two ways (S in shared memory in f32, or the
//   key range split over warpgroups) the kernel takes the split: a 64 x
//   640 f32 S (160 KB) does not fit beside K and V (160 KB), while a
//   quarter of it (160 keys, 80 accumulator registers a thread) fits in
//   registers. Per tile:
//     1. each warpgroup: S = Q . K_slice^T as two wgmma m64n80k16 products
//        (q and k from shared memory), each its own commit group so the
//        max of the first runs under the second; keys past T to -inf by
//        selects; the row max of the slice to shared memory (64 floats);
//     2. one barrier; each warpgroup takes the max of the four, forms
//        p = ex2(s * scale*log2(e) - max * scale*log2(e)) in f32 (its row
//        sum to shared memory) and packs p to bf16 straight from the S
//        accumulator registers into the A-operand registers of the PV
//        wgmma (m64n64k16, v from shared memory as an MN-major B): for
//        bf16 the accumulator and A-fragment layouts match, so P never
//        leaves the registers; the first keys' PV steps are issued before
//        the last keys' ex2;
//     3. warpgroups 1-3 write their partial O (f32) to shared memory; one
//        barrier; warpgroup 0 adds them to its own in the fixed order
//        0 + 1 + 2 + 3, multiplies by one reciprocal of the row sum (the
//        four partial sums added in the same order) and stores bf16.
//   QK^T is computed once per (query, key) pair. K, V and the q tile sit
//   in the no-swizzle core-matrix layout wgmma reads (8 rows x 16 bytes a
//   core matrix); with the partial O's and the row statistics that is
//   229,376 bytes of dynamic shared memory, one block an SM. Every wgmma
//   is issued outside any branch and starts its product with scale-d = 0
//   rather than zeroed accumulators: otherwise ptxas serializes the wgmma
//   (warning C7520), each product waiting for the one before.
// Build (nvcc -Xptxas -v, sm_90a, CUDA 12.8): 128 registers (the cap of
//   512 threads an SM), 24 bytes of spill stores and loads, no C7520.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kDh = 64;              // head dim
constexpr int kWG = 4;               // consumer warpgroups
constexpr int kThreads = 128 * kWG;
constexpr int kRows = 64;            // query rows per tile
constexpr int kSpan = 160;           // keys per warpgroup
constexpr int kTmax = kWG * kSpan;   // 640
constexpr int kChunks = kSpan / 32;  // 32-key chunks of the S accumulators
constexpr int kPv = kSpan / 16;      // k16 steps of PV per warpgroup
constexpr int kSplit = 2;            // n32 chunks held by the first m64n80
constexpr int kOld = kDh + 8;        // padded f32 row of a partial O

// shared memory: [K | V | Q | partial O x3 | row max x4 | row sum x4]
constexpr int kKBytes = kTmax * kDh * 2;
constexpr int kQBytes = kRows * kDh * 2;
constexpr int kOBytes = (kWG - 1) * kRows * kOld * 4;
constexpr int kSmem = 2 * kKBytes + kQBytes + kOBytes + 2 * kWG * kRows * 4;

// Core-matrix layout of a [rows x 64] bf16 operand: row r, column group g
// (8 columns) at (r / 8) * 1024 + g * 128 + (r % 8) * 16 bytes.
constexpr uint32_t kGroupBytes = 8 * kDh * 2;   // 8 rows, all 64 columns

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

// D[64 x 80] = A[64 x 16] . B[16 x 80] (+ D when sc), both operands
// K-major in shared memory. The first k step of a product passes sc = 0
// instead of zeroing D: writes to the accumulators outside wgmma make
// ptxas serialize the wgmma (C7520).
__device__ __forceinline__ void wgmma_n80_ss(float (&d)[40], uint64_t da,
                                              uint64_t db, int sc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39 }, "
      "%40, %41, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
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
qkv_attention_kernel(const __nv_bfloat16* __restrict__ qkv,
                     __nv_bfloat16* __restrict__ out, int T, int heads,
                     float scale) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* Ks = smem;
  uint8_t* Vs = Ks + kKBytes;
  uint8_t* Qs = Vs + kKBytes;
  float* Ox = reinterpret_cast<float*>(Qs + kQBytes);
  float* red_max = Ox + (kWG - 1) * kRows * kOld;
  float* red_sum = red_max + kWG * kRows;

  const int h = blockIdx.x, n = blockIdx.y;
  const int D = heads * kDh, D3 = 3 * D;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  const int row0 = 16 * warp + lane / 4;     // this thread's rows: +0, +8
  const int cq = 2 * (lane % 4);             // its column pair in an n8 block
  const int key0 = wg * kSpan;               // first key of this warpgroup
  const __nv_bfloat16* base = qkv + (size_t)n * T * D3;
  const float c = scale * 1.4426950408889634f;   // scale * log2(e)

  // q tile 0 and K (group 0), then V (group 1)
  load_rows(base, T, D3, h * kDh, 0, kRows, Qs);
  load_rows(base, T, D3, D + h * kDh, 0, kTmax, Ks);
  cp_commit();
  load_rows(base, T, D3, 2 * D + h * kDh, 0, kTmax, Vs);
  cp_commit();
  cp_wait<1>();
  fence_async_smem();
  __syncthreads();

  const uint32_t qs = smem_u32(Qs), ks = smem_u32(Ks), vs = smem_u32(Vs);
  const int tiles = (T + kRows - 1) / kRows;
  for (int tile = 0; tile < tiles; ++tile) {
    const int q0 = tile * kRows;

    // 1. S = Q . K_slice^T (fp32), keys past T masked, row max of the slice
    float s[kChunks][16];
    // Two m64n80 products, every key of the slice (keys >= T are zero rows,
    // masked below; a wgmma under a branch would be serialized), each its
    // own commit group: the max of the first runs while the second is in
    // the tensor cores. The accumulators keep the n32-chunk indexing:
    // s[ch][i] is column 32 ch + 8 (i / 4) + 2 (lane % 4) + (i & 1).
    wgmma_fence();
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int kk = 0; kk < kDh / 16; ++kk)
        wgmma_n80_ss(*reinterpret_cast<float(*)[40]>(&s[0][0] + 40 * half),
                     make_desc(qs + kk * 256, 128, kGroupBytes),
                     make_desc(ks + ((key0 + 80 * half) / 8) * kGroupBytes +
                                   kk * 256,
                               128, kGroupBytes),
                     kk > 0);
      wgmma_commit();
    }

    // keys past T to -inf by selects (a branch that writes accumulator
    // registers would serialize the next tile's wgmma), row max
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int ch = 0; ch < kChunks; ++ch) {
      if (ch == 0) wgmma_wait<1>();
      if (ch == kSplit) wgmma_wait<0>();
      const int lim = T - (key0 + 32 * ch);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        s[ch][i] = 8 * (i / 4) + cq + (i & 1) < lim ? s[ch][i] : -INFINITY;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[ch][i]);
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
    }
    if (lane % 4 == 0) {
      red_max[wg * kRows + row0] = mx[0];
      red_max[wg * kRows + row0 + 8] = mx[1];
    }
    if (tile == 0) {      // V has had the first QK^T to arrive
      cp_wait<0>();
      fence_async_smem();
    }
    __syncthreads();      // B1: row maxima; every warpgroup is done with Q

    // the next q tile comes in behind this tile's softmax and PV
    if (tile + 1 < tiles) {
      load_rows(base, T, D3, h * kDh, q0 + kRows, kRows, Qs);
      cp_commit();
    }

    // 2. p at the final max, f32 row sum, bf16 P in A-operand registers
    float mc[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float m = red_max[row0 + 8 * hh];
#pragma unroll
      for (int w = 1; w < kWG; ++w)
        m = fmaxf(m, red_max[w * kRows + row0 + 8 * hh]);
      mc[hh] = m * c;
    }
    // p, packed to bf16 as the A fragments of PV (masked keys give 0);
    // O_partial = P . V_slice (V rows past T are zero), the first chunks'
    // k16 steps issued before the last chunks' ex2
    uint32_t pa[kPv][4];
    float o[32];
#pragma unroll
    for (int ch = 0; ch < kChunks; ++ch) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float p = ex2(fmaf(s[ch][i], c, -mc[(i >> 1) & 1]));
        s[ch][i] = p;
        sum[(i >> 1) & 1] += p;
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float* v = s[ch] + 8 * q;
        pa[2 * ch + q][0] = pack_bf16(v[0], v[1]);
        pa[2 * ch + q][1] = pack_bf16(v[2], v[3]);
        pa[2 * ch + q][2] = pack_bf16(v[4], v[5]);
        pa[2 * ch + q][3] = pack_bf16(v[6], v[7]);
      }
      if (ch == kSplit - 1 || ch == kChunks - 1) {
        const int k0 = ch == kSplit - 1 ? 0 : 2 * kSplit;
        const int k1 = 2 * ch + 2;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kPv; ++kk)
          if (kk >= k0 && kk < k1)
            wgmma_n64_rs(o, pa[kk],
                         make_desc(vs + ((key0 + 16 * kk) / 8) * kGroupBytes,
                                   kGroupBytes, 128), kk > 0);
      }
    }
    wgmma_commit();
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 1);
      sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 2);
    }
    if (lane % 4 == 0) {
      red_sum[wg * kRows + row0] = sum[0];
      red_sum[wg * kRows + row0 + 8] = sum[1];
    }
    wgmma_wait<0>();

    // 3. partial O's of warpgroups 1-3 to shared memory
    if (wg > 0) {
      float* dst = Ox + (wg - 1) * kRows * kOld;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<float2*>(dst + row0 * kOld + 8 * j + cq) =
            make_float2(o[4 * j], o[4 * j + 1]);
        *reinterpret_cast<float2*>(dst + (row0 + 8) * kOld + 8 * j + cq) =
            make_float2(o[4 * j + 2], o[4 * j + 3]);
      }
    }
    if (tile + 1 < tiles) {
      cp_wait<0>();
      fence_async_smem();
    }
    __syncthreads();      // B2: partial O's, row sums, the next q tile

    if (wg == 0) {
      float inv[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float tot = red_sum[row0 + 8 * hh];
#pragma unroll
        for (int w = 1; w < kWG; ++w) tot += red_sum[w * kRows + row0 + 8 * hh];
        inv[hh] = __frcp_rn(tot);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = row0 + 8 * hh;
          float a = o[4 * j + 2 * hh], b = o[4 * j + 2 * hh + 1];
#pragma unroll
          for (int w = 0; w < kWG - 1; ++w) {
            const float2 x = *reinterpret_cast<const float2*>(
                Ox + w * kRows * kOld + r * kOld + 8 * j + cq);
            a += x.x;
            b += x.y;
          }
          if (q0 + r < T)
            *reinterpret_cast<__nv_bfloat162*>(
                out + ((size_t)n * T + q0 + r) * D + h * kDh + 8 * j + cq) =
                __floats2bfloat162_rn(a * inv[hh], b * inv[hh]);
        }
    }
  }
}

}  // namespace

extern "C" int vsc_qkv_attention(const void* qkv, void* out, int N, int T,
                                 int heads, float scale, void* stream) {
  if (N < 1 || N > 65535 || T < 1 || T > kTmax || heads < 1 ||
      heads > 65535)
    return (int)cudaErrorInvalidValue;
  // (per call: the attribute belongs to the current device)
  cudaError_t err = cudaFuncSetAttribute(
      qkv_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(heads, N);
  qkv_attention_kernel<<<grid, kThreads, kSmem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)qkv, (__nv_bfloat16*)out, T, heads, scale);
  return (int)cudaGetLastError();
}
