// ConvTranspose 2x2 / stride 2 / no padding, channels-last in and out.
//
// Replaces: vsc_tpu/ops/deconv_pallas.py  _kernel via deconv2x2_pallas
//   (reached from vsc_tpu/models/depthpro.py ConvT2x2 under
//   VSC_TPU_PALLAS_DECONV=1).
// Computes: out[n, o, 2i+a, 2j+b] = bias[o] + sum_c x[n, c, i, j] w[c, o, a, b]
//   with x [N, C, H, W] in channels-last memory (each image a dense
//   [H, W, C]; the batch stride may be wider, as the slice of a token
//   sequence that drops its cls token leaves it), torch's weight
//   [C, O, 2, 2] packed by the wrapper to Wt [4O, C] (row q = a*2O + b*O + o,
//   C contiguous), accumulated in f32, the bias added in f32, one rounding
//   to the input dtype (f32 or bf16). The output [N, O, 2H, 2W] is
//   channels-last too, as conv_transpose2d returns it for this input. With
//   NHWC memory the op is one product Y[p, q] = sum_c X[p, c] Wt[q, c] over
//   the M = N*H*W pixels p = (n*H + i)*W + j, both operands K-major, and
//   for fixed a the 2O columns (b, o) of one row of Y are ONE contiguous
//   span of output row 2i+a: elements ((2(n*H+i) + a)*2W + 2j)*O .. + 2O.
//   So the epilogue writes whole 16-byte vectors with no interleave.
// Bound on the H100: 2*M*C*4O operations against (M*C + 4O*C + 4*M*O)
//   elements. In bf16 the tensor cores put DepthPro's 14 sites of a 2-frame
//   batch at ~0.7 ms of products against ~1.2 ms of bytes, most of them the
//   4x larger output: the bytes bound it, so the loads and the store path
//   matter more than the product's shape. (On the CUDA cores the same 708
//   GFLOP take >= 10.6 ms at 67 TFLOP/s.)
// Design, bf16: a 128 x 128 tile of Y per block of two warpgroups, each
//   issuing wgmma m64n128k16 (f32 accumulators) on 64-deep K slices that
//   cp.async brings into a ring of three stages; two blocks an SM. The
//   slices sit in wgmma's 128-byte swizzle (one 128-byte row per pixel or
//   weight row, its 16-byte chunks permuted by row % 8), so eight lanes copy
//   one whole 128-byte line of device memory and the warp's shared-memory
//   stores hit every bank once (the no-swizzle layout, eight half-used
//   lines a warp, was slower). The column tiles of one row tile are
//   neighbouring blocks, so X is read from device memory about once and
//   from L2 for the other column tiles. Epilogue: bias in f32, one
//   rounding, the tile staged in shared memory, then written as 16-byte
//   vectors along the contiguous spans. What holds it back: outside the
//   head's site it runs at 2-4x its bytes bound and slower than cuDNN.
//   Each block's short K loop (2-4 slices at C <= 256) and its epilogue run
//   one after the other. The L2 re-reads of X and W are not the limit: a
//   block that kept its X rows resident and walked every column tile (half
//   the L2 traffic, one block an SM) was slower at every site.
// Design, float32: the same tiling on the CUDA cores (no TF32): 8-deep K
//   slices staged transposed in shared memory, an 8 x 8 register tile per
//   thread read with 16-byte loads, float4 stores along the spans.
// Build (nvcc -Xptxas -v, sm_90a, CUDA 12.8): bf16 128 registers, f32 115,
//   no spills, no C7520.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBN = 128;   // columns of Wt per block (divides 2O)

// ---- bf16: wgmma --------------------------------------------------------
constexpr int kWG = 2;                       // warpgroups, 64 pixels each
constexpr int kBMh = 64 * kWG;               // pixels per block
constexpr int kThreadsH = 128 * kWG;
constexpr int kBK = 64;                      // K slice: one 128-byte row
constexpr int kStages = 3;
constexpr int kMinBlocks = 2;                // blocks an SM
constexpr int kABytes = kBMh * kBK * 2;      // X slice
constexpr int kStageBytes = kABytes + kBN * kBK * 2;   // + Wt slice
constexpr int kSmem = kStages * kStageBytes; // 96 KB
constexpr int kOutLd = kBN + 8;              // staged output row (bf16)
static_assert(kBMh * kOutLd * 2 <= kSmem, "output staging must fit");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// wgmma matrix descriptor of a K-major operand in the 128-byte swizzle:
// start (16-byte units), leading byte offset unused (1), stride byte offset
// 1024 (between 8-row groups), layout type 1 (128-byte swizzle) in bits
// 62-63. A k16 step within the 128-byte rows advances the start by 32
// bytes; tiles start on 1024-byte boundaries, so the base offset is 0.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
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
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// D[64 x 128] = A[64 x 16] . B[16 x 128] (+ D when sc), both K-major in
// shared memory. The first k step passes sc = 0 instead of zeroing D
// (ordinary writes to the accumulators make ptxas serialize, C7520).
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
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

// Element offset of row p of a [rows, C] matrix whose rows come in groups
// of hw, sb elements apart (x: the pixels of one image; the packed weight:
// one group, hw = rows).
__device__ __forceinline__ size_t row_off(int p, int hw, long long sb,
                                          int C) {
  return (size_t)(p / hw) * sb + (size_t)(p % hw) * C;
}

// rows [r0, r0 + R) x K [k0, k0 + 64) of a [rows, C] bf16 matrix (rows
// laid out as row_off says) into wgmma's 128-byte swizzle at dst
// (1024-byte aligned): row r at r * 128 bytes, its 16-byte chunk g (8
// columns) at slot g ^ (r % 8). Rows >= rows and columns >= C (C % 8 ==
// 0) are zero. Eight lanes take the eight chunks of one row: a warp reads
// four whole 128-byte lines and writes four 128-byte lines of shared
// memory without bank conflicts.
template <int R>
__device__ __forceinline__ void load_slice(const __nv_bfloat16* src,
                                           int rows, int C, int hw,
                                           long long sb, int r0, int k0,
                                           uint8_t* dst) {
#pragma unroll
  for (int it = 0; it < R * 8 / kThreadsH; ++it) {
    const int i = threadIdx.x + it * kThreadsH;
    const int r = i / 8, g = i % 8;
    uint8_t* d = dst + r * 128 + ((g ^ (r % 8)) * 16);
    const int k = k0 + g * 8;
    if (r0 + r < rows && k < C)
      cp_async16(smem_u32(d), src + row_off(r0 + r, hw, sb, C) + k);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// Element offset of output row p (pixel (n, i, j), ni = n*H + i) at phase
// a: the start of its contiguous 2O span.
__device__ __forceinline__ size_t span(int p, int W, int O, int a) {
  const int ni = p / W, j = p % W;
  return ((size_t)(2 * ni + a) * 2 * W + 2 * j) * O;
}

__global__ void __launch_bounds__(kThreadsH, kMinBlocks)
deconv2x2_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ wt,
                      const __nv_bfloat16* __restrict__ bias,
                      __nv_bfloat16* __restrict__ out, int M, int C, int HW,
                      long long sxb, int W, int O, int ncol) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const int ct = blockIdx.x % ncol, mt = blockIdx.x / ncol;
  const int m0 = mt * kBMh, q0 = ct * kBN;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  const int N4 = 4 * O;
  const uint32_t sbase = smem_u32(smem);
  auto load_stage = [&](int st, int k0) {
    load_slice<kBMh>(x, M, C, HW, sxb, m0, k0, smem + st * kStageBytes);
    load_slice<kBN>(wt, N4, C, N4, 0, q0, k0,
                    smem + st * kStageBytes + kABytes);
  };

  const int ktiles = (C + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) load_stage(s, s * kBK);
    cp_commit();
  }

  float d[64];
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_wait<kStages - 2>();
    fence_async_smem();
    __syncthreads();   // slice kt landed; slice kt - 1 consumed by all
    const int nk = kt + kStages - 1;
    if (nk < ktiles) load_stage(nk % kStages, nk * kBK);
    cp_commit();
    const uint32_t a = sbase + (kt % kStages) * kStageBytes + wg * 64 * 128;
    const uint32_t b = sbase + (kt % kStages) * kStageBytes + kABytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_n128(d, make_desc(a + kk * 32), make_desc(b + kk * 32),
                 kt > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait0();
  }
  __syncthreads();     // every warpgroup is done reading the ring

  // bias in f32, one rounding, the tile staged as bf16 rows
  __nv_bfloat16* os = reinterpret_cast<__nv_bfloat16*>(smem);
  const int row = 64 * wg + 16 * warp + lane / 4;
  const int a_ph = q0 / (2 * O), c0 = q0 % (2 * O);
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int col = 8 * j + 2 * (lane % 4);
    float b0 = 0.0f, b1 = 0.0f;
    if (bias != nullptr) {
      b0 = __bfloat162float(bias[(c0 + col) % O]);
      b1 = __bfloat162float(bias[(c0 + col + 1) % O]);
    }
    *reinterpret_cast<__nv_bfloat162*>(os + row * kOutLd + col) =
        __floats2bfloat162_rn(d[4 * j] + b0, d[4 * j + 1] + b1);
    *reinterpret_cast<__nv_bfloat162*>(os + (row + 8) * kOutLd + col) =
        __floats2bfloat162_rn(d[4 * j + 2] + b0, d[4 * j + 3] + b1);
  }
  __syncthreads();
  // 16-byte vectors along the spans: 16 lanes write one row's 256 bytes
#pragma unroll
  for (int it = 0; it < kBMh * (kBN / 8) / kThreadsH; ++it) {
    const int i = threadIdx.x + it * kThreadsH;
    const int r = i / (kBN / 8), c = i % (kBN / 8);
    const int p = m0 + r;
    if (p < M)
      *reinterpret_cast<uint4*>(out + span(p, W, O, a_ph) + c0 + 8 * c) =
          *reinterpret_cast<const uint4*>(os + r * kOutLd + 8 * c);
  }
}

// ---- float32: CUDA cores ------------------------------------------------
constexpr int kBM = 128;         // pixels per block
constexpr int kThreads = 256;
constexpr int kBK32 = 8;
constexpr int kLd32 = kBM + 4;   // staged rows: 16-byte aligned, no 2-way
                                 // conflicts on the transposing stores

__global__ void __launch_bounds__(kThreads)
deconv2x2_f32_kernel(const float* __restrict__ x, const float* __restrict__ wt,
                     const float* __restrict__ bias, float* __restrict__ out,
                     int M, int C, int HW, long long sxb, int W, int O,
                     int ncol) {
  __shared__ __align__(16) float As[kBK32][kLd32];
  __shared__ __align__(16) float Bs[kBK32][kLd32];
  const int ct = blockIdx.x % ncol, mt = blockIdx.x / ncol;
  const int m0 = mt * kBM, q0 = ct * kBN;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int lr = tid / 2, lk = (tid % 2) * 4;   // this thread's loads
  const bool a_ok = m0 + lr < M;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < C; k0 += kBK32) {
    float4 av = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (a_ok)
      av = *reinterpret_cast<const float4*>(
          x + row_off(m0 + lr, HW, sxb, C) + k0 + lk);
    const float4 bv = *reinterpret_cast<const float4*>(
        wt + (size_t)(q0 + lr) * C + k0 + lk);
    __syncthreads();
    As[lk][lr] = av.x; As[lk + 1][lr] = av.y;
    As[lk + 2][lr] = av.z; As[lk + 3][lr] = av.w;
    Bs[lk][lr] = bv.x; Bs[lk + 1][lr] = bv.y;
    Bs[lk + 2][lr] = bv.z; Bs[lk + 3][lr] = bv.w;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBK32; ++k) {
      // rows ty*4 + {0..3} and 64 + ty*4 + {0..3}; columns likewise by tx
      const float4 a0 = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[k][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

  const int a_ph = q0 / (2 * O), c0 = q0 % (2 * O);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int p = m0 + (i / 4) * 64 + ty * 4 + i % 4;
    if (p >= M) continue;
    float* orow = out + span(p, W, O, a_ph) + c0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = h * 64 + tx * 4;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = acc[i][4 * h + e] +
               (bias != nullptr ? bias[(c0 + col + e) % O] : 0.0f);
      *reinterpret_cast<float4*>(orow + col) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

}  // namespace

// x [N, H, W, C] memory (channels-last) with a batch stride of sxb
// elements, wt [4O, C] packed (row a*2O + b*O + o), bias [O] or null, out
// [N, 2H, 2W, O] memory; bf16 selects __nv_bfloat16 for all four (else
// float32). C % 8 == 0, O % 64 == 0, sxb % 8 == 0, x and wt 16-byte
// aligned.
extern "C" int vsc_deconv2x2(const void* x, const void* wt, const void* bias,
                             void* out, int N, int C, int H, int W, int O,
                             long long sxb, int bf16, void* stream) {
  const long long M = (long long)N * H * W;
  if (N < 1 || H < 1 || W < 1 || C < 8 || C % 8 || O < 64 || O % 64 ||
      M > (1LL << 30) || sxb % 8 || sxb < (long long)H * W * C)
    return (int)cudaErrorInvalidValue;
  const int ncol = 4 * O / kBN;
  const int bm = bf16 ? kBMh : kBM;
  const long long blocks = ((M + bm - 1) / bm) * ncol;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    // (per call: the attribute belongs to the current device)
    const cudaError_t e = cudaFuncSetAttribute(
        deconv2x2_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmem);
    if (e != cudaSuccess) return (int)e;
    deconv2x2_bf16_kernel<<<(unsigned)blocks, kThreadsH, kSmem, s>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)wt,
        (const __nv_bfloat16*)bias, (__nv_bfloat16*)out, (int)M, C, H * W,
        sxb, W, O, ncol);
  } else {
    deconv2x2_f32_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
        (const float*)x, (const float*)wt, (const float*)bias, (float*)out,
        (int)M, C, H * W, sxb, W, O, ncol);
  }
  return (int)cudaGetLastError();
}
