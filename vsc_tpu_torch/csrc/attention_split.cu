// Short-sequence attention on separate q, k, v.
//
// Replaces: vsc_tpu/ops/attention_pallas.py  _kernel via short_seq_attention
//   (reached from vsc_tpu/models/vit.py Attention for head layouts the qkv
//   kernel cannot take; the port sends every dtype and head dim other than
//   its qkv kernel's bf16 / 64 here, so the whole float32 DepthPro, and
//   every T beyond the qkv kernel's 640 keys).
// Computes: per (sample, head), full-row softmax attention with the qkv
//   kernel's semantics: f32 logits (q . k) * scale, the row max over the T
//   real keys, p = exp(logit - final max), row sum in f32, p rounded to the
//   input dtype before the PV product, f32 accumulation, out = acc / sum in
//   the input dtype. q, k and v are [B, T, H, Dh] views with a unit last
//   stride and shared batch / token / head strides, all multiples of 16
//   bytes (strided views of the fused qkv projection, no copies); the
//   output is a contiguous [B, T, H, Dh]. float32 or bf16; Dh = 16, 32,
//   ..., 128; any T.
// Bound on the H100: 4*T*T*Dh operations per (sample, head) against 4*T*Dh
//   elements: bf16 is bound by the bytes on paper (the tensor cores' share
//   is ~0.1 ms at [72, 577, 16, 64]); f32 (full fp32, no TF32) by the CUDA
//   cores' 67 TFLOP/s (1.49 ms at that shape).
// Design: the exact semantics round p at the FINAL row max, which rules
//   out an online softmax. One block takes 64 queries of one (sample, head)
//   on one of two routes, which the caller picks:
//   - resident (T <= kTmax): each logit is computed ONCE and the block's
//     [64, T] logits stay in shared memory as f32 (up to 161 KB at T = 640,
//     so one block an SM) until the row max is final; p is formed from them
//     for the PV product;
//   - two-pass (any T): a first pass over the K chunks computes the logits
//     for the row max only; a second pass recomputes each chunk's logits
//     (the same instructions on the same operands, so the same bits), forms
//     p at the final max and runs PV. Only one chunk of logits is held
//     (bf16: in registers; f32: [64, chunk] in shared memory), so T has no
//     cap, for 1.5x the products and 1.5x the K/V copies of the resident
//     route. Each thread sums its p over the same keys in the same order as
//     on the resident route: the two routes give the same bits. (Fewer
//     query rows a block would also fit [rows, T] logits, but would stream
//     K and V once per 32 or 16 queries: 2x or 4x the L2 traffic that
//     already holds the bf16 route back.)
//   K and V pass through shared memory in 32- or 64-key chunks, each copied
//   once per pass and block (cp.async).
//   - bf16: eight warps, each 16 queries x half of every 64-key chunk;
//     mma.sync m16n8k16 (f32 accumulation) for QK^T (q fragments kept in
//     registers, k by ldmatrix) and for PV (p at the final max rounded to
//     bf16 straight into the A fragments, v by ldmatrix.trans). The logits
//     a warp writes are the ones it reads back (two-pass: its QK^T
//     accumulators are the PV's A fragments as they stand), so only the row
//     max (and at the end the row sums and partial outputs) cross warps. K
//     then V chunks (two-pass: the K chunks, then K and V in turn) stream
//     through a ring of two to four slots. What holds it back: each of the
//     10 query tiles of a (sample, head) streams the whole K and V from L2
//     (~1.9 GB at [72, 577, 16, 64]); without the copies the kernel takes
//     ~70 % of its time.
//   - float32: eight warps on the CUDA cores. In QK^T and PV each warp
//     takes 32 rows and a quarter of the chunk's keys (or of the output's
//     columns); each thread 4 rows x 4 keys (or Dh/16 columns), read with
//     16-byte loads that touch 8 rows and 4 keys a warp: one shared-memory
//     wavefront a load (16 FMAs a load; 8 x 8 thread tiles would need
//     128-key chunks, which do not fit beside the logits). A quarter of
//     the last chunk with no real key skips its products. The row max
//     crosses the four quarters through shared memory; then p = exp(l -
//     max) in place, all loads of a run before its exps and stores (loads
//     and stores through one pointer stay in program order, so an
//     interleaved loop serializes on them).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kQ = 64;        // queries per block
constexpr int kTmax = 640;    // keys the resident route's logits hold

struct Strides {
  long long b, t, h;   // elements
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
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

// ---- bf16: tensor cores (mma.sync) -------------------------------------
constexpr int kKC = 64;                 // keys per chunk
constexpr int kThreadsB = 256;          // 8 warps: 4 query groups x 2 halves
// slots of the K/V ring (chunks in flight: one less), as many as fit
// beside T = 640 logits
template <int DH>
__host__ __device__ constexpr int ring_slots() {
  return DH <= 64 ? 4 : DH <= 96 ? 3 : 2;
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
// C[16 x 8] += A[16 x 16] . B[16 x 8], bf16 in, f32 accumulators
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows t0 .. t0 + 63 of one head's [T, DH] bf16 slice (a K or V chunk, or
// the block's queries) -> dst (row stride DH + 8 elements) by cp.async;
// rows >= T zero
static_assert(kQ == kKC, "one copy routine for queries and chunks");
template <int DH>
__device__ __forceinline__ void load_rows_bf16(const __nv_bfloat16* src,
                                               long long st, int T, int t0,
                                               __nv_bfloat16* dst) {
  constexpr int kC = DH / 8;   // 16-byte chunks a row
  for (int i = threadIdx.x; i < kKC * kC; i += kThreadsB) {
    const int r = i / kC, c = i % kC;
    __nv_bfloat16* d = dst + r * (DH + 8) + c * 8;
    if (t0 + r < T)
      cp_async16(d, src + (long long)(t0 + r) * st + c * 8);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// TWO: the two-pass route (else the resident one). Its shared memory
// leaves room for two blocks an SM; up to head dim 64 their registers fit
// too (128 a thread, no spills; at 148 there was one block an SM, and the
// route ran 1.5x slower at [72, 1025, 16, 64])
template <int DH, bool TWO>
__global__ void __launch_bounds__(kThreadsB, TWO && DH <= 64 ? 2 : 1)
split_attention_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            __nv_bfloat16* __restrict__ out, int T,
                            int heads, Strides st, float scale) {
  constexpr int kLd = DH + 8;             // bf16 row of Q, K, V (no ldmatrix
                                          // bank conflicts)
  constexpr int kNd = DH / 8;             // n8 tiles of the output
  constexpr int kLo = DH + 4;             // f32 row of a partial output
  constexpr int kNS = ring_slots<DH>();
  extern __shared__ __align__(128) uint8_t smem[];
  const int tpad = (T + kKC - 1) / kKC * kKC;
  const int lds = tpad + 8;               // f32 logits row (== 8 mod 32)
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ring = Qs + kQ * kLd;    // kNS slots of kKC x kLd
  float* red = reinterpret_cast<float*>(ring + kNS * kKC * kLd);
                                          // [2][64] row max, then row sums
  float* S = red + 2 * kQ;                // resident: [64][lds]; at the end
                                          // [64][kLo]

  const int q0 = blockIdx.x * kQ, h = blockIdx.y, n = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qg = warp & 3, kh = warp >> 2;
  const int g = lane / 4, tq = lane % 4;
  const int row0 = 16 * qg + g;           // this thread's rows: +0, +8
  const long long off = (long long)n * st.b + (long long)h * st.h;
  const __nv_bfloat16* qb = q + off;
  const __nv_bfloat16* kb = k + off;
  const __nv_bfloat16* vb = v + off;
  const int nc = tpad / kKC;
  const int steps = (TWO ? 3 : 2) * nc;
  float* Sw = S + row0 * lds;             // this thread's first row

  // steps x < nc copy K chunk x (pass 1). Resident: step nc + x copies V
  // chunk x; two-pass: steps nc + 2x and nc + 2x + 1 copy K and V chunk x.
  // Into slot x % kNS.
  auto step_is_v = [&](int x) {
    return x >= nc && (TWO ? ((x - nc) & 1) : 1);
  };
  auto step_chunk = [&](int x) {
    return x < nc ? x : TWO ? (x - nc) >> 1 : x - nc;
  };
  auto load_step = [&](int x) {
    load_rows_bf16<DH>(step_is_v(x) ? vb : kb, st.t, T, step_chunk(x) * kKC,
                       ring + (x % kNS) * kKC * kLd);
  };
  load_rows_bf16<DH>(qb, st.t, T, q0, Qs);
#pragma unroll
  for (int x = 0; x < kNS - 1; ++x) {
    if (x < steps) load_step(x);
    cp_commit();
  }

  uint32_t qa[DH / 16][4];
  float cl[4][4];       // two-pass: this warp's logits of the current chunk
  float m[2] = {-INFINITY, -INFINITY}, sum[2] = {0.0f, 0.0f};
  float o[kNd][4];
#pragma unroll
  for (int j = 0; j < kNd; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.0f;

  for (int s = 0; s < steps; ++s) {
    cp_wait<kNS - 2>();
    __syncthreads();        // step s landed; step s - 1's slot read by all
    if (s + kNS - 1 < steps) load_step(s + kNS - 1);
    cp_commit();
    const __nv_bfloat16* buf = ring + (s % kNS) * kKC * kLd;
    if (s == 0) {
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
        ldsm_x4(qa[kk], Qs + (16 * qg + lane % 16) * kLd + kk * 16 +
                            (lane / 16) * 8);
    }
    const int chunk = step_chunk(s);
    if (!step_is_v(s)) {
      // S[16 x 32] = Q . K_half^T, scaled, keys >= T to -inf: resident, to
      // shared memory; two-pass, only maximized (pass 1) or kept in cl
      const int key0 = chunk * kKC + kh * 32;
      float c[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[j][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          uint32_t b[4];
          ldsm_x4(b, buf + (kh * 32 + jp * 16 + lane % 8 + (lane / 16) * 8) *
                               kLd + kk * 16 + ((lane / 8) % 2) * 8);
          mma16816(c[2 * jp], qa[kk], b[0], b[1]);
          mma16816(c[2 * jp + 1], qa[kk], b[2], b[3]);
        }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = key0 + 8 * j + 2 * tq;
        float l[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          l[e] = key + (e & 1) < T ? __fmul_rn(c[j][e], scale) : -INFINITY;
          if (s < nc) m[e >> 1] = fmaxf(m[e >> 1], l[e]);
          cl[j][e] = l[e];
        }
        if (!TWO) {
          *reinterpret_cast<float2*>(Sw + key) = make_float2(l[0], l[1]);
          *reinterpret_cast<float2*>(Sw + 8 * lds + key) =
              make_float2(l[2], l[3]);
        }
      }
    } else {
      if (s == (TWO ? nc + 1 : nc)) {   // the final row max: both key halves
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          m[hh] = fmaxf(m[hh], __shfl_xor_sync(0xffffffffu, m[hh], 1));
          m[hh] = fmaxf(m[hh], __shfl_xor_sync(0xffffffffu, m[hh], 2));
        }
        if (tq == 0) {
          red[kh * kQ + row0] = m[0];
          red[kh * kQ + row0 + 8] = m[1];
        }
        __syncthreads();
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          m[hh] = fmaxf(red[row0 + 8 * hh], red[kQ + row0 + 8 * hh]);
      }
      // O += P . V_half: p at the final max (f32 sum), bf16 A fragments
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const int key = chunk * kKC + kh * 32 + ks * 16 + 2 * tq;
        uint32_t pa[4];
#pragma unroll
        for (int f = 0; f < 4; ++f) {        // (g, k), (g+8, k), (g, k+8), ..
          const float2 l =
              TWO ? make_float2(cl[2 * ks + (f >> 1)][2 * (f & 1)],
                                cl[2 * ks + (f >> 1)][2 * (f & 1) + 1])
                  : *reinterpret_cast<const float2*>(
                        Sw + (f & 1) * 8 * lds + key + (f >> 1) * 8);
          const float mm = m[f & 1];
          const float p0 = __expf(__fsub_rn(l.x, mm));
          const float p1 = __expf(__fsub_rn(l.y, mm));
          sum[f & 1] = __fadd_rn(__fadd_rn(sum[f & 1], p0), p1);
          pa[f] = pack_bf16(p0, p1);
        }
#pragma unroll
        for (int jp = 0; jp < kNd / 2; ++jp) {
          uint32_t b[4];
          ldsm_x4_t(b, buf + (kh * 32 + ks * 16 + lane % 8 +
                              ((lane / 8) % 2) * 8) * kLd +
                           jp * 16 + (lane / 16) * 8);
          mma16816(o[2 * jp], pa, b[0], b[1]);
          mma16816(o[2 * jp + 1], pa, b[2], b[3]);
        }
      }
    }
  }
  __syncthreads();          // every warp is done with the logits

  // the two key halves: sums and partial outputs of half 1 to shared
  // memory (over the logits, no longer read), added to half 0's
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    sum[hh] = __fadd_rn(sum[hh], __shfl_xor_sync(0xffffffffu, sum[hh], 1));
    sum[hh] = __fadd_rn(sum[hh], __shfl_xor_sync(0xffffffffu, sum[hh], 2));
  }
  float* Ox = S;                            // [64][kLo]
  if (kh == 1) {
    if (tq == 0) {
      red[kQ + row0] = sum[0];
      red[kQ + row0 + 8] = sum[1];
    }
#pragma unroll
    for (int j = 0; j < kNd; ++j) {
      *reinterpret_cast<float2*>(Ox + row0 * kLo + 8 * j + 2 * tq) =
          make_float2(o[j][0], o[j][1]);
      *reinterpret_cast<float2*>(Ox + (row0 + 8) * kLo + 8 * j + 2 * tq) =
          make_float2(o[j][2], o[j][3]);
    }
  }
  __syncthreads();
  if (kh == 0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = row0 + 8 * hh, t = q0 + r;
      const float l = __fadd_rn(sum[hh], red[kQ + r]);
      if (t >= T) continue;
      __nv_bfloat16* orow = out + (((long long)n * T + t) * heads + h) * DH;
#pragma unroll
      for (int j = 0; j < kNd; ++j) {
        const float2 x =
            *reinterpret_cast<const float2*>(Ox + r * kLo + 8 * j + 2 * tq);
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * tq) =
            __floats2bfloat162_rn(
                __fdiv_rn(__fadd_rn(o[j][2 * hh], x.x), l),
                __fdiv_rn(__fadd_rn(o[j][2 * hh + 1], x.y), l));
      }
    }
  }
}

template <int DH>
int smem_bf16(int T, bool two) {
  const int tpad = (T + kKC - 1) / kKC * kKC;
  const int s_floats = kQ * (!two && tpad + 8 > DH + 4 ? tpad + 8 : DH + 4);
  return (kQ + ring_slots<DH>() * kKC) * (DH + 8) * 2 +
         (2 * kQ + s_floats) * 4;
}

// ---- float32: CUDA cores -----------------------------------------------
constexpr int kThreadsF = 256;   // 8 warps: 2 row halves x 4 quarters

template <int DH>
__host__ __device__ constexpr int chunk_f32() { return DH <= 64 ? 64 : 32; }   // keys a chunk

// rows t0 .. t0 + rows - 1 of one head's [T, DH] f32 slice -> dst (row
// stride ld) by cp.async; rows >= T zero
template <int DH>
__device__ __forceinline__ void load_rows_f32(const float* src, long long st,
                                              int T, int t0, int rows,
                                              int ld, float* dst) {
  constexpr int kC = DH / 4;   // 16-byte chunks a row
  for (int i = threadIdx.x; i < rows * kC; i += kThreadsF) {
    const int r = i / kC, c = i % kC;
    float* d = dst + r * ld + c * 4;
    if (t0 + r < T)
      cp_async16(d, src + (long long)(t0 + r) * st + c * 4);
    else
      *reinterpret_cast<float4*>(d) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// TWO: the two-pass route (else the resident one)
template <int DH, bool TWO>
__global__ void __launch_bounds__(kThreadsF, 1)
split_attention_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           float* __restrict__ out, int T, int heads,
                           Strides st, float scale) {
  constexpr int KC = chunk_f32<DH>();
  constexpr int QS = KC / 4;      // keys of a chunk a warp's QK takes
  constexpr int NJ = QS / 4;      // ... a thread: kg + 4 j
  constexpr int CW = DH / 16;     // output columns a thread: cg*CW + e
  constexpr int kLd = DH + 4;     // Q, K, V rows: 16-byte aligned, and the
                                  // eight rows (or four keys) a warp reads
                                  // at once fall in distinct banks
  extern __shared__ __align__(16) float smf[];
  const int tpad = (T + KC - 1) / KC * KC;
  const int lds = TWO ? KC + 4 : tpad + 4;   // logits row (== 4 mod 32)
  float* Qs = smf;                // [64][kLd]
  float* ring = Qs + kQ * kLd;    // 2 slots of [KC][kLd]
  float* S = ring + 2 * KC * kLd; // [64][lds]: every key's logits
                                  // (resident) or one chunk's (two-pass)
  // row max partials [4][64], then row sums [64]: over Q once the products
  // are done (resident), beside S (two-pass, which reads Q to the end)
  float* red = TWO ? S + kQ * lds : Qs;
  float* lsum = red + 4 * kQ;

  const int q0 = blockIdx.x * kQ, h = blockIdx.y, n = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // QK and PV: each warp 32 rows (half rh) x a quarter (keys of a chunk,
  // or output columns); each thread 4 rows (rg + 8 i) x 4 keys (kg + 4 j)
  // or CW columns. A warp's loads then touch 8 rows and 4 keys or column
  // groups: one 128-byte wavefront each, where 16 distinct rows took two.
  const int rh = warp >> 2, wq = warp & 3;
  const int rg = lane >> 2, kg = lane & 3;
  const int r0 = 32 * rh + rg;    // rows r0 + 8 i
  const long long off = (long long)n * st.b + (long long)h * st.h;
  const float* kb = k + off;
  const float* vb = v + off;
  const int nc = tpad / KC;
  const int steps = (TWO ? 3 : 2) * nc;
  // steps x < nc copy K chunk x (pass 1). Resident: step nc + x copies V
  // chunk x; two-pass: steps nc + 2x and nc + 2x + 1 copy K and V chunk x.
  // Into slot x & 1.
  auto step_is_v = [&](int x) {
    return x >= nc && (TWO ? ((x - nc) & 1) : 1);
  };
  auto step_chunk = [&](int x) {
    return x < nc ? x : TWO ? (x - nc) >> 1 : x - nc;
  };
  auto load_step = [&](int x) {
    load_rows_f32<DH>(step_is_v(x) ? vb : kb, st.t, T, step_chunk(x) * KC,
                      KC, kLd, ring + (x & 1) * KC * kLd);
  };

  load_rows_f32<DH>(q + off, st.t, T, q0, kQ, kLd, Qs);
  load_step(0);
  cp_commit();

  float m[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = -INFINITY;
  float acc[4][CW];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < CW; ++e) acc[i][e] = 0.0f;
  const int t4 = (T + 3) & ~3;    // keys the PV product reads
  // the softmax pass: rows ty + 16 i, 4-key runs 4 tx + 64 k; the final
  // row maxima and the running row sums of those rows
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float mr[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) l[i] = 0.0f;

  for (int s = 0; s < steps; ++s) {
    cp_wait<0>();
    __syncthreads();        // step s landed; step s - 1's slot read by all
    if (s + 1 < steps) load_step(s + 1);
    cp_commit();
    const float* buf = ring + (s & 1) * KC * kLd;
    const int chunk = step_chunk(s);
    // S indexed by key: the two-pass route holds chunk `chunk` alone
    float* Sk = TWO ? S - chunk * KC : S;
    if (!step_is_v(s)) {
      // 16-byte loads along d; scaled, keys >= T to -inf, to S (pass 1 of
      // the two-pass route: only the row max). A quarter with no real key
      // is skipped (its logits are never read).
      const int key0 = chunk * KC + QS * wq;
      if (key0 >= T) continue;
      float c[4][NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) c[i][j] = 0.0f;
#pragma unroll
      for (int d = 0; d < DH; d += 4) {
        float4 a[4], b[NJ];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[i] = *reinterpret_cast<const float4*>(Qs + (r0 + 8 * i) * kLd +
                                                  d);
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          b[j] = *reinterpret_cast<const float4*>(
              buf + (QS * wq + kg + 4 * j) * kLd + d);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            c[i][j] = fmaf(a[i].x, b[j].x, c[i][j]);
            c[i][j] = fmaf(a[i].y, b[j].y, c[i][j]);
            c[i][j] = fmaf(a[i].z, b[j].z, c[i][j]);
            c[i][j] = fmaf(a[i].w, b[j].w, c[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int key = key0 + kg + 4 * j;
          const float x = key < T ? __fmul_rn(c[i][j], scale) : -INFINITY;
          if (s < nc) m[i] = fmaxf(m[i], x);
          if (!TWO || s >= nc) Sk[(r0 + 8 * i) * lds + key] = x;
        }
      continue;
    }
    if (s == (TWO ? nc + 1 : nc)) {
      // the final row max: over the 4 lanes (kg) of a warp, then the 4
      // quarters through shared memory
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 1));
        m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 2));
        if (kg == 0) red[wq * kQ + r0 + 8 * i] = m[i];
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        mr[i] = fmaxf(fmaxf(red[r], red[kQ + r]),
                      fmaxf(red[2 * kQ + r], red[3 * kQ + r]));
      }
    }
    if (TWO || s == nc) {
      // p = exp(l - m) in place with the f32 row sums, over every key
      // (resident) or this chunk's (two-pass: a chunk lies within one
      // 64-key run, so each thread adds its runs in the same order on both
      // routes); all loads of a run before its exps and all exps before its
      // stores (loads and stores through one pointer stay in program order,
      // so an interleaved loop serializes on them)
      const int k_lo = TWO ? chunk * KC : 0;
      const int k_hi = TWO ? min(k_lo + KC, t4) : t4;
      for (int key = (k_lo & ~63) + 4 * tx; key < k_hi; key += 64) {
        if (key < k_lo) continue;
        float4 x[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          x[i] = *reinterpret_cast<const float4*>(Sk + (ty + 16 * i) * lds +
                                                  key);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          x[i].x = expf(__fsub_rn(x[i].x, mr[i]));
          x[i].y = expf(__fsub_rn(x[i].y, mr[i]));
          x[i].z = expf(__fsub_rn(x[i].z, mr[i]));
          x[i].w = expf(__fsub_rn(x[i].w, mr[i]));
          l[i] = __fadd_rn(__fadd_rn(l[i], x[i].x), __fadd_rn(x[i].y,
                                                              x[i].z));
          l[i] = __fadd_rn(l[i], x[i].w);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
          *reinterpret_cast<float4*>(Sk + (ty + 16 * i) * lds + key) = x[i];
      }
      if (!TWO) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int o = 8; o > 0; o >>= 1)
            l[i] = __fadd_rn(l[i], __shfl_xor_sync(0xffffffffu, l[i], o));
          if (tx == 0) lsum[ty + 16 * i] = l[i];
        }
      }
      __syncthreads();      // p of every row before any thread reads it
    }
    // O += P . V_chunk: 4 rows x CW columns a thread, p read 4 keys at a
    // time, up to the last real key (p of keys >= T is 0)
    const int key0 = chunk * KC;
    const int kn = min(KC, t4 - key0);
    const int c0 = wq * (DH / 4) + kg * CW;
#pragma unroll 2
    for (int kk = 0; kk < kn; kk += 4) {
      float p[4][4], vv[4][CW];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<float4*>(p[i]) = *reinterpret_cast<const float4*>(
            Sk + (r0 + 8 * i) * lds + key0 + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vr = buf + (kk + u) * kLd + c0;
        if constexpr (CW % 4 == 0) {
#pragma unroll
          for (int e = 0; e < CW; e += 4)
            *reinterpret_cast<float4*>(vv[u] + e) =
                *reinterpret_cast<const float4*>(vr + e);
        } else {
#pragma unroll
          for (int e = 0; e < CW; ++e) vv[u][e] = vr[e];
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < CW; ++e)
            acc[i][e] = fmaf(p[i][u], vv[u][e], acc[i][e]);
    }
  }

  if (TWO) {        // the row sums, reduced as the resident route does
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        l[i] = __fadd_rn(l[i], __shfl_xor_sync(0xffffffffu, l[i], o));
      if (tx == 0) lsum[ty + 16 * i] = l[i];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + 8 * i, t = q0 + r;
    if (t >= T) continue;
    const float l = lsum[r];
    float* orow = out + (((long long)n * T + t) * heads + h) * DH + wq *
                  (DH / 4) + kg * CW;
    if constexpr (CW % 4 == 0) {
#pragma unroll
      for (int e = 0; e < CW; e += 4)
        *reinterpret_cast<float4*>(orow + e) = make_float4(
            __fdiv_rn(acc[i][e], l), __fdiv_rn(acc[i][e + 1], l),
            __fdiv_rn(acc[i][e + 2], l), __fdiv_rn(acc[i][e + 3], l));
    } else {
#pragma unroll
      for (int e = 0; e < CW; ++e) orow[e] = __fdiv_rn(acc[i][e], l);
    }
  }
}

template <int DH>
int smem_f32(int T, bool two) {
  constexpr int KC = chunk_f32<DH>();
  const int tpad = (T + KC - 1) / KC * KC;
  // two-pass: one chunk's logits, then the [4][64] maxima and [64] sums
  return ((kQ + 2 * KC) * (DH + 4) + kQ * (two ? KC + 4 + 5 : tpad + 4)) * 4;
}

template <int DH, bool TWO>
int dispatch_route(const void* q, const void* k, const void* v, void* out,
                   int B, int T, int heads, Strides st, float scale, int bf16,
                   cudaStream_t s) {
  const dim3 grid((T + kQ - 1) / kQ, heads, B);
  if (bf16) {
    const int smem = smem_bf16<DH>(T, TWO);
    const cudaError_t e = cudaFuncSetAttribute(
        split_attention_bf16_kernel<DH, TWO>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    split_attention_bf16_kernel<DH, TWO><<<grid, kThreadsB, smem, s>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, (__nv_bfloat16*)out, T, heads, st, scale);
  } else {
    const int smem = smem_f32<DH>(T, TWO);
    const cudaError_t e = cudaFuncSetAttribute(
        split_attention_f32_kernel<DH, TWO>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    split_attention_f32_kernel<DH, TWO><<<grid, kThreadsF, smem, s>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)out, T,
        heads, st, scale);
  }
  return (int)cudaGetLastError();
}

template <int DH>
int dispatch_dh(const void* q, const void* k, const void* v, void* out,
                int B, int T, int heads, Strides st, float scale, int bf16,
                int two_pass, cudaStream_t s) {
  return two_pass ? dispatch_route<DH, true>(q, k, v, out, B, T, heads, st,
                                             scale, bf16, s)
                  : dispatch_route<DH, false>(q, k, v, out, B, T, heads, st,
                                              scale, bf16, s);
}

}  // namespace

// strides in elements, shared by q, k and v (pointers and strides 16-byte
// aligned); bf16 selects __nv_bfloat16 (else float32) for q, k, v and out;
// two_pass the two-pass route (any T), else the resident one (T <= kTmax)
extern "C" int vsc_split_attention(const void* q, const void* k,
                                   const void* v, void* out, int B, int T,
                                   int heads, int dh, long long sb,
                                   long long st, long long sh, float scale,
                                   int bf16, int two_pass, void* stream) {
  if (B < 1 || B > 65535 || T < 1 || (!two_pass && T > kTmax) ||
      heads < 1 || heads > 65535)
    return (int)cudaErrorInvalidValue;
  const Strides s = {sb, st, sh};
  cudaStream_t cs = (cudaStream_t)stream;
  switch (dh) {
#define VSC_DH(D)                                                     \
    case D:                                                           \
      return dispatch_dh<D>(q, k, v, out, B, T, heads, s, scale, bf16,  \
                            two_pass, cs);
    VSC_DH(16) VSC_DH(32) VSC_DH(48) VSC_DH(64)
    VSC_DH(80) VSC_DH(96) VSC_DH(112) VSC_DH(128)
#undef VSC_DH
    default: return (int)cudaErrorInvalidValue;
  }
}
