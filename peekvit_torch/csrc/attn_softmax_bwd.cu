// Per-head attention backward over packed qkv for the trainable block.
//
// Replaces the per-head core shared by the two backward kernels of
// peekvit_tpu/ops/pallas/fused_attention_vjp.py: :93 _attn_bwd_kernel
// (:117-156, the recompute path) and :172 _attn_bwd_kernel_saved
// (:202-236, the default path). From qkv and dattn it writes
// dqkv = [dQ | dK | dV] (B, N, 3D) bf16 in the packed layout (head h at
// columns h*64, D + h*64, 2D + h*64), with the Pallas rounding points
// (:130-148):
//   - S = softmax((q . k^T) * scale) recomputed in fp32 (max subtracted,
//     divided by the row sum);
//   - dV = bf16(S)^T . dA, accumulated in fp32;
//   - dS = dA . V^T stays fp32;
//   - dZ = S * (dS - rowsum(dS * S)) with the fp32 S;
//   - bf16(dZ * scale) feeds dQ = dZ . K and dK = dZ^T . Q (fp32 sums).
// Outputs are rounded to bf16 once.
//
// Bound on H100: per (image, head) the five N x N x 64 products are
// 10 * N^2 * 64 flops against 7 * N * 64 * 2 bytes (q, k, v, dA in; dq,
// dk, dv out), ~280 flops per byte at N = 197: near the ridge, so both
// the bytes and the tensor cores bound it; the work per logit (exp, the
// row statistics, the bf16 packing) is what costs time in practice.
//
// Design for N <= 256 (attn_bwd_wgmma_kernel; every path the port trains:
// N = 197 for ViT, 198 for ResidualViT): one CTA of one warpgroup per
// (head, image). Thread 0 loads the head's Q, K, V and dA once by TMA
// (3-D tensor maps over (column, token, image), 128-byte swizzle: a head
// row is 128 bytes; N padded to 16 NT rows, the rows past N read as zero):
// Q and K onto one mbarrier, V and dA onto a second, so the first
// product starts while V and dA are in flight. 4 x 208 x 128 bytes at
// N = 197 (108 KB with the row statistics): two CTAs per SM.
//   Phase A, by 64-row query tiles:
//     S = Q K^T (Q's fragments as the register A operand, K K-major in
//       shared memory; four 16-key chunks a wgmma m64n64k16), the whole
//       row of logits in registers (8 NT fp32 a thread);
//     the row max and sum, then P: the fp32 P stays in those registers;
//     D = rowsum(dS * P), with dS = dA V^T taken four 16-key chunks a
//       wgmma (dA and V both K-major in shared memory);
//     dS again, two chunks a wgmma: bf16(dZ * scale) with dZ = P * (dS - D)
//       becomes the register A operand of dQ += dZ K (wgmma m64n64k16, K
//       MN-major); dQ is stored. Each row's max (times scale log2 e), its
//       reciprocal sum and D go to shared memory.
//   Phase B, by 64-key tiles: S^T = K Q^T and dS^T = V dA^T four 16-query
//     chunks a wgmma, normalised with the stored row statistics, give
//     bf16(P^T) and bf16(dZ^T * scale) as register A operands of
//     dV += P^T dA and dK += dZ^T Q (wgmma m64n64k16, dA and Q MN-major);
//     dK and dV sum over the query chunks in order and are stored.
// So S is computed twice and dS three times (8 products, against the 5 the
// contract needs and the 10 of the kernel below), and 3 exponentials a
// logit, against 4. Every sum runs in one CTA in a fixed order:
// no atomics, the same bits on every run. Keys past N get P = 0 (their
// logits are -inf before the row max; only the last 16-key chunk can hold
// any); query rows past N have zero dA, so their dZ is 0, and phase B
// forces their P to 0 as well. A 64-row Q tile reaching past the 16 NT
// staged rows reads the last staged row (a row past n) in their place; a
// 64-row dA, K or V tile reads on into the next region. Those rows are
// never stored.
// Registers: the row of P is 8 NT of the 255 a thread may hold. Three
// things keep the rest in bounds with no spill at any NT (ptxas -v): a
// product takes up to four 16-row chunks at once and each descriptor is
// its region's base plus an offset added inside the wgmma's asm (built
// ahead, the hundred-odd distinct descriptors of a tile sat in registers
// and spilled); the last chunk's key-validity bits are hidden from the
// compiler behind an empty asm; the output pointer is formed where it is
// stored. The batch sizes of phase A shrink at 15 and 16 chunks (Batch).
// Numerics: every value is the kernel below's, operation for operation,
// so the two give the same bits (scripts/kernel_bit_identity.py): the
// tensor cores sum each product's 16-deep slices in the same order under
// wgmma as under mma.sync; the row max and the rescaled sum of
// expf(scaled logit - max) are taken chunk by chunk in the same order; P
// is expf(logit * scale - max) / sum and the row term rowsum(dS * P) sums
// two columns at a time in the same order. exp2 of a log2(e)-scaled logit
// and one reciprocal per row would save instructions, but they move P by
// an fp32 ulp before its bf16 rounding, and a training run then takes
// another path: after five ResidualViT-B/16 steps the gate gradients'
// agreement with the plain versions (chip_smoke.py phase 13) fell outside
// its bound, whichever kernel computed the checked step.
//
// For 256 < N <= 384 the C entry point keeps the earlier kernel
// (attn_bwd_kernel, its code and bits unchanged): one block of 8 warps per
// (head, image) holds the head's Q, K, V and dA whole in dynamic shared
// memory (N padded to a multiple of 16, zero-filled, by cp.async).
//   Phase A, by query rows (16 per warp task): pass 1 takes each row's
//   max and sum (online), pass 2 the row term rowsum(dS * S) over all
//   keys, pass 3 forms bf16(dZ * scale) and accumulates dQ in registers.
//   The rows' max, sum and row term go to shared memory.
//   Phase B, by keys (16 per warp task): S^T and dS^T are recomputed
//   as K . Q^T and V . dA^T with the stored row statistics, and dK and
//   dV accumulate in registers over every query of the image.
// The row term needs whole query rows, which phase A has; dK and dV sum
// over all queries, which phase B has; so neither needs atomics or a
// second launch. Keys past N are masked (S = 0); query rows past N have
// zero dA and are masked in phase B, so they add nothing to dK or dV.
//
// Every other shape takes the key-tiled pair (a template on the head dim,
// 32 or 64): head dim 32 at any N (ViT-Ti at 160 px: 401 tokens) and head
// dim 64 past 384 (ResidualViT at 160 px: 402). Two launches, no atomics,
// so every run gives the same bits. Each is a CTA of 512 threads: three
// consumer warpgroups of 64 rows and a producer warpgroup whose first
// thread (or warp) streams 64-row stages by TMA (3-D tensor maps over
// (column, token, image); 128-byte swizzle at head dim 64, 64-byte at 32)
// through a ring of four slots,
// each with a `full` and an `empty` mbarrier, so the three warpgroups
// share every stage and nothing waits on a CTA-wide barrier. The producer
// warpgroup gives back registers by setmaxnreg (32 a thread) and the
// consumers take them (160), which holds the products, the statistics and
// the operands of a stage without a spill at 12 consumer warps an SM (one
// CTA an SM; with a producer warp and two consumer warpgroups, 8):
//   attn_tiled_bwd_q_kernel, grid (three 64-row query tiles, head,
//   image): Q and dA resident (register A operands), K and V streamed in
//   two sweeps of 64-key stages. Sweep 1: S = Q K^T and dS = dA V^T by
//   wgmma; the online row max, sum and D numerator sum(e * dS), the last
//   two rescaled together as the max grows; then D = numerator * (1 /
//   sum).
//   Sweep 2: S and dS again, P and bf16(P * (dS - D) * scale) as the
//   register A operand of dQ += dZ K (K MN-major), which completes under
//   the next stage's wait. It stores dQ and each row's -max * scale *
//   log2(e), 1 / sum and D, fp32, in the (3, B, H, N) workspace the
//   wrapper allocates.
//   attn_tiled_bwd_kv_kernel, grid (three 64-row key tiles, head, image):
//   K and V resident (register A operands at head dim 32; at 64 read from
//   their tiles, which keeps the kernel free of spills), Q and dA streamed
//   in 64-query stages beside their rows' statistics (copied into the slot
//   by the producer's first warp). S^T = K Q^T and dS^T = V dA^T; bf16(P^T)
//   and bf16(dZ^T * scale) the register A operands of dV += P^T dA and dK
//   += dZ^T Q (dA and Q MN-major). dK and dV sum over the stages in order.
// So S is computed three times and dS three times, with dQ, dK and dV
// nine products a logit (the contract needs five), and three
// exponentials a logit.
// Numerics decisions (stated also in PERF.md): P is ex2(logit * scale
// log2(e) - max * scale log2(e)) * (1 / sum), the same operations in both
// launches (ex2 the SFU's exp2 alone, exp2f's result wherever that is a
// normal float, a term below 2^-126 flushed to 0; one IEEE reciprocal a
// row); D is taken online, sum(e dS) rescaled with the sum and divided by
// it once (an fp32 reassociation of rowsum(dS * P): within a few ulps).
// Keys past N have logit -inf in launch 1 (the last stage only); queries
// past N get -max 0, 1 / sum 0 and D 0 in launch 2, and their Q and dA
// rows load as zeros, so their P and dZ are 0. 116-119 KB of shared
// memory at head dim 64 (58-61 at 32): one CTA an SM.
// Bound at ResidualViT bs128 (N = 402, head dim 64, 4 heads): ~184 MB
// (0.055 ms) against ~5.3e10 flops (0.054 ms); at ViT-Ti bs128 (N = 401,
// head dim 32, 8 heads) the three exponentials a logit take 0.118 ms at the
// SFU's rate.
//
// The choice between the three is by shape (peekvit_attn_softmax_bwd_route),
// never a fallback on error.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int HD = 64;          // head dim the kernel is built for
constexpr int CH = 16;          // keys (phase A) or queries (phase B) per chunk
constexpr int STRIDE = HD + 8;  // padded smem row (bf16 elements)
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_SMEM = 232448;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// A-operand fragments of 16 rows x 64 (head dim) starting at row r0.
__device__ __forceinline__ void load_a_rows(uint32_t (*f)[4], const __nv_bfloat16* s, int r0,
                                            int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int r = r0 + (lane & 7) + ((lane >> 3) & 1) * 8;
    const int c = kk * 16 + (lane >> 4) * 8;
    ldmatrix_x4(f[kk], &s[r * STRIDE + c]);
  }
}

// acc (16 x 16) = A (16 x 64) . B^T, B's 16 rows (the n dimension) from
// row r0 of the (rows x 64) smem matrix s.
__device__ __forceinline__ void product_nt(float (*acc)[4], uint32_t (*a)[4],
                                           const __nv_bfloat16* s, int r0, int lane) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t f[4];
    const int r = r0 + (lane & 7) + (lane >> 4) * 8;
    const int c = kk * 16 + ((lane >> 3) & 1) * 8;
    ldmatrix_x4(f, &s[r * STRIDE + c]);
    mma_bf16(acc[0], a[kk], f[0], f[1]);
    mma_bf16(acc[1], a[kk], f[2], f[3]);
  }
}

// acc (16 x 64) += P (16 x 16, A fragment) . B, B's 16 rows (the k
// dimension) from row r0 of the (rows x 64) smem matrix s.
__device__ __forceinline__ void product_nn(float (*acc)[4], const uint32_t* p,
                                           const __nv_bfloat16* s, int r0, int lane) {
#pragma unroll
  for (int jn = 0; jn < 4; ++jn) {
    uint32_t f[4];
    const int r = r0 + (lane & 7) + ((lane >> 3) & 1) * 8;
    const int c = jn * 16 + (lane >> 4) * 8;
    ldmatrix_x4_trans(f, &s[r * STRIDE + c]);
    mma_bf16(acc[2 * jn], p, f[0], f[1]);
    mma_bf16(acc[2 * jn + 1], p, f[2], f[3]);
  }
}

// The 16 x 16 accumulator tile x as the A fragment of a bf16 product.
__device__ __forceinline__ void to_a_frag(uint32_t* a, float (*x)[4]) {
  a[0] = pack_bf16(x[0][0], x[0][1]);
  a[1] = pack_bf16(x[0][2], x[0][3]);
  a[2] = pack_bf16(x[1][0], x[1][1]);
  a[3] = pack_bf16(x[1][2], x[1][3]);
}

__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, float (*acc)[4], int r0, int n,
                                           long long row_stride, int lane) {
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = j * 8 + tq * 2;
    if (r0 + g < n)
      *reinterpret_cast<__nv_bfloat162*>(dst + (long long)(r0 + g) * row_stride + c) =
          __floats2bfloat162_rn(acc[j][0], acc[j][1]);
    if (r0 + g + 8 < n)
      *reinterpret_cast<__nv_bfloat162*>(dst + (long long)(r0 + g + 8) * row_stride + c) =
          __floats2bfloat162_rn(acc[j][2], acc[j][3]);
  }
}

__global__ void __launch_bounds__(THREADS)
attn_bwd_kernel(const __nv_bfloat16* __restrict__ qkv, const __nv_bfloat16* __restrict__ dattn,
                __nv_bfloat16* __restrict__ dqkv, int n, int d, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nch = (n + CH - 1) / CH;
  const int npad = nch * CH;
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sk = sq + npad * STRIDE;
  __nv_bfloat16* sv = sk + npad * STRIDE;
  __nv_bfloat16* sda = sv + npad * STRIDE;
  float* s_max = reinterpret_cast<float*>(sda + npad * STRIDE);
  float* s_sum = s_max + npad;
  float* s_row = s_sum + npad;

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const long long row3 = 3LL * d;
  const __nv_bfloat16* base = qkv + (long long)b * n * row3 + h * HD;
  const __nv_bfloat16* dbase = dattn + (long long)b * n * d + h * HD;

  for (int chunk = tid; chunk < npad * 8; chunk += THREADS) {
    const int r = chunk >> 3, c = (chunk & 7) * 8;
    const int ok = r < n;
    const __nv_bfloat16* src = base + (long long)(ok ? r : 0) * row3 + c;
    cp_async16(&sq[r * STRIDE + c], src, ok ? 16 : 0);
    cp_async16(&sk[r * STRIDE + c], src + d, ok ? 16 : 0);
    cp_async16(&sv[r * STRIDE + c], src + 2 * d, ok ? 16 : 0);
    cp_async16(&sda[r * STRIDE + c], dbase + (long long)(ok ? r : 0) * d + c, ok ? 16 : 0);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  __nv_bfloat16* out = dqkv + (long long)b * n * row3 + h * HD;

  // ---------------------------------------------- phase A: by query rows
  for (int qc = warp; qc < nch; qc += WARPS) {
    const int q0 = qc * CH;
    uint32_t qf[4][4], daf[4][4];
    load_a_rows(qf, sq, q0, lane);
    load_a_rows(daf, sda, q0, lane);
    float s[2][4], ds[2][4];

    // pass 1: row max and sum (rows g, g + 8)
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    for (int kc = 0; kc < nch; ++kc) {
      product_nt(s, qf, sk, kc * CH, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = kc * CH + j * 8 + tq * 2;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = (key + (e & 1) < n) ? s[j][e] * scale : -INFINITY;
      }
      const float n0 = fmaxf(m0, quad_max(fmaxf(fmaxf(s[0][0], s[0][1]), fmaxf(s[1][0], s[1][1]))));
      const float n1 = fmaxf(m1, quad_max(fmaxf(fmaxf(s[0][2], s[0][3]), fmaxf(s[1][2], s[1][3]))));
      l0 = l0 * expf(m0 - n0) + expf(s[0][0] - n0) + expf(s[0][1] - n0) +
           expf(s[1][0] - n0) + expf(s[1][1] - n0);
      l1 = l1 * expf(m1 - n1) + expf(s[0][2] - n1) + expf(s[0][3] - n1) +
           expf(s[1][2] - n1) + expf(s[1][3] - n1);
      m0 = n0;
      m1 = n1;
    }
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);

    // S (fp32) of chunk kc into s, dS into ds.
    auto probs = [&](int kc) {
      product_nt(s, qf, sk, kc * CH, lane);
      product_nt(ds, daf, sv, kc * CH, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = kc * CH + j * 8 + tq * 2;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float m = e < 2 ? m0 : m1, l = e < 2 ? l0 : l1;
          s[j][e] = (key + (e & 1) < n) ? expf(s[j][e] * scale - m) / l : 0.f;
        }
      }
    };

    // pass 2: the row term rowsum(dS * S)
    float r0 = 0.f, r1 = 0.f;
    for (int kc = 0; kc < nch; ++kc) {
      probs(kc);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        r0 += ds[j][0] * s[j][0] + ds[j][1] * s[j][1];
        r1 += ds[j][2] * s[j][2] + ds[j][3] * s[j][3];
      }
    }
    r0 = quad_sum(r0);
    r1 = quad_sum(r1);

    // pass 3: dQ += bf16(dZ * scale) . K
    float dq[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;
    for (int kc = 0; kc < nch; ++kc) {
      probs(kc);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = s[j][e] * (ds[j][e] - (e < 2 ? r0 : r1)) * scale;
      uint32_t za[4];
      to_a_frag(za, s);
      product_nn(dq, za, sk, kc * CH, lane);
    }
    store_rows(out, dq, q0, n, row3, lane);
    if (tq == 0) {
      s_max[q0 + g] = m0;
      s_sum[q0 + g] = l0;
      s_row[q0 + g] = r0;
      s_max[q0 + g + 8] = m1;
      s_sum[q0 + g + 8] = l1;
      s_row[q0 + g + 8] = r1;
    }
  }
  __syncthreads();

  // ---------------------------------------------------- phase B: by keys
  for (int kc = warp; kc < nch; kc += WARPS) {
    const int k0 = kc * CH;
    uint32_t kf[4][4], vf[4][4];
    load_a_rows(kf, sk, k0, lane);
    load_a_rows(vf, sv, k0, lane);
    float dk[8][4], dv[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dk[j][e] = 0.f;
        dv[j][e] = 0.f;
      }
    for (int qc = 0; qc < nch; ++qc) {
      float st[2][4], dst[2][4];
      product_nt(st, kf, sq, qc * CH, lane);   // S^T: keys x queries
      product_nt(dst, vf, sda, qc * CH, lane);  // dS^T
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = qc * CH + j * 8 + tq * 2 + (e & 1);
          float p = 0.f, z = 0.f;
          if (q < n) {
            p = expf(st[j][e] * scale - s_max[q]) / s_sum[q];
            z = p * (dst[j][e] - s_row[q]) * scale;
          }
          st[j][e] = p;
          dst[j][e] = z;
        }
      }
      uint32_t pa[4], za[4];
      to_a_frag(pa, st);
      to_a_frag(za, dst);
      product_nn(dv, pa, sda, qc * CH, lane);
      product_nn(dk, za, sq, qc * CH, lane);
    }
    store_rows(out + d, dk, k0, n, row3, lane);
    store_rows(out + 2 * d, dv, k0, n, row3, lane);
  }
}

// ------------------------------------------------------- the wgmma kernel

constexpr int WG_MAX_KEYS = 256;
// 16-key chunks per batch of wgmma before a wait in phase A's D pass and
// dQ pass (fewer there: it also holds dQ's accumulators). The largest row
// of P, at 15 and 16 chunks, leaves registers for smaller batches only:
// these are the largest that ptxas compiles without a spill at each NT.
template <int NT>
struct Batch {
  static constexpr int D = NT >= 15 ? 2 : 4;
  static constexpr int Q = NT >= 15 ? 1 : 2;
};
constexpr int GRP_B = 4;  // phase B: 16-query chunks per batch

// Bit (r & 1) | ((r >> 2) << 1) of a 16-column chunk: the column of
// accumulator register r of wgmma m64n16 (r = 0, 1: row g, columns 2t,
// 2t + 1; r = 2, 3: row g + 8, the same columns; r = 4..7: columns 8 + 2t,
// 9 + 2t).
__device__ __forceinline__ int col_bit(int r) { return (r & 1) | ((r >> 2) << 1); }

// wgmma with each descriptor given as a base descriptor and an offset in
// 16-byte units, added inside the asm right at the instruction: built
// outside, the hundred-odd distinct descriptors of a tile's unrolled
// products were computed ahead of their use, held in general registers and
// spilled. (A descriptor's address field is the byte address / 16, and no
// tile here crosses 2^18 bytes, so adding the offset adds to that field.)
__device__ __forceinline__ void mma_n16_rs(float* d, const uint32_t* a, uint64_t db,
                                           uint64_t off) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 bd;\nsetp.ne.b32 p, %14, 0;\nadd.s64 bd, %12, %13;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, bd, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "l"(off), "r"(1));
}

__device__ __forceinline__ void mma_n16_ss(float* d, uint64_t da, uint64_t aoff, uint64_t db,
                                           uint64_t boff) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 ad, bd;\nsetp.ne.b32 p, %12, 0;\n"
      "add.s64 ad, %8, %9;\nadd.s64 bd, %10, %11;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, ad, bd, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(aoff), "l"(db), "l"(boff), "r"(1));
}

__device__ __forceinline__ void mma_n32_ss(float* d, uint64_t da, uint64_t aoff, uint64_t db,
                                           uint64_t boff) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 ad, bd;\nsetp.ne.b32 p, %20, 0;\n"
      "add.s64 ad, %16, %17;\nadd.s64 bd, %18, %19;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, ad, bd, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(aoff), "l"(db), "l"(boff), "r"(1));
}

__device__ __forceinline__ void mma_n64_ss(float* d, uint64_t da, uint64_t aoff, uint64_t db,
                                           uint64_t boff) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 ad, bd;\nsetp.ne.b32 p, %36, 0;\n"
      "add.s64 ad, %32, %33;\nadd.s64 bd, %34, %35;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, ad, bd, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(aoff), "l"(db), "l"(boff), "r"(1));
}

__device__ __forceinline__ void mma_n64_rs(float* d, const uint32_t* a, uint64_t db,
                                           uint64_t off) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 bd;\nsetp.ne.b32 p, %38, 0;\nadd.s64 bd, %36, %37;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, bd, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "l"(off), "r"(1));
}

// B MN-major (a 16-row chunk of a (rows x 64) region read along its rows).
__device__ __forceinline__ void mma_n64_rs_mn(float* d, const uint32_t* a, uint64_t db,
                                              uint64_t off) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 bd;\nsetp.ne.b32 p, %38, 0;\nadd.s64 bd, %36, %37;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, bd, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "l"(off), "r"(1));
}

// Base descriptors of a 128-byte-swizzled region: K-major and MN-major.
__device__ __forceinline__ uint64_t kdesc(uint32_t addr) { return hopper::desc_sw128(addr, 16, 1024); }
__device__ __forceinline__ uint64_t mndesc(uint32_t addr) {
  return hopper::desc_sw128(addr, 1024, 1024);
}

// acc[jj] = A . B^T for the 16-row chunks j0 + jj (< NT) of the K-major
// region of descriptor db, A the 64-row K-major tile at da + aoff (16-byte
// units; the tile's offset added at the instruction, not held): one
// wgmma m64n(16 G) a K step for a whole group (its accumulators are the G
// chunks' m64n16 ones side by side), m64n16 per chunk for a last, partial
// group. Fewer, wider products keep fewer descriptors live.
template <int NT, int G>
__device__ __forceinline__ void chunk_products(float (*acc)[8], uint64_t da, uint32_t aoff,
                                               uint64_t db, int j0) {
#pragma unroll
  for (int jj = 0; jj < G; ++jj)
#pragma unroll
    for (int r = 0; r < 8; ++r) acc[jj][r] = 0.f;
#pragma unroll
  for (int jj = 0; jj < G; ++jj) hopper::fence_regs<8>(acc[jj]);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (j0 + G <= NT) {
      if constexpr (G == 4)
        mma_n64_ss(acc[0], da, aoff + kk * 2, db, j0 * 128 + kk * 2);
      else if constexpr (G == 2)
        mma_n32_ss(acc[0], da, aoff + kk * 2, db, j0 * 128 + kk * 2);
      else
        mma_n16_ss(acc[0], da, aoff + kk * 2, db, j0 * 128 + kk * 2);
    } else {
#pragma unroll
      for (int jj = 0; jj < G; ++jj)
        if (j0 + jj < NT)
          mma_n16_ss(acc[jj], da, aoff + kk * 2, db, (j0 + jj) * 128 + kk * 2);
    }
  }
}

__device__ __forceinline__ void pack_a(uint32_t* a, const float* x) {
  a[0] = pack_bf16(x[0], x[1]);
  a[1] = pack_bf16(x[2], x[3]);
  a[2] = pack_bf16(x[4], x[5]);
  a[3] = pack_bf16(x[6], x[7]);
}

// 64 x 64 fp32 accumulator tile (m64n64 layout) of rows r0.. into the
// packed output at dst (row stride `stride`), rows past n skipped.
__device__ __forceinline__ void store_tile(__nv_bfloat16* dst, const float* acc, int r0, int n,
                                           long long stride, int t4) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (r0 < n)
      *reinterpret_cast<__nv_bfloat162*>(dst + (long long)r0 * stride + 8 * j + 2 * t4) =
          __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
    if (r0 + 8 < n)
      *reinterpret_cast<__nv_bfloat162*>(dst + (long long)(r0 + 8) * stride + 8 * j + 2 * t4) =
          __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// The columns `col` (0, d or 2d: dQ, dK, dV) of this CTA's head in the
// packed dqkv, computed where they are stored (the block indices read
// anew): a pointer kept from the prologue was spilled across the products.
__device__ __forceinline__ __nv_bfloat16* head_out(__nv_bfloat16* dqkv, int n, int d, int col) {
  uint32_t h, b;
  asm volatile("mov.u32 %0, %%ctaid.x;\n" : "=r"(h));
  asm volatile("mov.u32 %0, %%ctaid.y;\n" : "=r"(b));
  return dqkv + (long long)b * n * (3 * d) + h * HD + col;
}

// Shared memory of the NT instance: dA, K, V, Q (16 NT rows each, in that
// order: a 64-row dA, K or V tile read past its 16 NT rows reads the next
// region, and its rows past n are never stored), the row statistics and
// two mbarriers; at NT = 1 the V tile reaches past them, so the
// allocation covers it.
template <int NT>
constexpr int wgmma_smem() {
  constexpr int region = NT * 16 * 128, tiles = (NT + 3) / 4;
  constexpr int regions = 4 * region + 3 * 256 * 4 + 16, reach = 2 * region + tiles * 64 * 128;
  return 1024 + (regions > reach ? regions : reach);
}

template <int NT>
__global__ void __launch_bounds__(128, 2)
attn_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap qkvmap,
                      const __grid_constant__ CUtensorMap damap, __nv_bfloat16* __restrict__ dqkv,
                      int n, int d, float scale) {
  constexpr int REGION = NT * 16 * 128;  // 16 NT rows of 64 bf16, swizzled
  constexpr int GRP_D = Batch<NT>::D, GRP_Q = Batch<NT>::Q;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  float* s_max = reinterpret_cast<float*>(smem_raw + (base + 4 * REGION - raw));  // scaled max
  float* s_sum = s_max + 256;                                                     // row sum
  float* s_dd = s_sum + 256;                                                      // rowsum(dS * P)
  const uint32_t bars = base + 4 * REGION + 3 * 256 * 4;

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;

  if (tid == 0) {
    hopper::mbar_init(bars, 1);
    hopper::mbar_init(bars + 8, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    const uint32_t sda = base, sk = base + REGION, sv = sk + REGION, sq = sv + REGION;
    hopper::mbar_expect_tx(bars, 2 * REGION);
    hopper::tma_load_3d(sq, &qkvmap, h * HD, 0, b, bars);
    hopper::tma_load_3d(sk, &qkvmap, d + h * HD, 0, b, bars);
    hopper::mbar_expect_tx(bars + 8, 2 * REGION);
    hopper::tma_load_3d(sv, &qkvmap, 2 * d + h * HD, 0, b, bars + 8);
    hopper::tma_load_3d(sda, &damap, h * HD, 0, b, bars + 8);
  }

  // Which of the thread's four columns of the last 16-column chunk (keys
  // in phase A, queries in phase B) lie below n, bit col_bit(r): every
  // earlier chunk lies below n whole (NT = ceil(n / 16)). The empty asm
  // hides the bits' origin, so the compiler reads them from this register
  // instead of keeping the comparisons alive through both phases.
  uint32_t last_ok = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    last_ok |= (uint32_t)(16 * (NT - 1) + (e >> 1) * 8 + 2 * t4 + (e & 1) < n) << e;
  asm volatile("" : "+r"(last_ok));

  // ---------------------------------------------- phase A: by query tiles
  for (int t = 0; 64 * t < n; ++t) {
    const uint32_t sda = base, sk = sda + REGION, sv = sk + REGION, sq = sv + REGION;
    hopper::mbar_wait(bars, 0);
    // Q's fragments (register A operand) from the swizzled tile; rows past
    // the 16 NT staged ones read the last (a row past n).
    uint32_t qa[4][4];
    {
      int r = 64 * t + warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
      r = r < 16 * NT - 1 ? r : 16 * NT - 1;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int chunk = 2 * kk + (lane >> 4);
        const uint32_t addr = sq + r * 128 + ((chunk ^ (r & 7)) << 4);
        asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                     : "=r"(qa[kk][0]), "=r"(qa[kk][1]), "=r"(qa[kk][2]), "=r"(qa[kk][3])
                     : "r"(addr));
      }
    }
    float s[NT][8];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 8; ++r) s[j][r] = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) hopper::fence_regs<8>(s[j]);
    hopper::wgmma_fence();
    // four 16-key chunks a wgmma m64n64 (their accumulators side by side),
    // the last NT % 4 chunks one m64n16 each
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int j = 0; j + 4 <= NT; j += 4) mma_n64_rs(s[j], qa[kk], kdesc(sk), j * 128 + kk * 2);
#pragma unroll
      for (int j = NT / 4 * 4; j < NT; ++j) mma_n16_rs(s[j], qa[kk], kdesc(sk), j * 128 + kk * 2);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < NT; ++j) hopper::fence_regs<8>(s[j]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hopper::fence_regs<4>(qa[kk]);

    // P for rows g (registers 0, 1, 4, 5) and g + 8 (2, 3, 6, 7), with the
    // earlier kernel's operations in its order: per 16-key chunk, the
    // scaled logits' running max and the sum of exp(x - max), rescaled as
    // the max grows; then P = exp(logit * scale - max) / sum.
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float x[8];
#pragma unroll
      for (int r = 0; r < 8; ++r)
        x[r] = j < NT - 1 || (last_ok >> col_bit(r)) & 1 ? s[j][r] * scale : -INFINITY;
      const float n0 = fmaxf(m0, quad_max(fmaxf(fmaxf(x[0], x[1]), fmaxf(x[4], x[5]))));
      const float n1 = fmaxf(m1, quad_max(fmaxf(fmaxf(x[2], x[3]), fmaxf(x[6], x[7]))));
      l0 = l0 * expf(m0 - n0) + expf(x[0] - n0) + expf(x[1] - n0) + expf(x[4] - n0) +
           expf(x[5] - n0);
      l1 = l1 * expf(m1 - n1) + expf(x[2] - n1) + expf(x[3] - n1) + expf(x[6] - n1) +
           expf(x[7] - n1);
      m0 = n0;
      m1 = n1;
    }
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const bool hi = (r >> 1) & 1;
        s[j][r] = j < NT - 1 || (last_ok >> col_bit(r)) & 1
                      ? expf(s[j][r] * scale - (hi ? m1 : m0)) / (hi ? l1 : l0)
                      : 0.f;
      }

    if (t == 0) hopper::mbar_wait(bars + 8, 0);
    const uint32_t aoff = t * 64 * 128 / 16;  // the 64-row tiles of dA (here), K and V (phase B)

    // D = rowsum(dS * P)
    float d0 = 0.f, d1 = 0.f;
    float ds[GRP_D][8];
#pragma unroll
    for (int j0 = 0; j0 < NT; j0 += GRP_D) {
      chunk_products<NT, GRP_D>(ds, kdesc(sda), aoff, kdesc(sv), j0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int jj = 0; jj < GRP_D; ++jj) hopper::fence_regs<8>(ds[jj]);
#pragma unroll
      for (int jj = 0; jj < GRP_D; ++jj) {
        if (j0 + jj >= NT) continue;
        const float* p = s[j0 + jj];
        const float* x = ds[jj];
        d0 += x[0] * p[0] + x[1] * p[1];
        d1 += x[2] * p[2] + x[3] * p[3];
        d0 += x[4] * p[4] + x[5] * p[5];
        d1 += x[6] * p[6] + x[7] * p[7];
      }
    }
    d0 = quad_sum(d0);
    d1 = quad_sum(d1);

    // dQ += bf16(P * (dS - D) * scale) . K
    float dq[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[i] = 0.f;
    float dsq[GRP_Q][8];
    uint32_t za[GRP_Q][4] = {};
#pragma unroll
    for (int j0 = 0; j0 < NT; j0 += GRP_Q) {
      hopper::fence_regs<32>(dq);
      chunk_products<NT, GRP_Q>(dsq, kdesc(sda), aoff, kdesc(sv), j0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int jj = 0; jj < GRP_Q; ++jj) {
        hopper::fence_regs<8>(dsq[jj]);
        hopper::fence_regs<4>(za[jj]);
      }
      hopper::fence_regs<32>(dq);
#pragma unroll
      for (int jj = 0; jj < GRP_Q; ++jj) {
        if (j0 + jj >= NT) continue;
        float z[8];
#pragma unroll
        for (int r = 0; r < 8; ++r)
          z[r] = s[j0 + jj][r] * (dsq[jj][r] - ((r >> 1) & 1 ? d1 : d0)) * scale;
        pack_a(za[jj], z);
      }
#pragma unroll
      for (int jj = 0; jj < GRP_Q; ++jj) hopper::fence_regs<4>(za[jj]);
      hopper::wgmma_fence();
#pragma unroll
      for (int jj = 0; jj < GRP_Q; ++jj)
        if (j0 + jj < NT)
          mma_n64_rs_mn(dq, za[jj], mndesc(sk), (j0 + jj) * 128);
      hopper::wgmma_commit();
      hopper::fence_regs<32>(dq);
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs<32>(dq);
#pragma unroll
    for (int jj = 0; jj < GRP_Q; ++jj) hopper::fence_regs<4>(za[jj]);

    const int r0 = 64 * t + 16 * warp + g;
    store_tile(head_out(dqkv, n, d, 0), dq, r0, n, 3LL * d, t4);
    if (t4 == 0) {
      s_max[r0] = m0;
      s_sum[r0] = l0;
      s_dd[r0] = d0;
      s_max[r0 + 8] = m1;
      s_sum[r0 + 8] = l1;
      s_dd[r0 + 8] = d1;
    }
  }
  __syncthreads();

  // ---------------------------------------------------- phase B: by key tiles
  for (int t = 0; 64 * t < n; ++t) {
    const uint32_t sda = base, sk = sda + REGION, sv = sk + REGION, sq = sv + REGION;
    float dk[32], dv[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      dk[i] = 0.f;
      dv[i] = 0.f;
    }
    float st[GRP_B][8], dst[GRP_B][8];
    uint32_t pa[GRP_B][4] = {}, za[GRP_B][4] = {};
#pragma unroll
    for (int j0 = 0; j0 < NT; j0 += GRP_B) {
      hopper::fence_regs<32>(dk);
      hopper::fence_regs<32>(dv);
      const uint32_t aoff = t * 64 * 128 / 16;
      chunk_products<NT, GRP_B>(st, kdesc(sk), aoff, kdesc(sq), j0);    // S^T: keys x queries
      chunk_products<NT, GRP_B>(dst, kdesc(sv), aoff, kdesc(sda), j0);  // dS^T
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int jj = 0; jj < GRP_B; ++jj) {
        hopper::fence_regs<8>(st[jj]);
        hopper::fence_regs<8>(dst[jj]);
        hopper::fence_regs<4>(pa[jj]);
        hopper::fence_regs<4>(za[jj]);
      }
      hopper::fence_regs<32>(dk);
      hopper::fence_regs<32>(dv);
#pragma unroll
      for (int jj = 0; jj < GRP_B; ++jj) {
        const int jc = j0 + jj;
        if (jc >= NT) continue;
        // the statistics of the thread's query columns 16 jc + 2 t4 (+1) and
        // 16 jc + 8 + 2 t4 (+1)
        const float2 mc[2] = {*reinterpret_cast<const float2*>(s_max + 16 * jc + 2 * t4),
                              *reinterpret_cast<const float2*>(s_max + 16 * jc + 8 + 2 * t4)};
        const float2 sm[2] = {*reinterpret_cast<const float2*>(s_sum + 16 * jc + 2 * t4),
                              *reinterpret_cast<const float2*>(s_sum + 16 * jc + 8 + 2 * t4)};
        const float2 dd[2] = {*reinterpret_cast<const float2*>(s_dd + 16 * jc + 2 * t4),
                              *reinterpret_cast<const float2*>(s_dd + 16 * jc + 8 + 2 * t4)};
        float p[8], z[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int half = r >> 2, e = r & 1;
          const float m = e ? mc[half].y : mc[half].x;
          const float l = e ? sm[half].y : sm[half].x;
          const float dsum = e ? dd[half].y : dd[half].x;
          const bool ok = jc < NT - 1 || (last_ok >> col_bit(r)) & 1;
          p[r] = ok ? expf(st[jj][r] * scale - m) / l : 0.f;
          z[r] = ok ? p[r] * (dst[jj][r] - dsum) * scale : 0.f;
        }
        pack_a(pa[jj], p);
        pack_a(za[jj], z);
      }
#pragma unroll
      for (int jj = 0; jj < GRP_B; ++jj) {
        hopper::fence_regs<4>(pa[jj]);
        hopper::fence_regs<4>(za[jj]);
      }
      hopper::wgmma_fence();
#pragma unroll
      for (int jj = 0; jj < GRP_B; ++jj) {
        if (j0 + jj >= NT) continue;
        mma_n64_rs_mn(dv, pa[jj], mndesc(sda), (j0 + jj) * 128);
        mma_n64_rs_mn(dk, za[jj], mndesc(sq), (j0 + jj) * 128);
      }
      hopper::wgmma_commit();
      hopper::fence_regs<32>(dk);
      hopper::fence_regs<32>(dv);
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs<32>(dk);
    hopper::fence_regs<32>(dv);
#pragma unroll
    for (int jj = 0; jj < GRP_B; ++jj) {
      hopper::fence_regs<4>(pa[jj]);
      hopper::fence_regs<4>(za[jj]);
    }
    const int r0 = 64 * t + 16 * warp + g;
    store_tile(head_out(dqkv, n, d, d), dk, r0, n, 3LL * d, t4);
    store_tile(head_out(dqkv, n, d, 2 * d), dv, r0, n, 3LL * d, t4);
  }
}

template <int NT>
int launch_wgmma(const CUtensorMap& qm, const CUtensorMap& dm, __nv_bfloat16* dqkv, int b, int n,
                 int d, int heads, float scale, cudaStream_t stream) {
  constexpr int smem = wgmma_smem<NT>();
  auto kernel = attn_bwd_wgmma_kernel<NT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(heads, b);
  kernel<<<grid, 128, smem, stream>>>(qm, dm, dqkv, n, d, scale);
  return (int)cudaGetLastError();
}

// --------------------------------------------------- the key-tiled kernels

constexpr int KEPT_MAX_TOKENS = 384;  // the kernel above: Q, K, V, dA whole in shared memory
constexpr int TL = 64;                // rows of a warpgroup's tile and of a streamed stage
constexpr int TL_STAGES = 4;          // stages of the ring
constexpr int TL_NWG = 3;             // consumer warpgroups of 64 rows
constexpr int TL_CONSUMERS = 128 * TL_NWG;
constexpr int TL_THREADS = TL_CONSUMERS + 128;  // and the producer warpgroup
// Registers a thread after setmaxnreg: the producer gives back what the
// consumers take (128 a thread at launch: 128 * 32 + 384 * 160 = 65,536).
constexpr int PRODUCER_REGS = 32, CONSUMER_REGS = 160;

template <int HD>
__host__ __device__ constexpr int tile_bytes() {
  return TL * 2 * HD;  // one 64-row tile (TMA's box {HD, 64})
}
// Dynamic shared memory: each warpgroup's two resident tiles (Q and dA in
// launch 1, K and V in launch 2), the ring of two tiles a stage (K and V;
// Q and dA) and, in launch 2, each stage's 64 rows of statistics; the
// mbarriers.
template <int HD>
constexpr int tiled_smem(bool stats) {
  return 1024 + (2 * TL_NWG + 2 * TL_STAGES) * tile_bytes<HD>() +
         (stats ? TL_STAGES * 3 * TL * 4 : 0) + (2 * TL_STAGES + 1) * 8;
}

// acc (m64n64 accumulators) += A B^T for a warpgroup's 64 rows of A and the
// 64 rows of a K-major stage tile: A as register fragments (a), or
// (A_SMEM) read from its K-major tile at a_tile.
template <int HD, bool A_SMEM>
__device__ __forceinline__ void tile_nt(float* acc, uint32_t (*a)[4], uint32_t a_tile,
                                        uint32_t tile) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    if constexpr (A_SMEM)
      hopper::wgmma_m64n64k16_ss<0, 0>(acc, hopper::desc_kmajor<HD>(a_tile + kk * 32),
                                       hopper::desc_kmajor<HD>(tile + kk * 32));
    else
      hopper::wgmma_m64n64k16_rs<0>(acc, a[kk], hopper::desc_kmajor<HD>(tile + kk * 32));
  }
}
__device__ __forceinline__ void zero32(float* a) {
#pragma unroll
  for (int r = 0; r < 32; ++r) a[r] = 0.f;
  hopper::fence_regs<32>(a);
}
// acc (m64n{HD}) += X . B over a stage's 64 rows: X's four 16-column
// slices as register A operands, B the stage tile read MN-major.
template <int HD>
__device__ __forceinline__ void tile_nn(float* acc, uint32_t (*x)[4], uint32_t tile) {
#pragma unroll
  for (int sl = 0; sl < 4; ++sl)
    hopper::wgmma_m64nhd_rs_mn<HD>(acc, x[sl], hopper::desc_mnmajor<HD>(tile + sl * 16 * 2 * HD));
}
__device__ __forceinline__ void fence_frags(uint32_t (*x)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) hopper::fence_regs<4>(x[j]);
}
// Accumulator rows g and g + 8 of the warp's 16, columns 8 j + 2 t4 + e,
// as the m64n{HD} tile's rows r0, r0 + 8 of the packed output at dst.
template <int HD>
__device__ __forceinline__ void store_rows64(__nv_bfloat16* dst, const float* acc, int r0, int n,
                                             long long stride, int t4) {
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    if (r0 < n)
      *reinterpret_cast<__nv_bfloat162*>(dst + (long long)r0 * stride + 8 * j + 2 * t4) =
          __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
    if (r0 + 8 < n)
      *reinterpret_cast<__nv_bfloat162*>(dst + (long long)(r0 + 8) * stride + 8 * j + 2 * t4) =
          __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// Launch 1, grid (three 64-row query tiles, head, image), 512 threads:
// three consumer warpgroups of 64 query rows and a producer warpgroup. The
// producer's first thread loads the warpgroups' Q and dA tiles onto one
// mbarrier and then streams K and V, two sweeps of 64-key stages, through
// a ring of TL_STAGES slots by TMA (full / empty mbarriers; a slot is
// refilled once every consumer warp has arrived on its empty barrier after
// the wgmma that read it completed). Sweep 1: S = Q K^T and dS = dA V^T,
// the online row max, sum and D numerator sum(e dS), rescaled together.
// Sweep 2: S and dS again, P and bf16(dZ * scale) as the register A
// operand of dQ += dZ K (K MN-major); that product completes under the next
// stage's wait and releases its slot then. Writes dQ and each row's
// statistics (ws: -max * scale log2 e, 1 / sum, D; fp32, (b, heads, n)
// each at ws, ws + bhn, ws + 2 bhn).
template <int HD>
__global__ void __launch_bounds__(TL_THREADS, 1)
attn_tiled_bwd_q_kernel(const __grid_constant__ CUtensorMap qkvmap,
                        const __grid_constant__ CUtensorMap damap,
                        __nv_bfloat16* __restrict__ dqkv, float* __restrict__ ws, int n, int d,
                        float scale_log2e, float scale) {
  constexpr int TB = tile_bytes<HD>();
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t sq = (raw + 1023) & ~1023u;  // Q tiles, then dA tiles
  const uint32_t sda = sq + TL_NWG * TB;
  const uint32_t sk = sda + TL_NWG * TB;  // the ring: K, then V
  const uint32_t sv = sk + TL_STAGES * TB;
  const uint32_t full = sv + TL_STAGES * TB, empty = full + 8 * TL_STAGES;
  const uint32_t qbar = empty + 8 * TL_STAGES;

  const int q0 = blockIdx.x * TL_NWG * TL, h = blockIdx.y, b = blockIdx.z;
  const int left = (n - q0 + TL - 1) / TL, nwg = left < TL_NWG ? left : TL_NWG;
  const int ns = (n + TL - 1) / TL;
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid == 0) {
    for (int i = 0; i < TL_STAGES; ++i) {
      hopper::mbar_init(full + 8 * i, 1);
      hopper::mbar_init(empty + 8 * i, 4 * nwg);
    }
    hopper::mbar_init(qbar, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= TL_CONSUMERS) {  // the producer warpgroup
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    if (tid == TL_CONSUMERS) {
      hopper::mbar_expect_tx(qbar, 2 * nwg * TB);
      for (int w = 0; w < nwg; ++w) {
        hopper::tma_load_3d(sq + w * TB, &qkvmap, h * HD, q0 + TL * w, b, qbar);
        hopper::tma_load_3d(sda + w * TB, &damap, h * HD, q0 + TL * w, b, qbar);
      }
      for (int it = 0; it < 2 * ns; ++it) {
        const int slot = it % TL_STAGES, c = it < ns ? it : it - ns;
        if (it >= TL_STAGES) hopper::mbar_wait(empty + 8 * slot, (it / TL_STAGES - 1) & 1);
        const uint32_t bar = full + 8 * slot;
        hopper::mbar_expect_tx(bar, 2 * TB);
        hopper::tma_load_3d(sk + slot * TB, &qkvmap, d + h * HD, c * TL, b, bar);
        hopper::tma_load_3d(sv + slot * TB, &qkvmap, 2 * d + h * HD, c * TL, b, bar);
      }
    }
    return;
  }

  hopper::setmaxnreg_inc<CONSUMER_REGS>();
  const int w = tid >> 7, warp = (tid >> 5) & 3, g = lane >> 2, t4 = lane & 3;
  if (w >= nwg) return;
  hopper::mbar_wait(qbar, 0);
  uint32_t qa[HD / 16][4], dfa[HD / 16][4];
  hopper::ldmatrix_a<HD>(qa, sq + w * TB, warp * 16, lane);
  hopper::ldmatrix_a<HD>(dfa, sda + w * TB, warp * 16, lane);
  // keys of the last stage at or past n: the thread's columns 8 j + 2 t4 + e
  const int lim = n - (ns - 1) * TL - 2 * t4;
  auto past_n = [&](int r) { return 8 * (r >> 2) + (r & 1) >= lim; };

  // Sweep 1, rows g (registers 4 j + e) and g + 8 (4 j + 2 + e).
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, u0 = 0.f, u1 = 0.f;
  float s[32], ds[32];
  for (int c = 0; c < ns; ++c) {
    const int slot = c % TL_STAGES;
    hopper::mbar_wait(full + 8 * slot, (c / TL_STAGES) & 1);
    zero32(s);
    zero32(ds);
    hopper::wgmma_fence();
    tile_nt<HD, false>(s, qa, 0, sk + slot * TB);
    tile_nt<HD, false>(ds, dfa, 0, sv + slot * TB);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs<32>(s);
    hopper::fence_regs<32>(ds);
    if (lane == 0) hopper::mbar_arrive(empty + 8 * slot);
    if (c == ns - 1) {
#pragma unroll
      for (int r = 0; r < 32; ++r)
        if (past_n(r)) s[r] = -INFINITY;
    }
    float c0 = -INFINITY, c1 = -INFINITY;
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      if ((r >> 1) & 1)
        c1 = fmaxf(c1, s[r]);
      else
        c0 = fmaxf(c0, s[r]);
    }
    const float n0 = fmaxf(m0, quad_max(c0)), n1 = fmaxf(m1, quad_max(c1));
    const float b0 = -n0 * scale_log2e, b1 = -n1 * scale_log2e;
    float e0 = 0.f, e1 = 0.f, x0 = 0.f, x1 = 0.f;
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      if ((r >> 1) & 1) {
        const float e = hopper::ex2(fmaf(s[r], scale_log2e, b1));
        e1 += e;
        x1 = fmaf(e, ds[r], x1);
      } else {
        const float e = hopper::ex2(fmaf(s[r], scale_log2e, b0));
        e0 += e;
        x0 = fmaf(e, ds[r], x0);
      }
    }
    const float a0 = hopper::ex2(fmaf(m0, scale_log2e, b0)), a1 = hopper::ex2(fmaf(m1, scale_log2e, b1));
    l0 = fmaf(l0, a0, e0);
    l1 = fmaf(l1, a1, e1);
    u0 = fmaf(u0, a0, x0);
    u1 = fmaf(u1, a1, x1);
    m0 = n0;
    m1 = n1;
  }
  const float i0 = 1.f / quad_sum(l0), i1 = 1.f / quad_sum(l1);
  const float dd0 = quad_sum(u0) * i0, dd1 = quad_sum(u1) * i1;
  const float b0 = -m0 * scale_log2e, b1 = -m1 * scale_log2e;

  // Sweep 2: dQ += bf16(P (dS - D) scale) K.
  float dq[HD / 2];
#pragma unroll
  for (int r = 0; r < HD / 2; ++r) dq[r] = 0.f;
  uint32_t za[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) za[j][e] = 0u;
  int prev = 0;
  for (int c = 0; c < ns; ++c) {
    const int it = ns + c, slot = it % TL_STAGES;
    hopper::mbar_wait(full + 8 * slot, (it / TL_STAGES) & 1);
    zero32(s);
    zero32(ds);
    hopper::wgmma_fence();
    tile_nt<HD, false>(s, qa, 0, sk + slot * TB);
    tile_nt<HD, false>(ds, dfa, 0, sv + slot * TB);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();  // these products, and the previous stage's dQ
    hopper::fence_regs<32>(s);
    hopper::fence_regs<32>(ds);
    hopper::fence_regs<HD / 2>(dq);
    fence_frags(za);
    if (c > 0 && lane == 0) hopper::mbar_arrive(empty + 8 * prev);
    if (c == ns - 1) {  // P = 0 past n
#pragma unroll
      for (int r = 0; r < 32; ++r)
        if (past_n(r)) s[r] = -INFINITY;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float z[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 4 * j + e;
        const bool hi = (e >> 1) & 1;
        const float p = hopper::ex2(fmaf(s[r], scale_log2e, hi ? b1 : b0)) * (hi ? i1 : i0);
        z[e] = p * (ds[r] - (hi ? dd1 : dd0)) * scale;
      }
      za[j >> 1][(j & 1) * 2] = pack_bf16(z[0], z[1]);
      za[j >> 1][(j & 1) * 2 + 1] = pack_bf16(z[2], z[3]);
    }
    fence_frags(za);
    hopper::fence_regs<HD / 2>(dq);
    hopper::wgmma_fence();
    tile_nn<HD>(dq, za, sk + slot * TB);
    hopper::wgmma_commit();
    hopper::fence_regs<HD / 2>(dq);
    prev = slot;
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs<HD / 2>(dq);
  fence_frags(za);

  const int r0 = q0 + TL * w + warp * 16 + g;
  store_rows64<HD>(dqkv + (long long)b * n * 3 * d + h * HD, dq, r0, n, 3LL * d, t4);
  if (t4 == 0) {
    const long long bhn = (long long)gridDim.z * gridDim.y * n;
    float* row = ws + ((long long)b * gridDim.y + h) * n;
    if (r0 < n) {
      row[r0] = b0;
      row[bhn + r0] = i0;
      row[2 * bhn + r0] = dd0;
    }
    if (r0 + 8 < n) {
      row[r0 + 8] = b1;
      row[bhn + r0 + 8] = i1;
      row[2 * bhn + r0 + 8] = dd1;
    }
  }
}

// Launch 2, grid (three 64-row key tiles, head, image), 512 threads: three
// consumer warpgroups of 64 keys and a producer warpgroup. Its first warp
// loads the warpgroups' K and V tiles onto one mbarrier and then streams
// the 64-query stages of Q and dA by TMA through the ring, each beside its
// rows' statistics from launch 1, which the warp's 32 lanes copy into the
// slot (the full barrier takes the TMA bytes and the 32 lanes' arrivals; queries
// past n get -max 0, 1 / sum 0 and D 0, so P and dZ are 0 there). Per
// stage: S^T = K Q^T and dS^T = V dA^T with K and V as register A
// operands; bf16(P^T) and bf16(dZ^T * scale) the register A operands of dV
// += P^T dA and dK += dZ^T Q (dA and Q MN-major). dK and dV sum over the
// stages in order in one warpgroup and are stored. A stage's two products
// complete under the next stage's wait and release its slot then.
template <int HD>
__global__ void __launch_bounds__(TL_THREADS, 1)
attn_tiled_bwd_kv_kernel(const __grid_constant__ CUtensorMap qkvmap,
                         const __grid_constant__ CUtensorMap damap,
                         __nv_bfloat16* __restrict__ dqkv, const float* __restrict__ ws, int n,
                         int d, float scale_log2e, float scale) {
  constexpr int TB = tile_bytes<HD>();
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t skk = (raw + 1023) & ~1023u;  // K tiles, then V tiles
  const uint32_t svv = skk + TL_NWG * TB;
  const uint32_t sq = svv + TL_NWG * TB;  // the ring: Q, then dA
  const uint32_t sda = sq + TL_STAGES * TB;
  const uint32_t sst = sda + TL_STAGES * TB;  // [slot][-max, 1 / sum, D][64]
  float* stats = reinterpret_cast<float*>(smem_raw + (sst - raw));
  const uint32_t full = sst + TL_STAGES * 3 * TL * 4, empty = full + 8 * TL_STAGES;
  const uint32_t kvbar = empty + 8 * TL_STAGES;

  const int k0 = blockIdx.x * TL_NWG * TL, h = blockIdx.y, b = blockIdx.z;
  const int left = (n - k0 + TL - 1) / TL, nwg = left < TL_NWG ? left : TL_NWG;
  const int ns = (n + TL - 1) / TL;
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid == 0) {
    for (int i = 0; i < TL_STAGES; ++i) {
      hopper::mbar_init(full + 8 * i, 1 + 32);
      hopper::mbar_init(empty + 8 * i, 4 * nwg);
    }
    hopper::mbar_init(kvbar, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= TL_CONSUMERS) {  // the producer warpgroup: its first warp
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    if (tid >= TL_CONSUMERS + 32) return;
    if (lane == 0) {
      hopper::mbar_expect_tx(kvbar, 2 * nwg * TB);
      for (int w = 0; w < nwg; ++w) {
        hopper::tma_load_3d(skk + w * TB, &qkvmap, d + h * HD, k0 + TL * w, b, kvbar);
        hopper::tma_load_3d(svv + w * TB, &qkvmap, 2 * d + h * HD, k0 + TL * w, b, kvbar);
      }
    }
    const long long bhn = (long long)gridDim.z * gridDim.y * n;
    const float* wrow = ws + ((long long)b * gridDim.y + h) * n;
    for (int c = 0; c < ns; ++c) {
      const int slot = c % TL_STAGES;
      if (c >= TL_STAGES) hopper::mbar_wait(empty + 8 * slot, (c / TL_STAGES - 1) & 1);
      const uint32_t bar = full + 8 * slot;
      if (lane == 0) {
        hopper::mbar_expect_tx(bar, 2 * TB);
        hopper::tma_load_3d(sq + slot * TB, &qkvmap, h * HD, c * TL, b, bar);
        hopper::tma_load_3d(sda + slot * TB, &damap, h * HD, c * TL, b, bar);
      }
      float* st = stats + slot * 3 * TL;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = lane + 32 * i, qq = c * TL + r;
        const bool ok = qq < n;
        st[r] = ok ? wrow[qq] : 0.f;
        st[TL + r] = ok ? wrow[bhn + qq] : 0.f;
        st[2 * TL + r] = ok ? wrow[2 * bhn + qq] : 0.f;
      }
      hopper::mbar_arrive(bar);
    }
    return;
  }

  hopper::setmaxnreg_inc<CONSUMER_REGS>();
  const int w = tid >> 7, warp = (tid >> 5) & 3, g = lane >> 2, t4 = lane & 3;
  if (w >= nwg) return;
  hopper::mbar_wait(kvbar, 0);
  // K and V as register A operands at head dim 32; at 64 read from their
  // tiles (their 32 registers a thread would spill beside dK, dV, S^T and
  // dS^T)
  uint32_t ka[HD / 16][4], va[HD / 16][4];
  if constexpr (HD == 32) {
    hopper::ldmatrix_a<HD>(ka, skk + w * TB, warp * 16, lane);
    hopper::ldmatrix_a<HD>(va, svv + w * TB, warp * 16, lane);
  }
  float dk[HD / 2], dv[HD / 2];
#pragma unroll
  for (int r = 0; r < HD / 2; ++r) {
    dk[r] = 0.f;
    dv[r] = 0.f;
  }
  uint32_t pa[4][4], za[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      pa[j][e] = 0u;
      za[j][e] = 0u;
    }
  float s[32], ds[32];
  int prev = 0;
  for (int c = 0; c < ns; ++c) {
    const int slot = c % TL_STAGES;
    hopper::mbar_wait(full + 8 * slot, (c / TL_STAGES) & 1);
    zero32(s);
    zero32(ds);
    hopper::wgmma_fence();
    tile_nt<HD, HD == 64>(s, ka, skk + w * TB, sq + slot * TB);    // S^T: keys x queries
    tile_nt<HD, HD == 64>(ds, va, svv + w * TB, sda + slot * TB);  // dS^T
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();  // these products, and the previous stage's dV, dK
    hopper::fence_regs<32>(s);
    hopper::fence_regs<32>(ds);
    hopper::fence_regs<HD / 2>(dk);
    hopper::fence_regs<HD / 2>(dv);
    fence_frags(pa);
    fence_frags(za);
    if (c > 0 && lane == 0) hopper::mbar_arrive(empty + 8 * prev);
    const float* st = stats + slot * 3 * TL;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + 2 * t4;  // the thread's queries col, col + 1
      const float2 mb = *reinterpret_cast<const float2*>(st + col);
      const float2 iv = *reinterpret_cast<const float2*>(st + TL + col);
      const float2 dd = *reinterpret_cast<const float2*>(st + 2 * TL + col);
      float p[4], z[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 4 * j + e;
        const bool odd = e & 1;
        p[e] = hopper::ex2(fmaf(s[r], scale_log2e, odd ? mb.y : mb.x)) * (odd ? iv.y : iv.x);
        z[e] = p[e] * (ds[r] - (odd ? dd.y : dd.x)) * scale;
      }
      pa[j >> 1][(j & 1) * 2] = pack_bf16(p[0], p[1]);
      pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
      za[j >> 1][(j & 1) * 2] = pack_bf16(z[0], z[1]);
      za[j >> 1][(j & 1) * 2 + 1] = pack_bf16(z[2], z[3]);
    }
    fence_frags(pa);
    fence_frags(za);
    hopper::fence_regs<HD / 2>(dk);
    hopper::fence_regs<HD / 2>(dv);
    hopper::wgmma_fence();
    tile_nn<HD>(dv, pa, sda + slot * TB);
    tile_nn<HD>(dk, za, sq + slot * TB);
    hopper::wgmma_commit();
    hopper::fence_regs<HD / 2>(dk);
    hopper::fence_regs<HD / 2>(dv);
    prev = slot;
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs<HD / 2>(dk);
  hopper::fence_regs<HD / 2>(dv);
  fence_frags(pa);
  fence_frags(za);
  const int r0 = k0 + TL * w + warp * 16 + g;
  __nv_bfloat16* out = dqkv + (long long)b * n * 3 * d + h * HD;
  store_rows64<HD>(out + d, dk, r0, n, 3LL * d, t4);
  store_rows64<HD>(out + 2 * d, dv, r0, n, 3LL * d, t4);
}

// Tensor maps over (column, token, image) of qkv and dattn (each image's
// rows past n load as zeros), then the two launches.
template <int HD>
int launch_tiled(const void* qkv, const void* dattn, __nv_bfloat16* dqkv, float* ws, int b, int n,
                 int d, int heads, float scale, cudaStream_t stream) {
  CUtensorMap qm, dm;
  const uint64_t qdims[3] = {(uint64_t)(3 * d), (uint64_t)n, (uint64_t)b};
  const uint64_t qstr[2] = {(uint64_t)d * 6, (uint64_t)d * 6 * n};
  const uint64_t ddims[3] = {(uint64_t)d, (uint64_t)n, (uint64_t)b};
  const uint64_t dstr[2] = {(uint64_t)d * 2, (uint64_t)d * 2 * n};
  const uint32_t box[3] = {HD, TL, 1};
  const CUtensorMapSwizzle sw = HD == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  if (!hopper::make_map_bf16(&qm, qkv, 3, qdims, qstr, box, sw) ||
      !hopper::make_map_bf16(&dm, dattn, 3, ddims, dstr, box, sw))
    return (int)cudaErrorInvalidValue;
  constexpr int smem_q = tiled_smem<HD>(false), smem_kv = tiled_smem<HD>(true);
  auto kq = attn_tiled_bwd_q_kernel<HD>;
  auto kkv = attn_tiled_bwd_kv_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(kq, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kkv, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
  if (err != cudaSuccess) return (int)err;
  const float sl2e = scale * 1.4426950408889634f;
  dim3 grid((n + TL_NWG * TL - 1) / (TL_NWG * TL), heads, b);
  kq<<<grid, TL_THREADS, smem_q, stream>>>(qm, dm, dqkv, ws, n, d, sl2e, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kkv<<<grid, TL_THREADS, smem_kv, stream>>>(qm, dm, dqkv, ws, n, d, sl2e, scale);
  return (int)cudaGetLastError();
}

// 1 the wgmma kernel, 0 the kept kernel, 2 the key-tiled pair, -1 none.
int bwd_route(int n, int head_dim) {
  if (head_dim == 64 && n <= WG_MAX_KEYS) return 1;
  if (head_dim == 64 && n <= KEPT_MAX_TOKENS) return 0;
  return head_dim == 32 || head_dim == 64 ? 2 : -1;
}

}  // namespace

// qkv: (b, n, 3d) bf16 packed as [q | k | v], head h at columns
// h*head_dim; dattn: (b, n, d) bf16; dqkv: (b, n, 3d) bf16, the same layout
// as qkv. The head dim is d / num_heads and must be 32 or 64; the pointers
// 16-byte aligned (the wrapper checks). The kernel is chosen by shape
// (peekvit_attn_softmax_bwd_route): at head dim 64 the wgmma kernel up to
// 256 tokens and the earlier kernel up to 384, else the key-tiled pair
// (head dim 32 at any n, head dim 64 past 384), which needs `workspace`:
// 3 * b * num_heads * n fp32 (each row's -max * scale * log2(e), 1 / sum
// and D between its two launches); the other routes take null. scale = head_dim^-0.5. Returns
// the cudaError_t of the launch.
extern "C" int peekvit_attn_softmax_bwd(const void* qkv, const void* dattn, void* dqkv,
                                        void* workspace, int b, int n, int d, int num_heads,
                                        float scale, void* stream) {
  if (b == 0 || n == 0) return 0;
  if (num_heads <= 0 || d % num_heads != 0) return (int)cudaErrorInvalidValue;
  const int head_dim = d / num_heads;
  const int route = bwd_route(n, head_dim);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(qkv);
  const __nv_bfloat16* db = static_cast<const __nv_bfloat16*>(dattn);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(dqkv);
  if (route == 2) {
    if (!workspace) return (int)cudaErrorInvalidValue;
    float* ws = static_cast<float*>(workspace);
    return head_dim == 32 ? launch_tiled<32>(qkv, dattn, o, ws, b, n, d, num_heads, scale, st)
                          : launch_tiled<64>(qkv, dattn, o, ws, b, n, d, num_heads, scale, st);
  }
  if (route == 1) {
    const int nt = (n + 15) / 16;
    CUtensorMap qm, dm;
    const uint64_t qdims[3] = {(uint64_t)(3 * d), (uint64_t)n, (uint64_t)b};
    const uint64_t qstr[2] = {(uint64_t)d * 6, (uint64_t)d * 6 * n};
    const uint64_t ddims[3] = {(uint64_t)d, (uint64_t)n, (uint64_t)b};
    const uint64_t dstr[2] = {(uint64_t)d * 2, (uint64_t)d * 2 * n};
    const uint32_t box[3] = {64, (uint32_t)(16 * nt), 1};
    if (!hopper::make_map_bf16(&qm, qkv, 3, qdims, qstr, box) ||
        !hopper::make_map_bf16(&dm, dattn, 3, ddims, dstr, box))
      return (int)cudaErrorInvalidValue;
    switch (nt) {
#define PEEKVIT_NT(k) \
  case k:             \
    return launch_wgmma<k>(qm, dm, o, b, n, d, num_heads, scale, st);
      PEEKVIT_NT(1) PEEKVIT_NT(2) PEEKVIT_NT(3) PEEKVIT_NT(4) PEEKVIT_NT(5) PEEKVIT_NT(6)
      PEEKVIT_NT(7) PEEKVIT_NT(8) PEEKVIT_NT(9) PEEKVIT_NT(10) PEEKVIT_NT(11) PEEKVIT_NT(12)
      PEEKVIT_NT(13) PEEKVIT_NT(14) PEEKVIT_NT(15) PEEKVIT_NT(16)
#undef PEEKVIT_NT
    }
    return (int)cudaErrorInvalidValue;
  }
  if (route != 0) return (int)cudaErrorInvalidValue;
  const int npad = (n + CH - 1) / CH * CH;
  const int smem = npad * (4 * STRIDE * 2 + 3 * 4);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(num_heads, b);
  attn_bwd_kernel<<<grid, THREADS, smem, st>>>(qb, db, o, n, d, scale);
  return (int)cudaGetLastError();
}

// Which kernel peekvit_attn_softmax_bwd runs at n tokens and this head
// dim: 1 the wgmma kernel, 0 the earlier one, 2 the key-tiled pair, -1
// none (the head dim is neither 32 nor 64).
extern "C" int peekvit_attn_softmax_bwd_route(int n, int head_dim) {
  return bwd_route(n, head_dim);
}
