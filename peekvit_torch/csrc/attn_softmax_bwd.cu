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
// dim 64 past 384 (ResidualViT at 160 px: 402). It is the kernel above
// with its operands streamed, in two launches and no atomics, so every run
// gives the same bits:
//   attn_tiled_bwd_q_kernel, grid (64-row query tile, head, image), four
//   warps of 16 query rows: phase A with K and V streamed in 64-key tiles
//   through two shared buffers each (cp.async, the next tile in flight).
//   Three sweeps over the keys: the rows' max and sum, D = rowsum(dS * P),
//   dQ. It stores dQ and each row's max, sum and D, fp32, in a (3, B, H,
//   N) workspace the wrapper allocates.
//   attn_tiled_bwd_kv_kernel, grid (64-row key tile, head, image): phase B
//   with Q, dA and those statistics streamed in 64-query tiles; dK and dV
//   sum over the query chunks in order.
// The statistics are stored as the max, the sum and D (not 1/sum), so P
// is expf(logit * scale - max) / sum in both launches, as in the kernel
// above and the forward. Keys past N have logit -inf in phase A (only the
// last chunk can hold any) and their rows of dK and dV are never stored;
// queries past N get P = dZ = 0 in phase B.
// Bound at ResidualViT bs128 (N = 402, head dim 64, 4 heads): ~184 MB
// (0.055 ms) against ~5.3e10 flops (0.054 ms).
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
constexpr int TL = 64;                // rows of a CTA and of a streamed tile
constexpr int TL_THREADS = 128;       // four warps of 16 rows

// The helpers above with the head dim a parameter (for HD = 64 the same
// instructions in the same order).
template <int HD>
__device__ __forceinline__ void t_load_a(uint32_t (*f)[4], const __nv_bfloat16* s, int r0,
                                         int lane) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int r = r0 + (lane & 7) + ((lane >> 3) & 1) * 8;
    const int c = kk * 16 + (lane >> 4) * 8;
    ldmatrix_x4(f[kk], &s[r * (HD + 8) + c]);
  }
}

template <int HD>
__device__ __forceinline__ void t_product_nt(float (*acc)[4], uint32_t (*a)[4],
                                             const __nv_bfloat16* s, int r0, int lane) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t f[4];
    const int r = r0 + (lane & 7) + (lane >> 4) * 8;
    const int c = kk * 16 + ((lane >> 3) & 1) * 8;
    ldmatrix_x4(f, &s[r * (HD + 8) + c]);
    mma_bf16(acc[0], a[kk], f[0], f[1]);
    mma_bf16(acc[1], a[kk], f[2], f[3]);
  }
}

template <int HD>
__device__ __forceinline__ void t_product_nn(float (*acc)[4], const uint32_t* p,
                                             const __nv_bfloat16* s, int r0, int lane) {
#pragma unroll
  for (int jn = 0; jn < HD / 16; ++jn) {
    uint32_t f[4];
    const int r = r0 + (lane & 7) + ((lane >> 3) & 1) * 8;
    const int c = jn * 16 + (lane >> 4) * 8;
    ldmatrix_x4_trans(f, &s[r * (HD + 8) + c]);
    mma_bf16(acc[2 * jn], p, f[0], f[1]);
    mma_bf16(acc[2 * jn + 1], p, f[2], f[3]);
  }
}

template <int HD>
__device__ __forceinline__ void t_store_rows(__nv_bfloat16* dst, float (*acc)[4], int r0, int n,
                                             long long row_stride, int lane) {
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int c = j * 8 + tq * 2;
    if (r0 + g < n)
      *reinterpret_cast<__nv_bfloat162*>(dst + (long long)(r0 + g) * row_stride + c) =
          __floats2bfloat162_rn(acc[j][0], acc[j][1]);
    if (r0 + g + 8 < n)
      *reinterpret_cast<__nv_bfloat162*>(dst + (long long)(r0 + g + 8) * row_stride + c) =
          __floats2bfloat162_rn(acc[j][2], acc[j][3]);
  }
}

// Rows [r0, r0 + 64) of one head (HD columns at row stride `stride`) into
// a padded shared tile by cp.async; rows at or past n read as zero.
template <int HD>
__device__ __forceinline__ void t_load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                            long long stride, int r0, int n, int tid) {
  constexpr int CPR = HD / 8;  // 16-byte chunks a row
  for (int chunk = tid; chunk < TL * CPR; chunk += TL_THREADS) {
    const int r = chunk / CPR, c = (chunk % CPR) * 8;
    const int row = r0 + r;
    const int ok = row < n;
    cp_async16(&dst[r * (HD + 8) + c], src + (long long)(ok ? row : 0) * stride + c,
               ok ? 16 : 0);
  }
}

// Streams `ntiles` pairs of 64-row tiles (a from a_src, b from b_src, or
// a alone when b_src is null) through two shared buffers each, double-
// buffered by cp.async, and calls body(t, a_tile, b_tile) with tile t
// resident and visible to every thread. extra(t, buf), if given, stages
// more of tile t (plain stores) beside the cp.async copies.
template <int HD, class Body, class Extra>
__device__ __forceinline__ void stream_tiles(int ntiles, const __nv_bfloat16* a_src,
                                             const __nv_bfloat16* b_src, long long stride, int n,
                                             __nv_bfloat16* sa, __nv_bfloat16* sb, int tid,
                                             Body body, Extra extra) {
  constexpr int TILE = TL * (HD + 8);
  auto load = [&](int t) {
    const int buf = t & 1;
    t_load_tile<HD>(sa + buf * TILE, a_src, stride, t * TL, n, tid);
    if (b_src) t_load_tile<HD>(sb + buf * TILE, b_src, stride, t * TL, n, tid);
    extra(t, buf);
    cp_async_commit();
  };
  load(0);
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      load(t + 1);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      cp_async_wait_all();
    }
    __syncthreads();
    body(t, sa + (t & 1) * TILE, sb + (t & 1) * TILE);
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }
}

// Launch 1, by 64-row query tiles: the kept kernel's phase A with K and V
// streamed in 64-key tiles. Three sweeps over the keys: the row max and
// sum, the row term D = rowsum(dS * P), then dQ. Writes dQ and each row's
// max, sum and D (fp32, (b, heads, n) each, at ws, ws + bhn, ws + 2 bhn).
template <int HD>
__global__ void __launch_bounds__(TL_THREADS)
attn_tiled_bwd_q_kernel(const __nv_bfloat16* __restrict__ qkv,
                        const __nv_bfloat16* __restrict__ dattn, __nv_bfloat16* __restrict__ dqkv,
                        float* __restrict__ ws, int n, int d, float scale) {
  constexpr int STR = HD + 8, TILE = TL * STR, KK = HD / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sda = sq + TILE;
  __nv_bfloat16* sk = sda + TILE;  // two tiles
  __nv_bfloat16* sv = sk + 2 * TILE;

  const int h = blockIdx.y, b = blockIdx.z, heads = gridDim.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int nch = (n + CH - 1) / CH, ntiles = (n + TL - 1) / TL;
  const long long row3 = 3LL * d;
  const __nv_bfloat16* base = qkv + (long long)b * n * row3 + h * HD;
  const int q0 = blockIdx.x * TL + warp * 16;

  t_load_tile<HD>(sq, base, row3, blockIdx.x * TL, n, tid);
  t_load_tile<HD>(sda, dattn + (long long)b * n * d + h * HD, d, blockIdx.x * TL, n, tid);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  uint32_t qf[KK][4], daf[KK][4];
  t_load_a<HD>(qf, sq, warp * 16, lane);
  t_load_a<HD>(daf, sda, warp * 16, lane);
  auto none = [](int, int) {};

  // sweep 1: row max and sum (rows g, g + 8), online per 16-key chunk
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float s[2][4], ds[2][4];
  stream_tiles<HD>(ntiles, base + d, nullptr, row3, n, sk, sv, tid,
                   [&](int t, const __nv_bfloat16* skt, const __nv_bfloat16*) {
#pragma unroll
    for (int c = 0; c < TL / CH; ++c) {
      if (t * (TL / CH) + c >= nch) break;
      t_product_nt<HD>(s, qf, skt, c * CH, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = t * TL + c * CH + j * 8 + tq * 2;
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
  }, none);
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);

  // S (fp32) of the chunk at row c * 16 of the tiles into s, dS into ds
  auto probs = [&](int key0, const __nv_bfloat16* skt, const __nv_bfloat16* svt, int c) {
    t_product_nt<HD>(s, qf, skt, c * CH, lane);
    t_product_nt<HD>(ds, daf, svt, c * CH, lane);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int key = key0 + c * CH + j * 8 + tq * 2;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float m = e < 2 ? m0 : m1, l = e < 2 ? l0 : l1;
        s[j][e] = (key + (e & 1) < n) ? expf(s[j][e] * scale - m) / l : 0.f;
      }
    }
  };

  // sweep 2: the row term rowsum(dS * S)
  float r0 = 0.f, r1 = 0.f;
  stream_tiles<HD>(ntiles, base + d, base + 2 * d, row3, n, sk, sv, tid,
                   [&](int t, const __nv_bfloat16* skt, const __nv_bfloat16* svt) {
#pragma unroll
    for (int c = 0; c < TL / CH; ++c) {
      if (t * (TL / CH) + c >= nch) break;
      probs(t * TL, skt, svt, c);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        r0 += ds[j][0] * s[j][0] + ds[j][1] * s[j][1];
        r1 += ds[j][2] * s[j][2] + ds[j][3] * s[j][3];
      }
    }
  }, none);
  r0 = quad_sum(r0);
  r1 = quad_sum(r1);

  // sweep 3: dQ += bf16(dZ * scale) . K
  float dq[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;
  stream_tiles<HD>(ntiles, base + d, base + 2 * d, row3, n, sk, sv, tid,
                   [&](int t, const __nv_bfloat16* skt, const __nv_bfloat16* svt) {
#pragma unroll
    for (int c = 0; c < TL / CH; ++c) {
      if (t * (TL / CH) + c >= nch) break;
      probs(t * TL, skt, svt, c);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = s[j][e] * (ds[j][e] - (e < 2 ? r0 : r1)) * scale;
      uint32_t za[4];
      to_a_frag(za, s);
      t_product_nn<HD>(dq, za, skt, c * CH, lane);
    }
  }, none);
  t_store_rows<HD>(dqkv + (long long)b * n * row3 + h * HD, dq, q0, n, row3, lane);
  if (tq == 0) {
    const long long bhn = (long long)gridDim.z * heads * n;
    float* row = ws + ((long long)b * heads + h) * n;
    if (q0 + g < n) {
      row[q0 + g] = m0;
      row[bhn + q0 + g] = l0;
      row[2 * bhn + q0 + g] = r0;
    }
    if (q0 + g + 8 < n) {
      row[q0 + g + 8] = m1;
      row[bhn + q0 + g + 8] = l1;
      row[2 * bhn + q0 + g + 8] = r1;
    }
  }
}

// Launch 2, by 64-row key tiles: the kept kernel's phase B with Q and dA
// streamed in 64-query tiles, beside their rows' max, sum and D from
// launch 1. dK and dV sum over the queries in order and are stored.
template <int HD>
__global__ void __launch_bounds__(TL_THREADS)
attn_tiled_bwd_kv_kernel(const __nv_bfloat16* __restrict__ qkv,
                         const __nv_bfloat16* __restrict__ dattn, __nv_bfloat16* __restrict__ dqkv,
                         const float* __restrict__ ws, int n, int d, float scale) {
  constexpr int STR = HD + 8, TILE = TL * STR, KK = HD / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sk = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sv = sk + TILE;
  __nv_bfloat16* sq = sv + TILE;      // two tiles
  __nv_bfloat16* sda = sq + 2 * TILE;  // two tiles
  float* stats = reinterpret_cast<float*>(sda + 2 * TILE);  // [buffer][max, sum, D][64]

  const int h = blockIdx.y, b = blockIdx.z, heads = gridDim.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tq = lane & 3;
  const int nch = (n + CH - 1) / CH, ntiles = (n + TL - 1) / TL;
  const long long row3 = 3LL * d;
  const __nv_bfloat16* base = qkv + (long long)b * n * row3 + h * HD;
  const __nv_bfloat16* dbase = dattn + (long long)b * n * d + h * HD;
  const long long bhn = (long long)gridDim.z * heads * n;
  const float* wrow = ws + ((long long)b * heads + h) * n;

  t_load_tile<HD>(sk, base + d, row3, blockIdx.x * TL, n, tid);
  t_load_tile<HD>(sv, base + 2 * d, row3, blockIdx.x * TL, n, tid);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  uint32_t kf[KK][4], vf[KK][4];
  t_load_a<HD>(kf, sk, warp * 16, lane);
  t_load_a<HD>(vf, sv, warp * 16, lane);
  float dk[HD / 8][4], dv[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk[j][e] = 0.f;
      dv[j][e] = 0.f;
    }

  // Q tiles from qkv (row stride 3d) and dA tiles from dattn (row stride
  // d): stream_tiles takes one stride, so dA is staged by `extra`.
  auto stage = [&](int t, int buf) {
    t_load_tile<HD>(sda + buf * TILE, dbase, d, t * TL, n, tid);
    for (int r = tid; r < TL; r += TL_THREADS) {
      const int q = t * TL + r;
      float* st = stats + buf * 3 * TL;
      st[r] = q < n ? wrow[q] : 0.f;
      st[TL + r] = q < n ? wrow[bhn + q] : 1.f;
      st[2 * TL + r] = q < n ? wrow[2 * bhn + q] : 0.f;
    }
  };
  stream_tiles<HD>(ntiles, base, nullptr, row3, n, sq, sq, tid,
                   [&](int t, const __nv_bfloat16* sqt, const __nv_bfloat16*) {
    const __nv_bfloat16* sdat = sda + (t & 1) * TILE;
    const float* st = stats + (t & 1) * 3 * TL;
#pragma unroll
    for (int c = 0; c < TL / CH; ++c) {
      if (t * (TL / CH) + c >= nch) break;
      float sT[2][4], dsT[2][4];
      t_product_nt<HD>(sT, kf, sqt, c * CH, lane);   // S^T: keys x queries
      t_product_nt<HD>(dsT, vf, sdat, c * CH, lane);  // dS^T
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = c * CH + j * 8 + tq * 2 + (e & 1);
          float p = 0.f, z = 0.f;
          if (t * TL + ql < n) {
            p = expf(sT[j][e] * scale - st[ql]) / st[TL + ql];
            z = p * (dsT[j][e] - st[2 * TL + ql]) * scale;
          }
          sT[j][e] = p;
          dsT[j][e] = z;
        }
      }
      uint32_t pa[4], za[4];
      to_a_frag(pa, sT);
      to_a_frag(za, dsT);
      t_product_nn<HD>(dv, pa, sdat, c * CH, lane);
      t_product_nn<HD>(dk, za, sqt, c * CH, lane);
    }
  }, stage);
  __nv_bfloat16* out = dqkv + (long long)b * n * row3 + h * HD;
  const int k0 = blockIdx.x * TL + warp * 16;
  t_store_rows<HD>(out + d, dk, k0, n, row3, lane);
  t_store_rows<HD>(out + 2 * d, dv, k0, n, row3, lane);
}

template <int HD>
int launch_tiled(const __nv_bfloat16* qkv, const __nv_bfloat16* dattn, __nv_bfloat16* dqkv,
                 float* ws, int b, int n, int d, int heads, float scale, cudaStream_t stream) {
  constexpr int TILE_BYTES = TL * (HD + 8) * 2;
  constexpr int smem_q = 6 * TILE_BYTES;
  constexpr int smem_kv = 6 * TILE_BYTES + 2 * 3 * TL * 4;
  auto kq = attn_tiled_bwd_q_kernel<HD>;
  auto kkv = attn_tiled_bwd_kv_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(kq, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kkv, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + TL - 1) / TL, heads, b);
  kq<<<grid, TL_THREADS, smem_q, stream>>>(qkv, dattn, dqkv, ws, n, d, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kkv<<<grid, TL_THREADS, smem_kv, stream>>>(qkv, dattn, dqkv, ws, n, d, scale);
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
// 3 * b * num_heads * n fp32 (each row's max, sum and D between its two
// launches); the other routes take null. scale = head_dim^-0.5. Returns
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
    return head_dim == 32 ? launch_tiled<32>(qb, db, o, ws, b, n, d, num_heads, scale, st)
                          : launch_tiled<64>(qb, db, o, ws, b, n, d, num_heads, scale, st);
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
