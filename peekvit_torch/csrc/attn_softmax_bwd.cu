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
// the bytes and the tensor cores bound it. Design (simple, deterministic,
// no atomics): one block of 8 warps per (head, image) holds the head's Q,
// K, V and dA whole in dynamic shared memory (N padded to a multiple of
// 16, zero-filled; 4 x 208 x 72 bf16 at N = 197).
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

}  // namespace

// qkv: (b, n, 3d) bf16 packed as [q | k | v], head h at columns h*64;
// dattn: (b, n, d) bf16; dqkv: (b, n, 3d) bf16, the same layout as qkv.
// head_dim must be 64, d a multiple of 64 and n at most 384 (Q, K, V and
// dA of one head in shared memory; the wrapper checks). scale =
// head_dim^-0.5. Returns the cudaError_t of the launch.
extern "C" int peekvit_attn_softmax_bwd(const void* qkv, const void* dattn, void* dqkv, int b,
                                        int n, int d, int num_heads, float scale,
                                        void* stream) {
  if (b == 0 || n == 0) return 0;
  if (d != num_heads * HD) return (int)cudaErrorInvalidValue;
  const int npad = (n + CH - 1) / CH * CH;
  const int smem = npad * (4 * STRIDE * 2 + 3 * 4);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(num_heads, b);
  attn_bwd_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const __nv_bfloat16*>(dattn),
      static_cast<__nv_bfloat16*>(dqkv), n, d, scale);
  return (int)cudaGetLastError();
}
