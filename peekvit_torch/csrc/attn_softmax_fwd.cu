// Per-head attention over packed qkv with the trainable block's softmax.
//
// Replaces the attention core of peekvit_tpu/ops/pallas/
// fused_attention_vjp.py:49 _attn_fwd_kernel (:65-82), the forward of
// attention_block_trainable: softmax(q k^T * scale) v per image and head,
// with the Pallas numerics kept:
//   - logits = (q . k^T) accumulated in fp32, then multiplied by scale
//     (the scale is not folded into q);
//   - softmax in fp32 with the row max subtracted: e = exp(x - max),
//     s = e / sum(e) (a division, as jax.nn.softmax does);
//   - s is rounded to bf16 BEFORE the PV product, s_bf16 . v accumulates
//     in fp32 and the output is rounded to bf16.
// An online (flash) softmax that divides after PV rounds elsewhere, so
// the kernel makes two passes over the keys: the first takes each row's
// max and sum (online, rescaling the partial sum when the max grows), the
// second forms the normalised bf16 P and multiplies.
//
// Bound on H100: at ViT-B (N = 197, head dim 64) the two products are
// 4 * N * N * 64 flops per (image, head) against 4 * N * 64 * 2 bytes of
// q, k, v and output, about 100 flops per byte, under the ~295 flop/byte
// ridge: bytes bound it. Design: grid (query tile of 64, head, image), 4
// warps of 16 query rows. The head's whole K and V (N padded to a
// multiple of 64, zero-filled) sit in dynamic shared memory (2 x 256 x 72
// bf16 at N = 197), loaded once with cp.async straight from the packed
// (B, N, 3D) buffer; both passes read them from there. Scores stay in
// registers and feed the PV product as its A operand. Keys past N get
// logit -inf (e = 0); query rows past N are not stored.
//
// q, k and v are addressed by three base pointers and one row stride, so
// the same kernel also carries peekvit_tpu/ops/pallas/fused_attention.py
// :220 fused_attention (_attn_kernel :168, the test-only attention over
// separate (B, N, D) q, k, v; row stride D). Its padding of N and the
// head dim to 128 with masked keys is a TPU layout artefact: keys past N
// already get -inf here. The packed mode passes qkv, qkv + D, qkv + 2D
// and stride 3D, the addresses it always read.
//
// A third mode carries the attention of peekvit_tpu/ops/pallas/
// fused_layer_vjp.py:560 _sp_tail_call (_sp_tail_math :478-514, the
// sequence-parallel tail): the rank's n_q local queries attend to the
// n_k gathered keys (n_q != n_k, q and k/v with their own row strides:
// q is a slice of the local qkv, k and v of the gathered kv buffer), and
// a per-image key mask (B, n_k) fp32, 1 = attend, gives an excluded key
// logit -inf before the row max, as keys past n_k get. It is the template
// instance MASK = true; the other modes are MASK = false, whose code is
// the earlier modes' unchanged. The mask is read once per block into
// shared memory. A 64-key tile whose keys are all excluded, met while a
// row's running max is still -inf, would give exp(-inf - (-inf)) = NaN
// in pass 1: the masked instance takes the exponent's base as 0 while the
// max is -inf (every term is then exp(-inf) = 0), so any mask that leaves
// a row one key gives that row the plain version's softmax, wherever the
// key sits. At ViT-B/16 bs256 over two ranks (n_q 99, n_k 198) this
// attention alone is bytes-bound as the square mode is; the tail's GEMMs
// make the whole site operation-bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int HD = 64;          // head dim the kernel is built for
constexpr int QT = 64;          // query rows per block
constexpr int KT = 64;          // keys per tile
constexpr int STRIDE = HD + 8;  // padded smem row (bf16 elements)
constexpr int THREADS = 128;
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

// S = Q K^T for the warp's 16 query rows x the 64 keys of tile t, times
// scale, with keys past n (and, with MASK, keys whose skm entry is not
// > 0; skm is 0 past n) at -inf.
template <bool MASK>
__device__ __forceinline__ void scaled_logits(float (*s)[4], uint32_t (*qf)[4],
                                              const __nv_bfloat16* sk, const float* skm, int t,
                                              int n, float scale, int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int jp = 0; jp < 4; ++jp) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t kf[4];
      const int r = t * KT + jp * 16 + (lane & 7) + (lane >> 4) * 8;
      const int c = kk * 16 + ((lane >> 3) & 1) * 8;
      ldmatrix_x4(kf, &sk[r * STRIDE + c]);
      mma_bf16(s[2 * jp], qf[kk], kf[0], kf[1]);
      mma_bf16(s[2 * jp + 1], qf[kk], kf[2], kf[3]);
    }
  }
  const int tq = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int key = t * KT + j * 8 + tq * 2;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (MASK)
        s[j][e] = (skm[key + (e & 1)] > 0.f) ? s[j][e] * scale : -INFINITY;
      else
        s[j][e] = (key + (e & 1) < n) ? s[j][e] * scale : -INFINITY;
    }
  }
}

// nq query rows at q_stride, nk key / value rows at kv_stride; out is
// (b, nq, d). kmask (b, nk) is read only by the MASK instance.
template <bool MASK>
__global__ void __launch_bounds__(THREADS)
attn_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                const float* __restrict__ kmask, int nq, int n, int d, int q_stride,
                int row_stride, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ntiles = (n + KT - 1) / KT;
  const int npad = ntiles * KT;
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sk = sq + QT * STRIDE;
  __nv_bfloat16* sv = sk + npad * STRIDE;
  float* skm = reinterpret_cast<float*>(sv + npad * STRIDE);

  const int q0 = blockIdx.x * QT, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long qhead = (long long)b * nq * q_stride + h * HD;
  const long long head = (long long)b * n * row_stride + h * HD;

  for (int chunk = tid; chunk < QT * 8; chunk += THREADS) {
    const int r = chunk >> 3, c = (chunk & 7) * 8;
    const int row = q0 + r;
    const int ok = row < nq;
    cp_async16(&sq[r * STRIDE + c], q + qhead + (long long)(ok ? row : 0) * q_stride + c,
               ok ? 16 : 0);
  }
  for (int chunk = tid; chunk < npad * 8; chunk += THREADS) {
    const int r = chunk >> 3, c = (chunk & 7) * 8;
    const int ok = r < n;
    const long long off = head + (long long)(ok ? r : 0) * row_stride + c;
    cp_async16(&sk[r * STRIDE + c], k + off, ok ? 16 : 0);
    cp_async16(&sv[r * STRIDE + c], v + off, ok ? 16 : 0);
  }
  if constexpr (MASK) {
    for (int r = tid; r < npad; r += THREADS)
      skm[r] = r < n ? kmask[(long long)b * n + r] : 0.f;
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  uint32_t qf[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int r = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    const int c = kk * 16 + (lane >> 4) * 8;
    ldmatrix_x4(qf[kk], &sq[r * STRIDE + c]);
  }

  // Pass 1: row max and sum of exp(x - max), rows g and g + 8.
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float s[8][4];
  for (int t = 0; t < ntiles; ++t) {
    scaled_logits<MASK>(s, qf, sk, skm, t, n, scale, lane);
    float c0 = -INFINITY, c1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      c0 = fmaxf(c0, fmaxf(s[j][0], s[j][1]));
      c1 = fmaxf(c1, fmaxf(s[j][2], s[j][3]));
    }
    const float n0 = fmaxf(m0, quad_max(c0)), n1 = fmaxf(m1, quad_max(c1));
    if constexpr (MASK) {  // no key of the row seen yet: every term below is 0
      const float e0 = n0 == -INFINITY ? 0.f : n0, e1 = n1 == -INFINITY ? 0.f : n1;
      l0 *= expf(m0 - e0);
      l1 *= expf(m1 - e1);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        l0 += expf(s[j][0] - e0) + expf(s[j][1] - e0);
        l1 += expf(s[j][2] - e1) + expf(s[j][3] - e1);
      }
    } else {
      l0 *= expf(m0 - n0);
      l1 *= expf(m1 - n1);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        l0 += expf(s[j][0] - n0) + expf(s[j][1] - n0);
        l1 += expf(s[j][2] - n1) + expf(s[j][3] - n1);
      }
    }
    m0 = n0;
    m1 = n1;
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);

  // Pass 2: P = bf16(exp(x - max) / sum), O += P V.
  float o[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  for (int t = 0; t < ntiles; ++t) {
    scaled_logits<MASK>(s, qf, sk, skm, t, n, scale, lane);
    uint32_t pa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p0 = expf(s[j][0] - m0) / l0, p1 = expf(s[j][1] - m0) / l0;
      const float p2 = expf(s[j][2] - m1) / l1, p3 = expf(s[j][3] - m1) / l1;
      pa[j >> 1][(j & 1) * 2] = pack_bf16(p0, p1);
      pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
      for (int jn = 0; jn < 4; ++jn) {
        uint32_t vf[4];
        const int r = t * KT + jj * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int c = jn * 16 + (lane >> 4) * 8;
        ldmatrix_x4_trans(vf, &sv[r * STRIDE + c]);
        mma_bf16(o[2 * jn], pa[jj], vf[0], vf[1]);
        mma_bf16(o[2 * jn + 1], pa[jj], vf[2], vf[3]);
      }
    }
  }

  const int g = lane >> 2, tq = lane & 3;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  __nv_bfloat16* obase = out + (long long)b * nq * d + h * HD + tq * 2;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (r0 < nq)
      *reinterpret_cast<__nv_bfloat162*>(obase + (long long)r0 * d + j * 8) =
          __floats2bfloat162_rn(o[j][0], o[j][1]);
    if (r1 < nq)
      *reinterpret_cast<__nv_bfloat162*>(obase + (long long)r1 * d + j * 8) =
          __floats2bfloat162_rn(o[j][2], o[j][3]);
  }
}

}  // namespace

// q: row r of image b at q + (b * nq + r) * q_stride, k and v at base +
// (b * nk + r) * kv_stride, head h at columns h*64 (packed qkv: qkv,
// qkv + d, qkv + 2d and both strides 3d, nq = nk; separate (b, n, d)
// tensors: strides d; the SP tail: q a slice of the local qkv, stride 3d,
// k and v of the gathered kv, stride 2d); out: (b, nq, d) bf16. kmask:
// null, or (b, nk) fp32 with 1 = attend (the MASK instance). head_dim must
// be 64, d a multiple of 64 and nk at most 768 (K and V of one head in
// shared memory; the wrapper checks). scale = head_dim^-0.5. Returns the
// cudaError_t of the launch.
extern "C" int peekvit_attn_softmax_fwd(const void* q, const void* k, const void* v, void* out,
                                        const void* kmask, int b, int nq, int nk, int d,
                                        int q_stride, int kv_stride, int num_heads, float scale,
                                        void* stream) {
  if (b == 0 || nq == 0) return 0;
  if (nk == 0 || d != num_heads * HD || q_stride < d || kv_stride < d)
    return (int)cudaErrorInvalidValue;
  const int npad = (nk + KT - 1) / KT * KT;
  const int smem = (QT + 2 * npad) * STRIDE * 2 + (kmask ? npad * 4 : 0);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  auto kernel = kmask ? attn_fwd_kernel<true> : attn_fwd_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((nq + QT - 1) / QT, num_heads, b);
  kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<const float*>(kmask), nq, nk, d, q_stride, kv_stride, scale);
  return (int)cudaGetLastError();
}
