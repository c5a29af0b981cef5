// Per-head attention over packed qkv with the inference fast softmax.
//
// Replaces peekvit_tpu/ops/pallas/fused_attention.py:46 _attn_scores_pv
// as it runs inside the plain layer kernel (_layer_kernel :683-696) and
// _attn_block_kernel (:263-275): softmax(q k^T * scale) v per image and
// head, with the Pallas numerics kept:
//   - q is multiplied by scale * log2(e) in fp32 and rounded to bf16;
//   - logits accumulate in fp32, are clamped to [-80, 115], rounded to
//     bf16, and go through exp2 with the result rounded to bf16;
//   - no max subtraction: the clamp keeps exp2 finite and the rowsum > 0;
//   - the rowsum accumulates in fp32 beside e . v, and the output is
//     (e . v) * (1 / rowsum), rounded to bf16;
//   - with phantom_idx >= 0, key phantom_idx's term becomes
//     bf16(e * bf16(phantom_mult)) before the rowsum and PV (the key
//     weight ``kweight`` of _attn_scores_pv :98-99): the token-compaction
//     engine's phantom slot, one key standing in for phantom_mult dropped
//     tokens whose keys and values are identical. Unlike the Pallas
//     kernels, which build the weight only when phantom_mult > 0
//     (fused_attention.py:398, :660), the weight applies whenever
//     phantom_idx >= 0, so a phantom with mult 0 contributes nothing;
//   - with a key mask (kmask, (b, n) bf16, 1 = attend; the padded RankViT
//     layer, _layer_kernel mode 'keymasked' :616 and
//     _keymasked_attn_kernel :494), a key whose kmask is not > 0 (the
//     predicate in fp32) has its term SELECTED to 0 after the exp2, so a
//     NaN or Inf logit from a garbage excluded row never reaches the
//     rowsum; and every non-finite v value is scrubbed to 0, element by
//     element (_attn_scores_pv :80-97), so that 0 * NaN cannot reach PV.
//     The scrub runs in shared memory after the cp.async wait, on the
//     chunks each thread copied itself (its own copies are visible to it
//     after the wait), before the barrier that publishes the tile. The
//     clamp here is fminf/fmaxf, which turns a NaN logit finite where
//     torch.clamp keeps it NaN: the select after the exp is what makes
//     the kernel and its plain version agree on excluded keys. A key mask
//     and a phantom key are exclusive (no JAX path combines them).
//
// The head dim HD is a template parameter, instantiated at 64 (ViT-B,
// ViT-S, every earlier model) and 32 (PCT: d = 128 over 4 heads). Only
// the tile geometry follows HD: a shared-memory row is HD + 8 bf16 (144 B
// at 64, 80 B at 32, both multiples of ldmatrix's 16-byte rows, and with
// 8 rows of a ldmatrix landing on distinct banks), Q K^T takes HD / 16
// k-steps of m16n8k16 and P V HD / 8 n8 tiles. The arithmetic and its
// order are the same for both, so the HD = 64 kernel is the one built
// before the template.
//
// Bound on H100: at ViT-B (N = 197, head dim 64) the two products are
// 4 * N * N * 64 flops per (image, head) against 4 * N * 64 * 2 bytes
// of q, k, v and output, about 100 flops per byte, under the card's
// ~295 flop/byte ridge: bytes bound it, with the exp2 on the SFU close.
// At PCT (N = 1024, head dim 32) the products are 4 * N * 32 flops per
// query against 4 * 32 * 2 bytes of its q, k, v and output: 4 N / 2 =
// 2,048 flops per byte, far past the ridge, so the tensor-core
// operations bound it (128 flops per score), and the exp2 terms, one per
// score at the SFU's 16 per SM and cycle (132 SMs at 1.98 GHz: 4.2e12
// per second), take about twice the tensor-core time at 989 TFLOP/s: at
// that length the SFU is what limits this design.
// Design: grid (query tile of 64, head, image), 4 warps of 16 query rows.
// Q, K and V are read straight from the packed (B, N, 3D) buffer at
// columns h*HD, D + h*HD and 2D + h*HD and the output is written at
// column h*HD of (B, N, D): no transposes through memory. Because there
// is no max subtraction, key tiles of 64 stream through a 2-stage
// cp.async ring and their partial sums simply add: no online rescaling,
// no (N, N) score tile in memory. Scores stay in registers and feed the
// PV product as its A operand (the accumulator layout of m16n8k16 is the
// A-fragment layout). Keys past N are zero-filled on load and their e
// set to 0; query rows past N are not stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int QT = 64;          // query rows per block
constexpr int KT = 64;          // keys per streamed tile
constexpr int THREADS = 128;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

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
// bf16(exp2(bf16(clamp(logit, -80, 115)))) as a float.
__device__ __forceinline__ float exp2_term(float logit) {
  const float c = __bfloat162float(__float2bfloat16_rn(fminf(fmaxf(logit, -80.f), 115.f)));
  return __bfloat162float(__float2bfloat16_rn(exp2f(c)));
}
// Two bf16 values with every non-finite one (exponent all ones) set to 0.
__device__ __forceinline__ uint32_t scrub_bf16x2(uint32_t w) {
  const uint32_t lo = (w & 0x7F80u) == 0x7F80u ? 0u : (w & 0x0000FFFFu);
  const uint32_t hi = (w & 0x7F800000u) == 0x7F800000u ? 0u : (w & 0xFFFF0000u);
  return lo | hi;
}
// bf16(e * w), w already a bf16 value.
__device__ __forceinline__ float weighted(float e, float w) {
  return __bfloat162float(__float2bfloat16_rn(e * w));
}

template <int HD, bool KMASK>
__global__ void __launch_bounds__(THREADS)
attn_kernel(const __nv_bfloat16* __restrict__ qkv, const __nv_bfloat16* __restrict__ kmask,
            __nv_bfloat16* __restrict__ out, int n, int d, float qscale, int phantom_idx,
            float phantom_w) {
  constexpr int STRIDE = HD + 8;               // padded smem row (bf16 elements)
  constexpr int CH = HD / 8;                   // 16-byte chunks per row
  constexpr int LOADS = QT * CH / THREADS;     // chunks per thread per tile (QT == KT)
  __shared__ __align__(16) __nv_bfloat16 sq[QT * STRIDE];
  __shared__ __align__(16) __nv_bfloat16 sk[2][KT * STRIDE];
  __shared__ __align__(16) __nv_bfloat16 sv[2][KT * STRIDE];
  __shared__ float skeep[2][KT];  // KMASK: 1 where the key is attended

  const int q0 = blockIdx.x * QT, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long row_stride = 3LL * d;
  const __nv_bfloat16* base = qkv + (long long)b * n * row_stride;

  // K/V tile loader: 64 keys x CH chunks of 8 bf16, for K and for V.
  auto load_kv = [&](int tile, int buf) {
    const int kv0 = tile * KT;
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int chunk = tid + i * THREADS;
      const int r = chunk / CH, c = (chunk % CH) * 8;
      const int key = kv0 + r;
      const int ok = key < n;
      const __nv_bfloat16* src = base + (long long)(ok ? key : 0) * row_stride + h * HD + c;
      cp_async16(&sk[buf][r * STRIDE + c], src + d, ok ? 16 : 0);
      cp_async16(&sv[buf][r * STRIDE + c], src + 2 * d, ok ? 16 : 0);
    }
    if (KMASK && tid < KT) {
      const int key = kv0 + tid;
      skeep[buf][tid] =
          key < n && __bfloat162float(kmask[(long long)b * n + key]) > 0.f ? 1.f : 0.f;
    }
  };

  const int ntiles = (n + KT - 1) / KT;
  load_kv(0, 0);
  cp_async_commit();

  // Q tile, pre-scaled by scale * log2(e) in fp32 and rounded to bf16.
#pragma unroll
  for (int i = 0; i < LOADS; ++i) {
    const int chunk = tid + i * THREADS;
    const int r = chunk / CH, c = (chunk % CH) * 8;
    const int qrow = q0 + r;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (qrow < n) {
      raw = *reinterpret_cast<const uint4*>(base + (long long)qrow * row_stride + h * HD + c);
      __nv_bfloat162* hv = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(hv[e]);
        hv[e] = __floats2bfloat162_rn(f.x * qscale, f.y * qscale);
      }
    }
    *reinterpret_cast<uint4*>(&sq[r * STRIDE + c]) = raw;
  }
  __syncthreads();

  uint32_t qf[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int r = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    const int c = kk * 16 + (lane >> 4) * 8;
    ldmatrix_x4(qf[kk], &sq[r * STRIDE + c]);
  }

  float o[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float rsum0 = 0.f, rsum1 = 0.f;  // rows g and g + 8
  const int tq = lane & 3;

  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) load_kv(t + 1, (t + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    if (KMASK) {  // scrub the V chunks this thread copied for tile t
#pragma unroll
      for (int i = 0; i < LOADS; ++i) {
        const int chunk = tid + i * THREADS;
        uint4* p = reinterpret_cast<uint4*>(&sv[t & 1][(chunk / CH) * STRIDE + (chunk % CH) * 8]);
        uint4 v = *p;
        v.x = scrub_bf16x2(v.x);
        v.y = scrub_bf16x2(v.y);
        v.z = scrub_bf16x2(v.z);
        v.w = scrub_bf16x2(v.w);
        *p = v;
      }
    }
    __syncthreads();
    const __nv_bfloat16* tk = sk[t & 1];
    const __nv_bfloat16* tv = sv[t & 1];

    // S = Q K^T for 16 query rows x 64 keys.
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t kf[4];
        const int r = jp * 16 + (lane & 7) + (lane >> 4) * 8;
        const int c = kk * 16 + ((lane >> 3) & 1) * 8;
        ldmatrix_x4(kf, &tk[r * STRIDE + c]);
        mma_bf16(s[2 * jp], qf[kk], kf[0], kf[1]);
        mma_bf16(s[2 * jp + 1], qf[kk], kf[2], kf[3]);
      }
    }

    // e = bf16(exp2(bf16(clamp(s)))), 0 past the last key and (KMASK) on
    // an excluded key, the phantom key's weighted; rowsum in fp32.
    const int kv0 = t * KT;
    uint32_t pa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int key = kv0 + j * 8 + tq * 2;
      bool ok0 = key < n, ok1 = key + 1 < n;
      if (KMASK) {  // skeep is 0 past the last key too
        ok0 = skeep[t & 1][j * 8 + tq * 2] != 0.f;
        ok1 = skeep[t & 1][j * 8 + tq * 2 + 1] != 0.f;
      }
      float e0 = ok0 ? exp2_term(s[j][0]) : 0.f;
      float e1 = ok1 ? exp2_term(s[j][1]) : 0.f;
      float e2 = ok0 ? exp2_term(s[j][2]) : 0.f;
      float e3 = ok1 ? exp2_term(s[j][3]) : 0.f;
      if (key == phantom_idx) {
        e0 = weighted(e0, phantom_w);
        e2 = weighted(e2, phantom_w);
      } else if (key + 1 == phantom_idx) {
        e1 = weighted(e1, phantom_w);
        e3 = weighted(e3, phantom_w);
      }
      rsum0 += e0 + e1;
      rsum1 += e2 + e3;
      pa[j >> 1][(j & 1) * 2] = pack_bf16(e0, e1);
      pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(e2, e3);
    }

    // O += E V.
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
      for (int jn = 0; jn < HD / 16; ++jn) {
        uint32_t vf[4];
        const int r = jj * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int c = jn * 16 + (lane >> 4) * 8;
        ldmatrix_x4_trans(vf, &tv[r * STRIDE + c]);
        mma_bf16(o[2 * jn], pa[jj], vf[0], vf[1]);
        mma_bf16(o[2 * jn + 1], pa[jj], vf[2], vf[3]);
      }
    }
    __syncthreads();  // the next iteration's prefetch overwrites this buffer
  }

  rsum0 += __shfl_xor_sync(0xffffffffu, rsum0, 1);
  rsum0 += __shfl_xor_sync(0xffffffffu, rsum0, 2);
  rsum1 += __shfl_xor_sync(0xffffffffu, rsum1, 1);
  rsum1 += __shfl_xor_sync(0xffffffffu, rsum1, 2);
  const float inv0 = 1.0f / rsum0, inv1 = 1.0f / rsum1;

  const int g = lane >> 2;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  __nv_bfloat16* obase = out + (long long)b * n * d + h * HD + tq * 2;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    if (r0 < n)
      *reinterpret_cast<__nv_bfloat162*>(obase + (long long)r0 * d + j * 8) =
          __floats2bfloat162_rn(o[j][0] * inv0, o[j][1] * inv0);
    if (r1 < n)
      *reinterpret_cast<__nv_bfloat162*>(obase + (long long)r1 * d + j * 8) =
          __floats2bfloat162_rn(o[j][2] * inv1, o[j][3] * inv1);
  }
}

template <int HD>
int launch(const __nv_bfloat16* q, const __nv_bfloat16* km, __nv_bfloat16* o, int b, int n,
           int d, int num_heads, float qscale, int phantom_idx, float phantom_w,
           cudaStream_t st) {
  dim3 grid((n + QT - 1) / QT, num_heads, b);
  if (km != nullptr)
    attn_kernel<HD, true><<<grid, THREADS, 0, st>>>(q, km, o, n, d, qscale, -1, phantom_w);
  else
    attn_kernel<HD, false><<<grid, THREADS, 0, st>>>(q, nullptr, o, n, d, qscale,
                                                     phantom_idx < 0 ? -1 : phantom_idx,
                                                     phantom_w);
  return (int)cudaGetLastError();
}

}  // namespace

// qkv: (b, n, 3d) bf16 packed as [q | k | v] with head h at columns
// h*head_dim; out: (b, n, d) bf16. head_dim must be 64 or 32 and d =
// num_heads * head_dim (the wrapper checks). qscale = head_dim^-0.5 *
// log2(e). phantom_idx < 0 (no phantom key) or in [0, n); phantom_mult
// is rounded to bf16 here. kmask: null, or (b, n) bf16 (1 = attend), and
// then phantom_idx < 0. Returns the cudaError_t of the launch.
extern "C" int peekvit_attn_scores_pv(const void* qkv, void* out, const void* kmask, int b,
                                      int n, int d, int num_heads, int head_dim, float qscale,
                                      int phantom_idx, float phantom_mult, void* stream) {
  if (b == 0 || n == 0) return 0;
  if ((head_dim != 64 && head_dim != 32) || d != num_heads * head_dim || phantom_idx >= n ||
      (kmask != nullptr && phantom_idx >= 0))
    return (int)cudaErrorInvalidValue;
  const float phantom_w = __bfloat162float(__float2bfloat16_rn(phantom_mult));
  const auto* q = static_cast<const __nv_bfloat16*>(qkv);
  const auto* km = static_cast<const __nv_bfloat16*>(kmask);
  auto* o = static_cast<__nv_bfloat16*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return head_dim == 64
             ? launch<64>(q, km, o, b, n, d, num_heads, qscale, phantom_idx, phantom_w, st)
             : launch<32>(q, km, o, b, n, d, num_heads, qscale, phantom_idx, phantom_w, st);
}
