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
//     element (_attn_scores_pv :80-97), so that 0 * NaN cannot reach PV,
//     in shared memory before the products read it (below). The
//     clamp here is fminf/fmaxf, which turns a NaN logit finite where
//     torch.clamp keeps it NaN: the select after the exp is what makes
//     the kernel and its plain version agree on excluded keys. A key mask
//     and a phantom key are exclusive (no JAX path combines them).
//
// The head dim HD is a template parameter, instantiated at 64 (ViT-B,
// ViT-S, every earlier model), 32 (PCT: d = 128 over 4 heads; MAE) and 48
// (the EncDec ResidualViT's decoder: d = 192 over 4 heads). Only the tile
// geometry follows HD; the arithmetic and its order are the same for all
// three. All three take the wgmma kernel below up to a token count set by
// shared memory, and the mma.sync kernel past it (see "Past those token
// counts").
//
// Bound on H100: at ViT-B (N = 197, head dim 64) the two products are
// 4 * N * N * 64 flops per (image, head) against 4 * N * 64 * 2 bytes
// of q, k, v and output, about 100 flops per byte, under the card's
// ~295 flop/byte ridge: bytes bound it (310 MB at bs256, 0.0925 ms), with
// the exp2 terms close (one MUFU and about ten ALU instructions a
// score). At PCT (N = 1024, head dim 32) the products are 4 * N * 32 flops
// per query against 4 * 32 * 2 bytes of its q, k, v and output: 2,048
// flops per byte, far past the ridge, so the tensor-core operations bound
// it (128 flops per score), and the exp2 terms, one per score at the SFU's
// 16 per SM and cycle (132 SMs at 1.98 GHz: 4.2e12 per second), take about
// twice the tensor-core time at 989 TFLOP/s: there the per-score
// instructions are what limits any design.
//
// Design (attn_wgmma_kernel, every N the port runs: up to 832 tokens at
// head dim 64, 1,088 at 48, 1,728 at 32): one CTA of two warpgroups (four
// where K and V leave room for one CTA an SM only, so that 16 warps share
// the SM all the same) per (image, head, set of 64-row query tiles), no
// producer warp.
// The head's whole K and V (keys padded to a multiple of 64) stay in
// shared memory, loaded ONCE per CTA by TMA in 64-key chunks, each on its
// own mbarrier, all waited for before the first product (a wait inside
// the chunk loop made ptxas serialize the wgmma pipeline, C7511). One 3-D
// tensor map over the packed (B, N, 3D) buffer (column, token, image)
// serves Q, K and V, so keys past N of image b load as zeros, never as
// image b + 1's rows. The swizzle is the row's: 128 bytes at head dim 64,
// 64 bytes at 32 (rows of 64 bytes), in the map and in the wgmma
// descriptors alike. At head dim 48 a row is 96 bytes, which fits no
// swizzle span, so every 64-row tile of Q, K and V is three column boxes
// of 16 (32 bytes a row, the 32-byte swizzle's span; 2,048 bytes a box),
// one TMA each, box after box (Geo, load_tile). Each k16 step of S reads
// one box K-major (sbo 256); PV's V, MN-major, spans the three boxes as
// three 16-wide N atoms of one wgmma m64n48k16 (lbo 2,048, the box step).
// That layout was chosen over two others: 32 + 16 columns (64- and 32-byte
// swizzles) needs two descriptor kinds and a split PV for nothing that the
// three equal boxes lack; rows padded to 64 in shared memory cost a third
// more shared memory (one CTA an SM at the decoder's 400 tokens where this
// keeps two) and 64-wide boxes that reach into the next head's columns.
// The three boxes keep the shared memory at 96 bytes a row, so head dim
// 48 reaches 1,088 tokens. Warpgroup w takes the CTA's query tiles w,
// w + NWG, ... (of the head's tiles, interleaved over gridDim.x CTAs when
// the batch is small), each through its own Q buffer: the next tile's TMA
// is issued as soon as the warpgroup holds the current one in registers.
// Per query tile, chunk by chunk:
//   S = Q K^T: Q's fragments by ldmatrix from the swizzled tile (or box),
//     scaled by qscale in fp32 and rounded to bf16 (the register A
//     operand), K K-major in shared memory; wgmma m64n64k16 over a full
//     chunk, and m64n16k16 per 16-key slice over the last, ragged one (no
//     work on slices wholly past N);
//   the terms in registers: e = bf16(exp2f(bf16(clamp(s)))), two keys at
//     a time in bf16x2 form (exp2_terms: about six instructions a score,
//     where the scalar form took about twelve; the instructions a score
//     bound the kernel at PCT's length), 0 past N or on an excluded key,
//     the phantom key's weighted, the fp32 rowsum;
//   O += P V: wgmma m64n{HD}k16 per 16-key slice, P packed in bf16 as the
//     A operand, V MN-major in shared memory; the chunk's PV runs while
//     the next chunk's S is issued.
// No max is subtracted, so key chunks simply add: nothing is rescaled.
// The output is O * (1 / rowsum), rounded to bf16, written per row as
// before. With a key mask every CTA then scrubs its V in shared memory
// and fences the async proxy (wgmma reads through it) before the barrier
// that publishes it: edit, fence, barrier, product.
// Numerics: the old kernel's bits. The wgmma accumulator gives each
// thread the (row, key) pairs of the m16n8 fragments, the terms are the
// scalar ones bit for bit (peekvit_attn_scores_pv_ex2_check holds the two
// on every fp32 logit), the rowsum is summed in the same key order, PV is
// fed the same 16-key slices in order, and the slices the old kernel
// padded with (zero P, zero V) add exact zeros.
//
// Past those token counts (head dim 64 above 832 keys, 48 above 1,088, 32
// above 1,728: K and V no longer fit beside the Q buffers), the C entry
// point takes the earlier kernel (attn_kernel below, its code and bits
// unchanged): grid (query tile of 64, head, image), 4 warps of 16 query
// rows, Q, K and V read straight from the packed buffer by cp.async, key
// tiles of 64 streamed through a 2-stage ring, mma.sync fed by ldmatrix,
// padded shared-memory rows of HD + 8 bf16, V scrubbed by each thread on
// the chunks it copied itself after the cp.async wait. Its geometry holds
// at 48: rows of 56 bf16 (112 bytes, 16-byte aligned for cp.async and
// ldmatrix, the eight rows of an ldmatrix on distinct bank groups), 3
// chunks of 16 bytes a thread per tile, HD / 16 = 3 k-steps for Q K^T and
// HD / 8 = 6 n-tiles for P V; a head's columns start at h * 96 bytes, a
// multiple of 16. The choice is by shape inside the entry point
// (peekvit_attn_scores_pv_plan), never a fallback on error. No shipped
// path reaches the mma.sync kernel: the EncDec decoder runs head dim 48 at
// N = 400 (160 px).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

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


// ------------------------------------------------------- the wgmma kernel

constexpr int CHUNK = 64;              // keys per TMA chunk (and query rows per tile)
constexpr int MAX_SMEM = 232448;

// A tile (64 rows of Q, K or V) is stored as BOXES column boxes, one after
// the other, each as TMA writes it: one box of the whole row at head dims
// 64 and 32 (128- and 64-byte rows, one swizzle span each), three boxes of
// 16 columns at 48 (32-byte rows, the 32-byte swizzle's span).
template <int HD>
struct Geo {
  static constexpr int BOXES = HD == 48 ? 3 : 1;
  static constexpr int BOX_COLS = HD / BOXES;
  static constexpr int BOX_ROW = BOX_COLS * 2;  // bytes per row of a box
  static constexpr int BOX = CHUNK * BOX_ROW;   // one box of 64 rows
  static constexpr int TILE = BOXES * BOX;      // one chunk of K or V, one Q tile
  static constexpr int SBO = 8 * BOX_ROW;       // between 8-row groups
  static constexpr int KSTEP = BOXES == 1 ? 32 : BOX;  // to the next 16 columns
};

// Descriptors of K rows (K-major: lbo not read) and of V rows (MN-major:
// lbo the step between N atoms: one atom wide at 64 and 32, three at 48,
// one box each) at `addr`, in the swizzle of a box row.
template <int HD>
__device__ __forceinline__ uint64_t k_desc(uint32_t addr) {
  if constexpr (HD == 64)
    return hopper::desc_sw128(addr, 16, Geo<HD>::SBO);
  else if constexpr (HD == 32)
    return hopper::desc_sw64(addr, 16, Geo<HD>::SBO);
  else
    return hopper::desc_sw32(addr, 16, Geo<HD>::SBO);
}
template <int HD>
__device__ __forceinline__ uint64_t v_desc(uint32_t addr) {
  if constexpr (HD == 64)
    return hopper::desc_sw128(addr, 1024, Geo<HD>::SBO);
  else if constexpr (HD == 32)
    return hopper::desc_sw64(addr, 512, Geo<HD>::SBO);
  else
    return hopper::desc_sw32(addr, Geo<HD>::BOX, Geo<HD>::SBO);
}

// One tile's TMA: 64 rows from token `row` of image b, columns from `col`,
// box by box, all on barrier `bar`.
template <int HD>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, int col, int row,
                                          int b, uint32_t bar) {
#pragma unroll
  for (int j = 0; j < Geo<HD>::BOXES; ++j)
    hopper::tma_load_3d(dst + j * Geo<HD>::BOX, map, col + j * Geo<HD>::BOX_COLS, row, b, bar);
}

__device__ __forceinline__ void wg_bar(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The terms of two logits a and b as a bf16x2 word (a low, b high), each
// bf16(exp2(bf16(clamp(x, -80, 115)))), 0 where `keep` clears its half:
// the bf16 rounding first and both halves at once (cvt.rn.bf16x2), the
// clamp on the rounded pair (max / min.bf16x2: -80 and 115 are bf16
// values and the rounding is monotone, so clamp and rounding commute;
// both return the other operand for a NaN, as fminf / fmaxf do), then
// ex2.approx.ftz.f32 on each, which on every bf16 value in [-80, 115] is
// exp2f's result bit for bit, rounded and packed again. exp2_term's bits:
// peekvit_attn_scores_pv_ex2_check compares the two on every fp32 logit.
__device__ __forceinline__ uint32_t exp2_terms(float a, float b) {
  uint32_t p;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(p) : "f"(b), "f"(a));
  asm("max.bf16x2 %0, %0, %1;\n" : "+r"(p) : "r"(0xC2A0C2A0u));  // -80
  asm("min.bf16x2 %0, %0, %1;\n" : "+r"(p) : "r"(0x42E642E6u));  // 115
  float lo = __uint_as_float(p << 16), hi = __uint_as_float(p & 0xFFFF0000u);
  asm("ex2.approx.ftz.f32 %0, %0;\n" : "+f"(lo));
  asm("ex2.approx.ftz.f32 %0, %0;\n" : "+f"(hi));
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(p) : "f"(hi), "f"(lo));
  return p;
}
__device__ __forceinline__ float lo_f(uint32_t p) { return __uint_as_float(p << 16); }
__device__ __forceinline__ float hi_f(uint32_t p) { return __uint_as_float(p & 0xFFFF0000u); }

// Bytes of dynamic shared memory for `nchunks` chunks of keys and NWG
// warpgroups: K and V, one Q buffer per warpgroup, the key mask, the
// mbarriers.
template <int HD>
constexpr int wg_smem(int nchunks, int nwg) {
  return 1024 + 2 * nchunks * Geo<HD>::TILE + nwg * Geo<HD>::TILE + nchunks * CHUNK +
         (nchunks + nwg) * 8;
}

template <int HD, bool KMASK, int NWG>
__global__ void __launch_bounds__(128 * NWG, 2 / (NWG / 2))
attn_wgmma_kernel(const __grid_constant__ CUtensorMap map, const __nv_bfloat16* __restrict__ kmask,
                  __nv_bfloat16* __restrict__ out, int n, int d, float qscale, int phantom_idx,
                  float phantom_w) {
  using G = Geo<HD>;
  constexpr int THREADS = 128 * NWG;
  extern __shared__ unsigned char smem_raw[];
  const int nchunks = (n + CHUNK - 1) / CHUNK;
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // 1024-aligned for the swizzle
  const uint32_t sk = base;
  const uint32_t sv = sk + nchunks * G::TILE;
  const uint32_t sq = sv + nchunks * G::TILE;    // one Q buffer per warpgroup
  unsigned char* skeep = smem_raw + (sq + NWG * G::TILE - raw);  // KMASK: 1 = attended
  const uint32_t kvbar = sq + NWG * G::TILE + nchunks * CHUNK;
  const uint32_t qbar = kvbar + 8 * nchunks;

  const int h = blockIdx.y, b = blockIdx.z;
  const int ntiles = nchunks;  // query tiles of 64 rows, as many as key chunks
  const int step = NWG * gridDim.x;
  const int tid = threadIdx.x, w = tid >> 7, wtid = tid & 127;
  const int warp = wtid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int first = blockIdx.x + w * gridDim.x;  // this warpgroup's first query tile

  if (tid == 0) {
    for (int c = 0; c < nchunks + NWG; ++c) hopper::mbar_init(kvbar + 8 * c, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {  // each warpgroup's first Q tile, then K and V chunk by chunk
    for (int q = 0; q < NWG; ++q) {
      const int t = blockIdx.x + q * gridDim.x;
      if (t < ntiles) {
        hopper::mbar_expect_tx(qbar + 8 * q, G::TILE);
        load_tile<HD>(sq + q * G::TILE, &map, h * HD, t * CHUNK, b, qbar + 8 * q);
      }
    }
    for (int c = 0; c < nchunks; ++c) {
      hopper::mbar_expect_tx(kvbar + 8 * c, 2 * G::TILE);
      load_tile<HD>(sk + c * G::TILE, &map, d + h * HD, c * CHUNK, b, kvbar + 8 * c);
      load_tile<HD>(sv + c * G::TILE, &map, 2 * d + h * HD, c * CHUNK, b, kvbar + 8 * c);
    }
  }
  for (int c = 0; c < nchunks; ++c) hopper::mbar_wait(kvbar + 8 * c, 0);
  if constexpr (KMASK) {
    // the keys attended (0 past N), then V scrubbed of every non-finite
    // value: edit, fence the async proxy, barrier
    for (int key = tid; key < nchunks * CHUNK; key += THREADS)
      skeep[key] = key < n && __bfloat162float(kmask[(long long)b * n + key]) > 0.f ? 1 : 0;
    uint4* v4 = reinterpret_cast<uint4*>(smem_raw + (sv - raw));
    for (int i = tid; i < nchunks * G::TILE / 16; i += THREADS) {
      uint4 v = v4[i];
      v.x = scrub_bf16x2(v.x);
      v.y = scrub_bf16x2(v.y);
      v.z = scrub_bf16x2(v.z);
      v.w = scrub_bf16x2(v.w);
      v4[i] = v;
    }
    fence_async_smem();
    __syncthreads();
  }

  const uint32_t my_q = sq + w * G::TILE, my_qbar = qbar + 8 * w;
  for (int i = 0, t = first; t < ntiles; ++i, t += step) {
    hopper::mbar_wait(my_qbar, i & 1);
    // Q's fragments from the swizzled tile, scaled by qscale in fp32 and
    // rounded to bf16: the register A operand of S = Q K^T. Columns 16 kk
    // on are 16-byte chunk 2 kk of the row at 64 and 32, chunk 0 of box kk
    // at 48.
    uint32_t qa[HD / 16][4];
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int r = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
      const int chunk = (G::BOXES == 1 ? 2 * kk : 0) + (lane >> 4);
      const int swz = HD == 64   ? (chunk ^ (r & 7))
                      : HD == 32 ? (chunk ^ ((r >> 1) & 3))
                                 : (chunk ^ ((r >> 2) & 1));
      const uint32_t box = G::BOXES == 1 ? 0u : (uint32_t)(kk * G::BOX);
      asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                   : "=r"(qa[kk][0]), "=r"(qa[kk][1]), "=r"(qa[kk][2]), "=r"(qa[kk][3])
                   : "r"(my_q + box + r * G::BOX_ROW + (swz << 4))
                   : "memory");
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&qa[kk][e]));
        qa[kk][e] = pack_bf16(f.x * qscale, f.y * qscale);
      }
    }
    // The buffer takes the warpgroup's next tile once every thread has read
    // it: the reads, the barrier, then (the async proxy writes it) a proxy
    // fence before the TMA.
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) hopper::fence_regs<4>(qa[kk]);
    fence_async_smem();
    wg_bar(1 + w);
    if (wtid == 0 && t + step < ntiles) {
      fence_async_smem();
      hopper::mbar_expect_tx(my_qbar, G::TILE);
      load_tile<HD>(my_q, &map, h * HD, (t + step) * CHUNK, b, my_qbar);
    }

    float o[HD / 2];
#pragma unroll
    for (int r = 0; r < HD / 2; ++r) o[r] = 0.f;
    float rsum0 = 0.f, rsum1 = 0.f;  // rows g and g + 8
    uint32_t pa[4][4];               // the previous chunk's P, read by its PV in flight
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) pa[j][e] = 0u;

    for (int c = 0; c < nchunks; ++c) {
      const int left = n - c * CHUNK;
      const int nsl = left >= CHUNK ? 4 : (left + 15) / 16;  // 16-key slices with keys
      const uint32_t kc = sk + c * G::TILE, vc = sv + c * G::TILE;

      // S = Q K^T for the warpgroup's 64 rows x the chunk's keys.
      float s[32];
#pragma unroll
      for (int r = 0; r < 32; ++r) s[r] = 0.f;
      hopper::fence_regs<32>(s);
      hopper::wgmma_fence();
      if (nsl == 4) {
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          hopper::wgmma_m64n64k16_rs<0>(s, qa[kk], k_desc<HD>(kc + kk * G::KSTEP));
      } else {
#pragma unroll
        for (int sl = 0; sl < 3; ++sl)
          if (sl < nsl) {
#pragma unroll
            for (int kk = 0; kk < HD / 16; ++kk)
              hopper::wgmma_m64n16k16_rs<0>(
                  s + 8 * sl, qa[kk], k_desc<HD>(kc + sl * 16 * G::BOX_ROW + kk * G::KSTEP));
          }
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();  // this S, and the previous chunk's PV
      hopper::fence_regs<32>(s);
      hopper::fence_regs<HD / 2>(o);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) hopper::fence_regs<4>(qa[kk]);
#pragma unroll
      for (int j = 0; j < 4; ++j) hopper::fence_regs<4>(pa[j]);

      // The terms, packed two keys a word as P's A fragment: 0 past the last
      // key and (KMASK) on an excluded key, the phantom key's weighted; the
      // rowsum in fp32, in the old kernel's key order.
      const int kv0 = c * CHUNK;
      const bool full = !KMASK && left >= CHUNK;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j < 2 * nsl) {
          const int key = kv0 + j * 8 + t4 * 2;
          uint32_t p0 = exp2_terms(s[4 * j], s[4 * j + 1]);      // row g
          uint32_t p1 = exp2_terms(s[4 * j + 2], s[4 * j + 3]);  // row g + 8
          if (!full) {
            bool ok0 = key < n, ok1 = key + 1 < n;
            if (KMASK) {  // skeep is 0 past the last key too
              ok0 = skeep[key] != 0;
              ok1 = skeep[key + 1] != 0;
            }
            const uint32_t keep = (ok0 ? 0x0000FFFFu : 0u) | (ok1 ? 0xFFFF0000u : 0u);
            p0 &= keep;
            p1 &= keep;
          }
          if (key == phantom_idx) {
            p0 = pack_bf16(weighted(lo_f(p0), phantom_w), hi_f(p0));
            p1 = pack_bf16(weighted(lo_f(p1), phantom_w), hi_f(p1));
          } else if (key + 1 == phantom_idx) {
            p0 = pack_bf16(lo_f(p0), weighted(hi_f(p0), phantom_w));
            p1 = pack_bf16(lo_f(p1), weighted(hi_f(p1), phantom_w));
          }
          rsum0 += lo_f(p0) + hi_f(p0);
          rsum1 += lo_f(p1) + hi_f(p1);
          pa[j >> 1][(j & 1) * 2] = p0;
          pa[j >> 1][(j & 1) * 2 + 1] = p1;
        }
      }

      // O += P V, slice by slice; completes under the next chunk's wait.
#pragma unroll
      for (int j = 0; j < 4; ++j) hopper::fence_regs<4>(pa[j]);
      hopper::fence_regs<HD / 2>(o);
      hopper::wgmma_fence();
#pragma unroll
      for (int sl = 0; sl < 4; ++sl)
        if (sl < nsl) {
          const uint64_t vd = v_desc<HD>(vc + sl * 16 * G::BOX_ROW);
          if constexpr (HD == 64)
            hopper::wgmma_m64n64k16_rs<1>(o, pa[sl], vd);
          else if constexpr (HD == 32)
            hopper::wgmma_m64n32k16_rs<1>(o, pa[sl], vd);
          else
            hopper::wgmma_m64n48k16_rs<1>(o, pa[sl], vd);
        }
      hopper::wgmma_commit();
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs<HD / 2>(o);
#pragma unroll
    for (int j = 0; j < 4; ++j) hopper::fence_regs<4>(pa[j]);

    rsum0 += __shfl_xor_sync(0xffffffffu, rsum0, 1);
    rsum0 += __shfl_xor_sync(0xffffffffu, rsum0, 2);
    rsum1 += __shfl_xor_sync(0xffffffffu, rsum1, 1);
    rsum1 += __shfl_xor_sync(0xffffffffu, rsum1, 2);
    const float inv0 = 1.0f / rsum0, inv1 = 1.0f / rsum1;
    const int r0 = t * CHUNK + warp * 16 + g, r1 = r0 + 8;
    __nv_bfloat16* obase = out + (long long)b * n * d + h * HD + t4 * 2;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      if (r0 < n)
        *reinterpret_cast<__nv_bfloat162*>(obase + (long long)r0 * d + j * 8) =
            __floats2bfloat162_rn(o[4 * j] * inv0, o[4 * j + 1] * inv0);
      if (r1 < n)
        *reinterpret_cast<__nv_bfloat162*>(obase + (long long)r1 * d + j * 8) =
            __floats2bfloat162_rn(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
  }
}

// Every fp32 bit pattern x (NaN and +-Inf included), as a logit: counts
// where exp2_terms(x, x) differs in either half from the scalar
// bf16(exp2f(bf16(clamp(x)))) of the earlier kernel (exp2_term), and keeps
// the first such x. counts: [mismatches, patterns checked, first x].
__global__ void ex2_check_kernel(unsigned long long* counts) {
  unsigned long long bad = 0, seen = 0;
  const unsigned long long total = 1ull << 32;
  for (unsigned long long i = blockIdx.x * (unsigned long long)blockDim.x + threadIdx.x;
       i < total; i += (unsigned long long)gridDim.x * blockDim.x) {
    const float x = __uint_as_float((uint32_t)i);
    const uint32_t want = __float_as_uint(exp2_term(x)) >> 16;
    const uint32_t got = exp2_terms(x, x);
    if ((got & 0xFFFFu) != want || (got >> 16) != want) {
      ++bad;
      atomicCAS(&counts[2], 0ull, i | (1ull << 32));
    }
    ++seen;
  }
  atomicAdd(&counts[0], bad);
  atomicAdd(&counts[1], seen);
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        sms < 1)
      sms = 132;
  }
  return sms;
}

int smem_for(int head_dim, int nchunks, int nwg) {
  return head_dim == 64   ? wg_smem<64>(nchunks, nwg)
         : head_dim == 48 ? wg_smem<48>(nchunks, nwg)
                          : wg_smem<32>(nchunks, nwg);
}

// The schedule for b images of n tokens and `heads` heads of head_dim:
// out[0] = 1 for the wgmma kernel (the head's K and V fit in shared
// memory beside the Q buffers), 0 for the kept mma.sync kernel; out[1] =
// CTAs per (image, head) (enough for two waves of CTAs on the card when
// the batch is small, at most one per warpgroup's tile); out[2] = the
// wgmma kernel's dynamic shared memory in bytes; out[3] = its warpgroups
// per CTA: 2, with two CTAs an SM, or 4 where K and V leave room for one
// CTA an SM only (so that 16 warps share each SM all the same). For the
// mma.sync kernel its own: ceil(n / 64) CTAs, no dynamic shared memory,
// one warpgroup of 4 warps. One rule at every head dim; at 48 it gives two
// warpgroups and two CTAs an SM up to 512 tokens, four warpgroups to
// 1,024, two warpgroups to 1,088 and the mma.sync kernel past that.
void plan(int b, int n, int heads, int head_dim, int* out) {
  const int nchunks = (n + CHUNK - 1) / CHUNK;
  int nwg = 2, smem = smem_for(head_dim, nchunks, 2);
  if (smem > MAX_SMEM) {  // the mma.sync kernel: one CTA of 4 warps per 64 query rows
    out[0] = 0;
    out[1] = nchunks;
    out[2] = 0;
    out[3] = 1;
    return;
  }
  out[0] = 1;
  if (smem > MAX_SMEM / 2 && smem_for(head_dim, nchunks, 4) <= MAX_SMEM) {
    nwg = 4;
    smem = smem_for(head_dim, nchunks, 4);
  }
  const long long heads_total = (long long)b * heads;
  const int per_sm = smem <= MAX_SMEM / 2 ? 2 : 1;
  const long long want = 2LL * sm_count() * per_sm;
  const long long x = (want + heads_total - 1) / heads_total;
  const int most = (nchunks + nwg - 1) / nwg;
  out[1] = (int)(x < 1 ? 1 : x > most ? most : x);
  out[2] = smem;
  out[3] = nwg;
}

template <int HD, bool KMASK, int NWG>
int launch_nwg(const CUtensorMap& map, const __nv_bfloat16* km, __nv_bfloat16* o, int b, int d,
               int n, int heads, float qscale, int phantom_idx, float phantom_w, const int* pl,
               cudaStream_t st) {
  auto kernel = attn_wgmma_kernel<HD, KMASK, NWG>;
  static bool sized = false;  // the attribute is set once per instance
  if (!sized) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  dim3 grid(pl[1], heads, b);
  kernel<<<grid, 128 * NWG, pl[2], st>>>(map, km, o, n, d, qscale,
                                         KMASK || phantom_idx < 0 ? -1 : phantom_idx, phantom_w);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_wgmma(const void* qkv, const __nv_bfloat16* km, __nv_bfloat16* o, int b, int n, int d,
                 int heads, float qscale, int phantom_idx, float phantom_w, const int* pl,
                 cudaStream_t st) {
  CUtensorMap map;
  const uint64_t dims[3] = {(uint64_t)(3 * d), (uint64_t)n, (uint64_t)b};
  const uint64_t strides[2] = {(uint64_t)d * 6, (uint64_t)d * 6 * n};
  const uint32_t box[3] = {Geo<HD>::BOX_COLS, CHUNK, 1};
  const CUtensorMapSwizzle sw = HD == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                : HD == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                           : CU_TENSOR_MAP_SWIZZLE_32B;
  if (!hopper::make_map_bf16(&map, qkv, 3, dims, strides, box, sw))
    return (int)cudaErrorInvalidValue;
  const bool four = pl[3] == 4;
  if (km != nullptr)
    return four
               ? launch_nwg<HD, true, 4>(map, km, o, b, d, n, heads, qscale, -1, phantom_w, pl, st)
               : launch_nwg<HD, true, 2>(map, km, o, b, d, n, heads, qscale, -1, phantom_w, pl, st);
  return four ? launch_nwg<HD, false, 4>(map, km, o, b, d, n, heads, qscale, phantom_idx,
                                         phantom_w, pl, st)
              : launch_nwg<HD, false, 2>(map, km, o, b, d, n, heads, qscale, phantom_idx,
                                         phantom_w, pl, st);
}

}  // namespace

// qkv: (b, n, 3d) bf16 packed as [q | k | v] with head h at columns
// h*head_dim, 16-byte aligned; out: (b, n, d) bf16. head_dim must be 64,
// 32 or 48 and d = num_heads * head_dim (the wrapper checks). qscale =
// head_dim^-0.5 * log2(e). phantom_idx < 0 (no phantom key) or in [0, n);
// phantom_mult is rounded to bf16 here. kmask: null, or (b, n) bf16 (1 =
// attend), and then phantom_idx < 0. The kernel is chosen by shape
// (peekvit_attn_scores_pv_plan). Returns the cudaError_t of the launch.
extern "C" int peekvit_attn_scores_pv(const void* qkv, void* out, const void* kmask, int b,
                                      int n, int d, int num_heads, int head_dim, float qscale,
                                      int phantom_idx, float phantom_mult, void* stream) {
  if (b == 0 || n == 0) return 0;
  if ((head_dim != 64 && head_dim != 32 && head_dim != 48) || d != num_heads * head_dim ||
      phantom_idx >= n ||
      (kmask != nullptr && phantom_idx >= 0))
    return (int)cudaErrorInvalidValue;
  const float phantom_w = __bfloat162float(__float2bfloat16_rn(phantom_mult));
  const auto* q = static_cast<const __nv_bfloat16*>(qkv);
  const auto* km = static_cast<const __nv_bfloat16*>(kmask);
  auto* o = static_cast<__nv_bfloat16*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int pl[4];
  plan(b, n, num_heads, head_dim, pl);
  if (pl[0]) {
    if (head_dim == 48)
      return launch_wgmma<48>(qkv, km, o, b, n, d, num_heads, qscale, phantom_idx, phantom_w, pl,
                              st);
    return head_dim == 64 ? launch_wgmma<64>(qkv, km, o, b, n, d, num_heads, qscale, phantom_idx,
                                             phantom_w, pl, st)
                          : launch_wgmma<32>(qkv, km, o, b, n, d, num_heads, qscale, phantom_idx,
                                             phantom_w, pl, st);
  }
  if (head_dim == 48)
    return launch<48>(q, km, o, b, n, d, num_heads, qscale, phantom_idx, phantom_w, st);
  return head_dim == 64
             ? launch<64>(q, km, o, b, n, d, num_heads, qscale, phantom_idx, phantom_w, st)
             : launch<32>(q, km, o, b, n, d, num_heads, qscale, phantom_idx, phantom_w, st);
}

// The schedule peekvit_attn_scores_pv takes for b images of n tokens and
// num_heads heads of head_dim: out[0] = 1 (the wgmma kernel) or 0 (the
// kept mma.sync kernel), out[1] = CTAs per (image, head), out[2] = the
// wgmma kernel's dynamic shared memory in bytes, out[3] = its warpgroups
// per CTA (for the mma.sync kernel its own: ceil(n / 64) CTAs, no dynamic
// shared memory, one warpgroup). Returns 0.
extern "C" int peekvit_attn_scores_pv_plan(int b, int n, int num_heads, int head_dim, int* out) {
  plan(b, n, num_heads, head_dim, out);
  return 0;
}

// The exhaustive check of the packed exp2 terms against the earlier
// kernel's scalar ones over all 2^32 fp32 logits: counts (3 x u64 on the
// card, zeroed by the caller) gets [mismatches, patterns checked, 2^32 +
// the first mismatching pattern or 0]. Returns the cudaError_t.
extern "C" int peekvit_attn_scores_pv_ex2_check(void* counts, void* stream) {
  ex2_check_kernel<<<4 * sm_count(), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(counts));
  return (int)cudaGetLastError();
}
