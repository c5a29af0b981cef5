// Per-head attention over packed qkv with the trainable block's softmax.
//
// Replaces the attention core of peekvit_tpu/ops/pallas/
// fused_attention_vjp.py:49 _attn_fwd_kernel (:65-82), the forward of
// attention_block_trainable: softmax(q k^T * scale) v per image and head,
// with the Pallas numerics kept:
//   - logits = (q . k^T) accumulated in fp32, then multiplied by scale;
//   - softmax in fp32 with the row max subtracted: e = exp(x - max),
//     s = e / sum(e);
//   - s is rounded to bf16 BEFORE the PV product, s_bf16 . v accumulates
//     in fp32 and the output is rounded to bf16.
// Because P is normalised before PV, the whole row of logits is needed
// before any PV product: no online rescaling.
//
// q, k and v are addressed by three base pointers and their row strides,
// so the same kernels carry peekvit_tpu/ops/pallas/fused_attention.py:220
// fused_attention (_attn_kernel :168, separate (B, N, D) q, k, v; row
// stride D; its padding to 128 is a TPU layout artefact) and the
// attention of fused_layer_vjp.py:560 _sp_tail_call (_sp_tail_math
// :478-514, the sequence-parallel tail): n_q local queries against n_k
// gathered keys under a per-image key mask (B, n_k) fp32, 1 = attend; an
// excluded key, like a key past n_k, has logit -inf before the row max.
// The packed mode passes qkv, qkv + D, qkv + 2D and stride 3D.
//
// Bound on H100: at ViT-B bs256 (N = 197, head dim 64) the two products
// are 4 * N * N * 64 flops per (image, head), 3.1e10 in all (0.031 ms of
// bf16 tensor time), against 310 MB of q, k, v and output (0.0925 ms):
// bytes bound it. What costs time in practice is the work per logit
// (max, exp, sum, scale, pack) and the latency of loading a head.
//
// Design for n_k <= 256 (attn_wgmma_kernel; every path the port runs:
// N = 197 / 198, n_k 198 / 200 in the SP tail): one CTA of one warpgroup
// per (image, head, 256 query rows). Thread 0 loads the head's K and V
// once per CTA, and up to four 64-row Q tiles, by TMA (3-D tensor maps
// over (column, token, image), 128-byte swizzle: a head row is 128
// bytes) onto three mbarriers: Q tile 0 with K first, the other Q tiles,
// then V, so the first product starts while V and the later Q tiles are
// still in flight. Keys are padded to a multiple of 16 (NT chunks of 16,
// a template argument: N = 197 becomes 208), the rows past n_k read as
// zero. Per 64-row query tile, in one pass:
//   S = Q K^T: Q's fragments by ldmatrix from the swizzled tile (register
//     A operand), K in shared memory K-major, 4 x NT wgmma m64n16k16;
//     the whole row of logits stays in registers (8 NT fp32 a thread);
//   the row max (quad shuffles), exp once, the sum, one reciprocal per
//     row, the normalised bf16 P packed in registers as wgmma's A
//     operand;
//   O = P V: NT wgmma m64n64k16 with V in shared memory as the MN-major
//     (transposed) B operand, the fp32 O rounded to bf16 on store.
// So Q K^T is computed once per logit and exp once (the key-tiled kernel
// below computes both twice). 96 KB of shared memory and ~140 registers a
// thread: two CTAs per SM.
// Numerics decisions: exp is taken as exp2f of the raw logit times
// scale * log2(e) less the raw row max times the same factor (one FFMA and
// one MUFU.EX2 a logit; the max commutes with the positive scale), and
// the division is one IEEE reciprocal per row and one multiply a logit;
// both move P by about an fp32 ulp before its bf16 rounding (2^-9). Both
// were taken for their instruction count (expf is a few FMAs around the
// same MUFU.EX2, a division several instructions a logit); the kernel's
// time with expf and a division per logit instead was not measured.
// The key mask (and the n_k edge) becomes 64 register bits per thread
// once per CTA: a thread's key columns are fixed by the fragment layout.
// A row's max is taken over all its keys at once, so a fully excluded run
// of keys needs no guard; a row with one attended key gets the plain
// version's softmax wherever that key sits.
//
// Every other shape takes the key-tiled kernel (attn_tiled_fwd_kernel, a
// template on the head dim, 32 or 64, and on the mask): head dim 32 at
// any n_k (ViT-Ti and RankViT at 160 px: 401 tokens; at 224 px: 785) and
// head dim 64 past 256 keys (ResidualViT: 402 and 786), in all three
// modes (packed, separate, the masked rectangular SP tail). Grid (pair of
// 64-row query tiles, head, image), 288 threads: two consumer warpgroups
// of 64 query rows and one producer warp. The producer loads both Q tiles
// by TMA and then streams K (pass 1) and K and V (pass 2) in 64-key stages
// through a ring of four slots (3-D tensor maps over (column, token,
// image): keys past n_k load as zeros; 128-byte swizzle at head dim 64,
// 64-byte at 32, where a row is 64 bytes), each slot with a `full` and an
// `empty` mbarrier: both warpgroups read every stage, so K and V are
// fetched once per 128 query rows, and nothing waits on a CTA-wide
// barrier. Per stage:
//   pass 1: S = Q K^T by wgmma m64n64k16 (Q's fragments the register A
//     operand at head dim 32; at 64 Q read from its tile, which keeps the
//     kernel at two CTAs an SM without a spill), the key mask as bits, the
//     stage's row max and the running sum rescaled to the new max: one
//     exponential a logit;
//   pass 2: S again, P = bf16(exp2(...) * (1 / sum)) packed in registers as
//     the A operand of O += P V (wgmma m64n{64,32}k16, V MN-major); a
//     stage's P V completes under the next stage's wait, which releases
//     its slot.
// Numerics decisions (stated also in PERF.md): the exponent is the wgmma
// kernel's FFMA form above, exp2 is ex2.approx.ftz (MUFU.EX2 alone:
// exp2f's result wherever that is a normal float, a term below 2^-126
// flushed to 0), and the division is one IEEE reciprocal per row and a
// multiply a logit. The running sum sums each stage's terms, then adds
// them to the rescaled sum. P is still normalised before its bf16
// rounding, as the contract asks.
// The key mask (and the n_k edge, last stage only) becomes 64 bits a
// stage from a per-CTA bitmap built by ballots; excluded keys have logit
// -inf. A stage wholly excluded adds exp2(-inf) = 0 once a row has seen a
// key, and before that the exponent's base is 0 (the masked instance), so
// no NaN. 82 KB (head dim 64) or 41 KB (32) of shared memory, 82-90
// registers: two CTAs an SM.
// Bound at ViT-Ti bs128 (N = 401, head dim 32, 8 heads): q, k, v and the
// output are 105 MB (0.031 ms) against 2.1e10 flops (0.021 ms), but each
// pass takes 1.65e8 exponentials, 0.039 ms at the SFU's rate: the two
// passes' exponentials bound it.
//
// The choice between the two is by shape inside the entry point
// (peekvit_attn_softmax_fwd_route), never a fallback on error.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int HD = 64;  // the wgmma kernel's head dim
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

// ------------------------------------------------------- the wgmma kernel

constexpr int WG_QTILES = 4;          // 64-row query tiles per CTA
constexpr int WG_QBYTES = 64 * 128;   // one swizzled Q tile
constexpr int WG_MAX_KEYS = 256;

// Bit (r & 1) | ((r >> 2) << 1) of a 16-key chunk: the key column of
// accumulator register r of wgmma m64n16 (r = 0, 1: row g, columns 2t,
// 2t + 1; r = 2, 3: row g + 8, the same columns; r = 4..7: columns 8 + 2t,
// 9 + 2t).
__device__ __forceinline__ int key_bit(int r) { return (r & 1) | ((r >> 2) << 1); }

template <int NT, bool MASK>
__global__ void __launch_bounds__(128)
attn_wgmma_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ out,
                  const float* __restrict__ kmask, int nq, int nk, int d, float scale_log2e) {
  constexpr int KV_BYTES = NT * 16 * 128;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t sq = (raw + 1023) & ~1023u;  // 1024-aligned for the swizzle
  const uint32_t sk = sq + WG_QTILES * WG_QBYTES;
  const uint32_t sv = sk + KV_BYTES;
  const uint32_t bars = sv + KV_BYTES;  // three mbarriers: Q0 + K, Q1-3, V

  const int q0 = blockIdx.x * WG_QTILES * 64, h = blockIdx.y, b = blockIdx.z;
  const int left = (nq - q0 + 63) / 64;
  const int ntq = left < WG_QTILES ? left : WG_QTILES;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) hopper::mbar_init(bars + 8 * i, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_expect_tx(bars, WG_QBYTES + KV_BYTES);
    hopper::tma_load_3d(sq, &qmap, h * 64, q0, b, bars);
    hopper::tma_load_3d(sk, &kmap, h * 64, 0, b, bars);
    if (ntq > 1) {
      hopper::mbar_expect_tx(bars + 8, (ntq - 1) * WG_QBYTES);
      for (int t = 1; t < ntq; ++t)
        hopper::tma_load_3d(sq + t * WG_QBYTES, &qmap, h * 64, q0 + 64 * t, b, bars + 8);
    }
    hopper::mbar_expect_tx(bars + 16, KV_BYTES);
    hopper::tma_load_3d(sv, &vmap, h * 64, 0, b, bars + 16);
  }

  // The thread's key columns, attended or not: bit 4 j + key_bit(r).
  uint64_t keep = 0;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = 16 * j + (e >> 1) * 8 + 2 * t4 + (e & 1);
      bool ok = key < nk;
      if constexpr (MASK) ok = ok && kmask[(long long)b * nk + key] > 0.f;
      keep |= (uint64_t)ok << (4 * j + e);
    }

  for (int t = 0; t < ntq; ++t) {
    hopper::mbar_wait(t == 0 ? bars : bars + 8, 0);
    // Q's fragments (register A operand) from the swizzled tile.
    uint32_t qa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int r = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
      const int chunk = 2 * kk + (lane >> 4);
      const uint32_t addr = sq + t * WG_QBYTES + r * 128 + ((chunk ^ (r & 7)) << 4);
      asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                   : "=r"(qa[kk][0]), "=r"(qa[kk][1]), "=r"(qa[kk][2]), "=r"(qa[kk][3])
                   : "r"(addr));
    }
    float s[NT][8];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 8; ++r) s[j][r] = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) hopper::fence_regs<8>(s[j]);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < NT; ++j)
        hopper::wgmma_m64n16k16_rs<0>(s[j], qa[kk],
                                      hopper::desc_sw128(sk + j * 2048 + kk * 32, 16, 1024));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < NT; ++j) hopper::fence_regs<8>(s[j]);

    // Rows g (registers 0, 1, 4, 5) and g + 8 (2, 3, 6, 7).
    float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float x = (keep >> (4 * j + key_bit(r))) & 1 ? s[j][r] : -INFINITY;
        s[j][r] = x;
        if ((r >> 1) & 1)
          m1 = fmaxf(m1, x);
        else
          m0 = fmaxf(m0, x);
      }
    m0 = quad_max(m0);
    m1 = quad_max(m1);
    const float b0 = -m0 * scale_log2e, b1 = -m1 * scale_log2e;
    float l0 = 0.f, l1 = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const bool hi = (r >> 1) & 1;
        const float e = exp2f(fmaf(s[j][r], scale_log2e, hi ? b1 : b0));
        s[j][r] = e;
        if (hi)
          l1 += e;
        else
          l0 += e;
      }
    const float i0 = 1.f / quad_sum(l0), i1 = 1.f / quad_sum(l1);
    uint32_t pa[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      pa[j][0] = pack_bf16(s[j][0] * i0, s[j][1] * i0);
      pa[j][1] = pack_bf16(s[j][2] * i1, s[j][3] * i1);
      pa[j][2] = pack_bf16(s[j][4] * i0, s[j][5] * i0);
      pa[j][3] = pack_bf16(s[j][6] * i1, s[j][7] * i1);
    }

    if (t == 0) hopper::mbar_wait(bars + 16, 0);
    float o[32];
#pragma unroll
    for (int r = 0; r < 32; ++r) o[r] = 0.f;
    hopper::fence_regs<32>(o);
#pragma unroll
    for (int j = 0; j < NT; ++j) hopper::fence_regs<4>(pa[j]);
    hopper::wgmma_fence();
#pragma unroll
    for (int j = 0; j < NT; ++j)
      hopper::wgmma_m64n64k16_rs<1>(o, pa[j], hopper::desc_sw128(sv + j * 2048, 1024, 1024));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs<32>(o);
#pragma unroll
    for (int j = 0; j < NT; ++j) hopper::fence_regs<4>(pa[j]);

    const int r0 = q0 + t * 64 + warp * 16 + g, r1 = r0 + 8;
    __nv_bfloat16* obase = out + (long long)b * nq * d + h * HD + t4 * 2;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (r0 < nq)
        *reinterpret_cast<__nv_bfloat162*>(obase + (long long)r0 * d + j * 8) =
            __floats2bfloat162_rn(o[4 * j], o[4 * j + 1]);
      if (r1 < nq)
        *reinterpret_cast<__nv_bfloat162*>(obase + (long long)r1 * d + j * 8) =
            __floats2bfloat162_rn(o[4 * j + 2], o[4 * j + 3]);
    }
  }
}

template <int NT, bool MASK>
int launch_wgmma(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm,
                 __nv_bfloat16* out, const float* kmask, int b, int nq, int nk, int d, int heads,
                 float scale_log2e, cudaStream_t stream) {
  const int smem = 1024 + WG_QTILES * WG_QBYTES + 2 * NT * 16 * 128 + 64;
  auto kernel = attn_wgmma_kernel<NT, MASK>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((nq + WG_QTILES * 64 - 1) / (WG_QTILES * 64), heads, b);
  kernel<<<grid, 128, smem, stream>>>(qm, km, vm, out, kmask, nq, nk, d, scale_log2e);
  return (int)cudaGetLastError();
}

template <bool MASK>
int dispatch_wgmma(int nt, const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm,
                   __nv_bfloat16* out, const float* kmask, int b, int nq, int nk, int d, int heads,
                   float sl2e, cudaStream_t st) {
  switch (nt) {
#define PEEKVIT_NT(n) \
  case n:             \
    return launch_wgmma<n, MASK>(qm, km, vm, out, kmask, b, nq, nk, d, heads, sl2e, st);
    PEEKVIT_NT(1) PEEKVIT_NT(2) PEEKVIT_NT(3) PEEKVIT_NT(4) PEEKVIT_NT(5) PEEKVIT_NT(6)
    PEEKVIT_NT(7) PEEKVIT_NT(8) PEEKVIT_NT(9) PEEKVIT_NT(10) PEEKVIT_NT(11) PEEKVIT_NT(12)
    PEEKVIT_NT(13) PEEKVIT_NT(14) PEEKVIT_NT(15) PEEKVIT_NT(16)
#undef PEEKVIT_NT
  }
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------- the key-tiled kernel

constexpr int TL = 64;                         // keys a stage, query rows a warpgroup
constexpr int TL_STAGES = 4;                   // stages of the K / V ring
constexpr int TL_CONSUMERS = 256;              // two warpgroups of 64 query rows
constexpr int TL_THREADS = TL_CONSUMERS + 32;  // and the producer warp

// Bytes of one 64-row tile of K, V or Q (TMA's box {HD, 64}).
template <int HD>
__host__ __device__ constexpr int tile_bytes() {
  return TL * 2 * HD;
}

// Dynamic shared memory of the key-tiled kernel: two Q tiles, the ring's
// K and V tiles, its mbarriers and the key mask's bits (8 bytes a stage;
// mask_stages is 0 without a mask).
template <int HD>
int tiled_smem(int mask_stages) {
  return 1024 + (2 + 2 * TL_STAGES) * tile_bytes<HD>() + (2 * TL_STAGES + 1) * 8 +
         8 * mask_stages;
}

// The thread's key columns of 64-key stage c, bit 8 j + e for accumulator
// registers 4 j + 2 h + e (column 8 j + 2 t4 + e): attended and below n_k.
template <bool MASK>
__device__ __forceinline__ uint64_t stage_keys(const uint32_t* keep, int c, int nk, int t4) {
  if constexpr (MASK) {
    const uint64_t kb = (uint64_t)keep[2 * c] | ((uint64_t)keep[2 * c + 1] << 32);
    return kb >> (2 * t4);
  } else {
    const int lim = nk - c * TL - 2 * t4;
    return lim >= 64 ? ~0ull : lim <= 0 ? 0ull : (1ull << lim) - 1;
  }
}
__device__ __forceinline__ void mask_keys(float* s, uint64_t kb) {
#pragma unroll
  for (int r = 0; r < 32; ++r)
    if (!((kb >> (8 * (r >> 2) + (r & 1))) & 1)) s[r] = -INFINITY;
}

// s (m64n64 accumulators, zeroed here) = Q K^T for the warpgroup's 64 query
// rows and a stage's 64 keys; issued, not waited for. Q is the register A
// operand at head dim 32 (qa) and read from its tile sq at 64, where its
// 16 registers a thread would not fit beside S, O and P at two CTAs an SM.
template <int HD>
__device__ __forceinline__ void stage_logits(float* s, uint32_t (*qa)[4], uint32_t sq,
                                             uint32_t sk) {
#pragma unroll
  for (int r = 0; r < 32; ++r) s[r] = 0.f;
  hopper::fence_regs<32>(s);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    if constexpr (HD == 64)
      hopper::wgmma_m64n64k16_ss<0, 0>(s, hopper::desc_kmajor<HD>(sq + kk * 32),
                                       hopper::desc_kmajor<HD>(sk + kk * 32));
    else
      hopper::wgmma_m64n64k16_rs<0>(s, qa[kk], hopper::desc_kmajor<HD>(sk + kk * 32));
  }
  hopper::wgmma_commit();
}

// Grid (pair of 64-row query tiles, head, image); 288 threads: warps 0-7
// are two consumer warpgroups (query tiles 2 x and 2 x + 1), warp 8 the
// producer. The producer's lane 0 loads both Q tiles onto one mbarrier,
// then K (pass 1) and K and V (pass 2) of every 64-key stage through a
// ring of TL_STAGES slots by TMA: a slot's `full` barrier takes the bytes,
// its `empty` barrier one arrival from each consumer warp once the wgmma
// that read it has completed, and the producer refills the slot only
// then. Both warpgroups read each stage, so K and V are fetched once per
// 128 query rows.
template <int HD, bool MASK>
__global__ void __launch_bounds__(TL_THREADS, 2)
attn_tiled_fwd_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ out,
                      const float* __restrict__ kmask, int nq, int nk, int d, float scale_log2e) {
  constexpr int TB = tile_bytes<HD>();
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t sq = (raw + 1023) & ~1023u;  // 1024-aligned for the swizzle
  const uint32_t sk = sq + 2 * TB;
  const uint32_t sv = sk + TL_STAGES * TB;
  const uint32_t full = sv + TL_STAGES * TB, empty = full + 8 * TL_STAGES;
  const uint32_t qbar = empty + 8 * TL_STAGES;
  uint32_t* keep = reinterpret_cast<uint32_t*>(smem_raw + (qbar + 8 - raw));

  const int q0 = blockIdx.x * 2 * TL, h = blockIdx.y, b = blockIdx.z;
  const int nwg = nq - q0 > TL ? 2 : 1;  // warpgroups with query rows
  const int ns = (nk + TL - 1) / TL;     // 64-key stages a pass
  const int tid = threadIdx.x, lane = tid & 31;

  if (tid == 0) {
    for (int i = 0; i < TL_STAGES; ++i) {
      hopper::mbar_init(full + 8 * i, 1);
      hopper::mbar_init(empty + 8 * i, 4 * nwg);
    }
    hopper::mbar_init(qbar, 1);
    hopper::mbar_fence_init();
  }
  if constexpr (MASK) {  // one bit a key, 0 past n_k: a ballot per 32 keys
    for (int w = tid >> 5; w < 2 * ns; w += TL_THREADS / 32) {
      const int key = 32 * w + lane;
      const uint32_t bits =
          __ballot_sync(0xffffffffu, key < nk && kmask[(long long)b * nk + key] > 0.f);
      if (lane == 0) keep[w] = bits;
    }
  }
  __syncthreads();

  if (tid >= TL_CONSUMERS) {  // the producer warp
    if (tid == TL_CONSUMERS) {
      hopper::mbar_expect_tx(qbar, nwg * TB);
      for (int w = 0; w < nwg; ++w)
        hopper::tma_load_3d(sq + w * TB, &qmap, h * HD, q0 + TL * w, b, qbar);
      for (int it = 0; it < 2 * ns; ++it) {  // pass 1: K; pass 2: K and V
        const int slot = it % TL_STAGES, c = it < ns ? it : it - ns;
        if (it >= TL_STAGES) hopper::mbar_wait(empty + 8 * slot, (it / TL_STAGES - 1) & 1);
        const uint32_t bar = full + 8 * slot;
        hopper::mbar_expect_tx(bar, (it < ns ? 1 : 2) * TB);
        hopper::tma_load_3d(sk + slot * TB, &kmap, h * HD, c * TL, b, bar);
        if (it >= ns) hopper::tma_load_3d(sv + slot * TB, &vmap, h * HD, c * TL, b, bar);
      }
    }
    return;
  }

  const int w = tid >> 7, warp = (tid >> 5) & 3, g = lane >> 2, t4 = lane & 3;
  if (w >= nwg) return;
  auto release = [&](int slot) {
    if (lane == 0) hopper::mbar_arrive(empty + 8 * slot);
  };
  hopper::mbar_wait(qbar, 0);
  const uint32_t myq = sq + w * TB;
  uint32_t qa[HD / 16][4];
  if constexpr (HD == 32) hopper::ldmatrix_a<HD>(qa, myq, warp * 16, lane);

  // Pass 1: each row's max (of the raw logits: the scale is positive) and
  // its sum of exp2(x * scale log2 e - max * scale log2 e), online per
  // stage; rows g (registers 4 j + e) and g + 8 (4 j + 2 + e). A row that
  // has seen no attended key (MASK) keeps the exponent's base at 0, so its
  // terms are exp2(-inf) = 0 and no NaN arises.
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float s[32];
  for (int c = 0; c < ns; ++c) {
    const int slot = c % TL_STAGES;
    hopper::mbar_wait(full + 8 * slot, (c / TL_STAGES) & 1);
    stage_logits<HD>(s, qa, myq, sk + slot * TB);
    hopper::wgmma_wait<0>();
    hopper::fence_regs<32>(s);
    release(slot);
    if (MASK || c == ns - 1) mask_keys(s, stage_keys<MASK>(keep, c, nk, t4));
    float c0 = -INFINITY, c1 = -INFINITY;
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      if ((r >> 1) & 1)
        c1 = fmaxf(c1, s[r]);
      else
        c0 = fmaxf(c0, s[r]);
    }
    const float n0 = fmaxf(m0, quad_max(c0)), n1 = fmaxf(m1, quad_max(c1));
    const float b0 = MASK && n0 == -INFINITY ? 0.f : -n0 * scale_log2e;
    const float b1 = MASK && n1 == -INFINITY ? 0.f : -n1 * scale_log2e;
    float e0 = 0.f, e1 = 0.f;
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      if ((r >> 1) & 1)
        e1 += hopper::ex2(fmaf(s[r], scale_log2e, b1));
      else
        e0 += hopper::ex2(fmaf(s[r], scale_log2e, b0));
    }
    l0 = fmaf(l0, hopper::ex2(fmaf(m0, scale_log2e, b0)), e0);
    l1 = fmaf(l1, hopper::ex2(fmaf(m1, scale_log2e, b1)), e1);
    m0 = n0;
    m1 = n1;
  }
  const float i0 = 1.f / quad_sum(l0), i1 = 1.f / quad_sum(l1);
  const float b0 = MASK && m0 == -INFINITY ? 0.f : -m0 * scale_log2e;
  const float b1 = MASK && m1 == -INFINITY ? 0.f : -m1 * scale_log2e;

  // Pass 2: P = bf16(exp2(x * scale log2 e - max * scale log2 e) / sum), the
  // register A operand of O += P V (V MN-major). A stage's P V completes
  // under the next stage's wait, and its slot is released then.
  float o[HD / 2];
#pragma unroll
  for (int r = 0; r < HD / 2; ++r) o[r] = 0.f;
  uint32_t pa[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) pa[j][e] = 0u;
  int prev = 0;
  for (int c = 0; c < ns; ++c) {
    const int it = ns + c, slot = it % TL_STAGES;
    hopper::mbar_wait(full + 8 * slot, (it / TL_STAGES) & 1);
    stage_logits<HD>(s, qa, myq, sk + slot * TB);
    hopper::wgmma_wait<0>();  // this S, and the previous stage's P V
    hopper::fence_regs<32>(s);
    hopper::fence_regs<HD / 2>(o);
#pragma unroll
    for (int j = 0; j < 4; ++j) hopper::fence_regs<4>(pa[j]);
    if (c > 0) release(prev);
    if (MASK || c == ns - 1) mask_keys(s, stage_keys<MASK>(keep, c, nk, t4));
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p0 = hopper::ex2(fmaf(s[4 * j], scale_log2e, b0)) * i0;
      const float p1 = hopper::ex2(fmaf(s[4 * j + 1], scale_log2e, b0)) * i0;
      const float p2 = hopper::ex2(fmaf(s[4 * j + 2], scale_log2e, b1)) * i1;
      const float p3 = hopper::ex2(fmaf(s[4 * j + 3], scale_log2e, b1)) * i1;
      pa[j >> 1][(j & 1) * 2] = pack_bf16(p0, p1);
      pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) hopper::fence_regs<4>(pa[j]);
    hopper::fence_regs<HD / 2>(o);
    hopper::wgmma_fence();
#pragma unroll
    for (int sl = 0; sl < 4; ++sl)
      hopper::wgmma_m64nhd_rs_mn<HD>(
          o, pa[sl], hopper::desc_mnmajor<HD>(sv + slot * TB + sl * 16 * 2 * HD));
    hopper::wgmma_commit();
    hopper::fence_regs<HD / 2>(o);
    prev = slot;
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs<HD / 2>(o);
#pragma unroll
  for (int j = 0; j < 4; ++j) hopper::fence_regs<4>(pa[j]);

  const int r0 = q0 + TL * w + warp * 16 + g, r1 = r0 + 8;
  __nv_bfloat16* obase = out + (long long)b * nq * d + h * HD + t4 * 2;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    if (r0 < nq)
      *reinterpret_cast<__nv_bfloat162*>(obase + (long long)r0 * d + j * 8) =
          __floats2bfloat162_rn(o[4 * j], o[4 * j + 1]);
    if (r1 < nq)
      *reinterpret_cast<__nv_bfloat162*>(obase + (long long)r1 * d + j * 8) =
          __floats2bfloat162_rn(o[4 * j + 2], o[4 * j + 3]);
  }
}

// Tensor maps over (column, token, image) of q, k and v (each image's rows
// past nq / nk load as zeros), then the launch.
template <int HD>
int launch_tiled(const void* q, const void* k, const void* v, __nv_bfloat16* out,
                 const float* kmask, int b, int nq, int nk, int d, int q_stride, int kv_stride,
                 int heads, float scale_log2e, cudaStream_t stream) {
  CUtensorMap qmap, kmap, vmap;
  const uint64_t qdims[3] = {(uint64_t)d, (uint64_t)nq, (uint64_t)b};
  const uint64_t qstr[2] = {(uint64_t)q_stride * 2, (uint64_t)q_stride * 2 * nq};
  const uint64_t kdims[3] = {(uint64_t)d, (uint64_t)nk, (uint64_t)b};
  const uint64_t kstr[2] = {(uint64_t)kv_stride * 2, (uint64_t)kv_stride * 2 * nk};
  const uint32_t box[3] = {HD, TL, 1};
  const CUtensorMapSwizzle sw = HD == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  if (!hopper::make_map_bf16(&qmap, q, 3, qdims, qstr, box, sw) ||
      !hopper::make_map_bf16(&kmap, k, 3, kdims, kstr, box, sw) ||
      !hopper::make_map_bf16(&vmap, v, 3, kdims, kstr, box, sw))
    return (int)cudaErrorInvalidValue;
  const int ns = (nk + TL - 1) / TL;
  const int smem = tiled_smem<HD>(kmask ? ns : 0);
  auto kernel = kmask ? attn_tiled_fwd_kernel<HD, true> : attn_tiled_fwd_kernel<HD, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((nq + 2 * TL - 1) / (2 * TL), heads, b);
  kernel<<<grid, TL_THREADS, smem, stream>>>(qmap, kmap, vmap, out, kmask, nq, nk, d,
                                             scale_log2e);
  return (int)cudaGetLastError();
}

// The kernel peekvit_attn_softmax_fwd runs at n_k keys and this head dim,
// with or without a key mask: 1 the wgmma kernel, 2 the key-tiled kernel,
// -1 none.
int fwd_route(int nk, int head_dim) {
  if (head_dim == 64 && nk <= WG_MAX_KEYS) return 1;
  return head_dim == 32 || head_dim == 64 ? 2 : -1;
}

}  // namespace

// q: row r of image b at q + (b * nq + r) * q_stride, k and v at base +
// (b * nk + r) * kv_stride, head h at columns h*head_dim (packed qkv: qkv,
// qkv + d, qkv + 2d and both strides 3d, nq = nk; separate (b, n, d)
// tensors: strides d; the SP tail: q a slice of the local qkv, stride 3d,
// k and v of the gathered kv, stride 2d); out: (b, nq, d) bf16. kmask:
// null, or (b, nk) fp32 with 1 = attend (the MASK instances). The head
// dim is d / num_heads and must be 32 or 64; the pointers must be 16-byte
// aligned and the strides multiples of 8 (the wrappers check). The kernel
// is chosen by shape (peekvit_attn_softmax_fwd_route): at head dim 64 the
// wgmma kernel up to 256 keys, else the key-tiled kernel (head dim 32 at
// any nk, head dim 64 past 256). scale = head_dim^-0.5. Returns the
// cudaError_t of the launch.
extern "C" int peekvit_attn_softmax_fwd(const void* q, const void* k, const void* v, void* out,
                                        const void* kmask, int b, int nq, int nk, int d,
                                        int q_stride, int kv_stride, int num_heads, float scale,
                                        void* stream) {
  if (b == 0 || nq == 0) return 0;
  if (nk == 0 || num_heads <= 0 || d % num_heads != 0 || q_stride < d || kv_stride < d)
    return (int)cudaErrorInvalidValue;
  const int head_dim = d / num_heads;
  const int route = fwd_route(nk, head_dim);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  const float* km = static_cast<const float*>(kmask);
  const float sl2e = scale * 1.4426950408889634f;
  if (route == 2)
    return head_dim == 32
               ? launch_tiled<32>(q, k, v, o, km, b, nq, nk, d, q_stride, kv_stride, num_heads,
                                  sl2e, st)
               : launch_tiled<64>(q, k, v, o, km, b, nq, nk, d, q_stride, kv_stride, num_heads,
                                  sl2e, st);
  if (route != 1) return (int)cudaErrorInvalidValue;
  const int nt = (nk + 15) / 16;
  CUtensorMap qmap, kmap, vmap;
  const uint64_t qdims[3] = {(uint64_t)d, (uint64_t)nq, (uint64_t)b};
  const uint64_t qstr[2] = {(uint64_t)q_stride * 2, (uint64_t)q_stride * 2 * nq};
  const uint64_t kdims[3] = {(uint64_t)d, (uint64_t)nk, (uint64_t)b};
  const uint64_t kstr[2] = {(uint64_t)kv_stride * 2, (uint64_t)kv_stride * 2 * nk};
  const uint32_t qbox[3] = {64, 64, 1}, kbox[3] = {64, (uint32_t)(16 * nt), 1};
  if (!hopper::make_map_bf16(&qmap, q, 3, qdims, qstr, qbox) ||
      !hopper::make_map_bf16(&kmap, k, 3, kdims, kstr, kbox) ||
      !hopper::make_map_bf16(&vmap, v, 3, kdims, kstr, kbox))
    return (int)cudaErrorInvalidValue;
  return km ? dispatch_wgmma<true>(nt, qmap, kmap, vmap, o, km, b, nq, nk, d, num_heads, sl2e, st)
            : dispatch_wgmma<false>(nt, qmap, kmap, vmap, o, km, b, nq, nk, d, num_heads, sl2e,
                                    st);
}

// Which kernel peekvit_attn_softmax_fwd runs at nk keys and this head dim,
// with or without a key mask: 1 the wgmma kernel, 2 the key-tiled kernel,
// -1 none (the head dim is neither 32 nor 64).
extern "C" int peekvit_attn_softmax_fwd_route(int nk, int head_dim) {
  return fwd_route(nk, head_dim);
}
