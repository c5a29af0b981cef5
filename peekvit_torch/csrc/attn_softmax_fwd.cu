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
// below computes both twice and divides per logit). 96 KB of shared
// memory and ~140 registers a thread: two CTAs per SM.
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
// head dim 64 past 256 keys (ResidualViT: 402 and 786). Grid (query tile
// of 64, head, image), four warps of 16 query rows with mma.sync, K (pass
// 1) and K and V (pass 2) streamed through two shared buffers of 64 keys
// each by cp.async, the next tile in flight while the warps work on this
// one. Pass 1 takes each row's max and sum online, pass 2 forms the
// normalised bf16 P (expf and a division per logit: the same P as the
// backward recomputes) and multiplies. Keys past n_k and excluded
// keys have logit -inf; a tile wholly excluded adds exp(-inf) = 0 once a
// row has seen a key, and before that the exponent's base is 0 (the
// masked instance), so no NaN. 46.6 KB (head dim 64) or 25.6 KB (32) of
// shared memory; four CTAs an SM, which caps a thread at 128 registers
// (without the bound ptxas held the masked head-dim-32 instance at 96 and
// spilled 8 bytes).
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
constexpr int THREADS = 128;

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

constexpr int TL_Q = 64;  // query rows per CTA: four warps of 16
constexpr int TL_K = 64;  // keys per streamed tile

// Rows [r0, r0 + 64) of one head (HD columns, row stride `stride`) into a
// padded shared tile by cp.async; rows at or past `rows` read as zero.
template <int HD>
__device__ __forceinline__ void load_tile_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                               long long stride, int r0, int rows, int tid) {
  constexpr int STR = HD + 8, CPR = HD / 8;  // 16-byte chunks a row
  for (int chunk = tid; chunk < 64 * CPR; chunk += THREADS) {
    const int r = chunk / CPR, c = (chunk % CPR) * 8;
    const int row = r0 + r;
    const int ok = row < rows;
    cp_async16(&dst[r * STR + c], src + (long long)(ok ? row : 0) * stride + c, ok ? 16 : 0);
  }
}

// S = Q K^T for the warp's 16 query rows x the 64 keys of one staged tile
// (key0 its first key), times scale; keys past n (and, with MASK, keys
// whose tile mask entry is not > 0; the entry is 0 past n) at -inf.
template <int HD, bool MASK>
__device__ __forceinline__ void tile_logits(float (*s)[4], uint32_t (*qf)[4],
                                            const __nv_bfloat16* sk, const float* skm, int key0,
                                            int n, float scale, int lane) {
  constexpr int STR = HD + 8;
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
      ldmatrix_x4(kf, &sk[r * STR + c]);
      mma_bf16(s[2 * jp], qf[kk], kf[0], kf[1]);
      mma_bf16(s[2 * jp + 1], qf[kk], kf[2], kf[3]);
    }
  }
  const int tq = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = j * 8 + tq * 2;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (MASK)
        s[j][e] = (skm[col + (e & 1)] > 0.f) ? s[j][e] * scale : -INFINITY;
      else
        s[j][e] = (key0 + col + (e & 1) < n) ? s[j][e] * scale : -INFINITY;
    }
  }
}

// Two passes over the keys with K and V streamed through shared memory in
// 64-key tiles (double-buffered cp.async), the head dim a template
// argument: any n_k, head dim 32 or 64.
template <int HD, bool MASK>
__global__ void __launch_bounds__(THREADS, 4)
attn_tiled_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                      const float* __restrict__ kmask, int nq, int n, int d, int q_stride,
                      int kv_stride, float scale) {
  constexpr int STR = HD + 8, TILE = TL_K * STR, KK = HD / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sk = sq + TL_Q * STR;  // two tiles
  __nv_bfloat16* sv = sk + 2 * TILE;    // two tiles
  float* skm = reinterpret_cast<float*>(sv + 2 * TILE);  // two tiles' key mask

  const int q0 = blockIdx.x * TL_Q, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ntiles = (n + TL_K - 1) / TL_K;
  const __nv_bfloat16* kh = k + (long long)b * n * kv_stride + h * HD;
  const __nv_bfloat16* vh = v + (long long)b * n * kv_stride + h * HD;

  auto load_kv = [&](int t, bool with_v) {
    const int buf = t & 1;
    load_tile_rows<HD>(sk + buf * TILE, kh, kv_stride, t * TL_K, n, tid);
    if (with_v) load_tile_rows<HD>(sv + buf * TILE, vh, kv_stride, t * TL_K, n, tid);
    if constexpr (MASK) {
      for (int r = tid; r < TL_K; r += THREADS) {
        const int key = t * TL_K + r;
        skm[buf * TL_K + r] = key < n ? kmask[(long long)b * n + key] : 0.f;
      }
    }
    cp_async_commit();
  };
  // Tile t's buffers are complete and visible once this returns; the
  // next tile is then in flight.
  auto next_tile = [&](int t, bool with_v) {
    if (t + 1 < ntiles) {
      load_kv(t + 1, with_v);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      cp_async_wait_all();
    }
    __syncthreads();
  };

  load_tile_rows<HD>(sq, q + (long long)b * nq * q_stride + h * HD, q_stride, q0, nq, tid);
  cp_async_commit();
  load_kv(0, false);
  asm volatile("cp.async.wait_group 1;\n" ::);
  __syncthreads();
  uint32_t qf[KK][4];
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    const int r = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    const int c = kk * 16 + (lane >> 4) * 8;
    ldmatrix_x4(qf[kk], &sq[r * STR + c]);
  }

  // Pass 1: row max and sum of exp(x - max), rows g and g + 8.
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float s[8][4];
  for (int t = 0; t < ntiles; ++t) {
    next_tile(t, false);
    const int buf = t & 1;
    tile_logits<HD, MASK>(s, qf, sk + buf * TILE, skm + buf * TL_K, t * TL_K, n, scale, lane);
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
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);

  // Pass 2: P = bf16(exp(x - max) / sum), O += P V.
  float o[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  load_kv(0, true);
  for (int t = 0; t < ntiles; ++t) {
    next_tile(t, true);
    const int buf = t & 1;
    tile_logits<HD, MASK>(s, qf, sk + buf * TILE, skm + buf * TL_K, t * TL_K, n, scale, lane);
    uint32_t pa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p0 = expf(s[j][0] - m0) / l0, p1 = expf(s[j][1] - m0) / l0;
      const float p2 = expf(s[j][2] - m1) / l1, p3 = expf(s[j][3] - m1) / l1;
      pa[j >> 1][(j & 1) * 2] = pack_bf16(p0, p1);
      pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
    const __nv_bfloat16* svt = sv + buf * TILE;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
      for (int jn = 0; jn < HD / 16; ++jn) {
        uint32_t vf[4];
        const int r = jj * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int c = jn * 16 + (lane >> 4) * 8;
        ldmatrix_x4_trans(vf, &svt[r * STR + c]);
        mma_bf16(o[2 * jn], pa[jj], vf[0], vf[1]);
        mma_bf16(o[2 * jn + 1], pa[jj], vf[2], vf[3]);
      }
    }
    __syncthreads();
  }

  const int g = lane >> 2, tq = lane & 3;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  __nv_bfloat16* obase = out + (long long)b * nq * d + h * HD + tq * 2;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    if (r0 < nq)
      *reinterpret_cast<__nv_bfloat162*>(obase + (long long)r0 * d + j * 8) =
          __floats2bfloat162_rn(o[j][0], o[j][1]);
    if (r1 < nq)
      *reinterpret_cast<__nv_bfloat162*>(obase + (long long)r1 * d + j * 8) =
          __floats2bfloat162_rn(o[j][2], o[j][3]);
  }
}

template <int HD>
int launch_tiled(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                 __nv_bfloat16* out, const float* kmask, int b, int nq, int nk, int d,
                 int q_stride, int kv_stride, int heads, float scale, cudaStream_t stream) {
  const int smem = (TL_Q + 4 * TL_K) * (HD + 8) * 2 + 2 * TL_K * 4;
  auto kernel = kmask ? attn_tiled_fwd_kernel<HD, true> : attn_tiled_fwd_kernel<HD, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((nq + TL_Q - 1) / TL_Q, heads, b);
  kernel<<<grid, THREADS, smem, stream>>>(q, k, v, out, kmask, nq, nk, d, q_stride, kv_stride,
                                          scale);
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
  const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(q);
  const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(k);
  const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(v);
  if (route == 2)
    return head_dim == 32
               ? launch_tiled<32>(qb, kb, vb, o, km, b, nq, nk, d, q_stride, kv_stride, num_heads,
                                  scale, st)
               : launch_tiled<64>(qb, kb, vb, o, km, b, nq, nk, d, q_stride, kv_stride, num_heads,
                                  scale, st);
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
  const float sl2e = scale * 1.4426950408889634f;
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
