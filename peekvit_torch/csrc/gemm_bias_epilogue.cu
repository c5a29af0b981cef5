// C = A . W with a fused epilogue: the four matrix products of the
// Pallas encoder layer.
//
// Replaces the in-kernel products of peekvit_tpu/ops/pallas/
// fused_attention.py:616 _layer_kernel (and of _attn_block_kernel :238):
//   epilogue 0: + bias -> bf16                       (qkv, :680-681)
//   epilogue 1: + bias, tanh-gelu -> bf16            (fc1, :711-713)
//   epilogue 2: + bias + residual -> fp32            (out-proj, :698-702)
//   epilogue 3: + bias + residual -> bf16            (fc2, :714-716)
// and, with a per-row mask (ResidualViT, _layer_kernel mode 'masked'
// and _masked_attn_kernel :378):
//   epilogue 6: (+ bias) * mask[row] + residual -> fp32  (out-proj, :698-702)
//   epilogue 7: (+ bias) * mask[row] + residual -> bf16  (split out-proj, :417-419)
// The residual is fp32 (the layer's mid residual y) or bf16 (the layer
// input, split path). The mask is (M,) bf16, read as fp32. Every sum is
// taken in fp32 and rounded once.
//
// With W read as (N, K) row-major (C = A . W^T, the "NT" layout, chosen
// at compile time) and no bias, it also carries the two transposed-weight
// products inside the backward kernels of peekvit_tpu/ops/pallas/
// fused_attention_vjp.py (_attn_bwd_kernel :93, _attn_bwd_kernel_saved
// :172):
//   epilogue 4: -> bf16   (dattn = g . Wo^T, :111-115 and :196-200)
//   epilogue 5: -> fp32   (dln = dqkv . Wqkv^T, :159-161 and :238-240)
//
// Epilogue 8 ("masked_rowdot") is the head of the masked trainable
// block's backward (_masked_bwd_kernel :445 at :488-494 and
// _masked_bwd_kernel_saved :550 at :575-579). It rebuilds
// proj = attn . Wo + bo in fp32 from the saved attn and never writes it.
// Reading the block's output cotangent g (res, bf16) and the row mask, it
// writes dproj = bf16(g * mask) (out), which feeds the NT GEMM g Wo^T,
// and for every (row, 128-column tile) the fp32 partial of
// sum(g * proj) (aux, (M, ceil(N / 128)) fp32): the output-mask term of
// the gate cotangent dm, summed per row by ln_bwd_rows.masked. The four
// warps that share a tile's rows add their partials in shared memory in a
// fixed order: no atomics, the same bits on every run. Bound on H100 at
// ResidualViT-B bs256 (50688 x 768 x 768): bytes (attn, g and dproj in
// bf16, about 236 MB, against 60 GFLOP), as for epilogue 7.
//
// Two epilogues carry the merged trainable layer (peekvit_tpu/ops/pallas/
// fused_layer_vjp.py, the backward _layer_bwd_kernel :135):
//   epilogue 9 ("gelu_hpre"): the recomputed fc1, hpre = A . W1 + b1 in
//     fp32 (:184-185), writes h = bf16(gelu(hpre)) (out, :186) and hpre
//     itself (aux, (M, N) fp32), which gelu' reads in the backward;
//   epilogue 10 ("gelu_grad", NT): dh = g . W2^T (:193-196), then
//     dhpre = dh * gelu'(hpre) in fp32 (:197) with hpre read as res
//     ((M, N) fp32); writes dhpre_b = bf16(dhpre) (out, :198) and, per
//     128-row tile, the fp32 column partials of the unrounded dhpre (aux,
//     (ceil(M / 128), N) fp32) for db1 = sum(dhpre) (:202). The fp32
//     dhpre is never stored. The two row halves of a tile meet in shared
//     memory in a fixed order: no atomics, the same bits on every run.
// Bytes at ViT-B bs256 (M = 50432, K = 768, N = 3072): epilogue 9 reads
// 77 MB and writes 310 MB of h and 620 MB of hpre; epilogue 10 reads
// 77 MB of g and 620 MB of hpre and writes 310 MB of dhpre_b and 2.4 MB
// of partials.
//
// Epilogue 11 ("partial_f32") is the bare product C = A . W in fp32, W
// read as (K, N) as it lies, with no bias and no residual, rounded
// nowhere: the out-projection and fc2 partials of the tensor-parallel
// sublayers (peekvit_tpu/ops/pallas/tp_blocks.py :68, :144, :206, :257),
// whose sum over the model shards a collective takes before bias and
// residual are added once. Bound on H100 at ViT-B/16 bs256 (M = 50432,
// N = 768): the fp32 (M, 768) write is 155 MB (0.046 ms). With the bf16 A
// at K = 384 / 192 (out-proj, n_model 2 / 4) and 768 (fc2, n_model 4)
// bytes bound it; fc2 at n_model 2 (K = 1536, 119 GFLOP: 0.120 ms against
// 0.093 ms of bytes) is bound by operations.
//
// Bound on H100: operations. At ViT-B bs256 the products are
// (50432 x 768) . (768 x {2304, 768, 3072}) and (50432 x 3072) . (3072 x 768):
// hundreds of flops per byte, above the card's ~295 flop/byte ridge.
// Design (wgmma on TMA-fed shared memory, persistent CTAs):
//   - One CTA per SM (at most the card's SM count, never more than there
//     are tiles) walks the 128 x BN output tiles in row-major tile order
//     (tile t: rows 128 (t / tiles_n), columns BN (t % tiles_n)), CTA c
//     taking tiles c, c + grid, ...: the CTAs in flight at one time read
//     the same few 128-row panels of A, and W (at most 4.7 MB here) stays
//     in L2.
//   - A producer warp keeps a ring of STAGES 64-deep K slices in flight by
//     TMA (2-D tensor maps, 128-byte swizzle) onto `full` mbarriers: A's
//     128 x 64 tile (K-major as it lies) and W's slice, (64, BN) as
//     BN / 64 MN-major slabs in the NN layout or one (BN, 64) K-major tile
//     in the NT layout. Rows past M, columns past N and K past its end load
//     as zero (TMA fills them), so any K % 8 == 0 takes the same path.
//     The producer runs ahead into the next tile while the consumers finish
//     this one's epilogue.
//   - Two consumer warpgroups own 64 rows each of the 128 x BN tile and
//     issue wgmma m64nBNk16 from shared memory with fp32 accumulators in
//     registers (BN / 2 a thread); wait_group 1 keeps one slice's products
//     in flight, and a slice is freed on its `empty` mbarrier (one arrival
//     per consumer warp) once the products reading it have completed.
//   - BN = 256 where it pads N no more than 128 does and the tiles still
//     fill the card, else 128, and 128 for gelu_grad, whose epilogue needs
//     the registers (peekvit_gemm_bias_epilogue_plan; the other ViT-B/16
//     bs256 products all take 256). 4 stages of 48 KB (BN 256) or 6 of
//     32 KB (BN 128). 288 threads take registers as 12 warps would: 168 a
//     thread, of which a 128 x 256 tile's accumulators hold 128.
//   - The epilogue runs on the accumulator fragment, whose layout per
//     8-column group is mma.sync's (row g / g + 8, columns 2 t, 2 t + 1), so
//     each epilogue's element code is unchanged. It loads the inputs of 8
//     column groups (bias, residual, cotangent, hpre) before it stores
//     their outputs: an output may share its type with an input, and the
//     compiler then kept each load behind the store before it. Epilogue
//     8's per-row partials: a thread's 16 column pairs of a 128-column
//     group, then the quad, in that order. Epilogue 10's per-tile column partials: a
//     thread's two rows, the warp's eight row groups by shuffles, then the
//     eight warps in order through shared memory. No atomics and no split
//     of K: every output and partial is summed by one CTA in one order, so
//     a rerun gives the same bits.
//
// A: (M, K) bf16 row-major. W: (K, N) bf16 row-major (the JAX (in, out)
// layout), or (N, K) row-major for epilogues 4, 5 and 10. K % 32 == 0,
// N % 8 == 0, pointers 16-byte aligned (the wrapper checks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BM = 128;             // output rows per tile
constexpr int BK = 64;              // K per stage: one 128-byte swizzle row
constexpr int A_BYTES = BM * 128;   // A's 128 x 64 tile
constexpr int SLAB = 64 * 128;      // 64 rows x 64 bf16, swizzled
constexpr int THREADS = 288;        // two consumer warpgroups + a producer warp

template <int BN>
struct Cfg {
  static constexpr int STAGES = BN == 256 ? 4 : 6;
  static constexpr int STAGE_BYTES = A_BYTES + BN * 128;
  static constexpr int RED_BYTES = 8 * BN * 4;  // epilogue 10: [warp][column]
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + RED_BYTES + 2 * STAGES * 8;
};

// jax.nn.gelu(approximate=True), in fp32.
__device__ __forceinline__ float gelu_tanh(float x) {
  const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
  const float k1 = 0.044715f;
  return 0.5f * x * (1.0f + tanhf(k0 * (x + k1 * x * x * x)));
}

// Its derivative, fused_layer_vjp.py:70 _gelu_tanh_grad, in fp32.
__device__ __forceinline__ float gelu_tanh_grad(float x) {
  const float k0 = 0.7978845608028654f;
  const float k1 = 0.044715f;
  const float t = tanhf(k0 * (x + k1 * x * x * x));
  const float du = k0 * (1.0f + 3.0f * k1 * x * x);
  return 0.5f * (1.0f + t) + 0.5f * x * (1.0f - t * t) * du;
}

template <typename R>
__device__ __forceinline__ float2 load_res2(const R* p);
template <>
__device__ __forceinline__ float2 load_res2<float>(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
template <>
__device__ __forceinline__ float2 load_res2<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

template <int BN, bool NT>
__device__ __forceinline__ void mma_slice(float* acc, uint32_t sa, uint32_t sw) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t da = hopper::desc_sw128(sa + kk * 32, 16, 1024);
    // NT: W's (BN, 64) tile is K-major; NN: its BN / 64 slabs of (64, 64)
    // are MN-major, 16 K rows = 2048 bytes a step.
    const uint64_t dw = NT ? hopper::desc_sw128(sw + kk * 32, 16, 1024)
                           : hopper::desc_sw128(sw + kk * 2048, SLAB, 1024);
    if constexpr (BN == 256)
      hopper::wgmma_m64n256k16_ss<0, NT ? 0 : 1>(acc, da, dw);
    else
      hopper::wgmma_m64n128k16_ss<0, NT ? 0 : 1>(acc, da, dw);
  }
}

template <int EPI, bool NT, int BN, typename RES, typename OUT>
__global__ void __launch_bounds__(THREADS, 1)
gemm_kernel(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap wmap,
            const __nv_bfloat16* __restrict__ bias, const RES* __restrict__ res,
            const __nv_bfloat16* __restrict__ mask, OUT* __restrict__ out,
            float* __restrict__ aux, int m, int n, int k, int tiles_n, int n_tiles) {
  using C = Cfg<BN>;
  constexpr int STAGES = C::STAGES, NACC = BN / 2;
  constexpr bool HAS_BIAS = EPI != 4 && EPI != 5 && EPI != 10 && EPI != 11;
  constexpr bool HAS_IN = EPI == 2 || EPI == 3 || EPI == 6 || EPI == 7 || EPI == 8 || EPI == 10;
  constexpr int EPI_CHUNK = 8;  // 8-column groups whose epilogue inputs load together
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  float* red = reinterpret_cast<float*>(smem_raw + (ring - raw) + STAGES * C::STAGE_BYTES);
  const uint32_t full = ring + STAGES * C::STAGE_BYTES + C::RED_BYTES;
  const uint32_t empty = full + STAGES * 8;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ksteps = (k + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(full + 8 * s, 1);
      hopper::mbar_init(empty + 8 * s, 8);  // one arrival per consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {  // the producer: the CTA's tiles in order, K slice by slice
    if (lane != 0) return;
    int it = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const int m0 = (t / tiles_n) * BM, n0 = (t % tiles_n) * BN;
      for (int ks = 0; ks < ksteps; ++ks, ++it) {
        const int s = it % STAGES;
        hopper::mbar_wait(empty + 8 * s, ((it / STAGES) & 1) ^ 1);
        const uint32_t fb = full + 8 * s, dst = ring + s * C::STAGE_BYTES;
        hopper::mbar_expect_tx(fb, C::STAGE_BYTES);
        hopper::tma_load_2d(dst, &amap, ks * BK, m0, fb);
        if constexpr (NT) {
          hopper::tma_load_2d(dst + A_BYTES, &wmap, ks * BK, n0, fb);
        } else {
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            hopper::tma_load_2d(dst + A_BYTES + j * SLAB, &wmap, n0 + 64 * j, ks * BK, fb);
        }
      }
    }
    return;
  }

  // The consumers: warpgroup w owns rows [64 w, 64 w + 64) of every tile.
  const int w = warp >> 2, wq = warp & 3, g = lane >> 2, t4 = lane & 3;
  int it = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int tm = t / tiles_n, m0 = tm * BM, n0 = (t % tiles_n) * BN;
    float acc[NACC];
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
    int prev = -1;
    for (int ks = 0; ks < ksteps; ++ks, ++it) {
      const int s = it % STAGES;
      hopper::mbar_wait(full + 8 * s, (it / STAGES) & 1);
      const uint32_t st = ring + s * C::STAGE_BYTES;
      hopper::fence_regs<NACC>(acc);
      hopper::wgmma_fence();
      mma_slice<BN, NT>(acc, st + w * (A_BYTES / 2), st + A_BYTES);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();
      hopper::fence_regs<NACC>(acc);
      if (prev >= 0 && lane == 0) hopper::mbar_arrive(empty + 8 * prev);
      prev = s;
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs<NACC>(acc);
    if (prev >= 0 && lane == 0) hopper::mbar_arrive(empty + 8 * prev);

    // acc[4 j + 2 hh + e]: row lr + 8 hh of the tile, column 8 j + 2 t4 + e.
    // The epilogue reads its inputs (bias, residual, cotangent or hpre) for
    // EPI_CHUNK column groups before it writes their outputs: an output may
    // share its type with an input, and a load after a store of that type
    // would wait for the store.
    const int lr = 64 * w + 16 * wq + g;
    float mk[2] = {1.f, 1.f};
    if constexpr (EPI == 6 || EPI == 7 || EPI == 8) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        if (m0 + lr + 8 * hh < m) mk[hh] = __bfloat162float(mask[m0 + lr + 8 * hh]);
    }
    float rs[2] = {0.f, 0.f};  // epilogue 8: the rows' partials of the current 128 columns
#pragma unroll
    for (int j0 = 0; j0 < BN / 8; j0 += EPI_CHUNK) {
      float2 b2[EPI_CHUNK], in[EPI_CHUNK][2];
#pragma unroll
      for (int jj = 0; jj < EPI_CHUNK; ++jj) {
        const int col = n0 + 8 * (j0 + jj) + 2 * t4;
        b2[jj] = make_float2(0.f, 0.f);
        if (HAS_BIAS && col < n)
          b2[jj] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + col));
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = m0 + lr + 8 * hh;
          in[jj][hh] = make_float2(0.f, 0.f);
          if (HAS_IN && col < n && row < m) in[jj][hh] = load_res2<RES>(res + (long long)row * n + col);
        }
      }
#pragma unroll
      for (int jj = 0; jj < EPI_CHUNK; ++jj) {
        const int j = j0 + jj, col = n0 + 8 * j + 2 * t4;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = m0 + lr + 8 * hh;
          const bool ok = col < n && row < m;
          const long long off = (long long)row * n + col;
          float v0 = acc[4 * j + 2 * hh] + b2[jj].x;
          float v1 = acc[4 * j + 2 * hh + 1] + b2[jj].y;
          if constexpr (EPI == 8) {
            // dproj = bf16(g * mask); the row partial of g * (A . W + bias)
            if (ok)
              *reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<__nv_bfloat16*>(out) + off) =
                  __floats2bfloat162_rn(in[jj][hh].x * mk[hh], in[jj][hh].y * mk[hh]);
            rs[hh] += in[jj][hh].x * v0 + in[jj][hh].y * v1;
          } else if constexpr (EPI == 10) {
            // dhpre = acc * gelu'(hpre), rounded on store and kept in acc for the sums
            v0 = ok ? v0 * gelu_tanh_grad(in[jj][hh].x) : 0.f;
            v1 = ok ? v1 * gelu_tanh_grad(in[jj][hh].y) : 0.f;
            if (ok)
              *reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<__nv_bfloat16*>(out) + off) =
                  __floats2bfloat162_rn(v0, v1);
            acc[4 * j + 2 * hh] = v0;
            acc[4 * j + 2 * hh + 1] = v1;
          } else {
            if (!ok) continue;
            if (EPI == 9) *reinterpret_cast<float2*>(aux + off) = make_float2(v0, v1);
            if (EPI == 1 || EPI == 9) {
              v0 = gelu_tanh(v0);
              v1 = gelu_tanh(v1);
            }
            if (EPI == 6 || EPI == 7) {
              v0 *= mk[hh];
              v1 *= mk[hh];
            }
            if (HAS_IN) {
              v0 += in[jj][hh].x;
              v1 += in[jj][hh].y;
            }
            if (EPI == 2 || EPI == 5 || EPI == 6 || EPI == 11) {
              *reinterpret_cast<float2*>(reinterpret_cast<float*>(out) + off) = make_float2(v0, v1);
            } else {
              *reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<__nv_bfloat16*>(out) + off) =
                  __floats2bfloat162_rn(v0, v1);
            }
          }
        }
      }
      if constexpr (EPI == 8) {
        // per row and 128-column group: the thread's 16 column pairs, then the quad
        if ((j0 + EPI_CHUNK) % 16 == 0) {
          const int part = (n0 + 8 * (j0 + EPI_CHUNK - 16)) / 128, parts = (n + 127) / 128;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            float v = rs[hh];
            v += __shfl_xor_sync(0xffffffffu, v, 1);
            v += __shfl_xor_sync(0xffffffffu, v, 2);
            const int row = m0 + lr + 8 * hh;
            if (t4 == 0 && row < m && part < parts) aux[(long long)row * parts + part] = v;
            rs[hh] = 0.f;
          }
        }
      }
    }
    if constexpr (EPI == 10) {
      // per column: the thread's two rows, the warp's eight row groups, then
      // the eight warps in order
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = acc[4 * j + e] + acc[4 * j + 2 + e];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (g == 0) red[warp * BN + 8 * j + 2 * t4 + e] = v;
        }
      }
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
      if (tid < BN && n0 + tid < n) {
        float v = red[tid];
#pragma unroll
        for (int r = 1; r < 8; ++r) v += red[r * BN + tid];
        aux[(long long)tm * n + n0 + tid] = v;
      }
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
    }
  }
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

// The C tile width for an (m, n) output of `epilogue`, 256 where it pads N
// no more than 128 does and the tiles still fill the card, else 128 (and
// always 128 for gelu_grad, whose epilogue needs the registers); and the
// persistent grid.
void plan(int m, int n, int epilogue, int* bn, int* grid) {
  const long long tiles_m = (m + BM - 1) / BM;
  const int t128 = (n + 127) / 128, t256 = (n + 255) / 256;
  const bool wide = epilogue != 10 && t256 * 256 <= t128 * 128 && tiles_m * t256 >= sm_count();
  *bn = wide ? 256 : 128;
  const long long tiles = tiles_m * (wide ? t256 : t128);
  *grid = (int)(tiles < sm_count() ? tiles : sm_count());
}

struct Args {
  const void *a, *w, *bias, *res, *mask;
  void *out, *aux;
  int m, n, k;
};

template <int EPI, bool NT, int BN, typename RES, typename OUT>
int launch_bn(const Args& p, int grid, cudaStream_t stream) {
  auto kern = gemm_kernel<EPI, NT, BN, RES, OUT>;
  static bool sized = false;  // the attribute is set once per instance
  if (!sized) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<BN>::SMEM);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  CUtensorMap am, wm;
  const uint64_t adims[2] = {(uint64_t)p.k, (uint64_t)p.m}, astr[1] = {(uint64_t)p.k * 2};
  const uint32_t abox[2] = {BK, BM};
  // NT: W is (N, K), K innermost; NN: W is (K, N), N innermost.
  const uint64_t wdims[2] = {(uint64_t)(NT ? p.k : p.n), (uint64_t)(NT ? p.n : p.k)};
  const uint64_t wstr[1] = {(uint64_t)(NT ? p.k : p.n) * 2};
  const uint32_t wbox[2] = {64, NT ? (uint32_t)BN : 64u};
  if (!hopper::make_map_bf16(&am, p.a, 2, adims, astr, abox) ||
      !hopper::make_map_bf16(&wm, p.w, 2, wdims, wstr, wbox))
    return (int)cudaErrorInvalidValue;
  const int tiles_n = (p.n + BN - 1) / BN;
  const int n_tiles = ((p.m + BM - 1) / BM) * tiles_n;
  kern<<<grid, THREADS, Cfg<BN>::SMEM, stream>>>(
      am, wm, static_cast<const __nv_bfloat16*>(p.bias), static_cast<const RES*>(p.res),
      static_cast<const __nv_bfloat16*>(p.mask), static_cast<OUT*>(p.out),
      static_cast<float*>(p.aux), p.m, p.n, p.k, tiles_n, n_tiles);
  return (int)cudaGetLastError();
}

template <int EPI, bool NT, typename RES, typename OUT>
int launch(const Args& p, cudaStream_t stream) {
  int bn, grid;
  plan(p.m, p.n, EPI, &bn, &grid);
  if constexpr (EPI == 10) {
    return launch_bn<EPI, NT, 128, RES, OUT>(p, grid, stream);
  } else {
    return bn == 256 ? launch_bn<EPI, NT, 256, RES, OUT>(p, grid, stream)
                     : launch_bn<EPI, NT, 128, RES, OUT>(p, grid, stream);
  }
}

// Residual epilogues (2, 3, 6, 7) with either residual type.
template <int EPI, typename OUT>
int launch_res(int res_f32, const Args& p, cudaStream_t s) {
  return res_f32 ? launch<EPI, false, float, OUT>(p, s)
                 : launch<EPI, false, __nv_bfloat16, OUT>(p, s);
}

}  // namespace

// epilogue: 0 bias, 1 bias + tanh-gelu, 2 bias + residual -> fp32,
// 3 bias + residual -> bf16, 4 A . W^T -> bf16, 5 A . W^T -> fp32 (W as
// (N, K); bias and res are ignored for 4 and 5), 6 (bias) * mask +
// residual -> fp32, 7 (bias) * mask + residual -> bf16, 8 masked_rowdot:
// out = bf16(res * mask) and aux = per-(row, 128-column group) partials of
// sum(res * (A . W + bias)), fp32 (m, ceil(n / 128)); res is the bf16
// cotangent. 9 gelu_hpre: out = bf16(gelu(A . W + bias)) and aux = the
// fp32 A . W + bias, (m, n). 10 gelu_grad (W as (N, K), no bias): with
// res the fp32 hpre (m, n), out = bf16(A . W^T * gelu'(res)) and aux =
// per-128-row-tile column partials of the fp32 product, (ceil(m / 128),
// n). 11 partial_f32: A . W -> fp32, no bias (bias, res and mask are
// ignored). res_f32 selects an fp32 (1) or bf16 (0) residual for
// epilogues 2, 3, 6 and 7; res is ignored for 0, 1, 4, 5, 9 and 11. mask ((m,) bf16) is
// read by epilogues 6, 7 and 8 only; aux is written by 8, 9 and 10 only.
// Returns the cudaError_t of the launch (an unknown epilogue, or 6, 7 or 8
// without a mask, 8 or 10 without res or aux, 9 without aux, returns
// cudaErrorInvalidValue).
extern "C" int peekvit_gemm_bias_epilogue(const void* a, const void* w, const void* bias,
                                          const void* res, const void* mask, void* out,
                                          void* aux, int m, int n, int k, int epilogue,
                                          int res_f32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m == 0) return 0;
  const Args p{a, w, bias, res, mask, out, aux, m, n, k};
  switch (epilogue) {
    case 0:
      return launch<0, false, float, __nv_bfloat16>(p, s);
    case 1:
      return launch<1, false, float, __nv_bfloat16>(p, s);
    case 2:
      return launch_res<2, float>(res_f32, p, s);
    case 3:
      return launch_res<3, __nv_bfloat16>(res_f32, p, s);
    case 4:
      return launch<4, true, float, __nv_bfloat16>(p, s);
    case 5:
      return launch<5, true, float, float>(p, s);
    case 6:
    case 7:
      if (mask == nullptr) return (int)cudaErrorInvalidValue;
      return epilogue == 6 ? launch_res<6, float>(res_f32, p, s)
                           : launch_res<7, __nv_bfloat16>(res_f32, p, s);
    case 8:
      if (mask == nullptr || res == nullptr || aux == nullptr) return (int)cudaErrorInvalidValue;
      return launch<8, false, __nv_bfloat16, __nv_bfloat16>(p, s);
    case 9:
      if (aux == nullptr) return (int)cudaErrorInvalidValue;
      return launch<9, false, float, __nv_bfloat16>(p, s);
    case 10:
      if (res == nullptr || aux == nullptr) return (int)cudaErrorInvalidValue;
      return launch<10, true, float, __nv_bfloat16>(p, s);
    case 11:
      return launch<11, false, float, float>(p, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The schedule peekvit_gemm_bias_epilogue takes for an (m, n) output of
// `epilogue`: writes the C tile width (128 or 256) to out[0] and the number
// of persistent CTAs to out[1]. Returns 0.
extern "C" int peekvit_gemm_bias_epilogue_plan(int m, int n, int epilogue, int* out) {
  plan(m, n, epilogue, &out[0], &out[1]);
  return 0;
}
