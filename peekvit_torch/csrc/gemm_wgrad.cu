// C = A^T . B with an fp32 result: the weight-gradient products of the
// merged trainable layer.
//
// Replaces the four weight-gradient accumulations of peekvit_tpu/ops/
// pallas/fused_layer_vjp.py:135 _layer_bwd_kernel (the `accum(...)` calls
// :189-191, :199-201, :212-214, :255-257):
//   dW2   = h^T . g_b       (M x D)
//   dW1   = ln2b^T . dhpre_b (D x M)
//   dWo   = attn^T . dy_b    (D x D)
//   dWqkv = ln1^T . dqkv     (D x 3D)
// and, through the optional column sums of B, two bias gradients whose
// Pallas sums run over the same bf16 values the GEMM reads:
// db2 = sum(g) (:192) and dbqkv = sum(dqkv) (:258).
//
// On the TPU the grid ran in order, so each image cell added its product
// into one VMEM accumulator. Hopper's blocks run in no order, so the
// reduction over rows is cut into work units.
//
// Bound on H100: operations. At ViT-B bs256 (R = 50432 rows) the four
// products are 1.79e11 (dWqkv), 5.95e10 (dWo) and 2.38e11 (dW1, dW2)
// flops against 77-310 MB of operands: 0.722 ms of bf16 tensor-core time
// per layer. Design:
//   - Tensor cores with both operands transposed: A and B are row-major
//     with the reduction along their rows, so a 64-row slab of either is
//     the MN-major (transposed) operand of wgmma as it lies; C's tile is
//     128 (A's columns) x BN (B's columns), BN = 128 or 256, two consumer
//     warpgroups of 64 rows each issuing wgmma m64nBNk16 from shared
//     memory, fp32 accumulators in registers.
//   - TMA into a ring: one producer warp loads each stage (64 rows of A's
//     two 64-column slabs and of B's BN / 64 slabs, 2-D tensor maps,
//     128-byte swizzle) onto a `full` mbarrier; the consumers free a stage
//     on its `empty` mbarrier once the wgmma reading it has completed
//     (wait_group 1 keeps one stage's products in flight). 6 stages of
//     32 KB (BN = 128) or 4 of 48 KB (BN = 256).
//   - Persistent CTAs with no tail wave: gridDim.x <= 132 CTAs (one per SM)
//     walk a static list of work units (C tile, first stage, end stage,
//     partial slot), CTA c taking units c, c + grid, ... The list is
//     planned in Python (ops/cuda/fused_layer_vjp.py wgrad_plan): whole
//     waves of 132 tiles run over all the rows, the remaining tiles are
//     split into s row runs of whole stages with s the least count that
//     makes their units fill whole waves of 132, ordered split-major so
//     that the CTAs of one wave read the same rows at about the same time
//     (the slabs are reused through L2).
//   - The split partials in a fixed order: a unit over all the rows writes
//     its C tile directly; a split unit writes its fp32 tile to its slot,
//     and reduce_kernel adds a tile's slots in split order. No atomics:
//     a rerun gives the same bits.
//   - The column sums off the critical path: in the units of the first
//     row of tiles, each consumer thread adds up 8 columns of its rows of
//     the staged B slab while the stage's wgmma runs (asynchronously),
//     then the 256 threads' sums meet in shared memory in a fixed order;
//     split units write them to their slot, summed by reduce_kernel in
//     split order.
//
// A: (R, K), B: (R, N), bf16 row-major, K % 8 == 0, N % 8 == 0, pointers
// 16-byte aligned (the wrapper checks). Rows past R and columns past K or
// N load as zero (TMA fills them); columns of C past K or N are masked on
// store.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BM = 128;             // C rows per tile (A's columns)
constexpr int SLAB = 64 * 128;      // 64 rows x 64 bf16 columns, swizzled
constexpr int ROWS = 64;            // rows (the reduction) per stage
constexpr int THREADS = 288;        // two consumer warpgroups + a producer warp
constexpr int RED_BYTES = 8192;     // the column sums' meeting place

template <int BN>
struct Cfg {
  static constexpr int STAGES = BN == 256 ? 4 : 6;
  static constexpr int A_BYTES = 2 * SLAB;
  static constexpr int STAGE_BYTES = A_BYTES + (BN / 64) * SLAB;
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + RED_BYTES + 2 * STAGES * 8;
};

template <int BN>
__device__ __forceinline__ void wgmma_tile(float* acc, uint64_t da, uint64_t db) {
  if constexpr (BN == 256)
    hopper::wgmma_m64n256k16_ss<1, 1>(acc, da, db);
  else
    hopper::wgmma_m64n128k16_ss<1, 1>(acc, da, db);
}

// units[u] = {C tile (tm * tiles_n + tn), first stage, end stage, slot};
// slot -1 writes C (and the column sums) directly, else the fp32 tile goes
// to ws + slot * BM * BN (and the column sums to cs_ws + slot * BN).
template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
wgrad_kernel(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap bmap,
             const int4* __restrict__ units, int n_units, float* __restrict__ c,
             float* __restrict__ colsum, float* __restrict__ ws, float* __restrict__ cs_ws,
             int kdim, int ndim, int tiles_n) {
  using C = Cfg<BN>;
  constexpr int STAGES = C::STAGES, NACC = BN / 2;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  float* red = reinterpret_cast<float*>(smem_raw + (ring - raw) + STAGES * C::STAGE_BYTES);
  const uint32_t full = ring + STAGES * C::STAGE_BYTES + RED_BYTES;
  const uint32_t empty = full + STAGES * 8;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(full + 8 * s, 1);
      hopper::mbar_init(empty + 8 * s, 8);  // one arrival per consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {  // the producer
    if (lane != 0) return;
    int it = 0;
    for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
      const int4 un = units[u];
      const int m0 = (un.x / tiles_n) * BM, n0 = (un.x % tiles_n) * BN;
      for (int st = un.y; st < un.z; ++st, ++it) {
        const int s = it % STAGES;
        const uint32_t ph = (it / STAGES) & 1;
        hopper::mbar_wait(empty + 8 * s, ph ^ 1);
        const uint32_t fb = full + 8 * s, dst = ring + s * C::STAGE_BYTES;
        hopper::mbar_expect_tx(fb, C::STAGE_BYTES);
        const int r = st * ROWS;
        hopper::tma_load_2d(dst, &amap, m0, r, fb);
        hopper::tma_load_2d(dst + SLAB, &amap, m0 + 64, r, fb);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          hopper::tma_load_2d(dst + C::A_BYTES + j * SLAB, &bmap, n0 + 64 * j, r, fb);
      }
    }
    return;
  }

  // The consumers: warpgroup w owns C rows [64 w, 64 w + 64) of the tile.
  const int w = warp >> 2, wq = warp & 3, g = lane >> 2, t4 = lane & 3;
  constexpr int CH = BN / 8;             // 8-column chunks of B per stage
  constexpr int RPT = ROWS * CH / 256;   // rows per consumer thread in the column sums
  const int ch = tid % CH, rg = tid / CH;
  int it = 0;
  for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
    const int4 un = units[u];
    const int tm = un.x / tiles_n, tn = un.x % tiles_n, slot = un.w;
    const bool sums = colsum != nullptr && tm == 0;
    float acc[NACC];
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
    float cs[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) cs[e] = 0.f;
    int prev = -1;
    for (int st = un.y; st < un.z; ++st, ++it) {
      const int s = it % STAGES;
      hopper::mbar_wait(full + 8 * s, (it / STAGES) & 1);
      const uint32_t sa = ring + s * C::STAGE_BYTES + w * SLAB;
      const uint32_t sb = ring + s * C::STAGE_BYTES + C::A_BYTES;
      hopper::fence_regs<NACC>(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_tile<BN>(acc, hopper::desc_sw128(sa + kk * 2048, 1024, 1024),
                       hopper::desc_sw128(sb + kk * 2048, SLAB, 1024));
      hopper::wgmma_commit();
      if (sums) {  // while the products run: this thread's rows of 8 columns
        const unsigned char* slab = smem_raw + (sb - raw) + (ch >> 3) * SLAB;
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const int r = rg * RPT + i;
          const uint4 v =
              *reinterpret_cast<const uint4*>(slab + r * 128 + (((ch & 7) ^ (r & 7)) << 4));
          const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(p[e]);
            cs[2 * e] += f.x;
            cs[2 * e + 1] += f.y;
          }
        }
      }
      hopper::wgmma_wait<1>();
      hopper::fence_regs<NACC>(acc);
      if (prev >= 0 && lane == 0) hopper::mbar_arrive(empty + 8 * prev);
      prev = s;
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs<NACC>(acc);
    if (prev >= 0 && lane == 0) hopper::mbar_arrive(empty + 8 * prev);

    // acc[4 j + 2 h + e]: row 16 wq + g + 8 h of the warpgroup's 64, column
    // 8 j + 2 t4 + e.
    const int lr = 64 * w + 16 * wq + g;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = 8 * j + 2 * t4;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float2 v = make_float2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
        const int row = lr + 8 * hh;
        if (slot < 0) {
          const int grow = tm * BM + row, gcol = tn * BN + col;
          if (grow < kdim && gcol < ndim)
            *reinterpret_cast<float2*>(c + (long long)grow * ndim + gcol) = v;
        } else {
          *reinterpret_cast<float2*>(ws + ((long long)slot * BM + row) * BN + col) = v;
        }
      }
    }
    if (sums) {  // rows of the stage met in a fixed order: row group, then column
#pragma unroll
      for (int e = 0; e < 8; ++e) red[rg * BN + ch * 8 + e] = cs[e];
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
      if (tid < BN) {
        float v = 0.f;
        for (int r = 0; r < 256 / CH; ++r) v += red[r * BN + tid];
        const int col = tn * BN + tid;
        if (slot < 0) {
          if (col < ndim) colsum[col] = v;
        } else {
          cs_ws[(long long)slot * BN + tid] = v;
        }
      }
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
    }
  }
}

// The split tiles' partials summed in split order: tile red_tiles[i] of C
// is sum over k < n_split of ws slot k * n_red + i (then the column sums
// of the tiles in C's first row of tiles, from cs_ws).
__global__ void reduce_kernel(const float* __restrict__ ws, const float* __restrict__ cs_ws,
                              float* __restrict__ c, float* __restrict__ colsum,
                              const int* __restrict__ red_tiles, int n_red, int n_split, int kdim,
                              int ndim, int tiles_n, int bn) {
  const long long tile4 = (long long)BM * bn / 4;
  const long long c4 = (long long)n_red * tile4;
  const long long total = c4 + (colsum ? (long long)n_red * bn / 4 : 0);
  for (long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x; q < total;
       q += (long long)gridDim.x * blockDim.x) {
    if (q < c4) {
      const int i = (int)(q / tile4);
      const int local = (int)(q % tile4) * 4;
      const int tile = red_tiles[i];
      const int row = (tile / tiles_n) * BM + local / bn, col = (tile % tiles_n) * bn + local % bn;
      if (row >= kdim || col >= ndim) continue;
      float4 v = reinterpret_cast<const float4*>(ws)[(long long)i * tile4 + local / 4];
      for (int k = 1; k < n_split; ++k) {
        const float4 p =
            reinterpret_cast<const float4*>(ws)[((long long)k * n_red + i) * tile4 + local / 4];
        v.x += p.x;
        v.y += p.y;
        v.z += p.z;
        v.w += p.w;
      }
      *reinterpret_cast<float4*>(c + (long long)row * ndim + col) = v;
    } else {
      const long long e = (q - c4) * 4;
      const int i = (int)(e / bn), local = (int)(e % bn);
      const int tile = red_tiles[i];
      const int col = (tile % tiles_n) * bn + local;
      if (tile / tiles_n != 0 || col >= ndim) continue;
      for (int x = 0; x < 4; ++x) {
        float v = cs_ws[(long long)i * bn + local + x];
        for (int k = 1; k < n_split; ++k) v += cs_ws[((long long)k * n_red + i) * bn + local + x];
        colsum[col + x] = v;
      }
    }
  }
}

template <int BN>
int launch(const CUtensorMap& am, const CUtensorMap& bm, const int4* units, int n_units, int grid,
           float* c, float* colsum, float* ws, float* cs_ws, int k, int n, int tiles_n,
           cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(wgrad_kernel<BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<BN>::SMEM);
  if (err != cudaSuccess) return (int)err;
  wgrad_kernel<BN><<<grid, THREADS, Cfg<BN>::SMEM, s>>>(am, bm, units, n_units, c, colsum, ws,
                                                       cs_ws, k, n, tiles_n);
  return (int)cudaGetLastError();
}

}  // namespace

// a: (rows, k) bf16; b: (rows, n) bf16; c: (k, n) fp32. colsum: (n,)
// fp32, the column sums of b, or null. bn: C tile width, 128 or 256.
// units: n_units int4 work units (see wgrad_kernel), taken by `grid`
// persistent CTAs. n_red tiles (red_tiles, int32) are split into n_split
// row runs: ws holds n_split * n_red fp32 tiles of 128 x bn (slot k *
// n_red + i) and cs_ws as many rows of bn column sums; with n_split = 1
// neither is read and no summing pass runs. k and n multiples of 8,
// pointers 16-byte aligned (the wrapper checks). Returns the cudaError_t
// of the first failing call.
extern "C" int peekvit_gemm_wgrad(const void* a, const void* b, void* c, void* colsum, void* ws,
                                  void* cs_ws, const void* units, int n_units, int grid,
                                  const void* red_tiles, int n_red, int n_split, long long rows,
                                  int k, int n, int bn, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k == 0 || n == 0) return 0;
  if (rows == 0) {  // empty sums
    cudaError_t err = cudaMemsetAsync(c, 0, (size_t)k * n * sizeof(float), s);
    if (err == cudaSuccess && colsum != nullptr)
      err = cudaMemsetAsync(colsum, 0, n * sizeof(float), s);
    return (int)err;
  }
  if ((bn != 128 && bn != 256) || grid < 1 || n_units < grid ||
      (n_split > 1 && (ws == nullptr || cs_ws == nullptr || red_tiles == nullptr)))
    return (int)cudaErrorInvalidValue;
  CUtensorMap am, bm;
  const uint64_t adims[2] = {(uint64_t)k, (uint64_t)rows}, astr[1] = {(uint64_t)k * 2};
  const uint64_t bdims[2] = {(uint64_t)n, (uint64_t)rows}, bstr[1] = {(uint64_t)n * 2};
  const uint32_t box[2] = {64, ROWS};
  if (!hopper::make_map_bf16(&am, a, 2, adims, astr, box) ||
      !hopper::make_map_bf16(&bm, b, 2, bdims, bstr, box))
    return (int)cudaErrorInvalidValue;
  const int tiles_n = (n + bn - 1) / bn;
  float* cf = static_cast<float*>(c);
  float* csf = static_cast<float*>(colsum);
  const int4* u = static_cast<const int4*>(units);
  int e = bn == 256 ? launch<256>(am, bm, u, n_units, grid, cf, csf, static_cast<float*>(ws),
                                  static_cast<float*>(cs_ws), k, n, tiles_n, s)
                    : launch<128>(am, bm, u, n_units, grid, cf, csf, static_cast<float*>(ws),
                                  static_cast<float*>(cs_ws), k, n, tiles_n, s);
  if (e != 0 || n_split <= 1) return e;
  const long long total = (long long)n_red * BM * bn / 4 + (colsum ? (long long)n_red * bn / 4 : 0);
  const long long want = (total + 255) / 256;
  const unsigned blocks = (unsigned)(want < 132 * 16 ? want : 132 * 16);
  reduce_kernel<<<blocks, 256, 0, s>>>(static_cast<const float*>(ws),
                                       static_cast<const float*>(cs_ws), cf, csf,
                                       static_cast<const int*>(red_tiles), n_red, n_split, k, n,
                                       tiles_n, bn);
  return (int)cudaGetLastError();
}
