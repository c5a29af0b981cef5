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

__device__ __forceinline__ void wgmma_m64n128k16_ss_tt(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n256k16_ss_tt(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(float* acc, uint64_t da, uint64_t db) {
  if constexpr (BN == 256)
    wgmma_m64n256k16_ss_tt(acc, da, db);
  else
    wgmma_m64n128k16_ss_tt(acc, da, db);
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
