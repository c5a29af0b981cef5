// The PCT ARPE embedding: point cloud -> encoder tokens, gather-free.
//
// Replaces peekvit_tpu/ops/pallas/pct_embed.py:121 arpe_tokens (body
// _arpe_kernel :55-105). Per cloud of n points and for every point i:
//
//   d2_ij  = (sq_i + sq_j) - 2 <p_i, p_j>,  sq_i = <p_i, p_i>
//   thr_i  = the k-th smallest d2_ij, by 30 bisection steps on
//            [0, max_j d2_ij]: mid = 0.5 (lo + hi), hi = mid where
//            count_j(d2_ij <= mid) >= k, else lo = mid; thr_i = hi
//   g_j    = -(p_j @ Wb')                              (6 channels)
//   c_i    = p_i @ (Wa' + Wb') + b1'
//   h_i    = elu(c_i + max_{j : d2_ij <= thr_i} g_j)  (per channel)
//   out_i  = elu(h_i @ W2' + b2')                      (d channels)
//
// with BN1 and BN2 (running statistics) folded into lin1 and lin2 at
// engine build; elu(x) = x > 0 ? x : exp(min(x, 0)) - 1 (the Pallas
// _elu :50-52). Every point tied at the k-th distance is in the set, as
// in the Pallas kernel. The output is written in fp32 or rounded once to
// bf16 (the JAX engine casts the fp32 kernel output to the compute dtype).
//
// Same neighbours as the plain version: every fp32 operation that feeds
// a discrete decision (d2, the bisection midpoint, g) or the masked max
// is written with __fmul_rn / __fadd_rn / __fsub_rn in the plain
// version's order, so nvcc contracts none of them into an FMA:
// sq = (x x + y y) + z z, <p_i, p_j> = (x_i x_j + y_i y_j) + z_i z_j,
// d2 = (sq_i + sq_j) - 2 <p_i, p_j>, mid = 0.5 (lo + hi),
// g = -((x wb0 + y wb1) + z wb2). Then the thresholds, the neighbour
// sets and the masked max equal the plain version's exactly, and c_i,
// the lin2 sum (over the 6 channels in order, then + b2') follow the same
// order; only expf in the two elus differs from torch.exp by rounding.
//
// Bound on H100: operations, in fp32 outside the tensor cores. Per pair
// (i, j) the kernel does 8 operations for d2, 1 for the row max, 2 (a
// compare and an add) in each of the 30 bisection counts and the final
// count, and 7 for the masked max: 78 per pair, B n^2 78 in all (1.05e10
// at B = 128, n = 1024: 0.16 ms at 67 TFLOP/s), against 1.5 MB of points
// and 34 MB of bf16 tokens (0.01 ms at 3.35 TB/s).
//
// Design. The (n, n) distances (4 MB per cloud at n = 1024) do not fit on
// chip, and do not need to: one warp owns a query row and keeps its n
// distances in registers, 32 per lane (so n <= 1024, the kernel's
// largest cloud; the wrapper raises past it). A block of 8 warps takes 32
// rows of one cloud and first stages the cloud in shared memory as
// structure of arrays: x, y, z, sq and the 6 channels of g, 40 n bytes
// (40 KB at n = 1024). Each bisection step is 32 compares and adds per
// lane and a warp sum by shuffles; the row max and the masked max per
// channel are warp max reductions (exact in any order). The lin2 product
// then puts the lanes over the d output channels, with coalesced stores.
// Optionally the kernel writes each row's threshold and neighbour count,
// so that a check can hold its neighbour sets against the plain
// version's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 3;                   // point coordinates
constexpr int CH = 2 * C;              // lin1 channels ([point | diff] -> 2C)
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS_PER_BLOCK = 32;
constexpr int PER_LANE = 32;           // distances per lane, in registers
constexpr int MAX_N = 32 * PER_LANE;   // 1024 points per cloud
constexpr int BISECT_ITERS = 30;       // pct_embed.py:39 _BISECT_ITERS
constexpr float NEG = -3.4e38f;        // the Pallas kernel's masked-max fill

__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0, float b1,
                                      float b2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1)), __fmul_rn(a2, b2));
}

__device__ __forceinline__ float elu(float x) {
  return x > 0.f ? x : __fsub_rn(expf(fminf(x, 0.f)), 1.f);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// count_j(dist_j <= thr) over the warp's row (entries past n hold +inf).
__device__ __forceinline__ int warp_count(const float (&dist)[PER_LANE], float thr) {
  int c = 0;
#pragma unroll
  for (int t = 0; t < PER_LANE; ++t) c += dist[t] <= thr ? 1 : 0;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) c += __shfl_xor_sync(0xffffffffu, c, o);
  return c;
}

template <bool OUT_BF16>
__global__ void __launch_bounds__(THREADS)
arpe_kernel(const float* __restrict__ pts, const float* __restrict__ wc,
            const float* __restrict__ wb, const float* __restrict__ b1,
            const float* __restrict__ w2, const float* __restrict__ b2, void* __restrict__ out,
            float* __restrict__ kth, int* __restrict__ count, int n, int d, int k) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + n;
  float* sz = sy + n;
  float* ssq = sz + n;
  float* sg = ssq + n;  // [CH][n]
  const int b = blockIdx.y;
  const float* p = pts + (long long)b * n * C;

  for (int j = threadIdx.x; j < n; j += THREADS) {
    const float x = p[j * C], y = p[j * C + 1], z = p[j * C + 2];
    sx[j] = x;
    sy[j] = y;
    sz[j] = z;
    ssq[j] = dot3(x, y, z, x, y, z);
#pragma unroll
    for (int ch = 0; ch < CH; ++ch)
      sg[ch * n + j] = -dot3(x, y, z, wb[ch], wb[CH + ch], wb[2 * CH + ch]);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row_end = min(n, (blockIdx.x + 1) * ROWS_PER_BLOCK);
  const float inf = __int_as_float(0x7f800000);
  for (int i = blockIdx.x * ROWS_PER_BLOCK + warp; i < row_end; i += WARPS) {
    const float xi = sx[i], yi = sy[i], zi = sz[i], sqi = ssq[i];
    float dist[PER_LANE];
    float rowmax = -inf;
#pragma unroll
    for (int t = 0; t < PER_LANE; ++t) {
      const int j = lane + 32 * t;
      float v = inf;
      if (j < n) {
        const float dot = dot3(xi, yi, zi, sx[j], sy[j], sz[j]);
        v = __fsub_rn(__fadd_rn(sqi, ssq[j]), __fmul_rn(2.f, dot));
        rowmax = fmaxf(rowmax, v);
      }
      dist[t] = v;
    }
    float lo = 0.f, hi = warp_max(rowmax);
    for (int it = 0; it < BISECT_ITERS; ++it) {
      const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
      if (warp_count(dist, mid) >= k)
        hi = mid;
      else
        lo = mid;
    }

    float gmax[CH];
#pragma unroll
    for (int ch = 0; ch < CH; ++ch) gmax[ch] = NEG;
#pragma unroll
    for (int t = 0; t < PER_LANE; ++t) {
      const int j = lane + 32 * t;
      if (j < n && dist[t] <= hi) {
#pragma unroll
        for (int ch = 0; ch < CH; ++ch) gmax[ch] = fmaxf(gmax[ch], sg[ch * n + j]);
      }
    }
    float h[CH];
#pragma unroll
    for (int ch = 0; ch < CH; ++ch) {
      const float ci = __fadd_rn(dot3(xi, yi, zi, wc[ch], wc[CH + ch], wc[2 * CH + ch]), b1[ch]);
      h[ch] = elu(__fadd_rn(ci, warp_max(gmax[ch])));
    }

    const long long orow = ((long long)b * n + i) * d;
    for (int col = lane; col < d; col += 32) {
      float acc = __fmul_rn(h[0], w2[col]);
#pragma unroll
      for (int ch = 1; ch < CH; ++ch) acc = __fadd_rn(acc, __fmul_rn(h[ch], w2[ch * d + col]));
      const float v = elu(__fadd_rn(acc, b2[col]));
      if (OUT_BF16)
        static_cast<__nv_bfloat16*>(out)[orow + col] = __float2bfloat16_rn(v);
      else
        static_cast<float*>(out)[orow + col] = v;
    }
    if (kth != nullptr) {
      const int cnt = warp_count(dist, hi);
      if (lane == 0) {
        kth[(long long)b * n + i] = hi;
        count[(long long)b * n + i] = cnt;
      }
    }
  }
}

}  // namespace

// pts: (b, n, 3) fp32; wc = Wa' + Wb' and wb = Wb': (3, 6) fp32; b1:
// (6,) fp32; w2: (6, d) fp32; b2: (d,) fp32, all contiguous. out: (b, n,
// d), bf16 when out_bf16 else fp32. kth (fp32) and count (int32), both
// (b, n) or both null: each row's threshold and neighbour count. Needs
// 1 <= n <= 1024 and 1 <= k <= n (the wrapper checks). Returns the
// cudaError_t of the launch.
extern "C" int peekvit_arpe_tokens(const void* pts, const void* wc, const void* wb,
                                   const void* b1, const void* w2, const void* b2, void* out,
                                   int out_bf16, void* kth, void* count, int b, int n, int d,
                                   int k, void* stream) {
  if (b == 0 || n == 0) return 0;
  if (n > MAX_N || k < 1 || k > n || d < 1 || (kth == nullptr) != (count == nullptr))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((n + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK, b);
  const size_t smem = (size_t)(C + 1 + CH) * n * sizeof(float);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const float*>(pts);
  const auto* fc = static_cast<const float*>(wc);
  const auto* fb = static_cast<const float*>(wb);
  const auto* f1 = static_cast<const float*>(b1);
  const auto* f2 = static_cast<const float*>(w2);
  const auto* fb2 = static_cast<const float*>(b2);
  auto* fk = static_cast<float*>(kth);
  auto* ik = static_cast<int*>(count);
  if (out_bf16)
    arpe_kernel<true><<<grid, THREADS, smem, st>>>(p, fc, fb, f1, f2, fb2, out, fk, ik, n, d, k);
  else
    arpe_kernel<false><<<grid, THREADS, smem, st>>>(p, fc, fb, f1, f2, fb2, out, fk, ik, n, d, k);
  return (int)cudaGetLastError();
}
