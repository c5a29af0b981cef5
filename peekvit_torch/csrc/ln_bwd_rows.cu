// LayerNorm backward of the trainable attention block, one warp per row.
//
// Replaces the LN-backward tail of the two backward kernels of
// peekvit_tpu/ops/pallas/fused_attention_vjp.py (_attn_bwd_kernel :93 at
// :158-169, _attn_bwd_kernel_saved :172 at :238-245). Per row, from x
// (bf16), dln (fp32, = dqkv . Wqkv^T), g (the block's output cotangent)
// and gamma:
//   - the two-pass mean and inv = rsqrt(var + eps) of _ln_f32 (:29-35),
//     and xhat = (x - mean) * inv, all fp32;
//   - dx = _ln_bwd(dln, xhat, inv, gamma) + g (:38-43):
//     dxhat = dln * gamma, dx = (dxhat - mean(dxhat) - xhat *
//     mean(dxhat * xhat)) * inv + g, rounded once to bf16;
//   - per-block column partials of sum(dln * xhat) and sum(dln) in fp32,
//     which the caller sums (as XLA sums the Pallas per-cell partials,
//     :347-348).
//
// Bound on H100: bytes (x, g, dx in bf16 and dln in fp32: 10 bytes per
// element for a few tens of flops). Design: 8 warps per block, each warp
// owns 8 rows in turn and keeps the row in registers (16-byte loads, 8
// values per lane and step, warp-shuffle reductions, no shared memory for
// the row statistics). Each lane keeps its columns' partials in registers
// across its rows; at the end the 8 warps' partials meet in shared memory
// and are summed in a fixed order, so reruns give the same bits (no
// atomics). 64 rows per block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int ROWS_PER_WARP = 8;
constexpr int ROWS_PER_BLOCK = WARPS * ROWS_PER_WARP;
constexpr int MAX_D = 1024;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float* v) {
  float4 a = *reinterpret_cast<const float4*>(p);
  float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// NC = ceil(d / 256): 8-value chunks per lane (column lane*8 + i*256).
template <int NC>
__global__ void __launch_bounds__(WARPS * 32)
ln_bwd_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ dln,
              const __nv_bfloat16* __restrict__ g, const __nv_bfloat16* __restrict__ gamma,
              __nv_bfloat16* __restrict__ dx, float* __restrict__ part_w,
              float* __restrict__ part_b, long long rows, int d, float eps) {
  __shared__ float red[WARPS][MAX_D];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float inv_d = 1.0f / (float)d;

  float gam[NC][8], pw[NC][8], pb[NC][8];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = lane * 8 + i * 256;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      gam[i][e] = 0.f;
      pw[i][e] = 0.f;
      pb[i][e] = 0.f;
    }
    if (c < d) load8(gamma + c, gam[i]);
  }

  for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
    const long long row = (long long)blockIdx.x * ROWS_PER_BLOCK + rr * WARPS + warp;
    if (row >= rows) break;
    float xv[NC][8], dv[NC][8];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane * 8 + i * 256;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        xv[i][e] = 0.f;
        dv[i][e] = 0.f;
      }
      if (c < d) {
        load8(x + row * d + c, xv[i]);
        load8(dln + row * d + c, dv[i]);
#pragma unroll
        for (int e = 0; e < 8; ++e) sum += xv[i][e];
      }
    }
    const float mu = warp_sum(sum) * inv_d;
    float dev = 0.f;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      if (lane * 8 + i * 256 < d) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float t = xv[i][e] - mu;
          dev += t * t;
        }
      }
    }
    const float inv = rsqrtf(warp_sum(dev) * inv_d + eps);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        xv[i][e] = (xv[i][e] - mu) * inv;  // xhat; unused columns have dv = 0
        const float dxhat = dv[i][e] * gam[i][e];
        s1 += dxhat;
        s2 += dxhat * xv[i][e];
        pw[i][e] += dv[i][e] * xv[i][e];
        pb[i][e] += dv[i][e];
      }
    }
    const float m1 = warp_sum(s1) * inv_d, m2 = warp_sum(s2) * inv_d;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane * 8 + i * 256;
      if (c < d) {
        float gv[8], out[8];
        load8(g + row * d + c, gv);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          out[e] = (dv[i][e] * gam[i][e] - m1 - xv[i][e] * m2) * inv + gv[e];
        store8(dx + row * d + c, out);
      }
    }
  }

  // Column partials of this block: the warps' registers summed in order.
#pragma unroll
  for (int which = 0; which < 2; ++which) {
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane * 8 + i * 256;
      if (c < d) {
#pragma unroll
        for (int e = 0; e < 8; ++e) red[warp][c + e] = which == 0 ? pw[i][e] : pb[i][e];
      }
    }
    __syncthreads();
    float* part = (which == 0 ? part_w : part_b) + (long long)blockIdx.x * d;
    for (int c = threadIdx.x; c < d; c += WARPS * 32) {
      float acc = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) acc += red[w][c];
      part[c] = acc;
    }
    __syncthreads();
  }
}

template <int NC>
int launch(const void* x, const void* dln, const void* g, const void* gamma, void* dx,
           void* part_w, void* part_b, long long rows, int d, float eps, cudaStream_t stream) {
  const unsigned grid = (unsigned)((rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK);
  ln_bwd_kernel<NC><<<grid, WARPS * 32, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(dln),
      static_cast<const __nv_bfloat16*>(g), static_cast<const __nv_bfloat16*>(gamma),
      static_cast<__nv_bfloat16*>(dx), static_cast<float*>(part_w),
      static_cast<float*>(part_b), rows, d, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// x, g, dx: (rows, d) bf16; dln: (rows, d) fp32; gamma: (d,) bf16;
// part_w, part_b: (ceil(rows / 64), d) fp32, the per-block column sums of
// dln * xhat and dln. d must be a multiple of 8 and at most 1024, every
// pointer 16-byte aligned (the wrapper checks). Returns the cudaError_t
// of the launch.
extern "C" int peekvit_ln_bwd_rows(const void* x, const void* dln, const void* g,
                                   const void* gamma, void* dx, void* part_w, void* part_b,
                                   long long rows, int d, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == 0) return 0;
  switch ((d + 255) / 256) {
    case 1:
      return launch<1>(x, dln, g, gamma, dx, part_w, part_b, rows, d, eps, s);
    case 2:
      return launch<2>(x, dln, g, gamma, dx, part_w, part_b, rows, d, eps, s);
    case 3:
      return launch<3>(x, dln, g, gamma, dx, part_w, part_b, rows, d, eps, s);
    case 4:
      return launch<4>(x, dln, g, gamma, dx, part_w, part_b, rows, d, eps, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
