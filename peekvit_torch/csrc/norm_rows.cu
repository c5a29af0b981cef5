// Row normalization for the encoder layer: one warp per row.
//
// Replaces the normalization step of the Pallas layer kernel,
// peekvit_tpu/ops/pallas/fused_attention.py:583 _norm_rows (one-pass
// statistics, no affine: the LN affine is folded into the next matmul's
// weights) and, with two_pass=1, the two-pass LayerNorm with affine of
// _attn_block_kernel (fused_attention.py:253-258) used by the split
// fused_attention_block path.
//
// Bound on H100: bytes. A ViT-B row is 768 values; the kernel reads the
// row and writes it back in bf16, a few flops per byte. Design: one warp
// owns a row, reads it with 16-byte vector loads (8 bf16 or 4 fp32 per
// lane and step), reduces the sums with warp shuffles (no shared memory,
// no block barrier), and reads the row a second time for the output
// (the second read mostly hits L1/L2). Eight rows per 256-thread block.
//
// Numerics follow the Pallas kernel: statistics in fp32,
// var = max(E[x^2] - mu^2, 0), rsqrt(var + eps), result rounded to bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Loads 8 consecutive values of a row as fp32. T is __nv_bfloat16 (one
// 16-byte load) or float (two 16-byte loads).
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

template <typename T, bool kTwoPass>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
norm_rows_kernel(const T* __restrict__ x, const __nv_bfloat16* __restrict__ scale,
                 const __nv_bfloat16* __restrict__ bias,
                 __nv_bfloat16* __restrict__ out, long long rows, int d,
                 float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + row * d;
  __nv_bfloat16* orow = out + row * d;
  const float inv_d = 1.0f / (float)d;
  float v[8];

  float sum = 0.f, sq = 0.f;
  for (int c = lane * 8; c < d; c += 256) {
    load8(xr + c, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      sum += v[i];
      sq += v[i] * v[i];
    }
  }
  sum = warp_sum(sum);
  const float mu = sum * inv_d;
  float var;
  if (kTwoPass) {
    float dev = 0.f;
    for (int c = lane * 8; c < d; c += 256) {
      load8(xr + c, v);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float t = v[i] - mu;
        dev += t * t;
      }
    }
    var = warp_sum(dev) * inv_d;
  } else {
    sq = warp_sum(sq);
    var = fmaxf(sq * inv_d - mu * mu, 0.f);
  }
  const float rs = rsqrtf(var + eps);

  for (int c = lane * 8; c < d; c += 256) {
    load8(xr + c, v);
    if (kTwoPass) {
      float s[8], b[8];
      load8(scale + c, s);
      load8(bias + c, b);
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = (v[i] - mu) * rs * s[i] + b[i];
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = (v[i] - mu) * rs;
    }
    store8(orow + c, v);
  }
}

template <typename T, bool kTwoPass>
int launch(const void* x, const void* scale, const void* bias, void* out,
           long long rows, int d, float eps, cudaStream_t stream) {
  const unsigned grid = (unsigned)((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  norm_rows_kernel<T, kTwoPass><<<grid, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const __nv_bfloat16*>(scale),
      static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(out),
      rows, d, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (rows, d) bf16 (in_f32 = 0) or fp32 (in_f32 = 1), row-major; out:
// (rows, d) bf16. two_pass = 1 selects two-pass statistics plus the affine
// (scale, bias: (d,) bf16); otherwise scale and bias are ignored.
// d must be a multiple of 8 and every pointer 16-byte aligned (the
// wrapper checks). Returns the cudaError_t of the launch.
extern "C" int peekvit_norm_rows(const void* x, int in_f32, const void* scale,
                                 const void* bias, void* out, long long rows,
                                 int d, float eps, int two_pass,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == 0) return 0;
  if (in_f32) {
    return two_pass ? launch<float, true>(x, scale, bias, out, rows, d, eps, s)
                    : launch<float, false>(x, scale, bias, out, rows, d, eps, s);
  }
  return two_pass
             ? launch<__nv_bfloat16, true>(x, scale, bias, out, rows, d, eps, s)
             : launch<__nv_bfloat16, false>(x, scale, bias, out, rows, d, eps, s);
}
