// Row quantization for the int8 (w8a8) layer: one warp per row.
//
// Replaces the activation quantization inside the Pallas int8 kernels of
// peekvit_tpu/ops/pallas/quant_blocks.py: _quant_rows (:42-60) and, with
// the LN affine, _ln_f32 (:73-86) followed by _quant_rows. _q_layer_kernel
// (:359) runs it four times per layer: LN1 of the layer input x (bf16,
// :385-388), the bf16 attention output (:407), LN2 of the fp32 mid
// residual y (:413-416) and the fp32 gelu output (:419); _q_attn_kernel
// (:145) and _q_mlp_kernel (:177), the split sublayers, run the same
// steps. With a row mask it carries the ResidualViT int8 layer's
// mask * LN(x) (_q_layer_kernel mode 'masked', :384-387 and :411-413;
// _q_masked_attn_kernel :259 and _q_masked_mlp_kernel :289): the LN
// output times the row's mask in fp32, and only then the scale and the
// codes. The mask is continuous (relu(sig - thr) in [0, 1)), so with a
// static cap the multiply comes before the rounding; a row of zeros
// takes the 1e-12 floor and all-zero codes.
//
// Numerics follow the Pallas kernel, every step in fp32:
//   LN (optional): mu = sum(x) / d, ms = sum(x * x) / d,
//     var = max(ms - mu * mu, 0), v = (x - mu) * rsqrt(var + eps) * scale
//     + bias; the affine is applied, not folded, and v is never rounded
//     to bf16 (unlike norm_rows); masked: v = v * mask[row] (bf16 mask
//     read as fp32);
//   dynamic: s = max(max|v| / 127, 1e-12), one per row, written out;
//   static: s = max(cap, 1e-12) / 127, computed by the wrapper and shared
//     by every row (values beyond the cap saturate);
//   code = clamp(rint(v / s), -127, 127): true IEEE division (no
//     reciprocal, no __fdividef) and round half to even, as jnp.round.
// The products and sums of the LN output and the division use the
// __f*_rn intrinsics, so nvcc contracts none of them into an FMA: each
// step rounds where the plain version's separate torch ops round. The
// statistics' sums run in another order than torch's (and rsqrtf is not
// correctly rounded), so a code can differ from the plain version's by 1
// where v / s lies within an ulp or two of a .5 boundary.
//
// Bound on H100: bytes. The kernel reads each row once (bf16 or fp32)
// and writes it back as int8 plus one fp32 scale, a few operations per
// byte. Design: one warp owns a row and keeps it in registers (up to
// 12 x 256 values: 8 consecutive values per lane and chunk, read with
// 16-byte loads), reduces the statistics and the absmax with warp
// shuffles (no shared memory, no atomics, no block barrier) and writes
// each lane's 8 codes with one 8-byte store. Eight rows per 256-thread
// block.

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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
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

// C: chunks of 256 values (8 per lane) a row may hold; d <= 256 * C.
template <typename T, int C, bool kLN, bool kMask, bool kStatic>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
quant_rows_kernel(const T* __restrict__ x, const __nv_bfloat16* __restrict__ scale,
                  const __nv_bfloat16* __restrict__ bias,
                  const __nv_bfloat16* __restrict__ mask, int8_t* __restrict__ codes,
                  float* __restrict__ row_scale, long long rows, int d, float eps,
                  float s_static) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + row * d;
  float v[C][8];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int col = c * 256 + lane * 8;
    if (col < d) {
      load8(xr + col, v[c]);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[c][i] = 0.f;
    }
  }

  if (kLN) {
    float sum = 0.f, sq = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int i = 0; i < 8; ++i) {  // padding lanes hold zeros
        sum += v[c][i];
        sq += v[c][i] * v[c][i];
      }
    const float fd = (float)d;
    const float mu = __fdiv_rn(warp_sum(sum), fd);
    const float ms = __fdiv_rn(warp_sum(sq), fd);
    const float var = fmaxf(__fsub_rn(ms, __fmul_rn(mu, mu)), 0.f);
    const float rs = rsqrtf(__fadd_rn(var, eps));
    const float m = kMask ? __bfloat162float(mask[row]) : 1.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = c * 256 + lane * 8;
      if (col >= d) continue;
      float s[8], b[8];
      load8(scale + col, s);
      load8(bias + col, b);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        v[c][i] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v[c][i], mu), rs), s[i]), b[i]);
        if (kMask) v[c][i] = __fmul_rn(v[c][i], m);
      }
    }
  }

  // The row's absmax: the dynamic scale, and for both modes the test for
  // an all-zero row (a masked row, or gelu(0)), whose codes are 0 and
  // which skips the division on a warp-uniform branch: a zero dividend
  // takes __fdiv_rn's slow path. (fmaxf drops NaN, so a row of zeros and
  // NaN, the garbage a key-masked engine leaves in excluded rows, also
  // gets zero codes.)
  float amax = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (c * 256 + lane * 8 >= d) continue;
#pragma unroll
    for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(v[c][i]));
  }
  amax = warp_max(amax);
  float s = s_static;
  if (!kStatic) {
    s = fmaxf(__fdiv_rn(amax, 127.f), 1e-12f);
    if (lane == 0) row_scale[row] = s;
  }

  int8_t* cr = codes + row * d;
  const bool zero_row = amax == 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int col = c * 256 + lane * 8;
    if (col >= d) continue;
    uint32_t packed[2] = {0u, 0u};
    if (!zero_row) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float q = fminf(fmaxf(rintf(__fdiv_rn(v[c][i], s)), -127.f), 127.f);
        packed[i >> 2] |= (uint32_t)(uint8_t)(int8_t)(int)q << (8 * (i & 3));
      }
    }
    *reinterpret_cast<uint2*>(cr + col) = make_uint2(packed[0], packed[1]);
  }
}

struct Args {
  const void* x;
  const void* scale;
  const void* bias;
  const void* mask;
  void* codes;
  void* row_scale;
  long long rows;
  int d;
  float eps;
  float s_static;
};

template <typename T, int C, bool kLN, bool kMask, bool kStatic>
int launch(const Args& a, cudaStream_t stream) {
  const unsigned grid = (unsigned)((a.rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  quant_rows_kernel<T, C, kLN, kMask, kStatic><<<grid, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(a.x), static_cast<const __nv_bfloat16*>(a.scale),
      static_cast<const __nv_bfloat16*>(a.bias), static_cast<const __nv_bfloat16*>(a.mask),
      static_cast<int8_t*>(a.codes), static_cast<float*>(a.row_scale), a.rows, a.d, a.eps,
      a.s_static);
  return (int)cudaGetLastError();
}

template <typename T, int C, bool kStatic>
int by_mode(const Args& a, cudaStream_t s) {
  if (a.scale == nullptr) return launch<T, C, false, false, kStatic>(a, s);
  return a.mask != nullptr ? launch<T, C, true, true, kStatic>(a, s)
                           : launch<T, C, true, false, kStatic>(a, s);
}

template <typename T>
int by_width(const Args& a, int is_static, cudaStream_t s) {
  if (a.d <= 4 * 256)
    return is_static ? by_mode<T, 4, true>(a, s) : by_mode<T, 4, false>(a, s);
  return is_static ? by_mode<T, 12, true>(a, s) : by_mode<T, 12, false>(a, s);
}

}  // namespace

// x: (rows, d) bf16 (in_f32 = 0) or fp32 (in_f32 = 1), row-major. scale
// and bias ((d,) bf16, or both null) select the LN with its affine; mask
// ((rows,) bf16, or null; only with the LN) multiplies each LN output row
// before the scale and the codes. codes: (rows, d) int8 out. is_static =
// 0: row_scale ((rows,) fp32) gets each row's scale; is_static = 1: every
// row uses s_static (the wrapper's max(cap, 1e-12) / 127) and row_scale
// is not written. d must be a multiple of 8 and at most 3072; x, scale,
// bias 16-byte and codes 8-byte aligned (the wrapper checks). Other
// inputs return cudaErrorInvalidValue. Returns the cudaError_t of the
// launch.
extern "C" int peekvit_quant_rows(const void* x, int in_f32, const void* scale,
                                  const void* bias, const void* mask, void* codes,
                                  void* row_scale, long long rows, int d, float eps,
                                  float s_static, int is_static, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == 0) return 0;
  if ((scale == nullptr) != (bias == nullptr) || (mask != nullptr && scale == nullptr) ||
      d % 8 != 0 || d <= 0 || d > 12 * 256 || (!is_static && row_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a{x, scale, bias, mask, codes, row_scale, rows, d, eps, s_static};
  return in_f32 ? by_width<float>(a, is_static, s) : by_width<__nv_bfloat16>(a, is_static, s);
}
