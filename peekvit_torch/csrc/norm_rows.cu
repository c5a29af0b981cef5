// Row normalization for the encoder layer: one warp per row.
//
// Replaces the normalization step of the Pallas layer kernel,
// peekvit_tpu/ops/pallas/fused_attention.py:583 _norm_rows (one-pass
// statistics, no affine: the LN affine is folded into the next matmul's
// weights) and, with mode 1, the two-pass LayerNorm with affine of
// _attn_block_kernel (fused_attention.py:253-258) used by the split
// fused_attention_block path.
//
// With the LN affine and a per-row mask it also carries the ResidualViT
// mask * LN(x) steps: one-pass statistics with affine and mask for the
// masked layer kernel (_layer_kernel mode 'masked', :672-678 and
// :707-710, via _ln_f32_rows :578), and two-pass with affine and mask for
// the split masked sublayers (_masked_attn_kernel :389-395,
// _masked_mlp_kernel :426-432). The affine cannot be folded there: the row
// mask does not commute with the folded bias term.
//
// With mode 2 it carries A-ViT's LN(x * a) * a (_layer_kernel mode 'avit',
// :671-672 and :704-705; reference adavit.py:65-70): each value is
// multiplied by its row's mask in fp32 BEFORE the one-pass statistics,
// then the affine, then the mask again. For a 0/1 mask this is the masked
// mode's value (up to the sign of a zero), but the Pallas contract takes
// any mask, so the kernel computes the contract.
//
// Bound on H100: bytes. A ViT-B row is 768 values; the kernel reads the
// row and writes it back in bf16, a few flops per byte. Design, for rows
// of up to 1024 values (every width the port runs) in every mode but
// ln_rows of bf16 rows (see launch below): a persistent grid of
// as many 256-thread blocks as fit on the card at once; each warp walks
// rows row, row + stride, ..., holds its row in registers (d / 256
// chunks of 8 values a lane, read with 16-byte loads: 8 bf16 or two
// float4), starts the next row's loads before it reduces the current
// one, and keeps its columns' LN affine in registers for all its rows.
// So the statistics (two passes included) and the output come from one
// read of device memory, with two rows a warp in flight, where the
// one-warp-a-row kernel read a two-pass row three times, one pass
// waiting on the previous pass's shuffle sums. The sums are reduced with
// warp shuffles (no shared memory, no block barrier). Wider rows keep
// that one-warp-a-row kernel (8 rows a 256-thread block); both give the
// same bits.
//
// Numerics follow the Pallas kernel: statistics in fp32,
// var = max(E[x^2] - mu^2, 0) (one pass) or E[(x - mu)^2] (two passes),
// rsqrt(var + eps), then * scale + bias, then * mask[row] (the bf16 mask
// read as fp32), one rounding to bf16 at the end; mode 2 first takes
// x * mask[row] in fp32 as the row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// A chunk of 8 row values as loaded: one uint4 of bf16, or two float4 of
// fp32. The resident kernel keeps the next row's chunks in this form
// while it reduces the current row.
template <typename T>
struct Raw;
template <>
struct Raw<__nv_bfloat16> {
  uint4 a;
};
template <>
struct Raw<float> {
  float4 a, b;
};

__device__ __forceinline__ void load_raw(const __nv_bfloat16* p, Raw<__nv_bfloat16>& r) {
  r.a = *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ void load_raw(const float* p, Raw<float>& r) {
  r.a = *reinterpret_cast<const float4*>(p);
  r.b = *reinterpret_cast<const float4*>(p + 4);
}

__device__ __forceinline__ void unpack(const Raw<__nv_bfloat16>& r, float* v) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r.a);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void unpack(const Raw<float>& r, float* v) {
  v[0] = r.a.x; v[1] = r.a.y; v[2] = r.a.z; v[3] = r.a.w;
  v[4] = r.b.x; v[5] = r.b.y; v[6] = r.b.z; v[7] = r.b.w;
}

// Loads 8 consecutive values of a row as fp32. T is __nv_bfloat16 (one
// 16-byte load) or float (two 16-byte loads).
template <typename T>
__device__ __forceinline__ void load8(const T* p, float* v) {
  Raw<T> r;
  load_raw(p, r);
  unpack(r, v);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

template <typename T, bool kTwoPass, bool kAffine, bool kMask, bool kPreMask>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
norm_rows_kernel(const T* __restrict__ x, const __nv_bfloat16* __restrict__ scale,
                 const __nv_bfloat16* __restrict__ bias,
                 const __nv_bfloat16* __restrict__ mask,
                 __nv_bfloat16* __restrict__ out, long long rows, int d,
                 float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + row * d;
  __nv_bfloat16* orow = out + row * d;
  const float inv_d = 1.0f / (float)d;
  const float m = kMask ? __bfloat162float(mask[row]) : 1.f;
  float v[8];

  float sum = 0.f, sq = 0.f;
  for (int c = lane * 8; c < d; c += 256) {
    load8(xr + c, v);
    if (kPreMask) {  // rounded, as the plain version's x * a
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = __fmul_rn(v[i], m);
    }
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
    if (kPreMask) {  // rounded, as the plain version's x * a
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = __fmul_rn(v[i], m);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = (v[i] - mu) * rs;
    if (kAffine) {
      float s[8], b[8];
      load8(scale + c, s);
      load8(bias + c, b);
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = v[i] * s[i] + b[i];
    }
    if (kMask) {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] *= m;
    }
    store8(orow + c, v);
  }
}

// The resident kernel: each warp walks rows row, row + stride, ... with
// its row in registers (kChunks chunks of 8 values a lane: d <= 256
// kChunks), the next row's loads started before the current row's
// reductions, and the LN affine of its columns loaded once. Each
// expression and each sum's order is the one-warp-a-row kernel's above:
// a lane sums its chunks in order, each chunk's values in order, then
// warp_sum; the same products and sums, so the same bits.
// Two blocks an SM (128 registers a thread) up to 768 values a row; at 4
// chunks the fp32 row, its successor and the affine need more.
template <typename T, int kChunks, bool kTwoPass, bool kAffine, bool kMask, bool kPreMask>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, kChunks < 4 ? 2 : 1)
norm_rows_resident(const T* __restrict__ x, const __nv_bfloat16* __restrict__ scale,
                   const __nv_bfloat16* __restrict__ bias,
                   const __nv_bfloat16* __restrict__ mask, __nv_bfloat16* __restrict__ out,
                   long long rows, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * kWarpsPerBlock;
  long long row = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const float inv_d = 1.0f / (float)d;
  bool has[kChunks];
#pragma unroll
  for (int ci = 0; ci < kChunks; ++ci) has[ci] = lane * 8 + 256 * ci < d;
  Raw<__nv_bfloat16> s_raw[kAffine ? kChunks : 1], b_raw[kAffine ? kChunks : 1];
  if (kAffine) {
#pragma unroll
    for (int ci = 0; ci < kChunks; ++ci)
      if (has[ci]) {
        load_raw(scale + lane * 8 + 256 * ci, s_raw[ci]);
        load_raw(bias + lane * 8 + 256 * ci, b_raw[ci]);
      }
  }
  Raw<T> next[kChunks];
  float next_m = 1.f;
  auto fetch = [&](long long r) {
    const T* xr = x + r * d + lane * 8;
#pragma unroll
    for (int ci = 0; ci < kChunks; ++ci)
      if (has[ci]) load_raw(xr + 256 * ci, next[ci]);
    if (kMask) next_m = __bfloat162float(mask[r]);
  };
  if (row < rows) fetch(row);
  for (; row < rows; row += stride) {
    float v[kChunks][8] = {};
#pragma unroll
    for (int ci = 0; ci < kChunks; ++ci)
      if (has[ci]) unpack(next[ci], v[ci]);
    const float m = next_m;
    if (row + stride < rows) fetch(row + stride);

    float sum = 0.f, sq = 0.f;
#pragma unroll
    for (int ci = 0; ci < kChunks; ++ci) {
      if (!has[ci]) continue;
      if (kPreMask) {  // rounded, as the plain version's x * a
#pragma unroll
        for (int i = 0; i < 8; ++i) v[ci][i] = __fmul_rn(v[ci][i], m);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        sum += v[ci][i];
        sq += v[ci][i] * v[ci][i];
      }
    }
    sum = warp_sum(sum);
    const float mu = sum * inv_d;
    float var;
    if (kTwoPass) {
      float dev = 0.f;
#pragma unroll
      for (int ci = 0; ci < kChunks; ++ci) {
        if (!has[ci]) continue;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float t = v[ci][i] - mu;
          dev += t * t;
        }
      }
      var = warp_sum(dev) * inv_d;
    } else {
      sq = warp_sum(sq);
      var = fmaxf(sq * inv_d - mu * mu, 0.f);
    }
    const float rs = rsqrtf(var + eps);

    __nv_bfloat16* orow = out + row * d + lane * 8;
#pragma unroll
    for (int ci = 0; ci < kChunks; ++ci) {
      if (!has[ci]) continue;
      float o[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) o[i] = (v[ci][i] - mu) * rs;
      if (kAffine) {
        float s[8], b[8];
        unpack(s_raw[ci], s);
        unpack(b_raw[ci], b);
#pragma unroll
        for (int i = 0; i < 8; ++i) o[i] = o[i] * s[i] + b[i];
      }
      if (kMask) {
#pragma unroll
        for (int i = 0; i < 8; ++i) o[i] *= m;
      }
      store8(orow + 256 * ci, o);
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

template <typename T, int kChunks, bool kTwoPass, bool kAffine, bool kMask, bool kPreMask>
int launch_resident(const void* x, const void* scale, const void* bias, const void* mask,
                    void* out, long long rows, int d, float eps, cudaStream_t stream) {
  auto kernel = norm_rows_resident<T, kChunks, kTwoPass, kAffine, kMask, kPreMask>;
  static int per_sm = 0;  // resident blocks an SM, for this instance
  if (per_sm == 0 &&
      (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kWarpsPerBlock * 32, 0) !=
           cudaSuccess ||
       per_sm < 1))
    per_sm = 1;
  const long long blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const unsigned grid = (unsigned)(blocks < (long long)sm_count() * per_sm
                                       ? blocks
                                       : (long long)sm_count() * per_sm);
  kernel<<<grid, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const __nv_bfloat16*>(scale),
      static_cast<const __nv_bfloat16*>(bias), static_cast<const __nv_bfloat16*>(mask),
      static_cast<__nv_bfloat16*>(out), rows, d, eps);
  return (int)cudaGetLastError();
}

// The resident kernel for rows of up to 1024 values, the one-warp-a-row
// kernel past that and for ln_rows (two passes of unmasked bf16 rows),
// which the resident kernel did not make faster at ViT-B/16's width
// (scripts/kernel_bit_identity.py): there the one-warp-a-row grid's 64
// warps an SM already keep enough rows in flight.
template <typename T, bool kTwoPass, bool kAffine, bool kMask, bool kPreMask = false>
int launch(const void* x, const void* scale, const void* bias, const void* mask, void* out,
           long long rows, int d, float eps, cudaStream_t stream) {
  constexpr bool kKept = kTwoPass && !kMask && std::is_same<T, __nv_bfloat16>::value;
  if constexpr (!kKept) {
    switch ((d + 255) / 256) {
      case 1:
        return launch_resident<T, 1, kTwoPass, kAffine, kMask, kPreMask>(
            x, scale, bias, mask, out, rows, d, eps, stream);
      case 2:
        return launch_resident<T, 2, kTwoPass, kAffine, kMask, kPreMask>(
            x, scale, bias, mask, out, rows, d, eps, stream);
      case 3:
        return launch_resident<T, 3, kTwoPass, kAffine, kMask, kPreMask>(
            x, scale, bias, mask, out, rows, d, eps, stream);
      case 4:
        return launch_resident<T, 4, kTwoPass, kAffine, kMask, kPreMask>(
            x, scale, bias, mask, out, rows, d, eps, stream);
      default:
        break;
    }
  }
  const unsigned grid = (unsigned)((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  norm_rows_kernel<T, kTwoPass, kAffine, kMask, kPreMask>
      <<<grid, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const __nv_bfloat16*>(scale),
      static_cast<const __nv_bfloat16*>(bias), static_cast<const __nv_bfloat16*>(mask),
      static_cast<__nv_bfloat16*>(out), rows, d, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* scale, const void* bias, const void* mask, void* out,
             long long rows, int d, float eps, int mode, cudaStream_t s) {
  const bool affine = scale != nullptr, masked = mask != nullptr;
  if (mode == 2) {
    if (!affine || !masked) return (int)cudaErrorInvalidValue;
    return launch<T, false, true, true, true>(x, scale, bias, mask, out, rows, d, eps, s);
  }
  if (mode == 1) {
    if (!affine) return (int)cudaErrorInvalidValue;
    return masked ? launch<T, true, true, true>(x, scale, bias, mask, out, rows, d, eps, s)
                  : launch<T, true, true, false>(x, scale, bias, mask, out, rows, d, eps, s);
  }
  if (affine != masked) return (int)cudaErrorInvalidValue;
  return masked ? launch<T, false, true, true>(x, scale, bias, mask, out, rows, d, eps, s)
                : launch<T, false, false, false>(x, scale, bias, mask, out, rows, d, eps, s);
}

}  // namespace

// x: (rows, d) bf16 (in_f32 = 0) or fp32 (in_f32 = 1), row-major; out:
// (rows, d) bf16. scale and bias ((d,) bf16, or both null) select the
// affine; mask ((rows,) bf16, or null) multiplies each output row.
// mode 0: one-pass statistics, which take the affine exactly when they
// take the mask (unmasked, the affine is folded into the next GEMM);
// mode 1: two-pass statistics, needs the affine; mode 2: A-ViT's
// LN(x * mask) * mask, one-pass, needs the affine and the mask. Other
// combinations return cudaErrorInvalidValue. d must be a multiple of 8 and x, scale, bias and
// out 16-byte aligned (the wrapper checks). Returns the cudaError_t of
// the launch.
extern "C" int peekvit_norm_rows(const void* x, int in_f32, const void* scale,
                                 const void* bias, const void* mask, void* out,
                                 long long rows, int d, float eps, int mode,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == 0) return 0;
  if ((scale == nullptr) != (bias == nullptr) || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  return in_f32 ? dispatch<float>(x, scale, bias, mask, out, rows, d, eps, mode, s)
                : dispatch<__nv_bfloat16>(x, scale, bias, mask, out, rows, d, eps, mode, s);
}
