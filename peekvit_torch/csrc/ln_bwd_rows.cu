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
//
// The masked mode ("ln_bwd_rows.masked") is the tail of the masked
// trainable block's backward kernels (_masked_bwd_kernel :445 at
// :536-547, _masked_bwd_kernel_saved :550 at :621-631), where the block's
// input to the qkv GEMM was s1 = mask * LN(x) and the row mask is a
// differentiable operand. The kernel reads ds1 = dqkv . Wqkv^T (fp32) in
// dln's place, the mask, beta and the per-(row, column tile) partials of
// sum(g * proj) that GEMM epilogue masked_rowdot wrote, and per row:
//   - ln_f32 = xhat * gamma + beta, fp32 and never rounded (:624);
//   - dm = sum(partials) + sum(ds1 * ln_f32), rounded once to bf16 (the
//     mask's dtype): the gate cotangent's output-mask and input-mask terms;
//   - dln = ds1 * mask, then dx and the column partials from dln as above.
// Same bound (bytes) and design; beta is read per row from L1 rather than
// held in registers, which the unmasked mode already fills.
//
// Two operand-type variants carry the LN backwards of the merged
// trainable layer (peekvit_tpu/ops/pallas/fused_layer_vjp.py:135
// _layer_bwd_kernel):
//   - "ln_bwd_rows.f32" (LN2, :206-208): x is the fp32 mid residual y, g
//     the layer's bf16 output cotangent; it writes dy in fp32 (dx's
//     place), its bf16 copy (dx_b, the next GEMMs' operand, :211) and a
//     third set of column partials, sum(dy), for dbo (:215);
//   - "ln_bwd_rows.g_f32" (LN1, :262-265): g is that fp32 dy, x the bf16
//     layer input, dx bf16.
// The bf16 mode is the same template at <bf16, bf16, false>: its
// arithmetic is unchanged.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

__device__ __forceinline__ void store8(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

// NC = ceil(d / 256): 8-value chunks per lane (column lane*8 + i*256).
// TX, TG: the types of x and g. F32OUT: dx is fp32, with its bf16 copy in
// dx_b and its column partials in part_dx.
template <int NC, bool MASKED, typename TX, typename TG, bool F32OUT>
__global__ void __launch_bounds__(WARPS * 32)
ln_bwd_kernel(const TX* __restrict__ x, const float* __restrict__ dln,
              const TG* __restrict__ g, const __nv_bfloat16* __restrict__ gamma,
              typename std::conditional<F32OUT, float, __nv_bfloat16>::type* __restrict__ dx,
              __nv_bfloat16* __restrict__ dx_b, float* __restrict__ part_w,
              float* __restrict__ part_b, float* __restrict__ part_dx, long long rows, int d,
              float eps, const __nv_bfloat16* __restrict__ mask,
              const __nv_bfloat16* __restrict__ beta, const float* __restrict__ rowdot,
              int rowdot_parts, __nv_bfloat16* __restrict__ dm) {
  __shared__ float red[WARPS][MAX_D];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float inv_d = 1.0f / (float)d;

  float gam[NC][8], pw[NC][8], pb[NC][8], pd[F32OUT ? NC : 1][8];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = lane * 8 + i * 256;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      gam[i][e] = 0.f;
      pw[i][e] = 0.f;
      pb[i][e] = 0.f;
      if (F32OUT) pd[F32OUT ? i : 0][e] = 0.f;
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
#pragma unroll
    for (int i = 0; i < NC; ++i) {
#pragma unroll
      for (int e = 0; e < 8; ++e) xv[i][e] = (xv[i][e] - mu) * inv;  // xhat
    }
    if (MASKED) {
      // dm = sum(g * proj) + sum(ds1 * ln_f32); then dln = ds1 * mask
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int c = lane * 8 + i * 256;
        if (c < d) {
          float bet[8];
          load8(beta + c, bet);
#pragma unroll
          for (int e = 0; e < 8; ++e) dot += dv[i][e] * (xv[i][e] * gam[i][e] + bet[e]);
        }
      }
      dot = warp_sum(dot);
      float rd = 0.f;
      for (int p = 0; p < rowdot_parts; ++p) rd += rowdot[row * rowdot_parts + p];
      if (lane == 0) dm[row] = __float2bfloat16_rn(rd + dot);
      const float mk = __bfloat162float(mask[row]);
#pragma unroll
      for (int i = 0; i < NC; ++i) {
#pragma unroll
        for (int e = 0; e < 8; ++e) dv[i][e] *= mk;
      }
    }
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {  // unused columns have dv = 0
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
        if (F32OUT) {
          store8(dx_b + row * d + c, out);
#pragma unroll
          for (int e = 0; e < 8; ++e) pd[F32OUT ? i : 0][e] += out[e];
        }
      }
    }
  }

  // Column partials of this block: the warps' registers summed in order.
#pragma unroll
  for (int which = 0; which < (F32OUT ? 3 : 2); ++which) {
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane * 8 + i * 256;
      if (c < d) {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          red[warp][c + e] = which == 0 ? pw[i][e] : which == 1 ? pb[i][e] : pd[F32OUT ? i : 0][e];
      }
    }
    __syncthreads();
    float* part = (which == 0 ? part_w : which == 1 ? part_b : part_dx) + (long long)blockIdx.x * d;
    for (int c = threadIdx.x; c < d; c += WARPS * 32) {
      float acc = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) acc += red[w][c];
      part[c] = acc;
    }
    __syncthreads();
  }
}

template <int NC, bool MASKED, typename TX, typename TG, bool F32OUT>
int launch(const void* x, const void* dln, const void* g, const void* gamma, void* dx,
           void* dx_b, void* part_w, void* part_b, void* part_dx, long long rows, int d,
           float eps, const void* mask, const void* beta, const void* rowdot, int rowdot_parts,
           void* dm, cudaStream_t stream) {
  using DX = typename std::conditional<F32OUT, float, __nv_bfloat16>::type;
  const unsigned grid = (unsigned)((rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK);
  ln_bwd_kernel<NC, MASKED, TX, TG, F32OUT><<<grid, WARPS * 32, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const float*>(dln), static_cast<const TG*>(g),
      static_cast<const __nv_bfloat16*>(gamma), static_cast<DX*>(dx),
      static_cast<__nv_bfloat16*>(dx_b), static_cast<float*>(part_w),
      static_cast<float*>(part_b), static_cast<float*>(part_dx), rows, d, eps,
      static_cast<const __nv_bfloat16*>(mask), static_cast<const __nv_bfloat16*>(beta),
      static_cast<const float*>(rowdot), rowdot_parts, static_cast<__nv_bfloat16*>(dm));
  return (int)cudaGetLastError();
}

// mode 0 bf16 (masked or not), 1 fp32 x with fp32 dx, 2 fp32 g.
template <int NC>
int dispatch(int mode, const void* x, const void* dln, const void* g, const void* gamma,
             void* dx, void* dx_b, void* part_w, void* part_b, void* part_dx, long long rows,
             int d, float eps, const void* mask, const void* beta, const void* rowdot,
             int rowdot_parts, void* dm, cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  if (mode == 1)
    return launch<NC, false, float, bf16, true>(x, dln, g, gamma, dx, dx_b, part_w, part_b,
                                                part_dx, rows, d, eps, mask, beta, rowdot,
                                                rowdot_parts, dm, s);
  if (mode == 2)
    return launch<NC, false, bf16, float, false>(x, dln, g, gamma, dx, dx_b, part_w, part_b,
                                                 part_dx, rows, d, eps, mask, beta, rowdot,
                                                 rowdot_parts, dm, s);
  return mask != nullptr
             ? launch<NC, true, bf16, bf16, false>(x, dln, g, gamma, dx, dx_b, part_w, part_b,
                                                   part_dx, rows, d, eps, mask, beta, rowdot,
                                                   rowdot_parts, dm, s)
             : launch<NC, false, bf16, bf16, false>(x, dln, g, gamma, dx, dx_b, part_w, part_b,
                                                    part_dx, rows, d, eps, mask, beta, rowdot,
                                                    rowdot_parts, dm, s);
}

}  // namespace

// mode 0: x, g, dx: (rows, d) bf16. mode 1 (LN2 of the merged layer):
// x fp32, dx fp32, plus dx_b ((rows, d) bf16, dx rounded) and part_dx
// (the column partials of dx). mode 2 (its LN1): g fp32. dln: (rows, d)
// fp32; gamma: (d,) bf16; part_w, part_b (and part_dx):
// (ceil(rows / 64), d) fp32, the per-block column sums of dln * xhat and
// dln (and dx). The masked mode (mode 0, mask != nullptr) also takes mask
// ((rows,) bf16), beta ((d,) bf16) and rowdot ((rows, rowdot_parts)
// fp32), reads dln as ds1, and writes dm ((rows,) bf16). d must be a
// multiple of 8 and at most 1024, every pointer 16-byte aligned (the
// wrapper checks). Returns the cudaError_t of the launch (a masked call
// missing beta, rowdot or dm, a masked call in mode 1 or 2, or mode 1
// without dx_b or part_dx, returns cudaErrorInvalidValue).
extern "C" int peekvit_ln_bwd_rows(const void* x, const void* dln, const void* g,
                                   const void* gamma, void* dx, void* dx_b, void* part_w,
                                   void* part_b, void* part_dx, long long rows, int d, float eps,
                                   int mode, const void* mask, const void* beta,
                                   const void* rowdot, int rowdot_parts, void* dm,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == 0) return 0;
  if (mode < 0 || mode > 2 || (mask != nullptr && mode != 0) ||
      (mode == 1 && (dx_b == nullptr || part_dx == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (mask != nullptr && (beta == nullptr || rowdot == nullptr || dm == nullptr))
    return (int)cudaErrorInvalidValue;
  switch ((d + 255) / 256) {
    case 1:
      return dispatch<1>(mode, x, dln, g, gamma, dx, dx_b, part_w, part_b, part_dx, rows, d, eps,
                         mask, beta, rowdot, rowdot_parts, dm, s);
    case 2:
      return dispatch<2>(mode, x, dln, g, gamma, dx, dx_b, part_w, part_b, part_dx, rows, d, eps,
                         mask, beta, rowdot, rowdot_parts, dm, s);
    case 3:
      return dispatch<3>(mode, x, dln, g, gamma, dx, dx_b, part_w, part_b, part_dx, rows, d, eps,
                         mask, beta, rowdot, rowdot_parts, dm, s);
    case 4:
      return dispatch<4>(mode, x, dln, g, gamma, dx, dx_b, part_w, part_b, part_dx, rows, d, eps,
                         mask, beta, rowdot, rowdot_parts, dm, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
