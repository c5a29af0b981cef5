// C = dequant(A_s8 . W_s8) with a fused epilogue: the four int8 matrix
// products of the Pallas w8a8 layer.
//
// Replaces _qmatmul (peekvit_tpu/ops/pallas/quant_blocks.py:63-70) and the
// bias / residual / gelu steps around it in _q_layer_kernel (:359) and
// the split _q_attn_kernel (:145) / _q_mlp_kernel (:177):
//   epilogue 0 "bias":         + bias -> bf16                 (qkv, :389-390)
//   epilogue 1 "gelu_f32":     + bias, tanh-gelu -> fp32      (fc1, :417-418; h is never rounded)
//   epilogue 2 "residual_f32": + bias + residual -> fp32      (merged out-proj, :408-411: y)
//   epilogue 3 "residual":     + bias + residual -> bf16      (fc2 :420, split out-proj :173, fc2 :187)
// and, with a per-row mask (the ResidualViT int8 layer, mode 'masked'):
//   epilogue 4 "masked_residual_f32": (+ bias) * mask + residual -> fp32
//                                     (merged out-proj, :407-410: y)
//   epilogue 5 "masked_residual":     (+ bias) * mask + residual -> bf16
//                                     (split out-proj, _q_masked_attn_kernel :277-279)
// The residual is bf16 (the layer input) or fp32 (the mid residual y);
// the mask is (M,) bf16, read as fp32, as gemm_bias_epilogue.cu's
// epilogues 6 and 7. Site 16's MLP (_q_masked_mlp_kernel :293) keeps an
// unmasked residual: epilogue 3. And for the MoE experts' int8 linear
// (_quant_linear_xla, quant_blocks.py:89-102, which XLA runs in the JAX
// package: no Pallas kernel):
//   epilogue 6 "bias_f32":     + bias -> fp32                 (epilogue 2 without the residual)
//
// Numerics: s8 x s8 products summed in s32 by the tensor cores (exact),
// then, as _qmatmul: v = float(acc) * s_row * s_col, then + bias, then
// (masked) * mask, then + residual, every step rounded in fp32 with the __f*_rn intrinsics, so
// nvcc contracts none of them into an FMA (FMA contraction is off for the
// epilogue arithmetic): the dequantized value is the plain version's,
// bit for bit, and gelu differs only by tanhf's ulps. float(acc) rounds
// an |acc| above 2^24 to nearest, as the plain version's float64 -> fp32
// cast does. s_row is a per-row pointer (dynamic activation scales) or,
// when it is null, the one static scale s_static. s_col is fp32 (N,);
// bias is bf16 (N,).
//
// Layout. 8-bit wgmma takes no transposed operand: both A and W must be
// K-major in shared memory. So W is read as (N, K) row-major: the engine
// keeps each int8 kernel as an (in, out)-shaped view of an (out, in) copy
// made once at engine build, and both operands are loaded as they lie.
//
// Bound on H100: operations for qkv and fc2 at ViT-B bs256 (R = 50432:
// 2 * R * K * N int8 operations over 1,979 TOP/s), bytes for the
// out-proj and for fc1 (its 620 MB fp32 output). Design
// (gemm_bias_epilogue.cu's persistent kernel, for 8-bit operands):
//   - One CTA per SM (at most the card's SM count, never more than there
//     are tiles) walks the 128 x BN output tiles in row-major tile order,
//     CTA c taking tiles c, c + grid, ...: the CTAs in flight read the same
//     few 128-row panels of A, and W stays in L2.
//   - A producer warp keeps a ring of K slices of 128 bytes in flight by
//     TMA (2-D 8-bit tensor maps, 128-byte swizzle: a 128-byte slice row
//     is one swizzle row) onto `full` mbarriers: A's 128 x 128 tile and
//     W's (BN, 128) tile, both K-major as they lie. Rows past M, columns
//     past N and K past its end load as zero (TMA fills them; a zero code
//     adds nothing), so any K % 16 == 0 takes the same path. The producer
//     runs ahead into the next tile while the consumers finish this one's
//     epilogue.
//   - Two consumer warpgroups own 64 rows each of the 128 x BN tile and
//     issue wgmma m64nBNk32 s32.s8.s8 from shared memory, four a slice,
//     with s32 accumulators in registers (BN / 2 a thread); wait_group 1
//     keeps one slice's products in flight, and a slice is freed on its
//     `empty` mbarrier (one arrival per consumer warp) once the products
//     reading it have completed.
//   - BN = 192 where it pads N no more than 128 does and the tiles still
//     fill the card, else 128 (peekvit_gemm_s8_epilogue_plan; the ViT-B/16
//     bs256 products all take 192: 768, 2304 and 3072 are multiples). 5
//     stages of 40 KB (BN 192) or 6 of 32 KB (BN 128). 288 threads take
//     registers as 12 warps would: 168 a thread, of which a 128 x 192
//     tile's accumulators hold 96 (a 128 x 256 tile's 128 left the
//     epilogue too few: ptxas spilled).
//   - The epilogue runs on the accumulator fragment, whose layout per
//     8-column group is mma.sync's (row g / g + 8, columns 2 t, 2 t + 1),
//     with the arithmetic above unchanged. It loads the inputs of a few
//     column groups (column scale, bias, residual) before it stores their
//     outputs: an output may share its type with an input, and a load
//     behind a store of that type would wait for it.
// s32 sums are exact in any order, so every output has the earlier
// mma.sync kernel's bits.
//
// A: (M, K) int8 row-major. W: (N, K) int8 row-major. K % 16 == 0,
// N % 8 == 0, A and W 16-byte aligned, outputs and residual 8-byte
// aligned (the wrapper checks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BM = 128;             // output rows per tile
constexpr int BK = 128;             // K bytes per stage: one 128-byte swizzle row
constexpr int A_BYTES = BM * BK;    // A's 128 x 128 tile
constexpr int THREADS = 288;        // two consumer warpgroups + a producer warp

template <int BN>
struct Cfg {
  static constexpr int STAGES = BN == 192 ? 5 : 6;
  static constexpr int STAGE_BYTES = A_BYTES + BN * BK;
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8;
  static constexpr int EPI_CHUNK = BN == 192 ? 4 : 8;  // column groups loaded together
};

// jax.nn.gelu(approximate=True), in fp32.
__device__ __forceinline__ float gelu_tanh(float x) {
  const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
  const float k1 = 0.044715f;
  return 0.5f * x * (1.0f + tanhf(k0 * (x + k1 * x * x * x)));
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

template <int BN>
__device__ __forceinline__ void mma_slice(int* acc, uint32_t sa, uint32_t sw) {
#pragma unroll
  for (int kk = 0; kk < BK / 32; ++kk) {
    const uint64_t da = hopper::desc_sw128(sa + kk * 32, 16, 1024);
    const uint64_t dw = hopper::desc_sw128(sw + kk * 32, 16, 1024);
    if constexpr (BN == 192)
      hopper::wgmma_m64n192k32_s8(acc, da, dw);
    else
      hopper::wgmma_m64n128k32_s8(acc, da, dw);
  }
}

template <int N>
__device__ __forceinline__ void fence_acc(int* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

template <int EPI, int BN, typename RES, typename OUT>
__global__ void __launch_bounds__(THREADS, 1)
gemm_s8_kernel(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap wmap,
               const float* __restrict__ s_row, float s_static, const float* __restrict__ s_col,
               const __nv_bfloat16* __restrict__ bias, const RES* __restrict__ res,
               const __nv_bfloat16* __restrict__ mask, OUT* __restrict__ out, int m, int n,
               int k, int tiles_n, int n_tiles) {
  using C = Cfg<BN>;
  constexpr int STAGES = C::STAGES, NACC = BN / 2, EPI_CHUNK = C::EPI_CHUNK;
  constexpr bool kMask = EPI == 4 || EPI == 5;
  constexpr bool kRes = EPI >= 2 && EPI <= 5;
  constexpr bool kOutF32 = EPI == 1 || EPI == 2 || EPI == 4 || EPI == 6;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  const uint32_t full = ring + STAGES * C::STAGE_BYTES;
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
        hopper::tma_load_2d(dst + A_BYTES, &wmap, ks * BK, n0, fb);
      }
    }
    return;
  }

  // The consumers: warpgroup w owns rows [64 w, 64 w + 64) of every tile.
  const int w = warp >> 2, wq = warp & 3, g = lane >> 2, t4 = lane & 3;
  int it = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int m0 = (t / tiles_n) * BM, n0 = (t % tiles_n) * BN;
    int acc[NACC];
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] = 0;
    int prev = -1;
    for (int ks = 0; ks < ksteps; ++ks, ++it) {
      const int s = it % STAGES;
      hopper::mbar_wait(full + 8 * s, (it / STAGES) & 1);
      const uint32_t st = ring + s * C::STAGE_BYTES;
      fence_acc<NACC>(acc);
      hopper::wgmma_fence();
      mma_slice<BN>(acc, st + w * (A_BYTES / 2), st + A_BYTES);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();
      fence_acc<NACC>(acc);
      if (prev >= 0 && lane == 0) hopper::mbar_arrive(empty + 8 * prev);
      prev = s;
    }
    hopper::wgmma_wait<0>();
    fence_acc<NACC>(acc);
    if (prev >= 0 && lane == 0) hopper::mbar_arrive(empty + 8 * prev);

    // acc[4 j + 2 hh + e]: row lr + 8 hh of the tile, column 8 j + 2 t4 + e.
    const int lr = 64 * w + 16 * wq + g;
    float sr[2], mk[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = m0 + lr + 8 * hh;
      sr[hh] = s_row == nullptr ? s_static : (row < m ? s_row[row] : 0.f);
      mk[hh] = kMask && row < m ? __bfloat162float(mask[row]) : 0.f;
    }
#pragma unroll
    for (int j0 = 0; j0 < BN / 8; j0 += EPI_CHUNK) {
      float2 sc[EPI_CHUNK], b2[EPI_CHUNK], in[EPI_CHUNK][2];
#pragma unroll
      for (int jj = 0; jj < EPI_CHUNK; ++jj) {
        const int col = n0 + 8 * (j0 + jj) + 2 * t4;
        sc[jj] = b2[jj] = make_float2(0.f, 0.f);
        if (col < n) {
          sc[jj] = *reinterpret_cast<const float2*>(s_col + col);
          b2[jj] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + col));
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = m0 + lr + 8 * hh;
          in[jj][hh] = make_float2(0.f, 0.f);
          if (kRes && col < n && row < m)
            in[jj][hh] = load_res2<RES>(res + (long long)row * n + col);
        }
      }
#pragma unroll
      for (int jj = 0; jj < EPI_CHUNK; ++jj) {
        const int j = j0 + jj, col = n0 + 8 * j + 2 * t4;
        if (col >= n) continue;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = m0 + lr + 8 * hh;
          if (row >= m) continue;
          float v0 = __fadd_rn(__fmul_rn(__fmul_rn((float)acc[4 * j + 2 * hh], sr[hh]), sc[jj].x),
                               b2[jj].x);
          float v1 = __fadd_rn(
              __fmul_rn(__fmul_rn((float)acc[4 * j + 2 * hh + 1], sr[hh]), sc[jj].y), b2[jj].y);
          const long long off = (long long)row * n + col;
          if (EPI == 1) {
            v0 = gelu_tanh(v0);
            v1 = gelu_tanh(v1);
          }
          if (kMask) {
            v0 = __fmul_rn(v0, mk[hh]);
            v1 = __fmul_rn(v1, mk[hh]);
          }
          if (kRes) {
            v0 = __fadd_rn(v0, in[jj][hh].x);
            v1 = __fadd_rn(v1, in[jj][hh].y);
          }
          if (kOutF32) {
            *reinterpret_cast<float2*>(reinterpret_cast<float*>(out) + off) = make_float2(v0, v1);
          } else {
            *reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<__nv_bfloat16*>(out) + off) =
                __floats2bfloat162_rn(v0, v1);
          }
        }
      }
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

// The C tile width for an (m, n) output, 192 where it pads N no more than
// 128 does and the tiles still fill the card, else 128; and the persistent
// grid.
void plan(int m, int n, int* bn, int* grid) {
  const long long tiles_m = (m + BM - 1) / BM;
  const int t128 = (n + 127) / 128, t192 = (n + 191) / 192;
  const bool wide = t192 * 192 <= t128 * 128 && tiles_m * t192 >= sm_count();
  *bn = wide ? 192 : 128;
  const long long tiles = tiles_m * (wide ? t192 : t128);
  *grid = (int)(tiles < sm_count() ? tiles : sm_count());
}

struct Args {
  const void *a, *w, *s_row, *s_col, *bias, *res, *mask;
  float s_static;
  void* out;
  int m, n, k;
};

template <int EPI, int BN, typename RES, typename OUT>
int launch_bn(const Args& p, int grid, cudaStream_t stream) {
  auto kern = gemm_s8_kernel<EPI, BN, RES, OUT>;
  static bool sized = false;  // the attribute is set once per instance
  if (!sized) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<BN>::SMEM);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  CUtensorMap am, wm;
  const uint64_t adims[2] = {(uint64_t)p.k, (uint64_t)p.m}, astr[1] = {(uint64_t)p.k};
  const uint64_t wdims[2] = {(uint64_t)p.k, (uint64_t)p.n}, wstr[1] = {(uint64_t)p.k};
  const uint32_t abox[2] = {BK, BM}, wbox[2] = {BK, (uint32_t)BN};
  if (!hopper::make_map_s8(&am, p.a, 2, adims, astr, abox) ||
      !hopper::make_map_s8(&wm, p.w, 2, wdims, wstr, wbox))
    return (int)cudaErrorInvalidValue;
  const int tiles_n = (p.n + BN - 1) / BN;
  const int n_tiles = ((p.m + BM - 1) / BM) * tiles_n;
  kern<<<grid, THREADS, Cfg<BN>::SMEM, stream>>>(
      am, wm, static_cast<const float*>(p.s_row), p.s_static, static_cast<const float*>(p.s_col),
      static_cast<const __nv_bfloat16*>(p.bias), static_cast<const RES*>(p.res),
      static_cast<const __nv_bfloat16*>(p.mask), static_cast<OUT*>(p.out), p.m, p.n, p.k,
      tiles_n, n_tiles);
  return (int)cudaGetLastError();
}

template <int EPI, typename RES, typename OUT>
int launch(const Args& p, cudaStream_t stream) {
  int bn, grid;
  plan(p.m, p.n, &bn, &grid);
  return bn == 192 ? launch_bn<EPI, 192, RES, OUT>(p, grid, stream)
                   : launch_bn<EPI, 128, RES, OUT>(p, grid, stream);
}

// An epilogue that reads the residual, in either residual type.
template <int EPI, typename OUT>
int launch_res(int res_f32, const Args& p, cudaStream_t s) {
  return res_f32 ? launch<EPI, float, OUT>(p, s) : launch<EPI, __nv_bfloat16, OUT>(p, s);
}

}  // namespace

// epilogue: 0 bias -> bf16, 1 bias + tanh-gelu -> fp32, 2 bias + residual
// -> fp32, 3 bias + residual -> bf16, 4 (bias) * mask + residual -> fp32,
// 5 (bias) * mask + residual -> bf16, 6 bias -> fp32. a: (m, k) int8; w:
// (n, k) int8 (the (out, in) layout); s_row: (m,) fp32, or null to use
// s_static for every row; s_col: (n,) fp32; bias: (n,) bf16; res: (m, n),
// fp32 (res_f32 = 1) or bf16 (0), read by epilogues 2-5 only; mask: (m,)
// bf16, read by 4 and 5 only; out: (m, n) in the epilogue's type. Returns
// the cudaError_t of the launch (an unknown epilogue, 2-5 without a
// residual or 4-5 without a mask returns cudaErrorInvalidValue).
extern "C" int peekvit_gemm_s8_epilogue(const void* a, const void* w, const void* s_row,
                                        float s_static, const void* s_col, const void* bias,
                                        const void* res, const void* mask, void* out, int m,
                                        int n, int k, int epilogue, int res_f32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m == 0) return 0;
  if (k % 16 != 0 || n % 8 != 0) return (int)cudaErrorInvalidValue;
  if (epilogue >= 2 && epilogue <= 5 && res == nullptr) return (int)cudaErrorInvalidValue;
  if ((epilogue == 4 || epilogue == 5) && mask == nullptr) return (int)cudaErrorInvalidValue;
  const Args p{a, w, s_row, s_col, bias, res, mask, s_static, out, m, n, k};
  switch (epilogue) {
    case 0:
      return launch<0, float, __nv_bfloat16>(p, s);
    case 1:
      return launch<1, float, float>(p, s);
    case 2:
      return launch_res<2, float>(res_f32, p, s);
    case 3:
      return launch_res<3, __nv_bfloat16>(res_f32, p, s);
    case 4:
      return launch_res<4, float>(res_f32, p, s);
    case 5:
      return launch_res<5, __nv_bfloat16>(res_f32, p, s);
    case 6:
      return launch<6, float, float>(p, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The schedule peekvit_gemm_s8_epilogue takes for an (m, n) output: writes
// the C tile width (128 or 192) to out[0] and the number of persistent
// CTAs to out[1]. Returns 0.
extern "C" int peekvit_gemm_s8_epilogue_plan(int m, int n, int* out) {
  plan(m, n, &out[0], &out[1]);
  return 0;
}
