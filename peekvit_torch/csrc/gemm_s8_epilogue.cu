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
// unmasked residual: epilogue 3.
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
// Layout. The B operand of the 8-bit mma.sync (and of wgmma) must be
// K-contiguous per output column, and ldmatrix's .trans does not
// transpose 8-bit elements. So W is read as (N, K) row-major: the engine
// keeps each int8 kernel as an (in, out)-shaped view of an (out, in)
// copy made once at engine build, and both operands are staged and read
// alike (ldmatrix without transpose gives the m16n8k32 fragments of A's
// rows and of W's columns directly).
//
// Bound on H100: operations for qkv and fc2 at ViT-B bs256 (R = 50432:
// 2 * R * K * N int8 operations over 1,979 TOP/s), bytes for the
// out-proj and for fc1 (its 620 MB fp32 output). Design (a simple first
// version, as gemm_bias_epilogue.cu): 128 x 128 output tile per
// 256-thread block, 8 warps each owning 64 x 32, mma.sync.m16n8k32 s8
// with s32 accumulators, operands staged in shared memory by a 3-stage
// cp.async ring of 64-byte K slices (rows padded to 80 bytes: no bank
// conflicts on ldmatrix). Ragged rows, columns and K chunks are
// zero-filled on load (a zero code adds nothing) and masked on store.
// wgmma, TMA and an epilogue that quantizes its own output are later
// work.
//
// A: (M, K) int8 row-major. W: (N, K) int8 row-major. K % 16 == 0,
// N % 8 == 0, A and W 16-byte aligned, outputs and residual 8-byte
// aligned (the wrapper checks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 64, STAGES = 3, THREADS = 256;
constexpr int STRIDE = BK + 16;  // bytes per shared-memory row of A and W
constexpr int TILE = BM * STRIDE;
constexpr int SMEM_BYTES = STAGES * 2 * TILE;  // 61,440

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes = 0 zero-fills the destination.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

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

// Loads the 64-deep K slice at k0 of A (BM rows) and W (BN rows) into one
// ring stage. Each thread moves two 16-byte chunks of each operand.
__device__ __forceinline__ void load_stage(int8_t* sa, int8_t* sb, const int8_t* __restrict__ a,
                                           const int8_t* __restrict__ w, int m, int n, int k,
                                           int row0, int col0, int k0) {
  const int t = threadIdx.x;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int chunk = t + i * THREADS;  // 0..511: 128 rows x 4 chunks of 16 bytes
    const int r = chunk >> 2, c = (chunk & 3) * 16;
    const bool kin = k0 + c < k;
    const int grow = row0 + r, gn = col0 + r;
    const int8_t* asrc = a + (long long)(grow < m ? grow : 0) * k + (kin ? k0 + c : 0);
    cp_async16(sa + r * STRIDE + c, asrc, grow < m && kin ? 16 : 0);
    const int8_t* wsrc = w + (long long)(gn < n ? gn : 0) * k + (kin ? k0 + c : 0);
    cp_async16(sb + r * STRIDE + c, wsrc, gn < n && kin ? 16 : 0);
  }
}

template <int EPI, typename RES, typename OUT>
__global__ void __launch_bounds__(THREADS)
gemm_s8_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ w,
               const float* __restrict__ s_row, float s_static, const float* __restrict__ s_col,
               const __nv_bfloat16* __restrict__ bias, const RES* __restrict__ res,
               const __nv_bfloat16* __restrict__ mask, OUT* __restrict__ out, int m, int n,
               int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int8_t* sa = reinterpret_cast<int8_t*>(smem_raw);
  int8_t* sb = sa + STAGES * TILE;

  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp >> 2) * 64;  // warp's row offset in the tile
  const int wn = (warp & 3) * 32;   // warp's column offset in the tile

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int ktiles = (k + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load_stage(sa + s * TILE, sb + s * TILE, a, w, m, n, k, row0, col0, s * BK);
    cp_async_commit();
  }

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int next = kt + STAGES - 1;
    if (next < ktiles) {
      const int st = next % STAGES;
      load_stage(sa + st * TILE, sb + st * TILE, a, w, m, n, k, row0, col0, next * BK);
    }
    cp_async_commit();

    const int8_t* ta = sa + (kt % STAGES) * TILE;
    const int8_t* tb = sb + (kt % STAGES) * TILE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // matrices: rows 0-7 / 8-15 at bytes 0-15, then the same at 16-31
        const int r = wm + i * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int c = kk + (lane >> 4) * 16;
        ldmatrix_x4(af[i], ta + r * STRIDE + c);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        // matrices: columns 0-7 at bytes 0-15 and 16-31, then columns 8-15
        uint32_t t4[4];
        const int r = wn + j * 16 + (lane & 7) + (lane >> 4) * 8;
        const int c = kk + ((lane >> 3) & 1) * 16;
        ldmatrix_x4(t4, tb + r * STRIDE + c);
        bf[2 * j][0] = t4[0];
        bf[2 * j][1] = t4[1];
        bf[2 * j + 1][0] = t4[2];
        bf[2 * j + 1][1] = t4[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
  }
  cp_async_wait<0>();

  // Epilogue straight from the accumulator fragments: thread holds
  // (row g, cols 2t, 2t+1) and (row g + 8, same cols) of each 16 x 8 tile.
  const int g = lane >> 2, tq = lane & 3;
  constexpr bool kMask = EPI == 4 || EPI == 5;
  float sr[4][2], mk[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + wm + i * 16 + g + h * 8;
      sr[i][h] = s_row == nullptr ? s_static : (row < m ? s_row[row] : 0.f);
      mk[i][h] = kMask && row < m ? __bfloat162float(mask[row]) : 0.f;
    }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = col0 + wn + j * 8 + tq * 2;
    if (col >= n) continue;
    const float2 sc = *reinterpret_cast<const float2*>(s_col + col);
    const float2 b2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + col));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + wm + i * 16 + g + h * 8;
        if (row >= m) continue;
        float v0 = __fadd_rn(__fmul_rn(__fmul_rn((float)acc[i][j][2 * h], sr[i][h]), sc.x), b2.x);
        float v1 =
            __fadd_rn(__fmul_rn(__fmul_rn((float)acc[i][j][2 * h + 1], sr[i][h]), sc.y), b2.y);
        const long long off = (long long)row * n + col;
        if (EPI == 1) {
          v0 = gelu_tanh(v0);
          v1 = gelu_tanh(v1);
        }
        if (kMask) {
          v0 = __fmul_rn(v0, mk[i][h]);
          v1 = __fmul_rn(v1, mk[i][h]);
        }
        if (EPI >= 2) {
          const float2 r2 = load_res2<RES>(res + off);
          v0 = __fadd_rn(v0, r2.x);
          v1 = __fadd_rn(v1, r2.y);
        }
        if (EPI == 1 || EPI == 2 || EPI == 4) {
          *reinterpret_cast<float2*>(reinterpret_cast<float*>(out) + off) = make_float2(v0, v1);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<__nv_bfloat16*>(out) + off) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }
}

template <int EPI, typename RES, typename OUT>
int launch(const void* a, const void* w, const void* s_row, float s_static, const void* s_col,
           const void* bias, const void* res, const void* mask, void* out, int m, int n, int k,
           cudaStream_t stream) {
  auto kern = gemm_s8_kernel<EPI, RES, OUT>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  kern<<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(w),
      static_cast<const float*>(s_row), s_static, static_cast<const float*>(s_col),
      static_cast<const __nv_bfloat16*>(bias), static_cast<const RES*>(res),
      static_cast<const __nv_bfloat16*>(mask), static_cast<OUT*>(out), m, n, k);
  return (int)cudaGetLastError();
}

// An epilogue that reads the residual, in either residual type.
template <int EPI, typename OUT>
int launch_res(int res_f32, const void* a, const void* w, const void* s_row, float s_static,
               const void* s_col, const void* bias, const void* res, const void* mask, void* out,
               int m, int n, int k, cudaStream_t s) {
  return res_f32 ? launch<EPI, float, OUT>(a, w, s_row, s_static, s_col, bias, res, mask, out, m,
                                           n, k, s)
                 : launch<EPI, __nv_bfloat16, OUT>(a, w, s_row, s_static, s_col, bias, res, mask,
                                                   out, m, n, k, s);
}

}  // namespace

// epilogue: 0 bias -> bf16, 1 bias + tanh-gelu -> fp32, 2 bias + residual
// -> fp32, 3 bias + residual -> bf16, 4 (bias) * mask + residual -> fp32,
// 5 (bias) * mask + residual -> bf16. a: (m, k) int8; w: (n, k) int8 (the
// (out, in) layout); s_row: (m,) fp32, or null to use s_static for every
// row; s_col: (n,) fp32; bias: (n,) bf16; res: (m, n), fp32 (res_f32 = 1)
// or bf16 (0), read by epilogues 2-5 only; mask: (m,) bf16, read by 4 and
// 5 only; out: (m, n) in the epilogue's type. Returns the cudaError_t of
// the launch (an unknown epilogue, 2-5 without a residual or 4-5 without
// a mask returns cudaErrorInvalidValue).
extern "C" int peekvit_gemm_s8_epilogue(const void* a, const void* w, const void* s_row,
                                        float s_static, const void* s_col, const void* bias,
                                        const void* res, const void* mask, void* out, int m,
                                        int n, int k, int epilogue, int res_f32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m == 0) return 0;
  if (k % 16 != 0 || n % 8 != 0) return (int)cudaErrorInvalidValue;
  if (epilogue >= 2 && res == nullptr) return (int)cudaErrorInvalidValue;
  if (epilogue >= 4 && mask == nullptr) return (int)cudaErrorInvalidValue;
  switch (epilogue) {
    case 0:
      return launch<0, float, __nv_bfloat16>(a, w, s_row, s_static, s_col, bias, res, mask, out,
                                             m, n, k, s);
    case 1:
      return launch<1, float, float>(a, w, s_row, s_static, s_col, bias, res, mask, out, m, n, k,
                                     s);
    case 2:
      return launch_res<2, float>(res_f32, a, w, s_row, s_static, s_col, bias, res, mask, out, m,
                                  n, k, s);
    case 3:
      return launch_res<3, __nv_bfloat16>(res_f32, a, w, s_row, s_static, s_col, bias, res, mask,
                                          out, m, n, k, s);
    case 4:
      return launch_res<4, float>(res_f32, a, w, s_row, s_static, s_col, bias, res, mask, out, m,
                                  n, k, s);
    case 5:
      return launch_res<5, __nv_bfloat16>(res_f32, a, w, s_row, s_static, s_col, bias, res, mask,
                                          out, m, n, k, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
