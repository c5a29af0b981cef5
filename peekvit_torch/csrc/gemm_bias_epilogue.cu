// C = A . W with a fused epilogue: the four matrix products of the
// Pallas encoder layer.
//
// Replaces the in-kernel products of peekvit_tpu/ops/pallas/
// fused_attention.py:616 _layer_kernel (and of _attn_block_kernel :238):
//   epilogue 0: + bias -> bf16                       (qkv, :680-681)
//   epilogue 1: + bias, tanh-gelu -> bf16            (fc1, :711-713)
//   epilogue 2: + bias + residual -> fp32            (out-proj, :698-702)
//   epilogue 3: + bias + residual -> bf16            (fc2, :714-716)
// The residual is fp32 (the layer's mid residual y) or bf16 (the layer
// input, split path). Every sum is taken in fp32 and rounded once.
//
// With W read as (N, K) row-major (C = A . W^T, the "NT" layout, chosen
// at compile time) and no bias, it also carries the two transposed-weight
// products inside the backward kernels of peekvit_tpu/ops/pallas/
// fused_attention_vjp.py (_attn_bwd_kernel :93, _attn_bwd_kernel_saved
// :172):
//   epilogue 4: -> bf16   (dattn = g . Wo^T, :111-115 and :196-200)
//   epilogue 5: -> fp32   (dln = dqkv . Wqkv^T, :159-161 and :238-240)
//
// Bound on H100: operations. At ViT-B bs256 the products are
// (50432 x 768) . (768 x {2304, 768, 3072}) and (50432 x 3072) . (3072 x 768):
// hundreds of flops per byte, above the card's ~295 flop/byte ridge.
// Design (a simple first version, not the card's peak): 128 x 128 output
// tile per 256-thread block, 8 warps each owning 64 x 32, bf16
// mma.sync.m16n8k16 with fp32 accumulators, operands staged in shared
// memory by a 3-stage cp.async ring of 32-deep K slices and read with
// ldmatrix (padded rows: no bank conflicts). Ragged rows and columns are
// zero-filled on load and masked on store. wgmma and TMA are later work.
//
// A: (M, K) bf16 row-major. W: (K, N) bf16 row-major (the JAX (in, out)
// layout), or (N, K) row-major for epilogues 4 and 5. K % 32 == 0,
// N % 8 == 0, pointers 16-byte aligned (the wrapper checks). In the NT
// layout W's tile is staged like A's (BN rows of 32 k values) and read
// with ldmatrix without transpose.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 32, STAGES = 3, THREADS = 256;
constexpr int A_STRIDE = BK + 8;   // bf16 elements per smem row of A
constexpr int B_STRIDE = BN + 8;   // bf16 elements per smem row of W
constexpr int A_TILE = BM * A_STRIDE;
constexpr int B_TILE = BK * B_STRIDE;
constexpr int B_TILE_NT = BN * A_STRIDE;  // W as (N, K): staged like A
template <bool NT>
constexpr int smem_bytes() { return STAGES * (A_TILE + (NT ? B_TILE_NT : B_TILE)) * 2; }

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
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
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

// Loads the k-th 32-deep slice of A (BM rows) and W (BN columns) into one
// ring stage. Each thread moves two 16-byte chunks of each operand.
template <bool NT>
__device__ __forceinline__ void load_stage(__nv_bfloat16* sa, __nv_bfloat16* sb,
                                           const __nv_bfloat16* __restrict__ a,
                                           const __nv_bfloat16* __restrict__ w, int m,
                                           int n, int k, int row0, int col0, int k0) {
  const int t = threadIdx.x;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int chunk = t + i * THREADS;  // 0..511
    // A: 128 rows x 4 chunks of 8 bf16
    const int ar = chunk >> 2, ac = (chunk & 3) * 8;
    const int grow = row0 + ar;
    const __nv_bfloat16* src = a + (long long)(grow < m ? grow : 0) * k + k0 + ac;
    cp_async16(sa + ar * A_STRIDE + ac, src, grow < m ? 16 : 0);
    if (NT) {
      // W as (N, K): 128 rows (n) x 4 chunks of 8 bf16 (k), like A
      const int gn = col0 + ar;
      const __nv_bfloat16* wsrc = w + (long long)(gn < n ? gn : 0) * k + k0 + ac;
      cp_async16(sb + ar * A_STRIDE + ac, wsrc, gn < n ? 16 : 0);
    } else {
      // W: 32 rows (k) x 16 chunks of 8 bf16 (n)
      const int br = chunk >> 4, bc = (chunk & 15) * 8;
      const int gcol = col0 + bc;
      const __nv_bfloat16* wsrc = w + (long long)(k0 + br) * n + (gcol < n ? gcol : 0);
      cp_async16(sb + br * B_STRIDE + bc, wsrc, gcol < n ? 16 : 0);
    }
  }
}

template <int EPI, bool NT, typename RES, typename OUT>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ w,
            const __nv_bfloat16* __restrict__ bias, const RES* __restrict__ res,
            OUT* __restrict__ out, int m, int n, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sa = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sb = sa + STAGES * A_TILE;
  constexpr int BT = NT ? B_TILE_NT : B_TILE;

  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp >> 2) * 64;  // warp's row offset in the tile
  const int wn = (warp & 3) * 32;   // warp's column offset in the tile

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int ktiles = k / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load_stage<NT>(sa + s * A_TILE, sb + s * BT, a, w, m, n, k, row0, col0, s * BK);
    cp_async_commit();
  }

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int next = kt + STAGES - 1;
    if (next < ktiles) {
      const int st = next % STAGES;
      load_stage<NT>(sa + st * A_TILE, sb + st * BT, a, w, m, n, k, row0, col0, next * BK);
    }
    cp_async_commit();

    const __nv_bfloat16* ta = sa + (kt % STAGES) * A_TILE;
    const __nv_bfloat16* tb = sb + (kt % STAGES) * BT;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = wm + i * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int c = kk + (lane >> 4) * 8;
        ldmatrix_x4(af[i], ta + r * A_STRIDE + c);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t t4[4];
        if (NT) {
          const int r = wn + j * 16 + (lane & 7) + (lane >> 4) * 8;
          const int c = kk + ((lane >> 3) & 1) * 8;
          ldmatrix_x4(t4, tb + r * A_STRIDE + c);
        } else {
          const int r = kk + (lane & 7) + ((lane >> 3) & 1) * 8;
          const int c = wn + j * 16 + (lane >> 4) * 8;
          ldmatrix_x4_trans(t4, tb + r * B_STRIDE + c);
        }
        bf[2 * j][0] = t4[0];
        bf[2 * j][1] = t4[1];
        bf[2 * j + 1][0] = t4[2];
        bf[2 * j + 1][1] = t4[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], af[i], bf[j]);
    }
  }
  cp_async_wait<0>();

  // Epilogue straight from the accumulator fragments: thread holds
  // (row g, cols 2t, 2t+1) and (row g + 8, same cols) of each 16 x 8 tile.
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = col0 + wn + j * 8 + tq * 2;
    if (col >= n) continue;
    const float2 b2 = EPI >= 4 ? make_float2(0.f, 0.f)
                               : __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + col));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + wm + i * 16 + g + h * 8;
        if (row >= m) continue;
        float v0 = acc[i][j][2 * h] + b2.x;
        float v1 = acc[i][j][2 * h + 1] + b2.y;
        const long long off = (long long)row * n + col;
        if (EPI == 1) {
          v0 = gelu_tanh(v0);
          v1 = gelu_tanh(v1);
        }
        if (EPI == 2 || EPI == 3) {
          const float2 r2 = load_res2<RES>(res + off);
          v0 += r2.x;
          v1 += r2.y;
        }
        if (EPI == 2 || EPI == 5) {
          *reinterpret_cast<float2*>(reinterpret_cast<float*>(out) + off) = make_float2(v0, v1);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<__nv_bfloat16*>(out) + off) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }
}

template <int EPI, bool NT, typename RES, typename OUT>
int launch(const void* a, const void* w, const void* bias, const void* res, void* out,
           int m, int n, int k, cudaStream_t stream) {
  auto kern = gemm_kernel<EPI, NT, RES, OUT>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<NT>());
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  kern<<<grid, THREADS, smem_bytes<NT>(), stream>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(bias), static_cast<const RES*>(res),
      static_cast<OUT*>(out), m, n, k);
  return (int)cudaGetLastError();
}

}  // namespace

// epilogue: 0 bias, 1 bias + tanh-gelu, 2 bias + residual -> fp32,
// 3 bias + residual -> bf16, 4 A . W^T -> bf16, 5 A . W^T -> fp32 (W as
// (N, K); bias and res are ignored for 4 and 5). res_f32 selects an fp32
// (1) or bf16 (0) residual for epilogues 2 and 3; res is ignored
// otherwise. Returns the cudaError_t of the launch (an unknown epilogue
// returns cudaErrorInvalidValue).
extern "C" int peekvit_gemm_bias_epilogue(const void* a, const void* w, const void* bias,
                                          const void* res, void* out, int m, int n, int k,
                                          int epilogue, int res_f32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m == 0) return 0;
  switch (epilogue) {
    case 0:
      return launch<0, false, float, __nv_bfloat16>(a, w, bias, res, out, m, n, k, s);
    case 1:
      return launch<1, false, float, __nv_bfloat16>(a, w, bias, res, out, m, n, k, s);
    case 2:
      return res_f32 ? launch<2, false, float, float>(a, w, bias, res, out, m, n, k, s)
                     : launch<2, false, __nv_bfloat16, float>(a, w, bias, res, out, m, n, k, s);
    case 3:
      return res_f32 ? launch<3, false, float, __nv_bfloat16>(a, w, bias, res, out, m, n, k, s)
                     : launch<3, false, __nv_bfloat16, __nv_bfloat16>(a, w, bias, res, out, m, n, k, s);
    case 4:
      return launch<4, true, float, __nv_bfloat16>(a, w, bias, res, out, m, n, k, s);
    case 5:
      return launch<5, true, float, float>(a, w, bias, res, out, m, n, k, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
