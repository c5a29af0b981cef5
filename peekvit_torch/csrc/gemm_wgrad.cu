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
// reduction over rows is split: block (n tile, k tile, split s) sums rows
// [s * rows_per_split, (s + 1) * rows_per_split) into an fp32 partial,
// and a second kernel adds the splits' partials element by element in
// split order. No atomics: two runs give the same bits. With one split
// the first kernel writes C directly.
//
// Bound on H100: operations. At ViT-B bs256 (R = 50432 rows) the four
// products are 1.79e11 (dWqkv), 5.95e10 (dWo) and 2.38e11 (dW1, dW2)
// flops against 77-310 MB of operands: 0.722 ms of bf16 tensor-core time
// per layer. Design (a simple first version, as gemm_bias_epilogue.cu):
// a 128 x 128 tile of C per 256-thread block, 8 warps each owning 64 x 32,
// bf16 mma.sync.m16n8k16 with fp32 accumulators, a 3-stage cp.async ring
// of 32-row slices of A and B. Both operands lie row-major with the
// reduction along their rows, so both are staged as 32 rows x 128 columns
// and read with ldmatrix.trans: for B as the col-major operand (as W in
// gemm_bias_epilogue.cu), for A to form A^T's row-major fragments. The
// column sums of B come from the k-tile-0 blocks, which add up each
// staged B slice from shared memory (two threads per column, halves met
// in shared memory in a fixed order). wgmma and TMA are later work.
//
// A: (R, K), B: (R, N), bf16 row-major, K % 8 == 0, N % 8 == 0, pointers
// 16-byte aligned (the wrapper checks). Ragged rows are zero-filled on
// load; ragged columns of C are masked on store.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 32, STAGES = 3, THREADS = 256;
constexpr int STRIDE = 128 + 8;  // bf16 elements per smem row (no bank conflicts)
constexpr int TILE = BK * STRIDE;
constexpr int SMEM_BYTES = STAGES * 2 * TILE * 2;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

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

// Rows [r0, r0 + 32) of A's columns [k0, k0 + 128) and of B's columns
// [n0, n0 + 128) into one ring stage; rows at or past r_end read as zero.
__device__ __forceinline__ void load_stage(__nv_bfloat16* sa, __nv_bfloat16* sb,
                                           const __nv_bfloat16* __restrict__ a,
                                           const __nv_bfloat16* __restrict__ b, int kdim,
                                           int ndim, long long r0, long long r_end, int k0,
                                           int n0) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int chunk = threadIdx.x + i * THREADS;  // 32 rows x 16 chunks of 8 bf16
    const int row = chunk >> 4, c = (chunk & 15) * 8;
    const long long gr = r0 + row;
    const bool ok = gr < r_end;
    const long long src_row = ok ? gr : 0;
    const int gk = k0 + c, gn = n0 + c;
    cp_async16(sa + row * STRIDE + c, a + src_row * kdim + (gk < kdim ? gk : 0),
               ok && gk < kdim ? 16 : 0);
    cp_async16(sb + row * STRIDE + c, b + src_row * ndim + (gn < ndim ? gn : 0),
               ok && gn < ndim ? 16 : 0);
  }
}

__global__ void __launch_bounds__(THREADS)
wgrad_kernel(const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ b,
             float* __restrict__ part, float* __restrict__ colpart, long long rows, int kdim,
             int ndim, long long rows_per_split) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sa = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sb = sa + STAGES * TILE;

  const int n0 = blockIdx.x * BN, k0 = blockIdx.y * BM, split = blockIdx.z;
  const long long r_begin = (long long)split * rows_per_split;
  const long long r_end = r_begin + rows_per_split < rows ? r_begin + rows_per_split : rows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp >> 2) * 64;  // warp's offset along C's rows (A's columns)
  const int wn = (warp & 3) * 32;   // warp's offset along C's columns (B's columns)
  const bool colsum = colpart != nullptr && blockIdx.y == 0;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  float cs = 0.f;  // column threadIdx.x & 127 of B, rows of half threadIdx.x >> 7

  const int ktiles = (int)((r_end - r_begin + BK - 1) / BK);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles)
      load_stage(sa + s * TILE, sb + s * TILE, a, b, kdim, ndim, r_begin + s * BK, r_end, k0, n0);
    cp_async_commit();
  }

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int next = kt + STAGES - 1;
    if (next < ktiles) {
      const int st = next % STAGES;
      load_stage(sa + st * TILE, sb + st * TILE, a, b, kdim, ndim, r_begin + (long long)next * BK,
                 r_end, k0, n0);
    }
    cp_async_commit();

    const __nv_bfloat16* ta = sa + (kt % STAGES) * TILE;
    const __nv_bfloat16* tb = sb + (kt % STAGES) * TILE;
    if (colsum) {
      const __nv_bfloat16* col = tb + (threadIdx.x >> 7) * 16 * STRIDE + (threadIdx.x & 127);
#pragma unroll
      for (int r = 0; r < 16; ++r) cs += __bfloat162float(col[r * STRIDE]);
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // A^T's 16 x 16 fragment: matrices (m 0-7 | 8-15) x (k 0-7 | 8-15)
        const int r = kk + (lane & 7) + (lane >> 4) * 8;
        const int c = wm + i * 16 + ((lane >> 3) & 1) * 8;
        ldmatrix_x4_trans(af[i], ta + r * STRIDE + c);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t t4[4];
        const int r = kk + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int c = wn + j * 16 + (lane >> 4) * 8;
        ldmatrix_x4_trans(t4, tb + r * STRIDE + c);
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

  float* out = part + (long long)split * kdim * ndim;
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + wn + j * 8 + tq * 2;
    if (col >= ndim) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = k0 + wm + i * 16 + g + h * 8;
        if (row >= kdim) continue;
        *reinterpret_cast<float2*>(out + (long long)row * ndim + col) =
            make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
  }
  if (colsum) {
    __shared__ float cred[2][BN];
    cred[threadIdx.x >> 7][threadIdx.x & 127] = cs;
    __syncthreads();
    const int c = threadIdx.x;
    if (c < BN && n0 + c < ndim) colpart[(long long)split * ndim + n0 + c] = cred[0][c] + cred[1][c];
  }
}

// out[i] = sum over s of part[s * stride + i], s in order (C, then the
// column sums when they are asked for).
__global__ void reduce_kernel(const float* __restrict__ part, float* __restrict__ out,
                              long long count, long long stride, int splits) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < count;
       i += (long long)gridDim.x * blockDim.x) {
    float v = part[i];
    for (int s = 1; s < splits; ++s) v += part[(long long)s * stride + i];
    out[i] = v;
  }
}

int reduce(const float* part, float* out, long long count, long long stride, int splits,
           cudaStream_t stream) {
  const int threads = 256;
  const long long want = (count + threads - 1) / threads;
  const unsigned grid = (unsigned)(want < 132 * 16 ? want : 132 * 16);
  reduce_kernel<<<grid, threads, 0, stream>>>(part, out, count, stride, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// a: (rows, k) bf16; b: (rows, n) bf16; c: (k, n) fp32. colsum: (n,)
// fp32, the column sums of b, or null. The rows are cut into `splits`
// runs of rows_per_split (a multiple of 32; the last may be shorter).
// With splits > 1, work holds splits * (k * n + n) fp32 values of
// partials (C's, then the column sums'); with one split it is not read.
// k and n multiples of 8, pointers 16-byte aligned (the wrapper checks).
// Returns the cudaError_t of the first failing launch.
extern "C" int peekvit_gemm_wgrad(const void* a, const void* b, void* c, void* colsum,
                                  void* work, long long rows, int k, int n,
                                  long long rows_per_split, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k == 0 || n == 0) return 0;
  if (splits < 1 || rows_per_split % BK != 0 || (long long)splits * rows_per_split < rows ||
      (splits > 1 && work == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long kn = (long long)k * n;
  float* part = splits > 1 ? static_cast<float*>(work) : static_cast<float*>(c);
  float* colpart = colsum == nullptr ? nullptr
                   : splits > 1      ? static_cast<float*>(work) + (long long)splits * kn
                                     : static_cast<float*>(colsum);
  if (rows == 0) {  // empty sums
    cudaError_t err = cudaMemsetAsync(c, 0, kn * sizeof(float), s);
    if (err == cudaSuccess && colsum != nullptr)
      err = cudaMemsetAsync(colsum, 0, n * sizeof(float), s);
    return (int)err;
  }
  cudaError_t err =
      cudaFuncSetAttribute(wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + BN - 1) / BN, (k + BM - 1) / BM, splits);
  wgrad_kernel<<<grid, THREADS, SMEM_BYTES, s>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b), part, colpart,
      rows, k, n, rows_per_split);
  int e = (int)cudaGetLastError();
  if (e != 0 || splits == 1) return e;
  e = reduce(part, static_cast<float*>(c), kn, kn, splits, s);
  if (e != 0 || colsum == nullptr) return e;
  return reduce(colpart, static_cast<float*>(colsum), n, n, splits, s);
}
