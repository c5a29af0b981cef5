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
// The bisection without its counts. Let v_k be the k-th smallest of the
// row's values counted with multiplicity (NaN never counts, as it is
// never <= mid). For any mid, count_j(d2_ij <= mid) >= k exactly when
// v_k <= mid, negative d2 (rounding, a point against itself) included.
// So all 30 decisions depend on v_k alone: the kernel finds v_k once by
// an exact selection and replays the 30 steps as warp-uniform scalar
// code with the same midpoints, and its final hi is the counting
// bisection's bit for bit. The selection is a radix select over an
// order-preserving key of 48 bits: first a 16-bit linear key,
// round(sat(d2 / rowmax) * 65535) (monotone in d2, and spread evenly
// over the row's range, so a pass's bins do not pile up as the top
// digits of a float's bits would), then the fp32 value's own
// order-preserving bits (the sign flipped). Each pass histograms one
// 8-bit digit of the members that share the digits chosen so far (256
// shared-memory bins per warp), finds the digit holding the rank by a
// warp scan, and stops once that digit holds at most 32 values: those
// are compacted by ballot and prefix popcount, and v_k is the one whose
// count of smaller and not-larger peers brackets the rank. On a cloud of
// 1024 points drawn at random one pass suffices for every row
// (tests/test_torch_arpe_norm_select.py follows each row); more than 32
// equal distances (duplicated points) take further passes; a row whose
// range cannot scale the linear key (max d2 <= 0 or infinite, e.g. one
// point) goes straight to the float bits. After the last pass the members
// share every bit, so they are one value. The replay forms both of a
// step's possible next midpoints beside its test, so the dependent chain
// a step is one compare and one select.
//
// The masked max over a neighbour list. Each slot's test d2 <= thr is a
// ballot, stored as one word: word t holds the neighbour bits of points
// 32 t .. 32 t + 31, and lane t walks the set bits of its word (about 64
// neighbours spread over 32 words), loading the packed g of each. The
// list has no capacity to overflow: a row whose neighbours crowd one word
// walks at most the 32 slots of the old sweep. The count of the words'
// bits is the neighbour count that knn_stats reports.
//
// Bound on H100: operations, in fp32 outside the tensor cores. Per pair
// (i, j) the kernel does 8 operations for d2, 1 for the row max, 5 in
// the histogram pass (the NaN test, the key's product and fused
// multiply-add, its digit, the increment) and 5 in the compaction pass
// (the same key and the digit test) and 1 for the neighbour test: 20 per
// pair; 6 maxima per neighbour; per row the 30 replayed steps (3 each),
// c_i, the elus and lin2 (about 120 + 15 d). At B = 128, n = 1024, k = 64,
// d = 128: 3.0e9 operations, 0.045 ms at 67 TFLOP/s, against 1.5 MB of
// points and 34 MB of bf16 tokens (0.01 ms at 3.35 TB/s). (The counting
// bisection's own work was 78 operations per pair, 0.160 ms.) The kernel
// takes ten times that: it is bound by instruction throughput and
// latency, each instruction a warp's, a row's steps waiting on shared
// memory and shuffles.
//
// Design. The (n, n) distances (4 MB per cloud at n = 1024) do not fit on
// chip, and do not need to: one warp owns a query row and keeps its n
// distances in registers, 32 per lane (so n <= 1024, the kernel's
// largest cloud; the wrapper raises past it). A block of 8 warps takes 32
// rows of one cloud and first stages the cloud in shared memory: x, y, z
// and sq as one float4 per point (one 16-byte read per key in the
// distance loop) and the 6 channels of g as a float4 and a float2, 40 n
// bytes, beside each warp's 256-bin histogram (8 KB; the candidates and
// the neighbour words reuse it), 48 KB at n = 1024. Each sweep forms its
// keys anew (no 32 keys held across sweeps), so a thread needs 64
// registers and four blocks share an SM. The row max and the masked max
// per channel are warp max reductions (exact in any order).
// The lin2 product then puts the lanes over the d output channels, with
// coalesced stores. Optionally the kernel writes each row's threshold
// and neighbour count, so that a check can hold its neighbour sets
// against the plain version's.

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
constexpr int BINS = 256;              // one 8-bit digit a radix pass
constexpr int MAX_CANDIDATES = 32;     // compacted once a digit holds no more
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0, float b1,
                                      float b2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1)), __fmul_rn(a2, b2));
}

__device__ __forceinline__ float elu(float x) {
  return x > 0.f ? x : __fsub_rn(expf(fminf(x, 0.f)), 1.f);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// The 16-bit linear key round(sat(v * inv) * 65535), inv > 0: every step
// rounds monotonically, so v <= w gives key(v) <= key(w). Adding 2^23
// leaves the rounded integer in the mantissa's low bits.
__device__ __forceinline__ int key16(float v, float inv) {
  const float t = __saturatef(__fmul_rn(v, inv));
  return __float_as_int(__fmaf_rn(t, 65535.f, 8388608.f)) - 0x4b000000;
}

// The order-preserving bits of a non-NaN fp32 value (-0 before +0).
__device__ __forceinline__ unsigned fkey(float v) {
  const unsigned b = __float_as_uint(v);
  return b ^ ((b >> 31) ? FULL : 0x80000000u);
}

__device__ __forceinline__ float from_fkey(unsigned key) {
  return __uint_as_float(key ^ ((key >> 31) ? 0x80000000u : FULL));
}

struct Digit {
  int digit;  // the digit holding the rank, -1 when fewer members than the rank
  int below;  // members in smaller digits
  int count;  // members in that digit
};

// Adds 1 to *bin where p holds: a predicated shared-memory reduction, so
// the unrolled slot loop has no branch.
__device__ __forceinline__ void count_if(bool p, int* bin) {
  asm volatile(
      "{\n\t.reg .pred q;\n\tsetp.ne.u32 q, %1, 0;\n\t@q red.shared.add.u32 [%0], 1;\n\t}"
      ::"r"((unsigned)__cvta_generic_to_shared(bin)), "r"((unsigned)p)
      : "memory");
}

// One radix pass: the histogram of digit_of(v) (-1 for a non-member) over
// the row's slots, then the digit holding the rank-th smallest member.
// Each lane scans 8 consecutive bins; a warp scan of the lanes' totals
// and a ballot find the digit.
template <typename DigitOf>
__device__ __forceinline__ Digit radix_pass(const float (&dist)[PER_LANE], DigitOf digit_of,
                                            int rank, int* hist, int lane) {
  int4* h4 = reinterpret_cast<int4*>(hist);
  h4[2 * lane] = make_int4(0, 0, 0, 0);
  h4[2 * lane + 1] = make_int4(0, 0, 0, 0);
  __syncwarp();
#pragma unroll
  for (int t = 0; t < PER_LANE; ++t) {
    const int dg = digit_of(dist[t]);
    count_if(dg >= 0, hist + (dg & 0xff));
  }
  __syncwarp();
  const int4 a = h4[2 * lane], b = h4[2 * lane + 1];
  const int h[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  int tot = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) tot += h[i];
  int incl = tot;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int up = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += up;
  }
  const int excl = incl - tot;
  const unsigned hit = __ballot_sync(FULL, excl < rank && rank <= incl);
  int before = excl, pick = 0, pick_below = 0, pick_count = 0;
  bool found = false;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (!found && before + h[i] >= rank) {
      found = true;
      pick = i;
      pick_below = before;
      pick_count = h[i];
    }
    before += h[i];
  }
  __syncwarp();  // every lane has read the bins before they are reused
  if (hit == 0u) return {-1, 0, 0};
  const int src = __ffs(hit) - 1;
  return {__shfl_sync(FULL, lane * 8 + pick, src), __shfl_sync(FULL, pick_below, src),
          __shfl_sync(FULL, pick_count, src)};
}

// The rank-th smallest (1-based) of the at most 32 slots whose value v
// has member(v): compacted by ballot and prefix popcount into cand, then
// each lane counts the members below and not above its own.
template <typename Member>
__device__ __forceinline__ float select_among(const float (&dist)[PER_LANE], Member member,
                                              int rank, float* cand, int lane) {
  const unsigned below_me = (1u << lane) - 1u;
  int count = 0;
#pragma unroll
  for (int t = 0; t < PER_LANE; ++t) {
    const bool in = member(dist[t]);
    const unsigned b = __ballot_sync(FULL, in);
    if (b != 0u) {  // warp-uniform: most slots hold no member
      if (in) cand[count + __popc(b & below_me)] = dist[t];
      count += __popc(b);
    }
  }
  __syncwarp();
  const float mine = lane < count ? cand[lane] : 0.f;
  int lt = 0, le = 0;
#pragma unroll
  for (int j = 0; j < MAX_CANDIDATES; j += 4) {
    if (j >= count) break;  // warp-uniform
    const float4 x4 = *reinterpret_cast<const float4*>(cand + j);
    const float x[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (j + u < count) {
        lt += x[u] < mine ? 1 : 0;
        le += x[u] <= mine ? 1 : 0;
      }
  }
  const unsigned hit = __ballot_sync(FULL, lane < count && lt < rank && rank <= le);
  const float vk = __shfl_sync(FULL, mine, __ffs(hit) - 1);
  __syncwarp();  // every lane has read cand before it is reused
  return vk;
}

// A warp-uniform x read from lane src. Each sweep over the row takes its
// own copy of the key's scale from another lane, so the compiler forms
// each sweep's keys anew rather than holding a previous sweep's 32 in
// registers (which cost the kernel a third of its occupancy).
__device__ __forceinline__ float opaque(float x, int src) {
  return __shfl_sync(FULL, x, src);
}

// v_k: the k-th smallest non-NaN value of the row's 1024 slots (the +inf
// past n included, as the counts included them), NaN when there are
// fewer than k (then every count falls short of k).
__device__ __forceinline__ float kth_smallest(const float (&dist)[PER_LANE], float rowmax,
                                              int k, int* hist, int lane) {
  const float nan = __int_as_float(0x7fffffff);
  float* cand = reinterpret_cast<float*>(hist);
  int rank = k;
  const bool linear = rowmax > 0.f && rowmax < __int_as_float(0x7f800000);
  const float inv = linear ? __frcp_rn(rowmax) : 0.f;
  int k16 = 0;
  if (linear) {
    Digit r = radix_pass(
        dist, [&](float v) { return v == v ? key16(v, inv) >> 8 : -1; }, rank, hist, lane);
    if (r.digit < 0) return nan;
    rank -= r.below;
    const int top = r.digit;
    const float inv_b = opaque(inv, 1);
    if (r.count <= MAX_CANDIDATES)
      return select_among(
          dist, [&](float v) { return v == v && (key16(v, inv_b) >> 8) == top; }, rank, cand,
          lane);
    const float inv_c = opaque(inv, 2);
    r = radix_pass(
        dist,
        [&](float v) {
          const int q = key16(v, inv_c);
          return v == v && (q >> 8) == top ? (q & 0xff) : -1;
        },
        rank, hist, lane);
    rank -= r.below;
    k16 = (top << 8) | r.digit;
    const float inv_d = opaque(inv, 3);
    if (r.count <= MAX_CANDIDATES)
      return select_among(
          dist, [&](float v) { return v == v && key16(v, inv_d) == k16; }, rank, cand, lane);
  }
  // the value's own bits, among the members of the chosen linear key
  // (every non-NaN slot where the key was not used)
  unsigned prefix = 0u;
#pragma unroll 1
  for (int shift = 24; shift >= 0; shift -= 8) {
    const float inv_e = opaque(inv, 4);
    const Digit r = radix_pass(
        dist,
        [&](float v) {
          const unsigned f = fkey(v);
          return v == v && (!linear || key16(v, inv_e) == k16) &&
                         (shift == 24 || (f >> (shift + 8)) == prefix)
                     ? (int)((f >> shift) & 0xffu)
                     : -1;
        },
        rank, hist, lane);
    if (r.digit < 0) return nan;
    rank -= r.below;
    prefix = (prefix << 8) | (unsigned)r.digit;
    const float inv_f = opaque(inv, 5);
    if (r.count <= MAX_CANDIDATES)
      return select_among(
          dist,
          [&](float v) {
            return v == v && (!linear || key16(v, inv_f) == k16) && (fkey(v) >> shift) == prefix;
          },
          rank, cand, lane);
  }
  return from_fkey(prefix);  // the members share all 32 bits: one value
}

// Four blocks an SM (64 registers a thread, 48 KB of shared memory each):
// the row's latencies (shared-memory reads, the scan's shuffles, the
// replay's chain) are hidden by other warps, not by the warp itself.
template <bool OUT_BF16>
__global__ void __launch_bounds__(THREADS, 4)
arpe_kernel(const float* __restrict__ pts, const float* __restrict__ wc,
            const float* __restrict__ wb, const float* __restrict__ b1,
            const float* __restrict__ w2, const float* __restrict__ b2, void* __restrict__ out,
            float* __restrict__ kth, int* __restrict__ count, int n, int d, int k) {
  extern __shared__ float4 smem4[];
  int* hist_all = reinterpret_cast<int*>(smem4);             // [WARPS][BINS]
  float4* sp = smem4 + WARPS * BINS / 4;                     // [n] x, y, z, sq
  float4* sg = sp + n;                                       // [n] g channels 0-3
  float2* sg2 = reinterpret_cast<float2*>(sg + n);           // [n] g channels 4-5
  const int b = blockIdx.y;
  const float* p = pts + (long long)b * n * C;

  for (int j = threadIdx.x; j < n; j += THREADS) {
    const float x = p[j * C], y = p[j * C + 1], z = p[j * C + 2];
    sp[j] = make_float4(x, y, z, dot3(x, y, z, x, y, z));
    float g[CH];
#pragma unroll
    for (int ch = 0; ch < CH; ++ch) g[ch] = -dot3(x, y, z, wb[ch], wb[CH + ch], wb[2 * CH + ch]);
    sg[j] = make_float4(g[0], g[1], g[2], g[3]);
    sg2[j] = make_float2(g[4], g[5]);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* hist = hist_all + warp * BINS;
  unsigned* words = reinterpret_cast<unsigned*>(hist);
  const int row_end = min(n, (blockIdx.x + 1) * ROWS_PER_BLOCK);
  const float inf = __int_as_float(0x7f800000);
  // the bits of lane's word that are points (j = 32 lane + bit < n)
  const int real = n - 32 * lane;
  const unsigned real_bits = real >= 32 ? FULL : real <= 0 ? 0u : (1u << real) - 1u;
  for (int i = blockIdx.x * ROWS_PER_BLOCK + warp; i < row_end; i += WARPS) {
    float4 pi = sp[i];
    float dist[PER_LANE];
    float rowmax = -inf;
#pragma unroll
    for (int t = 0; t < PER_LANE; ++t) {
      const int j = lane + 32 * t;
      float v = inf;
      if (j < n) {
        const float4 q = sp[j];
        const float dot = dot3(pi.x, pi.y, pi.z, q.x, q.y, q.z);
        v = __fsub_rn(__fadd_rn(pi.w, q.w), __fmul_rn(2.f, dot));
        rowmax = fmaxf(rowmax, v);
      }
      dist[t] = v;
    }
    rowmax = warp_max(rowmax);

    const float vk = kth_smallest(dist, rowmax, k, hist, lane);
    pi = sp[i];  // read again rather than held through the selection
    float ci[CH];
#pragma unroll
    for (int ch = 0; ch < CH; ++ch)
      ci[ch] = __fadd_rn(dot3(pi.x, pi.y, pi.z, wc[ch], wc[CH + ch], wc[2 * CH + ch]), b1[ch]);

    // the 30 bisection steps, each decided by v_k alone. Both of a step's
    // possible next midpoints are formed beside its test (the same sums
    // of the same operands as mid = 0.5 (lo + hi) after the step), so the
    // dependent chain a step is the test and one select.
    float lo = 0.f, hi = rowmax;
    float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
#pragma unroll
    for (int it = 0; it < BISECT_ITERS; ++it) {
      const float if_hi = __fmul_rn(0.5f, __fadd_rn(lo, mid));  // next mid when hi = mid
      const float if_lo = __fmul_rn(0.5f, __fadd_rn(mid, hi));  // next mid when lo = mid
      if (vk <= mid) {
        hi = mid;
        mid = if_hi;
      } else {
        lo = mid;
        mid = if_lo;
      }
    }

    // the neighbour set as ballot words; lane t walks word t
#pragma unroll
    for (int t = 0; t < PER_LANE; ++t) {
      const unsigned w = __ballot_sync(FULL, dist[t] <= hi);
      if (lane == 0) words[t] = w;
    }
    __syncwarp();
    const unsigned word = words[lane];
    __syncwarp();  // read before the next row's histogram reuses it
    float gmax[CH];
#pragma unroll
    for (int ch = 0; ch < CH; ++ch) gmax[ch] = NEG;
    for (unsigned left = word & real_bits; left != 0u; left &= left - 1u) {
      const int j = 32 * lane + __ffs(left) - 1;
      const float4 g = sg[j];
      const float2 g2 = sg2[j];
      gmax[0] = fmaxf(gmax[0], g.x);
      gmax[1] = fmaxf(gmax[1], g.y);
      gmax[2] = fmaxf(gmax[2], g.z);
      gmax[3] = fmaxf(gmax[3], g.w);
      gmax[4] = fmaxf(gmax[4], g2.x);
      gmax[5] = fmaxf(gmax[5], g2.y);
    }
    float h[CH];
#pragma unroll
    for (int ch = 0; ch < CH; ++ch) h[ch] = elu(__fadd_rn(ci[ch], warp_max(gmax[ch])));

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
      // count_j(d2 <= thr) over the 1024 slots, as the counting bisection took it
      const int cnt = warp_sum(__popc(word));
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
  const size_t smem = (size_t)WARPS * BINS * sizeof(int) + (size_t)n * (2 * sizeof(float4) +
                                                                        sizeof(float2));
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
