// K1 fused_head_topk: prediction head -> logsumexp -> top-k, with the
// (m, V) logits never written to device memory.
//
// Replaces simpleimagecaptionzoo_tpu/ops/fused_head.py:_kernel (launched by
// _run_kernel, entered through topk_head), with bf16/float32 weights and,
// for the int8 serving path (K1-int8), int8 weights with a per-column scale
// (prepare_head at fused_head.py:79-87).
//
//   logits = (x @ w) * s + b   in float32, per column chunk
//   lse    = logsumexp(logits) per row
//   top-k  of the raw logits, k <= 16, ordered by value descending and, on
//          a tie, by vocab id ascending (lax.top_k order)
//
// x (m, K) is float32 or bf16; w (K, V) has x's dtype or is int8 (the
// weight type is a template parameter: the loader widens each element to
// float32 with to_f, exactly).  s and b are float32 (V,): 1 and the bias
// for a float head, the column scale and bias for an int8 head.  Pad
// columns carry s = 0 and b = -1e30 (prepare_head).
//
// What bounds it on an H100 SXM at the greedy shape (m=384, K=1024,
// V=10,240, bf16): 8.05 GFLOP against 989 TFLOP/s of bf16 tensor cores is
// 8.1 us; the 21.0 MB of w against 3.35 TB/s is 6.3 us.  So the product
// bounds it, and with an int8 w (10.5 MB, 3.1 us) all the more.  This
// first kernel multiplies on the CUDA cores in float32 (67 TFLOP/s peak,
// at least 120 us) for every weight type; wgmma is the next step (PERF.md).
//
// Design.  On the TPU the vocab grid runs in order and carries the running
// max, sum and top-k from one tile to the next.  Here blocks run in
// parallel and in no order, so the work is two passes:
//   1. head_partial: a block takes BM rows and one chunk of BN columns,
//      computes the chunk's logits into shared memory, and writes per
//      (row, chunk) the chunk max, the sum of exp(logit - max) and the
//      chunk's top-k (value, id).
//   2. head_merge: one warp per row merges the partials:
//      lse = M + log(sum_c s_c * exp(m_c - M)), and the top-k over the
//      chunks' candidates in the same (value desc, id asc) order.
// A chunk made only of pad columns has max -1e30 and sum BN, finite, and
// adds exp(-1e30 - M) = 0 to the merged sum.  Columns past V (a ragged
// last chunk) read as -inf with id INT_MAX and are never chosen.  Any m.
#include <climits>
#include <math.h>

#include "common.cuh"

namespace {

using namespace sicz;

constexpr int BM = 32;
constexpr int BN = 128;       // columns per chunk (HEAD_CHUNK in fused_head.py)
constexpr int BK = 32;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int CX = BN / TN;
constexpr int NT = (BM / TM) * CX;
constexpr int NWARP = NT / 32;
constexpr int PER_LANE = BN / 32;
constexpr int KMAX = 16;
static_assert(NT == 256, "block of 256 threads");

// a before b in (value desc, id asc) order
__device__ __forceinline__ bool before(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

// best (value, id) across the warp
__device__ __forceinline__ void warp_best(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (before(ov, oi, v, i)) { v = ov; i = oi; }
  }
}

template <typename TX, typename TW>
__global__ void __launch_bounds__(NT)
head_partial(const TX* __restrict__ x, const TW* __restrict__ w,
             const float* __restrict__ s, const float* __restrict__ b,
             float* __restrict__ pmax, float* __restrict__ psum,
             float* __restrict__ pval, int* __restrict__ pidx,
             int M, int K, int V, int k, int nchunk) {
  __shared__ float As[BK * (BM + 1)];
  __shared__ float Bs[BK * BN];
  __shared__ float L[BM * (BN + 1)];
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  auto load_a = [&](int r, int kk) -> float {
    const int row = row0 + r;
    return (row < M && kk < K) ? to_f(x[(size_t)row * K + kk]) : 0.f;
  };
  auto load_b = [&](int kk, int n) -> float {
    const int col = col0 + n;
    return (kk < K && col < V) ? to_f(w[(size_t)kk * V + col]) : 0.f;
  };
  float acc[TM][TN];
  tile_gemm<BM, BN, BK, TM, TN>(acc, K, load_a, load_b, As, Bs);

  const int tx = threadIdx.x % CX, ty = threadIdx.x / CX;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = tx + j * CX, col = col0 + n;
      L[(ty * TM + i) * (BN + 1) + n] =
          col < V ? fmaf(acc[i][j], s[col], b[col]) : -INFINITY;
    }
  __syncthreads();

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int r = warp; r < BM; r += NWARP) {
    const int row = row0 + r;
    if (row >= M) break;              // warp-uniform; rows only grow
    float v[PER_LANE];
    int id[PER_LANE];
    float mx = -INFINITY;
#pragma unroll
    for (int q = 0; q < PER_LANE; ++q) {
      const int n = lane + 32 * q;
      v[q] = L[r * (BN + 1) + n];
      id[q] = col0 + n < V ? col0 + n : INT_MAX;
      mx = fmaxf(mx, v[q]);
    }
    mx = warp_max(mx);
    float sm = 0.f;
#pragma unroll
    for (int q = 0; q < PER_LANE; ++q) sm += expf(v[q] - mx);
    sm = warp_sum(sm);
    const size_t base = (size_t)row * nchunk + blockIdx.x;
    if (lane == 0) { pmax[base] = mx; psum[base] = sm; }
    // k rounds; round t takes the best candidate after the one taken in
    // round t-1 in the total (value desc, id asc) order: ids are unique
    float lv = INFINITY;
    int li = -1;
    for (int t = 0; t < k; ++t) {
      float bv = -INFINITY;
      int bi = INT_MAX;
#pragma unroll
      for (int q = 0; q < PER_LANE; ++q)
        if (before(lv, li, v[q], id[q]) && before(v[q], id[q], bv, bi)) {
          bv = v[q]; bi = id[q];
        }
      warp_best(bv, bi);
      if (lane == 0) { pval[base * k + t] = bv; pidx[base * k + t] = bi; }
      lv = bv; li = bi;
    }
  }
}

__global__ void __launch_bounds__(NT)
head_merge(const float* __restrict__ pmax, const float* __restrict__ psum,
           const float* __restrict__ pval, const int* __restrict__ pidx,
           float* __restrict__ vals, int* __restrict__ idx,
           float* __restrict__ lse, int M, int k, int nchunk) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * NWARP + threadIdx.x / 32;
  if (row >= M) return;               // whole warp; no block barrier below
  const float* rmax = pmax + (size_t)row * nchunk;
  const float* rsum = psum + (size_t)row * nchunk;
  float mx = -INFINITY;
  for (int ch = lane; ch < nchunk; ch += 32) mx = fmaxf(mx, rmax[ch]);
  mx = warp_max(mx);
  float sm = 0.f;
  for (int ch = lane; ch < nchunk; ch += 32) sm += rsum[ch] * expf(rmax[ch] - mx);
  sm = warp_sum(sm);
  if (lane == 0) lse[row] = mx + logf(sm);

  const int ncand = nchunk * k;
  const float* rv = pval + (size_t)row * ncand;
  const int* ri = pidx + (size_t)row * ncand;
  float lv = INFINITY;
  int li = -1;
  for (int t = 0; t < k; ++t) {
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int q = lane; q < ncand; q += 32) {
      const float cv = rv[q];
      const int ci = ri[q];
      if (before(lv, li, cv, ci) && before(cv, ci, bv, bi)) { bv = cv; bi = ci; }
    }
    warp_best(bv, bi);
    if (lane == 0) { vals[(size_t)row * k + t] = bv; idx[(size_t)row * k + t] = bi; }
    lv = bv; li = bi;
  }
}

template <typename TX, typename TW>
void launch_partial(dim3 grid, cudaStream_t st, const void* x, const void* w,
                    const float* s, const float* b, float* pmax, float* psum,
                    float* pval, int* pidx, int M, int K, int V, int k, int nchunk) {
  head_partial<TX, TW><<<grid, NT, 0, st>>>((const TX*)x, (const TW*)w, s, b, pmax, psum,
                                            pval, pidx, M, K, V, k, nchunk);
}

}  // namespace

// dtype is x's type, wdtype w's: kF32 or kBF16, and w may also be kI8.
extern "C" int fused_head_topk(const void* x, const void* w, const float* s,
                               const float* b, float* pmax, float* psum,
                               float* pval, int* pidx, float* vals, int* idx,
                               float* lse, int M, int K, int V, int k,
                               int nchunk, int dtype, int wdtype, void* stream) {
  if (M <= 0 || K <= 0 || V <= 0 || k < 1 || k > KMAX || k > V ||
      nchunk != (V + BN - 1) / BN)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid(nchunk, (M + BM - 1) / BM);
  if (dtype == sicz::kF32 && wdtype == sicz::kF32) {
    launch_partial<float, float>(grid, st, x, w, s, b, pmax, psum, pval, pidx, M, K, V, k, nchunk);
  } else if (dtype == sicz::kBF16 && wdtype == sicz::kBF16) {
    launch_partial<__nv_bfloat16, __nv_bfloat16>(grid, st, x, w, s, b, pmax, psum, pval, pidx,
                                                 M, K, V, k, nchunk);
  } else if (dtype == sicz::kF32 && wdtype == sicz::kI8) {
    launch_partial<float, int8_t>(grid, st, x, w, s, b, pmax, psum, pval, pidx, M, K, V, k, nchunk);
  } else if (dtype == sicz::kBF16 && wdtype == sicz::kI8) {
    launch_partial<__nv_bfloat16, int8_t>(grid, st, x, w, s, b, pmax, psum, pval, pidx,
                                          M, K, V, k, nchunk);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  head_merge<<<(M + NWARP - 1) / NWARP, NT, 0, st>>>(pmax, psum, pval, pidx, vals, idx,
                                                     lse, M, k, nchunk);
  return (int)cudaGetLastError();
}
