// K1 fused_head_topk: prediction head -> logsumexp -> top-k, with the
// (m, V) logits never written to device memory.
//
// Replaces simpleimagecaptionzoo_tpu/ops/fused_head.py:155 _kernel
// (pallas_call at :203, launched by _run_kernel, entered through topk_head),
// with bf16/float32 weights and, for the int8 serving path (K1-int8), int8
// weights with a per-column scale (prepare_head at fused_head.py:79-87).
//
//   logits = (x @ w) * s + b   in float32, per column chunk
//   lse    = logsumexp(logits) per row
//   top-k  of the raw logits, k <= 16, ordered by value descending and, on
//          a tie, by vocab id ascending (lax.top_k order)
//
// x (m, K) is float32 or bf16; w (K, V) has x's dtype or is int8.  s and b
// are float32 (V,): 1 and the bias for a float head, the column scale and
// bias for an int8 head.  Pad columns carry s = 0 and b = -1e30
// (prepare_head).
//
// What bounds it on an H100 SXM at the greedy shape (m=384, K=1024,
// V=10,240): in bf16, 8.05 GFLOP against 989 TFLOP/s of bf16 tensor cores
// is 8.1 us; the 21.0 MB of w against 3.35 TB/s is 6.3 us.  So the product
// bounds it, and with an int8 w (10.5 MB, 3.1 us) all the more: the int8
// head multiplies in bf16 on the same tensor cores after widening.  In
// float32, three TF32 products (24.2 GFLOP) against 494.7 TFLOP/s are
// 48.8 us; the 42 MB of w 12.5 us.
//
// The float32 products are float32-accurate on every route: route 2 runs
// 3xTF32 (hopper.cuh), route 3 (an int8 w) 2xTF32, route 4 float32 fmaf,
// and the plain version on the card float32 with TF32 off.
//
// Design.  On the TPU the vocab grid runs in order and carries the running
// max, sum and top-k from one tile to the next.  Here blocks run in
// parallel and in no order, so the work is two passes:
//   1. a partial pass: a block takes BM rows and one chunk of BN columns,
//      computes the chunk's logits and writes per (row, chunk) the chunk
//      max, the sum of exp(logit - max) and the chunk's top-k (value, id);
//   2. head_merge: one warp per row merges the partials:
//      lse = M + log(sum_c s_c * exp(m_c - M)), and the top-k over the
//      chunks' candidates in the same (value desc, id asc) order.
// A chunk made only of pad columns has max -1e30 and sum BN, finite, and
// adds exp(-1e30 - M) = 0 to the merged sum.  Columns past V (a ragged
// last chunk) read as -inf with id INT_MAX and are never chosen.  Any m.
//
// The partial pass has four routes, picked by ops/fused_head.py:head_route
// from dtypes, shapes and alignment; the chunk width is the route's
// (head_chunks in ops/fused_head.py):
//
// 1. bf16 x, bf16 or int8 w, with 16-byte rows and aligned bases:
//    head_partial_wgmma<TW>, the tensor-core route (csrc/hopper.cuh).
//    - A block takes 128 rows by a chunk of BN = 256 columns: at m=384 and
//      V=10,240 that is 3 x 40 = 120 blocks, one wave on 120 of the 132
//      SMs; at the beam shape m=1,152, 360 blocks, 2.7 waves.
//    - bf16 w: one thread of a producer warpgroup keeps a ring of 4 stages
//      full with TMA: a 128 x 64 box of x (128-byte swizzle) and four
//      64 x 64 boxes of w (128-byte swizzle), 48 KB a stage, K = 1,024 in
//      16 steps; dynamic shared memory 197,728 bytes.
//    - int8 w (K1-int8): a ring of 3 stages of 64 KB, each the x box, a
//      64 x 256-byte int8 box of w into a staging tile, and the bf16 B
//      tile it is widened into (hopper.cuh's i8_producer: one thread loads,
//      the 128 threads of the producer warpgroup widen step t while the
//      consumers multiply step t - 1, a proxy fence before each "widened"
//      arrival); four stages would need 256 KB.  Dynamic shared memory
//      197,704 bytes.  ptxas: 168 registers at entry and the same 192
//      bytes of epilogue spills as the bf16 sibling, so the widening fits
//      the producer's 40 registers.
//    - The producer warpgroup gives its registers to the consumers
//      (setmaxnreg 40 / 232).
//    - Two consumer warpgroups, 64 rows each, issue four m64n256k16 bf16
//      wgmma per stage, one group in flight.  Each thread holds 128
//      float32 accumulators.
//    - Epilogue on the accumulator in registers: a row's 256 logits lie in
//      the four lanes of a quad, 64 each.  Scale and bias in place (columns
//      past V become -inf), then max, rescaled sum and k rounds of
//      "best after the last taken", each reduced across the quad with
//      __shfl_xor (1, 2).  Nothing goes through shared memory
//      (chunk_partials).
// 2. float32 x and w, with 16-byte rows and aligned bases:
//    head_partial_tf32x3, the tensor-core route for float32.  wgmma has no
//    float32 product and plain TF32's 10 mantissa bits break the float32
//    hold (1e-4) and the float32 decode's identical rows; so the logits are
//    three TF32 products, x_lo w_hi + x_hi w_lo + x_hi w_hi, on
//    hopper.cuh's tf32x3 pipeline.  w_hi and w_lo are w split and
//    transposed once per decode (ops/tf32.py: (Vp, Kp), K-major, which
//    tf32 wgmma requires); x is split in registers.
//    - A block takes 128 rows by a chunk of BN = 128 columns
//      (HEAD_CHUNK_TF32X3): at m=384 and V=10,240, 3 x 80 = 240 blocks,
//      1.8 waves on 132 SMs.  A 256-column chunk would give each thread
//      128 accumulators beside its A fragments, and a stage of 32 K-values
//      80 KB (two stages); at 128 columns a stage is 48 KB, a ring of 4.
//    - Each consumer warpgroup issues 12 m64n128k8 tf32 wgmma a stage into
//      a partial and adds it into its float32 result (hopper.cuh); the
//      producer warpgroup gives its registers to the consumers.
//    - The epilogue is route 1's (chunk_partials) on 64 accumulators.
// 3. float32 x with an int8 w (K1-int8 in float32), 16-byte rows and
//    aligned bases: head_partial_tf32x2, 2xTF32 on hopper.cuh's tf32x2
//    pipeline.  An int8 w is exact in TF32, so x_lo q + x_hi q keeps the
//    float32 hold with two products; q stays int8 in device memory and is
//    transposed and widened to float32 in shared memory, between its TMA
//    load and the products (widen_i8_tile_tf32), since tf32 wgmma takes B
//    K-major only.  At the greedy shape 16.1 GFLOP against 494.7 TFLOP/s
//    is 32.6 us; the 10.5 MB int8 w 3.1 us.
//    - A block takes 128 rows by a chunk of 128 columns (HEAD_CHUNK_TF32X3,
//      as route 2): 240 blocks at m=384, 720 at the beam's m=1,152.
//    - A ring of 5 stages of 36 KB (x, the widened w, the int8 staging
//      tile); the producer warpgroup loads and widens on 40 registers, the
//      consumers run two m64n128k8 tf32 wgmma a k8 step into a stage
//      partial added into the float32 result.
//    - The epilogue is route 1's (chunk_partials) on 64 accumulators.
// 4. Everything else (operands TMA cannot take): head_partial, the
//    CUDA-core route, BN = 128 (HEAD_CHUNK): common.cuh's tile product
//    (fmaf in float32, at least 120 us at the greedy shape), the chunk's
//    logits into shared memory, and one warp per row for the epilogue.
#include <climits>
#include <math.h>

#include "common.cuh"
#include "hopper.cuh"

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

// ---- the partial pass, route 1: TMA + wgmma (bf16) --------------------------

namespace tc {

using namespace sicz::hopper;

constexpr int BM = 128;              // rows: two consumer warpgroups of 64
constexpr int BN = 256;              // columns per chunk (wgmma N)
constexpr int BK = 64;
constexpr int SWB = 128;             // bytes of a w box row: the 128-byte swizzle
constexpr int BOXN = SWB / 2;        // columns of a w box
constexpr int A_BYTES = BM * BK * 2;
constexpr int B_BOX = BK * SWB;
constexpr int B_BYTES = (BN / BOXN) * B_BOX;
// two consumer warpgroups and one producer warpgroup, whose registers go to
// the consumers (setmaxnreg: 2 x 128 x 232 + 128 x 40 <= 65,536): the
// 128-float accumulator and the epilogue then fit without spills
constexpr int NT = 3 * 128;

// The ring per weight type.  bf16 w: 4 stages of [x box][w boxes], 48 KB.
// int8 w: 3 stages of [x box][widened w][int8 staging tile], 64 KB (four
// would need 256 KB).  Both in hopper.cuh's I8Ring.
template <typename TW>
struct Ring {
  static constexpr bool I8 = sizeof(TW) == 1;
  static constexpr int STAGES = I8 ? 3 : 4;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES + (I8 ? BK * BN : 0);
  static constexpr int SMEM = i8_ring_smem(STAGES, STAGE_BYTES);
};

// best (value, id) across the four lanes of a quad
__device__ __forceinline__ void quad_best(float& v, int& i) {
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (before(ov, oi, v, i)) { v = ov; i = oi; }
  }
}

// The chunk's partials from the accumulator of an m64nN product in
// registers (R = N / 2 floats a thread): rows r64 .. r64 + 63, columns
// col0 .. col0 + N - 1.  A row's N logits lie in the four lanes of a quad,
// N / 4 each.  Scale and bias in place (columns past V become -inf), then
// max, rescaled sum and k rounds of "best after the last taken", each
// reduced across the quad with __shfl_xor (1, 2).
template <int R>
__device__ __forceinline__ void chunk_partials(float (&acc)[R], const float* __restrict__ s,
                                               const float* __restrict__ b,
                                               float* __restrict__ pmax, float* __restrict__ psum,
                                               float* __restrict__ pval, int* __restrict__ pidx,
                                               int M, int V, int k, int nchunk, int r64,
                                               int col0) {
  // register i: row 16 w + l/4 + 8 ((i/2) % 2), column 8 (i/4) + 2 (l%4) + i%2
  const int l = threadIdx.x % 32;
  const int cq = col0 + 2 * (l % 4);
#pragma unroll
  for (int jb = 0; jb < R / 4; ++jb) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = cq + 8 * jb + e;
      const bool in = col < V;
      const float sc = in ? s[col] : 0.f, bc = in ? b[col] : 0.f;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float& v = acc[4 * jb + 2 * r + e];
        v = in ? fmaf(v, sc, bc) : -INFINITY;
      }
    }
  }

  const int rbase = r64 + (threadIdx.x / 32 % 4) * 16 + l / 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = rbase + 8 * r;
    const bool live = row < M && l % 4 == 0;   // shuffles need every lane
    float mx = -INFINITY;
#pragma unroll
    for (int jb = 0; jb < R / 4; ++jb)
#pragma unroll
      for (int e = 0; e < 2; ++e) mx = fmaxf(mx, acc[4 * jb + 2 * r + e]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    float sm = 0.f;
#pragma unroll
    for (int jb = 0; jb < R / 4; ++jb)
#pragma unroll
      for (int e = 0; e < 2; ++e) sm += expf(acc[4 * jb + 2 * r + e] - mx);
    sm += __shfl_xor_sync(0xffffffffu, sm, 1);
    sm += __shfl_xor_sync(0xffffffffu, sm, 2);
    const size_t base = (size_t)row * nchunk + blockIdx.x;
    if (live) { pmax[base] = mx; psum[base] = sm; }
    // k rounds; round t takes the best candidate after the one taken in
    // round t-1 in the total (value desc, id asc) order: ids are unique
    float lv = INFINITY;
    int li = -1;
    for (int t = 0; t < k; ++t) {
      float bv = -INFINITY;
      int bi = INT_MAX;
#pragma unroll
      for (int jb = 0; jb < R / 4; ++jb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v = acc[4 * jb + 2 * r + e];
          const int col = cq + 8 * jb + e;
          const int id = col < V ? col : INT_MAX;
          if (before(lv, li, v, id) && before(v, id, bv, bi)) { bv = v; bi = id; }
        }
      quad_best(bv, bi);
      if (live) { pval[base * k + t] = bv; pidx[base * k + t] = bi; }
      lv = bv; li = bi;
    }
  }
}

template <typename TW>
__global__ void __launch_bounds__(NT, 1)
head_partial_wgmma(const __grid_constant__ CUtensorMap map_x,
                   const __grid_constant__ CUtensorMap map_w,
                   const float* __restrict__ s, const float* __restrict__ b,
                   float* __restrict__ pmax, float* __restrict__ psum,
                   float* __restrict__ pval, int* __restrict__ pidx,
                   int M, int K, int V, int k, int nchunk) {
  using R = Ring<TW>;
  constexpr int STAGES = R::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const I8Ring r = i8_ring_init<STAGES, R::STAGE_BYTES>(smem_raw);
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int nk = (K + BK - 1) / BK;
  const int warp = threadIdx.x / 32;
  const int wg = warp / 4;
  if (wg == 2) {                       // producer
    setmaxnreg_dec<40>();
    if constexpr (R::I8) {             // one thread loads, all 128 widen
      i8_producer<BM, BK, BN, STAGES>(&map_x, &map_w, r, row0, col0, nk, threadIdx.x - 256);
    } else if (threadIdx.x == 256) {   // one thread starts the TMA loads
      for (int t = 0; t < nk; ++t) {
        const int st = t % STAGES;
        uint8_t* const sp = r.stages + st * R::STAGE_BYTES;
        if (t >= STAGES) mbar_wait(&r.empty[st], ((t / STAGES) - 1) & 1);
        mbar_expect_tx(&r.full[st], A_BYTES + B_BYTES);
        tma_load_2d(sp, &map_x, t * BK, row0, &r.full[st]);
#pragma unroll
        for (int q = 0; q < BN / BOXN; ++q)
          tma_load_2d(sp + A_BYTES + q * B_BOX, &map_w, col0 + q * BOXN, t * BK, &r.full[st]);
      }
    }
  } else {                             // consumers, to the end of the kernel
    setmaxnreg_inc<232>();
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int t = 0; t < nk; ++t) {
      const int st = t % STAGES;
      mbar_wait(&r.full[st], (t / STAGES) & 1);
      if constexpr (R::I8) mbar_wait(&r.ready[st], (t / STAGES) & 1);
      const uint8_t* a = r.stages + st * R::STAGE_BYTES + wg * 64 * 128;
      const uint8_t* bw = r.stages + st * R::STAGE_BYTES + A_BYTES;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_m64n256k16(acc, desc_a(a + kk * 32), desc_b<SWB>(bw + kk * 16 * SWB, B_BOX), 1);
      wgmma_commit();
      fence_regs(acc);
      wgmma_wait<1>();
      if (t > 0 && threadIdx.x % 128 == 0) mbar_arrive(&r.empty[(t - 1) % STAGES]);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    chunk_partials(acc, s, b, pmax, psum, pval, pidx, M, V, k, nchunk, row0 + wg * 64, col0);
  }
}

// ---- the partial pass, route 2: TMA + 3xTF32 wgmma (float32) ----------------

__global__ void __launch_bounds__(tf32x3::NT, 1)
head_partial_tf32x3(const __grid_constant__ CUtensorMap map_x,
                    const __grid_constant__ CUtensorMap map_hi,
                    const __grid_constant__ CUtensorMap map_lo,
                    const float* __restrict__ s, const float* __restrict__ b,
                    float* __restrict__ pmax, float* __restrict__ psum,
                    float* __restrict__ pval, int* __restrict__ pidx,
                    int M, int K, int V, int k, int nchunk) {
  extern __shared__ uint8_t smem_raw[];
  const tf32x3::Ring r = tf32x3::ring_init(smem_raw);
  const int row0 = blockIdx.y * tf32x3::BM;
  const int col0 = blockIdx.x * tf32x3::BN;
  const int nk = (K + tf32x3::BK - 1) / tf32x3::BK;
  const int warp = threadIdx.x / 32;
  const int wg = warp / 4;
  if (wg == 2) {                       // producer: w_hi / w_lo rows col0 .. col0 + 127
    setmaxnreg_dec<tf32x3::PRODUCER_REGS>();
    if (threadIdx.x == 256)
      tf32x3::produce(r, &map_x, &map_x, nk, nk, 0, row0, &map_hi, &map_lo, col0,
                      tf32x3::BOX_N);
  } else {                             // consumers: warpgroup wg takes rows row0 + 64 wg ..
    setmaxnreg_inc<tf32x3::CONSUMER_REGS>();
    float acc[tf32x3::BN / 2];
#pragma unroll
    for (int i = 0; i < tf32x3::BN / 2; ++i) acc[i] = 0.f;
    tf32x3::consume(r, acc, nk, wg);
    chunk_partials(acc, s, b, pmax, psum, pval, pidx, M, V, k, nchunk, row0 + wg * 64, col0);
  }
}

// ---- the partial pass, route 3: TMA + int8 widened to TF32 + 2xTF32 wgmma -----

__global__ void __launch_bounds__(tf32x2::NT, 1)
head_partial_tf32x2(const __grid_constant__ CUtensorMap map_x,
                    const __grid_constant__ CUtensorMap map_w,
                    const float* __restrict__ s, const float* __restrict__ b,
                    float* __restrict__ pmax, float* __restrict__ psum,
                    float* __restrict__ pval, int* __restrict__ pidx,
                    int M, int K, int V, int k, int nchunk) {
  extern __shared__ uint8_t smem_raw[];
  const I8Ring r = tf32x2::ring_init(smem_raw);
  const int row0 = blockIdx.y * tf32x2::BM;
  const int col0 = blockIdx.x * tf32x2::BN;
  const int nk = (K + tf32x2::BK - 1) / tf32x2::BK;
  const int wg = threadIdx.x / 128;
  if (wg == 2) {                       // producer: loads and widens w's columns col0 ..
    setmaxnreg_dec<tf32x2::PRODUCER_REGS>();
    tf32x2::produce(r, &map_x, &map_w, row0, col0, nk, threadIdx.x - 256);
  } else {                             // consumers: warpgroup wg takes rows row0 + 64 wg ..
    setmaxnreg_inc<tf32x2::CONSUMER_REGS>();
    float acc[tf32x2::BN / 2];
#pragma unroll
    for (int i = 0; i < tf32x2::BN / 2; ++i) acc[i] = 0.f;
    tf32x2::consume(r, acc, nk, wg);
    chunk_partials(acc, s, b, pmax, psum, pval, pidx, M, V, k, nchunk, row0 + wg * 64, col0);
  }
}

}  // namespace tc

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

// The tensor-core route of the partial pass: x bf16, w bf16 or int8 (wdtype
// kBF16 or kI8), K a multiple of 8 and w's rows 16 bytes (V a multiple of 8
// for bf16, of 16 for int8), x and w 16-byte aligned (TMA;
// cudaErrorMisalignedAddress if not); nchunk = ceil(V / 256).  The merge is
// head_merge, as for the other route.  The two tensor maps come from
// hopper.cuh's cache of encoded maps.
extern "C" int fused_head_topk_wgmma(const void* x, const void* w, const float* s,
                                     const float* b, float* pmax, float* psum,
                                     float* pval, int* pidx, float* vals,
                                     int* idx, float* lse, int M, int K, int V,
                                     int k, int nchunk, int wdtype, void* stream) {
  const bool i8 = wdtype == sicz::kI8;
  if (M <= 0 || K <= 0 || V <= 0 || K % 8 != 0 || V % (i8 ? 16 : 8) != 0 || k < 1 ||
      k > KMAX || k > V || nchunk != (V + tc::BN - 1) / tc::BN ||
      (wdtype != sicz::kBF16 && !i8))
    return (int)cudaErrorInvalidValue;
  if (!sicz::hopper::aligned16(x) || !sicz::hopper::aligned16(w))
    return (int)cudaErrorMisalignedAddress;
  CUtensorMap mx, mw;
  if (!sicz::hopper::tensor_map_bf16(&mx, x, M, K, K, tc::BM, tc::BK, 128) ||
      !(i8 ? sicz::hopper::tensor_map_i8(&mw, w, K, V, V, tc::BK, tc::BN)
           : sicz::hopper::tensor_map_bf16(&mw, w, K, V, V, tc::BK, tc::BOXN, tc::SWB)))
    return (int)cudaErrorInvalidValue;
  static std::atomic<uint64_t> smem_set_bf16{0}, smem_set_i8{0};
  const void* kern = i8 ? (const void*)tc::head_partial_wgmma<int8_t>
                        : (const void*)tc::head_partial_wgmma<__nv_bfloat16>;
  const int smem = i8 ? tc::Ring<int8_t>::SMEM : tc::Ring<__nv_bfloat16>::SMEM;
  cudaError_t err = sicz::hopper::allow_smem(kern, smem, i8 ? smem_set_i8 : smem_set_bf16);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid(nchunk, (M + tc::BM - 1) / tc::BM);
  if (i8)
    tc::head_partial_wgmma<int8_t><<<grid, tc::NT, smem, st>>>(
        mx, mw, s, b, pmax, psum, pval, pidx, M, K, V, k, nchunk);
  else
    tc::head_partial_wgmma<__nv_bfloat16><<<grid, tc::NT, smem, st>>>(
        mx, mw, s, b, pmax, psum, pval, pidx, M, K, V, k, nchunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  head_merge<<<(M + NWARP - 1) / NWARP, NT, 0, st>>>(pmax, psum, pval, pidx, vals, idx,
                                                     lse, M, k, nchunk);
  return (int)cudaGetLastError();
}

// The float32 tensor-core route of the partial pass (3xTF32): x float32
// (M, K); w_hi and w_lo w's TF32 parts, each (V, K) row-major (ops/tf32.py);
// K a multiple of 4, x, w_hi and w_lo 16-byte aligned (TMA;
// cudaErrorMisalignedAddress if not); nchunk = ceil(V / 128).  The merge is
// head_merge, as for the other routes.
extern "C" int fused_head_topk_tf32x3(const void* x, const void* w_hi, const void* w_lo,
                                      const float* s, const float* b, float* pmax,
                                      float* psum, float* pval, int* pidx, float* vals,
                                      int* idx, float* lse, int M, int K, int V, int k,
                                      int nchunk, void* stream) {
  namespace t3 = sicz::hopper::tf32x3;
  if (M <= 0 || K <= 0 || V <= 0 || K % 4 != 0 || k < 1 || k > KMAX || k > V ||
      nchunk != (V + t3::BN - 1) / t3::BN)
    return (int)cudaErrorInvalidValue;
  if (!sicz::hopper::aligned16(x) || !sicz::hopper::aligned16(w_hi) ||
      !sicz::hopper::aligned16(w_lo))
    return (int)cudaErrorMisalignedAddress;
  CUtensorMap mx, mhi, mlo;
  if (!sicz::hopper::tensor_map_f32(&mx, x, M, K, K, t3::BM) ||
      !sicz::hopper::tensor_map_f32(&mhi, w_hi, V, K, K, t3::BOX_N) ||
      !sicz::hopper::tensor_map_f32(&mlo, w_lo, V, K, K, t3::BOX_N))
    return (int)cudaErrorInvalidValue;
  static std::atomic<uint64_t> smem_set{0};
  cudaError_t err =
      sicz::hopper::allow_smem((const void*)tc::head_partial_tf32x3, t3::SMEM, smem_set);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid(nchunk, (M + t3::BM - 1) / t3::BM);
  tc::head_partial_tf32x3<<<grid, t3::NT, t3::SMEM, st>>>(mx, mhi, mlo, s, b, pmax, psum,
                                                          pval, pidx, M, K, V, k, nchunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  head_merge<<<(M + NWARP - 1) / NWARP, NT, 0, st>>>(pmax, psum, pval, pidx, vals, idx,
                                                     lse, M, k, nchunk);
  return (int)cudaGetLastError();
}

// The float32 tensor-core route of the partial pass with an int8 head
// (2xTF32): x float32 (M, K), w int8 (K, V) as stored; K a multiple of 4,
// V of 16, x and w 16-byte aligned (TMA; cudaErrorMisalignedAddress if
// not); nchunk = ceil(V / 128).  The merge is head_merge, as for the other
// routes.
extern "C" int fused_head_topk_tf32x2(const void* x, const void* w, const float* s,
                                      const float* b, float* pmax, float* psum,
                                      float* pval, int* pidx, float* vals, int* idx,
                                      float* lse, int M, int K, int V, int k, int nchunk,
                                      void* stream) {
  namespace t2 = sicz::hopper::tf32x2;
  if (M <= 0 || K <= 0 || V <= 0 || K % 4 != 0 || V % 16 != 0 || k < 1 || k > KMAX ||
      k > V || nchunk != (V + t2::BN - 1) / t2::BN)
    return (int)cudaErrorInvalidValue;
  if (!sicz::hopper::aligned16(x) || !sicz::hopper::aligned16(w))
    return (int)cudaErrorMisalignedAddress;
  CUtensorMap mx, mw;
  if (!sicz::hopper::tensor_map_f32(&mx, x, M, K, K, t2::BM) ||
      !sicz::hopper::tensor_map_i8(&mw, w, K, V, V, t2::BK, t2::BN))
    return (int)cudaErrorInvalidValue;
  static std::atomic<uint64_t> smem_set{0};
  cudaError_t err =
      sicz::hopper::allow_smem((const void*)tc::head_partial_tf32x2, t2::SMEM, smem_set);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid(nchunk, (M + t2::BM - 1) / t2::BM);
  tc::head_partial_tf32x2<<<grid, t2::NT, t2::SMEM, st>>>(mx, mw, s, b, pmax, psum, pval,
                                                          pidx, M, K, V, k, nchunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  head_merge<<<(M + NWARP - 1) / NWARP, NT, 0, st>>>(pmax, psum, pval, pidx, vals, idx,
                                                     lse, M, k, nchunk);
  return (int)cudaGetLastError();
}
