// K2's backward products on the tensor cores: the two float32 products of
// the LSTM cell's backward, and the bias gradient.
//
// Replaces the jnp products of simpleimagecaptionzoo_tpu/ops/pallas_lstm.py:455
// _cell_bwd (the custom VJP around the Pallas cell, :445-491):
//
//   dxh = d_gates @ w_cat^T     (B, E+H): dx its first E columns, dh the rest
//   dW  = [x, h]^T @ d_gates    (E+H, 4H)
//   db  = sum over B of d_gates (4H,)
//
// A cell whose input is hoisted runs these over its smaller w_cat (the
// rows of w_ih that stay in the step, then w_hh): E may be 0 (NIC's
// teacher-forced cell), where dx is empty, dW has H rows and x gets no
// tensor map.
//
// d_gates is float32 in both dtypes, so both products are float32 products
// there: a bf16 product of bf16 operands would be another function.
// fused_lstm.cu's backward kernel (the gate recompute and gradients) writes
// d_gates and, beside it, the operands these kernels load.  Each output is
// written in its primal's dtype straight from the accumulator, with no
// float32 intermediate and no cast pass.
//
// What bounds them on an H100 SXM at the XE shape (B=128, E=2048, H=1024:
// K = E+H = 3,072, N = 4H = 4,096, 3.22 GFLOP a product): in bf16 the
// 25.2 MB of w_cat read by dx·dh (7.5 us) and the 25.2 MB of dW written
// (7.5 us) against 6.4 GFLOP each at 989 TFLOP/s (6.5 us); in float32
// three TF32 products each, 9.7 GFLOP at 494.7 TFLOP/s (19.5 us), above
// the 50.3 MB read or written (15.0 us).  So bytes bound the bf16 pair and
// operations the float32 pair.
//
// bf16 ("wgmma"): d_gates arrives as two bf16 parts, d_hi = bf16(d) and
// d_lo = bf16(d - d_hi): d_hi + d_lo is d within 2^-16 |d|, and each bf16
// product of a part with a bf16 w_cat, x or h is exact in float32, so two
// bf16 products into one float32 accumulator are a float32 product to the
// 2^-16 of the split, two orders below the bf16 rounding of the outputs.
//   dx·dh (lstm_bwd_dxh_wgmma): out (B, E+H), reduction over 4H.  A is a
//   part of d (K-major as stored), B is w_cat as stored, (E+H, 4H), which
//   is K-major for this product: both load by TMA in 128-byte-swizzled
//   boxes of 64 K-values, and wgmma reads both without a transpose (<0, 0>).
//   A block computes 128 rows (two consumer warpgroups of 64) by 128
//   columns over a ring of 4 stages of 48 KB (d_hi, d_lo, w_cat), 8
//   m64n128k16 products a stage per warpgroup, one stage's group left in
//   flight while the next is issued.  At B=128 the output is 24
//   such tiles, too few for 132 SMs, so the reduction is split: S blocks
//   per tile (fused_lstm.dxh_splits: at most one block an SM, at most 3
//   in bf16 and 8 in float32, at least 4 stages each), each storing its
//   float32 partial; the last of a tile's S
//   blocks to finish (an integer counter per tile, which that block resets)
//   sums the S partials in split order and writes dx and dh.  The sum does
//   not depend on which block ends last: no float atomics, the same bits
//   from run to run.
//   dW (lstm_bwd_dw_wgmma): out (E+H, 4H), reduction over the batch, 64 to
//   192 deep, so the kernel is bound by its output writes.  A is [x, h]^T,
//   B is d_hi and d_lo; both are stored batch-major, MN-major for this
//   product, and load by TMA as stored (x's or h's columns m0.., E a
//   multiple of 64 so no box straddles x and h; d's columns n0..), read
//   through wgmma's transpose bits (<1, 1>).  Tiles of 128 x 128, stages
//   of 64 batch rows, a ring of 2 (96 KB: two blocks an SM, so one's
//   stores overlap the other's loads), 8 products a stage per warpgroup;
//   the tile leaves through shared memory by TMA stores (dw_store).
//
// float32 ("tf32x3"): three TF32 products, a_lo b_hi + a_hi b_lo + a_hi b_hi,
// each stage's 12 products into a fresh partial added into the float32
// result (hopper.cuh's tf32x3: the tensor core's own sums stay short).
// TF32 wgmma takes K-major operands only.
//   dx·dh (lstm_bwd_dxh_tf32x3): A is d_gates (K-major as stored), split
//   in registers (split_a).  w_cat as stored is K-major for this product,
//   but the forward's TF32 split of it is transposed, (4H, E+H); a second
//   split as stored would be 100 MB more to read a call at AoA's cell and
//   a step to prepare.  So the kernel loads w_cat's float32 tile by TMA and
//   the producer warpgroup splits it in shared memory (split_w_tile: hi in
//   place, lo beside it, then a proxy fence and a "ready" arrival, as the
//   int8 widening stage does): 50 MB read, not 100.  Tiles and split as in
//   bf16; stages of 32 K-values, A 16 KB + w_hi and w_lo 16 KB each, a
//   ring of 4; the producer warpgroup on 40 registers, the consumers on
//   232 (setmaxnreg).
//   dW (lstm_bwd_dw_tf32x3): neither operand is K-major as stored (the
//   batch is K).  B is d^T, split into TF32 parts by the backward kernel's
//   epilogue ((4H, pitch), 4 MB at B=128), which reads by TMA as
//   tf32x3's weight does.  A needs no layout at all: it goes to wgmma from
//   registers, so the consumers read x's and h's TMA boxes (batch rows by
//   32 columns, 128-byte swizzle) transposed into the A fragment (split_at:
//   two lanes of a warp share a bank) and split them there.  Stages of 32
//   batch rows, a ring of 4 (192 KB, one block an SM); the tile leaves by
//   TMA stores as in bf16.
//
// db: the column sums of d_gates (float32) over the batch, a thread a
// column, in a fixed order, in extra blocks of the dW launch, scheduled
// first (no float atomics).
//
// So the tensor-core backward is three launches: the gate kernel, dx·dh and
// dW·db.  Ragged shapes: rows of d, x or h beyond B, columns beyond 4H or
// E+H, and K beyond 4H read TMA's zero fill; stores outside the outputs are
// skipped.  Conditions (fused_lstm.lstm_bwd_route): E a multiple of 64,
// 16-byte rows and bases for TMA, pairs of outputs 4- (bf16) or 8-byte
// (float32) aligned; the C entries refuse anything else.
#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace sicz;
using namespace sicz::hopper;

constexpr int BM = 128;              // output rows of a tile: two consumer warpgroups of 64
constexpr int BN = 128;              // output columns of a tile (wgmma N)

// In the m64n128 fragment (hopper.cuh) register i, i even, and i + 1 hold
// row frag_row(i) and columns frag_col(i), frag_col(i) + 1 of the
// warpgroup's 64 x 128.
__device__ __forceinline__ int frag_row(int i) {
  return (threadIdx.x / 32 % 4) * 16 + threadIdx.x % 32 / 4 + 8 * ((i / 2) % 2);
}
__device__ __forceinline__ int frag_col(int i) { return 8 * (i / 4) + 2 * (threadIdx.x % 4); }

template <typename T> __device__ __forceinline__ void store2(T* p, float a, float b);
template <> __device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *(float2*)p = make_float2(a, b);
}
template <> __device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p, float a,
                                                                  float b) {
  *(__nv_bfloat162*)p = __floats2bfloat162_rn(a, b);
}

// the two consumer warpgroups alone (the producer may have left)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// ---- dx·dh -------------------------------------------------------------------

template <typename T>
struct DxhOut {
  T* dx;           // (B, E)
  T* dh;           // (B, H)
  float* ws;       // S > 1: the partials, (S, B, E+H) float32
  int* count;      // S > 1: a counter per tile, 0 between launches
  int B, E, H;
};

// The end of a dx·dh tile (rows row0 + 64 wg .., columns col0 ..): with
// S > 1 the partial goes to ws, and the last of the tile's S blocks sums
// the S partials in split order; then columns below E go to dx, the others
// to dh.
template <typename T>
__device__ __forceinline__ void dxh_finish(float (&acc)[64], const DxhOut<T>& o, int row0,
                                           int col0, int split, int S, int wg) {
  const int N = o.E + o.H;
  const int r64 = row0 + wg * 64;
  if (S > 1) {
    __shared__ int last;
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int r = r64 + frag_row(i), c = col0 + frag_col(i);
      if (r < o.B && c < N)
        *(float2*)(o.ws + ((size_t)split * o.B + r) * N + c) = make_float2(acc[i], acc[i + 1]);
    }
    __threadfence();
    consumers_sync();
    if (threadIdx.x == 0) {
      const int tile = blockIdx.y * gridDim.x + blockIdx.x;
      last = atomicAdd(o.count + tile, 1) == S - 1;
      if (last) o.count[tile] = 0;       // every block of the tile has counted
    }
    consumers_sync();
    if (!last) return;
    __threadfence();
    // split by split, in split order, each split's 32 loads in flight
    // together; sum holds the running total
    float sum[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) sum[i] = 0.f;
    for (int s = 0; s < S; ++s) {
      if (s == split) {
#pragma unroll
        for (int i = 0; i < 64; ++i) sum[i] += acc[i];
        continue;
      }
      float2 v[32];
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        const int r = r64 + frag_row(i), c = col0 + frag_col(i);
        v[i / 2] = r < o.B && c < N
                       ? __ldcg((const float2*)(o.ws + ((size_t)s * o.B + r) * N + c))
                       : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        sum[i] += v[i / 2].x;
        sum[i + 1] += v[i / 2].y;
      }
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = sum[i];
  }
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int r = r64 + frag_row(i), c = col0 + frag_col(i);
    if (r >= o.B || c >= N) continue;
    // E is even and c is even: a pair never straddles x and h
    if (c < o.E) store2(o.dx + (size_t)r * o.E + c, acc[i], acc[i + 1]);
    else store2(o.dh + (size_t)r * o.H + (c - o.E), acc[i], acc[i + 1]);
  }
}

// the stages [k_begin, k_end) of split `split` of nk_total
__device__ __forceinline__ void split_range(int nk_total, int S, int split, int& k_begin,
                                            int& nk) {
  k_begin = (int)((long long)split * nk_total / S);
  nk = (int)((long long)(split + 1) * nk_total / S) - k_begin;
}

namespace dxh_bf16 {
constexpr int BK = 64;                      // gate columns (K) a stage: one 128-byte box
constexpr int STAGES = 4;
constexpr int A_BYTES = BM * BK * 2;        // one part of d: 16 KB
constexpr int W_BYTES = BN * BK * 2;        // w_cat's rows col0 ..: 16 KB
constexpr int STAGE_BYTES = 2 * A_BYTES + W_BYTES;
constexpr int NT = 2 * 128 + 32;            // two consumer warpgroups, one producer warp
constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8;
}  // namespace dxh_bf16

__global__ void __launch_bounds__(dxh_bf16::NT, 1)
lstm_bwd_dxh_wgmma_kernel(const __grid_constant__ CUtensorMap map_hi,
                   const __grid_constant__ CUtensorMap map_lo,
                   const __grid_constant__ CUtensorMap map_w, const DxhOut<__nv_bfloat16> o,
                   int nk_total, int S) {
  using namespace dxh_bf16;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const ring = smem_1024(smem_raw);
  uint64_t* const full = (uint64_t*)(ring + STAGES * STAGE_BYTES);
  uint64_t* const empty = full + STAGES;
  const int col0 = blockIdx.x * BN, row0 = blockIdx.y * BM, split = blockIdx.z;
  int k_begin, nk;
  split_range(nk_total, S, split, k_begin, nk);
  const int warp = threadIdx.x / 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 8) {                          // producer
    if (threadIdx.x % 32 == 0) {
      for (int t = 0; t < nk; ++t) {
        const int s = t % STAGES;
        uint8_t* const st = ring + s * STAGE_BYTES;
        if (t >= STAGES) mbar_wait(&empty[s], ((t / STAGES) - 1) & 1);
        mbar_expect_tx(&full[s], STAGE_BYTES);
        const int k0 = (k_begin + t) * BK;
        tma_load_2d(st, &map_hi, k0, row0, &full[s]);
        tma_load_2d(st + A_BYTES, &map_lo, k0, row0, &full[s]);
        tma_load_2d(st + 2 * A_BYTES, &map_w, k0, col0, &full[s]);
      }
    }
  } else {                                  // consumers: warpgroup wg takes rows row0 + 64 wg ..
    const int wg = warp / 4;
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int t = 0; t < nk; ++t) {
      const int s = t % STAGES;
      mbar_wait(&full[s], (t / STAGES) & 1);
      const uint8_t* const st = ring + s * STAGE_BYTES;
      const uint8_t* const a_hi = st + wg * 64 * 128;
      const uint8_t* const a_lo = a_hi + A_BYTES;
      const uint8_t* const w = st + 2 * A_BYTES;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wgmma_m64n128k16_t<0, 0>(acc, desc_a(a_lo + kk * 32), desc_a(w + kk * 32), 1);
        wgmma_m64n128k16_t<0, 0>(acc, desc_a(a_hi + kk * 32), desc_a(w + kk * 32), 1);
      }
      wgmma_commit();
      fence_regs(acc);
      // one group in flight: the previous stage's products are done, so
      // its slot goes back to the producer while this stage's run
      wgmma_wait<1>();
      if (t > 0 && threadIdx.x % 128 == 0) mbar_arrive(&empty[(t - 1) % STAGES]);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    dxh_finish(acc, o, row0, col0, split, S, wg);
  }
}

namespace dxh_tf32 {
constexpr int BK = 32;                      // K a stage: 128 bytes of float32
constexpr int STAGES = 4;
constexpr int A_BYTES = BM * BK * 4;        // d_gates: 16 KB
constexpr int W_BYTES = BN * BK * 4;        // w_cat's tile as loaded, then its TF32 hi part
constexpr int STAGE_BYTES = A_BYTES + 2 * W_BYTES;   // [A][w hi][w lo]: tf32x3's stage
constexpr int NT = 3 * 128;                 // two consumer warpgroups, one producer warpgroup
constexpr int SMEM = i8_ring_smem(STAGES, STAGE_BYTES);
static_assert(STAGE_BYTES == tf32x3::STAGE_BYTES && A_BYTES == tf32x3::A_BYTES,
              "the consumers read tf32x3's stage");
}  // namespace dxh_tf32

// w_cat's float32 tile as TMA left it split in place into TF32 parts: hi
// over the tile, lo at the same offsets in `lo` (the split is elementwise,
// so the swizzle stays as it is).  The 128 threads of the producer
// warpgroup, 16 bytes each at a time, consecutive: no bank conflict.
__device__ __forceinline__ void split_w_tile(uint8_t* hi, uint8_t* lo, int tid) {
  const uint32_t h0 = smem_addr(hi), l0 = smem_addr(lo);
#pragma unroll 2
  for (int i = 0; i < dxh_tf32::W_BYTES / (16 * 128); ++i) {
    const uint32_t off = (uint32_t)(tid + 128 * i) * 16;
    float v[4];
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                 : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3]) : "r"(h0 + off) : "memory");
    uint32_t a[4], b[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      a[e] = rna_tf32(v[e]);
      b[e] = rna_tf32(v[e] - __uint_as_float(a[e]));
    }
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n"
                 :: "r"(h0 + off), "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]) : "memory");
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n"
                 :: "r"(l0 + off), "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]) : "memory");
  }
}

__global__ void __launch_bounds__(dxh_tf32::NT, 1)
lstm_bwd_dxh_tf32x3_kernel(const __grid_constant__ CUtensorMap map_d,
                    const __grid_constant__ CUtensorMap map_w, const DxhOut<float> o,
                    int nk_total, int S) {
  using namespace dxh_tf32;
  extern __shared__ uint8_t smem_raw[];
  const I8Ring r = i8_ring_init<STAGES, STAGE_BYTES>(smem_raw);
  const int col0 = blockIdx.x * BN, row0 = blockIdx.y * BM, split = blockIdx.z;
  int k_begin, nk;
  split_range(nk_total, S, split, k_begin, nk);
  const int wg = threadIdx.x / 128;
  if (wg == 2) {                            // producer warpgroup: loads (one thread) and splits
    setmaxnreg_dec<tf32x3::PRODUCER_REGS>();
    const int tid = threadIdx.x - 256;
    auto load_step = [&](int t) {
      const int s = t % STAGES;
      uint8_t* const st = r.stages + s * STAGE_BYTES;
      if (t >= STAGES) mbar_wait(&r.empty[s], ((t / STAGES) - 1) & 1);
      mbar_expect_tx(&r.full[s], A_BYTES + W_BYTES);
      const int k0 = (k_begin + t) * BK;
      tma_load_2d(st, &map_d, k0, row0, &r.full[s]);
#pragma unroll
      for (int g = 0; g < BN / tf32x3::BOX_N; ++g)
        tma_load_2d(st + A_BYTES + g * tf32x3::BOX_N * 128, &map_w, k0,
                    col0 + g * tf32x3::BOX_N, &r.full[s]);
    };
    if (tid == 0)
      for (int t = 0; t < STAGES - 1 && t < nk; ++t) load_step(t);
    for (int t = 0; t < nk; ++t) {
      const int s = t % STAGES;
      uint8_t* const st = r.stages + s * STAGE_BYTES;
      mbar_wait(&r.full[s], (t / STAGES) & 1);
      split_w_tile(st + A_BYTES, st + A_BYTES + W_BYTES, tid);
      fence_proxy_async();
      mbar_arrive(&r.ready[s]);
      // the slot of step t - 1, free once its products are done
      if (tid == 0 && t + STAGES - 1 < nk) load_step(t + STAGES - 1);
    }
  } else {                                  // consumers: warpgroup wg takes rows row0 + 64 wg ..
    setmaxnreg_inc<tf32x3::CONSUMER_REGS>();
    float acc[64], part[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    const uint32_t frag = a_frag(r.stages, wg);
    for (int t = 0; t < nk; ++t) {
      const int s = t % STAGES;
      const uint32_t ph = (t / STAGES) & 1;
      mbar_wait(&r.full[s], ph);            // d's box
      mbar_wait(&r.ready[s], ph);           // w_cat's tile, split
      const uint8_t* const st = r.stages + s * STAGE_BYTES;
      uint32_t hi[BK / 8][4], lo[BK / 8][4];
      split_a(frag + s * STAGE_BYTES, hi, lo);
      fence_regs(part);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) {
        const uint64_t dh = desc_a(st + A_BYTES + kk * 32);
        const uint64_t dl = desc_a(st + A_BYTES + W_BYTES + kk * 32);
        wgmma_m64n128k8_tf32(part, lo[kk], dh, kk > 0);   // the first starts the partial
        wgmma_m64n128k8_tf32(part, hi[kk], dl, 1);
        wgmma_m64n128k8_tf32(part, hi[kk], dh, 1);
      }
      wgmma_commit();
      fence_regs(part);
      wgmma_wait<0>();
      fence_regs(part);
      if (threadIdx.x % 128 == 0) mbar_arrive(&r.empty[s]);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += part[i];
    }
    dxh_finish(acc, o, row0, col0, split, S, wg);
  }
}

// ---- dW and db ------------------------------------------------------------------

template <typename T>
struct DwOut {
  T* db;           // (4H,); dW (E+H, 4H) is written by TMA (map_dw)
  const float* d;  // d_gates (B, 4H) float32: db's operand
  int B, E, H;
  int tiles_n;     // tiles across 4H
  int db_blocks;   // the first blocks sum db; tile t is block db_blocks + t
};

// db in the blocks before dW's tiles (so the card starts them first): a
// thread a column, eight running sums over the batch (row b into sum
// b % 8, so eight loads go out together), added in a fixed tree
template <typename T>
__device__ __forceinline__ void db_block(const DwOut<T>& o) {
  const int n4 = 4 * o.H;
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n4) return;
  float s[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j] = 0.f;
  const float* p = o.d + n;
  int b = 0;
#pragma unroll 2
  for (; b + 8 <= o.B; b += 8)
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j] += p[(size_t)(b + j) * n4];
  for (; b < o.B; ++b) s[b % 8] += p[(size_t)b * n4];
  o.db[n] = from_f<T>(((s[0] + s[1]) + (s[2] + s[3])) + ((s[4] + s[5]) + (s[6] + s[7])));
}

// dW's tile (rows row0 .., columns col0 ..) out of the two warpgroups'
// fragments through shared memory, at `stage` (the ring, free once both
// warpgroups' products are done): each thread writes its pairs into boxes
// of BM rows by 128 bytes (64 bf16 or 32 float32 columns), the 16-byte
// chunk c of row r at c ^ (r % 8), the 128-byte swizzle, so a warp's eight
// rows land on eight bank groups; then one thread stores the boxes with
// TMA, whole 128-byte lines, the tensor's edges clipped.  Written pair by
// pair from the fragment, dW's rows went out 16 bytes at a time and the
// bf16 kernel wrote 25 MB at 0.7 TB/s (scripts/probe_lstm_bwd.py --sweep).
template <typename T>
__device__ __forceinline__ void dw_store(const float (&acc)[64], const CUtensorMap* map_dw,
                                         uint8_t* stage, int row0, int col0, int wg) {
  constexpr int PER_BOX = 128 / (int)sizeof(T);
  constexpr int BOX_BYTES = BM * 128;
  consumers_sync();                         // the other warpgroup's products are done
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int r = wg * 64 + frag_row(i), c = frag_col(i);
    const int at = (c % PER_BOX) * (int)sizeof(T);
    store2((T*)(stage + (c / PER_BOX) * BOX_BYTES + r * 128 +
                ((((at >> 4) ^ (r & 7)) << 4) | (at & 15))),
           acc[i], acc[i + 1]);
  }
  fence_proxy_async();
  consumers_sync();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int b = 0; b < BN / PER_BOX; ++b)
      tma_store_2d(map_dw, stage + b * BOX_BYTES, col0 + b * PER_BOX, row0);
    bulk_commit_wait_read();
  }
}

namespace dw_bf16 {
constexpr int BK = 64;                      // batch rows a stage
constexpr int STAGES = 2;
constexpr int BOX = BK * 128;               // 64 batch rows of 64 bf16 (128 bytes): 8 KB
constexpr int A_BYTES = 2 * BOX;            // [x, h]'s 128 columns m0 ..
constexpr int D_BYTES = 2 * BOX;            // one part of d: 128 columns n0 ..
constexpr int STAGE_BYTES = A_BYTES + 2 * D_BYTES;
constexpr int NT = 2 * 128 + 32;
constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8;
}  // namespace dw_bf16

__global__ void __launch_bounds__(dw_bf16::NT, 2)
lstm_bwd_dw_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                  const __grid_constant__ CUtensorMap map_h,
                  const __grid_constant__ CUtensorMap map_hi,
                  const __grid_constant__ CUtensorMap map_lo,
                  const __grid_constant__ CUtensorMap map_dw, const DwOut<__nv_bfloat16> o) {
  using namespace dw_bf16;
  if ((int)blockIdx.x < o.db_blocks) {
    db_block(o);
    return;
  }
  const int tile = blockIdx.x - o.db_blocks;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const ring = smem_1024(smem_raw);
  uint64_t* const full = (uint64_t*)(ring + STAGES * STAGE_BYTES);
  uint64_t* const empty = full + STAGES;
  const int col0 = (tile % o.tiles_n) * BN, row0 = (tile / o.tiles_n) * BM;
  const int nk = (o.B + BK - 1) / BK;
  const int warp = threadIdx.x / 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 8) {                          // producer
    if (threadIdx.x % 32 == 0) {
      for (int t = 0; t < nk; ++t) {
        const int s = t % STAGES;
        uint8_t* const st = ring + s * STAGE_BYTES;
        if (t >= STAGES) mbar_wait(&empty[s], ((t / STAGES) - 1) & 1);
        mbar_expect_tx(&full[s], STAGE_BYTES);
        const int b0 = t * BK;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int m = row0 + 64 * q;      // E % 64 == 0: the box lies in x or in h
          if (m < o.E) tma_load_2d(st + q * BOX, &map_x, m, b0, &full[s]);
          else tma_load_2d(st + q * BOX, &map_h, m - o.E, b0, &full[s]);
          tma_load_2d(st + A_BYTES + q * BOX, &map_hi, col0 + 64 * q, b0, &full[s]);
          tma_load_2d(st + A_BYTES + D_BYTES + q * BOX, &map_lo, col0 + 64 * q, b0, &full[s]);
        }
      }
    }
  } else {                                  // consumers: warpgroup wg takes dW's rows row0 + 64 wg ..
    const int wg = warp / 4;
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int t = 0; t < nk; ++t) {
      const int s = t % STAGES;
      mbar_wait(&full[s], (t / STAGES) & 1);
      const uint8_t* const st = ring + s * STAGE_BYTES;
      const uint8_t* const a = st + wg * BOX;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // A MN-major: 64 columns of x or h, one 128-byte box wide; the
        // next 16 batch rows 16 * 128 bytes on
        const uint64_t da = smem_desc(a + kk * 16 * 128, BOX, 1024, 1);
        wgmma_m64n128k16_t<1, 1>(acc, da, desc_b<128>(st + A_BYTES + D_BYTES + kk * 16 * 128, BOX), 1);
        wgmma_m64n128k16_t<1, 1>(acc, da, desc_b<128>(st + A_BYTES + kk * 16 * 128, BOX), 1);
      }
      wgmma_commit();
      fence_regs(acc);
      wgmma_wait<1>();                      // as in dx·dh: one group in flight
      if (t > 0 && threadIdx.x % 128 == 0) mbar_arrive(&empty[(t - 1) % STAGES]);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    dw_store<__nv_bfloat16>(acc, &map_dw, ring, row0, col0, wg);
  }
}

namespace dw_tf32 {
constexpr int BK = 32;                      // batch rows a stage
constexpr int STAGES = 4;
constexpr int BOX = BK * 128;               // 32 batch rows of 32 float32: 4 KB
constexpr int A_BYTES = 4 * BOX;            // [x, h]'s 128 columns m0 ..: 16 KB
constexpr int D_BYTES = BN * BK * 4;        // one TF32 part of d^T: rows n0 .., 16 KB
constexpr int STAGE_BYTES = A_BYTES + 2 * D_BYTES;
constexpr int NT = 2 * 128 + 32;
constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8;
}  // namespace dw_tf32

// This thread's A fragments of one stage of dW's float32 product, split
// into TF32 hi and lo.  Element (m, k) of A is [x, h][k][m]: in box m / 32
// (BOX bytes apart), row k (the batch) at k * 128 bytes, 16-byte chunk
// (m % 32) / 4 at ((m % 32) / 4) ^ (k % 8) (the 128-byte swizzle), word
// m % 4.  The fragment (hopper.cuh, m64nNk8 tf32): row 16 w + l/4 + 8 (i%2),
// k = l % 4 + 4 (i/2), for the warpgroup's rows 64 wg ..
template <int KSTEPS>
__device__ __forceinline__ void split_at(const uint8_t* a, int wg, uint32_t (&hi)[KSTEPS][4],
                                         uint32_t (&lo)[KSTEPS][4]) {
  const int l = threadIdx.x % 32;
  const uint32_t base = smem_addr(a);
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = wg * 64 + (threadIdx.x / 32 % 4) * 16 + l / 4 + 8 * (i % 2);
      const int k = 8 * kk + l % 4 + 4 * (i / 2);
      float f;
      asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(f)
                   : "r"(base + (m / 32) * dw_tf32::BOX + k * 128 +
                         ((((m % 32) / 4) ^ (k % 8)) << 4) + (m % 4) * 4));
      hi[kk][i] = rna_tf32(f);
      lo[kk][i] = rna_tf32(f - __uint_as_float(hi[kk][i]));
    }
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    fence_regs(hi[kk]);
    fence_regs(lo[kk]);
  }
}

__global__ void __launch_bounds__(dw_tf32::NT, 1)
lstm_bwd_dw_tf32x3_kernel(const __grid_constant__ CUtensorMap map_x,
                   const __grid_constant__ CUtensorMap map_h,
                   const __grid_constant__ CUtensorMap map_thi,
                   const __grid_constant__ CUtensorMap map_tlo,
                   const __grid_constant__ CUtensorMap map_dw, const DwOut<float> o) {
  using namespace dw_tf32;
  if ((int)blockIdx.x < o.db_blocks) {
    db_block(o);
    return;
  }
  const int tile = blockIdx.x - o.db_blocks;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const ring = smem_1024(smem_raw);
  uint64_t* const full = (uint64_t*)(ring + STAGES * STAGE_BYTES);
  uint64_t* const empty = full + STAGES;
  const int col0 = (tile % o.tiles_n) * BN, row0 = (tile / o.tiles_n) * BM;
  const int nk = (o.B + BK - 1) / BK;
  const int warp = threadIdx.x / 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 8) {                          // producer
    if (threadIdx.x % 32 == 0) {
      for (int t = 0; t < nk; ++t) {
        const int s = t % STAGES;
        uint8_t* const st = ring + s * STAGE_BYTES;
        if (t >= STAGES) mbar_wait(&empty[s], ((t / STAGES) - 1) & 1);
        mbar_expect_tx(&full[s], STAGE_BYTES);
        const int b0 = t * BK;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int m = row0 + 32 * q;      // E % 64 == 0: the box lies in x or in h
          if (m < o.E) tma_load_2d(st + q * BOX, &map_x, m, b0, &full[s]);
          else tma_load_2d(st + q * BOX, &map_h, m - o.E, b0, &full[s]);
          tma_load_2d(st + A_BYTES + q * BOX, &map_thi, b0, col0 + 32 * q, &full[s]);
          tma_load_2d(st + A_BYTES + D_BYTES + q * BOX, &map_tlo, b0, col0 + 32 * q, &full[s]);
        }
      }
    }
  } else {                                  // consumers: warpgroup wg takes dW's rows row0 + 64 wg ..
    const int wg = warp / 4;
    float acc[64], part[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int t = 0; t < nk; ++t) {
      const int s = t % STAGES;
      mbar_wait(&full[s], (t / STAGES) & 1);
      const uint8_t* const st = ring + s * STAGE_BYTES;
      uint32_t hi[BK / 8][4], lo[BK / 8][4];
      split_at(st, wg, hi, lo);
      fence_regs(part);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) {
        const uint64_t dh = desc_a(st + A_BYTES + kk * 32);
        const uint64_t dl = desc_a(st + A_BYTES + D_BYTES + kk * 32);
        wgmma_m64n128k8_tf32(part, lo[kk], dh, kk > 0);   // the first starts the partial
        wgmma_m64n128k8_tf32(part, hi[kk], dl, 1);
        wgmma_m64n128k8_tf32(part, hi[kk], dh, 1);
      }
      wgmma_commit();
      fence_regs(part);
      wgmma_wait<0>();
      fence_regs(part);
      if (threadIdx.x % 128 == 0) mbar_arrive(&empty[s]);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += part[i];
    }
    dw_store<float>(acc, &map_dw, ring, row0, col0, wg);
  }
}

// ---- host ----------------------------------------------------------------------

bool shape_ok(int B, int E, int H, int align) {
  return B > 0 && E >= 0 && H > 0 && E % 64 == 0 && H % align == 0;
}

template <typename T>
bool out_misaligned(const T* a, const T* b) {
  constexpr uintptr_t m = 2 * sizeof(T) - 1;   // pairs
  return (((uintptr_t)a | (uintptr_t)b) & m) != 0;
}

int dxh_check(int B, int E, int H, int S, int bk, const void* ws, const void* count) {
  const int nk_total = (4 * H + bk - 1) / bk;
  if (S < 1 || S > nk_total) return (int)cudaErrorInvalidValue;
  if (S > 1 && (ws == nullptr || count == nullptr || ((uintptr_t)ws & 7) != 0))
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// dx·dh on the bf16 tensor cores: d_hi and d_lo (B, 4H) bf16, w_cat
// (E+H, 4H) bf16 -> dx (B, E), dh (B, H) bf16.  S splits of the reduction
// (fused_lstm.dxh_splits); with S > 1, ws holds S * B * (E+H) float32 and
// count one int per tile (ceil((E+H)/128) * ceil(B/128)), zero (the
// kernel leaves them zero).  E a multiple of 64, H of 8; d_hi, d_lo and
// w_cat 16-byte aligned (TMA), dx and dh 4-byte aligned.
extern "C" int lstm_bwd_dxh_wgmma(const void* d_hi, const void* d_lo, const void* w_cat,
                                  void* dx, void* dh, void* ws, void* count, int B, int E,
                                  int H, int S, void* stream) {
  using namespace dxh_bf16;
  if (!shape_ok(B, E, H, 8)) return (int)cudaErrorInvalidValue;
  if (const int e = dxh_check(B, E, H, S, BK, ws, count)) return e;
  if (!aligned16(d_hi) || !aligned16(d_lo) || !aligned16(w_cat) ||
      out_misaligned((const __nv_bfloat16*)dx, (const __nv_bfloat16*)dh))
    return (int)cudaErrorMisalignedAddress;
  const uint64_t n4 = 4 * (uint64_t)H, kt = (uint64_t)E + H;
  CUtensorMap mhi, mlo, mw;
  if (!tensor_map_bf16(&mhi, d_hi, B, n4, n4, BM, BK, 128) ||
      !tensor_map_bf16(&mlo, d_lo, B, n4, n4, BM, BK, 128) ||
      !tensor_map_bf16(&mw, w_cat, kt, n4, n4, BN, BK, 128))
    return (int)cudaErrorInvalidValue;
  static std::atomic<uint64_t> smem_set{0};
  const cudaError_t err = allow_smem((const void*)lstm_bwd_dxh_wgmma_kernel, SMEM, smem_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((kt + BN - 1) / BN), (B + BM - 1) / BM, S);
  const DxhOut<__nv_bfloat16> o{(__nv_bfloat16*)dx, (__nv_bfloat16*)dh, (float*)ws,
                                (int*)count, B, E, H};
  lstm_bwd_dxh_wgmma_kernel<<<grid, NT, SMEM, (cudaStream_t)stream>>>(mhi, mlo, mw, o,
                                                               (int)((n4 + BK - 1) / BK), S);
  return (int)cudaGetLastError();
}

// dx·dh on the float32 tensor cores (3xTF32): d_gates (B, 4H) and w_cat
// (E+H, 4H) float32 -> dx (B, E), dh (B, H) float32; S, ws and count as
// above.  E a multiple of 64, H of 4; d_gates and w_cat 16-byte aligned,
// dx and dh 8-byte aligned.
extern "C" int lstm_bwd_dxh_tf32x3(const void* d, const void* w_cat, void* dx, void* dh,
                                   void* ws, void* count, int B, int E, int H, int S,
                                   void* stream) {
  using namespace dxh_tf32;
  if (!shape_ok(B, E, H, 4)) return (int)cudaErrorInvalidValue;
  if (const int e = dxh_check(B, E, H, S, BK, ws, count)) return e;
  if (!aligned16(d) || !aligned16(w_cat) || out_misaligned((const float*)dx, (const float*)dh))
    return (int)cudaErrorMisalignedAddress;
  const uint64_t n4 = 4 * (uint64_t)H, kt = (uint64_t)E + H;
  CUtensorMap md, mw;
  if (!tensor_map_f32(&md, d, B, n4, n4, BM) ||
      !tensor_map_f32(&mw, w_cat, kt, n4, n4, tf32x3::BOX_N))
    return (int)cudaErrorInvalidValue;
  static std::atomic<uint64_t> smem_set{0};
  const cudaError_t err = allow_smem((const void*)lstm_bwd_dxh_tf32x3_kernel, SMEM, smem_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((kt + BN - 1) / BN), (B + BM - 1) / BM, S);
  const DxhOut<float> o{(float*)dx, (float*)dh, (float*)ws, (int*)count, B, E, H};
  lstm_bwd_dxh_tf32x3_kernel<<<grid, NT, SMEM, (cudaStream_t)stream>>>(md, mw, o,
                                                                (int)((n4 + BK - 1) / BK), S);
  return (int)cudaGetLastError();
}

// dW and db on the bf16 tensor cores: x (B, E), h (B, H), d_hi and d_lo
// (B, 4H) bf16, d_gates (B, 4H) float32 -> dW (E+H, 4H), db (4H,) bf16.
// E a multiple of 64, H of 8; x, h, d_hi, d_lo and dW 16-byte aligned
// (TMA), db 4-byte aligned.
extern "C" int lstm_bwd_dw_wgmma(const void* x, const void* h, const void* d_hi,
                                 const void* d_lo, const void* d, void* dw, void* db, int B,
                                 int E, int H, void* stream) {
  using namespace dw_bf16;
  if (!shape_ok(B, E, H, 8)) return (int)cudaErrorInvalidValue;
  if ((E > 0 && !aligned16(x)) || !aligned16(h) || !aligned16(d_hi) || !aligned16(d_lo) ||
      !aligned16(dw) || ((uintptr_t)db & 3) != 0)
    return (int)cudaErrorMisalignedAddress;
  const uint64_t n4 = 4 * (uint64_t)H, kt = (uint64_t)E + H;
  // E = 0: no box lies in x, which gets no map (h's fills its slot)
  CUtensorMap mx, mh, mhi, mlo, mdw;
  if ((E > 0 && !tensor_map_bf16(&mx, x, B, E, E, BK, 64, 128)) ||
      !tensor_map_bf16(&mh, h, B, H, H, BK, 64, 128) ||
      !tensor_map_bf16(&mhi, d_hi, B, n4, n4, BK, 64, 128) ||
      !tensor_map_bf16(&mlo, d_lo, B, n4, n4, BK, 64, 128) ||
      !tensor_map_bf16(&mdw, dw, kt, n4, n4, BM, 64, 128))
    return (int)cudaErrorInvalidValue;
  if (E == 0) mx = mh;
  static std::atomic<uint64_t> smem_set{0};
  const cudaError_t err = allow_smem((const void*)lstm_bwd_dw_wgmma_kernel, SMEM, smem_set);
  if (err != cudaSuccess) return (int)err;
  const int tiles_n = (int)((n4 + BN - 1) / BN);
  const int tiles = tiles_n * ((E + H + BM - 1) / BM);
  const int db_blocks = (int)((n4 + NT - 1) / NT);
  const DwOut<__nv_bfloat16> o{(__nv_bfloat16*)db, (const float*)d, B, E, H, tiles_n,
                               db_blocks};
  lstm_bwd_dw_wgmma_kernel<<<db_blocks + tiles, NT, SMEM, (cudaStream_t)stream>>>(
      mx, mh, mhi, mlo, mdw, o);
  return (int)cudaGetLastError();
}

// dW and db on the float32 tensor cores (3xTF32): x (B, E), h (B, H)
// float32, dt_hi and dt_lo (4H rows of dt_pitch >= B, a multiple of 4)
// d_gates^T's TF32 parts (fused_lstm_cell_bwd_tf32x3), d_gates (B, 4H)
// float32 -> dW (E+H, 4H), db (4H,) float32.  E a multiple of 64, H of 4;
// x, h, dt_hi, dt_lo and dW 16-byte aligned (TMA), db 4-byte aligned.
extern "C" int lstm_bwd_dw_tf32x3(const void* x, const void* h, const void* dt_hi,
                                  const void* dt_lo, int dt_pitch, const void* d, void* dw,
                                  void* db, int B, int E, int H, void* stream) {
  using namespace dw_tf32;
  if (!shape_ok(B, E, H, 4) || dt_pitch < B) return (int)cudaErrorInvalidValue;
  if ((E > 0 && !aligned16(x)) || !aligned16(h) || !aligned16(dt_hi) || !aligned16(dt_lo) ||
      !aligned16(dw) || ((uintptr_t)db & 3) != 0)
    return (int)cudaErrorMisalignedAddress;
  const uint64_t n4 = 4 * (uint64_t)H, kt = (uint64_t)E + H;
  CUtensorMap mx, mh, mthi, mtlo, mdw;
  if ((E > 0 && !tensor_map_f32(&mx, x, B, E, E, BK)) ||
      !tensor_map_f32(&mh, h, B, H, H, BK) ||
      !tensor_map_f32(&mthi, dt_hi, n4, B, dt_pitch, 32) ||
      !tensor_map_f32(&mtlo, dt_lo, n4, B, dt_pitch, 32) ||
      !tensor_map_f32(&mdw, dw, kt, n4, n4, BM))
    return (int)cudaErrorInvalidValue;
  if (E == 0) mx = mh;
  static std::atomic<uint64_t> smem_set{0};
  const cudaError_t err = allow_smem((const void*)lstm_bwd_dw_tf32x3_kernel, SMEM, smem_set);
  if (err != cudaSuccess) return (int)err;
  const int tiles_n = (int)((n4 + BN - 1) / BN);
  const int tiles = tiles_n * ((E + H + BM - 1) / BM);
  const int db_blocks = (int)((n4 + NT - 1) / NT);
  const DwOut<float> o{(float*)db, (const float*)d, B, E, H, tiles_n, db_blocks};
  lstm_bwd_dw_tf32x3_kernel<<<db_blocks + tiles, NT, SMEM, (cudaStream_t)stream>>>(
      mx, mh, mthi, mtlo, mdw, o);
  return (int)cudaGetLastError();
}

// TMA tensor maps this library has encoded so far, on every host thread.
extern "C" unsigned long long lstm_bwd_map_encodes() {
  return (unsigned long long)map_encodes().load();
}
