// K3 quant_matmul: weight-only int8 product with a per-column scale.
//
// Replaces simpleimagecaptionzoo_tpu/ops/quant.py:_kernel (launched by
// _matmul_pallas, entered through quant_matmul).
//
//   out[r, c] = (sum_k x[r, k] * float(q[k, c])) * s[c] + b[c]   c < n
//
// accumulated in float32 and rounded once to x's type.  x (M, K) is float32
// or bf16; q (Kp, Np) is int8, zero-padded to K <= Kp (a multiple of 128)
// and n <= Np (a multiple of 512) at quantization time; s and b are float32
// (n,).  The loop runs over x's K columns: q's pad rows are zero and would
// add nothing.  Only the n true columns are stored, so out is (M, n).
//
// What bounds it on an H100 SXM at the LSTM gate shape of the int8 decode
// (M=384, K=3072, n=4096, bf16 x): 9.66 GFLOP against 989 TFLOP/s of bf16
// tensor cores is 9.8 us; the 18.1 MB it must move (the 12.6 MB int8
// weight, x, out) against 3.35 TB/s is 5.4 us.  So the bf16 tensor-core
// rate bounds it, and the int8 weight read is next.  The step's two other
// shapes (aoa_dec.q 384 x 1024 x 1024, aoa_dec.aoa 384 x 2048 x 2048) are
// bound the same way, at 0.8 and 3.3 us.
//
// Two routes, picked by ops/quant.py:quant_route from dtypes, shapes and
// alignment:
//
// 1. bf16 x with K a multiple of 8 and 16-byte-aligned x and q:
//    quant_matmul_wgmma, the tensor-core route (csrc/hopper.cuh).
//    - A block computes 128 rows by 128 columns: 3 x 32 = 96 blocks at the
//      LSTM shape, one wave.  Where 128 x 128 tiles would fill at most half
//      the SMs, a block computes 128 x 64 instead: the aoa_dec shapes run
//      48 and 96 blocks, not 24 and 48 (the C entry picks the width).
//    - A producer warpgroup keeps a ring of stages full (5 of 40 KB at 128
//      columns, 7 of 28 KB at 64): a 128 x 64 box of x (128-byte swizzle),
//      a 64 x BN-byte int8 box of q into a staging tile, and the 64 x BN
//      bf16 B tile the warpgroup widens it into (hopper.cuh's i8_producer
//      and widen_i8_tile: byte permutes and float adds, exact).  One thread
//      starts the TMA loads STAGES - 1 steps ahead; all 128 widen step t
//      while the consumers multiply step t - 1.  Barriers per stage: loaded
//      (TMA), widened (128 arrivals after a proxy fence each), freed (the
//      two consumer warpgroups).
//    - Two consumer warpgroups, 64 rows each, run four m64nBNk16 bf16
//      wgmma per stage, wait for them and free the stage at once (as K2).
//    - Epilogue in registers: acc * s[c] + b[c] in float32, rounded once to
//      bf16, pairs of columns stored where c < n.  s and b of the thread's
//      BN / 4 columns are loaded before the k-loop.
//    Dynamic shared memory, with 1 KB for alignment and the barriers:
//    205,944 bytes at 128 columns, 201,896 at 64; 384 threads, one block
//    per SM; 148 registers at 128 columns, 83 at 64, no spills (ptxas).
//    The weight could instead be A, widened in registers (out^T = q^T x^T,
//    CUTLASS's mixed-input scheme), which skips the bf16 rewrite of shared
//    memory; that is for when the widening is shown to set the pace.
// 2. Everything else (float32 x, and bf16 shapes or pointers TMA cannot
//    take): quant_matmul_kernel, the CUDA-core route.  The grid tiles rows
//    (BM) and columns (BN); the shared tile product of common.cuh reads x
//    through load_a and q through load_b, which widens each int8 with to_f
//    (fmaf in float32, at least 144 us at the LSTM shape).  float32 stays
//    here: wgmma has no float32 product, and TF32 breaks the float32 hold.
//    Any M, K and n are taken (loads outside the operands read 0, stores
//    outside out are skipped).
#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace sicz;

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int CX = BN / TN;
constexpr int NT = (BM / TM) * CX;
static_assert(NT == 256, "block of 256 threads");

template <typename T>
__global__ void __launch_bounds__(NT)
quant_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
                    const float* __restrict__ s, const float* __restrict__ b,
                    T* __restrict__ out, int M, int K, int n, int Np) {
  __shared__ float As[BK * (BM + 1)];
  __shared__ float Bs[BK * BN];
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  auto load_a = [&](int r, int k) -> float {
    const int row = row0 + r;
    return (row < M && k < K) ? to_f(x[(size_t)row * K + k]) : 0.f;
  };
  auto load_b = [&](int k, int c) -> float {
    const int col = col0 + c;
    return (k < K && col < n) ? to_f(q[(size_t)k * Np + col]) : 0.f;
  };
  float acc[TM][TN];
  tile_gemm<BM, BN, BK, TM, TN>(acc, K, load_a, load_b, As, Bs);

  const int tx = threadIdx.x % CX, ty = threadIdx.x / CX;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = row0 + ty * TM + i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = col0 + tx + j * CX;
      if (col < n) out[(size_t)row * n + col] = from_f<T>(acc[i][j] * s[col] + b[col]);
    }
  }
}

// ---- route 1: TMA + int8 widening + wgmma (bf16 x) --------------------------

namespace tc {

using namespace sicz::hopper;

constexpr int BM = 128;              // rows: two consumer warpgroups of 64
constexpr int BK = 64;               // K per stage: one x box
constexpr int A_BYTES = BM * BK * 2;
constexpr int B_BOX = BK * 128;      // one 64-column box of the widened B
constexpr int NT = 3 * 128;          // two consumer warpgroups, one producer warpgroup

// The tile per width: BN = 128 columns in 5 stages of 40 KB, or BN = 64
// (for shapes with few 128-column blocks) in 7 stages of 28 KB.
template <int BN>
struct Tile {
  static constexpr int STAGES = BN == 128 ? 5 : 7;
  static constexpr int STAGE_BYTES = A_BYTES + BK * BN * 2 + BK * BN;
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 3 * STAGES * 8;
};

template <int BN>
__global__ void __launch_bounds__(NT, 1)
quant_matmul_wgmma(const __grid_constant__ CUtensorMap map_x,
                   const __grid_constant__ CUtensorMap map_q,
                   const float* __restrict__ s, const float* __restrict__ b,
                   __nv_bfloat16* __restrict__ out, int M, int K, int n) {
  static_assert(BN == 64 || BN == 128, "wgmma N of 64 or 128");
  constexpr int STAGES = Tile<BN>::STAGES, STAGE_BYTES = Tile<BN>::STAGE_BYTES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const ring = smem_1024(smem_raw);
  uint64_t* const full = (uint64_t*)(ring + STAGES * STAGE_BYTES);
  uint64_t* const ready = full + STAGES;
  uint64_t* const empty = ready + STAGES;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int nk = (K + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&full[st], 1);         // the expect-tx arrival
      mbar_init(&ready[st], 128);      // every thread of the producer warpgroup
      mbar_init(&empty[st], 2);        // one arrival per consumer warpgroup
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    i8_producer<BM, BK, BN, STAGES>(&map_x, &map_q, ring, full, ready, empty, row0, col0,
                                    nk, threadIdx.x - 256);
    return;
  }
  // consumers: warpgroup wg takes rows row0 + 64 wg ..; register i of the
  // accumulator holds column 8 (i/4) + 2 (l%4) + i%2
  const int l = threadIdx.x % 32;
  const int cq = col0 + 2 * (l % 4);
  float sc[BN / 4], bc[BN / 4];        // [2 jb + e]: the thread's BN / 4 columns
#pragma unroll
  for (int jb = 0; jb < BN / 8; ++jb)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = cq + 8 * jb + e;
      sc[2 * jb + e] = col < n ? __ldg(s + col) : 0.f;
      bc[2 * jb + e] = col < n ? __ldg(b + col) : 0.f;
    }
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int t = 0; t < nk; ++t) {
    const int st = t % STAGES;
    const uint32_t ph = (t / STAGES) & 1;
    mbar_wait(&full[st], ph);          // x's box
    mbar_wait(&ready[st], ph);         // the widened q tile
    const uint8_t* a = ring + st * STAGE_BYTES + wg * 64 * 128;
    const uint8_t* bw = ring + st * STAGE_BYTES + A_BYTES;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t da = desc_a(a + kk * 32), db = desc_b<128>(bw + kk * 16 * 128, B_BOX);
      if constexpr (BN == 128) wgmma_m64n128k16(acc, da, db, 1);
      else wgmma_m64n64k16(acc, da, db, 1);
    }
    wgmma_commit();
    fence_regs(acc);
    wgmma_wait<0>();
    if (threadIdx.x % 128 == 0) mbar_arrive(&empty[st]);
  }
  fence_regs(acc);

  const int rbase = row0 + wg * 64 + (threadIdx.x / 32 % 4) * 16 + l / 4;
  const bool pairs = n % 2 == 0;       // (row * n + col) even: bf16x2 stores
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = rbase + 8 * r;
    if (row >= M) continue;
    __nv_bfloat16* const orow = out + (size_t)row * n;
#pragma unroll
    for (int jb = 0; jb < BN / 8; ++jb) {
      const int col = cq + 8 * jb;
      if (col >= n) continue;
      const float v0 = fmaf(acc[4 * jb + 2 * r], sc[2 * jb], bc[2 * jb]);
      const float v1 = fmaf(acc[4 * jb + 2 * r + 1], sc[2 * jb + 1], bc[2 * jb + 1]);
      if (pairs) {
        *(__nv_bfloat162*)(orow + col) = __floats2bfloat162_rn(v0, v1);
      } else {
        orow[col] = __float2bfloat16(v0);
        if (col + 1 < n) orow[col + 1] = __float2bfloat16(v1);
      }
    }
  }
}

template <int BN>
cudaError_t launch_wgmma(const void* x, const void* q, const float* s, const float* b,
                         void* out, int M, int K, int n, int Kp, int Np,
                         cudaStream_t stream) {
  CUtensorMap mx, mq;
  if (!tensor_map_bf16(&mx, x, M, K, K, BM, BK, 128) ||
      !tensor_map_i8(&mq, q, Kp, Np, Np, BK, BN))
    return cudaErrorInvalidValue;
  static std::atomic<uint64_t> smem_set{0};
  const cudaError_t err =
      allow_smem((const void*)quant_matmul_wgmma<BN>, Tile<BN>::SMEM, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + BN - 1) / BN, (M + BM - 1) / BM);
  quant_matmul_wgmma<BN><<<grid, NT, Tile<BN>::SMEM, stream>>>(
      mx, mq, s, b, (__nv_bfloat16*)out, M, K, n);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

extern "C" int quant_matmul(const void* x, const void* q, const float* s,
                            const float* b, void* out, int M, int K, int n,
                            int Kp, int Np, int dtype, void* stream) {
  if (M <= 0 || K <= 0 || n <= 0 || K > Kp || n > Np)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid((n + BN - 1) / BN, (M + BM - 1) / BM);
  if (dtype == sicz::kF32) {
    quant_matmul_kernel<float><<<grid, NT, 0, st>>>(
        (const float*)x, (const int8_t*)q, s, b, (float*)out, M, K, n, Np);
  } else if (dtype == sicz::kBF16) {
    quant_matmul_kernel<__nv_bfloat16><<<grid, NT, 0, st>>>(
        (const __nv_bfloat16*)x, (const int8_t*)q, s, b, (__nv_bfloat16*)out, M, K, n, Np);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The tensor-core route: bf16 x with K a multiple of 8, x and q 16-byte
// aligned (TMA; cudaErrorMisalignedAddress if not), out 4-byte aligned.
// The tile is 128 x 128, or 128 x 64 where 128 x 128 tiles would fill at
// most half the SMs (twice the blocks, half the work a step).  The tensor
// maps come from hopper.cuh's cache of encoded maps.
extern "C" int quant_matmul_wgmma(const void* x, const void* q, const float* s,
                                  const float* b, void* out, int M, int K, int n,
                                  int Kp, int Np, void* stream) {
  if (M <= 0 || K <= 0 || n <= 0 || K > Kp || n > Np || K % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if (!sicz::hopper::aligned16(x) || !sicz::hopper::aligned16(q) || ((uintptr_t)out & 3))
    return (int)cudaErrorMisalignedAddress;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long blocks128 = (long)((n + 127) / 128) * ((M + tc::BM - 1) / tc::BM);
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(2 * blocks128 <= sms
                   ? tc::launch_wgmma<64>(x, q, s, b, out, M, K, n, Kp, Np, st)
                   : tc::launch_wgmma<128>(x, q, s, b, out, M, K, n, Kp, Np, st));
}
