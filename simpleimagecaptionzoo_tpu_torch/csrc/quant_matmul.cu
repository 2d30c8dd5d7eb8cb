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
// Three routes, picked by ops/quant.py:quant_route from dtypes, shapes and
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
// 2. float32 x with K a multiple of 4 and 16-byte-aligned x and q:
//    quant_matmul_tf32x2, the float32 tensor-core route (hopper.cuh's
//    tf32x2).  wgmma has no float32 product, and one TF32 product of x
//    (10 mantissa bits) breaks the float32 hold; but q is exact in TF32, so
//    two products, x_lo q + x_hi q (x split in registers), keep float32
//    accuracy.  At the LSTM shape that is 19.3 GFLOP of TF32 against 494.7
//    TFLOP/s, 39.1 us; the 23.6 MB to move (x and out in float32) take 7.1
//    us, so the products bound it.
//    - A block computes 128 rows by 128 columns at every shape (96 blocks
//      at the LSTM shape, 24 and 48 at aoa_dec.q and aoa_dec.aoa; 288, 72
//      and 144 over the beam's 1,152 rows).
//    - The producer warpgroup keeps a ring of 5 stages of 36 KB full: a
//      128 x 32 box of x (float32, 128-byte swizzle), a 32 x 128-byte int8
//      box of q into a staging tile, and the 128 x 32 float32 B tile,
//      K-major (tf32 wgmma takes no other), that the warpgroup transposes
//      and widens the staging tile into (widen_i8_tile_tf32).  The
//      barriers are route 1's.
//    - Two consumer warpgroups, 64 rows each, split their A fragments into
//      TF32 hi and lo (cvt.rna.tf32.f32), run two m64n128k8 tf32 wgmma per
//      k8 step (x_lo q, then x_hi q) into a fresh stage partial, wait for
//      them, free the stage and add the partial into the float32 result.
//    - Epilogue in registers: acc * s[c] + b[c] in float32, pairs of
//      columns stored where c < n; s and b read after the k-loop (the
//      consumers hold 128 floats a thread during it).
// 3. Everything else (shapes or pointers TMA cannot take):
//    quant_matmul_kernel, the CUDA-core route.  The grid tiles rows (BM)
//    and columns (BN); the shared tile product of common.cuh reads x
//    through load_a and q through load_b, which widens each int8 with to_f
//    (fmaf in float32, at least 144 us at the LSTM shape).  Any M, K and n
//    are taken (loads outside the operands read 0, stores outside out are
//    skipped).
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
  static constexpr int SMEM = i8_ring_smem(STAGES, STAGE_BYTES);
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
  const I8Ring ring = i8_ring_init<STAGES, STAGE_BYTES>(smem_raw);
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int nk = (K + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (wg == 2) {
    i8_producer<BM, BK, BN, STAGES>(&map_x, &map_q, ring, row0, col0, nk, threadIdx.x - 256);
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
    mbar_wait(&ring.full[st], ph);     // x's box
    mbar_wait(&ring.ready[st], ph);    // the widened q tile
    const uint8_t* a = ring.stages + st * STAGE_BYTES + wg * 64 * 128;
    const uint8_t* bw = ring.stages + st * STAGE_BYTES + A_BYTES;
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
    if (threadIdx.x % 128 == 0) mbar_arrive(&ring.empty[st]);
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

// ---- route 2: TMA + int8 widening to TF32 + two TF32 wgmma (float32 x) ---------

__global__ void __launch_bounds__(tf32x2::NT, 1)
quant_matmul_tf32x2(const __grid_constant__ CUtensorMap map_x,
                    const __grid_constant__ CUtensorMap map_q,
                    const float* __restrict__ s, const float* __restrict__ b,
                    float* __restrict__ out, int M, int K, int n) {
  extern __shared__ uint8_t smem_raw[];
  const I8Ring r = tf32x2::ring_init(smem_raw);
  const int row0 = blockIdx.y * tf32x2::BM;
  const int col0 = blockIdx.x * tf32x2::BN;
  const int nk = (K + tf32x2::BK - 1) / tf32x2::BK;
  const int wg = threadIdx.x / 128;
  if (wg == 2) {                       // producer: loads and widens
    setmaxnreg_dec<tf32x2::PRODUCER_REGS>();
    tf32x2::produce(r, &map_x, &map_q, row0, col0, nk, threadIdx.x - 256);
  } else {                             // consumers: warpgroup wg takes rows row0 + 64 wg ..
    setmaxnreg_inc<tf32x2::CONSUMER_REGS>();
    float acc[tf32x2::BN / 2];
#pragma unroll
    for (int i = 0; i < tf32x2::BN / 2; ++i) acc[i] = 0.f;
    tf32x2::consume(r, acc, nk, wg);
    // register i: row 16 w + l/4 + 8 ((i/2) % 2), column 8 (i/4) + 2 (l%4) + i%2
    const int l = threadIdx.x % 32;
    const int cq = col0 + 2 * (l % 4);
    const int rbase = row0 + wg * 64 + (threadIdx.x / 32 % 4) * 16 + l / 4;
    const bool pairs = n % 2 == 0;     // (row * n + col) even: float2 stores
#pragma unroll
    for (int jb = 0; jb < tf32x2::BN / 8; ++jb) {
      const int col = cq + 8 * jb;
      if (col >= n) continue;
      const bool two = col + 1 < n;
      const float s0 = __ldg(s + col), b0 = __ldg(b + col);
      const float s1 = two ? __ldg(s + col + 1) : 0.f, b1 = two ? __ldg(b + col + 1) : 0.f;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = rbase + 8 * rr;
        if (row >= M) continue;
        float* const o = out + (size_t)row * n + col;
        const float v0 = fmaf(acc[4 * jb + 2 * rr], s0, b0);
        const float v1 = fmaf(acc[4 * jb + 2 * rr + 1], s1, b1);
        if (pairs) {
          *(float2*)o = make_float2(v0, v1);
        } else {
          o[0] = v0;
          if (two) o[1] = v1;
        }
      }
    }
  }
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

// The float32 tensor-core route (2xTF32): float32 x with K a multiple of 4,
// x and q 16-byte aligned (TMA; cudaErrorMisalignedAddress if not), out
// 8-byte aligned.  The tile is 128 x 128 at every shape; the tensor maps
// come from hopper.cuh's cache of encoded maps.
extern "C" int quant_matmul_tf32x2(const void* x, const void* q, const float* s,
                                   const float* b, void* out, int M, int K, int n,
                                   int Kp, int Np, void* stream) {
  namespace t2 = sicz::hopper::tf32x2;
  if (M <= 0 || K <= 0 || n <= 0 || K > Kp || n > Np || K % 4 != 0)
    return (int)cudaErrorInvalidValue;
  if (!sicz::hopper::aligned16(x) || !sicz::hopper::aligned16(q) || ((uintptr_t)out & 7))
    return (int)cudaErrorMisalignedAddress;
  CUtensorMap mx, mq;
  if (!sicz::hopper::tensor_map_f32(&mx, x, M, K, K, t2::BM) ||
      !sicz::hopper::tensor_map_i8(&mq, q, Kp, Np, Np, t2::BK, t2::BN))
    return (int)cudaErrorInvalidValue;
  static std::atomic<uint64_t> smem_set{0};
  cudaError_t err =
      sicz::hopper::allow_smem((const void*)tc::quant_matmul_tf32x2, t2::SMEM, smem_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + t2::BN - 1) / t2::BN, (M + t2::BM - 1) / t2::BM);
  tc::quant_matmul_tf32x2<<<grid, t2::NT, t2::SMEM, (cudaStream_t)stream>>>(
      mx, mq, s, b, (float*)out, M, K, n);
  return (int)cudaGetLastError();
}
