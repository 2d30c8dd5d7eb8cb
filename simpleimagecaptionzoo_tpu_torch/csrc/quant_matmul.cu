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
// rate bounds it, and the int8 weight read is next.  This first kernel
// widens q to float32 in shared memory and multiplies on the CUDA cores
// (67 TFLOP/s peak, at least 144 us at that shape); wgmma with the
// dequantize between the TMA load and the MMA is the step to its bound.
//
// Design: the grid tiles rows (BM) and columns (BN); the shared tile product
// of common.cuh reads x through load_a and q through load_b, which widens
// each int8 with to_f.  On the TPU one block holds all M rows and walks N;
// here the tiles run in parallel and any M, K and n are taken (loads
// outside the operands read 0, stores outside out are skipped).
#include "common.cuh"

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
