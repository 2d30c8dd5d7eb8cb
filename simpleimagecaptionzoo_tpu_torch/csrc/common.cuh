// Shared pieces of the port's CUDA kernels: element conversion (float32,
// bf16 and int8 to float32, exact), warp reductions, and one shared-memory
// tiled product with float32 accumulation.
//
// The tile product is the plain CUDA-core form (fmaf on float32 operands
// staged in shared memory).  It is exact in its float32 accumulation for
// float32, bf16 and int8 operands.  The kernels' tensor-core routes
// (hopper.cuh) take bf16 x; this one stays for float32 and for operands
// TMA cannot take.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sicz {

enum Dtype : int { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(int8_t v) { return (float)v; }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// max and sum across the 32 lanes of a warp; every lane gets the result
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// acc[i][j] += sum_k A(r, k) * B(k, n) over k in [0, K) for the block tile
// of BM rows by BN columns.  Thread t owns rows ty*TM + i and columns
// tx + j*(BN/TN), with tx = t % (BN/TN), ty = t / (BN/TN), so neighbouring
// threads read neighbouring columns of the B stage.  load_a(r, k) takes a
// local row and a global k, load_b(k, n) a global k and a local column;
// both return 0 outside the operand (ragged rows, columns and K).
// As holds BK*(BM+1) floats (A stored k-major, padded against bank
// conflicts), Bs holds BK*BN floats.  Every thread of the block must call.
template <int BM, int BN, int BK, int TM, int TN, typename LoadA, typename LoadB>
__device__ __forceinline__ void tile_gemm(float (&acc)[TM][TN], int K,
                                          LoadA load_a, LoadB load_b,
                                          float* As, float* Bs) {
  constexpr int CX = BN / TN;
  constexpr int NT = (BM / TM) * CX;
  const int tid = threadIdx.x;
  const int tx = tid % CX, ty = tid / CX;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < BM * BK; e += NT) {
      const int r = e / BK, kk = e % BK;
      As[kk * (BM + 1) + r] = load_a(r, k0 + kk);
    }
    for (int e = tid; e < BK * BN; e += NT) {
      const int kk = e / BN, n = e % BN;
      Bs[kk * BN + n] = load_b(k0 + kk, n);
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk * (BM + 1) + ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk * BN + tx + j * CX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

}  // namespace sicz
