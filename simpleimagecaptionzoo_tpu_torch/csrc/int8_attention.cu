// K4 int8_attention: masked softmax attention over int8 K/V with per-row
// scales, and the mean over heads of the attention.
//
// Replaces simpleimagecaptionzoo_tpu/ops/int8_attention.py:_kernel (launched
// through lanes_attention_int8).  Per sample b, head h, query row i:
//
//   scores[n] = (q[i, h] . kq[n, h]) * ks[n] / sqrt(dh)     float32
//   scores[n] = -1e9 where mask[n] <= 0
//   p         = softmax(scores) = exp(scores - max) / sum
//   out[i, h] = sum_n (p[n] * vs[n]) * vq[n, h]              in q's type
//   pmean[i]  = sum_h p / heads                              float32
//
// q (B, k, D) is float32 or bf16; kq and vq (B, N, D) are int8; ks, vs and
// mask (B, N) are float32.  D = heads * dh with dh a multiple of 128;
// k <= 16, N <= 2048.
//
// What bounds it on an H100 SXM at the greedy shape (B=384, k=1, N=36,
// D=1024, bf16 q): 56.6 MFLOP is nothing; the 30.1 MB it must move (the
// 28.3 MB of int8 K and V, q, out, the scales and mask) against 3.35 TB/s
// is 9.0 us.  So the bytes bound it, and the int8 K/V read is nearly all
// of them.
//
// Design.  On the TPU the head is a sequential grid axis, and pmean is
// carried across it in the output block.  Hopper blocks run in no order,
// so one block takes one sample and loops over the heads itself: for each
// head it widens that head's q rows into shared memory, computes the
// scores (a warp per key row, each lane reading 4 int8 of K at a time),
// masks and softmaxes them (a warp per query row), writes out (a thread
// per (row, column)), and adds p / heads to a pmean tile in shared memory,
// which it writes once after the last head.  No atomics, so every run
// gives the same bits.  Query rows go in chunks of kc rows so that the
// shared memory (kc * (dh + 2N) floats) stays within the default 48 KB;
// at the decode shapes one chunk takes every row.
#include <math.h>

#include <algorithm>

#include "common.cuh"

namespace {

using namespace sicz;

constexpr int NT = 256;
constexpr int NWARP = NT / 32;
constexpr int SMEM_FLOATS = 48 * 1024 / 4;
constexpr int KMAX = 16;
constexpr int NMAX = 2048;
constexpr float NEG = -1e9f;

template <typename T>
__global__ void __launch_bounds__(NT)
int8_attention_kernel(const T* __restrict__ q, const int8_t* __restrict__ kq,
                      const float* __restrict__ ks, const int8_t* __restrict__ vq,
                      const float* __restrict__ vs, const float* __restrict__ mask,
                      T* __restrict__ out, float* __restrict__ pmean, int k, int N,
                      int D, int heads, int kc, float inv_sqrt_dh) {
  extern __shared__ float smem[];
  const int dh = D / heads;
  float* qs = smem;               // kc * dh: this head's query rows, widened
  float* sc = qs + kc * dh;       // kc * N: scores, then p * vs
  float* pm = sc + kc * N;        // kc * N: sum over heads of p / heads
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const size_t b = blockIdx.x;
  const int8_t* kq_b = kq + b * N * D;
  const int8_t* vq_b = vq + b * N * D;
  const float* ks_b = ks + b * N;
  const float* vs_b = vs + b * N;
  const float* mask_b = mask + b * N;

  for (int i0 = 0; i0 < k; i0 += kc) {
    const int rows = min(kc, k - i0);
    for (int e = tid; e < rows * N; e += NT) pm[e] = 0.f;
    for (int h = 0; h < heads; ++h) {
      const int c0 = h * dh;
      for (int e = tid; e < rows * dh; e += NT)
        qs[e] = to_f(q[(b * k + i0 + e / dh) * D + c0 + e % dh]);
      __syncthreads();
      for (int n = warp; n < N; n += NWARP) {          // warp-uniform loop
        const int8_t* krow = kq_b + (size_t)n * D + c0;
        const bool valid = mask_b[n] > 0.f;
        for (int i = 0; i < rows; ++i) {
          const float* qr = qs + i * dh;
          float part = 0.f;
          for (int d = 4 * lane; d < dh; d += 128) {
            const char4 kv = *reinterpret_cast<const char4*>(krow + d);
            part = fmaf(qr[d], (float)kv.x, part);
            part = fmaf(qr[d + 1], (float)kv.y, part);
            part = fmaf(qr[d + 2], (float)kv.z, part);
            part = fmaf(qr[d + 3], (float)kv.w, part);
          }
          part = warp_sum(part);
          if (lane == 0) sc[i * N + n] = valid ? part * ks_b[n] * inv_sqrt_dh : NEG;
        }
      }
      __syncthreads();
      for (int i = warp; i < rows; i += NWARP) {       // softmax, a warp per row
        float* r = sc + i * N;
        float mx = -INFINITY;
        for (int n = lane; n < N; n += 32) mx = fmaxf(mx, r[n]);
        mx = warp_max(mx);
        float sum = 0.f;
        for (int n = lane; n < N; n += 32) {
          const float e = expf(r[n] - mx);
          r[n] = e;
          sum += e;
        }
        sum = warp_sum(sum);
        for (int n = lane; n < N; n += 32) {
          const float p = r[n] / sum;
          pm[i * N + n] += p / heads;
          r[n] = p * vs_b[n];
        }
      }
      __syncthreads();
      for (int e = tid; e < rows * dh; e += NT) {
        const int i = e / dh, d = e % dh;
        const float* pr = sc + i * N;
        const int8_t* vcol = vq_b + c0 + d;
        float acc = 0.f;
        for (int n = 0; n < N; ++n) acc = fmaf(pr[n], (float)vcol[(size_t)n * D], acc);
        out[(b * k + i0 + i) * D + c0 + d] = from_f<T>(acc);
      }
      __syncthreads();
    }
    for (int e = tid; e < rows * N; e += NT) pmean[(b * k + i0) * N + e] = pm[e];
    __syncthreads();
  }
}

}  // namespace

extern "C" int int8_attention(const void* q, const void* kq, const float* ks,
                              const void* vq, const float* vs, const float* mask,
                              void* out, float* pmean, int B, int k, int N, int D,
                              int heads, float inv_sqrt_dh, int dtype, void* stream) {
  if (B <= 0 || k < 1 || k > KMAX || N < 1 || N > NMAX || heads <= 0 || D % heads ||
      (D / heads) % 128)
    return (int)cudaErrorInvalidValue;
  const int dh = D / heads;
  const int kc = std::min(k, SMEM_FLOATS / (dh + 2 * N));
  if (kc < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kc * (dh + 2 * N) * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == sicz::kF32) {
    int8_attention_kernel<float><<<B, NT, smem, st>>>(
        (const float*)q, (const int8_t*)kq, ks, (const int8_t*)vq, vs, mask, (float*)out,
        pmean, k, N, D, heads, kc, inv_sqrt_dh);
  } else if (dtype == sicz::kBF16) {
    int8_attention_kernel<__nv_bfloat16><<<B, NT, smem, st>>>(
        (const __nv_bfloat16*)q, (const int8_t*)kq, ks, (const int8_t*)vq, vs, mask,
        (__nv_bfloat16*)out, pmean, k, N, D, heads, kc, inv_sqrt_dh);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
