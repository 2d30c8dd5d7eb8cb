// K2 fused_lstm_cell: one LSTM cell step, torch nn.LSTMCell gate math.
//
// Replaces simpleimagecaptionzoo_tpu/ops/pallas_lstm.py:_kernel_wholerow
// (and its TPU-tiling variants _kernel_tiled and _kernel_gate_tiled, which
// compute the same function), entered through lstm_cell_fused.
//
//   gates = [x, h] @ w_cat + b_sum           (float32 accumulation)
//   i, f, g, o = sigmoid, sigmoid, tanh, sigmoid of the four gate blocks
//   c' = f * c + i * g ;  h' = o * tanh(c')  (float32), cast to the dtype
//
// w_cat is (E + H, 4H) row-major, gates packed i,f,g,o on the columns;
// b_sum is (4H,).  All tensors share one dtype, float32 or bf16.
//
// What bounds it on an H100 SXM at the decode shape (B=384, E=2048,
// H=1024, bf16): 9.66 GFLOP against 989 TFLOP/s of bf16 tensor cores is
// 9.8 us; the 25.2 MB of w_cat against 3.35 TB/s is 7.5 us.  So the product
// bounds it.  This first kernel multiplies on the CUDA cores in float32
// (67 TFLOP/s peak), so it cannot come closer than about 144 us; moving the
// product onto wgmma is the next step for speed (PERF.md).
//
// Design: the grid tiles rows (BM) and hidden columns (BH).  A block's
// output tile holds, for hidden columns j..j+BH, the four gate columns j,
// H+j, 2H+j and 3H+j, so the epilogue finishes c' and h' in registers and
// the (B, 4H) gate block never reaches device memory.  x and h are read
// through two pointers (k < E reads x, k >= E reads h), so [x, h] is never
// concatenated in memory.  K, B and H may be ragged: loads outside the
// operands read 0 and stores outside the outputs are skipped.
#include "common.cuh"

namespace {

using namespace sicz;

constexpr int BM = 64;        // rows of a block tile
constexpr int BH = 32;        // hidden columns of a block tile
constexpr int BN = 4 * BH;    // gate columns of a block tile
constexpr int BK = 32;
constexpr int TM = 4;
constexpr int TN = 8;         // 4 gates x 2 hidden columns per thread
constexpr int CX = BN / TN;   // 16 threads across
constexpr int NT = (BM / TM) * CX;
static_assert(NT == 256, "block of 256 threads");
static_assert(CX * 2 == BH, "a thread's two hidden columns are tx, tx + CX");

__device__ __forceinline__ float sigmoidf_(float z) { return 1.f / (1.f + expf(-z)); }

template <typename T>
__global__ void __launch_bounds__(NT)
lstm_cell_kernel(const T* __restrict__ x, const T* __restrict__ h,
                 const T* __restrict__ c, const T* __restrict__ w,
                 const T* __restrict__ b, T* __restrict__ h_out,
                 T* __restrict__ c_out, int B, int E, int H) {
  __shared__ float As[BK * (BM + 1)];
  __shared__ float Bs[BK * BN];
  const int row0 = blockIdx.y * BM;
  const int j0 = blockIdx.x * BH;
  const int ktot = E + H;
  const size_t n4 = 4 * (size_t)H;

  auto load_a = [&](int r, int k) -> float {
    const int row = row0 + r;
    if (row >= B || k >= ktot) return 0.f;
    return k < E ? to_f(x[(size_t)row * E + k]) : to_f(h[(size_t)row * H + (k - E)]);
  };
  auto load_b = [&](int k, int n) -> float {
    const int gate = n / BH, j = j0 + n % BH;
    if (k >= ktot || j >= H) return 0.f;
    return to_f(w[(size_t)k * n4 + (size_t)gate * H + j]);
  };
  float acc[TM][TN];
  tile_gemm<BM, BN, BK, TM, TN>(acc, ktot, load_a, load_b, As, Bs);

  // thread column n = tx + CX*jn holds gate jn/2 of hidden column
  // j0 + tx + CX*(jn%2)
  const int tx = threadIdx.x % CX, ty = threadIdx.x / CX;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = row0 + ty * TM + i;
    if (row >= B) continue;
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int j = j0 + tx + CX * jj;
      if (j >= H) continue;
      const float zi = acc[i][0 + jj] + to_f(b[j]);
      const float zf = acc[i][2 + jj] + to_f(b[H + j]);
      const float zg = acc[i][4 + jj] + to_f(b[2 * H + j]);
      const float zo = acc[i][6 + jj] + to_f(b[3 * H + j]);
      const size_t o = (size_t)row * H + j;
      const float cn = sigmoidf_(zf) * to_f(c[o]) + sigmoidf_(zi) * tanhf(zg);
      const float hn = sigmoidf_(zo) * tanhf(cn);
      h_out[o] = from_f<T>(hn);
      c_out[o] = from_f<T>(cn);
    }
  }
}

template <typename T>
void launch(const void* x, const void* h, const void* c, const void* w,
            const void* b, void* h_out, void* c_out, int B, int E, int H,
            cudaStream_t stream) {
  dim3 grid((H + BH - 1) / BH, (B + BM - 1) / BM);
  lstm_cell_kernel<T><<<grid, NT, 0, stream>>>(
      (const T*)x, (const T*)h, (const T*)c, (const T*)w, (const T*)b,
      (T*)h_out, (T*)c_out, B, E, H);
}

}  // namespace

extern "C" int fused_lstm_cell(const void* x, const void* h, const void* c,
                               const void* w_cat, const void* b_sum,
                               void* h_out, void* c_out, int B, int E, int H,
                               int dtype, void* stream) {
  if (B <= 0 || E < 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == sicz::kF32) {
    launch<float>(x, h, c, w_cat, b_sum, h_out, c_out, B, E, H, s);
  } else if (dtype == sicz::kBF16) {
    launch<__nv_bfloat16>(x, h, c, w_cat, b_sum, h_out, c_out, B, E, H, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
