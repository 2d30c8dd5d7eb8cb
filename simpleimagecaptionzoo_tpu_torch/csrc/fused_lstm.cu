// K2 fused_lstm_cell: one LSTM cell step, torch nn.LSTMCell gate math.
//
// Replaces simpleimagecaptionzoo_tpu/ops/pallas_lstm.py:166 _kernel_wholerow
// (and its TPU-tiling variants _kernel_gate_tiled at :207 and _kernel_tiled
// at :252, which compute the same function), entered through
// lstm_cell_fused.
//
//   gates = [x, h] @ w_cat + b_sum           (float32 accumulation)
//   i, f, g, o = sigmoid, sigmoid, tanh, sigmoid of the four gate blocks
//   c' = f * c + i * g ;  h' = o * tanh(c')  (float32), cast to the dtype
//
// w_cat is (E + H, 4H) row-major, gates packed i,f,g,o on the columns;
// b_sum is (4H,).  All tensors share one dtype, float32 or bf16.
//
// What bounds it on an H100 SXM at the decode shape (B=384, E=2048,
// H=1024): in bf16, 9.66 GFLOP against 989 TFLOP/s of bf16 tensor cores is
// 9.8 us; the 25.2 MB of w_cat against 3.35 TB/s is 7.5 us.  In float32,
// three TF32 products of that size (29.0 GFLOP) against 494.7 TFLOP/s are
// 58.6 us; the 50.3 MB of w_cat 15.0 us.  So the product bounds it.
//
// The float32 products are float32-accurate on every route: route 2 runs
// 3xTF32 (hopper.cuh), route 3 float32 fmaf, and the plain version on the
// card float32 with TF32 off.
//
// Three routes, picked by ops/fused_lstm.py:lstm_route from dtypes, shapes
// and alignment:
//
// 1. bf16 with E and H multiples of 8 and 16-byte-aligned x, h and w_cat:
//    lstm_cell_wgmma, the tensor-core route (csrc/hopper.cuh).
//    - A block computes 128 rows by BH = 32 hidden columns, i.e. a 128 x 128
//      tile of gate columns j0.., H+j0.., 2H+j0.., 3H+j0.. .  At B=384 that
//      is 3 x 32 = 96 blocks, one wave on 96 of the 132 SMs; at the beam
//      shape B=1,152, 288 blocks, 2.2 waves.
//    - One producer warp keeps a ring of 3 stages of 64 KB full with TMA:
//      per stage two 128 x 64 boxes of x or h (128-byte swizzle; 128 values
//      of K) and four 128 x 32 boxes of w_cat, one per gate at columns
//      gate*H + j0 (64-byte swizzle).  Deep stages halve the barrier,
//      commit and release round trips per product against 64-value
//      stages.  [x, h] is never concatenated: the k-loop runs ceil(E/128)
//      steps over x (w_cat rows k0..) and then ceil(H/128) over h (rows
//      E + k0..).  A step that straddles E reads w_cat rows of h, but x's
//      zero fill past column E multiplies them by 0.
//    - Each block loads its own w_cat boxes: the row tiles of a hidden tile
//      read the same boxes at about the same time, so HBM serves w_cat once
//      and L2 the rest (151 MB of L2 reads a call at B=384).
//    - Two consumer warpgroups, 64 rows each, issue eight m64n128k16 bf16
//      wgmma per stage, wait for them (wgmma.wait_group 0) and free the
//      stage at once, so two of the three buffers are loading while one is
//      multiplied; the other warpgroup's products keep the tensor cores
//      busy meanwhile.
//    - Epilogue in registers: in the wgmma fragment a thread that holds
//      gate column n also holds n + 32, n + 64 and n + 96 (the fragment
//      repeats every 8 columns), i.e. the i, f, g and o pre-activations of
//      one hidden column.  So bias, sigmoid/tanh, c' and h' are finished
//      where the product ends and the (B, 4H) gates never reach memory.
//      The epilogue's operands (the four gate biases and c of the thread's
//      columns) are loaded before the k-loop, so their latency hides
//      behind the products.
//    Host side: three TMA tensor maps per call, from hopper.cuh's cache of
//    encoded maps (w_cat's is encoded once; x's and h's when their buffers
//    move).
//
// 2. float32 with E and H multiples of 4 and 16-byte-aligned x, h, w_hi and
//    w_lo: lstm_cell_tf32x3, the tensor-core route for float32.  wgmma has
//    no float32 product and plain TF32 keeps 10 mantissa bits, too few for
//    the float32 hold (1e-5) and the float32 decode's identical rows; so
//    the gates are three TF32 products, a_lo w_hi + a_hi w_lo + a_hi w_hi,
//    on hopper.cuh's tf32x3 pipeline.  w_hi and w_lo are w_cat split and
//    transposed once per decode (ops/tf32.py: (4H, E+H), K-major, which
//    tf32 wgmma requires); x and h are split in registers.
//    - The tile and grid of route 1: 128 rows by BH = 32 hidden columns,
//      the weight tile four 32-row boxes of w_hi and w_lo at rows
//      gate*H + j0; 96 blocks at B=384, 288 at B=1,152.
//    - A stage is 32 values of K (128 bytes of float32): A 16 KB + w_hi and
//      w_lo 16 KB each; a ring of 4.  The k-loop runs over x and then h.
//    - Each consumer warpgroup issues 12 m64n128k8 tf32 wgmma a stage (three
//      per k8) into a partial, frees the stage when they are done and adds
//      the partial into its float32 result; a producer warpgroup (one
//      thread loads) gives its registers to the consumers (setmaxnreg).
//    - The epilogue is route 1's on float32 pairs, its operands loaded after
//      the k-loop: held through it beside the result and the partial they
//      made ptxas spill 184 bytes, and the kernel 19 % slower (0.1324
//      against 0.1074 ms at B=384 on the H100, chip_smoke.py).
// 3. Everything else (bf16 or float32 shapes or pointers TMA cannot take):
//    lstm_cell_kernel, the CUDA-core route.  The grid tiles rows (BM) and
//    hidden columns (BH) with the same gate grouping and epilogue, on
//    common.cuh's tile product (fmaf in float32, at least 144 us at the
//    decode shape).  K, B and H may be ragged: loads outside the operands
//    read 0 and stores outside the outputs are skipped.
//
// The backward (fused_lstm_cell_bwd*): the JAX package's custom VJP of the
// cell (pallas_lstm.py:445-491 _cell_bwd, jnp around the Pallas forward)
// recomputes the gates with one product of the forward's shape, forms the
// gate gradients elementwise, and finishes with three plain products
// (dxh = d_gates W^T, dW = [x, h]^T d_gates, db = sum d_gates).  Here the
// recompute and the gate gradients are one kernel: each route above runs
// its own product on its own tiles, and its epilogue (BWD = true) takes
// dh' and dc' of the thread's rows and columns (a null cotangent reads as
// zero) beside c and the biases, and writes, in place of h' and c',
//
//   dc_total = dc' + dh' o (1 - tanh(c')^2)
//   d_gates  = [dc_total g i (1-i), dc_total c f (1-f),
//               dc_total i (1-g^2), dh' tanh(c') o (1-o)]   (float32)
//   dc       = dc_total f                                 (c's dtype)
//
// so the (B, 4H) gates never reach memory; d_gates does, in float32, and
// beside it, when the whole backward runs on the tensor cores, the
// operands of its products (csrc/lstm_bwd.cu): route 1 writes d_hi =
// bf16(d) and d_lo = bf16(d - d_hi) (B, 4H), route 2 d^T's TF32 parts
// (4H, B rounded up to 4), the layout the dW product's K-major operand
// needs.  On the CUDA-core route the products stay float32 torch.matmul
// calls (ops/fused_lstm.py), as the JAX package leaves them to XLA.  The
// recompute is in float32 as the forward's epilogue is (in bf16 the JAX
// package's recompute rounds the gates to bf16 first).  Bound: the
// forward's product, plus d_gates and the operands written: at the
// training shape (B=128, E=2048, H=1024) 3.22 GFLOP against 25.2 MB of
// w_cat in bf16 (bytes), three times the operations at the 3xTF32 rate in
// float32 (operations).
#include "common.cuh"
#include "hopper.cuh"

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

// The epilogue's tensors.  The forward reads c and b and writes h' and c';
// the backward reads c, b and the cotangents dh' and dc' (null: zero, a
// cotangent autograd did not form), and writes d_gates and dc, and, when
// the whole backward runs on the tensor cores, d_gates again in the form
// its products load (csrc/lstm_bwd.cu): in bf16 its two bf16 parts, in
// float32 its transpose's two TF32 parts.
template <typename T>
struct Epi {
  const T* c;          // (B, H)
  const T* b;          // (4H,)
  T* h_out;            // forward: h' (B, H)
  T* c_out;            // forward: c' (B, H)
  const T* dh;         // backward: the cotangent of h' (B, H), or null
  const T* dc;         // backward: the cotangent of c' (B, H), or null
  float* d_gates;      // backward: (B, 4H) float32, gates i, f, g, o
  T* dc_out;           // backward: the cotangent of c (B, H)
  __nv_bfloat16* d_hi; // backward, route 1, or null: bf16(d_gates) (B, 4H)
  __nv_bfloat16* d_lo; //   and bf16(d_gates - d_hi)
  float* dt_hi;        // backward, route 2, or null: rna_tf32(d_gates^T)
  float* dt_lo;        //   and rna_tf32(d_gates^T - dt_hi), (4H, dt_pitch)
  int dt_pitch;        //   row pitch of dt_hi and dt_lo, >= B
};

// one hidden column of the cell, float32: the forward's (h', c')
__device__ __forceinline__ void cell_fwd(float zi, float zf, float zg, float zo, float c,
                                         float& hn, float& cn) {
  cn = sigmoidf_(zf) * c + sigmoidf_(zi) * tanhf(zg);
  hn = sigmoidf_(zo) * tanhf(cn);
}

// ... and the backward's gate gradients dz (i, f, g, o) and dc
struct CellGrad {
  float dz[4];
  float dc;
};

__device__ __forceinline__ CellGrad cell_bwd(float zi, float zf, float zg, float zo,
                                             float c, float dh, float dc) {
  const float i = sigmoidf_(zi), f = sigmoidf_(zf), g = tanhf(zg), o = sigmoidf_(zo);
  const float tc = tanhf(f * c + i * g);
  const float dct = dc + dh * o * (1.f - tc * tc);
  CellGrad r;
  r.dz[0] = dct * g * i * (1.f - i);
  r.dz[1] = dct * c * f * (1.f - f);
  r.dz[2] = dct * i * (1.f - g * g);
  r.dz[3] = dh * tc * o * (1.f - o);
  r.dc = dct * f;
  return r;
}

template <typename T, bool BWD>
__global__ void __launch_bounds__(NT)
lstm_cell_kernel(const T* __restrict__ x, const T* __restrict__ h,
                 const T* __restrict__ w, const Epi<T> ep, int B, int E, int H) {
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
      const float zi = acc[i][0 + jj] + to_f(ep.b[j]);
      const float zf = acc[i][2 + jj] + to_f(ep.b[H + j]);
      const float zg = acc[i][4 + jj] + to_f(ep.b[2 * H + j]);
      const float zo = acc[i][6 + jj] + to_f(ep.b[3 * H + j]);
      const size_t o = (size_t)row * H + j;
      if constexpr (BWD) {
        const CellGrad gr = cell_bwd(zi, zf, zg, zo, to_f(ep.c[o]),
                                     ep.dh ? to_f(ep.dh[o]) : 0.f,
                                     ep.dc ? to_f(ep.dc[o]) : 0.f);
        float* const dg = ep.d_gates + (size_t)row * n4 + j;
#pragma unroll
        for (int q = 0; q < 4; ++q) dg[(size_t)q * H] = gr.dz[q];
        ep.dc_out[o] = from_f<T>(gr.dc);
      } else {
        float hn, cn;
        cell_fwd(zi, zf, zg, zo, to_f(ep.c[o]), hn, cn);
        ep.h_out[o] = from_f<T>(hn);
        ep.c_out[o] = from_f<T>(cn);
      }
    }
  }
}

// ---- route 1: TMA + wgmma (bf16) -------------------------------------------

namespace tc {

using namespace sicz::hopper;

constexpr int BM = 128;              // rows: two consumer warpgroups of 64
constexpr int BH = 32;               // hidden columns of a block tile
constexpr int BN = 4 * BH;           // gate columns of a block tile (wgmma N)
constexpr int BK = 128;              // K per stage: two x or h boxes
constexpr int STAGES = 3;
constexpr int SWB = 2 * BH;          // bytes of a w_cat box row: the 64-byte swizzle
constexpr int A_BOX = BM * 64 * 2;   // one x or h box: 64 values (128 bytes) a row
constexpr int A_BYTES = (BK / 64) * A_BOX;
constexpr int B_BOX = BK * SWB;      // one gate's box
constexpr int B_BYTES = 4 * B_BOX;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int NT = 2 * 128 + 32;     // two consumer warpgroups, one producer warp
constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8;
static_assert(SWB == 64, "the w_cat boxes use the 64-byte swizzle");

// Two neighbouring elements (hidden columns j, j + 1) of T: one bf16x2
// word or one float2.
template <typename T> struct Pair;

template <> struct Pair<__nv_bfloat16> {
  using Raw = uint32_t;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return __ldg((const unsigned int*)p);
  }
  static __device__ __forceinline__ float2 get(Raw v) {
    return __bfloat1622float2(*(const __nv_bfloat162*)&v);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float a, float b) {
    *(__nv_bfloat162*)p = __floats2bfloat162_rn(a, b);
  }
};

template <> struct Pair<float> {
  using Raw = float2;
  static __device__ __forceinline__ Raw load(const float* p) { return __ldg((const float2*)p); }
  static __device__ __forceinline__ float2 get(Raw v) { return v; }
  static __device__ __forceinline__ void store(float* p, float a, float b) {
    *(float2*)p = make_float2(a, b);
  }
};

// The epilogue's operands: for this thread's hidden columns j, j+1 (one
// pair each) the four gate biases, and c of its two rows (0 outside).
// The backward's dh' and dc' are read in the epilogue (below).
template <typename T>
struct EpiIn {
  typename Pair<T>::Raw bias[4][4];    // [gate][jj]
  typename Pair<T>::Raw c[2][4];       // [r][jj]
};

// register i of the accumulator holds row 16 w + l/4 + 8 ((i/2) % 2) and
// gate column 8 (i/4) + 2 (l%4) + i%2, i.e. gate (i/4) / 4 and hidden
// column 8 ((i/4) % 4) + 2 (l%4) + i%2; rows from r64 on, hidden columns
// from j0 on
template <typename T>
__device__ __forceinline__ void epilogue_load(EpiIn<T>& in, const Epi<T>& ep, int B, int H,
                                              int r64, int j0) {
  using P = Pair<T>;
  using Raw = typename P::Raw;
  const int l = threadIdx.x % 32;
  const int rbase = r64 + (threadIdx.x / 32 % 4) * 16 + l / 4;
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    const int j = j0 + 8 * jj + 2 * (l % 4);   // even; H is even, so j + 1 < H too
    const bool jin = j < H;
#pragma unroll
    for (int g = 0; g < 4; ++g) in.bias[g][jj] = jin ? P::load(ep.b + g * H + j) : Raw{};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = rbase + 8 * r;
      in.c[r][jj] = jin && row < B ? P::load(ep.c + (size_t)row * H + j) : Raw{};
    }
  }
}

// h' and c' (the backward: d_gates and dc) of the warpgroup's 64 rows and
// 32 hidden columns
template <typename T, bool BWD>
__device__ __forceinline__ void epilogue(const float (&acc)[BN / 2], const EpiIn<T>& in,
                                         const Epi<T>& ep, int B, int H, int r64, int j0) {
  using P = Pair<T>;
  using Raw = typename P::Raw;
  const int l = threadIdx.x % 32;
  const int rbase = r64 + (threadIdx.x / 32 % 4) * 16 + l / 4;
  // The backward's dh' and dc': route 2 (float32) requests all of the
  // thread's pairs together, ahead of the arithmetic (read pair by pair
  // its backward took 0.140 ms against 0.108 at B=128); route 1 (bf16)
  // reads them pair by pair (held together from before or after the
  // k-loop, ptxas spilled 28 or 46 bytes there; this way 150 registers
  // and no spill).
  constexpr bool grads_ahead = BWD && sizeof(T) == 4;
  Raw gdh[2][4], gdc[2][4];
  if constexpr (grads_ahead) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int row = rbase + 8 * r, j = j0 + 8 * jj + 2 * (l % 4);
        const size_t o = (size_t)row * H + j;
        const bool in_ = row < B && j < H;
        gdh[r][jj] = in_ && ep.dh ? P::load(ep.dh + o) : Raw{};
        gdc[r][jj] = in_ && ep.dc ? P::load(ep.dc + o) : Raw{};
      }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = rbase + 8 * r;
    if (row >= B) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = j0 + 8 * jj + 2 * (l % 4);
      if (j >= H) continue;
      const float2 bi = P::get(in.bias[0][jj]), bf = P::get(in.bias[1][jj]);
      const float2 bg = P::get(in.bias[2][jj]), bo = P::get(in.bias[3][jj]);
      const float2 cv = P::get(in.c[r][jj]);
      const int i0 = 4 * jj + 2 * r;           // gate 0's registers: i0, i0 + 1
      const size_t o = (size_t)row * H + j;
      if constexpr (BWD) {
        const float2 dhv = P::get(grads_ahead ? gdh[r][jj]
                                  : ep.dh ? P::load(ep.dh + o) : Raw{});
        const float2 dcv = P::get(grads_ahead ? gdc[r][jj]
                                  : ep.dc ? P::load(ep.dc + o) : Raw{});
        CellGrad gr[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          gr[e] = cell_bwd(acc[i0 + e] + (e ? bi.y : bi.x), acc[i0 + e + 16] + (e ? bf.y : bf.x),
                           acc[i0 + e + 32] + (e ? bg.y : bg.x),
                           acc[i0 + e + 48] + (e ? bo.y : bo.x), e ? cv.y : cv.x,
                           e ? dhv.y : dhv.x, e ? dcv.y : dcv.x);
        float* const dg = ep.d_gates + (size_t)row * 4 * H + j;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          *(float2*)(dg + (size_t)q * H) = make_float2(gr[0].dz[q], gr[1].dz[q]);
        P::store(ep.dc_out + o, gr[0].dc, gr[1].dc);
        if constexpr (sizeof(T) == 2) {
          // the products' bf16 operands: d = d_hi + d_lo within 2^-16 |d|
          if (ep.d_hi != nullptr) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const __nv_bfloat162 hi = __floats2bfloat162_rn(gr[0].dz[q], gr[1].dz[q]);
              const float2 hf = __bfloat1622float2(hi);
              const size_t at = (size_t)row * 4 * H + (size_t)q * H + j;
              *(__nv_bfloat162*)(ep.d_hi + at) = hi;
              *(__nv_bfloat162*)(ep.d_lo + at) =
                  __floats2bfloat162_rn(gr[0].dz[q] - hf.x, gr[1].dz[q] - hf.y);
            }
          }
        } else {
          // the dW product's K-major TF32 operand: d^T, split as the
          // forward splits x (cvt.rna.tf32.f32)
          if (ep.dt_hi != nullptr) {
#pragma unroll
            for (int q = 0; q < 4; ++q)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float v = gr[e].dz[q];
                const uint32_t hi = rna_tf32(v);
                const size_t at = ((size_t)q * H + j + e) * ep.dt_pitch + row;
                ep.dt_hi[at] = __uint_as_float(hi);
                ep.dt_lo[at] = __uint_as_float(rna_tf32(v - __uint_as_float(hi)));
              }
          }
        }
      } else {
        float hn[2], cn[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          cell_fwd(acc[i0 + e] + (e ? bi.y : bi.x), acc[i0 + e + 16] + (e ? bf.y : bf.x),
                   acc[i0 + e + 32] + (e ? bg.y : bg.x), acc[i0 + e + 48] + (e ? bo.y : bo.x),
                   e ? cv.y : cv.x, hn[e], cn[e]);
        P::store(ep.h_out + o, hn[0], hn[1]);
        P::store(ep.c_out + o, cn[0], cn[1]);
      }
    }
  }
}

template <bool BWD>
__global__ void __launch_bounds__(NT, 1)
lstm_cell_wgmma(const __grid_constant__ CUtensorMap map_x,
                const __grid_constant__ CUtensorMap map_h,
                const __grid_constant__ CUtensorMap map_w, const Epi<__nv_bfloat16> ep,
                int B, int E, int H) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const sa = smem_1024(smem_raw);
  uint8_t* const sb = sa + STAGES * A_BYTES;
  uint64_t* const full = (uint64_t*)(sb + STAGES * B_BYTES);
  uint64_t* const empty = full + STAGES;
  const int row0 = blockIdx.y * BM;
  const int j0 = blockIdx.x * BH;
  const int nkx = (E + BK - 1) / BK;
  const int nk = nkx + (H + BK - 1) / BK;
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);          // the producer's expect-tx arrival
      mbar_init(&empty[s], 2);         // one arrival per consumer warpgroup
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 8) {                     // producer
    if (threadIdx.x % 32 == 0) {
      for (int t = 0; t < nk; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) mbar_wait(&empty[s], ((t / STAGES) - 1) & 1);
        mbar_expect_tx(&full[s], STAGE_BYTES);
        const bool xs = t < nkx;
        const int k0 = (xs ? t : t - nkx) * BK;
#pragma unroll
        for (int q = 0; q < BK / 64; ++q)
          tma_load_2d(sa + s * A_BYTES + q * A_BOX, xs ? &map_x : &map_h, k0 + 64 * q,
                      row0, &full[s]);
        const int krow = xs ? k0 : E + k0;
#pragma unroll
        for (int g = 0; g < 4; ++g)
          tma_load_2d(sb + s * B_BYTES + g * B_BOX, &map_w, g * H + j0, krow, &full[s]);
      }
    }
  } else {                             // consumers: warpgroup wg takes rows row0 + 64 wg ..
    const int wg = warp / 4;
    EpiIn<__nv_bfloat16> in;
    epilogue_load(in, ep, B, H, row0 + wg * 64, j0);
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int t = 0; t < nk; ++t) {
      const int s = t % STAGES;
      mbar_wait(&full[s], (t / STAGES) & 1);
      const uint8_t* a = sa + s * A_BYTES + wg * 64 * 128;
      const uint8_t* bw = sb + s * B_BYTES;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_m64n128k16(acc, desc_a(a + kk / 4 * A_BOX + kk % 4 * 32),
                         desc_b<SWB>(bw + kk * 16 * SWB, B_BOX), 1);
      wgmma_commit();
      fence_regs(acc);
      // free the stage as soon as its products are done: with 3 stages,
      // holding it over the next step would leave one buffer for loads
      wgmma_wait<0>();
      if (threadIdx.x % 128 == 0) mbar_arrive(&empty[s]);
    }
    fence_regs(acc);
    epilogue<__nv_bfloat16, BWD>(acc, in, ep, B, H, row0 + wg * 64, j0);
  }
}

// ---- route 2: TMA + 3xTF32 wgmma (float32) -----------------------------------

static_assert(tf32x3::BN == BN && tf32x3::BM == BM,
              "route 2 keeps route 1's tile and epilogue");

template <bool BWD>
__global__ void __launch_bounds__(tf32x3::NT, 1)
lstm_cell_tf32x3(const __grid_constant__ CUtensorMap map_x,
                 const __grid_constant__ CUtensorMap map_h,
                 const __grid_constant__ CUtensorMap map_hi,
                 const __grid_constant__ CUtensorMap map_lo, const Epi<float> ep, int B,
                 int E, int H) {
  extern __shared__ uint8_t smem_raw[];
  const tf32x3::Ring r = tf32x3::ring_init(smem_raw);
  const int row0 = blockIdx.y * BM;
  const int j0 = blockIdx.x * BH;
  const int nkx = (E + tf32x3::BK - 1) / tf32x3::BK;
  const int nk = nkx + (H + tf32x3::BK - 1) / tf32x3::BK;
  const int warp = threadIdx.x / 32;
  const int wg = warp / 4;
  if (wg == 2) {                       // producer: w_hi / w_lo boxes at gate * H + j0
    setmaxnreg_dec<tf32x3::PRODUCER_REGS>();
    if (threadIdx.x == 256)
      tf32x3::produce(r, &map_x, &map_h, nkx, nk, E, row0, &map_hi, &map_lo, j0, H);
  } else {                             // consumers: warpgroup wg takes rows row0 + 64 wg ..
    setmaxnreg_inc<tf32x3::CONSUMER_REGS>();
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    tf32x3::consume(r, acc, nk, wg);
    EpiIn<float> in;
    epilogue_load(in, ep, B, H, row0 + wg * 64, j0);
    epilogue<float, BWD>(acc, in, ep, B, H, row0 + wg * 64, j0);
  }
}

}  // namespace tc

template <typename T>
Epi<T> fwd_epi(const void* c, const void* b, void* h_out, void* c_out) {
  return Epi<T>{(const T*)c, (const T*)b, (T*)h_out, (T*)c_out, nullptr, nullptr, nullptr,
                nullptr, nullptr, nullptr, nullptr, nullptr, 0};
}

template <typename T>
Epi<T> bwd_epi(const void* c, const void* b, const void* dh, const void* dc, void* d_gates,
               void* dc_out) {
  return Epi<T>{(const T*)c, (const T*)b, nullptr, nullptr, (const T*)dh, (const T*)dc,
                (float*)d_gates, (T*)dc_out, nullptr, nullptr, nullptr, nullptr, 0};
}

// True when an epilogue operand breaks the tensor-core epilogue's pairs:
// c, b and the outputs (and dh', dc') `mask + 1`-byte aligned, d_gates
// 8-byte aligned (float2), d_hi and d_lo 4-byte aligned (bf16x2).
template <typename T>
bool pairs_misaligned(const Epi<T>& ep, uintptr_t mask) {
  const uintptr_t a = (uintptr_t)ep.c | (uintptr_t)ep.b | (uintptr_t)ep.h_out |
                      (uintptr_t)ep.c_out | (uintptr_t)ep.dh | (uintptr_t)ep.dc |
                      (uintptr_t)ep.dc_out;
  return (a & mask) != 0 || ((uintptr_t)ep.d_gates & 7) != 0 ||
         (((uintptr_t)ep.d_hi | (uintptr_t)ep.d_lo) & 3) != 0;
}

template <typename T, bool BWD>
int run_cuda_core(const void* x, const void* h, const void* w, const Epi<T>& ep, int B,
                  int E, int H, void* stream) {
  if (B <= 0 || E < 0 || H <= 0) return (int)cudaErrorInvalidValue;
  dim3 grid((H + BH - 1) / BH, (B + BM - 1) / BM);
  lstm_cell_kernel<T, BWD><<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)h, (const T*)w, ep, B, E, H);
  return (int)cudaGetLastError();
}

template <bool BWD>
int run_wgmma(const void* x, const void* h, const void* w_cat,
              const Epi<__nv_bfloat16>& ep, int B, int E, int H, void* stream) {
  if (B <= 0 || E <= 0 || H <= 0 || E % 8 != 0 || H % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if (pairs_misaligned(ep, 3) || !sicz::hopper::aligned16(x) ||
      !sicz::hopper::aligned16(h) || !sicz::hopper::aligned16(w_cat))
    return (int)cudaErrorMisalignedAddress;
  CUtensorMap mx, mh, mw;
  if (!sicz::hopper::tensor_map_bf16(&mx, x, B, E, E, tc::BM, 64, 128) ||
      !sicz::hopper::tensor_map_bf16(&mh, h, B, H, H, tc::BM, 64, 128) ||
      !sicz::hopper::tensor_map_bf16(&mw, w_cat, (uint64_t)E + H, 4 * (uint64_t)H,
                       4 * (uint64_t)H, tc::BK, tc::BH, tc::SWB))
    return (int)cudaErrorInvalidValue;
  static std::atomic<uint64_t> smem_set{0};
  const cudaError_t err =
      sicz::hopper::allow_smem((const void*)tc::lstm_cell_wgmma<BWD>, tc::SMEM, smem_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((H + tc::BH - 1) / tc::BH, (B + tc::BM - 1) / tc::BM);
  tc::lstm_cell_wgmma<BWD><<<grid, tc::NT, tc::SMEM, (cudaStream_t)stream>>>(mx, mh, mw, ep,
                                                                              B, E, H);
  return (int)cudaGetLastError();
}

template <bool BWD>
int run_tf32x3(const void* x, const void* h, const void* w_hi, const void* w_lo,
               const Epi<float>& ep, int B, int E, int H, void* stream) {
  namespace t3 = sicz::hopper::tf32x3;
  if (B <= 0 || E <= 0 || H <= 0 || E % 4 != 0 || H % 4 != 0)
    return (int)cudaErrorInvalidValue;
  if (pairs_misaligned(ep, 7) || !sicz::hopper::aligned16(x) ||
      !sicz::hopper::aligned16(h) || !sicz::hopper::aligned16(w_hi) ||
      !sicz::hopper::aligned16(w_lo))
    return (int)cudaErrorMisalignedAddress;
  const uint64_t kt = (uint64_t)E + H, n4 = 4 * (uint64_t)H;
  CUtensorMap mx, mh, mhi, mlo;
  if (!sicz::hopper::tensor_map_f32(&mx, x, B, E, E, t3::BM) ||
      !sicz::hopper::tensor_map_f32(&mh, h, B, H, H, t3::BM) ||
      !sicz::hopper::tensor_map_f32(&mhi, w_hi, n4, kt, kt, t3::BOX_N) ||
      !sicz::hopper::tensor_map_f32(&mlo, w_lo, n4, kt, kt, t3::BOX_N))
    return (int)cudaErrorInvalidValue;
  static std::atomic<uint64_t> smem_set{0};
  const cudaError_t err =
      sicz::hopper::allow_smem((const void*)tc::lstm_cell_tf32x3<BWD>, t3::SMEM, smem_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((H + tc::BH - 1) / tc::BH, (B + t3::BM - 1) / t3::BM);
  tc::lstm_cell_tf32x3<BWD><<<grid, t3::NT, t3::SMEM, (cudaStream_t)stream>>>(
      mx, mh, mhi, mlo, ep, B, E, H);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fused_lstm_cell(const void* x, const void* h, const void* c,
                               const void* w_cat, const void* b_sum,
                               void* h_out, void* c_out, int B, int E, int H,
                               int dtype, void* stream) {
  if (dtype == sicz::kF32)
    return run_cuda_core<float, false>(x, h, w_cat, fwd_epi<float>(c, b_sum, h_out, c_out),
                                       B, E, H, stream);
  if (dtype == sicz::kBF16)
    return run_cuda_core<__nv_bfloat16, false>(
        x, h, w_cat, fwd_epi<__nv_bfloat16>(c, b_sum, h_out, c_out), B, E, H, stream);
  return (int)cudaErrorInvalidValue;
}

// The tensor-core route: bf16 only, E and H multiples of 8, x, h and w_cat
// 16-byte aligned (TMA), c, b_sum, h_out and c_out 4-byte aligned (pairs);
// cudaErrorMisalignedAddress if a pointer is not.
extern "C" int fused_lstm_cell_wgmma(const void* x, const void* h, const void* c,
                                     const void* w_cat, const void* b_sum,
                                     void* h_out, void* c_out, int B, int E,
                                     int H, void* stream) {
  return run_wgmma<false>(x, h, w_cat, fwd_epi<__nv_bfloat16>(c, b_sum, h_out, c_out), B, E,
                          H, stream);
}

// The float32 tensor-core route (3xTF32): E and H multiples of 4; w_hi and
// w_lo are w_cat's TF32 parts, each (4H, E+H) row-major (ops/tf32.py);
// x, h, w_hi and w_lo 16-byte aligned (TMA), c, b_sum, h_out and c_out
// 8-byte aligned (float2 pairs); cudaErrorMisalignedAddress if a pointer
// is not.
extern "C" int fused_lstm_cell_tf32x3(const void* x, const void* h, const void* c,
                                      const void* w_hi, const void* w_lo,
                                      const void* b_sum, void* h_out, void* c_out, int B,
                                      int E, int H, void* stream) {
  return run_tf32x3<false>(x, h, w_hi, w_lo, fwd_epi<float>(c, b_sum, h_out, c_out), B, E, H,
                           stream);
}

// The backward of each route: the same operands as its forward, with dh'
// and dc' (c's dtype, laid out as c; either may be null, read as zero) in,
// and d_gates ((B, 4H) float32) and dc (c's dtype) out in place of h' and
// c'.  The tensor-core routes take the forward's conditions, d_gates
// 8-byte aligned; each also writes, where its pointers are not null, the
// operands of the products of csrc/lstm_bwd.cu: the wgmma route d_hi and
// d_lo (bf16, (B, 4H), 4-byte aligned), the tf32x3 route dt_hi and dt_lo
// (float32, (4H, dt_pitch), dt_pitch >= B).
extern "C" int fused_lstm_cell_bwd(const void* x, const void* h, const void* c,
                                   const void* w_cat, const void* b_sum, const void* dh,
                                   const void* dc, void* d_gates, void* dc_out, int B,
                                   int E, int H, int dtype, void* stream) {
  if (dtype == sicz::kF32)
    return run_cuda_core<float, true>(
        x, h, w_cat, bwd_epi<float>(c, b_sum, dh, dc, d_gates, dc_out), B, E, H, stream);
  if (dtype == sicz::kBF16)
    return run_cuda_core<__nv_bfloat16, true>(
        x, h, w_cat, bwd_epi<__nv_bfloat16>(c, b_sum, dh, dc, d_gates, dc_out), B, E, H,
        stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" int fused_lstm_cell_bwd_wgmma(const void* x, const void* h, const void* c,
                                         const void* w_cat, const void* b_sum,
                                         const void* dh, const void* dc, void* d_gates,
                                         void* dc_out, void* d_hi, void* d_lo, int B, int E,
                                         int H, void* stream) {
  Epi<__nv_bfloat16> ep = bwd_epi<__nv_bfloat16>(c, b_sum, dh, dc, d_gates, dc_out);
  ep.d_hi = (__nv_bfloat16*)d_hi;
  ep.d_lo = (__nv_bfloat16*)d_lo;
  if ((d_hi == nullptr) != (d_lo == nullptr)) return (int)cudaErrorInvalidValue;
  return run_wgmma<true>(x, h, w_cat, ep, B, E, H, stream);
}

extern "C" int fused_lstm_cell_bwd_tf32x3(const void* x, const void* h, const void* c,
                                          const void* w_hi, const void* w_lo,
                                          const void* b_sum, const void* dh, const void* dc,
                                          void* d_gates, void* dc_out, void* dt_hi,
                                          void* dt_lo, int dt_pitch, int B, int E, int H,
                                          void* stream) {
  Epi<float> ep = bwd_epi<float>(c, b_sum, dh, dc, d_gates, dc_out);
  ep.dt_hi = (float*)dt_hi;
  ep.dt_lo = (float*)dt_lo;
  ep.dt_pitch = dt_pitch;
  if ((dt_hi == nullptr) != (dt_lo == nullptr) || (dt_hi != nullptr && dt_pitch < B))
    return (int)cudaErrorInvalidValue;
  return run_tf32x3<true>(x, h, w_hi, w_lo, ep, B, E, H, stream);
}

// TMA tensor maps this library has encoded so far, on every host thread
// (the forward's and autograd's): what the map cache missed.
extern "C" unsigned long long fused_lstm_map_encodes() {
  return (unsigned long long)sicz::hopper::map_encodes().load();
}
