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
// of them.  To stream them at that rate each SM needs some 20 KB of loads
// in flight at every moment (3.35 TB/s x about 0.8 us of memory latency
// / 132 SMs).
//
// Two routes, chosen by ops/int8_attention.py:attention_route.
//
// "tma" (int8_attention_tma): one block of 256 threads per sample.  Thread
// 0 asks TMA for the sample's whole int8 K and V at entry (boxes of up to
// 256 rows by one 128-byte column block, over the (B*N, D) int8 arrays), K
// on one mbarrier and V on another, so every byte the block needs is in
// flight before it computes anything, and the scores start while V still
// arrives.  At the greedy shape a block holds 72 KB of K and V (76,608
// bytes of shared memory in all), three blocks fit an SM, and all 384 run
// at once: the 28.3 MB are in flight together.
//  - scores: a thread per (head, key row), over heads * N tasks.  The
//    thread walks its K row's eight 16-byte chunks starting at chunk n % 8,
//    so 8 neighbouring rows read 8 different chunks: 32 banks.  (The
//    128-byte swizzle does the same in the layout, but needs 1024-byte
//    aligned boxes: 36 rows padded to 40, and a block then no longer fits
//    three to an SM.)  q is read from device memory through L1 (prefetched
//    at entry), the chunk the thread reads of K; float32 q with 3 or more
//    rows (beam search) is staged in shared memory instead, laid out so
//    that the 8 chunks a load phase reads fall on 8 bank groups (q_staged).
//    int8 widens to float32 by byte permutes and float adds (no I2F); 1,
//    2 or 4 query rows ride one pass over the row (a template argument, so
//    k = 1 and 2 test nothing per row), each in two accumulators for a
//    shorter dependent chain.
//  - softmax: a warp per (head, query row), into p and p * vs.
//  - out: a thread per (query row, 4 columns), 4 float32 sums over the
//    value rows in key order (a warp reads a row's 128 bytes: no
//    conflict), so all 256 threads work at k = 1.
//  - pmean: a thread per (query row, key), summing p / heads in head
//    order.
// No atomics, so every run gives the same bits.  The arithmetic is the
// "cuda_core" route's but for the order of the score sums (by chunk from
// n % 8, in two halves; a warp's butterfly there).  The route takes
// 16-byte aligned q, kq and vq (TMA; q's vector loads), D a multiple of 16
// and a plan that fits 227 KB of shared memory (attn_plan below; at D =
// 1024, 8 heads and k = 1 up to N = 109).
//
// "cuda_core" (int8_attention): the first port of the TPU kernel, kept for
// shapes the "tma" route does not take (the largest N; q, kq or vq not
// 16-byte aligned).  One block takes one sample and loops over
// the heads itself: for each head it widens that head's q rows into shared
// memory, computes the scores (a warp per key row, each lane reading 4 int8
// of K at a time from device memory), masks and softmaxes them (a warp per
// query row), writes out (a thread per (row, column)), and adds p / heads
// to a pmean tile in shared memory, which it writes once after the last
// head.  Query rows go in chunks of kc rows so that the shared memory
// (kc * (dh + 2N) floats) stays within the default 48 KB; at the decode
// shapes one chunk takes every row.  It is bound by latency: a block has
// about 1 KB of scattered 4-byte and 1-byte loads in flight at a time.
#include <math.h>

#include <algorithm>
#include <atomic>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

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

// ---- the "tma" route -----------------------------------------------------------

namespace tma {

using namespace sicz::hopper;

constexpr int NT = 256;                 // 8 warps: a warp per head in P.V
constexpr int NW = NT / 32;
constexpr int BOX_ROWS = 256;           // TMA's largest box side
constexpr int SMEM_MAX = 232448;        // 227 KB, a block's most

// The shared-memory plan of one block (one sample): K then V, each D / 128
// column blocks of nbox boxes of `rows` rows by 128 bytes, back to back
// (row n of a column block at n * 128).  The last box may run up to
// nbox - 1 rows past N (into the next sample, or TMA's zero fill); those
// rows are never read.  Then the two mbarriers, the scores (then p) and
// p * vs (heads x k x N each), ks, vs and mask (N each); 128 bytes more to
// align the start.  At the greedy shape that is 76,608 bytes: three
// blocks an SM (each also holds 1 KB the card reserves).  Where q's rows
// are staged in shared memory (q_staged, below), they follow, 16-byte
// aligned: k x D floats and 16 bytes more.
// ops/int8_attention.py (tma_smem_bytes) repeats this sum.
struct Plan {
  int nbox, rows;
  size_t smem;
};

// KB: query rows a thread carries through one pass over its K row (1, 2
// or 4: no per-row test where k is 1 or 2)
inline int rows_a_pass(int k) { return k == 1 ? 1 : k == 2 ? 2 : 4; }

// Does attend_tma<T, KB> stage q's rows in shared memory?  Only float32 q
// with 4 rows a pass (k >= 3, the beam): there each key row reads 48 bytes
// of q a chunk, which through L1 cost more than K's own 16; bf16 q and
// fewer rows read q through L1.
template <typename T, int KB>
constexpr bool q_staged = std::is_same<T, float>::value && KB == 4;

template <typename T>
inline Plan attn_plan(int k, int N, int D, int heads) {
  Plan p;
  p.nbox = (N + BOX_ROWS - 1) / BOX_ROWS;
  p.rows = (N + p.nbox - 1) / p.nbox;
  p.smem = 128 + 2 * (size_t)(D / 128) * p.nbox * p.rows * 128 + 16 +
           4 * (2 * (size_t)heads * k * N + 3 * (size_t)N) +
           (q_staged<T, 4> && rows_a_pass(k) == 4 ? 16 + 4 * (size_t)k * D : 0);
  return p;
}

// q staged in shared memory (QS): a row's 128-column block is 32 float4,
// float4 u of 16-value chunk c at slot u * 8 + c, so the 8 threads of a
// 16-byte load phase, which read 8 different chunks c, hit 8 different
// 16-byte bank groups
__device__ __forceinline__ void load_q16s(const float4* blk, int c, float4 (&v)[4]) {
#pragma unroll
  for (int u = 0; u < 4; ++u) v[u] = blk[u * 8 + c];
}

// 16 values of q (float32 or bf16) from device memory (through L1: the
// block's q is read by every key row) as float32
__device__ __forceinline__ void load_q16(const float* p, float4 (&v)[4]) {
  const float4* s = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int u = 0; u < 4; ++u) v[u] = __ldg(s + u);
}
__device__ __forceinline__ float4 bf16x4(uint32_t lo, uint32_t hi) {
  return make_float4(__uint_as_float(lo << 16), __uint_as_float(lo & 0xFFFF0000u),
                     __uint_as_float(hi << 16), __uint_as_float(hi & 0xFFFF0000u));
}
__device__ __forceinline__ void load_q16(const __nv_bfloat16* p, float4 (&v)[4]) {
  const uint4* s = reinterpret_cast<const uint4*>(p);
  const uint4 a = __ldg(s), b = __ldg(s + 1);
  v[0] = bf16x4(a.x, a.y);
  v[1] = bf16x4(a.z, a.w);
  v[2] = bf16x4(b.x, b.y);
  v[3] = bf16x4(b.z, b.w);
}

// 4 int8 (a word, lowest byte first) -> 4 float, exact: the float with bits
// 0x4B0000uu is 2^23 + u, u = q + 128; byte permutes and float adds, no I2F
// (a quarter-rate instruction), as hopper.cuh's widen2
__device__ __forceinline__ float4 widen4(uint32_t w) {
  w ^= 0x80808080u;
  return make_float4(__uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540)) - 8388736.f,
                     __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7541)) - 8388736.f,
                     __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7542)) - 8388736.f,
                     __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7543)) - 8388736.f);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void axpy4(float p, float4 v, float* a) {
  a[0] = fmaf(p, v.x, a[0]);
  a[1] = fmaf(p, v.y, a[1]);
  a[2] = fmaf(p, v.z, a[2]);
  a[3] = fmaf(p, v.w, a[3]);
}

template <typename T>
__device__ __forceinline__ void store4(T* o, const float* a);
template <>
__device__ __forceinline__ void store4<float>(float* o, const float* a) {
  *reinterpret_cast<float4*>(o) = make_float4(a[0], a[1], a[2], a[3]);
}
template <>
__device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* o, const float* a) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a[0], a[1]), hi = __floats2bfloat162_rn(a[2], a[3]);
  uint2 v;
  v.x = *reinterpret_cast<uint32_t*>(&lo);
  v.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(o) = v;
}

// KB: query rows a pass (rows_a_pass)
template <typename T, int KB>
__global__ void __launch_bounds__(NT, KB == 1 ? 3 : 2)
attend_tma(const __grid_constant__ CUtensorMap map_k, const __grid_constant__ CUtensorMap map_v,
           const T* __restrict__ q, const float* __restrict__ ks, const float* __restrict__ vs,
           const float* __restrict__ mask, T* __restrict__ out, float* __restrict__ pmean,
           int k, int N, int D, int heads, int nbox, int rows, float inv_sqrt_dh) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const Ks = (uint8_t*)(((uintptr_t)smem_raw + 127) & ~(uintptr_t)127);
  const int ncol = D / 128, dh = D / heads, ncb = dh / 128;
  const int cbytes = nbox * rows * 128;             // a column block's bytes
  uint8_t* const Vs = Ks + ncol * cbytes;
  uint64_t* const bar = (uint64_t*)(Vs + ncol * cbytes);             // [0] K, [1] V
  float* const sc = (float*)(bar + 2);             // (heads, k, N): scores, then p
  float* const pvs = sc + heads * k * N;           // (heads, k, N): p * vs
  float* const kss = pvs + heads * k * N;
  float* const vss = kss + N;
  float* const msk = vss + N;
  float4* const qs4 = (float4*)(((uintptr_t)(msk + N) + 15) & ~(uintptr_t)15);  // QS only
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const size_t b = blockIdx.x;
  const size_t row0 = b * k;                                         // q's first row
  constexpr bool QS = q_staged<T, KB>;

  if (tid == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    const uint32_t bytes = (uint32_t)ncol * nbox * rows * 128;
    mbar_expect_tx(&bar[0], bytes);
    mbar_expect_tx(&bar[1], bytes);
    for (int g = 0; g < ncol; ++g)
      for (int j = 0; j < nbox; ++j)
        tma_load_2d(Ks + g * cbytes + j * rows * 128, &map_k, g * 128, (int)(b * N) + j * rows,
                    &bar[0]);
    for (int g = 0; g < ncol; ++g)
      for (int j = 0; j < nbox; ++j)
        tma_load_2d(Vs + g * cbytes + j * rows * 128, &map_v, g * 128, (int)(b * N) + j * rows,
                    &bar[1]);
  }
  // without QS q stays in device memory, read through L1; each thread
  // asks for one of its 128-byte lines now, while K and V are on their way
  const T* qb = q + row0 * D;
  if constexpr (QS) {
    const float4* qg = reinterpret_cast<const float4*>(qb);
    const int w4 = D / 4;                                  // float4 a row
    for (int e = tid; e < k * w4; e += NT) {
      const int i = e / w4, w = e - i * w4;
      qs4[(i * ncol + (w >> 5)) * 32 + (w & 3) * 8 + ((w >> 2) & 7)] = __ldg(qg + e);
    }
  } else if (tid < k * D * (int)sizeof(T) / 128) {
    asm volatile("prefetch.global.L1 [%0];" :: "l"((const char*)qb + tid * 128));
  }
  for (int n = tid; n < N; n += NT) {
    const float a = ks[b * N + n], c = vs[b * N + n], m = mask[b * N + n];
    kss[n] = a;
    vss[n] = c;
    msk[n] = m;
  }
  __syncthreads();

  // scores: a thread per (head, key row), over heads * N tasks.  The thread
  // reads its K row 16 bytes at a time, starting at chunk n % 8 (chunk c
  // at step (c - n) % 8), so 8 neighbouring rows read 8 different chunks:
  // 32 banks, without a swizzle; it reads the same chunk of q.
  mbar_wait(&bar[0], 0);
  for (int t = tid; t < heads * N; t += NT) {
    const int h = t / N, n = t - h * N;
    const uint8_t* krow = Ks + h * ncb * cbytes + n * 128;
    const bool valid = msk[n] > 0.f;
    for (int i0 = 0; i0 < k; i0 += KB) {
      float acc[KB][2];                                // even and odd steps
#pragma unroll
      for (int i = 0; i < KB; ++i) acc[i][0] = acc[i][1] = 0.f;
      for (int cb = 0; cb < ncb; ++cb) {
        const uint8_t* kr = krow + cb * cbytes;
        const T* qc = qb + (size_t)i0 * D + h * dh + cb * 128;
#pragma unroll
        for (int s = 0; s < 8; ++s) {
          const int c = (s + n) & 7;
          const uint4 kw = *reinterpret_cast<const uint4*>(kr + c * 16);
          const float4 k0 = widen4(kw.x), k1 = widen4(kw.y), k2 = widen4(kw.z), k3 = widen4(kw.w);
#pragma unroll
          for (int i = 0; i < KB; ++i) {
            if (KB <= 2 || i0 + i < k) {
              float4 qv[4];
              if constexpr (QS)
                load_q16s(qs4 + ((i0 + i) * ncol + h * ncb + cb) * 32, c, qv);
              else
                load_q16(qc + (size_t)i * D + c * 16, qv);
              float& a = acc[i][s & 1];
              a = dot4(qv[3], k3, dot4(qv[2], k2, dot4(qv[1], k1, dot4(qv[0], k0, a))));
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < KB; ++i)
        if (KB <= 2 || i0 + i < k)
          sc[(h * k + i0 + i) * N + n] =
              valid ? (acc[i][0] + acc[i][1]) * kss[n] * inv_sqrt_dh : NEG;
    }
  }
  __syncthreads();

  for (int t = warp; t < heads * k; t += NW) {          // softmax, a warp per (head, row)
    float* r = sc + t * N;
    float* pr = pvs + t * N;
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
      r[n] = p;
      pr[n] = p * vss[n];
    }
  }
  __syncthreads();

  // out: a thread per (query row, 4 columns), over the value rows in key
  // order (a warp reads a row's 128 bytes: no conflict); the sums of the
  // "cuda_core" route, in its order
  mbar_wait(&bar[1], 0);
  const int n4 = D / 4;
  for (int t = tid; t < k * n4; t += NT) {
    const int i = t / n4, col = 4 * (t - i * n4);
    const uint8_t* vc = Vs + (col >> 7) * cbytes + (col & 127);
    const float* pv = pvs + (col / dh * k + i) * N;
    float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int n = 0; n < N; ++n)
      axpy4(pv[n], widen4(*reinterpret_cast<const uint32_t*>(vc + n * 128)), a);
    store4<T>(out + (row0 + i) * D + col, a);
  }
  for (int e = tid; e < k * N; e += NT) {              // pmean, in head order
    const int i = e / N, n = e - i * N;
    float acc = 0.f;
    for (int h = 0; h < heads; ++h) acc += sc[(h * k + i) * N + n] / heads;
    pmean[row0 * N + e] = acc;
  }
}

template <typename T, int KB>
cudaError_t launch_kb(const CUtensorMap& mk, const CUtensorMap& mv, const Plan& p, const void* q,
                      const float* ks, const float* vs, const float* mask, void* out,
                      float* pmean, int B, int k, int N, int D, int heads, float inv_sqrt_dh,
                      cudaStream_t st) {
  static std::atomic<uint64_t> smem_set{0};
  const cudaError_t err = allow_smem((const void*)attend_tma<T, KB>, SMEM_MAX, smem_set);
  if (err != cudaSuccess) return err;
  attend_tma<T, KB><<<B, NT, p.smem, st>>>(mk, mv, (const T*)q, ks, vs, mask, (T*)out, pmean,
                                           k, N, D, heads, p.nbox, p.rows, inv_sqrt_dh);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* kq, const float* ks, const void* vq,
                   const float* vs, const float* mask, void* out, float* pmean, int B, int k,
                   int N, int D, int heads, float inv_sqrt_dh, cudaStream_t st) {
  const Plan p = attn_plan<T>(k, N, D, heads);
  CUtensorMap mk, mv;
  if (!tensor_map_i8(&mk, kq, (uint64_t)B * N, D, D, p.rows, 128) ||
      !tensor_map_i8(&mv, vq, (uint64_t)B * N, D, D, p.rows, 128))
    return cudaErrorInvalidValue;
  if (k == 1)
    return launch_kb<T, 1>(mk, mv, p, q, ks, vs, mask, out, pmean, B, k, N, D, heads,
                           inv_sqrt_dh, st);
  if (k == 2)
    return launch_kb<T, 2>(mk, mv, p, q, ks, vs, mask, out, pmean, B, k, N, D, heads,
                           inv_sqrt_dh, st);
  return launch_kb<T, 4>(mk, mv, p, q, ks, vs, mask, out, pmean, B, k, N, D, heads,
                         inv_sqrt_dh, st);
}

}  // namespace tma

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

// The "tma" route.  Refuses (cudaErrorInvalidValue) what the route does not
// take: D not a multiple of 16, q, kq or vq not 16-byte aligned, a plan
// beyond 227 KB of shared memory, and the shapes the "cuda_core" route
// refuses.
extern "C" int int8_attention_tma(const void* q, const void* kq, const float* ks,
                                  const void* vq, const float* vs, const float* mask,
                                  void* out, float* pmean, int B, int k, int N, int D,
                                  int heads, float inv_sqrt_dh, int dtype, void* stream) {
  const bool f32 = dtype == sicz::kF32;
  if (B <= 0 || k < 1 || k > KMAX || N < 1 || N > NMAX || heads <= 0 || D % heads ||
      (D / heads) % 128 || D % 16 ||
      (f32 ? tma::attn_plan<float>(k, N, D, heads)
           : tma::attn_plan<__nv_bfloat16>(k, N, D, heads)).smem > (size_t)tma::SMEM_MAX ||
      !sicz::hopper::aligned16(q) || !sicz::hopper::aligned16(kq) ||
      !sicz::hopper::aligned16(vq))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (f32)
    return (int)tma::launch<float>(q, kq, ks, vq, vs, mask, out, pmean, B, k, N, D, heads,
                                   inv_sqrt_dh, st);
  if (dtype == sicz::kBF16)
    return (int)tma::launch<__nv_bfloat16>(q, kq, ks, vq, vs, mask, out, pmean, B, k, N, D,
                                           heads, inv_sqrt_dh, st);
  return (int)cudaErrorInvalidValue;
}
