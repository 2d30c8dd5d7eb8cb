// Hopper (sm_90a) pieces of the port's tensor-core kernels: TMA tensor
// maps made on the host, the mbarrier ring, TMA tile loads, bf16 and tf32
// wgmma tile products with their shared-memory matrix descriptors, the
// int8 -> bf16 and int8 -> TF32 widening stages of the int8-weight
// products, and the 3xTF32 and 2xTF32 pipelines of the float32 products.
// Used by the bf16 routes of K1 (csrc/fused_head.cu, bf16 and int8
// weights), K2 (csrc/fused_lstm.cu) and K3 (csrc/quant_matmul.cu), by the
// float32 ("tf32x3") routes of K1 and K2, by the float32 routes with an
// int8 weight ("tf32x2") of K1 and K3, and by K2 backward's products on
// both routes (csrc/lstm_bwd.cu: bf16 wgmma with either operand
// transposed, wgmma_m64n128k16_t, and the tf32x3 products with the
// weight split in shared memory or d^T as the weight); the CUDA-core tile
// product of common.cuh stays for shapes and pointers TMA cannot take.
//
// Everything is inline PTX, so a kernel source still builds with one nvcc
// call and no other headers than the toolkit's.  cuTensorMapEncodeTiled is
// a driver-API function; it is fetched once through the runtime's
// cudaGetDriverEntryPoint, so the libraries need no -lcuda.
//
// The layouts, as the kernels use them:
//   A, the activations, row-major (m, K): TMA boxes of 64 K-values (128
//     bytes) by BM rows with the 128-byte swizzle.  In shared memory a row
//     is 128 bytes and eight rows make a 1024-byte swizzle atom: the
//     "K-major" layout of wgmma, SBO = 1024 bytes.  The next 16 values of K
//     start 32 bytes further on.
//   B, the weight, row-major (K, N), N contiguous, as stored: TMA boxes of
//     SW/2 columns (SW = 64 or 128 bytes, the swizzle) by BK rows, one box
//     beside the other.  That is wgmma's "MN-major" layout (the transpose
//     bit of B set): a box row is SW bytes, eight rows are one swizzle atom
//     (SBO = 8 * SW bytes), and the next SW/2 columns are the next box
//     (LBO = BK * SW bytes).  The next 16 rows of K start 16 * SW bytes on.
//     In a box row the 16-byte chunk c (columns 8c .. 8c+7 of the box) of
//     row k lies at chunk c ^ (k % 8): the swizzle.
//   An int8 weight, row-major (Kp, Np) as ops/quant.py stores it, reaches
//     B in two moves.  TMA copies a box of BK rows by BN bytes, unswizzled,
//     into a staging tile (row k at k * BN bytes).  Then the 128 threads of
//     the producer warpgroup widen it (widen_i8_tile): each takes 8 int8 of
//     one row (8 bytes), makes 8 bf16 (16 bytes; exact, |q| <= 128 has at
//     most 8 significant bits) and stores them where TMA would have put a
//     bf16 weight: box c / 8 of BN / 64, row k, chunk (c % 8) ^ (k % 8), the
//     128-byte-swizzled B above (store_b_chunk).  Those are ordinary
//     (generic-proxy) stores and wgmma reads through the async proxy, so
//     each thread fences (fence_proxy_async) before it arrives on the
//     barrier that hands the stage to the consumers.
//   The float32 products (3xTF32, tf32x3 below) take both operands
//     K-major, since wgmma has no transpose for tf32: A as above with 32
//     float32 values (128 bytes) a row, and the weight stored transposed,
//     (N, K), read the same way, 32 K-values by 32 rows a box.  A k8 step
//     is 32 bytes, as a bf16 k16 step is, so desc_a describes both.
//   An int8 weight under float32 x (2xTF32, tf32x2 below) reaches that
//     K-major B from its stored (Kp, Np) layout: TMA copies a box of 32 K
//     rows by 128 bytes, unswizzled, into a staging tile, and the producer
//     warpgroup transposes while it widens (widen_i8_tile_tf32): four words
//     of four K rows, a 4 x 4 byte transpose, one 16-byte chunk of four
//     float32 per column, stored at row n (a column of q), chunk c ^ (n % 8).
// Every stage buffer starts on a 1024-byte boundary, so the swizzle phase
// of every descriptor is 0.  TMA fills what lies outside the tensor with
// zeros (FLOAT_OOB_FILL_NONE), so ragged rows, columns and K read 0.
//
// The accumulator of m64nNk16 (PTX ISA, wgmma D fragment): thread t of the
// warpgroup, w = t / 32, l = t % 32, holds in register i the element
//   row 16 w + l / 4 + 8 ((i / 2) % 2),  column 8 (i / 4) + 2 (l % 4) + i % 2.
// So a thread holding column n also holds n + 8 q for every q: a fused
// epilogue can take the columns it needs from its own registers.
#pragma once

#include <cuda.h>            // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace sicz {
namespace hopper {

// ---- host: TMA tensor maps --------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiledFn)p;
  }
  return fn;
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// Tensor map of a row-major matrix (rows, cols) of bf16, int8 or float32
// (dtype CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, _UINT8 or _FLOAT32) whose rows lie `pitch`
// elements apart, read in boxes of box_rows x box_cols with the given
// swizzle (0 for none; 64 or 128 bytes, box_cols times the element size
// must then equal it).  False when cuTensorMapEncodeTiled refuses it (a
// base or a pitch not 16-byte aligned among others).
//
// A map is a function of these arguments alone, so each host thread keeps
// the last MAP_CACHE maps it encoded and copies one out on a repeat: a
// weight's map is encoded once, and x's or h's again only when the
// allocator hands out a buffer the cache has not seen.  A decode step
// maps about five new activations (K2's x and h of two cells, K1's x),
// and the allocator cycles each through a few blocks of its size (blocks
// a size class shares with other activations): 64 entries hold the
// cycles of several steps, where 16 missed on every alternation.
constexpr int MAP_CACHE = 64;

// How many maps this library has encoded (cache misses, each a driver call
// on the host), over all host threads: the timing scripts read it.
inline std::atomic<uint64_t>& map_encodes() {
  static std::atomic<uint64_t> n{0};
  return n;
}

// cuTensorMapEncodeTiled needs a current context.  A host thread that
// has launched nothing yet has none: autograd's device thread, whose first
// work in a backward may be a kernel of this port, or any new thread.  So
// before encoding, the primary context of the device that holds `base` is
// made current, as a launch there would make it.
inline void bind_device_of(const void* base) {
  cudaPointerAttributes a;
  if (cudaPointerGetAttributes(&a, base) == cudaSuccess && a.type == cudaMemoryTypeDevice)
    cudaSetDevice(a.device);
  else
    cudaGetLastError();                  // clear what the query left
}

inline bool tensor_map(CUtensorMap* map, CUtensorMapDataType dtype, const void* base,
                       uint64_t rows, uint64_t cols, uint64_t pitch, uint32_t box_rows,
                       uint32_t box_cols, int swizzle_bytes) {
  struct Entry {
    CUtensorMap map;
    CUtensorMapDataType dtype;
    const void* base;
    uint64_t rows, cols, pitch;
    uint32_t box_rows, box_cols;
    int swizzle_bytes;
  };
  thread_local Entry cache[MAP_CACHE] = {};
  thread_local int next = 0;
  for (const Entry& e : cache)
    if (e.base != nullptr && e.base == base && e.dtype == dtype && e.rows == rows &&
        e.cols == cols && e.pitch == pitch && e.box_rows == box_rows &&
        e.box_cols == box_cols && e.swizzle_bytes == swizzle_bytes) {
      *map = e.map;
      return true;
    }
  const uint64_t item = dtype == CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 ? 2
                      : dtype == CU_TENSOR_MAP_DATA_TYPE_UINT8 ? 1
                      : dtype == CU_TENSOR_MAP_DATA_TYPE_FLOAT32 ? 4 : 0;
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr || item == 0 || !aligned16(base) || (pitch * item) % 16 != 0)
    return false;
  bind_device_of(base);
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {pitch * item};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUtensorMapSwizzle swz = swizzle_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                               : swizzle_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                               : CU_TENSOR_MAP_SWIZZLE_NONE;
  if (fn(map, dtype, 2, const_cast<void*>(base), dims, strides, box, unit,
         CU_TENSOR_MAP_INTERLEAVE_NONE, swz, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  map_encodes().fetch_add(1, std::memory_order_relaxed);
  cache[next] = {*map, dtype, base, rows, cols, pitch, box_rows, box_cols, swizzle_bytes};
  next = (next + 1) % MAP_CACHE;
  return true;
}

inline bool tensor_map_bf16(CUtensorMap* map, const void* base, uint64_t rows,
                            uint64_t cols, uint64_t pitch, uint32_t box_rows,
                            uint32_t box_cols, int swizzle_bytes) {
  return tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, rows, cols, pitch,
                    box_rows, box_cols, swizzle_bytes);
}

// an int8 matrix read in unswizzled boxes: the widening stage's staging tile
inline bool tensor_map_i8(CUtensorMap* map, const void* base, uint64_t rows,
                          uint64_t cols, uint64_t pitch, uint32_t box_rows,
                          uint32_t box_cols) {
  return tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, base, rows, cols, pitch,
                    box_rows, box_cols, 0);
}

// a float32 matrix read in boxes of box_rows x 32 values (128 bytes), with
// the 128-byte swizzle: the operands of the 3xTF32 products
inline bool tensor_map_f32(CUtensorMap* map, const void* base, uint64_t rows,
                           uint64_t cols, uint64_t pitch, uint32_t box_rows) {
  return tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, base, rows, cols, pitch,
                    box_rows, 32, 128);
}

// Lets `kernel` take `bytes` of dynamic shared memory on the current
// device.  The attribute belongs to the device's context, so it is set once
// per device; `done` (one per kernel) keeps a bit for each device set.
inline cudaError_t allow_smem(const void* kernel, int bytes,
                              std::atomic<uint64_t>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? 1ull << dev : 0;
  if (bit & done.load(std::memory_order_relaxed)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

// ---- device: mbarriers and TMA -----------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The dynamic shared memory rounded up to a 1024-byte boundary (the kernels
// ask for 1024 bytes more than they use).
__device__ __forceinline__ uint8_t* smem_1024(uint8_t* raw) {
  return (uint8_t*)(((uintptr_t)raw + 1023) & ~(uintptr_t)1023);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// after the inits, before any thread uses the barriers (then a __syncthreads)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also tells the barrier to wait for `bytes` of TMA data
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

// wait until the phase of parity `parity` has completed.  A wait that lasts
// 2^34 clock cycles (about 9 s) traps, so a pipeline fault ends the launch
// with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  const long long t0 = clock64();
  uint32_t done = 0;
  do {
    if (clock64() - t0 > (1ll << 34)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  } while (!done);
}

// TMA: the box at (column c0, row c1) of `map` into shared memory at dst;
// completion (the box's full byte count) is reported to `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"((uint64_t)map), "r"(smem_addr(bar)),
         "r"(c0), "r"(c1)
      : "memory");
}

// make this thread's ordinary shared-memory stores visible to the async
// proxy (wgmma, TMA) before it signals that they are there
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// TMA: shared memory at src into the box at (column c0, row c1) of `map`;
// what lies outside the tensor is not written.  One thread issues; the
// stores of a bulk group are awaited with bulk_wait_read.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n"
      :: "l"((uint64_t)map), "r"(smem_addr(src)), "r"(c0), "r"(c1)
      : "memory");
}

// close this thread's bulk group, then wait until its stores have read
// their shared memory (which may then be reused, or the block end)
__device__ __forceinline__ void bulk_commit_wait_read() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// ---- device: the int8 -> bf16 widening stage -----------------------------------

// 8 int8 (two words, lowest byte first) -> 8 bf16 (four words), exact.
// u = q + 128 as a byte; the float with bits 0x4B0000uu is 2^23 + u, so
// subtracting 2^23 + 128 leaves q exactly, and the upper half of a float
// with at most 8 significant bits is that value in bf16.  Byte permutes and
// float adds, no int-to-float conversion (a quarter-rate instruction).
__device__ __forceinline__ uint32_t widen2(uint32_t w, uint32_t sel_lo, uint32_t sel_hi) {
  const float lo = __uint_as_float(__byte_perm(w, 0x4B000000u, sel_lo)) - 8388736.f;
  const float hi = __uint_as_float(__byte_perm(w, 0x4B000000u, sel_hi)) - 8388736.f;
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

__device__ __forceinline__ uint4 widen8(uint32_t w0, uint32_t w1) {
  w0 ^= 0x80808080u;
  w1 ^= 0x80808080u;
  return make_uint4(widen2(w0, 0x7540, 0x7541), widen2(w0, 0x7542, 0x7543),
                    widen2(w1, 0x7540, 0x7541), widen2(w1, 0x7542, 0x7543));
}

// store 8 widened bf16 (columns 8c .. 8c+7 of row k) where desc_b<128>
// reads them: box c / 8 (box_bytes apart), row k, chunk (c % 8) ^ (k % 8)
__device__ __forceinline__ void store_b_chunk(uint8_t* b, uint32_t box_bytes, int k, int c,
                                              uint4 v) {
  const uint32_t a = smem_addr(b + (c >> 3) * box_bytes + k * 128 + (((c ^ k) & 7) << 4));
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(a), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w) : "memory");
}

// The staging tile (BK rows of BN int8, row k at k * BN) widened into B:
// BN / 64 boxes of BK rows x 128 bytes, 128-byte swizzle.  tid is the
// thread's index in its warpgroup; the 128 threads share the tile, a warp
// reading whole rows (8 bytes a thread) and writing whole box rows.  Loads
// go out four at a time ahead of their stores (the asm keeps its order),
// in few registers: the producer of K1 runs on 40.
template <int BK, int BN>
__device__ __forceinline__ void widen_i8_tile(const uint8_t* src, uint8_t* dst, int tid) {
  constexpr int CPR = BN / 8;                  // 8-column chunks per row
  constexpr int PER = BK * CPR / 128;          // chunks per thread
  constexpr int BATCH = 4;
  static_assert(BN % 64 == 0 && PER % BATCH == 0, "whole boxes, whole batches");
  const uint32_t s0 = smem_addr(src);
#pragma unroll 1
  for (int i0 = 0; i0 < PER; i0 += BATCH) {
    uint32_t w[BATCH][2];
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int e = tid + 128 * (i0 + j);
      asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
                   : "=r"(w[j][0]), "=r"(w[j][1])
                   : "r"(s0 + (e / CPR) * BN + (e % CPR) * 8) : "memory");
    }
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int e = tid + 128 * (i0 + j);
      store_b_chunk(dst, BK * 128, e / CPR, e % CPR, widen8(w[j][0], w[j][1]));
    }
  }
}

// ---- device: the int8 -> TF32 widening stage ------------------------------------

// 4 int8 (one word, lowest byte first) -> 4 float32 (16 bytes), exact, as
// widen2: the float with bits 0x4B0000uu is 2^23 + u, u = q + 128.  Each
// is a TF32 value: |q| <= 127 has at most 7 significant bits, TF32 11.
__device__ __forceinline__ uint4 widen4_f32(uint32_t w) {
  w ^= 0x80808080u;
  return make_uint4(
      __float_as_uint(__uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540)) - 8388736.f),
      __float_as_uint(__uint_as_float(__byte_perm(w, 0x4B000000u, 0x7541)) - 8388736.f),
      __float_as_uint(__uint_as_float(__byte_perm(w, 0x4B000000u, 0x7542)) - 8388736.f),
      __float_as_uint(__uint_as_float(__byte_perm(w, 0x4B000000u, 0x7543)) - 8388736.f));
}

// The staging tile (BK = 32 rows of BN = 128 int8, row k at k * BN)
// transposed and widened into the K-major B of the tf32 products: row n (a
// column of q) at n * 128 bytes, its 32 K-values in 8 chunks of 4 floats,
// chunk c (K values 4c .. 4c+3) at c ^ (n % 8), the 128-byte swizzle (the
// layout TMA gives w_hi in the 3xTF32 products).  Warp w of the producer
// warpgroup takes K rows 4c .. 4c+3 for c = w and w + 4 (both groups'
// eight loads go out before the first is used), lane j columns
// 4j .. 4j+3: four words, one a K row (a warp reads 128 consecutive bytes
// of a row: no bank conflict), a 4 x 4 byte transpose (prmt) into one
// word a column, each widened to one 16-byte chunk.  A warp's 16-byte
// stores go out eight lanes at a time; each lane first rotates its words
// by (j / 2) % 4 bytes, so lanes 8p .. 8p+7 store the columns
// 4j + (t + j / 2) % 4, whose n % 8 differ: eight chunks on eight
// different bank groups.
template <int BK, int BN>
__device__ __forceinline__ void widen_i8_tile_tf32(const uint8_t* src, uint8_t* dst, int tid) {
  static_assert(BK == 32 && BN == 128, "a warp per 4 K rows, a lane per 4 columns");
  const int j = tid % 32;
  const int rot = (j >> 1) & 3;
  const uint32_t s0 = smem_addr(src) + 4 * j;
  const uint32_t d0 = smem_addr(dst);
  uint32_t ws[2][4];                           // both groups' loads go out first
#pragma unroll
  for (int g = 0; g < 2; ++g)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      asm volatile("ld.shared.u32 %0, [%1];\n"
                   : "=r"(ws[g][r]) : "r"(s0 + (4 * (tid / 32 + 4 * g) + r) * BN) : "memory");
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    const int c = tid / 32 + 4 * g;
    uint32_t w[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) w[r] = __funnelshift_r(ws[g][r], ws[g][r], 8 * rot);
    // byte t of w[r]: q[4c + r][4j + (t + rot) % 4]
    const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140), t1 = __byte_perm(w[0], w[1], 0x7362);
    const uint32_t t2 = __byte_perm(w[2], w[3], 0x5140), t3 = __byte_perm(w[2], w[3], 0x7362);
    const uint32_t col[4] = {__byte_perm(t0, t2, 0x5410), __byte_perm(t0, t2, 0x7632),
                             __byte_perm(t1, t3, 0x5410), __byte_perm(t1, t3, 0x7632)};
#pragma unroll
    for (int t = 0; t < 4; ++t) {            // col[t]: q[4c .. 4c+3][n]
      const int n = 4 * j + ((t + rot) & 3);
      const uint4 v = widen4_f32(col[t]);
      asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n"
                   :: "r"(d0 + n * 128 + ((c ^ (n & 7)) << 4)), "r"(v.x), "r"(v.y), "r"(v.z),
                      "r"(v.w)
                   : "memory");
    }
  }
}

// The ring of an int8-weight product in dynamic shared memory: STAGES
// stages of STAGE_BYTES from the first 1,024-byte boundary, then three
// barriers per stage: full (TMA landed; the expect-tx arrival), ready
// (widened; every thread of the producer warpgroup) and empty (one arrival
// per consumer warpgroup).  K1's bf16 weight, which needs no widening,
// shares the layout and leaves ready unused.
struct I8Ring {
  uint8_t* stages;
  uint64_t* full;
  uint64_t* ready;
  uint64_t* empty;
};

// Dynamic shared memory of an I8Ring: the ring, its barriers, and up to
// 1,024 bytes to align the ring.
constexpr int i8_ring_smem(int stages, int stage_bytes) {
  return 1024 + stages * stage_bytes + 3 * stages * 8;
}

// Every thread of the block calls this.
template <int STAGES, int STAGE_BYTES>
__device__ __forceinline__ I8Ring i8_ring_init(uint8_t* smem_raw) {
  I8Ring r;
  r.stages = smem_1024(smem_raw);
  r.full = (uint64_t*)(r.stages + STAGES * STAGE_BYTES);
  r.ready = r.full + STAGES;
  r.empty = r.ready + STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&r.full[s], 1);
      mbar_init(&r.ready[s], 128);
      mbar_init(&r.empty[s], 2);
    }
    mbar_init_fence();
  }
  __syncthreads();
  return r;
}

// The producer warpgroup of an int8-weight product (all 128 threads call;
// tid is the index in the warpgroup), on an I8Ring whose stages are
// [A: BM x BK][B: the widened BK x BN][staging: BK x BN int8].  A and B
// are bf16 (B MN-major, widen_i8_tile), or with TF32 float32 (B K-major,
// widen_i8_tile_tf32).  Thread 0 starts the TMA loads, STAGES - 1 steps
// ahead; all 128 widen step t while the consumers multiply step t - 1.
template <int BM, int BK, int BN, int STAGES, bool TF32 = false>
__device__ __forceinline__ void i8_producer(const CUtensorMap* map_x, const CUtensorMap* map_q,
                                            const I8Ring& r, int row0, int col0, int nk,
                                            int tid) {
  constexpr int ITEM = TF32 ? 4 : 2;           // bytes of an A value and a widened B value
  constexpr int A_BYTES = BM * BK * ITEM, B_BYTES = BK * BN * ITEM, Q_BYTES = BK * BN;
  constexpr int STAGE_BYTES = A_BYTES + B_BYTES + Q_BYTES;
  uint8_t* const ring = r.stages;
  uint64_t* const full = r.full;
  uint64_t* const ready = r.ready;
  uint64_t* const empty = r.empty;
  auto load_step = [&](int t) {
    const int s = t % STAGES;
    uint8_t* st = ring + s * STAGE_BYTES;
    if (t >= STAGES) mbar_wait(&empty[s], ((t / STAGES) - 1) & 1);
    mbar_expect_tx(&full[s], A_BYTES + Q_BYTES);
    tma_load_2d(st, map_x, t * BK, row0, &full[s]);
    tma_load_2d(st + A_BYTES + B_BYTES, map_q, col0, t * BK, &full[s]);
  };
  if (tid == 0)
    for (int t = 0; t < STAGES - 1 && t < nk; ++t) load_step(t);
  for (int t = 0; t < nk; ++t) {
    const int s = t % STAGES;
    uint8_t* st = ring + s * STAGE_BYTES;
    mbar_wait(&full[s], (t / STAGES) & 1);
    if constexpr (TF32) widen_i8_tile_tf32<BK, BN>(st + A_BYTES + B_BYTES, st + A_BYTES, tid);
    else widen_i8_tile<BK, BN>(st + A_BYTES + B_BYTES, st + A_BYTES, tid);
    fence_proxy_async();
    mbar_arrive(&ready[s]);
    // the slot of step t - 1, free once its products are done
    if (tid == 0 && t + STAGES - 1 < nk) load_step(t + STAGES - 1);
  }
}

// ---- device: wgmma --------------------------------------------------------------

__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo_bytes,
                                              uint32_t sbo_bytes, uint32_t layout) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4)
       | ((uint64_t)((lbo_bytes >> 4) & 0x3FFF) << 16)
       | ((uint64_t)((sbo_bytes >> 4) & 0x3FFF) << 32)
       | ((uint64_t)layout << 62);
}

// A: K-major, 128-byte swizzle (layout type 1); LBO is unused there.  The
// same descriptor takes the K-major weight of the tf32 products as B.
__device__ __forceinline__ uint64_t desc_a(const void* p) {
  return smem_desc(p, 16, 1024, 1);
}

// B: MN-major with the SW-byte swizzle (type 1 for 128, 2 for 64); boxes of
// SW/2 columns lie box_bytes apart
template <int SW>
__device__ __forceinline__ uint64_t desc_b(const void* p, uint32_t box_bytes) {
  static_assert(SW == 64 || SW == 128, "64- or 128-byte swizzle");
  return smem_desc(p, box_bytes, 8 * SW, SW == 128 ? 1 : 2);
}

// hand registers between warpgroups (every warp of the warpgroup calls);
// a kernel that uses them splits its warpgroups in one if/else that never
// joins again
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(R));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed groups are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keep the compiler from moving accumulator reads or writes across the
// asynchronous product
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// D (64 x 64, float32, the wgmma fragment) += A (64 x 16, K-major) *
// B (16 x 64, MN-major: the weight's rows, N contiguous), bf16 operands.
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da, uint64_t db,
                                                int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 128, float32, the wgmma fragment) += A (64 x 16) * B (16 x 128),
// bf16 operands in shared memory, each K-major (TA or TB 0: 16 K-values a
// 32-byte run of its rows, the desc_a layout) or MN-major (1: the matrix's
// rows or columns contiguous, the desc_b layout; an A of 64 rows is one
// 128-byte box wide).  16-bit wgmma takes the transpose bit on both
// operands; wgmma_m64n128k16 below is <0, 1>.  K2's backward products use
// <0, 0> (dx and dh: d_gates times w_cat as stored) and <1, 1> (dW: x and
// h, and d_gates, as stored, the batch their K).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16_t(float (&d)[64], uint64_t da, uint64_t db,
                                                   int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// D (64 x 128, float32, the wgmma fragment) += A (64 x 16, K-major) *
// B (16 x 128, MN-major: the weight's rows, N contiguous), bf16 operands.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                                 int scale_d) {
  wgmma_m64n128k16_t<0, 1>(d, da, db, scale_d);
}

// D (64 x 256, float32, the wgmma fragment) += A (64 x 16, K-major) *
// B (16 x 256, MN-major: the weight's rows, N contiguous), bf16 operands.
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127},"
      " %128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 128, float32, the wgmma fragment) += A (64 x 8, tf32, from
// registers: the fragment below) * B (8 x 128, tf32, K-major).
// The A fragment of m64nNk8 tf32 (PTX ISA, wgmma register fragments;
// CUTLASS's ALayout_64x8): thread t, w = t / 32, l = t % 32, holds in
// register i the element  row 16 w + l / 4 + 8 (i % 2),  k = l % 4 + 4 (i / 2).
__device__ __forceinline__ void wgmma_m64n128k8_tf32(float (&d)[64], const uint32_t (&a)[4],
                                                     uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// ---- device: 3xTF32, the float32 products on the tensor cores -----------------
//
// wgmma has no float32 product, and one TF32 product keeps 10 of float32's
// 23 mantissa bits.  So each operand is split into two TF32 values,
// a = a_hi + a_lo (a_hi = rna(a), a_lo = rna(a - a_hi): exact to 2^-22 of
// |a|), and each k8 step sums three products into one float32
// accumulator, the small terms first: a_lo * b_hi, a_hi * b_lo, a_hi * b_hi
// (the order of CUTLASS's OpMultiplyAddFastF32).  a_lo * b_lo, below
// 2^-22 of the product, is dropped.
//
// The tensor core's float32 sums are not IEEE: measured on the H100, one
// accumulator carried through all of K2's 1,152 products (K = 3,072) put
// h' up to 3.1e-5 off the float32 product, against a hold of 1e-5.  So a
// stage's 12 products go into a fresh accumulator (scale-d 0 on the first),
// which is then added into the float32 result with ordinary
// round-to-nearest adds: the tensor core only sums 32 values of K at a
// time, at the partial's small magnitude.  That costs 64 more registers a
// thread, hence the producer warpgroup that hands its registers to the
// consumers (setmaxnreg 40 / 232).
//
// The weight is split once per decode on the host side (ops/tf32.py) and
// stored transposed, (N, K), as w_hi and w_lo; the activations are split
// here, in registers, as they leave shared memory.
//
// One tile shape serves K1 and K2: BM = 128 rows (two consumer warpgroups
// of 64) by BN = 128 weight rows, 32 K-values (128 bytes) a stage.  A
// stage is A (128 x 32 float32, 16 KB) + w_hi and w_lo (128 x 32 each,
// 16 KB), 48 KB; a ring of 4 stages.  The weight tile is four TMA boxes
// of 32 rows, box g at weight row brow0 + g * bstride (K2: the four gates
// of 32 hidden columns; K1: 128 consecutive vocab columns).  One thread of
// the producer warpgroup keeps the ring full; each consumer warpgroup, per
// stage, reads its A fragments for the four k8 steps (16 floats a thread,
// conflict-free through the swizzle), splits them (cvt.rna.tf32.f32),
// issues the 12 products into the stage's partial, waits for them, frees
// the stage and adds the partial into its result.
__device__ __forceinline__ uint32_t rna_tf32(float f) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(f));
  return r;
}

// The shared-memory address of this thread's first A value in a stage
// whose A (128 rows of 32 float32, 128-byte swizzle) starts at `stages`,
// for consumer warpgroup wg (rows 64 wg ..): the fragment's rows
// 16 w + l/4 (+ 8) lie 128 bytes apart.
__device__ __forceinline__ uint32_t a_frag(const uint8_t* stages, int wg) {
  const int l = threadIdx.x % 32;
  return smem_addr(stages) + (wg * 64 + (threadIdx.x / 32 % 4) * 16 + l / 4) * 128 + (l % 4) * 4;
}

// This thread's A fragments of one stage (frag: a_frag plus the stage's
// offset), one per k8 step, each float split into TF32 hi and lo
// (cvt.rna.tf32.f32): 16 floats, conflict-free through the swizzle, which
// puts 16-byte chunk c of the fragment's rows at c ^ (row % 8) = c ^ (l/4).
template <int KSTEPS>
__device__ __forceinline__ void split_a(uint32_t frag, uint32_t (&hi)[KSTEPS][4],
                                        uint32_t (&lo)[KSTEPS][4]) {
  const int swz = threadIdx.x % 32 / 4;
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int chunk = 2 * kk + i / 2;             // k = 8 kk + l % 4 + 4 (i / 2)
      float f;
      asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(f)
                   : "r"(frag + (i % 2) * 1024 + ((chunk ^ swz) << 4)));
      hi[kk][i] = rna_tf32(f);
      lo[kk][i] = rna_tf32(f - __uint_as_float(hi[kk][i]));
    }
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    fence_regs(hi[kk]);
    fence_regs(lo[kk]);
  }
}

namespace tf32x3 {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int STAGES = 4;
constexpr int BOX_N = 32;                  // weight rows of one TMA box
constexpr int A_BYTES = BM * BK * 4;
constexpr int B_BYTES = BN * BK * 4;       // each of w_hi and w_lo
constexpr int STAGE_BYTES = A_BYTES + 2 * B_BYTES;
constexpr int NT = 3 * 128;                // two consumer warpgroups, one producer warpgroup
constexpr int PRODUCER_REGS = 40;          // setmaxnreg: 2 x 128 x 232 + 128 x 40 <= 65,536
constexpr int CONSUMER_REGS = 232;
constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8;

// The ring in dynamic shared memory, its barriers after it: full (the
// producer's expect-tx arrival) and empty (one arrival per consumer
// warpgroup).  Every thread of the block calls this.
struct Ring {
  uint8_t* stages;
  uint64_t* full;
  uint64_t* empty;
};

__device__ __forceinline__ Ring ring_init(uint8_t* smem_raw) {
  Ring r;
  r.stages = smem_1024(smem_raw);
  r.full = (uint64_t*)(r.stages + STAGES * STAGE_BYTES);
  r.empty = r.full + STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&r.full[s], 1);
      mbar_init(&r.empty[s], 2);
    }
    mbar_init_fence();
  }
  __syncthreads();
  return r;
}

// One thread.  Step t loads A's box from map_a (t < nka) or map_a2, at K
// column (t or t - nka) * BK, rows row0 ..; and the four boxes of w_hi and
// w_lo at K column t * BK (t < nka) or koff + (t - nka) * BK.  So K2 runs
// over x and then h without concatenating them (koff = E), and K1 over x
// alone (nka = nk).  A step past the end of one operand reads zeros (TMA's
// fill), which also zero the products with the other operand's rows.
__device__ __forceinline__ void produce(const Ring& r, const CUtensorMap* map_a,
                                        const CUtensorMap* map_a2, int nka, int nk, int koff,
                                        int row0, const CUtensorMap* map_hi,
                                        const CUtensorMap* map_lo, int brow0, int bstride) {
  for (int t = 0; t < nk; ++t) {
    const int s = t % STAGES;
    uint8_t* const st = r.stages + s * STAGE_BYTES;
    if (t >= STAGES) mbar_wait(&r.empty[s], ((t / STAGES) - 1) & 1);
    mbar_expect_tx(&r.full[s], STAGE_BYTES);
    const bool first = t < nka;
    const int k0 = (first ? t : t - nka) * BK;
    tma_load_2d(st, first ? map_a : map_a2, k0, row0, &r.full[s]);
    const int kb = first ? k0 : koff + k0;
#pragma unroll
    for (int g = 0; g < BN / BOX_N; ++g) {
      const int row = brow0 + g * bstride;
      tma_load_2d(st + A_BYTES + g * BOX_N * 128, map_hi, kb, row, &r.full[s]);
      tma_load_2d(st + A_BYTES + B_BYTES + g * BOX_N * 128, map_lo, kb, row, &r.full[s]);
    }
  }
}

// A consumer warpgroup (wg 0 or 1: rows 64 wg .. of the tile): acc (the
// m64n128 fragment, zeroed by the caller) += its A rows times the weight
// tile, over nk stages.
__device__ __forceinline__ void consume(const Ring& r, float (&acc)[64], int nk, int wg) {
  float part[64];                             // one stage's products
  const uint32_t frag = a_frag(r.stages, wg);
  for (int t = 0; t < nk; ++t) {
    const int s = t % STAGES;
    mbar_wait(&r.full[s], (t / STAGES) & 1);
    const uint8_t* const st = r.stages + s * STAGE_BYTES;
    uint32_t hi[BK / 8][4], lo[BK / 8][4];
    split_a(frag + s * STAGE_BYTES, hi, lo);
    fence_regs(part);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      const uint64_t dh = desc_a(st + A_BYTES + kk * 32);
      const uint64_t dl = desc_a(st + A_BYTES + B_BYTES + kk * 32);
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
}

}  // namespace tf32x3

// ---- device: 2xTF32, float32 x times an int8 weight on the tensor cores ---------
//
// An int8 weight is exact in TF32 (|q| <= 127: 7 significant bits of 11),
// so q_lo = 0 and 3xTF32 loses its a_hi * b_lo product: each k8 step sums
// x_lo * q + x_hi * q, which keeps float32 accuracy at half the TF32 rate.
// x is split in registers as in tf32x3 (split_a); q stays int8 in device
// memory, (Kp, Np) as ops/quant.py stores it, and reaches wgmma's K-major
// B through the widening stage (i8_producer with TF32: TMA into an int8
// staging tile, widen_i8_tile_tf32 into B).  As in tf32x3, each stage's
// products go into a fresh accumulator that is then added into the
// float32 result.  The two consumer warpgroups multiply side by side:
// taking the tensor cores in turns, to hide one's split under the other's
// products, measured a quarter slower (PERF.md, the tf32x2 findings), as
// one warpgroup's chain of eight dependent products alone does not keep
// the tensor cores busy.
//
// One tile shape serves K1-int8 and K3: BM = 128 rows (two consumer
// warpgroups of 64) by BN = 128 columns of q, 32 K-values a stage.  A stage
// is A (128 x 32 float32, 16 KB), B (q widened, 128 x 32 float32, 16 KB)
// and the staging tile (32 x 128 int8, 4 KB), 36 KB; a ring of 5.
// Barriers per stage: full (TMA: A and the staging tile), ready (widened;
// 128 arrivals after a proxy fence each), empty (both consumer warpgroups).
// The producer warpgroup widens on 40 registers and gives the rest to the
// consumers (setmaxnreg 40 / 232), whose result and stage partial are 128
// floats a thread; ptxas holds the kernel to 168 (384 threads), so a
// second set of A fragments, to split a stage under the previous one's
// products, spills.
namespace tf32x2 {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int STAGES = 5;
constexpr int A_BYTES = BM * BK * 4;
constexpr int B_BYTES = BN * BK * 4;       // q's tile widened to float32, K-major
constexpr int Q_BYTES = BK * BN;           // q's int8 staging tile
constexpr int STAGE_BYTES = A_BYTES + B_BYTES + Q_BYTES;
constexpr int NT = 3 * 128;                // two consumer warpgroups, one producer warpgroup
constexpr int PRODUCER_REGS = 40;          // setmaxnreg: 2 x 128 x 232 + 128 x 40 <= 65,536
constexpr int CONSUMER_REGS = 232;
constexpr int SMEM = i8_ring_smem(STAGES, STAGE_BYTES);

// The ring (an I8Ring); every thread of the block calls this.
__device__ __forceinline__ I8Ring ring_init(uint8_t* smem_raw) {
  return i8_ring_init<STAGES, STAGE_BYTES>(smem_raw);
}

// The producer warpgroup (all 128 threads; tid the index in it): x's rows
// row0 .., q's columns col0 .., nk stages of 32 K-values.  A stage past
// x's K reads zeros (TMA's fill), which zero its products.
__device__ __forceinline__ void produce(const I8Ring& r, const CUtensorMap* map_x,
                                        const CUtensorMap* map_q, int row0, int col0, int nk,
                                        int tid) {
  i8_producer<BM, BK, BN, STAGES, true>(map_x, map_q, r, row0, col0, nk, tid);
}

// A consumer warpgroup (wg 0 or 1: rows 64 wg .. of the tile): acc (the
// m64n128 fragment, zeroed by the caller) += its A rows times the widened
// q tile, over nk stages.
__device__ __forceinline__ void consume(const I8Ring& r, float (&acc)[64], int nk, int wg) {
  float part[64];                             // one stage's products
  const uint32_t frag = a_frag(r.stages, wg);
  for (int t = 0; t < nk; ++t) {
    const int s = t % STAGES;
    const uint32_t ph = (t / STAGES) & 1;
    mbar_wait(&r.full[s], ph);                // x's box
    mbar_wait(&r.ready[s], ph);               // the widened q tile
    const uint8_t* const st = r.stages + s * STAGE_BYTES;
    uint32_t hi[BK / 8][4], lo[BK / 8][4];
    split_a(frag + s * STAGE_BYTES, hi, lo);
    fence_regs(part);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      const uint64_t dq = desc_a(st + A_BYTES + kk * 32);
      wgmma_m64n128k8_tf32(part, lo[kk], dq, kk > 0);   // the first starts the partial
      wgmma_m64n128k8_tf32(part, hi[kk], dq, 1);
    }
    wgmma_commit();
    fence_regs(part);
    wgmma_wait<0>();
    fence_regs(part);
    if (threadIdx.x % 128 == 0) mbar_arrive(&r.empty[s]);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[i];
  }
}

}  // namespace tf32x2

}  // namespace hopper
}  // namespace sicz
