// Tiled flash attention for Hopper (sm_90a): forward, dq and dk/dv kernels
// shared by flash_attention_gqa.cu (causal or full attention, GQA and, at
// G = 1, multi-head) and splash_attention.cu (a block-sparse pattern).
// Each source instantiates the kernels with its own Walk, which says
//   * which key tiles a block of queries visits (forward, dq) and which
//     query tiles a block of keys visits (dk/dv), in order, and whether a
//     visited tile is partial (some of its (query, key) pairs masked);
//   * dead(pos, key): whether the pair is masked, asked only in a partial
//     tile;
//   * kEmptyRows: whether a row may meet a tile in which all its pairs are
//     masked before its first live key (then the forward zeroes each
//     masked probability, which exp2(s - m) does not while m is -1e30).
// The functions, with the same roundings as the TPU kernels:
//
//   q (B, Hkv*G, Sq, D), k/v (B, Hkv, Sk, D), head h = kv_head*G + g
//   q2 = round_T(q * sm_scale * log2(e))           scores in the exp2 domain
//   s  = q2 . k (f32 sums), -1e30 where the pair is masked
//   forward: online softmax over the visited key tiles (m, l, acc in f32),
//            p = exp2(s - m), exactly 0 where the pair is masked (also while
//            m is still -1e30); acc gathers round_T(p) . v; out = acc / l,
//            rounded to T; lse = ln2*m + log(l), natural log, f32
//            (B, Hq, Sq). A row with no live key: out = 0, lse = -1e30
//   dq:  p = exp2(s - lse*log2(e)), 0 where masked (lse may be -1e30 there),
//        ds = p*(do.v - delta)*sm_scale, dq = round_T(ds) . k
//        (delta = rowsum(do*out))
//   dkv: k2 = round_T(k * sm_scale * log2(e)), s = q . k2, p as above,
//        dv = round_T(p)^T . do, dk = round_T(ds)^T . q
// T is bfloat16, float16 or float; every sum is f32. head_dim D is 64, 128
// or 256.
//
// What bounds it: operations. At the training shapes (S = 4096 or 8192,
// D = 128) each live (query, key) pair costs 4*D flops forward and 6*D /
// 8*D in the two backward kernels against a few bytes per pair, far above
// the card's ~295 flop/byte balance point. The design follows that:
//   * the 16-bit kernels (forward, dq, dk/dv; bfloat16 and float16 alike)
//     run on wgmma, Hopper's warpgroup products, fed by TMA. A CTA is one
//     warpgroup (M = 64 rows: queries in the forward and dq, keys in
//     dk/dv), two CTAs an SM (one at D = 256 in the forward, whose tiles
//     fill the shared memory); its thread 0 copies the streamed tiles (K/V
//     for the forward and dq; Q and dO for dk/dv, whose lse and delta warp
//     0 copies beside them) into a 2-stage ring of 128-byte-swizzled
//     shared memory under full/empty mbarriers, one ring ahead of the
//     products. The resident operands (q2; q2 and dO; k2 and V) are copied
//     once and scaled in place. The scores and dP come from wgmma with
//     both operands in shared memory; the online softmax, p and ds are
//     formed in the accumulators' registers (each row lies in one quad of
//     lanes) and packed to T as the register A operand of
//     the next products (the accumulator's layout is that operand's);
//     those read their B (V for O, K for dQ, dO and Q for dV and dK)
//     MN-major from the same tiles, so nothing is staged transposed. Each
//     CTA writes its own rows once: deterministic, no atomics, no f32
//     scratch. At D = 256 the backward keeps D = 128's registers by
//     splitting the output columns: two CTAs a tile, each recomputing the
//     scores over the full depth and owning 128 columns of dQ (or of dK
//     and dV);
//   * float32 runs on the CUDA cores in full f32 from shared-memory tiles
//     (simple, exact up to the order of its sums; small shapes only);
//   * one block per (batch x group of query heads, tile of query
//     positions): where G divides the row tile, the group is all G heads
//     of a kv head (G heads x 64/G positions a tile), so each K/V tile is
//     read once for the whole group, as on the TPU; where it does not
//     (G = 3, 5, 6, 7, or 64 in float32), a tile holds one query head's
//     positions and reads kv head h / G;
//   * dk/dv: one block per (batch x kv head, key tile) walks the query
//     tiles of its walk for every group of its kv head and sums in
//     registers;
//   * the mask is asked only inside partial tiles; a full tile runs the
//     products and the softmax alone;
//   * blocks of the last query tiles are launched first (causal imbalance).
// Known limits, for later work: one warpgroup a CTA waits on each tile's
// products in turn (the two CTAs of an SM cover each other's waits; in
// the forward the softmax of one tile does not overlap the scores of the
// next), the N = 64 score products are small wgmma shapes, and outputs
// are stored from registers, not by TMA.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
// a score at or below this is a masked one (real scores are far above)
constexpr float kMaskedBelow = 0.5f * kNegInf;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;

enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

using bf16 = __nv_bfloat16;
using f16 = __half;

// The 16-bit element types: rounding from f32 (to nearest even), the
// TMA maps' data type, and the name wgmma gives the type.
template <typename T> struct Elt;
template <> struct Elt<bf16> {
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  __device__ static float to_f32(bf16 x) { return __bfloat162float(x); }
  __device__ static bf16 round(float x) { return __float2bfloat16(x); }
  // two f32 -> one register of two T, lo first
  __device__ static uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};
template <> struct Elt<f16> {
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  __device__ static float to_f32(f16 x) { return __half2float(x); }
  __device__ static f16 round(float x) { return __float2half_rn(x); }
  __device__ static uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

// The query heads a row tile holds: all G of a kv head where G divides the
// tile's rows, else one (the tile is then one head's positions).
__host__ __device__ constexpr int group_tile(int G, int rows) {
  return rows % G == 0 ? G : 1;
}

// Copy `rows` rows of D floats into shared memory (row stride LD). Row r
// is read from src + ((r / rpg) * gstride + r % rpg) * D: rpg rows per
// head, heads gstride rows apart. With scale != 0 each element is
// multiplied by scale.
template <int D, int LD, int NT>
__device__ __forceinline__ void copy_rows(float* dst,
                                          const float* __restrict__ src,
                                          int rows, int rpg, int gstride,
                                          float scale) {
  constexpr int PER_ROW = D / 4;
  for (int e = threadIdx.x; e < rows * PER_ROW; e += NT) {
    const int r = e / PER_ROW, c = (e % PER_ROW) * 4;
    const size_t row = (size_t)(r / rpg) * gstride + r % rpg;
    float4 p = *reinterpret_cast<const float4*>(src + row * D + c);
    if (scale != 0.f) {
      p.x *= scale;
      p.y *= scale;
      p.z *= scale;
      p.w *= scale;
    }
    *reinterpret_cast<float4*>(dst + r * LD + c) = p;
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 1));
  return fmaxf(v, __shfl_xor_sync(kFull, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}

// exp2(s - m) of a score; exactly 0 for a masked one where a row may
// still have m = -1e30 (elsewhere exp2(-1e30 - m) is 0 already)
template <class Walk>
__device__ __forceinline__ float prob(float s, float m) {
  if constexpr (Walk::kEmptyRows) return s > kMaskedBelow ? exp2f(s - m) : 0.f;
  return exp2f(s - m);
}

// =========================================================================
// 16-bit kernels: wgmma fed by TMA through mbarrier rings
// =========================================================================
//
// A CTA is one warpgroup (128 threads: the wgmma M of 64 rows). Its thread
// 0 also produces: it issues the TMA copies of the streamed tiles into a
// ring of kStages stages, each guarded by a full and an empty mbarrier,
// one ring ahead of the products (in dk/dv all of warp 0, whose lanes also
// copy the streamed rows' lse and delta with cp.async). (A producer warp of its own would need
// setmaxnreg to hand its registers to the consumers; ptxas did not raise
// the consumers' budget for it, and at 128 registers a thread the dk/dv
// accumulators spill. One warpgroup of two CTAs an SM has 255.) Tiles are
// 64 rows of D 16-bit elements in 128-byte-swizzled shared memory: a row
// is D / 64 boxes of 64 columns, each 64 * 128 bytes after the one
// before. wgmma reads such a tile K-major (rows are M or N, columns K) or,
// with its transpose bit, MN-major (rows are K, columns N), so no operand
// is ever staged transposed.

constexpr int kRows = 64;     // query rows of a forward / dq block
constexpr int kKeys = 64;     // keys per tile
constexpr int kDkvRows = 64;  // query rows per tile of a dk/dv block
constexpr int kBwdThreads = 128;                // one warpgroup
constexpr int kStages = 2;
constexpr int kHalf = 64;                       // 16-bit columns of a box
constexpr int kBox = 64 * 128;                  // bytes of a 64-row box
constexpr int kSplit = 128;   // output columns of a backward CTA at most

struct Maps {  // TMA maps of the four 16-bit operands, encoded per call
  CUtensorMap q, dout, k, v;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Wait for the phase of `parity` to complete. A barrier that never
// completes is a fault of the kernel: trap rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (n == (1u << 22)) __trap();
  }
}

// TMA: one box of a 2-D / 3-D map into shared memory, completion counted
// in bytes on `bar`
__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map,
                                       uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1) : "memory");
}

__device__ __forceinline__ void tma_3d(void* dst, const CUtensorMap* map,
                                       uint64_t* bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2) : "memory");
}

// coordinates out of bounds (a paged pool's bad page id) fill zeros
__device__ __forceinline__ void tma_4d(void* dst, const CUtensorMap* map,
                                       uint64_t* bar, int c0, int c1, int c2,
                                       int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3) : "memory");
}

// 4 bytes from global to shared memory, asynchronously; cp_async_arrive
// then counts one arrival on `bar` once all of this thread's copies have
// landed (the barrier's expected count includes it)
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// Generic-proxy writes to shared memory, made visible to wgmma and TMA
// (the async proxy); a barrier must follow before they read.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// Tie the accumulators to the asm statements around them, so the compiler
// neither reads them before wgmma_wait nor writes them after wgmma_fence.
template <int N> __device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (in 16-byte units).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}

// k-step kk (16 columns) of a 64-row tile read K-major: 8-row groups 1024
// bytes apart (SBO), the step 32 bytes into the swizzled row of its box
// kk / 4 (the swizzle is applied to the address, so tiles are
// 1024-aligned).
__device__ __forceinline__ uint64_t desc_k(const void* tile, int kk) {
  return sw128_desc(smem_u32(tile) + (kk / 4) * kBox + (kk % 4) * 32, 16,
                    1024);
}

// k-step kk (16 rows) of a 64-row tile read MN-major from column box
// `box` on: 8-row groups 1024 bytes apart (SBO), each further box of 64
// columns kBox bytes on (LBO), for N of 64, 128 or 256 columns.
__device__ __forceinline__ uint64_t desc_mn(const void* tile, int kk,
                                            int box = 0) {
  return sw128_desc(smem_u32(tile) + box * kBox + kk * 16 * 128, kBox, 1024);
}

// The wgmma instructions, one macro per shape with the element type's PTX
// name TY ("bf16" or "f16"); f32 accumulators in every case.
// d (64 x 64 f32) (+)= A (64 x 16, shared, K-major) . B (16 x 64, shared,
// K-major); scale_d 0 overwrites d
#define WGMMA_SS(TY)                                                            \
  asm volatile(                                                                 \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                              \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "               \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"  \
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"  \
      " %30, %31}, "                                                            \
      "%32, %33, p, 1, 1, 0, 0;\n}\n"                                           \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),             \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),             \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),        \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),        \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),        \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),        \
        "+f"(d[30]), "+f"(d[31])                                                \
      : "l"(a), "l"(b), "r"(scale_d))

// d (64 x 64 f32) += A (64 x 16, registers) . B (16 x 64, shared,
// MN-major)
#define WGMMA_RS64(TY)                                                          \
  asm volatile(                                                                 \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                              \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "               \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"  \
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"  \
      " %30, %31}, "                                                            \
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                             \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),             \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),             \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),        \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),        \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),        \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),        \
        "+f"(d[30]), "+f"(d[31])                                                \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))

// d (64 x 128 f32) += A (64 x 16, registers) . B (16 x 128, shared,
// MN-major)
#define WGMMA_RS128(TY)                                                         \
  asm volatile(                                                                 \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                              \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "              \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"  \
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"  \
      " %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"  \
      " %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57,"  \
      " %58, %59, %60, %61, %62, %63}, "                                        \
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                             \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),             \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),             \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),        \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),        \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),        \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),        \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),        \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),        \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),        \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),        \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),        \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),        \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                      \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))

// d (64 x 256 f32) += A (64 x 16, registers) . B (16 x 256, shared,
// MN-major)
#define WGMMA_RS256(TY)                                                         \
  asm volatile(                                                                 \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"                             \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " "              \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"  \
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"  \
      " %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"  \
      " %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57,"  \
      " %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"  \
      " %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85,"  \
      " %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99,"  \
      " %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110,"      \
      " %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121,"      \
      " %122, %123, %124, %125, %126, %127}, "                                  \
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"                        \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),             \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),             \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),        \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),        \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),        \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),        \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),        \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),        \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),        \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),        \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),        \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),        \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),        \
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),        \
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),        \
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),        \
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),        \
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),        \
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),        \
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),        \
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),                 \
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),                 \
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),                 \
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),                 \
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),                 \
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),                 \
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])                  \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))

template <typename T>
__device__ __forceinline__ void wgmma_ss64(float* d, uint64_t a, uint64_t b,
                                          int scale_d) {
  if constexpr (std::is_same_v<T, f16>) WGMMA_SS("f16");
  else WGMMA_SS("bf16");
}

// d (64 x N f32) += A (64 x 16, registers) . B (16 x N, shared, MN-major),
// N = 64, 128 or 256
template <typename T, int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t b) {
  constexpr bool half = std::is_same_v<T, f16>;
  static_assert(N == 64 || N == 128 || N == 256, "wgmma_rs: N");
  if constexpr (N == 64) {
    if constexpr (half) WGMMA_RS64("f16"); else WGMMA_RS64("bf16");
  } else if constexpr (N == 128) {
    if constexpr (half) WGMMA_RS128("f16"); else WGMMA_RS128("bf16");
  } else {
    if constexpr (half) WGMMA_RS256("f16"); else WGMMA_RS256("bf16");
  }
}

#undef WGMMA_SS
#undef WGMMA_RS64
#undef WGMMA_RS128
#undef WGMMA_RS256

// The A operands of the next products from a 64-column accumulator,
// rounded to T: k-step kk takes columns 16kk..16kk+15, and the
// accumulator's layout of them is wgmma's register A layout.
template <typename T>
__device__ __forceinline__ void acc_to_a(uint32_t (*a)[4], const float* d) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = Elt<T>::pack(d[8 * kk], d[8 * kk + 1]);
    a[kk][1] = Elt<T>::pack(d[8 * kk + 2], d[8 * kk + 3]);
    a[kk][2] = Elt<T>::pack(d[8 * kk + 4], d[8 * kk + 5]);
    a[kk][3] = Elt<T>::pack(d[8 * kk + 6], d[8 * kk + 7]);
  }
}

// x <- round(x * scale) over n elements of a tile, by the warpgroup. The
// swizzle only permutes 16-byte chunks, so this pass need not know it.
template <typename T>
__device__ __forceinline__ void scale_tile(T* tile, int n, float scale) {
  union Pack {
    uint4 u;
    T t[8];
  };
  for (int e = threadIdx.x; e < n / 8; e += kBwdThreads) {
    Pack p;
    p.u = reinterpret_cast<const uint4*>(tile)[e];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      p.t[i] = Elt<T>::round(Elt<T>::to_f32(p.t[i]) * scale);
    reinterpret_cast<uint4*>(tile)[e] = p.u;
  }
}

// Shared memory, from a 1024-aligned base. Forward: tile 0 the resident
// q2, tiles 1 + 2s and 2 + 2s the K and V tiles of stage s. Backward:
// tiles 0 and 1 resident, tiles 2 + 2s and 3 + 2s the two streamed tiles
// of stage s, then per stage the streamed rows' lse and delta (dk/dv).
// Each tile is 64 rows of D 16-bit elements. Then the barriers:
// full[kStages], empty[kStages] and one for the resident tiles.
template <int D> __host__ __device__ constexpr int tile_bytes() {
  return 64 * D * 2;
}
constexpr size_t kBarrierBytes = (2 * kStages + 1) * sizeof(uint64_t);
template <int D> constexpr size_t fwd_smem() {
  return 1024 + (1 + 2 * kStages) * tile_bytes<D>() + kBarrierBytes;
}
template <int D> constexpr size_t bwd_smem() {
  return 1024 + (2 + 2 * kStages) * tile_bytes<D>() +
         kStages * 128 * sizeof(float) + kBarrierBytes;
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

template <int D> __device__ __forceinline__ float* bwd_rows(unsigned char* sm) {
  return reinterpret_cast<float*>(sm + (2 + 2 * kStages) * tile_bytes<D>());
}

// The barriers at `at`; thread 0 sets them up. A full barrier completes on
// its TMA bytes and `full_count` arrivals, an empty one when all four
// warps have released the stage.
__device__ __forceinline__ uint64_t* ring_barriers(void* at, int full_count) {
  uint64_t* bar = reinterpret_cast<uint64_t*>(at);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&bar[s], full_count);
      mbar_init(&bar[kStages + s], kBwdThreads / 32);
    }
    mbar_init(&bar[2 * kStages], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return bar;
}

// Thread 0's copy of a tile of query rows (3-D map, at position row0 of
// heads head0..), as D / kHalf boxes, completing on `bar` (whose expected
// bytes the caller has set).
template <int D>
__device__ __forceinline__ void load_rows(unsigned char* dst, uint64_t* bar,
                                          const CUtensorMap* a, int row0,
                                          int head0) {
#pragma unroll
  for (int h = 0; h < D / kHalf; ++h)
    tma_3d(dst + h * kBox, a, bar, h * kHalf, row0, head0);
}

// Thread 0's copies of a pair of tiles, completing on `bar`: q and dout
// rows (3-D maps, at position row0 of heads head0..) or k and v rows (2-D
// maps, at row0), as D / kHalf boxes each.
template <int D>
__device__ __forceinline__ void load_pair(unsigned char* dst, uint64_t* bar,
                                          const CUtensorMap* a,
                                          const CUtensorMap* b, int rank,
                                          int row0, int head0) {
  constexpr int T = tile_bytes<D>();
  mbar_expect_tx(bar, 2 * T);
  if (rank == 3) {
    load_rows<D>(dst, bar, a, row0, head0);
    load_rows<D>(dst + T, bar, b, row0, head0);
    return;
  }
#pragma unroll
  for (int h = 0; h < D / kHalf; ++h) {
    tma_2d(dst + h * kBox, a, bar, h * kHalf, row0);
    tma_2d(dst + T + h * kBox, b, bar, h * kHalf, row0);
  }
}

// The end of a streamed tile: each warp releases stage s; the producer
// threads (thread 0 in the forward and dq, warp 0 in dk/dv) then wait
// until all four have and refill it with tile i + kStages of the walk
// (`load(i + kStages)`), so the copies run one ring ahead.
template <class Load>
__device__ __forceinline__ void release(uint64_t* bar, int i, int n,
                                        int producers, const Load& load) {
  const int s = i % kStages;
  __syncwarp();
  if (threadIdx.x % 32 == 0) mbar_arrive(&bar[kStages + s]);
  if (threadIdx.x < producers && i + kStages < n) {
    mbar_wait(&bar[kStages + s], (i / kStages) & 1);
    load(i + kStages);
  }
  __syncwarp();
}

// Forward: one CTA per (batch x group of GT query heads, 64-row query
// tile: GT heads x 64 / GT positions). q2 is resident; the K/V tiles of
// the walk stream through the ring. Per tile: S = q2 . K^T (wgmma, both
// operands in shared memory, K-major), the mask where the tile is
// partial, the online softmax in the accumulators' registers (a row's 64
// scores lie in one quad of lanes), O *= alpha, then O += round(p) . V
// (p as the register A operand, V read MN-major, N = D). out = O / l and
// lse are written from registers at the end.
template <int D, class Walk, typename T>
// two CTAs an SM; one at D = 256, whose tiles fill the shared memory
__global__ void __launch_bounds__(kBwdThreads, D > 128 ? 1 : 2)
fwd_mma(const __grid_constant__ Maps maps, T* __restrict__ out,
        float* __restrict__ lse, int BHg, int G, int GT, int Sq, int Sk,
        float scale_log2, int n_q_tiles, Walk walk) {
  constexpr int TB = tile_bytes<D>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  uint64_t* bar = ring_barriers(sm + (1 + 2 * kStages) * TB, 1);

  const int hg = blockIdx.x % BHg;                 // group of GT heads
  const int qt = n_q_tiles - 1 - blockIdx.x / BHg;  // longest rows first
  const int bh = hg / (G / GT);                    // its kv head
  const int BQ = kRows / GT;
  const int p0 = qt * BQ;
  const int n_k = walk.row_count(qt, p0, BQ, kKeys);
  const auto load = [&](int i) {  // tile i of the walk into its stage
    bool partial;
    const int k0 = walk.row_tile(qt, i, partial) * kKeys;
    load_pair<D>(sm + (1 + 2 * (i % kStages)) * TB, &bar[i % kStages],
                 &maps.k, &maps.v, 2, bh * Sk + k0, 0);
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(&bar[2 * kStages], TB);
    load_rows<D>(sm, &bar[2 * kStages], &maps.q, p0, hg * GT);
    for (int i = 0; i < kStages && i < n_k; ++i) load(i);
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = warp * 16 + g, r1 = r0 + 8;  // this lane's two rows
  const int pos0 = p0 + r0 % BQ, pos1 = p0 + r1 % BQ;
  T* q_s = reinterpret_cast<T*>(sm);

  mbar_wait(&bar[2 * kStages], 0);
  scale_tile<T>(q_s, 64 * D, scale_log2);  // q2, in place
  fence_proxy_async();
  __syncthreads();

  float o[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) o[e] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  for (int i = 0; i < n_k; ++i) {
    const int s = i % kStages;
    bool partial;
    const int k0 = walk.row_tile(qt, i, partial) * kKeys;
    const unsigned char* k_s = sm + (1 + 2 * s) * TB;
    const unsigned char* v_s = sm + (2 + 2 * s) * TB;
    mbar_wait(&bar[s], (i / kStages) & 1);

    float st[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss64<T>(st, desc_k(q_s, kk), desc_k(k_s, kk), kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<32>(st);
    // st[e]: row (e / 2) % 2 ? r1 : r0, key k0 + 8 * (e / 4) + 2t + e % 2
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const bool hi = (e / 2) % 2;
      if (partial &&
          walk.dead(hi ? pos1 : pos0, k0 + 8 * (e / 4) + 2 * t + e % 2))
        st[e] = kNegInf;
      if (hi) mx1 = fmaxf(mx1, st[e]);
      else mx0 = fmaxf(mx0, st[e]);
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      if ((e / 2) % 2) {
        st[e] = prob<Walk>(st[e], mn1);
        sum1 += st[e];
      } else {
        st[e] = prob<Walk>(st[e], mn0);
        sum0 += st[e];
      }
    }
    l0 = al0 * l0 + quad_sum(sum0);
    l1 = al1 * l1 + quad_sum(sum1);
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int e = 0; e < D / 2; ++e) o[e] *= (e / 2) % 2 ? al1 : al0;
    uint32_t pa[4][4];
    acc_to_a<T>(pa, st);
    fence_regs<D / 2>(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<T, D>(o, pa[kk], desc_mn(v_s, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<D / 2>(o);
    release(bar, i, n_k, 1, load);
  }

  // a row with no live key has l = 0 and acc = 0: out 0, lse -1e30
  const float d0 = l0 == 0.f ? 1.f : l0, d1 = l1 == 0.f ? 1.f : l1;
  const size_t head0 = (size_t)hg * GT * Sq + p0;
  const size_t row0 = head0 + (size_t)(r0 / BQ) * Sq + r0 % BQ;
  const size_t row1 = head0 + (size_t)(r1 / BQ) * Sq + r1 % BQ;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = j * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(out + row0 * D + c) =
        Elt<T>::pack(o[4 * j] / d0, o[4 * j + 1] / d0);
    *reinterpret_cast<uint32_t*>(out + row1 * D + c) =
        Elt<T>::pack(o[4 * j + 2] / d1, o[4 * j + 3] / d1);
  }
  if (t == 0) {
    lse[row0] = l0 == 0.f ? kNegInf : kLn2 * m0 + logf(d0);
    lse[row1] = l1 == 0.f ? kNegInf : kLn2 * m1 + logf(d1);
  }
}

// Output columns of a backward CTA: all D up to kSplit, else kSplit of
// them (D / kSplit CTAs a tile, each recomputing the scores).
template <int D> __host__ __device__ constexpr int out_cols() { return D > kSplit ? kSplit : D; }

// dq: one CTA per (batch x group of GT query heads, 64-row query tile,
// block of output columns). q2 and dO are resident; the K/V tiles of the
// walk stream through the ring. Per tile: S = q2 . K^T and dP = dO . V^T
// (wgmma, both operands in shared memory, K-major, over all D), p and ds
// in the accumulators' registers, dQ += round(ds) . K (ds as the register
// A operand, K's columns of this CTA read MN-major).
template <int D, class Walk, typename T>
__global__ void __launch_bounds__(kBwdThreads, 2)
dq_mma(const __grid_constant__ Maps maps, const float* __restrict__ lse,
       const float* __restrict__ delta, T* __restrict__ dq, int BHg, int G,
       int GT, int Sq, int Sk, float scale_log2, float sm_scale,
       int n_q_tiles, Walk walk) {
  constexpr int TB = tile_bytes<D>();
  constexpr int DC = out_cols<D>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  uint64_t* bar = ring_barriers(bwd_rows<D>(sm) + kStages * 128, 1);

  const int col0 = (blockIdx.x % (D / DC)) * DC;  // this CTA's columns
  const int blk = blockIdx.x / (D / DC);
  const int hg = blk % BHg;
  const int qt = n_q_tiles - 1 - blk / BHg;  // longest rows first
  const int bh = hg / (G / GT);
  const int BQ = kRows / GT;
  const int p0 = qt * BQ;
  const int n_k = walk.row_count(qt, p0, BQ, kKeys);
  const auto load = [&](int i) {  // tile i of the walk into its stage
    bool partial;
    const int k0 = walk.row_tile(qt, i, partial) * kKeys;
    load_pair<D>(sm + (2 + 2 * (i % kStages)) * TB, &bar[i % kStages],
                 &maps.k, &maps.v, 2, bh * Sk + k0, 0);
  };
  if (threadIdx.x == 0) {
    load_pair<D>(sm, &bar[2 * kStages], &maps.q, &maps.dout, 3, p0, hg * GT);
    for (int i = 0; i < kStages && i < n_k; ++i) load(i);
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = warp * 16 + g, r1 = r0 + 8;  // this lane's two rows
  const int pos0 = p0 + r0 % BQ, pos1 = p0 + r1 % BQ;
  const size_t head0 = (size_t)hg * GT * Sq + p0;
  const size_t row0 = head0 + (size_t)(r0 / BQ) * Sq + r0 % BQ;
  const size_t row1 = head0 + (size_t)(r1 / BQ) * Sq + r1 % BQ;
  const float ls0 = lse[row0] * kLog2e, ls1 = lse[row1] * kLog2e;
  const float dl0 = delta[row0], dl1 = delta[row1];
  T* q_s = reinterpret_cast<T*>(sm);
  const unsigned char* do_s = sm + TB;

  mbar_wait(&bar[2 * kStages], 0);
  scale_tile<T>(q_s, 64 * D, scale_log2);  // q2, in place
  fence_proxy_async();
  __syncthreads();

  float acc[DC / 2];
#pragma unroll
  for (int e = 0; e < DC / 2; ++e) acc[e] = 0.f;
  for (int i = 0; i < n_k; ++i) {
    const int s = i % kStages;
    bool partial;
    const int k0 = walk.row_tile(qt, i, partial) * kKeys;
    const unsigned char* k_s = sm + (2 + 2 * s) * TB;
    const unsigned char* v_s = sm + (3 + 2 * s) * TB;
    mbar_wait(&bar[s], (i / kStages) & 1);

    float st[32], dpt[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss64<T>(st, desc_k(q_s, kk), desc_k(k_s, kk), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss64<T>(dpt, desc_k(do_s, kk), desc_k(v_s, kk), kk);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs<32>(st);
    // p = exp2(s - lse * log2 e), exactly 0 on a masked pair
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int hi = (e / 2) % 2;
      const int key = k0 + 8 * (e / 4) + 2 * t + e % 2;
      st[e] = (partial && walk.dead(hi ? pos1 : pos0, key))
                  ? 0.f : exp2f(st[e] - (hi ? ls1 : ls0));
    }
    wgmma_wait<0>();
    fence_regs<32>(dpt);
    // ds = p * (dp - delta) * sm_scale
#pragma unroll
    for (int e = 0; e < 32; ++e)
      dpt[e] = st[e] * (dpt[e] - ((e / 2) % 2 ? dl1 : dl0)) * sm_scale;
    uint32_t dsa[4][4];
    acc_to_a<T>(dsa, dpt);
    fence_regs<DC / 2>(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<T, DC>(acc, dsa[kk], desc_mn(k_s, kk, col0 / kHalf));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<DC / 2>(acc);
    release(bar, i, n_k, 1, load);
  }
#pragma unroll
  for (int j = 0; j < DC / 8; ++j) {
    const int c = col0 + j * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(dq + row0 * D + c) =
        Elt<T>::pack(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(dq + row1 * D + c) =
        Elt<T>::pack(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// dk/dv: one CTA per (batch x kv head, 64-key tile, block of output
// columns); low key tiles first (causal: they do the most work). k2 and V
// are resident; the query tiles of the walk (64 rows: GT heads x BQ
// positions), for each of the G / GT groups of the kv head in turn,
// stream through the ring. Per tile: S^T = k2 . Q^T and dP^T = V . dO^T
// (wgmma, shared memory, K-major, over all D), p^T and ds^T in registers
// (each lane reads the lse and delta of its 16 query rows while the
// products run), then dV += round(p)^T . dO and dK += round(ds)^T . Q with
// p^T / ds^T as the register A operand and this CTA's columns of dO / Q
// read MN-major from the same tiles. dK and dV are written once at the
// end: no atomics.
template <int D, class Walk, typename T>
__global__ void __launch_bounds__(kBwdThreads, 2)
dkv_mma(const __grid_constant__ Maps maps, const float* __restrict__ lse,
        const float* __restrict__ delta, T* __restrict__ dk,
        T* __restrict__ dv, int BH, int G, int GT, int Sq, int Sk,
        float scale_log2, float sm_scale, Walk walk) {
  constexpr int TB = tile_bytes<D>();
  constexpr int DC = out_cols<D>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  float* rows_s = bwd_rows<D>(sm);
  // 32 lanes' rows and the TMA
  uint64_t* bar = ring_barriers(rows_s + kStages * 128, 33);

  const int col0 = (blockIdx.x % (D / DC)) * DC;  // this CTA's columns
  const int blk = blockIdx.x / (D / DC);
  const int bh = blk % BH;
  const int kt = blk / BH;
  const int k0 = kt * kKeys;
  const int BQ = kDkvRows / GT;
  const int n_q = walk.col_count(kt, k0, BQ);  // query tiles of one group
  const int n = (G / GT) * n_q;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bq_log2 = __ffs(BQ) - 1;
  // by warp 0, in order of i: tile i (query tile i % n_q of the walk, for
  // the group of heads from hq0 = bh * G + (i / n_q) * GT, both counted up
  // here) into its stage, with its rows' lse and delta (row r: head
  // hq0 + r / BQ, position p0 + r % BQ)
  int load_tile = 0, hq0 = bh * G;
  const auto load = [&](int i) {
    const int s = i % kStages;
    bool partial;
    const int p0 = walk.col_tile(kt, k0, BQ, load_tile, partial) * BQ;
    const size_t head0 = (size_t)hq0 * Sq + p0;
    for (int r = lane; r < kDkvRows; r += 32) {
      const size_t row = head0 + (size_t)(r >> bq_log2) * Sq + (r & (BQ - 1));
      cp_async4(rows_s + s * 128 + r, lse + row);
      cp_async4(rows_s + s * 128 + 64 + r, delta + row);
    }
    cp_async_arrive(&bar[s]);
    if (lane == 0)
      load_pair<D>(sm + (2 + 2 * s) * TB, &bar[s], &maps.q, &maps.dout, 3,
                   p0, hq0);
    if (++load_tile == n_q) {
      load_tile = 0;
      hq0 += GT;
    }
  };
  if (warp == 0) {
    if (lane == 0)
      load_pair<D>(sm, &bar[2 * kStages], &maps.k, &maps.v, 2, bh * Sk + k0,
                   0);
    for (int i = 0; i < kStages && i < n; ++i) load(i);
  }
  __syncwarp();

  const int g = lane / 4, t = lane % 4;
  const int key0 = k0 + warp * 16 + g;  // this lane's keys: key0, key0 + 8
  T* k_s = reinterpret_cast<T*>(sm);
  const unsigned char* v_s = sm + TB;

  mbar_wait(&bar[2 * kStages], 0);
  scale_tile<T>(k_s, 64 * D, scale_log2);  // k2, in place
  fence_proxy_async();
  __syncthreads();

  float dka[DC / 2], dva[DC / 2];
#pragma unroll
  for (int e = 0; e < DC / 2; ++e) dka[e] = dva[e] = 0.f;
  // tile i of the ring: query tile `tile` of the walk for group `grp`
  for (int grp = 0, i = 0; grp < G / GT; ++grp)
  for (int tile = 0; tile < n_q; ++tile, ++i) {
    const int s = i % kStages;
    bool partial;
    const int p0 = walk.col_tile(kt, k0, BQ, tile, partial) * BQ;
    const unsigned char* q_s = sm + (2 + 2 * s) * TB;
    const unsigned char* do_s = sm + (3 + 2 * s) * TB;
    const float* ls = rows_s + s * 128;  // lse, then delta, of its rows
    mbar_wait(&bar[s], (i / kStages) & 1);

    // s^T and dp^T: rows are keys, columns the tile's query rows
    float st[32], dpt[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss64<T>(st, desc_k(k_s, kk), desc_k(q_s, kk), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss64<T>(dpt, desc_k(v_s, kk), desc_k(do_s, kk), kk);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs<32>(st);
    // p^T = exp2(s^T - lse * log2 e), exactly 0 on a masked pair
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int col = 8 * (e / 4) + 2 * t + e % 2;
      const int key = key0 + 8 * ((e / 2) % 2);
      st[e] = (partial && walk.dead(p0 + (col & (BQ - 1)), key))
                  ? 0.f : exp2f(st[e] - ls[col] * kLog2e);
    }
    uint32_t pa[4][4], dsa[4][4];
    acc_to_a<T>(pa, st);
    fence_regs<DC / 2>(dva);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<T, DC>(dva, pa[kk], desc_mn(do_s, kk, col0 / kHalf));
    wgmma_commit();
    wgmma_wait<1>();  // dP^T is in; dV may still run
    fence_regs<32>(dpt);
    // ds^T = p^T * (dp^T - delta) * sm_scale
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int col = 8 * (e / 4) + 2 * t + e % 2;
      dpt[e] = st[e] * (dpt[e] - ls[64 + col]) * sm_scale;
    }
    acc_to_a<T>(dsa, dpt);
    fence_regs<DC / 2>(dka);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<T, DC>(dka, dsa[kk], desc_mn(q_s, kk, col0 / kHalf));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<DC / 2>(dka);
    fence_regs<DC / 2>(dva);
    release(bar, i, n, 32, load);
  }
  const size_t rk0 = ((size_t)bh * Sk + key0) * D + col0;
  const size_t rk1 = rk0 + 8 * D;
#pragma unroll
  for (int j = 0; j < DC / 8; ++j) {
    const int c = j * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(dk + rk0 + c) =
        Elt<T>::pack(dka[4 * j], dka[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(dk + rk1 + c) =
        Elt<T>::pack(dka[4 * j + 2], dka[4 * j + 3]);
    *reinterpret_cast<uint32_t*>(dv + rk0 + c) =
        Elt<T>::pack(dva[4 * j], dva[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(dv + rk1 + c) =
        Elt<T>::pack(dva[4 * j + 2], dva[4 * j + 3]);
  }
}

// =========================================================================
// float32: CUDA cores, shared-memory tiles
// =========================================================================

constexpr int kF32Threads = 256;
constexpr int kF32Warps = kF32Threads / 32;
constexpr int BM = 32;  // query rows of a block or tile (GT heads x positions)
constexpr int BK = 32;  // keys per tile

template <int D> __host__ __device__ constexpr int ldt() { return D + 4; }
constexpr int LDS = BK + 4;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// C[m][n] (+)= sum_k A(m, k) * B(k, n), f32, one thread per element of C.
// A(m, k) = A[m * lda + k], or A[k * lda + m] with A_COL; B(k, n) =
// B[k * ldb + n], or B[n * ldb + k] with B_COL; C is row-major.
template <bool A_COL, bool B_COL, bool ACC, int M, int N, int K>
__device__ __forceinline__ void tile_mm(const float* A, int lda,
                                        const float* B, int ldb, float* C,
                                        int ldc) {
  for (int e = threadIdx.x; e < M * N; e += kF32Threads) {
    const int m = e / N, n = e % N;
    float s = ACC ? C[m * ldc + n] : 0.f;
#pragma unroll 8
    for (int k = 0; k < K; ++k)
      s = fmaf(A_COL ? A[k * lda + m] : A[m * lda + k],
               B_COL ? B[n * ldb + k] : B[k * ldb + n], s);
    C[m * ldc + n] = s;
  }
}

template <int D> constexpr size_t f32_fwd_smem() {
  return sizeof(float) * ((BM + 2 * BK) * ldt<D>() + BM * LDS * 2 +
                          BM * ldt<D>() + 3 * BM);
}

template <int D, class Walk>
__global__ void __launch_bounds__(kF32Threads)
fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
        const float* __restrict__ v, float* __restrict__ out,
        float* __restrict__ lse, int BHg, int G, int GT, int Sq, int Sk,
        float scale_log2, int n_q_tiles, Walk walk) {
  constexpr int LD = ldt<D>();
  extern __shared__ __align__(128) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  float* k_s = q_s + BM * LD;
  float* v_s = k_s + BK * LD;
  float* s_s = v_s + BK * LD;
  float* p_s = s_s + BM * LDS;
  float* o_s = p_s + BM * LDS;
  float* m_s = o_s + BM * LD;
  float* l_s = m_s + BM;
  float* a_s = l_s + BM;

  const int hg = blockIdx.x % BHg;  // group of GT query heads
  const int qt = n_q_tiles - 1 - blockIdx.x / BHg;
  const int bh = hg / (G / GT);     // its kv head
  const int BQ = BM / GT;
  const int p0 = qt * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t head0 = (size_t)hg * GT * Sq + p0;

  copy_rows<D, LD, kF32Threads>(q_s, q + head0 * D, BM, BQ, Sq,
                                       scale_log2);
  for (int r = threadIdx.x; r < BM; r += kF32Threads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  for (int e = threadIdx.x; e < BM * D; e += kF32Threads)
    o_s[(e / D) * LD + e % D] = 0.f;

  const int n_k = walk.row_count(qt, p0, BQ, BK);
  const float* kb = k + (size_t)bh * Sk * D;
  const float* vb = v + (size_t)bh * Sk * D;
  for (int i = 0; i < n_k; ++i) {
    bool partial;
    const int k0 = walk.row_tile(qt, i, partial) * BK;
    __syncthreads();
    copy_rows<D, LD, kF32Threads>(k_s, kb + (size_t)k0 * D, BK, BK, 0,
                                         0.f);
    copy_rows<D, LD, kF32Threads>(v_s, vb + (size_t)k0 * D, BK, BK, 0,
                                         0.f);
    __syncthreads();
    tile_mm<false, true, false, BM, BK, D>(q_s, LD, k_s, LD, s_s, LDS);
    __syncthreads();
    for (int r = warp; r < BM; r += kF32Warps) {  // one warp per row
      const int pos = p0 + r % BQ;
      const bool masked = partial && walk.dead(pos, k0 + lane);
      const float s = masked ? kNegInf : s_s[r * LDS + lane];
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float p = prob<Walk>(s, m_new);
      p_s[r * LDS + lane] = p;
      const float sum = warp_sum(p);
      if (lane == 0) {
        const float alpha = exp2f(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = alpha * l_s[r] + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < BM * D; e += kF32Threads) {
      const int r = e / D;
      o_s[r * LD + e % D] *= a_s[r];
    }
    __syncthreads();
    tile_mm<false, false, true, BM, D, BK>(p_s, LDS, v_s, LD, o_s, LD);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < BM * D; e += kF32Threads) {
    const int r = e / D, c = e % D;
    const float l = l_s[r];
    const size_t row = head0 + (size_t)(r / BQ) * Sq + r % BQ;
    out[row * D + c] = o_s[r * LD + c] / (l == 0.f ? 1.f : l);
  }
  for (int r = threadIdx.x; r < BM; r += kF32Threads) {
    const float l = l_s[r];
    const size_t row = head0 + (size_t)(r / BQ) * Sq + r % BQ;
    lse[row] = l == 0.f ? kNegInf : kLn2 * m_s[r] + logf(l);
  }
}

template <int D> constexpr size_t f32_dq_smem() {
  return sizeof(float) * (2 * (BM + BK) * ldt<D>() + 3 * BM * LDS +
                          BM * ldt<D>() + 2 * BM);
}

template <int D, class Walk>
__global__ void __launch_bounds__(kF32Threads)
dq_f32(const float* __restrict__ q, const float* __restrict__ k,
       const float* __restrict__ v, const float* __restrict__ dout,
       const float* __restrict__ lse, const float* __restrict__ delta,
       float* __restrict__ dq, int BHg, int G, int GT, int Sq, int Sk,
       float scale_log2, float sm_scale, int n_q_tiles, Walk walk) {
  constexpr int LD = ldt<D>();
  extern __shared__ __align__(128) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  float* do_s = q_s + BM * LD;
  float* k_s = do_s + BM * LD;
  float* v_s = k_s + BK * LD;
  float* s_s = v_s + BK * LD;
  float* dp_s = s_s + BM * LDS;
  float* ds_s = dp_s + BM * LDS;
  float* dq_s = ds_s + BM * LDS;
  float* lse_s = dq_s + BM * LD;
  float* dl_s = lse_s + BM;

  const int hg = blockIdx.x % BHg;
  const int qt = n_q_tiles - 1 - blockIdx.x / BHg;
  const int bh = hg / (G / GT);
  const int BQ = BM / GT;
  const int p0 = qt * BQ;
  const size_t head0 = (size_t)hg * GT * Sq + p0;

  copy_rows<D, LD, kF32Threads>(q_s, q + head0 * D, BM, BQ, Sq,
                                       scale_log2);
  copy_rows<D, LD, kF32Threads>(do_s, dout + head0 * D, BM, BQ, Sq,
                                       0.f);
  for (int r = threadIdx.x; r < BM; r += kF32Threads) {
    const size_t row = head0 + (size_t)(r / BQ) * Sq + r % BQ;
    lse_s[r] = lse[row] * kLog2e;
    dl_s[r] = delta[row];
  }
  for (int e = threadIdx.x; e < BM * D; e += kF32Threads)
    dq_s[(e / D) * LD + e % D] = 0.f;

  const int n_k = walk.row_count(qt, p0, BQ, BK);
  const float* kb = k + (size_t)bh * Sk * D;
  const float* vb = v + (size_t)bh * Sk * D;
  for (int i = 0; i < n_k; ++i) {
    bool partial;
    const int k0 = walk.row_tile(qt, i, partial) * BK;
    __syncthreads();
    copy_rows<D, LD, kF32Threads>(k_s, kb + (size_t)k0 * D, BK, BK, 0,
                                         0.f);
    copy_rows<D, LD, kF32Threads>(v_s, vb + (size_t)k0 * D, BK, BK, 0,
                                         0.f);
    __syncthreads();
    tile_mm<false, true, false, BM, BK, D>(q_s, LD, k_s, LD, s_s, LDS);
    tile_mm<false, true, false, BM, BK, D>(do_s, LD, v_s, LD, dp_s, LDS);
    __syncthreads();
    for (int e = threadIdx.x; e < BM * BK; e += kF32Threads) {
      const int r = e / BK, c = e % BK;
      const bool masked = partial && walk.dead(p0 + r % BQ, k0 + c);
      const float p = masked ? 0.f : exp2f(s_s[r * LDS + c] - lse_s[r]);
      ds_s[r * LDS + c] = p * (dp_s[r * LDS + c] - dl_s[r]) * sm_scale;
    }
    __syncthreads();
    tile_mm<false, false, true, BM, D, BK>(ds_s, LDS, k_s, LD, dq_s, LD);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < BM * D; e += kF32Threads) {
    const int r = e / D, c = e % D;
    const size_t row = head0 + (size_t)(r / BQ) * Sq + r % BQ;
    dq[row * D + c] = dq_s[r * LD + c];
  }
}

template <int D> constexpr size_t f32_dkv_smem() {
  return sizeof(float) * (2 * (BM + BK) * ldt<D>() + 4 * BM * LDS +
                          2 * BK * ldt<D>() + 2 * BM);
}

template <int D, class Walk>
__global__ void __launch_bounds__(kF32Threads)
dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
        const float* __restrict__ v, const float* __restrict__ dout,
        const float* __restrict__ lse, const float* __restrict__ delta,
        float* __restrict__ dk, float* __restrict__ dv, int BH, int G,
        int GT, int Sq, int Sk, float scale_log2, float sm_scale,
        Walk walk) {
  constexpr int LD = ldt<D>();
  extern __shared__ __align__(128) unsigned char smem[];
  float* k_s = reinterpret_cast<float*>(smem);
  float* v_s = k_s + BK * LD;
  float* q_s = v_s + BK * LD;
  float* do_s = q_s + BM * LD;
  float* s_s = do_s + BM * LD;
  float* dp_s = s_s + BM * LDS;
  float* p_s = dp_s + BM * LDS;
  float* ds_s = p_s + BM * LDS;
  float* dk_s = ds_s + BM * LDS;
  float* dv_s = dk_s + BK * LD;
  float* lse_s = dv_s + BK * LD;
  float* dl_s = lse_s + BM;

  const int bh = blockIdx.x % BH;
  const int kt = blockIdx.x / BH;
  const int k0 = kt * BK;
  const int BQ = BM / GT;
  const size_t kv_row0 = (size_t)bh * Sk + k0;
  copy_rows<D, LD, kF32Threads>(k_s, k + kv_row0 * D, BK, BK, 0,
                                       scale_log2);
  copy_rows<D, LD, kF32Threads>(v_s, v + kv_row0 * D, BK, BK, 0, 0.f);
  for (int e = threadIdx.x; e < BK * D; e += kF32Threads) {
    const int idx = (e / D) * LD + e % D;
    dk_s[idx] = 0.f;
    dv_s[idx] = 0.f;
  }
  // the query tiles of the walk for each group of GT heads in turn
  const int n_q = walk.col_count(kt, k0, BQ);
  for (int i = 0; i < (G / GT) * n_q; ++i) {
    bool partial;
    const int p0 = walk.col_tile(kt, k0, BQ, i % n_q, partial) * BQ;
    const size_t head0 = ((size_t)bh * G + (i / n_q) * GT) * Sq + p0;
    __syncthreads();
    copy_rows<D, LD, kF32Threads>(q_s, q + head0 * D, BM, BQ, Sq,
                                         0.f);
    copy_rows<D, LD, kF32Threads>(do_s, dout + head0 * D, BM, BQ, Sq,
                                         0.f);
    for (int r = threadIdx.x; r < BM; r += kF32Threads) {
      const size_t row = head0 + (size_t)(r / BQ) * Sq + r % BQ;
      lse_s[r] = lse[row] * kLog2e;
      dl_s[r] = delta[row];
    }
    __syncthreads();
    tile_mm<false, true, false, BM, BK, D>(q_s, LD, k_s, LD, s_s, LDS);
    tile_mm<false, true, false, BM, BK, D>(do_s, LD, v_s, LD, dp_s, LDS);
    __syncthreads();
    for (int e = threadIdx.x; e < BM * BK; e += kF32Threads) {
      const int r = e / BK, c = e % BK;
      const bool masked = partial && walk.dead(p0 + r % BQ, k0 + c);
      const float p = masked ? 0.f : exp2f(s_s[r * LDS + c] - lse_s[r]);
      p_s[r * LDS + c] = p;
      ds_s[r * LDS + c] = p * (dp_s[r * LDS + c] - dl_s[r]) * sm_scale;
    }
    __syncthreads();
    tile_mm<true, false, true, BK, D, BM>(p_s, LDS, do_s, LD, dv_s, LD);
    tile_mm<true, false, true, BK, D, BM>(ds_s, LDS, q_s, LD, dk_s, LD);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < BK * D; e += kF32Threads) {
    const int r = e / D, c = e % D;
    const size_t idx = (kv_row0 + r) * D + c;
    dk[idx] = dk_s[r * LD + c];
    dv[idx] = dv_s[r * LD + c];
  }
}

// =========================================================================
// launchers
// =========================================================================

// Above 48 KB a block's shared memory must be asked for explicitly: once
// per kernel instance and device.
template <typename Kernel>
cudaError_t prepare(Kernel kern, size_t smem, bool* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

struct Shape {
  int B, Hkv, G, Sq, Sk;
  float scale_log2, sm_scale;
};

// The tiles must divide the sequences: rows/keys per tile are (64, 64)
// for the 16-bit kernels (forward, dq and dk/dv) and (32, 32) for
// float32; a tile holds group_tile(G, rows) heads.
inline bool shape_ok(const Shape& s, int rows, int keys) {
  return s.B > 0 && s.Hkv > 0 && s.G > 0 && s.Sq > 0 && s.Sk > 0 &&
         s.Sq % (rows / group_tile(s.G, rows)) == 0 && s.Sk % keys == 0;
}

// cuTensorMapEncodeTiled, taken from the driver at run time so the library
// links against the CUDA runtime alone
inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// One map of rank 1 to 5, by default 16-bit with 128-byte swizzle (the
// box's inner extent kHalf columns, 128 bytes).
inline bool encode_map(
    CUtensorMap* m, CUtensorMapDataType type, const void* ptr,
    cuuint32_t rank, const cuuint64_t* dims, const cuuint64_t* strides,
    const cuuint32_t* box,
    CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const auto encode = tensor_map_encoder();
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  return encode != nullptr &&
         encode(m, type, rank, const_cast<void*>(ptr), dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The 16-bit kernels' maps, which hold the data pointers: q and dout as
// (D, Sq, B * Hq) with a box (kHalf, 64 / GT, GT), which lands the GT
// heads x 64 / GT positions of a 64-row tile in its row order (row r:
// head r / BQ, position p0 + r % BQ); k and v as (D, B * Hkv * Sk) with a
// box (kHalf, 64). The forward passes q for dout.
template <typename T>
cudaError_t make_maps(Maps* m, const void* q, const void* dout,
                      const void* k, const void* v, const Shape& s, int D) {
  static_assert(kRows == kDkvRows, "dq and dk/dv share the query tile");
  const int GT = group_tile(s.G, kRows);
  const cuuint64_t row = (cuuint64_t)D * sizeof(T);
  const cuuint64_t qdims[3] = {(cuuint64_t)D, (cuuint64_t)s.Sq,
                               (cuuint64_t)s.B * s.Hkv * s.G};
  const cuuint64_t qstrides[2] = {row, row * s.Sq};
  const cuuint32_t qbox[3] = {kHalf, (cuuint32_t)(kRows / GT),
                              (cuuint32_t)GT};
  const cuuint64_t kdims[2] = {(cuuint64_t)D,
                               (cuuint64_t)s.B * s.Hkv * s.Sk};
  const cuuint32_t kbox[2] = {kHalf, kKeys};
  constexpr CUtensorMapDataType type = Elt<T>::kMap;
  const bool ok = encode_map(&m->q, type, q, 3, qdims, qstrides, qbox) &&
                  encode_map(&m->dout, type, dout, 3, qdims, qstrides, qbox) &&
                  encode_map(&m->k, type, k, 2, kdims, &row, kbox) &&
                  encode_map(&m->v, type, v, 2, kdims, &row, kbox);
  return ok ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename Kernel, typename... Args>
cudaError_t run(Kernel kern, size_t smem, bool* done, long long blocks,
                int threads, cudaStream_t stream, const Args&... args) {
  cudaError_t err = prepare(kern, smem, done);
  if (err != cudaSuccess) return err;
  if (blocks <= 0 || blocks > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  kern<<<(unsigned)blocks, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// The blocks of a row walk: (batch x groups of GT heads, query tiles)
struct RowGrid {
  int GT, BHg, n_q;
  RowGrid(const Shape& s, int rows)
      : GT(group_tile(s.G, rows)),
        BHg(s.B * s.Hkv * (s.G / GT)),
        n_q(s.Sq / (rows / GT)) {}
  long long blocks() const { return (long long)BHg * n_q; }
};

template <int D, class Walk, typename T>
cudaError_t fwd16(const void* q, const void* k, const void* v, void* out,
                  void* lse, const Shape& s, const Walk& w, cudaStream_t st) {
  Maps maps;
  cudaError_t err = make_maps<T>(&maps, q, q, k, v, s, D);
  if (err != cudaSuccess) return err;
  static bool done[kMaxDevices] = {};
  const RowGrid grid(s, kRows);
  return run(fwd_mma<D, Walk, T>, fwd_smem<D>(), done, grid.blocks(),
             kBwdThreads, st, maps, static_cast<T*>(out),
             static_cast<float*>(lse), grid.BHg, s.G, grid.GT, s.Sq, s.Sk,
             s.scale_log2, grid.n_q, w);
}

template <int D, class Walk>
cudaError_t fwd(int dtype, const void* q, const void* k, const void* v,
                void* out, void* lse, const Shape& s, const Walk& w,
                cudaStream_t st) {
  if (dtype != kF32) {
    if (!shape_ok(s, kRows, kKeys)) return cudaErrorInvalidValue;
    if (dtype == kBF16) return fwd16<D, Walk, bf16>(q, k, v, out, lse, s, w, st);
    return fwd16<D, Walk, f16>(q, k, v, out, lse, s, w, st);
  }
  if (!shape_ok(s, BM, BK)) return cudaErrorInvalidValue;
  static bool done[kMaxDevices] = {};
  const RowGrid grid(s, BM);
  return run(fwd_f32<D, Walk>, f32_fwd_smem<D>(), done, grid.blocks(),
             kF32Threads, st, static_cast<const float*>(q),
             static_cast<const float*>(k), static_cast<const float*>(v),
             static_cast<float*>(out), static_cast<float*>(lse), grid.BHg,
             s.G, grid.GT, s.Sq, s.Sk, s.scale_log2, grid.n_q, w);
}

template <int D, class Walk, typename T>
cudaError_t dq16(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 void* dq, const Shape& s, const Walk& w, cudaStream_t st) {
  Maps maps;
  cudaError_t err = make_maps<T>(&maps, q, dout, k, v, s, D);
  if (err != cudaSuccess) return err;
  static bool done[kMaxDevices] = {};
  const RowGrid grid(s, kRows);
  return run(dq_mma<D, Walk, T>, bwd_smem<D>(), done,
             grid.blocks() * (D / out_cols<D>()), kBwdThreads, st, maps, lse,
             delta, static_cast<T*>(dq), grid.BHg, s.G, grid.GT, s.Sq, s.Sk,
             s.scale_log2, s.sm_scale, grid.n_q, w);
}

template <int D, class Walk>
cudaError_t bwd_dq(int dtype, const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, const Shape& s, const Walk& w, cudaStream_t st) {
  const float* ls = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (dtype != kF32) {
    if (!shape_ok(s, kRows, kKeys)) return cudaErrorInvalidValue;
    if (dtype == kBF16)
      return dq16<D, Walk, bf16>(q, k, v, dout, ls, dl, dq, s, w, st);
    return dq16<D, Walk, f16>(q, k, v, dout, ls, dl, dq, s, w, st);
  }
  if (!shape_ok(s, BM, BK)) return cudaErrorInvalidValue;
  static bool done[kMaxDevices] = {};
  const RowGrid grid(s, BM);
  return run(dq_f32<D, Walk>, f32_dq_smem<D>(), done, grid.blocks(),
             kF32Threads, st, static_cast<const float*>(q),
             static_cast<const float*>(k), static_cast<const float*>(v),
             static_cast<const float*>(dout), ls, dl,
             static_cast<float*>(dq), grid.BHg, s.G, grid.GT, s.Sq, s.Sk,
             s.scale_log2, s.sm_scale, grid.n_q, w);
}

template <int D, class Walk, typename T>
cudaError_t dkv16(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta,
                  void* dk, void* dv, const Shape& s, const Walk& w,
                  cudaStream_t st) {
  Maps maps;
  cudaError_t err = make_maps<T>(&maps, q, dout, k, v, s, D);
  if (err != cudaSuccess) return err;
  static bool done[kMaxDevices] = {};
  const int BH = s.B * s.Hkv;
  return run(dkv_mma<D, Walk, T>, bwd_smem<D>(), done,
             (long long)BH * (s.Sk / kKeys) * (D / out_cols<D>()),
             kBwdThreads, st, maps, lse, delta, static_cast<T*>(dk),
             static_cast<T*>(dv), BH, s.G, group_tile(s.G, kDkvRows), s.Sq,
             s.Sk, s.scale_log2, s.sm_scale, w);
}

template <int D, class Walk>
cudaError_t bwd_dkv(int dtype, const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dk, void* dv, const Shape& s, const Walk& w,
                    cudaStream_t st) {
  const int BH = s.B * s.Hkv;
  const float* ls = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (dtype != kF32) {
    if (!shape_ok(s, kDkvRows, kKeys)) return cudaErrorInvalidValue;
    if (dtype == kBF16)
      return dkv16<D, Walk, bf16>(q, k, v, dout, ls, dl, dk, dv, s, w, st);
    return dkv16<D, Walk, f16>(q, k, v, dout, ls, dl, dk, dv, s, w, st);
  }
  if (!shape_ok(s, BM, BK)) return cudaErrorInvalidValue;
  static bool done[kMaxDevices] = {};
  return run(dkv_f32<D, Walk>, f32_dkv_smem<D>(), done,
             (long long)BH * (s.Sk / BK), kF32Threads, st,
             static_cast<const float*>(q), static_cast<const float*>(k),
             static_cast<const float*>(v), static_cast<const float*>(dout),
             ls, dl, static_cast<float*>(dk), static_cast<float*>(dv), BH,
             s.G, group_tile(s.G, BM), s.Sq, s.Sk, s.scale_log2, s.sm_scale,
             w);
}

// The three entry points' dispatch on dtype (0 float32, 1 bfloat16,
// 2 float16) and head_dim (64, 128 or 256).
inline bool dtype_ok(int dtype) {
  return dtype == kF32 || dtype == kBF16 || dtype == kF16;
}

template <class Walk>
cudaError_t fwd_any(int D, int dtype, const void* q, const void* k,
                    const void* v, void* out, void* lse, const Shape& s,
                    const Walk& w, cudaStream_t st) {
  if (!dtype_ok(dtype)) return cudaErrorInvalidValue;
  if (D == 64) return fwd<64>(dtype, q, k, v, out, lse, s, w, st);
  if (D == 128) return fwd<128>(dtype, q, k, v, out, lse, s, w, st);
  if (D == 256) return fwd<256>(dtype, q, k, v, out, lse, s, w, st);
  return cudaErrorInvalidValue;
}

template <class Walk>
cudaError_t dq_any(int D, int dtype, const void* q, const void* k,
                   const void* v, const void* dout, const void* lse,
                   const void* delta, void* dq, const Shape& s,
                   const Walk& w, cudaStream_t st) {
  if (!dtype_ok(dtype)) return cudaErrorInvalidValue;
  if (D == 64)
    return bwd_dq<64>(dtype, q, k, v, dout, lse, delta, dq, s, w, st);
  if (D == 128)
    return bwd_dq<128>(dtype, q, k, v, dout, lse, delta, dq, s, w, st);
  if (D == 256)
    return bwd_dq<256>(dtype, q, k, v, dout, lse, delta, dq, s, w, st);
  return cudaErrorInvalidValue;
}

template <class Walk>
cudaError_t dkv_any(int D, int dtype, const void* q, const void* k,
                    const void* v, const void* dout, const void* lse,
                    const void* delta, void* dk, void* dv, const Shape& s,
                    const Walk& w, cudaStream_t st) {
  if (!dtype_ok(dtype)) return cudaErrorInvalidValue;
  if (D == 64)
    return bwd_dkv<64>(dtype, q, k, v, dout, lse, delta, dk, dv, s, w, st);
  if (D == 128)
    return bwd_dkv<128>(dtype, q, k, v, dout, lse, delta, dk, dv, s, w, st);
  if (D == 256)
    return bwd_dkv<256>(dtype, q, k, v, dout, lse, delta, dk, dv, s, w, st);
  return cudaErrorInvalidValue;
}

}  // namespace
