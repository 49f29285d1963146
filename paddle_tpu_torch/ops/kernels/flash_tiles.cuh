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
// T is bfloat16 or float; every sum is f32.
//
// What bounds it: operations. At the training shapes (S = 4096 or 8192,
// D = 128) each live (query, key) pair costs 4*D flops forward and 6*D /
// 8*D in the two backward kernels against a few bytes per pair, far above
// the card's ~295 flop/byte balance point. The design follows that:
//   * bfloat16 runs on the tensor cores with `mma.sync` m16n8k16 (f32
//     accumulators) and keeps every accumulator in registers: each warp
//     owns 16 rows (queries; keys in dk/dv), so the online softmax's row
//     statistics live in the lanes that hold the row, and the score
//     fragments become the next product's A operand without leaving the
//     registers (their f32 layout is the bf16 A layout). K/V tiles are
//     staged in shared memory, padded by 16 bytes a row so the fragment
//     loads hit 32 distinct banks; operands read along the other axis are
//     staged transposed;
//   * float32 runs on the CUDA cores in full f32 from shared-memory tiles
//     (simple, exact up to the order of its sums; small shapes only);
//   * one block per (batch x kv head, tile of query positions) holds all
//     G query heads of that kv head, so each K/V tile is read once for the
//     whole group, as on the TPU;
//   * dk/dv: one block per (batch x kv head, key tile) walks the query
//     tiles of its walk for all G heads and sums in registers: no atomics;
//   * the mask is asked only inside partial tiles; a full tile runs the
//     products and the softmax alone;
//   * blocks of the last query tiles are launched first (causal imbalance).
// Known limits, for later work: no wgmma/TMA, no cp.async double
// buffering of the K/V (or Q/dO) tiles.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
// a score at or below this is a masked one (real scores are far above)
constexpr float kMaskedBelow = 0.5f * kNegInf;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;

enum DType { kF32 = 0, kBF16 = 1 };

using bf16 = __nv_bfloat16;

// Copy `rows` rows of D elements of T into shared memory (row stride LD).
// Row r is read from src + ((r / rpg) * gstride + r % rpg) * D: rpg rows
// per head, heads gstride rows apart. With scale != 0 each element is
// multiplied by scale in f32 and rounded back to T.
template <typename T, int D, int LD, int NT>
__device__ __forceinline__ void copy_rows(T* dst, const T* __restrict__ src,
                                          int rows, int rpg, int gstride,
                                          float scale) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = D / VEC;
  union Pack {
    uint4 u;
    T t[VEC];
  };
  for (int e = threadIdx.x; e < rows * PER_ROW; e += NT) {
    const int r = e / PER_ROW, c = (e % PER_ROW) * VEC;
    const size_t row = (size_t)(r / rpg) * gstride + r % rpg;
    Pack p;
    p.u = *reinterpret_cast<const uint4*>(src + row * D + c);
    if (scale != 0.f) {
#pragma unroll
      for (int t = 0; t < VEC; ++t) {
        if constexpr (sizeof(T) == 2)
          p.t[t] = __float2bfloat16(__bfloat162float(p.t[t]) * scale);
        else
          p.t[t] = p.t[t] * scale;
      }
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c) = p.u;
  }
}

// =========================================================================
// bfloat16: mma.sync m16n8k16, accumulators in registers
// =========================================================================

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 64;     // query rows of a forward / dq block
constexpr int kKeys = 64;     // keys per tile
constexpr int kDkvRows = 32;  // query rows per tile of a dk/dv block
constexpr int kPad = 8;       // 16 bytes of padding per shared row

// Copy `rows` rows of D bf16 (row r from src + ((r / rpg) * gstride +
// r % rpg) * D) into shared memory TRANSPOSED: dst[c * LD + r]. Lanes take
// consecutive rows, so the 2-byte stores of a warp are contiguous.
template <int D, int LD>
__device__ __forceinline__ void copy_rows_t(bf16* dst, const bf16* __restrict__ src,
                                            int rows, int rpg, int gstride) {
  union Pack {
    uint4 u;
    bf16 t[8];
  };
  for (int e = threadIdx.x; e < rows * (D / 8); e += kThreads) {
    const int r = e % rows, c = (e / rows) * 8;
    const size_t row = (size_t)(r / rpg) * gstride + r % rpg;
    Pack p;
    p.u = *reinterpret_cast<const uint4*>(src + row * D + c);
#pragma unroll
    for (int t = 0; t < 8; ++t) dst[(c + t) * LD + r] = p.t[t];
  }
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two f32 -> one register of two bf16 (round to nearest even), lo first
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c (16x8 f32) += a (16x16 bf16, row) . b (16x8 bf16, col)
__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragments of m16n8k16 for lane (g = lane / 4, t = lane % 4):
//   A (16x16): a0 = (g, 2t..2t+1), a1 = (g+8, 2t..), a2 = (g, 2t+8..),
//              a3 = (g+8, 2t+8..)
//   B (16x8):  b0 = (k 2t..2t+1, n g), b1 = (k 2t+8.., n g)
//   C (16x8):  c0, c1 = (g, 2t..2t+1), c2, c3 = (g+8, 2t..2t+1)
// A from a row-major tile: A(m, k) = m_s[(row0 + m) * ld + col0 + k].
__device__ __forceinline__ void load_a(uint32_t* a, const bf16* m_s, int ld,
                                       int row0, int col0, int g, int t) {
  const bf16* p = m_s + (row0 + g) * ld + col0 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

// B from an n-major tile: B(k, n) = m_s[(n0 + n) * ld + k0 + k].
__device__ __forceinline__ void load_b(uint32_t& b0, uint32_t& b1,
                                       const bf16* m_s, int ld, int n0,
                                       int k0, int g, int t) {
  const bf16* p = m_s + (n0 + g) * ld + k0 + 2 * t;
  b0 = ld32(p);
  b1 = ld32(p + 8);
}

// The A operand of the next product from two C tiles (columns 16*kc..):
// the C layout of tiles 2kc and 2kc+1 is the A layout, rounded to bf16.
__device__ __forceinline__ void c_to_a(uint32_t* a, const float* c0,
                                       const float* c1) {
  a[0] = pack(c0[0], c0[1]);
  a[1] = pack(c0[2], c0[3]);
  a[2] = pack(c1[0], c1[1]);
  a[3] = pack(c1[2], c1[3]);
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

template <int D> constexpr size_t mma_fwd_smem() {
  return sizeof(bf16) * ((kRows + kKeys) * (D + kPad) + D * (kKeys + kPad));
}

template <int D, class Walk>
__global__ void __launch_bounds__(kThreads)
fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
        const bf16* __restrict__ v, bf16* __restrict__ out,
        float* __restrict__ lse, int BH, int G, int Sq, int Sk,
        float scale_log2, int n_q_tiles, Walk walk) {
  constexpr int LD = D + kPad, LDV = kKeys + kPad;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* k_s = q_s + kRows * LD;
  bf16* vt_s = k_s + kKeys * LD;  // V transposed: (D, keys)

  const int bh = blockIdx.x % BH;
  const int qt = n_q_tiles - 1 - blockIdx.x / BH;  // longest rows first
  const int BQ = kRows / G;
  const int p0 = qt * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = warp * 16 + g, r1 = r0 + 8;  // this lane's two rows
  const int pos0 = p0 + r0 % BQ, pos1 = p0 + r1 % BQ;
  const size_t head0 = (size_t)bh * G * Sq + p0;

  copy_rows<bf16, D, LD, kThreads>(q_s, q + head0 * D, kRows, BQ, Sq,
                                   scale_log2);
  __syncthreads();
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc)
    load_a(qa[kc], q_s, LD, warp * 16, kc * 16, g, t);

  float o[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  const int n_k = walk.row_count(qt, p0, BQ, kKeys);
  const bf16* kb = k + (size_t)bh * Sk * D;
  const bf16* vb = v + (size_t)bh * Sk * D;
  for (int i = 0; i < n_k; ++i) {
    bool partial;
    const int k0 = walk.row_tile(qt, i, partial) * kKeys;
    __syncthreads();  // the previous tile is consumed
    copy_rows<bf16, D, LD, kThreads>(k_s, kb + (size_t)k0 * D, kKeys, kKeys,
                                     0, 0.f);
    copy_rows_t<D, LDV>(vt_s, vb + (size_t)k0 * D, kKeys, kKeys, 0);
    __syncthreads();

    float s[kKeys / 8][4];
#pragma unroll
    for (int nt = 0; nt < kKeys / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
#pragma unroll
      for (int nt = 0; nt < kKeys / 8; ++nt) {
        uint32_t b0, b1;
        load_b(b0, b1, k_s, LD, nt * 8, kc * 16, g, t);
        mma(s[nt], qa[kc], b0, b1);
      }
    }
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int nt = 0; nt < kKeys / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = k0 + nt * 8 + 2 * t + j;
        if (partial && walk.dead(pos0, key)) s[nt][j] = kNegInf;
        if (partial && walk.dead(pos1, key)) s[nt][2 + j] = kNegInf;
        mx0 = fmaxf(mx0, s[nt][j]);
        mx1 = fmaxf(mx1, s[nt][2 + j]);
      }
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kKeys / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[nt][j] = prob<Walk>(s[nt][j], mn0);
        s[nt][2 + j] = prob<Walk>(s[nt][2 + j], mn1);
        sum0 += s[nt][j];
        sum1 += s[nt][2 + j];
      }
    }
    l0 = al0 * l0 + quad_sum(sum0);
    l1 = al1 * l1 + quad_sum(sum1);
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      o[dt][0] *= al0;
      o[dt][1] *= al0;
      o[dt][2] *= al1;
      o[dt][3] *= al1;
    }
#pragma unroll
    for (int kc = 0; kc < kKeys / 16; ++kc) {
      uint32_t a[4];
      c_to_a(a, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        uint32_t b0, b1;
        load_b(b0, b1, vt_s, LDV, dt * 8, kc * 16, g, t);
        mma(o[dt], a, b0, b1);
      }
    }
  }

  // a row with no live key has l = 0 and acc = 0: out 0, lse -1e30
  const float d0 = l0 == 0.f ? 1.f : l0, d1 = l1 == 0.f ? 1.f : l1;
  const size_t row0 = head0 + (size_t)(r0 / BQ) * Sq + r0 % BQ;
  const size_t row1 = head0 + (size_t)(r1 / BQ) * Sq + r1 % BQ;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(out + row0 * D + c) =
        pack(o[dt][0] / d0, o[dt][1] / d0);
    *reinterpret_cast<uint32_t*>(out + row1 * D + c) =
        pack(o[dt][2] / d1, o[dt][3] / d1);
  }
  if (t == 0) {
    lse[row0] = l0 == 0.f ? kNegInf : kLn2 * m0 + logf(d0);
    lse[row1] = l1 == 0.f ? kNegInf : kLn2 * m1 + logf(d1);
  }
}

template <int D> constexpr size_t mma_dq_smem() {
  return sizeof(bf16) * ((2 * kRows + 2 * kKeys) * (D + kPad) +
                         D * (kKeys + kPad));
}

template <int D, class Walk>
__global__ void __launch_bounds__(kThreads)
dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
       const bf16* __restrict__ v, const bf16* __restrict__ dout,
       const float* __restrict__ lse, const float* __restrict__ delta,
       bf16* __restrict__ dq, int BH, int G, int Sq, int Sk,
       float scale_log2, float sm_scale, int n_q_tiles, Walk walk) {
  constexpr int LD = D + kPad, LDK = kKeys + kPad;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* do_s = q_s + kRows * LD;
  bf16* k_s = do_s + kRows * LD;
  bf16* v_s = k_s + kKeys * LD;
  bf16* kt_s = v_s + kKeys * LD;  // K transposed: (D, keys)

  const int bh = blockIdx.x % BH;
  const int qt = n_q_tiles - 1 - blockIdx.x / BH;
  const int BQ = kRows / G;
  const int p0 = qt * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = warp * 16 + g, r1 = r0 + 8;
  const int pos0 = p0 + r0 % BQ, pos1 = p0 + r1 % BQ;
  const size_t head0 = (size_t)bh * G * Sq + p0;
  const size_t row0 = head0 + (size_t)(r0 / BQ) * Sq + r0 % BQ;
  const size_t row1 = head0 + (size_t)(r1 / BQ) * Sq + r1 % BQ;
  const float ls0 = lse[row0] * kLog2e, ls1 = lse[row1] * kLog2e;
  const float dl0 = delta[row0], dl1 = delta[row1];

  copy_rows<bf16, D, LD, kThreads>(q_s, q + head0 * D, kRows, BQ, Sq,
                                   scale_log2);
  copy_rows<bf16, D, LD, kThreads>(do_s, dout + head0 * D, kRows, BQ, Sq,
                                   0.f);
  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  const int n_k = walk.row_count(qt, p0, BQ, kKeys);
  const bf16* kb = k + (size_t)bh * Sk * D;
  const bf16* vb = v + (size_t)bh * Sk * D;
  for (int i = 0; i < n_k; ++i) {
    bool partial;
    const int k0 = walk.row_tile(qt, i, partial) * kKeys;
    __syncthreads();
    copy_rows<bf16, D, LD, kThreads>(k_s, kb + (size_t)k0 * D, kKeys, kKeys,
                                     0, 0.f);
    copy_rows<bf16, D, LD, kThreads>(v_s, vb + (size_t)k0 * D, kKeys, kKeys,
                                     0, 0.f);
    copy_rows_t<D, LDK>(kt_s, kb + (size_t)k0 * D, kKeys, kKeys, 0);
    __syncthreads();

    float s[kKeys / 8][4], dp[kKeys / 8][4];
#pragma unroll
    for (int nt = 0; nt < kKeys / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t aq[4], ado[4];
      load_a(aq, q_s, LD, warp * 16, kc * 16, g, t);
      load_a(ado, do_s, LD, warp * 16, kc * 16, g, t);
#pragma unroll
      for (int nt = 0; nt < kKeys / 8; ++nt) {
        uint32_t b0, b1;
        load_b(b0, b1, k_s, LD, nt * 8, kc * 16, g, t);
        mma(s[nt], aq, b0, b1);
        load_b(b0, b1, v_s, LD, nt * 8, kc * 16, g, t);
        mma(dp[nt], ado, b0, b1);
      }
    }
    // ds = p * (dp - delta) * sm_scale, kept in s
#pragma unroll
    for (int nt = 0; nt < kKeys / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = k0 + nt * 8 + 2 * t + j;
        const float p0v = (partial && walk.dead(pos0, key))
                              ? 0.f : exp2f(s[nt][j] - ls0);
        const float p1v = (partial && walk.dead(pos1, key))
                              ? 0.f : exp2f(s[nt][2 + j] - ls1);
        s[nt][j] = p0v * (dp[nt][j] - dl0) * sm_scale;
        s[nt][2 + j] = p1v * (dp[nt][2 + j] - dl1) * sm_scale;
      }
    }
#pragma unroll
    for (int kc = 0; kc < kKeys / 16; ++kc) {
      uint32_t a[4];
      c_to_a(a, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        uint32_t b0, b1;
        load_b(b0, b1, kt_s, LDK, dt * 8, kc * 16, g, t);
        mma(acc[dt], a, b0, b1);
      }
    }
  }
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(dq + row0 * D + c) =
        pack(acc[dt][0], acc[dt][1]);
    *reinterpret_cast<uint32_t*>(dq + row1 * D + c) =
        pack(acc[dt][2], acc[dt][3]);
  }
}

template <int D> constexpr size_t mma_dkv_smem() {
  return sizeof(bf16) * ((2 * kKeys + 2 * kDkvRows) * (D + kPad) +
                         2 * D * (kDkvRows + kPad)) +
         sizeof(float) * 2 * kDkvRows;
}

template <int D, class Walk>
__global__ void __launch_bounds__(kThreads)
dkv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
        const bf16* __restrict__ v, const bf16* __restrict__ dout,
        const float* __restrict__ lse, const float* __restrict__ delta,
        bf16* __restrict__ dk, bf16* __restrict__ dv, int BH, int G, int Sq,
        int Sk, float scale_log2, float sm_scale, Walk walk) {
  constexpr int LD = D + kPad, LDR = kDkvRows + kPad;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);  // k2 = round(k * scale)
  bf16* v_s = k_s + kKeys * LD;
  bf16* q_s = v_s + kKeys * LD;
  bf16* do_s = q_s + kDkvRows * LD;
  bf16* qt_s = do_s + kDkvRows * LD;   // Q transposed: (D, rows)
  bf16* dot_s = qt_s + D * LDR;        // dO transposed: (D, rows)
  float* lse_s = reinterpret_cast<float*>(dot_s + D * LDR);
  float* dl_s = lse_s + kDkvRows;

  const int bh = blockIdx.x % BH;
  const int kt = blockIdx.x / BH;  // causal: low key tiles do the most work
  const int k0 = kt * kKeys;
  const int BQ = kDkvRows / G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // this lane's two keys (accumulator rows)
  const int key0 = k0 + warp * 16 + g, key1 = key0 + 8;

  const size_t kv_row0 = (size_t)bh * Sk + k0;
  copy_rows<bf16, D, LD, kThreads>(k_s, k + kv_row0 * D, kKeys, kKeys, 0,
                                   scale_log2);
  copy_rows<bf16, D, LD, kThreads>(v_s, v + kv_row0 * D, kKeys, kKeys, 0,
                                   0.f);
  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[dt][e] = dva[dt][e] = 0.f;

  const int n_q = walk.col_count(kt, k0, BQ);
  for (int i = 0; i < n_q; ++i) {
    bool partial;
    const int p0 = walk.col_tile(kt, k0, BQ, i, partial) * BQ;
    const size_t head0 = (size_t)bh * G * Sq + p0;
    __syncthreads();  // the previous query tile is consumed
    copy_rows<bf16, D, LD, kThreads>(q_s, q + head0 * D, kDkvRows, BQ, Sq,
                                     0.f);
    copy_rows<bf16, D, LD, kThreads>(do_s, dout + head0 * D, kDkvRows, BQ,
                                     Sq, 0.f);
    copy_rows_t<D, LDR>(qt_s, q + head0 * D, kDkvRows, BQ, Sq);
    copy_rows_t<D, LDR>(dot_s, dout + head0 * D, kDkvRows, BQ, Sq);
    for (int r = threadIdx.x; r < kDkvRows; r += kThreads) {
      const size_t row = head0 + (size_t)(r / BQ) * Sq + r % BQ;
      lse_s[r] = lse[row] * kLog2e;
      dl_s[r] = delta[row];
    }
    __syncthreads();

    // s^T = k2 . q^T and dp^T = v . do^T: rows are keys, columns queries
    float s[kDkvRows / 8][4], dp[kDkvRows / 8][4];
#pragma unroll
    for (int nt = 0; nt < kDkvRows / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t ak[4], av[4];
      load_a(ak, k_s, LD, warp * 16, kc * 16, g, t);
      load_a(av, v_s, LD, warp * 16, kc * 16, g, t);
#pragma unroll
      for (int nt = 0; nt < kDkvRows / 8; ++nt) {
        uint32_t b0, b1;
        load_b(b0, b1, q_s, LD, nt * 8, kc * 16, g, t);
        mma(s[nt], ak, b0, b1);
        load_b(b0, b1, do_s, LD, nt * 8, kc * 16, g, t);
        mma(dp[nt], av, b0, b1);
      }
    }
    // p^T into s, ds^T into dp
#pragma unroll
    for (int nt = 0; nt < kDkvRows / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = nt * 8 + 2 * t + j;
        const int pos = p0 + col % BQ;
        const float l2 = lse_s[col], dl = dl_s[col];
        const float pa = (partial && walk.dead(pos, key0))
                             ? 0.f : exp2f(s[nt][j] - l2);
        const float pb = (partial && walk.dead(pos, key1))
                             ? 0.f : exp2f(s[nt][2 + j] - l2);
        s[nt][j] = pa;
        s[nt][2 + j] = pb;
        dp[nt][j] = pa * (dp[nt][j] - dl) * sm_scale;
        dp[nt][2 + j] = pb * (dp[nt][2 + j] - dl) * sm_scale;
      }
    }
    // dv += round(p)^T . do, dk += round(ds)^T . q
#pragma unroll
    for (int kc = 0; kc < kDkvRows / 16; ++kc) {
      uint32_t ap[4], ads[4];
      c_to_a(ap, s[2 * kc], s[2 * kc + 1]);
      c_to_a(ads, dp[2 * kc], dp[2 * kc + 1]);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        uint32_t b0, b1;
        load_b(b0, b1, dot_s, LDR, dt * 8, kc * 16, g, t);
        mma(dva[dt], ap, b0, b1);
        load_b(b0, b1, qt_s, LDR, dt * 8, kc * 16, g, t);
        mma(dka[dt], ads, b0, b1);
      }
    }
  }
  const size_t rk0 = (kv_row0 + warp * 16 + g) * D;
  const size_t rk1 = rk0 + 8 * D;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(dk + rk0 + c) = pack(dka[dt][0], dka[dt][1]);
    *reinterpret_cast<uint32_t*>(dk + rk1 + c) = pack(dka[dt][2], dka[dt][3]);
    *reinterpret_cast<uint32_t*>(dv + rk0 + c) = pack(dva[dt][0], dva[dt][1]);
    *reinterpret_cast<uint32_t*>(dv + rk1 + c) = pack(dva[dt][2], dva[dt][3]);
  }
}

// =========================================================================
// float32: CUDA cores, shared-memory tiles
// =========================================================================

constexpr int kF32Threads = 256;
constexpr int kF32Warps = kF32Threads / 32;
constexpr int BM = 32;  // query rows of a block or tile (G heads x positions)
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
        float* __restrict__ lse, int BH, int G, int Sq, int Sk,
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

  const int bh = blockIdx.x % BH;
  const int qt = n_q_tiles - 1 - blockIdx.x / BH;
  const int BQ = BM / G;
  const int p0 = qt * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t head0 = (size_t)bh * G * Sq + p0;

  copy_rows<float, D, LD, kF32Threads>(q_s, q + head0 * D, BM, BQ, Sq,
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
    copy_rows<float, D, LD, kF32Threads>(k_s, kb + (size_t)k0 * D, BK, BK, 0,
                                         0.f);
    copy_rows<float, D, LD, kF32Threads>(v_s, vb + (size_t)k0 * D, BK, BK, 0,
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
       float* __restrict__ dq, int BH, int G, int Sq, int Sk,
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

  const int bh = blockIdx.x % BH;
  const int qt = n_q_tiles - 1 - blockIdx.x / BH;
  const int BQ = BM / G;
  const int p0 = qt * BQ;
  const size_t head0 = (size_t)bh * G * Sq + p0;

  copy_rows<float, D, LD, kF32Threads>(q_s, q + head0 * D, BM, BQ, Sq,
                                       scale_log2);
  copy_rows<float, D, LD, kF32Threads>(do_s, dout + head0 * D, BM, BQ, Sq,
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
    copy_rows<float, D, LD, kF32Threads>(k_s, kb + (size_t)k0 * D, BK, BK, 0,
                                         0.f);
    copy_rows<float, D, LD, kF32Threads>(v_s, vb + (size_t)k0 * D, BK, BK, 0,
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
        int Sq, int Sk, float scale_log2, float sm_scale, Walk walk) {
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
  const int BQ = BM / G;
  const size_t kv_row0 = (size_t)bh * Sk + k0;
  copy_rows<float, D, LD, kF32Threads>(k_s, k + kv_row0 * D, BK, BK, 0,
                                       scale_log2);
  copy_rows<float, D, LD, kF32Threads>(v_s, v + kv_row0 * D, BK, BK, 0, 0.f);
  for (int e = threadIdx.x; e < BK * D; e += kF32Threads) {
    const int idx = (e / D) * LD + e % D;
    dk_s[idx] = 0.f;
    dv_s[idx] = 0.f;
  }
  const int n_q = walk.col_count(kt, k0, BQ);
  for (int i = 0; i < n_q; ++i) {
    bool partial;
    const int p0 = walk.col_tile(kt, k0, BQ, i, partial) * BQ;
    const size_t head0 = (size_t)bh * G * Sq + p0;
    __syncthreads();
    copy_rows<float, D, LD, kF32Threads>(q_s, q + head0 * D, BM, BQ, Sq,
                                         0.f);
    copy_rows<float, D, LD, kF32Threads>(do_s, dout + head0 * D, BM, BQ, Sq,
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

// G must divide every row tile and the tiles must divide the sequences:
// rows/keys per tile are (64, 64) for bfloat16 forward and dq, 32 query
// rows for its dk/dv, and (32, 32) for float32.
inline bool shape_ok(const Shape& s, int rows, int keys) {
  return s.B > 0 && s.Hkv > 0 && s.G > 0 && rows % s.G == 0 &&
         kDkvRows % s.G == 0 && s.Sq > 0 && s.Sk > 0 &&
         s.Sq % (rows / s.G) == 0 && s.Sk % keys == 0;
}

template <typename Kernel, typename... Args>
cudaError_t run(Kernel kern, size_t smem, bool* done, long long blocks,
                int threads, cudaStream_t stream, Args... args) {
  cudaError_t err = prepare(kern, smem, done);
  if (err != cudaSuccess) return err;
  if (blocks <= 0 || blocks > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  kern<<<(unsigned)blocks, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <int D, class Walk>
cudaError_t fwd(int dtype, const void* q, const void* k, const void* v,
                void* out, void* lse, const Shape& s, const Walk& w,
                cudaStream_t st) {
  const int BH = s.B * s.Hkv;
  if (dtype == kBF16) {
    if (!shape_ok(s, kRows, kKeys)) return cudaErrorInvalidValue;
    static bool done[kMaxDevices] = {};
    const int n_q = s.Sq / (kRows / s.G);
    return run(fwd_mma<D, Walk>, mma_fwd_smem<D>(), done,
               (long long)BH * n_q, kThreads, st,
               static_cast<const bf16*>(q), static_cast<const bf16*>(k),
               static_cast<const bf16*>(v), static_cast<bf16*>(out),
               static_cast<float*>(lse), BH, s.G, s.Sq, s.Sk, s.scale_log2,
               n_q, w);
  }
  if (!shape_ok(s, BM, BK)) return cudaErrorInvalidValue;
  static bool done[kMaxDevices] = {};
  const int n_q = s.Sq / (BM / s.G);
  return run(fwd_f32<D, Walk>, f32_fwd_smem<D>(), done, (long long)BH * n_q,
             kF32Threads, st, static_cast<const float*>(q),
             static_cast<const float*>(k), static_cast<const float*>(v),
             static_cast<float*>(out), static_cast<float*>(lse), BH, s.G,
             s.Sq, s.Sk, s.scale_log2, n_q, w);
}

template <int D, class Walk>
cudaError_t bwd_dq(int dtype, const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, const Shape& s, const Walk& w, cudaStream_t st) {
  const int BH = s.B * s.Hkv;
  const float* ls = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (dtype == kBF16) {
    if (!shape_ok(s, kRows, kKeys)) return cudaErrorInvalidValue;
    static bool done[kMaxDevices] = {};
    const int n_q = s.Sq / (kRows / s.G);
    return run(dq_mma<D, Walk>, mma_dq_smem<D>(), done, (long long)BH * n_q,
               kThreads, st, static_cast<const bf16*>(q),
               static_cast<const bf16*>(k), static_cast<const bf16*>(v),
               static_cast<const bf16*>(dout), ls, dl, static_cast<bf16*>(dq),
               BH, s.G, s.Sq, s.Sk, s.scale_log2, s.sm_scale, n_q, w);
  }
  if (!shape_ok(s, BM, BK)) return cudaErrorInvalidValue;
  static bool done[kMaxDevices] = {};
  const int n_q = s.Sq / (BM / s.G);
  return run(dq_f32<D, Walk>, f32_dq_smem<D>(), done, (long long)BH * n_q,
             kF32Threads, st, static_cast<const float*>(q),
             static_cast<const float*>(k), static_cast<const float*>(v),
             static_cast<const float*>(dout), ls, dl,
             static_cast<float*>(dq), BH, s.G, s.Sq, s.Sk, s.scale_log2,
             s.sm_scale, n_q, w);
}

template <int D, class Walk>
cudaError_t bwd_dkv(int dtype, const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dk, void* dv, const Shape& s, const Walk& w,
                    cudaStream_t st) {
  const int BH = s.B * s.Hkv;
  const float* ls = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (dtype == kBF16) {
    if (!shape_ok(s, kRows, kKeys)) return cudaErrorInvalidValue;
    static bool done[kMaxDevices] = {};
    return run(dkv_mma<D, Walk>, mma_dkv_smem<D>(), done,
               (long long)BH * (s.Sk / kKeys), kThreads, st,
               static_cast<const bf16*>(q), static_cast<const bf16*>(k),
               static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
               ls, dl, static_cast<bf16*>(dk), static_cast<bf16*>(dv), BH,
               s.G, s.Sq, s.Sk, s.scale_log2, s.sm_scale, w);
  }
  if (!shape_ok(s, BM, BK)) return cudaErrorInvalidValue;
  static bool done[kMaxDevices] = {};
  return run(dkv_f32<D, Walk>, f32_dkv_smem<D>(), done,
             (long long)BH * (s.Sk / BK), kF32Threads, st,
             static_cast<const float*>(q), static_cast<const float*>(k),
             static_cast<const float*>(v), static_cast<const float*>(dout),
             ls, dl, static_cast<float*>(dk), static_cast<float*>(dv), BH,
             s.G, s.Sq, s.Sk, s.scale_log2, s.sm_scale, w);
}

// The three entry points' dispatch on dtype (0 float32, 1 bfloat16) and
// head_dim (64 or 128).
template <class Walk>
cudaError_t fwd_any(int D, int dtype, const void* q, const void* k,
                    const void* v, void* out, void* lse, const Shape& s,
                    const Walk& w, cudaStream_t st) {
  if (dtype != kF32 && dtype != kBF16) return cudaErrorInvalidValue;
  if (D == 64) return fwd<64>(dtype, q, k, v, out, lse, s, w, st);
  if (D == 128) return fwd<128>(dtype, q, k, v, out, lse, s, w, st);
  return cudaErrorInvalidValue;
}

template <class Walk>
cudaError_t dq_any(int D, int dtype, const void* q, const void* k,
                   const void* v, const void* dout, const void* lse,
                   const void* delta, void* dq, const Shape& s,
                   const Walk& w, cudaStream_t st) {
  if (dtype != kF32 && dtype != kBF16) return cudaErrorInvalidValue;
  if (D == 64)
    return bwd_dq<64>(dtype, q, k, v, dout, lse, delta, dq, s, w, st);
  if (D == 128)
    return bwd_dq<128>(dtype, q, k, v, dout, lse, delta, dq, s, w, st);
  return cudaErrorInvalidValue;
}

template <class Walk>
cudaError_t dkv_any(int D, int dtype, const void* q, const void* k,
                    const void* v, const void* dout, const void* lse,
                    const void* delta, void* dk, void* dv, const Shape& s,
                    const Walk& w, cudaStream_t st) {
  if (dtype != kF32 && dtype != kBF16) return cudaErrorInvalidValue;
  if (D == 64)
    return bwd_dkv<64>(dtype, q, k, v, dout, lse, delta, dk, dv, s, w, st);
  if (D == 128)
    return bwd_dkv<128>(dtype, q, k, v, dout, lse, delta, dk, dv, s, w, st);
  return cudaErrorInvalidValue;
}

}  // namespace
