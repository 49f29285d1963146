// The shared part of the paged-attention kernels (paged_attention.cu):
// the constants, the element helpers and the split decode instance
// (flash-decoding over pages: `paged_attention_split_kernel` and its
// launch), in a namespace of external linkage. paged_attention.cu routes
// and launches; the 72 split decode instances (q f32 / bf16, pools f32 /
// bf16 / int8, head_dim 64 / 128 / 256, groups of 1 / 2 / 4 / 8) are
// compiled in the six translation units of paged_attention_parts/, one
// (q, pool) pair each, explicitly instantiating `split_by_dim` there, so
// that the build's nvcc processes share them.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>
#include <stdint.h>

#include <type_traits>

namespace paged_attention_impl {

constexpr int kWarp = 32;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * kWarp;
constexpr int kKeyTile = 32;  // keys per shared-memory tile: one per lane
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;

constexpr int kDecodeWarps = 8;
constexpr int kDecodeThreads = kDecodeWarps * kWarp;
constexpr int kStages = 3;            // tiles in the ring
constexpr int kTileBytes = 16384;     // K (or V) bytes of a tile, at most
constexpr int kMaxTileKeys = 64;

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };
// the kernel's instances, as `paged_attention_instance` numbers them
enum Instance { kInstSplit = 0, kInstMma = 1, kInstRows = 2 };

__device__ __forceinline__ void load4(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* o) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}

__device__ __forceinline__ void load4(const int8_t* p, float* o) {
  const char4 v = *reinterpret_cast<const char4*>(p);
  o[0] = static_cast<signed char>(v.x);
  o[1] = static_cast<signed char>(v.y);
  o[2] = static_cast<signed char>(v.z);
  o[3] = static_cast<signed char>(v.w);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

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

// Tile geometry of one instance: kKeys keys a tile (K and V at most
// kTileBytes each); the D / 8 lanes of a key each hold 8 dims.
template <typename TKV, int D>
struct DecodeTile {
  static constexpr int kRowBytes = D * (int)sizeof(TKV);
  static constexpr int kKeys = kTileBytes / kRowBytes < kMaxTileKeys
                                   ? kTileBytes / kRowBytes
                                   : kMaxTileKeys;
  static constexpr int kChunks = kRowBytes / 16;   // 16-byte copies a row
  static constexpr int kLanes = D / 8;             // lanes a key
  static constexpr int kKeysPerPass = kWarp / kLanes;
  static constexpr int kPasses = kKeys / kDecodeWarps / kKeysPerPass;
  static constexpr int kRingBytes = kStages * 2 * kKeys * kRowBytes;
  // the copies of a tile: a thread's chunks lie kCopyStep keys apart at
  // one offset of the row, kCopyKeys of them (for K, and as many for V)
  static constexpr int kCopyStep = kDecodeThreads / kChunks;
  static constexpr int kCopyKeys = kKeys / kCopyStep;
  static_assert(kPasses >= 1 && kKeys % (kDecodeWarps * kKeysPerPass) == 0,
                "a tile must give every warp whole passes");
  static_assert(kDecodeThreads % kChunks == 0 && kKeys % kCopyStep == 0,
                "a tile must give every thread whole copies");
};

// Dim i (0..7) of lane lk among the LPK lanes of a key. 16-bit and int8
// rows: 8 contiguous dims a lane (one 16- or 8-byte word); f32 rows: two
// words of 4, LPK words apart, so a key's lanes read contiguous bytes.
template <typename TKV, int LPK>
__device__ __forceinline__ int dim_of(int lk, int i) {
  return sizeof(TKV) == 4 ? ((i / 4) * LPK + lk) * 4 + i % 4 : lk * 8 + i;
}

template <int LPK>
__device__ __forceinline__ void load8(const float* row, int lk, float* o) {
  load4(row + lk * 4, o);
  load4(row + (LPK + lk) * 4, o + 4);
}

template <int LPK>
__device__ __forceinline__ void load8(const __nv_bfloat16* row, int lk,
                                      float* o) {
  const uint4 raw = *reinterpret_cast<const uint4*>(row + lk * 8);
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // a bf16 is the top half of its f32
    o[2 * i] = __uint_as_float(w[i] << 16);
    o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <int LPK>
__device__ __forceinline__ void load8(const int8_t* row, int lk, float* o) {
  load4(row + lk * 8, o);
  load4(row + lk * 8 + 4, o + 4);
}

// 2^x by the SFU alone (relative error below 2^-22; 0 for x < -126)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// cp.async of 16 (or 4) bytes; ok == false copies nothing and zero-fills
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The last of the n_split live items of one (sequence, kv head) to finish,
// found by an atomic ticket, merges their partials in split order (no
// atomics on values, so two launches give the same bits) and resets the
// ticket for the next call. A split with l == 0 (all its pages bad) is
// skipped, so a row with no live key anywhere is exactly 0. `sm` holds
// (2 * n_split + 1) * G floats.
template <typename TQ>
__device__ __forceinline__ void merge_if_last(const float* part, int* ticket,
                                              TQ* out, int G, int D,
                                              int n_split, float* sm) {
  __shared__ int last;
  __threadfence();  // this block's partial, visible before its ticket
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(ticket, 1) == n_split - 1;
    if (last) atomicExch(ticket, 0);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int n = n_split * G, PS = D + 2;
  float* wt = sm;       // (split, row): m, then its weight
  float* ls = wt + n;   // (split, row): l
  float* den = ls + n;  // row: the weighted sum of l
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    wt[i] = __ldcg(part + (size_t)i * PS + D);
    ls[i] = __ldcg(part + (size_t)i * PS + D + 1);
  }
  __syncthreads();
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    float M = kNegInf;
    for (int s = 0; s < n_split; ++s)
      if (ls[s * G + g] > 0.f) M = fmaxf(M, wt[s * G + g]);
    float L = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const int i = s * G + g;
      wt[i] = ls[i] > 0.f ? exp2f(wt[i] - M) : 0.f;
      L = fmaf(wt[i], ls[i], L);
    }
    den[g] = fmaxf(L, 1e-20f);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < G * D; e += blockDim.x) {
    const int g = e / D, d = e % D;
    float A = 0.f;
#pragma unroll 4
    for (int s = 0; s < n_split; ++s) {
      const float w = wt[s * G + g];
      if (w > 0.f)  // an empty split's acc was never written
        A = fmaf(w, __ldcg(part + (size_t)(s * G + g) * PS + d), A);
    }
    store1(out + e, A / den[g]);
  }
}

// One item: the keys of one split of one (sequence, kv head), GP >= G
// query rows in registers. Writes the split's partial (acc[D], m, l per
// row, m in base 2) to `part`, and the last live split of the (sequence,
// kv head) merges them; a sequence with one live split writes its output
// there. key_end: min(lens, pos + 1, W * ps) of the sequence.
template <typename TQ, typename TKV, int D, int GP>
__device__ __forceinline__ void decode_item(
    const TQ* __restrict__ q, const TKV* __restrict__ kp,
    const TKV* __restrict__ vp, const float* __restrict__ ks,
    const float* __restrict__ vs, const int* __restrict__ tables,
    TQ* __restrict__ out, float* __restrict__ part, int* __restrict__ tickets,
    int Hkv, int G, int P, int ps, int W, int n_split, int split_pages,
    float scale_log2, int split, int bh, int key_end) {
  using Tile = DecodeTile<TKV, D>;
  constexpr int KK = Tile::kKeys, LPK = Tile::kLanes, RB = Tile::kRowBytes;
  constexpr int KPP = Tile::kKeysPerPass, CH = Tile::kChunks;
  constexpr int PS = D + 2;  // a partial row: acc[D], m, l
  // passes scored together: at most 32 scores a lane in flight
  constexpr int PB = Tile::kPasses < 32 / GP ? Tile::kPasses : 32 / GP;
  extern __shared__ __align__(16) unsigned char ring_smem[];
  unsigned char* ring = ring_smem;  // kStages x (K tile, V tile)
  float* scl = reinterpret_cast<float*>(
      ring_smem + (Tile::kRingBytes > kDecodeWarps * GP * PS * 4
                  ? Tile::kRingBytes
                  : kDecodeWarps * GP * PS * 4));  // kStages x (ks, vs) x KK
  int* live_s = reinterpret_cast<int*>(scl + kStages * 2 * KK);
  int* pages_s = live_s + kStages * KK;  // split_pages page ids

  const int h = bh % Hkv;
  const int b = bh / Hkv;
  const int tid = threadIdx.x;
  const int warp = tid / kWarp, lane = tid % kWarp;
  const int lk = lane % LPK, grp = lane / LPK;
  const size_t row0 = (size_t)bh * G;  // the block's first q / out row
  const int k0 = split * split_pages * ps;
  const int k1 = min(k0 + split_pages * ps, key_end);
  // the splits that hold live keys: the merge waits for them alone
  const int split_keys = split_pages * ps;
  const int n_live = min((key_end + split_keys - 1) / split_keys, n_split);
  if (split >= n_live) {  // no live key in this split: nothing to add
    if (split == 0)       // nor in any: the rows are exactly 0
      for (int e = tid; e < G * D; e += kDecodeThreads)
        store1(out + row0 * D + e, 0.f);
    return;
  }
  // the split's page ids
  const int j0 = split * split_pages;
  const int n_pages = min(split_pages, W - j0);
  for (int j = tid; j < n_pages; j += kDecodeThreads)
    pages_s[j] = tables[(size_t)b * W + j0 + j];
  const float* part_bh = part + (size_t)bh * n_split * G * PS;
  float* mine = part + ((size_t)bh * n_split + split) * G * PS;

  // this lane's 8 dims of each q row, in log2 units of the softmax
  float qr[GP][8];
#pragma unroll
  for (int g = 0; g < GP; ++g)
#pragma unroll
    for (int i = 0; i < 8; ++i)
      qr[g][i] = g < G ? to_f32(q[(row0 + g) * D + dim_of<TKV, LPK>(lk, i)])
                             * scale_log2
                       : 0.f;

  constexpr bool quant = sizeof(TKV) == 1;  // int8 slots carry scales
  __syncthreads();  // pages_s
  // A thread copies keys kk0 + i * kCopyStep of each tile (and, for
  // tid < 2 * KK, reads the liveness and scales of key tid % KK); it walks
  // their (page, slot) from tile to tile without dividing by ps.
  const int kk0 = tid / CH, off = (tid % CH) * 16;
  int cj = kk0 / ps, cs = kk0 % ps;                    // key kk0 of tile t
  int fj = (tid % KK) / ps, fs = (tid % KK) % ps;      // key tid % KK
  auto advance = [&](int& j, int& slot, int by) {
    slot += by;
    while (slot >= ps) {
      slot -= ps;
      ++j;
    }
  };
  // the pool row of the key at (page j, slot) of the split, relative key
  // r; -1 past the split's live keys or on a bad page (it reads nothing)
  auto row_of = [&](int r, int j, int slot) -> long long {
    if (r >= k1 - k0) return -1;
    const int page = pages_s[j];
    if (page < 0 || page >= P) return -1;
    return ((long long)h * P + page) * ps + slot;
  };
  auto load_tile = [&](int t) {  // tiles load in order: 0, 1, 2, ...
    const int st = t % kStages;
    unsigned char* kd = ring + (size_t)st * 2 * KK * RB;
    unsigned char* vd = kd + KK * RB;
    long long rows[Tile::kCopyKeys];  // every page id read before a copy
    int j = cj, slot = cs;
#pragma unroll
    for (int i = 0; i < Tile::kCopyKeys; ++i) {
      rows[i] = row_of(t * KK + kk0 + i * Tile::kCopyStep, j, slot);
      advance(j, slot, Tile::kCopyStep);
    }
    advance(cj, cs, KK);
#pragma unroll
    for (int i = 0; i < Tile::kCopyKeys; ++i) {
      const int kk = kk0 + i * Tile::kCopyStep;
      const size_t src = rows[i] < 0 ? 0 : (size_t)rows[i] * RB + off;
      cp_async16(kd + kk * RB + off,
                 reinterpret_cast<const unsigned char*>(kp) + src,
                 rows[i] >= 0);
      cp_async16(vd + kk * RB + off,
                 reinterpret_cast<const unsigned char*>(vp) + src,
                 rows[i] >= 0);
    }
    if (tid < 2 * KK) {  // each key's liveness, and its int8 scales
      const int kk = tid % KK;
      const long long row = row_of(t * KK + kk, fj, fs);
      advance(fj, fs, KK);
      if (tid < KK) live_s[st * KK + kk] = row >= 0;
      if (quant) {
        const float* src = (tid < KK ? ks : vs) + (row < 0 ? 0 : row);
        cp_async4(scl + (st * 2 + tid / KK) * KK + kk, src, row >= 0);
      }
    }
  };

  float m[GP], l[GP], acc[GP][8];
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[g][i] = 0.f;
  }

  const int n_tiles = (k1 - k0 + KK - 1) / KK;
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) load_tile(t);
    cp_async_commit();
  }
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile t landed
    __syncthreads();  // everyone's did, and tile t - 1's stage is free
    if (t + kStages - 1 < n_tiles) load_tile(t + kStages - 1);
    cp_async_commit();
    const int st = t % kStages;
    const TKV* kt = reinterpret_cast<const TKV*>(ring + (size_t)st * 2 * KK
                                                 * RB);
    const TKV* vt = kt + KK * D;
    const float* kscl = scl + st * 2 * KK;
    const int* lv = live_s + st * KK;
    // a warp's keys of the tile, PB passes at a time: score them all,
    // then one max and rescale a row, then P.V
#pragma unroll 1
    for (int b0 = 0; b0 < Tile::kPasses; b0 += PB) {
      float s[PB][GP];
      bool live[PB];
#pragma unroll
      for (int j = 0; j < PB; ++j) {
        const int kk = (warp * Tile::kPasses + b0 + j) * KPP + grp;
        live[j] = lv[kk] != 0;
        float kf[8];
        load8<LPK>(kt + kk * D, lk, kf);
#pragma unroll
        for (int g = 0; g < GP; ++g) {
          float d = 0.f;
#pragma unroll
          for (int i = 0; i < 8; ++i) d = fmaf(qr[g][i], kf[i], d);
          s[j][g] = d;
        }
      }
#pragma unroll
      for (int o = LPK / 2; o > 0; o >>= 1)
#pragma unroll
        for (int j = 0; j < PB; ++j)
#pragma unroll
          for (int g = 0; g < GP; ++g)
            s[j][g] += __shfl_xor_sync(kFull, s[j][g], o);
      float mx[GP];
#pragma unroll
      for (int g = 0; g < GP; ++g) mx[g] = kNegInf;
#pragma unroll
      for (int j = 0; j < PB; ++j) {
        const int kk = (warp * Tile::kPasses + b0 + j) * KPP + grp;
        const float ksc = quant ? kscl[kk] : 1.f;
#pragma unroll
        for (int g = 0; g < GP; ++g) {
          s[j][g] = live[j] ? (quant ? s[j][g] * ksc : s[j][g]) : kNegInf;
          mx[g] = fmaxf(mx[g], s[j][g]);
        }
      }
#pragma unroll
      for (int o = kWarp / 2; o >= LPK; o >>= 1)
#pragma unroll
        for (int g = 0; g < GP; ++g)
          mx[g] = fmaxf(mx[g], __shfl_xor_sync(kFull, mx[g], o));
      // no live key in the warp's batch (the rows share their keys): skip.
      // Otherwise every m is finite after the update, and a masked score
      // gives exp2(-1e30 - m) = 0 exactly.
      if (mx[0] == kNegInf) continue;
#pragma unroll
      for (int g = 0; g < GP; ++g) {
        if (mx[g] > m[g]) {  // warp-uniform
          const float a = fast_exp2(m[g] - mx[g]);
          l[g] *= a;
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[g][i] *= a;
          m[g] = mx[g];
        }
      }
#pragma unroll
      for (int j = 0; j < PB; ++j) {
        const int kk = (warp * Tile::kPasses + b0 + j) * KPP + grp;
        const float vsc = quant ? kscl[KK + kk] : 1.f;
        float vf[8];
        load8<LPK>(vt + kk * D, lk, vf);
#pragma unroll
        for (int g = 0; g < GP; ++g) {
          const float p = fast_exp2(s[j][g] - m[g]);
          l[g] += p;
          const float pv = quant ? p * vsc : p;
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[g][i] = fmaf(pv, vf[i], acc[g][i]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it holds the warps' partials now

  // sum over the warp's key groups (they share m), then over the warps
#pragma unroll
  for (int o = kWarp / 2; o >= LPK; o >>= 1)
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      l[g] += __shfl_xor_sync(kFull, l[g], o);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        acc[g][i] += __shfl_xor_sync(kFull, acc[g][i], o);
    }
  float* red = reinterpret_cast<float*>(ring_smem);  // warps x GP x PS
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    if (g < G && grp == 0) {
      float* r = red + (warp * GP + g) * PS;
#pragma unroll
      for (int i = 0; i < 8; ++i) r[dim_of<TKV, LPK>(lk, i)] = acc[g][i];
      if (lk == 0) {
        r[D] = m[g];
        r[D + 1] = l[g];
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < G * D; e += kDecodeThreads) {
    const int g = e / D, d = e % D;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w)
      M = fmaxf(M, red[(w * GP + g) * PS + D]);
    float A = 0.f, L = 0.f;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) {
      const float* r = red + (w * GP + g) * PS;
      const float wt = exp2f(r[D] - M);
      A = fmaf(wt, r[d], A);
      L = fmaf(wt, r[D + 1], L);
    }
    if (n_live == 1) {
      store1(out + (row0 + g) * D + d, A / fmaxf(L, 1e-20f));
    } else {
      mine[g * PS + d] = A;
      if (d == 0) {
        mine[g * PS + D] = M;
        mine[g * PS + D + 1] = L;
      }
    }
  }
  if (n_live > 1)
    merge_if_last(part_bh, tickets + bh, out + row0 * D, G, D, n_live,
                  reinterpret_cast<float*>(ring_smem));
}

// Persistent: at most as many blocks as the card holds at once, each
// taking items (split-major: the early splits, live in most sequences,
// first) from a counter until none is left, so an item with no live key
// costs a look at its sequence's length and a block never waits for a
// slot. tickets[n_bh] counts the items taken, tickets[n_bh + 1] the blocks
// done; the last block out resets both. Which block takes an item changes
// none of its arithmetic.
template <typename TQ, typename TKV, int D, int GP>
__global__ void __launch_bounds__(kDecodeThreads)
paged_attention_split_kernel(const TQ* __restrict__ q,
                             const TKV* __restrict__ kp,
                             const TKV* __restrict__ vp,
                             const float* __restrict__ ks,
                             const float* __restrict__ vs,
                             const int* __restrict__ tables,
                             const int* __restrict__ lens,
                             const int* __restrict__ starts,
                             TQ* __restrict__ out, float* __restrict__ part,
                             int* __restrict__ tickets, int B, int Hkv,
                             int G, int P, int ps, int W, int n_split,
                             int split_pages, int ends_at,
                             float scale_log2) {
  extern __shared__ __align__(16) unsigned char ring_smem[];
  __shared__ int item_s;
  int* end_s = reinterpret_cast<int*>(ring_smem + ends_at);  // B key ends
  const int n_bh = B * Hkv;
  // decode: every row sits at starts[b] (lens[b] - 1 without starts)
  for (int i = threadIdx.x; i < B; i += kDecodeThreads)
    end_s[i] = min(starts ? min(lens[i], starts[i] + 1) : lens[i], W * ps);
  for (;;) {
    __syncthreads();  // end_s; the last item's shared memory is free
    if (threadIdx.x == 0) item_s = atomicAdd(tickets + n_bh, 1);
    __syncthreads();
    const int item = item_s;
    if (item >= n_bh * n_split) break;
    const int bh = item % n_bh;
    decode_item<TQ, TKV, D, GP>(q, kp, vp, ks, vs, tables, out, part,
                                tickets, Hkv, G, P, ps, W, n_split,
                                split_pages, scale_log2, item / n_bh, bh,
                                end_s[bh / Hkv]);
  }
  if (threadIdx.x == 0
      && atomicAdd(tickets + n_bh + 1, 1) == (int)gridDim.x - 1) {
    atomicExch(tickets + n_bh, 0);
    atomicExch(tickets + n_bh + 1, 0);
  }
}

struct DecodeArgs {
  const void *q, *k, *v;
  const float *ks, *vs;
  const int *tables, *lens, *starts;
  void* out;
  float* part;
  int* tickets;
  int B, Hkv, G, D, P, ps, W, n_split, split_pages, n_sm;
  float scale_log2;
  cudaStream_t stream;
};

template <typename TQ, typename TKV, int D, int GP>
cudaError_t launch_split(const DecodeArgs& a) {
  using Tile = DecodeTile<TKV, D>;
  const size_t red = sizeof(float) * kDecodeWarps * GP * (D + 2);
  const size_t ring = (size_t)Tile::kRingBytes > red ? Tile::kRingBytes : red;
  // the last block's merge reuses the ring: (2 * n_split + 1) * G floats
  const size_t merge = sizeof(float) * (2 * (size_t)a.n_split + 1) * a.G;
  const size_t ends_at = (ring > merge ? ring : merge)
                         + sizeof(float) * kStages * 2 * Tile::kKeys
                         + sizeof(int) * kStages * Tile::kKeys
                         + sizeof(int) * a.split_pages;
  const size_t smem = ends_at + sizeof(int) * a.B;
  auto kern = paged_attention_split_kernel<TQ, TKV, D, GP>;
  // above 48 KB a block's shared memory must be asked for explicitly, per
  // instance and device, whenever a launch takes more than was asked
  static size_t smem_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem > smem_set[dev]) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    smem_set[dev] = smem;
  }
  const long long items = (long long)a.B * a.Hkv * a.n_split;
  if (items <= 0) return cudaSuccess;
  if (items > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  // as many blocks as the card holds at once (per device and smem size)
  static size_t occ_smem[kMaxDevices] = {};
  static int occ_blocks[kMaxDevices] = {};
  if (occ_smem[dev] != smem) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ_blocks[dev], kern, kDecodeThreads, smem);
    if (err != cudaSuccess) return err;
    if (occ_blocks[dev] < 1) return cudaErrorInvalidConfiguration;
    occ_smem[dev] = smem;
  }
  const long long held = (long long)occ_blocks[dev] * a.n_sm;
  kern<<<(unsigned)(items < held ? items : held), kDecodeThreads, smem,
         a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k),
      static_cast<const TKV*>(a.v), a.ks, a.vs, a.tables, a.lens, a.starts,
      static_cast<TQ*>(a.out), a.part, a.tickets, a.B, a.Hkv, a.G, a.P,
      a.ps, a.W, a.n_split, a.split_pages, (int)ends_at, a.scale_log2);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, int D>
cudaError_t split_by_group(const DecodeArgs& a) {
  if (a.G <= 1) return launch_split<TQ, TKV, D, 1>(a);
  if (a.G <= 2) return launch_split<TQ, TKV, D, 2>(a);
  if (a.G <= 4) return launch_split<TQ, TKV, D, 4>(a);
  return launch_split<TQ, TKV, D, 8>(a);
}

template <typename TQ, typename TKV>
cudaError_t split_by_dim(const DecodeArgs& a) {
  switch (a.D) {
    case 64: return split_by_group<TQ, TKV, 64>(a);
    case 128: return split_by_group<TQ, TKV, 128>(a);
    case 256: return split_by_group<TQ, TKV, 256>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace paged_attention_impl
