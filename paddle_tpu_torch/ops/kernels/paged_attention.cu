// Paged attention for Hopper (sm_90a), CUDA C++ with a plain C entry point.
//
// Replaces the TPU kernel `_paged_kernel` in
// paddle_tpu/ops/pallas/paged_attention.py (launched by `_paged_call`,
// behind `paged_attention` for decode and `paged_prefill_attention` for
// chunked prefill). It computes the same function:
//
//   q      (B, Hkv, R, D)      R = G * chunk query rows per kv head; row r
//                              sits at absolute position start[b] + r % chunk
//   k, v   (Hkv, P, ps, D)     page pools: f32, bf16, or int8 with per-slot
//                              f32 scales ks, vs (Hkv, P, ps)
//   tables (B, W) int32        page ids of each sequence
//   lens, starts (B,) int32
//   out    (B, Hkv, R, D)      q's dtype
//
// Key slot t is live for row r iff t <= position(r) and t < lens[b]; a
// slot on a page id outside [0, P) reads nothing and is not live. Scores
// are q.k * sm_scale in f32, masked, run through an online softmax; the
// output is acc / max(l, 1e-20), so a row with no live key is exactly 0
// (serving pad rows rely on it).
//
// What bounds it: the bytes of the live K/V pages. Decode does 4*D flops
// per key per query row against 2*D*bytes(kv) bytes per key, far under the
// card's ~295 flop/byte balance point: a streaming read of the live pages.
// Prefill (R = G * chunk rows against the same pages) does chunk times the
// flops on the same bytes: at chunk 256 the tensor cores' rate bounds it.
//
// The C entry routes on shapes alone, between three kernels, by
// `paged_attention_instance` (exported, so the wrapper asks the same
// route), and reports through an out-parameter which one it launched:
//
// * Decode (chunk == 1, G <= kDecodeMaxGroup): flash-decoding, one kernel.
//   - The keys of each (sequence, kv head) are split into n_split
//     contiguous ranges of `split_pages` whole pages, planned from W, ps,
//     B, Hkv and the SM count only (`plan_splits`, mirrored by
//     `_decode_splits` in ops/paged_attention.py): about kSplitItemsPerSm
//     items an SM, and at least kSplitMinKeys keys a split. The host never
//     reads lens, so a call never synchronises and can be captured in a
//     CUDA graph.
//   - The grid is persistent: as many blocks as the card holds at once,
//     each taking (split, sequence, kv head) items from an atomic counter,
//     split-major, so the early splits, live in most sequences, go first.
//     The lengths are read on the card, once a block: an item past
//     min(lens, pos + 1) adds nothing and costs a look at its length, and
//     the splits below it are the sequence's live ones.
//   - An item streams its keys through a kStages-deep ring in shared
//     memory, in the pool's own dtype, by cp.async (16-byte copies; a dead
//     slot or a bad page zero-fills), with kStages - 1 tiles in flight
//     while one is scored. Its page ids sit in shared memory; int8 slots
//     are dequantised at use with their scales, copied beside the tile.
//   - All kDecodeWarps warps work on every tile: a warp takes a slice of
//     its keys, the D / 8 lanes of a key hold 8 of its dims each (the q
//     rows of those dims in registers), and shuffles reduce the dot
//     products. All G query rows of the kv head score against the same K
//     tile. A warp scores a batch of its keys before one max and rescale a
//     row; m, l and acc stay in f32 registers (the softmax in base 2, by
//     the SFU's ex2), summed over the warp's keys and then over the warps.
//   - A sequence with one live split writes its output there. Otherwise
//     each live item writes (acc[D], m, l) of its G rows to a workspace of
//     (B, Hkv, n_split, G, D + 2) floats that the wrapper allocates, and
//     the last of them to finish, found by an atomic ticket, merges the
//     partials in split order (no atomics on values, so two launches give
//     the same bits) and writes the output in q's dtype. The tickets and
//     the item counter (B * Hkv + 2 ints, zero between calls) are reset by
//     the kernel itself.
//   What holds it (one H100, PERF.md): the SMs' issue rate while every
//   live item is in flight, about a fifth of a tile's instructions the
//   copies' addressing (cp.async moves 16 bytes a thread) and the rest the
//   scoring around the FMAs (shuffles, conversions, the online softmax);
//   then the longest sequence's items in series and its merge. At the
//   serve shape a call reads 4-5x its byte bound.
//
// * Prefill chunks that `prefill_route` takes (chunk > 1, q bf16, pools
//   bf16 or int8, D 64 / 128 / 256, ps a multiple of 64 or a divisor of
//   64 of at least 8 slots): `paged_prefill_mma`, on the tensor cores.
//   - One warpgroup a CTA, 64 query rows: group_tile(G, 64) heads x 64 /
//     GT positions, so each K/V tile is read once for all G heads of its
//     kv head where G divides 64 (one head's positions otherwise). CTAs of
//     the last positions (the longest key ranges) start first.
//   - q lands once by TMA. K and V stream in 64-key tiles through a
//     2-stage ring of TMA boxes over a 4-D map of the pool (D, ps, P,
//     Hkv), one box a page, its coordinates from the page ids; a bad id
//     is an out-of-bounds coordinate, which TMA fills with zeros, and its
//     keys are masked. int8 tiles are widened to bf16 (exact) on the card
//     into the swizzled layout, their scales copied beside them.
//   - S = q . K^T by wgmma; in f32 on the accumulators: times sm_scale *
//     log2(e) (q stays unscaled in bf16), the key's scale, the mask
//     (causal over absolute positions, lens, page validity), an online
//     softmax in base 2. P . V by wgmma from registers as two bf16 parts
//     of p (hi = bf16(p), lo = bf16(p - hi)), so p keeps about 2^-17 of
//     its f32 value: one rounding of p to bf16 would leave ~1e-3 / sqrt(n)
//     on an output near 0, past the 1e-4 the plain version's f32 p allows.
//   - The host reads no length; a call never synchronises.
//
// * Everything else (float32 q or pools, pages of other sizes, decode
//   with G > kDecodeMaxGroup): one kernel, one block per (sequence, kv
//   head, tile of query rows):
//   - all G query heads of a kv head share the block, so each K/V tile is
//     read from device memory once per row tile;
//   - the block walks only the pages below min(lens, last row position +
//     1), in tiles of 32 keys; the TPU version still DMAs the dead pages;
//   - each tile is staged in shared memory as f32, int8 dequantized there
//     with its per-slot scale; m, l and acc stay in registers in f32;
//   - one warp per query row: lane i scores key i of the tile (K rows are
//     padded to D+1 floats so the 32 lanes hit 32 banks), then the lanes
//     split the D output columns for the P.V update.
//   On the CUDA cores, a prefill chunk of 256 tokens read 80-140x its
//   tensor-core bound (PERF.md).
//
// Each call runs one CUDA kernel. Left for later work: decode's tiles by
// bulk copies (one instruction a page), and a producer warp with
// overlapped softmax for the prefill instance.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>
#include <stdint.h>

#include <type_traits>

// The wgmma, TMA and mbarrier primitives of the attention kernels, in a
// namespace of their own: their constants and helpers share names with
// the decode and row instances below. (The system headers it includes
// are included above, so their guards keep them out of the namespace.)
namespace tiles {
#include "flash_tiles.cuh"
}  // namespace tiles

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * kWarp;
constexpr int kKeyTile = 32;  // keys per shared-memory tile: one per lane
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;

// the decode instance: its route and its split plan (mirrored in Python)
constexpr int kDecodeMaxGroup = 8;    // query rows a kv head, at most
constexpr int kSplitMinKeys = 256;    // keys a split holds, at least
constexpr int kSplitItemsPerSm = 4;  // split items an SM the plan aims at
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

// RPW query rows per warp, kWarps warps: a block owns TR = kWarps * RPW rows.
template <typename TQ, typename TKV, int D, int RPW>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kp,
                       const TKV* __restrict__ vp,
                       const float* __restrict__ ks,
                       const float* __restrict__ vs,
                       const int* __restrict__ tables,
                       const int* __restrict__ lens,
                       const int* __restrict__ starts, TQ* __restrict__ out,
                       int Hkv, int R, int P, int ps, int W, int chunk,
                       float sm_scale, int n_row_tiles) {
  constexpr int TR = kWarps * RPW;
  constexpr int NC = D / kWarp;  // output columns per lane
  constexpr int KS = D + 1;      // padded K row stride (bank-conflict free)
  extern __shared__ float smem[];
  float* q_s = smem;                  // TR x D
  float* k_s = q_s + TR * D;          // kKeyTile x KS
  float* v_s = k_s + kKeyTile * KS;   // kKeyTile x D

  const int tile = blockIdx.x % n_row_tiles;
  const int bh = blockIdx.x / n_row_tiles;
  const int h = bh % Hkv;
  const int b = bh / Hkv;
  const int r0 = tile * TR;
  const int rows = min(TR, R - r0);
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;

  const int seq_len = lens[b];
  const int start = starts[b];
  // the furthest position any row of this tile holds bounds the keys
  const int r_last = r0 + rows - 1;
  const int max_off = (r0 / chunk != r_last / chunk) ? chunk - 1
                                                     : r_last % chunk;
  const int key_end = min(seq_len, start + max_off + 1);

  const size_t slab = (size_t)(b * Hkv + h) * R + r0;  // first row of tile
  const TQ* qb = q + slab * D;
  for (int e = threadIdx.x * 4; e < rows * D; e += kThreads * 4)
    load4(qb + e, q_s + e);

  float m[RPW], l[RPW], acc[RPW][NC];
  int pos[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
    pos[i] = start + (r0 + warp * RPW + i) % chunk;
  }

  const bool quant = ks != nullptr;
  for (int j = 0; j < W && j * ps < key_end; ++j) {
    const int page = tables[b * W + j];
    const bool page_ok = page >= 0 && page < P;  // a bad id reads nothing
    for (int off = 0; off < ps && j * ps + off < key_end; off += kKeyTile) {
      const int kpos0 = j * ps + off;
      const int n = page_ok ? min(min(kKeyTile, ps - off), key_end - kpos0)
                            : 0;
      const size_t row0 = ((size_t)h * P + (page_ok ? page : 0)) * ps + off;
      __syncthreads();  // the previous tile is consumed
      for (int e = threadIdx.x * 4; e < kKeyTile * D; e += kThreads * 4) {
        const int kk = e / D, d = e % D;
        float kv4[4] = {0.f, 0.f, 0.f, 0.f}, vv4[4] = {0.f, 0.f, 0.f, 0.f};
        if (kk < n) {
          load4(kp + row0 * D + e, kv4);
          load4(vp + row0 * D + e, vv4);
          if (quant) {
            const float a = ks[row0 + kk], s = vs[row0 + kk];
#pragma unroll
            for (int t = 0; t < 4; ++t) { kv4[t] *= a; vv4[t] *= s; }
          }
        }
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          k_s[kk * KS + d + t] = kv4[t];
          v_s[kk * D + d + t] = vv4[t];
        }
      }
      __syncthreads();

#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const int r = warp * RPW + i;
        // warp-uniform: a row past the tile, or a tile wholly in the
        // row's future, changes nothing
        if (r < rows && kpos0 <= pos[i]) {
          const float* qr = q_s + r * D;
          const float* kr = k_s + lane * KS;
          float s = 0.f;
#pragma unroll 16
          for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
          s *= sm_scale;
          const int kpos = kpos0 + lane;
          const bool live = lane < n && kpos <= pos[i] && kpos < seq_len;
          s = live ? s : kNegInf;
          const float m_new = fmaxf(m[i], warp_max(s));
          const float p = live ? expf(s - m_new) : 0.f;
          const float alpha = expf(m[i] - m_new);
          l[i] = l[i] * alpha + warp_sum(p);
#pragma unroll
          for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
          for (int kk = 0; kk < n; ++kk) {
            const float pk = __shfl_sync(kFull, p, kk);
            const float* vr = v_s + kk * D + lane;
#pragma unroll
            for (int c = 0; c < NC; ++c)
              acc[i][c] = fmaf(pk, vr[c * kWarp], acc[i][c]);
          }
          m[i] = m_new;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = warp * RPW + i;
    if (r < rows) {
      const float den = fmaxf(l[i], 1e-20f);
      TQ* o = out + (slab + r) * D + lane;
#pragma unroll
      for (int c = 0; c < NC; ++c) store1(o + c * kWarp, acc[i][c] / den);
    }
  }
}

template <typename TQ, typename TKV, int D, int RPW>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* ks, const float* vs, const int* tables,
                   const int* lens, const int* starts, void* out, int B,
                   int Hkv, int R, int P, int ps, int W, int chunk,
                   float sm_scale, cudaStream_t stream) {
  constexpr int TR = kWarps * RPW;
  const size_t smem =
      sizeof(float) * (TR * D + kKeyTile * (D + 1) + kKeyTile * D);
  auto kern = paged_attention_kernel<TQ, TKV, D, RPW>;
  // above 48 KB a block's shared memory must be asked for explicitly, once
  // per instance and device
  static bool smem_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!smem_set[dev]) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    smem_set[dev] = true;
  }
  const int n_row_tiles = (R + TR - 1) / TR;
  const long long blocks = (long long)B * Hkv * n_row_tiles;
  if (blocks <= 0) return cudaSuccess;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kern<<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), ks, vs, tables, lens, starts,
      static_cast<TQ*>(out), Hkv, R, P, ps, W, chunk, sm_scale, n_row_tiles);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, int D>
cudaError_t by_rows(const void* q, const void* k, const void* v,
                    const float* ks, const float* vs, const int* tables,
                    const int* lens, const int* starts, void* out, int B,
                    int Hkv, int R, int P, int ps, int W, int chunk,
                    float sm_scale, cudaStream_t stream) {
  // decode has R = G rows (a handful, one per warp up to G = 4); prefill
  // has G * chunk rows
  if (R <= kWarps)
    return launch<TQ, TKV, D, 1>(q, k, v, ks, vs, tables, lens, starts, out,
                                 B, Hkv, R, P, ps, W, chunk, sm_scale,
                                 stream);
  return launch<TQ, TKV, D, 8>(q, k, v, ks, vs, tables, lens, starts, out, B,
                               Hkv, R, P, ps, W, chunk, sm_scale, stream);
}

template <typename TQ, typename TKV>
cudaError_t by_dim(const void* q, const void* k, const void* v,
                   const float* ks, const float* vs, const int* tables,
                   const int* lens, const int* starts, void* out, int B,
                   int Hkv, int R, int D, int P, int ps, int W, int chunk,
                   float sm_scale, cudaStream_t stream) {
  switch (D) {
    case 64:
      return by_rows<TQ, TKV, 64>(q, k, v, ks, vs, tables, lens, starts, out,
                                  B, Hkv, R, P, ps, W, chunk, sm_scale,
                                  stream);
    case 128:
      return by_rows<TQ, TKV, 128>(q, k, v, ks, vs, tables, lens, starts,
                                   out, B, Hkv, R, P, ps, W, chunk, sm_scale,
                                   stream);
    case 256:  // 8 rows a warp: 4 * (32 * 256 + 32 * 257 + 32 * 256) B
      return by_rows<TQ, TKV, 256>(q, k, v, ks, vs, tables, lens, starts,
                                   out, B, Hkv, R, P, ps, W, chunk, sm_scale,
                                   stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename TQ>
cudaError_t by_kv(const void* q, const void* k, const void* v,
                  const float* ks, const float* vs, const int* tables,
                  const int* lens, const int* starts, void* out, int B,
                  int Hkv, int R, int D, int P, int ps, int W, int chunk,
                  float sm_scale, int kv_dtype, cudaStream_t stream) {
  switch (kv_dtype) {
    case kF32:
      return by_dim<TQ, float>(q, k, v, nullptr, nullptr, tables, lens,
                               starts, out, B, Hkv, R, D, P, ps, W, chunk,
                               sm_scale, stream);
    case kBF16:
      return by_dim<TQ, __nv_bfloat16>(q, k, v, nullptr, nullptr, tables,
                                       lens, starts, out, B, Hkv, R, D, P, ps,
                                       W, chunk, sm_scale, stream);
    case kI8:
      if (ks == nullptr || vs == nullptr) return cudaErrorInvalidValue;
      return by_dim<TQ, int8_t>(q, k, v, ks, vs, tables, lens, starts, out,
                                B, Hkv, R, D, P, ps, W, chunk, sm_scale,
                                stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// --- decode: split-K over pages (flash-decoding) ---------------------------

// The split plan, from shapes alone: about kSplitItemsPerSm (split,
// sequence, kv head) items an SM, each split at least kSplitMinKeys keys
// (whole pages), no split empty of pages. Returns n_split; *pages gets the
// pages a split holds.
int plan_splits(int B, int Hkv, int W, int ps, int n_sm, int* pages) {
  const long long min_pages = (kSplitMinKeys + ps - 1) / ps;
  const long long bh = (long long)B * Hkv > 0 ? (long long)B * Hkv : 1;
  const long long want = (kSplitItemsPerSm * (long long)n_sm + bh - 1) / bh;
  const long long most = W / min_pages;  // splits of min_pages or more
  long long n = want < most ? want : most;
  if (n < 1) n = 1;
  *pages = (int)((W + n - 1) / n);
  return (W + *pages - 1) / *pages;
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

template <typename TQ>
cudaError_t split_by_kv(const DecodeArgs& a, int kv_dtype) {
  switch (kv_dtype) {
    case kF32: return split_by_dim<TQ, float>(a);
    case kBF16: return split_by_dim<TQ, __nv_bfloat16>(a);
    case kI8: return split_by_dim<TQ, int8_t>(a);
    default: return cudaErrorInvalidValue;
  }
}

// the SM count of the current device, read once per device
cudaError_t sm_count(int* n) {
  static int counts[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (counts[dev] == 0) {
    err = cudaDeviceGetAttribute(&counts[dev],
                                 cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  *n = counts[dev];
  return cudaSuccess;
}

// --- prefill: wgmma on a TMA-fed page ring -----------------------------------

// The calls the prefill instance takes, on shapes alone: a chunk of more
// than one position, q in bf16, pools in bf16 or int8, head_dim 64, 128 or
// 256, and pages that tile a 64-key tile whole: ps a multiple of
// kPrefillKeys, or a divisor of it of at least kPrefillMinPage slots (a
// page's box of bf16 rows must land on the 128-byte swizzle's 1024-byte
// period, 8 rows).
constexpr int kPrefillKeys = 64;    // keys a tile of the ring
constexpr int kPrefillMinPage = 8;  // slots a page, at least
constexpr int kPrefillThreads = 128;  // one warpgroup: 64 query rows
constexpr int kPrefillPagesMax = kPrefillKeys / kPrefillMinPage;
static_assert(kPrefillThreads == 2 * kPrefillKeys,
              "a thread copies one of a tile's key and value scales");

bool prefill_route(int chunk, int q_dtype, int kv_dtype, int D, int ps) {
  return chunk > 1 && q_dtype == kBF16
         && (kv_dtype == kBF16 || kv_dtype == kI8)
         && (D == 64 || D == 128 || D == 256)
         && (ps % kPrefillKeys == 0
             || (kPrefillKeys % ps == 0 && ps >= kPrefillMinPage));
}

// Shared memory of one instance, in bytes from a 1024-aligned base: the
// resident q tile; the ring's stages, each a K and a V tile in the pool's
// dtype (bf16: 128-byte swizzled as TMA lands them; int8: rows as in the
// pool); for int8, the tile's K and V widened to bf16 (swizzled), the
// stages' scales (ks[64], vs[64]) and the tile's own copy of them; the
// stages' page ids; the barriers.
template <typename TKV, int D>
struct PrefillSmem {
  static constexpr bool kQuant = sizeof(TKV) == 1;
  static constexpr int kTile = tiles::tile_bytes<D>();  // 64 x D bf16
  static constexpr int kHalfStage = kPrefillKeys * D * (int)sizeof(TKV);
  static constexpr int kRing = kTile;
  static constexpr int kWide = kRing + tiles::kStages * 2 * kHalfStage;
  static constexpr int kScales = kWide + (kQuant ? 2 * kTile : 0);
  static constexpr int kPages =
      kScales + (kQuant ? (tiles::kStages + 1) * 2 * kPrefillKeys * 4 : 0);
  static constexpr int kBars = kPages + tiles::kStages * kPrefillPagesMax * 4;
  static constexpr size_t kBytes = 1024 + kBars + tiles::kBarrierBytes;
  static_assert(kWide % 1024 == 0 && kBars % 8 == 0, "prefill: alignment");
};

struct PrefillMaps {  // q (3-D) and the two pools (4-D), encoded per call
  CUtensorMap q, k, v;
};

// int8 rows (64 x D, as in the pool) -> bf16, exactly (every int8 is a
// bf16), into the 128-byte-swizzled layout the wgmma descriptors read: the
// 16-byte chunk c of row r (8 columns) lands in column box c / 8, row r,
// chunk (c % 8) ^ (r % 8).
template <int D>
__device__ __forceinline__ void widen_tile(unsigned char* dst,
                                           const int8_t* src) {
  constexpr int CH = D / 8;  // chunks a row
  using E = tiles::Elt<__nv_bfloat16>;
  for (int e = threadIdx.x; e < kPrefillKeys * CH; e += kPrefillThreads) {
    const int r = e / CH, c = e % CH;
    const char4 a = *reinterpret_cast<const char4*>(src + r * D + c * 8);
    const char4 b = *reinterpret_cast<const char4*>(src + r * D + c * 8 + 4);
    uint4 w;
    w.x = E::pack((float)a.x, (float)a.y);
    w.y = E::pack((float)a.z, (float)a.w);
    w.z = E::pack((float)b.x, (float)b.y);
    w.w = E::pack((float)b.z, (float)b.w);
    *reinterpret_cast<uint4*>(dst + (c / 8) * tiles::kBox + r * 128
                              + ((c % 8) ^ (r % 8)) * 16) = w;
  }
}

// One CTA (one warpgroup) per (sequence x group of GT query heads of a kv
// head, tile of 64 / GT chunk positions): GT heads x BQ positions, 64
// rows, row r at head r / BQ and chunk position p0 + r % BQ. q is resident
// (TMA, unscaled bf16); the 64-key tiles of the pages below the tile's
// last live key stream through a kStages ring, one TMA box a page (warp 0
// produces: page ids from the table, and for int8 the slots' scales by
// cp.async, one ring ahead). Per tile, in f32 on the accumulators: S = q .
// K^T (wgmma, both from shared memory), times sm_scale * log2(e) (and the
// key's scale), masked causally by absolute position, by lens and by page
// validity; the online softmax in base 2; p times the value's scale, split
// as hi = bf16(p) and lo = bf16(p - hi), and O += hi . V + lo . V (two
// wgmma from registers, V read MN-major). out = O / max(l, 1e-20) in bf16,
// from registers: a row with no live key is exactly 0. No atomics.
template <typename TKV, int D>
__global__ void __launch_bounds__(kPrefillThreads, D > 128 ? 1 : 2)
paged_prefill_mma(const __grid_constant__ PrefillMaps maps,
                  const float* __restrict__ ks, const float* __restrict__ vs,
                  const int* __restrict__ tables,
                  const int* __restrict__ lens,
                  const int* __restrict__ starts,
                  __nv_bfloat16* __restrict__ out, int Hkv, int G, int GT,
                  int C, int P, int ps, int W, float scale_log2, int BHg,
                  int n_q_tiles) {
  using L = PrefillSmem<TKV, D>;
  using T = __nv_bfloat16;
  constexpr bool quant = L::kQuant;
  constexpr int TB = L::kTile;
  constexpr int NS = tiles::kStages;
  extern __shared__ unsigned char prefill_smem[];
  unsigned char* sm = tiles::align1024(prefill_smem);
  // full barriers: the TMA bytes and warp 0's arrival (int8: and each
  // lane's scale copies)
  uint64_t* bar = tiles::ring_barriers(sm + L::kBars, quant ? 33 : 1);
  int* pages_s = reinterpret_cast<int*>(sm + L::kPages);  // NS x pages
  float* scl_s = reinterpret_cast<float*>(sm + L::kScales);  // NS x 128
  float* tile_scl = scl_s + NS * 2 * kPrefillKeys;  // the tile's ks, vs

  const int hg = blockIdx.x % BHg;
  const int qt = n_q_tiles - 1 - blockIdx.x / BHg;  // longest rows first
  const int bh = hg / (G / GT);                     // (sequence, kv head)
  const int h = bh % Hkv, b = bh / Hkv;
  const int BQ = kPrefillKeys / GT;
  const int p0 = qt * BQ;
  const int start = starts[b], len = lens[b];
  // keys below the tile's last position, its sequence's length and the
  // table's end
  const int key_end =
      min(min(len, start + min(p0 + BQ, C)), W * ps);
  const int n_k = key_end > 0 ? (key_end + kPrefillKeys - 1) / kPrefillKeys
                              : 0;
  const int kpp = ps < kPrefillKeys ? ps : kPrefillKeys;  // a page's keys
  const int npg = kPrefillKeys / kpp;                     // pages a tile

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // lane pi < npg of warp 0: the id of page pi of tile i (-1 past the
  // table), read one load ahead so its latency hides behind a tile
  const auto page_id = [&](int i) {
    const int j = (i * kPrefillKeys + lane * kpp) / ps;  // table column
    return lane < npg && j < W ? tables[(size_t)b * W + j] : -1;
  };
  int next_page = warp == 0 ? page_id(0) : -1;
  const auto load = [&](int i) {  // by warp 0: tile i into its stage
    const int s = i % NS;
    int* pg = pages_s + s * kPrefillPagesMax;
    const int page = next_page;
    next_page = page_id(i + 1);
    if (lane < npg) pg[lane] = page >= 0 && page < P ? page : -1;
    __syncwarp();
    if constexpr (quant) {  // the slots' scales; 0 on a bad page
      float* sc = scl_s + s * 2 * kPrefillKeys;
      for (int e = lane; e < 2 * kPrefillKeys; e += 32) {
        const int kk = e % kPrefillKeys;
        const int page = pg[kk / kpp];
        const size_t row = ((size_t)h * P + (page < 0 ? 0 : page)) * ps
                           + (i * kPrefillKeys + kk) % ps;
        cp_async4(sc + e, (e < kPrefillKeys ? ks : vs) + row, page >= 0);
      }
      tiles::cp_async_arrive(&bar[s]);
    }
    if (lane == 0) {
      unsigned char* kd = sm + L::kRing + s * 2 * L::kHalfStage;
      unsigned char* vd = kd + L::kHalfStage;
      const int slot0 = (i * kPrefillKeys) % ps;
      tiles::mbar_expect_tx(&bar[s], 2 * L::kHalfStage);
      for (int pi = 0; pi < npg; ++pi) {
        const int page = pg[pi];  // -1 lies out of bounds: zeros
        if constexpr (quant) {
          tiles::tma_4d(kd + pi * kpp * D, &maps.k, &bar[s], 0, slot0, page, h);
          tiles::tma_4d(vd + pi * kpp * D, &maps.v, &bar[s], 0, slot0, page, h);
        } else {
#pragma unroll
          for (int c = 0; c < D / tiles::kHalf; ++c) {
            const int at = c * tiles::kBox + pi * kpp * 128;
            tiles::tma_4d(kd + at, &maps.k, &bar[s], c * tiles::kHalf, slot0,
                   page, h);
            tiles::tma_4d(vd + at, &maps.v, &bar[s], c * tiles::kHalf, slot0,
                   page, h);
          }
        }
      }
    }
  };
  if (warp == 0) {
    if (lane == 0) {
      tiles::mbar_expect_tx(&bar[2 * NS], TB);
      tiles::load_rows<D>(sm, &bar[2 * NS], &maps.q, p0, hg * GT);
    }
    for (int i = 0; i < NS && i < n_k; ++i) load(i);
  }

  const int g = lane / 4, t = lane % 4;
  const int r0 = warp * 16 + g, r1 = r0 + 8;  // this lane's two rows
  const int c0 = p0 + r0 % BQ, c1 = p0 + r1 % BQ;  // their chunk positions
  const int pos0 = start + c0, pos1 = start + c1;
  const unsigned char* q_s = sm;
  unsigned char* wide = sm + L::kWide;  // int8: the tile's K, V in bf16

  float o[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) o[e] = 0.f;
  float m0 = tiles::kNegInf, m1 = tiles::kNegInf, l0 = 0.f, l1 = 0.f;
  tiles::mbar_wait(&bar[2 * NS], 0);
  for (int i = 0; i < n_k; ++i) {
    const int s = i % NS;
    const int k0 = i * kPrefillKeys;
    tiles::mbar_wait(&bar[s], (i / NS) & 1);
    // which of this lane's key columns (8j + 2t, + 1) lie on a good page
    unsigned page_ok = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      page_ok |= (pages_s[s * kPrefillPagesMax + 8 * j / kpp] >= 0) << j;
    const unsigned char* k_s = sm + L::kRing + s * 2 * L::kHalfStage;
    const unsigned char* v_s = k_s + L::kHalfStage;
    if constexpr (quant) {
      __syncthreads();  // every warp is done with the last tile's wide K, V
      widen_tile<D>(wide, reinterpret_cast<const int8_t*>(k_s));
      widen_tile<D>(wide + TB, reinterpret_cast<const int8_t*>(v_s));
      tile_scl[threadIdx.x] = scl_s[s * 2 * kPrefillKeys + threadIdx.x];
      tiles::fence_proxy_async();
      __syncthreads();
      tiles::release(bar, i, n_k, 32, load);  // the stage is free already
      k_s = wide;
      v_s = wide + TB;
    }

    float st[32];
    tiles::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      tiles::wgmma_ss64<T>(st, tiles::desc_k(q_s, kk), tiles::desc_k(k_s, kk),
                           kk);
    tiles::wgmma_commit();
    tiles::wgmma_wait<0>();
    tiles::fence_regs<32>(st);
    // st[e]: row (e / 2) % 2 ? r1 : r0, key k0 + 8 * (e / 4) + 2t + e % 2
    float mx0 = tiles::kNegInf, mx1 = tiles::kNegInf;
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const bool hi = (e / 2) % 2;
      const int col = 8 * (e / 4) + 2 * t + e % 2;
      const int key = k0 + col;
      const bool live = ((page_ok >> (e / 4)) & 1) && key < len
                        && key <= (hi ? pos1 : pos0);
      float x = st[e];
      if constexpr (quant) x *= tile_scl[col];
      st[e] = live ? x * scale_log2 : tiles::kNegInf;
      if (hi) mx1 = fmaxf(mx1, st[e]);
      else mx0 = fmaxf(mx0, st[e]);
    }
    const float mn0 = fmaxf(m0, tiles::quad_max(mx0));
    const float mn1 = fmaxf(m1, tiles::quad_max(mx1));
    const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const bool hi = (e / 2) % 2;
      // exactly 0 on a masked key, also while the row's m is still -1e30
      const float p = st[e] > tiles::kMaskedBelow
                          ? exp2f(st[e] - (hi ? mn1 : mn0)) : 0.f;
      if (hi) sum1 += p;
      else sum0 += p;
      st[e] = p;
      if constexpr (quant) st[e] *= tile_scl[kPrefillKeys + 8 * (e / 4)
                                             + 2 * t + e % 2];
    }
    l0 = al0 * l0 + tiles::quad_sum(sum0);
    l1 = al1 * l1 + tiles::quad_sum(sum1);
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int e = 0; e < D / 2; ++e) o[e] *= (e / 2) % 2 ? al1 : al0;
    // p = hi + lo, each a bf16 operand: p . V to about 2^-17 of p
    uint32_t pa[4][4], pb[4][4];
    tiles::acc_to_a<T>(pa, st);
#pragma unroll
    for (int e = 0; e < 32; ++e)
      st[e] -= __bfloat162float(__float2bfloat16(st[e]));
    tiles::acc_to_a<T>(pb, st);
    tiles::fence_regs<D / 2>(o);
    tiles::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      tiles::wgmma_rs<T, D>(o, pa[kk], tiles::desc_mn(v_s, kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      tiles::wgmma_rs<T, D>(o, pb[kk], tiles::desc_mn(v_s, kk));
    tiles::wgmma_commit();
    tiles::wgmma_wait<0>();
    tiles::fence_regs<D / 2>(o);
    if constexpr (!quant) tiles::release(bar, i, n_k, 32, load);
  }

  // rows past the chunk (the tile's last positions) are not written
  const float d0 = fmaxf(l0, 1e-20f), d1 = fmaxf(l1, 1e-20f);
  const size_t head0 = (size_t)hg * GT * C;
  const size_t row0 = head0 + (size_t)(r0 / BQ) * C + c0;
  const size_t row1 = head0 + (size_t)(r1 / BQ) * C + c1;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = j * 8 + 2 * t;
    if (c0 < C)
      *reinterpret_cast<uint32_t*>(out + row0 * D + c) =
          tiles::Elt<T>::pack(o[4 * j] / d0, o[4 * j + 1] / d0);
    if (c1 < C)
      *reinterpret_cast<uint32_t*>(out + row1 * D + c) =
          tiles::Elt<T>::pack(o[4 * j + 2] / d1, o[4 * j + 3] / d1);
  }
}

// A pool (Hkv, P, ps, D) as a 4-D map (D, ps, P, Hkv) whose box is one
// page's slots of a tile (min(ps, 64)): bf16 as 64 columns under the
// 128-byte swizzle, int8 as whole rows unswizzled (widened on the card).
template <typename TKV>
bool pool_map(CUtensorMap* m, const void* pool, int Hkv, int P, int ps,
              int D) {
  constexpr bool quant = sizeof(TKV) == 1;
  const cuuint64_t es = sizeof(TKV);
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)ps, (cuuint64_t)P,
                              (cuuint64_t)Hkv};
  const cuuint64_t strides[3] = {D * es, (cuuint64_t)ps * D * es,
                                 (cuuint64_t)P * ps * D * es};
  const cuuint32_t box[4] = {quant ? (cuuint32_t)D : (cuuint32_t)tiles::kHalf,
                             (cuuint32_t)(ps < kPrefillKeys ? ps
                                                            : kPrefillKeys),
                             1, 1};
  return tiles::encode_map(m, quant ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                    : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                           pool, 4, dims, strides, box,
                           quant ? CU_TENSOR_MAP_SWIZZLE_NONE
                                 : CU_TENSOR_MAP_SWIZZLE_128B);
}

struct PrefillArgs {
  const void *q, *k, *v;
  const float *ks, *vs;
  const int *tables, *lens, *starts;
  void* out;
  int B, Hkv, G, C, D, P, ps, W;
  float scale_log2;
  cudaStream_t stream;
};

template <typename TKV, int D>
cudaError_t launch_prefill(const PrefillArgs& a) {
  PrefillMaps maps;
  const int GT = tiles::group_tile(a.G, kPrefillKeys);
  const int BQ = kPrefillKeys / GT;
  // q as (D, C, B * Hkv * G): a box of GT heads x BQ positions lands the
  // tile's 64 rows in order (positions past C read zeros)
  const cuuint64_t row = (cuuint64_t)D * sizeof(__nv_bfloat16);
  const cuuint64_t qdims[3] = {(cuuint64_t)D, (cuuint64_t)a.C,
                               (cuuint64_t)a.B * a.Hkv * a.G};
  const cuuint64_t qstrides[2] = {row, row * a.C};
  const cuuint32_t qbox[3] = {tiles::kHalf, (cuuint32_t)BQ, (cuuint32_t)GT};
  if (!tiles::encode_map(&maps.q, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a.q, 3,
                         qdims, qstrides, qbox)
      || !pool_map<TKV>(&maps.k, a.k, a.Hkv, a.P, a.ps, D)
      || !pool_map<TKV>(&maps.v, a.v, a.Hkv, a.P, a.ps, D))
    return cudaErrorInvalidValue;
  const int n_q = (a.C + BQ - 1) / BQ;
  const int BHg = a.B * a.Hkv * (a.G / GT);
  static bool done[kMaxDevices] = {};
  return tiles::run(paged_prefill_mma<TKV, D>, PrefillSmem<TKV, D>::kBytes,
                    done, (long long)BHg * n_q, kPrefillThreads, a.stream,
                    maps, a.ks, a.vs, a.tables, a.lens, a.starts,
                    static_cast<__nv_bfloat16*>(a.out), a.Hkv, a.G, GT, a.C,
                    a.P, a.ps, a.W, a.scale_log2, BHg, n_q);
}

template <typename TKV>
cudaError_t prefill_by_dim(const PrefillArgs& a) {
  switch (a.D) {
    case 64: return launch_prefill<TKV, 64>(a);
    case 128: return launch_prefill<TKV, 128>(a);
    case 256: return launch_prefill<TKV, 256>(a);
    default: return cudaErrorInvalidValue;
  }
}


// The launch of instance `inst` (`paged_attention_instance`); the
// arguments as `paged_attention_launch` takes them.
cudaError_t launch_instance(int inst, const void* q, const void* k,
                            const void* v, const void* k_scales,
                            const void* v_scales, const void* tables,
                            const void* lens, const void* starts, void* out,
                            void* workspace, void* tickets, int B, int Hkv,
                            int R, int D, int P, int ps, int W, int chunk,
                            int n_split, float sm_scale, int q_dtype,
                            int kv_dtype, cudaStream_t s) {
  const float* ks = static_cast<const float*>(k_scales);
  const float* vs = static_cast<const float*>(v_scales);
  const int* t = static_cast<const int*>(tables);
  const int* sl = static_cast<const int*>(lens);
  const int* st = static_cast<const int*>(starts);
  if (kv_dtype == kI8 && (ks == nullptr || vs == nullptr))
    return cudaErrorInvalidValue;
  if (inst == kInstSplit) {
    int n_sm = 0, pages = 0;
    cudaError_t err = sm_count(&n_sm);
    if (err != cudaSuccess) return err;
    if (n_split != plan_splits(B, Hkv, W, ps, n_sm, &pages)
        || tickets == nullptr || (n_split > 1 && workspace == nullptr))
      return cudaErrorInvalidValue;
    const DecodeArgs a{q, k, v, kv_dtype == kI8 ? ks : nullptr,
                       kv_dtype == kI8 ? vs : nullptr, t, sl, st, out,
                       static_cast<float*>(workspace),
                       static_cast<int*>(tickets), B, Hkv, R, D, P, ps,
                       W, n_split, pages, n_sm,
                       sm_scale * 1.4426950408889634f,  // log2(e)
                       s};
    switch (q_dtype) {
      case kF32: return split_by_kv<float>(a, kv_dtype);
      case kBF16: return split_by_kv<__nv_bfloat16>(a, kv_dtype);
      default: return cudaErrorInvalidValue;
    }
  }
  if (st == nullptr) return cudaErrorInvalidValue;
  if (inst == kInstMma) {
    if (R % chunk) return cudaErrorInvalidValue;
    const PrefillArgs a{q, k, v, ks, vs, t, sl, st, out, B, Hkv, R / chunk,
                        chunk, D, P, ps, W,
                        sm_scale * 1.4426950408889634f,  // log2(e)
                        s};
    return kv_dtype == kI8 ? prefill_by_dim<int8_t>(a)
                           : prefill_by_dim<__nv_bfloat16>(a);
  }
  switch (q_dtype) {
    case kF32:
      return by_kv<float>(q, k, v, ks, vs, t, sl, st, out, B, Hkv, R, D, P,
                          ps, W, chunk, sm_scale, kv_dtype, s);
    case kBF16:
      return by_kv<__nv_bfloat16>(q, k, v, ks, vs, t, sl, st, out, B, Hkv, R,
                                  D, P, ps, W, chunk, sm_scale, kv_dtype, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The instance a call with these shapes runs, on shapes alone: 0 the split
// decode instance (chunk == 1, R <= kDecodeMaxGroup), 1 the tensor-core
// prefill instance (`prefill_route`), 2 the row-tile kernel. The one
// route: `paged_attention_launch` dispatches by it and reports it.
int paged_attention_instance(int chunk, int R, int q_dtype, int kv_dtype,
                             int D, int ps) {
  if (chunk == 1 && R <= kDecodeMaxGroup) return kInstSplit;
  return prefill_route(chunk, q_dtype, kv_dtype, D, ps) ? kInstMma
                                                        : kInstRows;
}

// Returns a cudaError_t: 0 on a launch the card accepted. Allocates nothing
// and does not synchronise; everything runs on `stream`. Decode (chunk ==
// 1, R <= kDecodeMaxGroup) takes the split instance: `n_split` must be the
// plan's for these shapes on this device, `tickets` holds B * Hkv + 2 ints
// that are 0 (each call leaves them 0 again; calls that may run at once
// need their own), at n_split > 1 `workspace` holds (B, Hkv, n_split, R,
// D + 2) floats, and `starts` may be null (each row at lens - 1). Other calls
// need `starts` and ignore workspace, tickets and n_split: a chunk that
// `prefill_route` takes runs the wgmma instance (R a multiple of chunk),
// everything else the row-tile kernel. `*instance` is set to the instance
// launched (`paged_attention_instance`), or to -1 when none was.
int paged_attention_launch(const void* q, const void* k, const void* v,
                           const void* k_scales, const void* v_scales,
                           const void* tables, const void* lens,
                           const void* starts, void* out, void* workspace,
                           void* tickets, int* instance, int B, int Hkv,
                           int R, int D, int P, int ps,
                           int W, int chunk, int n_split, float sm_scale,
                           int q_dtype, int kv_dtype, void* stream) {
  *instance = -1;
  if (chunk < 1 || ps < 1 || W < 1 || R < 1) return cudaErrorInvalidValue;
  const int inst = paged_attention_instance(chunk, R, q_dtype, kv_dtype, D,
                                            ps);
  const cudaError_t err = launch_instance(
      inst, q, k, v, k_scales, v_scales, tables, lens, starts, out,
      workspace, tickets, B, Hkv, R, D, P, ps, W, chunk, n_split, sm_scale,
      q_dtype, kv_dtype, static_cast<cudaStream_t>(stream));
  if (err == cudaSuccess) *instance = inst;
  return err;
}

const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
