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
// Key slot t is live for row r iff t <= position(r) and t < lens[b].
// Scores are q.k * sm_scale in f32, masked to -1e30, run through an online
// softmax; the output is acc / max(l, 1e-20), so a row with no live key is
// exactly 0 (serving pad rows rely on it).
//
// What bounds it: the bytes of the live K/V pages. Decode does 4*D flops
// per key per query row against 2*D*bytes(kv) bytes per key, well under
// the card's ~295 flop/byte balance point, so the kernel is a streaming
// read of the pages. The design follows that:
//   * one block per (sequence, kv head, tile of query rows); all G query
//     heads of a kv head share the block, so each K/V tile is read from
//     device memory once per row tile (once per kv head in decode);
//   * the block reads its own page ids and walks only the pages below
//     min(lens, last row position + 1), in tiles of 32 keys; the TPU
//     version still DMAs the dead pages, this one never loads them;
//   * each tile is staged in shared memory as f32, int8 dequantized there
//     with its per-slot scale; m, l and acc stay in registers in f32;
//   * one warp per query row: lane i scores key i of the tile (K rows are
//     padded to D+1 floats so the 32 lanes hit 32 banks), then the lanes
//     split the D output columns for the P.V update.
// Known limits, left for later work: CUDA cores only (no mma/wgmma), no
// cp.async/TMA double buffering, and decode launches only B*Hkv blocks
// (64 at B=8, Hkv=8) on the card's 132 SMs; split-K over pages would fix
// that.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * kWarp;
constexpr int kKeyTile = 32;  // keys per shared-memory tile: one per lane
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };

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

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 on a launch the card accepted. Allocates nothing
// and does not synchronise; everything runs on `stream`.
int paged_attention_launch(const void* q, const void* k, const void* v,
                           const void* k_scales, const void* v_scales,
                           const void* tables, const void* lens,
                           const void* starts, void* out, int B, int Hkv,
                           int R, int D, int P, int ps, int W, int chunk,
                           float sm_scale, int q_dtype, int kv_dtype,
                           void* stream) {
  if (chunk < 1 || ps < 1 || W < 1 || R < 1) return cudaErrorInvalidValue;
  const float* ks = static_cast<const float*>(k_scales);
  const float* vs = static_cast<const float*>(v_scales);
  const int* t = static_cast<const int*>(tables);
  const int* sl = static_cast<const int*>(lens);
  const int* st = static_cast<const int*>(starts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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

const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
