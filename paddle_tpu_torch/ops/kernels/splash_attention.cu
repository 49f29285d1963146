// Block-sparse ("splash") flash attention for Hopper (sm_90a), forward and
// backward, CUDA C++ with plain C entry points.
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/splash_attention.py:
//   forward  <- `_fwd_kernel` / `_fwd_kernel_stream`      (`_splash_fwd`)
//   dq       <- `_bwd_dq_kernel` / `_bwd_dq_kernel_stream` (`_splash_bwd`)
//   dk, dv   <- `_bwd_dkv_kernel`                          (`_splash_bwd`)
// and computes their function: attention over q (B, Hkv*G, Sq, D) and
// k/v (B, Hkv, Sk, D) in which the pair (query position i, key j) is live
// iff
//   mask[i / bq][j / bk] && (!causal || i + q_offset >= j)
//                        && i + q_offset - j < window
// (window = INT_MAX for none), with the roundings of flash_tiles.cuh, whose
// kernels these are. A row with no live key gives out 0 and lse -1e30, and
// its gradients are 0 (its probabilities are exactly 0, never
// exp2(s - lse) with lse = -1e30).
//
// The walk: the host (paddle_tpu_torch/ops/splash_attention.py) turns the
// pattern into tables for the kernel's own tiles, once per pattern, kept on
// the card:
//   * forward and dq: for each query tile, the key tiles that hold a live
//     pair, in order;
//   * dk/dv: for each key tile, the query tiles that hold a live pair: the
//     column of the mask, transposed on the host, so a block of keys visits
//     only its live query tiles (the TPU kernel visits every query block
//     and skips the dead ones' compute behind a predicate);
// each entry is 2 * tile + partial, where partial says the tile also holds
// masked pairs. Only partial tiles ask dead() per element; a full tile
// runs as dense flash. Tiles need not match the mask's blocks: the mask is
// read per element, so blocks smaller or larger than a tile both work.
//
// What bounds it: operations, as for flash (4*D flops per live pair
// forward, 6*D and 8*D in dq and dk/dv): work scales with the live pairs,
// and at the Mistral band (S 8192, window 4096) about 3% of the visited
// tiles are partial.

#include "flash_tiles.cuh"

namespace {

struct SplashWalk {
  static constexpr bool kEmptyRows = true;  // a live tile may hold none of
                                            // a row's live keys
  const int* tiles;            // (n tiles, stride): 2 * tile + partial
  const int* counts;           // (n tiles,)
  int stride;
  const unsigned char* mask;   // (Sq / bq, Sk / bk) block mask
  int n_mask_k, bq, bk, causal, window, q_offset;

  __device__ int entry_count(int tile) const { return counts[tile]; }
  __device__ int entry(int tile, int i, bool& partial) const {
    const int e = tiles[(size_t)tile * stride + i];
    partial = e & 1;
    return e >> 1;
  }
  __device__ int row_count(int qt, int, int, int) const {
    return entry_count(qt);
  }
  __device__ int row_tile(int qt, int i, bool& partial) const {
    return entry(qt, i, partial);
  }
  __device__ int col_count(int kt, int, int) const { return entry_count(kt); }
  __device__ int col_tile(int kt, int, int, int i, bool& partial) const {
    return entry(kt, i, partial);
  }
  __device__ bool dead(int pos, int key) const {
    const int d = pos + q_offset - key;
    return !mask[(pos / bq) * n_mask_k + key / bk] || (causal && d < 0) ||
           d >= window;
  }
};

SplashWalk walk_of(const void* tiles, const void* counts, int stride,
                   const void* mask, int n_mask_k, int bq, int bk,
                   int causal, int window, int q_offset) {
  return SplashWalk{static_cast<const int*>(tiles),
                    static_cast<const int*>(counts),
                    stride,
                    static_cast<const unsigned char*>(mask),
                    n_mask_k, bq, bk, causal, window, q_offset};
}

}  // namespace

extern "C" {

// Each returns a cudaError_t: 0 on a launch the card accepted. They
// allocate nothing and do not synchronise; everything runs on `stream`.
// dtype: 0 float32, 1 bfloat16, 2 float16; D: 64, 128 or 256; any G.
// `tiles`/`counts`/`stride`
// are the walk for the kernel's tiles: per query tile for the forward and
// dq, per key tile for dk/dv. `mask` is uint8 (Sq / bq, Sk / bk).

int splash_fwd_launch(const void* q, const void* k, const void* v, void* out,
                      void* lse, const void* tiles, const void* counts,
                      int stride, const void* mask, int n_mask_k, int bq,
                      int bk, int B, int Hkv, int G, int Sq, int Sk, int D,
                      int causal, int window, int q_offset, float scale_log2,
                      int dtype, void* stream) {
  const Shape s{B, Hkv, G, Sq, Sk, scale_log2, 0.f};
  return fwd_any(D, dtype, q, k, v, out, lse, s,
                 walk_of(tiles, counts, stride, mask, n_mask_k, bq, bk,
                         causal, window, q_offset),
                 static_cast<cudaStream_t>(stream));
}

int splash_bwd_dq_launch(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse,
                         const void* delta, void* dq, const void* tiles,
                         const void* counts, int stride, const void* mask,
                         int n_mask_k, int bq, int bk, int B, int Hkv, int G,
                         int Sq, int Sk, int D, int causal, int window,
                         int q_offset, float scale_log2, float sm_scale,
                         int dtype, void* stream) {
  const Shape s{B, Hkv, G, Sq, Sk, scale_log2, sm_scale};
  return dq_any(D, dtype, q, k, v, dout, lse, delta, dq, s,
                walk_of(tiles, counts, stride, mask, n_mask_k, bq, bk,
                        causal, window, q_offset),
                static_cast<cudaStream_t>(stream));
}

int splash_bwd_dkv_launch(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse,
                          const void* delta, void* dk, void* dv,
                          const void* tiles, const void* counts, int stride,
                          const void* mask, int n_mask_k, int bq, int bk,
                          int B, int Hkv, int G, int Sq, int Sk, int D,
                          int causal, int window, int q_offset,
                          float scale_log2, float sm_scale, int dtype,
                          void* stream) {
  const Shape s{B, Hkv, G, Sq, Sk, scale_log2, sm_scale};
  return dkv_any(D, dtype, q, k, v, dout, lse, delta, dk, dv, s,
                 walk_of(tiles, counts, stride, mask, n_mask_k, bq, bk,
                         causal, window, q_offset),
                 static_cast<cudaStream_t>(stream));
}

const char* splash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
