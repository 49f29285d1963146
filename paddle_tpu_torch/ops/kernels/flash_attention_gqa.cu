// Grouped-query (GQA/MQA) and multi-head flash attention for Hopper
// (sm_90a), forward and backward, CUDA C++ with plain C entry points.
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/flash_attention_gqa.py:
//   forward  <- `_fwd_kernel`      (launched by `_gqa_fwd_impl`)
//   dq       <- `_bwd_dq_kernel`   (launched by `_fa_bwd`)
//   dk, dv   <- `_bwd_dkv_kernel`  (launched by `_fa_bwd`)
// and, at G = 1 (one query head per kv head), those of
// paddle_tpu/ops/pallas/flash_attention.py, whose K/V-resident
// (`_fwd_kernel`, `_bwd_dq_kernel`, `_bwd_dkv_kernel`) and K/V-streamed
// (`_fwd_kernel_stream`, `_bwd_dq_kernel_stream`, `_bwd_dkv_kernel_stream`)
// variants compute one function: the grouped kernels' at G = 1, with the
// same roundings. The streamed/resident split is a TPU VMEM matter; these
// kernels hold K/V tiles in shared memory at every length.
//
// The kernels themselves are flash_tiles.cuh's (the functions, roundings
// and design are described there), with the walk of causal or full
// attention: a block of queries at positions [p0, p0 + BQ) visits the key
// tiles from 0 up to its last live key, top-left causal (key <= query
// position), partial only where a tile straddles the diagonal; a block of
// keys visits the query tiles from the first that reaches it. The walk
// starts at key tile 0, which holds key 0 <= every row's position, so no
// row is ever empty.

#include "flash_tiles.cuh"

namespace {

struct CausalWalk {
  static constexpr bool kEmptyRows = false;
  int causal, Sq, Sk;
  int bq, keys;  // query positions and keys of the dtype's tiles

  __device__ int row_count(int, int p0, int BQ, int keys) const {
    return ((causal ? min(Sk, p0 + BQ) : Sk) + keys - 1) / keys;
  }
  // A tile is partial iff it straddles the diagonal: its last key lies
  // above its first query position (fully live iff k0 + keys - 1 <= p0).
  __device__ int row_tile(int qt, int i, bool& partial) const {
    partial = causal && (i + 1) * keys - 1 > qt * bq;
    return i;
  }
  __device__ int col_count(int, int k0, int BQ) const {
    const int n_q = Sq / BQ;
    return causal ? max(0, n_q - k0 / BQ) : n_q;
  }
  __device__ int col_tile(int, int k0, int BQ, int i, bool& partial) const {
    const int tile = (causal ? k0 / BQ : 0) + i;
    partial = causal && k0 + keys - 1 > tile * BQ;
    return tile;
  }
  __device__ bool dead(int pos, int key) const { return key > pos; }
};

// The walk for the tiles of `dtype`: (64, 64) bf16 and f16, (32, 32) f32,
// each holding group_tile(G, rows) heads.
CausalWalk causal_walk(int causal, int Sq, int Sk, int G, int dtype) {
  const int rows = dtype == kF32 ? BM : kRows;
  return CausalWalk{causal, Sq, Sk, rows / group_tile(G > 0 ? G : 1, rows),
                    dtype == kF32 ? BK : kKeys};
}

}  // namespace

extern "C" {

// Each returns a cudaError_t: 0 on a launch the card accepted. They
// allocate nothing and do not synchronise; everything runs on `stream`.
// dtype: 0 float32, 1 bfloat16, 2 float16; D: 64, 128 or 256; any G.

int gqa_fwd_launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, int B, int Hkv, int G, int Sq, int Sk, int D,
                   int causal, float scale_log2, int dtype, void* stream) {
  const Shape s{B, Hkv, G, Sq, Sk, scale_log2, 0.f};
  return fwd_any(D, dtype, q, k, v, out, lse, s,
                 causal_walk(causal, Sq, Sk, G, dtype),
                 static_cast<cudaStream_t>(stream));
}

int gqa_bwd_dq_launch(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int B, int Hkv, int G, int Sq, int Sk, int D,
                      int causal, float scale_log2, float sm_scale,
                      int dtype, void* stream) {
  const Shape s{B, Hkv, G, Sq, Sk, scale_log2, sm_scale};
  return dq_any(D, dtype, q, k, v, dout, lse, delta, dq, s,
                causal_walk(causal, Sq, Sk, G, dtype),
                static_cast<cudaStream_t>(stream));
}

int gqa_bwd_dkv_launch(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int B, int Hkv, int G, int Sq,
                       int Sk, int D, int causal, float scale_log2,
                       float sm_scale, int dtype, void* stream) {
  const Shape s{B, Hkv, G, Sq, Sk, scale_log2, sm_scale};
  return dkv_any(D, dtype, q, k, v, dout, lse, delta, dk, dv, s,
                 causal_walk(causal, Sq, Sk, G, dtype),
                 static_cast<cudaStream_t>(stream));
}

const char* flash_attention_gqa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
