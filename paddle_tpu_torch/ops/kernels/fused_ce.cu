// Fused softmax cross-entropy for Hopper (sm_90a), forward and backward,
// CUDA C++ with plain C entry points.
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/fused_ce.py:
//   ce_fwd_kernel <- `_ce_fwd_kernel` (launched by `_ce_fwd`)
//   ce_bwd_kernel <- `_ce_bwd_kernel` (launched by `_bwd`)
// and computes the same functions:
//
//   logits x (N, V) float or bfloat16, labels (N,) int64
//   forward:  lse = max(x) + log(sum(exp(x - max(x)))), per row, f32;
//             loss = lse - x[label], where a label outside [0, V) reads 0
//   backward: dx = (exp(x - lse) - onehot(label)) * g, rounded to x's type
// No (N, V) softmax is written: the forward reads the logits once.
//
// What bounds it: bytes. A row does a few operations per element against
// 2 or 4 bytes, and at Llama-3's vocabulary (V = 128256) a bfloat16 row is
// 250 KB, more than a block's shared memory. The design follows that:
//   * one block of 256 threads per row; each thread streams its share of
//     the row in 16-byte loads, keeping an online (max, sum of exp) pair
//     that it rescales once per 16-byte chunk, so no row is staged;
//   * the pairs are merged across the warp with shuffles and across warps
//     in shared memory; thread 0 reads the label's logit itself;
//   * the backward is one elementwise pass, 16-byte loads and stores.
// Rows whose length or address is not 16-byte aligned take scalar loads.
// A -inf logit (a masked entry) adds nothing to the sum: a thread that has
// seen only -inf keeps its empty pair (m = -inf, s = 0), as the reference's
// max over the whole row does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

// (m, s) <- the pair of the union of two sets, s = sum(exp(x - m)).
__device__ __forceinline__ void merge(float& m, float& s, float m2, float s2) {
  const float mx = fmaxf(m, m2);
  if (mx == -CUDART_INF_F) return;  // both empty
  s = s * expf(m - mx) + s2 * expf(m2 - mx);
  m = mx;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
ce_fwd_kernel(const T* __restrict__ x, const int64_t* __restrict__ labels,
              float* __restrict__ loss, float* __restrict__ lse, int V) {
  constexpr int W = 16 / sizeof(T);
  union Pack {
    uint4 u;
    T t[W];
  };
  const T* row = x + (size_t)blockIdx.x * V;
  float m = -CUDART_INF_F, s = 0.f;
  if constexpr (VEC) {
    for (int c = threadIdx.x * W; c < V; c += kThreads * W) {
      Pack p;
      p.u = *reinterpret_cast<const uint4*>(row + c);
      float f[W];
      float mx = m;
#pragma unroll
      for (int t = 0; t < W; ++t) {
        f[t] = to_f(p.t[t]);
        mx = fmaxf(mx, f[t]);
      }
      if (mx == -CUDART_INF_F) continue;  // nothing seen but -inf yet
      float add = 0.f;
#pragma unroll
      for (int t = 0; t < W; ++t) add += expf(f[t] - mx);
      s = s * expf(m - mx) + add;
      m = mx;
    }
  } else {
    for (int c = threadIdx.x; c < V; c += kThreads) {
      const float f = to_f(row[c]);
      const float mx = fmaxf(m, f);
      if (mx == -CUDART_INF_F) continue;  // nothing seen but -inf yet
      s = s * expf(m - mx) + expf(f - mx);
      m = mx;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(kFull, m, o);
    const float s2 = __shfl_xor_sync(kFull, s, o);
    merge(m, s, m2, s2);
  }
  __shared__ float ms[kWarps], ss[kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    ms[warp] = m;
    ss[warp] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    m = ms[0];
    s = ss[0];
    for (int w = 1; w < kWarps; ++w) merge(m, s, ms[w], ss[w]);
    const float l = m + logf(s);
    const int64_t lbl = labels[blockIdx.x];
    const float xl = (lbl >= 0 && lbl < V) ? to_f(row[lbl]) : 0.f;
    loss[blockIdx.x] = l - xl;
    lse[blockIdx.x] = l;
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
ce_bwd_kernel(const T* __restrict__ x, const int64_t* __restrict__ labels,
              const float* __restrict__ lse, const float* __restrict__ g,
              T* __restrict__ dx, int V) {
  constexpr int W = 16 / sizeof(T);
  union Pack {
    uint4 u;
    T t[W];
  };
  const size_t base = (size_t)blockIdx.x * V;
  const float l = lse[blockIdx.x], gr = g[blockIdx.x];
  const int64_t lbl = labels[blockIdx.x];
  if constexpr (VEC) {
    for (int c = threadIdx.x * W; c < V; c += kThreads * W) {
      Pack p;
      p.u = *reinterpret_cast<const uint4*>(x + base + c);
#pragma unroll
      for (int t = 0; t < W; ++t) {
        const float hot = (c + t == lbl) ? 1.f : 0.f;
        p.t[t] = from_f<T>((expf(to_f(p.t[t]) - l) - hot) * gr);
      }
      *reinterpret_cast<uint4*>(dx + base + c) = p.u;
    }
  } else {
    for (int c = threadIdx.x; c < V; c += kThreads) {
      const float hot = (c == lbl) ? 1.f : 0.f;
      dx[base + c] = from_f<T>((expf(to_f(x[base + c]) - l) - hot) * gr);
    }
  }
}

template <typename T>
bool vec_ok(int V, const void* a, const void* b) {
  return (V * sizeof(T)) % 16 == 0 && (uintptr_t)a % 16 == 0 &&
         (uintptr_t)b % 16 == 0;
}

template <typename T>
cudaError_t fwd(const void* x, const void* labels, void* loss, void* lse,
                int N, int V, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const int64_t* lb = static_cast<const int64_t*>(labels);
  float* lo = static_cast<float*>(loss);
  float* ls = static_cast<float*>(lse);
  if (vec_ok<T>(V, x, x))
    ce_fwd_kernel<T, true><<<N, kThreads, 0, stream>>>(xt, lb, lo, ls, V);
  else
    ce_fwd_kernel<T, false><<<N, kThreads, 0, stream>>>(xt, lb, lo, ls, V);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd(const void* x, const void* labels, const void* lse,
                const void* g, void* dx, int N, int V, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const int64_t* lb = static_cast<const int64_t*>(labels);
  const float* ls = static_cast<const float*>(lse);
  const float* gf = static_cast<const float*>(g);
  T* d = static_cast<T*>(dx);
  if (vec_ok<T>(V, x, dx))
    ce_bwd_kernel<T, true><<<N, kThreads, 0, stream>>>(xt, lb, ls, gf, d, V);
  else
    ce_bwd_kernel<T, false><<<N, kThreads, 0, stream>>>(xt, lb, ls, gf, d,
                                                        V);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns a cudaError_t: 0 on a launch the card accepted. They
// allocate nothing and do not synchronise; everything runs on `stream`.

int fused_ce_fwd_launch(const void* x, const void* labels, void* loss,
                        void* lse, int N, int V, int dtype, void* stream) {
  if (N < 1 || V < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return fwd<float>(x, labels, loss, lse, N, V, s);
    case kBF16: return fwd<__nv_bfloat16>(x, labels, loss, lse, N, V, s);
    default: return cudaErrorInvalidValue;
  }
}

int fused_ce_bwd_launch(const void* x, const void* labels, const void* lse,
                        const void* g, void* dx, int N, int V, int dtype,
                        void* stream) {
  if (N < 1 || V < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return bwd<float>(x, labels, lse, g, dx, N, V, s);
    case kBF16: return bwd<__nv_bfloat16>(x, labels, lse, g, dx, N, V, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* fused_ce_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
