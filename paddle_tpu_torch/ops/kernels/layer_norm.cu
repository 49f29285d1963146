// Row normalisations for Hopper (sm_90a): LayerNorm, RMSNorm and
// dropout + residual-add + LayerNorm, CUDA C++ with plain C entry points.
//
// Replaces the TPU kernels
//   paddle_tpu/ops/pallas/layer_norm.py  `_ln_kernel`  (`fused_layer_norm`)
//                                        `_rms_kernel` (`fused_rms_norm`)
//   paddle_tpu/ops/pallas/dropout_ln.py  `_kernel`     (`_pallas_forward`)
// and computes the same functions, row by row over x (N, H):
//
//   layer norm:  mu = mean(x), var = mean((x - mu)^2)   (two passes, f32)
//                y = (x - mu) * rsqrt(var + eps) * w + b
//   rms norm:    y = x * rsqrt(mean(x^2) + eps) * w
//   dropout-add-LN: u = f32(bits) / 2^32, the bits read as unsigned and
//                rounded to nearest; keep = u >= p; h = x * keep / (1 - p)
//                + res (dropout only when `drop`); y = layer norm of h
//
// in f32 whatever the storage type: x, res and out in float or bfloat16,
// w and b read as float or bfloat16 and multiplied in f32, the result
// cast once to x's type. The variance is never E[x^2] - mu^2, which
// cancels at small eps.
//
// What bounds it: bytes. A row does a few operations per element against
// 2 or 4 bytes each way (and 4 bytes of bits), far below the card's ratio
// of operations to bytes. The design reads every element from device
// memory once and writes it once:
//   * T threads per row (a multiple of 32), each keeping its share of the
//     row in registers (kCap f32 values), so the two reductions and the
//     output pass re-read registers, not memory; narrow rows (T < 128)
//     share a block of 128 threads, 128 / T rows to a block;
//   * 16-byte loads and stores where the row length and every pointer
//     allow them, scalar ones otherwise, so every H works;
//   * rows longer than 512 * kCap values (H > 16384 in float or bfloat16
//     with 16-byte loads) are re-read from L2 on each pass, 512 threads a
//     row, instead of kept in registers;
//   * the row sums go through warp shuffles and, across the warps of a
//     row, shared memory.
// The weight and bias are read per element; they stay in L1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCap = 32;        // f32 values of a row a thread keeps
constexpr int kBlock = 128;     // threads of a block of narrow rows
constexpr int kMaxThreads = 512;   // threads of a row, at most
constexpr unsigned kFull = 0xffffffffu;
constexpr float kTwoPowMinus32 = 2.3283064365386963e-10f;  // 2^-32, exact

enum DType { kF32 = 0, kBF16 = 1 };
enum Mode { kLN = 0, kRMS = 1, kDropLN = 2 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// W consecutive elements at p (16-byte aligned when W > 1) as f32.
template <int W>
__device__ __forceinline__ void load(const float* p, float (&f)[W]) {
  if constexpr (W == 1) {
    f[0] = *p;
  } else {
    static_assert(W == 4, "16 bytes of float");
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  }
}
template <int W>
__device__ __forceinline__ void load(const __nv_bfloat16* p, float (&f)[W]) {
  if constexpr (W == 1) {
    f[0] = __bfloat162float(*p);
  } else {
    static_assert(W == 8, "16 bytes of bfloat16");
    uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
}
template <int W>
__device__ __forceinline__ void load_bits(const uint32_t* p,
                                          uint32_t (&b)[W]) {
  if constexpr (W == 1) {
    b[0] = *p;
  } else {
#pragma unroll
    for (int j = 0; j < W / 4; ++j) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[j];
      b[4 * j] = u.x; b[4 * j + 1] = u.y; b[4 * j + 2] = u.z;
      b[4 * j + 3] = u.w;
    }
  }
}
template <int W>
__device__ __forceinline__ void store(float* p, const float (&f)[W]) {
  if constexpr (W == 1) {
    *p = f[0];
  } else {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
}
template <int W>
__device__ __forceinline__ void store(__nv_bfloat16* p, const float (&f)[W]) {
  if constexpr (W == 1) {
    *p = __float2bfloat16(f[0]);
  } else {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);  // nearest even
    *reinterpret_cast<uint4*>(p) = u;
  }
}

// The sum of v over the T threads of this thread's row, returned to each
// of them. Every thread of the block calls it (it synchronises the block
// when a row spans several warps); `red` holds a float per warp.
__device__ __forceinline__ float row_sum(float v, float* red, int T) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  if (T == 32) return v;
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  const int first = (threadIdx.x / T) * (T >> 5);
  float t = 0.f;
  for (int i = 0; i < (T >> 5); ++i) t += red[first + i];
  __syncthreads();  // `red` is free for the next sum
  return t;
}

// One row per T threads. W: elements per chunk (16 bytes, or 1 for the
// scalar path); NV: chunks a thread keeps in registers (0: re-read).
template <int MODE, typename T, typename Wt, int W, int NV>
__global__ void __launch_bounds__(kMaxThreads)
rows_kernel(const T* __restrict__ x, const T* __restrict__ res,
            const uint32_t* __restrict__ bits, const Wt* __restrict__ w,
            const Wt* __restrict__ b, T* __restrict__ out, int N, int H,
            int T_row, float eps, float p, float keep_div, int drop) {
  __shared__ float red[kMaxThreads / 32];
  const int rows_per_block = blockDim.x / T_row;
  const int row = blockIdx.x * rows_per_block + threadIdx.x / T_row;
  const int tid = threadIdx.x % T_row;
  const int nch = row < N ? H / W : 0;  // a row past N loads nothing
  const size_t base = (size_t)(row < N ? row : 0) * H;

  // the values the row's statistics are taken over, chunk k
  auto values = [&](int k, float (&f)[W]) {
    const size_t at = base + (size_t)k * W;
    load<W>(x + at, f);
    if constexpr (MODE == kDropLN) {
      float r[W];
      load<W>(res + at, r);
      if (drop) {
        uint32_t u[W];
        load_bits<W>(bits + at, u);
#pragma unroll
        for (int j = 0; j < W; ++j) {
          const float keep =
              __uint2float_rn(u[j]) * kTwoPowMinus32 >= p ? 1.f : 0.f;
          f[j] = f[j] * keep / keep_div;
        }
      }
#pragma unroll
      for (int j = 0; j < W; ++j) f[j] += r[j];
    }
  };
  auto emit = [&](int k, const float (&f)[W], float mu, float rs) {
    float y[W];
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const int c = k * W + j;
      if constexpr (MODE == kRMS) {
        y[j] = f[j] * rs * to_f(w[c]);
      } else {
        y[j] = (f[j] - mu) * rs * to_f(w[c]) + to_f(b[c]);
      }
    }
    store<W>(out + base + (size_t)k * W, y);
  };

  constexpr int kKeep = NV > 0 ? NV : 1;
  float cache[kKeep][W];

  // pass 1: the sum (of squares, for RMSNorm)
  float s = 0.f;
  if constexpr (NV > 0) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int k = tid + i * T_row;
      if (k < nch) {
        values(k, cache[i]);
#pragma unroll
        for (int j = 0; j < W; ++j)
          s += MODE == kRMS ? cache[i][j] * cache[i][j] : cache[i][j];
      }
    }
  } else {
    for (int k = tid; k < nch; k += T_row) {
      float f[W];
      values(k, f);
#pragma unroll
      for (int j = 0; j < W; ++j) s += MODE == kRMS ? f[j] * f[j] : f[j];
    }
  }
  const float m1 = row_sum(s, red, T_row) / (float)H;

  float mu = 0.f, rs;
  if constexpr (MODE == kRMS) {
    rs = rsqrtf(m1 + eps);
  } else {
    // pass 2: the sum of squared deviations from the mean
    mu = m1;
    float q = 0.f;
    if constexpr (NV > 0) {
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int k = tid + i * T_row;
        if (k < nch) {
#pragma unroll
          for (int j = 0; j < W; ++j) {
            const float d = cache[i][j] - mu;
            q += d * d;
          }
        }
      }
    } else {
      for (int k = tid; k < nch; k += T_row) {
        float f[W];
        values(k, f);
#pragma unroll
        for (int j = 0; j < W; ++j) {
          const float d = f[j] - mu;
          q += d * d;
        }
      }
    }
    rs = rsqrtf(row_sum(q, red, T_row) / (float)H + eps);
  }

  // pass 3: normalise, scale, shift, store
  if constexpr (NV > 0) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int k = tid + i * T_row;
      if (k < nch) emit(k, cache[i], mu, rs);
    }
  } else {
    for (int k = tid; k < nch; k += T_row) {
      float f[W];
      values(k, f);
      emit(k, f, mu, rs);
    }
  }
}

template <int MODE, typename T, typename Wt, int W>
cudaError_t launch_w(const void* x, const void* res, const void* bits,
                     const void* w, const void* b, void* out, int N, int H,
                     float eps, float p, float keep_div, int drop,
                     cudaStream_t stream) {
  constexpr int NV = kCap / W;
  const int nch = H / W;
  int threads = ((nch + NV - 1) / NV + 31) / 32 * 32;
  const bool keep_in_registers = threads <= kMaxThreads;
  if (!keep_in_registers) threads = kMaxThreads;
  const int rows_per_block = threads < kBlock ? kBlock / threads : 1;
  const int grid = (N + rows_per_block - 1) / rows_per_block;
  const T* xt = static_cast<const T*>(x);
  const T* rt = static_cast<const T*>(res);
  const uint32_t* bt = static_cast<const uint32_t*>(bits);
  const Wt* wt = static_cast<const Wt*>(w);
  const Wt* btt = static_cast<const Wt*>(b);
  T* ot = static_cast<T*>(out);
  if (keep_in_registers)
    rows_kernel<MODE, T, Wt, W, NV>
        <<<grid, threads * rows_per_block, 0, stream>>>(
            xt, rt, bt, wt, btt, ot, N, H, threads, eps, p, keep_div, drop);
  else
    rows_kernel<MODE, T, Wt, W, 0><<<grid, threads, 0, stream>>>(
        xt, rt, bt, wt, btt, ot, N, H, threads, eps, p, keep_div, drop);
  return cudaGetLastError();
}

bool aligned(const void* ptr) { return (uintptr_t)ptr % 16 == 0; }

template <int MODE, typename T, typename Wt>
cudaError_t launch_t(const void* x, const void* res, const void* bits,
                     const void* w, const void* b, void* out, int N, int H,
                     float eps, float p, float keep_div, int drop,
                     cudaStream_t stream) {
  constexpr int W = 16 / sizeof(T);
  bool vec = H % W == 0 && aligned(x) && aligned(out);
  if (MODE == kDropLN) vec = vec && aligned(res) && (!drop || aligned(bits));
  if (vec)
    return launch_w<MODE, T, Wt, W>(x, res, bits, w, b, out, N, H, eps, p,
                                    keep_div, drop, stream);
  return launch_w<MODE, T, Wt, 1>(x, res, bits, w, b, out, N, H, eps, p,
                                  keep_div, drop, stream);
}

template <int MODE>
int launch(const void* x, const void* res, const void* bits, const void* w,
           const void* b, void* out, int N, int H, float eps, float p,
           float keep_div, int drop, int dtype, int wdtype, void* stream) {
  if (N < 1 || H < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using BF = __nv_bfloat16;
  const int code = dtype * 2 + wdtype;
  if (dtype < 0 || dtype > 1 || wdtype < 0 || wdtype > 1)
    return cudaErrorInvalidValue;
  switch (code) {
    case kF32 * 2 + kF32:
      return launch_t<MODE, float, float>(x, res, bits, w, b, out, N, H, eps,
                                          p, keep_div, drop, s);
    case kF32 * 2 + kBF16:
      return launch_t<MODE, float, BF>(x, res, bits, w, b, out, N, H, eps, p,
                                       keep_div, drop, s);
    case kBF16 * 2 + kF32:
      return launch_t<MODE, BF, float>(x, res, bits, w, b, out, N, H, eps, p,
                                       keep_div, drop, s);
    default:
      return launch_t<MODE, BF, BF>(x, res, bits, w, b, out, N, H, eps, p,
                                    keep_div, drop, s);
  }
}

}  // namespace

extern "C" {

// Each returns a cudaError_t: 0 on a launch the card accepted. They
// allocate nothing and do not synchronise; everything runs on `stream`.
// dtype is x's (and res's and out's) type, wdtype the weight's and the
// bias's: 0 float, 1 bfloat16.

int layer_norm_launch(const void* x, const void* w, const void* b, void* out,
                      int N, int H, float eps, int dtype, int wdtype,
                      void* stream) {
  return launch<kLN>(x, nullptr, nullptr, w, b, out, N, H, eps, 0.f, 1.f, 0,
                     dtype, wdtype, stream);
}

int rms_norm_launch(const void* x, const void* w, void* out, int N, int H,
                    float eps, int dtype, int wdtype, void* stream) {
  return launch<kRMS>(x, nullptr, nullptr, w, nullptr, out, N, H, eps, 0.f,
                      1.f, 0, dtype, wdtype, stream);
}

// keep_div is 1 - p rounded to float, as the reference divides by it;
// drop = 0 skips the dropout (eval, or p = 0) and reads no bits.
int dropout_add_ln_launch(const void* x, const void* res, const void* bits,
                          const void* w, const void* b, void* out, int N,
                          int H, float p, float keep_div, float eps, int drop,
                          int dtype, int wdtype, void* stream) {
  return launch<kDropLN>(x, res, bits, w, b, out, N, H, eps, p, keep_div,
                         drop, dtype, wdtype, stream);
}

const char* layer_norm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
