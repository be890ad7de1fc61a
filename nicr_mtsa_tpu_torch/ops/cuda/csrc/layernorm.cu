// Single-pass LayerNorm over the last axis for Hopper (sm_90a).
//
// Replaces the TPU kernel nicr_mtsa_tpu/ops/pallas/layernorm.py
// (`fused_layer_norm` -> `_ln_kernel`): per row of C values, the f32 mean
// and the fast variance E[x^2] - E[x]^2 clamped at 0, y = (x - mean) *
// rsqrt(var + eps), the affine y * scale + bias in f32, one cast to the
// output type at the end. Any C (the patch embeds have 96 and 32), any
// eps (the decoders' skip LayerNorm uses flax's 1e-6).
//
// What bounds it on an H100: bytes. Each value is read once from device
// memory and written once; the work is a few f32 operations per value.
// At the Swin stage-1 shape (153600 x 128 bf16) that is 2 x 39.3 MB, about
// 23 us at 3.35 TB/s. The design gives each row to one warp: the lanes read
// 16 bytes each per step (8 bf16 or 4 f32 values) where the row allows it,
// sum x and x*x in registers, reduce with shuffles, then read the row again
// (from L1/L2: the warp just loaded it) to normalise and write. Eight rows
// per block of 256 threads.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS_PER_BLOCK = THREADS / 32;

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(
    __nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename O> __device__ __forceinline__ O from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, typename O, bool VEC>
__global__ void __launch_bounds__(THREADS)
layer_norm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ bias, O* __restrict__ out,
                  long long rows, int C, float eps) {
  constexpr int V = 16 / sizeof(T);       // values per 16-byte load
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + row * C;
  O* yr = out + row * C;

  float s = 0.0f, ss = 0.0f;
  if (VEC) {
    for (int c = lane * V; c < C; c += 32 * V) {
      const uint4 u = *reinterpret_cast<const uint4*>(xr + c);
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float f = to_f32<T>(e[v]);
        s = __fadd_rn(s, f);
        ss = __fadd_rn(ss, __fmul_rn(f, f));
      }
    }
  } else {
    for (int c = lane; c < C; c += 32) {
      const float f = to_f32<T>(xr[c]);
      s = __fadd_rn(s, f);
      ss = __fadd_rn(ss, __fmul_rn(f, f));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
    ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, o));
  }
  const float mean = __fdiv_rn(s, (float)C);
  const float var =
      fmaxf(__fsub_rn(__fdiv_rn(ss, (float)C), __fmul_rn(mean, mean)), 0.0f);
  const float inv = rsqrtf(__fadd_rn(var, eps));

  if (VEC) {
    for (int c = lane * V; c < C; c += 32 * V) {
      const uint4 u = *reinterpret_cast<const uint4*>(xr + c);
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float y = __fmul_rn(__fsub_rn(to_f32<T>(e[v]), mean), inv);
        yr[c + v] = from_f32<O>(
            __fadd_rn(__fmul_rn(y, scale[c + v]), bias[c + v]));
      }
    }
  } else {
    for (int c = lane; c < C; c += 32) {
      const float y = __fmul_rn(__fsub_rn(to_f32<T>(xr[c]), mean), inv);
      yr[c] = from_f32<O>(__fadd_rn(__fmul_rn(y, scale[c]), bias[c]));
    }
  }
}

template <typename T, typename O>
int launch(const void* x, const float* scale, const float* bias, void* out,
           long long rows, int C, float eps, cudaStream_t stream) {
  if (rows <= 0 || C <= 0) return (int)cudaSuccess;
  const long long blocks = (rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  const bool vec = (C * (int)sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (vec) {
    layer_norm_kernel<T, O, true><<<(unsigned)blocks, THREADS, 0, stream>>>(
        static_cast<const T*>(x), scale, bias, static_cast<O*>(out), rows, C,
        eps);
  } else {
    layer_norm_kernel<T, O, false><<<(unsigned)blocks, THREADS, 0, stream>>>(
        static_cast<const T*>(x), scale, bias, static_cast<O*>(out), rows, C,
        eps);
  }
  return (int)cudaGetLastError();
}

}  // namespace

#define LN_ENTRY(NAME, T, O)                                                 \
  extern "C" int NAME(const void* x, const float* scale, const float* bias, \
                      void* out, long long rows, int C, float eps,           \
                      void* stream) {                                        \
    return launch<T, O>(x, scale, bias, out, rows, C, eps,                   \
                        static_cast<cudaStream_t>(stream));                  \
  }

LN_ENTRY(layer_norm_f32_f32, float, float)
LN_ENTRY(layer_norm_f32_bf16, float, __nv_bfloat16)
LN_ENTRY(layer_norm_bf16_f32, __nv_bfloat16, float)
LN_ENTRY(layer_norm_bf16_bf16, __nv_bfloat16, __nv_bfloat16)
