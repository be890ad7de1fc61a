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
// 23 us at 3.35 TB/s. The design (the row path, NV > 0):
// - a row's C values are NV 16-byte vectors on each of `lanes` lanes
//   (lanes = C / (8 NV) in bf16: 16 lanes a row at C = 128, so a warp
//   takes 2 rows a pass; 32 lanes and 2 or 4 vectors at C = 512, 1024);
//   the sums reduce with xor shuffles inside each group of `lanes` lanes;
// - the row stays in registers between the statistics and the
//   normalisation (one read), the outputs go out as 16-byte stores;
// - each lane's columns are the same in every row, so scale and bias
//   are read once a thread into registers;
// - a warp keeps U rows a lane group in flight (U NV <= 6 vectors a
//   lane); the grid (`layernorm.ln_plan` on the host) gives each warp
//   one such step up to 16 waves of resident blocks, and a row loop
//   beyond (measured on the path's shapes: one step a warp beat a
//   one-wave grid walking 2-10 steps by 3-12 %).
// The generic path (NV = 0) takes a C that no row plan covers, a C that
// is not a whole number of 16-byte vectors and misaligned views: one warp
// a row, 16-byte or scalar loads, a second read of the row (from L1) to
// normalise and write.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// rows a lane group keeps in flight on the row path (measured: 2 rows
// at NV = 3 beat 1; more rows lost at NV = 1, 2, 4)
template <int NV> struct Unroll {
  static constexpr int value = NV == 1 ? 4 : NV == 4 ? 1 : 2;
};

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

// V outputs of type O from f32 as 16-byte stores (4 bf16: one 8-byte
// store), at a pointer aligned to min(16, V sizeof(O)) bytes
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

template <typename O, int V>
__device__ __forceinline__ void store_vec(O* dst, const float (&y)[V]) {
  if constexpr (sizeof(O) == 4) {
#pragma unroll
    for (int i = 0; i < V / 4; ++i)
      reinterpret_cast<uint4*>(dst)[i] = make_uint4(
          __float_as_uint(y[4 * i]), __float_as_uint(y[4 * i + 1]),
          __float_as_uint(y[4 * i + 2]), __float_as_uint(y[4 * i + 3]));
  } else if constexpr (V == 4) {
    *reinterpret_cast<uint2*>(dst) =
        make_uint2(pack_bf16(y[0], y[1]), pack_bf16(y[2], y[3]));
  } else {
#pragma unroll
    for (int i = 0; i < V / 8; ++i)
      reinterpret_cast<uint4*>(dst)[i] = make_uint4(
          pack_bf16(y[8 * i], y[8 * i + 1]),
          pack_bf16(y[8 * i + 2], y[8 * i + 3]),
          pack_bf16(y[8 * i + 4], y[8 * i + 5]),
          pack_bf16(y[8 * i + 6], y[8 * i + 7]));
  }
}

__device__ __forceinline__ void stats(float s, float ss, int C, float eps,
                                      float& mean, float& inv) {
  mean = __fdiv_rn(s, (float)C);
  const float var =
      fmaxf(__fsub_rn(__fdiv_rn(ss, (float)C), __fmul_rn(mean, mean)), 0.0f);
  inv = rsqrtf(__fadd_rn(var, eps));
}

// value e of a 16-byte vector of T (bf16 -> f32 is exact: the high half)
__device__ __forceinline__ unsigned word(const uint4& q, int j) {
  return j == 0 ? q.x : j == 1 ? q.y : j == 2 ? q.z : q.w;
}
template <typename T>
__device__ __forceinline__ float elem(const uint4& q, int e) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(word(q, e));
  } else {
    const unsigned w = word(q, e >> 1);
    return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
  }
}

// V f32 parameters from 16-byte loads
template <int V>
__device__ __forceinline__ void load_params(const float* p, float (&v)[V]) {
#pragma unroll
  for (int i = 0; i < V / 4; ++i) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p) + i);
    v[4 * i] = f.x;
    v[4 * i + 1] = f.y;
    v[4 * i + 2] = f.z;
    v[4 * i + 3] = f.w;
  }
}

// The row path: rows [base + i G + grp] for i < U, G = 32 / lanes row
// groups a warp; base walks the rows in steps of gridDim.x WARPS G U.
template <typename T, typename O, int NV>
__device__ __forceinline__ void ln_rows(const T* __restrict__ x,
                                        const float* __restrict__ scale,
                                        const float* __restrict__ bias,
                                        O* __restrict__ out, long long rows,
                                        int C, int lanes_log2, float eps) {
  constexpr int V = 16 / sizeof(T);
  constexpr int U = Unroll<NV>::value;
  const int lane = threadIdx.x & 31;
  const int sub = lane & ((1 << lanes_log2) - 1);
  const int grp = lane >> lanes_log2;
  const int G = 32 >> lanes_log2;
  const int half = (1 << lanes_log2) >> 1;   // first xor offset (lanes / 2)

  float w[NV][V], b[NV][V];     // this lane's columns, the same every row
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int c = ((k << lanes_log2) + sub) * V;
    load_params<V>(scale + c, w[k]);
    load_params<V>(bias + c, b[k]);
  }

  const long long step = (long long)G * U;
  const long long stride = (long long)gridDim.x * WARPS * step;
  for (long long base =
           ((long long)blockIdx.x * WARPS + (threadIdx.x >> 5)) * step;
       base < rows; base += stride) {
    uint4 u[U][NV];
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const long long r = base + i * G + grp;
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        u[i][k] = r < rows ? __ldg(reinterpret_cast<const uint4*>(
                                 x + r * C + ((k << lanes_log2) + sub) * V))
                           : make_uint4(0u, 0u, 0u, 0u);
      }
    }
#pragma unroll
    for (int i = 0; i < U; ++i) {
      float s = 0.0f, ss = 0.0f;
#pragma unroll
      for (int k = 0; k < NV; ++k) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float f = elem<T>(u[i][k], v);
          s = __fadd_rn(s, f);
          ss = __fadd_rn(ss, __fmul_rn(f, f));
        }
      }
      // all 32 lanes take part (rows past the end carry zeros)
      for (int o = half; o > 0; o >>= 1) {
        s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
        ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, o));
      }
      float mean, inv;
      stats(s, ss, C, eps, mean, inv);
      const long long r = base + i * G + grp;
      if (r < rows) {
#pragma unroll
        for (int k = 0; k < NV; ++k) {
          const int c = ((k << lanes_log2) + sub) * V;
          // the packed row again (registers), not a second read
          float y[V];
#pragma unroll
          for (int v = 0; v < V; ++v)
            y[v] = __fadd_rn(
                __fmul_rn(__fmul_rn(__fsub_rn(elem<T>(u[i][k], v), mean),
                                    inv),
                          w[k][v]),
                b[k][v]);
          store_vec<O, V>(out + r * C + c, y);
        }
      }
    }
  }
}

// V values of a row: one 16-byte load (V = 16 / sizeof(T)) or one scalar
template <typename T, int V> struct Chunk {
  alignas(16) T e[V];
  __device__ __forceinline__ void load(const T* p) {
    if constexpr (V * sizeof(T) == 16)
      *reinterpret_cast<uint4*>(e) = *reinterpret_cast<const uint4*>(p);
    else
      e[0] = *p;
  }
};

// The generic path: one warp a row, 16-byte loads where VEC, else scalar.
template <typename T, typename O, bool VEC>
__device__ __forceinline__ void ln_generic(const T* __restrict__ x,
                                           const float* __restrict__ scale,
                                           const float* __restrict__ bias,
                                           O* __restrict__ out,
                                           long long rows, int C, float eps) {
  constexpr int V = VEC ? 16 / sizeof(T) : 1;
  const int lane = threadIdx.x & 31;
  for (long long row = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
       row < rows; row += (long long)gridDim.x * WARPS) {
    const T* xr = x + row * C;
    O* yr = out + row * C;
    float s = 0.0f, ss = 0.0f;
    for (int c = lane * V; c < C; c += 32 * V) {
      Chunk<T, V> e;
      e.load(xr + c);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float f = to_f32<T>(e.e[v]);
        s = __fadd_rn(s, f);
        ss = __fadd_rn(ss, __fmul_rn(f, f));
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
      ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, o));
    }
    float mean, inv;
    stats(s, ss, C, eps, mean, inv);
    for (int c = lane * V; c < C; c += 32 * V) {
      Chunk<T, V> e;
      e.load(xr + c);
      float y[V];
#pragma unroll
      for (int v = 0; v < V; ++v)
        y[v] = __fadd_rn(
            __fmul_rn(__fmul_rn(__fsub_rn(to_f32<T>(e.e[v]), mean), inv),
                      scale[c + v]),
            bias[c + v]);
      if constexpr (VEC) {
        store_vec<O, V>(yr + c, y);
      } else {
        yr[c] = from_f32<O>(y[0]);
      }
    }
  }
}

// NV > 0: the row path with NV vectors a lane; NV = 0: the generic path
// (`vec` picks its 16-byte or scalar form).
template <typename T, typename O, int NV>
__global__ void __launch_bounds__(THREADS)
layer_norm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ bias, O* __restrict__ out,
                  long long rows, int C, int lanes_log2, int vec, float eps) {
  if (NV > 0) {
    ln_rows<T, O, (NV > 0 ? NV : 1)>(x, scale, bias, out, rows, C,
                                     lanes_log2, eps);
  } else if (vec) {
    ln_generic<T, O, true>(x, scale, bias, out, rows, C, eps);
  } else {
    ln_generic<T, O, false>(x, scale, bias, out, rows, C, eps);
  }
}

template <typename T, typename O>
using KernelFn = void (*)(const T*, const float*, const float*, O*,
                          long long, int, int, int, float);

template <typename T, typename O>
KernelFn<T, O> kernel_for(int nv) {
  switch (nv) {
    case 1: return layer_norm_kernel<T, O, 1>;
    case 2: return layer_norm_kernel<T, O, 2>;
    case 3: return layer_norm_kernel<T, O, 3>;
    case 4: return layer_norm_kernel<T, O, 4>;
    case 0: return layer_norm_kernel<T, O, 0>;
    default: return nullptr;
  }
}

// The host plan (`layernorm.ln_plan`) gives nv (0 = generic), lanes_log2,
// vec and the grid; every row is covered by the kernel's row loop.
template <typename T, typename O>
int launch(const void* x, const float* scale, const float* bias, void* out,
           long long rows, int C, float eps, int nv, int lanes_log2, int vec,
           long long blocks, cudaStream_t stream) {
  if (rows <= 0 || C <= 0) return (int)cudaSuccess;
  KernelFn<T, O> fn = kernel_for<T, O>(nv);
  if (fn == nullptr || blocks <= 0 || blocks > 0x7fffffffLL ||
      (nv > 0 && (lanes_log2 < 0 || lanes_log2 > 5)))
    return (int)cudaErrorInvalidValue;
  fn<<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(x), scale, bias, static_cast<O*>(out), rows, C,
      lanes_log2, vec, eps);
  return (int)cudaGetLastError();
}

template <typename T, typename O>
int blocks_per_sm(int nv) {
  KernelFn<T, O> fn = kernel_for<T, O>(nv);
  int per_sm = 0;
  if (fn == nullptr ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, THREADS,
                                                    0) != cudaSuccess)
    return -1;
  return per_sm;
}

}  // namespace

#define LN_ENTRY(NAME, T, O)                                                 \
  extern "C" int NAME(const void* x, const float* scale, const float* bias, \
                      void* out, long long rows, int C, float eps, int nv,   \
                      int lanes_log2, int vec, long long blocks,             \
                      void* stream) {                                        \
    return launch<T, O>(x, scale, bias, out, rows, C, eps, nv, lanes_log2,   \
                        vec, blocks, static_cast<cudaStream_t>(stream));     \
  }                                                                          \
  extern "C" int NAME##_blocks_per_sm(int nv) {                              \
    return blocks_per_sm<T, O>(nv);                                          \
  }

LN_ENTRY(layer_norm_f32_f32, float, float)
LN_ENTRY(layer_norm_f32_bf16, float, __nv_bfloat16)
LN_ENTRY(layer_norm_bf16_f32, __nv_bfloat16, float)
LN_ENTRY(layer_norm_bf16_bf16, __nv_bfloat16, __nv_bfloat16)
