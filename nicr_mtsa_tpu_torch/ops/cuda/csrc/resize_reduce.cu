// Crop + half-pixel bilinear resize + first argmax / max-softmax score,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel nicr_mtsa_tpu/ops/pallas/resize_reduce.py
// (`crop_resize_argmax_score`): working-resolution class logits
// (B, C, H, W) are cropped to the valid region [y0, y0 + in_h) x
// [x0, x0 + in_w), resized to (OH, OW) with 2-tap half-pixel bilinear
// interpolation (torch align_corners=False, taps clamped at the edges),
// and reduced over the classes to idx (first argmax, int32) and score
// = 1 / sum_c exp(l_c - max) (f32). The resized logits never exist in
// device memory.
//
// Numerics, pinned to the JAX package's CPU result: each value is cast
// to f32, the rows are interpolated first, then the columns, each lerp
// as fl(fl(a * w0) + fl(b * w1)) with w0 = f32(1 - f) formed in double
// on the host and w1 = f (no FMA: XLA does not contract this form on
// the CPU, measured against resize_bilinear); a weight w1 of 0 takes
// the first tap as it is. The argmax is then bit-identical to the plain
// version's and to the JAX package's. The tap tables (clamped lo/hi
// taps and both weights per output row and column) come from the host.
//
// What bounds it on an H100: bytes. At the eval shape (8, 40, 480,
// 640) bf16 -> (512, 512): 196.6 MB read once + 16.8 MB written, ~0.064
// ms at 3.35 TB/s, against ~20 f32 operations per output value (1.7
// GFLOP with both passes, ~0.025 ms at 67 TFLOP/s). The design: one
// thread per output pixel; two passes over the classes (max/argmax,
// then the exp sum) that recompute the 4-tap value from the input, which
// stays in L1/L2 between them; strict `>` keeps the first maximum.
// Built with -fmad=false and written with round-to-nearest intrinsics.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float lerp(float a, float b, float w0, float w1) {
  return __fadd_rn(__fmul_rn(a, w0), __fmul_rn(b, w1));
}

template <typename T>
struct Taps {
  const T* p00;   // (lo row, lo col) of class 0
  long long dr;   // hi row - lo row, in elements
  long long dc;   // hi col - lo col, in elements
  long long sc;   // class stride
  float h0, h1, w0, w1;

  __device__ __forceinline__ float value(int c) const {
    const T* p = p00 + c * sc;
    const float a = to_f32(p[0]);
    const float left = h1 != 0.0f ? lerp(a, to_f32(p[dr]), h0, h1) : a;
    if (w1 == 0.0f) return left;
    const float b = to_f32(p[dc]);
    const float right = h1 != 0.0f ? lerp(b, to_f32(p[dr + dc]), h0, h1)
                                   : b;
    return lerp(left, right, w0, w1);
  }
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
resize_reduce_kernel(const T* __restrict__ x, int C, long long sb,
                     long long sc, long long sh, long long sw, int y0,
                     int x0, const int* __restrict__ lo_h,
                     const int* __restrict__ hi_h,
                     const float* __restrict__ w0_h,
                     const float* __restrict__ w1_h,
                     const int* __restrict__ lo_w,
                     const int* __restrict__ hi_w,
                     const float* __restrict__ w0_w,
                     const float* __restrict__ w1_w, int OH, int OW,
                     int* __restrict__ idx, float* __restrict__ score,
                     long long n_px) {
  const long long p = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (p >= n_px) return;
  const int ox = (int)(p % OW);
  const long long t = p / OW;
  const int oy = (int)(t % OH);
  const long long b = t / OH;

  const long long r0 = (long long)(y0 + lo_h[oy]) * sh;
  const long long r1 = (long long)(y0 + hi_h[oy]) * sh;
  const long long c0 = (long long)(x0 + lo_w[ox]) * sw;
  const long long c1 = (long long)(x0 + hi_w[ox]) * sw;
  Taps<T> tp;
  tp.p00 = x + b * sb + r0 + c0;
  tp.dr = r1 - r0;
  tp.dc = c1 - c0;
  tp.sc = sc;
  tp.h0 = w0_h[oy];
  tp.h1 = w1_h[oy];
  tp.w0 = w0_w[ox];
  tp.w1 = w1_w[ox];

  float m = tp.value(0);
  int arg = 0;
  for (int c = 1; c < C; ++c) {
    const float v = tp.value(c);
    if (v > m) {
      m = v;
      arg = c;
    }
  }
  float s = 0.0f;
  for (int c = 0; c < C; ++c) {
    s = __fadd_rn(s, expf(__fsub_rn(tp.value(c), m)));
  }
  idx[p] = arg;
  score[p] = __fdiv_rn(1.0f, s);
}

template <typename T>
int launch(const void* x, const int* lo_h, const int* hi_h,
           const float* w0_h, const float* w1_h, const int* lo_w,
           const int* hi_w, const float* w0_w, const float* w1_w, int* idx,
           float* score, int B, int C, int OH, int OW, int y0, int x0,
           long long sb, long long sc, long long sh, long long sw,
           void* stream) {
  const long long n_px = (long long)B * OH * OW;
  if (n_px <= 0 || C <= 0) return (int)cudaSuccess;
  const long long blocks = (n_px + THREADS - 1) / THREADS;
  resize_reduce_kernel<T><<<(unsigned)blocks, THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), C, sb, sc, sh, sw, y0, x0, lo_h, hi_h, w0_h,
      w1_h, lo_w, hi_w, w0_w, w1_w, OH, OW, idx, score, n_px);
  return (int)cudaGetLastError();
}

}  // namespace

#define RESIZE_REDUCE_ENTRY(NAME, T)                                        \
  extern "C" int NAME(const void* x, const int* lo_h, const int* hi_h,      \
                      const float* w0_h, const float* w1_h,                 \
                      const int* lo_w, const int* hi_w, const float* w0_w,  \
                      const float* w1_w, int* idx, float* score, int B,     \
                      int C, int OH, int OW, int y0, int x0, long long sb,  \
                      long long sc, long long sh, long long sw,             \
                      void* stream) {                                       \
    return launch<T>(x, lo_h, hi_h, w0_h, w1_h, lo_w, hi_w, w0_w, w1_w,     \
                     idx, score, B, C, OH, OW, y0, x0, sb, sc, sh, sw,      \
                     stream);                                               \
  }

RESIZE_REDUCE_ENTRY(resize_reduce_f32, float)
RESIZE_REDUCE_ENTRY(resize_reduce_bf16, __nv_bfloat16)
