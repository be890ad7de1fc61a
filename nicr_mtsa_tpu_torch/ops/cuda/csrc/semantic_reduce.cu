// First argmax and max-softmax score over the class axis, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel nicr_mtsa_tpu/ops/pallas/semantic_reduce.py
// (`semantic_score_idx_pallas`): for class logits (B, C, H, W) it writes
// idx = the FIRST class attaining the maximum (int32) and
// score = 1 / sum_c exp(l_c - max) (f32), both (B, H, W), in one pass
// over the logits; no softmax tensor is written.
//
// Any strides: the pipeline makes the model channels-last on the card,
// so the head's logits are NHWC in memory; the kernel reads them where
// they lie instead of paying for a contiguous copy.
//
// What bounds it on an H100: the logits are read once (2 bytes a value
// in bf16) against ~4 operations a value, so bytes bound it; at the
// eval shape (8, 40, 480, 640) bf16 ~196.6 MB read + 19.7 MB written,
// ~0.065 ms at 3.35 TB/s. The design: one thread per pixel, two passes
// over its C logits (max/argmax, then the exp sum: the second pass
// hits L1), strict `>` keeps the first maximum, every f32 step an
// explicit round-to-nearest intrinsic. Built with -fmad=false.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
score_idx_kernel(const T* __restrict__ x, int C, int H, int W,
                 long long sb, long long sc, long long sh, long long sw,
                 int* __restrict__ idx, float* __restrict__ score,
                 long long n_px) {
  const long long p = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (p >= n_px) return;
  const int w = (int)(p % W);
  const long long t = p / W;
  const int h = (int)(t % H);
  const long long b = t / H;
  const T* px = x + b * sb + (long long)h * sh + (long long)w * sw;

  float m = to_f32(px[0]);
  int arg = 0;
  for (int c = 1; c < C; ++c) {
    const float v = to_f32(px[c * sc]);
    if (v > m) {
      m = v;
      arg = c;
    }
  }
  float s = 0.0f;
  for (int c = 0; c < C; ++c) {
    s = __fadd_rn(s, expf(__fsub_rn(to_f32(px[c * sc]), m)));
  }
  idx[p] = arg;
  score[p] = __fdiv_rn(1.0f, s);
}

template <typename T>
int launch(const void* x, int* idx, float* score, int B, int C, int H,
           int W, long long sb, long long sc, long long sh, long long sw,
           void* stream) {
  const long long n_px = (long long)B * H * W;
  if (n_px <= 0 || C <= 0) return (int)cudaSuccess;
  const long long blocks = (n_px + THREADS - 1) / THREADS;
  score_idx_kernel<T><<<(unsigned)blocks, THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), C, H, W, sb, sc, sh, sw, idx, score, n_px);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int semantic_score_idx_f32(const void* x, int* idx, float* score,
                                      int B, int C, int H, int W,
                                      long long sb, long long sc,
                                      long long sh, long long sw,
                                      void* stream) {
  return launch<float>(x, idx, score, B, C, H, W, sb, sc, sh, sw, stream);
}

extern "C" int semantic_score_idx_bf16(const void* x, int* idx,
                                       float* score, int B, int C, int H,
                                       int W, long long sb, long long sc,
                                       long long sh, long long sw,
                                       void* stream) {
  return launch<__nv_bfloat16>(x, idx, score, B, C, H, W, sb, sc, sh, sw,
                               stream);
}
