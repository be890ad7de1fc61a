// Fused 4x semantic finisher for Hopper (sm_90a).
//
// Replaces the TPU kernel nicr_mtsa_tpu/ops/pallas/semantic_finisher4x.py
// (`upsample4x_argmax_score` -> `_finisher4x_call`): two learned-3x3-
// zeropad x2 depthwise upsamplings of the quarter-res semantic logits,
// then the first-index argmax over classes and the max-softmax score
// 1 / sum_c exp(l_c - max) at full resolution. Neither the 2x nor the
// 4x logits are ever written to device memory.
//
// Numerics (exactly those of `finisher4x_logits_exact`, which is the
// JAX package's `_finisher4x_logits_exact`):
//   stage 1, per phase: four taps multiplied and summed in f32 in (a, b)
//     order, rounded to T, plus the T-rounded bias in f32, the stage-2
//     zero ring applied AFTER the bias, rounded to T;
//   stage 2: the same, without the ring;
//   reduce: max, first index attaining it, then sum exp(l - max) in
//     class order and its reciprocal.
// The phase arithmetic (taps, rounding, bias) is zeropad_phase.cuh's,
// shared with the 2x finisher (finisher2x.cu).
//
// Layout: x is NCHW (B, C, H, W) as the torch head writes it; the fused
// 4x4 stage kernels arrive as (C, 16) f32 values already rounded to T,
// the biases as (C,) f32 already rounded to T. Outputs are (B, 4H, 4W)
// int32 idx and f32 score. Any B, H, W and C: ragged tiles are masked.
//
// What bounds it on an H100: per output pixel and class the kernel does
// about 12 f32 operations (stage-2 taps, bias, max, exp, sum) plus a
// quarter of the 8 stage-1 operations, against 8 output bytes per pixel
// and 2-4 input bytes per quarter-res logit; at the serving shape
// (8, 40, 120, 160) that is ~1.4 GFLOP against ~32 MB, so f32 operations
// bound it (~21 us at 67 TFLOP/s vs ~10 us for the bytes). The design
// keeps every intermediate on chip: one block owns one image and a
// 16 x 64 output tile, builds the stage-1 plane of one class at a time
// (10 x 34 values) in shared memory, and each thread evaluates stage 2
// for its 4 pixels. Two passes over the classes (max/argmax, then the
// exp sum) recompute the logits rather than hold 40 of them per pixel in
// registers; this simple form is the first, correct one.
#include <math.h>

#include "zeropad_phase.cuh"

namespace {

using namespace zeropad_phase;

constexpr int TILE_Y = 16;            // output rows per block
constexpr int TILE_X = 64;            // output cols per block
constexpr int THREADS = 256;
constexpr int PIX_PER_THREAD = TILE_Y * TILE_X / THREADS;   // 4
constexpr int INT_ROWS = TILE_Y / 2 + 2;                    // 10
constexpr int INT_COLS = TILE_X / 2 + 2;                    // 34

// one input value of the padded quarter-res plane xp (index i, j of
// the (H+2, W+2) padded plane): zero pad, or edge replication
template <typename T, bool EDGE>
__device__ __forceinline__ float xp_at(const T* plane, int i, int j,
                                       int H, int W) {
  int y = i - 1, x = j - 1;
  if (EDGE) {
    y = min(max(y, 0), H - 1);
    x = min(max(x, 0), W - 1);
  } else if (y < 0 || y >= H || x < 0 || x >= W) {
    return 0.0f;
  }
  return to_f32<T>(plane[(size_t)y * W + x]);
}

template <typename T, bool EDGE>
__global__ void __launch_bounds__(THREADS)
finisher4x_kernel(const T* __restrict__ x, const float* __restrict__ k1,
                  const float* __restrict__ b1,
                  const float* __restrict__ k2,
                  const float* __restrict__ b2, int* __restrict__ idx_out,
                  float* __restrict__ score_out, int C, int H, int W) {
  __shared__ float inter[INT_ROWS][INT_COLS];

  const int b = blockIdx.z;
  const int Y0 = blockIdx.y * TILE_Y;
  const int X0 = blockIdx.x * TILE_X;
  const int Q0 = Y0 / 2;              // first intermediate row of the tile
  const int S0 = X0 / 2;
  const int HO = 4 * H, WO = 4 * W;
  const int QMAX = 2 * H + 1, SMAX = 2 * W + 1;
  const int tid = threadIdx.x;

  // this thread's output pixels: one column, rows ty + 4k
  const int tx = tid % TILE_X;
  const int ty = tid / TILE_X;
  const int X = X0 + tx;

  float m[PIX_PER_THREAD];
  int arg[PIX_PER_THREAD];
  float s[PIX_PER_THREAD];
  for (int k = 0; k < PIX_PER_THREAD; ++k) {
    m[k] = -INFINITY;
    arg[k] = 0;
    s[k] = 0.0f;
  }

  for (int pass = 0; pass < 2; ++pass) {
    for (int c = 0; c < C; ++c) {
      const T* plane = x + ((size_t)b * C + c) * H * W;
      const float* kc1 = k1 + c * 16;
      const float* kc2 = k2 + c * 16;
      const float bias1 = b1[c];
      const float bias2 = b2[c];

      __syncthreads();               // previous class's plane is consumed
      for (int e = tid; e < INT_ROWS * INT_COLS; e += THREADS) {
        const int qi = e / INT_COLS, si = e % INT_COLS;
        const int q = Q0 + qi, sc = S0 + si;
        float v = 0.0f;
        if (q <= QMAX && sc <= SMAX) {
          // intermediate row q is phase py of stage-1 row r
          const int py = (q + 1) & 1, r = q >> 1;
          const int px = (sc + 1) & 1, t = sc >> 1;
          v = logit<T>(taps(kc1, py, px, [&](int a, int bb) {
                         return xp_at<T, EDGE>(plane, r + a, t + bb, H, W);
                       }), bias1);
          // the stage-2 zero ring, after the bias (0 rounds to 0)
          if (!EDGE && (q == 0 || q == QMAX || sc == 0 || sc == SMAX)) {
            v = 0.0f;
          }
        }
        inter[qi][si] = v;
      }
      __syncthreads();

      if (X < WO) {
        const int v0 = X >> 1, qx = X & 1;
        for (int k = 0; k < PIX_PER_THREAD; ++k) {
          const int Y = Y0 + ty + 4 * k;
          if (Y >= HO) break;
          const int u = Y >> 1, qy = Y & 1;
          const float l = logit<T>(taps(kc2, qy, qx, [&](int cc, int d) {
                                     return inter[u + qy + cc - Q0]
                                                 [v0 + qx + d - S0];
                                   }), bias2);
          if (pass == 0) {
            if (l > m[k]) {                 // strict: first index wins
              m[k] = l;
              arg[k] = c;
            }
          } else {
            s[k] = __fadd_rn(s[k], expf(__fsub_rn(l, m[k])));
          }
        }
      }
    }
  }

  if (X < WO) {
    for (int k = 0; k < PIX_PER_THREAD; ++k) {
      const int Y = Y0 + ty + 4 * k;
      if (Y >= HO) break;
      const size_t o = ((size_t)b * HO + Y) * WO + X;
      idx_out[o] = arg[k];
      score_out[o] = __fdiv_rn(1.0f, s[k]);
    }
  }
}

template <typename T>
int launch(const void* x, const float* k1, const float* b1, const float* k2,
           const float* b2, int* idx, float* score, int B, int C, int H,
           int W, int edge, cudaStream_t stream) {
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  dim3 grid((4 * W + TILE_X - 1) / TILE_X, (4 * H + TILE_Y - 1) / TILE_Y,
            B);
  if (edge) {
    finisher4x_kernel<T, true><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(x), k1, b1, k2, b2, idx, score, C, H, W);
  } else {
    finisher4x_kernel<T, false><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(x), k1, b1, k2, b2, idx, score, C, H, W);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int finisher4x_f32(const void* x, const float* k1,
                              const float* b1, const float* k2,
                              const float* b2, int* idx, float* score,
                              int B, int C, int H, int W, int edge,
                              void* stream) {
  return launch<float>(x, k1, b1, k2, b2, idx, score, B, C, H, W, edge,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int finisher4x_bf16(const void* x, const float* k1,
                               const float* b1, const float* k2,
                               const float* b2, int* idx, float* score,
                               int B, int C, int H, int W, int edge,
                               void* stream) {
  return launch<__nv_bfloat16>(x, k1, b1, k2, b2, idx, score, B, C, H, W,
                               edge, static_cast<cudaStream_t>(stream));
}
