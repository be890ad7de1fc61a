// Fused 2x semantic finisher for Hopper (sm_90a).
//
// Replaces the TPU kernel nicr_mtsa_tpu/ops/pallas/semantic_finisher.py
// (`upsample2x_argmax_score` -> `_finisher_call`): one learned-3x3-
// zeropad x2 depthwise upsampling of the half-res semantic logits, as
// four output phases of 2x2 taps, then the first-index argmax over the
// classes and the max-softmax score 1 / sum_c exp(l_c - max) at full
// resolution. The (B, C, 2H, 2W) logits are never written to memory.
//
// Numerics (exactly those of `zeropad2x_logits_exact`, the JAX
// package's `_zeropad_2x_phases_exact`, and of the TPU kernel's `phase`):
// per phase the four taps of the fused kernel (values rounded to T) times
// the zero-padded input, summed in f32 in (a, b) order, rounded to T,
// plus the T-rounded bias in f32, rounded to T (zeropad_phase.cuh, the
// same arithmetic as stage 2 of finisher4x.cu); then the max, the first
// class attaining it (strict >), and sum exp(l - max) in class order and
// its reciprocal.
//
// Layout: x is (B, C, H, W) with any strides, read where it lies: on the
// card the model is channels-last, so the head's logits are NHWC in
// memory and a contiguous copy would cost a pass over them. The fused 4x4
// kernel arrives as (C, 16) f32 values rounded to T, the bias as (C,) f32
// rounded to T. Outputs are (B, 2H, 2W) int32 idx and f32 score. Any B,
// H, W and C: the TPU kernel's shape gates and batch-minor layout are not
// carried over, ragged tiles are masked.
//
// What bounds it on an H100: bytes, nearly evenly with operations. At
// the serving shape (8, 40, 240, 320) bf16 the logits are 49 MB and the
// outputs 20 MB (~0.021 ms at 3.35 TB/s); per output value the kernel
// does ~14 f32 operations (4 taps, 2 roundings and the bias, compare,
// subtract, exp, add), ~1.4 GFLOP (~0.021 ms at 67 TFLOP/s).
//
// Design: one block of 256 threads owns one image and a 16 x 64 output
// tile, which reads a 10 x 34 window of the input. The classes go in
// chunks of 16: a chunk's window is staged in shared memory as f32 (the
// loads walk the classes fastest when they are the contiguous axis, the
// columns fastest otherwise), and each thread evaluates the four phases'
// logits of its 4 pixels. Two passes over the classes (max/argmax, then
// the exp sum) recompute the logits rather than hold C of them per pixel;
// the second pass rereads the input, mostly from L2. This simple form is
// the first, correct one.
#include <math.h>

#include "zeropad_phase.cuh"

namespace {

using namespace zeropad_phase;

constexpr int TILE_Y = 16;            // output rows per block
constexpr int TILE_X = 64;            // output cols per block
constexpr int THREADS = 256;
constexpr int PIX_PER_THREAD = TILE_Y * TILE_X / THREADS;   // 4
constexpr int IN_ROWS = TILE_Y / 2 + 2;                     // 10
constexpr int IN_COLS = TILE_X / 2 + 2;                     // 34
constexpr int CC = 16;                // classes per staged chunk
constexpr int TILE = IN_ROWS * IN_COLS;

template <typename T>
__global__ void __launch_bounds__(THREADS)
finisher2x_kernel(const T* __restrict__ x, const float* __restrict__ k,
                  const float* __restrict__ bias, int* __restrict__ idx_out,
                  float* __restrict__ score_out, int C, int H, int W,
                  long long sb, long long sc, long long sh, long long sw) {
  __shared__ float xs[CC][IN_ROWS][IN_COLS];

  const int b = blockIdx.z;
  const int Y0 = blockIdx.y * TILE_Y;
  const int X0 = blockIdx.x * TILE_X;
  const int I0 = Y0 / 2, J0 = X0 / 2;   // first padded row / col of the tile
  const int HO = 2 * H, WO = 2 * W;
  const int tid = threadIdx.x;
  const bool classes_fastest = sc < sw;
  const T* xb = x + (long long)b * sb;

  // this thread's output pixels: one column, rows ty + 4k
  const int tx = tid % TILE_X;
  const int ty = tid / TILE_X;
  const int X = X0 + tx;
  const int jj = (X >> 1) - J0, px = X & 1;

  float m[PIX_PER_THREAD];
  int arg[PIX_PER_THREAD];
  float s[PIX_PER_THREAD];
  for (int p = 0; p < PIX_PER_THREAD; ++p) {
    m[p] = -INFINITY;
    arg[p] = 0;
    s[p] = 0.0f;
  }

  for (int pass = 0; pass < 2; ++pass) {
    for (int c0 = 0; c0 < C; c0 += CC) {
      const int nc = min(CC, C - c0);
      __syncthreads();               // the previous chunk is consumed
      for (int e = tid; e < CC * TILE; e += THREADS) {
        int ci, r, q;
        if (classes_fastest) {
          ci = e % CC;
          r = e / CC / IN_COLS;
          q = e / CC % IN_COLS;
        } else {
          ci = e / TILE;
          r = e % TILE / IN_COLS;
          q = e % IN_COLS;
        }
        // padded (row, col) (I0 + r, J0 + q) is input (I0 + r - 1, ...)
        const int y = I0 + r - 1, xx = J0 + q - 1;
        float v = 0.0f;
        if (ci < nc && y >= 0 && y < H && xx >= 0 && xx < W)
          v = to_f32<T>(xb[(long long)(c0 + ci) * sc + (long long)y * sh +
                           (long long)xx * sw]);
        xs[ci][r][q] = v;
      }
      __syncthreads();

      if (X < WO) {
        for (int ci = 0; ci < nc; ++ci) {
          const int c = c0 + ci;
          const float* kc = k + c * 16;
          const float bc = bias[c];
          for (int p = 0; p < PIX_PER_THREAD; ++p) {
            const int Y = Y0 + ty + 4 * p;
            if (Y >= HO) break;
            const int ii = (Y >> 1) - I0, py = Y & 1;
            const float l = logit<T>(taps(kc, py, px, [&](int a, int bb) {
                                       return xs[ci][ii + a + py]
                                                [jj + bb + px];
                                     }), bc);
            if (pass == 0) {
              if (l > m[p]) {               // strict: first index wins
                m[p] = l;
                arg[p] = c;
              }
            } else {
              s[p] = __fadd_rn(s[p], expf(__fsub_rn(l, m[p])));
            }
          }
        }
      }
    }
  }

  if (X < WO) {
    for (int p = 0; p < PIX_PER_THREAD; ++p) {
      const int Y = Y0 + ty + 4 * p;
      if (Y >= HO) break;
      const size_t o = ((size_t)b * HO + Y) * WO + X;
      idx_out[o] = arg[p];
      score_out[o] = __fdiv_rn(1.0f, s[p]);
    }
  }
}

template <typename T>
int launch(const void* x, const float* k, const float* bias, int* idx,
           float* score, int B, int C, int H, int W, long long sb,
           long long sc, long long sh, long long sw, void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  dim3 grid((2 * W + TILE_X - 1) / TILE_X, (2 * H + TILE_Y - 1) / TILE_Y, B);
  finisher2x_kernel<T><<<grid, THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), k, bias, idx, score, C, H, W, sb, sc, sh, sw);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int finisher2x_f32(const void* x, const float* k,
                              const float* bias, int* idx, float* score,
                              int B, int C, int H, int W, long long sb,
                              long long sc, long long sh, long long sw,
                              void* stream) {
  return launch<float>(x, k, bias, idx, score, B, C, H, W, sb, sc, sh, sw,
                       stream);
}

extern "C" int finisher2x_bf16(const void* x, const float* k,
                               const float* bias, int* idx, float* score,
                               int B, int C, int H, int W, long long sb,
                               long long sc, long long sh, long long sw,
                               void* stream) {
  return launch<__nv_bfloat16>(x, k, bias, idx, score, B, C, H, W, sb, sc, sh,
                               sw, stream);
}
