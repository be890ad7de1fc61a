// Per-(window, head) tiles of the window-attention kernels for Hopper
// (sm_90a): shared by window_attention_core.cu (the training forward and
// backward) and window_attention_qkv.cu (serving over the packed qkv).
//
// A block of THREADS threads owns one head (32 columns) of one window of
// N <= 64 tokens. Its tiles live in shared memory as [64][ld] arrays,
// rows >= N zero; products accumulate in f32 (the tensor cores through
// wmma for bf16, fmaf chains on the CUDA cores for f32). The shift mask
// is never read: each token's shift region comes from the window's
// position on the padded image's window grid (windows in image-major,
// then row-major grid order) and the token's coordinates, the rule of
// `shift_region_ids` (per axis, positions below n - ws are region 0,
// below n - shift region 1, the rest region 2; an axis with no shift is
// all region 2), and -100 is added between different regions.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>
#include <type_traits>

namespace window_tiles {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int NMAX = 64;                  // tokens per window, at most
constexpr int D = 32;                     // head width
constexpr int HLD = D + 8;                // q, k, v, dO tiles   [64][40]
constexpr int S_LD = NMAX + 4;            // f32 logits, dP      [64][68]
constexpr int P_LD = NMAX + 8;            // P, dS in T          [64][72]
constexpr int O_LD = D + 4;               // f32 product staging [64][36]

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// shift region of one coordinate of the padded image (see the header)
__device__ __forceinline__ int axis_region(int pos, int n, int ws,
                                           int shift) {
  if (shift == 0) return 2;
  return pos < n - ws ? 0 : (pos < n - shift ? 1 : 2);
}

__device__ __forceinline__ void window_regions(int* region, int g, int N,
                                               int ws, int nWh, int nWw,
                                               int shift_h, int shift_w) {
  const int t = threadIdx.x;
  if (t < N) {
    const int loc = g % (nWh * nWw);
    const int y = (loc / nWw) * ws + t / ws;
    const int x = (loc % nWw) * ws + t % ws;
    region[t] = axis_region(y, nWh * ws, ws, shift_h) * 3 +
                axis_region(x, nWw * ws, ws, shift_w);
  }
}

// columns col .. col + 31 of window g's N rows of a (Bw, N, ld) tensor
// into a [64][HLD] shared tile, rows >= N zero; 16-byte loads (col and
// ld multiples of 8 elements, the tensor 16-byte aligned)
template <typename E>
__device__ __forceinline__ void load_tile(E* dst, const E* __restrict__ src,
                                          int g, int N, int ld, int col) {
  constexpr int PER = 16 / sizeof(E);     // elements per 16-byte vector
  constexpr int VPR = D / PER;            // vectors per row
  for (int e = threadIdx.x; e < NMAX * VPR; e += THREADS) {
    const int n = e / VPR, c = e % VPR;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (n < N)
      val = *reinterpret_cast<const uint4*>(
          src + ((size_t)g * N + n) * ld + col + c * PER);
    *reinterpret_cast<uint4*>(dst + n * HLD + c * PER) = val;
  }
}

// rows < N of a [64][O_LD] f32 staging tile, rounded to E, into head j's
// columns of window g of a (Bw, N, C) tensor
template <typename E>
__device__ __forceinline__ void store_tile(E* __restrict__ dst,
                                           const float* src, int g, int j,
                                           int N, int C) {
  for (int e = threadIdx.x; e < N * D; e += THREADS) {
    const int n = e / D, d = e % D;
    dst[((size_t)g * N + n) * C + j * D + d] = from_f32<E>(src[n * O_LD + d]);
  }
}

// C (64 x NC, f32, row-major ldc) = A . B, A (64 x K), B (K x NC):
// A[i][k] at a[i lda + k] (A_COL: a[k lda + i]), B[k][j] at b[k ldb + j]
// (B_COL: b[j ldb + k]).
// f32: one output cell per thread and step, fmaf over k in order.
template <bool A_COL, bool B_COL, int NC, int K>
__device__ __forceinline__ void mm(const float* a, int lda, const float* b,
                                   int ldb, float* c, int ldc) {
  for (int e = threadIdx.x; e < NMAX * NC; e += THREADS) {
    const int i = e / NC, jj = e % NC;
    float acc = 0.0f;
#pragma unroll 8
    for (int k = 0; k < K; ++k) {
      const float av = A_COL ? a[k * lda + i] : a[i * lda + k];
      const float bv = B_COL ? b[jj * ldb + k] : b[k * ldb + jj];
      acc = fmaf(av, bv, acc);
    }
    c[i * ldc + jj] = acc;
  }
}

// bf16: tensor cores, one 16 x 16 output tile per warp and step
template <bool A_COL, bool B_COL, int NC, int K>
__device__ __forceinline__ void mm(const bf16* a, int lda, const bf16* b,
                                   int ldb, float* c, int ldc) {
  using namespace nvcuda;
  using LA = typename std::conditional<A_COL, wmma::col_major,
                                       wmma::row_major>::type;
  using LB = typename std::conditional<B_COL, wmma::col_major,
                                       wmma::row_major>::type;
  constexpr int TN = NC / 16;
  const int warp = threadIdx.x >> 5;
  for (int t = warp; t < (NMAX / 16) * TN; t += WARPS) {
    const int ti = t / TN, tj = t % TN;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int k0 = 0; k0 < K; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LA> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> fb;
      wmma::load_matrix_sync(
          fa, A_COL ? a + k0 * lda + ti * 16 : a + ti * 16 * lda + k0, lda);
      wmma::load_matrix_sync(
          fb, B_COL ? b + tj * 16 * ldb + k0 : b + k0 * ldb + tj * 16, ldb);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(c + ti * 16 * ldc + tj * 16, acc, ldc,
                            wmma::mem_row_major);
  }
}

// Softmax over the keys of each query row, one warp a row: the logits
// l = S x scale + pb (the head's (N, N) position bias) + the shift mask
// (when `masked`), max, e = exp(l - max), s = sum e, P = e / s in f32,
// rounded to E; rows >= N of P zero. With lse, lse[n] = max + log(s).
// A scale of 1 leaves S as it is (x 1 is exact).
template <typename E>
__device__ __forceinline__ void softmax_rows(const float* S, E* P,
                                             const float* pb,
                                             const int* region, bool masked,
                                             int N, float scale,
                                             float* lse) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int n = warp; n < NMAX; n += WARPS) {
    E* prow = P + n * P_LD;
    if (n >= N) {
      prow[lane] = prow[lane + 32] = from_f32<E>(0.0f);
      continue;
    }
    float l[2];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int m = lane + 32 * h2;
      l[h2] = -INFINITY;
      if (m < N) {
        float x = __fadd_rn(__fmul_rn(S[n * S_LD + m], scale), pb[n * N + m]);
        if (masked) x = __fadd_rn(x, region[n] == region[m] ? 0.0f : -100.0f);
        l[h2] = x;
      }
    }
    const float mx = warp_max(fmaxf(l[0], l[1]));
    const float e0 = lane < N ? expf(__fsub_rn(l[0], mx)) : 0.0f;
    const float e1 = lane + 32 < N ? expf(__fsub_rn(l[1], mx)) : 0.0f;
    const float s = warp_sum(__fadd_rn(e0, e1));
    prow[lane] = from_f32<E>(__fdiv_rn(e0, s));
    prow[lane + 32] = from_f32<E>(__fdiv_rn(e1, s));
    if (lse != nullptr && lane == 0) lse[n] = __fadd_rn(mx, logf(s));
  }
}

inline bool bad_shape(int N, int C, int h, int ws) {
  return N <= 0 || N > NMAX || ws * ws != N || h <= 0 || C != h * D;
}

}  // namespace window_tiles
