// Whole Swin window-attention sub-block for Hopper (sm_90a).
//
// Replaces the TPU kernel nicr_mtsa_tpu/ops/pallas/window_attention.py
// (`fused_window_attention_block` -> `_fwd_call_block`): for one window
// of N <= 64 tokens of width C (h = C / 32 heads of 32),
//   qkv = x . Wqkv (f32 accumulation) rounded to T, + bqkv (in T);
//   v2: q and k of each head divided by max(||.||, 1e-6) in f32, rounded;
//   logits = q . k^T (f32) x scale (v2: the head's clamped logit scale,
//     v1: d^-0.5), + the relative-position bias, + the shift mask;
//   softmax in f32, probabilities rounded to T, out_h = P . V rounded;
//   out = concat_h(out_h) . Wproj (f32 accumulation) rounded, + bproj (T).
// Those rounding points are the TPU kernel's; they fix the bf16 output.
//
// The shift mask is not streamed: the kernel computes each token's
// shift region from the window's position in the padded image's window
// grid and the token's coordinates (the rule of `_shift_attn_mask`:
// rows below Hp - ws are region 0, below Hp - shift region 1, the rest
// region 2, per axis; an axis with no shift is all region 2) and adds
// -100 between different regions. For v1's N = 49 the keys >= N are
// skipped inside the kernel; no padded copy is made. Besides windows laid
// out (Bw, N, C), the kernel takes the (B, H, W, C) image itself
// (img_h > 0): each token's row is found through the zero pad to window
// multiples, the cyclic shift and the window partition, and the output
// is written back to the same pixel, so the Swin block makes no padded,
// rolled or partitioned copies.
//
// What bounds it on an H100: operations. Per window 512 C^2 + 16384 C
// flops against 4 N C bytes of activations in and out (the weights come
// from L2), e.g. 10.5 MFLOP vs 32 KB at C = 128 in bf16.
//
// Design. One block of 256 threads (8 warps) owns one window. Per head
// it computes q, k, v (N x 96) from x and the head's 96 columns of Wqkv,
// keeps them, the 64 x 64 logits and the probabilities in shared memory,
// and writes the head's 32 output columns to a global scratch tile (the
// wrapper allocates it: at C = 1024 the window's x tile and its
// concatenated attention output are 128 KB each in bf16 and would not
// both fit in shared memory beside the rest). The same block then reads
// its scratch tile back (from L2) for the output projection, in column
// tiles of 128.
// - bf16 (serving): the four products run on the tensor cores (wmma
//   16x16x16 bf16 with f32 accumulators); x stays in shared memory for
//   all heads (C + 8 bf16 a row, 17 KB at C = 128, 129 KB at C = 1024),
//   the weights stream through it in chunks of 64 rows, the next chunk
//   loaded into registers while the tensor cores work on the current
//   one. Dynamic shared memory: 70 KB at C = 128 (3 blocks an SM),
//   182 KB at C = 1024.
// - f32 (the card-vs-CPU check): the CUDA cores with fmaf chains, x and
//   the weights streamed in chunks of 32 along C; 46 KB static.
// Tensor-core products that overlap their loads (wgmma fed by TMA) are
// the next step.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int NMAX = 64;                 // tokens per window, at most
constexpr int D = 32;                    // head width
constexpr int KC = 32;                   // K chunk of the two products
constexpr int QKV = 3 * D;               // one head's q, k and v columns
constexpr int PC = 128;                  // output-projection column tile
constexpr int XS = NMAX * (KC + 1);      // x chunk   [NMAX][KC + 1]
constexpr int WS = KC * (QKV + 1);       // Wqkv chunk [KC][QKV + 1]
constexpr int SCRATCH = XS + WS;         // aliased by the logits S
constexpr int SS = NMAX * (NMAX + 1);    // logits    [NMAX][NMAX + 1]
constexpr int HS = NMAX * (D + 1);       // q, k, v   [NMAX][D + 1] each
constexpr int SMEM = SCRATCH + 3 * HS;
constexpr int PB = NMAX * (KC + 1) + KC * (PC + 1);   // projection phase
static_assert(SS <= SCRATCH, "logits must fit the GEMM scratch");
static_assert(PB <= SMEM, "projection tiles must fit shared memory");

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(
    __nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}

template <typename T> __device__ __forceinline__ float round_t(float v) {
  return to_f32<T>(from_f32<T>(v));
}

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

// shift region of one image coordinate (see the header)
__device__ __forceinline__ int axis_region(int pos, int n, int ws,
                                           int shift) {
  if (shift == 0) return 2;
  return pos < n - ws ? 0 : (pos < n - shift ? 1 : 2);
}

// offset (elements) of each token's row in x and out, or -1 for a token
// of the zero pad: windows laid out (Bw, N, C) when img_h == 0, else
// the (B, img_h, img_w, C) image itself, read and written through the
// pad, the cyclic shift and the window partition (the pad rows are
// zero keys; their outputs are not written)
__device__ __forceinline__ void token_rows(long long* rowoff, int g, int N,
                                           int C, int ws, int nWh, int nWw,
                                           int shift_h, int shift_w,
                                           int img_h, int img_w) {
  for (int n = threadIdx.x; n < NMAX; n += blockDim.x) {
    long long off = -1;
    if (n < N && img_h == 0) {
      off = ((long long)g * N + n) * C;
    } else if (n < N) {
      const int nW = nWh * nWw, b = g / nW, loc = g % nW;
      const int y = ((loc / nWw) * ws + n / ws + shift_h) % (nWh * ws);
      const int xx = ((loc % nWw) * ws + n % ws + shift_w) % (nWw * ws);
      if (y < img_h && xx < img_w)
        off = (((long long)b * img_h + y) * img_w + xx) * C;
    }
    rowoff[n] = off;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
window_attention_block_kernel(
    const T* __restrict__ x, const T* __restrict__ wqkv,
    const float* __restrict__ bqkv, const T* __restrict__ wproj,
    const float* __restrict__ bproj, const float* __restrict__ pos_bias,
    const float* __restrict__ v2_scale, T* attn, T* __restrict__ out, int N,
    int C, int n_heads, int ws, int nWh, int nWw, int shift_h, int shift_w,
    int img_h, int img_w, float v1_scale) {
  __shared__ float smem[SMEM];
  __shared__ int region[NMAX];
  __shared__ long long rowoff[NMAX];
  float* xs = smem;
  float* wsm = smem + XS;
  float* S = smem;
  float* qs = smem + SCRATCH;
  float* ks = qs + HS;
  float* vs = ks + HS;

  const int g = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const bool masked = shift_h > 0 || shift_w > 0;
  T* ag = attn + (size_t)g * N * C;
  token_rows(rowoff, g, N, C, ws, nWh, nWw, shift_h, shift_w, img_h, img_w);

  if (masked && tid < N) {
    const int loc = g % (nWh * nWw);
    const int y = (loc / nWw) * ws + tid / ws;
    const int xx = (loc % nWw) * ws + tid % ws;
    region[tid] = axis_region(y, nWh * ws, ws, shift_h) * 3 +
                  axis_region(xx, nWw * ws, ws, shift_w);
  }
  __syncthreads();

  for (int j = 0; j < n_heads; ++j) {
    // ---- q, k, v of head j: (N x C) . (C x 96) ----
    {
      const int tr = tid >> 4, tc = tid & 15;
      float acc[4][6];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 6; ++c) acc[i][c] = 0.0f;
      for (int k0 = 0; k0 < C; k0 += KC) {
        for (int e = tid; e < NMAX * KC; e += THREADS) {
          const int n = e / KC, kk = e % KC;
          xs[n * (KC + 1) + kk] =
              rowoff[n] >= 0 ? to_f32<T>(x[rowoff[n] + k0 + kk]) : 0.0f;
        }
        for (int e = tid; e < KC * QKV; e += THREADS) {
          const int kk = e / QKV, col = e % QKV;
          const int gc = (col / D) * C + j * D + col % D;
          wsm[kk * (QKV + 1) + col] =
              to_f32<T>(wqkv[(size_t)(k0 + kk) * 3 * C + gc]);
        }
        __syncthreads();
#pragma unroll 8
        for (int kk = 0; kk < KC; ++kk) {
          float a[4], b[6];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = xs[(tr + 16 * i) * (KC + 1) + kk];
#pragma unroll
          for (int c = 0; c < 6; ++c) b[c] = wsm[kk * (QKV + 1) + tc + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int c = 0; c < 6; ++c) acc[i][c] = fmaf(a[i], b[c], acc[i][c]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = tr + 16 * i;
#pragma unroll
        for (int c = 0; c < 6; ++c) {
          const int col = tc + 16 * c;
          const int part = col / D, dd = col % D;
          const float v = round_t<T>(__fadd_rn(
              round_t<T>(acc[i][c]), bqkv[part * C + j * D + dd]));
          float* dst = part == 0 ? qs : (part == 1 ? ks : vs);
          dst[n * (D + 1) + dd] = n < N ? v : 0.0f;
        }
      }
    }
    __syncthreads();

    // ---- v2: cosine attention, q and k normalised per head in f32 ----
    if (v2_scale != nullptr) {
      for (int n = warp; n < N; n += WARPS) {
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          float* row = (p == 0 ? qs : ks) + n * (D + 1);
          const float f = row[lane];
          const float nrm = sqrtf(warp_sum(__fmul_rn(f, f)));
          row[lane] = round_t<T>(__fdiv_rn(f, fmaxf(nrm, 1e-6f)));
        }
      }
      __syncthreads();
    }

    // ---- logits: (q . k^T) x scale + position bias + shift mask ----
    {
      const float scale = v2_scale != nullptr ? v2_scale[j] : v1_scale;
      const float* pb = pos_bias + (size_t)j * N * N;
      const int tn = tid >> 4, tm = tid & 15;
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;
#pragma unroll 8
      for (int dd = 0; dd < D; ++dd) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qs[(tn + 16 * i) * (D + 1) + dd];
#pragma unroll
        for (int c = 0; c < 4; ++c) b[c] = ks[(tm + 16 * c) * (D + 1) + dd];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(a[i], b[c], acc[i][c]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = tn + 16 * i;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int m = tm + 16 * c;
          if (n < N && m < N) {
            float l = __fadd_rn(__fmul_rn(acc[i][c], scale), pb[n * N + m]);
            if (masked) {
              l = __fadd_rn(l, region[n] == region[m] ? 0.0f : -100.0f);
            }
            S[n * (NMAX + 1) + m] = l;
          }
        }
      }
    }
    __syncthreads();

    // ---- softmax over the keys of each query row, in f32 ----
    for (int n = warp; n < N; n += WARPS) {
      float* row = S + n * (NMAX + 1);
      const bool in0 = lane < N, in1 = lane + 32 < N;
      const float l0 = in0 ? row[lane] : -INFINITY;
      const float l1 = in1 ? row[lane + 32] : -INFINITY;
      const float mx = warp_max(fmaxf(l0, l1));
      const float e0 = in0 ? expf(__fsub_rn(l0, mx)) : 0.0f;
      const float e1 = in1 ? expf(__fsub_rn(l1, mx)) : 0.0f;
      const float s = warp_sum(__fadd_rn(e0, e1));
      if (in0) row[lane] = round_t<T>(__fdiv_rn(e0, s));
      if (in1) row[lane + 32] = round_t<T>(__fdiv_rn(e1, s));
    }
    __syncthreads();

    // ---- out_h = P . V, rounded, into the scratch tile ----
    {
      const int tn = tid >> 3, td = tid & 7;
      float acc[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;
      for (int m = 0; m < N; ++m) {
        float a[2], b[4];
#pragma unroll
        for (int i = 0; i < 2; ++i) a[i] = S[(tn + 32 * i) * (NMAX + 1) + m];
#pragma unroll
        for (int c = 0; c < 4; ++c) b[c] = vs[m * (D + 1) + td + 8 * c];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(a[i], b[c], acc[i][c]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int n = tn + 32 * i;
        if (n < N) {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            ag[(size_t)n * C + j * D + td + 8 * c] = from_f32<T>(acc[i][c]);
        }
      }
    }
    __syncthreads();    // the next head reuses the shared buffers
  }

  // ---- output projection: (N x C) . (C x C), column tiles of PC ----
  float* as = smem;
  float* wps = smem + NMAX * (KC + 1);
  const int tr = tid >> 4, tc = tid & 15;
  for (int c0 = 0; c0 < C; c0 += PC) {
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] = 0.0f;
    for (int k0 = 0; k0 < C; k0 += KC) {
      for (int e = tid; e < NMAX * KC; e += THREADS) {
        const int n = e / KC, kk = e % KC;
        as[n * (KC + 1) + kk] =
            n < N ? to_f32<T>(ag[(size_t)n * C + k0 + kk]) : 0.0f;
      }
      for (int e = tid; e < KC * PC; e += THREADS) {
        const int kk = e / PC, col = e % PC;
        wps[kk * (PC + 1) + col] =
            c0 + col < C ? to_f32<T>(wproj[(size_t)(k0 + kk) * C + c0 + col])
                         : 0.0f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < KC; ++kk) {
        float a[4], b[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = as[(tr + 16 * i) * (KC + 1) + kk];
#pragma unroll
        for (int c = 0; c < 8; ++c) b[c] = wps[kk * (PC + 1) + tc + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(a[i], b[c], acc[i][c]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = tr + 16 * i;
      if (rowoff[n] < 0) continue;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = c0 + tc + 16 * c;
        if (col < C) {
          out[rowoff[n] + col] =
              from_f32<T>(__fadd_rn(round_t<T>(acc[i][c]), bproj[col]));
        }
      }
    }
  }
}

// ---- the bf16 form on the tensor cores ---------------------------------
namespace tc {

using namespace nvcuda;
using bf16 = __nv_bfloat16;
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16,
                             wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16,
                             wmma::row_major>;
using FragBt = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16,
                              wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// leading dimensions (elements), padded against bank conflicts; every
// 16-row tile offset stays 32-byte aligned, as wmma requires
constexpr int KC = 64;                   // weight rows per chunk
constexpr int WLD = QKV + 8;             // Wqkv chunk      bf16 [KC][104]
constexpr int ACC_LD = QKV + 4;          // qkv accumulators f32 [64][100]
constexpr int HLD = D + 8;               // q, k, v          bf16 [64][40]
constexpr int S_LD = NMAX + 4;           // logits           f32 [64][68]
constexpr int P_LD = NMAX + 8;           // probabilities    bf16 [64][72]
constexpr int O_LD = D + 4;              // head output      f32 [64][36]
constexpr int ALD = KC + 8;              // attention chunk  bf16 [64][72]
constexpr int PW_LD = PC + 8;            // Wproj chunk      bf16 [KC][136]
constexpr int OUT_LD = PC + 4;           // projection       f32 [64][132]
constexpr int W_BYTES = KC * WLD * 2;
constexpr int ACC_BYTES = NMAX * ACC_LD * 4;
constexpr int H_BYTES = NMAX * HLD * 2;
constexpr int REST_BYTES = W_BYTES + ACC_BYTES + 3 * H_BYTES;
constexpr int A_BYTES = NMAX * ALD * 2;
constexpr int PW_BYTES = KC * PW_LD * 2;
constexpr int OUT_BYTES = NMAX * OUT_LD * 4;
// uint4 loads of one chunk, and per thread
constexpr int WV = KC * QKV / 8, WR = WV / THREADS;
constexpr int AV = NMAX * KC / 8, AR = AV / THREADS;
constexpr int PV = KC * PC / 8, PR = PV / THREADS;
static_assert(WV % THREADS == 0 && AV % THREADS == 0 && PV % THREADS == 0,
              "whole chunks per thread");
static_assert(NMAX * S_LD * 4 <= ACC_BYTES, "logits alias the accumulators");
static_assert(NMAX * O_LD * 4 <= ACC_BYTES, "head output aliases them too");
static_assert(NMAX * P_LD * 2 <= W_BYTES, "probabilities alias the chunk");
static_assert(W_BYTES % 32 == 0 && ACC_BYTES % 32 == 0 &&
                  H_BYTES % 32 == 0 && A_BYTES % 32 == 0 &&
                  PW_BYTES % 32 == 0,
              "32-byte aligned regions");

// x tile [64][C + 8] bf16, then the per-head buffers; the projection
// phase reuses all of it (x is dead by then)
inline size_t smem_bytes(int C) {
  const size_t head_phase = (size_t)NMAX * (C + 8) * 2 + REST_BYTES;
  const size_t proj_phase = A_BYTES + PW_BYTES + OUT_BYTES;
  return head_phase > proj_phase ? head_phase : proj_phase;
}

__global__ void __launch_bounds__(THREADS)
window_attention_block_tc_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ wqkv,
    const float* __restrict__ bqkv, const bf16* __restrict__ wproj,
    const float* __restrict__ bproj, const float* __restrict__ pos_bias,
    const float* __restrict__ v2_scale, bf16* attn, bf16* __restrict__ out,
    int N, int C, int n_heads, int ws, int nWh, int nWw, int shift_h,
    int shift_w, int img_h, int img_w, float v1_scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int region[NMAX];
  __shared__ long long rowoff[NMAX];
  const int XLD = C + 8;
  bf16* Xs = reinterpret_cast<bf16*>(smem);
  unsigned char* rest = smem + (size_t)NMAX * XLD * 2;
  bf16* Ws = reinterpret_cast<bf16*>(rest);
  bf16* Ps = Ws;                        // probabilities, after the qkv product
  float* ACC = reinterpret_cast<float*>(rest + W_BYTES);
  float* S = ACC;                       // logits, after the qkv epilogue
  float* Ost = ACC;                     // head output, after the softmax
  bf16* Qs = reinterpret_cast<bf16*>(rest + W_BYTES + ACC_BYTES);
  bf16* Ks = Qs + NMAX * HLD;
  bf16* Vs = Ks + NMAX * HLD;
  bf16* As = reinterpret_cast<bf16*>(smem);                  // projection
  bf16* PWs = reinterpret_cast<bf16*>(smem + A_BYTES);
  float* OUTs = reinterpret_cast<float*>(smem + A_BYTES + PW_BYTES);

  const int g = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const bool masked = shift_h > 0 || shift_w > 0;
  bf16* ag = attn + (size_t)g * N * C;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  token_rows(rowoff, g, N, C, ws, nWh, nWw, shift_h, shift_w, img_h, img_w);

  if (masked && tid < N) {
    const int loc = g % (nWh * nWw);
    const int y = (loc / nWw) * ws + tid / ws;
    const int xx = (loc % nWw) * ws + tid % ws;
    region[tid] = axis_region(y, nWh * ws, ws, shift_h) * 3 +
                  axis_region(xx, nWw * ws, ws, shift_w);
  }
  __syncthreads();
  // the window's x tile, once for all heads (pad rows are zero)
  const int cv = C / 8;
  for (int e = tid; e < NMAX * cv; e += THREADS) {
    const int n = e / cv, q = e % cv;
    *reinterpret_cast<uint4*>(Xs + n * XLD + q * 8) =
        rowoff[n] >= 0 ? reinterpret_cast<const uint4*>(x + rowoff[n])[q]
                       : zero;
  }

  for (int j = 0; j < n_heads; ++j) {
    // ---- q, k, v of head j: (64 x C) . (C x 96); warp: 1 x 3 tiles.
    //      The next weight chunk is loaded into registers while the
    //      tensor cores work on the current one ----
    {
      const int tr = warp >> 1, tc0 = (warp & 1) * 3;
      FragC acc[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) wmma::fill_fragment(acc[i], 0.0f);
      uint4 wreg[WR];
      auto load_w = [&](int k0) {
#pragma unroll
        for (int r = 0; r < WR; ++r) {
          const int e = tid + r * THREADS, kk = e / 12;
          wreg[r] = k0 + kk < C
                        ? reinterpret_cast<const uint4*>(
                              wqkv + (size_t)(k0 + kk) * 3 * C +
                              ((e % 12) / 4) * C + j * D)[e % 4]
                        : zero;
        }
      };
      load_w(0);
      for (int k0 = 0; k0 < C; k0 += KC) {
#pragma unroll
        for (int r = 0; r < WR; ++r) {
          const int e = tid + r * THREADS;
          *reinterpret_cast<uint4*>(Ws + (e / 12) * WLD +
                                    ((e % 12) / 4) * D + (e % 4) * 8) =
              wreg[r];
        }
        __syncthreads();
        if (k0 + KC < C) load_w(k0 + KC);
        const int kc = min(KC, C - k0);
#pragma unroll
        for (int ks = 0; ks < KC; ks += 16) {
          if (ks >= kc) break;
          FragA a;
          wmma::load_matrix_sync(a, Xs + tr * 16 * XLD + k0 + ks, XLD);
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            FragB b;
            wmma::load_matrix_sync(b, Ws + ks * WLD + (tc0 + i) * 16, WLD);
            wmma::mma_sync(acc[i], a, b, acc[i]);
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 3; ++i)
        wmma::store_matrix_sync(ACC + tr * 16 * ACC_LD + (tc0 + i) * 16,
                                acc[i], ACC_LD, wmma::mem_row_major);
    }
    __syncthreads();
    // rounded to bf16, + the bias in bf16 (rows >= N zero)
    for (int e = tid; e < NMAX * QKV; e += THREADS) {
      const int n = e / QKV, col = e % QKV, part = col / D, dd = col % D;
      float v = 0.0f;
      if (n < N)
        v = __fadd_rn(round_t<bf16>(ACC[n * ACC_LD + col]),
                      bqkv[part * C + j * D + dd]);
      bf16* dst = part == 0 ? Qs : (part == 1 ? Ks : Vs);
      dst[n * HLD + dd] = __float2bfloat16_rn(v);
    }
    __syncthreads();

    if (v2_scale != nullptr) {
      for (int n = warp; n < N; n += WARPS) {
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          bf16* row = (p == 0 ? Qs : Ks) + n * HLD;
          const float f = __bfloat162float(row[lane]);
          const float nrm = sqrtf(warp_sum(__fmul_rn(f, f)));
          row[lane] = __float2bfloat16_rn(__fdiv_rn(f, fmaxf(nrm, 1e-6f)));
        }
      }
      __syncthreads();
    }

    // ---- logits q . k^T (64 x 64); warp: 1 x 2 tiles ----
    {
      const int tr = warp >> 1, tc0 = (warp & 1) * 2;
      FragC acc[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::fill_fragment(acc[i], 0.0f);
#pragma unroll
      for (int ks = 0; ks < D; ks += 16) {
        FragA a;
        wmma::load_matrix_sync(a, Qs + tr * 16 * HLD + ks, HLD);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          FragBt b;                  // k^T: column-major view of k
          wmma::load_matrix_sync(b, Ks + (tc0 + i) * 16 * HLD + ks, HLD);
          wmma::mma_sync(acc[i], a, b, acc[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::store_matrix_sync(S + tr * 16 * S_LD + (tc0 + i) * 16, acc[i],
                                S_LD, wmma::mem_row_major);
    }
    __syncthreads();

    // ---- x scale + position bias + shift mask, softmax in f32 ----
    {
      const float scale = v2_scale != nullptr ? v2_scale[j] : v1_scale;
      const float* pb = pos_bias + (size_t)j * N * N;
      for (int n = warp; n < NMAX; n += WARPS) {
        bf16* prow = Ps + n * P_LD;
        if (n >= N) {
          prow[lane] = prow[lane + 32] = __float2bfloat16_rn(0.0f);
          continue;
        }
        const float* srow = S + n * S_LD;
        float l[2];
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int m = lane + 32 * h2;
          l[h2] = -INFINITY;
          if (m < N) {
            float v = __fadd_rn(__fmul_rn(srow[m], scale), pb[n * N + m]);
            if (masked) v = __fadd_rn(v, region[n] == region[m] ? 0.0f
                                                                : -100.0f);
            l[h2] = v;
          }
        }
        const float mx = warp_max(fmaxf(l[0], l[1]));
        const float e0 = lane < N ? expf(__fsub_rn(l[0], mx)) : 0.0f;
        const float e1 = lane + 32 < N ? expf(__fsub_rn(l[1], mx)) : 0.0f;
        const float s = warp_sum(__fadd_rn(e0, e1));
        prow[lane] = __float2bfloat16_rn(__fdiv_rn(e0, s));
        prow[lane + 32] = __float2bfloat16_rn(__fdiv_rn(e1, s));
      }
    }
    __syncthreads();

    // ---- head output P . V (64 x 32); warp: one tile ----
    {
      const int tr = warp >> 1, tc = warp & 1;
      FragC acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int ks = 0; ks < NMAX; ks += 16) {
        FragA a;
        FragB b;
        wmma::load_matrix_sync(a, Ps + tr * 16 * P_LD + ks, P_LD);
        wmma::load_matrix_sync(b, Vs + ks * HLD + tc * 16, HLD);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(Ost + tr * 16 * O_LD + tc * 16, acc, O_LD,
                              wmma::mem_row_major);
    }
    __syncthreads();
    for (int e = tid; e < N * D; e += THREADS) {
      const int n = e / D, dd = e % D;
      ag[(size_t)n * C + j * D + dd] = __float2bfloat16_rn(Ost[n * O_LD + dd]);
    }
    __syncthreads();           // the next head reuses the buffers
  }

  // ---- output projection (64 x C) . (C x C), column tiles of 128;
  //      warp: 1 x 4 tiles ----
  const int tr = warp >> 1, tc0 = (warp & 1) * 4;
  for (int c0 = 0; c0 < C; c0 += PC) {
    FragC acc[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) wmma::fill_fragment(acc[i], 0.0f);
    uint4 areg[AR], preg[PR];
    auto load_ap = [&](int k0) {
#pragma unroll
      for (int r = 0; r < AR; ++r) {
        const int e = tid + r * THREADS, n = e / (KC / 8), q = e % (KC / 8);
        areg[r] = n < N && k0 + q * 8 < C
                      ? reinterpret_cast<const uint4*>(ag + (size_t)n * C +
                                                       k0)[q]
                      : zero;
      }
#pragma unroll
      for (int r = 0; r < PR; ++r) {
        const int e = tid + r * THREADS, kk = e / (PC / 8), q = e % (PC / 8);
        preg[r] = k0 + kk < C && c0 + q * 8 < C
                      ? reinterpret_cast<const uint4*>(
                            wproj + (size_t)(k0 + kk) * C + c0)[q]
                      : zero;
      }
    };
    load_ap(0);
    for (int k0 = 0; k0 < C; k0 += KC) {
#pragma unroll
      for (int r = 0; r < AR; ++r) {
        const int e = tid + r * THREADS;
        *reinterpret_cast<uint4*>(As + (e / (KC / 8)) * ALD +
                                  (e % (KC / 8)) * 8) = areg[r];
      }
#pragma unroll
      for (int r = 0; r < PR; ++r) {
        const int e = tid + r * THREADS;
        *reinterpret_cast<uint4*>(PWs + (e / (PC / 8)) * PW_LD +
                                  (e % (PC / 8)) * 8) = preg[r];
      }
      __syncthreads();
      if (k0 + KC < C) load_ap(k0 + KC);
      const int kc = min(KC, C - k0);
#pragma unroll
      for (int ks = 0; ks < KC; ks += 16) {
        if (ks >= kc) break;
        FragA a;
        wmma::load_matrix_sync(a, As + tr * 16 * ALD + ks, ALD);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          FragB b;
          wmma::load_matrix_sync(b, PWs + ks * PW_LD + (tc0 + i) * 16, PW_LD);
          wmma::mma_sync(acc[i], a, b, acc[i]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      wmma::store_matrix_sync(OUTs + tr * 16 * OUT_LD + (tc0 + i) * 16,
                              acc[i], OUT_LD, wmma::mem_row_major);
    __syncthreads();
    for (int e = tid; e < N * PC; e += THREADS) {
      const int n = e / PC, col = c0 + e % PC;
      if (col < C && rowoff[n] >= 0)
        out[rowoff[n] + col] = __float2bfloat16_rn(__fadd_rn(
            round_t<bf16>(OUTs[n * OUT_LD + e % PC]), bproj[col]));
    }
    __syncthreads();
  }
}

}  // namespace tc

template <typename T>
int launch(const void* x, const void* wqkv, const float* bqkv,
           const void* wproj, const float* bproj, const float* pos_bias,
           const float* v2_scale, void* attn, void* out, int Bw, int N, int C,
           int n_heads, int ws, int nWh, int nWw, int shift_h, int shift_w,
           int img_h, int img_w, float v1_scale, cudaStream_t stream) {
  if (Bw <= 0) return (int)cudaSuccess;
  if (N <= 0 || N > NMAX || ws * ws != N || C != n_heads * D)
    return (int)cudaErrorInvalidValue;
  if constexpr (sizeof(T) == 2) {
    const size_t smem = tc::smem_bytes(C);
    cudaError_t err = cudaFuncSetAttribute(
        tc::window_attention_block_tc_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    tc::window_attention_block_tc_kernel<<<Bw, THREADS, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(wqkv), bqkv,
        static_cast<const T*>(wproj), bproj, pos_bias, v2_scale,
        static_cast<T*>(attn), static_cast<T*>(out), N, C, n_heads, ws, nWh,
        nWw, shift_h, shift_w, img_h, img_w, v1_scale);
    return (int)cudaGetLastError();
  }
  window_attention_block_kernel<T><<<Bw, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wqkv), bqkv,
      static_cast<const T*>(wproj), bproj, pos_bias, v2_scale,
      static_cast<T*>(attn), static_cast<T*>(out), N, C, n_heads, ws, nWh,
      nWw, shift_h, shift_w, img_h, img_w, v1_scale);
  return (int)cudaGetLastError();
}

}  // namespace

#define WAB_ENTRY(NAME, T)                                                    \
  extern "C" int NAME(const void* x, const void* wqkv, const float* bqkv,    \
                      const void* wproj, const float* bproj,                 \
                      const float* pos_bias, const float* v2_scale,          \
                      void* attn, void* out, int Bw, int N, int C,           \
                      int n_heads, int ws, int nWh, int nWw, int shift_h,    \
                      int shift_w, int img_h, int img_w, float v1_scale,     \
                      void* stream) {                                        \
    return launch<T>(x, wqkv, bqkv, wproj, bproj, pos_bias, v2_scale, attn,  \
                     out, Bw, N, C, n_heads, ws, nWh, nWw, shift_h, shift_w, \
                     img_h, img_w, v1_scale,                                 \
                     static_cast<cudaStream_t>(stream));                     \
  }

WAB_ENTRY(window_attention_block_f32, float)
WAB_ENTRY(window_attention_block_bf16, __nv_bfloat16)
