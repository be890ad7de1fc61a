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
// The shift mask is not streamed: each token's shift region comes from
// the window's position in the padded image's window grid and the
// token's coordinates (the rule of `_shift_attn_mask`: rows below
// Hp - ws are region 0, below Hp - shift region 1, the rest region 2,
// per axis; an axis with no shift is all region 2), and -100 is added
// between different regions. For v1's N = 49 the keys >= N are skipped
// inside the kernel; no padded copy is made. Besides windows laid out
// (Bw, N, C), the kernels take the (B, H, W, C) image itself: each
// token's row is found through the zero pad to window multiples, the
// cyclic shift and the window partition (bf16: the wrapper's table of
// source pixels, -1 for a pad token; f32: computed here), and the
// output is written back to the same pixel, so the Swin block makes no
// padded, rolled or partitioned copies.
//
// What bounds it on an H100: operations. Per window 8 N C^2 flops for
// the two products plus 4 N^2 C for the attention (10.5 MFLOP at
// C = 128) against 4 N C bytes of activations in and out; the products
// are 80 % of the work at C = 128, 97 % at C = 1024.
//
// Design of the bf16 path (serving): two kernels, launched together on
// the caller's stream, on the tensor cores throughout. The two products
// are wgmma (bf16 in, f32 accumulators in registers) with both operands
// read by the tensor cores from shared memory; the attention is
// mma.sync m16n8k16 fed by ldmatrix. The activations (x, the scratch)
// arrive in chunks of 64 along K, 128-byte rows, by 16-byte cp.async.cg
// (8 threads a row; pad tokens, rows >= N and columns past C zero-filled)
// into the 128-byte-swizzled K-major layout. The weights are packed once
// by the wrapper (cached per weight tensor) into one contiguous tile per
// (head or output-column tile, K chunk), already in the no-swizzle
// MN-major core-matrix layout, and arrive by one bulk async copy
// (cp.async.bulk, completed on an mbarrier). Both because issuing the
// copies bounds the products: per-thread 16-byte copies of 64-byte rows
// or weight segments touch 16 lines a warp and took ~2000 clocks a
// chunk to issue.
// - `qkv_attend_kernel`: one warpgroup a window, WPB = 2 windows a block
//   sharing each weight chunk, one head a block (blockIdx.y). A block
//   walks its window pairs (blockIdx.x, + gridDim.x, ...) on a grid
//   sized to one wave of resident blocks (2 an SM). qkv_j = x_w .
//   Wqkv[:, q_j | k_j | v_j] (64 x 96, K = C, wgmma m64n96k16) through a
//   2-stage ring that runs on across windows, so the next window's first
//   chunk is in flight while a window's attention runs. Each warp holds
//   its 16 rows x 96 columns in f32 registers, in the layout of
//   mma.sync's C fragments; the epilogue rounds, adds the bias (rounded
//   to bf16 here) on bf16 pairs, (v2) normalises q and k over quad
//   shuffles, keeps q in registers as the A fragments of q k^T and
//   writes k and v to [64][40] shared tiles. The attention is the
//   forward tile's `attend_rows` (window_tiles.cuh: S and P in
//   registers), reading the head's bias cells from shared memory (stored
//   there once a block, in fragment order) and the shift-mask bits from
//   registers; the head's 32 output columns leave in 16-byte stores to
//   the (Bw, N, C) scratch. 128 registers, no spills.
// - `proj_kernel`: the output projection as a tiled GEMM over all
//   windows' rows (M = Bw N, N = K = C): 128 x 128 tiles, a warpgroup of
//   64 rows each (wgmma m64n128k16), a 3-stage ring; the epilogue rounds,
//   adds bproj in bf16, stages the tile in shared memory and writes each
//   row to its window row or pixel in 16-byte stores (pad tokens and rows
//   past the end are not written).
// What keeps it from the bound: the L2 traffic of the activation chunks
// (x re-read by every head, the weight chunks by every window pair),
// the per-window epilogue and softmax instructions, and the scratch
// round trip (2 N C bytes a window each way, mostly held in L2). A
// projection fused through clusters, and x shared across heads, are the
// next steps.
// The f32 path (the card-vs-CPU check) is one block of 256 threads a
// window on the CUDA cores, with fmaf chains, x and the weights streamed
// in chunks of 32 along C (46 KB static), writing the same scratch.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "window_tiles.cuh"

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

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
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

// ---- the bf16 path on the tensor cores (see the header) ----------------
namespace tc {

namespace fwd = window_tiles::fwd;
using bf16 = __nv_bfloat16;
using fwd::cp_async16_zfill;
using fwd::pack_bf16;

constexpr int KC = 64;                   // K chunk of both products
constexpr int KV = KC / 8;               // 16-byte vectors of a chunk row

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// row of window g's token n in x or out: g N + n for windows laid out
// (Bw, N, C), else (rows: the wrapper's table) the token's pixel of the
// (B, H, W, C) image, -1 for a pad token
__device__ __forceinline__ int token_row(const int* __restrict__ rows, int g,
                                         int n, int N) {
  return rows == nullptr ? g * N + n : rows[(size_t)g * N + n];
}

// ---- wgmma operands in shared memory ----
// A (activations, M x K) is K-major with the 128-byte swizzle: a chunk
// row is KC = 64 values (128 bytes), 16-byte vector c of row r at
// r 128 + ((c ^ (r % 8)) 16) bytes, 8-row atoms of 1024 bytes (1024-byte
// aligned); SBO = 1024, the k16 step advances the start by 32 bytes.
// B (weights, K x N) is MN-major without swizzle, as the wrapper packs
// it: 8 x 16-byte core matrices, core (k / 8, n / 8) of a chunk of nc
// columns at ((k / 8) nc / 8 + n / 8) 128 bytes; LBO (between cores
// adjacent along K) = nc / 8 x 128, SBO (along N) = 128.
__device__ __forceinline__ int swz(int r, int c) {
  return r * KC + ((c ^ (r & 7)) << 3);
}

__device__ __forceinline__ uint64_t desc_a(const bf16* p) {
  return (uint64_t)((fwd::smem_u32(p) >> 4) & 0x3FFFu) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ uint64_t desc_b(const bf16* p, int nc) {
  return (uint64_t)((fwd::smem_u32(p) >> 4) & 0x3FFFu) |
         ((uint64_t)(nc / 8 * 128 >> 4) << 16) | ((uint64_t)(128 >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// shared-memory writes of this thread (generic proxy) made visible to
// the wgmma operand reads (async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keeps the compiler from moving accesses of the accumulators across a
// wgmma wait or issue
template <int T>
__device__ __forceinline__ void fence_regs(float (&d)[T][4]) {
#pragma unroll
  for (int t = 0; t < T; ++t)
#pragma unroll
    for (int c = 0; c < 4; ++c) asm volatile("" : "+f"(d[t][c])::"memory");
}

// d (a warpgroup's 64 x 96 f32 accumulators: in each warp the m16n8 C
// fragments of 12 n8-tiles, rows 16 w + lane / 4 (+ 8)) = a . b
// (+ d unless scale_d is 0) by wgmma m64n96k16, B MN-major
__device__ __forceinline__ void wgmma_n96(float (&d)[12][4], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3])
      : "l"(da), "l"(db), "r"(scale_d));
}

// the same over 16 n8-tiles: wgmma m64n128k16
__device__ __forceinline__ void wgmma_n128(float (&d)[16][4], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(da), "l"(db), "r"(scale_d));
}

// the activation side of a chunk: rows of the A tile (tile row r0 + i
// THREADS_ / 8's source row src_row[i], -1 for zeros; r0 = thread / 8)
// columns k0 .. k0 + 63, in 16-byte copies (8 threads a 128-byte row;
// vectors past C zero-filled). A thread's rows lie a multiple of 8
// apart, so they share one swizzle pattern.
template <int ROWS, int THREADS_>
__device__ __forceinline__ void issue_rows(bf16* dst,
                                           const bf16* __restrict__ src,
                                           const int (&src_row)[ROWS * KV /
                                                                THREADS_],
                                           int k0, int C) {
  static_assert((THREADS_ / KV) % 8 == 0, "rows a multiple of 8 apart");
  const int c = threadIdx.x % KV, col = k0 + c * 8;
  bf16* d = dst + swz(threadIdx.x / KV, c);
#pragma unroll
  for (int i = 0; i < ROWS * KV / THREADS_; ++i) {
    const bool ok = src_row[i] >= 0 && col < C;
    cp_async16_zfill(d + i * (THREADS_ / KV) * KC,
                     ok ? src + (size_t)src_row[i] * C + col : src, ok);
  }
}

// ---- a packed weight chunk: one bulk async copy, its completion
// counted on an mbarrier (one arrival, the bytes as its transactions)
__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(fwd::smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void bar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_load(bf16* dst, const bf16* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%2], [%3], %1, [%0];\n"
      :: "r"(fwd::smem_u32(bar)), "r"(bytes), "r"(fwd::smem_u32(dst)),
         "l"(src)
      : "memory");
}

// until the phase of `bar` with this parity has completed
__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n}\n"
      :: "r"(fwd::smem_u32(bar)), "r"(parity) : "memory");
}

// ---- kernel A: qkv and attention per (window, head) ----
namespace qa {

constexpr int WPB = 2;                   // windows a block, a warpgroup each
constexpr int THREADS = 128 * WPB;
constexpr int MIN_BLOCKS = 4 / WPB;      // resident blocks an SM
constexpr int STAGES = 2;
constexpr int X_ELEMS = NMAX * KC;       // x chunk of a window (A)
constexpr int W_ELEMS = KC * QKV;        // Wqkv chunk (B), packed, shared
constexpr int STAGE_ELEMS = WPB * X_ELEMS + W_ELEMS;
constexpr int TILE = NMAX * fwd::LD;     // the k, v and output tiles
constexpr int XR = WPB * NMAX * KV / THREADS;   // x rows a thread copies
constexpr int CELLS = 32 * 128;         // the head's bias cells, by thread
// the stages, the k, v and output tiles, the biases, the bias cells and
// the stages' mbarriers
constexpr size_t SMEM = (size_t)(STAGES * STAGE_ELEMS + WPB * 3 * TILE) * 2 +
                        (QKV + CELLS) * 4 + STAGES * 8;
static_assert(XR * THREADS == WPB * NMAX * KV, "whole x chunks per thread");
static_assert(STAGE_ELEMS * 2 % 1024 == 0, "1024-byte aligned stages");
static_assert(fwd::LD == 40, "the forward tile's [64][40] tiles");

template <bool UNIT_QK>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
qkv_attend_kernel(const bf16* __restrict__ x, const int* __restrict__ rows,
                  const bf16* __restrict__ wpk,
                  const float* __restrict__ bqkv,
                  const float* __restrict__ pos_bias,
                  const float* __restrict__ v2_scale, bf16* __restrict__ attn,
                  int Bw, int N, int C, int ws, int nWh, int nWw, int shift_h,
                  int shift_w, float v1_scale) {
  // the stages first: the dynamic shared memory of a kernel without
  // static shared memory starts 1024-byte aligned
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int slot = warp >> 2, w = warp & 3;   // window of the block, warp in it
  const int tq = lane & 3, row0 = w * 16 + (lane >> 2);
  bf16* Ks = ring + STAGES * STAGE_ELEMS + slot * 3 * TILE;
  bf16* Vs = Ks + TILE;
  bf16* Os = Vs + TILE;
  float2* bq = reinterpret_cast<float2*>(ring + STAGES * STAGE_ELEMS +
                                         WPB * 3 * TILE);   // head's biases
  float* cells = reinterpret_cast<float*>(bq) + QKV;
  uint64_t* bar = reinterpret_cast<uint64_t*>(cells + CELLS);
  const int j = blockIdx.y, bx = blockIdx.x, gx = gridDim.x;
  const int n_groups = (Bw + WPB - 1) / WPB;
  const int nK = (C + KC - 1) / KC;
  const int T = bx < n_groups ? ((n_groups - 1 - bx) / gx + 1) * nK : 0;
  const float scale = UNIT_QK ? v2_scale[j] : v1_scale;
  if ((fwd::smem_u32(smem) & 1023u) != 0) __trap();   // swizzle atoms
  for (int e = tid; e < QKV; e += THREADS)         // rounded to bf16
    reinterpret_cast<float*>(bq)[e] =
        round_bf16(bqkv[(e / D) * C + j * D + e % D]);
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) bar_init(bar + s);
    bar_fence_init();
  }
  // the head's bias cells (identical in both warpgroups) to shared
  // memory, where each window's attention reads them; the shift-mask
  // bits stay in registers
  fwd::HeadCells hc;
  fwd::load_head_cells(hc, pos_bias + (size_t)j * N * N, row0, N, ws,
                       shift_h, shift_w);
  if (slot == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int k = 0; k < 16; ++k)
        cells[(i * 16 + k) * 128 + tid] = hc.pb[i][k];
  }
  __syncthreads();

  // the ring's producer side: chunk t of the block's sequence (windows
  // (bx + (t / nK) gx) WPB .., K columns (t % nK) KC ..): the x rows of
  // each window (cp.async, one commit a call, empty past the end), and
  // the head's packed Wqkv chunk, which they share (a bulk copy on the
  // stage's mbarrier). The source rows of this thread's x vectors are
  // found once a window group.
  int xrow[XR];
  auto issue = [&](int t) {
    if (t < T) {
      bf16* st = ring + (t % STAGES) * STAGE_ELEMS;
      const int kc = t % nK;
      if (kc == 0) {
        const int g0 = (bx + (t / nK) * gx) * WPB;
#pragma unroll
        for (int i = 0; i < XR; ++i) {
          const int r = (tid + i * THREADS) / KV, g = g0 + r / NMAX;
          xrow[i] = g < Bw && r % NMAX < N
                        ? token_row(rows, g, r % NMAX, N) : -1;
        }
      }
      issue_rows<WPB * NMAX, THREADS>(st, x, xrow, kc * KC, C);
      if (tid == 0)
        bulk_load(st + WPB * X_ELEMS, wpk + ((size_t)j * nK + kc) * W_ELEMS,
                  W_ELEMS * 2, bar + t % STAGES);
    }
    fwd::cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) issue(t);

  float acc[12][4];                        // 16 rows x (q | k | v) columns
  for (int t = 0; t < T; ++t) {
    const int kc = t % nK;
    if (kc == 0) {             // a new window: the last one's values are dead
#pragma unroll
      for (int nt = 0; nt < 12; ++nt)
        acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
    }
    fwd::cp_async_wait<STAGES - 2>();
    fence_async_smem();
    bar_wait(bar + t % STAGES, (t / STAGES) & 1);
    __syncthreads();           // chunk t landed; chunk t - 1's stage is free
    issue(t + STAGES - 1);
    const bf16* st = ring + (t % STAGES) * STAGE_ELEMS;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks)
      wgmma_n96(acc, desc_a(st + slot * X_ELEMS + ks * 16),
                desc_b(st + WPB * X_ELEMS + ks * 2 * 12 * 64, QKV),
                kc > 0 || ks > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    if (kc != nK - 1) continue;

    // ---- the window's epilogue, on bf16 pairs (columns 8 nt + 2 tq, + 1
    //      of rows row0 + 8 i): rounded, + the bias in bf16, rows >= N
    //      zero; v2: q and k divided by max(||row||, 1e-6) ----
    const int g = (bx + (t / nK) * gx) * WPB + slot;
    __nv_bfloat162 v[12][2];
#pragma unroll
    for (int nt = 0; nt < 12; ++nt) {
      const float2 b = bq[nt * 4 + tq];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float2 f = __bfloat1622float2(
            __floats2bfloat162_rn(acc[nt][2 * i], acc[nt][2 * i + 1]));
        v[nt][i] = __floats2bfloat162_rn(__fadd_rn(f.x, b.x),
                                         __fadd_rn(f.y, b.y));
      }
    }
    if (N < NMAX) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (row0 + 8 * i >= N) {
#pragma unroll
          for (int nt = 0; nt < 12; ++nt)
            v[nt][i] = __floats2bfloat162_rn(0.0f, 0.0f);
        }
    }
    if (UNIT_QK) {
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float2 f[4];
          float ss = 0.0f;
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            f[u] = __bfloat1622float2(v[4 * p + u][i]);
            ss = __fadd_rn(ss, __fmul_rn(f[u].x, f[u].x));
            ss = __fadd_rn(ss, __fmul_rn(f[u].y, f[u].y));
          }
          ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, 1));
          ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, 2));
          const float den = fmaxf(sqrtf(ss), 1e-6f), r = __frcp_rn(den);
#pragma unroll
          for (int u = 0; u < 4; ++u)
            v[4 * p + u][i] = __floats2bfloat162_rn(
                fwd::div_by(f[u].x, den, r), fwd::div_by(f[u].y, den, r));
        }
    }
    // q as the A fragments of q k^T (keys 16 kk ..); k and v to the tiles
    unsigned qf[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          qf[kk][half * 2 + i] =
              *reinterpret_cast<const unsigned*>(&v[2 * kk + half][i]);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int off = (row0 + 8 * i) * fwd::LD + nt * 8 + 2 * tq;
        *reinterpret_cast<__nv_bfloat162*>(Ks + off) = v[4 + nt][i];
        *reinterpret_cast<__nv_bfloat162*>(Vs + off) = v[8 + nt][i];
      }
    __syncthreads();           // every warp of a window needs all its keys
    if (g < Bw) {              // uniform in a warpgroup
      const int loc = g % (nWh * nWw);
      const bool edge_y = shift_h > 0 && loc / nWw == nWh - 1;
      const bool edge_x = shift_w > 0 && loc % nWw == nWw - 1;
      const float* my_cells = cells + (tid & 127);
      float o[4][4];
      fwd::attend_rows<false>(
          qf, Ks, Vs,
          [&](int i, int k) { return my_cells[(i * 16 + k) * 128]; },
          edge_y || edge_x,
          (edge_y ? hc.ydiff : 0u) | (edge_x ? hc.xdiff : 0u), scale, N,
          row0, nullptr, o);
      fwd::store_rows(o, Os, w, attn + j * D, C, g, N);
    }
  }
}

}  // namespace qa

// ---- kernel B: the output projection over all windows' rows ----
namespace proj {

constexpr int BM = 128, BN = 128;        // output tile: a warpgroup 64 rows
constexpr int STAGES = 3;
constexpr int THREADS = 256;
constexpr int A_ELEMS = BM * KC;         // scratch chunk (A)
constexpr int B_ELEMS = KC * BN;         // Wproj chunk (B), packed
constexpr int STAGE_ELEMS = A_ELEMS + B_ELEMS;
constexpr int AR = BM * KV / THREADS;    // scratch rows a thread copies
constexpr int OLD = BN + 8;              // output tile [128][136]
// the stages, the output rows and the stages' mbarriers
constexpr size_t SMEM = (size_t)STAGES * STAGE_ELEMS * 2 + BM * 4 +
                        STAGES * 8;
static_assert((size_t)BM * OLD * 2 <= (size_t)STAGES * STAGE_ELEMS * 2,
              "the output tile reuses the ring");
static_assert(AR * THREADS == BM * KV, "whole chunks per thread");

__global__ void __launch_bounds__(THREADS, 2)
proj_kernel(const bf16* __restrict__ attn, const int* __restrict__ rows,
            const bf16* __restrict__ wpk, const float* __restrict__ bproj,
            bf16* __restrict__ out, int M, int N, int C) {
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  int* orow = reinterpret_cast<int*>(ring + STAGES * STAGE_ELEMS);
  uint64_t* bar = reinterpret_cast<uint64_t*>(orow + BM);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, w = warp & 3;      // warpgroup, warp in it
  const int tq = lane & 3, row0 = wg * 64 + w * 16 + (lane >> 2);
  const int nt0 = blockIdx.x, n0 = nt0 * BN, m0 = blockIdx.y * BM;
  const int nK = (C + KC - 1) / KC;
  if ((fwd::smem_u32(smem) & 1023u) != 0) __trap();   // swizzle atoms
  if (tid < BM) {              // the output row of each tile row
    const int r = m0 + tid;
    orow[tid] = r < M ? token_row(rows, r / N, r % N, N) : -1;
  }
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) bar_init(bar + s);
    bar_fence_init();
  }
  __syncthreads();
  int arow[AR];                // the scratch rows this thread copies
#pragma unroll
  for (int i = 0; i < AR; ++i) {
    const int r = m0 + (tid + i * THREADS) / KV;
    arow[i] = r < M ? r : -1;
  }

  auto issue = [&](int t) {
    if (t < nK) {
      bf16* st = ring + (t % STAGES) * STAGE_ELEMS;
      issue_rows<BM, THREADS>(st, attn, arow, t * KC, C);
      if (tid == 0)
        bulk_load(st + A_ELEMS, wpk + ((size_t)nt0 * nK + t) * B_ELEMS,
                  B_ELEMS * 2, bar + t % STAGES);
    }
    fwd::cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) issue(t);

  float acc[16][4] = {};
  for (int t = 0; t < nK; ++t) {
    fwd::cp_async_wait<STAGES - 2>();
    fence_async_smem();
    bar_wait(bar + t % STAGES, (t / STAGES) & 1);
    __syncthreads();
    issue(t + STAGES - 1);
    const bf16* st = ring + (t % STAGES) * STAGE_ELEMS;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks)
      wgmma_n128(acc, desc_a(st + wg * 64 * KC + ks * 16),
                 desc_b(st + A_ELEMS + ks * 2 * (BN / 8) * 64, BN),
                 t > 0 || ks > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
  }
  fwd::cp_async_wait_all();
  __syncthreads();             // the ring is free for the output tile

  // rounded, + bproj in bf16, into the output tile; then each row to its
  // window row or pixel in 16-byte stores
  bf16* os = ring;
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
    const int col = nt * 8 + 2 * tq;
    const float b0 = n0 + col < C ? round_bf16(bproj[n0 + col]) : 0.0f;
    const float b1 = n0 + col < C ? round_bf16(bproj[n0 + col + 1]) : 0.0f;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<unsigned*>(os + (row0 + 8 * i) * OLD + col) =
          pack_bf16(__fadd_rn(round_bf16(acc[nt][2 * i]), b0),
                    __fadd_rn(round_bf16(acc[nt][2 * i + 1]), b1));
  }
  __syncthreads();
  for (int e = tid; e < BM * (BN / 8); e += THREADS) {
    const int r = e / (BN / 8), c = e % (BN / 8);
    if (orow[r] >= 0 && n0 + c * 8 < C)
      *reinterpret_cast<uint4*>(out + (size_t)orow[r] * C + n0 + c * 8) =
          *reinterpret_cast<const uint4*>(os + r * OLD + c * 8);
  }
}

}  // namespace proj

// what a launch needs to know of the current device, found once a
// device (the kernels' shared-memory attributes set on the way): its SM
// count and kernel A's resident blocks an SM (v1, v2)
struct DeviceInfo {
  int sms = 0;
  int per_sm[2] = {0, 0};
};

inline cudaError_t device_info(const DeviceInfo** out) {
  constexpr int MAX_DEVICES = 64;
  static DeviceInfo info[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  DeviceInfo& d = info[dev];
  if (d.sms == 0) {
    const void* kernels[2] = {
        reinterpret_cast<const void*>(qa::qkv_attend_kernel<false>),
        reinterpret_cast<const void*>(qa::qkv_attend_kernel<true>)};
    int sms = 0, per_sm[2] = {0, 0};
    for (int v = 0; v < 2 && err == cudaSuccess; ++v) {
      err = cudaFuncSetAttribute(kernels[v],
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)qa::SMEM);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm[v], kernels[v], qa::THREADS, qa::SMEM);
    }
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          reinterpret_cast<const void*>(proj::proj_kernel),
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)proj::SMEM);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (per_sm[0] <= 0 || per_sm[1] <= 0) return cudaErrorInvalidConfiguration;
    d.per_sm[0] = per_sm[0];
    d.per_sm[1] = per_sm[1];
    d.sms = sms;
  }
  *out = &d;
  return cudaSuccess;
}

// wqkv, wproj: the packed weights (see window_attention.py `pack_wqkv`,
// `pack_wproj`). Kernel A's grid: one wave of resident blocks spread over
// the h heads, at most one block a window group.
int launch(const bf16* x, const int* rows, const bf16* wqkv,
           const float* bqkv, const bf16* wproj, const float* bproj,
           const float* pos_bias, const float* v2_scale, bf16* attn,
           bf16* out, int Bw, int N, int C, int h, int ws, int nWh, int nWw,
           int shift_h, int shift_w, float v1_scale, cudaStream_t stream) {
  const DeviceInfo* d = nullptr;
  cudaError_t err = device_info(&d);
  if (err != cudaSuccess) return (int)err;
  const bool v2 = v2_scale != nullptr;
  const int groups = (Bw + qa::WPB - 1) / qa::WPB;
  const int gx = d->sms * d->per_sm[v2] / h;
  const dim3 grid(gx < 1 ? 1 : (gx > groups ? groups : gx), h);
  if (v2)
    qa::qkv_attend_kernel<true><<<grid, qa::THREADS, qa::SMEM, stream>>>(
        x, rows, wqkv, bqkv, pos_bias, v2_scale, attn, Bw, N, C, ws, nWh,
        nWw, shift_h, shift_w, v1_scale);
  else
    qa::qkv_attend_kernel<false><<<grid, qa::THREADS, qa::SMEM, stream>>>(
        x, rows, wqkv, bqkv, pos_bias, v2_scale, attn, Bw, N, C, ws, nWh,
        nWw, shift_h, shift_w, v1_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int M = Bw * N;
  proj::proj_kernel<<<dim3((C + proj::BN - 1) / proj::BN,
                           (M + proj::BM - 1) / proj::BM),
                      proj::THREADS, proj::SMEM, stream>>>(
      attn, rows, wproj, bproj, out, M, N, C);
  return (int)cudaGetLastError();
}

}  // namespace tc

template <typename T>
int launch(const void* x, const int* rows, const void* wqkv,
           const float* bqkv, const void* wproj, const float* bproj,
           const float* pos_bias, const float* v2_scale, void* attn,
           void* out, int Bw, int N, int C, int n_heads, int ws, int nWh,
           int nWw, int shift_h, int shift_w, int img_h, int img_w,
           float v1_scale, cudaStream_t stream) {
  if (Bw <= 0) return (int)cudaSuccess;
  if (N <= 0 || N > NMAX || ws * ws != N || C != n_heads * D)
    return (int)cudaErrorInvalidValue;
  if constexpr (sizeof(T) == 2) {
    return tc::launch(static_cast<const T*>(x), rows,
                      static_cast<const T*>(wqkv), bqkv,
                      static_cast<const T*>(wproj), bproj, pos_bias, v2_scale,
                      static_cast<T*>(attn), static_cast<T*>(out), Bw, N, C,
                      n_heads, ws, nWh, nWw, shift_h, shift_w, v1_scale,
                      stream);
  } else {
    window_attention_block_kernel<T><<<Bw, THREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(wqkv), bqkv,
        static_cast<const T*>(wproj), bproj, pos_bias, v2_scale,
        static_cast<T*>(attn), static_cast<T*>(out), N, C, n_heads, ws, nWh,
        nWw, shift_h, shift_w, img_h, img_w, v1_scale);
    return (int)cudaGetLastError();
  }
}

}  // namespace

#define WAB_ENTRY(NAME, T)                                                    \
  extern "C" int NAME(const void* x, const int* rows, const void* wqkv,      \
                      const float* bqkv, const void* wproj,                  \
                      const float* bproj, const float* pos_bias,             \
                      const float* v2_scale, void* attn, void* out, int Bw,  \
                      int N, int C, int n_heads, int ws, int nWh, int nWw,   \
                      int shift_h, int shift_w, int img_h, int img_w,        \
                      float v1_scale, void* stream) {                        \
    return launch<T>(x, rows, wqkv, bqkv, wproj, bproj, pos_bias, v2_scale,  \
                     attn, out, Bw, N, C, n_heads, ws, nWh, nWw, shift_h,    \
                     shift_w, img_h, img_w, v1_scale,                        \
                     static_cast<cudaStream_t>(stream));                     \
  }

WAB_ENTRY(window_attention_block_f32, float)
WAB_ENTRY(window_attention_block_bf16, __nv_bfloat16)

// resident blocks an SM of the two bf16 kernels, v2 (reported by
// chip_smoke.py); -1 on an error
extern "C" int window_attention_block_qkv_attend_blocks_per_sm() {
  const tc::DeviceInfo* d = nullptr;
  return tc::device_info(&d) == cudaSuccess ? d->per_sm[1] : -1;
}

extern "C" int window_attention_block_proj_blocks_per_sm() {
  const tc::DeviceInfo* d = nullptr;
  int per_sm = 0;
  if (tc::device_info(&d) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, tc::proj::proj_kernel, tc::proj::THREADS,
          tc::proj::SMEM) != cudaSuccess)
    return -1;
  return per_sm;
}
