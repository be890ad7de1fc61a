// Per-(window, head) tiles of the window-attention kernels for Hopper
// (sm_90a): shared by window_attention_core.cu (the training forward and
// backward), window_attention_qkv.cu (serving over the packed qkv) and
// window_attention_block.cu (the whole sub-block: its bf16 kernel runs
// `attend_rows` on the q, k and v it computes itself).
//
// Two designs live here.
//
// The bf16 forward (namespace `fwd`: row 9 and row 7's forward). It is
// bound by bytes (~16 operations a byte against the ~295 at which an
// H100's tensor cores would bind), so it keeps loads in flight and every
// intermediate in registers:
// - one warpgroup (4 warps, 128 threads) a block, one head a block; the
//   block walks the windows g = blockIdx.x, + gridDim.x, ... of head
//   blockIdx.y, on a grid sized to one wave of resident blocks;
// - the head's (N, N) f32 bias is read once a block into registers, in
//   the order of the logit fragments each thread owns (32 cells), and
//   the shift mask becomes two 32-bit masks a thread (which of its cells
//   differ in row or in column region), applied per window from its grid
//   position;
// - a 2-stage cp.async ring (16-byte cp.async.cg) brings window g+1's
//   q, k and v tiles ([64][40] bf16, 80-byte rows: ldmatrix is
//   conflict-free) while window g computes: 30 KB of shared memory;
// - each warp owns 16 query rows: S = q k^T by mma.sync m16n8k16 (bf16
//   in, f32 out) fed by ldmatrix, a whole row of S in registers (a window
//   has at most 64 keys: no online softmax), max and sum over quad
//   shuffles, P = e / s in f32 rounded to bf16 and packed straight into
//   the A fragments of P v (v by ldmatrix.trans); O rounded to bf16 and
//   written with 16-byte stores through the warp's own q rows.
//
// The bf16 backward (namespace `bwd`: row 7's backward) starts from the
// forward tile: one warpgroup a block, one head a block, a 2-stage
// cp.async ring of q, k, v and dO tiles, each warp owning 16 query rows
// for the products that contract over the keys (S, dP and dQ, with P32,
// delta and dS in registers); the two that contract over the query rows
// (dV = P^T dO, dK = dS^T q) read P and dS from shared memory, each warp
// computing 16 key rows (`product_tn`). See window_attention_core.cu.
//
// The f32 paths (the card-vs-CPU checks) keep the first design: a block
// of THREADS threads owns one head (32 columns) of one window of N <= 64
// tokens; its tiles live in shared memory as [64][ld] arrays, rows >= N
// zero; products are fmaf chains on the CUDA cores.
//
// The shift mask is never read: each token's shift region comes from the
// window's position on the padded image's window grid (windows in
// image-major, then row-major grid order) and the token's coordinates,
// the rule of `shift_region_ids` (per axis, positions below n - ws are
// region 0, below n - shift region 1, the rest region 2; an axis with no
// shift is all region 2), and -100 is added between different regions.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
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
constexpr int P_LD = NMAX + 8;            // P, dS               [64][72]
constexpr int O_LD = D + 4;               // f32 product staging [64][36]

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

// f32 columns col .. col + 31 of window g's N rows of a (Bw, N, ld)
// tensor into a [64][HLD] shared tile, rows >= N zero; 16-byte loads
// (col and ld multiples of 4, the tensor 16-byte aligned)
__device__ __forceinline__ void load_tile(float* dst,
                                          const float* __restrict__ src,
                                          int g, int N, int ld, int col) {
  constexpr int PER = 4;                  // floats per 16-byte vector
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

// rows < N of a [64][O_LD] f32 staging tile into head j's columns of
// window g of a (Bw, N, C) f32 tensor
__device__ __forceinline__ void store_tile(float* __restrict__ dst,
                                           const float* src, int g, int j,
                                           int N, int C) {
  for (int e = threadIdx.x; e < N * D; e += THREADS) {
    const int n = e / D, d = e % D;
    dst[((size_t)g * N + n) * C + j * D + d] = src[n * O_LD + d];
  }
}

// C (64 x NC, f32, row-major ldc) = A . B, A (64 x K), B (K x NC):
// A[i][k] at a[i lda + k] (A_COL: a[k lda + i]), B[k][j] at b[k ldb + j]
// (B_COL: b[j ldb + k]); one output cell per thread and step, fmaf over
// k in order.
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

// Softmax over the keys of each query row, one warp a row: the logits
// l = S x scale + pb (the head's (N, N) position bias) + the shift mask
// (when `masked`), max, e = exp(l - max), s = sum e, P = e / s in f32;
// rows >= N of P zero. With lse, lse[n] = max + log(s). A scale of 1
// leaves S as it is (x 1 is exact). The f32 forwards' softmax.
__device__ __forceinline__ void softmax_rows(const float* S, float* P,
                                             const float* pb,
                                             const int* region, bool masked,
                                             int N, float scale,
                                             float* lse) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int n = warp; n < NMAX; n += WARPS) {
    float* prow = P + n * P_LD;
    if (n >= N) {
      prow[lane] = prow[lane + 32] = 0.0f;
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
    prow[lane] = __fdiv_rn(e0, s);
    prow[lane + 32] = __fdiv_rn(e1, s);
    if (lse != nullptr && lane == 0) lse[n] = __fadd_rn(mx, logf(s));
  }
}

inline bool bad_shape(int N, int C, int h, int ws) {
  return N <= 0 || N > NMAX || ws * ws != N || h <= 0 || C != h * D;
}

// ---------------------------------------------------------------------
// The bf16 forward tile (see the header): rows 7 and 9.
namespace fwd {

constexpr int THREADS = 128;              // one warpgroup, 16 query rows a warp
constexpr int MIN_BLOCKS = 4;             // resident blocks an SM (register cap)
constexpr int LD = HLD;                   // [64][40] tiles, 80-byte rows
constexpr int TILE = NMAX * LD;           // elements of one tile
constexpr int STAGES = 2;
constexpr int SMEM_ELEMS = STAGES * 3 * TILE;   // q, k, v of each stage

// where one head's columns lie: window g's token n at p + (g N + n) ld
struct Cols {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  int ld;
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

// 16 bytes, or (full false) 16 zero bytes and no read of src
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// all but the newest `PENDING` committed groups have landed
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(PENDING) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)) : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)) : "memory");
}

// d += a . b, one m16n8k16 tile: bf16 in, f32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a / b rounded to nearest, from r = 1 / b rounded to nearest: q = a r,
// then one correction by the exact remainder a - q b (Markstein). This is
// the IEEE quotient wherever q and the remainder stay normal (checked
// against exact rounding), without the slow-path branch of __fdiv_rn,
// which kept the compiler from interleaving a row's 32 divisions.
__device__ __forceinline__ float div_by(float a, float b, float r) {
  const float q = __fmul_rn(a, r);
  return __fmaf_rn(__fmaf_rn(-q, b, a), r, q);
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// copies of window g's rows < N of the head's q, k and v columns into
// one stage (3 tiles); rows >= N are never written (zero from the start)
__device__ __forceinline__ void issue_window(bf16* stage, const Cols& c,
                                             int g, int N) {
  const bf16* src[3] = {c.q, c.k, c.v};
#pragma unroll
  for (int t = 0; t < 3; ++t)
    for (int e = threadIdx.x; e < N * 4; e += THREADS) {
      const int n = e >> 2, part = e & 3;
      cp_async16(stage + t * TILE + n * LD + part * 8,
                 src[t] + ((size_t)g * N + n) * c.ld + part * 8);
    }
  cp_async_commit();
}

// v2: the q and k rows of a stage divided by max(||row||, 1e-6) in f32,
// rounded to bf16, in place; 4 threads a row (a quad), 8 values each
__device__ __forceinline__ void unit_rows_qk(bf16* stage) {
#pragma unroll
  for (int u = 0; u < 2 * NMAX * 4 / THREADS; ++u) {
    const int e = threadIdx.x + u * THREADS;
    bf16* p = stage + (e >> 8) * TILE + ((e >> 2) & (NMAX - 1)) * LD +
              (e & 3) * 8;
    uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
    float f[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(h2[i]);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
    float ss = __fmul_rn(f[0], f[0]);
#pragma unroll
    for (int i = 1; i < 8; ++i) ss = __fadd_rn(ss, __fmul_rn(f[i], f[i]));
    ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, 1));
    ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, 2));
    const float den = fmaxf(sqrtf(ss), 1e-6f), r = __frcp_rn(den);
    unsigned* w = reinterpret_cast<unsigned*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = pack_bf16(div_by(f[2 * i], den, r),
                       div_by(f[2 * i + 1], den, r));
    *reinterpret_cast<uint4*>(p) = raw;
  }
}

// The head's (N, N) f32 bias cells that this thread's logit fragments
// hold (rows row0 and row0 + 8 of the window, row0 = 16 w + lane / 4
// for the window's warp w), and which of them straddle a row or a
// column shift-region boundary once a window lies on the grid's last
// row or column (bit i 16 + nt 2 + c: row row0 + 8 i, key 8 nt + 2 tq +
// c); cells of keys or rows >= N hold 0
struct HeadCells {
  float pb[2][16];
  unsigned ydiff, xdiff;
};

__device__ __forceinline__ void load_head_cells(
    HeadCells& hc, const float* __restrict__ bias, int row0, int N, int ws,
    int shift_h, int shift_w) {
  const int tq = threadIdx.x & 3;
  hc.ydiff = hc.xdiff = 0u;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int n = row0 + 8 * i;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int m = nt * 8 + 2 * tq + c, b = i * 16 + nt * 2 + c;
        const bool ok = n < N && m < N;
        hc.pb[i][nt * 2 + c] = ok ? bias[n * N + m] : 0.0f;
        if (ok && ((n / ws < ws - shift_h) != (m / ws < ws - shift_h)))
          hc.ydiff |= 1u << b;
        if (ok && ((n % ws < ws - shift_w) != (m % ws < ws - shift_w)))
          hc.xdiff |= 1u << b;
      }
  }
}

// One window for this warp's 16 query rows row0 - lane / 4 + 0 .. 15:
// S = q k^T from qa (the rows' A fragments, keys 16 kk .. 16 kk + 15)
// and the [64][LD] k tile; L = S x scale + the bias cells (bias(i, k):
// cell k of row row0 + 8 i, as `HeadCells::pb` orders them), + -100 where
// `maskbits` has a bit (when `edge`: the window lies on the grid's last
// row or column), keys >= N out; P = softmax(L) (f32, e / s) rounded to
// bf16; o = P v (v a [64][LD] tile) in f32. With LSE, lse[n] = max +
// log(s) for rows n = row0, row0 + 8 below N. The shift mask and the
// keys >= N take passes of their own behind uniform branches: most
// windows need neither.
template <bool LSE, typename Bias>
__device__ __forceinline__ void attend_rows(
    const unsigned (&qa)[2][4], const bf16* Ks, const bf16* Vs,
    const Bias& bias, bool edge, unsigned maskbits, float scale, int N,
    int row0, float* __restrict__ lse, float (&o)[4][4]) {
  const int lane = threadIdx.x & 31, tq = lane & 3;
  float sc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    unsigned kb[4];
    ldsm_x4(kb, Ks + (nt * 8 + (lane & 7)) * LD + (lane >> 3) * 8);
    sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.0f;
    mma(sc[nt], qa[0], kb[0], kb[1]);
    mma(sc[nt], qa[1], kb[2], kb[3]);
  }

  // logits, then the softmax of rows row0 and row0 + 8 (a quad a row)
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        sc[nt][2 * i + c] = __fadd_rn(__fmul_rn(sc[nt][2 * i + c], scale),
                                      bias(i, nt * 2 + c));
  if (edge) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          if ((maskbits >> (i * 16 + nt * 2 + c)) & 1u)
            sc[nt][2 * i + c] = __fadd_rn(sc[nt][2 * i + c], -100.0f);
  }
  if (N < NMAX) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        if (nt * 8 + 2 * tq + c >= N)
          sc[nt][c] = sc[nt][2 + c] = -INFINITY;
  }
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      mx[i] = fmaxf(mx[i], fmaxf(sc[nt][2 * i], sc[nt][2 * i + 1]));
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
  }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        // keys >= N: exp(-inf) = 0
        const float e = expf(__fsub_rn(sc[nt][2 * i + c], mx[i]));
        sc[nt][2 * i + c] = e;
        sum[i] = __fadd_rn(sum[i], e);
      }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    sum[i] = __fadd_rn(sum[i], __shfl_xor_sync(0xffffffffu, sum[i], 1));
    sum[i] = __fadd_rn(sum[i], __shfl_xor_sync(0xffffffffu, sum[i], 2));
  }
  if (LSE && tq == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (row0 + 8 * i < N)
        lse[row0 + 8 * i] = __fadd_rn(mx[i], logf(sum[i]));
  }

  // P = e / s (f32, rounded to bf16) as the A fragments of P v: keys
  // 16 kk .. 16 kk + 15
  const float rs[2] = {__frcp_rn(sum[0]), __frcp_rn(sum[1])};
  unsigned pa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float* e = sc[2 * kk + half];
        pa[kk][half * 2 + i] = pack_bf16(div_by(e[2 * i], sum[i], rs[i]),
                                         div_by(e[2 * i + 1], sum[i], rs[i]));
      }
#pragma unroll
  for (int nd = 0; nd < 4; ++nd)
    o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      unsigned vb[4];
      ldsm_x4_t(vb, Vs + (kk * 16 + (lane & 15)) * LD +
                        (2 * p + (lane >> 4)) * 8);
      mma(o[2 * p], pa[kk], vb[0], vb[1]);
      mma(o[2 * p + 1], pa[kk], vb[2], vb[3]);
    }
}

// o (this warp's 16 rows x 32, f32) rounded to bf16 through rows 16 w ..
// 16 w + 15 of a [64][LD] tile the warp owns, then rows n < N in 16-byte
// stores to out + (g N + n) C
__device__ __forceinline__ void store_rows(const float (&o)[4][4], bf16* tile,
                                           int w, bf16* __restrict__ out,
                                           int C, int g, int N) {
  const int lane = threadIdx.x & 31, row0 = w * 16 + (lane >> 2);
#pragma unroll
  for (int nd = 0; nd < 4; ++nd)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<unsigned*>(tile + (row0 + 8 * i) * LD + nd * 8 +
                                   2 * (lane & 3)) =
          pack_bf16(o[nd][2 * i], o[nd][2 * i + 1]);
  __syncwarp();
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int e = lane + 32 * u, n = w * 16 + (e >> 2);
    if (n < N)
      *reinterpret_cast<uint4*>(out + ((size_t)g * N + n) * C + (e & 3) * 8) =
          *reinterpret_cast<const uint4*>(tile + n * LD + (e & 3) * 8);
  }
}

// One block's share of a launch: head j (blockIdx.y) of the windows
// g = blockIdx.x, + gridDim.x, ... < Bw. Per window: `attend_rows`
// (with LSE also lse into lse (Bw, h, N)) and the output's 16-byte
// stores through the warp's own q rows. UNIT_QK: q and k are first
// normalised per token (v2). `bias` is the head's (N, N) f32
// query-major; `out` points at the head's first column of a (Bw, N, C)
// tensor.
template <bool UNIT_QK, bool LSE>
__device__ __forceinline__ void attend_windows(
    bf16* tiles, const Cols cols, const float* __restrict__ bias,
    float scale, bf16* __restrict__ out, int C, float* __restrict__ lse,
    int Bw, int N, int ws, int nWh, int nWw, int shift_h, int shift_w) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j = blockIdx.y, h = gridDim.y;
  const int row0 = warp * 16 + (lane >> 2);   // rows row0 and row0 + 8

  // rows >= N of every tile stay zero: finite logits, P v = 0 off window
  for (int e = tid; e < STAGES * 3 * (NMAX - N) * 4; e += THREADS) {
    const int t = e / ((NMAX - N) * 4), r = e % ((NMAX - N) * 4);
    *reinterpret_cast<uint4*>(tiles + t * TILE + (N + (r >> 2)) * LD +
                              (r & 3) * 8) = make_uint4(0u, 0u, 0u, 0u);
  }
  issue_window(tiles, cols, blockIdx.x, N);
  HeadCells hc;
  load_head_cells(hc, bias, row0, N, ws, shift_h, shift_w);

  int s = 0;
  for (int g = blockIdx.x; g < Bw; g += gridDim.x, s ^= 1) {
    bf16* Qs = tiles + s * 3 * TILE;
    const bf16* Ks = Qs + TILE;
    const bf16* Vs = Ks + TILE;
    cp_async_wait_all();
    __syncthreads();              // this stage landed; the other is free
    if (g + (int)gridDim.x < Bw)
      issue_window(tiles + (s ^ 1) * 3 * TILE, cols, g + gridDim.x, N);
    if (UNIT_QK) {
      unit_rows_qk(Qs);
      __syncthreads();
    }
    const int loc = g % (nWh * nWw);
    const bool edge_y = shift_h > 0 && loc / nWw == nWh - 1;
    const bool edge_x = shift_w > 0 && loc % nWw == nWw - 1;

    unsigned qa[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      ldsm_x4(qa[kk], Qs + (warp * 16 + (lane & 15)) * LD + kk * 16 +
                          (lane >> 4) * 8);
    float o[4][4];
    attend_rows<LSE>(qa, Ks, Vs,
                     [&](int i, int k) { return hc.pb[i][k]; },
                     edge_y || edge_x,
                     (edge_y ? hc.ydiff : 0u) | (edge_x ? hc.xdiff : 0u),
                     scale, N, row0,
                     LSE ? lse + ((size_t)g * h + j) * N : nullptr, o);
    store_rows(o, Qs, warp, out, C, g, N);
  }
}

// The grid of a launch: one wave of resident blocks spread over the h
// heads, at most one block a window.
template <typename Kernel>
inline cudaError_t grid_for(Kernel kernel, int Bw, int h, dim3* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        THREADS, 0);
  if (err != cudaSuccess) return err;
  if (per_sm <= 0) return cudaErrorInvalidConfiguration;
  const int x = sms * per_sm / h;
  *grid = dim3(x < 1 ? 1 : (x > Bw ? Bw : x), h);
  return cudaSuccess;
}

// resident blocks an SM of a forward tile kernel (reported by
// chip_smoke.py); -1 on an error
template <typename Kernel>
inline int blocks_per_sm(Kernel kernel) {
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS,
                                                    0) != cudaSuccess)
    return -1;
  return per_sm;
}

}  // namespace fwd

// ---------------------------------------------------------------------
// The bf16 backward tile (see the header): row 7's backward.
namespace bwd {

constexpr int THREADS = 128;      // one warpgroup, 16 query rows a warp
constexpr int MIN_BLOCKS = 3;     // resident blocks an SM: <= 168 registers
constexpr int LD = HLD;           // q, k, v, dO tiles [64][40]
constexpr int TILE = NMAX * LD;
constexpr int STAGES = 2;
constexpr int PLD = P_LD;         // P and dS [64][72], 144-byte rows
constexpr int CELLS = 32 * THREADS;   // the head's bias cells, by thread
// the ring (q, k, v, dO of each stage), P, dS and the bias cells: 74 KB
constexpr size_t SMEM =
    (size_t)(STAGES * 4 * TILE + 2 * NMAX * PLD) * 2 + CELLS * 4;

// copies of window g's rows < N of the head's q, k, v and dO columns
// (src, each of row stride ld) into one stage (4 tiles); rows >= N are
// never written
__device__ __forceinline__ void issue_window(bf16* stage,
                                             const bf16* const (&src)[4],
                                             int ld, int g, int N) {
#pragma unroll
  for (int t = 0; t < 4; ++t)
    for (int e = threadIdx.x; e < N * 4; e += THREADS) {
      const int n = e >> 2, part = e & 3;
      fwd::cp_async16(stage + t * TILE + n * LD + part * 8,
                      src[t] + ((size_t)g * N + n) * ld + part * 8);
    }
  fwd::cp_async_commit();
}

// o (16 rows x 32, f32) = rows 16 w .. 16 w + 15 of A^T B for A a
// [64][PLD] tile and B a [64][LD] tile, contracting over all 64 rows of
// both (the query rows): A^T's fragments by ldmatrix.trans of A's
// columns, B's as the forward reads v
__device__ __forceinline__ void product_tn(const bf16* A, const bf16* B,
                                           int w, float (&o)[4][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int nd = 0; nd < 4; ++nd)
    o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    unsigned a[4];
    fwd::ldsm_x4_t(a, A + (kk * 16 + (lane & 7) + ((lane >> 4) << 3)) * PLD +
                          w * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      unsigned b[4];
      fwd::ldsm_x4_t(b, B + (kk * 16 + (lane & 15)) * LD +
                            (2 * p + (lane >> 4)) * 8);
      fwd::mma(o[2 * p], a, b[0], b[1]);
      fwd::mma(o[2 * p + 1], a, b[2], b[3]);
    }
  }
}

}  // namespace bwd

}  // namespace window_tiles
