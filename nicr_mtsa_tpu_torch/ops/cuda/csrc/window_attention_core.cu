// Window-attention core with its flash-style backward for Hopper (sm_90a).
//
// Replaces the TPU kernels of nicr_mtsa_tpu/ops/pallas/window_attention.py
// `fused_window_attention` (the training path): the forward `_fwd_call`
// and the backward `_bwd_call` of its custom VJP. For windows q, k, v of
// N <= 64 tokens and width C = 32 h, per head j (columns 32 j .. 32 j + 31):
//   L = q_j . k_j^T (f32) + bias_j + shift mask (-100 between regions),
//   P = softmax(L) in f32, rounded to T; out_j = P . v_j rounded to T;
//   lse = max(L) + log(sum exp(L - max)), f32, laid out (Bw, h, N).
// q already carries the scale (v2: the cosine normalisation and the logit
// scale are applied outside). The backward recomputes L and follows the
// TPU kernel's rounding points:
//   P32 = exp(L - lse) (f32), P = P32 rounded to T;
//   dV = P^T dO; dP = dO V^T (f32); delta_n = sum_m P32 dP (over keys);
//   dS = P32 (dP - delta) (f32); dbias += dS;
//   dQ = dS_T K, dK = dS_T^T Q with dS_T = dS rounded to T;
//   dq, dk, dv rounded to T.
//
// The shift mask is not read: each token's shift region comes from the
// window's position on the padded image's window grid (windows in
// image-major, then row-major grid order) and the token's coordinates,
// the rule of `shift_region_ids`. For v1's N = 49 the tokens >= N are
// left out inside the kernel (their tile rows are zero); no padded copy.
//
// dbias is deterministic: a backward block owns one head and a fixed
// range of `wpb` windows (`bwd_partition` in window_attention_core.py, a
// function of the shape alone), keeps the sum of its windows' dS in
// registers (in bf16 each thread owns the 32 (query, key) cells of its S
// fragments; in f32, 16 fixed cells) and writes it to its own slot of a
// (G, h, N, N) partial buffer; `wac_dbias_reduce` then sums the G
// partials of each cell in order 0 .. G-1. No float atomics: two runs
// give the same bits.
//
// What bounds it on an H100: bytes. Per window and head the forward moves
// 4 N 32 elements (q, k, v in, out) plus N lse floats for 4 N^2 32 flops,
// the backward 7 N 32 elements (q, k, v, dO in; dq, dk, dv out) plus N
// lse floats for 10 N^2 32 flops: ~16 operations a byte in bf16, far
// under the ~295 at which the tensor cores would bind. The backward's
// bounds at 3.35 TB/s over the four stages of B=8 480 x 640 training
// ((2400, 64, 128) to (48, 64, 1024) bf16): 0.0829, 0.0442, 0.0221 and
// 0.0133 ms; the forward's at stage 1 ~0.048 ms. The dbias reduction
// reads G h N^2 floats once (~2.6 us at stage 1).
//
// Design.
// - The bf16 forward is the forward tile of window_tiles.cuh (namespace
//   `fwd`): a warpgroup walks the windows of one head with the head's
//   bias in registers, a 2-stage cp.async ring ahead of mma.sync
//   products, S and P in registers, 16-byte output stores.
// - The bf16 backward (`wac_bwd_bf16_kernel`, replacing the TPU's
//   `_bwd_call`, nicr_mtsa_tpu/ops/pallas/window_attention.py:563) keeps
//   the backward's loads in flight and its intermediates out of shared
//   memory where it can. One warpgroup (128 threads) a block walks its
//   window range of one head while a 2-stage cp.async ring brings the
//   next window's q, k, v and dO tiles (its lse rows go straight to
//   registers); the head's bias is read once into shared memory, in
//   the order of the fragments each thread owns (16 KB, not registers:
//   32 dbias sums, P32 and dP already take 96), and the shift mask is
//   two 32-bit masks a thread, as in the forward. Each warp owns 16
//   query rows: S = q k^T and dP = dO v^T by mma.sync m16n8k16 fed by
//   ldmatrix land in the same accumulator layout, so P32 = exp(L - lse),
//   delta (quad shuffles over the row), dS and the dbias sums stay in
//   registers, and dQ = dS k takes dS as packed bf16 A fragments. P and
//   dS (bf16) go to shared memory once; after one barrier each warp
//   computes 16 key rows of dV = P^T dO and dK = dS^T q from them
//   (ldmatrix.trans), with no reduction across warps. dq, dk and dv
//   leave in 16-byte stores through the warp's own rows of the k and v
//   tiles, free by then. Two barriers a window; 74 KB of dynamic shared
//   memory and at most 168 registers, so 3 blocks (12 warps) an SM.
//   Rows >= N: their lse is taken as +inf and keys >= N are set to 0,
//   so their P32 and dS are exactly 0, and so are the rows >= N the
//   outputs stage through the tiles.
// - f32 (the card-vs-CPU check), forward and backward: one block a
//   (window, head) in the forward, a (window range, head) in the
//   backward, 256 threads, tiles, logits and products staged in shared
//   memory, fmaf loops on the CUDA cores (74 KB in the forward).
// - The dbias reduction: one thread a cell, adding its G partials in
//   order (~4-5 us of card time at every stage of B=8 480 x 640
//   training on an H100 80GB HBM3 at 700 W, below torch.sum's; a
//   two-level order that fills every SM was tried and gained nothing
//   over a training step, see PERF.md).
#include "window_tiles.cuh"

namespace {

using namespace window_tiles;

constexpr int OWN = NMAX * NMAX / THREADS;   // f32: cells a thread owns

constexpr size_t FWD_F32_SMEM = 3 * NMAX * HLD * 4 + NMAX * S_LD * 4 +
                                NMAX * P_LD * 4 + NMAX * O_LD * 4;

constexpr size_t BWD_F32_SMEM =
    4 * NMAX * HLD * 4 + 2 * NMAX * S_LD * 4 + 3 * NMAX * O_LD * 4;

// f32: grid (Bw, h), block (g, j) computes head j of window g
__global__ void __launch_bounds__(THREADS)
wac_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const float* __restrict__ bias, float* __restrict__ out,
                   float* __restrict__ lse, int N, int C, int ws, int nWh,
                   int nWw, int shift_h, int shift_w) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int region[NMAX];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + NMAX * HLD;
  float* Vs = Ks + NMAX * HLD;
  float* S = Vs + NMAX * HLD;
  float* P = S + NMAX * S_LD;
  float* O = P + NMAX * P_LD;

  const int g = blockIdx.x, j = blockIdx.y, h = gridDim.y;
  const bool masked = shift_h > 0 || shift_w > 0;
  load_tile(Qs, q, g, N, C, j * D);
  load_tile(Ks, k, g, N, C, j * D);
  load_tile(Vs, v, g, N, C, j * D);
  if (masked) window_regions(region, g, N, ws, nWh, nWw, shift_h, shift_w);
  __syncthreads();

  mm<false, true, NMAX, D>(Qs, HLD, Ks, HLD, S, S_LD);      // q . k^T
  __syncthreads();

  // + bias + mask, softmax over the keys of each query row, in f32
  softmax_rows(S, P, bias + (size_t)j * N * N, region, masked, N, 1.0f,
               lse + ((size_t)g * h + j) * N);
  __syncthreads();

  mm<false, false, D, NMAX>(P, P_LD, Vs, HLD, O, O_LD);     // P . v
  __syncthreads();
  store_tile(out, O, g, j, N, C);
}

// bf16: the forward tile, grid (windows of a head in turn, h)
__global__ void __launch_bounds__(fwd::THREADS, fwd::MIN_BLOCKS)
wac_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v,
                    const float* __restrict__ bias, bf16* __restrict__ out,
                    float* __restrict__ lse, int Bw, int N, int C, int ws,
                    int nWh, int nWw, int shift_h, int shift_w) {
  __shared__ __align__(128) unsigned char tiles[fwd::SMEM_ELEMS * 2];
  const int col = blockIdx.y * D;
  fwd::attend_windows<false, true>(
      reinterpret_cast<bf16*>(tiles), fwd::Cols{q + col, k + col, v + col, C},
      bias + (size_t)blockIdx.y * N * N, 1.0f, out + col, C, lse, Bw, N, ws,
      nWh, nWw, shift_h, shift_w);
}

// f32: grid (G, h), block (grp, j) runs head j of windows [grp wpb,
// (grp+1) wpb) and writes the sum of their dS to dbias_part[grp][j]
__global__ void __launch_bounds__(THREADS)
wac_bwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const float* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ bias, float* __restrict__ dq,
                   float* __restrict__ dk, float* __restrict__ dv,
                   float* __restrict__ dbias_part, int Bw, int N, int C,
                   int ws, int nWh, int nWw, int shift_h, int shift_w,
                   int wpb) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int region[NMAX];
  __shared__ float lse_s[NMAX];
  __shared__ float delta[NMAX];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + NMAX * HLD;
  float* Vs = Ks + NMAX * HLD;
  float* dOs = Vs + NMAX * HLD;
  float* S = dOs + NMAX * HLD;                  // L, then P32 (= P)
  float* dP = S + NMAX * S_LD;                  // dP, then dS
  float* Odv = dP + NMAX * S_LD;
  float* Odq = Odv + NMAX * O_LD;
  float* Odk = Odq + NMAX * O_LD;

  const int grp = blockIdx.x, j = blockIdx.y, h = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool masked = shift_h > 0 || shift_w > 0;
  const float* pb = bias + (size_t)j * N * N;
  float acc[OWN];
#pragma unroll
  for (int r = 0; r < OWN; ++r) acc[r] = 0.0f;

  const int g_end = min(Bw, (grp + 1) * wpb);
  for (int g = grp * wpb; g < g_end; ++g) {
    load_tile(Qs, q, g, N, C, j * D);
    load_tile(Ks, k, g, N, C, j * D);
    load_tile(Vs, v, g, N, C, j * D);
    load_tile(dOs, dout, g, N, C, j * D);
    if (tid < N) lse_s[tid] = lse[((size_t)g * h + j) * N + tid];
    if (masked) window_regions(region, g, N, ws, nWh, nWw, shift_h, shift_w);
    __syncthreads();

    mm<false, true, NMAX, D>(Qs, HLD, Ks, HLD, S, S_LD);    // q . k^T
    mm<false, true, NMAX, D>(dOs, HLD, Vs, HLD, dP, S_LD);  // dO . v^T
    __syncthreads();

    // P32 = exp(L - lse) over the cells this thread owns; 0 off the window
#pragma unroll
    for (int r = 0; r < OWN; ++r) {
      const int e = tid + r * THREADS, n = e / NMAX, m = e % NMAX;
      float p = 0.0f;
      if (n < N && m < N) {
        float x = __fadd_rn(S[n * S_LD + m], pb[n * N + m]);
        if (masked) x = __fadd_rn(x, region[n] == region[m] ? 0.0f : -100.0f);
        p = expf(__fsub_rn(x, lse_s[n]));
      }
      S[n * S_LD + m] = p;
    }
    __syncthreads();

    // delta_n = sum over keys of P32 dP, one warp per query row; dV = P^T dO
    for (int n = warp; n < NMAX; n += WARPS) {
      const float* s = S + n * S_LD;
      const float* dp = dP + n * S_LD;
      const float t = __fadd_rn(__fmul_rn(s[lane], dp[lane]),
                                __fmul_rn(s[lane + 32], dp[lane + 32]));
      const float sum = warp_sum(t);
      if (lane == 0) delta[n] = sum;
    }
    mm<true, false, D, NMAX>(S, S_LD, dOs, HLD, Odv, O_LD);
    __syncthreads();

    // dS = P32 (dP - delta), summed into the owned dbias cells
#pragma unroll
    for (int r = 0; r < OWN; ++r) {
      const int e = tid + r * THREADS, n = e / NMAX, m = e % NMAX;
      const float ds = __fmul_rn(S[n * S_LD + m],
                                 __fsub_rn(dP[n * S_LD + m], delta[n]));
      acc[r] = __fadd_rn(acc[r], ds);
      dP[n * S_LD + m] = ds;
    }
    __syncthreads();

    mm<false, false, D, NMAX>(dP, S_LD, Ks, HLD, Odq, O_LD);  // dS . k
    mm<true, false, D, NMAX>(dP, S_LD, Qs, HLD, Odk, O_LD);   // dS^T . q
    __syncthreads();
    store_tile(dv, Odv, g, j, N, C);
    store_tile(dq, Odq, g, j, N, C);
    store_tile(dk, Odk, g, j, N, C);
    __syncthreads();             // the next window reuses every buffer
  }

  float* part = dbias_part + ((size_t)grp * h + j) * N * N;
#pragma unroll
  for (int r = 0; r < OWN; ++r) {
    const int e = tid + r * THREADS, n = e / NMAX, m = e % NMAX;
    if (n < N && m < N) part[n * N + m] = acc[r];
  }
}

// bf16: the backward tile, grid (G, h); block (grp, j) runs head j of
// windows [grp wpb, (grp+1) wpb) in order and writes the sum of their dS
// to dbias_part[grp][j]
__global__ void __launch_bounds__(bwd::THREADS, bwd::MIN_BLOCKS)
wac_bwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ bias, bf16* __restrict__ dq,
                    bf16* __restrict__ dk, bf16* __restrict__ dv,
                    float* __restrict__ dbias_part, int Bw, int N, int C,
                    int ws, int nWh, int nWw, int shift_h, int shift_w,
                    int wpb) {
  constexpr int THREADS = bwd::THREADS, STAGES = bwd::STAGES;
  constexpr int LD = bwd::LD, TILE = bwd::TILE, PLD = bwd::PLD;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);     // STAGES x (q, k, v, dO)
  bf16* Ps = ring + STAGES * 4 * TILE;            // P  [64][PLD], query-major
  bf16* dSs = Ps + NMAX * PLD;                    // dS [64][PLD]
  float2* cells = reinterpret_cast<float2*>(dSs + NMAX * PLD);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tq = lane & 3, row0 = warp * 16 + (lane >> 2);  // rows row0, +8
  const int grp = blockIdx.x, j = blockIdx.y, h = gridDim.y, col = j * D;
  const int g_begin = grp * wpb, g_end = min(Bw, g_begin + wpb);
  const bf16* const src[4] = {q + col, k + col, v + col, dout + col};

  // rows >= N of every tile stay zero (and so do the outputs staged
  // there: see the header)
  for (int e = tid; e < STAGES * 4 * (NMAX - N) * 4; e += THREADS) {
    const int t = e / ((NMAX - N) * 4), r = e % ((NMAX - N) * 4);
    *reinterpret_cast<uint4*>(ring + t * TILE + (N + (r >> 2)) * LD +
                              (r & 3) * 8) = make_uint4(0u, 0u, 0u, 0u);
  }
  bwd::issue_window(ring, src, C, g_begin, N);
  // the head's bias cells to shared memory, in fragment order (pairs of
  // keys); the shift-mask bits stay in registers
  fwd::HeadCells hc;
  fwd::load_head_cells(hc, bias + (size_t)j * N * N, row0, N, ws, shift_h,
                       shift_w);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      cells[(i * 8 + nt) * THREADS + tid] =
          make_float2(hc.pb[i][2 * nt], hc.pb[i][2 * nt + 1]);
  const float2* my_cells = cells + tid;
  // lse of rows row0 and row0 + 8 of window g; +inf for rows >= N, so
  // that their P32 is exp(-inf) = 0
  auto row_lse = [&](int g, float (&ls)[2]) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int n = row0 + 8 * i;
      ls[i] = n < N ? __ldg(lse + ((size_t)g * h + j) * N + n) : INFINITY;
    }
  };
  float ls[2];
  row_lse(g_begin, ls);
  float acc[8][4];                          // dbias sums, as S fragments
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;

  int s = 0;
  for (int g = g_begin; g < g_end; ++g, s ^= 1) {
    bf16* Qs = ring + s * 4 * TILE;
    bf16* Ks = Qs + TILE;
    bf16* Vs = Ks + TILE;
    const bf16* Ds = Vs + TILE;             // dO
    fwd::cp_async_wait_all();
    __syncthreads();              // this stage landed; the other is free
    float ls_next[2] = {0.0f, 0.0f};
    if (g + 1 < g_end) {
      bwd::issue_window(ring + (s ^ 1) * 4 * TILE, src, C, g + 1, N);
      row_lse(g + 1, ls_next);
    }
    const int loc = g % (nWh * nWw);
    const bool edge_y = shift_h > 0 && loc / nWw == nWh - 1;
    const bool edge_x = shift_w > 0 && loc % nWw == nWw - 1;
    const unsigned maskbits =
        (edge_y ? hc.ydiff : 0u) | (edge_x ? hc.xdiff : 0u);

    // S = q k^T (16 rows x 64 keys a warp), then L and P32 in place
    unsigned fa[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      fwd::ldsm_x4(fa[kk], Qs + (warp * 16 + (lane & 15)) * LD + kk * 16 +
                               (lane >> 4) * 8);
    float p[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      unsigned kb[4];
      fwd::ldsm_x4(kb, Ks + (nt * 8 + (lane & 7)) * LD + (lane >> 3) * 8);
      p[nt][0] = p[nt][1] = p[nt][2] = p[nt][3] = 0.0f;
      fwd::mma(p[nt], fa[0], kb[0], kb[1]);
      fwd::mma(p[nt], fa[1], kb[2], kb[3]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float2 b = my_cells[(i * 8 + nt) * THREADS];
        p[nt][2 * i] = __fadd_rn(p[nt][2 * i], b.x);
        p[nt][2 * i + 1] = __fadd_rn(p[nt][2 * i + 1], b.y);
      }
    if (maskbits != 0u) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            if ((maskbits >> (i * 16 + nt * 2 + c)) & 1u)
              p[nt][2 * i + c] = __fadd_rn(p[nt][2 * i + c], -100.0f);
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          p[nt][2 * i + c] = expf(__fsub_rn(p[nt][2 * i + c], ls[i]));
    if (N < NMAX) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          if (nt * 8 + 2 * tq + c >= N) p[nt][c] = p[nt][2 + c] = 0.0f;
    }
    // P = P32 rounded to bf16, for dV after the barrier
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<unsigned*>(Ps + (row0 + 8 * i) * PLD + nt * 8 +
                                     2 * tq) =
            fwd::pack_bf16(p[nt][2 * i], p[nt][2 * i + 1]);

    // dP = dO v^T, in the layout of S
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      fwd::ldsm_x4(fa[kk], Ds + (warp * 16 + (lane & 15)) * LD + kk * 16 +
                               (lane >> 4) * 8);
    float dp[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      unsigned vb[4];
      fwd::ldsm_x4(vb, Vs + (nt * 8 + (lane & 7)) * LD + (lane >> 3) * 8);
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.0f;
      fwd::mma(dp[nt], fa[0], vb[0], vb[1]);
      fwd::mma(dp[nt], fa[1], vb[2], vb[3]);
    }

    // delta = sum over keys of P32 dP (a quad a row); dS = P32 (dP -
    // delta) in f32, summed into dbias and rounded to bf16: the A
    // fragments of dS k, and dS to shared memory for dK
    float dl[2] = {0.0f, 0.0f};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          dl[i] = __fadd_rn(dl[i], __fmul_rn(p[nt][2 * i + c],
                                             dp[nt][2 * i + c]));
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      dl[i] = __fadd_rn(dl[i], __shfl_xor_sync(0xffffffffu, dl[i], 1));
      dl[i] = __fadd_rn(dl[i], __shfl_xor_sync(0xffffffffu, dl[i], 2));
    }
    unsigned sa[4][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float ds[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          ds[c] = __fmul_rn(p[nt][2 * i + c],
                            __fsub_rn(dp[nt][2 * i + c], dl[i]));
          acc[nt][2 * i + c] = __fadd_rn(acc[nt][2 * i + c], ds[c]);
        }
        const unsigned packed = fwd::pack_bf16(ds[0], ds[1]);
        sa[nt >> 1][(nt & 1) * 2 + i] = packed;
        *reinterpret_cast<unsigned*>(dSs + (row0 + 8 * i) * PLD + nt * 8 +
                                     2 * tq) = packed;
      }

    // dQ = dS k (k by ldmatrix.trans, as the forward reads v)
    float o[4][4];
#pragma unroll
    for (int nd = 0; nd < 4; ++nd)
      o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int pp = 0; pp < 2; ++pp) {
        unsigned kb[4];
        fwd::ldsm_x4_t(kb, Ks + (kk * 16 + (lane & 15)) * LD +
                               (2 * pp + (lane >> 4)) * 8);
        fwd::mma(o[2 * pp], sa[kk], kb[0], kb[1]);
        fwd::mma(o[2 * pp + 1], sa[kk], kb[2], kb[3]);
      }
    __syncthreads();      // P and dS whole; no warp reads k or v any more
    fwd::store_rows(o, Ks, warp, dq + col, C, g, N);
    bwd::product_tn(Ps, Ds, warp, o);            // dV = P^T dO, key rows
    fwd::store_rows(o, Vs, warp, dv + col, C, g, N);
    bwd::product_tn(dSs, Qs, warp, o);           // dK = dS^T q, key rows
    __syncwarp();                           // the dq stores read Ks
    fwd::store_rows(o, Ks, warp, dk + col, C, g, N);
    ls[0] = ls_next[0];
    ls[1] = ls_next[1];
  }

  float* part = dbias_part + ((size_t)grp * h + j) * N * N;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int n = row0 + 8 * i, m = nt * 8 + 2 * tq + c;
        if (n < N && m < N) part[n * N + m] = acc[nt][2 * i + c];
      }
}

// out[i] = sum over g = 0 .. G-1 (in that order) of part[g][i]
__global__ void dbias_reduce_kernel(const float* __restrict__ part,
                                    float* __restrict__ out, int G,
                                    int total) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = 0.0f;
  for (int g = 0; g < G; ++g) s = __fadd_rn(s, part[(size_t)g * total + i]);
  out[i] = s;
}

int forward_f32(const float* q, const float* k, const float* v,
                const float* bias, float* out, float* lse, int Bw, int N,
                int C, int h, int ws, int nWh, int nWw, int shift_h,
                int shift_w, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      wac_fwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)FWD_F32_SMEM);
  if (err != cudaSuccess) return (int)err;
  wac_fwd_f32_kernel<<<dim3(Bw, h), THREADS, FWD_F32_SMEM, stream>>>(
      q, k, v, bias, out, lse, N, C, ws, nWh, nWw, shift_h, shift_w);
  return (int)cudaGetLastError();
}

int forward_bf16(const bf16* q, const bf16* k, const bf16* v,
                 const float* bias, bf16* out, float* lse, int Bw, int N,
                 int C, int h, int ws, int nWh, int nWw, int shift_h,
                 int shift_w, cudaStream_t stream) {
  dim3 grid;
  cudaError_t err = fwd::grid_for(wac_fwd_bf16_kernel, Bw, h, &grid);
  if (err != cudaSuccess) return (int)err;
  wac_fwd_bf16_kernel<<<grid, fwd::THREADS, 0, stream>>>(
      q, k, v, bias, out, lse, Bw, N, C, ws, nWh, nWw, shift_h, shift_w);
  return (int)cudaGetLastError();
}

template <typename E>
int forward(const void* q, const void* k, const void* v, const float* bias,
            void* out, float* lse, int Bw, int N, int C, int h, int ws,
            int nWh, int nWw, int shift_h, int shift_w, cudaStream_t stream) {
  if (Bw <= 0) return (int)cudaSuccess;
  if (bad_shape(N, C, h, ws)) return (int)cudaErrorInvalidValue;
  const E* qe = static_cast<const E*>(q);
  const E* ke = static_cast<const E*>(k);
  const E* ve = static_cast<const E*>(v);
  E* oe = static_cast<E*>(out);
  if constexpr (std::is_same<E, bf16>::value)
    return forward_bf16(qe, ke, ve, bias, oe, lse, Bw, N, C, h, ws, nWh, nWw,
                        shift_h, shift_w, stream);
  else
    return forward_f32(qe, ke, ve, bias, oe, lse, Bw, N, C, h, ws, nWh, nWw,
                       shift_h, shift_w, stream);
}

template <typename E>
int backward(const void* q, const void* k, const void* v, const void* dout,
             const float* lse, const float* bias, void* dq, void* dk,
             void* dv, float* dbias_part, int Bw, int N, int C, int h,
             int ws, int nWh, int nWw, int shift_h, int shift_w, int wpb,
             cudaStream_t stream) {
  if (Bw <= 0) return (int)cudaSuccess;
  if (bad_shape(N, C, h, ws) || wpb <= 0) return (int)cudaErrorInvalidValue;
  constexpr bool BF16 = std::is_same<E, bf16>::value;
  void (*kernel)(const E*, const E*, const E*, const E*, const float*,
                 const float*, E*, E*, E*, float*, int, int, int, int, int,
                 int, int, int, int);
  if constexpr (BF16)
    kernel = wac_bwd_bf16_kernel;
  else
    kernel = wac_bwd_f32_kernel;
  const size_t smem = BF16 ? bwd::SMEM : BWD_F32_SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int G = (Bw + wpb - 1) / wpb;
  kernel<<<dim3(G, h), BF16 ? bwd::THREADS : THREADS, smem, stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(k),
      static_cast<const E*>(v), static_cast<const E*>(dout), lse, bias,
      static_cast<E*>(dq), static_cast<E*>(dk), static_cast<E*>(dv),
      dbias_part, Bw, N, C, ws, nWh, nWw, shift_h, shift_w, wpb);
  return (int)cudaGetLastError();
}

}  // namespace

#define WAC_ENTRIES(SUFFIX, E)                                                \
  extern "C" int wac_forward_##SUFFIX(                                        \
      const void* q, const void* k, const void* v, const float* bias,         \
      void* out, float* lse, int Bw, int N, int C, int h, int ws, int nWh,    \
      int nWw, int shift_h, int shift_w, void* stream) {                      \
    return forward<E>(q, k, v, bias, out, lse, Bw, N, C, h, ws, nWh, nWw,     \
                      shift_h, shift_w, static_cast<cudaStream_t>(stream));   \
  }                                                                           \
  extern "C" int wac_backward_##SUFFIX(                                       \
      const void* q, const void* k, const void* v, const void* dout,          \
      const float* lse, const float* bias, void* dq, void* dk, void* dv,      \
      float* dbias_part, int Bw, int N, int C, int h, int ws, int nWh,        \
      int nWw, int shift_h, int shift_w, int wpb, void* stream) {             \
    return backward<E>(q, k, v, dout, lse, bias, dq, dk, dv, dbias_part, Bw,  \
                       N, C, h, ws, nWh, nWw, shift_h, shift_w, wpb,          \
                       static_cast<cudaStream_t>(stream));                    \
  }

WAC_ENTRIES(f32, float)
WAC_ENTRIES(bf16, __nv_bfloat16)

extern "C" int wac_dbias_reduce(const float* part, float* out, int G,
                                int total, void* stream) {
  if (total <= 0) return (int)cudaSuccess;
  if (G <= 0) return (int)cudaErrorInvalidValue;
  dbias_reduce_kernel<<<(total + 255) / 256, 256, 0,
                        static_cast<cudaStream_t>(stream)>>>(part, out, G,
                                                             total);
  return (int)cudaGetLastError();
}

// resident blocks an SM of the bf16 forward and backward, reported by
// chip_smoke.py; -1 on an error
extern "C" int wac_forward_bf16_blocks_per_sm() {
  return fwd::blocks_per_sm(wac_fwd_bf16_kernel);
}

extern "C" int wac_backward_bf16_blocks_per_sm() {
  int per_sm = 0;
  if (cudaFuncSetAttribute(wac_bwd_bf16_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bwd::SMEM) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, wac_bwd_bf16_kernel, bwd::THREADS, bwd::SMEM) !=
          cudaSuccess)
    return -1;
  return per_sm;
}
