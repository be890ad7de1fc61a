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
// range of `wpb` windows, keeps the sum of its windows' dS in registers
// (each thread owns 16 fixed (query, key) cells) and writes it to its own
// slot of a (G, h, N, N) partial buffer; `wac_dbias_reduce` then sums the
// G partials of each cell in order 0 .. G-1. No float atomics: two runs
// give the same bits.
//
// What bounds it on an H100: bytes. Per window and head the forward moves
// 4 N 32 elements (q, k, v in, out) plus N lse floats for 4 N^2 32 flops,
// the backward 7 N 32 elements for 10 N^2 32 flops: ~16 operations a byte
// in bf16, far under the ~295 at which the tensor cores would bind. At
// stage 1 of B=8 480 x 640 training ((2400, 64, 128) bf16) the forward's
// bound is ~0.048 ms at 3.35 TB/s, the backward's ~0.083 ms. The dbias
// reduction reads G h N^2 floats once (8.8 MB at stage 1, ~2.6 us).
//
// Design.
// - The bf16 forward is the forward tile of window_tiles.cuh (namespace
//   `fwd`): a warpgroup walks the windows of one head with the head's
//   bias in registers, a 2-stage cp.async ring ahead of mma.sync
//   products, S and P in registers, 16-byte output stores.
// - The backward: one block of 256 threads (8 warps) per (window range,
//   head); the head's q, k, v and dO tiles are loaded once into shared
//   memory (16-byte loads, rows >= N zero), the logits, probabilities and
//   dS live in shared memory; bf16 products on the tensor cores (wmma
//   16x16x16, f32 accumulators), each warp owning whole 16 x 16 output
//   tiles; 99 KB of dynamic shared memory.
// - f32 (the card-vs-CPU check), forward and backward: that structure
//   with fmaf loops on the CUDA cores (74 KB in the forward).
// - The dbias reduction: one thread a cell, adding its G partials in
//   order (~4-5 us of card time at every stage of B=8 480 x 640
//   training on an H100 80GB HBM3 at 700 W, below torch.sum's; a
//   two-level order that fills every SM was tried and gained nothing
//   over a training step, see PERF.md).
#include "window_tiles.cuh"

namespace {

using namespace window_tiles;

constexpr int OWN = NMAX * NMAX / THREADS;   // (query, key) cells a thread owns

constexpr size_t FWD_F32_SMEM = 3 * NMAX * HLD * 4 + NMAX * S_LD * 4 +
                                NMAX * P_LD * 4 + NMAX * O_LD * 4;

template <typename E>
constexpr size_t bwd_smem_bytes() {
  return 4 * NMAX * HLD * sizeof(E) + 2 * NMAX * S_LD * 4 +
         2 * NMAX * P_LD * sizeof(E) + 3 * NMAX * O_LD * 4;
}

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

// grid (G, h): block (grp, j) runs head j of windows [grp wpb, (grp+1) wpb)
// and writes the sum of their dS to dbias_part[grp][j]
template <typename E>
__global__ void __launch_bounds__(THREADS)
wac_bwd_kernel(const E* __restrict__ q, const E* __restrict__ k,
               const E* __restrict__ v, const E* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ bias,
               E* __restrict__ dq, E* __restrict__ dk, E* __restrict__ dv,
               float* __restrict__ dbias_part, int Bw, int N, int C, int ws,
               int nWh, int nWw, int shift_h, int shift_w, int wpb) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int region[NMAX];
  __shared__ float lse_s[NMAX];
  __shared__ float delta[NMAX];
  E* Qs = reinterpret_cast<E*>(smem);
  E* Ks = Qs + NMAX * HLD;
  E* Vs = Ks + NMAX * HLD;
  E* dOs = Vs + NMAX * HLD;
  float* S = reinterpret_cast<float*>(dOs + NMAX * HLD);   // L, then P32
  float* dP = S + NMAX * S_LD;
  E* P = reinterpret_cast<E*>(dP + NMAX * S_LD);
  E* dS = P + NMAX * P_LD;
  float* Odv = reinterpret_cast<float*>(dS + NMAX * P_LD);
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
      P[n * P_LD + m] = from_f32<E>(p);
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
    mm<true, false, D, NMAX>(P, P_LD, dOs, HLD, Odv, O_LD);
    __syncthreads();

    // dS = P32 (dP - delta), summed into the owned dbias cells
#pragma unroll
    for (int r = 0; r < OWN; ++r) {
      const int e = tid + r * THREADS, n = e / NMAX, m = e % NMAX;
      const float ds = __fmul_rn(S[n * S_LD + m],
                                 __fsub_rn(dP[n * S_LD + m], delta[n]));
      acc[r] = __fadd_rn(acc[r], ds);
      dS[n * P_LD + m] = from_f32<E>(ds);
    }
    __syncthreads();

    mm<false, false, D, NMAX>(dS, P_LD, Ks, HLD, Odq, O_LD);  // dS . k
    mm<true, false, D, NMAX>(dS, P_LD, Qs, HLD, Odk, O_LD);   // dS^T . q
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
  const size_t smem = bwd_smem_bytes<E>();
  cudaError_t err = cudaFuncSetAttribute(
      wac_bwd_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int G = (Bw + wpb - 1) / wpb;
  wac_bwd_kernel<E><<<dim3(G, h), THREADS, smem, stream>>>(
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

// resident blocks an SM of the bf16 forward, reported by chip_smoke.py
extern "C" int wac_forward_bf16_blocks_per_sm() {
  return fwd::blocks_per_sm(wac_fwd_bf16_kernel);
}
