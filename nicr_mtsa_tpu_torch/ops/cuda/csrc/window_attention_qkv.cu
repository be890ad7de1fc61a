// Shifted-window attention over the packed qkv tensor for Hopper (sm_90a).
//
// Replaces the TPU kernel nicr_mtsa_tpu/ops/pallas/window_attention.py
// `fused_window_attention_qkv` (-> `_fwd_call_qkv`, body
// `_make_fwd_kernel_qkv`), the serving path of `attn_backend='pallas-qkv'`:
// for windows of N <= 64 tokens and width C = 32 h, the qkv projection's
// output qkv (Bw, N, 3C), its last axis laid out (3, h, 32), gives per
// head j
//   q, k, v = columns j 32 .. j 32 + 31 of the q, k and v thirds;
//   v2: q and k divided per token by max(||.||, 1e-6) in f32, rounded to T;
//   L = q . k^T (f32) x scale (v2: the head's logit scale, v1: d^-0.5),
//       + the position bias + the shift mask (-100 between regions);
//   P = softmax(L) in f32 (e / s), rounded to T; out_j = P . v (f32),
//       rounded to T, into columns j 32 .. j 32 + 31 of out (Bw, N, C).
// Those are the TPU kernel's rounding points. Pad tokens of a padded
// image have k = 0 exactly (zero input, zeroed k bias): max(0, 1e-6)
// keeps their normalised k at 0, a finite logit as in the TPU kernel.
//
// The window pairing, the pattern-pair mask table and the pad to 64
// tokens of the TPU kernel are not carried over: the shift mask comes
// from the window's position on the padded image's window grid (see
// window_tiles.cuh) and v1's N = 49 windows run as they are (rows >= N
// of the tiles are zero and left out of the softmax).
//
// What bounds it on an H100: bytes. Per window and head it reads 3 N 32
// values and writes N 32 for 4 N^2 32 flops (QK^T and PV), ~16
// operations a byte in bf16, far under the ~295 at which the tensor cores
// would bind; at stage 1 of B=8 480 x 640 serving ((2400, 64, 384) bf16)
// that is ~157 MB, ~0.047 ms at 3.35 TB/s.
//
// Design.
// - bf16 (serving): the forward tile of window_tiles.cuh (namespace
//   `fwd`), row 7's forward read from the packed rows: a warpgroup walks
//   the windows of one head with the head's bias and logit scale in
//   registers; a 2-stage cp.async ring brings window g+1's q, k and v
//   columns while window g computes; once a stage lands, q and k are
//   normalised in place (a quad of threads a token, f32 sum of squares,
//   max(norm, 1e-6), rounded to bf16); then S = q k^T and P v by
//   mma.sync with S and P in registers, and 16-byte output stores.
// - f32 (the card-vs-CPU check): one block of 256 threads per (window,
//   head) loads the q, k and v tiles into shared memory (16-byte loads),
//   normalises q and k there (a warp a token, the sum of squares by
//   shuffles), keeps the logits and probabilities in shared memory and
//   runs the products as fmaf loops (74 KB of dynamic shared memory).
#include "window_tiles.cuh"

namespace {

using namespace window_tiles;

constexpr size_t F32_SMEM = 3 * NMAX * HLD * 4 + NMAX * S_LD * 4 +
                            NMAX * P_LD * 4 + NMAX * O_LD * 4;

// v2: rows < N of a [64][HLD] f32 tile divided by max(||row||, 1e-6);
// one warp a row, a lane a column
__device__ __forceinline__ void unit_rows(float* tile, int N) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int n = warp; n < N; n += WARPS) {
    float* row = tile + n * HLD;
    const float f = row[lane];
    const float nrm = sqrtf(warp_sum(__fmul_rn(f, f)));
    row[lane] = __fdiv_rn(f, fmaxf(nrm, 1e-6f));
  }
}

// f32: grid (Bw, h), block (g, j) computes head j of window g
__global__ void __launch_bounds__(THREADS)
waq_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ bias,
               const float* __restrict__ v2_scale, float* __restrict__ out,
               int N, int C, int ws, int nWh, int nWw, int shift_h,
               int shift_w, float v1_scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int region[NMAX];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + NMAX * HLD;
  float* Vs = Ks + NMAX * HLD;
  float* S = Vs + NMAX * HLD;
  float* P = S + NMAX * S_LD;
  float* O = P + NMAX * P_LD;

  const int g = blockIdx.x, j = blockIdx.y;
  const bool masked = shift_h > 0 || shift_w > 0;
  load_tile(Qs, qkv, g, N, 3 * C, j * D);
  load_tile(Ks, qkv, g, N, 3 * C, C + j * D);
  load_tile(Vs, qkv, g, N, 3 * C, 2 * C + j * D);
  if (masked) window_regions(region, g, N, ws, nWh, nWw, shift_h, shift_w);
  __syncthreads();
  if (v2_scale != nullptr) {
    unit_rows(Qs, N);
    unit_rows(Ks, N);
    __syncthreads();
  }

  mm<false, true, NMAX, D>(Qs, HLD, Ks, HLD, S, S_LD);      // q . k^T
  __syncthreads();
  softmax_rows(S, P, bias + (size_t)j * N * N, region, masked, N,
               v2_scale != nullptr ? v2_scale[j] : v1_scale, nullptr);
  __syncthreads();
  mm<false, false, D, NMAX>(P, P_LD, Vs, HLD, O, O_LD);     // P . v
  __syncthreads();
  store_tile(out, O, g, j, N, C);
}

// bf16: the forward tile, grid (windows of a head in turn, h); UNIT_QK
// for v2 (q and k normalised, the head's logit scale), else v1_scale
template <bool UNIT_QK>
__global__ void __launch_bounds__(fwd::THREADS, fwd::MIN_BLOCKS)
waq_bf16_kernel(const bf16* __restrict__ qkv, const float* __restrict__ bias,
                const float* __restrict__ v2_scale, bf16* __restrict__ out,
                int Bw, int N, int C, int ws, int nWh, int nWw, int shift_h,
                int shift_w, float v1_scale) {
  __shared__ __align__(128) unsigned char tiles[fwd::SMEM_ELEMS * 2];
  const int j = blockIdx.y, col = j * D;
  fwd::attend_windows<UNIT_QK, false>(
      reinterpret_cast<bf16*>(tiles), fwd::Cols{qkv + col, qkv + C + col, qkv + 2 * C + col, 3 * C},
      bias + (size_t)j * N * N, UNIT_QK ? v2_scale[j] : v1_scale, out + col,
      C, nullptr, Bw, N, ws, nWh, nWw, shift_h, shift_w);
}

int launch_f32(const float* qkv, const float* bias, const float* v2_scale,
               float* out, int Bw, int N, int C, int h, int ws, int nWh,
               int nWw, int shift_h, int shift_w, float v1_scale,
               cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      waq_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)F32_SMEM);
  if (err != cudaSuccess) return (int)err;
  waq_f32_kernel<<<dim3(Bw, h), THREADS, F32_SMEM, stream>>>(
      qkv, bias, v2_scale, out, N, C, ws, nWh, nWw, shift_h, shift_w,
      v1_scale);
  return (int)cudaGetLastError();
}

template <bool UNIT_QK>
int launch_bf16(const bf16* qkv, const float* bias, const float* v2_scale,
                bf16* out, int Bw, int N, int C, int h, int ws, int nWh,
                int nWw, int shift_h, int shift_w, float v1_scale,
                cudaStream_t stream) {
  dim3 grid;
  cudaError_t err = fwd::grid_for(waq_bf16_kernel<UNIT_QK>, Bw, h, &grid);
  if (err != cudaSuccess) return (int)err;
  waq_bf16_kernel<UNIT_QK><<<grid, fwd::THREADS, 0, stream>>>(
      qkv, bias, v2_scale, out, Bw, N, C, ws, nWh, nWw, shift_h, shift_w,
      v1_scale);
  return (int)cudaGetLastError();
}

template <typename E>
int launch(const void* qkv, const float* bias, const float* v2_scale,
           void* out, int Bw, int N, int C, int h, int ws, int nWh, int nWw,
           int shift_h, int shift_w, float v1_scale, cudaStream_t stream) {
  if (Bw <= 0) return (int)cudaSuccess;
  if (bad_shape(N, C, h, ws)) return (int)cudaErrorInvalidValue;
  const E* in = static_cast<const E*>(qkv);
  E* o = static_cast<E*>(out);
  if constexpr (std::is_same<E, bf16>::value) {
    if (v2_scale != nullptr)
      return launch_bf16<true>(in, bias, v2_scale, o, Bw, N, C, h, ws, nWh,
                               nWw, shift_h, shift_w, v1_scale, stream);
    return launch_bf16<false>(in, bias, v2_scale, o, Bw, N, C, h, ws, nWh,
                              nWw, shift_h, shift_w, v1_scale, stream);
  } else {
    return launch_f32(in, bias, v2_scale, o, Bw, N, C, h, ws, nWh, nWw,
                      shift_h, shift_w, v1_scale, stream);
  }
}

}  // namespace

#define WAQ_ENTRY(SUFFIX, E)                                                  \
  extern "C" int window_attention_qkv_##SUFFIX(                               \
      const void* qkv, const float* bias, const float* v2_scale, void* out,   \
      int Bw, int N, int C, int h, int ws, int nWh, int nWw, int shift_h,     \
      int shift_w, float v1_scale, void* stream) {                            \
    return launch<E>(qkv, bias, v2_scale, out, Bw, N, C, h, ws, nWh, nWw,     \
                     shift_h, shift_w, v1_scale,                              \
                     static_cast<cudaStream_t>(stream));                      \
  }

WAQ_ENTRY(f32, float)
WAQ_ENTRY(bf16, __nv_bfloat16)

// resident blocks an SM of the bf16 kernel, v2 (reported by chip_smoke.py)
extern "C" int window_attention_qkv_bf16_blocks_per_sm() {
  return fwd::blocks_per_sm(waq_bf16_kernel<true>);
}
