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
// Design: row 7's forward (window_attention_core.cu) with the slicing and
// the v2 normalisation moved in. One block of 256 threads per (window,
// head) loads the head's q, k and v tiles from the packed rows once
// (16-byte loads), normalises q and k in shared memory (a warp a token,
// the sum of squares by shuffles), and keeps the logits and
// probabilities in shared memory; bf16 products on the tensor cores
// (wmma 16x16x16, f32 accumulators), f32 (the card-vs-CPU check) with
// fmaf loops. Dynamic shared memory: 50 KB in bf16, 74 KB in f32.
// Several heads a block and TMA-fed wgmma are the next steps.
#include "window_tiles.cuh"

namespace {

using namespace window_tiles;

template <typename E>
constexpr size_t smem_bytes() {
  return 3 * NMAX * HLD * sizeof(E) + NMAX * S_LD * 4 +
         NMAX * P_LD * sizeof(E) + NMAX * O_LD * 4;
}

// v2: rows < N of a [64][HLD] tile divided by max(||row||, 1e-6) in f32,
// rounded to E; one warp a row, a lane a column
template <typename E>
__device__ __forceinline__ void unit_rows(E* tile, int N) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int n = warp; n < N; n += WARPS) {
    E* row = tile + n * HLD;
    const float f = to_f32(row[lane]);
    const float nrm = sqrtf(warp_sum(__fmul_rn(f, f)));
    row[lane] = from_f32<E>(__fdiv_rn(f, fmaxf(nrm, 1e-6f)));
  }
}

// grid (Bw, h): block (g, j) computes head j of window g
template <typename E>
__global__ void __launch_bounds__(THREADS)
waq_kernel(const E* __restrict__ qkv, const float* __restrict__ bias,
           const float* __restrict__ v2_scale, E* __restrict__ out, int N,
           int C, int ws, int nWh, int nWw, int shift_h, int shift_w,
           float v1_scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int region[NMAX];
  E* Qs = reinterpret_cast<E*>(smem);
  E* Ks = Qs + NMAX * HLD;
  E* Vs = Ks + NMAX * HLD;
  float* S = reinterpret_cast<float*>(Vs + NMAX * HLD);
  E* P = reinterpret_cast<E*>(S + NMAX * S_LD);
  float* O = reinterpret_cast<float*>(P + NMAX * P_LD);

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

template <typename E>
int launch(const void* qkv, const float* bias, const float* v2_scale,
           void* out, int Bw, int N, int C, int h, int ws, int nWh, int nWw,
           int shift_h, int shift_w, float v1_scale, cudaStream_t stream) {
  if (Bw <= 0) return (int)cudaSuccess;
  if (bad_shape(N, C, h, ws)) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes<E>();
  cudaError_t err = cudaFuncSetAttribute(
      waq_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  waq_kernel<E><<<dim3(Bw, h), THREADS, smem, stream>>>(
      static_cast<const E*>(qkv), bias, v2_scale, static_cast<E*>(out), N, C,
      ws, nWh, nWw, shift_h, shift_w, v1_scale);
  return (int)cudaGetLastError();
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
