// Offset-vote pixel grouping for Hopper (sm_90a).
//
// Replaces the TPU kernel nicr_mtsa_tpu/ops/pallas/grouping_kernel.py
// (`group_pixels_pallas`): for each pixel, the nearest valid instance
// centre to (pixel + offset) by squared distance. ids are 1..K, 0 for
// background or when no centre is valid; min_d2 is the running minimum
// (3.4e38 when nothing won), for the caller's distance threshold.
//
// Semantics kept from the TPU kernel: invalid centres sit at +3.4e38,
// so their d2 overflows to inf and never wins; a strict `<` running
// minimum from (3.4e38, -1) keeps the FIRST minimal centre; ids =
// fg ? arg + 1 : 0.
//
// d2 is pinned to fma(dy, dy, dx * dx) with one rounding of dx * dx:
// that is how XLA lowers the TPU kernel's `dy * dy + dx * dx` (on the
// CPU in interpret mode, a plain mul/mul/add differs in the last bit of
// min_d2 on ~16% of pixels). Written with explicit intrinsics, so
// neither nvcc's contraction nor -fmad=false can change it, and the
// plain PyTorch version reproduces it exactly.
//
// What bounds it on an H100: per pixel and centre 6 f32 operations
// (2 sub, mul, fma as 2, compare) against 17 bytes per pixel; at the
// serving shape (8 x 307200 pixels, 64 centres) ~0.94 GFLOP against
// ~42 MB, so the operations bound it (~14 us at 67 TFLOP/s vs ~12 us
// for the bytes). The design: one thread per pixel, the image's K
// centres staged once per block in shared memory (any K, dynamic
// shared memory), and the running (min, arg) pair in registers; pixel
// loads and id stores are coalesced.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr float BIG = 3.4e38f;

__global__ void __launch_bounds__(THREADS)
group_pixels_kernel(const float* __restrict__ loc_y,
                    const float* __restrict__ loc_x,
                    const float* __restrict__ centers_yx,    // (B, K, 2)
                    const uint8_t* __restrict__ valid,       // (B, K)
                    const uint8_t* __restrict__ fg,          // (B, P)
                    int* __restrict__ ids, float* __restrict__ min_d2,
                    int P, int K) {
  extern __shared__ float smem[];
  float* cy = smem;
  float* cx = smem + K;
  const int b = blockIdx.y;
  for (int j = threadIdx.x; j < K; j += THREADS) {
    const bool ok = valid[(size_t)b * K + j] != 0;
    cy[j] = ok ? centers_yx[((size_t)b * K + j) * 2 + 0] : BIG;
    cx[j] = ok ? centers_yx[((size_t)b * K + j) * 2 + 1] : BIG;
  }
  __syncthreads();

  const int p = blockIdx.x * THREADS + threadIdx.x;
  if (p >= P) return;
  const size_t o = (size_t)b * P + p;
  const float ly = loc_y[o];
  const float lx = loc_x[o];
  float best = BIG;
  int arg = -1;
  for (int j = 0; j < K; ++j) {
    const float dy = __fsub_rn(ly, cy[j]);
    const float dx = __fsub_rn(lx, cx[j]);
    const float d2 = __fmaf_rn(dy, dy, __fmul_rn(dx, dx));
    if (d2 < best) {
      best = d2;
      arg = j;
    }
  }
  ids[o] = fg[o] ? arg + 1 : 0;
  min_d2[o] = best;
}

}  // namespace

extern "C" int group_pixels_f32(const float* loc_y, const float* loc_x,
                                const float* centers_yx,
                                const uint8_t* valid, const uint8_t* fg,
                                int* ids, float* min_d2, int B, int P,
                                int K, void* stream) {
  if (B <= 0 || P <= 0) return (int)cudaSuccess;
  const size_t smem = 2 * (size_t)(K > 0 ? K : 1) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        group_pixels_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((P + THREADS - 1) / THREADS, B);
  group_pixels_kernel<<<grid, THREADS, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      loc_y, loc_x, centers_yx, valid, fg, ids, min_d2, P, K);
  return (int)cudaGetLastError();
}
