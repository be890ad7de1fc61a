// PQ intersection histogram for Hopper (sm_90a).
//
// Replaces the TPU kernel nicr_mtsa_tpu/ops/pallas/intersection_kernel.py
// (`intersection_matrix_pallas`), which computes the function
// nicr_mtsa_tpu/ops/segments.py `intersection_matrix`: per image, the
// (n_gt + 1, n_pred + 1) matrix of pixel counts of (gt slot, pred slot)
// pairs of two slot maps (B, P). A slot outside [0, n] is not counted
// (a one-hot of it is all zeros in the JAX formulation).
//
// The TPU builds one-hot tiles and multiplies them on its matrix unit;
// on Hopper this is a joint histogram. Each block owns a private int32
// histogram in shared memory (129 x 129 bins = 66.6 KB at the eval
// shape, dynamic shared memory above 48 KB), counts its chunk of one
// image's pixels with shared-memory atomicAdd, then adds its non-zero
// bins into the image's global int32 matrix with integer atomicAdd.
// Counts are exact and the order of the atomics cannot change them (no
// float atomics anywhere); the wrapper converts the matrix to f32.
//
// What bounds it on an H100: bytes. At the eval shape (8 images of
// 512 x 512) the two slot maps are 16.8 MB, ~0.005 ms at 3.35 TB/s.
// Shared-memory atomics on a few hot bins (large segments) serialise
// within a warp; that is left for a later PR.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int CHUNK = 8192;            // pixels per block
constexpr size_t MAX_SMEM = 232448;    // bytes a block may use (sm_90)

__global__ void __launch_bounds__(THREADS)
intersection_kernel(const int* __restrict__ gt,
                    const int* __restrict__ pred, long long P, int G,
                    int Q, int* __restrict__ out) {
  extern __shared__ int hist[];
  const int nb = G * Q;
  for (int i = threadIdx.x; i < nb; i += THREADS) hist[i] = 0;
  __syncthreads();

  const long long b = blockIdx.y;
  const long long start = (long long)blockIdx.x * CHUNK;
  const long long end = start + CHUNK < P ? start + CHUNK : P;
  const int* g_img = gt + b * P;
  const int* p_img = pred + b * P;
  for (long long p = start + threadIdx.x; p < end; p += THREADS) {
    const int g = g_img[p];
    const int q = p_img[p];
    if ((unsigned)g < (unsigned)G && (unsigned)q < (unsigned)Q) {
      atomicAdd(&hist[g * Q + q], 1);
    }
  }
  __syncthreads();

  int* o = out + b * nb;
  for (int i = threadIdx.x; i < nb; i += THREADS) {
    const int v = hist[i];
    if (v != 0) atomicAdd(&o[i], v);
  }
}

}  // namespace

// out: (B, n_gt + 1, n_pred + 1) int32, zeroed by the caller.
extern "C" int intersection_counts(const int* gt, const int* pred,
                                   int* out, int B, long long P, int n_gt,
                                   int n_pred, void* stream) {
  if (B <= 0 || P <= 0) return (int)cudaSuccess;
  const int G = n_gt + 1;
  const int Q = n_pred + 1;
  const size_t smem = (size_t)G * Q * sizeof(int);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        intersection_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((unsigned)((P + CHUNK - 1) / CHUNK), (unsigned)B);
  intersection_kernel<<<grid, THREADS, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      gt, pred, P, G, Q, out);
  return (int)cudaGetLastError();
}
