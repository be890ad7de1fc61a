// PQ intersection histogram for Hopper (sm_90a).
//
// Replaces the TPU kernel nicr_mtsa_tpu/ops/pallas/intersection_kernel.py
// (`intersection_matrix_pallas`), which computes the function
// nicr_mtsa_tpu/ops/segments.py `intersection_matrix`: per image, the
// (n_gt + 1, n_pred + 1) matrix of pixel counts of (gt slot, pred slot)
// pairs of two slot maps (B, P). A slot outside [0, n] is not counted
// (a one-hot of it is all zeros in the JAX formulation). The result is
// f32, exact (integer counts below 2^24 a bin).
//
// The TPU builds one-hot tiles and multiplies them on its matrix unit;
// on Hopper this is a joint histogram. What bounds it on an H100:
// bytes. At the eval shape (8 images of 512 x 512, 129 x 129 bins) the
// two slot maps are 16.8 MB, ~0.005 ms at 3.35 TB/s. The design:
// - one thread-block cluster an image (`cluster` CTAs of 1024 threads,
//   as the host plan `intersection.it_plan` chooses from the clusters
//   the card holds at once: 8 at B = 8 and 129 x 129 bins, one wave of
//   64 CTAs; only 7 clusters of 16 fit, and a second wave of one image
//   took twice the time);
// - each CTA zeroes its own int32 histogram of all bins in shared
//   memory with 16-byte stores while its first loads are in flight,
//   then counts its share of the image: both maps read in 16-byte
//   vectors (4 pixels) from the first 16-byte boundary of the image's
//   row on, the head and tail by scalar loads (a map whose rows start
//   at another 4-pixel phase than the other's is read by scalar loads
//   throughout);
// - counting is a shared atomic a pixel: Hopper's shared atomics took a
//   warp of 32 pixels in one bin no slower than 32 bins, and the
//   warp-aggregated forms measured against it (`__match_any_sync`, one
//   atomic of 32 where a warp's pixels share a bin) were slower on
//   random, one-bin and the eval step's maps;
// - after `cluster.sync()` each CTA owns 1/cluster of the bins, sums
//   them in 16-byte groups over the cluster's histograms through
//   distributed shared memory (`map_shared_rank`) and writes them to
//   the f32 output; a second `cluster.sync()` keeps the peers' shared
//   memory alive until the reads end.
// One launch a call: no zero fill, no conversion, no global atomics;
// integer sums in any order are exact, so the result is deterministic.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 1024;
constexpr int U = 4;                   // 4-pixel vectors a thread a trip
constexpr int MAX_CLUSTER = 16;
constexpr int MAX_SMEM = 232448;       // bytes a block may use (sm_90)

struct Args {
  const int* gt;
  const int* pred;
  float* out;
  long long sg, sp;                    // image strides of the maps
  int G, Q;                            // bins n_gt + 1, n_pred + 1
  int head, vectors, tail;             // pixels of an image: scalar head,
                                       // 4-pixel vectors, scalar tail
};

// one pixel a lane; lanes without a pixel pass g = -1
__device__ __forceinline__ void count(int* hist, int g, int q, int G,
                                      int Q) {
  if ((unsigned)g < (unsigned)G && (unsigned)q < (unsigned)Q)
    atomicAdd(hist + g * Q + q, 1);
}

__global__ void __launch_bounds__(THREADS, 1)
intersection_kernel(Args a) {
  extern __shared__ __align__(16) int hist[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.y;
  const int tid = threadIdx.x, warp_px = tid & ~31;
  const int nb = a.G * a.Q;
  const int* g_img = a.gt + b * a.sg;
  const int* p_img = a.pred + b * a.sp;
  const int4* g4 = reinterpret_cast<const int4*>(g_img + a.head);
  const int4* p4 = reinterpret_cast<const int4*>(p_img + a.head);
  const int step = cs * THREADS;       // vectors (pixels) the cluster
                                       // takes a trip and u

  // trip k, slot u of this thread: vector (k U + u) step + rank THREADS
  // + tid; the first trip's loads fly while the histogram is zeroed
  int4 gv[U], pv[U];
  auto load = [&](int base) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int v = base + u * step + tid;
      if (v < a.vectors) {
        gv[u] = __ldg(g4 + v);
        pv[u] = __ldg(p4 + v);
      } else {
        gv[u] = make_int4(-1, -1, -1, -1);
        pv[u] = gv[u];
      }
    }
  };
  int base = rank * THREADS;
  load(base);
  int4* h4 = reinterpret_cast<int4*>(hist);
  for (int i = tid; i < (nb + 3) / 4; i += THREADS)
    h4[i] = make_int4(0, 0, 0, 0);
  __syncthreads();

  while (base + warp_px < a.vectors) {         // warp-uniform
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (base + u * step + warp_px < a.vectors) {
        count(hist, gv[u].x, pv[u].x, a.G, a.Q);
        count(hist, gv[u].y, pv[u].y, a.G, a.Q);
        count(hist, gv[u].z, pv[u].z, a.G, a.Q);
        count(hist, gv[u].w, pv[u].w, a.G, a.Q);
      }
    }
    base += U * step;
    load(base);
  }

  // the scalar pixels: the head, then the tail after the vectors
  const int n_scalar = a.head + a.tail;
  for (int i0 = rank * THREADS; i0 + warp_px < n_scalar; i0 += step) {
    const int i = i0 + tid;
    int g = -1, q = -1;
    if (i < n_scalar) {
      const int p = i < a.head ? i : i + 4 * a.vectors;
      g = g_img[p];
      q = p_img[p];
    }
    count(hist, g, q, a.G, a.Q);
  }

  cluster.sync();
  // this CTA's 16-byte bin groups, summed over the cluster's histograms
  // (eight peers' loads in flight at a time)
  const int n4 = (nb + 3) / 4;
  const int per = (n4 + cs - 1) / cs;
  const int end = min(n4, (rank + 1) * per);
  float* o = a.out + (long long)b * nb;
  for (int i = rank * per + tid; i < end; i += THREADS) {
    int4 s = make_int4(0, 0, 0, 0);
    for (int r0 = 0; r0 < cs; r0 += 8) {
      int4 v[8];
#pragma unroll
      for (int r = 0; r < 8; ++r)
        v[r] = r0 + r < cs ? reinterpret_cast<const int4*>(
                                 cluster.map_shared_rank(hist, r0 + r))[i]
                           : make_int4(0, 0, 0, 0);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        s.x += v[r].x;
        s.y += v[r].y;
        s.z += v[r].z;
        s.w += v[r].w;
      }
    }
    const int bin = 4 * i;
    o[bin] = __int2float_rn(s.x);
    if (bin + 1 < nb) o[bin + 1] = __int2float_rn(s.y);
    if (bin + 2 < nb) o[bin + 2] = __int2float_rn(s.z);
    if (bin + 3 < nb) o[bin + 3] = __int2float_rn(s.w);
  }
  cluster.sync();
}

// the kernel's attributes on the current device, set once a device:
// shared memory up to MAX_SMEM, clusters above the portable 8
int configure() {
  constexpr int MAX_DEVICES = 64;
  static bool done[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < MAX_DEVICES && done[dev]) return (int)cudaSuccess;
  e = cudaFuncSetAttribute(intersection_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           MAX_SMEM);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(intersection_kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  if (e == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
  return (int)e;
}

cudaLaunchConfig_t config(int cluster, int B, int smem, cudaStream_t st,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cluster, (unsigned)B, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

bool valid(int cluster, int smem) {
  return cluster >= 1 && cluster <= MAX_CLUSTER && smem > 0 &&
         smem <= MAX_SMEM && smem % 16 == 0;
}

}  // namespace

// clusters of `cluster` CTAs at `smem` bytes of shared memory that the
// card holds at once (0: none fits; negative: a CUDA error)
extern "C" int intersection_max_clusters(int cluster, int smem) {
  if (!valid(cluster, smem)) return -(int)cudaErrorInvalidValue;
  const int err = configure();
  if (err != (int)cudaSuccess) return -err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = config(cluster, 1, smem, nullptr, &attr);
  int n = 0;
  const cudaError_t e =
      cudaOccupancyMaxActiveClusters(&n, intersection_kernel, &cfg);
  return e == cudaSuccess ? n : -(int)e;
}

// out: (B, n_gt + 1, n_pred + 1) f32, every bin written
extern "C" int intersection_counts(const int* gt, const int* pred,
                                   float* out, int B, long long sg,
                                   long long sp, int n_gt, int n_pred,
                                   int cluster, int head, int vectors,
                                   int tail, int smem, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  const int G = n_gt + 1, Q = n_pred + 1;
  if (!valid(cluster, smem) || B > 65535 || (long long)G * Q * 4 > smem ||
      head < 0 || vectors < 0 || tail < 0)
    return (int)cudaErrorInvalidValue;
  const int err = configure();
  if (err != (int)cudaSuccess) return err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg =
      config(cluster, B, smem, static_cast<cudaStream_t>(stream), &attr);
  const Args a{gt, pred, out, sg, sp, G, Q, head, vectors, tail};
  const cudaError_t e = cudaLaunchKernelEx(&cfg, intersection_kernel, a);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}
