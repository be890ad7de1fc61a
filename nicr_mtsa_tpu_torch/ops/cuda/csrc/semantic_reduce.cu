// First argmax and max-softmax score over the class axis, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel nicr_mtsa_tpu/ops/pallas/semantic_reduce.py
// (`semantic_score_idx_pallas`): for class logits (B, C, H, W) it writes
// idx = the FIRST class attaining the maximum (int32, strict `>` in
// class order) and score = 1 / sum_c exp(l_c - max) (f32, the sum taken
// in class order 0..C-1), both (B, H, W); no softmax tensor is written.
// Every f32 step is an explicit round-to-nearest intrinsic with the
// accurate `expf`; built with -fmad=false.
//
// What bounds it on an H100: bytes. At the eval call (8, 40, 480, 640)
// bf16 channels-last (the model's layout on the card) 196.6 MB are read
// once and 19.7 MB written, ~0.065 ms at 3.35 TB/s, against ~14 issued
// instructions a value (~0.04 ms on 132 SMs) that have to hide under
// the loads. Two kernels, chosen by the host plan
// (`semantic_reduce.sr_plan`):
// - `staged_kernel`, where a pixel's classes are one contiguous 16-byte
//   aligned run (channels-last, C * elt a multiple of 16): pixels that
//   lie contiguously (a row, an image, or the whole tensor) are cut
//   into runs of `run` pixels; a persistent grid of about one wave
//   walks them, each block keeping `stages` runs in flight in a ring in
//   shared memory, each run one contiguous bulk copy by the Tensor
//   Memory Accelerator (`cp.async.bulk` completing on an mbarrier; it
//   beat 16-byte `cp.async` of all threads at every run and depth
//   measured). A thread takes a pixel: its C
//   values come out of shared memory in 16-byte loads (at an 80-byte
//   stride the 8 lanes of a quarter-warp hit disjoint banks), at C = 40
//   into registers, so max/argmax and the exp sum read global memory
//   once; idx and score are stored coalesced. The tile's coordinates
//   are 32-bit and computed once a run.
// - `strided_kernel` for every other layout (NCHW, views, misaligned
//   storage, C * elt not a multiple of 16): a thread a pixel with lanes
//   along W (each class read coalesced in NCHW) on the grid (W / 128,
//   H, B); at C = 40 all of a pixel's loads are issued at once and its
//   values held in registers (one pass), other C take two passes over
//   the pixel's classes (the second hits L1).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int STRIDED_THREADS = 128;
constexpr int MAX_RUN = 256;         // threads a staged block at most
constexpr int MAX_STAGES = 4;
constexpr int FAST_C = 40;           // the eval model's classes

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The f32 values of one 16-byte vector of T.
template <typename T>
struct Vec;
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void unpack(const uint4& u,
                                                float (&v)[8]) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void unpack(const uint4& u,
                                                float (&v)[4]) {
    v[0] = __uint_as_float(u.x);
    v[1] = __uint_as_float(u.y);
    v[2] = __uint_as_float(u.z);
    v[3] = __uint_as_float(u.w);
  }
};

// max/argmax over the classes of one vector, classes c0.. in order; the
// first class of the pixel initialises (m, arg)
template <typename T>
__device__ __forceinline__ void max_vec(const uint4& u, int c0, float& m,
                                        int& arg) {
  float v[Vec<T>::N];
  Vec<T>::unpack(u, v);
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) {
    if (c0 + i == 0) {
      m = v[i];
      arg = 0;
    } else if (v[i] > m) {
      m = v[i];
      arg = c0 + i;
    }
  }
}

template <typename T>
__device__ __forceinline__ float sum_vec(const uint4& u, float m, float s) {
  float v[Vec<T>::N];
  Vec<T>::unpack(u, v);
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i)
    s = __fadd_rn(s, expf(__fsub_rn(v[i], m)));
  return s;
}

// ---------------------------------------------------------------- strided

template <typename T, int CT>
__global__ void __launch_bounds__(STRIDED_THREADS)
strided_kernel(const T* __restrict__ x, int C, int H, int W, long long sb,
               long long sc, long long sh, long long sw,
               int* __restrict__ idx, float* __restrict__ score) {
  const int w = blockIdx.x * STRIDED_THREADS + threadIdx.x;
  if (w >= W) return;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const T* px = x + b * sb + h * sh + w * sw;

  float m, s = 0.0f;
  int arg = 0;
  if constexpr (CT > 0) {
    // all C loads in flight at once, the values held in registers
    float v[CT];
#pragma unroll
    for (int c = 0; c < CT; ++c) v[c] = to_f32(px[c * sc]);
    m = v[0];
#pragma unroll
    for (int c = 1; c < CT; ++c) {
      if (v[c] > m) {
        m = v[c];
        arg = c;
      }
    }
#pragma unroll
    for (int c = 0; c < CT; ++c) s = __fadd_rn(s, expf(__fsub_rn(v[c], m)));
  } else {
    m = to_f32(px[0]);
    for (int c = 1; c < C; ++c) {
      const float v = to_f32(px[c * sc]);
      if (v > m) {
        m = v;
        arg = c;
      }
    }
    for (int c = 0; c < C; ++c)
      s = __fadd_rn(s, expf(__fsub_rn(to_f32(px[c * sc]), m)));
  }
  const int p = (b * H + h) * W + w;
  idx[p] = arg;
  score[p] = __fdiv_rn(1.0f, s);
}

// ----------------------------------------------------------------- staged

// The runs: segment `seg` (seg_len contiguous pixels) of image
// seg / segs_per_img starts at row seg % segs_per_img; run r of it at
// pixel r * run. Output pixels are numbered as the segments.
struct StagedArgs {
  long long sb, sh;     // image and row strides (elements)
  int C;
  int seg_len, segs_per_img, runs_per_seg, n_tiles;
  int run, stages, slot_bytes;
};

struct Tile {
  const char* src;
  int p0, n, bytes;
};

template <typename T>
__device__ __forceinline__ Tile tile_of(const T* x, const StagedArgs& a,
                                        int t) {
  const int seg = t / a.runs_per_seg;
  const int w0 = (t - seg * a.runs_per_seg) * a.run;
  const int img = seg / a.segs_per_img;
  const int row = seg - img * a.segs_per_img;
  Tile tl;
  tl.n = min(a.run, a.seg_len - w0);
  tl.p0 = seg * a.seg_len + w0;
  tl.bytes = tl.n * a.C * (int)sizeof(T);
  tl.src = reinterpret_cast<const char*>(x + img * a.sb + row * a.sh +
                                         (long long)w0 * a.C);
  return tl;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
// one thread: the whole run into `dst`, completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const Tile& tl,
                                          unsigned long long* bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(tl.bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(tl.src), "r"(tl.bytes), "r"(smem_addr(bar))
      : "memory");
}

// idx and score of this thread's pixel of a staged run
template <typename T, int CT>
__device__ __forceinline__ void reduce_staged(const char* slot,
                                              const Tile& tl, int C,
                                              int* __restrict__ idx,
                                              float* __restrict__ score) {
  const int t = threadIdx.x;
  if (t >= tl.n) return;
  const uint4* pv =
      reinterpret_cast<const uint4*>(slot + t * C * (int)sizeof(T));
  constexpr int N = Vec<T>::N;
  float m = 0.0f, s = 0.0f;
  int arg = 0;
  if constexpr (CT > 0) {
    constexpr int NV = CT / N;
    uint4 r[NV];
#pragma unroll
    for (int j = 0; j < NV; ++j) r[j] = pv[j];
#pragma unroll
    for (int j = 0; j < NV; ++j) max_vec<T>(r[j], j * N, m, arg);
#pragma unroll
    for (int j = 0; j < NV; ++j) s = sum_vec<T>(r[j], m, s);
  } else {
    const int nv = C / N;
    for (int j = 0; j < nv; ++j) max_vec<T>(pv[j], j * N, m, arg);
    for (int j = 0; j < nv; ++j) s = sum_vec<T>(pv[j], m, s);
  }
  idx[tl.p0 + t] = arg;
  score[tl.p0 + t] = __fdiv_rn(1.0f, s);
}

template <typename T, int CT>
__global__ void __launch_bounds__(MAX_RUN)
staged_kernel(const T* __restrict__ x, StagedArgs a, int* __restrict__ idx,
              float* __restrict__ score) {
  static_assert(CT % Vec<T>::N == 0, "C must fill whole 16-byte vectors");
  extern __shared__ __align__(128) char ring[];
  const int S = a.stages;
  const int G = gridDim.x;
  __shared__ __align__(8) unsigned long long bar[MAX_STAGES];
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) mbar_init(&bar[s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < S; ++s) {
      const int t = blockIdx.x + s * G;
      if (t < a.n_tiles)
        bulk_copy(ring + s * a.slot_bytes, tile_of(x, a, t), &bar[s]);
    }
  }
  __syncthreads();
  int i = 0;
  for (int t = blockIdx.x; t < a.n_tiles; t += G, ++i) {
    const int s = i % S;
    mbar_wait(&bar[s], (unsigned)(i / S) & 1u);
    reduce_staged<T, CT>(ring + s * a.slot_bytes, tile_of(x, a, t), a.C,
                         idx, score);
    __syncthreads();               // every thread is done with slot s
    const int next = t + S * G;
    if (threadIdx.x == 0 && next < a.n_tiles)
      bulk_copy(ring + s * a.slot_bytes, tile_of(x, a, next), &bar[s]);
  }
}

template <typename T, int CT>
int set_smem(int smem) {
  if (smem <= 48 * 1024) return (int)cudaSuccess;
  return (int)cudaFuncSetAttribute(staged_kernel<T, CT>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   smem);
}

template <typename T, int CT>
int launch_staged(const T* x, const StagedArgs& a, int blocks, int* idx,
                  float* score, cudaStream_t st) {
  const int smem = a.stages * a.slot_bytes;
  const int err = set_smem<T, CT>(smem);
  if (err != (int)cudaSuccess) return err;
  staged_kernel<T, CT><<<blocks, a.run, smem, st>>>(x, a, idx, score);
  return (int)cudaGetLastError();
}

template <typename T>
int staged(const void* x, int* idx, float* score, int C, long long sb,
           long long sh, int seg_len, int segs_per_img, int runs_per_seg,
           int n_tiles, int run, int stages, int slot_bytes, int blocks,
           void* stream) {
  if (n_tiles <= 0) return (int)cudaSuccess;
  if (run <= 0 || run > MAX_RUN || run % 32 != 0 || stages < 2 ||
      stages > MAX_STAGES || (C * (int)sizeof(T)) % 16 != 0 || blocks <= 0)
    return (int)cudaErrorInvalidValue;
  const StagedArgs a{sb, sh, C, seg_len, segs_per_img, runs_per_seg,
                     n_tiles, run, stages, slot_bytes};
  const T* xt = static_cast<const T*>(x);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return C == FAST_C
             ? launch_staged<T, FAST_C>(xt, a, blocks, idx, score, st)
             : launch_staged<T, 0>(xt, a, blocks, idx, score, st);
}

// resident staged blocks an SM at `run` threads and `smem` bytes (-1 on
// error)
template <typename T>
int staged_blocks_per_sm(int C, int run, int smem) {
  const bool fast = C == FAST_C;
  if ((fast ? set_smem<T, FAST_C>(smem) : set_smem<T, 0>(smem)) !=
      (int)cudaSuccess)
    return -1;
  void (*fn)(const T*, StagedArgs, int*, float*) =
      fast ? staged_kernel<T, FAST_C> : staged_kernel<T, 0>;
  int per_sm = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, run, smem);
  return err == cudaSuccess ? per_sm : -1;
}

template <typename T>
int strided(const void* x, int* idx, float* score, int B, int C, int H,
            int W, long long sb, long long sc, long long sh, long long sw,
            void* stream) {
  if ((long long)B * H * W <= 0 || C <= 0) return (int)cudaSuccess;
  if (H > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((W + STRIDED_THREADS - 1) / STRIDED_THREADS, H, B);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* xt = static_cast<const T*>(x);
  if (C == FAST_C)
    strided_kernel<T, FAST_C><<<grid, STRIDED_THREADS, 0, st>>>(
        xt, C, H, W, sb, sc, sh, sw, idx, score);
  else
    strided_kernel<T, 0><<<grid, STRIDED_THREADS, 0, st>>>(
        xt, C, H, W, sb, sc, sh, sw, idx, score);
  return (int)cudaGetLastError();
}

}  // namespace

#define SEMANTIC_REDUCE_ENTRY(NAME, T)                                      \
  extern "C" int NAME(const void* x, int* idx, float* score, int B, int C,  \
                      int H, int W, long long sb, long long sc,             \
                      long long sh, long long sw, void* stream) {           \
    return strided<T>(x, idx, score, B, C, H, W, sb, sc, sh, sw, stream);   \
  }                                                                         \
  extern "C" int NAME##_staged(                                             \
      const void* x, int* idx, float* score, int C, long long sb,           \
      long long sh, int seg_len, int segs_per_img, int runs_per_seg,        \
      int n_tiles, int run, int stages, int slot_bytes, int blocks,         \
      void* stream) {                                                       \
    return staged<T>(x, idx, score, C, sb, sh, seg_len, segs_per_img,       \
                     runs_per_seg, n_tiles, run, stages, slot_bytes,        \
                     blocks, stream);                                       \
  }                                                                         \
  extern "C" int NAME##_staged_blocks_per_sm(int C, int run, int smem) {    \
    return staged_blocks_per_sm<T>(C, run, smem);                           \
  }

SEMANTIC_REDUCE_ENTRY(semantic_score_idx_f32, float)
SEMANTIC_REDUCE_ENTRY(semantic_score_idx_bf16, __nv_bfloat16)
