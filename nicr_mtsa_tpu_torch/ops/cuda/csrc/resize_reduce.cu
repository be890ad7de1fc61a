// Crop + half-pixel bilinear resize + first argmax / max-softmax score,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel nicr_mtsa_tpu/ops/pallas/resize_reduce.py
// (`crop_resize_argmax_score`): working-resolution class logits
// (B, C, H, W) are cropped to the valid region [y0, y0 + in_h) x
// [x0, x0 + in_w), resized to (OH, OW) with 2-tap half-pixel bilinear
// interpolation (torch align_corners=False, taps clamped at the edges),
// and reduced over the classes to idx (first argmax, int32) and score
// = 1 / sum_c exp(l_c - max) (f32). The resized logits never exist in
// device memory.
//
// Numerics, pinned to the JAX package's CPU result: each value is cast
// to f32, the rows are interpolated first, then the columns, each lerp
// as fl(fl(a * w0) + fl(b * w1)) with w0 = f32(1 - f) formed in double
// on the host and w1 = f (no FMA: XLA does not contract this form on
// the CPU, measured against resize_bilinear); a weight w1 of 0 takes
// the first tap as it is. The argmax is then bit-identical to the plain
// version's and to the JAX package's. The tap tables (clamped lo/hi
// taps and both weights per output row and column) come from the host.
//
// What bounds it on an H100: bytes. At the eval shape (8, 40, 480, 640)
// bf16 channels-last -> (512, 512): 196.6 MB read once + 16.8 MB
// written, ~0.064 ms at 3.35 TB/s, against ~30 f32 operations per
// output value (~0.04 ms at 67 TFLOP/s). The design:
// - a block owns a strip of `strip_w` output columns of one image and
//   walks a band of output rows, `group_rows` rows at a time (one
//   thread a pixel; 256 columns of 1 row at the eval call);
// - the input columns the strip's taps reach, all C classes of each,
//   come into a ring of `ring_rows` input rows in shared memory, each
//   crop row once per strip: in channels-last they are one contiguous
//   run a row, copied by 16-byte cp.async while the previous group
//   computes; other layouts and alignments are staged by plain loads;
// - a pixel's 4 taps of all classes are read from shared memory
//   (16-byte reads on the C = 40 path) and its C interpolated logits
//   held in registers: one pass gives the first argmax (strict `>`),
//   a second over the registers the exp sum in class order. Other C
//   recompute the taps from shared memory in each pass.
// The geometry (strip, group, band, ring) is `resize_reduce.rr_plan` on
// the host. Built with -fmad=false and written with round-to-nearest
// intrinsics.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int FAST_C = 40;      // the eval model's classes: logits in registers

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float lerp(float a, float b, float w0, float w1) {
  return __fadd_rn(__fmul_rn(a, w0), __fmul_rn(b, w1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

struct Tables {
  const int* lo_h;
  const int* hi_h;
  const float* w0_h;
  const float* w1_h;
  const int* lo_w;
  const int* hi_w;
  const float* w0_w;
  const float* w1_w;
};

// The 4 taps of one output pixel in the ring: (lo row, lo col) pa,
// (hi row, lo col) pb, (lo row, hi col) pc, (hi row, hi col) pd, each
// pointing at class 0 of C contiguous classes.
template <typename T>
struct Taps {
  const T *pa, *pb, *pc, *pd;
  float h0, h1, w0, w1;

  __device__ __forceinline__ float value(float a, float b, float c,
                                         float d) const {
    const float left = h1 != 0.0f ? lerp(a, b, h0, h1) : a;
    if (w1 == 0.0f) return left;
    const float right = h1 != 0.0f ? lerp(c, d, h0, h1) : c;
    return lerp(left, right, w0, w1);
  }
  __device__ __forceinline__ float value(int c) const {
    return value(to_f32(pa[c]), to_f32(pb[c]), to_f32(pc[c]),
                 to_f32(pd[c]));
  }
};

template <typename T, int CT>
__device__ __forceinline__ void reduce_pixel(const Taps<T>& tp, int C,
                                             int* idx, float* score) {
  float m;
  int arg = 0;
  float s = 0.0f;
  if (CT > 0) {
    constexpr int V = 16 / sizeof(T);
    constexpr int NC = CT > 0 ? CT : V;
    float v[NC];
#pragma unroll
    for (int k = 0; k < NC / V; ++k) {
      const uint4 qa = reinterpret_cast<const uint4*>(tp.pa)[k];
      const uint4 qb = reinterpret_cast<const uint4*>(tp.pb)[k];
      const uint4 qc = reinterpret_cast<const uint4*>(tp.pc)[k];
      const uint4 qd = reinterpret_cast<const uint4*>(tp.pd)[k];
      const T* a = reinterpret_cast<const T*>(&qa);
      const T* b = reinterpret_cast<const T*>(&qb);
      const T* c = reinterpret_cast<const T*>(&qc);
      const T* d = reinterpret_cast<const T*>(&qd);
#pragma unroll
      for (int e = 0; e < V; ++e)
        v[k * V + e] = tp.value(to_f32(a[e]), to_f32(b[e]), to_f32(c[e]),
                                to_f32(d[e]));
    }
    m = v[0];
#pragma unroll
    for (int c = 1; c < NC; ++c) {
      if (v[c] > m) {
        m = v[c];
        arg = c;
      }
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) s = __fadd_rn(s, expf(__fsub_rn(v[c], m)));
  } else {
    m = tp.value(0);
    for (int c = 1; c < C; ++c) {
      const float v = tp.value(c);
      if (v > m) {
        m = v;
        arg = c;
      }
    }
    for (int c = 0; c < C; ++c)
      s = __fadd_rn(s, expf(__fsub_rn(tp.value(c), m)));
  }
  *idx = arg;
  *score = __fdiv_rn(1.0f, s);
}

// Block (strip, band, image): output columns [strip strip_w, + strip_w),
// rows [band band_groups group_rows, + band_groups group_rows). Crop row
// r of the strip sits in ring slot r % ring_rows, its input columns
// [lo_w[first column], hi_w[last column]] at slot_elems T a slot, class
// fastest. Group g's rows are issued one group ahead; the host plan
// sizes the ring to hold every pair of consecutive groups' rows.
// Launch bounds of 2 blocks an SM: 128 registers, no spills (measured:
// the compiler's own choice took 165 registers, 1 block an SM; 3 blocks
// spill)
template <typename T, int CT>
__global__ void __launch_bounds__(THREADS, 2)
resize_reduce_kernel(const T* __restrict__ x, int C, long long sb,
                     long long sc, long long sh, long long sw, int y0,
                     int x0, Tables tb, int OH, int OW,
                     int* __restrict__ idx, float* __restrict__ score,
                     int strip_w, int group_rows, int band_groups,
                     int ring_rows, int slot_elems, int async16) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x;
  const long long b = blockIdx.z;
  const int ox0 = blockIdx.x * strip_w;
  const int oy_begin = blockIdx.y * band_groups * group_rows;
  if (ox0 >= OW || oy_begin >= OH) return;
  const int ox_end = min(ox0 + strip_w, OW);
  const int oy_stop = min(oy_begin + band_groups * group_rows, OH);
  const int col0 = tb.lo_w[ox0];
  const int ncols = tb.hi_w[ox_end - 1] + 1 - col0;
  const int nc = CT > 0 ? CT : C;
  const int row_elems = ncols * nc;
  const T* xb = x + b * sb + (long long)(x0 + col0) * sw;

  int next_row = tb.lo_h[oy_begin];         // first crop row not issued
  auto issue_through = [&](int last) {
    for (; next_row <= last; ++next_row) {
      T* dst = ring + (next_row % ring_rows) * slot_elems;
      const T* src = xb + (long long)(y0 + next_row) * sh;
      if (async16) {                // channels-last: one contiguous run
        constexpr int V = 16 / sizeof(T);
        for (int i = tid; i < row_elems / V; i += THREADS)
          cp_async16(dst + i * V, src + i * V);
      } else if (sc == 1) {
        for (int i = tid; i < row_elems; i += THREADS) {
          const int col = i / nc;
          dst[i] = src[col * sw + (i - col * nc)];
        }
      } else {                      // class planes: along the columns
        for (int i = tid; i < row_elems; i += THREADS) {
          const int c = i / ncols;
          const int col = i - c * ncols;
          dst[col * nc + c] = src[c * sc + col * sw];
        }
      }
    }
  };

  const int n_groups = (oy_stop - oy_begin + group_rows - 1) / group_rows;
  issue_through(tb.hi_h[min(oy_begin + group_rows, oy_stop) - 1]);
  cp_async_commit();
  for (int g = 0; g < n_groups; ++g) {
    const int oy_g = oy_begin + g * group_rows;
    if (g + 1 < n_groups)
      issue_through(tb.hi_h[min(oy_g + 2 * group_rows, oy_stop) - 1]);
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();
    for (int p = tid; p < group_rows * strip_w; p += THREADS) {
      const int oy = oy_g + p / strip_w;
      const int ox = ox0 + p % strip_w;
      if (oy >= oy_stop || ox >= ox_end) continue;
      const int rlo = tb.lo_h[oy] % ring_rows;
      const int rhi = tb.hi_h[oy] % ring_rows;
      const int clo = (tb.lo_w[ox] - col0) * nc;
      const int chi = (tb.hi_w[ox] - col0) * nc;
      Taps<T> tp;
      tp.pa = ring + rlo * slot_elems + clo;
      tp.pb = ring + rhi * slot_elems + clo;
      tp.pc = ring + rlo * slot_elems + chi;
      tp.pd = ring + rhi * slot_elems + chi;
      tp.h0 = tb.w0_h[oy];
      tp.h1 = tb.w1_h[oy];
      tp.w0 = tb.w0_w[ox];
      tp.w1 = tb.w1_w[ox];
      const long long o = (b * OH + oy) * OW + ox;
      reduce_pixel<T, CT>(tp, C, idx + o, score + o);
    }
    __syncthreads();
  }
}

template <typename T, int CT>
int set_smem(int smem) {
  return (int)cudaFuncSetAttribute(
      resize_reduce_kernel<T, CT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <typename T>
int launch(const void* x, const Tables& tb, int* idx, float* score, int B,
           int C, int OH, int OW, int y0, int x0, long long sb, long long sc,
           long long sh, long long sw, int strip_w, int group_rows,
           int band_groups, int ring_rows, int slot_elems, int strips,
           int bands, void* stream) {
  if ((long long)B * OH * OW <= 0 || C <= 0) return (int)cudaSuccess;
  if (strip_w <= 0 || group_rows <= 0 || band_groups <= 0 ||
      ring_rows <= 0 || strips <= 0 || bands <= 0 || bands > 65535 ||
      B > 65535 || ((long long)slot_elems * sizeof(T)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int smem = ring_rows * slot_elems * (int)sizeof(T);
  const bool fast = C == FAST_C;
  const bool async16 = sc == 1 && sw == C &&
                       ((long long)C * sizeof(T)) % 16 == 0 &&
                       (sb * (long long)sizeof(T)) % 16 == 0 &&
                       (sh * (long long)sizeof(T)) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int err = fast ? set_smem<T, FAST_C>(smem) : set_smem<T, 0>(smem);
  if (err != (int)cudaSuccess) return err;
  const dim3 grid((unsigned)strips, (unsigned)bands, (unsigned)B);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fast) {
    resize_reduce_kernel<T, FAST_C><<<grid, THREADS, smem, st>>>(
        static_cast<const T*>(x), C, sb, sc, sh, sw, y0, x0, tb, OH, OW, idx,
        score, strip_w, group_rows, band_groups, ring_rows, slot_elems,
        async16);
  } else {
    resize_reduce_kernel<T, 0><<<grid, THREADS, smem, st>>>(
        static_cast<const T*>(x), C, sb, sc, sh, sw, y0, x0, tb, OH, OW, idx,
        score, strip_w, group_rows, band_groups, ring_rows, slot_elems,
        async16);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int blocks_per_sm(int C, int smem) {
  int per_sm = 0;
  const bool fast = C == FAST_C;
  if ((fast ? set_smem<T, FAST_C>(smem) : set_smem<T, 0>(smem)) !=
      (int)cudaSuccess)
    return -1;
  const cudaError_t err =
      fast ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &per_sm, resize_reduce_kernel<T, FAST_C>, THREADS, smem)
           : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &per_sm, resize_reduce_kernel<T, 0>, THREADS, smem);
  return err == cudaSuccess ? per_sm : -1;
}

}  // namespace

#define RESIZE_REDUCE_ENTRY(NAME, T)                                        \
  extern "C" int NAME(const void* x, const int* lo_h, const int* hi_h,      \
                      const float* w0_h, const float* w1_h,                 \
                      const int* lo_w, const int* hi_w, const float* w0_w,  \
                      const float* w1_w, int* idx, float* score, int B,     \
                      int C, int OH, int OW, int y0, int x0, long long sb,  \
                      long long sc, long long sh, long long sw,             \
                      int strip_w, int group_rows, int band_groups,         \
                      int ring_rows, int slot_elems, int strips, int bands, \
                      void* stream) {                                       \
    const Tables tb{lo_h, hi_h, w0_h, w1_h, lo_w, hi_w, w0_w, w1_w};        \
    return launch<T>(x, tb, idx, score, B, C, OH, OW, y0, x0, sb, sc, sh,   \
                     sw, strip_w, group_rows, band_groups, ring_rows,       \
                     slot_elems, strips, bands, stream);                    \
  }                                                                         \
  extern "C" int NAME##_blocks_per_sm(int C, int smem) {                    \
    return blocks_per_sm<T>(C, smem);                                       \
  }

RESIZE_REDUCE_ENTRY(resize_reduce_f32, float)
RESIZE_REDUCE_ENTRY(resize_reduce_bf16, __nv_bfloat16)
