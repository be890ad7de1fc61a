// Offset-vote pixel grouping for Hopper (sm_90a).
//
// Replaces the TPU kernel nicr_mtsa_tpu/ops/pallas/grouping_kernel.py
// (`group_pixels_pallas`): for each pixel, the nearest valid instance
// centre to (pixel + offset) by squared distance. ids are 1..K, 0 for
// background or when no centre is valid; min_d2 is the running minimum
// (3.4e38 when nothing won). Two entries share one kernel template:
// - `group_pixels_f32` takes loc = pixel + offset as (B, P) f32 planes,
//   the TPU kernel's interface (`ops/cuda/grouping.py`
//   `group_pixels_kernel`);
// - `group_pixels_offsets` is the pipeline's (`ops/grouping.py`
//   `group_pixels`): it takes the unnormalised offset map (B, 2, H, W)
//   through its strides in its own dtype, the foreground mask as the
//   bool tensor's bytes through its strides, and the centres as NMS
//   gives them (int32) or in f32; it forms loc = row or column index +
//   f32(offset) (one f32 add, as the JAX package's `group_pixels`) and
//   applies the distance threshold (ids 0 where min_d2 > thr^2). Its
//   min_d2 is 3.4e38 at background pixels, which it need not group.
//
// Semantics kept from the TPU kernel: d2 = fma(dy, dy, dx * dx) with one
// rounding of dx * dx (how XLA lowers the TPU kernel's
// `dy * dy + dx * dx`; written with explicit intrinsics, so neither
// nvcc's contraction nor -fmad=false can change it, and the plain
// PyTorch versions reproduce it exactly); a strict `<` running minimum
// from (3.4e38, -1), so the FIRST minimal centre wins; invalid centres
// never win; ids = fg ? arg + 1 : 0.
//
// What bounds it on an H100: the issue rate. At the serving shape (8 x
// 307200 pixels, 64 centres of which ~70 % valid) the bytes (loc or
// offsets, mask, ids) take 0.0125 ms at 3.35 TB/s, while each pixel and
// valid centre costs 4 f32 operations for d2 plus a compare and two
// selects, ~7 issued instructions: ~0.023 ms at 132 SMs x 128 lanes x
// 1.98 GHz. scripts/grouping_sweep.py times this kernel against the
// valid centres an image and counts its centre loop's instructions
// (PERF.md, row 2): the loads and stores are only partly hidden behind
// the arithmetic. The first form took one pixel a thread and read each
// centre's y and x by two 4-byte shared loads a pixel, ~9.8 M warp-wide
// shared loads that set its pace (~0.075 ms); it looped over invalid
// centres too, and its pipeline call spent ~10 small launches forming
// loc, casting and thresholding around it. The design: a block compacts
// its image's valid centres once into shared memory, in ascending
// original index (so the strict `<` over the compacted list still gives
// the first minimal centre), as interleaved (y, x) pairs with the
// original indices beside them; each thread holds PPT pixels
// (coalesced: pixel tid + i * THREADS of the block's tile) and reads two
// centres by one 16-byte broadcast load, which serves all its pixels.
// The pipeline entry skips a warp none of whose pixels is foreground.
// A grid of one resident wave that loads a tile while it groups the one
// before took more registers and ran slower; other tile shapes ran no
// faster.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int PPT = 8;                   // pixels a thread
constexpr int TILE = THREADS * PPT;      // pixels a block
constexpr float BIG = 3.4e38f;

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(
    __nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_f32<int>(int v) {
  return __int2float_rn(v);
}

// where a block's pixels lie: the loc planes (LOC) or the offset map, and
// the foreground bytes; an image is H x W pixels (LOC: 1 x P)
struct Pixels {
  const void* a;             // LOC: loc_y (B, P) f32; else the offsets
  const float* loc_x;        // LOC: (B, P) f32
  long long sb, sc, sh, sw;  // the offsets' strides, in elements
  const uint8_t* fg;
  long long fsb, fsh, fsw;   // the mask's strides
  int H, W;
};

__device__ __forceinline__ void nearer(float ly, float lx, float cy, float cx,
                                       int j, float& best, int& arg) {
  const float dy = __fsub_rn(ly, cy);
  const float dx = __fsub_rn(lx, cx);
  const float d2 = __fmaf_rn(dy, dy, __fmul_rn(dx, dx));
  if (d2 < best) {               // strict: the first minimal centre wins
    best = d2;
    arg = j;
  }
}

// Block (pixel tile, image). T: the offsets' type (LOC: f32 loc); CT:
// the centres' type. thr2 >= 0: the distance threshold squared (the
// pipeline entry); min_d2 may be null.
template <bool LOC, typename T, typename CT>
__global__ void __launch_bounds__(THREADS)
group_pixels_kernel(Pixels px, const CT* __restrict__ centers,  // (B, K, 2)
                    const uint8_t* __restrict__ valid,           // (B, K)
                    int K, float thr2, int* __restrict__ ids,
                    float* __restrict__ min_d2) {
  extern __shared__ __align__(16) unsigned char smem[];
  float2* cyx = reinterpret_cast<float2*>(smem);   // K rounded up to even
  int* orig = reinterpret_cast<int*>(cyx + ((K + 1) & ~1));
  __shared__ int warp_n[THREADS / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long b = blockIdx.y;

  // the image's valid centres, compacted in ascending original index
  int n = 0;
  for (int j0 = 0; j0 < K; j0 += THREADS) {
    const int j = j0 + tid;
    const bool ok = j < K && valid[b * K + j] != 0;
    const unsigned m = __ballot_sync(0xffffffffu, ok);
    if (lane == 0) warp_n[warp] = __popc(m);
    __syncthreads();
    int pos = n, total = n;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) {
      pos += w < warp ? warp_n[w] : 0;
      total += warp_n[w];
    }
    if (ok) {
      pos += __popc(m & ((1u << lane) - 1u));
      const CT* c = centers + (b * K + j) * 2;
      cyx[pos] = make_float2(to_f32<CT>(c[0]), to_f32<CT>(c[1]));
      orig[pos] = j;
    }
    n = total;
    __syncthreads();
  }

  // this thread's pixels: tid + i * THREADS of the block's tile
  const int W = px.W;
  const long long P = (long long)px.H * W;
  const long long p0 = (long long)blockIdx.x * TILE + tid;
  float ly[PPT], lx[PPT], best[PPT];
  int arg[PPT];
  unsigned fgm = 0;
  int y = (int)(p0 / W), x = (int)(p0 - (long long)y * W);
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    ly[i] = 0.0f;
    lx[i] = 0.0f;
    best[i] = BIG;
    arg[i] = -1;
    if (p0 + i * THREADS < P) {
      if constexpr (LOC) {
        const long long o = b * P + x;
        ly[i] = static_cast<const float*>(px.a)[o];
        lx[i] = px.loc_x[o];
      } else {
        const T* o = static_cast<const T*>(px.a) + b * px.sb + y * px.sh +
                     x * px.sw;
        ly[i] = __fadd_rn(__int2float_rn(y), to_f32<T>(o[0]));
        lx[i] = __fadd_rn(__int2float_rn(x), to_f32<T>(o[px.sc]));
      }
      if (px.fg[b * px.fsb + y * px.fsh + x * px.fsw]) fgm |= 1u << i;
    }
    x += THREADS;
    while (x >= W) {
      x -= W;
      ++y;
    }
  }

  // the loc entry groups every pixel (its min_d2 is the TPU kernel's);
  // the pipeline entry only warps that hold foreground
  if (LOC || __any_sync(0xffffffffu, fgm != 0)) {
    const float4* c2 = reinterpret_cast<const float4*>(cyx);
    int j = 0;
    for (; j + 2 <= n; j += 2) {
      const float4 c = c2[j >> 1];          // two centres, one load
#pragma unroll
      for (int i = 0; i < PPT; ++i)
        nearer(ly[i], lx[i], c.x, c.y, j, best[i], arg[i]);
#pragma unroll
      for (int i = 0; i < PPT; ++i)
        nearer(ly[i], lx[i], c.z, c.w, j + 1, best[i], arg[i]);
    }
    if (j < n) {
      const float2 c = cyx[j];
#pragma unroll
      for (int i = 0; i < PPT; ++i)
        nearer(ly[i], lx[i], c.x, c.y, j, best[i], arg[i]);
    }
  }

#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const long long p = p0 + i * THREADS;
    if (p >= P) break;
    const bool fg = (fgm >> i) & 1u;
    const bool keep = fg && arg[i] >= 0 && (thr2 < 0.0f || best[i] <= thr2);
    ids[b * P + p] = keep ? orig[arg[i]] + 1 : 0;
    if (min_d2 != nullptr) min_d2[b * P + p] = LOC || fg ? best[i] : BIG;
  }
}

template <bool LOC, typename T, typename CT>
int launch(const Pixels& px, const void* centers, const uint8_t* valid,
           int B, int K, float thr2, int* ids, float* min_d2, void* stream) {
  const long long P = (long long)px.H * px.W;
  if (B <= 0 || P <= 0) return (int)cudaSuccess;
  if (K < 0 || B > 65535 || (P + TILE - 1) / TILE > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)((K + 1) & ~1) * sizeof(float2) +
                      (size_t)K * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        group_pixels_kernel<LOC, T, CT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)((P + TILE - 1) / TILE), (unsigned)B);
  group_pixels_kernel<LOC, T, CT><<<grid, THREADS, smem,
                                    static_cast<cudaStream_t>(stream)>>>(
      px, static_cast<const CT*>(centers), valid, K, thr2, ids, min_d2);
  return (int)cudaGetLastError();
}

template <bool LOC, typename T, typename CT>
int occupancy(int K) {
  const size_t smem = (size_t)((K + 1) & ~1) * sizeof(float2) +
                      (size_t)K * sizeof(int);
  int per_sm = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, group_pixels_kernel<LOC, T, CT>, THREADS, smem);
  return e == cudaSuccess ? per_sm : -1;
}

}  // namespace

// loc (B, P) f32 planes, centres (B, K, 2) f32 (ctr_i32 = 0) or int32,
// valid (B, K) and fg (B, P) bytes, all contiguous; ids and min_d2 (B, P)
extern "C" int group_pixels_f32(const float* loc_y, const float* loc_x,
                                const void* centers_yx, int ctr_i32,
                                const uint8_t* valid, const uint8_t* fg,
                                int* ids, float* min_d2, int B, int P, int K,
                                void* stream) {
  const Pixels px{loc_y, loc_x, 0, 0, 0, 0, fg, (long long)P, 0, 1, 1, P};
  return ctr_i32 ? launch<true, float, int>(px, centers_yx, valid, B, K,
                                            -1.0f, ids, min_d2, stream)
                 : launch<true, float, float>(px, centers_yx, valid, B, K,
                                              -1.0f, ids, min_d2, stream);
}

// the offsets (B, 2, H, W) f32 (off_bf16 = 0) or bf16 and the mask
// (B, H, W) bytes through their strides; centres (B, K, 2) f32 or int32
// and valid (B, K) contiguous; thr2 < 0: no threshold; ids (B, H, W),
// min_d2 (B, H, W) or null
extern "C" int group_pixels_offsets(
    const void* offset, int off_bf16, long long sb, long long sc,
    long long sh, long long sw, const uint8_t* fg, long long fsb,
    long long fsh, long long fsw, const void* centers_yx, int ctr_i32,
    const uint8_t* valid, int B, int H, int W, int K, float thr2, int* ids,
    float* min_d2, void* stream) {
  const Pixels px{offset, nullptr, sb, sc, sh, sw, fg, fsb, fsh, fsw, H, W};
  if (off_bf16)
    return ctr_i32 ? launch<false, __nv_bfloat16, int>(
                         px, centers_yx, valid, B, K, thr2, ids, min_d2,
                         stream)
                   : launch<false, __nv_bfloat16, float>(
                         px, centers_yx, valid, B, K, thr2, ids, min_d2,
                         stream);
  return ctr_i32 ? launch<false, float, int>(px, centers_yx, valid, B, K,
                                             thr2, ids, min_d2, stream)
                 : launch<false, float, float>(px, centers_yx, valid, B, K,
                                               thr2, ids, min_d2, stream);
}

// resident blocks an SM at K centres: the loc entry's f32 instance
// (loc = 1) or the pipeline entry's bf16-offset, int32-centre one
extern "C" int group_pixels_blocks_per_sm(int loc, int K) {
  return loc ? occupancy<true, float, float>(K)
             : occupancy<false, __nv_bfloat16, int>(K);
}
