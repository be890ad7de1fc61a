// Fused semantic finishers for Hopper (sm_90a): the 4x finishers (two
// x2 upsampling stages) and the 2x finisher (one stage), as instances of
// one tile template (`finisher_tile<T, EDGE, STAGES, CT>`).
//
// Replaces the TPU kernels nicr_mtsa_tpu/ops/pallas/semantic_finisher4x.py
// (`_finisher4x_call`, reached from `upsample4x_argmax_score` and
// `upsample4x_bilinear_argmax_score`) and nicr_mtsa_tpu/ops/pallas/
// semantic_finisher.py (`upsample2x_argmax_score` -> `_finisher_call`):
// x2 depthwise upsamplings of the semantic logits (two from quarter
// resolution, or one from half resolution), then the first-index argmax
// over the classes and the max-softmax score 1 / sum_c exp(l_c - max) at
// full resolution. No upsampled logits are ever written to device
// memory. Three entries share the template:
// - two learned-3x3-zeropad stages (`finisher4x_*`, EDGE false): the
//   input zero-padded, the stage-2 zero ring applied to the stage-1
//   plane AFTER the stage-1 bias;
// - two half-pixel bilinear stages (`finisher4x_*`, EDGE true; fixed
//   weights, zero biases): the input edge-replicated, no ring;
// - one learned-3x3-zeropad stage (`finisher2x_*`, STAGES 1): the
//   zero-padded input window is the plane that the last stage reads.
//
// Numerics (exactly those of `finisher4x_logits_exact` and
// `zeropad2x_logits_exact`, which are the JAX package's
// `_finisher4x_logits_exact` and `_zeropad_2x_phases_exact`): per phase,
// four taps multiplied and summed in f32 in (a, b) order, rounded to T,
// plus the T-rounded bias in f32, rounded to T (zeropad_phase.cuh); then
// the max, the first class attaining it (strict `>`), and sum
// exp(l - max) in class order (the accurate expf) and its reciprocal.
// Built with -fmad=false, written with _rn intrinsics.
//
// Layout: x is (B, C, H, W) with any strides, read where it lies: on the
// card the model is channels-last, so the head's logits are NHWC in
// memory and a contiguous copy would cost a pass over them. The fused
// 4x4 stage kernels arrive as (C, 16) f32 values rounded to T, the
// biases as (C,) f32 rounded to T. Outputs are (B, 4H, 4W) (two stages)
// or (B, 2H, 2W) (one stage) int32 idx and f32 score. Any B, H, W and
// C; ragged tiles are masked.
//
// What bounds it on an H100: operations. At the 4x serving shape
// (8, 40, 120, 160) bf16 the kernel reads 12.3 MB and writes 19.7 MB
// (~0.0096 ms at 3.35 TB/s), against ~98 M output logits of ~12 f32
// operations each (4 taps, bias, two roundings, compare, subtract, exp,
// add), ~1.4 GFLOP (~0.021 ms at 67 TFLOP/s); the 2x finisher's serving
// shape (8, 40, 240, 320) gives the same 98 M logits from 49 MB of
// input. Issued, with the bf16 unpacking, the shared-memory loads and
// the accurate expf (8 instructions), a logit takes ~32 instructions;
// the measured variants fit a warp's 16-byte shared load costing 4
// cycles of the SM's 128 bytes a cycle even where every lane reads one
// address, so the issue rate and the shared-memory bandwidth bound it
// together (PERF.md). The first forms spent 23-30x their bound: they
// computed every logit twice (a max pass and an exp pass), restaged the
// input (and rebuilt stage 1) one class chunk at a time in both passes,
// behind dependent round trips of 2-byte global loads, and read their
// tap weights from global memory. The design:
// - a block owns one image and a tile_y x tile_x output tile (the host
//   plan `finisher4x.f4_plan`; 32 x 64 at both serving shapes). It
//   stages the tile's padded-input window (two stages: tile_y/4 + 2
//   rows, tile_x/4 + 2 columns; one stage: tile_y/2 + 2 and
//   tile_x/2 + 2; all classes, class fastest) into shared memory once:
//   a channels-last pixel's classes are contiguous, copied by 16-byte
//   cp.async; other layouts by plain loads. The halo is zero-filled
//   (zeropad) or edge-clamped (bilinear) as it is staged. The weights
//   (permuted to [class][phase][tap]) and biases come in by 4-byte
//   cp.async beside it;
// - two stages: stage 1 once for all classes: the tile's stage-1 window
//   (tile_y/2 + 2 x tile_x/2 + 2 values a class) into shared memory in
//   T (each value is T-exact: `logit` rounds to T), a thread a
//   position, 16 bytes of classes at a time, with the ring applied as
//   before. One stage has no stage 1: the staged window is the plane;
// - the last stage and the reduction: each output logit computed once.
//   A thread keeps one column and a phase, so that a warp shares its
//   weight loads' address, and takes two pixels two rows apart at a
//   time: they share a plane row and every weight and bias load
//   (16-byte shared loads of 4 weights of a class, of 8 bf16 taps). At
//   C = 40 (both served configurations) the 40 logits of both pixels
//   stay in registers, two bf16 to a register; the max is a packed bf16
//   max, the argmax the first class equal to it, the exp sum in class
//   order over the registers. Any other C takes the generic instance,
//   which recomputes the logits from shared memory in each pass.
// Launch bounds of 2 blocks an SM: 128 registers, no spills (one pixel
// at a time in 80 registers at 3 blocks an SM ran 4 % slower; a stage-1
// window in f32, without the unpacking, ran slower still on the shared-
// memory bandwidth; weights in the constant bank, a copy of stage 2 a
// phase, far slower).
#include <math.h>
#include <stdint.h>

#include "zeropad_phase.cuh"

namespace {

using namespace zeropad_phase;

constexpr int THREADS = 256;
constexpr int FAST_C = 40;      // both served configurations' classes

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

template <typename T> __device__ __forceinline__ T zero_t();
template <> __device__ __forceinline__ float zero_t<float>() { return 0.0f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero_t<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.0f);
}

// V = 16 / sizeof(T) values of T in one 16-byte word, as f32
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int V = 4;
  __device__ __forceinline__ static void unpack(const uint4& q, float* f) {
    f[0] = __uint_as_float(q.x);
    f[1] = __uint_as_float(q.y);
    f[2] = __uint_as_float(q.z);
    f[3] = __uint_as_float(q.w);
  }
  // f rounded to T (no-op) and packed
  __device__ __forceinline__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int V = 8;
  __device__ __forceinline__ static void unpack(const uint4& q, float* f) {
    const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static unsigned pack2(float lo, float hi) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const unsigned*>(&p);
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]),
                      pack2(f[4], f[5]), pack2(f[6], f[7]));
  }
};

// one phase's acc: w holds the phase's 4 tap weights in (a, b) order,
// x00..x11 the stage input at (a, b)
__device__ __forceinline__ float taps4(const float4& w, float x00, float x01,
                                       float x10, float x11) {
  float acc = __fmul_rn(w.x, x00);
  acc = __fadd_rn(acc, __fmul_rn(w.y, x01));
  acc = __fadd_rn(acc, __fmul_rn(w.z, x10));
  return __fadd_rn(acc, __fmul_rn(w.w, x11));
}

// round_t of V accs, two at a time where T is bf16
template <typename T>
__device__ __forceinline__ void round_v(float* acc) {
  if (sizeof(T) == 2) {
#pragma unroll
    for (int v = 0; v < Vec<T>::V; v += 2) {
      const __nv_bfloat162 p = __floats2bfloat162_rn(acc[v], acc[v + 1]);
      acc[v] = __low2float(p);
      acc[v + 1] = __high2float(p);
    }
  }
}

struct Geom {
  int C, H, W;
  long long sb, sc, sh, sw;
  int tile_y, tile_x;
  int vec;                    // the window staged by 16-byte cp.async
};

// classes of the staged windows: C rounded up to whole 16-byte words
__host__ __device__ __forceinline__ int padded_classes(int C, int elt) {
  const int v = 16 / elt;
  return (C + v - 1) / v * v;
}

// bias values a stage: C rounded up to whole 32-byte words (at least
// the padded classes of either dtype)
__host__ __device__ __forceinline__ int bias_len(int C) {
  return (C + 7) / 8 * 8;
}

// dynamic shared memory of a tile of `stages` stages: the padded-input
// window and (two stages) the stage-1 window, both [row][col][class] in
// T; the permuted (C, 16) kernels and the biases of each stage in f32
__host__ __device__ __forceinline__ int smem_bytes(int C, int elt,
                                                   int tile_y, int tile_x,
                                                   int stages) {
  const int cp = padded_classes(C, elt);
  const int plane = (tile_y / 2 + 2) * (tile_x / 2 + 2);
  const int win = (stages == 2 ? (tile_y / 4 + 2) * (tile_x / 4 + 2) + plane
                               : plane) * cp * elt;
  return win + stages * (C * 16 * 4 + bias_len(C) * 4);
}

// the V biases of classes [c0, c0 + V) (c0 a multiple of V)
template <int V>
__device__ __forceinline__ void biases(const float* bs, int c0, float* out) {
#pragma unroll
  for (int v = 0; v < V; v += 4) {
    const float4 q = reinterpret_cast<const float4*>(bs + c0)[v / 4];
    out[v] = q.x;
    out[v + 1] = q.y;
    out[v + 2] = q.z;
    out[v + 3] = q.w;
  }
}

__device__ __forceinline__ __nv_bfloat162 as_bf162(unsigned w) {
  return *reinterpret_cast<const __nv_bfloat162*>(&w);
}

// max, first argmax and exp sum of NC bf16 logits packed two a register:
// the max as a packed bf16 max (NaN ignored, as `l > m` ignores it), the
// argmax the first class equal to it (IEEE equality: -0 == +0), the exp
// sum in class order
template <int NC>
__device__ __forceinline__ void reduce_bf16(const uint4 (&lg)[NC / 8],
                                            float& m, int& arg, float& s) {
  const unsigned* w = reinterpret_cast<const unsigned*>(lg);
  __nv_bfloat162 mx = as_bf162(w[0]);
#pragma unroll
  for (int i = 1; i < NC / 2; ++i) mx = __hmax2(mx, as_bf162(w[i]));
  m = fmaxf(__low2float(mx), __high2float(mx));
  const __nv_bfloat162 m2 = __floats2bfloat162_rn(m, m);
  arg = 0;
#pragma unroll
  for (int i = NC / 2 - 1; i >= 0; --i) {
    const unsigned eq = __heq2_mask(as_bf162(w[i]), m2);
    if (eq) arg = (eq & 0xffffu) ? 2 * i : 2 * i + 1;
  }
  s = 0.0f;
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) {
    s = __fadd_rn(s, expf(__fsub_rn(__uint_as_float(w[i] << 16), m)));
    s = __fadd_rn(s, expf(__fsub_rn(__uint_as_float(w[i] & 0xffff0000u),
                                    m)));
  }
}

// the same of NC f32 logits, in order: strict `>` (the first index wins)
template <int NC>
__device__ __forceinline__ void reduce_f32(const uint4 (&lg)[NC / 4],
                                           float& m, int& arg, float& s) {
  const float* l = reinterpret_cast<const float*>(lg);
  m = -INFINITY;
  arg = 0;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    if (l[c] > m) {
      m = l[c];
      arg = c;
    }
  }
  s = 0.0f;
#pragma unroll
  for (int c = 0; c < NC; ++c) s = __fadd_rn(s, expf(__fsub_rn(l[c], m)));
}

// the NC logits (rounded to T) of one pixel of phase ph, its four
// stage-1 taps of a class at p00[c], p00[NC + c], p00[row + c] and
// p00[row + NC + c]
template <typename T, int NC>
__device__ __forceinline__ void pixel_logits(const T* p00, int row,
                                             const float4* k2q,
                                             const float* b2s, int ph,
                                             uint4 (&lg)[NC / Vec<T>::V]) {
  using VT = Vec<T>;
  constexpr int V = VT::V;
#pragma unroll
  for (int w16 = 0; w16 < NC / V; ++w16) {
    float x00[V], x01[V], x10[V], x11[V], acc[V], bias[V];
    const uint4* q00 = reinterpret_cast<const uint4*>(p00) + w16;
    const uint4* q10 = reinterpret_cast<const uint4*>(p00 + row) + w16;
    VT::unpack(q00[0], x00);
    VT::unpack(q00[NC / V], x01);
    VT::unpack(q10[0], x10);
    VT::unpack(q10[NC / V], x11);
#pragma unroll
    for (int v = 0; v < V; ++v)
      acc[v] = taps4(k2q[(w16 * V + v) * 4 + ph], x00[v], x01[v], x10[v],
                     x11[v]);
    round_v<T>(acc);
    biases<V>(b2s, w16 * V, bias);
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = __fadd_rn(acc[v], bias[v]);
    lg[w16] = VT::pack(acc);          // the final rounding to T
  }
}

// the same for two pixels of phase ph two rows apart (bf16): the first's
// taps in stage-1 rows p00 and p00 + row, the second's in p00 + row and
// p00 + 2 row; the two share the middle row's loads and every weight
// and bias load
template <int NC>
__device__ __forceinline__ void pair_logits(const __nv_bfloat16* p00, int row,
                                            const float4* k2q,
                                            const float* b2s, int ph,
                                            uint4 (&la)[NC / 8],
                                            uint4 (&lb)[NC / 8]) {
  using VT = Vec<__nv_bfloat16>;
#pragma unroll
  for (int w16 = 0; w16 < NC / 8; ++w16) {
    float x0[8], x1[8], y0[8], y1[8], z0[8], z1[8], acc[8], acd[8], bias[8];
    const uint4* q0 = reinterpret_cast<const uint4*>(p00) + w16;
    const uint4* q1 = reinterpret_cast<const uint4*>(p00 + row) + w16;
    const uint4* q2 = reinterpret_cast<const uint4*>(p00 + 2 * row) + w16;
    VT::unpack(q0[0], x0);
    VT::unpack(q0[NC / 8], x1);
    VT::unpack(q1[0], y0);
    VT::unpack(q1[NC / 8], y1);
    VT::unpack(q2[0], z0);
    VT::unpack(q2[NC / 8], z1);
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      const float4 w = k2q[(w16 * 8 + v) * 4 + ph];
      acc[v] = taps4(w, x0[v], x1[v], y0[v], y1[v]);
      acd[v] = taps4(w, y0[v], y1[v], z0[v], z1[v]);
    }
    round_v<__nv_bfloat16>(acc);
    round_v<__nv_bfloat16>(acd);
    biases<8>(b2s, w16 * 8, bias);
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      acc[v] = __fadd_rn(acc[v], bias[v]);
      acd[v] = __fadd_rn(acd[v], bias[v]);
    }
    la[w16] = VT::pack(acc);
    lb[w16] = VT::pack(acd);
  }
}

// One block's tile (block (tile column, tile row, image)), in phases
// behind barriers: stage the window, weights and biases; (two stages)
// stage 1 into shared memory; the last stage and the reduction, two
// pixels a thread at a time. STAGES: 2 (the 4x finishers) or 1 (the 2x
// finisher); CT: the class count the instance is specialised on (0:
// any).
template <typename T, bool EDGE, int STAGES, int CT>
__device__ __forceinline__ void finisher_tile(
    unsigned char* smem_raw, const T* __restrict__ x,
    const float* __restrict__ k1, const float* __restrict__ b1,
    const float* __restrict__ k2, const float* __restrict__ b2,
    int* __restrict__ idx_out, float* __restrict__ score_out,
    const Geom& g) {
  using VT = Vec<T>;
  constexpr int V = VT::V;
  static_assert(CT % V == 0, "a specialised class count fills 16 bytes");
  static_assert(STAGES == 2 || (STAGES == 1 && !EDGE),
                "one stage is the learned-zeropad x2 finisher");
  const int C = CT > 0 ? CT : g.C;
  const int CP = CT > 0 ? CT : padded_classes(g.C, sizeof(T));
  const int NG = CP / V;                       // 16-byte words a position
  const int H = g.H, W = g.W;
  const int TY = g.tile_y, TX = g.tile_x;
  // the plane the last stage reads: the stage-1 window (two stages) or
  // the padded-input window (one stage)
  const int R1 = TY / 2 + 2, S1 = TX / 2 + 2;
  // the staged padded-input window
  const int PR = STAGES == 2 ? TY / 4 + 2 : R1;
  const int PC = STAGES == 2 ? TX / 4 + 2 : S1;
  T* win = reinterpret_cast<T*>(smem_raw);
  T* inter = STAGES == 2 ? win + PR * PC * CP : win;
  // [k1 (two stages)][k2][b1 (two stages)][b2]
  float* k1s = reinterpret_cast<float*>(inter + R1 * S1 * CP);
  float* k2s = k1s + (STAGES - 1) * C * 16;
  float* b1s = k2s + C * 16;
  float* b2s = b1s + (STAGES - 1) * bias_len(C);
  const float4* k1q = reinterpret_cast<const float4*>(k1s);
  const float4* k2q = reinterpret_cast<const float4*>(k2s);

  const int tid = threadIdx.x;
  const long long b = blockIdx.z;
  const int Y0 = blockIdx.y * TY, X0 = blockIdx.x * TX;
  const int Q0 = Y0 / 2, S0 = X0 / 2;   // first plane row / col
  // first padded-input row / col of the staged window
  const int I0 = STAGES == 2 ? Q0 / 2 : Q0, J0 = STAGES == 2 ? S0 / 2 : S0;
  const int QMAX = 2 * H + 1, SMAX = 2 * W + 1;
  const T* xb = x + b * g.sb;

  // the padded-input window: padded (I0 + i, J0 + j) is input
  // (I0 + i - 1, J0 + j - 1), zero outside (zeropad) or clamped
  // (bilinear)
  const int n_win = PR * PC;
  if (g.vec) {
    for (int e = tid; e < n_win * NG; e += THREADS) {
      const int pos = e / NG, w16 = e - pos * NG;
      const int i = pos / PC, j = pos - i * PC;
      int y = I0 + i - 1, xx = J0 + j - 1;
      T* dst = win + pos * CP + w16 * V;
      if (EDGE) {
        y = min(max(y, 0), H - 1);
        xx = min(max(xx, 0), W - 1);
      } else if (y < 0 || y >= H || xx < 0 || xx >= W) {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
        continue;
      }
      cp_async16(dst, xb + y * g.sh + xx * g.sw + w16 * V);
    }
  } else {
    // class planes (NCHW): along the columns; else along the classes
    const bool cols_fastest = g.sw < g.sc;
    for (int e = tid; e < n_win * CP; e += THREADS) {
      int pos, c;
      if (cols_fastest) {
        c = e / n_win;
        pos = e - c * n_win;
      } else {
        pos = e / CP;
        c = e - pos * CP;
      }
      const int i = pos / PC, j = pos - i * PC;
      int y = I0 + i - 1, xx = J0 + j - 1;
      T v = zero_t<T>();
      if (EDGE) {
        y = min(max(y, 0), H - 1);
        xx = min(max(xx, 0), W - 1);
      }
      if (c < C && y >= 0 && y < H && xx >= 0 && xx < W)
        v = xb[c * g.sc + y * g.sh + xx * g.sw];
      win[pos * CP + c] = v;
    }
  }
  // weights [class][phase (py, px)][tap (a, b)] from (C, 16) row-major
  // [2a + py][2b + px], by 4-byte cp.async beside the window's copies;
  // biases padded with zeros
  for (int e = tid; e < C * 16; e += THREADS) {
    const int c = e >> 4, ph = (e >> 2) & 3, j = e & 3;
    const int src = c * 16 + (2 * (j >> 1) + (ph >> 1)) * 4 +
                    2 * (j & 1) + (ph & 1);
    if constexpr (STAGES == 2) cp_async4(k1s + e, k1 + src);
    cp_async4(k2s + e, k2 + src);
  }
  for (int e = tid; e < bias_len(C); e += THREADS) {
    if (e < C) {
      if constexpr (STAGES == 2) cp_async4(b1s + e, b1 + e);
      cp_async4(b2s + e, b2 + e);
    } else {
      if constexpr (STAGES == 2) b1s[e] = 0.0f;
      b2s[e] = 0.0f;
    }
  }
  cp_async_wait_all();
  __syncthreads();

  if constexpr (STAGES == 2) {
    // stage 1: value (q, s) of the (2H + 2, 2W + 2) plane is phase
    // (py, px) = ((q + 1) & 1, (s + 1) & 1) of padded input (q >> 1,
    // s >> 1). A thread a position, all its classes, 16 bytes at a
    // time: a warp's threads read 4 weight addresses at a time, and
    // their consecutive positions (80 bytes apart at C = 40 bf16) meet
    // no bank twice in a quarter warp
    const int n1 = R1 * S1;
    for (int pos = tid; pos < n1; pos += THREADS) {
      const int qi = pos / S1, si = pos - qi * S1;
      const int q = Q0 + qi, s = S0 + si;
      const int ph = ((q + 1) & 1) * 2 + ((s + 1) & 1);
      const T* p0 = win + (((q >> 1) - I0) * PC + (s >> 1) - J0) * CP;
      // beyond the plane, and (zeropad) the stage-2 zero ring after the
      // bias: 0 (0 rounds to 0)
      const bool zero = q > QMAX || s > SMAX ||
                        (!EDGE && (q == 0 || q == QMAX || s == 0 ||
                                   s == SMAX));
#pragma unroll
      for (int w16 = 0; w16 < NG; ++w16) {
        const T* p00 = p0 + w16 * V;
        float x00[V], x01[V], x10[V], x11[V], acc[V], bias[V];
        VT::unpack(*reinterpret_cast<const uint4*>(p00), x00);
        VT::unpack(*reinterpret_cast<const uint4*>(p00 + CP), x01);
        VT::unpack(*reinterpret_cast<const uint4*>(p00 + PC * CP), x10);
        VT::unpack(*reinterpret_cast<const uint4*>(p00 + (PC + 1) * CP),
                   x11);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const int c = w16 * V + v;
          // (padded classes of the generic instance: 0)
          acc[v] = CT > 0 || c < C ? taps4(k1q[c * 4 + ph], x00[v], x01[v],
                                           x10[v], x11[v])
                                   : 0.0f;
        }
        round_v<T>(acc);
        biases<V>(b1s, w16 * V, bias);
#pragma unroll
        for (int v = 0; v < V; ++v)
          acc[v] = zero ? 0.0f : __fadd_rn(acc[v], bias[v]);
        *reinterpret_cast<uint4*>(inter + pos * CP + w16 * V) =
            VT::pack(acc);
      }
    }
    __syncthreads();
  }

  // the last stage and the reduction: output (Y, X) is phase (qy, qx) =
  // (Y & 1, X & 1) of value (Y >> 1, X >> 1) of the plane (the ringed
  // stage-1 plane, or the zero-padded input). A thread keeps one column
  // of the tile; the first half of a row's threads take the even
  // columns, the second half the odd ones, so that a warp's threads
  // share a phase and read the same weights. With n = THREADS / tile_x
  // threads a column (n even: tile_x divides THREADS / 2), thread t of a
  // column takes the row pairs (r, r + 2), r = 4 (t / 2) + t % 2 + 2 n k:
  // rows of one phase, whose taps share a plane row
  const int HO = (2 << (STAGES - 1)) * H, WO = (2 << (STAGES - 1)) * W;
  const int jx = tid % TX, half = TX / 2;
  const int X = X0 + (jx < half ? 2 * jx : 2 * (jx - half) + 1);
  if (X >= WO) return;
  const int qx = X & 1, t = tid / TX, row = S1 * CP;
  for (int r = (t >> 1) * 4 + (t & 1); r < TY && Y0 + r < HO;
       r += 2 * (THREADS / TX)) {
    const int Y = Y0 + r;
    const int qy = Y & 1, ph = qy * 2 + qx;
    const T* p00 = inter + (((Y >> 1) + qy - Q0) * S1 + (X >> 1) + qx - S0) *
                               CP;
    const long long o = (b * HO + Y) * WO + X;
    const int n_px = Y + 2 < HO ? 2 : 1;
    float m, s;
    int arg;
    if constexpr (CT > 0 && sizeof(T) == 2) {
      // the CT logits of both pixels, rounded to bf16, in registers
      // (two a register)
      uint4 la[CT / 8], lb[CT / 8];
      pair_logits<CT>(p00, row, k2q, b2s, ph, la, lb);
      reduce_bf16<CT>(la, m, arg, s);
      idx_out[o] = arg;
      score_out[o] = __fdiv_rn(1.0f, s);
      if (n_px == 2) {
        reduce_bf16<CT>(lb, m, arg, s);
        idx_out[o + 2 * WO] = arg;
        score_out[o + 2 * WO] = __fdiv_rn(1.0f, s);
      }
    } else {
      for (int k = 0; k < n_px; ++k) {
        const T* q00 = p00 + k * row;
        if constexpr (CT > 0) {
          // the CT f32 logits in registers
          uint4 lg[CT / V];
          pixel_logits<T, CT>(q00, row, k2q, b2s, ph, lg);
          reduce_f32<CT>(lg, m, arg, s);
        } else {
          auto logit_at = [&](int c) {
            return logit<T>(taps4(k2q[c * 4 + ph], to_f32<T>(q00[c]),
                                  to_f32<T>(q00[CP + c]),
                                  to_f32<T>(q00[row + c]),
                                  to_f32<T>(q00[row + CP + c])),
                            b2s[c]);
          };
          m = -INFINITY;
          arg = 0;
          s = 0.0f;
          for (int c = 0; c < C; ++c) {
            const float l = logit_at(c);
            if (l > m) {              // strict: first index wins
              m = l;
              arg = c;
            }
          }
          for (int c = 0; c < C; ++c)
            s = __fadd_rn(s, expf(__fsub_rn(logit_at(c), m)));
        }
        idx_out[o + 2 * k * WO] = arg;
        score_out[o + 2 * k * WO] = __fdiv_rn(1.0f, s);
      }
    }
  }
}

// the 4x finishers: two stages, learned-zeropad or (EDGE) bilinear
template <typename T, bool EDGE, int CT>
__global__ void __launch_bounds__(THREADS, 2)
finisher4x_kernel(const T* __restrict__ x, const float* __restrict__ k1,
                  const float* __restrict__ b1,
                  const float* __restrict__ k2,
                  const float* __restrict__ b2, int* __restrict__ idx_out,
                  float* __restrict__ score_out, Geom g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  finisher_tile<T, EDGE, 2, CT>(smem_raw, x, k1, b1, k2, b2, idx_out,
                                score_out, g);
}

// the 2x finisher: one learned-zeropad stage (k2, b2)
template <typename T, int CT>
__global__ void __launch_bounds__(THREADS, 2)
finisher2x_kernel(const T* __restrict__ x, const float* __restrict__ k,
                  const float* __restrict__ bias, int* __restrict__ idx_out,
                  float* __restrict__ score_out, Geom g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  finisher_tile<T, false, 1, CT>(smem_raw, x, nullptr, nullptr, k, bias,
                                 idx_out, score_out, g);
}

// the kernel of an instance: (stages, EDGE, C specialised or 0)
template <typename T, int STAGES, bool EDGE, int CT>
const void* kernel_fn() {
  if constexpr (STAGES == 2)
    return (const void*)finisher4x_kernel<T, EDGE, CT>;
  else
    return (const void*)finisher2x_kernel<T, CT>;
}

template <typename T, int STAGES, bool EDGE, int CT>
int set_smem(int smem) {
  return (int)cudaFuncSetAttribute(
      kernel_fn<T, STAGES, EDGE, CT>(),
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <typename T, int STAGES, bool EDGE, int CT>
int launch_one(const T* x, const float* k1, const float* b1, const float* k2,
               const float* b2, int* idx, float* score, const Geom& g,
               int B, int smem, cudaStream_t st) {
  const int err = set_smem<T, STAGES, EDGE, CT>(smem);
  if (err != (int)cudaSuccess) return err;
  const int up = 2 << (STAGES - 1);
  const dim3 grid((unsigned)((up * g.W + g.tile_x - 1) / g.tile_x),
                  (unsigned)((up * g.H + g.tile_y - 1) / g.tile_y),
                  (unsigned)B);
  if constexpr (STAGES == 2)
    finisher4x_kernel<T, EDGE, CT><<<grid, THREADS, smem, st>>>(
        x, k1, b1, k2, b2, idx, score, g);
  else
    finisher2x_kernel<T, CT><<<grid, THREADS, smem, st>>>(x, k2, b2, idx,
                                                          score, g);
  return (int)cudaGetLastError();
}

template <typename T, int STAGES>
int launch(const void* xv, const float* k1, const float* b1, const float* k2,
           const float* b2, int* idx, float* score, int B, int C, int H,
           int W, long long sb, long long sc, long long sh, long long sw,
           int edge, int tile_y, int tile_x, int vec, void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  if (tile_y <= 0 || tile_x <= 0 || tile_y % 4 || tile_x % 4 ||
      (THREADS / 2) % tile_x || B > 65535 ||
      ((2LL << (STAGES - 1)) * H + tile_y - 1) / tile_y > 65535)
    return (int)cudaErrorInvalidValue;
  const T* x = static_cast<const T*>(xv);
  const long long elt = sizeof(T);
  // the host plan's `vec` (finisher4x.f4_plan), held to what the
  // 16-byte copies need
  if (vec && !(sc == 1 && (C * elt) % 16 == 0 && (sw * elt) % 16 == 0 &&
               (sh * elt) % 16 == 0 && (sb * elt) % 16 == 0 &&
               reinterpret_cast<uintptr_t>(x) % 16 == 0))
    return (int)cudaErrorInvalidValue;
  const Geom g{C, H, W, sb, sc, sh, sw, tile_y, tile_x, vec};
  const int smem = smem_bytes(C, (int)elt, tile_y, tile_x, STAGES);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool fast = C == FAST_C;
  if constexpr (STAGES == 2) {
    if (edge)
      return fast ? launch_one<T, 2, true, FAST_C>(x, k1, b1, k2, b2, idx,
                                                   score, g, B, smem, st)
                  : launch_one<T, 2, true, 0>(x, k1, b1, k2, b2, idx, score,
                                              g, B, smem, st);
  }
  return fast ? launch_one<T, STAGES, false, FAST_C>(x, k1, b1, k2, b2, idx,
                                                     score, g, B, smem, st)
              : launch_one<T, STAGES, false, 0>(x, k1, b1, k2, b2, idx,
                                                score, g, B, smem, st);
}

// resident blocks an SM of the zeropad instance of `STAGES` stages that
// takes C classes, at a tile's shared memory (-1 on error)
template <typename T, int STAGES>
int blocks_per_sm(int C, int tile_y, int tile_x) {
  const int smem = smem_bytes(C, sizeof(T), tile_y, tile_x, STAGES);
  const bool fast = C == FAST_C;
  if ((fast ? set_smem<T, STAGES, false, FAST_C>(smem)
            : set_smem<T, STAGES, false, 0>(smem)) != (int)cudaSuccess)
    return -1;
  int per_sm = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm,
      fast ? kernel_fn<T, STAGES, false, FAST_C>()
           : kernel_fn<T, STAGES, false, 0>(),
      THREADS, smem);
  return err == cudaSuccess ? per_sm : -1;
}

}  // namespace

#define FINISHER4X_ENTRY(NAME, T)                                           \
  extern "C" int NAME(const void* x, const float* k1, const float* b1,      \
                      const float* k2, const float* b2, int* idx,           \
                      float* score, int B, int C, int H, int W,             \
                      long long sb, long long sc, long long sh,             \
                      long long sw, int edge, int tile_y, int tile_x,       \
                      int vec, void* stream) {                              \
    return launch<T, 2>(x, k1, b1, k2, b2, idx, score, B, C, H, W, sb, sc,  \
                        sh, sw, edge, tile_y, tile_x, vec, stream);         \
  }                                                                         \
  extern "C" int NAME##_blocks_per_sm(int C, int tile_y, int tile_x) {      \
    return blocks_per_sm<T, 2>(C, tile_y, tile_x);                          \
  }

#define FINISHER2X_ENTRY(NAME, T)                                           \
  extern "C" int NAME(const void* x, const float* k, const float* bias,     \
                      int* idx, float* score, int B, int C, int H, int W,   \
                      long long sb, long long sc, long long sh,             \
                      long long sw, int tile_y, int tile_x, int vec,        \
                      void* stream) {                                       \
    return launch<T, 1>(x, nullptr, nullptr, k, bias, idx, score, B, C, H,  \
                        W, sb, sc, sh, sw, 0, tile_y, tile_x, vec, stream); \
  }                                                                         \
  extern "C" int NAME##_blocks_per_sm(int C, int tile_y, int tile_x) {      \
    return blocks_per_sm<T, 1>(C, tile_y, tile_x);                          \
  }

FINISHER4X_ENTRY(finisher4x_f32, float)
FINISHER4X_ENTRY(finisher4x_bf16, __nv_bfloat16)
FINISHER2X_ENTRY(finisher2x_f32, float)
FINISHER2X_ENTRY(finisher2x_bf16, __nv_bfloat16)
