// The phase arithmetic of a learned-3x3-zeropad x2 upsampling stage, as
// the semantic finishers compute it (finisher4x.cu: the 4x finishers'
// stages and the 2x finisher's one), with the rounding points of the TPU
// kernels (nicr_mtsa_tpu/ops/pallas/semantic_finisher.py `phase`,
// semantic_finisher4x.py):
//   out[2i + py][2j + px] = round_T(round_T(acc) + bias),
//   acc = sum over (a, b) in (0,0), (0,1), (1,0), (1,1), in that order, of
//         kt[2a + py][2b + px] * xp[i + a + py][j + b + px]
// for the fused 4x4 kernel kt (values rounded to T) of the 3x3 one and the
// input xp zero-padded by one. Products and sums are __fmul_rn /
// __fadd_rn (the sources are built with -fmad=false): a contracted
// acc + w * x rounds differently, and the rounding to bf16 before the
// bias add can then flip an argmax.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace zeropad_phase {

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(
    __nv_bfloat16 v) {
  return __bfloat162float(v);
}

// round an f32 value to T and back
template <typename T> __device__ __forceinline__ float round_t(float v);
template <> __device__ __forceinline__ float round_t<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ float round_t<__nv_bfloat16>(
    float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// the phase's logit from its acc and the class's bias (an f32 value
// rounded to T)
template <typename T>
__device__ __forceinline__ float logit(float acc, float bias) {
  return round_t<T>(__fadd_rn(round_t<T>(acc), bias));
}

}  // namespace zeropad_phase
