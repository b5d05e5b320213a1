// The activation quant's arithmetic for Hopper (sm_90a), one device
// function per step, shared by every kernel that quantizes activations:
//   to_f32/from_f32  T <-> f32 (round to nearest even), which the
//                    stand-alone block-CAT and Hadamard share
//   asym_params/asym_code  asymmetric: scale = max(ymax - ymin, 1e-12) *
//                    f32(1 / (2^bits - 1)), zp = rint(-ymin / scale),
//                    codes rint(y / scale + zp) shifted by 2^(bits-1)
//                    (signed)
//   sym_params/sym_code    symmetric: scale = max(amax, 1e-12) *
//                    f32(1 / (2^(bits-1) - 1)), zp = 0, codes
//                    clamp(rint(y / scale), -2^(bits-1), 2^(bits-1) - 1)
//   asym_code_of/sym_code_of  the same codes from the quotient y / scale
//   quot/quot_exact  y / scale rounded as the IEEE division rounds it,
//                    from the row's f32 reciprocal without a branch
// The scale is the compiled reference's multiply by the f32 reciprocal;
// the divisions by the scale stay IEEE divisions, rintf is round half to
// even (jnp.round), and nothing is FMA-contracted. The stand-alone quant
// (dynamic_quant.cu) and the cluster transform (cluster_tq.cuh) both
// quantize with these functions, so every path computes a code with the
// same arithmetic.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

namespace tq {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// f32 -> T, rounding to nearest even as torch's .to(dtype) does.
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The asymmetric quant of a row whose values span [ymin, ymax], at
// `bits`: the scale is the range times the f32 reciprocal of the level
// count (one rounded multiply, as XLA compiles the reference), the zero
// point rint(-ymin / scale) (IEEE division).
__device__ __forceinline__ void asym_params(float ymin, float ymax, int bits,
                                            float* scale, float* zp) {
  const float levels = (float)((1 << bits) - 1);
  *scale = __fmul_rn(fmaxf(__fsub_rn(ymax, ymin), 1e-12f), 1.f / levels);
  *zp = rintf(-ymin / *scale);
}

// The signed-shifted code of a value whose quotient by asym_params' scale
// is q: clamp(rint(q + zp), 0, 2^bits - 1) - 2^(bits-1).
__device__ __forceinline__ int8_t asym_code_of(float q, float zp, int bits) {
  const float levels = (float)((1 << bits) - 1);
  const float v = rintf(__fadd_rn(q, zp));
  return (int8_t)(fminf(fmaxf(v, 0.f), levels) - (float)(1 << (bits - 1)));
}

// The signed-shifted code of y under asym_params' scale and zero point:
// clamp(rint(y / scale + zp), 0, 2^bits - 1) - 2^(bits-1).
__device__ __forceinline__ int8_t asym_code(float y, float scale, float zp,
                                            int bits) {
  return asym_code_of(y / scale, zp, bits);
}

// The symmetric scale of a row whose values span [ymin, ymax], at `bits`:
// the absolute maximum times the f32 reciprocal of 2^(bits-1) - 1 (one
// rounded multiply, as XLA compiles the reference).
__device__ __forceinline__ float sym_params(float ymin, float ymax,
                                            int bits) {
  const float qmax = (float)((1 << (bits - 1)) - 1);
  return __fmul_rn(fmaxf(fmaxf(fabsf(ymin), fabsf(ymax)), 1e-12f),
                   1.f / qmax);
}

// The symmetric code of a value whose quotient by sym_params' scale is
// q: clamp(rint(q), -2^(bits-1), 2^(bits-1) - 1).
__device__ __forceinline__ int8_t sym_code_of(float q, int bits) {
  const float qmax = (float)((1 << (bits - 1)) - 1);
  return (int8_t)fminf(fmaxf(rintf(q), -qmax - 1.f), qmax);
}

// The symmetric code of y under sym_params' scale:
// clamp(rint(y / scale), -2^(bits-1), 2^(bits-1) - 1).
__device__ __forceinline__ int8_t sym_code(float y, float scale, int bits) {
  return sym_code_of(y / scale, bits);
}

// y / scale as the IEEE division rounds it, from rcp = __frcp_rn(scale)
// (the correctly rounded reciprocal) with one multiply and two fma and no
// branch: with rcp within half an ulp of 1 / scale and q within one ulp
// of y / scale, the remainder y - scale * q is exact in one fma and
// q + remainder * rcp rounds to the correctly rounded quotient
// (Markstein's theorem), while nothing under- or overflows. The IEEE
// division instead checks every operand's range and may branch per
// element. quot_exact says whether a row qualifies: its rcp is a normal
// number and no |y| * rcp overflows. Nothing underflows either where the
// quotient's bits matter: the scale is at least 1e-12 / 255 > 2^-48, so
// for |y / scale| >= 1/4 the remainder's bits lie above 2^-100, and a
// smaller quotient rounds to the same code (0, or the zero point) whatever
// its last bits.
__device__ __forceinline__ float quot(float y, float scale, float rcp) {
  const float q = __fmul_rn(y, rcp);
  return __fmaf_rn(__fmaf_rn(-scale, q, y), rcp, q);
}

// Whether quot(y, scale, rcp) is the IEEE y / scale for every |y| <= amax
// of a row (false for a NaN or infinite scale or amax).
__device__ __forceinline__ bool quot_exact(float scale, float rcp,
                                           float amax) {
  return scale < 0x1p100f && __fmul_rn(amax, rcp) < 0x1p100f;
}

}  // namespace tq
