// Activation rows through the dynamic per-token quant, for Hopper
// (sm_90a), one device function per step:
//   to_f32/from_f32  T <-> f32 (round to nearest even), which the
//                    stand-alone block-CAT and Hadamard share
//   load_rows        x (T) -> f32 in shared memory
//   row_ranges       each row's min and max
//   quant_rows       asymmetric: scale = max(ymax - ymin, 1e-12) *
//                    f32(1 / (2^bits - 1)), zp = rint(-ymin / scale),
//                    codes rint(y / scale + zp) shifted by 2^(bits-1)
//                    (signed); symmetric: scale = max(amax, 1e-12) *
//                    f32(1 / (2^(bits-1) - 1)), zp = 0. The scale is the
//                    compiled reference's multiply by the f32 reciprocal;
//                    the divisions by the scale stay IEEE divisions.
//   asym_params/asym_code  that asymmetric arithmetic for one row / value,
//                    which the cluster transform (cluster_tq.cuh) shares.
// The stand-alone quant (dynamic_quant.cu) calls the steps one by one;
// the cluster kernels quantize with asym_params/asym_code, so every path
// computes a code with the same arithmetic. Every function takes m <= MAXR
// rows of d values (row stride d), must be called by every thread of the
// block, and ends with a barrier, so its outputs are visible to the whole
// block.
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

// s_x[i] = f32(x[i]) for i < n.
template <typename T>
__device__ void load_rows(const T* __restrict__ x, int n, float* s_x) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) s_x[i] = to_f32(x[i]);
  __syncthreads();
}

// Each row's min and max over d values, one partial per warp in
// red_min/red_max[r * 32 + warp] (MAXR * 32 floats each); quant_rows
// finishes the reduction.
template <int MAXR>
__device__ void row_ranges(const float* s_y, int m, int d, float* red_min,
                           float* red_max) {
  const int tid = threadIdx.x, nt = blockDim.x;
  float lmin[MAXR], lmax[MAXR];
#pragma unroll
  for (int r = 0; r < MAXR; ++r) { lmin[r] = INFINITY; lmax[r] = -INFINITY; }
  for (int idx = tid; idx < d; idx += nt) {
#pragma unroll
    for (int r = 0; r < MAXR; ++r) {
      if (r < m) {
        lmin[r] = fminf(lmin[r], s_y[r * d + idx]);
        lmax[r] = fmaxf(lmax[r], s_y[r * d + idx]);
      }
    }
  }
  const int warp = tid >> 5, lane = tid & 31;
#pragma unroll
  for (int r = 0; r < MAXR; ++r) {
    float mn = lmin[r], mx = lmax[r];
    for (int off = 16; off > 0; off >>= 1) {
      mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, off));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    }
    if (lane == 0) { red_min[r * 32 + warp] = mn; red_max[r * 32 + warp] = mx; }
  }
  __syncthreads();
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

// The signed-shifted code of y under asym_params' scale and zero point:
// clamp(rint(y / scale + zp), 0, 2^bits - 1) - 2^(bits-1).
__device__ __forceinline__ int8_t asym_code(float y, float scale, float zp,
                                            int bits) {
  const float levels = (float)((1 << bits) - 1);
  const float v = rintf(__fadd_rn(y / scale, zp));
  return (int8_t)(fminf(fmaxf(v, 0.f), levels) - (float)(1 << (bits - 1)));
}

// Quantize each row of s_y with its range from row_ranges. Writes k_pad
// codes per row to q_out (row stride k_pad; the K padding carries code 0)
// and each row's scale and (signed-shifted) zero point to scale_out[r],
// zp_out[r]. As XLA compiles the reference, the scale is the range times
// the f32 reciprocal of the level count (one rounded multiply); zp and the
// codes divide by the scale (IEEE, no fast math). rintf is round half to
// even (jnp.round), and nothing is FMA-contracted.
template <int MAXR>
__device__ void quant_rows(const float* s_y, int m, int d, int k_pad,
                           int bits, bool symmetric, const float* red_min,
                           const float* red_max, int8_t* q_out,
                           float* scale_out, float* zp_out) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int nwarps = (nt + 31) >> 5;
  const float half = (float)(1 << (bits - 1));
  for (int r = 0; r < m; ++r) {
    float ymin = red_min[r * 32], ymax = red_max[r * 32];
    for (int w = 1; w < nwarps; ++w) {
      ymin = fminf(ymin, red_min[r * 32 + w]);
      ymax = fmaxf(ymax, red_max[r * 32 + w]);
    }
    if (symmetric) {
      const float qmax = half - 1.f;
      const float scale = __fmul_rn(
          fmaxf(fmaxf(fabsf(ymin), fabsf(ymax)), 1e-12f), 1.f / qmax);
      for (int k = tid; k < k_pad; k += nt) {
        float q = 0.f;
        if (k < d) {
          q = fminf(fmaxf(rintf(s_y[r * d + k] / scale), -qmax - 1.f),
                    qmax);
        }
        q_out[(size_t)r * k_pad + k] = (int8_t)q;
      }
      if (tid == 0) {
        scale_out[r] = scale;
        zp_out[r] = 0.f;
      }
    } else {
      float scale, zp;
      asym_params(ymin, ymax, bits, &scale, &zp);
      for (int k = tid; k < k_pad; k += nt)
        q_out[(size_t)r * k_pad + k] =
            k < d ? asym_code(s_y[r * d + k], scale, zp, bits) : 0;
      if (tid == 0) {
        scale_out[r] = scale;
        zp_out[r] = zp - half;
      }
    }
  }
  __syncthreads();
}

}  // namespace tq
