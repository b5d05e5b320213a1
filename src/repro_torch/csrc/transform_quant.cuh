// Activation rows through the CAT transform and the dynamic per-token
// quant, for Hopper (sm_90a), one device function per step:
//   load_rows        x (T) -> f32 in shared memory
//   load_factors     the Kronecker factors, transposed, in shared memory
//   block_cat_sign   block-CAT (y_i = B_blk x_blk), then * sign
//   hadamard_rows    Kronecker Hadamard Y = Ha X Hb^T of each row
//   row_ranges       each row's min and max
//   quant_rows       asymmetric: scale = max(ymax - ymin, 1e-12) *
//                    f32(1 / (2^bits - 1)), zp = rint(-ymin / scale),
//                    codes rint(y / scale + zp) shifted by 2^(bits-1)
//                    (signed); symmetric: scale = max(amax, 1e-12) *
//                    f32(1 / (2^(bits-1) - 1)), zp = 0. The scale is the
//                    compiled reference's multiply by the f32 reciprocal;
//                    the divisions by the scale stay IEEE divisions.
// transform_quant_rows composes them for the fused CAT linear's tiled
// path (fused_cat_matmul.cu, stage 1: one row per CTA); the stand-alone
// quant (dynamic_quant.cu) calls the steps one by one, and the stand-alone
// block-CAT and Hadamard (block_matmul.cu, hadamard.cu) and the decode
// kernels' cluster transform (cluster_tq.cuh) compute the same fmaf chains
// in tilings of their own, so every path computes a step with the same
// arithmetic. Each output element is one fmaf chain in a fixed
// order, whatever the number of rows, so a row's values do not depend on
// its batch. Every function takes m <= MAXR rows of d values
// (row stride d), must be called by every thread of the block, and ends
// with a barrier, so its outputs are visible to the whole block.
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

// s_y = (blockdiag(B) x) * sign for each row of s_x. ``blocks`` (d/bk,
// bk, bk) f32 in device memory, or null for the identity; ``sign`` (d,)
// f32, or null for ones.
template <int MAXR>
__device__ void block_cat_sign(const float* s_x, int m, int d,
                               const float* __restrict__ blocks, int bk,
                               const float* __restrict__ sign, float* s_y) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int i = tid; i < d; i += nt) {
    float acc[MAXR];
#pragma unroll
    for (int r = 0; r < MAXR; ++r) acc[r] = 0.f;
    if (blocks != nullptr) {
      const int blk = i / bk, row = i - blk * bk;
      const float* brow = blocks + ((size_t)blk * bk + row) * bk;
      const float* xb = s_x + blk * bk;
      for (int j = 0; j < bk; ++j) {
        const float w = brow[j];
#pragma unroll
        for (int r = 0; r < MAXR; ++r)
          if (r < m) acc[r] = fmaf(xb[r * d + j], w, acc[r]);
      }
    } else {
#pragma unroll
      for (int r = 0; r < MAXR; ++r)
        if (r < m) acc[r] = s_x[r * d + i];
    }
    const float sg = sign != nullptr ? sign[i] : 1.f;
#pragma unroll
    for (int r = 0; r < MAXR; ++r)
      if (r < m) s_y[r * d + i] = acc[r] * sg;
  }
  __syncthreads();
}

// s_hat[i * a + p] = ha[p * a + i], s_hbt[j * b + l] = hb[l * b + j]: both
// Kronecker factors transposed into shared memory (read coalesced, written
// strided), where hadamard_rows reads them on distinct banks. Visible to
// the block after its next barrier.
__device__ void load_factors(const float* __restrict__ ha, int a,
                             const float* __restrict__ hb, int b,
                             float* s_hat, float* s_hbt) {
  for (int e = threadIdx.x; e < a * a; e += blockDim.x) {
    const int p = e / a, i = e - p * a;
    s_hat[i * a + p] = ha[e];
  }
  for (int e = threadIdx.x; e < b * b; e += blockDim.x) {
    const int l = e / b, j = e - l * b;
    s_hbt[j * b + l] = hb[e];
  }
}

// s_y <- Ha Y Hb^T for each row's Y = s_y viewed (a, b); s_tmp is scratch
// of the same size. s_hat and s_hbt: the factors as load_factors lays
// them out, already in shared memory. A warp's consecutive outputs step
// through l (p changes at most once), so its factor reads hit
// consecutive words and its reads of Y one or two rows i, on distinct
// banks.
template <int MAXR>
__device__ void hadamard_rows(float* s_y, float* s_tmp, int m, int d,
                              const float* s_hat, int a, const float* s_hbt,
                              int b) {
  const int tid = threadIdx.x, nt = blockDim.x;
  // Z = Y Hb^T
  for (int idx = tid; idx < d; idx += nt) {
    const int i = idx / b, l = idx - i * b;
    float acc[MAXR];
#pragma unroll
    for (int r = 0; r < MAXR; ++r) acc[r] = 0.f;
    for (int j = 0; j < b; ++j) {
      const float w = s_hbt[j * b + l];
#pragma unroll
      for (int r = 0; r < MAXR; ++r)
        if (r < m) acc[r] = fmaf(s_y[r * d + i * b + j], w, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < MAXR; ++r)
      if (r < m) s_tmp[r * d + idx] = acc[r];
  }
  __syncthreads();
  // out[p*b + l] = sum_i Ha[p][i] Z[i][l]
  for (int idx = tid; idx < d; idx += nt) {
    const int p = idx / b, l = idx - p * b;
    float acc[MAXR];
#pragma unroll
    for (int r = 0; r < MAXR; ++r) acc[r] = 0.f;
    for (int i = 0; i < a; ++i) {
      const float w = s_hat[i * a + p];
#pragma unroll
      for (int r = 0; r < MAXR; ++r)
        if (r < m) acc[r] = fmaf(s_tmp[r * d + i * b + l], w, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < MAXR; ++r)
      if (r < m) s_y[r * d + idx] = acc[r];
  }
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

// Transform and asymmetric-quantize rows x[0..m) (m <= MAXR, d values
// each, row stride d) with every thread of the block; each factor element
// is read once for all m rows. Shared scratch: s_x, s_y (m*d floats each),
// s_hat (a*a) and s_hbt (b*b) from load_factors, red_min/red_max (MAXR*32
// floats each). Writes k_pad codes per row to q_out (row stride k_pad) and
// each row's scale and signed-shifted zero point to scale_out[r], zp_out[r].
template <typename T, int MAXR>
__device__ void transform_quant_rows(
    const T* __restrict__ x, int m, int d, int k_pad,
    const float* __restrict__ blocks, int bk,
    const float* __restrict__ sign,
    const float* s_hat, int a, const float* s_hbt, int b, int act_bits,
    float* s_x, float* s_y, float* red_min, float* red_max,
    int8_t* q_out, float* scale_out, float* zp_out) {
  load_rows(x, m * d, s_x);
  block_cat_sign<MAXR>(s_x, m, d, blocks, bk, sign, s_y);
  hadamard_rows<MAXR>(s_y, s_x, m, d, s_hat, a, s_hbt, b);
  row_ranges<MAXR>(s_y, m, d, red_min, red_max);
  quant_rows<MAXR>(s_y, m, d, k_pad, act_bits, false, red_min, red_max,
                   q_out, scale_out, zp_out);
}

}  // namespace tq
