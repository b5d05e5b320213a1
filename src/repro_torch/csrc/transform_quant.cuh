// Activation rows through the CAT transform and the dynamic per-token
// asymmetric quant, for Hopper (sm_90a). Shared by the fused CAT linear
// (fused_cat_matmul.cu, stage 1: one row per CTA) and the decode QKV
// prologue (decode_layer.cu: every decode row in each CTA), so both
// quantize a row with the same arithmetic:
//   block-CAT (y_i = B_blk x_blk) -> * sign -> Kronecker Hadamard
//   Y = Ha X Hb^T -> scale = max(ymax - ymin, 1e-12) / (2^bits - 1),
//   zp = rint(-ymin / scale), codes shifted by 2^(bits-1) (signed).
// Each output element is one fmaf chain in a fixed order, whatever the
// number of rows, so a row's codes do not depend on its batch.
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

// Transform and quantize rows x[0..m) (m <= MAXR, d values each, row
// stride d) with every thread of the block; each factor element is read
// once for all m rows. Shared scratch: s_x, s_y (m*d floats each), s_ha
// (a*a) and s_hb (b*b) already loaded, red_min/red_max (MAXR*32 floats
// each). Writes k_pad codes per row to q_out (row stride k_pad; the K
// padding carries code 0) and each row's scale and signed-shifted zero
// point to scale_out[r], zp_out[r]. Every thread must call it; it ends
// with a barrier, so its outputs are visible to the whole block.
template <typename T, int MAXR>
__device__ void transform_quant_rows(
    const T* __restrict__ x, int m, int d, int k_pad,
    const float* __restrict__ blocks, int bk,
    const float* __restrict__ sign,
    const float* s_ha, int a, const float* s_hb, int b, int act_bits,
    float* s_x, float* s_y, float* red_min, float* red_max,
    int8_t* q_out, float* scale_out, float* zp_out) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int i = tid; i < m * d; i += nt) s_x[i] = to_f32(x[i]);
  __syncthreads();
  // block-diagonal CAT, then the elementwise sign
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
    const float sg = sign[i];
#pragma unroll
    for (int r = 0; r < MAXR; ++r)
      if (r < m) s_y[r * d + i] = acc[r] * sg;
  }
  __syncthreads();
  // Z = Y Hb^T on each row's Y = y viewed (a, b)
  for (int idx = tid; idx < d; idx += nt) {
    const int i = idx / b, l = idx - i * b;
    const float* hr = s_hb + l * b;
    float acc[MAXR];
#pragma unroll
    for (int r = 0; r < MAXR; ++r) acc[r] = 0.f;
    for (int j = 0; j < b; ++j) {
      const float w = hr[j];
#pragma unroll
      for (int r = 0; r < MAXR; ++r)
        if (r < m) acc[r] = fmaf(s_y[r * d + i * b + j], w, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < MAXR; ++r)
      if (r < m) s_x[r * d + idx] = acc[r];
  }
  __syncthreads();
  // out[p*b + l] = sum_i Ha[p][i] Z[i][l], with each row's min and max
  float lmin[MAXR], lmax[MAXR];
#pragma unroll
  for (int r = 0; r < MAXR; ++r) { lmin[r] = INFINITY; lmax[r] = -INFINITY; }
  for (int idx = tid; idx < d; idx += nt) {
    const int p = idx / b, l = idx - p * b;
    const float* hr = s_ha + p * a;
    float acc[MAXR];
#pragma unroll
    for (int r = 0; r < MAXR; ++r) acc[r] = 0.f;
    for (int i = 0; i < a; ++i) {
      const float w = hr[i];
#pragma unroll
      for (int r = 0; r < MAXR; ++r)
        if (r < m) acc[r] = fmaf(s_x[r * d + i * b + l], w, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < MAXR; ++r) {
      if (r < m) {
        s_y[r * d + idx] = acc[r];
        lmin[r] = fminf(lmin[r], acc[r]);
        lmax[r] = fmaxf(lmax[r], acc[r]);
      }
    }
  }
  const int warp = tid >> 5, lane = tid & 31, nwarps = (nt + 31) >> 5;
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
  const float levels = (float)((1 << act_bits) - 1);
  const float half = (float)(1 << (act_bits - 1));
  for (int r = 0; r < m; ++r) {
    float ymin = red_min[r * 32], ymax = red_max[r * 32];
    for (int w = 1; w < nwarps; ++w) {
      ymin = fminf(ymin, red_min[r * 32 + w]);
      ymax = fmaxf(ymax, red_max[r * 32 + w]);
    }
    const float scale = fmaxf(__fsub_rn(ymax, ymin), 1e-12f) / levels;
    const float zp = rintf(-ymin / scale);
    for (int k = tid; k < k_pad; k += nt) {
      float q = 0.f;
      if (k < d) {
        const float v = rintf(__fadd_rn(s_y[r * d + k] / scale, zp));
        q = fminf(fmaxf(v, 0.f), levels) - half;
      }
      q_out[(size_t)r * k_pad + k] = (int8_t)q;
    }
    if (tid == 0) {
      scale_out[r] = scale;
      zp_out[r] = zp - half;
    }
  }
  __syncthreads();
}

}  // namespace tq
