// Dynamic per-token quantization for Hopper (sm_90a), plain C interface:
// each row of x to int8 codes (asymmetric: signed-shifted by 2^(bits-1);
// symmetric: in [-2^(bits-1), 2^(bits-1) - 1]) with its f32 scale and
// (shifted) zero point, exactly as the reference's compiled Pallas kernel
// (jax.jit of ref.dynamic_quant: the scale is the range times the f32
// reciprocal of the level count).
//
// Replaces the Pallas TPU kernel dynamic_quant of
// src/repro/kernels/dynamic_quant.py:44 (one VMEM pass per token tile:
// row reduction, scale and zero point, round and clip).
//
// Bound on this card: bytes (the activation in, M x D x elt, and the codes
// out, M x D, plus 8 bytes per row) over HBM bandwidth, a handful of
// operations per element; at the path's shapes (M 8 and 128, D 512 and
// 1536) that is well under a microsecond, so the launch and the chain of
// dependent steps bound it. The design keeps that chain short: one warp
// per row, the row held in registers (each lane loads 16-byte vectors,
// neighbouring lanes on neighbouring addresses, all loads in flight at
// once), its range by __shfl_xor_sync butterflies (no shared memory, no
// barrier), the codes from registers stored 4 (f32) or 8 (bf16) at a
// time, lane 0 writing the scale and zero point; several rows per CTA.
// Each code divides by the row's scale through its reciprocal without a
// branch (tq::quot: one multiply and two fma, the IEEE quotient's bits;
// a row whose range could under- or overflow that takes the IEEE
// division), so a lane's dozens of codes pipeline instead of each waiting
// on the division's range check. Widths the register path does not take
// (dq_plan.h) run the general path: the same warp per row, scalar loads,
// the row read twice (the second read hits L2). The arithmetic is
// transform_quant.cuh's (tq::asym_params / asym_code, tq::sym_params /
// sym_code, and their _of forms on the reciprocal's quotient), which the
// fused linear's cluster transform shares; min
// and max are order-free, so codes, scales and zero points are bitwise
// those of the plain version. dq_floor.cu holds the yardsticks the chip
// check times it against.
#include "dq_plan.h"
#include "transform_quant.cuh"

namespace {

// The 16-byte vector v as E f32 values.
template <typename T>
__device__ __forceinline__ void unpack(const uint4& v, float* f);
template <>
__device__ __forceinline__ void unpack<float>(const uint4& v, float* f) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}
template <>
__device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& v,
                                                      float* f) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// The warp's min and max, in every lane.
__device__ __forceinline__ void warp_range(float* mn, float* mx) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    *mn = fminf(*mn, __shfl_xor_sync(0xffffffffu, *mn, off));
    *mx = fmaxf(*mx, __shfl_xor_sync(0xffffffffu, *mx, off));
  }
}

// The code of y under the row's scale and zero point: the quotient by
// the branch-free exact division (RCP) or the IEEE one.
template <bool SYM, bool RCP>
__device__ __forceinline__ int8_t code(float y, float scale, float rcp,
                                       float zp, int bits) {
  if constexpr (RCP) {
    const float q = tq::quot(y, scale, rcp);
    return SYM ? tq::sym_code_of(q, bits) : tq::asym_code_of(q, zp, bits);
  } else {
    return SYM ? tq::sym_code(y, scale, bits)
               : tq::asym_code(y, scale, zp, bits);
  }
}

// The row's scale, zero point and reciprocal scale from its range; lane 0
// stores the scale and the zero point (signed-shifted, 0 when symmetric).
// Returns whether the row's codes may divide by the reciprocal
// (tq::quot_exact).
template <bool SYM>
__device__ __forceinline__ bool row_params(float mn, float mx, int bits,
                                           int lane, size_t row,
                                           float* scale, float* zp,
                                           float* rcp, float* s_out,
                                           float* z_out) {
  if constexpr (SYM) {
    *scale = tq::sym_params(mn, mx, bits);
    *zp = 0.f;
  } else {
    tq::asym_params(mn, mx, bits, scale, zp);
  }
  if (lane == 0) {
    s_out[row] = *scale;
    z_out[row] = SYM ? 0.f : *zp - (float)(1 << (bits - 1));
  }
  *rcp = __frcp_rn(*scale);
  return tq::quot_exact(*scale, *rcp, fmaxf(fabsf(mn), fabsf(mx)));
}

// Lane `lane`'s codes of its V vectors v, stored 4 (f32) or 8 (bf16) at a
// time into the row's codes qr.
template <typename T, int V, bool SYM, bool RCP>
__device__ __forceinline__ void store_codes(const uint4* v, int nvec,
                                            int lane, float s, float rcp,
                                            float z, int bits, int8_t* qr) {
  constexpr int E = dq::kVecBytes / sizeof(T);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int j = i * 32 + lane;
    if (j < nvec) {
      float f[E];
      unpack<T>(v[i], f);
      unsigned w[E / 4];
#pragma unroll
      for (int k = 0; k < E / 4; ++k) {
        w[k] = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          w[k] |= (unsigned)(uint8_t)code<SYM, RCP>(f[4 * k + e], s, rcp, z,
                                                    bits)
                  << (8 * e);
      }
      int8_t* dst = qr + (size_t)j * E;
      if constexpr (E == 4)
        *reinterpret_cast<unsigned*>(dst) = w[0];
      else
        *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
    }
  }
}

// The register path: grid (ctas), block (rows * 32); warp w of CTA c
// quantizes row c * rows + w, lane l holding its vectors l, l + 32, ...
// (V per lane; E = 16 / sizeof(T) elements each).
template <typename T, int V, bool SYM>
__global__ void __launch_bounds__(dq::kMaxRows * 32)
dynamic_quant_kernel(const T* __restrict__ x, int m, int d, int bits,
                     int8_t* __restrict__ q, float* __restrict__ scale,
                     float* __restrict__ zp) {
  constexpr int E = dq::kVecBytes / sizeof(T);
  const int lane = threadIdx.x & 31;
  const size_t row = (size_t)blockIdx.x * (blockDim.x >> 5) +
                     (threadIdx.x >> 5);
  if (row >= (size_t)m) return;
  const int nvec = d / E;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * d);
  uint4 v[V];
#pragma unroll
  for (int i = 0; i < V; ++i)
    if (i * 32 + lane < nvec) v[i] = __ldg(xr + i * 32 + lane);
  float mn = INFINITY, mx = -INFINITY;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    if (i * 32 + lane < nvec) {
      float f[E];
      unpack<T>(v[i], f);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        mn = fminf(mn, f[e]);
        mx = fmaxf(mx, f[e]);
      }
    }
  }
  warp_range(&mn, &mx);
  float s, z, rcp;
  if (row_params<SYM>(mn, mx, bits, lane, row, &s, &z, &rcp, scale, zp))
    store_codes<T, V, SYM, true>(v, nvec, lane, s, rcp, z, bits, q + row * d);
  else
    store_codes<T, V, SYM, false>(v, nvec, lane, s, rcp, z, bits,
                                  q + row * d);
}

// The general path: any width and alignment, scalar loads, the row read
// twice (the range, then the codes).
template <typename T, bool SYM>
__global__ void __launch_bounds__(dq::kMaxRows * 32)
dynamic_quant_any_kernel(const T* __restrict__ x, int m, int d, int bits,
                         int8_t* __restrict__ q, float* __restrict__ scale,
                         float* __restrict__ zp) {
  const int lane = threadIdx.x & 31;
  const size_t row = (size_t)blockIdx.x * (blockDim.x >> 5) +
                     (threadIdx.x >> 5);
  if (row >= (size_t)m) return;
  const T* xr = x + row * d;
  float mn = INFINITY, mx = -INFINITY;
  for (int k = lane; k < d; k += 32) {
    const float f = tq::to_f32(xr[k]);
    mn = fminf(mn, f);
    mx = fmaxf(mx, f);
  }
  warp_range(&mn, &mx);
  float s, z, rcp;
  int8_t* qr = q + row * d;
  if (row_params<SYM>(mn, mx, bits, lane, row, &s, &z, &rcp, scale, zp)) {
    for (int k = lane; k < d; k += 32)
      qr[k] = code<SYM, true>(tq::to_f32(xr[k]), s, rcp, z, bits);
  } else {
    for (int k = lane; k < d; k += 32)
      qr[k] = code<SYM, false>(tq::to_f32(xr[k]), s, rcp, z, bits);
  }
}

#define DQ_VECS(X) X(1) X(2) X(4) X(8) X(16)   // dq::plan's vectors per lane

template <typename T, bool SYM>
cudaError_t launch(const dq::Plan& p, const void* x, int m, int d, int bits,
                   void* q, void* scale, void* zp, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  int8_t* qt = static_cast<int8_t*>(q);
  float* st = static_cast<float*>(scale);
  float* zt = static_cast<float*>(zp);
  const dim3 grid(p.ctas), block(p.rows * 32);
  switch (p.vecs) {
    case 0:
      dynamic_quant_any_kernel<T, SYM><<<grid, block, 0, stream>>>(
          xt, m, d, bits, qt, st, zt);
      break;
#define DQ_CASE(V)                                                  \
    case V:                                                         \
      dynamic_quant_kernel<T, V, SYM><<<grid, block, 0, stream>>>(  \
          xt, m, d, bits, qt, st, zt);                              \
      break;
    DQ_VECS(DQ_CASE)
#undef DQ_CASE
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

bool plan_for(const void* x, int x_is_bf16, int m, int d, int rows,
              dq::Plan* p) {
  const int aligned = (reinterpret_cast<uintptr_t>(x) % dq::kVecBytes) == 0;
  return dq::plan(m, d, x_is_bf16 ? 2 : 4, aligned, rows, p);
}

}  // namespace

// x (m, d) f32 or bf16 -> q (m, d) int8, scale (m,) f32, zp (m,) f32, on
// the plan of dq_plan.h (`rows`: rows per CTA, 0 = the plan's). Returns
// cudaErrorInvalidValue for bits outside 2..8 or a shape the plan refuses,
// else cudaGetLastError() of the launch.
extern "C" int dynamic_quant(const void* x, int x_is_bf16, int m, int d,
                             int bits, int symmetric, int rows, void* q,
                             void* scale, void* zp, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  dq::Plan p;
  if (bits < 2 || bits > 8 || !plan_for(x, x_is_bf16, m, d, rows, &p))
    return (int)cudaErrorInvalidValue;
  if (x_is_bf16)
    return (int)(symmetric ? launch<__nv_bfloat16, true>(p, x, m, d, bits, q,
                                                        scale, zp, stream)
                           : launch<__nv_bfloat16, false>(p, x, m, d, bits,
                                                          q, scale, zp,
                                                          stream));
  return (int)(symmetric
                   ? launch<float, true>(p, x, m, d, bits, q, scale, zp,
                                         stream)
                   : launch<float, false>(p, x, m, d, bits, q, scale, zp,
                                          stream));
}
