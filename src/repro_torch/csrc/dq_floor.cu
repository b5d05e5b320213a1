// The floor of the dynamic per-token quant (dynamic_quant.cu) on Hopper
// (sm_90a), plain C interface: yardsticks that chip_smoke.py times beside
// the quant at its grid, and that nothing in the port calls, so they live
// in a library of their own. An empty kernel gives the launch; a copy
// kernel moves the quant's bytes the register path's way (each row's
// 16-byte vectors in, one byte per element and 8 bytes per row out) with
// no range and no arithmetic between the load and the store, so the
// quant's time above it is its own work.
#include <cstdint>

#include <cuda_runtime.h>

#include "dq_plan.h"

namespace {

__global__ void dq_empty_kernel() {}

// Grid (ctas), block (rows * 32), as the quant's register path; each lane
// copies its vectors l, l + 32, ... of the row, masked past its end, so
// one instantiation at the plan's most vectors per lane takes every width
// the register path takes.
template <typename T>
__global__ void __launch_bounds__(dq::kMaxRows * 32)
dq_copy_kernel(const T* __restrict__ x, int m, int d,
               int8_t* __restrict__ q, float* __restrict__ scale,
               float* __restrict__ zp) {
  constexpr int E = dq::kVecBytes / sizeof(T);
  const int lane = threadIdx.x & 31;
  const size_t row = (size_t)blockIdx.x * (blockDim.x >> 5) +
                     (threadIdx.x >> 5);
  if (row >= (size_t)m) return;
  const int nvec = d / E;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * d);
#pragma unroll
  for (int i = 0; i < dq::kMaxVecs; ++i) {
    const int j = i * 32 + lane;
    if (j < nvec) {
      const uint4 v = __ldg(xr + j);
      const unsigned u[4] = {v.x, v.y, v.z, v.w};
      int8_t* dst = q + row * d + (size_t)j * E;
      if constexpr (E == 4) {
        *reinterpret_cast<unsigned*>(dst) =
            (u[0] & 0xffu) | (u[1] & 0xffu) << 8 | (u[2] & 0xffu) << 16 |
            (u[3] & 0xffu) << 24;
      } else {
        *reinterpret_cast<uint2*>(dst) = make_uint2(
            (u[0] & 0xffu) | (u[0] >> 16 & 0xffu) << 8 |
                (u[1] & 0xffu) << 16 | (u[1] >> 16 & 0xffu) << 24,
            (u[2] & 0xffu) | (u[2] >> 16 & 0xffu) << 8 |
                (u[3] & 0xffu) << 16 | (u[3] >> 16 & 0xffu) << 24);
      }
      if (i == 0 && lane == 0) {
        scale[row] = __uint_as_float(v.x);
        zp[row] = __uint_as_float(v.y);
      }
    }
  }
}

}  // namespace

// The floor of dynamic_quant for x (m, d), f32 or bf16 (x_is_bf16), at
// its plan's grid (dq_plan.h; rows per CTA 0: the plan's): kind 0 the
// empty kernel, kind 1 the copy kernel into q (m, d) int8, scale and zp
// (m,) f32 (register-path shapes only). Returns cudaErrorInvalidValue for
// a shape or kind it does not take, else cudaGetLastError() of the launch.
extern "C" int dq_floor(int kind, const void* x, int x_is_bf16, int m, int d,
                        int rows, void* q, void* scale, void* zp,
                        void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int aligned = (reinterpret_cast<uintptr_t>(x) % dq::kVecBytes) == 0;
  dq::Plan p;
  if (!dq::plan(m, d, x_is_bf16 ? 2 : 4, aligned, rows, &p))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(p.ctas), block(p.rows * 32);
  if (kind == 0) {
    dq_empty_kernel<<<grid, block, 0, stream>>>();
  } else if (kind == 1 && p.vecs) {
    int8_t* qt = static_cast<int8_t*>(q);
    float* st = static_cast<float*>(scale);
    float* zt = static_cast<float*>(zp);
    if (x_is_bf16)
      dq_copy_kernel<unsigned short><<<grid, block, 0, stream>>>(
          static_cast<const unsigned short*>(x), m, d, qt, st, zt);
    else
      dq_copy_kernel<float><<<grid, block, 0, stream>>>(
          static_cast<const float*>(x), m, d, qt, st, zt);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
