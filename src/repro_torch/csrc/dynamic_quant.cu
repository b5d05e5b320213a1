// Dynamic per-token quantization for Hopper (sm_90a), plain C interface:
// each row of x to int8 codes (asymmetric: signed-shifted by 2^(bits-1);
// symmetric: in [-2^(bits-1), 2^(bits-1) - 1]) with its f32 scale and
// (shifted) zero point, exactly as the reference's compiled Pallas kernel
// (jax.jit of ref.dynamic_quant: the scale is the range times the f32
// reciprocal of the level count).
//
// Replaces the Pallas TPU kernel dynamic_quant of
// src/repro/kernels/dynamic_quant.py:44 (one VMEM pass per token tile:
// row reduction, scale and zero point, round and clip). Here one CTA per
// row stages it in shared memory, reduces its range with warp shuffles
// (tq::row_ranges) and quantizes it (tq::quant_rows, whose asymmetric
// arithmetic, tq::asym_params / asym_code, the fused linear's cluster
// transform runs too: rintf for jnp.round, the scale by the f32
// reciprocal, zero point and codes by IEEE division), so codes are
// bitwise those of the plain version.
//
// Bound on this card: bytes (the activation in, M x D x elt, and the codes
// out, M x D, plus 8 bytes per row) over HBM bandwidth; a handful of
// operations per element.
#include "transform_quant.cuh"

namespace {

constexpr int kThreads = 256;

// grid (m), block kThreads; dynamic shared memory: d floats.
template <typename T>
__global__ void dynamic_quant_kernel(const T* __restrict__ x, int d,
                                     int bits, int symmetric,
                                     int8_t* __restrict__ q,
                                     float* __restrict__ scale,
                                     float* __restrict__ zp) {
  extern __shared__ float s_y[];
  __shared__ float red_min[32], red_max[32];
  const size_t row = blockIdx.x;
  tq::load_rows(x + row * d, d, s_y);
  tq::row_ranges<1>(s_y, 1, d, red_min, red_max);
  tq::quant_rows<1>(s_y, 1, d, d, bits, symmetric != 0, red_min, red_max,
                    q + row * d, scale + row, zp + row);
}

template <typename T>
cudaError_t launch(const void* x, int m, int d, int bits, int symmetric,
                   void* q, void* scale, void* zp, cudaStream_t stream) {
  dynamic_quant_kernel<T><<<m, kThreads, sizeof(float) * (size_t)d,
                            stream>>>(
      static_cast<const T*>(x), d, bits, symmetric, static_cast<int8_t*>(q),
      static_cast<float*>(scale), static_cast<float*>(zp));
  return cudaGetLastError();
}

}  // namespace

// x (m, d) f32 or bf16 -> q (m, d) int8, scale (m,) f32, zp (m,) f32.
// Returns cudaGetLastError() of the launch.
extern "C" int dynamic_quant(const void* x, int x_is_bf16, int m, int d,
                             int bits, int symmetric, void* q, void* scale,
                             void* zp, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (x_is_bf16)
    return (int)launch<__nv_bfloat16>(x, m, d, bits, symmetric, q, scale, zp,
                                      stream);
  return (int)launch<float>(x, m, d, bits, symmetric, q, scale, zp, stream);
}
