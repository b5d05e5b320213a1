// Sign and Kronecker Hadamard transform for Hopper (sm_90a), plain C
// interface:
//   y = (x * sign) @ (ha kron hb)^T   per row, in f32, written in x's dtype
// (sign null means ones).
//
// Replaces the Pallas TPU kernel hadamard_transform of
// src/repro/kernels/hadamard.py:37 (two factor matmuls on the (TM*a, b)
// and (TM*b, a) views, factors resident in VMEM). Here one CTA per row
// keeps the row, a scratch row and both factors in shared memory
// (2 x D + a^2 + b^2 floats: 25 KiB at D 1536 with factors 32 and 48) and
// runs tq::block_cat_sign (the sign) and tq::hadamard_rows (the two
// factor dots, each output element one fmaf chain), the code the fused
// linear's stage 1 runs.
//
// Bound on this card: bytes (the activation in and out, 2 x M x D x elt)
// over HBM bandwidth; the 2 x M x D x (a + b) FLOPs stay below the f32
// rate's share at these shapes. The factors are read once per CTA.
#include "transform_quant.cuh"

namespace {

constexpr int kThreads = 256;

// grid (m), block kThreads; dynamic shared memory: 2*d + a*a + b*b floats.
template <typename T>
__global__ void hadamard_kernel(const T* __restrict__ x, int d,
                                const float* __restrict__ sign,
                                const float* __restrict__ ha, int a,
                                const float* __restrict__ hb, int b,
                                T* __restrict__ out) {
  extern __shared__ float smem[];
  float* s_x = smem;
  float* s_y = s_x + d;
  float* s_ha = s_y + d;
  float* s_hb = s_ha + a * a;
  const size_t row = blockIdx.x;
  for (int i = threadIdx.x; i < a * a; i += blockDim.x) s_ha[i] = ha[i];
  for (int i = threadIdx.x; i < b * b; i += blockDim.x) s_hb[i] = hb[i];
  tq::load_rows(x + row * d, d, s_x);
  tq::block_cat_sign<1>(s_x, 1, d, nullptr, 0, sign, s_y);
  tq::hadamard_rows<1>(s_y, s_x, 1, d, s_ha, a, s_hb, b);
  for (int i = threadIdx.x; i < d; i += blockDim.x)
    out[row * d + i] = tq::from_f32<T>(s_y[i]);
}

template <typename T>
cudaError_t launch(const void* x, int m, int d, const void* sign,
                   const void* ha, int a, const void* hb, int b, void* out,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * (size_t)d + a * a + b * b);
  hadamard_kernel<T><<<m, kThreads, smem, stream>>>(
      static_cast<const T*>(x), d, static_cast<const float*>(sign),
      static_cast<const float*>(ha), a, static_cast<const float*>(hb), b,
      static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace

// x (m, d) f32 or bf16, sign (d,) f32 or null, ha (a, a), hb (b, b) f32
// with a * b = d -> out (m, d) in x's dtype. Returns cudaGetLastError().
extern "C" int hadamard_transform(const void* x, int x_is_bf16, int m,
                                  int d, const void* sign, const void* ha,
                                  int a, const void* hb, int b, void* out,
                                  void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (x_is_bf16)
    return (int)launch<__nv_bfloat16>(x, m, d, sign, ha, a, hb, b, out,
                                      stream);
  return (int)launch<float>(x, m, d, sign, ha, a, hb, b, out, stream);
}
