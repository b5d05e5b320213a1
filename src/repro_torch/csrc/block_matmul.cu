// Block-diagonal matmul (the online block-CAT transform) for Hopper
// (sm_90a), plain C interface:
//   y[..., i*k:(i+1)*k] = x[..., i*k:(i+1)*k] @ B_i^T,  blocks (n, k, k),
// in f32, written in x's dtype.
//
// Replaces the Pallas TPU kernel block_diag_matmul of
// src/repro/kernels/block_matmul.py:26 (grid: token tile x block, each
// block one MXU tile). Here one CTA per row loads the row into shared
// memory and each thread computes output elements as one fmaf chain over
// its block's row of B (tq::block_cat_sign, the code the fused linear's
// stage 1 runs), so the composed and the fused linear transform a row with
// the same arithmetic.
//
// Bound on this card: bytes (the activation in and out, 2 x M x D x
// elt, plus the D x k f32 blocks once) over HBM bandwidth; the 2 x M x D x
// k FLOPs are far below the f32 rate at these shapes. Each CTA reads the
// whole block tensor from L2 (64 KiB at D 512, k 32); one row per CTA
// keeps the kernel simple at the cost of that L2 traffic.
#include "transform_quant.cuh"

namespace {

constexpr int kThreads = 256;

// grid (m), block kThreads; dynamic shared memory: 2 * d floats.
template <typename T>
__global__ void block_diag_kernel(const T* __restrict__ x, int d,
                                  const float* __restrict__ blocks, int bk,
                                  T* __restrict__ out) {
  extern __shared__ float smem[];
  float* s_x = smem;
  float* s_y = s_x + d;
  const size_t row = blockIdx.x;
  tq::load_rows(x + row * d, d, s_x);
  tq::block_cat_sign<1>(s_x, 1, d, blocks, bk, nullptr, s_y);
  for (int i = threadIdx.x; i < d; i += blockDim.x)
    out[row * d + i] = tq::from_f32<T>(s_y[i]);
}

template <typename T>
cudaError_t launch(const void* x, int m, int d, const void* blocks, int bk,
                   void* out, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 2 * (size_t)d;
  block_diag_kernel<T><<<m, kThreads, smem, stream>>>(
      static_cast<const T*>(x), d, static_cast<const float*>(blocks), bk,
      static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace

// x (m, d) f32 or bf16, blocks (d/bk, bk, bk) f32 -> out (m, d) in x's
// dtype. Returns cudaGetLastError() of the launch.
extern "C" int block_diag_matmul(const void* x, int x_is_bf16, int m, int d,
                                 const void* blocks, int bk, void* out,
                                 void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (x_is_bf16)
    return (int)launch<__nv_bfloat16>(x, m, d, blocks, bk, out, stream);
  return (int)launch<float>(x, m, d, blocks, bk, out, stream);
}
