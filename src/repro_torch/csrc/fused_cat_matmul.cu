// The fused CAT serving linear for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernels fused_cat_gemv_w4 and fused_cat_matmul_w4
// of src/repro/kernels/fused_cat_matmul.py. Per activation row:
//   block-CAT (y_i = B_blk x_blk) -> * sign -> Kronecker Hadamard
//   Y = Ha X Hb^T -> per-token asymmetric act quant (signed-shifted codes)
// then the int8 x int4 (or int8 x int8) contraction with the epilogue
//   out[m, n] = sx[m] * sw[n] * (acc[m, n] - zx[m] * colsum[n]).
//
// Two launches per call. Stage 1 (one CTA per row) transforms and quantizes
// the row in shared memory (transform_quant.cuh) and writes its codes
// (m, k_pad) int8 plus sx, zx (m,) f32 to a scratch buffer the wrapper
// allocates: (k_pad + 8) bytes per row written and read back once, which
// the contraction then revisits from shared memory. Stage 2 is the GEMV
// (m <= 8) or, above, the tensor-core contraction of contract.cuh (int8
// weights, or int4-packed ones unpacked to s8 in shared memory), which
// the composed linear's stand-alone contractions (quant_matmul.cu)
// share.
//
// Bound on this card: at decode shapes (m <= 8) the packed-weight bytes
// (D/2 x N) over HBM bandwidth; at the 128-row ragged step the weight is
// still the larger stream (D/2 x N vs m x D x 2), so bytes bound both.
// The design reads each weight byte once per M tile and keeps codes on
// chip; above 8 rows the products run on the tensor cores (mma.sync s8,
// no wgmma yet), the GEMV's on the CUDA cores.
#include "contract.cuh"
#include "transform_quant.cuh"

namespace {

constexpr int kStage1Threads = 256;

// Stage 1: transform + dynamic per-token asymmetric quant of one row
// (transform_quant.cuh). Dynamic shared memory: 2*d + a*a + b*b floats.
template <typename T>
__global__ void transform_quant_kernel(
    const T* __restrict__ x, int d, int k_pad,
    const float* __restrict__ blocks, int bk,
    const float* __restrict__ sign,
    const float* __restrict__ ha, int a,
    const float* __restrict__ hb, int b,
    int act_bits,
    int8_t* __restrict__ qx, float* __restrict__ sx, float* __restrict__ zx) {
  extern __shared__ float smem[];
  float* s_x = smem;
  float* s_y = s_x + d;
  float* s_hat = s_y + d;
  float* s_hbt = s_hat + a * a;
  __shared__ float red_min[32], red_max[32];
  const int row = blockIdx.x;
  tq::load_factors(ha, a, hb, b, s_hat, s_hbt);
  tq::transform_quant_rows<T, 1>(x + (size_t)row * d, 1, d, k_pad, blocks,
                                 bk, sign, s_hat, a, s_hbt, b, act_bits, s_x,
                                 s_y, red_min, red_max,
                                 qx + (size_t)row * k_pad, sx + row,
                                 zx + row);
}

template <typename T>
cudaError_t launch_stage1(const void* x, int m, int d, int k_pad,
                          const void* blocks, int bk, const void* sign,
                          const void* ha, int a, const void* hb, int b,
                          int act_bits, void* qx, void* sx, void* zx,
                          cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * (size_t)d + a * a + b * b);
  transform_quant_kernel<T><<<m, kStage1Threads, smem, stream>>>(
      static_cast<const T*>(x), d, k_pad, static_cast<const float*>(blocks),
      bk, static_cast<const float*>(sign), static_cast<const float*>(ha), a,
      static_cast<const float*>(hb), b, act_bits, static_cast<int8_t*>(qx),
      static_cast<float*>(sx), static_cast<float*>(zx));
  return cudaGetLastError();
}

cudaError_t stage1(const void* x, int x_is_bf16, int m, int d, int k_pad,
                   const void* blocks, int bk, const void* sign,
                   const void* ha, int a, const void* hb, int b, int act_bits,
                   void* qx, void* sx, void* zx, cudaStream_t stream) {
  if (x_is_bf16) {
    return launch_stage1<__nv_bfloat16>(x, m, d, k_pad, blocks, bk, sign, ha,
                                        a, hb, b, act_bits, qx, sx, zx,
                                        stream);
  }
  return launch_stage1<float>(x, m, d, k_pad, blocks, bk, sign, ha, a, hb, b,
                              act_bits, qx, sx, zx, stream);
}

}  // namespace

// Decode-shaped entry (m <= 8). Returns cudaGetLastError() of the launches.
extern "C" int fused_cat_gemv_w4(
    const void* x, int x_is_bf16, int m, int d, int k_pad,
    const void* blocks, int bk, const void* sign,
    const void* ha, int a, const void* hb, int b, int act_bits,
    const void* qw, int packed, const void* sw, int n,
    void* qx, void* sx, void* zx, void* out, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err = stage1(x, x_is_bf16, m, d, k_pad, blocks, bk, sign, ha,
                           a, hb, b, act_bits, qx, sx, zx, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)contract::launch_gemv(qx, k_pad, k_pad, sx, zx, m, k_pad, qw,
                                    packed, sw, n, out, stream);
}

// Tiled entry (m > 8): stage 2 is the tensor-core contraction, for packed
// or int8 weights, with ``splits`` K splits and their scratch ws
// (quant_matmul_plan of quant_matmul.cu, with k = k_pad).
// Returns cudaGetLastError() of the launches.
extern "C" int fused_cat_matmul_w4(
    const void* x, int x_is_bf16, int m, int d, int k_pad,
    const void* blocks, int bk, const void* sign,
    const void* ha, int a, const void* hb, int b, int act_bits,
    const void* qw, int packed, const void* sw, int n, int splits, void* ws,
    void* qx, void* sx, void* zx, void* out, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err = stage1(x, x_is_bf16, m, d, k_pad, blocks, bk, sign, ha,
                           a, hb, b, act_bits, qx, sx, zx, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)contract::launch_mma(qx, k_pad, k_pad, sx, zx, m, k_pad, qw,
                                   packed, sw, n, splits, ws, out, stream);
}
