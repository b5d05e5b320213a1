// The fused CAT serving linear for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernels fused_cat_gemv_w4 and fused_cat_matmul_w4
// of src/repro/kernels/fused_cat_matmul.py. Per activation row:
//   block-CAT (y_i = B_blk x_blk) -> * sign -> Kronecker Hadamard
//   Y = Ha X Hb^T -> per-token asymmetric act quant (signed-shifted codes)
// then the int8 x int4 (or int8 x int8) contraction with the epilogue
//   out[m, n] = sx[m] * sw[n] * (acc[m, n] - zx[m] * colsum[n]).
//
// Decode (m <= 8): ONE launch, fused_cat_gemv_kernel, in thread-block
// clusters of c CTAs (c = 8 at the serving widths). Each cluster computes
// the transform and quant once, split over its CTAs (cluster_tq.cuh), and
// every CTA ends with all the codes in shared memory (pushed by its peers
// through distributed shared memory); each CTA then contracts them
// against its own output columns, whose weight bytes it stages in shared
// memory by 16-byte cp.async loads issued at kernel start, and applies
// the epilogue. No code leaves the chip. The cluster shape and the
// columns per CTA are ctq::gemv_plan's (cluster_plan.h), which the entry
// computes on every call and Python reads through ctq_gemv_plan.
//
// Tiled (m > 8): two launches. Stage 1 (one CTA per row) transforms and
// quantizes the row in shared memory (transform_quant.cuh) and writes its
// codes (m, k_pad) int8 plus sx, zx (m,) f32 to a scratch buffer the
// wrapper allocates; stage 2 is the tensor-core contraction of
// contract.cuh (int8 weights, or int4-packed ones unpacked to s8 in shared
// memory), which the composed linear's contractions (quant_matmul.cu)
// share.
//
// Bound on this card: at decode shapes the packed-weight bytes (D/2 x N)
// over HBM bandwidth; at the 128-row ragged step the weight is still the
// larger stream (D/2 x N vs m x D x 2), so bytes bound both. In practice
// the decode kernel is bound by its dependent phases (staging, three fmaf
// chains, three cluster barriers), which the cluster split shortens
// c-fold against one CTA per row; each weight byte is read once.
#include "cluster_tq.cuh"
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

// Decode: grid (clusters * c), clusters of c, ctq::kThreads threads. CTA
// `rank` of cluster g owns output columns [n0, n0 + tc), n0 = (g * c +
// rank) * tc; the cluster shares the transform (cluster_tq.cuh), and each
// CTA contracts all of K for its columns. Dynamic shared memory: the
// plan's (ctq::CtaLayout).
template <typename T, bool PACKED>
__global__ void __launch_bounds__(ctq::kThreads) fused_cat_gemv_kernel(
    const T* __restrict__ x, int m, int d,
    const float* __restrict__ blocks, int bk,
    const float* __restrict__ sign,
    const float* __restrict__ ha, int a,
    const float* __restrict__ hb, int b, int act_bits,
    const int8_t* __restrict__ qw, const float* __restrict__ sw, int n,
    int tc, int vw, float* __restrict__ out) {
  extern __shared__ float4 gemv_smem_base[];   // 16-byte aligned
  char* smem = reinterpret_cast<char*>(gemv_smem_base);
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int n0 = blockIdx.x * tc, L = d / c, bl = b / c;
  const int unit = PACKED ? 2 : 1, w_rows = d / unit;   // K per weight row
  const ctq::CtaLayout lay(m, d, c, a, b, blocks != nullptr ? bk : 0,
                           PACKED, tc, false);
  int8_t* s_w = reinterpret_cast<int8_t*>(smem + lay.w);
  int* s_part = reinterpret_cast<int*>(smem + lay.part);
  int* s_pcs = s_part + lay.slices * m * tc;
  float* s_sw = reinterpret_cast<float*>(smem + lay.sw);
  __shared__ float s_sx[ctq::kMaxRows], s_zx[ctq::kMaxRows];

  // the transform's operands, then the weight columns, whose loads overlap
  // the transform
  ctq::stage_transform(x, m, d, c, rank, blocks, bk, sign, ha, a, hb, b,
                       lay.tq, smem);
  const int cols = max(min(tc, n - n0), 0);
  ctq::stage_f32(s_sw, sw + n0, cols);
  ctq::stage_weights(s_w, lay.pitch, qw, n, w_rows, L / unit, bl / unit,
                     b / unit, n0, tc, vw);
  ctq::transform_quant(m, d, c, rank, blocks != nullptr, bk, sign, a, b,
                       act_bits, lay.tq, smem, s_sx, s_zx);
  cluster.sync();   // every CTA holds all the codes
  ctq::cp_async_wait_all();
  __syncthreads();
  ctq::contract_codes<PACKED, ctq::kMaxRows>(
      reinterpret_cast<const int8_t*>(smem + lay.tq.qall), d, d, s_w,
      lay.pitch, tc, m, s_part, s_pcs);
  for (int t = threadIdx.x; t < m * cols; t += ctq::kThreads) {
    const int r = t / cols, j = t - r * cols;
    out[(size_t)r * n + n0 + j] = contract::epilogue(
        s_sx[r], s_sw[j], s_part[r * tc + j], s_zx[r], s_pcs[j]);
  }
}

template <typename T, bool PACKED>
cudaError_t launch_decode(const void* x, int m, int d, const void* blocks,
                          int bk, const void* sign, const void* ha, int a,
                          const void* hb, int b, int act_bits,
                          const void* qw, const void* sw, int n,
                          const ctq::Plan& p, void* out,
                          cudaStream_t stream) {
  return ctq::launch_cluster(
      fused_cat_gemv_kernel<T, PACKED>, p.clusters * p.cluster, p.cluster,
      (size_t)p.smem, stream, static_cast<const T*>(x), m, d,
      static_cast<const float*>(blocks), bk,
      static_cast<const float*>(sign), static_cast<const float*>(ha), a,
      static_cast<const float*>(hb), b, act_bits,
      static_cast<const int8_t*>(qw), static_cast<const float*>(sw), n,
      p.cols, ctq::weight_vector(qw, n, p.cols), static_cast<float*>(out));
}

}  // namespace

// Decode-shaped entry (1 <= m <= 8), one launch in clusters, on the plan
// of ctq::gemv_plan (cluster_plan.h) for a card of ``sms`` SMs, with
// ``cols`` output columns per CTA (0: the plan's own choice). A shape the
// plan does not take returns cudaErrorInvalidValue. Returns
// cudaGetLastError() of the launch.
extern "C" int fused_cat_gemv_w4(
    const void* x, int x_is_bf16, int m, int d,
    const void* blocks, int bk, const void* sign,
    const void* ha, int a, const void* hb, int b, int act_bits,
    const void* qw, int packed, const void* sw, int n, int sms, int cols,
    void* out, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  ctq::Plan p;
  if (act_bits < 2 || act_bits > 8
      || !ctq::gemv_plan(m, d, n, a, b, blocks != nullptr ? bk : 0, packed,
                         sms, ctq::device_smem_optin(), cols, &p))
    return (int)cudaErrorInvalidValue;
#define REPRO_GEMV_ARGS                                                    \
  x, m, d, blocks, bk, sign, ha, a, hb, b, act_bits, qw, sw, n, p, out,    \
      stream
  cudaError_t err;
  if (x_is_bf16) {
    err = packed ? launch_decode<__nv_bfloat16, true>(REPRO_GEMV_ARGS)
                 : launch_decode<__nv_bfloat16, false>(REPRO_GEMV_ARGS);
  } else {
    err = packed ? launch_decode<float, true>(REPRO_GEMV_ARGS)
                 : launch_decode<float, false>(REPRO_GEMV_ARGS);
  }
#undef REPRO_GEMV_ARGS
  return (int)err;
}

// Clusters of ``cluster`` CTAs of the decode kernel (bf16 x, packed
// weights) resident at once with ``smem`` bytes each, or -1 on error.
extern "C" int fused_cat_gemv_capacity(int cluster, int smem) {
  return ctq::max_clusters(fused_cat_gemv_kernel<__nv_bfloat16, true>,
                           cluster, (size_t)smem);
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
