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
// Tiled (m > 8): two launches. Stage 1 runs the same cluster transform on
// groups of up to eight rows, one cluster per group (ctq::tiled_plan: 16
// clusters of 8 CTAs at 128 rows of D 512, all resident at once); each
// CTA stores the codes of its own K set straight to a scratch buffer the
// wrapper allocates ((m, k_pad) int8, plus sx, zx (m,) f32), so the
// clusters exchange only Z and the row ranges. Stage 2 is the tensor-core
// contraction of contract.cuh (int8 weights, or int4-packed ones unpacked
// to s8 in shared memory), which the composed linear's contractions
// (quant_matmul.cu) share.
//
// Widths the cluster transform does not split (ctq::general: odd D, any
// factors, any CAT block dividing D) run the same kernels on a cluster of
// one CTA through the general path of cluster_tq.cuh (scalar fmaf chains,
// codes and weight rows padded with zeros to a whole dp4a group; stage 1
// stores the codes of its rows byte by byte, zero past D), bitwise to the
// plain version as the vector path is.
//
// Widths whose operands the cluster's shared memory does not hold (d_ff
// 14336 and up, N 28672 at M 8: cluster_plan.h's path 1) take the
// streamed path of wide_tq.cuh in both entries: the decode linear as ONE
// cooperative launch (its first weight stages issued, the transform into
// a device scratch, then each CTA's work items, a column tile's K split
// each, streamed through a deep ring onto the tensor cores, the splits'
// exact int32 sums added in split order and the epilogue run once per
// tile), the tiled stage 1 as one cooperative launch writing the codes to
// qx.
//
// Bound on this card: at decode shapes the packed-weight bytes (D/2 x N)
// over HBM bandwidth; at the 128-row ragged step the weight is still the
// larger stream (D/2 x N vs m x D x 2), so bytes bound both. In practice
// the decode kernel and the tiled stage 1 are bound by their dependent
// phases (staging, three fmaf chains, two or three cluster barriers),
// which the cluster split shortens c-fold against one CTA per row; each
// weight byte is read once.
#include "cluster_tq.cuh"
#include "contract.cuh"
#include "wide_tq.cuh"

namespace {

// Tiled stage 1: grid (clusters * c), clusters of c, ctq::kThreads
// threads. Cluster g transforms and quantizes rows [g * rows, g * rows +
// mg) (mg = min(rows, m - g * rows)) over its CTAs (cluster_tq.cuh), and
// CTA `rank` stores the codes of its K set (K = p * b + rank * bl + ll,
// runs of bl = b / c consecutive K) into qx (row stride k_pad) in vw-byte
// pieces, rank 0 the rows' sx and zx. VW 1: the general path (c = 1),
// every code of the rows stored byte by byte, zero at K >= d. Dynamic
// shared memory: the plan's (ctq::TqLayout without the table of all
// codes).
template <typename T, int VW>
__global__ void __launch_bounds__(ctq::kThreads) cluster_transform_quant_kernel(
    const T* __restrict__ x, int m, int d, int k_pad, int rows,
    const float* __restrict__ blocks, int bk,
    const float* __restrict__ sign,
    const float* __restrict__ ha, int a,
    const float* __restrict__ hb, int b, int act_bits,
    int8_t* __restrict__ qx, float* __restrict__ sx, float* __restrict__ zx) {
  extern __shared__ float4 tq_smem_base[];   // 16-byte aligned
  char* smem = reinterpret_cast<char*>(tq_smem_base);
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int r0 = (int)(blockIdx.x / c) * rows, mg = min(rows, m - r0);
  const int L = d / c, bl = b / c;
  const ctq::TqLayout lay(rows, d, c, a, b, blocks != nullptr ? bk : 0,
                          false);
  __shared__ float s_sx[ctq::kMaxRows], s_zx[ctq::kMaxRows];
  if constexpr (VW == 1) {
    ctq::stage_transform_any(x + (size_t)r0 * d, mg, d, blocks, bk, sign,
                             ha, a, hb, b, lay, smem);
    ctq::cp_async_commit();   // no weights: an empty group
    ctq::transform_quant_any(mg, d, blocks != nullptr, bk, sign, a, b,
                             act_bits, lay, smem, s_sx, s_zx,
                             qx + (size_t)r0 * k_pad, k_pad, k_pad);
  } else {
    ctq::stage_transform(x + (size_t)r0 * d, mg, d, c, rank, blocks, bk,
                         sign, ha, a, hb, b, lay, smem);
    ctq::cp_async_commit();   // no weights: an empty group after the operands
    ctq::transform_quant(mg, d, c, rank, blocks != nullptr, bk, sign, a, b,
                         act_bits, lay, smem, s_sx, s_zx, false);
    const int8_t* s_q = reinterpret_cast<const int8_t*>(smem + lay.q);
    const int per_row = L / VW;
    for (int t = threadIdx.x; t < mg * per_row; t += ctq::kThreads) {
      const int r = t / per_row, kk = (t - r * per_row) * VW;
      const int p = kk / bl, ll = kk - p * bl;
      int8_t* dst = qx + (size_t)(r0 + r) * k_pad + p * b + rank * bl + ll;
      if (VW == 4) {
        *reinterpret_cast<int*>(dst) =
            *reinterpret_cast<const int*>(s_q + r * L + kk);
      } else {
        *reinterpret_cast<short*>(dst) =
            *reinterpret_cast<const short*>(s_q + r * L + kk);
      }
    }
  }
  if (rank == 0 && threadIdx.x < mg) {
    sx[r0 + threadIdx.x] = s_sx[threadIdx.x];
    zx[r0 + threadIdx.x] = s_zx[threadIdx.x];
  }
}

// Tiled stage 1, streamed path: one cooperative launch (the plan's CTAs
// per SM) transforms and quantizes all m rows through the scratch ws
// (wide::transform_quant), the codes into qx (row stride k_pad, zero past
// d), sx and zx. Dynamic shared memory: the transform's tile
// (ctq::wide_tq_bytes, the plan's).
template <typename T>
__global__ void __launch_bounds__(ctq::kThreads, ctq::kStreamCtasPerSm)
    wide_transform_quant_kernel(
    const T* __restrict__ x, int m, int d, int k_pad,
    const float* __restrict__ blocks, int bk,
    const float* __restrict__ sign,
    const float* __restrict__ ha, int a,
    const float* __restrict__ hb, int b, int act_bits, void* ws,
    int8_t* __restrict__ qx, float* __restrict__ sx, float* __restrict__ zx) {
  extern __shared__ float4 wide_tq_smem[];   // 16-byte aligned
  const wide::Regions s(ws, m, d, 0);
  wide::transform_quant(x, m, d, blocks, bk, sign, ha, a, hb, b, act_bits,
                        s.y, s.z, s.mm, qx, k_pad, k_pad, sx, zx,
                        reinterpret_cast<float*>(wide_tq_smem));
}

// Decode, streamed path: one cooperative launch (the plan's CTAs per SM,
// two where its ring fits in half an SM's shared memory). Each CTA first
// issues the weight stages of its first work items into its ring
// (wide::Stream, the plan's, ctq::stream_plan); the grid then
// transforms and quantizes the m rows into the scratch ws
// (wide::transform_quant), and each CTA contracts its items' K splits on
// the tensor cores; a tile's splits are added in split order, by the
// tile's owner after a grid barrier, which applies the epilogue to its
// columns. Dynamic shared memory: the plan's (ctq::StreamLayout).
template <typename T, bool PACKED>
__global__ void __launch_bounds__(ctq::kThreads, ctq::kStreamCtasPerSm)
    wide_gemv_kernel(
    const T* __restrict__ x, int m, int d,
    const float* __restrict__ blocks, int bk,
    const float* __restrict__ sign,
    const float* __restrict__ ha, int a,
    const float* __restrict__ hb, int b, int act_bits,
    const int8_t* __restrict__ qw, const float* __restrict__ sw, int n,
    ctq::Plan p, int vw, void* ws, float* __restrict__ out) {
  extern __shared__ float4 wide_smem_base[];   // 16-byte aligned
  char* smem = reinterpret_cast<char*>(wide_smem_base);
  const wide::Regions s(ws, m, d, p.ktile);
  const size_t ldq = ctq::wide_ldq(d, p.ktile);
  wide::Stream<PACKED> st(
      wide::StreamArgs{s.q, ldq, (int)ldq, m, true, qw, d, n, vw, p, s.part},
      smem);
  st.init();
  st.prefetch_weights();
  wide::transform_quant(x, m, d, blocks, bk, sign, ha, a, hb, b, act_bits,
                        s.y, s.z, s.mm, s.q, ldq, (int)ldq, nullptr, nullptr,
                        reinterpret_cast<float*>(smem + st.lay.tq));
  __shared__ float s_sx[ctq::kMaxRows], s_zx[ctq::kMaxRows];
  if (threadIdx.x < m) {
    float zp;
    wide::row_params(s.mm, threadIdx.x, act_bits, &s_sx[threadIdx.x], &zp,
                     &s_zx[threadIdx.x]);
  }
  st.prefetch_codes();
  const int tc = p.cols;
  st.run([&](int tile, const int* s_tot) {
    const int n0 = tile * tc, cols = min(tc, n - n0);
    for (int t = threadIdx.x; t < m * cols; t += ctq::kThreads) {
      const int r = t / cols, j = t - r * cols;
      out[(size_t)r * n + n0 + j] = contract::epilogue(
          s_sx[r], __ldg(sw + n0 + j), s_tot[r * tc + j], s_zx[r],
          s_tot[m * tc + j]);
    }
  });
}

template <typename T>
cudaError_t launch_stage1(const void* x, int m, int d, int k_pad,
                          const void* blocks, int bk, const void* sign,
                          const void* ha, int a, const void* hb, int b,
                          int act_bits, const ctq::Plan& p, void* ws,
                          void* qx, void* sx, void* zx,
                          cudaStream_t stream) {
  if (p.path == 1) {
    if (ws == nullptr) return cudaErrorInvalidValue;
    return wide::launch(
        wide_transform_quant_kernel<T>, p.per_sm * ctq::device_sms(),
        (size_t)p.smem,
        stream,
        static_cast<const T*>(x), m, d, k_pad,
        static_cast<const float*>(blocks), bk,
        static_cast<const float*>(sign), static_cast<const float*>(ha), a,
        static_cast<const float*>(hb), b, act_bits, ws,
        static_cast<int8_t*>(qx), static_cast<float*>(sx),
        static_cast<float*>(zx));
  }
  // each CTA's runs of bl = b / c codes go out 4 or 2 bytes at a time (bl
  // is even, k_pad = d a multiple of 32); the general path's byte by byte
  const bool vec4 = (b / p.cluster) % 4 == 0;
  auto kernel =
      !ctq::splits(d, a, b, blocks != nullptr ? bk : 0, p.cluster)
          ? cluster_transform_quant_kernel<T, 1>
      : vec4 ? cluster_transform_quant_kernel<T, 4>
             : cluster_transform_quant_kernel<T, 2>;
  return ctq::launch_cluster(
      kernel, p.clusters * p.cluster, p.cluster, (size_t)p.smem, stream,
      static_cast<const T*>(x), m, d, k_pad, p.cols,
      static_cast<const float*>(blocks), bk, static_cast<const float*>(sign),
      static_cast<const float*>(ha), a, static_cast<const float*>(hb), b,
      act_bits, static_cast<int8_t*>(qx), static_cast<float*>(sx),
      static_cast<float*>(zx));
}

// Decode: grid (clusters * c), clusters of c, ctq::kThreads threads. CTA
// `rank` of cluster g owns output columns [n0, n0 + tc), n0 = (g * c +
// rank) * tc; the cluster shares the transform (cluster_tq.cuh), and each
// CTA contracts all of K for its columns. ANY: the general path (c = 1),
// K padded to k_groups(d) with zero codes and zero weight rows. Dynamic
// shared memory: the plan's (ctq::CtaLayout).
template <typename T, bool PACKED, bool ANY>
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
  const int unit = PACKED ? 2 : 1;   // K per weight row
  const ctq::CtaLayout lay(m, d, c, a, b, blocks != nullptr ? bk : 0,
                           PACKED, tc, false, ANY);
  int8_t* s_w = reinterpret_cast<int8_t*>(smem + lay.w);
  int* s_part = reinterpret_cast<int*>(smem + lay.part);
  int* s_pcs = s_part + lay.slices * m * tc;
  float* s_sw = reinterpret_cast<float*>(smem + lay.sw);
  __shared__ float s_sx[ctq::kMaxRows], s_zx[ctq::kMaxRows];

  // the transform's operands, then the weight columns, whose loads overlap
  // the transform
  int cols;
  if constexpr (ANY) {
    ctq::stage_transform_any(x, m, d, blocks, bk, sign, ha, a, hb, b,
                             lay.tq, smem);
    cols = max(min(tc, n - n0), 0);
    ctq::stage_f32(s_sw, sw + n0, cols);
    const int w_rows = (d + unit - 1) / unit;   // the weight's rows
    ctq::stage_weights(s_w, lay.pitch, qw, n, w_rows, w_rows, 1, 1, n0, tc,
                       vw);
    ctq::zero_weight_rows(s_w, lay.pitch, w_rows, ctq::k_groups(d) / unit);
    ctq::transform_quant_any(
        m, d, blocks != nullptr, bk, sign, a, b, act_bits, lay.tq, smem,
        s_sx, s_zx, reinterpret_cast<int8_t*>(smem + lay.tq.qall),
        ctq::align16(d), ctq::k_groups(d));
  } else {
    ctq::stage_transform(x, m, d, c, rank, blocks, bk, sign, ha, a, hb, b,
                         lay.tq, smem);
    cols = max(min(tc, n - n0), 0);
    ctq::stage_f32(s_sw, sw + n0, cols);
    ctq::stage_weights(s_w, lay.pitch, qw, n, d / unit, L / unit, bl / unit,
                       b / unit, n0, tc, vw);
    ctq::transform_quant(m, d, c, rank, blocks != nullptr, bk, sign, a, b,
                         act_bits, lay.tq, smem, s_sx, s_zx);
    cluster.sync();   // every CTA holds all the codes
  }
  ctq::cp_async_wait_all();
  __syncthreads();
  // the table's row stride and the K contracted: d on the vector path;
  // d rounded up to 16 and to a dp4a group on the general one
  ctq::contract_codes<PACKED, ctq::kMaxRows>(
      reinterpret_cast<const int8_t*>(smem + lay.tq.qall),
      ANY ? (int)ctq::align16(d) : d, ANY ? ctq::k_groups(d) : d, s_w,
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
                          const ctq::Plan& p, int sms, void* ws, void* out,
                          cudaStream_t stream) {
  if (p.path == 1) {
    if (ws == nullptr) return cudaErrorInvalidValue;
    return wide::launch(
        wide_gemv_kernel<T, PACKED>, p.per_sm * sms,
        (size_t)p.smem, stream,
        static_cast<const T*>(x), m, d, static_cast<const float*>(blocks),
        bk, static_cast<const float*>(sign), static_cast<const float*>(ha),
        a, static_cast<const float*>(hb), b, act_bits,
        static_cast<const int8_t*>(qw), static_cast<const float*>(sw), n, p,
        ctq::weight_vector(qw, n, p.cols), ws, static_cast<float*>(out));
  }
  auto kernel =
      ctq::splits(d, a, b, blocks != nullptr ? bk : 0, p.cluster)
          ? fused_cat_gemv_kernel<T, PACKED, false>
          : fused_cat_gemv_kernel<T, PACKED, true>;
  return ctq::launch_cluster(
      kernel, p.clusters * p.cluster, p.cluster,
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
// ``cols`` output columns per CTA (0: the plan's own choice). On the
// streamed path (plan path 1) one cooperative launch of ``sms`` CTAs
// with the device scratch ``ws`` (ctq_wide_scratch bytes, 256-byte
// aligned; unused, and may be null, on the cluster path). A shape the
// plan does not take returns cudaErrorInvalidValue. Returns
// cudaGetLastError() of the launch.
extern "C" int fused_cat_gemv_w4(
    const void* x, int x_is_bf16, int m, int d,
    const void* blocks, int bk, const void* sign,
    const void* ha, int a, const void* hb, int b, int act_bits,
    const void* qw, int packed, const void* sw, int n, int sms, int cols,
    void* ws, void* out, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  ctq::Plan p;
  if (act_bits < 2 || act_bits > 8
      || !ctq::gemv_plan(m, d, n, a, b, blocks != nullptr ? bk : 0, packed,
                         sms, ctq::device_smem_optin(), cols, &p))
    return (int)cudaErrorInvalidValue;
#define REPRO_GEMV_ARGS                                                    \
  x, m, d, blocks, bk, sign, ha, a, hb, b, act_bits, qw, sw, n, p, sms,   \
      ws, out, stream
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
  return ctq::max_clusters(
      fused_cat_gemv_kernel<__nv_bfloat16, true, false>, cluster,
      (size_t)smem);
}

// Tiled entry (m > 8): stage 1 is the cluster transform-quant on the plan
// of ctq::tiled_plan (cluster_plan.h) with ``rows`` rows per cluster (0:
// the plan's) — on its streamed path one cooperative launch through the
// device scratch ``tws`` (ctq_wide_scratch(m, d, 0) bytes; may be null on
// the cluster path) — into the code scratch qx (m, k_pad) int8 (k_pad = d, or d
// + 1 for odd d against packed weights: that code is 0), sx, zx (m,) f32;
// stage 2 the tensor-core contraction, for packed or int8 weights,
// with ``splits`` K splits and their scratch ws (quant_matmul_plan of
// quant_matmul.cu, with k = k_pad). A shape the plan does not take returns
// cudaErrorInvalidValue. Returns cudaGetLastError() of the launches.
extern "C" int fused_cat_matmul_w4(
    const void* x, int x_is_bf16, int m, int d, int k_pad,
    const void* blocks, int bk, const void* sign,
    const void* ha, int a, const void* hb, int b, int act_bits,
    const void* qw, int packed, const void* sw, int n, int rows, int splits,
    void* ws, void* tws, void* qx, void* sx, void* zx, void* out,
    void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  ctq::Plan p;
  if (act_bits < 2 || act_bits > 8 || k_pad != d + (packed ? d % 2 : 0)
      || !ctq::tiled_plan(m, d, a, b, blocks != nullptr ? bk : 0,
                          ctq::device_smem_optin(), rows, &p))
    return (int)cudaErrorInvalidValue;
  cudaError_t err =
      x_is_bf16 ? launch_stage1<__nv_bfloat16>(x, m, d, k_pad, blocks, bk,
                                               sign, ha, a, hb, b, act_bits,
                                               p, tws, qx, sx, zx, stream)
                : launch_stage1<float>(x, m, d, k_pad, blocks, bk, sign, ha,
                                       a, hb, b, act_bits, p, tws, qx, sx,
                                       zx, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)contract::launch_mma(qx, k_pad, k_pad, sx, zx, m, k_pad, qw,
                                   packed, sw, n, splits, ws, out, stream);
}
