// The decode QKV prologue for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel decode_qkv_prologue of
// src/repro/kernels/decode_layer.py:162. For B <= 8 decode rows, in ONE
// launch: block-CAT -> * sign -> Kronecker Hadamard -> per-token
// asymmetric act quant -> W4A8 (or W8A8) contraction against the
// concatenated [q | k | v] weight with the epilogue
// sx*sw*(acc - zx*colsum) -> RoPE on the q and k heads at per-row
// positions -> symmetric int8 quant of k and v per (row, KV head) ->
// scatter of codes and scales into row row_ids[r] of page page_ids[r] of
// the layer's pools, in place. q comes back rope'd in f32 (bf16 values
// for bf16 rows).
//
// Design for this card: one CTA per head (n_q/hd q heads, then the k and v
// heads: 16 CTAs at catlm-60m's full width), in thread-block clusters of
// c heads (c = 8 there: 2 clusters). Each cluster computes the rows'
// transform and quant ONCE, split c ways (cluster_tq.cuh, shared with the
// fused CAT GEMV), which leaves all m x d codes in every CTA's shared
// memory (pushed by its peers). The TPU kernel sweeps a sequential (N, K)
// grid and carries the accumulator in VMEM; here every CTA owns its head's
// hd columns outright (their weight rows staged in shared memory by
// 16-byte cp.async at kernel start), so the RoPE pairs (i, i + hd/2) and
// the per-head amax of the KV quant stay inside the CTA and its codes go
// straight to the pool.
//
// Widths the cluster transform does not split (ctq::general: odd D, any
// factors, any CAT block dividing D) run on clusters of one head CTA
// through the general path of cluster_tq.cuh, bitwise as the vector path.
// Widths whose operands the cluster's shared memory does not hold (D
// 2048 at head_dim 128, 5120 and up) take the streamed path of
// wide_tq.cuh: one cooperative launch, the first weight stages issued
// before the transform runs through a device scratch, then each head's K
// split over CTAs on the tensor cores, streamed through a deep ring, the
// splits' exact sums added in split order, and the same head epilogue
// run once, by the head's owner.
//
// Bound on this card: the packed QKV weight (D/2 x N bytes, 256 KiB at
// full width) over HBM bandwidth; everything else is a few KiB. The design
// reads each weight byte once (each CTA its own hd columns) and keeps
// codes, accumulators and the head's outputs on chip. Arithmetic follows
// the plain version's roundings: __fmul_rn/__fsub_rn/__fadd_rn where torch
// rounds every op (no FMA contraction), rintf (round half to even), IEEE
// division, and cosf/sinf of angles computed from the wrapper's own torch
// ``freq`` vector. For bf16 rows it also rounds where the composed path
// (the fused linear, then RoPE and the KV quant in torch) rounds: the
// linear's outputs to bf16, and the rope'd q and k to bf16 again, so a
// decode row's q, codes and scales do not depend on which path served it.
#include <type_traits>

#include "cluster_tq.cuh"
#include "wide_tq.cuh"

namespace {

constexpr int kMaxRows = ctq::kMaxRows;   // decode rows per launch

// v rounded to T (round to nearest even, as torch's .to(bfloat16)).
template <typename T>
__device__ __forceinline__ float in_dtype(float v) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return __bfloat162float(__float2bfloat16_rn(v));
  else
    return v;
}

// The head's epilogue, by every thread of its CTA: the (m, hd) outputs
// from the exact sums s_acc (row r at r * hd) and column sums s_cs
// (rounded to T where the composed path rounds), RoPE on q and k heads,
// then q out, or the symmetric int8 quant per (row, KV head) and the
// paged scatter. Ends at a block barrier or with the head's last store.
template <typename T>
__device__ void head_epilogue(int head, int m, const float* s_sx,
                              const float* s_zx, const float* s_sw,
                              const int* s_acc, const int* s_cs,
                              float* s_out, int n_q, int n_kv, int hd,
                              const float* __restrict__ freq, int kv_bits,
                              const int* __restrict__ page_ids,
                              const int* __restrict__ row_ids,
                              const int* __restrict__ positions,
                              int page_size, int8_t* __restrict__ k_pool,
                              float* __restrict__ k_scale,
                              int8_t* __restrict__ v_pool,
                              float* __restrict__ v_scale,
                              float* __restrict__ q_out) {
  const int tid = threadIdx.x, nt = blockDim.x, kvh = n_kv / hd;
  __shared__ float s_amax[kMaxRows];
  for (int t = tid; t < m * hd; t += nt) {
    const int r = t / hd, j = t - r * hd;
    s_out[t] = in_dtype<T>(contract::epilogue(s_sx[r], s_sw[j], s_acc[t],
                                              s_zx[r], s_cs[j]));
  }
  __syncthreads();

  // 3. RoPE (half-split pairs) on q and k heads, at each row's position
  const int n_q_heads = n_q / hd;
  const bool is_q = head < n_q_heads;
  const bool is_k = !is_q && head < n_q_heads + kvh;
  const int half = hd / 2;
  if (is_q || is_k) {
    for (int idx = tid; idx < m * half; idx += nt) {
      const int r = idx / half, i = idx - r * half;
      const float ang = __fmul_rn((float)positions[r], freq[i]);
      const float cv = cosf(ang), sv = sinf(ang);
      const float x1 = s_out[r * hd + i], x2 = s_out[r * hd + i + half];
      s_out[r * hd + i] =
          in_dtype<T>(__fsub_rn(__fmul_rn(x1, cv), __fmul_rn(x2, sv)));
      s_out[r * hd + i + half] =
          in_dtype<T>(__fadd_rn(__fmul_rn(x2, cv), __fmul_rn(x1, sv)));
    }
    __syncthreads();
  }
  if (is_q) {
    for (int idx = tid; idx < m * hd; idx += nt) {
      const int r = idx / hd, i = idx - r * hd;
      q_out[(size_t)r * n_q + head * hd + i] = s_out[r * hd + i];
    }
    return;
  }

  // 4. symmetric int8 quant per (row, KV head) and the paged scatter
  const int kv_head = is_k ? head - n_q_heads : head - n_q_heads - kvh;
  int8_t* pool = is_k ? k_pool : v_pool;
  float* pscale = is_k ? k_scale : v_scale;
  const int warp = tid >> 5, lane = tid & 31;
  for (int r = warp; r < m; r += nt >> 5) {
    float amax = 0.f;
    for (int i = lane; i < hd; i += 32)
      amax = fmaxf(amax, fabsf(s_out[r * hd + i]));
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    if (lane == 0) s_amax[r] = amax;
  }
  __syncthreads();
  const float qmax = (float)((1 << (kv_bits - 1)) - 1);
  const float inv_qmax = 1.f / qmax;   // the compiled reference's reciprocal
  for (int idx = tid; idx < m * hd; idx += nt) {
    const int r = idx / hd, i = idx - r * hd;
    const float scale = __fmul_rn(fmaxf(s_amax[r], 1e-12f), inv_qmax);
    const float code = fminf(fmaxf(rintf(s_out[r * hd + i] / scale),
                                    -qmax - 1.f),
                             qmax);
    const size_t slot =
        ((size_t)page_ids[r] * page_size + row_ids[r]) * kvh + kv_head;
    pool[slot * hd + i] = (int8_t)code;
    if (i == 0) pscale[slot] = scale;
  }
  __syncthreads();
}

// grid (n_heads_total), clusters of c, ctq::kThreads threads; CTA
// blockIdx.x owns head blockIdx.x. Dynamic shared memory: the plan's
// (ctq::CtaLayout with outputs): the transform's (all m x d codes
// included), the head's weight columns, partial sums and (m, hd) outputs.
// ANY: the general path (c = 1), K padded to k_groups(d) with zero codes
// and zero weight rows.
template <typename T, bool PACKED, bool ANY>
__global__ void __launch_bounds__(ctq::kThreads) decode_qkv_prologue_kernel(
    const T* __restrict__ x, int m, int d,
    const float* __restrict__ blocks, int bk,
    const float* __restrict__ sign,
    const float* __restrict__ ha, int a,
    const float* __restrict__ hb, int b, int act_bits,
    const int8_t* __restrict__ qw, const float* __restrict__ sw, int n,
    int n_q, int n_kv, int hd, const float* __restrict__ freq,
    int kv_bits, const int* __restrict__ page_ids,
    const int* __restrict__ row_ids, const int* __restrict__ positions,
    int page_size, int8_t* __restrict__ k_pool, float* __restrict__ k_scale,
    int8_t* __restrict__ v_pool, float* __restrict__ v_scale,
    float* __restrict__ q_out, int vw) {
  extern __shared__ float4 prologue_smem_base[];   // 16-byte aligned
  char* smem = reinterpret_cast<char*>(prologue_smem_base);
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int head = blockIdx.x;
  const int L = d / c, bl = b / c;
  const int unit = PACKED ? 2 : 1;   // K per weight row
  const ctq::CtaLayout lay(m, d, c, a, b, blocks != nullptr ? bk : 0,
                           PACKED, hd, true, ANY);
  int8_t* s_w = reinterpret_cast<int8_t*>(smem + lay.w);
  int* s_part = reinterpret_cast<int*>(smem + lay.part);
  int* s_pcs = s_part + lay.slices * m * hd;
  float* s_out = reinterpret_cast<float*>(smem + lay.out);
  float* s_sw = reinterpret_cast<float*>(smem + lay.sw);
  __shared__ float s_sx[kMaxRows], s_zx[kMaxRows];

  // 1. the transform's operands and the head's weight columns (loads
  //    overlap the transform), then the rows' transform + quant over the
  //    cluster, which leaves all the codes in every CTA
  if constexpr (ANY) {
    ctq::stage_transform_any(x, m, d, blocks, bk, sign, ha, a, hb, b,
                             lay.tq, smem);
    ctq::stage_f32(s_sw, sw + head * hd, hd);
    const int w_rows = (d + unit - 1) / unit;   // the weight's rows
    ctq::stage_weights(s_w, lay.pitch, qw, n, w_rows, w_rows, 1, 1,
                       head * hd, hd, vw);
    ctq::zero_weight_rows(s_w, lay.pitch, w_rows, ctq::k_groups(d) / unit);
    ctq::transform_quant_any(
        m, d, blocks != nullptr, bk, sign, a, b, act_bits, lay.tq, smem,
        s_sx, s_zx, reinterpret_cast<int8_t*>(smem + lay.tq.qall),
        ctq::align16(d), ctq::k_groups(d));
  } else {
    ctq::stage_transform(x, m, d, c, rank, blocks, bk, sign, ha, a, hb, b,
                         lay.tq, smem);
    ctq::stage_f32(s_sw, sw + head * hd, hd);
    ctq::stage_weights(s_w, lay.pitch, qw, n, d / unit, L / unit, bl / unit,
                       b / unit, head * hd, hd, vw);
    ctq::transform_quant(m, d, c, rank, blocks != nullptr, bk, sign, a, b,
                         act_bits, lay.tq, smem, s_sx, s_zx);
    cluster.sync();   // every CTA holds all the codes
  }
  ctq::cp_async_wait_all();
  __syncthreads();

  // 2. the head's hd columns over all of K (the table's row stride and
  //    the K contracted: d on the vector path; d rounded up to 16 and to
  //    a dp4a group on the general one), then the head's epilogue
  ctq::contract_codes<PACKED, kMaxRows>(
      reinterpret_cast<const int8_t*>(smem + lay.tq.qall),
      ANY ? (int)ctq::align16(d) : d, ANY ? ctq::k_groups(d) : d, s_w,
      lay.pitch, hd, m, s_part, s_pcs);
  head_epilogue<T>(head, m, s_sx, s_zx, s_sw, s_part, s_pcs, s_out, n_q,
                   n_kv, hd, freq, kv_bits, page_ids, row_ids, positions,
                   page_size, k_pool, k_scale, v_pool, v_scale, q_out);
}

// The streamed path (cluster_plan.h path 1): one cooperative launch (the
// plan's CTAs per SM). Each CTA issues the weight stages of its first
// work items (a head's K split each, ctq::stream_plan); the grid
// transforms and quantizes the m rows into the scratch ws (wide_tq.cuh),
// then each CTA contracts its items on the tensor cores (wide::Stream),
// and the head's owner adds its splits in split order after a grid
// barrier and runs the head's epilogue (RoPE, KV quant, scatter) as the
// cluster kernel does, once. Dynamic shared memory: the plan's
// (ctq::StreamLayout with outputs).
template <typename T, bool PACKED>
__global__ void __launch_bounds__(ctq::kThreads, ctq::kStreamCtasPerSm)
    wide_prologue_kernel(
    const T* __restrict__ x, int m, int d,
    const float* __restrict__ blocks, int bk,
    const float* __restrict__ sign,
    const float* __restrict__ ha, int a,
    const float* __restrict__ hb, int b, int act_bits,
    const int8_t* __restrict__ qw, const float* __restrict__ sw, int n,
    int n_q, int n_kv, int hd, const float* __restrict__ freq,
    int kv_bits, const int* __restrict__ page_ids,
    const int* __restrict__ row_ids, const int* __restrict__ positions,
    int page_size, int8_t* __restrict__ k_pool, float* __restrict__ k_scale,
    int8_t* __restrict__ v_pool, float* __restrict__ v_scale,
    float* __restrict__ q_out, ctq::Plan p, int vw, void* ws) {
  extern __shared__ float4 wide_prologue_smem_base[];   // 16-byte aligned
  char* smem = reinterpret_cast<char*>(wide_prologue_smem_base);
  const wide::Regions s(ws, m, d, p.ktile);
  const size_t ldq = ctq::wide_ldq(d, p.ktile);
  wide::Stream<PACKED> st(
      wide::StreamArgs{s.q, ldq, (int)ldq, m, true, qw, d, n, vw, p, s.part},
      smem, true);
  st.init();
  st.prefetch_weights();
  wide::transform_quant(x, m, d, blocks, bk, sign, ha, a, hb, b, act_bits,
                        s.y, s.z, s.mm, s.q, ldq, (int)ldq, nullptr, nullptr,
                        reinterpret_cast<float*>(smem + st.lay.tq));
  float* s_sw = reinterpret_cast<float*>(smem + st.lay.sw);
  float* s_out = reinterpret_cast<float*>(smem + st.lay.out);
  __shared__ float s_sx[kMaxRows], s_zx[kMaxRows];
  if (threadIdx.x < m) {
    float zp;
    wide::row_params(s.mm, threadIdx.x, act_bits, &s_sx[threadIdx.x], &zp,
                     &s_zx[threadIdx.x]);
  }
  st.prefetch_codes();
  st.run([&](int head, const int* s_tot) {
    for (int j = threadIdx.x; j < hd; j += ctq::kThreads)
      s_sw[j] = __ldg(sw + head * hd + j);
    __syncthreads();
    head_epilogue<T>(head, m, s_sx, s_zx, s_sw, s_tot, s_tot + m * hd,
                     s_out, n_q, n_kv, hd, freq, kv_bits, page_ids, row_ids,
                     positions, page_size, k_pool, k_scale, v_pool, v_scale,
                     q_out);
  });
}

template <typename T, bool PACKED>
cudaError_t launch(const void* x, int m, int d, const void* blocks, int bk,
                   const void* sign, const void* ha, int a, const void* hb,
                   int b, int act_bits, const void* qw, const void* sw, int n,
                   int n_q, int n_kv, int hd, const void* freq, int kv_bits,
                   const void* page_ids, const void* row_ids,
                   const void* positions, int page_size, void* k_pool,
                   void* k_scale, void* v_pool, void* v_scale, void* q_out,
                   const ctq::Plan& p, void* ws, cudaStream_t stream) {
  if (p.path == 1) {
    if (ws == nullptr) return cudaErrorInvalidValue;
    return wide::launch(
        wide_prologue_kernel<T, PACKED>, p.per_sm * ctq::device_sms(),
        (size_t)p.smem,
        stream, static_cast<const T*>(x), m, d,
        static_cast<const float*>(blocks), bk,
        static_cast<const float*>(sign), static_cast<const float*>(ha), a,
        static_cast<const float*>(hb), b, act_bits,
        static_cast<const int8_t*>(qw), static_cast<const float*>(sw), n,
        n_q, n_kv, hd, static_cast<const float*>(freq), kv_bits,
        static_cast<const int*>(page_ids), static_cast<const int*>(row_ids),
        static_cast<const int*>(positions), page_size,
        static_cast<int8_t*>(k_pool), static_cast<float*>(k_scale),
        static_cast<int8_t*>(v_pool), static_cast<float*>(v_scale),
        static_cast<float*>(q_out), p, ctq::weight_vector(qw, n, hd), ws);
  }
  auto kernel =
      ctq::splits(d, a, b, blocks != nullptr ? bk : 0, p.cluster)
          ? decode_qkv_prologue_kernel<T, PACKED, false>
          : decode_qkv_prologue_kernel<T, PACKED, true>;
  return ctq::launch_cluster(
      kernel, p.clusters * p.cluster, p.cluster, (size_t)p.smem, stream,
      static_cast<const T*>(x), m, d, static_cast<const float*>(blocks), bk,
      static_cast<const float*>(sign), static_cast<const float*>(ha), a,
      static_cast<const float*>(hb), b, act_bits,
      static_cast<const int8_t*>(qw), static_cast<const float*>(sw), n, n_q,
      n_kv, hd, static_cast<const float*>(freq), kv_bits,
      static_cast<const int*>(page_ids), static_cast<const int*>(row_ids),
      static_cast<const int*>(positions), page_size,
      static_cast<int8_t*>(k_pool), static_cast<float*>(k_scale),
      static_cast<int8_t*>(v_pool), static_cast<float*>(v_scale),
      static_cast<float*>(q_out), ctq::weight_vector(qw, n, hd));
}

}  // namespace

// One launch in clusters of head CTAs, on the plan of ctq::prologue_plan
// (cluster_plan.h); on its streamed path (plan path 1) one cooperative
// launch of the plan's CTAs per SM with the device scratch ``ws``
// (ctq_wide_scratch bytes, 256-byte aligned; may be null on the cluster
// path). A shape the plan does not take returns cudaErrorInvalidValue.
// Returns cudaGetLastError() of the launch.
extern "C" int decode_qkv_prologue(
    const void* x, int x_is_bf16, int m, int d,
    const void* blocks, int bk, const void* sign,
    const void* ha, int a, const void* hb, int b, int act_bits,
    const void* qw, int packed, const void* sw, int n,
    int n_q, int n_kv, int hd, const void* freq, int kv_bits,
    const void* page_ids, const void* row_ids, const void* positions,
    int page_size, void* k_pool, void* k_scale, void* v_pool,
    void* v_scale, void* q_out, void* ws, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  ctq::Plan p;
  if (act_bits < 2 || act_bits > 8
      || !ctq::prologue_plan(m, d, n, hd, a, b, blocks != nullptr ? bk : 0,
                             packed, ctq::device_sms(),
                             ctq::device_smem_optin(), &p))
    return (int)cudaErrorInvalidValue;
#define REPRO_PROLOGUE_ARGS                                                 \
  x, m, d, blocks, bk, sign, ha, a, hb, b, act_bits, qw, sw, n, n_q, n_kv,  \
      hd, freq, kv_bits, page_ids, row_ids, positions, page_size, k_pool,   \
      k_scale, v_pool, v_scale, q_out, p, ws, stream
  cudaError_t err;
  if (x_is_bf16) {
    err = packed ? launch<__nv_bfloat16, true>(REPRO_PROLOGUE_ARGS)
                 : launch<__nv_bfloat16, false>(REPRO_PROLOGUE_ARGS);
  } else {
    err = packed ? launch<float, true>(REPRO_PROLOGUE_ARGS)
                 : launch<float, false>(REPRO_PROLOGUE_ARGS);
  }
#undef REPRO_PROLOGUE_ARGS
  return (int)err;
}

// Clusters of ``cluster`` CTAs of the prologue (bf16 x, packed weights)
// resident at once with ``smem`` bytes each, or -1 on error.
extern "C" int decode_qkv_prologue_capacity(int cluster, int smem) {
  return ctq::max_clusters(
      decode_qkv_prologue_kernel<__nv_bfloat16, true, false>, cluster,
      (size_t)smem);
}
