// Quantized contractions from precomputed activation codes for Hopper
// (sm_90a), plain C interface:
//   out[m, n] = sx[m] * sw[n] * (sum_k qx[m, k] qw[k, n] - zx[m] colsum[n])
// for int8 activation codes qx (m, k) against nibble-packed int4 weight
// codes (ceil(k/2), n) (quant_gemv_w4, quant_matmul_w4) or int8 codes
// (k, n) (quant_matmul), f32 out.
//
// Replaces the Pallas TPU kernels quant_matmul_w4 and quant_gemv_w4 of
// src/repro/kernels/quant_matmul_w4.py:72 and :127 and quant_matmul of
// src/repro/kernels/quant_matmul.py:42. The Pallas kernels add one f32
// epilogue per K tile; these accumulate exact int32 over all of K and
// apply the epilogue once, as the reference's oracle does. Odd K: the
// packed weight's last byte carries a zero high nibble and the missing
// activation code reads as 0, as the reference pads qx.
//
// At m <= 8 rows (quant_gemv_w4; quant_matmul for m <= 8) the code GEMV
// below: one CTA of ctq::kThreads per `cols` output columns (the plan of
// ctq::code_gemv_plan, cluster_plan.h, which fills every SM), the weight
// rows of its columns staged by 16-byte cp.async (cluster_tq.cuh
// stage_weights) and the m rows of codes once per CTA by 16-byte
// cp.async, then ctq::contract_codes, the dp4a contraction the decode
// fused linear and the prologue run: K split over kThreads / cols slices
// of whole dp4a groups, 16 codes of a row per read, the column sums riding
// along, the slices added in shared memory, one epilogue. At a K whose
// tile does not fit in shared memory even at 4 columns (about 9,100 int8
// or 13,700 packed K at m 8: the deep wd of LLMs) the plan is the
// streamed one (path 1), and the kernel the streamed contraction of the
// decode linear's streamed path (wide_tq.cuh wide::Stream): one
// cooperative launch, K through a deep ring onto the tensor cores, each
// column tile's K split over CTAs, the splits' exact int32 sums added in
// split order, one epilogue per output. Above 8 rows,
// the tensor-core contraction of contract.cuh that the fused CAT linear's
// stage 2 runs (quant_matmul_w4 at any m, quant_matmul above 8 rows:
// mma.sync m16n8k32 s8 on 64 x 64 tiles, weights transposed in shared
// memory, nibbles unpacked to s8 there for the packed weight, K split
// across CTAs where the tiles alone leave SMs idle).
//
// Bound on this card: the weight codes (k/2 x n packed, k x n int8) over
// HBM bandwidth at decode shapes and at 128 rows alike; the int8
// operations (2 m k n) are far below the tensor-core rate. At decode
// shapes the GEMV is in practice bound by its dependent phases (a load,
// the contraction, the slice sum, the epilogue), which the plan shortens
// by spreading the columns over every SM.
#include "cluster_tq.cuh"
#include "contract.cuh"
#include "wide_tq.cuh"

namespace {

// The packed weight's unpacked row count for k activation codes.
int k_pad_w4(int k) { return 2 * ((k + 1) / 2); }

// The code GEMV: grid (ceil(n / tc)), ctq::kThreads threads; CTA x owns
// output columns [x * tc, x * tc + tc). qx (m, k) with row stride ldx
// (vec: 16-byte rows at a 16-byte aligned address); qw (w_rows, n) int8
// or packed (bytes of K 2p | 2p + 1 << 4). Dynamic shared memory: the
// plan's (ctq::GemvLayout).
template <bool PACKED>
__global__ void __launch_bounds__(ctq::kThreads) code_gemv_kernel(
    const int8_t* __restrict__ qx, int ldx, int k, bool vec,
    const float* __restrict__ sx, const float* __restrict__ zx, int m,
    const int8_t* __restrict__ qw, const float* __restrict__ sw, int n,
    int tc, int vw, float* __restrict__ out) {
  extern __shared__ float4 code_gemv_smem[];   // 16-byte aligned
  char* smem = reinterpret_cast<char*>(code_gemv_smem);
  const ctq::GemvLayout lay(m, k, PACKED, tc);
  int8_t* s_q = reinterpret_cast<int8_t*>(smem + lay.q);
  int8_t* s_w = reinterpret_cast<int8_t*>(smem + lay.w);
  int* s_part = reinterpret_cast<int*>(smem + lay.part);
  int* s_pcs = s_part + lay.slices * m * tc;
  const int n0 = blockIdx.x * tc, cols = min(tc, n - n0);
  const int unit = PACKED ? 2 : 1, kg = ctq::k_groups(k);
  const int ldq = (int)ctq::align16(k), w_rows = (k + unit - 1) / unit;
  // the weight columns (the larger stream) first, then the codes
  ctq::stage_weights(s_w, lay.pitch, qw, n, w_rows, w_rows, 1, 1, n0, tc,
                     vw);
  ctq::zero_weight_rows(s_w, lay.pitch, w_rows, kg / unit);
  const int c16 = ldq / 16;
  for (int t = threadIdx.x; t < m * c16; t += ctq::kThreads) {
    const int r = t / c16, c = (t - r * c16) * 16;
    const int8_t* src = qx + (size_t)r * ldx + c;
    int8_t* dst = s_q + r * ldq + c;
    if (vec && c + 16 <= k) {
      contract::w8a8::cp_async16(dst, src);
    } else {
      for (int e = 0; e < 16; ++e) dst[e] = c + e < k ? src[e] : (int8_t)0;
    }
  }
  ctq::cp_async_commit();
  ctq::cp_async_wait_all();
  __syncthreads();
  ctq::contract_codes<PACKED, ctq::kMaxRows>(s_q, ldq, kg, s_w, lay.pitch,
                                             tc, m, s_part, s_pcs);
  for (int t = threadIdx.x; t < m * cols; t += ctq::kThreads) {
    const int r = t / cols, j = t - r * cols;
    out[(size_t)r * n + n0 + j] = contract::epilogue(
        sx[r], sw[n0 + j], s_part[r * tc + j], zx[r], s_pcs[j]);
  }
}

// The code GEMV at a K too deep for one tile of all of K (the plan's path
// 1): one cooperative launch (the plan's CTAs per SM) running the streamed
// contraction of the decode linear's streamed path (wide::Stream): each
// CTA issues its first weight stages, then contracts its work items (a
// column tile's K split each) on the tensor cores; a tile's splits are
// added in split order by its owner after a grid barrier, which applies
// the epilogue. qx (m, k) with row stride k (vec: 16-byte rows at a
// 16-byte aligned address); gws: the splits' partial sums
// (ctq::stream_totals).
template <bool PACKED>
__global__ void __launch_bounds__(ctq::kThreads, ctq::kStreamCtasPerSm)
    code_gemv_stream_kernel(
    const int8_t* __restrict__ qx, int k, bool vec,
    const float* __restrict__ sx, const float* __restrict__ zx, int m,
    const int8_t* __restrict__ qw, const float* __restrict__ sw, int n,
    ctq::Plan p, int vw, int* gws, float* __restrict__ out) {
  extern __shared__ float4 code_stream_smem[];   // 16-byte aligned
  char* smem = reinterpret_cast<char*>(code_stream_smem);
  wide::Stream<PACKED> st(
      wide::StreamArgs{qx, (size_t)k, k, m, vec, qw, k, n, vw, p, gws},
      smem);
  st.init();
  st.prefetch_weights();
  __shared__ float s_sx[ctq::kMaxRows], s_zx[ctq::kMaxRows];
  if (threadIdx.x < m) {
    s_sx[threadIdx.x] = sx[threadIdx.x];
    s_zx[threadIdx.x] = zx[threadIdx.x];
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

// Launch the code GEMV of m <= 8 rows on the plan of ctq::code_gemv_plan
// for a card of ``sms`` SMs with ``cols`` columns per CTA (0: the plan's)
// (with ``stream``: on ctq::stream_plan, the streamed contraction whatever
// the K, for timing it alone); its streamed plan takes the scratch gws.
// A shape the plan does not take returns cudaErrorInvalidValue. Returns
// the launch's CUDA error.
cudaError_t launch_code_gemv(const void* qx, int m, int k, const void* sx,
                             const void* zx, const void* qw, int packed,
                             const void* sw, int n, int sms, int cols,
                             void* gws, void* out, cudaStream_t stream,
                             bool force_stream = false) {
  ctq::Plan p;
  const int optin = ctq::device_smem_optin();
  if (!(force_stream
            ? ctq::stream_plan(m, k, n, packed, cols, false, sms, optin, &p)
            : ctq::code_gemv_plan(m, k, n, packed, sms, optin, cols, &p)))
    return cudaErrorInvalidValue;
  const bool vec = k % 16 == 0 && reinterpret_cast<uintptr_t>(qx) % 16 == 0;
  const int vw = ctq::weight_vector(qw, n, p.cols);
  if (p.path == 1) {
    if (p.splits > 1 && gws == nullptr) return cudaErrorInvalidValue;
    auto kernel = packed ? code_gemv_stream_kernel<true>
                         : code_gemv_stream_kernel<false>;
    return wide::launch(kernel, p.per_sm * sms, (size_t)p.smem, stream,
                        static_cast<const int8_t*>(qx), k, vec,
                        static_cast<const float*>(sx),
                        static_cast<const float*>(zx), m,
                        static_cast<const int8_t*>(qw),
                        static_cast<const float*>(sw), n, p, vw,
                        static_cast<int*>(gws), static_cast<float*>(out));
  }
  auto kernel = packed ? code_gemv_kernel<true> : code_gemv_kernel<false>;
  const cudaError_t err = ctq::opt_in(kernel);
  if (err != cudaSuccess) return err;
  kernel<<<p.clusters, ctq::kThreads, (size_t)p.smem, stream>>>(
      static_cast<const int8_t*>(qx), k, k, vec,
      static_cast<const float*>(sx), static_cast<const float*>(zx), m,
      static_cast<const int8_t*>(qw), static_cast<const float*>(sw), n,
      p.cols, vw, static_cast<float*>(out));
  return cudaGetLastError();
}

}  // namespace

// qx (m, k) int8, sx/zx (m,) f32, qw packed (ceil(k/2), n) int8, sw (n,)
// f32 -> out (m, n) f32; m <= 8, the code GEMV on a card of ``sms`` SMs
// with ``cols`` columns per CTA (0: the plan's); on its streamed plan
// (a deep K) gws holds the splits' partial sums (ctq_stream_totals bytes;
// may be null otherwise). Returns the launch's CUDA error
// (cudaErrorInvalidValue for a shape the plan does not take).
extern "C" int quant_gemv_w4(const void* qx, int m, int k, const void* sx,
                             const void* zx, const void* qw, const void* sw,
                             int n, int sms, int cols, void* gws, void* out,
                             void* stream_ptr) {
  return (int)launch_code_gemv(qx, m, k, sx, zx, qw, 1, sw, n, sms, cols,
                               gws, out,
                               static_cast<cudaStream_t>(stream_ptr));
}

// The streamed contraction alone, as the decode linear's streamed path
// runs it (ctq::stream_plan with ``cols`` columns per tile, 0: the
// plan's), whatever the K: qx (m, k) int8 against packed or int8 weights
// (``packed``), the other operands as quant_gemv_w4's, gws the plan's
// split sums (ctq_stream_totals bytes; null for one split). For timing the
// contraction apart from the transform. Returns the launch's CUDA error.
extern "C" int quant_gemv_stream(const void* qx, int m, int k,
                                 const void* sx, const void* zx,
                                 const void* qw, int packed, const void* sw,
                                 int n, int sms, int cols, void* gws,
                                 void* out, void* stream_ptr) {
  return (int)launch_code_gemv(qx, m, k, sx, zx, qw, packed, sw, n, sms,
                               cols, gws, out,
                               static_cast<cudaStream_t>(stream_ptr), true);
}

// As quant_gemv_w4, any m, through the tensor-core contraction with
// ``splits`` K splits and their scratch ws (quant_matmul_plan of (m, k,
// n)). Returns cudaGetLastError().
extern "C" int quant_matmul_w4(const void* qx, int m, int k, const void* sx,
                               const void* zx, const void* qw, const void* sw,
                               int n, int splits, void* ws, void* out,
                               void* stream_ptr) {
  return (int)contract::launch_mma(qx, k, k, sx, zx, m, k_pad_w4(k), qw, 1,
                                   sw, n, splits, ws, out,
                                   static_cast<cudaStream_t>(stream_ptr));
}

// K splits of quant_matmul's or quant_matmul_w4's (m, k) x (k, n)
// contraction (and of the fused linear's stage 2, k = k_pad) on a card of
// ``sms`` SMs (contract::w8a8_splits; 1 for m <= 8); *scratch gets the
// zeroed int32 elements they need (0 for one split).
extern "C" int quant_matmul_plan(int m, int k, int n, int sms,
                                 long long* scratch) {
  const int splits = contract::w8a8_splits(m, k, n, sms);
  *scratch = contract::w8a8_scratch(m, n, splits);
  return splits;
}

// qx (m, k) int8 against int8 weight codes qw (k, n): the code GEMV for m
// <= 8 (on ``sms`` SMs, ``cols`` columns per CTA, 0: the plan's; on its
// streamed plan with the totals gws), the tensor-core contraction above
// with ``splits`` K splits and their scratch ws, as quant_matmul_plan
// gives them. Returns the launches' CUDA error.
extern "C" int quant_matmul(const void* qx, int m, int k, const void* sx,
                            const void* zx, const void* qw, const void* sw,
                            int n, int splits, void* ws, int sms, int cols,
                            void* gws, void* out, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (m <= contract::kGemvM)
    return (int)launch_code_gemv(qx, m, k, sx, zx, qw, 0, sw, n, sms, cols,
                                 gws, out, stream);
  return (int)contract::launch_mma(qx, k, k, sx, zx, m, k, qw, 0, sw, n,
                                   splits, ws, out, stream);
}
