// Paged attention over the int8 KV page pool for Hopper (sm_90a), plain C
// interface.
//
// Replaces the Pallas TPU kernels paged_attention_ragged and
// paged_attention_decode of src/repro/kernels/paged_attention.py. One CTA
// per (work item, KV head, block of 128 query rows): it walks the item's
// page-table row, stages each int8 K/V page of its head in shared memory
// dequantized by the per-(token, head) scales, and every thread carries
// one query row's online-softmax state (m, l, acc[hd]) in f32 registers.
// A query row attends kv positions p with p <= q_pos and p < length
// (the decode entry has no q_pos: p < length); q_pos < 0 marks a padding
// row, whose output is written as zeros. Masked positions are skipped, so
// null and ragged pages get exactly zero weight. q is scaled by hd^-1/2
// in f32 and rounded back to q's dtype before the dots, as the reference
// kernels do; the output is written in q's dtype.
//
// Bound on this card: the int8 page bytes of the attended prefix plus
// their scales, over HBM bandwidth. The design streams each page once per
// (item, head, row block) and keeps scores and softmax state on chip; a
// CTA whose rows are all padding exits before reading any page.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int kRows = 128;   // query rows (and threads) per CTA

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float round_to(float v, float*) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// q, out: (R, nq, kvh, g, HD); pages: (n_pages, page_size, kvh, HD) int8;
// scales: (n_pages, page_size, kvh, 1) f32; table (R, n_ptab) int32;
// lengths (R,) int32; q_pos (R, nq) int32 or nullptr (decode).
// Dynamic shared memory: 2 * page_size * HD floats.
template <typename T, int HD>
__global__ void paged_attn_kernel(
    const T* __restrict__ q, const int8_t* __restrict__ k_pages,
    const float* __restrict__ k_scale, const int8_t* __restrict__ v_pages,
    const float* __restrict__ v_scale, const int32_t* __restrict__ table,
    int n_ptab, const int32_t* __restrict__ lengths,
    const int32_t* __restrict__ q_pos, int nq, int kvh, int g,
    int page_size, float q_scale, T* __restrict__ out) {
  extern __shared__ float smem[];
  float* s_k = smem;
  float* s_v = smem + page_size * HD;
  __shared__ int s_horizon;
  const int item = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x;
  const int r = blockIdx.z * kRows + tid;
  const bool active = r < nq * g;
  const int qi = active ? r / g : 0;
  const int gi = active ? r - qi * g : 0;
  const int len = lengths[item];
  int qpos = -1;
  if (active) qpos = q_pos != nullptr ? q_pos[item * nq + qi] : len - 1;
  const int horizon = qpos >= 0 ? min(qpos + 1, len) : 0;
  if (tid == 0) s_horizon = 0;
  __syncthreads();
  if (horizon > 0) atomicMax(&s_horizon, horizon);
  __syncthreads();
  const int cta_horizon = s_horizon;
  const size_t row_off = ((((size_t)item * nq + qi) * kvh + h) * g + gi) * HD;
  if (cta_horizon == 0) {
    if (active) {
      for (int dd = 0; dd < HD; ++dd) store(out + row_off + dd, 0.f);
    }
    return;
  }
  T* round_tag = nullptr;
  float qv[HD], acc[HD];
#pragma unroll
  for (int dd = 0; dd < HD; ++dd) {
    qv[dd] = active ? round_to(to_f32(q[row_off + dd]) * q_scale, round_tag)
                    : 0.f;
    acc[dd] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  const int n_pages = min((cta_horizon + page_size - 1) / page_size, n_ptab);
  const int32_t* trow = table + (size_t)item * n_ptab;
  for (int p = 0; p < n_pages; ++p) {
    const size_t page = (size_t)trow[p];
    __syncthreads();
    for (int idx = tid; idx < page_size * HD; idx += kRows) {
      const int row = idx / HD, dd = idx - row * HD;
      const size_t tok = (page * page_size + row) * kvh + h;
      s_k[idx] = (float)k_pages[tok * HD + dd] * k_scale[tok];
      s_v[idx] = (float)v_pages[tok * HD + dd] * v_scale[tok];
    }
    __syncthreads();
    const int j_end = min(page_size, horizon - p * page_size);
    for (int j = 0; j < j_end; ++j) {
      const float* kr = s_k + j * HD;
      const float* vr = s_v + j * HD;
      float s = 0.f;
#pragma unroll
      for (int dd = 0; dd < HD; ++dd) s = fmaf(qv[dd], kr[dd], s);
      const float m_new = fmaxf(m, s);
      const float corr = expf(m - m_new);
      const float pw = expf(s - m_new);
      l = l * corr + pw;
#pragma unroll
      for (int dd = 0; dd < HD; ++dd) acc[dd] = fmaf(pw, vr[dd], acc[dd] * corr);
      m = m_new;
    }
  }
  if (active) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int dd = 0; dd < HD; ++dd) {
      store(out + row_off + dd, horizon > 0 ? acc[dd] * inv : 0.f);
    }
  }
}

template <typename T, int HD>
cudaError_t launch_typed(const void* q, const void* kp, const void* ks,
                         const void* vp, const void* vs, const void* table,
                         int n_ptab, const void* lengths, const void* q_pos,
                         int n_items, int nq, int kvh, int g, int page_size,
                         float q_scale, void* out, cudaStream_t stream) {
  dim3 grid(n_items, kvh, (nq * g + kRows - 1) / kRows);
  const size_t smem = sizeof(float) * 2 * (size_t)page_size * HD;
  paged_attn_kernel<T, HD><<<grid, kRows, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const int8_t*>(kp),
      static_cast<const float*>(ks), static_cast<const int8_t*>(vp),
      static_cast<const float*>(vs), static_cast<const int32_t*>(table),
      n_ptab, static_cast<const int32_t*>(lengths),
      static_cast<const int32_t*>(q_pos), nq, kvh, g, page_size, q_scale,
      static_cast<T*>(out));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(int hd, const void* q, const void* kp, const void* ks,
                      const void* vp, const void* vs, const void* table,
                      int n_ptab, const void* lengths, const void* q_pos,
                      int n_items, int nq, int kvh, int g, int page_size,
                      float q_scale, void* out, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch_typed<T, 32>(q, kp, ks, vp, vs, table, n_ptab, lengths,
                                 q_pos, n_items, nq, kvh, g, page_size,
                                 q_scale, out, stream);
    case 64:
      return launch_typed<T, 64>(q, kp, ks, vp, vs, table, n_ptab, lengths,
                                 q_pos, n_items, nq, kvh, g, page_size,
                                 q_scale, out, stream);
    case 128:
      return launch_typed<T, 128>(q, kp, ks, vp, vs, table, n_ptab, lengths,
                                  q_pos, n_items, nq, kvh, g, page_size,
                                  q_scale, out, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

int launch(int q_is_bf16, int hd, const void* q, const void* kp,
           const void* ks, const void* vp, const void* vs, const void* table,
           int n_ptab, const void* lengths, const void* q_pos, int n_items,
           int nq, int kvh, int g, int page_size, float q_scale, void* out,
           void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err = q_is_bf16
      ? launch_hd<__nv_bfloat16>(hd, q, kp, ks, vp, vs, table, n_ptab,
                                 lengths, q_pos, n_items, nq, kvh, g,
                                 page_size, q_scale, out, stream)
      : launch_hd<float>(hd, q, kp, ks, vp, vs, table, n_ptab, lengths,
                         q_pos, n_items, nq, kvh, g, page_size, q_scale, out,
                         stream);
  return (int)err;
}

}  // namespace

// Ragged (mixed q_len) entry: q (R, nq, kvh, g, hd), q_pos (R, nq).
extern "C" int paged_attention_ragged(
    const void* q, int q_is_bf16, const void* k_pages, const void* k_scale,
    const void* v_pages, const void* v_scale, const void* table, int n_ptab,
    const void* lengths, const void* q_pos, int n_items, int nq, int kvh,
    int g, int hd, int page_size, float q_scale, void* out,
    void* stream_ptr) {
  return launch(q_is_bf16, hd, q, k_pages, k_scale, v_pages, v_scale, table,
                n_ptab, lengths, q_pos, n_items, nq, kvh, g, page_size,
                q_scale, out, stream_ptr);
}

// Decode (q_len = 1) entry: q (B, kvh, g, hd); row b attends p < lengths[b].
extern "C" int paged_attention_decode(
    const void* q, int q_is_bf16, const void* k_pages, const void* k_scale,
    const void* v_pages, const void* v_scale, const void* table, int n_ptab,
    const void* lengths, int n_items, int kvh, int g, int hd, int page_size,
    float q_scale, void* out, void* stream_ptr) {
  return launch(q_is_bf16, hd, q, k_pages, k_scale, v_pages, v_scale, table,
                n_ptab, lengths, nullptr, n_items, 1, kvh, g, page_size,
                q_scale, out, stream_ptr);
}
