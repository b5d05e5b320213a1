// The decode QKV prologue for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel decode_qkv_prologue of
// src/repro/kernels/decode_layer.py:162. For B <= 8 decode rows, in ONE
// launch: block-CAT -> * sign -> Kronecker Hadamard -> per-token
// asymmetric act quant (transform_quant.cuh) -> W4A8 (or W8A8) contraction
// against the concatenated [q | k | v] weight with the epilogue
// sx*sw*(acc - zx*colsum) -> RoPE on the q and k heads at per-row
// positions -> symmetric int8 quant of k and v per (row, KV head) ->
// scatter of codes and scales into row row_ids[r] of page page_ids[r] of
// the layer's pools, in place. q comes back rope'd in f32.
//
// Design for this card: one CTA per head (n_q/hd q heads, then the k and v
// heads: 16 CTAs at catlm-60m's full width). The TPU kernel sweeps a
// sequential (N, K) grid and carries the accumulator in VMEM; here every
// CTA owns its head's hd columns outright, so the RoPE pairs (i, i + hd/2)
// and the per-head amax of the KV quant stay inside the CTA and its codes
// go straight to the pool. Each CTA recomputes the rows' transform and
// quant in shared memory (B x D x (bk + a + b) MACs, ~8 x 512 x 80 at full
// width, every factor element read once for all B rows) instead of a
// second launch and a code round trip through HBM.
//
// Bound on this card: the packed QKV weight (D/2 x N bytes, 256 KiB at
// full width) over HBM bandwidth; everything else is a few KiB. The design
// reads each weight byte once (each CTA its own hd columns) and keeps
// codes, accumulators and the head's outputs on chip. Arithmetic follows
// the plain version's roundings: __fmul_rn/__fsub_rn/__fadd_rn where torch
// rounds every op (no FMA contraction), rintf (round half to even), IEEE
// division, and cosf/sinf of angles computed from the wrapper's own torch
// ``freq`` vector.
#include "transform_quant.cuh"

namespace {

constexpr int kMaxRows = 8;      // decode rows per launch
constexpr int kThreads = 256;    // threads per CTA: hd columns x K-slices
constexpr size_t kDefaultSmem = 32 * 1024;   // no opt-in needed below

__device__ __forceinline__ int lo_nibble(int byte) {
  return ((byte & 0xF) ^ 8) - 8;
}
__device__ __forceinline__ int hi_nibble(int byte) {
  return (((byte >> 4) & 0xF) ^ 8) - 8;
}

// grid (n_heads_total), block kThreads. Dynamic shared memory:
// (2*m*d + a*a + b*b) floats, then m * k_pad int8 codes; the head's
// outputs reuse the s_x region once the codes are made.
template <typename T, bool PACKED>
__global__ void decode_qkv_prologue_kernel(
    const T* __restrict__ x, int m, int d, int k_pad,
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
    float* __restrict__ q_out) {
  extern __shared__ float smem[];
  float* s_x = smem;
  float* s_y = s_x + (size_t)m * d;
  float* s_hat = s_y + (size_t)m * d;
  float* s_hbt = s_hat + a * a;
  int8_t* s_q = reinterpret_cast<int8_t*>(s_hbt + b * b);
  float* s_out = s_x;   // (m, hd): the head's outputs, after the codes
  __shared__ float red_min[kMaxRows * 32], red_max[kMaxRows * 32];
  __shared__ float s_sx[kMaxRows], s_zx[kMaxRows];
  __shared__ int s_acc[kMaxRows][kThreads];
  __shared__ int s_cs[kThreads];
  __shared__ float s_amax[kMaxRows];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int head = blockIdx.x;
  const int kvh = n_kv / hd;

  // 1. every row's transform + quant, codes kept in shared memory
  tq::load_factors(ha, a, hb, b, s_hat, s_hbt);
  tq::transform_quant_rows<T, kMaxRows>(x, m, d, k_pad, blocks, bk, sign,
                                        s_hat, a, s_hbt, b, act_bits, s_x,
                                        s_y, red_min, red_max, s_q, s_sx,
                                        s_zx);

  // 2. the head's hd columns: thread (c, s) sums K-slice s of column c
  const int c = tid % hd, slice = tid / hd, slices = nt / hd;
  const int col = head * hd + c;
  int acc[kMaxRows];
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) acc[r] = 0;
  int cs = 0;
  if (PACKED) {
    for (int pr = slice; pr < k_pad / 2; pr += slices) {
      const int byte = qw[(size_t)pr * n + col];
      const int lo = lo_nibble(byte), hi = hi_nibble(byte);
      cs += lo + hi;
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        if (r < m) {
          acc[r] += (int)s_q[r * k_pad + 2 * pr] * lo
                  + (int)s_q[r * k_pad + 2 * pr + 1] * hi;
        }
      }
    }
  } else {
    for (int k = slice; k < k_pad; k += slices) {
      const int w = qw[(size_t)k * n + col];
      cs += w;
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        if (r < m) acc[r] += (int)s_q[r * k_pad + k] * w;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) s_acc[r][tid] = acc[r];
  s_cs[tid] = cs;
  __syncthreads();
  if (tid < hd) {
    int total_cs = 0;
    for (int s = 0; s < slices; ++s) total_cs += s_cs[s * hd + tid];
    const float swv = sw[col];
    for (int r = 0; r < m; ++r) {
      int total = 0;
      for (int s = 0; s < slices; ++s) total += s_acc[r][s * hd + tid];
      s_out[r * hd + tid] = __fmul_rn(
          __fmul_rn(s_sx[r], swv),
          __fsub_rn((float)total, __fmul_rn(s_zx[r], (float)total_cs)));
    }
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
      s_out[r * hd + i] = __fsub_rn(__fmul_rn(x1, cv), __fmul_rn(x2, sv));
      s_out[r * hd + i + half] = __fadd_rn(__fmul_rn(x2, cv), __fmul_rn(x1, sv));
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
}

template <typename T, bool PACKED>
cudaError_t launch(const void* x, int m, int d, int k_pad,
                   const void* blocks, int bk, const void* sign,
                   const void* ha, int a, const void* hb, int b,
                   int act_bits, const void* qw, const void* sw, int n,
                   int n_q, int n_kv, int hd, const void* freq, int kv_bits,
                   const void* page_ids, const void* row_ids,
                   const void* positions, int page_size, void* k_pool,
                   void* k_scale, void* v_pool, void* v_scale, void* q_out,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * (size_t)m * d + a * a + b * b)
                      + (size_t)m * k_pad;
  const int heads = (n_q + 2 * n_kv) / hd;
  static size_t opted_in = kDefaultSmem;   // per instantiation
  if (smem > opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_qkv_prologue_kernel<T, PACKED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    opted_in = smem;
  }
  decode_qkv_prologue_kernel<T, PACKED><<<heads, kThreads, smem, stream>>>(
      static_cast<const T*>(x), m, d, k_pad,
      static_cast<const float*>(blocks), bk,
      static_cast<const float*>(sign), static_cast<const float*>(ha), a,
      static_cast<const float*>(hb), b, act_bits,
      static_cast<const int8_t*>(qw), static_cast<const float*>(sw), n, n_q,
      n_kv, hd, static_cast<const float*>(freq), kv_bits,
      static_cast<const int*>(page_ids), static_cast<const int*>(row_ids),
      static_cast<const int*>(positions), page_size,
      static_cast<int8_t*>(k_pool), static_cast<float*>(k_scale),
      static_cast<int8_t*>(v_pool), static_cast<float*>(v_scale),
      static_cast<float*>(q_out));
  return cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() of the launch.
extern "C" int decode_qkv_prologue(
    const void* x, int x_is_bf16, int m, int d, int k_pad,
    const void* blocks, int bk, const void* sign,
    const void* ha, int a, const void* hb, int b, int act_bits,
    const void* qw, int packed, const void* sw, int n,
    int n_q, int n_kv, int hd, const void* freq, int kv_bits,
    const void* page_ids, const void* row_ids, const void* positions,
    int page_size, void* k_pool, void* k_scale, void* v_pool,
    void* v_scale, void* q_out, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
#define REPRO_PROLOGUE_ARGS                                                 \
  x, m, d, k_pad, blocks, bk, sign, ha, a, hb, b, act_bits, qw, sw, n, n_q, \
      n_kv, hd, freq, kv_bits, page_ids, row_ids, positions, page_size,     \
      k_pool, k_scale, v_pool, v_scale, q_out, stream
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
