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
// the row in shared memory and writes its codes (m, k_pad) int8 plus
// sx, zx (m,) f32 to a scratch buffer the wrapper allocates: (k_pad + 8)
// bytes per row written and read back once, which the contraction then
// revisits from shared memory. Stage 2 is either the GEMV contraction
// (m <= 8: the packed weight is the only large stream; one CTA per 32
// output columns, 8 K-slices reduced in shared memory) or the tiled one
// (m > 8: 32 x 64 output tiles, codes and unpacked weights staged in
// shared memory per 64-deep K step). Integer accumulation is exact, so the
// column sums are accumulated beside it and the epilogue runs once.
//
// Bound on this card: at decode shapes (m <= 8) the packed-weight bytes
// (D/2 x N) over HBM bandwidth; at the 128-row ragged step the weight is
// still the larger stream (D/2 x N vs m x D x 2), so bytes bound both.
// The design reads each weight byte once per M tile, keeps codes on chip,
// and uses plain int32 FMAs (no wgmma yet).
#include "transform_quant.cuh"

namespace {

constexpr int kGemvM = 8;       // rows served by the GEMV contraction
constexpr int kGemvCols = 32;   // output columns per GEMV CTA
constexpr int kGemvSlices = 8;  // K-slices per GEMV CTA
constexpr int kTM = 32, kTN = 64, kTK = 64;   // tiled contraction tile
constexpr int kStage1Threads = 256;

__device__ __forceinline__ int lo_nibble(int byte) {
  return ((byte & 0xF) ^ 8) - 8;
}
__device__ __forceinline__ int hi_nibble(int byte) {
  return (((byte >> 4) & 0xF) ^ 8) - 8;
}

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
  float* s_ha = s_y + d;
  float* s_hb = s_ha + a * a;
  __shared__ float red_min[32], red_max[32];
  const int row = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int i = tid; i < a * a; i += nt) s_ha[i] = ha[i];
  for (int i = tid; i < b * b; i += nt) s_hb[i] = hb[i];
  tq::transform_quant_rows<T, 1>(x + (size_t)row * d, 1, d, k_pad, blocks,
                                 bk, sign, s_ha, a, s_hb, b, act_bits, s_x,
                                 s_y, red_min, red_max,
                                 qx + (size_t)row * k_pad, sx + row,
                                 zx + row);
}

__device__ __forceinline__ float epilogue(float sxv, float swv, int acc,
                                          float zxv, int cs) {
  return __fmul_rn(__fmul_rn(sxv, swv),
                   __fsub_rn((float)acc, __fmul_rn(zxv, (float)cs)));
}

// Stage 2a: GEMV contraction for m <= 8 rows.
// block (kGemvCols, kGemvSlices); dynamic shared memory: m * k_pad codes.
template <bool PACKED>
__global__ void contract_gemv_kernel(
    const int8_t* __restrict__ qx, const float* __restrict__ sx,
    const float* __restrict__ zx, int m, int k_pad,
    const int8_t* __restrict__ qw, const float* __restrict__ sw, int n,
    float* __restrict__ out) {
  extern __shared__ int8_t s_q[];
  __shared__ int s_acc[kGemvM][kGemvSlices][kGemvCols];
  __shared__ int s_cs[kGemvSlices][kGemvCols];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kGemvCols + tx, nt = kGemvCols * kGemvSlices;
  for (int i = tid; i < m * k_pad; i += nt) s_q[i] = qx[i];
  __syncthreads();
  const int col = blockIdx.x * kGemvCols + tx;
  int acc[kGemvM];
#pragma unroll
  for (int r = 0; r < kGemvM; ++r) acc[r] = 0;
  int cs = 0;
  if (col < n) {
    if (PACKED) {
      const int kp = k_pad / 2;
      for (int pr = ty; pr < kp; pr += kGemvSlices) {
        const int byte = qw[(size_t)pr * n + col];
        const int lo = lo_nibble(byte), hi = hi_nibble(byte);
        cs += lo + hi;
#pragma unroll
        for (int r = 0; r < kGemvM; ++r) {
          if (r < m) {
            acc[r] += (int)s_q[r * k_pad + 2 * pr] * lo
                    + (int)s_q[r * k_pad + 2 * pr + 1] * hi;
          }
        }
      }
    } else {
      for (int k = ty; k < k_pad; k += kGemvSlices) {
        const int w = qw[(size_t)k * n + col];
        cs += w;
#pragma unroll
        for (int r = 0; r < kGemvM; ++r) {
          if (r < m) acc[r] += (int)s_q[r * k_pad + k] * w;
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kGemvM; ++r) s_acc[r][ty][tx] = acc[r];
  s_cs[ty][tx] = cs;
  __syncthreads();
  if (ty == 0 && col < n) {
    int total_cs = 0;
    for (int s = 0; s < kGemvSlices; ++s) total_cs += s_cs[s][tx];
    const float swv = sw[col];
    for (int r = 0; r < m; ++r) {
      int total = 0;
      for (int s = 0; s < kGemvSlices; ++s) total += s_acc[r][s][tx];
      out[(size_t)r * n + col] = epilogue(sx[r], swv, total, zx[r], total_cs);
    }
  }
}

// Stage 2b: tiled contraction for m > 8 rows.
// grid (ceil(n / 64), ceil(m / 32)); block (64, 4): each thread owns one
// column and eight rows of the 32 x 64 output tile.
template <bool PACKED>
__global__ void contract_tiled_kernel(
    const int8_t* __restrict__ qx, const float* __restrict__ sx,
    const float* __restrict__ zx, int m, int k_pad,
    const int8_t* __restrict__ qw, const float* __restrict__ sw, int n,
    float* __restrict__ out) {
  __shared__ int8_t s_a[kTM][kTK + 4];
  __shared__ int8_t s_b[kTK][kTN];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTN + tx, nt = kTN * 4;
  const int m0 = blockIdx.y * kTM, n0 = blockIdx.x * kTN;
  const int col = n0 + tx;
  int acc[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) acc[r] = 0;
  int cs = 0;
  for (int k0 = 0; k0 < k_pad; k0 += kTK) {
    for (int i = tid; i < kTM * kTK; i += nt) {
      const int r = i / kTK, k = i - r * kTK;
      const int gr = m0 + r, gk = k0 + k;
      s_a[r][k] = (gr < m && gk < k_pad) ? qx[(size_t)gr * k_pad + gk] : 0;
    }
    if (PACKED) {
      for (int i = tid; i < (kTK / 2) * kTN; i += nt) {
        const int pr = i / kTN, c = i - pr * kTN;
        const int gpr = k0 / 2 + pr, gc = n0 + c;
        const int byte = (gpr < k_pad / 2 && gc < n)
                             ? qw[(size_t)gpr * n + gc] : 0;
        s_b[2 * pr][c] = (int8_t)lo_nibble(byte);
        s_b[2 * pr + 1][c] = (int8_t)hi_nibble(byte);
      }
    } else {
      for (int i = tid; i < kTK * kTN; i += nt) {
        const int k = i / kTN, c = i - k * kTN;
        const int gk = k0 + k, gc = n0 + c;
        s_b[k][c] = (gk < k_pad && gc < n) ? qw[(size_t)gk * n + gc] : 0;
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kTK; ++kk) {
      const int w = s_b[kk][tx];
      cs += w;
#pragma unroll
      for (int r = 0; r < 8; ++r) acc[r] += (int)s_a[ty * 8 + r][kk] * w;
    }
    __syncthreads();
  }
  if (col < n) {
    const float swv = sw[col];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int row = m0 + ty * 8 + r;
      if (row < m) {
        out[(size_t)row * n + col] = epilogue(sx[row], swv, acc[r], zx[row], cs);
      }
    }
  }
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
  dim3 grid((n + kGemvCols - 1) / kGemvCols);
  dim3 block(kGemvCols, kGemvSlices);
  const size_t smem = (size_t)m * k_pad;
  const int8_t* q = static_cast<const int8_t*>(qx);
  const float* s = static_cast<const float*>(sx);
  const float* z = static_cast<const float*>(zx);
  if (packed) {
    contract_gemv_kernel<true><<<grid, block, smem, stream>>>(
        q, s, z, m, k_pad, static_cast<const int8_t*>(qw),
        static_cast<const float*>(sw), n, static_cast<float*>(out));
  } else {
    contract_gemv_kernel<false><<<grid, block, smem, stream>>>(
        q, s, z, m, k_pad, static_cast<const int8_t*>(qw),
        static_cast<const float*>(sw), n, static_cast<float*>(out));
  }
  return (int)cudaGetLastError();
}

// Tiled entry (m > 8). Returns cudaGetLastError() of the launches.
extern "C" int fused_cat_matmul_w4(
    const void* x, int x_is_bf16, int m, int d, int k_pad,
    const void* blocks, int bk, const void* sign,
    const void* ha, int a, const void* hb, int b, int act_bits,
    const void* qw, int packed, const void* sw, int n,
    void* qx, void* sx, void* zx, void* out, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err = stage1(x, x_is_bf16, m, d, k_pad, blocks, bk, sign, ha,
                           a, hb, b, act_bits, qx, sx, zx, stream);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + kTN - 1) / kTN, (m + kTM - 1) / kTM);
  dim3 block(kTN, 4);
  const int8_t* q = static_cast<const int8_t*>(qx);
  const float* s = static_cast<const float*>(sx);
  const float* z = static_cast<const float*>(zx);
  if (packed) {
    contract_tiled_kernel<true><<<grid, block, 0, stream>>>(
        q, s, z, m, k_pad, static_cast<const int8_t*>(qw),
        static_cast<const float*>(sw), n, static_cast<float*>(out));
  } else {
    contract_tiled_kernel<false><<<grid, block, 0, stream>>>(
        q, s, z, m, k_pad, static_cast<const int8_t*>(qw),
        static_cast<const float*>(sw), n, static_cast<float*>(out));
  }
  return (int)cudaGetLastError();
}
