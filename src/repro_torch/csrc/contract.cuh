// Integer contraction of activation codes against int4-packed or int8
// weight codes, with the dequant + zero-point epilogue, for Hopper
// (sm_90a):
//   out[m, n] = sx[m] * sw[n] * (acc[m, n] - zx[m] * colsum[n]),
//   acc = sum_k qx[m, k] * qw[k, n] in exact int32.
// Shared by the fused CAT linear (fused_cat_matmul.cu, stage 2) and the
// stand-alone contractions of the composed linear (quant_matmul.cu).
//
// Two shapes. The GEMV (m <= 8: the packed weight is the only large
// stream; one CTA per 32 output columns, 8 K-slices reduced in shared
// memory) and the tiled one (m > 8: 32 x 64 output tiles, codes and
// unpacked weights staged in shared memory per 64-deep K step). Integer
// accumulation is exact over all of K, so the column sums ride along and
// the epilogue runs once (the TPU kernels add one f32 epilogue per K tile;
// the reference's oracle, like this, applies it once).
//
// qx is read with row stride ldq and its first k_valid codes; codes at
// k_valid <= k < k_pad count as 0 (odd K against a packed weight whose
// last byte has a zero high nibble). k_pad is the weight's unpacked row
// count: 2 * packed rows, or the int8 rows.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace contract {

constexpr int kGemvM = 8;       // rows served by the GEMV contraction
constexpr int kGemvCols = 32;   // output columns per GEMV CTA
constexpr int kGemvSlices = 8;  // K-slices per GEMV CTA
constexpr int kTM = 32, kTN = 64, kTK = 64;   // tiled contraction tile

__device__ __forceinline__ int lo_nibble(int byte) {
  return ((byte & 0xF) ^ 8) - 8;
}
__device__ __forceinline__ int hi_nibble(int byte) {
  return (((byte >> 4) & 0xF) ^ 8) - 8;
}

__device__ __forceinline__ float epilogue(float sxv, float swv, int acc,
                                          float zxv, int cs) {
  return __fmul_rn(__fmul_rn(sxv, swv),
                   __fsub_rn((float)acc, __fmul_rn(zxv, (float)cs)));
}

// GEMV contraction for m <= 8 rows.
// block (kGemvCols, kGemvSlices); dynamic shared memory: m * k_pad codes.
template <bool PACKED>
__global__ void contract_gemv_kernel(
    const int8_t* __restrict__ qx, int ldq, int k_valid,
    const float* __restrict__ sx, const float* __restrict__ zx, int m,
    int k_pad, const int8_t* __restrict__ qw, const float* __restrict__ sw,
    int n, float* __restrict__ out) {
  extern __shared__ int8_t s_q[];
  __shared__ int s_acc[kGemvM][kGemvSlices][kGemvCols];
  __shared__ int s_cs[kGemvSlices][kGemvCols];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kGemvCols + tx, nt = kGemvCols * kGemvSlices;
  for (int i = tid; i < m * k_pad; i += nt) {
    const int r = i / k_pad, k = i - r * k_pad;
    s_q[i] = k < k_valid ? qx[(size_t)r * ldq + k] : 0;
  }
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

// Tiled contraction for m > 8 rows.
// grid (ceil(n / 64), ceil(m / 32)); block (64, 4): each thread owns one
// column and eight rows of the 32 x 64 output tile.
template <bool PACKED>
__global__ void contract_tiled_kernel(
    const int8_t* __restrict__ qx, int ldq, int k_valid,
    const float* __restrict__ sx, const float* __restrict__ zx, int m,
    int k_pad, const int8_t* __restrict__ qw, const float* __restrict__ sw,
    int n, float* __restrict__ out) {
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
      s_a[r][k] = (gr < m && gk < k_valid) ? qx[(size_t)gr * ldq + gk] : 0;
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

// Launch the GEMV contraction (m <= kGemvM). Returns cudaGetLastError().
inline cudaError_t launch_gemv(const void* qx, int ldq, int k_valid,
                               const void* sx, const void* zx, int m,
                               int k_pad, const void* qw, int packed,
                               const void* sw, int n, void* out,
                               cudaStream_t stream) {
  dim3 grid((n + kGemvCols - 1) / kGemvCols);
  dim3 block(kGemvCols, kGemvSlices);
  const size_t smem = (size_t)m * k_pad;
  auto q = static_cast<const int8_t*>(qx);
  auto s = static_cast<const float*>(sx);
  auto z = static_cast<const float*>(zx);
  auto w = static_cast<const int8_t*>(qw);
  auto sc = static_cast<const float*>(sw);
  auto o = static_cast<float*>(out);
  if (packed) {
    contract_gemv_kernel<true><<<grid, block, smem, stream>>>(
        q, ldq, k_valid, s, z, m, k_pad, w, sc, n, o);
  } else {
    contract_gemv_kernel<false><<<grid, block, smem, stream>>>(
        q, ldq, k_valid, s, z, m, k_pad, w, sc, n, o);
  }
  return cudaGetLastError();
}

// Launch the tiled contraction (any m). Returns cudaGetLastError().
inline cudaError_t launch_tiled(const void* qx, int ldq, int k_valid,
                                const void* sx, const void* zx, int m,
                                int k_pad, const void* qw, int packed,
                                const void* sw, int n, void* out,
                                cudaStream_t stream) {
  dim3 grid((n + kTN - 1) / kTN, (m + kTM - 1) / kTM);
  dim3 block(kTN, 4);
  auto q = static_cast<const int8_t*>(qx);
  auto s = static_cast<const float*>(sx);
  auto z = static_cast<const float*>(zx);
  auto w = static_cast<const int8_t*>(qw);
  auto sc = static_cast<const float*>(sw);
  auto o = static_cast<float*>(out);
  if (packed) {
    contract_tiled_kernel<true><<<grid, block, 0, stream>>>(
        q, ldq, k_valid, s, z, m, k_pad, w, sc, n, o);
  } else {
    contract_tiled_kernel<false><<<grid, block, 0, stream>>>(
        q, ldq, k_valid, s, z, m, k_pad, w, sc, n, o);
  }
  return cudaGetLastError();
}

}  // namespace contract
