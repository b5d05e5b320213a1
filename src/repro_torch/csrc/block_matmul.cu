// Block-diagonal matmul (the online block-CAT transform) for Hopper
// (sm_90a), plain C interface:
//   y[..., i*k:(i+1)*k] = x[..., i*k:(i+1)*k] @ B_i^T,  blocks (n, k, k),
// in f32, written in x's dtype.
//
// Replaces the Pallas TPU kernel block_diag_matmul of
// src/repro/kernels/block_matmul.py:26, whose grid is (token tile, block).
// Here too: one CTA per (tile of up to kTM = 16 rows, block i). It
// stages B_i (k x (k+1) f32, the pad keeps a warp's column reads on
// distinct banks) and the tile's k-wide slice of x (16-byte loads where
// the rows allow) in shared memory once, so each block is read once per
// row tile, not once per row. Each thread owns one output column c and up
// to kRows rows of the tile, and each output element is one fmaf chain
// over j = 0..k-1 from 0, in the order the cluster transform's block-CAT
// uses (cluster_tq.cuh): the composed linear's block-CAT equals the fused
// linear's bitwise in f32, and a row's values do not depend on its batch.
//
// Bound on this card: bytes (the activation in and out, 2 x M x D x
// elt, plus the D x k f32 blocks once) over HBM bandwidth; the 2 x M x D x
// k FLOPs are far below the f32 rate at these shapes. No tensor cores:
// the work is a few MFLOP and exactness matters more.
#include "transform_quant.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTM = 16;    // rows per CTA at most
constexpr int kRows = 2;   // rows per thread at most

// Rows per CTA for block width bk: kThreads / bk threads share a column
// group, each owning up to kRows rows of the tile.
int tile_rows(int bk) {
  const int per_col = kThreads / bk;
  return per_col * kRows < kTM ? per_col * kRows : kTM;
}

// Copy rows [m0, m0 + tm) of x's columns [c0, c0 + bk) to s_x (f32, row
// stride bk), 16 bytes per thread where ``vec`` (the row stride, the
// column offset and the base are 16-byte aligned), else one element.
template <typename T>
__device__ void load_tile(const T* __restrict__ x, int m, int d, int m0,
                          int tm, int c0, int bk, bool vec, float* s_x) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec) {
    const int per_row = bk / kVec;
    for (int i = threadIdx.x; i < tm * per_row; i += blockDim.x) {
      const int r = i / per_row, v = i - r * per_row;
      float* dst = s_x + r * bk + v * kVec;
      if (m0 + r < m) {
        const uint4 raw = *reinterpret_cast<const uint4*>(
            x + (size_t)(m0 + r) * d + c0 + v * kVec);
        const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int e = 0; e < kVec; ++e) dst[e] = tq::to_f32(vals[e]);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) dst[e] = 0.f;
      }
    }
  } else {
    for (int i = threadIdx.x; i < tm * bk; i += blockDim.x) {
      const int r = i / bk, j = i - r * bk;
      s_x[i] = m0 + r < m ? tq::to_f32(x[(size_t)(m0 + r) * d + c0 + j])
                          : 0.f;
    }
  }
}

// grid (d / bk, ceil(m / tm)), block kThreads; dynamic shared memory:
// (bk * (bk + 1) + tm * bk) floats.
template <typename T>
__global__ void block_diag_kernel(const T* __restrict__ x, int m, int d,
                                  const float* __restrict__ blocks, int bk,
                                  int tm, bool vec, T* __restrict__ out) {
  extern __shared__ float smem[];
  float* s_b = smem;                    // bk rows of bk + 1
  float* s_x = s_b + bk * (bk + 1);     // tm rows of bk
  const int blk = blockIdx.x, m0 = blockIdx.y * tm, c0 = blk * bk;
  const float* bsrc = blocks + (size_t)blk * bk * bk;
  for (int i = threadIdx.x; i < bk * bk; i += blockDim.x) {
    const int row = i / bk, j = i - row * bk;
    s_b[row * (bk + 1) + j] = bsrc[i];
  }
  load_tile(x, m, d, m0, tm, c0, bk, vec, s_x);
  __syncthreads();
  const int per_col = blockDim.x / bk;
  const int c = threadIdx.x % bk, r0 = threadIdx.x / bk;
  if (r0 >= per_col) return;
  const float* brow = s_b + c * (bk + 1);
  float acc[kRows];
#pragma unroll
  for (int q = 0; q < kRows; ++q) acc[q] = 0.f;
  for (int j = 0; j < bk; ++j) {
    const float w = brow[j];
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const int r = r0 + q * per_col;
      if (r < tm) acc[q] = fmaf(s_x[r * bk + j], w, acc[q]);
    }
  }
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const int r = r0 + q * per_col;
    if (r < tm && m0 + r < m)
      out[(size_t)(m0 + r) * d + c0 + c] = tq::from_f32<T>(acc[q]);
  }
}

template <typename T>
cudaError_t launch(const void* x, int m, int d, const void* blocks, int bk,
                   void* out, cudaStream_t stream) {
  if (bk <= 0 || bk > kThreads || d % bk) return cudaErrorInvalidValue;
  const int tm = tile_rows(bk);
  const size_t smem = sizeof(float) * ((size_t)bk * (bk + 1) + tm * bk);
  const bool vec = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                   (d * sizeof(T)) % 16 == 0 && (bk * sizeof(T)) % 16 == 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        block_diag_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(d / bk, (m + tm - 1) / tm);
  block_diag_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), m, d, static_cast<const float*>(blocks), bk,
      tm, vec, static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace

// x (m, d) f32 or bf16, blocks (d/bk, bk, bk) f32 -> out (m, d) in x's
// dtype. Returns cudaErrorInvalidValue for a block width the kernel does
// not take (above kThreads, or a CTA's shared memory above the card's
// opt-in limit), else cudaGetLastError() of the launch.
extern "C" int block_diag_matmul(const void* x, int x_is_bf16, int m, int d,
                                 const void* blocks, int bk, void* out,
                                 void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (x_is_bf16)
    return (int)launch<__nv_bfloat16>(x, m, d, blocks, bk, out, stream);
  return (int)launch<float>(x, m, d, blocks, bk, out, stream);
}
