// Sign and Kronecker Hadamard transform for Hopper (sm_90a), plain C
// interface:
//   y = (x * sign) @ (ha kron hb)^T   per row, in f32, written in x's dtype
// (sign null means ones).
//
// Replaces the Pallas TPU kernel hadamard_transform of
// src/repro/kernels/hadamard.py:37 (two factor matmuls on the (TM*a, b)
// and (TM*b, a) views, factors resident in VMEM). Each row, viewed as Y
// (a x b), becomes Ha Y Hb^T in two dots:
//   Z[i, l] = sum_j Y[i, j] Hb[l, j],   out[p, l] = sum_i Ha[p, i] Z[i, l].
// Both stay inside one column l, so a CTA owns a tile of R rows (whole, in
// shared memory) and a slice of L of the b output columns: grid
// (ceil(m / R), b / L). Its threads own (i, l) pairs, then (p, l) pairs,
// each with R accumulators in registers, so every factor element read
// from shared memory serves all R rows of the tile; the slices fill the
// card when the rows alone are few (M 8). Each output element is one
// fmaf chain from 0, over j and then over i, exactly as the fused
// linear's cluster transform (cluster_tq.cuh) computes it, so the two
// agree bitwise in f32; that is why the tensor cores are not used (TF32 rounds the
// inputs). Shared memory is laid out so that a warp's reads hit distinct
// banks or one broadcast word: the row tile with an odd stride per (r, i)
// row, Ha and Hb's slice transposed.
//
// Bound on this card: bytes (the activation in and out, 2 x M x D x elt)
// over HBM bandwidth; the 2 x M x D x (a + b) FLOPs stay below the f32
// rate's share at these shapes. The factors are read once per CTA.
#include "transform_quant.cuh"

namespace {

constexpr int kThreads = 256;
constexpr size_t kSmemMax = 227 * 1024;   // a CTA's opt-in limit on sm_90

// Slice width L: the widest divisor of b whose (i, l) pairs fit the block.
int slice_cols(int a, int b) {
  int best = 1;
  for (int l = 1; l <= b; ++l)
    if (b % l == 0 && a * l <= kThreads) best = l;
  return best;
}

size_t smem_bytes(int rows, int a, int b, int cols) {
  return sizeof(float) * ((size_t)rows * a * (b | 1) + (size_t)a * a +
                          (size_t)b * cols + (size_t)rows * a * cols);
}

// grid (ceil(m / R), b / cols), block kThreads; dynamic shared memory
// smem_bytes(R, a, b, cols).
template <typename T, int R>
__global__ void __launch_bounds__(kThreads) hadamard_kernel(
    const T* __restrict__ x, int m, int a, int b, int cols,
    const float* __restrict__ sign, const float* __restrict__ ha,
    const float* __restrict__ hb, T* __restrict__ out) {
  extern __shared__ float smem[];
  const int ys = b | 1, d = a * b;
  float* s_y = smem;                    // R x a x ys: the sign-scaled rows
  float* s_hat = s_y + R * a * ys;      // a x a: Ha transposed
  float* s_hbt = s_hat + a * a;         // b x cols: Hb's slice transposed
  float* s_z = s_hbt + b * cols;        // R x a x cols
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * R, l0 = blockIdx.y * cols;
  const int rows = min(R, m - r0);
  for (int e = tid; e < R * d; e += kThreads) {
    const int r = e / d, c = e - r * d, i = c / b, j = c - i * b;
    float v = 0.f;
    if (r < rows) {
      v = tq::to_f32(x[(size_t)(r0 + r) * d + c]);
      if (sign != nullptr) v = v * sign[c];
    }
    s_y[(r * a + i) * ys + j] = v;
  }
  for (int e = tid; e < a * a; e += kThreads) {
    const int p = e / a, i = e - p * a;
    s_hat[i * a + p] = ha[e];
  }
  for (int e = tid; e < cols * b; e += kThreads) {
    const int l = e / b, j = e - l * b;
    s_hbt[j * cols + l] = hb[(size_t)(l0 + l) * b + j];
  }
  __syncthreads();
  const int pairs = a * cols;
  // Z[r, i, l] = sum_j Y[r, i, j] Hb[l0 + l, j]
  for (int q = tid; q < pairs; q += kThreads) {
    const int i = q / cols, l = q - i * cols;
    const float* y = s_y + i * ys;
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
    for (int j = 0; j < b; ++j) {
      const float w = s_hbt[j * cols + l];
#pragma unroll
      for (int r = 0; r < R; ++r)
        acc[r] = fmaf(y[r * a * ys + j], w, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) s_z[(r * a + i) * cols + l] = acc[r];
  }
  __syncthreads();
  // out[r, p * b + l0 + l] = sum_i Ha[p, i] Z[r, i, l]
  for (int q = tid; q < pairs; q += kThreads) {
    const int p = q / cols, l = q - p * cols;
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
    for (int i = 0; i < a; ++i) {
      const float w = s_hat[i * a + p];
#pragma unroll
      for (int r = 0; r < R; ++r)
        acc[r] = fmaf(s_z[(r * a + i) * cols + l], w, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (r < rows)
        out[(size_t)(r0 + r) * d + p * b + l0 + l] = tq::from_f32<T>(acc[r]);
  }
}

template <typename T, int R>
cudaError_t launch_rows(const void* x, int m, int a, int b, int cols,
                        size_t smem, const void* sign, const void* ha,
                        const void* hb, void* out, cudaStream_t stream) {
  static bool opted_in = false;   // once per instantiation, before capture
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        hadamard_kernel<T, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kSmemMax);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  dim3 grid((m + R - 1) / R, b / cols);
  hadamard_kernel<T, R><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), m, a, b, cols,
      static_cast<const float*>(sign), static_cast<const float*>(ha),
      static_cast<const float*>(hb), static_cast<T*>(out));
  return cudaGetLastError();
}

// Rows per CTA: ``rows`` when given (1, 2, 4 or 8), else halved from 8
// while the grid has fewer than two CTAs per SM (on an H100 the fastest
// of the four at every shape of chip_smoke.py's sweep: M 8 and 128, D 512
// and 1536); then halved until the CTA's shared memory fits. 0 when even
// one row does not fit.
int plan_rows(int m, int a, int b, int cols, int rows) {
  int r = rows;
  if (r == 0) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    r = 8;
    while (r > 1 && ((m + r - 1) / r) * (b / cols) < 2 * sms) r /= 2;
  }
  while (r >= 1 && smem_bytes(r, a, b, cols) > kSmemMax) r /= 2;
  return r;
}

template <typename T>
cudaError_t launch(const void* x, int m, int d, const void* sign,
                   const void* ha, int a, const void* hb, int b, int rows,
                   void* out, cudaStream_t stream) {
  if (a <= 0 || b <= 0 || a * b != d ||
      !(rows == 0 || rows == 1 || rows == 2 || rows == 4 || rows == 8))
    return cudaErrorInvalidValue;
  const int cols = slice_cols(a, b);
  const int r = plan_rows(m, a, b, cols, rows);
  if (r < 1) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(r, a, b, cols);
  switch (r) {
    case 8:
      return launch_rows<T, 8>(x, m, a, b, cols, smem, sign, ha, hb, out,
                               stream);
    case 4:
      return launch_rows<T, 4>(x, m, a, b, cols, smem, sign, ha, hb, out,
                               stream);
    case 2:
      return launch_rows<T, 2>(x, m, a, b, cols, smem, sign, ha, hb, out,
                               stream);
    default:
      return launch_rows<T, 1>(x, m, a, b, cols, smem, sign, ha, hb, out,
                               stream);
  }
}

}  // namespace

// x (m, d) f32 or bf16, sign (d,) f32 or null, ha (a, a), hb (b, b) f32
// with a * b = d -> out (m, d) in x's dtype. ``rows`` per CTA: 0 lets the
// source choose (plan_rows), else 1, 2, 4 or 8. Returns
// cudaErrorInvalidValue for factors that do not span d, another ``rows``,
// or a width whose one-row CTA exceeds the card's shared memory, else
// cudaGetLastError() of the launch.
extern "C" int hadamard_transform(const void* x, int x_is_bf16, int m,
                                  int d, const void* sign, const void* ha,
                                  int a, const void* hb, int b, int rows,
                                  void* out, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (x_is_bf16)
    return (int)launch<__nv_bfloat16>(x, m, d, sign, ha, a, hb, b, rows,
                                      out, stream);
  return (int)launch<float>(x, m, d, sign, ha, a, hb, b, rows, out, stream);
}
