// The streamed path of the cluster kernels, for Hopper (sm_90a): the CAT
// transform, the dynamic per-token quant and the code contraction at the
// widths whose operands do not fit in one cluster's shared memory (d_ff
// 14336 .. 24576, factors up to 192, N up to 32768). Used by the decode
// fused CAT linear and the tiled linear's stage 1 (fused_cat_matmul.cu)
// and by the decode QKV prologue (decode_layer.cu) wherever their plans
// (cluster_plan.h) say path 1.
//
// One cooperative launch of one CTA per SM. The transform's
// intermediates live in a device scratch buffer (ctq::WideScratch, read
// back through L2), so nothing of size d has to fit on chip:
//   1. block-CAT and sign of every value (y), the rows' ranges reset;
//   2. Z = Y Hb^T (z);
//   3. Ha Z (back into y), each CTA's range of each row folded into the
//      row's range by integer atomics on an order-preserving encoding of
//      the floats (min and max are exact in any order);
//   4. every row's scale and zero point (tq::asym_params of the range,
//      computed alike wherever it is needed) and the codes.
// A grid barrier separates the steps. Work goes out as items of kThreads
// consecutive values of one row, or of a group of eight rows where single
// rows would give a CTA more than two items, one value of each row per
// thread, so each transform output is ONE fmaf chain from 0
// computed whole by one thread, in the order of the cluster path and of
// the plain versions' fma_chain: the block-CAT over the block's row j, Z
// over j, Ha Z over i (eight chains side by side, unrolled by 4, so many
// L2 reads are in flight before their fmas, which stay in order). The
// codes, scales and zero points therefore equal the plain version's
// bitwise.
//
// The contraction then streams K: each CTA takes column tiles (the
// prologue: heads) in turn and runs through K in tiles of kt, the codes
// tile (L2) and the weight tile (HBM) of step t + 1 loading by cp.async
// into one stage of a two-stage ring while contract_codes sums step t
// from the other; exact int32 totals over the tiles, then the epilogue.
#pragma once

#include "cluster_tq.cuh"

namespace wide {

namespace cg = cooperative_groups;
using ctq::kThreads;
using ctq::kWarps;

// An order-preserving map of the non-NaN floats onto int (-0 below +0),
// so atomicMin / atomicMax on ints take the floats' min and max.
__device__ __forceinline__ int ord(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}
__device__ __forceinline__ float unord(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

// Row r's scale, zero point and signed-shifted zero point from its range
// (tq::asym_params, as the cluster path derives them).
__device__ __forceinline__ void row_params(const int* mm, int r, int bits,
                                           float* scale, float* zp,
                                           float* zx) {
  const float ymin = unord(__ldcg(mm + 2 * r));
  const float ymax = unord(__ldcg(mm + 2 * r + 1));
  tq::asym_params(ymin, ymax, bits, scale, zp);
  *zx = *zp - (float)(1 << (bits - 1));
}

// 16-byte cp.async through L2 only (the scratch is written by other CTAs
// of the same launch).
__device__ __forceinline__ void cp_async_cg16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

// Steps 1-4 for m rows of d = a * b (x row stride d), by every thread of
// the cooperative grid. Ends, after a grid barrier, with every row's codes
// at codes[r * ldq + k] for k < kz (0 for k >= d; kz <= ldq) and with
// sx, zx (if not null) holding each row's scale and signed-shifted zero
// point. y, z: m x d f32 planes; mm: 2 m ints (the scratch's). A work
// item of steps 1-3 is a group of R rows (rows past m compute on the
// group's first row and are never stored) and kThreads consecutive
// values: thread t computes value t of each row, R chains side by side,
// each factor element read once for them all.
template <typename T, int R>
__device__ void transform_quant_rows(const T* __restrict__ x, int m, int d,
                                const float* __restrict__ blocks, int bk,
                                const float* __restrict__ sign,
                                const float* __restrict__ ha, int a,
                                const float* __restrict__ hb, int b,
                                int act_bits, float* y, float* z, int* mm,
                                int8_t* codes, size_t ldq, int kz, float* sx,
                                float* zx) {
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int chunks = (d + kThreads - 1) / kThreads;
  const int items = (m + R - 1) / R * chunks;
  __shared__ float s_wmin[kWarps * R], s_wmax[kWarps * R];
  // item `it`: rows r0 .. r0 + R - 1 (row r0 + k at row[k]), value e
  auto rows_of = [&](int it, int* row, int* e) {
    const int g = it / chunks, r0 = g * R;
    *e = (it - g * chunks) * kThreads + tid;
#pragma unroll
    for (int k = 0; k < R; ++k) row[k] = r0 + k < m ? r0 + k : r0;
    return r0;
  };
  // 1. block-CAT over the block's row, then * sign
  if (blockIdx.x == 0)
    for (int r = tid; r < m; r += kThreads) {
      mm[2 * r] = ord(INFINITY);
      mm[2 * r + 1] = ord(-INFINITY);
    }
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    int row[R], e;
    const int r0 = rows_of(it, row, &e);
    if (e >= d) continue;
    float acc[R];
    if (blocks != nullptr) {
      const int lb = (e / bk) * bk;
      const float* brow = blocks + (size_t)e * bk;
#pragma unroll
      for (int k = 0; k < R; ++k) acc[k] = 0.f;
#pragma unroll 4
      for (int j = 0; j < bk; ++j) {
        const float w = __ldg(brow + j);
#pragma unroll
        for (int k = 0; k < R; ++k)
          acc[k] = fmaf(tq::to_f32(x[(size_t)row[k] * d + lb + j]), w,
                        acc[k]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < R; ++k)
        acc[k] = tq::to_f32(x[(size_t)row[k] * d + e]);
    }
    const float sg = sign != nullptr ? __ldg(sign + e) : 1.f;
#pragma unroll
    for (int k = 0; k < R; ++k)
      if (r0 + k < m) y[(size_t)(r0 + k) * d + e] = acc[k] * sg;
  }
  grid.sync();
  // 2. Z = Y Hb^T: z[r][i][l] over j
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    int row[R], e;
    const int r0 = rows_of(it, row, &e);
    if (e >= d) continue;
    const int i = e / b, l = e - i * b;
    const float* hrow = hb + (size_t)l * b;
    float acc[R];
#pragma unroll
    for (int k = 0; k < R; ++k) acc[k] = 0.f;
#pragma unroll 4
    for (int j = 0; j < b; ++j) {
      const float w = __ldg(hrow + j);
#pragma unroll
      for (int k = 0; k < R; ++k)
        acc[k] = fmaf(__ldcg(y + (size_t)row[k] * d + (size_t)i * b + j),
                      w, acc[k]);
    }
#pragma unroll
    for (int k = 0; k < R; ++k)
      if (r0 + k < m) z[(size_t)(r0 + k) * d + e] = acc[k];
  }
  grid.sync();
  // 3. Ha Z: out[r][p][l] over i, into y; the item's range of each row
  //    into the row's
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    int row[R], e;
    const int r0 = rows_of(it, row, &e);
    float mn[R], mx[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      mn[k] = INFINITY;
      mx[k] = -INFINITY;
    }
    if (e < d) {
      const int p = e / b, l = e - p * b;
      const float* hrow = ha + (size_t)p * a;
      float acc[R];
#pragma unroll
      for (int k = 0; k < R; ++k) acc[k] = 0.f;
#pragma unroll 4
      for (int i = 0; i < a; ++i) {
        const float w = __ldg(hrow + i);
#pragma unroll
        for (int k = 0; k < R; ++k)
          acc[k] = fmaf(__ldcg(z + (size_t)row[k] * d + (size_t)i * b + l),
                        w, acc[k]);
      }
#pragma unroll
      for (int k = 0; k < R; ++k)
        if (r0 + k < m) {
          y[(size_t)(r0 + k) * d + e] = acc[k];
          mn[k] = mx[k] = acc[k];
        }
    }
#pragma unroll
    for (int k = 0; k < R; ++k) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        mn[k] = fminf(mn[k], __shfl_xor_sync(0xffffffffu, mn[k], off));
        mx[k] = fmaxf(mx[k], __shfl_xor_sync(0xffffffffu, mx[k], off));
      }
      if (lane == 0) {
        s_wmin[warp * R + k] = mn[k];
        s_wmax[warp * R + k] = mx[k];
      }
    }
    __syncthreads();
    if (tid < R && r0 + tid < m) {
      float lo = INFINITY, hi = -INFINITY;
      for (int w = 0; w < kWarps; ++w) {
        lo = fminf(lo, s_wmin[w * R + tid]);
        hi = fmaxf(hi, s_wmax[w * R + tid]);
      }
      atomicMin(mm + 2 * (r0 + tid), ord(lo));
      atomicMax(mm + 2 * (r0 + tid) + 1, ord(hi));
    }
    __syncthreads();
  }
  grid.sync();
  // 4. the codes (zero from d to kz), each row's parameters beside them
  const int kchunks = (kz + kThreads - 1) / kThreads;
  for (int it = blockIdx.x; it < m * kchunks; it += gridDim.x) {
    const int r = it / kchunks, k = (it - r * kchunks) * kThreads + tid;
    float scale, zp, zxr;
    row_params(mm, r, act_bits, &scale, &zp, &zxr);
    if (k < kz)
      codes[(size_t)r * ldq + k] =
          k < d ? tq::asym_code(__ldcg(y + (size_t)r * d + k), scale, zp,
                                act_bits)
                : (int8_t)0;
    if (sx != nullptr && k == 0) {
      sx[r] = scale;
      zx[r] = zxr;
    }
  }
  grid.sync();
}

// transform_quant_rows with one row per work item where the items of
// single rows give each CTA at most two (decode rows at a narrow D), else
// eight (a deep D, or the tiled stage's many rows).
template <typename T>
__device__ void transform_quant(const T* __restrict__ x, int m, int d,
                                const float* __restrict__ blocks, int bk,
                                const float* __restrict__ sign,
                                const float* __restrict__ ha, int a,
                                const float* __restrict__ hb, int b,
                                int act_bits, float* y, float* z, int* mm,
                                int8_t* codes, size_t ldq, int kz, float* sx,
                                float* zx) {
  const int chunks = (d + kThreads - 1) / kThreads;
  if (m * chunks <= 2 * (int)gridDim.x)
    transform_quant_rows<T, 1>(x, m, d, blocks, bk, sign, ha, a, hb, b,
                               act_bits, y, z, mm, codes, ldq, kz, sx, zx);
  else
    transform_quant_rows<T, 8>(x, m, d, blocks, bk, sign, ha, a, hb, b,
                               act_bits, y, z, mm, codes, ldq, kz, sx, zx);
}

// Issue the loads of K tile `t` (kt K from k0 = t * kt) into ring stage
// `stage`: the m rows of kt codes (ldq a multiple of kt, 16-byte pieces
// through L2) and the weight rows of columns [n0, n0 + cols) (rows of kt /
// unit weight rows from k0 / unit; rows past the weight's `w_rows` are
// zeros, stored now), one commit group.
__device__ inline void load_tile(const int8_t* codes, size_t ldq, int m,
                                 int t, int kt, const int8_t* __restrict__ w,
                                 int n, int w_rows, int unit, int n0,
                                 int cols, int vw, int8_t* s_q, int8_t* s_w,
                                 int pitch) {
  const int k0 = t * kt, per_row = kt / 16;
  for (int e = threadIdx.x; e < m * per_row; e += kThreads) {
    const int r = e / per_row, c = (e - r * per_row) * 16;
    cp_async_cg16(s_q + (size_t)r * kt + c, codes + (size_t)r * ldq + k0 + c);
  }
  const int row0 = k0 / unit, rows = kt / unit;
  const int valid = max(0, min(rows, w_rows - row0));
  ctq::stage_weights(s_w, pitch, w + (size_t)row0 * n, n, valid, valid, 1,
                     1, n0, cols, vw);   // commits the group
  ctq::zero_weight_rows(s_w, pitch, valid, rows);
}

// The exact int32 contraction of the m rows of codes (scratch, row stride
// ldq = a whole number of kt tiles) against weight columns [n0, n0 +
// cols), K streamed through the two-stage ring of layout `lay`. Ends with
// tot[r * cols + j] and tot[m * cols + j] (the column sums) complete,
// visible to the block. Called by every thread of a CTA.
template <bool PACKED>
__device__ void contract_stream(const int8_t* codes, size_t ldq, int m,
                                int kt, const int8_t* __restrict__ w, int n,
                                int d, int n0, int cols, int vw,
                                const ctq::WideLayout& lay, char* smem) {
  const int unit = PACKED ? 2 : 1;
  const int w_rows = (d + unit - 1) / unit, tiles = (int)(ldq / kt);
  int8_t* s_q[2] = {reinterpret_cast<int8_t*>(smem + lay.q0),
                    reinterpret_cast<int8_t*>(smem + lay.q1)};
  int8_t* s_w[2] = {reinterpret_cast<int8_t*>(smem + lay.w0),
                    reinterpret_cast<int8_t*>(smem + lay.w1)};
  int* s_part = reinterpret_cast<int*>(smem + lay.part);
  int* s_pcs = s_part + lay.slices * m * cols;
  int* s_tot = reinterpret_cast<int*>(smem + lay.tot);
  for (int t = threadIdx.x; t < (m + 1) * cols; t += kThreads) s_tot[t] = 0;
  load_tile(codes, ldq, m, 0, kt, w, n, w_rows, unit, n0, cols, vw, s_q[0],
            s_w[0], lay.pitch);
  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) {
      load_tile(codes, ldq, m, t + 1, kt, w, n, w_rows, unit, n0, cols, vw,
                s_q[(t + 1) & 1], s_w[(t + 1) & 1], lay.pitch);
      ctq::cp_async_wait_prior();
    } else {
      ctq::cp_async_wait_all();
    }
    __syncthreads();   // tile t staged (and the totals' zeros visible)
    ctq::contract_codes<PACKED, ctq::kMaxRows>(s_q[t & 1], kt, kt,
                                               s_w[t & 1], lay.pitch, cols,
                                               m, s_part, s_pcs);
    for (int e = threadIdx.x; e < m * cols; e += kThreads)
      s_tot[e] += s_part[e];
    for (int e = threadIdx.x; e < cols; e += kThreads)
      s_tot[m * cols + e] += s_pcs[e];
    __syncthreads();   // stage t & 1 free for tile t + 2
  }
}

// A cooperative launch of ``kernel`` on `grid` CTAs of kThreads with smem
// bytes of dynamic shared memory (opted into on its first call). -> the
// CUDA error of the launch.
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int grid, size_t smem, cudaStream_t stream,
                   Args... args) {
  cudaError_t err = ctq::opt_in(kernel);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// The scratch regions of a 256-byte aligned buffer ws.
struct Regions {
  float* y;
  float* z;
  int* mm;
  int8_t* q;
  __host__ __device__ Regions(void* ws, int m, int d, int kt) {
    const ctq::WideScratch s(m, d, kt);
    char* base = static_cast<char*>(ws);
    y = reinterpret_cast<float*>(base + s.y);
    z = reinterpret_cast<float*>(base + s.z);
    mm = reinterpret_cast<int*>(base + s.mm);
    q = reinterpret_cast<int8_t*>(base + s.q);
  }
};

// SMs of the current device: the streamed kernels' grid.
inline int device_sms() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

}  // namespace wide
