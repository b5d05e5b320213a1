// The CAT transform and dynamic per-token quant of m <= 8 rows, split
// over the CTAs of a thread-block cluster, for Hopper (sm_90a). Shared by
// the one-launch fused CAT GEMV and the tiled fused linear's
// transform-quant stage, whose clusters each take a group of up to eight
// rows (fused_cat_matmul.cu), and by the decode QKV prologue
// (decode_layer.cu).
//
// A cluster of C CTAs computes the transform once. Viewing each row's d
// values as Y (a, b), CTA `rank` owns
//   - for the block-CAT and the first Hadamard dot Z = Y Hb^T: the a / C
//     rows i of Y, i.e. the L = d / C consecutive values [rank * L, (rank
//     + 1) * L), whole CAT blocks;
//   - for the second dot Ha Z and the quant: the bl = b / C columns l in
//     [rank * bl, (rank + 1) * bl) of every row p, i.e. the L values
//     K = p * b + rank * bl + ll, its K set, kept in the local order
//     kk = p * bl + ll.
// Between the two dots each Z value goes to the one CTA that owns its
// column (distributed shared memory: a remote store, which does not stall
// the thread), so a CTA receives m x L values, not all of Z. Then:
//   1. block-CAT and sign of its rows, from its x slice and its block rows;
//   2. Z of its rows, each value pushed to its column's owner;
//   3. after a cluster barrier, Ha Z of its columns;
//   4. row min/max of its values, pushed to every CTA; after a second
//      barrier every CTA derives every row's scale and zero point with the
//      same arithmetic and quantizes its own values;
//   5. (decode kernels) its codes, copied in 16-byte pieces into every
//      CTA's table of all codes, in cluster order (CTA q's K set at [q *
//      L, (q + 1) * L)), complete after the caller's next cluster barrier;
//      the tiled stage stores each CTA's own codes to device memory
//      instead.
// The factors and the block rows are staged by 16-byte cp.async in their
// row-major layout, each row's 16-byte chunks XOR-swizzled (swz) so that
// the 16-byte reads of the eight rows a quarter-warp walks fall on
// distinct banks where the row width allows. Each transform output is
// ONE fmaf chain from 0, computed whole by one thread: the block-CAT over
// the block's row j, the first Hadamard dot over j, the second over i,
// the order of the stand-alone block-CAT and Hadamard kernels
// (block_matmul.cu, hadamard.cu) and of the plain versions'
// fma_chain.chain_dot; min/max and the quant are exact in any order. So
// the codes, scales and zero points equal the plain version's bitwise,
// whatever the rows, the cluster size or the rows per thread. Every
// exchange between CTAs is a push before a barrier, so no CTA reads a
// peer's shared memory and none has to wait for its peers before it
// exits.
//
// contract_codes then contracts the table of codes against weight rows
// staged in the same cluster order (stage_weights, 16-byte cp.async loads
// issued right after the transform's operands, so they overlap the
// transform): four K per dp4a, int4 nibbles unpacked and sign-extended in
// registers, exact int32.
//
// Widths that split over no cluster (ctq::general: any factors a * b = d,
// any CAT block dividing d, odd d) take the general path on a cluster of
// one CTA: the operands staged by 4-byte cp.async and scalar loads, each
// transform output the same in-order fmaf chain from 0, computed by one
// thread with scalar reads (stage_transform_any, transform_quant_any);
// the codes go to a table whose rows are padded with zero codes to a
// whole dp4a group, against weight rows padded with zeros
// (zero_weight_rows), so contract_codes adds no term for them.
//
// Which shapes split, where each region of shared memory lies and the
// launch plans are cluster_plan.h's.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_plan.h"
#include "contract.cuh"
#include "transform_quant.cuh"

namespace ctq {

namespace cg = cooperative_groups;

constexpr int kWarps = kThreads / 32;

// The 16-byte chunk jc of row ``row`` of a matrix with cpr chunks per row
// is stored at chunk jc ^ swz(row, cpr), which stays inside the row: the
// XOR stays below the largest power of two (at most 8) that divides cpr.
// With 8 (4), eight consecutive rows (four pairs of equal rows) read at
// one jc land on eight distinct 16-byte bank groups.
__device__ __forceinline__ int swz(int row, int cpr) {
  return cpr % 8 == 0 ? (row & 7)
         : cpr % 4 == 0 ? ((row >> 1) & 3)
         : cpr % 2 == 0 ? ((row >> 2) & 1) : 0;
}

// cp.async of N (4, 8 or 16) bytes from global src to shared dst.
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(src), "n"(N));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Wait for all of this thread's cp.async groups but the newest one.
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// Store v at ``addr`` (a shared-memory address of this CTA) in each of the
// c CTAs of the cluster: remote stores, visible after the next cluster
// barrier.
template <typename V>
__device__ __forceinline__ void push_all(cg::cluster_group& cluster, V* addr,
                                         V v, int c) {
#pragma unroll
  for (int q = 0; q < kMaxCluster; ++q)
    if (q < c) *cluster.map_shared_rank(addr, q) = v;
}

// Issue the copy of the f32 values src[i], i < count, into dst by 4-byte
// cp.async (part of the caller's next commit group).
__device__ inline void stage_f32(float* dst, const float* __restrict__ src,
                                 int count) {
  for (int i = threadIdx.x; i < count; i += kThreads)
    cp_async<4>(dst + i, src + i);
}

// Issue the copy of columns [c0, c0 + cols) of all d K rows of the weight
// (row-major int8, row stride n, n columns; packed: d / 2 rows of two K)
// into dst (row stride pitch, a multiple of 16), the rows in the cluster
// order of the codes table: CTA q's K set at local rows [q * rq, (q + 1)
// * rq), rq = L / unit, its row v from global row (v / run) * stride + q
// * run + v % run (run = bl / unit, stride = b / unit; unit = 2 K per
// packed row, else 1). Chunks of vw bytes (16, 8 or 4: vw divides cols,
// n and the weight's address; 1: byte by byte), by cp.async where a
// chunk lies inside the matrix, else byte by byte; columns past n read 0.
// One commit group; complete after cp_async_wait_all() and a barrier.
__device__ inline void stage_weights(int8_t* dst, int pitch,
                                     const int8_t* __restrict__ w, int n,
                                     int rows, int rq, int run, int stride,
                                     int c0, int cols, int vw) {
  const int chunks = (cols + vw - 1) / vw;
  for (int e = threadIdx.x; e < rows * chunks; e += kThreads) {
    const int u = e / chunks, c = (e - u * chunks) * vw;
    const int q = u / rq, v = u - q * rq;
    const int gr = (v / run) * stride + q * run + v % run;
    const int8_t* src = w + (size_t)gr * n + c0 + c;
    int8_t* d = dst + u * pitch + c;
    if (vw > 1 && c0 + c + vw <= n) {
      if (vw == 16) {
        cp_async<16>(d, src);
      } else if (vw == 8) {
        cp_async<8>(d, src);
      } else {
        cp_async<4>(d, src);
      }
    } else {
      for (int k = 0; k < vw; ++k) d[k] = c0 + c + k < n ? src[k] : 0;
    }
  }
  cp_async_commit();
}

// The chunk width stage_weights may use for `cols` columns of an n-column
// weight at address w.
inline int weight_vector(const void* w, int n, int cols) {
  for (int vw = 16; vw >= 4; vw /= 2)
    if (n % vw == 0 && cols % vw == 0
        && reinterpret_cast<uintptr_t>(w) % vw == 0)
      return vw;
  return 1;
}

// Four bf16 or f32 values at p (8- or 16-byte aligned) as f32.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
  return make_float4(__low2float(lo), __high2float(lo), __low2float(hi),
                     __high2float(hi));
}

// A rows x cols row-major f32 matrix (cols % 4 == 0) into dst by 16-byte
// cp.async, chunk jc of row r at chunk jc ^ swz(r, cols / 4).
__device__ inline void stage_swizzled(float* dst,
                                      const float* __restrict__ src,
                                      int rows, int cols) {
  const int cpr = cols / 4;
  for (int t = threadIdx.x; t < rows * cpr; t += kThreads) {
    const int r = t / cpr, jc = t - r * cpr;
    contract::w8a8::cp_async16(dst + r * cols + ((jc ^ swz(r, cpr)) << 2),
                               src + (size_t)t * 4);
  }
}

// The transform's operands of CTA ``rank`` into shared memory: its block
// rows, Hb and Ha (16-byte cp.async, swizzled) and its slice of the sign
// (one commit group, all in flight at once), and its x slice as f32
// (vector loads). Call stage_weights right after it; transform_quant
// waits for this group only.
template <typename T>
__device__ void stage_transform(const T* __restrict__ x, int m, int d,
                                int c, int rank,
                                const float* __restrict__ blocks, int bk,
                                const float* __restrict__ sign,
                                const float* __restrict__ ha, int a,
                                const float* __restrict__ hb, int b,
                                const TqLayout& lay, char* smem) {
  const int L = d / c, k0 = rank * L;
  if (blocks != nullptr)
    stage_swizzled(reinterpret_cast<float*>(smem + lay.blk),
                   blocks + (size_t)k0 * bk, L, bk);
  if (sign != nullptr)
    stage_f32(reinterpret_cast<float*>(smem + lay.sg), sign + k0, L);
  stage_swizzled(reinterpret_cast<float*>(smem + lay.hb), hb, b, b);
  stage_swizzled(reinterpret_cast<float*>(smem + lay.ha), ha, a, a);
  cp_async_commit();
  float* s_x = reinterpret_cast<float*>(smem + lay.x);
  const int l4 = L / 4;
#pragma unroll 2
  for (int t = threadIdx.x; t < m * l4; t += kThreads) {
    const int r = t / l4, i4 = t - r * l4;
    reinterpret_cast<float4*>(s_x)[t] =
        load4(x + (size_t)r * d + k0 + 4 * i4);
  }
}

// Transform and asymmetric-quantize (act_bits) the m rows over the
// cluster. Ends with every row's scale and signed-shifted zero point in
// s_sx[r], s_zx[r] and this CTA's codes in lay.q (m rows of L, local
// order), visible to the block, and with push_codes the codes also pushed
// into every CTA's table lay.qall (row stride d, cluster order), complete
// after the caller's next cluster barrier; without it no CTA touches a
// peer's shared memory after the function's last cluster barrier. Called
// by every thread of every CTA of the cluster, after stage_transform and
// the caller's next cp.async commit (stage_weights, or an empty group).
// In each step thread t owns element e = t % L of rows g, g + rg, ..., g
// + (RPT - 1) rg (g = t / L, rg = max(1, kThreads / L) row groups, RPT
// rows with rg * RPT >= m): one accumulator per row, each factor element
// read once for them all; a warp's lanes share g (L % 32 == 0). Rows past
// m compute on row 0 and are never stored.
template <int RPT>
__device__ void transform_quant_rows(int m, int d, int c, int rank,
                                     bool has_blocks, int bk,
                                     const float* __restrict__ sign, int a,
                                     int b, int act_bits,
                                     const TqLayout& lay, char* smem,
                                     float* s_sx, float* s_zx,
                                     bool push_codes) {
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, L = d / c, k0 = rank * L, bl = b / c;
  const int rg = L >= kThreads ? 1 : kThreads / L;   // row groups
  const float* s_x = reinterpret_cast<const float*>(smem + lay.x);
  const float* s_sg = reinterpret_cast<const float*>(smem + lay.sg);
  const float* s_blk = reinterpret_cast<const float*>(smem + lay.blk);
  const float* s_hb = reinterpret_cast<const float*>(smem + lay.hb);
  const float* s_ha = reinterpret_cast<const float*>(smem + lay.ha);
  float* s_y = reinterpret_cast<float*>(smem + lay.y);
  float* s_zt = reinterpret_cast<float*>(smem + lay.zt);
  float* s_mm = reinterpret_cast<float*>(smem + lay.mm);
  int8_t* s_q = reinterpret_cast<int8_t*>(smem + lay.q);
  int8_t* s_qall = reinterpret_cast<int8_t*>(smem + lay.qall);
  __shared__ float s_wmin[kWarps * kMaxRows], s_wmax[kWarps * kMaxRows];
  __shared__ float s_zp[kMaxRows];
  // every CTA of the cluster must have started before a peer stores into
  // its shared memory: arrive now, wait before the first push
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  if (tid < kWarps * kMaxRows) {
    s_wmin[tid] = INFINITY;
    s_wmax[tid] = -INFINITY;
  }
  cp_async_wait_prior();
  __syncthreads();   // staged operands visible

  // 1. block-CAT, then * sign, of rows i of this CTA: e = il * b + j
  for (int t = tid; t < rg * L; t += kThreads) {
    const int g = t / L, e = t - g * L;
    const float sg = sign != nullptr ? s_sg[e] : 1.f;
    float acc[RPT];
    if (has_blocks) {
      const float* xr[RPT];
      const int lb = (e / bk) * bk;
#pragma unroll
      for (int k = 0; k < RPT; ++k) {
        acc[k] = 0.f;
        const int r = g + rg * k;
        xr[k] = s_x + (r < m ? r : 0) * L + lb;
      }
      const float* brow = s_blk + e * bk;
      const int cpr = bk / 4, f = swz(e, cpr);
#pragma unroll 4
      for (int jc = 0; jc < cpr; ++jc) {
        const float4 w = load4(brow + ((jc ^ f) << 2));
#pragma unroll
        for (int k = 0; k < RPT; ++k) {
          const float4 v = load4(xr[k] + 4 * jc);
          acc[k] = fmaf(v.x, w.x, acc[k]);
          acc[k] = fmaf(v.y, w.y, acc[k]);
          acc[k] = fmaf(v.z, w.z, acc[k]);
          acc[k] = fmaf(v.w, w.w, acc[k]);
        }
      }
    } else {
#pragma unroll
      for (int k = 0; k < RPT; ++k) {
        const int r = g + rg * k;
        acc[k] = s_x[(r < m ? r : 0) * L + e];
      }
    }
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      const int r = g + rg * k;
      if (r < m) s_y[r * L + e] = acc[k] * sg;
    }
  }
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  // 2. Z = Y Hb^T of rows i = rank * ar + il (e = il * b + l), each value
  //    pushed to the owner of column l, at s_zt[r][i][l % bl]
  for (int t = tid; t < rg * L; t += kThreads) {
    const int g = t / L, e = t - g * L;
    const int il = e / b, l = e - il * b;
    float acc[RPT];
    const float* yr[RPT];
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      acc[k] = 0.f;
      const int r = g + rg * k;
      yr[k] = s_y + (r < m ? r : 0) * L + il * b;
    }
    const float* hrow = s_hb + l * b;
    const int cpr = b / 4, f = swz(l, cpr);
#pragma unroll 4
    for (int jc = 0; jc < cpr; ++jc) {
      const float4 w = load4(hrow + ((jc ^ f) << 2));
#pragma unroll
      for (int k = 0; k < RPT; ++k) {
        const float4 v = load4(yr[k] + 4 * jc);
        acc[k] = fmaf(v.x, w.x, acc[k]);
        acc[k] = fmaf(v.y, w.y, acc[k]);
        acc[k] = fmaf(v.z, w.z, acc[k]);
        acc[k] = fmaf(v.w, w.w, acc[k]);
      }
    }
    const int owner = l / bl;
    float* dst = cluster.map_shared_rank(s_zt, owner) + (k0 / b + il) * bl
                 + l - owner * bl;
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      const int r = g + rg * k;
      if (r < m) dst[r * L] = acc[k];
    }
  }
  cluster.sync();   // every CTA holds Z of its columns
  // 3. Ha Z of this CTA's columns: e = p * bl + ll, with each row's min
  //    and max on the way
  float lmin[RPT], lmax[RPT];
#pragma unroll
  for (int k = 0; k < RPT; ++k) { lmin[k] = INFINITY; lmax[k] = -INFINITY; }
  for (int t = tid; t < rg * L; t += kThreads) {
    const int g = t / L, e = t - g * L;
    const int p = e / bl, ll = e - p * bl;
    float acc[RPT];
    const float* zr[RPT];
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      acc[k] = 0.f;
      const int r = g + rg * k;
      zr[k] = s_zt + (r < m ? r : 0) * L + ll;
    }
    const float* hrow = s_ha + p * a;
    const int cpr = a / 4, f = swz(p, cpr);
#pragma unroll 4
    for (int ic = 0; ic < cpr; ++ic) {
      const float4 w = load4(hrow + ((ic ^ f) << 2));
      const int i = 4 * ic;
#pragma unroll
      for (int k = 0; k < RPT; ++k) {
        acc[k] = fmaf(zr[k][i * bl], w.x, acc[k]);
        acc[k] = fmaf(zr[k][(i + 1) * bl], w.y, acc[k]);
        acc[k] = fmaf(zr[k][(i + 2) * bl], w.z, acc[k]);
        acc[k] = fmaf(zr[k][(i + 3) * bl], w.w, acc[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      const int r = g + rg * k;
      if (r < m) {
        s_y[r * L + e] = acc[k];
        lmin[k] = fminf(lmin[k], acc[k]);
        lmax[k] = fmaxf(lmax[k], acc[k]);
      }
    }
  }
  // 4. row ranges: warp, then CTA, pushed to every CTA (s_mm[rank][min |
  //    max][r]), then over the cluster
  const int warp = tid >> 5, lane = tid & 31;
  if (tid < rg * L || L >= kThreads) {
    const int g = (tid % (rg * L)) / L;   // the same for the whole warp
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      const int r = g + rg * k;
      if (r >= m) break;
      float mn = lmin[k], mx = lmax[k];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, off));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      if (lane == 0) {
        s_wmin[warp * kMaxRows + r] = mn;
        s_wmax[warp * kMaxRows + r] = mx;
      }
    }
  }
  __syncthreads();
  if (tid < c * m) {   // thread (q, r) sends row r's range to CTA q
    const int q = tid / m, r = tid - q * m;
    float mn = INFINITY, mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      mn = fminf(mn, s_wmin[w * kMaxRows + r]);
      mx = fmaxf(mx, s_wmax[w * kMaxRows + r]);
    }
    float* slot = cluster.map_shared_rank(s_mm, q) + rank * 2 * kMaxRows + r;
    slot[0] = mn;
    slot[kMaxRows] = mx;
  }
  cluster.sync();   // every CTA holds every CTA's row ranges
  // every CTA: each row's range over the cluster, then its scale and zero
  // point, and the codes of this CTA's values (tq::asym_params/asym_code,
  // the arithmetic of the stand-alone quant)
  if (tid < m) {
    float ymin = INFINITY, ymax = -INFINITY;
    for (int q = 0; q < c; ++q) {
      ymin = fminf(ymin, s_mm[q * 2 * kMaxRows + tid]);
      ymax = fmaxf(ymax, s_mm[q * 2 * kMaxRows + kMaxRows + tid]);
    }
    float scale, zp;
    tq::asym_params(ymin, ymax, act_bits, &scale, &zp);
    s_sx[tid] = scale;
    s_zp[tid] = zp;
    s_zx[tid] = zp - (float)(1 << (act_bits - 1));
  }
  __syncthreads();
  for (int e = tid; e < m * L; e += kThreads) {
    const int r = e / L;
    s_q[e] = tq::asym_code(s_y[e], s_sx[r], s_zp[r], act_bits);
  }
  __syncthreads();
  if (!push_codes) return;
  // 5. the codes into every CTA's table, 16 at a time
  const int l16 = L / 16;
  for (int t = tid; t < c * m * l16; t += kThreads) {
    const int q = t / (m * l16), rem = t - q * m * l16;
    const int r = rem / l16, e16 = rem - r * l16;
    *reinterpret_cast<int4*>(cluster.map_shared_rank(
        s_qall + (size_t)r * d + k0 + 16 * e16, q)) =
        reinterpret_cast<const int4*>(s_q)[rem];
  }
}

// transform_quant_rows with the rows per thread that m rows of this
// slice width need.
__device__ inline void transform_quant(int m, int d, int c, int rank,
                                       bool has_blocks, int bk,
                                       const float* __restrict__ sign, int a,
                                       int b, int act_bits,
                                       const TqLayout& lay, char* smem,
                                       float* s_sx, float* s_zx,
                                       bool push_codes = true) {
  const int L = d / c, rg = L >= kThreads ? 1 : kThreads / L;
  const int rpt = (m + rg - 1) / rg;
#define CTQ_ROWS(R)                                                        \
  transform_quant_rows<R>(m, d, c, rank, has_blocks, bk, sign, a, b,       \
                          act_bits, lay, smem, s_sx, s_zx, push_codes)
  if (rpt <= 1) {
    CTQ_ROWS(1);
  } else if (rpt <= 2) {
    CTQ_ROWS(2);
  } else if (rpt <= 4) {
    CTQ_ROWS(4);
  } else {
    CTQ_ROWS(8);
  }
#undef CTQ_ROWS
}

// ------------------------------------------------------ the general path

// The general path's operands of the m rows into shared memory: the block
// rows, the sign, Hb and Ha whole (4-byte cp.async, one commit group) and
// x as f32 (scalar loads). Call stage_weights (or commit an empty group)
// right after it; transform_quant_any waits for all of them.
template <typename T>
__device__ void stage_transform_any(const T* __restrict__ x, int m, int d,
                                    const float* __restrict__ blocks, int bk,
                                    const float* __restrict__ sign,
                                    const float* __restrict__ ha, int a,
                                    const float* __restrict__ hb, int b,
                                    const TqLayout& lay, char* smem) {
  if (blocks != nullptr)
    stage_f32(reinterpret_cast<float*>(smem + lay.blk), blocks, d * bk);
  if (sign != nullptr)
    stage_f32(reinterpret_cast<float*>(smem + lay.sg), sign, d);
  stage_f32(reinterpret_cast<float*>(smem + lay.hb), hb, b * b);
  stage_f32(reinterpret_cast<float*>(smem + lay.ha), ha, a * a);
  cp_async_commit();
  float* s_x = reinterpret_cast<float*>(smem + lay.x);
  for (int t = threadIdx.x; t < m * d; t += kThreads)
    s_x[t] = tq::to_f32(x[t]);
}

// Zero the weight rows [from, to) of a staged tile (row pitch ``pitch``):
// the rows past the weight up to k_groups(d), against zero codes.
__device__ inline void zero_weight_rows(int8_t* s_w, int pitch, int from,
                                        int to) {
  for (int e = from * pitch + threadIdx.x; e < to * pitch; e += kThreads)
    s_w[e] = 0;
}

// Transform and asymmetric-quantize (act_bits) the m rows of any width d =
// a * b on one CTA (the general path; a cluster of one). Each output is
// the chain of transform_quant_rows in the same order (the block-CAT over
// the block's row j, Z = Y Hb^T over j, Ha Z over i, each one fmaf chain
// from 0 by one thread), so the codes, scales and zero points equal the
// plain version's bitwise as on the vector path. Ends with every row's
// scale and signed-shifted zero point in s_sx[r], s_zx[r] and its codes
// at codes[r * ldq + k] for k < kz (0 for k >= d), visible to the block
// (``codes`` may be shared or device memory). Called by every thread
// after stage_transform_any and the caller's next cp.async commit
// (stage_weights, or an empty group), which it does not wait for.
__device__ inline void transform_quant_any(int m, int d, bool has_blocks,
                                           int bk,
                                           const float* __restrict__ sign,
                                           int a, int b, int act_bits,
                                           const TqLayout& lay, char* smem,
                                           float* s_sx, float* s_zx,
                                           int8_t* codes, size_t ldq,
                                           int kz) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float* s_x = reinterpret_cast<const float*>(smem + lay.x);
  const float* s_sg = reinterpret_cast<const float*>(smem + lay.sg);
  const float* s_blk = reinterpret_cast<const float*>(smem + lay.blk);
  const float* s_hb = reinterpret_cast<const float*>(smem + lay.hb);
  const float* s_ha = reinterpret_cast<const float*>(smem + lay.ha);
  float* s_y = reinterpret_cast<float*>(smem + lay.y);
  float* s_z = reinterpret_cast<float*>(smem + lay.zt);
  __shared__ float s_zp[kMaxRows];
  cp_async_wait_prior();
  __syncthreads();   // staged operands visible
  // 1. block-CAT, then * sign: y[r][e] over the block row e
  for (int t = tid; t < m * d; t += kThreads) {
    const int r = t / d, e = t - r * d;
    float acc = s_x[t];
    if (has_blocks) {
      const float* xr = s_x + r * d + (e / bk) * bk;
      const float* brow = s_blk + (size_t)e * bk;
      acc = 0.f;
      for (int j = 0; j < bk; ++j) acc = fmaf(xr[j], brow[j], acc);
    }
    s_y[t] = acc * (sign != nullptr ? s_sg[e] : 1.f);
  }
  __syncthreads();
  // 2. Z = Y Hb^T: z[r][i][l] over j
  for (int t = tid; t < m * d; t += kThreads) {
    const int r = t / d, e = t - r * d, i = e / b, l = e - i * b;
    const float* yr = s_y + r * d + i * b;
    const float* hrow = s_hb + l * b;
    float acc = 0.f;
    for (int j = 0; j < b; ++j) acc = fmaf(yr[j], hrow[j], acc);
    s_z[t] = acc;
  }
  __syncthreads();
  // 3. Ha Z: out[r][p][l] over i
  for (int t = tid; t < m * d; t += kThreads) {
    const int r = t / d, e = t - r * d, p = e / b, l = e - p * b;
    const float* zr = s_z + r * d + l;
    const float* hrow = s_ha + p * a;
    float acc = 0.f;
    for (int i = 0; i < a; ++i) acc = fmaf(zr[i * b], hrow[i], acc);
    s_y[t] = acc;
  }
  __syncthreads();
  // 4. each row's range (a warp per row), scale and zero point
  for (int r = warp; r < m; r += kWarps) {
    float mn = INFINITY, mx = -INFINITY;
    for (int e = lane; e < d; e += 32) {
      mn = fminf(mn, s_y[r * d + e]);
      mx = fmaxf(mx, s_y[r * d + e]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, off));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    }
    if (lane == 0) {
      float scale, zp;
      tq::asym_params(mn, mx, act_bits, &scale, &zp);
      s_sx[r] = scale;
      s_zp[r] = zp;
      s_zx[r] = zp - (float)(1 << (act_bits - 1));
    }
  }
  __syncthreads();
  // 5. the codes, zero past d
  for (int t = tid; t < m * kz; t += kThreads) {
    const int r = t / kz, k = t - r * kz;
    codes[r * ldq + k] =
        k < d ? tq::asym_code(s_y[r * d + k], s_sx[r], s_zp[r], act_bits)
              : (int8_t)0;
  }
  __syncthreads();
}

// Exact int32 contraction of m rows of codes (s_q, row stride ldq bytes,
// a multiple of 16, k_len codes from k = 0, a multiple of 4) against the
// weight tile s_w (k_len rows of int8, or k_len / 2 packed rows whose
// bytes hold K 2p in the low nibble and 2p + 1 in the high one; row
// stride pitch; cols <= kThreads columns). Thread (col, s) sums slice s
// of the groups of four K (S = kThreads / cols contiguous slices, each a
// multiple of four groups) with dp4a, reading 16 codes of a row at a
// time, the column sums riding along; the S partials are then added in
// shared memory. Ends with s_part[r * cols + col] = acc, s_pcs[col] =
// colsum, visible to the block. s_part holds S * m * cols ints, s_pcs
// S * cols.
template <bool PACKED, int MAXR>
__device__ void contract_codes(const int8_t* s_q, int ldq, int k_len,
                               const int8_t* s_w, int pitch, int cols,
                               int m, int* s_part, int* s_pcs) {
  const int tid = threadIdx.x, S = kThreads / cols;
  const int groups = k_len / 4;
  const int per = ((groups + S - 1) / S + 3) & ~3;
  if (tid < S * cols) {
    const int col = tid % cols, s = tid / cols;
    const int g0 = min(s * per, groups), g1 = min(g0 + per, groups);
    int acc[MAXR];
    const int8_t* qr[MAXR];   // rows past m read row 0, never stored
#pragma unroll
    for (int r = 0; r < MAXR; ++r) {
      acc[r] = 0;
      qr[r] = s_q + (r < m ? r : 0) * ldq;
    }
    int cs = 0;
    auto w4_at = [&](int gi) -> int {
      unsigned w4;
      if (PACKED) {
        const unsigned b0 = (uint8_t)s_w[(2 * gi) * pitch + col];
        const unsigned b1 = (uint8_t)s_w[(2 * gi + 1) * pitch + col];
        const unsigned v = b0 | (b1 << 16);
        const unsigned lo = v & 0x000F000Fu, hi = (v >> 4) & 0x000F000Fu;
        w4 = contract::w8a8::sext_nibbles(lo | (hi << 8));
      } else {
        const int8_t* p = s_w + (4 * gi) * pitch + col;
        w4 = (unsigned)(uint8_t)p[0] | ((unsigned)(uint8_t)p[pitch] << 8)
             | ((unsigned)(uint8_t)p[2 * pitch] << 16)
             | ((unsigned)(uint8_t)p[3 * pitch] << 24);
      }
      return (int)w4;
    };
    int gi = g0;
    for (; gi + 4 <= g1; gi += 4) {
      int w[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        w[u] = w4_at(gi + u);
        cs = __dp4a(w[u], 0x01010101, cs);
      }
#pragma unroll
      for (int r = 0; r < MAXR; ++r) {
        const int4 q = *reinterpret_cast<const int4*>(qr[r] + 4 * gi);
        acc[r] = __dp4a(w[0], q.x, acc[r]);
        acc[r] = __dp4a(w[1], q.y, acc[r]);
        acc[r] = __dp4a(w[2], q.z, acc[r]);
        acc[r] = __dp4a(w[3], q.w, acc[r]);
      }
    }
    for (; gi < g1; ++gi) {
      const int w = w4_at(gi);
      cs = __dp4a(w, 0x01010101, cs);
#pragma unroll
      for (int r = 0; r < MAXR; ++r)
        acc[r] = __dp4a(w, *reinterpret_cast<const int*>(qr[r] + 4 * gi),
                        acc[r]);
    }
#pragma unroll
    for (int r = 0; r < MAXR; ++r)
      if (r < m) s_part[(s * m + r) * cols + col] = acc[r];
    s_pcs[s * cols + col] = cs;
  }
  __syncthreads();
  if (S > 1) {
    for (int t = tid; t < m * cols; t += kThreads) {
      int total = s_part[t];
      for (int s = 1; s < S; ++s) total += s_part[s * m * cols + t];
      s_part[t] = total;
    }
    if (tid < cols) {
      int total = s_pcs[tid];
      for (int s = 1; s < S; ++s) total += s_pcs[s * cols + tid];
      s_pcs[tid] = total;
    }
    __syncthreads();
  }
}

// Opt ``kernel`` into the card's largest dynamic shared memory, once per
// kernel (its first call, before any graph capture). -> the CUDA error.
template <typename Kernel>
cudaError_t opt_in(Kernel kernel) {
  static const void* done[32];
  static int n_done = 0;
  for (int i = 0; i < n_done; ++i)
    if (done[i] == (const void*)kernel) return cudaSuccess;
  int dev = 0, max_optin = 0;
  cudaFuncAttributes fa;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &max_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kernel);
  // the plans leave kStaticSmem bytes beside their dynamic shared memory
  if (err == cudaSuccess && fa.sharedSizeBytes > (size_t)kStaticSmem)
    err = cudaErrorInvalidConfiguration;
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               max_optin - (int)fa.sharedSizeBytes);
  if (err == cudaSuccess && n_done < 32) done[n_done++] = (const void*)kernel;
  return err;
}

// A launch of ``kernel`` on grid CTAs in clusters of c, kThreads each,
// smem bytes of dynamic shared memory; ``attr`` holds its cluster shape.
inline cudaLaunchConfig_t cluster_config(int grid, int c, size_t smem,
                                         cudaStream_t stream,
                                         cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = c;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of c resident at once for ``kernel`` with smem bytes of dynamic
// shared memory per CTA (cudaOccupancyMaxActiveClusters), or -1 on error.
template <typename Kernel>
int max_clusters(Kernel kernel, int c, size_t smem) {
  if (opt_in(kernel) != cudaSuccess) return -1;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(c, c, smem, 0, &attr);
  int clusters = -1;
  if (cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg) != cudaSuccess)
    return -1;
  return clusters;
}

// Launch ``kernel`` on grid CTAs (a multiple of c) in clusters of c. Every
// new (kernel, c, smem) is first checked to be resident: a cluster that
// cannot be fails with cudaErrorInvalidConfiguration, loudly, and runs no
// other way. -> the CUDA error of the launch.
template <typename Kernel, typename... Args>
cudaError_t launch_cluster(Kernel kernel, int grid, int c, size_t smem,
                           cudaStream_t stream, Args... args) {
  struct Seen { const void* fn; int c; size_t smem; };
  static Seen seen[64];
  static int n_seen = 0;
  if (c < 1 || c > kMaxCluster || grid % c) return cudaErrorInvalidValue;
  bool known = false;
  for (int i = 0; i < n_seen; ++i)
    known |= seen[i].fn == (const void*)kernel && seen[i].c == c
             && seen[i].smem == smem;
  if (!known) {
    const int clusters = max_clusters(kernel, c, smem);
    if (clusters < 0) return cudaErrorInvalidValue;
    if (clusters == 0) return cudaErrorInvalidConfiguration;
    if (n_seen < 64) seen[n_seen++] = {(const void*)kernel, c, smem};
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(grid, c, smem, stream, &attr);
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace ctq
