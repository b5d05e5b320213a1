// Integer contraction of activation codes against int4-packed or int8
// weight codes, with the dequant + zero-point epilogue, for Hopper
// (sm_90a):
//   out[m, n] = sx[m] * sw[n] * (acc[m, n] - zx[m] * colsum[n]),
//   acc = sum_k qx[m, k] * qw[k, n] in exact int32.
// Shared by the fused CAT linear's tiled path (fused_cat_matmul.cu, stage
// 2) and the stand-alone contractions of the composed linear
// (quant_matmul.cu) above 8 rows: the tensor-core kernel (namespace w8a8
// below: mma.sync s8 x s8 -> s32 on 64 x 64 tiles, int4-packed weights
// unpacked to s8 in shared memory on the way). At m <= 8 rows every
// contraction runs ctq::contract_codes (cluster_tq.cuh): the decode fused
// linear, the decode prologue and the code GEMV of quant_matmul.cu.
// Integer accumulation is exact over all of K, so the column sums ride
// along and the epilogue runs once (the TPU kernels add one f32 epilogue
// per K tile; the reference's oracle, like this, applies it once).
//
// qx is read with row stride ldq and its first k_valid codes; codes at
// k_valid <= k < k_pad count as 0 (odd K against a packed weight whose
// last byte has a zero high nibble). k_pad is the weight's unpacked row
// count: 2 * packed rows, or the int8 rows.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace contract {

constexpr int kGemvM = 8;   // rows served by the GEMV (quant_matmul.cu)

__device__ __forceinline__ float epilogue(float sxv, float swv, int acc,
                                          float zxv, int cs) {
  return __fmul_rn(__fmul_rn(sxv, swv),
                   __fsub_rn((float)acc, __fmul_rn(zxv, (float)cs)));
}

// Tensor-core contraction of m > 8 rows against int8 weights (W8A8) or
// int4-packed ones (W4A8): 64 x 64 output tiles, four warps of 32 x 32,
// each product an mma.sync m16n8k32 s8 x s8 -> s32 (exact). The weights
// keep the reference's (k, n) row-major layout, so each weight tile of a
// 64-deep K step (64 rows of int8, or 32 packed rows whose bytes hold K
// 2p in the low nibble and 2p + 1 in the high one) is copied raw into
// shared memory with cp.async (a four-deep ring over K) and transposed
// there in 4 x 4 byte blocks with byte permutes to the K-contiguous
// columns the B operand wants, the nibbles unpacked and sign-extended to
// s8 on the way; the column sums ride along (dp4a) on the CUDA cores.
// Where the tiles alone leave the card's SMs short, K is split across
// CTAs (w8a8_splits): each adds its exact int32 partial sums into zeroed
// scratch with atomics (integer sums do not depend on their order), and
// the last CTA of a tile (a device counter) applies the one epilogue, so
// the result is the same bitwise whatever the split.
namespace w8a8 {

constexpr int kTM = 64, kTN = 64, kTK = 64, kThreads = 128;
constexpr int kStages = 4;       // cp.async ring depth over K
constexpr int kLd = kTK + 16;    // bytes per row of the A and B^T tiles
constexpr int kLdW = kTN + 16;   // bytes per row of the raw weight tile

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Wait until at most kStages - 2 committed groups are pending.
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
}

__device__ __forceinline__ unsigned ld32(const int8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// d += a (16 x 32, row) * b (32 x 8, col), s8 x s8 -> s32, exact.
__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Copy a rows x 64-byte tile at (r0, c0) of the row-major int8 matrix src
// (rows x cols, row stride ld) into dst (row stride dst_ld), zero outside
// the matrix: 16-byte cp.async where the whole chunk lies inside and
// ``vec`` (16-byte aligned rows), else byte by byte.
__device__ __forceinline__ void load_tile(int8_t* dst, int dst_ld,
                                          const int8_t* __restrict__ src,
                                          int ld, int rows, int cols, int r0,
                                          int c0, int tile_rows, bool vec) {
  for (int i = threadIdx.x; i < tile_rows * 4; i += kThreads) {
    const int r = i >> 2, c = (i & 3) * 16;
    const int gr = r0 + r, gc = c0 + c;
    int8_t* d = dst + r * dst_ld + c;
    if (vec && gr < rows && gc + 16 <= cols) {
      cp_async16(d, src + (size_t)gr * ld + gc);
    } else {
#pragma unroll
      for (int e = 0; e < 16; ++e)
        d[e] = (gr < rows && gc + e < cols) ? src[(size_t)gr * ld + gc + e]
                                            : (int8_t)0;
    }
  }
}

// The raw weight tile w (k, n) into bt (n, k) in 4 x 4 byte blocks; each
// thread owns columns n4 * 4 .. + 3 (n4 = tid % 16) and adds their codes
// to cs[].
__device__ __forceinline__ void transpose_w(const int8_t* w, int8_t* bt,
                                            int (&cs)[4]) {
  const int n4 = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int k4 = (threadIdx.x >> 4) + 8 * i;
    const int8_t* src = w + (k4 * 4) * kLdW + n4 * 4;
    const unsigned w0 = ld32(src), w1 = ld32(src + kLdW),
                   w2 = ld32(src + 2 * kLdW), w3 = ld32(src + 3 * kLdW);
    const unsigned t0 = __byte_perm(w0, w1, 0x5140);
    const unsigned t1 = __byte_perm(w0, w1, 0x7362);
    const unsigned t2 = __byte_perm(w2, w3, 0x5140);
    const unsigned t3 = __byte_perm(w2, w3, 0x7362);
    const unsigned col[4] = {__byte_perm(t0, t2, 0x5410),
                             __byte_perm(t0, t2, 0x7632),
                             __byte_perm(t1, t3, 0x5410),
                             __byte_perm(t1, t3, 0x7632)};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      *reinterpret_cast<unsigned*>(bt + (n4 * 4 + c) * kLd + k4 * 4) = col[c];
      cs[c] = __dp4a((int)col[c], 0x01010101, cs[c]);
    }
  }
}

// Four bytes of nibbles 0..15 sign-extended to s8: (v ^ 8) - 8 per byte,
// as ((v ^ 8) + 120) ^ 128, which carries into no other byte.
__device__ __forceinline__ unsigned sext_nibbles(unsigned v) {
  return ((v ^ 0x08080808u) + 0x78787878u) ^ 0x80808080u;
}

// The raw packed tile w (32 packed rows x 64 columns) into bt (n, k) as
// s8 codes: each thread transposes packed rows k4 * 4 .. + 3 (k4 = tid /
// 16) of columns n4 * 4 .. + 3 (n4 = tid % 16) in a 4 x 4 byte block,
// then splits each column's four bytes into K 8 * k4 .. + 7 (low nibble
// first), and adds the codes to cs[].
__device__ __forceinline__ void transpose_w4(const int8_t* w, int8_t* bt,
                                             int (&cs)[4]) {
  const int n4 = threadIdx.x & 15, k4 = threadIdx.x >> 4;
  const int8_t* src = w + (k4 * 4) * kLdW + n4 * 4;
  const unsigned w0 = ld32(src), w1 = ld32(src + kLdW),
                 w2 = ld32(src + 2 * kLdW), w3 = ld32(src + 3 * kLdW);
  const unsigned t0 = __byte_perm(w0, w1, 0x5140);
  const unsigned t1 = __byte_perm(w0, w1, 0x7362);
  const unsigned t2 = __byte_perm(w2, w3, 0x5140);
  const unsigned t3 = __byte_perm(w2, w3, 0x7362);
  const unsigned col[4] = {__byte_perm(t0, t2, 0x5410),
                           __byte_perm(t0, t2, 0x7632),
                           __byte_perm(t1, t3, 0x5410),
                           __byte_perm(t1, t3, 0x7632)};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const unsigned lo = sext_nibbles(col[c] & 0x0F0F0F0Fu);
    const unsigned hi = sext_nibbles((col[c] >> 4) & 0x0F0F0F0Fu);
    uint2 k8;
    k8.x = __byte_perm(lo, hi, 0x5140);
    k8.y = __byte_perm(lo, hi, 0x7362);
    *reinterpret_cast<uint2*>(bt + (n4 * 4 + c) * kLd + k4 * 8) = k8;
    cs[c] = __dp4a((int)k8.y, 0x01010101, __dp4a((int)k8.x, 0x01010101,
                                                  cs[c]));
  }
}

// grid (ceil(n / kTN), ceil(m / kTM), splits), block kThreads. qx
// is read with row stride ldq and its first k_valid codes (zero beyond);
// qw has k_pad rows of int8 or, PACKED, k_pad / 2 packed rows. Split z
// takes K tiles [z * kt_per, min((z + 1) * kt_per, ceil(k_pad / kTK))).
// With splits > 1, ws holds zeroed int32 scratch: the (m, n) sums, the
// (ceil(m / kTM), n) column sums and one counter per output tile.
template <bool PACKED>
__global__ void __launch_bounds__(kThreads) mma_kernel(
    const int8_t* __restrict__ qx, int ldq, int k_valid,
    const float* __restrict__ sx, const float* __restrict__ zx, int m,
    int k_pad, const int8_t* __restrict__ qw, const float* __restrict__ sw,
    int n, int kt_per, bool vec_a, bool vec_w, int* __restrict__ ws,
    float* __restrict__ out) {
  constexpr int kWRows = PACKED ? kTK / 2 : kTK;   // weight rows per K tile
  __shared__ __align__(16) int8_t s_a[kStages][kTM * kLd];
  __shared__ __align__(16) int8_t s_w[kStages][kWRows * kLdW];
  __shared__ __align__(16) int8_t s_bt[kTN * kLd];
  __shared__ int s_cs[kTN];
  __shared__ int s_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int n0 = blockIdx.x * kTN, m0 = blockIdx.y * kTM;
  const int splits = gridDim.z;
  const int w_rows = PACKED ? k_pad / 2 : k_pad;
  const int kt_total = (k_pad + kTK - 1) / kTK;
  const int kt0 = blockIdx.z * kt_per;
  const int kt1 = min(kt0 + kt_per, kt_total);
  if (tid < kTN) s_cs[tid] = 0;
  int acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mi][ni][c] = 0;
  int cs[4] = {0, 0, 0, 0};

  // ring: K tile kt0 + i lives in slot i % kStages, one commit group each
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (kt0 + i < kt1) {
      load_tile(s_a[i], kLd, qx, ldq, m, k_valid, m0, (kt0 + i) * kTK, kTM,
                vec_a);
      load_tile(s_w[i], kLdW, qw, n, w_rows, n, (kt0 + i) * kWRows, n0,
                kWRows, vec_w);
    }
    cp_async_commit();
  }
  for (int kt = kt0; kt < kt1; ++kt) {
    const int i = kt - kt0, slot = i % kStages;
    cp_async_wait_ring();
    __syncthreads();   // tile i landed; every warp is done with tile i - 1
    const int ahead = kt + kStages - 1;
    if (ahead < kt1) {
      const int to = (i + kStages - 1) % kStages;
      load_tile(s_a[to], kLd, qx, ldq, m, k_valid, m0, ahead * kTK, kTM,
                vec_a);
      load_tile(s_w[to], kLdW, qw, n, w_rows, n, ahead * kWRows, n0, kWRows,
                vec_w);
    }
    cp_async_commit();
    if constexpr (PACKED) {
      transpose_w4(s_w[slot], s_bt, cs);
    } else {
      transpose_w(s_w[slot], s_bt, cs);
    }
    __syncthreads();
    const int8_t* sa = s_a[slot];
#pragma unroll
    for (int kk = 0; kk < kTK; kk += 32) {
      unsigned a[2][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int8_t* p = sa + (wm + mi * 16 + g) * kLd + kk + t * 4;
        a[mi][0] = ld32(p);
        a[mi][1] = ld32(p + 8 * kLd);
        a[mi][2] = ld32(p + 16);
        a[mi][3] = ld32(p + 8 * kLd + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* p = s_bt + (wn + ni * 8 + g) * kLd + kk + t * 4;
        b[ni][0] = ld32(p);
        b[ni][1] = ld32(p + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < 4; ++c) atomicAdd(&s_cs[(tid & 15) * 4 + c], cs[c]);
  __syncthreads();

  int* ws_cs = ws + (size_t)m * n + (size_t)blockIdx.y * n;
  if (splits > 1) {
    // split K: add this split's exact partial sums into the zeroed
    // scratch; the tile's last CTA applies the epilogue to the totals
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int row = m0 + wm + mi * 16 + g + (c >> 1) * 8;
          const int col = n0 + wn + ni * 8 + t * 2 + (c & 1);
          if (row < m && col < n)
            atomicAdd(ws + (size_t)row * n + col, acc[mi][ni][c]);
        }
    if (tid < kTN && n0 + tid < n) atomicAdd(ws_cs + n0 + tid, s_cs[tid]);
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      int* counters = ws + (size_t)m * n + (size_t)gridDim.y * n;
      s_last = atomicAdd(counters + blockIdx.y * gridDim.x + blockIdx.x,
                         1) == splits - 1;
    }
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    if (tid < kTN && n0 + tid < n) s_cs[tid] = __ldcg(ws_cs + n0 + tid);
    __syncthreads();
    for (int i = tid; i < kTM * kTN; i += kThreads) {
      const int row = m0 + i / kTN, lc = i % kTN;
      if (row >= m || n0 + lc >= n) continue;
      const size_t at = (size_t)row * n + n0 + lc;
      out[at] = epilogue(sx[row], sw[n0 + lc], __ldcg(ws + at),
                                   zx[row], s_cs[lc]);
    }
    return;
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int row = m0 + wm + mi * 16 + g + (c >> 1) * 8;
        const int lc = wn + ni * 8 + t * 2 + (c & 1);
        if (row < m && n0 + lc < n)
          out[(size_t)row * n + n0 + lc] = epilogue(
              sx[row], sw[n0 + lc], acc[mi][ni][c], zx[row], s_cs[lc]);
      }
}

}  // namespace w8a8

// K splits of the tensor-core contraction (W8A8 or W4A8: the same tiles)
// of an (m, k) x (k, n) product on a card of ``sms`` SMs: where the output tiles fill fewer than half the SMs
// and K is deep (16 or more K tiles), enough splits to fill them once,
// each of at least one K tile; else 1 (a split costs a zeroed scratch and
// atomics, which a shallow K does not repay).
inline int w8a8_splits(int m, int k, int n, int sms) {
  constexpr int tm = w8a8::kTM, tn = w8a8::kTN, tk = w8a8::kTK;
  if (m <= kGemvM) return 1;
  const int tiles = ((m + tm - 1) / tm) * ((n + tn - 1) / tn);
  const int k_tiles = (k + tk - 1) / tk;
  if (tiles >= sms / 2 || k_tiles < 16) return 1;
  const int fill = (sms + tiles - 1) / tiles;
  const int want = fill < k_tiles ? fill : k_tiles;
  const int per = (k_tiles + want - 1) / want;
  return (k_tiles + per - 1) / per;
}

// Zeroed int32 scratch that ``splits`` K splits need: the (m, n) sums, the
// (ceil(m / 64), n) column sums and one counter per output tile; 0 for 1.
inline long long w8a8_scratch(int m, int n, int splits) {
  if (splits <= 1) return 0;
  const long long m_tiles = (m + w8a8::kTM - 1) / w8a8::kTM;
  const long long n_tiles = (n + w8a8::kTN - 1) / w8a8::kTN;
  return (long long)m * n + m_tiles * (n + n_tiles);
}

// Launch the tensor-core contraction (m > kGemvM) of qx (row stride ldq,
// first k_valid codes) against k_pad rows of int8 weights or, with
// ``packed``, k_pad / 2 packed rows, with ``splits`` K splits (from
// w8a8_splits; above 1, ws holds w8a8_scratch(m, n, splits) zeroed
// int32). Returns cudaGetLastError().
inline cudaError_t launch_mma(const void* qx, int ldq, int k_valid,
                              const void* sx, const void* zx, int m,
                              int k_pad, const void* qw, int packed,
                              const void* sw, int n, int splits, void* ws,
                              void* out, cudaStream_t stream) {
  constexpr int tm = w8a8::kTM, tn = w8a8::kTN, tk = w8a8::kTK;
  const int kt_total = (k_pad + tk - 1) / tk;
  const int kt_per = (kt_total + splits - 1) / splits;
  const bool vec_a =
      ldq % 16 == 0 && reinterpret_cast<uintptr_t>(qx) % 16 == 0;
  const bool vec_w =
      n % 16 == 0 && reinterpret_cast<uintptr_t>(qw) % 16 == 0;
  dim3 grid((n + tn - 1) / tn, (m + tm - 1) / tm, splits);
  auto q = static_cast<const int8_t*>(qx);
  auto s = static_cast<const float*>(sx);
  auto z = static_cast<const float*>(zx);
  auto w = static_cast<const int8_t*>(qw);
  auto sc = static_cast<const float*>(sw);
  auto o = static_cast<float*>(out);
  auto scratch = static_cast<int*>(ws);
  if (packed) {
    w8a8::mma_kernel<true><<<grid, w8a8::kThreads, 0, stream>>>(
        q, ldq, k_valid, s, z, m, k_pad, w, sc, n, kt_per, vec_a, vec_w,
        scratch, o);
  } else {
    w8a8::mma_kernel<false><<<grid, w8a8::kThreads, 0, stream>>>(
        q, ldq, k_valid, s, z, m, k_pad, w, sc, n, kt_per, vec_a, vec_w,
        scratch, o);
  }
  return cudaGetLastError();
}

}  // namespace contract
