// Launch plans and shared-memory layouts of the thread-block cluster
// kernels (cluster_tq.cuh): the one-launch decode fused CAT linear and the
// tiled fused linear's transform-quant stage (fused_cat_matmul.cu), and
// the decode QKV prologue (decode_layer.cu); and of the code GEMV built on
// the same contraction (quant_matmul.cu, code_gemv_plan).
//
// This header is the one owner of which shapes the cluster transform
// takes (splits: the vector path; general: every other width the
// reference's kernels take, on a cluster of one CTA), of every
// shared-memory region's offset and of the plans (cluster size, clusters,
// columns or rows per cluster). It is plain C++
// apart from the __host__ __device__ marks, so the kernels, their C
// entries and a host C++ build (the CPU tests) compile the same rules;
// Python reads the plans through ctq_gemv_plan, ctq_tiled_plan and
// ctq_prologue_plan, exported by the CUDA libraries.
#pragma once

#include <stddef.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define CTQ_HD __host__ __device__
#else
#define CTQ_HD
#endif

namespace ctq {

constexpr int kThreads = 256;      // threads per CTA of both cluster kernels
constexpr int kMaxRows = 8;        // decode rows per launch
constexpr int kMaxCluster = 8;     // portable cluster size
constexpr int kStaticSmem = 4096;  // bound on the kernels' static shared memory
constexpr int kMinCols = 16;       // fewest output columns per CTA of a plan

CTQ_HD inline size_t align16(size_t v) {
  return (v + 15) & ~static_cast<size_t>(15);
}

// Whether the transform of d = a * b values splits over a cluster of c:
// a / c rows and b / c columns of the (a, b) view each (b / c even: whole
// packed weight bytes), a slice of L = d / c values that is a multiple of
// 32 (a warp's lanes share their rows) and of the CAT block bk (0: none);
// a, b and bk multiples of 4 (16-byte rows of f32).
CTQ_HD inline bool splits(int d, int a, int b, int bk, int c) {
  if (c < 1 || c > kMaxCluster || a < 1 || b < 1 || a * b != d || a % c
      || b % c || (b / c) % 2 || a % 4 || b % 4 || bk < 0 || bk % 4)
    return false;
  const int L = d / c;
  return L % 32 == 0 && (bk == 0 || L % bk == 0);
}

// Whether the general path takes d = a * b with CAT block bk (0: none):
// any factors and any block that divides d, as the reference's kernels
// (a * b == d, nblk * bk == d); odd d included. It runs the widths that
// splits() refuses for every c, on a cluster of one CTA, each transform
// output one scalar fmaf chain (cluster_tq.cuh, transform_quant_any).
CTQ_HD inline bool general(int d, int a, int b, int bk) {
  return a >= 1 && b >= 1 && a * b == d && bk >= 0
         && (bk == 0 || d % bk == 0);
}

// The K the contraction runs over for d transform values: d rounded up to
// a whole dp4a group of four (codes and weight rows past d read 0); the
// table of codes has rows of align16(d) bytes. Both equal d on the vector
// path (d a multiple of 32).
CTQ_HD inline int k_groups(int d) { return (d + 3) & ~3; }

// Byte offsets of the transform's regions in dynamic shared memory, for
// m rows of d, cluster size c, factors a x b, CAT block bk (0: none);
// with all_codes the table of every CTA's codes (the decode kernels';
// on the general path, `general`, rows of align16(d) codes), else none
// (the tiled stage stores each CTA's own codes).
struct TqLayout {
  size_t x, sg, blk, hb, ha, y, zt, mm, q, qall, end;
  CTQ_HD TqLayout(int m, int d, int c, int a, int b, int bk,
                  bool all_codes = true, bool general = false) {
    const size_t L = d / c;
    size_t o = 0;
    x = o;    o += align16(4 * m * L);          // x slice, f32
    sg = o;   o += align16(4 * L);              // sign slice
    blk = o;  o += bk ? align16(4 * L * bk) : 0;   // block rows
    hb = o;   o += align16(4 * (size_t)b * b);
    ha = o;   o += align16(4 * (size_t)a * a);
    y = o;    o += align16(4 * m * L);          // block-CAT, then output
    zt = o;   o += align16(4 * m * L);          // Z of its columns (pushed)
    mm = o;   o += align16(4 * kMaxCluster * 2 * kMaxRows);   // (pushed)
    q = o;    o += align16(m * L);              // its codes, local order
    qall = o;
    o += all_codes ? align16((size_t)m * (general ? align16(d) : d)) : 0;
    end = o;
  }
};

// The transform's, then the contraction's regions of a CTA that owns
// `cols` output columns: the weight rows of its columns (d K; k_groups(d)
// on the general path; row pitch cols rounded up to 16 bytes), the int32
// partial sums of kThreads / cols K
// slices (m rows and the column sums), its columns' weight scales, and
// with `outs` its (m, cols) f32 outputs (the prologue's head).
struct CtaLayout {
  TqLayout tq;
  int pitch, slices;
  size_t w, part, out, sw, end;
  CTQ_HD CtaLayout(int m, int d, int c, int a, int b, int bk, int packed,
                   int cols, bool outs, bool general = false)
      : tq(m, d, c, a, b, bk, true, general) {
    pitch = (int)align16(cols);
    slices = kThreads / cols;
    w = tq.end;
    const int k = general ? k_groups(d) : d;
    part = w + align16((size_t)(packed ? k / 2 : k) * pitch);
    out = part + align16(4 * (size_t)slices * (m + 1) * cols);
    sw = out + (outs ? align16(4 * (size_t)m * cols) : 0);
    end = sw + align16(4 * (size_t)cols);
  }
};

// A launch plan: `clusters` clusters of `cluster` CTAs, `cols` output
// columns per CTA (the tiled plan: rows per cluster), `smem` bytes of
// dynamic shared memory per CTA. `path` 0 is the cluster path; 1 the
// streamed path (wide_tq.cuh), which takes every width the general path
// takes and the cluster path's shared memory does not hold: one
// cooperative launch of one CTA per SM, `clusters` the column tiles (the
// prologue's heads; the tiled stage: one group of all m rows) of `cols`
// columns, the K dimension streamed through shared memory in tiles of
// `ktile` K, its intermediates in a device scratch buffer (wide_scratch).
struct Plan {
  int cluster, clusters, cols, smem, path = 0, ktile = 0;
};

// The largest cluster (8, 4, 2, 1) the transform splits over that divides
// `groups` (0: any); else 1 for a width the general path takes; else 0.
// A plan of cluster c runs the vector path where splits(d, a, b, bk, c),
// the general path otherwise.
CTQ_HD inline int cluster_size(int d, int a, int b, int bk, int groups) {
  for (int c = kMaxCluster; c >= 1; c /= 2)
    if (splits(d, a, b, bk, c) && (groups <= 0 || groups % c == 0)) return c;
  return general(d, a, b, bk) ? 1 : 0;
}

// ---------------------------------------------------- the streamed path

constexpr int kWideMaxTile = 2048;   // most K per streamed tile
constexpr int kWideMinTile = 64;     // fewest

// The streamed contraction's shared memory for m rows, tiles of kt K and
// `cols` columns per tile: two stages of (m rows of kt codes, the tile's
// weight rows: kt / 2 packed rows, else kt, row pitch cols rounded up to
// 16 bytes), contract_codes' partial sums of kThreads / cols K slices,
// the int32 totals over the tiles (m rows and the column sums), the
// columns' weight scales and with `outs` the (m, cols) f32 outputs (the
// prologue's head).
struct WideLayout {
  int pitch, slices;
  size_t q0, q1, w0, w1, part, tot, sw, out, end;
  CTQ_HD WideLayout(int m, int kt, int packed, int cols, bool outs) {
    pitch = (int)align16(cols);
    slices = kThreads / cols;
    const size_t qb = align16((size_t)m * kt);
    const size_t wb = align16((size_t)(packed ? kt / 2 : kt) * pitch);
    q0 = 0;
    q1 = q0 + qb;
    w0 = q1 + qb;
    w1 = w0 + wb;
    part = w1 + wb;
    tot = part + align16(4 * (size_t)slices * (m + 1) * cols);
    sw = tot + align16(4 * (size_t)(m + 1) * cols);
    out = sw + align16(4 * (size_t)cols);
    end = out + (outs ? align16(4 * (size_t)m * cols) : 0);
  }
};

// The streamed path's device scratch for m rows of d (bytes from a
// 256-byte aligned base): the transform's two f32 planes y and z (m x d
// each), each row's range as two ordered ints, and with kt > 0 the codes
// (m rows of wide_ldq(d, kt) bytes, zero past d).
CTQ_HD inline size_t wide_ldq(int d, int kt) {
  return kt > 0 ? (size_t)((k_groups(d) + kt - 1) / kt) * kt : 0;
}
struct WideScratch {
  size_t y, z, mm, q, end;
  CTQ_HD WideScratch(int m, int d, int kt) {
    const size_t plane = align16(4 * (size_t)m * d);
    y = 0;
    z = y + plane;
    mm = z + plane;
    q = mm + align16(8 * (size_t)m);
    end = q + (size_t)m * wide_ldq(d, kt);
  }
};

// The largest tile (kWideMaxTile down to kWideMinTile, halving) whose
// layout fits beside kStaticSmem, so the most weight bytes are in flight
// per CTA; 0 if none does.
CTQ_HD inline int wide_tile(int m, int packed, int cols, bool outs,
                            int smem_optin, size_t* smem) {
  for (int kt = kWideMaxTile; kt >= kWideMinTile; kt /= 2) {
    const WideLayout lay(m, kt, packed, cols, outs);
    if (lay.end + kStaticSmem <= (size_t)smem_optin) {
      *smem = lay.end;
      return kt;
    }
  }
  return 0;
}

// The streamed decode linear's plan: `cols` columns per tile (a multiple
// of 4 in [4, kThreads]), or 0 for the plan's own: of 64 and 32, the one
// that gives the busiest of `sms` CTAs the fewest columns (ceil(tiles /
// sms) * cols; 64 on a tie), 32-byte weight rows at least.
CTQ_HD inline bool wide_gemv_plan(int m, int d, int n, int a, int b, int bk,
                                  int packed, int sms, int smem_optin,
                                  int cols, Plan* p) {
  if (!general(d, a, b, bk)) return false;
  if (cols == 0) {
    int best = 0;
    for (int c = 64; c >= 32; c /= 2) {
      const int tiles = (n + c - 1) / c;
      const int load = (tiles + sms - 1) / sms * c;
      if (best == 0 || load < best) {
        best = load;
        cols = c;
      }
    }
  }
  if (cols < 4 || cols > kThreads || cols % 4) return false;
  size_t smem = 0;
  const int kt = wide_tile(m, packed, cols, false, smem_optin, &smem);
  if (kt == 0) return false;
  *p = Plan{1, (n + cols - 1) / cols, cols, (int)smem, 1, kt};
  return true;
}

// The decode fused linear's plan for m rows of d = a * b against n
// columns on a card of `sms` SMs whose CTAs may opt into `smem_optin`
// bytes of shared memory: the largest cluster the transform splits over,
// and `cols` output columns per CTA (a multiple of 4 in [4, kThreads]),
// or 0 for the plan's own: the fewest, at least kMinCols and a multiple
// of 16, that need at most one CTA per SM. Each cluster repeats the
// transform, so a narrow N takes fewer clusters. -> false for a shape the
// kernel does not take.
CTQ_HD inline bool gemv_plan(int m, int d, int n, int a, int b, int bk,
                             int packed, int sms, int smem_optin, int cols,
                             Plan* p) {
  if (m < 1 || m > kMaxRows || n < 1 || sms < 1) return false;
  const int c = cluster_size(d, a, b, bk, 0);
  if (c == 0) return false;
  const int forced = cols;
  if (cols == 0) {
    const int ctas = c * (sms / c > 0 ? sms / c : 1);
    const int need = (int)align16((n + ctas - 1) / ctas);
    cols = need < kMinCols ? kMinCols : need > kThreads ? kThreads : need;
  }
  if (cols < 4 || cols > kThreads || cols % 4) return false;
  const CtaLayout lay(m, d, c, a, b, bk, packed, cols, false,
                      !splits(d, a, b, bk, c));
  if (lay.end + kStaticSmem > (size_t)smem_optin)   // the streamed path
    return wide_gemv_plan(m, d, n, a, b, bk, packed, sms, smem_optin,
                          forced, p);
  *p = Plan{c, (n + c * cols - 1) / (c * cols), cols, (int)lay.end};
  return true;
}

// The tiled fused linear's transform-quant plan for m > 0 rows of d = a *
// b: clusters of the largest size the transform splits over, each
// transforming `rows` consecutive rows (1..kMaxRows; 0: kMaxRows, so each
// factor element a CTA reads serves eight rows), ceil(m / rows) clusters.
// `cols` carries the rows per cluster. Where that does not fit in shared
// memory, the streamed path with `rows` 0: one group of all m rows,
// transformed by one CTA per SM through the device scratch (no dynamic
// shared memory). -> false for a shape the kernel does not take.
CTQ_HD inline bool tiled_plan(int m, int d, int a, int b, int bk,
                              int smem_optin, int rows, Plan* p) {
  const int forced = rows;
  if (rows == 0) rows = kMaxRows;
  if (m < 1 || rows < 1 || rows > kMaxRows) return false;
  const int c = cluster_size(d, a, b, bk, 0);
  if (c == 0) return false;
  const TqLayout lay(rows, d, c, a, b, bk, false);
  if (lay.end + kStaticSmem > (size_t)smem_optin) {
    if (forced != 0 || kStaticSmem > smem_optin) return false;
    *p = Plan{1, 1, m, 0, 1, 0};   // the streamed path
    return true;
  }
  *p = Plan{c, (m + rows - 1) / rows, rows, (int)lay.end};
  return true;
}

// The prologue's plan for m rows of d = a * b against n = heads * hd QKV
// columns: one CTA per head (cols = hd, a multiple of 4), in clusters of
// the largest size the transform splits over that divides the heads.
// Where that does not fit in shared memory, the streamed path: one head
// per tile (`clusters` tiles of hd columns).
CTQ_HD inline bool prologue_plan(int m, int d, int n, int hd, int a, int b,
                                 int bk, int packed, int smem_optin,
                                 Plan* p) {
  if (m < 1 || m > kMaxRows || hd < 4 || hd > kThreads || hd % 4
      || n % hd)
    return false;
  const int heads = n / hd, c = cluster_size(d, a, b, bk, heads);
  if (c == 0) return false;
  const CtaLayout lay(m, d, c, a, b, bk, packed, hd, true,
                      !splits(d, a, b, bk, c));
  if (lay.end + kStaticSmem > (size_t)smem_optin) {   // the streamed path
    size_t smem = 0;
    const int kt = wide_tile(m, packed, hd, true, smem_optin, &smem);
    if (kt == 0) return false;
    *p = Plan{1, heads, hd, (int)smem, 1, kt};
    return true;
  }
  *p = Plan{c, heads / c, hd, (int)lay.end};
  return true;
}

// The code GEMV's regions (rows of precomputed codes against a weight,
// m <= kMaxRows): the m rows of k codes (rows of align16(k) bytes, zero
// from k to k_groups(k)), the weight rows of its `cols` columns
// (k_groups(k) K: half as many packed rows; row pitch cols rounded up to
// 16 bytes), then contract_codes' int32 partial sums and column sums of
// kThreads / cols K slices.
struct GemvLayout {
  int pitch, slices;
  size_t q, w, part, end;
  CTQ_HD GemvLayout(int m, int k, int packed, int cols) {
    const int kg = k_groups(k);
    pitch = (int)align16(cols);
    slices = kThreads / cols;
    q = 0;
    w = align16((size_t)m * align16(k));
    part = w + align16((size_t)(packed ? kg / 2 : kg) * pitch);
    end = part + align16(4 * (size_t)slices * (m + 1) * cols);
  }
};

// The code GEMV's plan for m rows of k codes against n columns on a card
// of `sms` SMs: one CTA (cluster 1) per `cols` output columns, each
// contracting all of K for them; `cols` a multiple of 4 in [4, kThreads],
// or 0 for the plan's own: the most of 64, 32, 16, 8 that still give
// every SM a CTA (ceil(n / cols) >= sms), else 4, so the weight stream
// spreads over the whole card, halved while the CTA's K x cols weight
// tile does not fit in shared memory (a deep K). -> false for a shape the
// kernel does not take (m outside 1..kMaxRows, or more shared memory than
// a CTA gets even at 4 columns, whose rows take 16 bytes as 16 columns'
// do: K above about 9,100 int8 or 13,700 packed at m 8).
CTQ_HD inline bool code_gemv_plan(int m, int k, int n, int packed, int sms,
                                  int smem_optin, int cols, Plan* p) {
  if (m < 1 || m > kMaxRows || k < 1 || n < 1 || sms < 1) return false;
  if (cols == 0) {
    cols = 4;
    for (int c = 64; c > 4; c /= 2)
      if ((n + c - 1) / c >= sms) {
        cols = c;
        break;
      }
    while (cols > 4 && GemvLayout(m, k, packed, cols).end + kStaticSmem
                           > (size_t)smem_optin)
      cols /= 2;
  }
  if (cols < 4 || cols > kThreads || cols % 4) return false;
  const GemvLayout lay(m, k, packed, cols);
  if (lay.end + kStaticSmem > (size_t)smem_optin) return false;
  p->cluster = 1;
  p->clusters = (n + cols - 1) / cols;
  p->cols = cols;
  p->smem = (int)lay.end;
  return true;
}

#ifdef __CUDACC__
// Shared memory a CTA of the current device may opt into, once per device.
inline int device_smem_optin() {
  static int cache[16];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < 0 || dev >= 16) return 0;
  if (cache[dev] == 0)
    cudaDeviceGetAttribute(&cache[dev],
                           cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return cache[dev];
}
#endif

}  // namespace ctq

// The plans, for Python (kernels/fused_cat_matmul.gemv_plan and
// tiled_plan, kernels/decode_layer.prologue_plan,
// kernels/quant_matmul.gemv_plan): out = {cluster,
// clusters, cols (tiled: rows per cluster), smem, path, ktile}.
// smem_optin 0 reads the current device's (CUDA builds only). Return 0,
// or 1 for a shape the kernel does not take.
namespace ctq {
inline void write_plan(const Plan& p, int* out) {
  out[0] = p.cluster;
  out[1] = p.clusters;
  out[2] = p.cols;
  out[3] = p.smem;
  out[4] = p.path;
  out[5] = p.ktile;
}
}  // namespace ctq

extern "C" int ctq_gemv_plan(int m, int d, int n, int a, int b, int bk,
                             int packed, int sms, int smem_optin, int cols,
                             int* out) {
#ifdef __CUDACC__
  if (smem_optin == 0) smem_optin = ctq::device_smem_optin();
#endif
  ctq::Plan p;
  if (!ctq::gemv_plan(m, d, n, a, b, bk, packed, sms, smem_optin, cols, &p))
    return 1;
  ctq::write_plan(p, out);
  return 0;
}

extern "C" int ctq_tiled_plan(int m, int d, int a, int b, int bk,
                              int smem_optin, int rows, int* out) {
#ifdef __CUDACC__
  if (smem_optin == 0) smem_optin = ctq::device_smem_optin();
#endif
  ctq::Plan p;
  if (!ctq::tiled_plan(m, d, a, b, bk, smem_optin, rows, &p)) return 1;
  ctq::write_plan(p, out);
  return 0;
}

extern "C" int ctq_prologue_plan(int m, int d, int n, int hd, int a, int b,
                                 int bk, int packed, int smem_optin,
                                 int* out) {
#ifdef __CUDACC__
  if (smem_optin == 0) smem_optin = ctq::device_smem_optin();
#endif
  ctq::Plan p;
  if (!ctq::prologue_plan(m, d, n, hd, a, b, bk, packed, smem_optin, &p))
    return 1;
  ctq::write_plan(p, out);
  return 0;
}

extern "C" int ctq_code_gemv_plan(int m, int k, int n, int packed, int sms,
                                  int smem_optin, int cols, int* out) {
#ifdef __CUDACC__
  if (smem_optin == 0) smem_optin = ctq::device_smem_optin();
#endif
  ctq::Plan p;
  if (!ctq::code_gemv_plan(m, k, n, packed, sms, smem_optin, cols, &p))
    return 1;
  ctq::write_plan(p, out);
  return 0;
}

// The streamed path's device scratch in bytes for m rows of d and tiles
// of ktile K (0: the tiled stage, no codes), into *out. Returns 0.
extern "C" int ctq_wide_scratch(int m, int d, int ktile, long long* out) {
  *out = (long long)ctq::WideScratch(m, d, ktile).end;
  return 0;
}
