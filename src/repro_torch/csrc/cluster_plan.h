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
// takes and the cluster path's shared memory does not hold (and the code
// GEMV's deep K): one cooperative launch of `per_sm` CTAs per SM,
// `clusters` the column tiles (the prologue's heads; the tiled stage: one
// group of all m rows) of `cols` columns, each tile's K split `splits`
// ways, K streamed through a ring of `stages` stages of `ktile` K
// (stream_plan), the transform's intermediates and the splits' sums in a
// device scratch buffer (wide_scratch, stream_totals).
struct Plan {
  int cluster, clusters, cols, smem, path = 0, ktile = 0, splits = 1,
      stages = 0, per_sm = 1;
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

constexpr int kStreamCtasPerSm = 2;      // most CTAs of a streamed launch
                                         // per SM
constexpr int kStreamMaxTile = 2048;     // most K per ring stage
constexpr int kStreamMinTile = 32;       // fewest: one m16n8k32 step
constexpr int kStreamMaxStages = 16;     // deepest ring
constexpr int kStreamStageBytes = 16384; // weight bytes a stage aims at
constexpr int kStreamItemBytes = 16384;  // a work item's own cost, counted
                                         // as weight bytes, in the split
                                         // choice (its sums, its epilogue
                                         // or its partials)

// A streamed CTA's share of the shared memory a CTA may opt into, with
// `per_sm` CTAs per SM: they split the SM's memory, each less the 1 KiB
// the runtime reserves per CTA.
CTQ_HD inline int stream_smem(int smem_optin, int per_sm) {
  return per_sm == 1 ? smem_optin : (smem_optin + 1024) / per_sm - 1024;
}

// The streamed transform's shared-memory tile (wide_tq.cuh
// transform_quant) for factors a x b and CAT block bk (0: none): the
// largest of step 1's (32 block rows of bk + 1 floats and 8 rows of bk x
// values), step 2's (16 rows of Y and 16 of Hb, b + 1 floats each) and
// step 3's (16 rows of Ha of a + 1 floats, a rows of 16 Z columns).
CTQ_HD inline size_t wide_tq_bytes(int a, int b, int bk) {
  const size_t s1 = bk > 0 ? (size_t)32 * (bk + 1) + (size_t)8 * bk : 0;
  const size_t s2 = (size_t)32 * (b + 1);
  const size_t s3 = (size_t)16 * (a + 1) + (size_t)16 * a;
  const size_t s = s1 > s2 ? (s1 > s3 ? s1 : s3) : (s2 > s3 ? s2 : s3);
  return align16(4 * s);
}

// The streamed contraction (wide_tq.cuh) works on groups of 32 output
// columns: a warp's tile, two m16n8k32 products of 16 columns each.
CTQ_HD inline int stream_groups(int cols) { return (cols + 31) / 32; }

// The row pitch of a stage's weight rows (the groups' 32-byte column
// runs). Runs that fill whole 128-byte lines are not padded: their
// 16-byte pieces are XOR-swizzled instead (stream_swizzled: piece c of a
// row whose thread group t reads it sits at c ^ 2t), which puts the
// rows that one warp-wide word read of the fragments touches (rows 4t +
// i packed, 8t + i int8, t = 0..3) on distinct banks; other runs are
// padded to the least multiple of 16 that does so: 32 or 96 mod 128
// bytes (packed), 16 or 48 mod 64 (int8).
CTQ_HD inline bool stream_swizzled(int cols) {
  return stream_groups(cols) * 32 % 128 == 0;
}
CTQ_HD inline int stream_wpitch(int cols, int packed) {
  if (stream_swizzled(cols)) return stream_groups(cols) * 32;
  int p = stream_groups(cols) * 32 + 16;
  while (packed ? (p % 128 != 32 && p % 128 != 96)
                : (p % 64 != 16 && p % 64 != 48))
    p += 16;
  return p;
}

// The streamed contraction's shared memory for m rows, stages of kt K
// and tiles of `cols` columns: a ring of `stages` stages, each the
// tile's weight rows of kt K (kt / 2 packed rows, else kt; row-major,
// pitch stream_wpitch) and the m rows of kt codes (row pitch kt + 32
// bytes, so the eight rows of a fragment read fall on distinct banks);
// one mbarrier per stage; then one region that the transform's tile
// (`tq_bytes`, wide_tq_bytes; 0 for the code GEMV) and, once the
// transform is done, the contraction's ends share: the warps' partial
// sums (at most kThreads / 32 warps of m + 1 rows of 32 columns), the
// tile's int32 totals (m rows of `cols`, then the column sums), its
// weight scales and with `outs` its (m, cols) f32 outputs (the
// prologue's head).
struct StreamLayout {
  int groups, wpitch, qpitch;
  size_t wbytes, stage, bar, red, tot, sw, out, tq, end;
  CTQ_HD StreamLayout(int m, int kt, int stages, int packed, int cols,
                      bool outs, size_t tq_bytes = 0) {
    groups = stream_groups(cols);
    wpitch = stream_wpitch(cols, packed);
    qpitch = kt + 32;
    wbytes = (size_t)(packed ? kt / 2 : kt) * wpitch;
    stage = align16(wbytes + (size_t)m * qpitch);
    bar = stage * stages;
    tq = red = align16(bar + 8 * (size_t)stages);
    tot = red + align16(4 * (size_t)(kThreads / 32) * (m + 1) * 32);
    sw = tot + align16(4 * (size_t)(m + 1) * cols);
    out = sw + align16(4 * (size_t)cols);
    end = out + (outs ? align16(4 * (size_t)m * cols) : 0);
    if (tq + tq_bytes > end) end = tq + tq_bytes;
  }
};

// The ring for m rows and tiles of `cols` columns: the K per stage (a
// power of two in [kStreamMinTile, kStreamMaxTile], about
// kStreamStageBytes of the weight's bytes, no more than K needs) and the
// most stages (2..kStreamMaxStages) that fit beside kStaticSmem, the
// stage halved while two do not fit. -> false if none does.
CTQ_HD inline bool stream_ring(int m, int k, int packed, int cols,
                               bool outs, size_t tq_bytes, int smem_optin,
                               int per_sm, int* kt, int* stages,
                               size_t* smem) {
  const int bytes_k = stream_groups(cols) * 32 / (packed ? 2 : 1);
  int t = kStreamMaxTile;
  while (t > kStreamMinTile
         && (t * bytes_k > kStreamStageBytes || t / 2 >= k))
    t /= 2;
  for (; t >= kStreamMinTile; t /= 2)
    for (int s = kStreamMaxStages; s >= 2; --s) {
      const StreamLayout lay(m, t, s, packed, cols, outs, tq_bytes);
      if (lay.end + kStaticSmem <= (size_t)stream_smem(smem_optin, per_sm)) {
        *kt = t;
        *stages = s;
        *smem = lay.end;
        return true;
      }
    }
  return false;
}

// Stages of kt K that k takes (the last one padded with zero codes and
// zero weight rows).
CTQ_HD inline int stream_steps(int k, int kt) { return (k + kt - 1) / kt; }

// The stages of each K split: ceil(steps / splits), so split s takes
// stages [s * per, min((s + 1) * per, steps)), none of them empty.
CTQ_HD inline int stream_per(int steps, int splits) {
  return (steps + splits - 1) / splits;
}

// Weight bytes the busiest of `sms` CTAs streams for `tiles` tiles split
// `splits` ways (each item counted kStreamItemBytes more): the plans'
// cost.
CTQ_HD inline long long stream_cost(int tiles, int steps, int splits,
                                    int stage_bytes, int sms) {
  const long long items = (long long)tiles * splits;
  return (items + sms - 1) / sms
         * ((long long)stream_per(steps, splits) * stage_bytes
            + kStreamItemBytes);
}

// The most K one split of the streamed contraction takes for packed
// weights, whose nibbles it multiplies by 16: |16 w q| <= 2^14, so a sum
// of 2^17 such terms stays an exact int32.
constexpr int kStreamPackedSplitK = 1 << 17;

// The K splits of `tiles` tiles over `steps` stages on `sms` CTAs: of the
// counts that leave no split empty and no split more than `max_per`
// stages, the one of least cost, the fewest on a tie.
CTQ_HD inline int stream_splits(int tiles, int steps, int stage_bytes,
                                int sms, int max_per) {
  long long best = -1;
  int best_s = 1;
  for (int per = steps < max_per ? steps : max_per; per >= 1; --per) {
    const int s = (steps + per - 1) / per;
    const long long cost = stream_cost(tiles, steps, s, stage_bytes, sms);
    if (best < 0 || cost < best) {
      best = cost;
      best_s = s;
    }
  }
  return best_s;
}

// The streamed contraction's plan for m rows of k codes against n
// columns on a card of `sms` SMs (one cooperative launch of `per_sm` CTAs
// per SM, G of them: kStreamCtasPerSm where a ring fits in that share of
// shared memory, else 1): tiles of `cols` columns (a multiple of 4 in [4,
// kThreads]; 0: the plan's, of 128, 64 and 32 the one of least cost, the
// widest on a tie), each tile's K split `splits` ways, work item t *
// splits + s (tile t, split s) on CTA (t * splits + s) % G, its ring's
// stages of `ktile` K and `stages` deep, beside `tq_bytes` of the
// transform's tile. `outs`: with the prologue's (m, cols) outputs. ->
// false for a shape it does not take (m outside 1..kMaxRows, such
// columns, shared memory that holds no ring of two stages of
// kStreamMinTile K).
CTQ_HD inline bool stream_plan(int m, int k, int n, int packed, int cols,
                               bool outs, int sms, int smem_optin, Plan* p,
                               size_t tq_bytes = 0) {
  if (m < 1 || m > kMaxRows || k < 1 || n < 1 || sms < 1) return false;
  if (cols != 0 && (cols < 4 || cols > kThreads || cols % 4)) return false;
  const int cands[3] = {128, 64, 32};
  for (int per_sm = kStreamCtasPerSm; per_sm >= 1; --per_sm) {
    long long best = -1;
    for (int i = 0; i < (cols == 0 ? 3 : 1); ++i) {
      const int c = cols == 0 ? cands[i] : cols;
      int kt = 0, stages = 0;
      size_t smem = 0;
      if (!stream_ring(m, k, packed, c, outs, tq_bytes, smem_optin, per_sm,
                       &kt, &stages, &smem))
        continue;
      const int tiles = (n + c - 1) / c, steps = stream_steps(k, kt);
      const int stage_bytes =
          (packed ? kt / 2 : kt) * stream_groups(c) * 32;
      const int splits = stream_splits(
          tiles, steps, stage_bytes, per_sm * sms,
          packed ? kStreamPackedSplitK / kt : steps);
      const long long cost = stream_cost(tiles, steps, splits, stage_bytes,
                                         per_sm * sms);
      if (best < 0 || cost < best) {
        best = cost;
        *p = Plan{1, tiles, c, (int)smem, 1, kt, splits, stages, per_sm};
      }
    }
    if (best >= 0) return true;
  }
  return false;
}

// The streamed path's device scratch for m rows of d (bytes from a
// 256-byte aligned base): the transform's two f32 planes y and z (m x d
// each), each row's range as two ordered ints, with kt > 0 the codes (m
// rows of wide_ldq(d, kt) bytes, zero past d), then from `tot` (256-byte
// aligned) `tot_bytes` of the contraction's split sums (stream_totals).
CTQ_HD inline size_t wide_ldq(int d, int kt) {
  return kt > 0 ? (size_t)((k_groups(d) + kt - 1) / kt) * kt : 0;
}
struct WideScratch {
  size_t y, z, mm, q, tot, end;
  CTQ_HD WideScratch(int m, int d, int kt, size_t tot_bytes = 0) {
    const size_t plane = align16(4 * (size_t)m * d);
    y = 0;
    z = y + plane;
    mm = z + plane;
    q = mm + align16(8 * (size_t)m);
    tot = (q + (size_t)m * wide_ldq(d, kt) + 255)
          & ~static_cast<size_t>(255);
    end = tot + tot_bytes;
  }
};

// The streamed contraction's partial sums in device memory: with more
// than one split, each split of each tile writes its int32 sums ((m + 1)
// x cols: the rows', then the column sums) to its own slot, which the
// tile's owner adds in split order after a grid barrier; none for one
// split.
CTQ_HD inline size_t stream_totals(int m, int tiles, int cols, int splits) {
  return splits > 1 ? align16(4 * (size_t)tiles * splits * (m + 1) * cols)
                    : 0;
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
    return stream_plan(m, d, n, packed, forced, false, sms, smem_optin, p,
                       wide_tq_bytes(a, b, bk));
  *p = Plan{c, (n + c * cols - 1) / (c * cols), cols, (int)lay.end};
  return true;
}

// The tiled fused linear's transform-quant plan for m > 0 rows of d = a *
// b: clusters of the largest size the transform splits over, each
// transforming `rows` consecutive rows (1..kMaxRows; 0: kMaxRows, so each
// factor element a CTA reads serves eight rows), ceil(m / rows) clusters.
// `cols` carries the rows per cluster. Where that does not fit in shared
// memory, the streamed path with `rows` 0: one group of all m rows,
// transformed by `per_sm` CTAs per SM (kStreamCtasPerSm where the
// transform's tile, wide_tq_bytes, fits in that share) through the device
// scratch. -> false for a shape the kernel does not take.
CTQ_HD inline bool tiled_plan(int m, int d, int a, int b, int bk,
                              int smem_optin, int rows, Plan* p) {
  const int forced = rows;
  if (rows == 0) rows = kMaxRows;
  if (m < 1 || rows < 1 || rows > kMaxRows) return false;
  const int c = cluster_size(d, a, b, bk, 0);
  if (c == 0) return false;
  const TqLayout lay(rows, d, c, a, b, bk, false);
  if (lay.end + kStaticSmem > (size_t)smem_optin) {   // the streamed path
    const size_t tq = wide_tq_bytes(a, b, bk);
    if (forced != 0) return false;
    for (int per_sm = kStreamCtasPerSm; per_sm >= 1; --per_sm)
      if (tq + kStaticSmem <= (size_t)stream_smem(smem_optin, per_sm)) {
        *p = Plan{1, 1, m, (int)tq, 1, 0, 1, 0, per_sm};
        return true;
      }
    return false;
  }
  *p = Plan{c, (m + rows - 1) / rows, rows, (int)lay.end};
  return true;
}

// The prologue's plan for m rows of d = a * b against n = heads * hd QKV
// columns: one CTA per head (cols = hd, a multiple of 4), in clusters of
// the largest size the transform splits over that divides the heads.
// Where that does not fit in shared memory, the streamed path on a card
// of `sms` SMs: one head per tile (`clusters` tiles of hd columns), each
// head's K split over CTAs, its epilogue run once, by the head's owner
// once its splits are added.
CTQ_HD inline bool prologue_plan(int m, int d, int n, int hd, int a, int b,
                                 int bk, int packed, int sms, int smem_optin,
                                 Plan* p) {
  if (m < 1 || m > kMaxRows || hd < 4 || hd > kThreads || hd % 4
      || n % hd)
    return false;
  const int heads = n / hd, c = cluster_size(d, a, b, bk, heads);
  if (c == 0) return false;
  const CtaLayout lay(m, d, c, a, b, bk, packed, hd, true,
                      !splits(d, a, b, bk, c));
  if (lay.end + kStaticSmem > (size_t)smem_optin)   // the streamed path
    return stream_plan(m, d, n, packed, hd, true, sms, smem_optin, p,
                       wide_tq_bytes(a, b, bk));
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
// tile does not fit in shared memory (a deep K). Where even that does
// not fit (4 columns take 16-byte rows as 16 do: K above about 9,100
// int8 or 13,700 packed at m 8), or the forced columns' tile does not,
// the streamed plan (stream_plan, path 1: K through a ring, split over
// CTAs). -> false for a shape the kernel does not take (m outside
// 1..kMaxRows, such columns, or shared memory that holds no ring).
CTQ_HD inline bool code_gemv_plan(int m, int k, int n, int packed, int sms,
                                  int smem_optin, int cols, Plan* p) {
  if (m < 1 || m > kMaxRows || k < 1 || n < 1 || sms < 1) return false;
  const int forced = cols;
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
  if (lay.end + kStaticSmem > (size_t)smem_optin)   // a deep K
    return stream_plan(m, k, n, packed, forced, false, sms, smem_optin, p);
  *p = Plan{1, (n + cols - 1) / cols, cols, (int)lay.end};
  return true;
}

#ifdef __CUDACC__
// SMs of the current device, once per device.
inline int device_sms() {
  static int cache[16];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < 0 || dev >= 16) return 0;
  if (cache[dev] == 0)
    cudaDeviceGetAttribute(&cache[dev], cudaDevAttrMultiProcessorCount,
                           dev);
  return cache[dev];
}

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
// clusters, cols (tiled: rows per cluster), smem, path, ktile, splits,
// stages, per_sm}. smem_optin 0 (and the prologue's sms 0) reads the current
// device's (CUDA builds only). Return 0, or 1 for a shape the kernel does
// not take.
namespace ctq {
constexpr int kPlanFields = 9;
inline void write_plan(const Plan& p, int* out) {
  out[0] = p.cluster;
  out[1] = p.clusters;
  out[2] = p.cols;
  out[3] = p.smem;
  out[4] = p.path;
  out[5] = p.ktile;
  out[6] = p.splits;
  out[7] = p.stages;
  out[8] = p.per_sm;
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
                                 int bk, int packed, int sms, int smem_optin,
                                 int* out) {
#ifdef __CUDACC__
  if (smem_optin == 0) smem_optin = ctq::device_smem_optin();
  if (sms == 0) sms = ctq::device_sms();
#endif
  ctq::Plan p;
  if (!ctq::prologue_plan(m, d, n, hd, a, b, bk, packed, sms, smem_optin,
                          &p))
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

// The streamed contraction's plan (ctq::stream_plan, no outputs) for m
// rows of k codes against n columns with `cols` columns per tile (0: the
// plan's), as the code GEMV's deep K and the decode linear's streamed path
// run it; out as ctq_gemv_plan's. Return 0, or 1 for a shape it does not
// take.
extern "C" int ctq_stream_plan(int m, int k, int n, int packed, int cols,
                               int sms, int smem_optin, int* out) {
#ifdef __CUDACC__
  if (smem_optin == 0) smem_optin = ctq::device_smem_optin();
#endif
  ctq::Plan p;
  if (!ctq::stream_plan(m, k, n, packed, cols, false, sms, smem_optin, &p))
    return 1;
  ctq::write_plan(p, out);
  return 0;
}

// The streamed path's device scratch in bytes for m rows of d, stages of
// ktile K (0: the tiled stage, no codes) and the contraction's totals of
// `tiles` tiles of `cols` columns split `splits` ways (the plan's), into
// *out. Returns 0.
extern "C" int ctq_wide_scratch(int m, int d, int ktile, int tiles,
                                int cols, int splits, long long* out) {
  *out = (long long)ctq::WideScratch(
             m, d, ktile, ctq::stream_totals(m, tiles, cols, splits))
             .end;
  return 0;
}

// The streamed code GEMV's device scratch in bytes (its totals) for m rows
// and the plan's tiles, columns and splits, into *out. Returns 0.
extern "C" int ctq_stream_totals(int m, int tiles, int cols, int splits,
                                 long long* out) {
  *out = (long long)ctq::stream_totals(m, tiles, cols, splits);
  return 0;
}
