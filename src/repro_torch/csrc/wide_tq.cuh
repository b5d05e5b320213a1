// The streamed path of the cluster kernels, for Hopper (sm_90a): the CAT
// transform, the dynamic per-token quant and the code contraction at the
// widths whose operands do not fit in one cluster's shared memory (d_ff
// 14336 .. 24576, factors up to 192, N up to 32768). Used by the decode
// fused CAT linear and the tiled linear's stage 1 (fused_cat_matmul.cu),
// by the decode QKV prologue (decode_layer.cu) wherever their plans
// (cluster_plan.h) say path 1, and by the code GEMV of rows 7 and 8
// (quant_matmul.cu) at a K too deep for its one-tile plan.
//
// One cooperative launch of two CTAs per SM (ctq::kStreamCtasPerSm; one
// where half an SM's shared memory is too little), each in its share of
// the SM's shared memory. The transform's
// intermediates live in a device scratch buffer (ctq::WideScratch, read
// back through L2), so nothing of size d has to fit on chip:
//   1. block-CAT and sign of every value (y), the rows' ranges reset;
//   2. Z = Y Hb^T (z);
//   3. Ha Z (back into y), each CTA's range of each row folded into the
//      row's range by integer atomics on an order-preserving encoding of
//      the floats (min and max are exact in any order);
//   4. every row's scale and zero point (tq::asym_params of the range,
//      computed alike wherever it is needed) and the codes.
// A grid barrier separates the steps. Each step runs as tiles of a small
// product whose operands a CTA stages in shared memory (transform_quant),
// one output per thread, so each transform output is ONE fmaf chain from
// 0 computed whole by one thread, in the order of the cluster path and
// of the plain versions' fma_chain: the block-CAT over the block's row
// j, Z over j, Ha Z over i. The codes, scales and zero points therefore
// equal the plain version's bitwise.
//
// The contraction (Stream below) then streams K on the tensor cores:
// each CTA takes work items (a column tile's K split; the prologue: a
// head's) and runs their stages through a deep ring in shared memory,
// whose first stages of weights it issues before the transform starts
// (the weights do not depend on the codes), so the weight stream overlaps
// the transform and its barriers; the splits' exact int32 partial sums
// are added in split order after a grid barrier and the epilogue runs
// once per tile.
#pragma once

#include "cluster_tq.cuh"

// This header's contraction is the ring of wide::Stream (a probe built
// against several versions of the header tells them apart by it).
#define REPRO_WIDE_STREAM_RING 1

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
// point. y, z: m x d f32 planes; mm: 2 m ints (the scratch's); tile: the
// CTA's shared-memory tile of ctq::wide_tq_bytes(a, b, bk) bytes.
//
// Each step is a small product whose operand tiles a CTA stages in
// shared memory by coalesced reads, once per work item, so every chain
// reads shared memory, never L2:
//   1. a CAT block's 32 output rows x 8 activation rows: the block rows
//      and the rows' x slice staged (row pitch bk + 1, so a warp's 32
//      block rows fall on distinct banks);
//   2. Z = Y Hb^T as (m a) x b times b x b: 16 rows of Y against 16 rows
//      of Hb (pitch b + 1);
//   3. Ha Z per row as a x a times a x b: 16 rows of Ha (pitch a + 1)
//      against 16 columns of the row's Z;
// one output per thread, each ONE fmaf chain from 0 in the order of the
// cluster path and of the plain versions' fma_chain (the block-CAT over
// j, Z over j, Ha Z over i), so the codes, scales and zero points equal
// the plain version's bitwise. Step 3 folds each item's range of its row
// into the row's range by integer atomics on an order-preserving
// encoding (min and max are exact in any order).
template <typename T>
__device__ void transform_quant(const T* __restrict__ x, int m, int d,
                                const float* __restrict__ blocks, int bk,
                                const float* __restrict__ sign,
                                const float* __restrict__ ha, int a,
                                const float* __restrict__ hb, int b,
                                int act_bits, float* y, float* z, int* mm,
                                int8_t* codes, size_t ldq, int kz, float* sx,
                                float* zx, float* tile) {
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  constexpr int kT = 16;   // steps 2 and 3: 16 x 16 outputs per item
  if (blockIdx.x == 0)
    for (int r = tid; r < m; r += kThreads) {
      mm[2 * r] = ord(INFINITY);
      mm[2 * r + 1] = ord(-INFINITY);
    }
  // 1. block-CAT over the block's row, then * sign: item (block, 32 of
  //    its rows, 8 activation rows), thread (row of x, block row)
  if (blocks != nullptr) {
    const int nblk = d / bk, ec = (bk + 31) / 32, rg = (m + 7) / 8;
    float* s_b = tile;                       // 32 x (bk + 1)
    float* s_x = tile + 32 * (bk + 1);       // 8 x bk
    for (int it = blockIdx.x; it < nblk * ec * rg; it += gridDim.x) {
      const int blk = it / (ec * rg), rest = it - blk * ec * rg;
      const int e0 = blk * bk + (rest / rg) * 32, r0 = (rest % rg) * 8;
      const int ne = min(32, blk * bk + bk - e0), nr = min(8, m - r0);
      __syncthreads();   // the previous item's chains are done
      for (int q = tid; q < ne * bk; q += kThreads) {
        const int e = q / bk, j = q - e * bk;
        s_b[e * (bk + 1) + j] = __ldg(blocks + (size_t)e0 * bk + q);
      }
      for (int q = tid; q < nr * bk; q += kThreads) {
        const int r = q / bk, j = q - r * bk;
        s_x[q] = tq::to_f32(x[(size_t)(r0 + r) * d + blk * bk + j]);
      }
      __syncthreads();
      const int e = tid & 31, r = tid >> 5;
      if (e < ne && r < nr) {
        const float* br = s_b + e * (bk + 1);
        const float* xr = s_x + r * bk;
        float acc = 0.f;
        for (int j = 0; j < bk; ++j) acc = fmaf(xr[j], br[j], acc);
        const float sg = sign != nullptr ? __ldg(sign + e0 + e) : 1.f;
        y[(size_t)(r0 + r) * d + e0 + e] = acc * sg;
      }
    }
  } else {
    for (size_t q = (size_t)blockIdx.x * kThreads + tid; q < (size_t)m * d;
         q += (size_t)gridDim.x * kThreads) {
      const float sg = sign != nullptr ? __ldg(sign + q % d) : 1.f;
      y[q] = tq::to_f32(x[q]) * sg;
    }
  }
  grid.sync();
  // 2. Z = Y Hb^T: rows (r, i) of Y against rows l of Hb, over j
  {
    const int rows = m * a, tn = (rows + kT - 1) / kT, ln = (b + kT - 1) / kT;
    float* s_y = tile;                       // 16 x (b + 1)
    float* s_h = tile + kT * (b + 1);        // 16 x (b + 1)
    for (int it = blockIdx.x; it < tn * ln; it += gridDim.x) {
      const int t0 = (it / ln) * kT, l0 = (it % ln) * kT;
      __syncthreads();
      for (int q = tid; q < kT * b; q += kThreads) {
        const int rr = q / b, j = q - rr * b;
        if (t0 + rr < rows)
          s_y[rr * (b + 1) + j] = __ldcg(y + (size_t)t0 * b + q);
        if (l0 + rr < b)
          s_h[rr * (b + 1) + j] = __ldg(hb + (size_t)l0 * b + q);
      }
      __syncthreads();
      const int tl = tid % kT, ti = tid / kT;
      if (t0 + ti < rows && l0 + tl < b) {
        const float* yr = s_y + ti * (b + 1);
        const float* hr = s_h + tl * (b + 1);
        float acc = 0.f;
        for (int j = 0; j < b; ++j) acc = fmaf(yr[j], hr[j], acc);
        z[(size_t)(t0 + ti) * b + l0 + tl] = acc;
      }
    }
  }
  grid.sync();
  // 3. Ha Z: out[r][p][l] over i, into y; the item's range of its row
  //    into the row's
  {
    const int pn = (a + kT - 1) / kT, ln = (b + kT - 1) / kT;
    float* s_a = tile;                       // 16 x (a + 1)
    float* s_z = tile + kT * (a + 1);        // a x 16
    __shared__ float s_wmin[kWarps], s_wmax[kWarps];
    for (int it = blockIdx.x; it < m * pn * ln; it += gridDim.x) {
      const int r = it / (pn * ln), rest = it - r * pn * ln;
      const int p0 = (rest / ln) * kT, l0 = (rest % ln) * kT;
      __syncthreads();
      for (int q = tid; q < kT * a; q += kThreads) {
        const int pp = q / a, i = q - pp * a;
        if (p0 + pp < a)
          s_a[pp * (a + 1) + i] = __ldg(ha + (size_t)p0 * a + q);
        const int ii = q / kT, ll = q - ii * kT;
        if (l0 + ll < b)
          s_z[q] = __ldcg(z + (size_t)r * d + (size_t)ii * b + l0 + ll);
      }
      __syncthreads();
      const int tl = tid % kT, tp = tid / kT;
      float mn = INFINITY, mx = -INFINITY;
      if (p0 + tp < a && l0 + tl < b) {
        const float* ar = s_a + tp * (a + 1);
        float acc = 0.f;
        for (int i = 0; i < a; ++i) acc = fmaf(s_z[i * kT + tl], ar[i], acc);
        y[(size_t)r * d + (size_t)(p0 + tp) * b + l0 + tl] = acc;
        mn = mx = acc;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, off));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      if (lane == 0) {
        s_wmin[warp] = mn;
        s_wmax[warp] = mx;
      }
      __syncthreads();
      if (tid == 0) {
        float lo = INFINITY, hi = -INFINITY;
        for (int w = 0; w < kWarps; ++w) {
          lo = fminf(lo, s_wmin[w]);
          hi = fmaxf(hi, s_wmax[w]);
        }
        atomicMin(mm + 2 * r, ord(lo));
        atomicMax(mm + 2 * r + 1, ord(hi));
      }
    }
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

// ------------------------------------------------ the streamed contraction

// mbarriers in shared memory (CTA scope): each ring stage has one, which
// completes a phase once every thread has arrived twice for each of the
// stage's two parts (weights, codes): once when its cp.async copies have
// landed (cp.async.mbarrier.arrive.noinc) and once after its own stores
// (zero rows, byte copies; a release arrive).
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive_part(uint64_t* bar) {
  unsigned long long state;
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
  asm volatile("mbarrier.arrive.shared.b64 %0, [%1];\n"
               : "=l"(state)
               : "r"(smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}

// N (4, 8 or 16) bytes by cp.async; 16 through L2 only (a weight byte is
// read once, a code is written by another CTA of the launch).
template <int N>
__device__ __forceinline__ void cp_async_n(void* dst, const void* src) {
  if constexpr (N == 16)
    cp_async_cg16(dst, src);
  else
    ctq::cp_async<N>(dst, src);
}

// What the streamed contraction contracts: m <= 8 rows of codes (row
// stride ldq, the first kq of each valid, zero past them; qvec: 16-byte
// aligned rows) against the weight (k rows of int8, or ceil(k / 2)
// packed rows whose bytes hold K 2p in the low nibble and 2p + 1 in the
// high one; n columns; copied in chunks of vw bytes, ctq::weight_vector),
// on the plan p (ctq::stream_plan); part: the splits' partial sums in
// device memory (ctq::stream_totals; unused for one split).
struct StreamArgs {
  const int8_t* codes;
  size_t ldq;
  int kq, m;
  bool qvec;
  const int8_t* w;
  int k, n, vw;
  ctq::Plan p;
  int* part;
};

// The streamed contraction, by every thread of each CTA of a cooperative
// launch of the plan's CTAs per SM (ctq::stream_plan). Work item i = t *
// splits + s (column tile t of `cols` columns, K split s: stages [s *
// per, min((s + 1) * per, steps)) of kt K) goes to CTA i % grid; each CTA
// walks its items' stages in one sequence through a ring of `stages`
// stages, so the stages of its next item load while it finishes one. A
// stage holds the tile's weight rows of kt K (HBM) and the m rows of kt
// codes (L2), copied by 16-byte cp.async, each thread's pieces the same
// in every stage (plan_pieces), so a stage costs a thread a few adds per
// piece; each stage has an mbarrier (mbar_arrive_part), so any number of
// stages is in flight and the weight part can be issued before the codes
// exist (prefetch_weights, before the transform; prefetch_codes after
// it).
//
// The products run on the tensor cores: mma.sync m16n8k32 s8 x s8 ->
// s32 with the weight columns on the 16-row side and the <= 8 rows of
// codes on the n = 8 side. Warp w takes column group w % G (G = ceil(cols
// / 32), 32 columns) and every (kWarps / G)-th 32-K step of each stage.
// Thread (g, t) of a warp (lane = 4 g + t) reads, per 32-K step, four
// words of its columns 4g .. 4g + 3 (packed rows 4t .. 4t + 3; int8:
// eight words, rows 8t .. 8t + 7), transposes them with byte permutes to
// K-contiguous columns (int4 nibbles moved to the high half of each byte:
// the code times 16, as s8, so the sums come out times 16, exactly, and
// are shifted back at the item's end; ctq::stream_plan keeps a split's K
// within 2^31 / 2^14) and feeds
// columns (4g, 4g + 1) and (4g + 2, 4g + 3) as two mma A fragments; a sum
// is exact in any order, so each thread's fragment slots may hold K 8t +
// {0, 2, 4, 6} and 8t + {1, 3, 5, 7} (the nibbles' order) as long as its
// code fragment (8 codes of row g, split into the same two sets) does.
// The column sums come from a third and fourth mma against codes of all
// ones. The weight rows' pitch and swizzle (ctq::stream_wpitch) put the
// four rows that one word read of a warp touches on distinct banks.
//
// At an item's end the warps' partial sums are added in shared memory in
// warp order; with one split they are the tile's totals and the epilogue
// `epi` runs at once; else the split stores them to its own slot, and
// after a grid barrier the tile's owner (CTA t % grid) adds the slots in
// split order and runs `epi`. Integer sums do not depend on their order,
// so the totals, and the epilogue that runs once per tile on them, are
// the same bitwise in every split and every run.
template <bool PACKED>
struct Stream {
  static constexpr int kUnitRows = PACKED ? 16 : 32;   // weight rows / 32 K
  static constexpr int kRT = kUnitRows / 4;            // rows per t
  StreamArgs a;
  ctq::StreamLayout lay;
  char* smem;
  uint64_t* bars;
  int steps, per, items, groups, ki_n;
  bool wvec, swizzled;

  __device__ Stream(const StreamArgs& args, char* smem_base,
                    bool outs = false)
      : a(args),
        lay(args.m, args.p.ktile, args.p.stages, PACKED, args.p.cols,
            outs),
        smem(smem_base) {
    bars = reinterpret_cast<uint64_t*>(smem + lay.bar);
    steps = ctq::stream_steps(a.k, a.p.ktile);
    per = ctq::stream_per(steps, a.p.splits);
    items = a.p.clusters * a.p.splits;
    groups = lay.groups;
    ki_n = kWarps / groups;
    wvec = a.vw == 16;
    swizzled = ctq::stream_swizzled(a.p.cols);
    plan_pieces();
  }

  // The CTA's position in its sequence of stages: item i (a multiple of
  // the grid away from blockIdx.x), stage ks of its split, flat index f.
  struct Cursor {
    int i, ks, f;
  };
  __device__ int split_begin(int i) const { return (i % a.p.splits) * per; }
  __device__ int split_end(int i) const {
    return min(split_begin(i) + per, steps);
  }
  __device__ Cursor first() const {
    const int i = blockIdx.x;
    return Cursor{i, i < items ? split_begin(i) : 0, 0};
  }
  __device__ void advance(Cursor& c) const {
    ++c.f;
    if (++c.ks >= split_end(c.i)) {
      c.i += gridDim.x;
      if (c.i < items) c.ks = split_begin(c.i);
    }
  }

  // The ring's barriers, by every thread (thread 0 initializes them);
  // visible after the block barrier that ends it.
  __device__ void init() {
    if (threadIdx.x == 0) {
      for (int s = 0; s < a.p.stages; ++s)
        mbar_init(bars + s, 4 * kThreads);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }

  // This thread's pieces of a stage (the same in every stage): weight
  // piece j is 16 bytes of row wr[j] at byte wo[j] of the groups' column
  // runs; code piece j of row qr[j] at qo[j] (-1: none).
  // A stage holds at most ctq::kStreamStageBytes of weight runs
  // (ctq::stream_ring): 1,024 pieces, four per thread.
  static constexpr int kMaxPieces = 4;
  int wr[kMaxPieces], wo[kMaxPieces], wd[kMaxPieces], qr[2], qo[2];

  // The 16-byte piece c of a weight row read by thread group t, at its
  // place in the row (ctq::stream_wpitch: XOR-swizzled where the rows are
  // not padded).
  __device__ __forceinline__ int piece_at(int c, int t) const {
    return swizzled ? c ^ (2 * t) : c;
  }

  __device__ void plan_pieces() {
    const int cpr = groups * 2, rows = a.p.ktile / (PACKED ? 2 : 1);
#pragma unroll
    for (int j = 0; j < kMaxPieces; ++j) {
      const int e = threadIdx.x + j * kThreads;
      const int r = e / cpr, c = e - r * cpr;
      wr[j] = e < rows * cpr ? r : -1;
      wo[j] = c * 16;
      wd[j] = r * lay.wpitch + piece_at(c, (r / kRT) & 3) * 16;
    }
    const int pieces = a.p.ktile / 16;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int e = threadIdx.x + j * kThreads;
      qr[j] = e < a.m * pieces ? e / pieces : -1;
      qo[j] = e < a.m * pieces ? (e % pieces) * 16 : 0;
    }
  }

  // Stage c's weight part into its ring slot: the tile's weight rows of
  // its kt K (the groups' columns; those past n left as they are: they
  // feed only columns that are never stored), rows past the weight zero.
  __device__ void fill_weights(const Cursor& c) {
    uint64_t* bar = bars + c.f % a.p.stages;
    int8_t* base = reinterpret_cast<int8_t*>(
        smem + (size_t)(c.f % a.p.stages) * lay.stage);
    const int unit = PACKED ? 2 : 1, rows = a.p.ktile / unit;
    const int row0 = c.ks * rows, w_rows = (a.k + unit - 1) / unit;
    const int n0 = (c.i / a.p.splits) * a.p.cols;
    const int span = min(groups * 32, a.n - n0);   // bytes of each row
    const int valid = max(0, min(rows, w_rows - row0));
    const int8_t* src0 = a.w + (size_t)row0 * a.n + n0;
#pragma unroll
    for (int j = 0; j < kMaxPieces; ++j) {
      const int r = wr[j], o = wo[j];
      if (r < 0) break;
      int8_t* dst = base + wd[j];
      if (r >= valid) {
        *reinterpret_cast<int4*>(dst) = make_int4(0, 0, 0, 0);
        continue;
      }
      if (o >= span) continue;
      const int8_t* src = src0 + (size_t)r * a.n + o;
      if (wvec && o + 16 <= span) {
        cp_async_n<16>(dst, src);
      } else {
        for (int q = 0; q < 16; q += (a.vw > 1 ? a.vw : 16)) {
          if (a.vw == 8 && o + q + 8 <= span) {
            cp_async_n<8>(dst + q, src + q);
          } else if (a.vw == 4 && o + q + 4 <= span) {
            cp_async_n<4>(dst + q, src + q);
          } else {
            const int len = a.vw > 1 ? a.vw : 16;
            for (int e2 = 0; e2 < len; ++e2)
              dst[q + e2] = o + q + e2 < span ? src[q + e2] : (int8_t)0;
          }
        }
      }
    }
    mbar_arrive_part(bar);
  }

  // Stage c's code part: the m rows of its kt codes, zero past kq.
  __device__ void fill_codes(const Cursor& c) {
    uint64_t* bar = bars + c.f % a.p.stages;
    int8_t* base = reinterpret_cast<int8_t*>(
        smem + (size_t)(c.f % a.p.stages) * lay.stage + lay.wbytes);
    const int k0 = c.ks * a.p.ktile;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (qr[j] < 0) break;
      const int kk = k0 + qo[j];
      int8_t* dst = base + qr[j] * lay.qpitch + qo[j];
      const int8_t* src = a.codes + (size_t)qr[j] * a.ldq + kk;
      if (a.qvec && kk + 16 <= a.kq) {
        cp_async_n<16>(dst, src);
      } else {
        for (int e2 = 0; e2 < 16; ++e2)
          dst[e2] = kk + e2 < a.kq ? src[e2] : (int8_t)0;
      }
    }
    mbar_arrive_part(bar);
  }

  // The weight parts of the CTA's first `stages` stages (before the
  // codes exist); then, after them, their code parts.
  __device__ void prefetch_weights() {
    Cursor c = first();
    for (int s = 0; s < a.p.stages && c.i < items; ++s, advance(c))
      fill_weights(c);
  }
  __device__ void prefetch_codes() {
    Cursor c = first();
    for (int s = 0; s < a.p.stages && c.i < items; ++s, advance(c))
      fill_codes(c);
  }

  // The 32-K steps of one stage for this warp's column group.
  __device__ __forceinline__ void contract_stage(int slot, int (&acc)[2][4],
                                                 int (&cs)[2][4]) const {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (warp >= groups * ki_n) return;
    const int h = warp % groups, ki = warp / groups;
    const int g = lane >> 2, t = lane & 3;
    const char* base = smem + (size_t)slot * lay.stage;
    const int8_t* qp = reinterpret_cast<const int8_t*>(base + lay.wbytes)
                       + (g < a.m ? g : 0) * lay.qpitch + 8 * t;
    const int8_t* wp = reinterpret_cast<const int8_t*>(base)
                       + (size_t)kRT * t * lay.wpitch
                       + piece_at(2 * h + (g >> 2), t) * 16 + 4 * (g & 3);
    const int wp_unit = kUnitRows * lay.wpitch, wp_row = lay.wpitch;
    const unsigned ones[2] = {0x01010101u, 0x01010101u};
    const int units = a.p.ktile / 32;
#pragma unroll 2
    for (int u = ki; u < units; u += ki_n) {
      const uint2 q = *reinterpret_cast<const uint2*>(qp + u * 32);
      const int8_t* wu = wp + (size_t)u * wp_unit;
      unsigned b[2], a0[4], a1[4];
      if constexpr (PACKED) {
        b[0] = __byte_perm(q.x, q.y, 0x6420);   // K 8t + 0, 2, 4, 6
        b[1] = __byte_perm(q.x, q.y, 0x7531);   // K 8t + 1, 3, 5, 7
        unsigned col[4];
        transpose4(wu, wp_row, col);
        unsigned lo[4], hi[4];   // each nibble times 16, as s8
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          lo[c] = (col[c] << 4) & 0xF0F0F0F0u;
          hi[c] = col[c] & 0xF0F0F0F0u;
        }
        a0[0] = lo[0]; a0[1] = lo[1]; a0[2] = hi[0]; a0[3] = hi[1];
        a1[0] = lo[2]; a1[1] = lo[3]; a1[2] = hi[2]; a1[3] = hi[3];
      } else {
        b[0] = q.x;   // K 8t .. 8t + 3
        b[1] = q.y;   // K 8t + 4 .. 8t + 7
        unsigned ca[4], cb[4];
        transpose4(wu, wp_row, ca);
        transpose4(wu + 4 * wp_row, wp_row, cb);
        a0[0] = ca[0]; a0[1] = ca[1]; a0[2] = cb[0]; a0[3] = cb[1];
        a1[0] = ca[2]; a1[1] = ca[3]; a1[2] = cb[2]; a1[3] = cb[3];
      }
      contract::w8a8::mma_s8(acc[0], a0, b);
      contract::w8a8::mma_s8(acc[1], a1, b);
      contract::w8a8::mma_s8(cs[0], a0, ones);
      contract::w8a8::mma_s8(cs[1], a1, ones);
    }
  }

  // Rows i .. i + 3 (`pitch` bytes apart) of this thread's four columns,
  // as four K-contiguous words: col[c] byte i = row i, column c.
  __device__ __forceinline__ static void transpose4(const int8_t* p,
                                                    int pitch,
                                                    unsigned (&col)[4]) {
    const unsigned w0 = *reinterpret_cast<const unsigned*>(p);
    const unsigned w1 = *reinterpret_cast<const unsigned*>(p + pitch);
    const unsigned w2 = *reinterpret_cast<const unsigned*>(p + 2 * pitch);
    const unsigned w3 = *reinterpret_cast<const unsigned*>(p + 3 * pitch);
    const unsigned t0 = __byte_perm(w0, w1, 0x5140);
    const unsigned t1 = __byte_perm(w0, w1, 0x7362);
    const unsigned t2 = __byte_perm(w2, w3, 0x5140);
    const unsigned t3 = __byte_perm(w2, w3, 0x7362);
    col[0] = __byte_perm(t0, t2, 0x5410);
    col[1] = __byte_perm(t0, t2, 0x7632);
    col[2] = __byte_perm(t1, t3, 0x5410);
    col[3] = __byte_perm(t1, t3, 0x7632);
  }

  // An item's end: the warps' sums added in warp order, into s_tot (one
  // split: the tile's totals, m rows of cols then the column sums, row
  // stride cols; -> true) or into the split's slot in device memory (->
  // false). Ends at a block barrier.
  __device__ bool finish(int item, const int (&acc)[2][4],
                         const int (&cs)[2][4]) {
    const int m = a.m, cols = a.p.cols, cp = groups * 32;
    int* red = reinterpret_cast<int*>(smem + lay.red);
    int* s_tot = reinterpret_cast<int*>(smem + lay.tot);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (warp < groups * ki_n) {
      const int h = warp % groups, ki = warp / groups;
      const int g = lane >> 2, t = lane & 3, cb = h * 32 + 4 * g;
      int* rk = red + (size_t)ki * (m + 1) * cp;
      constexpr int sh = PACKED ? 4 : 0;   // the nibbles' factor of 16
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = 2 * t + half;
        if (r < m) {
          rk[r * cp + cb] = acc[0][half] >> sh;
          rk[r * cp + cb + 1] = acc[0][2 + half] >> sh;
          rk[r * cp + cb + 2] = acc[1][half] >> sh;
          rk[r * cp + cb + 3] = acc[1][2 + half] >> sh;
        }
      }
      if (t == 0) {
        rk[m * cp + cb] = cs[0][0] >> sh;
        rk[m * cp + cb + 1] = cs[0][2] >> sh;
        rk[m * cp + cb + 2] = cs[1][0] >> sh;
        rk[m * cp + cb + 3] = cs[1][2] >> sh;
      }
    }
    __syncthreads();
    const int n_sum = (m + 1) * cols;
    int* slot = a.part + (size_t)item * n_sum;
    for (int e = threadIdx.x; e < n_sum; e += kThreads) {
      const int r = e / cols, j = e - r * cols;
      int v = 0;
      for (int ki = 0; ki < ki_n; ++ki) v += red[(ki * (m + 1) + r) * cp + j];
      if (a.p.splits == 1)
        s_tot[e] = v;
      else
        __stcg(slot + e, v);
    }
    __syncthreads();
    return a.p.splits == 1;
  }

  // The CTA's items, after prefetch_weights and prefetch_codes: for each,
  // its stages through the ring (refilling each slot with the stage
  // `stages` later as it is freed), then finish and, with one split,
  // epi(tile, s_tot) by every thread, followed by a block barrier; with
  // more, after a grid barrier, each tile this CTA owns: its splits'
  // slots added in split order, then epi.
  template <typename Epi>
  __device__ void run(Epi&& epi) {
    int* s_tot = reinterpret_cast<int*>(smem + lay.tot);
    Cursor prod = first();
    for (int s = 0; s < a.p.stages && prod.i < items; ++s) advance(prod);
    int f = 0;
    for (int i = blockIdx.x; i < items; i += gridDim.x) {
      int acc[2][4], cs[2][4];
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y) acc[x][y] = cs[x][y] = 0;
      for (int ks = split_begin(i); ks < split_end(i); ++ks, ++f) {
        const int slot = f % a.p.stages;
        mbar_wait(bars + slot, (unsigned)(f / a.p.stages) & 1u);
        __syncthreads();   // every thread is done with stage f - 1's slot
        if (f >= 1 && prod.i < items) {
          fill_weights(prod);
          fill_codes(prod);
          advance(prod);
        }
        contract_stage(slot, acc, cs);
      }
      if (finish(i, acc, cs)) {
        epi(i, s_tot);
        __syncthreads();
      }
    }
    if (a.p.splits == 1) return;
    cg::this_grid().sync();
    const int n_sum = (a.m + 1) * a.p.cols;
    for (int tile = blockIdx.x; tile < a.p.clusters; tile += gridDim.x) {
      const int* slots = a.part + (size_t)tile * a.p.splits * n_sum;
      for (int e = threadIdx.x; e < n_sum; e += kThreads) {
        int v = 0;
        for (int s = 0; s < a.p.splits; ++s)
          v += __ldcg(slots + (size_t)s * n_sum + e);
        s_tot[e] = v;
      }
      __syncthreads();
      epi(tile, s_tot);
      __syncthreads();
    }
  }
};

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
  int* part;
  __host__ __device__ Regions(void* ws, int m, int d, int kt) {
    const ctq::WideScratch s(m, d, kt);
    char* base = static_cast<char*>(ws);
    y = reinterpret_cast<float*>(base + s.y);
    z = reinterpret_cast<float*>(base + s.z);
    mm = reinterpret_cast<int*>(base + s.mm);
    q = reinterpret_cast<int8_t*>(base + s.q);
    part = reinterpret_cast<int*>(base + s.tot);
  }
};


}  // namespace wide
