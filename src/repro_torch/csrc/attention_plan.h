// Launch plans and shared-memory layouts of the paged attentions
// (paged_attention.cu: paged_attn_decode_kernel, paged_attn_ragged_kernel).
//
// This header is the one owner of how the decode kernel splits an item's
// key positions over the CTAs of a cluster (split_range), of the number of
// splits (decode_plan), of how the ragged kernel tiles an item's query
// rows (ragged_rows, ragged_plan), of the head dims the kernels take and
// the width each is built for (padded_hd), of the chunk and tile sizes and
// of every shared-memory region's offset (DecodeLayout, RaggedLayout). It
// is plain C++ apart from the __host__ __device__ marks, so the kernels,
// their C entries and a host C++ build (the CPU tests) compile the same
// rules;
// Python reads them through pa_decode_plan, pa_split_range and
// pa_ragged_plan, exported by the CUDA library.
#pragma once

#include <stddef.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define PA_HD __host__ __device__
#else
#define PA_HD
#endif

namespace pa {

constexpr int kThreads = 128;     // threads per CTA
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 128;       // key positions per chunk, one per thread
constexpr int kMaxG = 8;          // query rows of a KV head per CTA
constexpr int kMaxSplit = 8;      // portable cluster size
constexpr int kMinUnits = 1;      // fewest split units per split of a prefix
constexpr int kStaticSmem = 1024; // bound on the kernel's static shared memory
constexpr int kRaggedRows = 64;   // ragged: query rows per CTA, 16 per warp
constexpr int kRaggedChunk = 64;  // ragged: key positions per chunk
constexpr int kRaggedGroups = 2;  // ragged: warp groups splitting the chunks
constexpr int kRaggedThreads = kThreads * kRaggedGroups;
constexpr int kRaggedStages = 2 * kRaggedGroups;   // int8 chunk ring
constexpr int kDefaultSmem = 48 * 1024;   // dynamic smem without opt-in
constexpr int kMaxHd = 256;       // the widest head dim the kernels take
// the shared memory the decode split rule fits its layout into: the
// H100's opt-in (227 KiB), a constant, so the split does not hang on the
// card
constexpr int kSplitSmem = 227 * 1024;

PA_HD inline int imin(int a, int b) { return a < b ? a : b; }

// The width the kernels are built for that holds head dim hd: the least
// of 32, 64, 128 and 256 at or above it; 0 for a head dim they do not take
// (other than a multiple of 8 from 8 to kMaxHd). The kernels keep each
// K and V row at that width in shared memory, the query's dims past hd
// zero, so the pad adds exact zeros to every score, and write hd dims.
PA_HD inline int padded_hd(int hd) {
  if (hd < 8 || hd > kMaxHd || hd % 8 != 0) return 0;
  int p = 32;
  while (p < hd) p *= 2;
  return p;
}

// The ragged kernel at a padded width above 128 splits the head dims
// between its warp groups (each holds half of every query row's dims and
// of its outputs, the partial scores exchanged through shared memory),
// where at 128 and below each group takes every other chunk with all the
// dims: a thread's query fragments and outputs of 256 dims do not fit in
// its registers. Its query fragments then wait in shared memory, and its
// int8 ring holds 2 chunks, not 4, to fit.
PA_HD constexpr bool ragged_split_dd(int hp) { return hp > 128; }
PA_HD constexpr int ragged_stages(int hp) {
  return ragged_split_dd(hp) ? 2 : kRaggedStages;
}

PA_HD inline size_t align16(size_t v) {
  return (v + 15) & ~static_cast<size_t>(15);
}

// Key positions per split unit: whole pages, about one chunk, so that a
// page never straddles two splits.
PA_HD inline int split_unit(int page_size) {
  return page_size >= kChunk ? page_size : (kChunk / page_size) * page_size;
}

// The key positions [*lo, *hi) that split `rank` of `split` attends for an
// item of `len` positions: consecutive runs of whole units, the first
// ranks taking ceil(units / split) each; empty ranks get lo == hi.
PA_HD inline void split_range(int len, int page_size, int split, int rank,
                              int* lo, int* hi) {
  const int u = split_unit(page_size);
  const int units = (len + u - 1) / u, per = (units + split - 1) / split;
  *lo = imin(rank * per * u, len);
  *hi = imin((rank + 1) * per * u, len);
}

// Floats of one partial softmax state of gl rows of hd: acc (gl x hd),
// then m and l (gl each), rounded up to 16 bytes.
PA_HD inline int slot_floats(int gl, int hd) {
  return (gl * (hd + 2) + 3) & ~3;
}

// Byte offsets of the kernel's regions in dynamic shared memory for gl
// query rows per CTA (gl <= kMaxG), padded head dim hd (padded_hd) and
// `split` CTAs per cluster: two stages of a chunk (int8 K and V codes, row
// stride hd,
// their f32 scales and the positions' token rows in the pools), the
// scaled query rows, each warp's probabilities of its 32 positions, each
// warp's partial softmax state and, when split > 1, that of every split
// (rank 0's).
struct DecodeLayout {
  size_t stage, k, v, ks, vs, tok, q, p, warps, part, end;
  PA_HD DecodeLayout(int gl, int hd, int split) {
    const size_t slot = 4 * (size_t)slot_floats(gl, hd);
    k = 0;
    v = k + (size_t)kChunk * hd;
    ks = v + (size_t)kChunk * hd;
    vs = ks + 4 * (size_t)kChunk;
    tok = vs + 4 * (size_t)kChunk;
    stage = align16(tok + 4 * (size_t)kChunk);   // stage 1 at k + stage
    q = 2 * stage;
    p = q + align16(4 * (size_t)gl * hd);
    warps = p + align16(4 * (size_t)gl * kChunk);
    part = warps + align16(kWarps * slot);
    end = part + (split > 1 ? align16(split * slot) : 0);
  }
};

// A launch plan: `split` CTAs (a cluster) per (item, KV head, group of up
// to kMaxG query rows), `ctas` CTAs in all, `smem` bytes of dynamic shared
// memory per CTA.
struct DecodePlan {
  int split, ctas, smem;
};

// The decode kernel's plan for b items of kvh KV heads, g query rows per
// KV head, head dim hd, pages of page_size rows and n_ptab table entries
// per item (which bound its prefix), on a card of `sms` SMs whose CTAs may
// opt into `smem_optin` bytes of shared memory. `split` 0 takes the plan's
// own: the largest power of two up to kMaxSplit that leaves each split at
// least kMinUnits units of the longest prefix the table holds; so a short
// prefix takes one split; and whose layout fits kSplitSmem (at a padded
// head dim of 256 and 8 rows, 4 splits). The split depends on the table's
// width and the head shape only, never on b or the card: it sets the
// order in which a row's partial softmax states combine, so an engine's
// rows (every launch of which passes the same table width) get the same
// bits whatever the batch that carries them. -> false for a shape the
// kernel does not take.
PA_HD inline bool decode_plan(int b, int kvh, int g, int hd, int page_size,
                              int n_ptab, int sms, int smem_optin, int split,
                              DecodePlan* p) {
  const int hp = padded_hd(hd);
  if (b < 1 || kvh < 1 || g < 1 || page_size < 1 || n_ptab < 1 || sms < 1
      || hp == 0)
    return false;
  const int groups = (g + kMaxG - 1) / kMaxG, gl = imin(g, kMaxG);
  const int base = b * kvh * groups;
  if (split == 0) {
    const int u = split_unit(page_size);
    const long long units = ((long long)n_ptab * page_size + u - 1) / u;
    split = 1;
    while (split * 2 <= kMaxSplit && units >= (long long)kMinUnits * split * 2
           && DecodeLayout(gl, hp, split * 2).end + kStaticSmem
                  <= (size_t)kSplitSmem)
      split *= 2;
  }
  if (split < 1 || split > kMaxSplit) return false;
  const DecodeLayout lay(gl, hp, split);
  if (lay.end + kStaticSmem > (size_t)smem_optin) return false;
  p->split = split;
  p->ctas = base * split;
  p->smem = (int)lay.end;
  return true;
}

// Byte offsets of the ragged kernel's regions for padded head dim hd
// (padded_hd): ragged_stages(hd) stages of a chunk of kRaggedChunk
// positions (the fields of DecodeLayout's stages: int8 K and V codes, row
// stride hd, their f32 scales and the positions' token rows), then per
// warp group (`group` bytes apart) its chunk's codes as bf16 for the
// tensor cores: K (kRaggedChunk rows of the group's hg dims) and V
// transposed (hg rows of kRaggedChunk positions, for the P.V product's B
// operand), hg = hd, or hd / kRaggedGroups where the groups split the dims
// (ragged_split_dd); then, there, each group's partial scores of a chunk
// (kRaggedRows x kRaggedChunk f32, `x`) and each thread's query fragments
// (`q`: 16 bytes per bf16 part, of which an f32 query has two, and k-step
// of its group's hg dims). After the chunks, the stages hold the groups'
// softmax states for their combine (groups that split the dims need
// none).
struct RaggedLayout {
  size_t stage, k, v, ks, vs, tok, kb, vt, group, x, q, end;
  PA_HD explicit RaggedLayout(int hd) {
    const bool split_dd = ragged_split_dd(hd);
    const size_t hg = split_dd ? hd / kRaggedGroups : hd;
    k = 0;
    v = k + (size_t)kRaggedChunk * hd;
    ks = v + (size_t)kRaggedChunk * hd;
    vs = ks + 4 * (size_t)kRaggedChunk;
    tok = vs + 4 * (size_t)kRaggedChunk;
    stage = align16(tok + 4 * (size_t)kRaggedChunk);   // stage s at s stage
    kb = ragged_stages(hd) * stage;
    vt = kb + 2 * (size_t)kRaggedChunk * hg;
    group = 4 * (size_t)kRaggedChunk * hg;             // K and V^T, bf16
    x = kb + kRaggedGroups * group;
    q = x + (split_dd ? (size_t)kRaggedGroups * 4 * kRaggedRows
                            * kRaggedChunk : 0);
    end = q + (split_dd ? (size_t)kRaggedGroups * 2 * (hg / 16) * kThreads
                              * 16 : 0);
  }
};

// The query rows [*lo, *hi) of tile `tile` of an item of nq query
// positions of g rows each: rows r = qi * g + gi in order, kRaggedRows per
// tile, so a tile's horizons rise with qi where q_pos does.
PA_HD inline void ragged_rows(int nq, int g, int tile, int* lo, int* hi) {
  *lo = imin(tile * kRaggedRows, nq * g);
  *hi = imin((tile + 1) * kRaggedRows, nq * g);
}

// A ragged launch plan: `tiles` tiles of query rows per (item, KV head),
// `ctas` CTAs in all (one per item, KV head and tile), `smem` bytes of
// dynamic shared memory per CTA.
struct RaggedPlan {
  int tiles, ctas, smem;
};

// The ragged kernel's plan for n_items work items of nq query positions,
// kvh KV heads of g query rows each and head dim hd, on a card whose CTAs
// may opt into `smem_optin` bytes of shared memory. -> false for a shape
// the kernel does not take.
PA_HD inline bool ragged_plan(int n_items, int nq, int kvh, int g, int hd,
                              int page_size, int smem_optin, RaggedPlan* p) {
  const int hp = padded_hd(hd);
  if (n_items < 1 || nq < 1 || kvh < 1 || g < 1 || page_size < 1 || hp == 0)
    return false;
  const long long tiles =
      ((long long)nq * g + kRaggedRows - 1) / kRaggedRows;
  const long long ctas = (long long)n_items * kvh * tiles;
  const RaggedLayout lay(hp);
  // the stages also hold the groups' states for the combine: per lane of
  // a group but the first, m and l of two rows and hp / 2 outputs
  const size_t states = ragged_split_dd(hp) ? 0
      : 4 * (size_t)(kRaggedGroups - 1) * kThreads * (4 + hp / 2);
  if (ctas > 0x7fffffffLL || states > lay.kb
      || lay.end + kStaticSmem > (size_t)smem_optin)
    return false;
  p->tiles = (int)tiles;
  p->ctas = (int)ctas;
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

}  // namespace pa

// For Python (kernels/paged_attention.decode_plan): out = {split, ctas,
// smem}; smem_optin 0 reads the current device's (CUDA builds only).
// Returns 0, or 1 for a shape the kernel does not take.
extern "C" int pa_decode_plan(int b, int kvh, int g, int hd, int page_size,
                              int n_ptab, int sms, int smem_optin, int split,
                              int* out) {
#ifdef __CUDACC__
  if (smem_optin == 0) smem_optin = pa::device_smem_optin();
#endif
  pa::DecodePlan p;
  if (!pa::decode_plan(b, kvh, g, hd, page_size, n_ptab, sms, smem_optin,
                       split, &p))
    return 1;
  out[0] = p.split;
  out[1] = p.ctas;
  out[2] = p.smem;
  return 0;
}

// For Python (kernels/paged_attention.ragged_plan): out = {tiles, ctas,
// smem}; smem_optin 0 reads the current device's (CUDA builds only).
// Returns 0, or 1 for a shape the kernel does not take.
extern "C" int pa_ragged_plan(int n_items, int nq, int kvh, int g, int hd,
                              int page_size, int smem_optin, int* out) {
#ifdef __CUDACC__
  if (smem_optin == 0) smem_optin = pa::device_smem_optin();
#endif
  pa::RaggedPlan p;
  if (!pa::ragged_plan(n_items, nq, kvh, g, hd, page_size, smem_optin, &p))
    return 1;
  out[0] = p.tiles;
  out[1] = p.ctas;
  out[2] = p.smem;
  return 0;
}

// For Python (kernels/paged_attention.ragged_rows): out = {lo, hi}.
extern "C" int pa_ragged_rows(int nq, int g, int tile, int* out) {
  if (nq < 0 || g < 1 || tile < 0) return 1;
  pa::ragged_rows(nq, g, tile, &out[0], &out[1]);
  return 0;
}

// For Python (kernels/paged_attention.split_range): out = {lo, hi}.
extern "C" int pa_split_range(int len, int page_size, int split, int rank,
                              int* out) {
  if (page_size < 1 || split < 1 || rank < 0 || rank >= split || len < 0)
    return 1;
  pa::split_range(len, page_size, split, rank, &out[0], &out[1]);
  return 0;
}
