// Paged attention over the int8 KV page pool for Hopper (sm_90a), plain C
// interface.
//
// Replaces the Pallas TPU kernels paged_attention_decode and
// paged_attention_ragged of src/repro/kernels/paged_attention.py. Both
// scale q by hd^-1/2 in f32 and round it back to q's dtype before the
// dots, as the reference kernels do, take the per-(token, head) f32 scales
// of the int8 K and V rows (dequantized as code * scale), mask positions
// past the length (and, ragged, past each query's q_pos) to zero weight,
// and write the output in q's dtype.
//
// Decode (paged_attn_decode_kernel): one CTA of four warps per (item, KV
// head, group of query rows) and split of the item's key positions; a
// split of s > 1 is a thread-block cluster of s CTAs. The CTA walks its
// positions in chunks of 128: the chunk's K and V rows (hd contiguous
// int8 bytes each) and their scales arrive by 16-byte (scales 4-byte)
// cp.async into a two-stage ring, the next chunk in flight while this one
// computes, the codes kept int8 (K rows XOR-swizzled by 16-byte piece, so
// the threads of a quarter-warp read distinct banks) and turned into f32
// by a byte permute under the exponent. Each warp owns 32 positions of
// every chunk and keeps its own online softmax over them, so a chunk
// needs no barrier but the stage's: lane = position for the scores (one
// fmaf chain over hd from 0 of q * (code * scale) per row, as before),
// the warp's max and sum by xor-tree shuffles, the running (m, l, acc)
// rescaled online as the reference's page loop does, and for P.V each
// lane owns four dd of a row, one fmaf chain per dd over the warp's
// positions. The four warps' states are combined once at the end, in
// warp order. Each chunk's page-table entries load while the chunk two
// before it computes.
// A split of s CTAs ends by pushing each CTA's (m, l, acc) into rank 0's
// shared memory (distributed shared memory, a remote store before a
// cluster barrier); rank 0 combines them in rank order. Every sum runs in
// a fixed order and no float atomic is used, so equal inputs give bitwise
// equal outputs. Length 0 writes zeros and reads no page; no position past
// the length is read. The split rule and the shared-memory layout are
// attention_plan.h's, which the entry runs on every call.
//
// Ragged (paged_attn_ragged_kernel): one CTA of four warps per (work
// item, KV head, tile of 64 query rows (qi, gi) in order, 16 per warp).
// A query row attends kv positions p < its horizon min(q_pos + 1, length);
// q_pos < 0 marks a padding row (horizon 0), written as zeros. The CTA
// walks positions in chunks of 64 up to its tile's largest horizon (a
// chunk past it is never read, a tile of padding reads no page), staged
// as int8 by the decode kernel's stage_chunk (16-byte cp.async, two-stage
// ring, K rows swizzled); each chunk's codes are turned into bf16 in
// shared memory once per CTA (V transposed by 4 x 4 byte blocks, so that
// the P.V operand's positions are contiguous). Both products run on the tensor cores, mma.sync m16n8k16
// bf16 x bf16 -> f32: the int8 codes are exact in bf16; a bf16 q is exact
// as it stands and an f32 q is split into a bf16 high and low part (two
// products); each score column is multiplied by its K scale after the
// product; the V scale is folded into the probabilities (p * v_scale),
// which are split into bf16 high and low parts. The fragments permute the
// products' inner index so that a thread's codes are contiguous bytes:
// for the scores, thread t's K bytes [t hd / 4, (t + 1) hd / 4) of a row
// in one load; for P.V, its 16 positions [16 t, 16 t + 16) of the chunk,
// which are also the score columns it holds. The online softmax runs per
// row in registers (a quad's shuffles in a fixed order); a row with no
// valid position yet keeps m = -inf and adds nothing. Every sum has a
// fixed order and no float atomic is used, so equal inputs give equal
// bits.
//
// Bound on this card: the int8 page bytes of the attended prefix plus
// their scales, over HBM bandwidth. Decode reads each byte once per (item,
// KV head) and keeps scores and softmax state on chip; below ~1k positions
// per item its time is the chain of dependent phases (the first chunk's
// load, the hd-long score chain, two reductions, the chunk-long P.V
// chain), which the split shortens at long prefixes while filling the
// card. The ragged kernel reads each page once per (item, head, tile)
// and spends its time in dependent phases too: the chunk's load, the
// transpose, the two products and the softmax between them.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

#include "attention_plan.h"

namespace {

namespace cg = cooperative_groups;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float round_to(float v, float*) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// ------------------------------------------------------------- decode

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}
// Wait until at most N of this thread's newest copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// Byte k of the word wx (an int8 code XOR 0x80, as an unsigned byte u)
// as the exact f32 of the code: 2^23 + u, built by a byte permute under
// the exponent, minus 2^23 + 128. Two full-rate instructions, where an
// int-to-float conversion runs at a quarter of the rate.
__device__ __forceinline__ float code_f32(unsigned wx, int k) {
  return __fsub_rn(__int_as_float(__byte_perm(wx, 0x4B000000u, 0x7540 | k)),
                   8388736.f);
}

// The 16-byte piece jc of K row j is stored at piece jc ^ kswz(j): the
// rows a quarter-warp reads (8 consecutive j, at one jc) then cover eight
// distinct 16-byte bank groups. A row of 128 bytes or more starts a bank
// line, so its pieces are XORed with j & 7; shorter rows share a line.
template <int HD>
__device__ __forceinline__ int kswz(int j) {
  constexpr int cpr = HD / 16;
  if constexpr (cpr >= 8) {
    return j & 7;
  } else {
    constexpr int per_line = 8 / cpr;
    return (j / per_line) & (cpr - 1);
  }
}

// The token-head row of key position pos: ((page * page_size + row) *
// kvh + h), page the table's entry `page_id`.
__device__ __forceinline__ int token_row(int page_id, int pos, int page_size,
                                         int kvh, int h) {
  return (page_id * page_size + pos % page_size) * kvh + h;
}

// Issue the cp.async copies of the n positions of stage `st`, whose token
// rows are the stage's tok[]: K rows swizzled, V rows as they are, and the
// f32 scales; by NT threads, this one t of them. Layout: pa::DecodeLayout
// or pa::RaggedLayout (the same stage fields). The pools' rows hold hd
// bytes, the stage's HD (hd's padded_hd): at hd == HD by 16-byte pieces,
// else by 8-byte halves of them (hd is a multiple of 8), the pad past hd
// left as it is (the query's dims there are zero).
template <int HD, int NT = pa::kThreads, typename Layout>
__device__ __forceinline__ void stage_chunk(
    char* smem, const Layout& lay, int st, int n, int hd,
    const int8_t* __restrict__ k_pages, const float* __restrict__ k_scale,
    const int8_t* __restrict__ v_pages, const float* __restrict__ v_scale,
    int t) {
  char* base = smem + st * lay.stage;
  int8_t* s_k = reinterpret_cast<int8_t*>(base + lay.k);
  int8_t* s_v = reinterpret_cast<int8_t*>(base + lay.v);
  float* s_ks = reinterpret_cast<float*>(base + lay.ks);
  float* s_vs = reinterpret_cast<float*>(base + lay.vs);
  const int* s_tok = reinterpret_cast<const int*>(base + lay.tok);
  if (hd == HD) {
    constexpr int cpr = HD / 16;
    for (int e = t; e < n * cpr; e += NT) {
      const int j = e / cpr, jc = e - j * cpr;
      const size_t row = (size_t)s_tok[j] * HD + jc * 16;
      cp_async16(s_k + j * HD + ((jc ^ kswz<HD>(j)) << 4), k_pages + row);
      cp_async16(s_v + j * HD + (jc << 4), v_pages + row);
    }
  } else {
    const int cpr = hd / 8;
    for (int e = t; e < n * cpr; e += NT) {
      const int j = e / cpr, hc = e - j * cpr, jc = hc >> 1;
      const size_t row = (size_t)s_tok[j] * hd + hc * 8;
      cp_async8(s_k + j * HD + ((jc ^ kswz<HD>(j)) << 4) + 8 * (hc & 1),
                k_pages + row);
      cp_async8(s_v + j * HD + 8 * hc, v_pages + row);
    }
  }
  for (int j = t; j < n; j += NT) {
    cp_async4(s_ks + j, k_scale + s_tok[j]);
    cp_async4(s_vs + j, v_scale + s_tok[j]);
  }
}

// q, out: (B, kvh, g, hd); pages, scales, table and lengths as the ragged
// kernel's; HD = pa::padded_hd(hd), the width of the staged K and V rows
// and of the query rows in shared memory (zeros past hd). Grid (B * kvh *
// groups * split) in clusters of split along x, pa::kThreads threads; CTA
// x is split rank x % split of (item, head, group) x / split, its rows g0
// .. g0 + gl - 1 (gl <= G). Warp w takes positions [32 w, 32 w + 32) of
// every chunk: lane = position for the scores, its own running (m, l) per
// row, and for P.V lane owns words lane % kWordLanes + u kWordLanes (u <
// kLaneWords; four dd each) of the rows lane / kWordLanes + k kRowGroups.
// Dynamic shared memory: pa::DecodeLayout(gl, HD, split).
template <typename T, int HD, int G>
__global__ void __launch_bounds__(pa::kThreads) paged_attn_decode_kernel(
    const T* __restrict__ q, const int8_t* __restrict__ k_pages,
    const float* __restrict__ k_scale, const int8_t* __restrict__ v_pages,
    const float* __restrict__ v_scale, const int32_t* __restrict__ table,
    int n_ptab, const int32_t* __restrict__ lengths, int kvh, int g, int hd,
    int page_size, int split, float q_scale, T* __restrict__ out) {
  constexpr int kWarps = pa::kThreads / 32;
  constexpr int kLaneWords = HD / 4 > 32 ? HD / 128 : 1;   // words per lane
  constexpr int kWordLanes = HD / 4 / kLaneWords;    // lanes per row: 8..32
  constexpr int kRowGroups = 32 / kWordLanes;        // rows side by side
  constexpr int kRows = (G + kRowGroups - 1) / kRowGroups;   // per lane
  constexpr int kQ = (G * HD + pa::kThreads - 1) / pa::kThreads;
  extern __shared__ float4 pa_smem[];
  char* smem = reinterpret_cast<char*>(pa_smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int groups = (g + G - 1) / G;
  const int rank = blockIdx.x % split, unit = blockIdx.x / split;
  const int grp = unit % groups, ih = unit / groups;   // ih = item * kvh + h
  const int item = ih / kvh, h = ih - item * kvh;
  const int g0 = grp * G, gl = min(G, g - g0);         // this CTA's rows
  const pa::DecodeLayout lay(min(g, G), HD, split);
  // the query rows' loads first: nothing they need waits on another load
  const size_t q_off = ((size_t)ih * g + g0) * hd;
  float qv[kQ];
#pragma unroll
  for (int k = 0; k < kQ; ++k) {
    const int i = tid + k * pa::kThreads, dd = i % HD;
    qv[k] = i < gl * HD && dd < hd ? to_f32(q[q_off + (i / HD) * hd + dd])
                                   : 0.f;
  }
  if (split > 1)   // every CTA has started before a peer stores into it
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const int32_t* trow = table + (size_t)item * n_ptab;
  const int width = n_ptab * page_size;   // positions the table holds
  // one split starts at position 0: its first two chunks' table entries
  // load beside the length (thread t: positions t and kChunk + t)
  int pre[2] = {0, 0};
  if (split == 1) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int pos = k * pa::kChunk + tid;
      if (pos < width) pre[k] = trow[pos / page_size];
    }
  }
  const int len = max(min(lengths[item], width), 0);
  int lo, hi;
  pa::split_range(len, page_size, split, rank, &lo, &hi);
  const int n_chunks = (hi - lo + pa::kChunk - 1) / pa::kChunk;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int pos = lo + k * pa::kChunk + tid;
    if (pos < hi) {
      const int page_id = split == 1 ? pre[k] : trow[pos / page_size];
      reinterpret_cast<int*>(smem + k * lay.stage + lay.tok)[tid] =
          token_row(page_id, pos, page_size, kvh, h);
    }
  }
  __syncthreads();
  if (n_chunks > 0)
    stage_chunk<HD>(smem, lay, 0, min(pa::kChunk, hi - lo), hd, k_pages,
                    k_scale, v_pages, v_scale, tid);
  cp_async_commit();

  // the query rows, scaled in f32 and rounded to T
  float* s_q = reinterpret_cast<float*>(smem + lay.q);
  float* s_p = reinterpret_cast<float*>(smem + lay.p) + warp * gl * 32;
  T* round_tag = nullptr;
#pragma unroll
  for (int k = 0; k < kQ; ++k) {
    const int i = tid + k * pa::kThreads;
    if (i < gl * HD) s_q[i] = round_to(qv[k] * q_scale, round_tag);
  }

  // this warp's running max and sum of each row (the same in every
  // lane), and this lane's sums of its rows' words (four dd each)
  const int word = lane % kWordLanes, row0 = lane / kWordLanes;
  float m[G], l[G], acc[kRows][kLaneWords][4];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) { m[gi] = -INFINITY; l[gi] = 0.f; }
#pragma unroll
  for (int k = 0; k < kRows; ++k)
#pragma unroll
    for (int u = 0; u < kLaneWords; ++u)
      acc[k][u][0] = acc[k][u][1] = acc[k][u][2] = acc[k][u][3] = 0.f;

  for (int c = 0; c < n_chunks; ++c) {
    const int p0 = lo + c * pa::kChunk, n = min(pa::kChunk, hi - p0);
    __syncthreads();   // the stage of chunk c - 1 is free again
    if (c + 1 < n_chunks)
      stage_chunk<HD>(smem, lay, (c + 1) & 1,
                      min(pa::kChunk, hi - p0 - pa::kChunk), hd, k_pages,
                      k_scale, v_pages, v_scale, tid);
    cp_async_commit();
    // the table entry of chunk c + 2's position tid, in flight while this
    // chunk computes; its token row goes to stage c & 1 at the end
    const int pos2 = p0 + 2 * pa::kChunk + tid;
    const int page2 = pos2 < hi ? trow[pos2 / page_size] : 0;
    cp_async_wait_prior();   // chunk c has landed (this thread's copies)
    __syncthreads();
    const int nw = min(32, n - 32 * warp);   // this warp's positions
    if (nw > 0) {
      const char* base = smem + (c & 1) * lay.stage;
      const int8_t* s_k = reinterpret_cast<const int8_t*>(base + lay.k);
      const int8_t* s_v = reinterpret_cast<const int8_t*>(base + lay.v)
                          + 32 * warp * HD;
      const float* s_ks = reinterpret_cast<const float*>(base + lay.ks);
      const float* s_vs = reinterpret_cast<const float*>(base + lay.vs)
                          + 32 * warp;

      // scores of position tid: one fmaf chain over dd from 0 per row
      float s[G];
#pragma unroll
      for (int gi = 0; gi < G; ++gi) s[gi] = lane < nw ? 0.f : -INFINITY;
      if (lane < nw) {
        const float ksc = s_ks[tid];
        const int8_t* kr = s_k + tid * HD;
#pragma unroll
        for (int jc = 0; jc < HD / 16; ++jc) {
          const int4 raw = *reinterpret_cast<const int4*>(
              kr + ((jc ^ kswz<HD>(tid)) << 4));
          const unsigned words[4] = {
              raw.x ^ 0x80808080u, raw.y ^ 0x80808080u,
              raw.z ^ 0x80808080u, raw.w ^ 0x80808080u};
          // four dd at a time, the rows' chains interleaved
#pragma unroll
          for (int u4 = 0; u4 < 4; ++u4) {
            float kv[4];
#pragma unroll
            for (int u = 0; u < 4; ++u)
              kv[u] = __fmul_rn(code_f32(words[u4], u), ksc);
            float4 qq[G];
#pragma unroll
            for (int gi = 0; gi < G; ++gi)
              if (gi < gl)
                qq[gi] = *reinterpret_cast<const float4*>(
                    s_q + gi * HD + jc * 16 + 4 * u4);
#pragma unroll
            for (int gi = 0; gi < G; ++gi)
              if (gi < gl) s[gi] = fmaf(qq[gi].x, kv[0], s[gi]);
#pragma unroll
            for (int gi = 0; gi < G; ++gi)
              if (gi < gl) s[gi] = fmaf(qq[gi].y, kv[1], s[gi]);
#pragma unroll
            for (int gi = 0; gi < G; ++gi)
              if (gi < gl) s[gi] = fmaf(qq[gi].z, kv[2], s[gi]);
#pragma unroll
            for (int gi = 0; gi < G; ++gi)
              if (gi < gl) s[gi] = fmaf(qq[gi].w, kv[3], s[gi]);
          }
        }
      }
      // per row: the warp's max (xor tree), the online rescale, the
      // probabilities and their sum (xor tree)
      float corr[G];
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        corr[gi] = 1.f;
        if (gi < gl) {
          float mx = s[gi];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
          const float m_new = fmaxf(m[gi], mx);
          corr[gi] = expf(m[gi] - m_new);
          m[gi] = m_new;
          float pw = lane < nw ? expf(s[gi] - m_new) : 0.f;
          s_p[gi * 32 + lane] = pw;
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            pw = __fadd_rn(pw, __shfl_xor_sync(0xffffffffu, pw, off));
          l[gi] = __fadd_rn(__fmul_rn(l[gi], corr[gi]), pw);
        }
      }
      __syncwarp();
      // P.V: each of this lane's rows and words, four fmaf chains over
      // the warp's positions from 0, then acc = acc * corr + chain
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const int gi = row0 + k * kRowGroups;
        if (gi < gl) {
          float cr = 1.f;
#pragma unroll
          for (int r = 0; r < G; ++r)
            if (r == gi) cr = corr[r];
          const float* pr = s_p + gi * 32;
          float a[kLaneWords][4];
#pragma unroll
          for (int u = 0; u < kLaneWords; ++u)
            a[u][0] = a[u][1] = a[u][2] = a[u][3] = 0.f;
#pragma unroll 4
          for (int j = 0; j < nw; ++j) {
            const float pj = pr[j], vsc = s_vs[j];
#pragma unroll
            for (int u = 0; u < kLaneWords; ++u) {
              const unsigned vw = *reinterpret_cast<const unsigned*>(
                  s_v + j * HD + 4 * (word + u * kWordLanes)) ^ 0x80808080u;
              a[u][0] = fmaf(pj, __fmul_rn(code_f32(vw, 0), vsc), a[u][0]);
              a[u][1] = fmaf(pj, __fmul_rn(code_f32(vw, 1), vsc), a[u][1]);
              a[u][2] = fmaf(pj, __fmul_rn(code_f32(vw, 2), vsc), a[u][2]);
              a[u][3] = fmaf(pj, __fmul_rn(code_f32(vw, 3), vsc), a[u][3]);
            }
          }
#pragma unroll
          for (int u = 0; u < kLaneWords; ++u)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[k][u][e] = __fadd_rn(__fmul_rn(acc[k][u][e], cr), a[u][e]);
        }
      }
    }
    if (pos2 < hi)
      reinterpret_cast<int*>(smem + (c & 1) * lay.stage + lay.tok)[tid] =
          token_row(page2, pos2, page_size, kvh, h);
  }

  // the warps' (acc, m, l) into this CTA's slots (pa::slot_floats each),
  // then combined in warp order: out = sum_w acc_w e^(m_w - M) / sum_w
  // l_w e^(m_w - M)
  const int slot_len = pa::slot_floats(gl, HD), ml = gl * HD;
  float* wpart = reinterpret_cast<float*>(smem + lay.warps);
  float* mine = wpart + warp * slot_len;
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    if (lane == 0 && gi < gl) {
      mine[ml + gi] = m[gi];
      mine[ml + gl + gi] = l[gi];
    }
  }
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int gi = row0 + k * kRowGroups;
    if (gi < gl)
#pragma unroll
      for (int u = 0; u < kLaneWords; ++u)
        *reinterpret_cast<float4*>(
            mine + gi * HD + 4 * (word + u * kWordLanes)) =
            make_float4(acc[k][u][0], acc[k][u][1], acc[k][u][2],
                        acc[k][u][3]);
  }
  __syncthreads();
  // combine `parts` slots of (m, l, acc) at `src` for output o of row gi
  auto combine = [&](const float* src, int parts, int o, int gi,
                     float* m_out, float* l_out, float* a_out) {
    float mx = -INFINITY;
    for (int r = 0; r < parts; ++r)
      mx = fmaxf(mx, src[r * slot_len + ml + gi]);
    float a = 0.f, den = 0.f;
    if (mx != -INFINITY) {
      for (int r = 0; r < parts; ++r) {
        const float* sl = src + r * slot_len;
        const float w = expf(sl[ml + gi] - mx);
        den = __fadd_rn(den, __fmul_rn(sl[ml + gl + gi], w));
        a = __fadd_rn(a, __fmul_rn(sl[o], w));
      }
    }
    *m_out = mx;
    *l_out = den;
    *a_out = a;
  };
  // output o of the slots is dim o % HD of row o / HD; dims past hd
  // (the pad) are neither combined nor written
  T* dst = out + q_off;
  if (split == 1) {
    for (int o = tid; o < gl * HD; o += pa::kThreads) {
      if (o % HD >= hd) continue;
      float mx, den, a;
      combine(wpart, kWarps, o, o / HD, &mx, &den, &a);
      store(dst + (o / HD) * hd + o % HD, a / fmaxf(den, 1e-30f));
    }
    return;
  }
  // split: this CTA's (m, l, acc) into rank 0's slot `rank`, then rank 0
  // combines the slots in rank order
  cg::cluster_group cluster = cg::this_cluster();
  float* part = reinterpret_cast<float*>(smem + lay.part);
  float* slot = cluster.map_shared_rank(part, 0) + rank * slot_len;
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  for (int o = tid; o < gl * HD; o += pa::kThreads) {
    if (o % HD >= hd) continue;
    const int gi = o / HD;
    float mx, den, a;
    combine(wpart, kWarps, o, gi, &mx, &den, &a);
    slot[o] = a;
    if (o % HD == 0) {
      slot[ml + gi] = mx;
      slot[ml + gl + gi] = den;
    }
  }
  cluster.sync();
  if (rank != 0) return;
  for (int o = tid; o < gl * HD; o += pa::kThreads) {
    if (o % HD >= hd) continue;
    float mx, den, a;
    combine(part, split, o, o / HD, &mx, &den, &a);
    store(dst + (o / HD) * hd + o % HD, a / fmaxf(den, 1e-30f));
  }
}

// ------------------------------------------------------------- ragged

// d += a (16 x 16, row) * b (16 x 8, col), bf16 x bf16 -> f32.
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x (low half) and y as bf16, rounded to nearest, in one register.
__device__ __forceinline__ unsigned bf16x2(float x, float y) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const unsigned*>(&v);
}

// x and y as a bf16 high part (*hi) and the bf16 of the rest (*lo).
__device__ __forceinline__ void split_bf16x2(float x, float y, unsigned* hi,
                                             unsigned* lo) {
  *hi = bf16x2(x, y);
  const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(hi);
  *lo = bf16x2(x - __low2float(h), y - __high2float(h));
}

// The int8 codes k, k + 1 (k = 0 or 2) of the word wx (codes XOR 0x80)
// as exact bf16 in one register.
__device__ __forceinline__ unsigned codes_bf16x2(unsigned wx, int k) {
  return bf16x2(code_f32(wx, k), code_f32(wx, k + 1));
}

// The 4 x 4 byte block w0..w3 (rows) transposed: out[c] holds byte c of
// w0, w1, w2, w3, in that order.
__device__ __forceinline__ void transpose4(unsigned w0, unsigned w1,
                                           unsigned w2, unsigned w3,
                                           unsigned (&out)[4]) {
  const unsigned t0 = __byte_perm(w0, w1, 0x5140);
  const unsigned t1 = __byte_perm(w0, w1, 0x7362);
  const unsigned t2 = __byte_perm(w2, w3, 0x5140);
  const unsigned t3 = __byte_perm(w2, w3, 0x7362);
  out[0] = __byte_perm(t0, t2, 0x5410);
  out[1] = __byte_perm(t0, t2, 0x7632);
  out[2] = __byte_perm(t1, t3, 0x5410);
  out[3] = __byte_perm(t1, t3, 0x7632);
}

// The bf16 K rows (2 HD bytes) keep 16-byte piece L of row j at piece L ^
// kbswz(j, L), and the bf16 V^T rows (kRaggedChunk positions, 128 bytes)
// piece L of row dd at L ^ vtswz(dd): the two rows a quarter-warp's
// fragment loads read (lanes 4 gq .. 4 gq + 7: rows of both parities,
// each lane its own pieces) fall on eight distinct bank groups, and a
// transpose's writes (16 rows of one position block) on eight.
__device__ __forceinline__ int kbswz(int j, int piece) {
  return (j & 1) | (((piece >> 3) & 1) << 1);
}
__device__ __forceinline__ int vtswz(int dd) {
  return ((dd >> 2) & 7) ^ (dd & 1);
}

// A staged chunk's int8 codes of dims [dd0, dd0 + HG) as bf16 for the
// tensor cores (exact): K rows into s_kb (row j, dim dd0 + d at byte 2 d
// of its row, pieces swizzled by kbswz) and V transposed into s_vt (row d,
// position p at byte 2 p, pieces swizzled by vtswz), by 4 x 4 byte blocks
// of (positions 4 pb .. 4 pb + 3, d 4 db .. 4 db + 3); the staged rows
// hold HD bytes; by pa::kThreads threads, this one t.
template <int HD, int HG>
__device__ __forceinline__ void convert_chunk(const int8_t* s_k,
                                              const int8_t* s_v,
                                              char* s_kb, char* s_vt,
                                              int dd0, int t) {
  constexpr int kW = HG / 4;   // 4-byte words per converted row
  const int w0 = dd0 / 4;
  for (int e = t; e < pa::kRaggedChunk * kW; e += pa::kThreads) {
    const int w = e % kW, j = e / kW, ws = w0 + w;
    const unsigned wx = *reinterpret_cast<const unsigned*>(
        s_k + j * HD + (((ws >> 2) ^ kswz<HD>(j)) << 4) + 4 * (ws & 3))
        ^ 0x80808080u;
    const int piece = w >> 1;
    *reinterpret_cast<uint2*>(
        s_kb + j * 2 * HG + ((piece ^ kbswz(j, piece)) << 4)
        + 8 * (w & 1)) = make_uint2(codes_bf16x2(wx, 0),
                                    codes_bf16x2(wx, 2));
  }
  for (int e = t; e < pa::kRaggedChunk * kW / 4; e += pa::kThreads) {
    const int db = e % kW, pb = e / kW;
    const int8_t* src = s_v + (4 * pb) * HD + dd0 + 4 * db;
    unsigned col[4];
    transpose4(*reinterpret_cast<const unsigned*>(src),
               *reinterpret_cast<const unsigned*>(src + HD),
               *reinterpret_cast<const unsigned*>(src + 2 * HD),
               *reinterpret_cast<const unsigned*>(src + 3 * HD), col);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int dd = 4 * db + c, piece = pb >> 1;
      const unsigned wx = col[c] ^ 0x80808080u;
      *reinterpret_cast<uint2*>(
          s_vt + dd * 2 * pa::kRaggedChunk + ((piece ^ vtswz(dd)) << 4)
          + 8 * (pb & 1)) = make_uint2(codes_bf16x2(wx, 0),
                                       codes_bf16x2(wx, 2));
    }
  }
}

// The bf16 words of a lane's fragment run: logical pieces [first, first +
// n) of a row of s (row stride `pitch` bytes, pieces swizzled by swz),
// 4 words each.
template <int N, typename Swz>
__device__ __forceinline__ void load_run(const char* row, int first,
                                         Swz swz, unsigned (&w)[4 * N]) {
#pragma unroll
  for (int pc = 0; pc < N; ++pc) {
    const int piece = first + pc;
    const uint4 v = *reinterpret_cast<const uint4*>(
        row + ((piece ^ swz(piece)) << 4));
    w[4 * pc] = v.x;
    w[4 * pc + 1] = v.y;
    w[4 * pc + 2] = v.z;
    w[4 * pc + 3] = v.w;
  }
}

// Named barrier `id` (1 + a warp group) over the pa::kThreads threads of
// one warp group.
__device__ __forceinline__ void group_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(pa::kThreads) : "memory");
}

// q, out: (R, nq, kvh, g, hd); pages, scales, table and lengths as the
// decode kernel's; q_pos (R, nq); HD = pa::padded_hd(hd), the width of the
// staged rows (the query's dims past hd zero). Grid pa::ragged_plan's
// ctas, CTA x tile x % tiles of (item, head) x / tiles,
// pa::kRaggedThreads threads in pa::kRaggedGroups warp groups. Up to HD
// 128 group G takes chunks c = G, G + groups, ... of the tile (stage c %
// kStages, its own bf16 buffers) with all HG = HD dims and its own online
// softmax, and the groups' states are combined at the end in group order.
// Above 128 (pa::ragged_split_dd) both groups take every chunk, group G
// the HG = HD / 2 dims from dd0 = G HG of its rows' queries, codes and
// outputs: each adds its partial scores to the other's (through shared
// memory, so both hold the same sums) and runs the same softmax. Warp w of
// a group owns the tile's rows 16 w .. 16 w + 15, lane (gq = lane / 4, tq
// = lane % 4) the fragment rows gq and gq + 8 (rows rA, rB). Fragments
// (m16n8k16): the scores' inner index k of step s is dim dd0 + tq HG / 4 +
// 4 s + {0, 1} for k = 2 tq, 2 tq + 1 and + {2, 3} for k = 2 tq + 8, 2 tq
// + 9; score column c of n-tile j is position 16 (c / 2) + 2 j + c % 2 of
// the chunk, so lane (gq, tq) holds the scores of positions 16 tq + 2 j +
// {0, 1}; the P.V inner index of step s is position 16 tq + 4 s + {0, 1}
// (k = 2 tq, 2 tq + 1) and + {2, 3} (k = 2 tq + 8, 2 tq + 9): n-tiles 2 s
// and 2 s + 1 of the scores. Dynamic shared memory: pa::RaggedLayout(HD).
template <typename T, int HD>
__global__ void __launch_bounds__(pa::kRaggedThreads, 1)
    paged_attn_ragged_kernel(
        const T* __restrict__ q, const int8_t* __restrict__ k_pages,
        const float* __restrict__ k_scale,
        const int8_t* __restrict__ v_pages,
        const float* __restrict__ v_scale, const int32_t* __restrict__ table,
        int n_ptab, const int32_t* __restrict__ lengths,
        const int32_t* __restrict__ q_pos, int nq, int kvh, int g, int hd,
        int page_size, float q_scale, T* __restrict__ out) {
  constexpr bool kSplitDd = pa::ragged_split_dd(HD);
  constexpr int kGroups = pa::kRaggedGroups;
  constexpr int HG = kSplitDd ? HD / kGroups : HD;   // a group's dims
  constexpr int kSteps = HG / 16;   // k-steps of the scores
  constexpr int kQd = HG / 4;       // dd of a lane's fragment run
  constexpr int kDt = HG / 8;       // n-tiles of the output
  constexpr int kC = pa::kRaggedChunk;
  constexpr int kStages = pa::ragged_stages(HD);
  // chunks between a group's turns, chunks staged ahead of the one a
  // turn computes, and the threads that stage a chunk: a group's own
  // chunks, or every chunk by the whole CTA
  constexpr int kStride = kSplitDd ? 1 : kGroups;
  constexpr int kAhead = kSplitDd ? kStages - 1 : kGroups;
  constexpr int kTeam = kSplitDd ? pa::kRaggedThreads : pa::kThreads;
  constexpr int kParts = sizeof(T) == 4 ? 2 : 1;   // bf16 parts of q
  extern __shared__ float4 pa_smem[];
  char* smem = reinterpret_cast<char*>(pa_smem);
  __shared__ int s_hmax[pa::kWarps];
  const pa::RaggedLayout lay(HD);
  const int tid = threadIdx.x, grp = tid / pa::kThreads;
  const int gt = tid - grp * pa::kThreads;   // thread within its group
  const int lane = tid & 31, warp = gt >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int st = kSplitDd ? tid : gt;        // thread within its team
  const int dd0 = kSplitDd ? grp * HG : 0;   // this group's first dim
  // the barrier of the threads that share a stage
  auto team_sync = [grp]() {
    if constexpr (kSplitDd) __syncthreads();
    else group_sync(1 + grp);
  };
  const int tiles = (nq * g + pa::kRaggedRows - 1) / pa::kRaggedRows;
  const int tile = blockIdx.x % tiles, ih = blockIdx.x / tiles;
  int r_lo, r_hi;   // this tile's query rows
  pa::ragged_rows(nq, g, tile, &r_lo, &r_hi);
  const int item = ih / kvh, h = ih - item * kvh;
  const int32_t* trow = table + (size_t)item * n_ptab;
  const int width = n_ptab * page_size;   // positions the table holds
  // the first kStages chunks' table entries (position tid + k
  // kRaggedThreads) load beside the length and the rows' positions
  constexpr int kPre =
      (kStages * kC + pa::kRaggedThreads - 1) / pa::kRaggedThreads;
  int pre[kPre];
#pragma unroll
  for (int k = 0; k < kPre; ++k) {
    const int pos = tid + k * pa::kRaggedThreads;
    pre[k] = pos < width ? trow[pos / page_size] : 0;
  }
  const int len = max(min(lengths[item], width), 0);
  // this lane's rows rA, rB: horizon, output offset
  int hz[2];
  bool live[2];
  size_t off[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r_lo + warp * 16 + gq + 8 * i;
    live[i] = r < r_hi;
    const int qi = live[i] ? r / g : 0, gi = live[i] ? r - qi * g : 0;
    const int qp = live[i] ? q_pos[(size_t)item * nq + qi] : -1;
    hz[i] = qp >= 0 ? min(qp + 1, len) : 0;
    off[i] = ((((size_t)item * nq + qi) * kvh + h) * g + gi) * hd;
  }
  // the rows' A fragments, scaled in f32 and rounded to T (an f32 row as
  // bf16 high and low parts), zeros past hd; a0a1 / a2a3 rows rA / rB at
  // dims d0 + {0, 1}, a4a5 / a6a7 at d0 + {2, 3}, d0 = dd0 + tq HG / 4 + 4 s
  unsigned qa[kParts][kSteps][4];
  T* round_tag = nullptr;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      const int d0 = dd0 + tq * kQd + 4 * s;
      if (live[i] && d0 < hd) {
        const T* src = q + off[i] + d0;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[e] = round_to(to_f32(src[e]) * q_scale, round_tag);
      }
      if constexpr (kParts == 2) {
        split_bf16x2(v[0], v[1], &qa[0][s][i], &qa[1][s][i]);
        split_bf16x2(v[2], v[3], &qa[0][s][2 + i], &qa[1][s][2 + i]);
      } else {
        qa[0][s][i] = bf16x2(v[0], v[1]);
        qa[0][s][2 + i] = bf16x2(v[2], v[3]);
      }
    }
  }
  // where the groups split the dims, the fragments wait in shared memory
  // (each thread's own 16 bytes per part and step), so that a thread's
  // registers hold its outputs and the chunk's operands
  uint4* const qs = reinterpret_cast<uint4*>(smem + lay.q)
                    + grp * kParts * kSteps * pa::kThreads + gt;
  if constexpr (kSplitDd) {
#pragma unroll
    for (int part = 0; part < kParts; ++part)
#pragma unroll
      for (int s = 0; s < kSteps; ++s)
        qs[(part * kSteps + s) * pa::kThreads] =
            make_uint4(qa[part][s][0], qa[part][s][1], qa[part][s][2],
                       qa[part][s][3]);
  }

  // the tile's horizon: each warp's largest (both groups hold the same
  // rows), then the CTA's
  int hw = max(hz[0], hz[1]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    hw = max(hw, __shfl_xor_sync(0xffffffffu, hw, o));
  if (grp == 0 && lane == 0) s_hmax[warp] = hw;
  __syncthreads();
  int th = 0;
#pragma unroll
  for (int w = 0; w < pa::kWarps; ++w) th = max(th, s_hmax[w]);
  const int n_chunks = (th + kC - 1) / kC;
  // the token rows of the first kStages chunks (chunk c into stage c),
  // then the first chunks' copies: each group's first, or the first
  // kAhead
#pragma unroll
  for (int k = 0; k < kPre; ++k) {
    const int pos = tid + k * pa::kRaggedThreads;
    if (pos < th && pos < kStages * kC)
      reinterpret_cast<int*>(smem + (pos / kC) * lay.stage + lay.tok)[
          pos % kC] = token_row(pre[k], pos, page_size, kvh, h);
  }
  __syncthreads();
  if constexpr (kSplitDd) {
#pragma unroll
    for (int c = 0; c < kAhead; ++c) {
      if (c < n_chunks)
        stage_chunk<HD, kTeam>(smem, lay, c, min(kC, th - c * kC), hd,
                               k_pages, k_scale, v_pages, v_scale, st);
      cp_async_commit();
    }
  } else {
    if (grp < n_chunks)
      stage_chunk<HD>(smem, lay, grp, min(kC, th - grp * kC), hd, k_pages,
                      k_scale, v_pages, v_scale, gt);
    cp_async_commit();
  }

  // running max and (this lane's partial) sum of rows rA, rB over this
  // group's chunks; the output fragments: o[nt][2 i + e] is row i's dim
  // dd0 + nt * 8 + 2 tq + e
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  float o[kDt][4];
#pragma unroll
  for (int nt = 0; nt < kDt; ++nt)
    o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  char* s_kb = smem + lay.kb + grp * lay.group;
  char* s_vt = smem + lay.vt + grp * lay.group;

  const int c_first = kSplitDd ? 0 : grp;
  for (int c = c_first; c < n_chunks + c_first; c += kStride) {
    // c may pass the last chunk on a group's last turn: it then computes
    // nothing but keeps the group's barriers in step
    const int p0 = c * kC;
    team_sync();   // chunk c - kStride's stage and bf16 codes free
    const int next = c + kAhead;
    if (next < n_chunks)
      stage_chunk<HD, kTeam>(smem, lay, next % kStages,
                             min(kC, th - next * kC), hd, k_pages, k_scale,
                             v_pages, v_scale, st);
    cp_async_commit();
    // the table entry of chunk c + kStages's position st, in flight while
    // this chunk computes; its token row goes to stage c % kStages at the
    // end
    const int pos2 = (c + kStages) * kC + st;
    const int page2 = st < kC && pos2 < th ? trow[pos2 / page_size] : 0;
    cp_async_wait<kSplitDd ? kAhead : 1>();   // chunk c has landed
    team_sync();
    if (c < n_chunks) {
      const char* base = smem + (c % kStages) * lay.stage;
      const float* s_ks = reinterpret_cast<const float*>(base + lay.ks);
      const float* s_vs = reinterpret_cast<const float*>(base + lay.vs);
      convert_chunk<HD, HG>(reinterpret_cast<const int8_t*>(base + lay.k),
                            reinterpret_cast<const int8_t*>(base + lay.v),
                            s_kb, s_vt, dd0, gt);
      group_sync(1 + grp);

      // scores: n-tile j's column gq is this lane's K row, whose bf16 dims
      // [tq HG / 4, (tq + 1) HG / 4) of the group's are its HG / 32
      // pieces from tq HG / 32: words 2 s, 2 s + 1 the B registers of
      // step s (four n-tiles at a time, their products interleaved, so
      // that no product waits on the one before it)
      float sc[8][4];
#pragma unroll
      for (int j0 = 0; j0 < 8; j0 += 4) {
        if constexpr (kSplitDd) {
          // one piece of each n-tile's run at a time (piece pc: steps 2
          // pc, 2 pc + 1), each step's fragment loaded from shared memory
#pragma unroll
          for (int j = j0; j < j0 + 4; ++j)
            sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
          for (int pc = 0; pc < HG / 32; ++pc) {
            unsigned kw[4][4];
#pragma unroll
            for (int j = j0; j < j0 + 4; ++j) {
              const int kr = 16 * (gq >> 1) + 2 * j + (gq & 1);
              load_run<1>(s_kb + kr * 2 * HG, tq * (HG / 32) + pc,
                          [kr](int piece) { return kbswz(kr, piece); },
                          kw[j - j0]);
            }
#pragma unroll
            for (int s = 2 * pc; s < 2 * pc + 2; ++s)
#pragma unroll
              for (int part = 0; part < kParts; ++part) {
                const uint4 f = qs[(part * kSteps + s) * pa::kThreads];
                const unsigned a[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
                for (int j = j0; j < j0 + 4; ++j)
                  mma_bf16(sc[j], a, kw[j - j0][2 * (s - 2 * pc)],
                           kw[j - j0][2 * (s - 2 * pc) + 1]);
              }
          }
        } else {
          unsigned kw[4][2 * kSteps];
#pragma unroll
          for (int j = j0; j < j0 + 4; ++j) {
            sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
            const int kr = 16 * (gq >> 1) + 2 * j + (gq & 1);
            load_run<HG / 32>(s_kb + kr * 2 * HG, tq * (HG / 32),
                              [kr](int piece) { return kbswz(kr, piece); },
                              kw[j - j0]);
          }
#pragma unroll
          for (int s = 0; s < kSteps; ++s)
#pragma unroll
            for (int part = 0; part < kParts; ++part)
#pragma unroll
              for (int j = j0; j < j0 + 4; ++j)
                mma_bf16(sc[j], qa[part][s], kw[j - j0][2 * s],
                         kw[j - j0][2 * s + 1]);
        }
      }
      if constexpr (kSplitDd) {
        // each group's partial scores through shared memory, then each
        // lane adds its peer's (the same rows and positions) to its own:
        // IEEE addition commutes, so both groups hold the same sums
        float* xs = reinterpret_cast<float*>(smem + lay.x);
        float* mine = xs + grp * (32 * pa::kThreads);
        const float* peer = xs + (1 - grp) * (32 * pa::kThreads);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            mine[(4 * j + e) * pa::kThreads + gt] = sc[j][e];
        __syncthreads();
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sc[j][e] = __fadd_rn(sc[j][e],
                                 peer[(4 * j + e) * pa::kThreads + gt]);
      }
      // this lane's 16 positions' K and V scales
      const float* ksc = s_ks + 16 * tq;
      const float* vsc = s_vs + 16 * tq;
      // per row: scale, causal mask, the quad's max, online rescale, the
      // probabilities (0 where masked) and this lane's sum of them
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int lim = hz[i] - p0 - 16 * tq;   // valid while idx < lim
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int idx = 2 * j + e;
            const float sv =
                idx < lim ? sc[j][2 * i + e] * ksc[idx] : -INFINITY;
            sc[j][2 * i + e] = sv;
            mx = fmaxf(mx, sv);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run[i], mx);
        const float corr =
            m_new == -INFINITY ? 1.f : __expf(m_run[i] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float sv = sc[j][2 * i + e];
            const float pw = sv == -INFINITY ? 0.f : __expf(sv - m_new);
            sc[j][2 * i + e] = pw;
            sum += pw;
          }
        l_run[i] = __fadd_rn(__fmul_rn(l_run[i], corr), sum);
        m_run[i] = m_new;
#pragma unroll
        for (int nt = 0; nt < kDt; ++nt) {
          o[nt][2 * i] *= corr;
          o[nt][2 * i + 1] *= corr;
        }
      }
      // P.V: the A fragments of p * v_scale (bf16 high and low parts) for
      // the 4 steps of 16 positions, then each output n-tile against its
      // bf16 V^T row (a lane's 16 positions: pieces 2 tq, 2 tq + 1; words
      // 2 s, 2 s + 1 the B registers of step s)
      unsigned pf[4][2][4];   // [step][high, low][a register]
#pragma unroll
      for (int s = 0; s < 4; ++s)
#pragma unroll
        for (int hx = 0; hx < 2; ++hx)        // n-tile 2 s + hx
#pragma unroll
          for (int i = 0; i < 2; ++i) {       // rows rA, rB
            const int idx = 4 * s + 2 * hx;
            const float p0v = sc[2 * s + hx][2 * i];
            const float p1v = sc[2 * s + hx][2 * i + 1];
            const float w0 = p0v == 0.f ? 0.f : p0v * vsc[idx];
            const float w1 = p1v == 0.f ? 0.f : p1v * vsc[idx + 1];
            split_bf16x2(w0, w1, &pf[s][0][2 * hx + i],
                         &pf[s][1][2 * hx + i]);
          }
      // (four output n-tiles at a time, their products interleaved)
#pragma unroll
      for (int n0 = 0; n0 < kDt; n0 += 4) {
        unsigned vw[4][8];
#pragma unroll
        for (int nt = n0; nt < n0 + 4; ++nt) {
          const int dd = nt * 8 + gq;
          const int sw = vtswz(dd);
          load_run<2>(s_vt + dd * 2 * kC, 2 * tq, [sw](int) { return sw; },
                      vw[nt - n0]);
        }
#pragma unroll
        for (int s = 0; s < 4; ++s)
#pragma unroll
          for (int part = 0; part < 2; ++part)
#pragma unroll
            for (int nt = n0; nt < n0 + 4; ++nt)
              mma_bf16(o[nt], pf[s][part], vw[nt - n0][2 * s],
                       vw[nt - n0][2 * s + 1]);
      }
    }
    if (st < kC && pos2 < th)
      reinterpret_cast<int*>(smem + (c % kStages) * lay.stage + lay.tok)[st] =
          token_row(page2, pos2, page_size, kvh, h);
  }

  if constexpr (!kSplitDd) {
    // the groups' states, combined in group order by group 0: group G > 0
    // leaves (m, l, o) of its lanes in the stage memory, no copy in flight
    cp_async_wait_all();
    __syncthreads();
    constexpr int kSlot = 4 + 4 * kDt;   // floats of one lane's state
    float* part = reinterpret_cast<float*>(smem);
    if (grp > 0) {
      float* mine = part + ((grp - 1) * pa::kThreads + gt) * kSlot;
      mine[0] = m_run[0];
      mine[1] = m_run[1];
      mine[2] = l_run[0];
      mine[3] = l_run[1];
#pragma unroll
      for (int nt = 0; nt < kDt; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) mine[4 + 4 * nt + e] = o[nt][e];
    }
    __syncthreads();
    if (grp > 0) return;
#pragma unroll
    for (int gr = 1; gr < kGroups; ++gr) {
      const float* peer = part + ((gr - 1) * pa::kThreads + gt) * kSlot;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float mp = peer[i], mx = fmaxf(m_run[i], mp);
        const float e0 = mx == -INFINITY ? 0.f : __expf(m_run[i] - mx);
        const float e1 = mx == -INFINITY ? 0.f : __expf(mp - mx);
        l_run[i] = __fadd_rn(__fmul_rn(l_run[i], e0),
                             __fmul_rn(peer[2 + i], e1));
#pragma unroll
        for (int nt = 0; nt < kDt; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            o[nt][2 * i + e] =
                __fadd_rn(__fmul_rn(o[nt][2 * i + e], e0),
                          __fmul_rn(peer[4 + 4 * nt + 2 * i + e], e1));
        m_run[i] = mx;
      }
    }
  }
  // each row: the quad's sum (the same tree in every lane), then out =
  // acc / max(l, 1e-30) at this group's dims below hd, zeros for a row
  // with no valid position
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l = __fadd_rn(l, __shfl_xor_sync(0xffffffffu, l, 1));
    l = __fadd_rn(l, __shfl_xor_sync(0xffffffffu, l, 2));
    if (!live[i]) continue;
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int nt = 0; nt < kDt; ++nt) {
      const int dd = dd0 + nt * 8 + 2 * tq;
      if (dd >= hd) continue;
      T* dst = out + off[i] + dd;
      store(dst, hz[i] > 0 ? o[nt][2 * i] / den : 0.f);
      store(dst + 1, hz[i] > 0 ? o[nt][2 * i + 1] / den : 0.f);
    }
  }
}

// Opt the decode kernel <T, HD, G> into `smem` bytes of dynamic shared
// memory where it needs more than the default 48 KiB; once per size
// reached, so a steady state (and a graph capture) sets no attribute.
template <typename T, int HD, int G>
cudaError_t opt_in(int smem) {
  static int granted = 48 * 1024;
  if (smem <= granted) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      paged_attn_decode_kernel<T, HD, G>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) granted = smem;
  return err;
}

template <typename T, int HD, int G>
cudaError_t launch_decode(const void* q, const void* kp, const void* ks,
                          const void* vp, const void* vs, const void* table,
                          int n_ptab, const void* lengths, int kvh, int g,
                          int hd, int page_size, float q_scale,
                          const pa::DecodePlan& p, void* out,
                          cudaStream_t stream) {
  auto kernel = paged_attn_decode_kernel<T, HD, G>;
  cudaError_t err = opt_in<T, HD, G>(p.smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.ctas);
  cfg.blockDim = dim3(pa::kThreads);
  cfg.dynamicSmemBytes = (size_t)p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  if (p.split > 1) {
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = p.split;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
  return cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(q), static_cast<const int8_t*>(kp),
      static_cast<const float*>(ks), static_cast<const int8_t*>(vp),
      static_cast<const float*>(vs), static_cast<const int32_t*>(table),
      n_ptab, static_cast<const int32_t*>(lengths), kvh, g, hd, page_size,
      p.split, q_scale, static_cast<T*>(out));
}

// The kernel for head dim hd (built at its pa::padded_hd) and a CTA's
// rows: up to 2 (the serving shapes, g 2) or up to pa::kMaxG.
template <typename T>
cudaError_t launch_decode_hd(int hd, const void* q, const void* kp,
                             const void* ks, const void* vp, const void* vs,
                             const void* table, int n_ptab,
                             const void* lengths, int kvh, int g,
                             int page_size, float q_scale,
                             const pa::DecodePlan& p, void* out,
                             cudaStream_t stream) {
#define REPRO_DECODE_ARGS                                                  \
  q, kp, ks, vp, vs, table, n_ptab, lengths, kvh, g, hd, page_size,        \
      q_scale, p, out, stream
#define REPRO_DECODE_G(HD)                                                 \
  (g <= 2 ? launch_decode<T, HD, 2>(REPRO_DECODE_ARGS)                     \
          : launch_decode<T, HD, pa::kMaxG>(REPRO_DECODE_ARGS))
  switch (pa::padded_hd(hd)) {
    case 32: return REPRO_DECODE_G(32);
    case 64: return REPRO_DECODE_G(64);
    case 128: return REPRO_DECODE_G(128);
    case 256: return REPRO_DECODE_G(256);
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_DECODE_G
#undef REPRO_DECODE_ARGS
}

template <typename T, int HD>
cudaError_t launch_ragged(const void* q, const void* kp, const void* ks,
                          const void* vp, const void* vs, const void* table,
                          int n_ptab, const void* lengths, const void* q_pos,
                          int nq, int kvh, int g, int hd, int page_size,
                          float q_scale, const pa::RaggedPlan& p, void* out,
                          cudaStream_t stream) {
  // opt in above the default 48 KiB once per size reached, so a steady
  // state (and a graph capture) sets no attribute
  auto kernel = paged_attn_ragged_kernel<T, HD>;
  static int granted = pa::kDefaultSmem;
  if (p.smem > granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return err;
    granted = p.smem;
  }
  kernel<<<p.ctas, pa::kRaggedThreads, (size_t)p.smem, stream>>>(
      static_cast<const T*>(q), static_cast<const int8_t*>(kp),
      static_cast<const float*>(ks), static_cast<const int8_t*>(vp),
      static_cast<const float*>(vs), static_cast<const int32_t*>(table),
      n_ptab, static_cast<const int32_t*>(lengths),
      static_cast<const int32_t*>(q_pos), nq, kvh, g, hd, page_size, q_scale,
      static_cast<T*>(out));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_ragged_hd(int hd, const void* q, const void* kp,
                             const void* ks, const void* vp, const void* vs,
                             const void* table, int n_ptab,
                             const void* lengths, const void* q_pos, int nq,
                             int kvh, int g, int page_size, float q_scale,
                             const pa::RaggedPlan& p, void* out,
                             cudaStream_t stream) {
#define REPRO_RAGGED_ARGS                                                  \
  q, kp, ks, vp, vs, table, n_ptab, lengths, q_pos, nq, kvh, g, hd,        \
      page_size, q_scale, p, out, stream
  switch (pa::padded_hd(hd)) {
    case 32: return launch_ragged<T, 32>(REPRO_RAGGED_ARGS);
    case 64: return launch_ragged<T, 64>(REPRO_RAGGED_ARGS);
    case 128: return launch_ragged<T, 128>(REPRO_RAGGED_ARGS);
    case 256: return launch_ragged<T, 256>(REPRO_RAGGED_ARGS);
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_RAGGED_ARGS
}

}  // namespace

// Ragged (mixed q_len) entry: q (R, nq, kvh, g, hd), q_pos (R, nq). One
// launch on the plan of pa::ragged_plan (attention_plan.h); a shape the
// plan does not take returns cudaErrorInvalidValue. Returns the launch's
// CUDA error.
extern "C" int paged_attention_ragged(
    const void* q, int q_is_bf16, const void* k_pages, const void* k_scale,
    const void* v_pages, const void* v_scale, const void* table, int n_ptab,
    const void* lengths, const void* q_pos, int n_items, int nq, int kvh,
    int g, int hd, int page_size, float q_scale, void* out,
    void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  pa::RaggedPlan p;
  if (!pa::ragged_plan(n_items, nq, kvh, g, hd, page_size,
                       pa::device_smem_optin(), &p))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = q_is_bf16
      ? launch_ragged_hd<__nv_bfloat16>(hd, q, k_pages, k_scale, v_pages,
                                        v_scale, table, n_ptab, lengths,
                                        q_pos, nq, kvh, g, page_size,
                                        q_scale, p, out, stream)
      : launch_ragged_hd<float>(hd, q, k_pages, k_scale, v_pages, v_scale,
                                table, n_ptab, lengths, q_pos, nq, kvh, g,
                                page_size, q_scale, p, out, stream);
  return (int)err;
}

// Decode (q_len = 1) entry: q (B, kvh, g, hd); row b attends p <
// lengths[b]. One launch on the plan of pa::decode_plan (attention_plan.h)
// for a card of ``sms`` SMs with ``split`` CTAs per (item, KV head, row
// group) (0: the plan's own). A shape the plan does not take returns
// cudaErrorInvalidValue. Returns the launch's CUDA error.
extern "C" int paged_attention_decode(
    const void* q, int q_is_bf16, const void* k_pages, const void* k_scale,
    const void* v_pages, const void* v_scale, const void* table, int n_ptab,
    const void* lengths, int n_items, int kvh, int g, int hd, int page_size,
    float q_scale, int sms, int split, void* out, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  pa::DecodePlan p;
  if (!pa::decode_plan(n_items, kvh, g, hd, page_size, n_ptab, sms,
                       pa::device_smem_optin(), split, &p))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = q_is_bf16
      ? launch_decode_hd<__nv_bfloat16>(hd, q, k_pages, k_scale, v_pages,
                                        v_scale, table, n_ptab, lengths,
                                        kvh, g, page_size, q_scale, p, out,
                                        stream)
      : launch_decode_hd<float>(hd, q, k_pages, k_scale, v_pages, v_scale,
                                table, n_ptab, lengths, kvh, g, page_size,
                                q_scale, p, out, stream);
  return (int)err;
}
