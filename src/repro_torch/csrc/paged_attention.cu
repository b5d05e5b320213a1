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
// Ragged (paged_attn_ragged_kernel): one CTA per (work item, KV head,
// block of 128 query rows); it walks the item's page-table row, stages
// each K/V page of its head in shared memory dequantized to f32, and every
// thread carries one query row's online-softmax state (m, l, acc[hd]) in
// f32 registers. A query row attends kv positions p with p <= q_pos and p
// < length; q_pos < 0 marks a padding row, whose output is written as
// zeros, and a CTA whose rows are all padding reads no page.
//
// Bound on this card: the int8 page bytes of the attended prefix plus
// their scales, over HBM bandwidth. Decode reads each byte once per (item,
// KV head) and keeps scores and softmax state on chip; below ~1k positions
// per item its time is the chain of dependent phases (the first chunk's
// load, the hd-long score chain, two reductions, the chunk-long P.V
// chain), which the split shortens at long prefixes while filling the
// card. The ragged kernel streams each page once per (item, head, row
// block) but runs one position at a time per query row.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

#include "attention_plan.h"

namespace {

namespace cg = cooperative_groups;

constexpr int kRows = 128;   // ragged: query rows (and threads) per CTA

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

// q, out: (R, nq, kvh, g, HD); pages: (n_pages, page_size, kvh, HD) int8;
// scales: (n_pages, page_size, kvh, 1) f32; table (R, n_ptab) int32;
// lengths (R,) int32; q_pos (R, nq) int32.
// Dynamic shared memory: 2 * page_size * HD floats.
template <typename T, int HD>
__global__ void paged_attn_ragged_kernel(
    const T* __restrict__ q, const int8_t* __restrict__ k_pages,
    const float* __restrict__ k_scale, const int8_t* __restrict__ v_pages,
    const float* __restrict__ v_scale, const int32_t* __restrict__ table,
    int n_ptab, const int32_t* __restrict__ lengths,
    const int32_t* __restrict__ q_pos, int nq, int kvh, int g,
    int page_size, float q_scale, T* __restrict__ out) {
  extern __shared__ float4 pa_smem[];
  float* s_k = reinterpret_cast<float*>(pa_smem);
  float* s_v = s_k + page_size * HD;
  __shared__ int s_horizon;
  const int item = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x;
  const int r = blockIdx.z * kRows + tid;
  const bool active = r < nq * g;
  const int qi = active ? r / g : 0;
  const int gi = active ? r - qi * g : 0;
  const int len = lengths[item];
  const int qpos = active ? q_pos[item * nq + qi] : -1;
  const int horizon = qpos >= 0 ? min(qpos + 1, len) : 0;
  if (tid == 0) s_horizon = 0;
  __syncthreads();
  if (horizon > 0) atomicMax(&s_horizon, horizon);
  __syncthreads();
  const int cta_horizon = s_horizon;
  const size_t row_off = ((((size_t)item * nq + qi) * kvh + h) * g + gi) * HD;
  if (cta_horizon == 0) {
    if (active) {
      for (int dd = 0; dd < HD; ++dd) store(out + row_off + dd, 0.f);
    }
    return;
  }
  T* round_tag = nullptr;
  float qv[HD], acc[HD];
#pragma unroll
  for (int dd = 0; dd < HD; ++dd) {
    qv[dd] = active ? round_to(to_f32(q[row_off + dd]) * q_scale, round_tag)
                    : 0.f;
    acc[dd] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  const int n_pages = min((cta_horizon + page_size - 1) / page_size, n_ptab);
  const int32_t* trow = table + (size_t)item * n_ptab;
  for (int p = 0; p < n_pages; ++p) {
    const size_t page = (size_t)trow[p];
    __syncthreads();
    for (int idx = tid; idx < page_size * HD; idx += kRows) {
      const int row = idx / HD, dd = idx - row * HD;
      const size_t tok = (page * page_size + row) * kvh + h;
      s_k[idx] = (float)k_pages[tok * HD + dd] * k_scale[tok];
      s_v[idx] = (float)v_pages[tok * HD + dd] * v_scale[tok];
    }
    __syncthreads();
    const int j_end = min(page_size, horizon - p * page_size);
    for (int j = 0; j < j_end; ++j) {
      const float* kr = s_k + j * HD;
      const float* vr = s_v + j * HD;
      float s = 0.f;
#pragma unroll
      for (int dd = 0; dd < HD; ++dd) s = fmaf(qv[dd], kr[dd], s);
      const float m_new = fmaxf(m, s);
      const float corr = expf(m - m_new);
      const float pw = expf(s - m_new);
      l = l * corr + pw;
#pragma unroll
      for (int dd = 0; dd < HD; ++dd) acc[dd] = fmaf(pw, vr[dd], acc[dd] * corr);
      m = m_new;
    }
  }
  if (active) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int dd = 0; dd < HD; ++dd) {
      store(out + row_off + dd, horizon > 0 ? acc[dd] * inv : 0.f);
    }
  }
}

// ------------------------------------------------------------- decode

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
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
// distinct 16-byte bank groups.
template <int HD>
__device__ __forceinline__ int kswz(int j) {
  constexpr int cpr = HD / 16, per_line = 8 / cpr;
  return (j / per_line) & (cpr - 1);
}

// The token-head row of key position pos: ((page * page_size + row) *
// kvh + h), page the table's entry `page_id`.
__device__ __forceinline__ int token_row(int page_id, int pos, int page_size,
                                         int kvh, int h) {
  return (page_id * page_size + pos % page_size) * kvh + h;
}

// Issue the cp.async copies of the n positions of stage `st`, whose token
// rows are the stage's tok[]: K rows swizzled, V rows as they are, and the
// f32 scales.
template <int HD>
__device__ __forceinline__ void stage_chunk(
    char* smem, const pa::DecodeLayout& lay, int st, int n,
    const int8_t* __restrict__ k_pages, const float* __restrict__ k_scale,
    const int8_t* __restrict__ v_pages, const float* __restrict__ v_scale) {
  constexpr int cpr = HD / 16;
  char* base = smem + st * lay.stage;
  int8_t* s_k = reinterpret_cast<int8_t*>(base + lay.k);
  int8_t* s_v = reinterpret_cast<int8_t*>(base + lay.v);
  float* s_ks = reinterpret_cast<float*>(base + lay.ks);
  float* s_vs = reinterpret_cast<float*>(base + lay.vs);
  const int* s_tok = reinterpret_cast<const int*>(base + lay.tok);
  for (int e = threadIdx.x; e < n * cpr; e += pa::kThreads) {
    const int j = e / cpr, jc = e - j * cpr;
    const size_t row = (size_t)s_tok[j] * HD + jc * 16;
    cp_async16(s_k + j * HD + ((jc ^ kswz<HD>(j)) << 4), k_pages + row);
    cp_async16(s_v + j * HD + (jc << 4), v_pages + row);
  }
  for (int j = threadIdx.x; j < n; j += pa::kThreads) {
    cp_async4(s_ks + j, k_scale + s_tok[j]);
    cp_async4(s_vs + j, v_scale + s_tok[j]);
  }
}

// q, out: (B, kvh, g, HD); pages, scales, table and lengths as the ragged
// kernel's. Grid (B * kvh * groups * split) in clusters of split along x,
// pa::kThreads threads; CTA x is split rank x % split of (item, head,
// group) x / split, its rows g0 .. g0 + gl - 1 (gl <= G). Warp w takes
// positions [32 w, 32 w + 32) of every chunk: lane = position for the
// scores, its own running (m, l) per row, and for P.V lane owns word
// lane % (HD / 4) (four dd) of the rows lane / (HD / 4) + k * 128 / HD.
// Dynamic shared memory: pa::DecodeLayout(gl, HD, split).
template <typename T, int HD, int G>
__global__ void __launch_bounds__(pa::kThreads) paged_attn_decode_kernel(
    const T* __restrict__ q, const int8_t* __restrict__ k_pages,
    const float* __restrict__ k_scale, const int8_t* __restrict__ v_pages,
    const float* __restrict__ v_scale, const int32_t* __restrict__ table,
    int n_ptab, const int32_t* __restrict__ lengths, int kvh, int g,
    int page_size, int split, float q_scale, T* __restrict__ out) {
  constexpr int kWarps = pa::kThreads / 32;
  constexpr int kWordLanes = HD / 4;                 // lanes per row: 8..32
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
  const size_t q_off = ((size_t)ih * g + g0) * HD;
  float qv[kQ];
#pragma unroll
  for (int k = 0; k < kQ; ++k) {
    const int i = tid + k * pa::kThreads;
    qv[k] = i < gl * HD ? to_f32(q[q_off + i]) : 0.f;
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
    stage_chunk<HD>(smem, lay, 0, min(pa::kChunk, hi - lo), k_pages,
                    k_scale, v_pages, v_scale);
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
  // lane), and this lane's sums of its rows' four dd
  const int word = lane % kWordLanes, row0 = lane / kWordLanes;
  float m[G], l[G], acc[kRows][4];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) { m[gi] = -INFINITY; l[gi] = 0.f; }
#pragma unroll
  for (int k = 0; k < kRows; ++k)
    acc[k][0] = acc[k][1] = acc[k][2] = acc[k][3] = 0.f;

  for (int c = 0; c < n_chunks; ++c) {
    const int p0 = lo + c * pa::kChunk, n = min(pa::kChunk, hi - p0);
    __syncthreads();   // the stage of chunk c - 1 is free again
    if (c + 1 < n_chunks)
      stage_chunk<HD>(smem, lay, (c + 1) & 1,
                      min(pa::kChunk, hi - p0 - pa::kChunk), k_pages,
                      k_scale, v_pages, v_scale);
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
      // P.V: each of this lane's rows, four fmaf chains over the warp's
      // positions from 0, then acc = acc * corr + chain
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const int gi = row0 + k * kRowGroups;
        if (gi < gl) {
          float cr = 1.f;
#pragma unroll
          for (int r = 0; r < G; ++r)
            if (r == gi) cr = corr[r];
          const float* pr = s_p + gi * 32;
          float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll 4
          for (int j = 0; j < nw; ++j) {
            const unsigned vw =
                *reinterpret_cast<const unsigned*>(s_v + j * HD + 4 * word)
                ^ 0x80808080u;
            const float pj = pr[j], vsc = s_vs[j];
            a0 = fmaf(pj, __fmul_rn(code_f32(vw, 0), vsc), a0);
            a1 = fmaf(pj, __fmul_rn(code_f32(vw, 1), vsc), a1);
            a2 = fmaf(pj, __fmul_rn(code_f32(vw, 2), vsc), a2);
            a3 = fmaf(pj, __fmul_rn(code_f32(vw, 3), vsc), a3);
          }
          acc[k][0] = __fadd_rn(__fmul_rn(acc[k][0], cr), a0);
          acc[k][1] = __fadd_rn(__fmul_rn(acc[k][1], cr), a1);
          acc[k][2] = __fadd_rn(__fmul_rn(acc[k][2], cr), a2);
          acc[k][3] = __fadd_rn(__fmul_rn(acc[k][3], cr), a3);
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
      *reinterpret_cast<float4*>(mine + gi * HD + 4 * word) =
          make_float4(acc[k][0], acc[k][1], acc[k][2], acc[k][3]);
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
  T* dst = out + q_off;
  if (split == 1) {
    for (int o = tid; o < gl * HD; o += pa::kThreads) {
      float mx, den, a;
      combine(wpart, kWarps, o, o / HD, &mx, &den, &a);
      store(dst + o, a / fmaxf(den, 1e-30f));
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
    float mx, den, a;
    combine(part, split, o, o / HD, &mx, &den, &a);
    store(dst + o, a / fmaxf(den, 1e-30f));
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
                          int page_size, float q_scale,
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
      n_ptab, static_cast<const int32_t*>(lengths), kvh, g, page_size,
      p.split, q_scale, static_cast<T*>(out));
}

// The kernel for head dim hd and a CTA's rows: up to 2 (the serving
// shapes, g 2) or up to pa::kMaxG.
template <typename T>
cudaError_t launch_decode_hd(int hd, const void* q, const void* kp,
                             const void* ks, const void* vp, const void* vs,
                             const void* table, int n_ptab,
                             const void* lengths, int kvh, int g,
                             int page_size, float q_scale,
                             const pa::DecodePlan& p, void* out,
                             cudaStream_t stream) {
#define REPRO_DECODE_ARGS                                                  \
  q, kp, ks, vp, vs, table, n_ptab, lengths, kvh, g, page_size, q_scale, p, \
      out, stream
#define REPRO_DECODE_G(HD)                                                 \
  (g <= 2 ? launch_decode<T, HD, 2>(REPRO_DECODE_ARGS)                     \
          : launch_decode<T, HD, pa::kMaxG>(REPRO_DECODE_ARGS))
  switch (hd) {
    case 32: return REPRO_DECODE_G(32);
    case 64: return REPRO_DECODE_G(64);
    case 128: return REPRO_DECODE_G(128);
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_DECODE_G
#undef REPRO_DECODE_ARGS
}

template <typename T, int HD>
cudaError_t launch_ragged(const void* q, const void* kp, const void* ks,
                          const void* vp, const void* vs, const void* table,
                          int n_ptab, const void* lengths, const void* q_pos,
                          int n_items, int nq, int kvh, int g, int page_size,
                          float q_scale, void* out, cudaStream_t stream) {
  dim3 grid(n_items, kvh, (nq * g + kRows - 1) / kRows);
  const size_t smem = sizeof(float) * 2 * (size_t)page_size * HD;
  paged_attn_ragged_kernel<T, HD><<<grid, kRows, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const int8_t*>(kp),
      static_cast<const float*>(ks), static_cast<const int8_t*>(vp),
      static_cast<const float*>(vs), static_cast<const int32_t*>(table),
      n_ptab, static_cast<const int32_t*>(lengths),
      static_cast<const int32_t*>(q_pos), nq, kvh, g, page_size, q_scale,
      static_cast<T*>(out));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_ragged_hd(int hd, const void* q, const void* kp,
                             const void* ks, const void* vp, const void* vs,
                             const void* table, int n_ptab,
                             const void* lengths, const void* q_pos,
                             int n_items, int nq, int kvh, int g,
                             int page_size, float q_scale, void* out,
                             cudaStream_t stream) {
#define REPRO_RAGGED_ARGS                                                  \
  q, kp, ks, vp, vs, table, n_ptab, lengths, q_pos, n_items, nq, kvh, g,   \
      page_size, q_scale, out, stream
  switch (hd) {
    case 32: return launch_ragged<T, 32>(REPRO_RAGGED_ARGS);
    case 64: return launch_ragged<T, 64>(REPRO_RAGGED_ARGS);
    case 128: return launch_ragged<T, 128>(REPRO_RAGGED_ARGS);
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_RAGGED_ARGS
}

}  // namespace

// Ragged (mixed q_len) entry: q (R, nq, kvh, g, hd), q_pos (R, nq).
extern "C" int paged_attention_ragged(
    const void* q, int q_is_bf16, const void* k_pages, const void* k_scale,
    const void* v_pages, const void* v_scale, const void* table, int n_ptab,
    const void* lengths, const void* q_pos, int n_items, int nq, int kvh,
    int g, int hd, int page_size, float q_scale, void* out,
    void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err = q_is_bf16
      ? launch_ragged_hd<__nv_bfloat16>(hd, q, k_pages, k_scale, v_pages,
                                        v_scale, table, n_ptab, lengths,
                                        q_pos, n_items, nq, kvh, g,
                                        page_size, q_scale, out, stream)
      : launch_ragged_hd<float>(hd, q, k_pages, k_scale, v_pages, v_scale,
                                table, n_ptab, lengths, q_pos, n_items, nq,
                                kvh, g, page_size, q_scale, out, stream);
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
