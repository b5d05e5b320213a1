"""Paged attention over the int8 KV page pool.

Replaces the Pallas TPU kernels ``paged_attention_ragged`` and
``paged_attention_decode`` of ``src/repro/kernels/paged_attention.py``.
The CUDA source is ``src/repro_torch/csrc/paged_attention.cu``.

- Decode: one CTA per (item, KV head, up to 8 query rows) walks the
  item's key positions in chunks of 128, their int8 K/V rows staged by
  16-byte ``cp.async`` into a two-stage ring; each thread scores one
  position for every query row, the chunk's max and sum come by warp
  shuffles, and threads owning (row, dd) outputs sum the chunk's P·V.
  Where the table allows long prefixes, a thread-block cluster of CTAs
  splits the item's positions and rank 0 combines their partial softmax
  states in rank order; the number of splits hangs on the table's width
  alone, never on the batch, so a row's bits do not depend on the rows
  launched beside it. The split rule
  and the shared-memory layout are the CUDA source's
  (``csrc/attention_plan.h``; ``decode_plan`` and ``split_range`` read
  them). Every sum has a fixed order, so equal inputs give equal bits.
- Ragged: one CTA per (work item, KV head, tile of 64 query rows), two
  warp groups of four warps taking turns at the item's positions in
  chunks of 64 up to the tile's largest horizon (never past it), staged
  as int8 like decode's and turned into bf16 in shared memory;
  the scores and P·V run on the tensor cores (``mma.sync`` bf16 -> f32:
  int8 codes exact in bf16, an f32 q split into bf16 high and low parts,
  the K scale applied to each score column, the V scale folded into the
  probabilities, which are split likewise), with an online softmax per
  row in registers, the groups combined in order. Its tile and chunk
  sizes and layout are ``csrc/attention_plan.h``'s (``ragged_plan`` and
  ``ragged_rows`` read them); every sum has a fixed order, so equal
  inputs give equal bits.

Both take every head dim that is a multiple of 8 from 8 to 256, built at
32, 64, 128 or 256 (``padded_hd`` in the header): K and V rows are staged
at that width, the query's dims past hd are zero (so the pad adds exact
zeros to every score) and only hd dims are written. Above 128 the ragged
kernel's two warp groups split the head dims instead of the chunks. The
plans refuse any other head dim, and so does the launch (no fallback).

What bounds both on the H100 is the page bytes of the attended prefix
(int8 codes + f32 scales) over HBM bandwidth: decode reads each once per
(item, KV head), the ragged kernel once per (item, head, row tile).

Contracts (as in the reference):

    q           (R, Q, KVH, g, hd) per-item query blocks (decode: (B, KVH,
                g, hd)), scaled by hd^-½ in f32 and rounded back to q's
                dtype inside the kernel
    k/v_pages   (n_pages, G, KVH, hd) int8 codes
    k/v_scale   (n_pages, G, KVH, 1) f32 per-(token, head) scales
    page_table  (R, n_ptab) int32 physical page ids (0 = null page)
    lengths     (R,) int32 valid kv rows per item
    q_pos       (R, Q) int32 absolute query positions; -1 = padding row

A query row attends kv p with p <= q_pos and p < length (decode: p <
length). Only valid rows are defined: padding rows come back as zeros from
the kernel and as the masked softmax's uniform mix from the plain version.

Each wrapper launches its kernel for CUDA tensors (counted in
``<wrapper>.launches``), takes its plain PyTorch version only for CPU
tensors and raises for any other device. The plain versions walk the
page table page by page with an online softmax, in the reference
kernels' op order, each dot written out as products and a sum (a GEMM's
summation order would hang on the batch's shape), so a row's result is
the same at one row per item (decode) as inside any ragged item; the decode kernel rescales per warp's 32 positions of
a chunk and combines warps and splits at the end, and the ragged kernel
per 64-position chunk on the tensor cores, combining its two warp
groups at the end: the same sums in another order. The gather fallbacks (``*_fallback``) are the reference's jnp paths
for fp pools: they keep the scaled q in f32 and take one softmax over the
gathered sequence, so they differ from the kernels by that rounding and
that order.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from . import build

_NEG_INF = -1e30

_INVALID_VALUE = 1   # cudaErrorInvalidValue

_C = ctypes.c_int
_P = ctypes.c_void_p
_F = ctypes.c_float
_PLAN = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    "paged_attention_ragged": [_P, _C, _P, _P, _P, _P, _P, _C, _P, _P, _C,
                               _C, _C, _C, _C, _C, _F, _P, _P],
    # ... lengths, B, KVH, g, hd, page_size, q_scale, the card's SMs, the
    # split (0: the plan's), out, stream
    "paged_attention_decode": [_P, _C, _P, _P, _P, _P, _P, _C, _P, _C, _C,
                               _C, _C, _C, _F, _C, _C, _P, _P],
    "pa_decode_plan": [_C] * 9 + [_PLAN],
    "pa_split_range": [_C] * 4 + [_PLAN],
    "pa_ragged_plan": [_C] * 7 + [_PLAN],
    "pa_ragged_rows": [_C] * 3 + [_PLAN],
}


# ------------------------------------------------------- decode plan

@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """Launch plan of the decode kernel: ``split`` CTAs (one cluster) per
    (item, KV head, group of up to 8 query rows), ``ctas`` in all,
    ``smem`` bytes of dynamic shared memory per CTA."""
    split: int
    ctas: int
    smem: int


def decode_plan(b: int, kvh: int, g: int, hd: int, page_size: int,
                n_ptab: int, sms: int, smem_optin: int = 0, split: int = 0,
                lib=None) -> DecodePlan:
    """The decode kernel's plan (``pa::decode_plan``, which its entry runs
    on every call) for B items of KVH heads, g query rows per head, pages
    of ``page_size`` rows and ``n_ptab`` table entries per item, on a card
    of ``sms`` SMs: ``split`` 0 takes the plan's own number of splits.
    ``smem_optin`` (0: the current card's) bounds the shared memory per
    CTA; ``lib`` a library exporting ``pa_decode_plan`` (default: the
    built CUDA library). Raises ValueError for a shape the kernel does not
    take."""
    lib = lib or build.load("paged_attention", _SIGNATURES)
    out = (ctypes.c_int * 3)()
    if lib.pa_decode_plan(b, kvh, g, hd, page_size, n_ptab, sms, smem_optin,
                          split, out):
        raise ValueError(f"the decode attention does not take B={b}, "
                         f"KVH={kvh}, g={g}, hd={hd}, page_size={page_size},"
                         f" n_ptab={n_ptab}, split={split}: it needs hd a "
                         f"multiple of 8 from 8 to 256, a split in 1..8 and "
                         f"its shared memory to fit (csrc/attention_plan.h)")
    return DecodePlan(*out)


def split_range(length: int, page_size: int, split: int, rank: int,
                lib=None) -> range:
    """The key positions that split ``rank`` of ``split`` attends for an
    item of ``length`` positions (``pa::split_range``)."""
    lib = lib or build.load("paged_attention", _SIGNATURES)
    out = (ctypes.c_int * 2)()
    if lib.pa_split_range(length, page_size, split, rank, out):
        raise ValueError(f"no split range for length={length}, page_size="
                         f"{page_size}, split={split}, rank={rank}")
    return range(out[0], out[1])


@dataclasses.dataclass(frozen=True)
class RaggedPlan:
    """Launch plan of the ragged kernel: ``tiles`` tiles of query rows
    per (item, KV head) (``ragged_rows``), one CTA each, ``ctas`` in all,
    ``smem`` bytes of dynamic shared memory per CTA."""
    tiles: int
    ctas: int
    smem: int


def ragged_plan(n_items: int, nq: int, kvh: int, g: int, hd: int,
                page_size: int, smem_optin: int = 0, lib=None
                ) -> RaggedPlan:
    """The ragged kernel's plan (``pa::ragged_plan``, which its entry runs
    on every call) for ``n_items`` work items of ``nq`` query positions,
    KVH heads of g query rows and head dim hd. ``smem_optin`` (0: the
    current card's) bounds the shared memory per CTA; ``lib`` a library
    exporting ``pa_ragged_plan`` (default: the built CUDA library).
    Raises ValueError for a shape the kernel does not take."""
    lib = lib or build.load("paged_attention", _SIGNATURES)
    out = (ctypes.c_int * 3)()
    if lib.pa_ragged_plan(n_items, nq, kvh, g, hd, page_size, smem_optin,
                          out):
        raise ValueError(f"the ragged attention does not take R={n_items}, "
                         f"Q={nq}, KVH={kvh}, g={g}, hd={hd}, page_size="
                         f"{page_size}: it needs hd a multiple of 8 from 8 "
                         f"to 256 and its shared memory to fit "
                         f"(csrc/attention_plan.h)")
    return RaggedPlan(*out)


def ragged_rows(nq: int, g: int, tile: int, lib=None) -> range:
    """The query rows r = qi·g + gi of an item that tile ``tile`` of the
    ragged kernel owns (``pa::ragged_rows``)."""
    lib = lib or build.load("paged_attention", _SIGNATURES)
    out = (ctypes.c_int * 2)()
    if lib.pa_ragged_rows(nq, g, tile, out):
        raise ValueError(f"no ragged rows for nq={nq}, g={g}, tile={tile}")
    return range(out[0], out[1])


# ----------------------------------------------------------- gather paths

def _logical(pages, scale, page_table, hd, kvh):
    """(n_pages, G, KVH, hd) pool -> (R, n_ptab*G, KVH, hd) f32 view."""
    b = page_table.shape[0]
    view = pages[page_table.long()].reshape(b, -1, kvh, hd)
    if scale is None:
        return view.to(torch.float32)
    sc = scale[page_table.long()].reshape(b, -1, kvh, 1)
    return view.to(torch.float32) * sc


def _ragged_gather(qf, k_pages, k_scale, v_pages, v_scale, page_table,
                   lengths, q_pos):
    """Masked f32 softmax attention of pre-scaled f32 queries qf
    (R, Q, KVH, g, hd) over each item's gathered logical view."""
    b, nq, kvh, g, hd = qf.shape
    k = _logical(k_pages, k_scale, page_table, hd, kvh)
    v = _logical(v_pages, v_scale, page_table, hd, kvh)
    skv = k.shape[1]
    s = torch.einsum("bqkgd,bskd->bqkgs", qf, k)
    kv = torch.arange(skv, dtype=torch.int32, device=qf.device)
    q_pos = q_pos.to(torch.int32)
    mask = ((kv[None, None, :] <= q_pos[:, :, None])
            & (kv[None, None, :] < lengths.to(torch.int32)[:, None, None])
            & (q_pos[:, :, None] >= 0))
    s = torch.where(mask[:, :, None, None, :], s,
                    torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqkgs,bskd->bqkgd", p, v)


def _decode_as_ragged(q, lengths):
    """Decode operands as one-query ragged items at q_pos = length - 1."""
    return q[:, None], (lengths.to(torch.int32) - 1)[:, None]


def paged_attention_ragged_fallback(q, k_pages, k_scale, v_pages, v_scale,
                                    page_table, lengths, q_pos):
    """The reference's gather path (``repro.kernels.paged_attention.
    paged_attention_ragged_fallback``): q scaled in f32; also serves fp
    pools (``k_scale``/``v_scale`` None)."""
    hd = q.shape[-1]
    qf = q.to(torch.float32) * hd ** -0.5
    return _ragged_gather(qf, k_pages, k_scale, v_pages, v_scale,
                          page_table, lengths, q_pos).to(q.dtype)


def paged_attention_fallback(q, k_pages, k_scale, v_pages, v_scale,
                             page_table, lengths):
    """The reference's decode gather path (q (B, KVH, g, hd)): the
    ragged one at q_len 1 with q_pos = length - 1 (the mask
    kv <= length - 1 is kv < length)."""
    q1, qpos = _decode_as_ragged(q, lengths)
    return paged_attention_ragged_fallback(q1, k_pages, k_scale, v_pages,
                                           v_scale, page_table, lengths,
                                           qpos)[:, 0]


def paged_attention_ragged_plain(q, k_pages, k_scale, v_pages, v_scale,
                                 page_table, lengths, q_pos):
    """Plain version of the ragged kernel, in the op order of the
    reference's ``_ragged_attn_kernel``: q scaled by hd^-½ in f32 and
    rounded back to q's dtype, then one page of the table at a time —
    dequant, f32 scores, the causal and length mask at -1e30, running max,
    ``exp``, correction factor, running sum and accumulator — and
    ``acc / max(l, 1e-30)`` rounded to q's dtype."""
    r, nq, kvh, g, hd = q.shape
    ps = k_pages.shape[1]
    qf = (q.to(torch.float32) * hd ** -0.5).to(q.dtype).to(torch.float32)
    q_pos = q_pos.to(torch.int32)
    lengths = lengths.to(torch.int32)
    m = torch.full((r, nq, kvh, g), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((r, nq, kvh, g, hd), dtype=torch.float32,
                      device=q.device)
    rows = torch.arange(ps, dtype=torch.int32, device=q.device)
    for i in range(page_table.shape[1]):
        page = page_table[:, i].long()
        k = k_pages[page].to(torch.float32) * k_scale[page]   # (R, G, KVH, hd)
        v = v_pages[page].to(torch.float32) * v_scale[page]
        # products and sums written out, not einsum: a GEMM's summation
        # order hangs on its shape, and a row's bits may not hang on the
        # rows beside it (``paged_attention_decode_plain`` is this at one
        # row per item)
        kt = k.permute(0, 2, 1, 3)[:, None, :, None]   # (R, 1, KVH, 1, G, hd)
        s = (qf[..., None, :] * kt).sum(-1)
        kv_pos = i * ps + rows
        mask = ((kv_pos[None, None, :] <= q_pos[:, :, None])
                & (kv_pos[None, None, :] < lengths[:, None, None])
                & (q_pos[:, :, None] >= 0))
        s = torch.where(mask[:, :, None, None, :], s,
                        torch.full_like(s, _NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        m = m_new
        l = l * corr + p.sum(dim=-1)
        vt = v.permute(0, 2, 1, 3)[:, None, :, None]   # (R, 1, KVH, 1, G, hd)
        acc = acc * corr[..., None] + (p[..., None] * vt).sum(-2)
    return (acc / torch.clamp_min(l, 1e-30)[..., None]).to(q.dtype)


def paged_attention_decode_plain(q, k_pages, k_scale, v_pages, v_scale,
                                 page_table, lengths):
    """Plain version of the decode kernel (q (B, KVH, g, hd))."""
    q1, qpos = _decode_as_ragged(q, lengths)
    return paged_attention_ragged_plain(q1, k_pages, k_scale, v_pages,
                                        v_scale, page_table, lengths,
                                        qpos)[:, 0]


# ------------------------------------------------------------ CUDA launch

def _validate(q, k_pages, k_scale, v_pages, v_scale, page_table, lengths,
              q_pos, kvh):
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be f32 or bf16, got {q.dtype}")
    hd = q.shape[-1]
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.dtype != torch.int8 or t.ndim != 4 or t.shape[2:] != (kvh, hd):
            raise TypeError(f"{name} must be int8 (n_pages, G, {kvh}, {hd}),"
                            f" got {t.dtype} {tuple(t.shape)}")
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        if (t.dtype != torch.float32
                or t.shape != k_pages.shape[:3] + (1,)):
            raise TypeError(f"{name} must be f32 {tuple(k_pages.shape[:3])}"
                            f"+(1,), got {t.dtype} {tuple(t.shape)}")
    n = page_table.shape[0]
    for name, t in (("page_table", page_table), ("lengths", lengths),
                    ("q_pos", q_pos)):
        if t is not None and t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    if lengths.shape != (n,):
        raise ValueError(f"lengths {tuple(lengths.shape)} must be ({n},)")
    if q_pos is not None and q_pos.shape != (n, q.shape[1]):
        raise ValueError(f"q_pos {tuple(q_pos.shape)} must be "
                         f"({n}, {q.shape[1]})")
    for t in (k_pages, k_scale, v_pages, v_scale, page_table, lengths):
        if t.device != q.device:
            raise TypeError(f"all operands must be on {q.device}")


def _contig(*ts):
    return [None if t is None else t.contiguous() for t in ts]


def _aligned(t):
    """Contiguous and 16-byte aligned (the kernels stage K and V rows by
    16-byte copies and read q rows in whole fragments)."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def paged_attention_ragged(q, k_pages, k_scale, v_pages, v_scale,
                           page_table, lengths, q_pos) -> torch.Tensor:
    """Mixed-q_len paged attention (one launch for a unified step's work
    items) -> (R, Q, KVH, g, hd) in q's dtype."""
    if build.off_card(q, "paged_attention_ragged"):
        return paged_attention_ragged_plain(q, k_pages, k_scale, v_pages,
                                            v_scale, page_table, lengths,
                                            q_pos)
    out = _launch_ragged(q, k_pages, k_scale, v_pages, v_scale, page_table,
                         lengths, q_pos)
    paged_attention_ragged.launches += 1
    return out


def _launch_ragged(q, k_pages, k_scale, v_pages, v_scale, page_table,
                   lengths, q_pos):
    """One launch of the ragged kernel on its plan; allocates the output
    only."""
    r, nq, kvh, g, hd = q.shape
    _validate(q, k_pages, k_scale, v_pages, v_scale, page_table, lengths,
              q_pos, kvh)
    q, k_scale, v_scale, page_table, lengths, q_pos = _contig(
        q, k_scale, v_scale, page_table, lengths, q_pos)
    q, k_pages, v_pages = _aligned(q), _aligned(k_pages), _aligned(v_pages)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    ps = k_pages.shape[1]
    lib = build.load("paged_attention", _SIGNATURES)
    code = lib.paged_attention_ragged(
        build.ptr(q), int(q.dtype == torch.bfloat16), build.ptr(k_pages),
        build.ptr(k_scale), build.ptr(v_pages), build.ptr(v_scale),
        build.ptr(page_table), page_table.shape[1], build.ptr(lengths),
        build.ptr(q_pos), r, nq, kvh, g, hd, ps, float(hd ** -0.5),
        build.ptr(out), build.stream_of(q))
    if code == _INVALID_VALUE:   # a shape the plan refuses: say why
        ragged_plan(r, nq, kvh, g, hd, ps, lib=lib)
    build.check(code, "paged_attention_ragged")
    return out


def _launch_decode(q, k_pages, k_scale, v_pages, v_scale, page_table,
                   lengths, split=0):
    """One launch of the decode kernel with ``split`` CTAs per (item,
    head, row group) (0: the plan's own); allocates the output only."""
    b, kvh, g, hd = q.shape
    _validate(q, k_pages, k_scale, v_pages, v_scale, page_table, lengths,
              None, kvh)
    q, k_scale, v_scale, page_table, lengths = _contig(
        q, k_scale, v_scale, page_table, lengths)
    k_pages, v_pages = _aligned(k_pages), _aligned(v_pages)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    n_ptab, ps = page_table.shape[1], k_pages.shape[1]
    sms = build.sm_count(q.device)
    lib = build.load("paged_attention", _SIGNATURES)
    code = lib.paged_attention_decode(
        build.ptr(q), int(q.dtype == torch.bfloat16), build.ptr(k_pages),
        build.ptr(k_scale), build.ptr(v_pages), build.ptr(v_scale),
        build.ptr(page_table), n_ptab, build.ptr(lengths), b, kvh, g, hd,
        ps, float(hd ** -0.5), sms, split, build.ptr(out),
        build.stream_of(q))
    if code == _INVALID_VALUE:   # a shape the plan refuses: say why
        decode_plan(b, kvh, g, hd, ps, n_ptab, sms, split=split, lib=lib)
    build.check(code, "paged_attention_decode")
    return out


def paged_attention_decode(q, k_pages, k_scale, v_pages, v_scale,
                           page_table, lengths) -> torch.Tensor:
    """Single-token paged decode attention: q (B, KVH, g, hd), lengths =
    pos + 1 -> (B, KVH, g, hd) in q's dtype. An item of length 0 comes
    back as zeros from the kernel (and as the masked softmax's uniform mix
    from the plain version)."""
    if build.off_card(q, "paged_attention_decode"):
        return paged_attention_decode_plain(q, k_pages, k_scale, v_pages,
                                            v_scale, page_table, lengths)
    out = _launch_decode(q, k_pages, k_scale, v_pages, v_scale, page_table,
                         lengths)
    paged_attention_decode.launches += 1
    return out


paged_attention_ragged.launches = 0
paged_attention_decode.launches = 0
