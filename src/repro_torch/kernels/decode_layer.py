"""The decode QKV prologue: hidden rows -> rope'd q + the step's K/V rows
written into the paged pool, in one launch.

Replaces the Pallas TPU kernel ``decode_qkv_prologue`` of
``src/repro/kernels/decode_layer.py:162``:

    block-CAT -> ⊙ sign -> Kronecker Hadamard -> per-token asymmetric act
    quant -> W4A8 (W8A8 unpacked) QKV contraction -> RoPE(q, k) at per-row
    positions -> symmetric int8 quant of k and v per (row, KV head) ->
    scatter of codes and scales into (page_ids[r], row_ids[r])

With it a decode layer's attention block is two launches: this prologue
and ``paged_attention_decode``. The CUDA source is
``src/repro_torch/csrc/decode_layer.cu``: one CTA per head, in
thread-block clusters of heads (the CUDA source's plan, read by
``prologue_plan``: 2 clusters of 8 at full width); each cluster computes
the rows' transform and quant once, split over its CTAs
(``csrc/cluster_tq.cuh``, shared with the fused CAT GEMV), and each CTA
pushes its codes into every peer's shared memory; every CTA then
contracts its head's columns against all the codes (16-byte weight loads
into shared memory), applies RoPE and the KV quant on chip and writes
its codes straight into the pool. Widths whose operands one cluster's
shared memory cannot hold (the plan's ``path`` 1: D 5120 at head_dim
128, for one) take the streamed path (``csrc/wide_tq.cuh``): one
cooperative launch of two CTAs per SM, the transform through a device
scratch this wrapper allocates (beside the first weight stages, issued
before it), then each head's K split over CTAs and streamed through a
deep ring onto the tensor cores, the splits' exact sums added in the
same scratch, and the same per-head epilogue, run once per head by the
CTA that adds its last split. What bounds it on
the H100 is the packed QKV weight (D/2 x N bytes) over HBM bandwidth;
each weight byte is read once.

The wrapper launches the kernel for CUDA tensors (counted in
``decode_qkv_prologue.launches``), raises for a device that is neither
CUDA nor the CPU, and takes the plain PyTorch version,
which composes ``fused_cat_linear_plain``, ``models.layers.rope``,
``quantize_kv`` and the paged scatter in the op order of the reference's
oracle (``ref.decode_qkv_prologue``), only for CPU tensors. Both update
the pools in place; padded rows target the null page 0.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.models.layers import quantize_kv, rope, rope_freq

from . import build
from .fused_cat_matmul import (_INVALID_VALUE, _PLAN, GEMV_M, _contiguous,
                               _SIGNATURES as _F_SIGNATURES,
                               fused_cat_linear_plain, read_plan,
                               split_k_range, wide_scratch)

_C = ctypes.c_int
_P = ctypes.c_void_p
_SIGNATURES = {"decode_qkv_prologue": [
    _P, _C, _C, _C, _P, _C, _P, _P, _C, _P, _C, _C, _P, _C, _P, _C,
    _C, _C, _C, _P, _C, _P, _P, _P, _C, _P, _P, _P, _P, _P, _P, _P],
    "decode_qkv_prologue_capacity": [_C, _C],
    "ctq_prologue_plan": [_C] * 10 + [_PLAN],
    "ctq_wide_scratch": _F_SIGNATURES["ctq_wide_scratch"]}

_FREQ: dict = {}


def _freq(head_dim: int, theta: float, device) -> torch.Tensor:
    """``rope_freq`` computed once per (head_dim, theta, device), so the
    kernel's angles use the plain version's own frequencies."""
    key = (head_dim, float(theta), str(device))
    if key not in _FREQ:
        _FREQ[key] = rope_freq(head_dim, theta, device)
    return _FREQ[key]


def decode_qkv_prologue_plain(x, blocks, ha, hb, sign, qw, sw, k_pool,
                              k_scale, v_pool, v_scale, page_ids, row_ids,
                              positions, *, n_q: int, head_dim: int,
                              rope_theta: float, kv_bits: int = 8,
                              act_bits: int = 8, packed: bool = True):
    """Plain PyTorch version (the reference oracle's op order). bf16 rows
    round where the composed path does (the linear's outputs, then the
    rope'd q and k), so q, codes and scales equal that path's."""
    m = x.shape[0]
    n_kv = (qw.shape[1] - n_q) // 2
    kvh = n_kv // head_dim
    y = fused_cat_linear_plain(x, blocks, ha, hb, sign, qw, sw,
                               act_bits=act_bits, packed=packed).to(x.dtype)
    pos = positions.to(torch.int32)[:, None]
    q = rope(y[:, :n_q].reshape(m, 1, n_q // head_dim, head_dim), pos,
             rope_theta).reshape(m, n_q).to(torch.float32)
    k = rope(y[:, n_q:n_q + n_kv].reshape(m, 1, kvh, head_dim), pos,
             rope_theta).reshape(m, kvh, head_dim)
    v = y[:, n_q + n_kv:].reshape(m, kvh, head_dim)
    kq, ks = quantize_kv(k, kv_bits)
    vq, vs = quantize_kv(v, kv_bits)
    pids, rows = page_ids.long(), row_ids.long()
    k_pool[pids, rows] = kq
    k_scale[pids, rows] = ks
    v_pool[pids, rows] = vq
    v_scale[pids, rows] = vs
    return q, k_pool, k_scale, v_pool, v_scale


@dataclasses.dataclass(frozen=True)
class ProloguePlan:
    """Launch plan of the prologue: one CTA per head (``cols`` = head_dim
    columns), in ``clusters`` clusters of ``cluster`` heads (cluster g
    holds heads g·cluster .. (g+1)·cluster − 1, each CTA computing
    D/cluster of the transform's values); ``smem`` bytes of dynamic
    shared memory per CTA. On the streamed path (``path`` 1) each of the
    ``clusters`` heads is a column tile whose K is split ``splits`` ways
    (``k_range``), each split a work item that ``per_sm`` CTAs per SM
    take in turn, streamed in stages of ``ktile`` K through a ring of
    ``stages``; the head's owner adds its splits and runs its epilogue."""
    cluster: int
    clusters: int
    cols: int
    smem: int
    path: int = 0
    ktile: int = 0
    splits: int = 1
    stages: int = 0
    per_sm: int = 1

    def heads(self, g: int) -> range:
        return range(g * self.cluster, (g + 1) * self.cluster)

    def k_range(self, split: int, d: int) -> range:
        """The K of D that split ``split`` of a head contracts (all of D
        on the cluster path)."""
        return split_k_range(self, split, d)


def prologue_plan(m: int, d: int, n: int, head_dim: int, a: int, b: int,
                  bk: int, packed: bool, smem_optin: int = 0,
                  lib=None, sms: int = 0) -> ProloguePlan:
    """The prologue's plan for B = m rows of D = a·b against the N =
    heads·head_dim QKV columns (``ctq::prologue_plan``, which the kernel's
    entry runs on every call): the largest cluster that divides the heads
    and over which the transform splits (8 at full width: 2 clusters of 8
    heads). ``smem_optin`` (0: the current card's) bounds the shared
    memory per CTA and ``sms`` (0: the current card's) is the streamed
    path's grid; ``lib`` a library exporting ``ctq_prologue_plan``
    (default: the built CUDA library). Raises ValueError for a shape the
    kernel does not take."""
    lib = lib or build.load("decode_layer", _SIGNATURES)
    return ProloguePlan(*read_plan(lib.ctq_prologue_plan, "the prologue", m,
                                   d, n, head_dim, a, b, bk, int(packed),
                                   sms, smem_optin))


@functools.lru_cache(maxsize=256)
def _served_plan(lib, *args):
    """The prologue's plan for a served shape, read once; None for a shape
    the plan refuses (the entry then reports it)."""
    try:
        return prologue_plan(*args, lib=lib)
    except ValueError:
        return None


def _validate(x, blocks, ha, hb, sign, qw, sw, pools, ids, n_q, head_dim,
              kv_bits, act_bits, packed):
    m, d = x.shape
    n = qw.shape[1]
    n_kv = (n - n_q) // 2
    if m > GEMV_M:
        raise ValueError(f"the decode prologue takes B <= {GEMV_M} rows, "
                         f"got {m}")
    if n_q + 2 * n_kv != n or n_q % head_dim or n_kv % head_dim:
        raise ValueError(f"QKV width {n} does not split into n_q={n_q} and "
                         f"two KV blocks of whole heads of {head_dim}")
    if head_dim & (head_dim - 1) or not 2 <= head_dim <= d:
        raise ValueError(f"head_dim must be a power of two in [2, {d}], "
                         f"got {head_dim}")
    if (packed and qw.shape[0] != (d + 1) // 2) or (not packed
                                                    and qw.shape[0] != d):
        raise ValueError(f"qw {tuple(qw.shape)} does not match D={d} "
                         f"(packed={packed})")
    if ha.shape[0] * hb.shape[0] != d:
        raise ValueError(f"Hadamard factors {tuple(ha.shape)}x"
                         f"{tuple(hb.shape)} do not span D={d}")
    if blocks is not None and blocks.shape[0] * blocks.shape[1] != d:
        raise ValueError(f"CAT blocks {tuple(blocks.shape)} do not span "
                         f"D={d}")
    if not 2 <= act_bits <= 8 or not 2 <= kv_bits <= 8:
        raise ValueError(f"act_bits and kv_bits must be in [2, 8], got "
                         f"{act_bits}, {kv_bits}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be f32 or bf16, got {x.dtype}")
    k_pool, k_scale, v_pool, v_scale = pools
    kvh = n_kv // head_dim
    shape = k_pool.shape
    if (len(shape) != 4 or shape[2:] != (kvh, head_dim)
            or v_pool.shape != shape
            or k_scale.shape != shape[:3] + (1,)
            or v_scale.shape != k_scale.shape):
        raise ValueError(f"pools {tuple(k_pool.shape)}/{tuple(k_scale.shape)}"
                         f" do not hold {kvh} KV heads of {head_dim}")
    dev = x.device
    for name, t, dt in (("k_pool", k_pool, torch.int8),
                        ("v_pool", v_pool, torch.int8),
                        ("k_scale", k_scale, torch.float32),
                        ("v_scale", v_scale, torch.float32),
                        ("qw", qw, torch.int8), ("sw", sw, torch.float32),
                        ("ha", ha, torch.float32),
                        ("hb", hb, torch.float32)):
        if t.dtype != dt or t.device != dev:
            raise TypeError(f"{name} must be {dt} on {dev}")
    for name, t in (("k_pool", k_pool), ("k_scale", k_scale),
                    ("v_pool", v_pool), ("v_scale", v_scale)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous: the kernel "
                             f"writes it in place")
    for name, t in zip(("page_ids", "row_ids", "positions"), ids):
        if t.shape != (m,) or t.device != dev:
            raise ValueError(f"{name} must be ({m},) on {dev}")
    for name, t in (("sign", sign), ("blocks", blocks)):
        if t is not None and (t.dtype != torch.float32 or t.device != dev):
            raise TypeError(f"{name} must be f32 on {dev}")
    return n_kv


def decode_qkv_prologue(x, blocks, ha, hb, sign, qw, sw, k_pool, k_scale,
                        v_pool, v_scale, page_ids, row_ids, positions, *,
                        n_q: int, head_dim: int, rope_theta: float,
                        kv_bits: int = 8, act_bits: int = 8,
                        packed: bool = True):
    """Fused decode QKV prologue.

    x (B <= 8, D) f32/bf16 normed hidden rows; blocks/ha/hb/sign the CAT
    operands (``ops.fused_transform_operands``); qw (ceil(D/2), N) packed
    int4 — or (D, N) int8 with ``packed=False`` — laid out [q | k | v];
    sw (1, N) f32; k/v_pool (n_pages, page, KVH, hd) int8 and k/v_scale
    (n_pages, page, KVH, 1) f32, written in place; page_ids, row_ids,
    positions (B,) int. -> (q (B, n_q) f32 rope'd, k_pool, k_scale,
    v_pool, v_scale)."""
    if build.off_card(x, "decode_qkv_prologue"):
        return decode_qkv_prologue_plain(
            x, blocks, ha, hb, sign, qw, sw, k_pool, k_scale, v_pool,
            v_scale, page_ids, row_ids, positions, n_q=n_q,
            head_dim=head_dim, rope_theta=rope_theta, kv_bits=kv_bits,
            act_bits=act_bits, packed=packed)
    ids = [t.to(torch.int32).contiguous()
           for t in (page_ids, row_ids, positions)]
    pools = (k_pool, k_scale, v_pool, v_scale)
    n_kv = _validate(x, blocks, ha, hb, sign, qw, sw, pools, ids, n_q,
                     head_dim, kv_bits, act_bits, packed)
    x, qw, sw, ha, hb, sign, blocks = _contiguous(x, qw, sw, ha, hb, sign,
                                                  blocks)
    m, d = x.shape
    q = torch.empty((m, n_q), dtype=torch.float32, device=x.device)
    if m == 0:
        return q, k_pool, k_scale, v_pool, v_scale
    bk = 0 if blocks is None else blocks.shape[1]
    freq = _freq(head_dim, rope_theta, x.device)
    lib = build.load("decode_layer", _SIGNATURES)
    plan = _served_plan(lib, m, d, qw.shape[1], head_dim, ha.shape[0],
                        hb.shape[0], bk, bool(packed))
    ws = None
    if plan is not None and plan.path == 1:
        ws = torch.empty(wide_scratch(m, d, plan, lib=lib),
                         dtype=torch.uint8, device=x.device)
    code = lib.decode_qkv_prologue(
        build.ptr(x), int(x.dtype == torch.bfloat16), m, d,
        build.ptr(blocks), bk, build.ptr(sign), build.ptr(ha), ha.shape[0],
        build.ptr(hb), hb.shape[0], act_bits, build.ptr(qw), int(packed),
        build.ptr(sw), qw.shape[1], n_q, n_kv, head_dim, build.ptr(freq),
        kv_bits, *(build.ptr(t) for t in ids), k_pool.shape[1],
        build.ptr(k_pool), build.ptr(k_scale), build.ptr(v_pool),
        build.ptr(v_scale), build.ptr(q), build.ptr(ws), build.stream_of(x))
    if code == _INVALID_VALUE:   # a shape the plan refuses: say why
        prologue_plan(m, d, qw.shape[1], head_dim, ha.shape[0], hb.shape[0],
                      bk, packed, lib=lib)
    build.check(code, "decode_qkv_prologue")
    decode_qkv_prologue.launches += 1
    return q, k_pool, k_scale, v_pool, v_scale


decode_qkv_prologue.launches = 0
