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
``src/repro_torch/csrc/decode_layer.cu``: one CTA per head recomputes the
rows' transform and quant in shared memory (every factor element read
once for all rows), contracts its head's columns, applies RoPE and the KV
quant on chip and writes its codes straight into the pool. What bounds it
on the H100 is the packed QKV weight (D/2 x N bytes) over HBM bandwidth;
each weight byte is read once.

The wrapper launches the kernel for CUDA tensors (counted in
``decode_qkv_prologue.launches``) and takes the plain PyTorch version,
which composes ``fused_cat_linear_plain``, ``models.layers.rope``,
``quantize_kv`` and the paged scatter in the op order of the reference's
oracle (``ref.decode_qkv_prologue``), only for CPU tensors. Both update
the pools in place; padded rows target the null page 0.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.models.layers import quantize_kv, rope, rope_freq

from . import build
from .fused_cat_matmul import GEMV_M, fused_cat_linear_plain

_C = ctypes.c_int
_P = ctypes.c_void_p
_SIGNATURES = {"decode_qkv_prologue": [
    _P, _C, _C, _C, _C, _P, _C, _P, _P, _C, _P, _C, _C, _P, _C, _P, _C,
    _C, _C, _C, _P, _C, _P, _P, _P, _C, _P, _P, _P, _P, _P, _P]}
_THREADS = 256                 # threads per CTA (decode_layer.cu kThreads)
_DYN_SMEM_MAX = 200 * 1024     # beside ~12 KiB static, of 227 KiB a CTA

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
    """Plain PyTorch version (the reference oracle's op order)."""
    m = x.shape[0]
    n_kv = (qw.shape[1] - n_q) // 2
    kvh = n_kv // head_dim
    y = fused_cat_linear_plain(x, blocks, ha, hb, sign, qw, sw,
                               act_bits=act_bits, packed=packed)
    pos = positions.to(torch.int32)[:, None]
    q = rope(y[:, :n_q].reshape(m, 1, n_q // head_dim, head_dim), pos,
             rope_theta).reshape(m, n_q)
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
    if (head_dim & (head_dim - 1) or not 2 <= head_dim <= _THREADS
            or head_dim > d):
        raise ValueError(f"head_dim must be a power of two in [2, "
                         f"{min(_THREADS, d)}], got {head_dim}")
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
                        ("ha", ha, torch.float32), ("hb", hb, torch.float32),
                        ("sign", sign, torch.float32)):
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
    k_pad = 2 * qw.shape[0] if packed else d
    smem = 4 * (2 * m * d + ha.shape[0] ** 2 + hb.shape[0] ** 2) + m * k_pad
    if smem > _DYN_SMEM_MAX:
        raise ValueError(f"the prologue needs {smem} B of dynamic shared "
                         f"memory (D={d}); it takes at most {_DYN_SMEM_MAX}")
    return k_pad, n_kv


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
    if not x.is_cuda:
        return decode_qkv_prologue_plain(
            x, blocks, ha, hb, sign, qw, sw, k_pool, k_scale, v_pool,
            v_scale, page_ids, row_ids, positions, n_q=n_q,
            head_dim=head_dim, rope_theta=rope_theta, kv_bits=kv_bits,
            act_bits=act_bits, packed=packed)
    ids = [t.to(torch.int32).contiguous()
           for t in (page_ids, row_ids, positions)]
    pools = (k_pool, k_scale, v_pool, v_scale)
    k_pad, n_kv = _validate(x, blocks, ha, hb, sign, qw, sw, pools, ids,
                            n_q, head_dim, kv_bits, act_bits, packed)
    lib = build.load("decode_layer", _SIGNATURES)
    x, qw, sw = x.contiguous(), qw.contiguous(), sw.contiguous()
    ha, hb, sign = ha.contiguous(), hb.contiguous(), sign.contiguous()
    blocks = None if blocks is None else blocks.contiguous()
    m, d = x.shape
    q = torch.empty((m, n_q), dtype=torch.float32, device=x.device)
    if m == 0:
        return q, k_pool, k_scale, v_pool, v_scale
    freq = _freq(head_dim, rope_theta, x.device)
    bk = 0 if blocks is None else blocks.shape[1]
    code = lib.decode_qkv_prologue(
        build.ptr(x), int(x.dtype == torch.bfloat16), m, d, k_pad,
        build.ptr(blocks), bk, build.ptr(sign), build.ptr(ha), ha.shape[0],
        build.ptr(hb), hb.shape[0], act_bits, build.ptr(qw), int(packed),
        build.ptr(sw), qw.shape[1], n_q, n_kv, head_dim, build.ptr(freq),
        kv_bits, *(build.ptr(t) for t in ids), k_pool.shape[1],
        build.ptr(k_pool), build.ptr(k_scale), build.ptr(v_pool),
        build.ptr(v_scale), build.ptr(q), build.stream_of(x))
    build.check(code, "decode_qkv_prologue")
    decode_qkv_prologue.launches += 1
    return q, k_pool, k_scale, v_pool, v_scale


decode_qkv_prologue.launches = 0
