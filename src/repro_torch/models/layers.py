"""Shared model layers — counterpart of ``repro.models.layers`` for the
dense family: norms, softcap, RoPE, chunked online-softmax attention
(also over ``(codes, scale)`` int8 KV tuples, with a sliding window and an
attention softcap), the activations, the gated MLP, KV quantization, the
slot cache's writes and the paged KV pool's scatter and gather.

The cache writes update the cache and pool tensors in place (the
reference returns new arrays): a slot cache row block, or a view of one
slot of it, takes its rows where they land; in a paged pool distinct
sequences own distinct pages, so real writes never collide, and padding
rows land on the reserved null page 0.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import qlinear

_NEG_INF = -1e30

# Sequence-axis granularity of the per-token KV quant scales (as in the
# reference): a page never splits a scale group.
KV_QUANT_GROUP = 1


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    """x * rsqrt(mean(x²) + eps) * (1 + scale), in f32, rounded to x's
    dtype. The f32 squares are summed in f64 and the mean rounded to f32:
    the order of an f32 sum moves its last bit, and a reduction kernel's
    order on the card changes with the number of rows, so a row's bits
    would depend on the step that carries it."""
    dt = x.dtype
    xf = x.to(torch.float32)
    var = torch.mean((xf * xf).to(torch.float64), dim=-1,
                     keepdim=True).to(torch.float32)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.to(torch.float32))
    return out.to(dt)


def add_rms_norm(x: torch.Tensor, a: torch.Tensor, scale: torch.Tensor,
                 eps: float = 1e-6):
    """The residual add followed by a norm: (x + a in x's dtype, the norm
    of the sum in x's dtype). The reference's compiled step fuses the two
    and hands the norm the unrounded f32 sum (XLA's excess precision)
    while the residual stream keeps the rounded one; the port does the
    same, so bf16 norms agree bitwise (identical in f32)."""
    total = x.to(torch.float32) + a.to(torch.float32)
    return total.to(x.dtype), rms_norm(total, scale, eps).to(x.dtype)


def softcap(x: torch.Tensor, cap: float):
    """cap · tanh(x / cap); the identity for cap 0."""
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


def rope_freq(head_dim: int, theta: float, device) -> torch.Tensor:
    """RoPE's (head_dim // 2,) f32 inverse frequencies."""
    half = head_dim // 2
    return theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=device) / half)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (B, S, H, hd), positions: (B, S) or (S,) absolute positions."""
    hd = x.shape[-1]
    half = hd // 2
    freq = rope_freq(hd, theta, x.device)
    if positions.ndim == 1:
        positions = positions[None, :]
    ang = positions.to(torch.float32)[:, :, None] * freq[None, None, :]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def chunked_attention(q: torch.Tensor, k, v, *, q_positions: torch.Tensor,
                      window: Optional[int] = None,
                      attn_softcap: float = 0.0,
                      kv_chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention. q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd)
    with KV | H — or (codes int8, scale) tuples, dequantized per chunk.
    q_positions: (B, Sq) or (Sq,); KV positions are arange(Skv); causal
    mask q_pos >= kv_pos, and with ``window`` also q_pos - kv_pos <
    window; ``attn_softcap`` caps the scores (``softcap``) before the
    mask. Score and PV products accumulate in f32 on the compute-dtype
    operands, as the reference's preferred_element_type."""
    k_q = isinstance(k, tuple)
    v_q = isinstance(v, tuple)
    k_arr = k[0] if k_q else k
    b, sq, h, hd = q.shape
    skv, kvh = k_arr.shape[1], k_arr.shape[2]
    g = h // kvh
    cd = q.dtype
    qf = (q * torch.tensor(hd ** -0.5, dtype=cd)    # host scalar: no sync
          ).reshape(b, sq, kvh, g, hd).to(torch.float32)
    c = min(kv_chunk, skv)
    qp = q_positions if q_positions.ndim == 2 else q_positions[None, :]

    def chunk(t, lo, hi, quantized):
        if quantized:
            codes, sc = t
            return (codes[:, lo:hi].to(cd) * sc[:, lo:hi].to(cd)
                    ).to(torch.float32)
        return t[:, lo:hi].to(cd).to(torch.float32)

    m = torch.full((b, kvh, g, sq), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, kvh, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, kvh, g, sq, hd), dtype=torch.float32,
                      device=q.device)
    for lo in range(0, skv, c):
        hi = min(lo + c, skv)
        kj = chunk(k, lo, hi, k_q)
        vj = chunk(v, lo, hi, v_q)
        pj = torch.arange(lo, hi, dtype=torch.int32, device=q.device)
        s = softcap(torch.einsum("bqkgd,bckd->bkgqc", qf, kj), attn_softcap)
        mask = qp[:, :, None] >= pj[None, None, :]
        if window is not None:
            mask = mask & ((qp[:, :, None] - pj[None, None, :]) < window)
        s = torch.where(mask[:, None, None, :, :], s,
                        torch.full_like(s, _NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        pv = torch.einsum("bkgqc,bckd->bkgqd",
                          p.to(cd).to(torch.float32), vj)
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd)
    return out.to(q.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x) as the reference's ``jax.nn.silu`` is written —
    x * (1 / (1 + exp(-x))), each op rounded to x's dtype. In bf16 this
    matches the reference bitwise, where ``F.silu`` (one rounding) does
    not."""
    return x * (1 / (1 + torch.exp(-x)))


_SQRT_2_OVER_PI = float(np.sqrt(2 / np.pi).astype(np.float32))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh approximation as the reference's ``jax.nn.gelu`` is
    written — x · (0.5 · (1 + tanh(√(2/π) · (x + 0.044715 · x³)))), x³ as
    x · x · x (``lax.integer_pow``), each op rounded to x's dtype."""
    inner = _SQRT_2_OVER_PI * (x + 0.044715 * (x * x * x))
    return x * (0.5 * (1.0 + torch.tanh(inner)))


def activation(name: str):
    return {"silu": silu, "gelu": gelu}[name]


def glu_mlp(p, x, act: str):
    """Gated MLP: down( act(gate(x)) * up(x) ). p: dict wg/wu/wd."""
    h = activation(act)(qlinear.dense(p["wg"], x)) * qlinear.dense(p["wu"], x)
    return qlinear.dense(p["wd"], h)


def quantize_kv(x: torch.Tensor, bits: int):
    """Symmetric per-(token, head) quantization of K/V.
    x (B, S, KV, hd) -> (codes int8, scale f32 (B, S, KV, 1))."""
    qmax = 2.0 ** (bits - 1) - 1
    xf = x.to(torch.float32)
    amax = torch.amax(torch.abs(xf), dim=-1, keepdim=True)
    # the compiled reference turns ``/ qmax`` into a multiply by the f32
    # reciprocal; the port does the same (one ulp apart otherwise)
    scale = torch.clamp_min(amax, 1e-12) * _f32_reciprocal(qmax)
    codes = torch.clamp(torch.round(xf / scale), -qmax - 1, qmax)
    return codes.to(torch.int8), scale


def _write_kv(cache, x, pos):
    """Write x (B, S, ...) in place into cache (B, Smax, ...) at rows
    [pos, pos+S). ``pos`` is an int (the whole batch at one offset) or a
    (B,) tensor of per-slot offsets (continuous batching: every slot at
    its own position). As the reference's ``dynamic_update_slice``, a
    start is clamped to [0, Smax - S]."""
    b, s = x.shape[:2]
    top = cache.shape[1] - s
    x = x.to(cache.dtype)
    if not torch.is_tensor(pos) or pos.ndim == 0:
        start = min(max(int(pos), 0), top)
        cache[:, start:start + s] = x
        return cache
    dev = cache.device
    rows = (pos.to(device=dev, dtype=torch.int64).clamp(0, top)[:, None]
            + torch.arange(s, device=dev))
    cache[torch.arange(b, device=dev)[:, None], rows] = x
    return cache


def cache_update(cache_k, cache_v, k, v, pos):
    """Write k, v (B, S, KV, hd) into the slot caches at [pos, pos+S);
    ``pos`` an int or (B,) per-slot offsets (see ``_write_kv``)."""
    return _write_kv(cache_k, k, pos), _write_kv(cache_v, v, pos)


def cache_update_quantized(ck, cks, cv, cvs, k, v, pos, bits: int):
    """int8 slot-cache write: ``quantize_kv`` codes and per-token scales
    (the paged pool's rule, so both caches hold the same values) at
    [pos, pos+S); ``pos`` an int or (B,) per-slot offsets."""
    kq, ks = quantize_kv(k, bits)
    vq, vs = quantize_kv(v, bits)
    return (_write_kv(ck, kq, pos), _write_kv(cks, ks, pos),
            _write_kv(cv, vq, pos), _write_kv(cvs, vs, pos))


def _f32_reciprocal(v: float) -> float:
    """1 / v rounded to f32, as a Python float (exact in f32 arithmetic)."""
    return float(np.float32(1.0) / np.float32(v))


def _paged_indices(page_table, pos, b, s, page_size):
    """Physical (page, row) targets for writing (B, S) tokens starting at
    ``pos`` (int or (B,)) into a paged pool. Positions past the table and
    table entries of 0 land on the null page 0.
    Returns flat ((B*S,) page ids, (B*S,) rows)."""
    dev = page_table.device
    if not torch.is_tensor(pos) or pos.ndim == 0:
        pos = torch.full((b,), int(pos), dtype=torch.int32, device=dev)
    logical = pos.to(torch.int64)[:, None] + torch.arange(s, device=dev)[None]
    n_ptab = page_table.shape[1]
    pidx = logical // page_size
    valid = pidx < n_ptab
    pids = torch.gather(page_table.to(torch.int64), 1,
                        torch.clamp_max(pidx, n_ptab - 1))
    pids = torch.where(valid, pids, torch.zeros_like(pids))
    rows = logical % page_size
    return pids.reshape(-1), rows.reshape(-1)


def _write_kv_paged(pool, x, page_table, pos):
    """Scatter x (B, S, KV, d) in place into pool (n_pages, G, KV, d) at the
    pages ``page_table`` (B, n_ptab) names for logical rows [pos, pos+S)."""
    b, s = x.shape[:2]
    pids, rows = _paged_indices(page_table, pos, b, s, pool.shape[1])
    pool[pids, rows] = x.reshape((b * s,) + tuple(x.shape[2:])).to(pool.dtype)
    return pool


def paged_cache_update(ck, cv, k, v, page_table, pos):
    """fp paged write of k, v (B, S, KV, hd)."""
    return (_write_kv_paged(ck, k, page_table, pos),
            _write_kv_paged(cv, v, page_table, pos))


def paged_cache_update_quantized(ck, cks, cv, cvs, k, v, page_table, pos,
                                 bits: int):
    """int8 paged write: ``quantize_kv`` codes + per-token scales."""
    kq, ks = quantize_kv(k, bits)
    vq, vs = quantize_kv(v, bits)
    return (_write_kv_paged(ck, kq, page_table, pos),
            _write_kv_paged(cks, ks, page_table, pos),
            _write_kv_paged(cv, vq, page_table, pos),
            _write_kv_paged(cvs, vs, page_table, pos))


def copy_pool_pages(pool, src, dst):
    """Copy whole pages ``src`` -> ``dst`` along a pool leaf's page axis
    (axis 1: leaves are (L, n_pages, page_size, ...)), in place: the prefix
    cache's copy-on-write split. ``src``/``dst`` are (C,) int tensors;
    padding pairs are (0, 0), a null-page self-copy (the gather reads every
    source before any write lands)."""
    pool[:, dst.long()] = pool[:, src.long()]
    return pool


def gather_pages(pool, page_table):
    """(n_pages, G, KV, d) pool + (B, n_ptab) table -> the logical
    (B, n_ptab*G, KV, d) view."""
    b, n_ptab = page_table.shape
    g = pool.shape[1]
    return pool[page_table.long()].reshape((b, n_ptab * g)
                                           + tuple(pool.shape[2:]))


def fake_quant_kv(x: torch.Tensor, bits: Optional[int]):
    """Training/calibration forward without a cache: simulate the KV
    quantization numerics (dynamic per-token asymmetric fake quant)."""
    from repro_torch.core.quantizers import QuantSpec, fake_quant
    spec = QuantSpec(bits=bits, symmetric=False, per="token", dynamic=True)
    return fake_quant(x, spec)
