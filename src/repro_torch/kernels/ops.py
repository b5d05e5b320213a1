"""Dispatch to the port's kernels — counterpart of ``repro.kernels.ops``.

The reference chooses between Pallas interpret mode and Mosaic codegen by
backend and environment (``ops.py:32-60``). Here one device test decides,
inside each kernel wrapper: a CUDA tensor launches the kernel, a CPU
tensor takes the kernel's plain PyTorch version. ``use_fused_decode``
decides, as the reference's does, whether decode layers take the
two-launch path (``decode_qkv_prologue`` + paged attention).

The stand-alone kernels go by the reference's ``ops`` names
(``block_matmul``, ``hadamard``, ``dyn_quant``, ``qmatmul``,
``qmatmul_w4``, ``qgemv_w4``) and compose into ``cat_transform_matmul``,
the deployed linear in four launches.
"""
from __future__ import annotations

import os

import torch

from repro_torch.core import transforms as T

from .block_matmul import block_diag_matmul as block_matmul
from .decode_layer import decode_qkv_prologue  # noqa: F401
from .dynamic_quant import dynamic_quant as dyn_quant
from .fused_cat_matmul import GEMV_M, fused_cat_gemv_w4, fused_cat_matmul_w4
from .hadamard import hadamard_transform as hadamard
from .paged_attention import (paged_attention_decode,
                              paged_attention_fallback,
                              paged_attention_ragged,
                              paged_attention_ragged_fallback)
from .quant_matmul import quant_matmul as qmatmul
from .quant_matmul_w4 import quant_gemv_w4 as qgemv_w4
from .quant_matmul_w4 import quant_matmul_w4 as qmatmul_w4

_FALSY = ("", "0", "false", "no", "off")


def use_fused_decode(device) -> bool:
    """Whether decode layers on ``device`` route through the two-launch
    fused path (``decode_qkv_prologue`` + paged attention).

    ``REPRO_DECODE_FUSED`` overrides in both directions (``1`` enables it
    on the CPU, where the kernels' plain versions run; ``0`` pins the
    composed path); unset, it is on for CUDA devices and off on the CPU,
    as the reference's is on its TPU and off elsewhere."""
    env = os.environ.get("REPRO_DECODE_FUSED")
    if env is not None:
        return env.strip().lower() not in _FALSY
    return getattr(device, "type", device) == "cuda"


def fused_transform_operands(t):
    """Decompose a CAT transform into the fused kernel's ``(blocks, ha, hb,
    sign)`` operands, or None when it doesn't fit: a bare ``Hadamard``, or
    a ``Compose`` of (``Scale`` | ``BlockDiag`` | ``Identity``,
    ``Hadamard``). A ``Scale`` folds into the pre-Hadamard sign."""
    if isinstance(t, T.Hadamard):
        return None, t.ha, t.hb, t.sign
    if not isinstance(t, T.Compose) or len(t.parts) != 2:
        return None
    first, had = t.parts
    if not isinstance(had, T.Hadamard):
        return None
    if isinstance(first, T.Scale):
        return None, had.ha, had.hb, had.sign * first.s
    if isinstance(first, T.BlockDiag):
        return first.blocks, had.ha, had.hb, had.sign
    if isinstance(first, T.Identity):
        return None, had.ha, had.hb, had.sign
    return None


def fused_cat_matmul(x, blocks, ha, hb, sign, qw, sw, act_bits: int = 8,
                     packed: bool = True):
    """Serving linear y ≈ W·T⁻¹·Q(T x): the GEMV kernel for M <= 8 rows,
    the tiled kernel above. x (..., D) -> (..., N) in x's dtype."""
    lead, d = x.shape[:-1], x.shape[-1]
    xf = x.reshape(-1, d)
    run = fused_cat_gemv_w4 if xf.shape[0] <= GEMV_M else fused_cat_matmul_w4
    y = run(xf, blocks, ha, hb, sign, qw, sw, act_bits=act_bits,
            packed=packed)
    return y.reshape(*lead, y.shape[-1]).to(x.dtype)


def cat_transform_matmul(x, blocks, ha, hb, sign, qw, sw, act_bits: int = 4,
                         packed_int4: bool = False):
    """The paper's deployed quantized linear layer, composed of the
    stand-alone kernels: y ≈ W·T⁻¹·Q(T x) with T = H·M̂_block.

    block-CAT (``block_matmul``; skipped when ``blocks`` is None) ->
    sign ⊙ Hadamard (``hadamard``) -> dynamic per-token asymmetric quant
    (``dyn_quant``) -> ``qgemv_w4`` for packed weights at M <= 8 rows,
    ``qmatmul_w4`` for packed weights above, ``qmatmul`` for int8 weights.
    The block-CAT and Hadamard outputs are rounded to x's dtype between
    launches, as the reference's are; so in bf16 this is not the fused
    linear, and in f32 it is, up to the order of the dot sums.

    x (..., d) f32/bf16; blocks (n, k, k) f32 or None; sign (d,) f32; qw
    (d, d_out) int8 codes — or, with ``packed_int4``, (ceil(d/2), d_out)
    nibble-packed int4 codes; sw (1, d_out) f32 -> (..., d_out) in x's
    dtype. The reference's ``axis_name`` (a K-sharded call inside a
    tensor-parallel mesh) waits for the port of tensor-parallel serving."""
    lead, d = x.shape[:-1], x.shape[-1]
    xf = x.reshape(-1, d)
    if blocks is not None:
        xf = block_matmul(xf, blocks)
    xf = hadamard(xf, ha, hb, sign)
    qx, sx, zpx = dyn_quant(xf, bits=act_bits, symmetric=False)
    if not packed_int4:
        y = qmatmul(qx, sx, zpx, qw, sw)
    elif qx.shape[0] <= GEMV_M:
        y = qgemv_w4(qx, sx, zpx, qw, sw)
    else:
        y = qmatmul_w4(qx, sx, zpx, qw, sw)
    return y.reshape(*lead, qw.shape[1]).to(x.dtype)


def paged_attention(q, k_pages, k_scale, v_pages, v_scale, page_table,
                    lengths):
    """Paged decode attention: int8 pools go to the decode kernel, fp pools
    (no scales) to the gather fallback."""
    if k_scale is None or v_scale is None:
        return paged_attention_fallback(q, k_pages, k_scale, v_pages,
                                        v_scale, page_table, lengths)
    return paged_attention_decode(q, k_pages, k_scale, v_pages, v_scale,
                                  page_table, lengths)


def ragged_paged_attention(q, k_pages, k_scale, v_pages, v_scale,
                           page_table, lengths, q_pos):
    """Mixed-q_len paged attention for the unified step: int8 pools go to
    the ragged kernel, fp pools to the gather fallback."""
    if k_scale is None or v_scale is None:
        return paged_attention_ragged_fallback(q, k_pages, k_scale,
                                               v_pages, v_scale, page_table,
                                               lengths, q_pos)
    return paged_attention_ragged(q, k_pages, k_scale, v_pages, v_scale,
                                  page_table, lengths, q_pos)


def step_paged_attention(q, k_pages, k_scale, v_pages, v_scale, desc):
    """A unified step's attention over its T packed rows on int8 pools:
    q (T, KVH, g, hd) -> (T, KVH, g, hd) in q's dtype.

    ``desc`` is the scheduler's ragged descriptor (``qidx``, ``qpos``,
    ``lengths``, ``table``, ``inv_seq``, ``inv_qi``) with the executor's
    routing (``launch.executor.route_rows``): ``dec_rows``, ``dec_table``
    and ``dec_len`` (the first ``n_dec`` real) name the rows whose logits
    the step reads — decode rows, every row of a verify item and a
    completing prefill chunk's last row — and those attend through the
    decode kernel, one query row per item at its own length, as a
    pure-decode step's rows do; so a query row's bits do not depend on the
    step shape that carried it. The rest (``n_ragged`` valid rows left in
    ``qpos``) attend through the ragged kernel in per-item blocks."""
    if desc["n_ragged"]:
        ob = ragged_paged_attention(
            q[desc["qidx"].long()], k_pages, k_scale, v_pages, v_scale,
            desc["table"], desc["lengths"].to(torch.int32),
            desc["qpos"].to(torch.int32))
        out = ob[desc["inv_seq"].long(), desc["inv_qi"].long()]
    else:
        out = torch.zeros_like(q)
    n = desc["n_dec"]
    if n:
        rows = desc["dec_rows"][:n].long()
        od = paged_attention(q[rows], k_pages, k_scale, v_pages, v_scale,
                             desc["dec_table"][:n],
                             desc["dec_len"][:n].to(torch.int32))
        out = out.index_copy(0, rows, od)
    return out
