"""The fused CAT serving linear: transform -> act quant -> W4 contraction.

Replaces the Pallas TPU kernels ``fused_cat_gemv_w4`` and
``fused_cat_matmul_w4`` of ``src/repro/kernels/fused_cat_matmul.py``:

    block-CAT (per-block dots) -> ⊙ sign -> Kronecker Hadamard (two factor
    dots) -> per-token asymmetric act quant (signed-shifted codes) ->
    int4-unpack -> exact integer dot -> sx·sw·(acc − zx·colsum)

The CUDA source is ``src/repro_torch/csrc/fused_cat_matmul.cu``: a
transform-quant launch (one CTA per row, in shared memory) followed by a
contraction launch (GEMV for M <= 8; above, the tensor-core contraction
of ``quant_matmul`` and ``quant_matmul_w4``, for int8 or packed int4
weights). What bounds it
on the H100 is the packed weight stream (D/2 x N bytes) at decode shapes
and at the 128-row step alike; the design reads each weight byte once per
row tile and keeps the codes on chip. The code round trip between the two
launches costs (K_pad + 8) bytes per row written and read once.

Each wrapper launches its kernel for CUDA tensors (and counts the launch
in ``<wrapper>.launches``) and takes the plain PyTorch version, which
repeats the kernel's arithmetic in the kernel's op order
(``ref.kernel_transform_quant`` in the reference), only for CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quantizers import unpack_int4

from . import build
from .block_matmul import block_diag_f32
from .dynamic_quant import dynamic_quant_plain
from .hadamard import hadamard_f32
from .quant_matmul import quant_matmul_plain, w8a8_plan
from .quant_matmul_w4 import GEMV_M

_C = ctypes.c_int
_P = ctypes.c_void_p
_HEAD = [_P, _C, _C, _C, _C, _P, _C, _P, _P, _C, _P, _C, _C, _P, _C, _P,
         _C]                 # x ... n
_TAIL = [_P] * 5             # qx, sx, zx, out, stream
# the tiled entry adds the contraction's K splits and their scratch
_SIGNATURES = {"fused_cat_gemv_w4": _HEAD + _TAIL,
               "fused_cat_matmul_w4": _HEAD + [_C, _P] + _TAIL}


# ------------------------------------------------------------ plain version

def transform_quant_plain(x, blocks, ha, hb, sign, act_bits: int):
    """CAT transform + dynamic per-token asymmetric quant in the kernel's
    op order (per-block dots, the two Kronecker-factor dots, then the
    signed-shifted quant), all in f32. -> (q int8 (M, D), scale (M, 1),
    zp (M, 1))."""
    xf = x.to(torch.float32)
    if blocks is not None:
        xf = block_diag_f32(xf, blocks)
    y = hadamard_f32(xf * sign.to(torch.float32), ha, hb)
    return dynamic_quant_plain(y, act_bits)


def fused_cat_linear_plain(x, blocks, ha, hb, sign, qw, sw, *,
                           act_bits: int = 8, packed: bool = True):
    """Plain PyTorch version of both fused-linear kernels -> (M, N) f32."""
    q, sx, zx = transform_quant_plain(x, blocks, ha, hb, sign, act_bits)
    w = unpack_int4(qw, x.shape[1], axis=0) if packed else qw
    return quant_matmul_plain(q, sx, zx, w, sw)


# ------------------------------------------------------------ CUDA launch

def _validate(x, blocks, ha, hb, sign, qw, sw, act_bits, packed):
    m, d = x.shape
    n = qw.shape[1]
    if packed and qw.shape[0] != (d + 1) // 2:
        raise ValueError(f"packed qw {tuple(qw.shape)} needs ceil(D/2) rows "
                         f"for D={d}")
    if not packed and qw.shape[0] != d:
        raise ValueError(f"qw {tuple(qw.shape)} needs D={d} rows")
    if ha.shape[0] * hb.shape[0] != d:
        raise ValueError(f"Hadamard factors {tuple(ha.shape)}x"
                         f"{tuple(hb.shape)} do not span D={d}")
    if blocks is not None and blocks.shape[0] * blocks.shape[1] != d:
        raise ValueError(f"CAT blocks {tuple(blocks.shape)} do not span "
                         f"D={d}")
    if not 2 <= act_bits <= 8:
        raise ValueError(f"act_bits must be in [2, 8], got {act_bits}")
    if sw.shape != (1, n):
        raise ValueError(f"sw {tuple(sw.shape)} must be (1, {n})")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be f32 or bf16, got {x.dtype}")
    if qw.dtype != torch.int8:
        raise TypeError(f"qw must be int8, got {qw.dtype}")
    smem = 4 * (2 * d + ha.shape[0] ** 2 + hb.shape[0] ** 2)
    if smem > 48 * 1024:
        raise ValueError(f"transform stage needs {smem} B of shared memory "
                         f"(D={d}); the kernel takes at most 48 KiB")
    dev = x.device
    for name, t in (("blocks", blocks), ("ha", ha), ("hb", hb),
                    ("sign", sign), ("sw", sw)):
        if t is not None and (t.dtype != torch.float32 or t.device != dev):
            raise TypeError(f"{name} must be f32 on {dev}")
    if qw.device != dev:
        raise TypeError(f"qw must be on {dev}")


def _launch(fn_name, x, blocks, ha, hb, sign, qw, sw, act_bits, packed):
    _validate(x, blocks, ha, hb, sign, qw, sw, act_bits, packed)
    lib = build.load("fused_cat_matmul", _SIGNATURES)
    x, qw, sw = x.contiguous(), qw.contiguous(), sw.contiguous()
    ha, hb, sign = ha.contiguous(), hb.contiguous(), sign.contiguous()
    blocks = None if blocks is None else blocks.contiguous()
    m, d = x.shape
    n = qw.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return out
    k_pad = 2 * qw.shape[0] if packed else d
    qx = torch.empty((m, k_pad), dtype=torch.int8, device=x.device)
    sx = torch.empty((m,), dtype=torch.float32, device=x.device)
    zx = torch.empty((m,), dtype=torch.float32, device=x.device)
    bk = 0 if blocks is None else blocks.shape[1]
    split = ()
    if fn_name == "fused_cat_matmul_w4":
        splits, ws = w8a8_plan(m, k_pad, n, x.device)
        split = (splits, build.ptr(ws))
    code = getattr(lib, fn_name)(
        build.ptr(x), int(x.dtype == torch.bfloat16), m, d, k_pad,
        build.ptr(blocks), bk, build.ptr(sign), build.ptr(ha), ha.shape[0],
        build.ptr(hb), hb.shape[0], act_bits, build.ptr(qw), int(packed),
        build.ptr(sw), n, *split, build.ptr(qx), build.ptr(sx),
        build.ptr(zx), build.ptr(out), build.stream_of(x))
    build.check(code, fn_name)
    return out


def fused_cat_gemv_w4(x, blocks, ha, hb, sign, qw, sw, *, act_bits: int = 8,
                      packed: bool = True) -> torch.Tensor:
    """Decode-shaped fused CAT linear for M <= 8 rows.

    x (M, D) f32/bf16; blocks (n, k, k) f32 CAT factors or None; ha/hb
    Kronecker Hadamard factors; sign (D,) (a Scale CAT factor folded in);
    qw (ceil(D/2), N) nibble-packed int4 codes — or (D, N) int8 codes with
    ``packed=False``; sw (1, N) f32 -> (M, N) f32."""
    if x.shape[0] > GEMV_M:
        raise ValueError(f"GEMV variant is for M <= {GEMV_M}, got "
                         f"M={x.shape[0]}")
    if not x.is_cuda:
        return fused_cat_linear_plain(x, blocks, ha, hb, sign, qw, sw,
                                      act_bits=act_bits, packed=packed)
    out = _launch("fused_cat_gemv_w4", x, blocks, ha, hb, sign, qw, sw,
                  act_bits, packed)
    fused_cat_gemv_w4.launches += 1
    return out


def fused_cat_matmul_w4(x, blocks, ha, hb, sign, qw, sw, *,
                        act_bits: int = 8, packed: bool = True
                        ) -> torch.Tensor:
    """Tiled fused CAT linear for M > 8 rows (operands as in
    ``fused_cat_gemv_w4``)."""
    if not x.is_cuda:
        return fused_cat_linear_plain(x, blocks, ha, hb, sign, qw, sw,
                                      act_bits=act_bits, packed=packed)
    out = _launch("fused_cat_matmul_w4", x, blocks, ha, hb, sign, qw, sw,
                  act_bits, packed)
    fused_cat_matmul_w4.launches += 1
    return out


fused_cat_gemv_w4.launches = 0
fused_cat_matmul_w4.launches = 0
