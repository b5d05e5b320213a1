"""W4A8 contractions from precomputed activation codes.

Replaces the Pallas TPU kernels ``quant_matmul_w4`` and ``quant_gemv_w4``
of ``src/repro/kernels/quant_matmul_w4.py:72`` and ``:127``: the W8A8
contraction of ``quant_matmul`` against nibble-packed int4 weight codes
qw (ceil(K/2), N) (even K index in the low nibble). Odd K follows the
reference: the last byte's high nibble is zero and qx is read as
zero-padded. ``quant_gemv_w4`` serves M <= 8 rows and raises above.

Both run ``src/repro_torch/csrc/quant_matmul.cu`` (entries
``quant_matmul_w4`` and ``quant_gemv_w4``), the contractions of the
fused linear's stage 2 (``contract.cuh``). ``quant_matmul_w4`` runs the
tensor-core contraction of the W8A8 ``quant_matmul`` (``mma.sync``
m16n8k32 s8 x s8 -> s32 on 64x64 tiles): each raw packed tile (32 packed
rows x 64 columns per 64-deep K step) goes by ``cp.async`` into a
four-deep ring and is unpacked to s8 while it is transposed in shared
memory; K is split across CTAs where the tiles alone would leave the
card's SMs idle, by the plan of the CUDA source (``w8a8_plan``). The GEMV
is the code GEMV of ``quant_matmul`` (``quant_matmul.gemv_plan``: a few
columns per CTA on every SM, dp4a over the packed weight staged by
16-byte ``cp.async``, nibbles unpacked in registers). What bounds them on the H100 is the packed
weight bytes (K/2 x N) over HBM bandwidth; the design reads each weight
byte once per 64-row tile (the GEMV: once). Exact integer accumulation
over all of K and one epilogue, as ``ref.quant_matmul_w4`` (the Pallas
kernels add one f32 epilogue per K tile).

Each wrapper launches its kernel for CUDA tensors (counted in
``<wrapper>.launches``), takes the plain PyTorch version only for CPU
tensors and raises for any other device.
"""
from __future__ import annotations

from repro_torch.core.quantizers import unpack_int4

from . import build
from .quant_matmul import GEMV_M, launch, quant_matmul_plain, validate


def quant_matmul_w4_plain(qx, sx, zpx, qw_packed, sw):
    """Plain PyTorch version of both W4A8 contractions -> (M, N) f32."""
    qw = unpack_int4(qw_packed, qx.shape[1], axis=0)
    return quant_matmul_plain(qx, sx, zpx, qw, sw)


def quant_matmul_w4(qx, sx, zpx, qw_packed, sw):
    """qx (M, K) int8, sx/zpx (M, 1) f32, qw_packed (ceil(K/2), N) int8,
    sw (1, N) f32 -> (M, N) f32."""
    if build.off_card(qx, "quant_matmul_w4"):
        return quant_matmul_w4_plain(qx, sx, zpx, qw_packed, sw)
    validate(qx, sx, zpx, qw_packed, sw, (qx.shape[1] + 1) // 2)
    out = launch("quant_matmul_w4", qx, sx, zpx, qw_packed, sw,
                 planned=True)
    quant_matmul_w4.launches += 1
    return out


def quant_gemv_w4(qx, sx, zpx, qw_packed, sw):
    """Decode-shaped W4A8 GEMV for M <= 8 rows (operands as in
    ``quant_matmul_w4``)."""
    if qx.shape[0] > GEMV_M:
        raise ValueError(f"GEMV path is for M <= {GEMV_M}, got "
                         f"M={qx.shape[0]}")
    if build.off_card(qx, "quant_gemv_w4"):
        return quant_matmul_w4_plain(qx, sx, zpx, qw_packed, sw)
    validate(qx, sx, zpx, qw_packed, sw, (qx.shape[1] + 1) // 2)
    out = launch("quant_gemv_w4", qx, sx, zpx, qw_packed, sw, gemv=True)
    quant_gemv_w4.launches += 1
    return out


quant_matmul_w4.launches = 0
quant_gemv_w4.launches = 0
