"""Dynamic per-token quantization.

Replaces the Pallas TPU kernel ``dynamic_quant`` of
``src/repro/kernels/dynamic_quant.py:44``: each row of x to int8 codes
with an f32 scale and zero point, at 2–8 bits, asymmetric (codes and zero
point shifted by 2^(bits-1) into the signed range) or symmetric (zero
point 0), bitwise as the Pallas kernel computes them: XLA compiles the
division of the range by the level count as a multiply by the f32
reciprocal, and divides by the scale for zero point and codes (the eager
``ref.dynamic_quant`` divides by the level count and is an ulp off in
some scales).

The CUDA source is ``src/repro_torch/csrc/dynamic_quant.cu``: one warp per
row, the row held in registers as 16-byte vectors, its range by warp
shuffles, then the quant arithmetic the fused linear's cluster transform
shares (``transform_quant.cuh``: ``rintf`` for ``jnp.round``, the same
reciprocal scale, IEEE division by the scale), so codes are bitwise the
plain version's; widths the register path does not take run a general
path, so every width the reference takes runs. The plan (rows per CTA,
vectors per lane, the general-path switch) is ``csrc/dq_plan.h``'s, read
here through ``plan``. What bounds it on the H100 at the path's shapes is
the launch and its chain of dependent steps: its bytes (the activation
in, the codes out) take well under a microsecond.

The wrapper launches the kernel for CUDA tensors (counted in
``dynamic_quant.launches``) and takes the plain PyTorch version only for
CPU tensors.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.core.quantizers import times_recip

from . import build

_C = ctypes.c_int
_P = ctypes.c_void_p
_SIGNATURES = {
    "dynamic_quant": [_P, _C, _C, _C, _C, _C, _C, _P, _P, _P, _P],
    "dq_plan": [_C, _C, _C, _C, _C, ctypes.POINTER(_C)],
}


class Plan(NamedTuple):
    rows: int   # rows (warps) per CTA
    vecs: int   # 16-byte vectors per lane; 0: the general path
    ctas: int   # CTAs of the grid


def plan(m: int, d: int, elt: int, aligned: bool = True, rows: int = 0,
         lib=None) -> Plan:
    """The kernel's plan (``dq::plan`` of ``csrc/dq_plan.h``, which the
    entry runs on every call) for ``m`` rows of ``d`` elements of ``elt``
    bytes (4: f32, 2: bf16) starting at a 16-byte boundary when
    ``aligned``; ``rows`` forces the rows per CTA (0: the plan's). ``lib``
    a library exporting ``dq_plan`` (default: the built CUDA library).
    Raises ValueError for a shape the kernel does not take."""
    lib = lib or build.load("dynamic_quant", _SIGNATURES)
    out = (ctypes.c_int * 3)()
    if lib.dq_plan(m, d, elt, int(aligned), rows, out):
        raise ValueError(f"dynamic_quant does not take M={m}, D={d}, "
                         f"{elt}-byte elements, rows={rows}: it needs M, D "
                         f">= 1, f32 or bf16 and rows per CTA in 0..8 "
                         f"(csrc/dq_plan.h)")
    return Plan(*out)


def dynamic_quant_plain(x: torch.Tensor, bits: int = 8,
                        symmetric: bool = False):
    """Plain PyTorch version -> (q int8 (..., D), scale f32 (..., 1),
    zp f32 (..., 1))."""
    xf = x.to(torch.float32)
    if symmetric:
        qmax = 2.0 ** (bits - 1) - 1
        amax = torch.amax(torch.abs(xf), dim=-1, keepdim=True)
        scale = times_recip(torch.clamp_min(amax, 1e-12), qmax)
        zp = torch.zeros_like(scale)
        q = torch.clamp(torch.round(xf / scale), -qmax - 1, qmax)
    else:
        levels = 2.0 ** bits - 1
        xmin = xf.amin(-1, keepdim=True)
        xmax = xf.amax(-1, keepdim=True)
        scale = times_recip(torch.clamp_min(xmax - xmin, 1e-12), levels)
        zp = torch.round(-xmin / scale)
        q = torch.clamp(torch.round(xf / scale + zp), 0, levels)
        q = q - 2.0 ** (bits - 1)
        zp = zp - 2.0 ** (bits - 1)
    return q.to(torch.int8), scale, zp


def _validate(x, bits):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be f32 or bf16, got {x.dtype}")
    if not 2 <= bits <= 8:
        raise ValueError(f"bits must be in [2, 8], got {bits}")


def dynamic_quant(x: torch.Tensor, bits: int = 8, symmetric: bool = False,
                  rows: int = 0):
    """Per-token (last-axis) dynamic quant: x (..., D) f32/bf16 -> (q int8
    (..., D), scale f32 (..., 1), zp f32 (..., 1)). ``rows`` forces the
    kernel's rows per CTA (0: the plan's)."""
    if build.off_card(x, "dynamic_quant"):
        return dynamic_quant_plain(x, bits, symmetric)
    _validate(x, bits)
    lead, d = x.shape[:-1], x.shape[-1]
    q, scale, zp = _launch(x.reshape(-1, d).contiguous(), bits, symmetric,
                           rows)
    return (q.reshape(*lead, d), scale.reshape(*lead, 1),
            zp.reshape(*lead, 1))


def _launch(xf: torch.Tensor, bits: int, symmetric: bool, rows: int):
    """Run the kernel on xf (m, d) -> (q (m, d), scale (m, 1), zp (m, 1)).
    The entry computes its plan from the shape, the dtype and xf's
    address; ``rows`` forces the rows per CTA (0: the plan's)."""
    m, d = xf.shape
    q = torch.empty((m, d), dtype=torch.int8, device=xf.device)
    scale = torch.empty((m, 1), dtype=torch.float32, device=xf.device)
    zp = torch.empty((m, 1), dtype=torch.float32, device=xf.device)
    if m and d:
        lib = build.load("dynamic_quant", _SIGNATURES)
        build.check(lib.dynamic_quant(
            build.ptr(xf), int(xf.dtype == torch.bfloat16), m, d, bits,
            int(symmetric), rows, build.ptr(q), build.ptr(scale),
            build.ptr(zp), build.stream_of(xf)), "dynamic_quant")
        dynamic_quant.launches += 1
    return q, scale, zp


dynamic_quant.launches = 0

