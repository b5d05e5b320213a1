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

The CUDA source is ``src/repro_torch/csrc/dynamic_quant.cu``: one CTA per
row, the row range by warp shuffles, then the quant arithmetic the fused
linear's cluster transform shares (``transform_quant.cuh``: ``rintf`` for
``jnp.round``, the same reciprocal scale, IEEE division by the scale), so
codes are bitwise the plain version's. What bounds it on the H100 is bytes (the activation in,
the codes out) over HBM bandwidth; the design reads and writes each
element once.

The wrapper launches the kernel for CUDA tensors (counted in
``dynamic_quant.launches``) and takes the plain PyTorch version only for
CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quantizers import times_recip

from . import build

_C = ctypes.c_int
_P = ctypes.c_void_p
_SIGNATURES = {"dynamic_quant": [_P, _C, _C, _C, _C, _C, _P, _P, _P, _P]}
_SMEM_MAX = 48 * 1024


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
    if 4 * x.shape[-1] > _SMEM_MAX:
        raise ValueError(f"D={x.shape[-1]} needs {4 * x.shape[-1]} B of "
                         f"shared memory; the kernel takes at most "
                         f"{_SMEM_MAX}")


def dynamic_quant(x: torch.Tensor, bits: int = 8, symmetric: bool = False):
    """Per-token (last-axis) dynamic quant: x (..., D) f32/bf16 -> (q int8
    (..., D), scale f32 (..., 1), zp f32 (..., 1))."""
    if not x.is_cuda:
        return dynamic_quant_plain(x, bits, symmetric)
    _validate(x, bits)
    lead, d = x.shape[:-1], x.shape[-1]
    xf = x.reshape(-1, d).contiguous()
    m = xf.shape[0]
    q = torch.empty((m, d), dtype=torch.int8, device=x.device)
    scale = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    zp = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    if m and d:
        lib = build.load("dynamic_quant", _SIGNATURES)
        build.check(lib.dynamic_quant(
            build.ptr(xf), int(x.dtype == torch.bfloat16), m, d, bits,
            int(symmetric), build.ptr(q), build.ptr(scale), build.ptr(zp),
            build.stream_of(x)), "dynamic_quant")
        dynamic_quant.launches += 1
    return (q.reshape(*lead, d), scale.reshape(*lead, 1),
            zp.reshape(*lead, 1))


dynamic_quant.launches = 0
