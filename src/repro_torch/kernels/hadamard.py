"""Sign and Kronecker Hadamard transform.

Replaces the Pallas TPU kernel ``hadamard_transform`` of
``src/repro/kernels/hadamard.py:37``: y = (x ⊙ sign) @ (ha ⊗ hb)ᵀ in f32,
with the output in x's dtype (``sign=None`` means ones). The factors come
from ``core.hadamard.hadamard_factors``: (32, 16) for D 512 and (32, 48)
for D 1536.

The CUDA source is ``src/repro_torch/csrc/hadamard.cu``: a CTA owns a
tile of rows (whole, in shared memory) and a slice of the b output
columns, whose two factor dots stay inside the slice; each thread keeps
one accumulator per row of the tile, so each factor element it reads
serves them all, and each output element is one in-order fmaf chain, as
in the fused linear's cluster transform (``csrc/cluster_tq.cuh``), so the
two agree bitwise in f32. The rows per CTA and the width limit (a CTA's shared
memory) live in the CUDA source alone. What bounds it on the H100 is
bytes (the activation in and out) over HBM bandwidth; the design reads
each row once per column slice and the factors once per CTA.

The wrapper launches the kernel for CUDA tensors (counted in
``hadamard_transform.launches``) and takes the plain PyTorch version only
for CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .fma_chain import chain_dot

_C = ctypes.c_int
_P = ctypes.c_void_p
_SIGNATURES = {"hadamard_transform": [_P, _C, _C, _C, _P, _P, _C, _P, _C,
                                      _C, _P, _P]}


def hadamard_f32(xf: torch.Tensor, ha: torch.Tensor, hb: torch.Tensor
                 ) -> torch.Tensor:
    """(M, D) f32 rows through the two Kronecker-factor dots, in the
    kernels' op order (the right factor on the (M·a, b) view, then the left
    one on the (M·b, a) view), each output one in-order fma chain from 0
    (``fma_chain.chain_dot``), as the CUDA kernels compute it, at every
    row count -> (M, D) f32."""
    m, d = xf.shape
    a, b = ha.shape[0], hb.shape[0]
    y = chain_dot(xf.reshape(m * a, b), hb.to(torch.float32))
    y = y.reshape(m, a, b).transpose(1, 2).reshape(m * b, a)
    y = chain_dot(y, ha.to(torch.float32))
    return y.reshape(m, b, a).transpose(1, 2).reshape(m, d)


def hadamard_transform_plain(x, ha, hb, sign=None) -> torch.Tensor:
    """Plain PyTorch version: x (..., D) -> (..., D) in x's dtype."""
    d = x.shape[-1]
    xf = x.reshape(-1, d).to(torch.float32)
    if sign is not None:
        xf = xf * sign.to(torch.float32)
    return hadamard_f32(xf, ha, hb).to(x.dtype).reshape(x.shape)


def _validate(x, ha, hb, sign):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be f32 or bf16, got {x.dtype}")
    d = x.shape[-1]
    a, b = ha.shape[0], hb.shape[0]
    if ha.shape != (a, a) or hb.shape != (b, b) or a * b != d:
        raise ValueError(f"Hadamard factors {tuple(ha.shape)}x"
                         f"{tuple(hb.shape)} do not span D={d}")
    if sign is not None and sign.shape != (d,):
        raise ValueError(f"sign {tuple(sign.shape)} must be ({d},)")
    for name, t in (("ha", ha), ("hb", hb), ("sign", sign)):
        if t is not None and (t.dtype != torch.float32
                              or t.device != x.device):
            raise TypeError(f"{name} must be f32 on {x.device}")


def hadamard_transform(x: torch.Tensor, ha: torch.Tensor, hb: torch.Tensor,
                       sign=None, *, rows: int = 0) -> torch.Tensor:
    """y = (x ⊙ sign) @ (ha ⊗ hb)ᵀ: x (..., a·b) f32/bf16, ha (a, a), hb
    (b, b), sign (a·b,) f32 or None -> (..., a·b) in x's dtype. ``rows``
    per CTA (1, 2, 4 or 8) overrides the CUDA source's choice (0), for a
    sweep; the result does not depend on it."""
    if not x.is_cuda:
        return hadamard_transform_plain(x, ha, hb, sign)
    _validate(x, ha, hb, sign)
    d = x.shape[-1]
    xf = x.reshape(-1, d).contiguous()
    out = torch.empty_like(xf)
    if xf.shape[0] and d:
        lib = build.load("hadamard", _SIGNATURES)
        ha, hb = ha.contiguous(), hb.contiguous()
        sign = None if sign is None else sign.contiguous()
        build.check(lib.hadamard_transform(
            build.ptr(xf), int(x.dtype == torch.bfloat16), xf.shape[0], d,
            build.ptr(sign), build.ptr(ha), ha.shape[0], build.ptr(hb),
            hb.shape[0], rows, build.ptr(out), build.stream_of(x)),
            "hadamard_transform")
        hadamard_transform.launches += 1
    return out.reshape(x.shape)


hadamard_transform.launches = 0
