"""Block-diagonal matmul: the online block-CAT transform.

Replaces the Pallas TPU kernel ``block_diag_matmul`` of
``src/repro/kernels/block_matmul.py:26``: y = x @ blockdiag(B)ᵀ for
blocks (n, k, k), in f32, with the output in x's dtype.

The CUDA source is ``src/repro_torch/csrc/block_matmul.cu``: one CTA per
(tile of up to 16 rows, block), B_i and the tile's slice of x staged in
shared memory once, each output element one fmaf chain over its block's
row of B in the order of the fused linear's cluster transform
(``csrc/cluster_tq.cuh``), so the two agree bitwise in f32. What bounds
it on the H100 is bytes (the activation in and out, plus the blocks once)
over HBM bandwidth; the design reads the activation once, writes it once
and reads each block once per row tile.

The wrapper launches the kernel for CUDA tensors (and counts the launch
in ``block_diag_matmul.launches``) and takes the plain PyTorch version
only for CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .fma_chain import chain_dot

_C = ctypes.c_int
_P = ctypes.c_void_p
_SIGNATURES = {"block_diag_matmul": [_P, _C, _C, _C, _P, _C, _P, _P]}


def block_diag_f32(xf: torch.Tensor, blocks: torch.Tensor) -> torch.Tensor:
    """(M, D) f32 rows through the per-block dots, each output one
    in-order fma chain over its block's row from 0
    (``fma_chain.chain_dot``), as the CUDA kernels compute it, at every
    row count -> (M, D) f32."""
    m, d = xf.shape
    nblk, bk, _ = blocks.shape
    y = chain_dot(xf.reshape(m, nblk, bk), blocks.to(torch.float32))
    return y.reshape(m, d)


def block_diag_matmul_plain(x: torch.Tensor, blocks: torch.Tensor
                            ) -> torch.Tensor:
    """Plain PyTorch version: x (..., D) -> (..., D) in x's dtype."""
    d = x.shape[-1]
    y = block_diag_f32(x.reshape(-1, d).to(torch.float32), blocks)
    return y.to(x.dtype).reshape(x.shape)


def _validate(x, blocks):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be f32 or bf16, got {x.dtype}")
    if blocks.dtype != torch.float32 or blocks.device != x.device:
        raise TypeError(f"blocks must be f32 on {x.device}")
    d = x.shape[-1]
    if (blocks.ndim != 3 or blocks.shape[1] != blocks.shape[2]
            or blocks.shape[0] * blocks.shape[1] != d):
        raise ValueError(f"blocks {tuple(blocks.shape)} must be (n, k, k) "
                         f"with n*k = D = {d}")


def block_diag_matmul(x: torch.Tensor, blocks: torch.Tensor) -> torch.Tensor:
    """y = x @ blockdiag(B)ᵀ: x (..., n·k) f32/bf16, blocks (n, k, k) f32
    -> (..., n·k) in x's dtype."""
    if not x.is_cuda:
        return block_diag_matmul_plain(x, blocks)
    _validate(x, blocks)
    d = x.shape[-1]
    xf = x.reshape(-1, d).contiguous()
    out = torch.empty_like(xf)
    if xf.shape[0] and d:
        lib = build.load("block_matmul", _SIGNATURES)
        blocks = blocks.contiguous()
        build.check(lib.block_diag_matmul(
            build.ptr(xf), int(x.dtype == torch.bfloat16), xf.shape[0], d,
            build.ptr(blocks), blocks.shape[1], build.ptr(out),
            build.stream_of(x)), "block_diag_matmul")
        block_diag_matmul.launches += 1
    return out.reshape(x.shape)


block_diag_matmul.launches = 0
