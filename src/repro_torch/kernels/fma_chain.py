"""Dot products as in-order f32 fma chains, the same on every device.

The CUDA kernels of the transform (``csrc/cluster_tq.cuh``,
``block_matmul.cu``, ``hadamard.cu``) compute each output of a dot as
one ``fmaf`` chain over k from 0: acc = fma(x[k], w[k], acc) for k = 0,
1, ... An f32 product of a library fixes no order: MKL takes another
micro-kernel under AVX2 than under AVX-512, cuBLAS another kernel for one
row than for eight, and XLA-CPU's ``jnp.dot`` another association again.
So the plain versions of those kernels run the chain here themselves.
Each step is the correctly rounded f32 fma, emulated in f64: x·w is exact
in f64 (24 + 24 significant bits), the sum is rounded to odd (its TwoSum
error tells which neighbour), and an f64 rounded to odd then rounded to
f32 is the f32 rounding of the exact sum (Boldo and Melquiond, 2008).
Every step is IEEE f64 elementwise arithmetic, so the result is bitwise
the same on any CPU and on the card.
"""
from __future__ import annotations

import torch


def _round_sum(p: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """f32(p + acc) rounded once, for an f64 ``p`` and an f32 ``acc``."""
    a = acc.double()
    s = p + a
    t = s - p
    err = (p - (s - t)) + (a - t)             # s + err == p + a exactly
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def chain_dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """out[..., n] = fma chain over k of x[..., k]·w[..., n, k] from 0.

    x (..., K) and w (..., N, K) f32, their leading dims broadcast
    -> (..., N) f32."""
    x64, w64 = x.double(), w.double()
    shape = torch.broadcast_shapes(x.shape[:-1] + (1,), w.shape[:-1])
    acc = torch.zeros(shape, dtype=torch.float32, device=x.device)
    for k in range(x.shape[-1]):
        acc = _round_sum(x64[..., k, None] * w64[..., k], acc)
    return acc
