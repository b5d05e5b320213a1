"""Quantized linear dispatch — counterpart of ``repro.core.qlinear``.

Model code calls ``dense(p, x)`` for every linear layer. ``p`` is either a
plain tensor ``V`` of shape (d_in, d_out) (fp path) or a ``QLinear``:
int8 (or nibble-packed int4) weight codes + per-output-channel scales +
an online activation transform + dynamic activation quant.

``dense_fused`` has the reference's three routes; route 1, the fused
CUDA kernel, is taken exactly when the activation lies on a CUDA device
(the reference takes its Pallas kernel exactly on a TPU).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from . import transforms as T
from .quantizers import (act_spec, fake_quant, int_matmul,
                         quantize_dynamic, unpack_int4)


@dataclasses.dataclass(frozen=True)
class QLinear:
    qweight: torch.Tensor         # int8 codes (d_in, d_out); int4-packed:
                                  # (ceil(d_in/2), d_out), two nibbles/byte;
                                  # an moe expert stack: (E, ...) leading
    scale: torch.Tensor           # f32, (1, d_out) [(E, 1, d_out)]
    transform: Any                # transform acting on the input dim
    # serving-only precomputes (``make_serving``): Σ_k codes (f32,
    # (1, d_out)) for the zero-point epilogue, and the dequantized
    # compute-dtype weight for the off-card fake-quant route
    colsum: Optional[torch.Tensor] = None
    w_eff: Optional[torch.Tensor] = None
    act_bits: int = 4             # dynamic per-token act quant bits (0 = off)
    w_bits: int = 8               # bit width of the stored weight codes
    d_in: int = 0                 # unpacked input dim when int4-packed

    @property
    def packed(self) -> bool:
        return self.d_in > 0

    def map_tensors(self, fn) -> "QLinear":
        """Apply ``fn`` to every tensor of the layer (device moves, layer
        slicing)."""
        opt = lambda v: None if v is None else fn(v)  # noqa: E731
        return dataclasses.replace(
            self, qweight=fn(self.qweight), scale=fn(self.scale),
            transform=T.map_tensors(self.transform, fn),
            colsum=opt(self.colsum), w_eff=opt(self.w_eff))


def unpacked_qweight(p: QLinear) -> torch.Tensor:
    """The int8 code tensor (d_in, d_out), unpacking int4 storage."""
    if p.packed:
        return unpack_int4(p.qweight, p.d_in, axis=-2)
    return p.qweight


def iter_qlinear(params) -> list:
    """(path, QLinear) pairs of a params tree (dicts and lists)."""
    out = []

    def walk(path, node):
        if isinstance(node, QLinear):
            out.append((path, node))
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(f"{path}.{k}" if path else k, v)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(f"{path}.{i}", v)

    walk("", params)
    return out


def fuse_weight_in(t, v: torch.Tensor) -> torch.Tensor:
    """Fuse T⁻¹ into an input-major weight V (d_in, d_out): V' = T⁻ᵀ V."""
    return T.fuse_weight(t, v.T).T


def dense(p, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """y = x @ V (fp) or the quantized equivalent (transform -> dyn act
    quant -> weight matmul with dequant)."""
    if isinstance(p, QLinear):
        if p.colsum is not None and p.act_bits:
            return dense_fused(p, x, compute_dtype)
        cd = compute_dtype or x.dtype
        x = T.apply(p.transform, x)
        if p.act_bits:
            x = fake_quant(x, act_spec(p.act_bits))
        w = unpacked_qweight(p).to(cd) * p.scale.to(cd)
        return x.to(cd) @ w
    cd = compute_dtype or x.dtype
    return x @ p.to(cd)


def _use_fused_kernel(x: torch.Tensor) -> bool:
    """Route 1 (the fused CUDA kernel) exactly when the activation is on a
    CUDA device — the counterpart of the reference's TPU-backend test."""
    return x.is_cuda


def dense_fused(p: QLinear, x: torch.Tensor, compute_dtype=None
                ) -> torch.Tensor:
    """Serving hot path for QLinears prepared by ``make_serving``:

    1. **CUDA + decomposable transform** — the fused CAT linear kernel
       (``ops.fused_cat_matmul``): transform + quant + W4A4/W4A8 + zero-
       point epilogue (rtol-level numerics).
    2. **``w_eff`` present** — the fake-quant matmul against the
       build-time dequantized weight, bitwise equal to ``dense`` on
       unprepared params.
    3. **integer accumulation** — real activation codes against stored
       codes: y = s_x·s_w·(q_x @ q_w − zp_x·Σ_k q_w)."""
    cd = compute_dtype or x.dtype
    lead, d = x.shape[:-1], x.shape[-1]
    if _use_fused_kernel(x) and p.act_bits:
        from repro_torch.kernels import ops
        dec = ops.fused_transform_operands(p.transform)
        if dec is not None:
            blocks, ha, hb, sign = dec
            y = ops.fused_cat_matmul(x.reshape(-1, d), blocks, ha, hb,
                                     sign, p.qweight, p.scale,
                                     act_bits=p.act_bits, packed=p.packed)
            return y.reshape(*lead, y.shape[-1]).to(cd)
    xt = T.apply(p.transform, x)
    if p.w_eff is not None:
        if p.act_bits:
            xt = fake_quant(xt, act_spec(p.act_bits))
        return xt.to(cd) @ p.w_eff.to(cd)
    xf = xt.reshape(-1, d)
    # the epilogue in f32 with the unrounded f32 act scale, rounded once
    # to the compute dtype, as XLA compiles the reference's
    q, s, zp = quantize_dynamic(xf, act_spec(p.act_bits))
    acc = int_matmul(q, unpacked_qweight(p))
    y = s * p.scale * (acc - zp.to(torch.float32) * p.colsum)
    return y.reshape(*lead, y.shape[-1]).to(cd)


def make_serving(p: QLinear, keep_packed: Optional[bool] = None,
                 compute_dtype=None) -> QLinear:
    """Precompute the weight-code column sums for the zero-point epilogue
    and — where route 1 will not serve the layer — the dequantized
    compute-dtype weight ``w_eff``. ``keep_packed=None`` keeps packed-only
    storage exactly when the weights live on a CUDA device (where the
    fused kernel unpacks them on chip)."""
    if keep_packed is None:
        keep_packed = p.qweight.is_cuda
    w = unpacked_qweight(p)
    colsum = torch.sum(w.to(torch.float32), dim=-2, keepdim=True)
    if keep_packed:
        return dataclasses.replace(p, colsum=colsum)
    cd = compute_dtype or torch.float32
    w_eff = w.to(cd) * p.scale.to(cd)
    return dataclasses.replace(p, colsum=colsum, w_eff=w_eff)


def concat_out(ps, keep_packed: Optional[bool] = None, compute_dtype=None):
    """Column-concatenate linears that consume the SAME input into one
    (d_in, Σ d_out) linear (exact). QLinears must share meta; the concat
    keeps the first member's transform. None when not concatenable."""
    if all(isinstance(p, torch.Tensor) for p in ps):
        return torch.cat(ps, dim=-1)
    if not all(isinstance(p, QLinear) for p in ps):
        return None
    head = ps[0]
    if any((p.act_bits, p.w_bits, p.d_in) !=
           (head.act_bits, head.w_bits, head.d_in) for p in ps[1:]):
        return None
    cat = dataclasses.replace(
        head,
        qweight=torch.cat([p.qweight for p in ps], dim=-1),
        scale=torch.cat([p.scale for p in ps], dim=-1))
    return make_serving(cat, keep_packed, compute_dtype)


def num_weight_bytes(p) -> int:
    if isinstance(p, QLinear):
        return (p.qweight.numel() * p.qweight.element_size()
                + p.scale.numel() * 4)
    return p.numel() * p.element_size()
