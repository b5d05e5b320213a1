"""Uniform integer quantizers (the paper's Section 2 setting), in PyTorch.

Counterpart of ``repro.core.quantizers``: the same ``QuantSpec``, range
estimation (including the L2.4 grid search), quantize / dequantize /
fake-quant, and the int4 nibble packing, whose bytes are identical to
the reference's (even K in the low nibble, odd K zero-padded).

Dtype behaviour follows the reference: arithmetic stays in the input's
dtype (bf16 activations quantize with bf16 scales, as JAX's weakly typed
Python scalars keep them), and ``dequantize`` computes in f32.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

# Tiny epsilon guarding divide-by-zero on all-zero ranges.
_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Declarative description of one quantizer."""

    bits: int = 4
    symmetric: bool = True
    per: str = "tensor"  # "tensor" | "token" | "channel"
    dynamic: bool = True
    # L_p norm-minimizing range search (GPTQ's L2.4 trick) — weights only.
    range_p: Optional[float] = None
    range_grid: int = 64

    @property
    def n_levels(self) -> int:
        """N(b) = 2^b - 1 quantization intervals (paper notation)."""
        return 2**self.bits - 1

    @property
    def qmin(self) -> int:
        return -(2 ** (self.bits - 1)) if self.symmetric else 0

    @property
    def qmax(self) -> int:
        return 2 ** (self.bits - 1) - 1 if self.symmetric else 2**self.bits - 1


def _reduce_dims(x: torch.Tensor, spec: QuantSpec) -> tuple:
    if spec.per == "tensor":
        return tuple(range(x.ndim))
    return (x.ndim - 1,)


def _amax(x, dims):
    return torch.amax(x, dim=dims, keepdim=True)


def _amin(x, dims):
    return torch.amin(x, dim=dims, keepdim=True)


def compute_scale_zp(x: torch.Tensor, spec: QuantSpec):
    """Range estimation -> (scale, zero_point). Keeps reduced dims (size 1)."""
    dims = _reduce_dims(x, spec)
    if spec.range_p is not None:
        return _lp_optimal_scale(x, spec, dims)
    if spec.symmetric:
        amax = _amax(torch.abs(x), dims)
        scale = torch.clamp_min(amax, _EPS) / spec.qmax
        zp = torch.zeros_like(scale)
    else:
        xmin = _amin(x, dims)
        xmax = _amax(x, dims)
        scale = torch.clamp_min(xmax - xmin, _EPS) / spec.n_levels
        zp = torch.round(-xmin / scale)
    return scale, zp


def times_recip(t: torch.Tensor, levels: float) -> torch.Tensor:
    """t * f32(1 / levels), one rounded multiply: the compiled reference
    folds a division by the level count into a multiply by its f32
    reciprocal. The reciprocal is a Python float that is exact in f32, so
    no host tensor is copied (CUDA-graph safe)."""
    recip = (torch.tensor(1.0, dtype=torch.float32) / levels).item()
    return t * recip


def quantize_dynamic(x: torch.Tensor, spec: QuantSpec):
    """``quantize`` with min/max ranges, as ``jax.jit`` compiles the
    reference's: the scale is the range times the f32 reciprocal of the
    level count (``times_recip``); zero point and codes divide by that
    scale rounded to ``x``'s dtype. The scale comes back unrounded in f32:
    XLA-CPU computes a bf16 chain in f32 and drops the scale's round trip
    through bf16 where it feeds f32 arithmetic (route 3's epilogue, the
    low-precision fake quant's dequant). The weight and static quant keep
    ``quantize``, which divides, as the eager reference does. -> (q, f32
    scale, zp)."""
    dims = _reduce_dims(x, spec)
    if spec.symmetric:
        rng, zp, levels = _amax(torch.abs(x), dims), None, spec.qmax
    else:
        xmin = _amin(x, dims)
        rng, levels = _amax(x, dims) - xmin, spec.n_levels
    scale32 = times_recip(torch.clamp_min(rng, _EPS).to(torch.float32),
                          levels)
    scale = scale32.to(x.dtype)
    if not spec.symmetric:
        zp = torch.round(-xmin / scale)
    q, _, zp = quantize(x, spec, scale, zp)
    return q, scale32, zp


def _lp_optimal_scale(x: torch.Tensor, spec: QuantSpec, dims):
    """Grid-search the clipping range minimizing E|x - Q(x)|^p (p=2.4)."""
    p = spec.range_p
    amax = torch.clamp_min(_amax(torch.abs(x), dims), _EPS)
    fracs = np.linspace(0.35, 1.0, spec.range_grid).astype(np.float32)
    best_err = best_frac = None
    for frac in fracs:      # first minimum wins, as jnp.argmin
        f = torch.tensor(frac, dtype=x.dtype, device=x.device)
        scale = amax * f / spec.qmax
        q = torch.clamp(torch.round(x / scale), spec.qmin, spec.qmax)
        err = torch.sum(torch.abs(q * scale - x) ** p, dim=dims, keepdim=True)
        if best_err is None:
            best_err, best_frac = err, torch.full_like(err, float(frac))
        else:
            better = err < best_err
            best_err = torch.where(better, err, best_err)
            best_frac = torch.where(better, f.to(err.dtype), best_frac)
    scale = amax * best_frac.to(amax.dtype) / spec.qmax
    return scale, torch.zeros_like(scale)


def _store_dtype(spec: QuantSpec):
    if spec.qmin >= -128 and spec.qmax <= 127:
        return torch.int8
    if spec.qmin >= 0 and spec.qmax <= 255:
        return torch.uint8
    return torch.int32


def quantize(x: torch.Tensor, spec: QuantSpec, scale=None, zp=None):
    """-> (q integer codes, scale, zp). Static params may be passed."""
    if scale is None:
        scale, zp = compute_scale_zp(x, spec)
    if zp is None:
        zp = torch.zeros_like(scale)
    q = torch.round(x / scale + zp)
    q = torch.clamp(q, spec.qmin, spec.qmax)
    return q.to(_store_dtype(spec)), scale, zp


def dequantize(q, scale, zp, dtype=torch.float32):
    return ((q.to(torch.float32) - zp) * scale).to(dtype)


def fake_quant(x: torch.Tensor, spec: QuantSpec, scale=None,
               zp=None) -> torch.Tensor:
    """Quantize-dequantize in the input dtype (the analysis workhorse)."""
    if (scale is None and not spec.symmetric and spec.range_p is None
            and x.dtype in (torch.bfloat16, torch.float16)):
        return _fake_quant_asym_lowp(x, spec)
    q, scale, zp = quantize(x, spec, scale, zp)
    return dequantize(q, scale, zp, x.dtype)


def _fake_quant_asym_lowp(x: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """Dynamic asymmetric fake quant of bf16/f16 ``x`` as the reference
    computes it under ``jax.jit``: XLA folds ``range / n_levels`` into a
    multiply by the f32 reciprocal, rounds that scale to ``x``'s dtype
    only for the division, and dequantizes with the unrounded f32 scale
    (``quantize_dynamic``). Every other op rounds to ``x``'s dtype, as
    torch's low-precision ops do."""
    q, scale_f32, zp = quantize_dynamic(x, spec)
    return ((q.to(torch.float32) - zp.to(torch.float32)) * scale_f32
            ).to(x.dtype)


# ---------------------------------------------------------------------------
# Int4 packing (two nibbles per int8 byte, serving storage format)
# ---------------------------------------------------------------------------

def pack_int4(q: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """Pack int4-range codes (values in [-8, 7]) two per byte along
    ``axis``: byte[i] = (q[2i] & 0xF) | (q[2i+1] << 4). Odd sizes are
    zero-padded. Output size along ``axis`` is ceil(n/2)."""
    axis = axis % q.ndim
    q = q.to(torch.int32)
    if q.shape[axis] % 2:
        pad_shape = list(q.shape)
        pad_shape[axis] = 1
        q = torch.cat([q, q.new_zeros(pad_shape)], dim=axis)
    n = q.shape[axis]
    lo = q.index_select(axis, torch.arange(0, n, 2, device=q.device))
    hi = q.index_select(axis, torch.arange(1, n, 2, device=q.device))
    packed = (lo & 0xF) | ((hi & 0xF) << 4)
    # two's-complement wrap of 0..255 into int8
    return torch.where(packed > 127, packed - 256, packed).to(torch.int8)


def unpack_int4(packed: torch.Tensor, n: Optional[int] = None,
                axis: int = -2) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: -> int8 codes in [-8, 7], sized ``n``
    along ``axis`` (pass the original size to strip odd-size padding).
    Each nibble is sign-extended by arithmetic shifts of the int8 byte."""
    p = packed.to(torch.int8)
    axis = axis % p.ndim
    lo = torch.bitwise_right_shift(torch.bitwise_left_shift(p, 4), 4)
    hi = torch.bitwise_right_shift(p, 4)
    q = torch.stack([lo, hi], dim=axis + 1)
    shape = list(p.shape)
    shape[axis] *= 2
    q = q.reshape(shape)
    if n is not None:
        q = q.narrow(axis, 0, n)
    return q


def int_matmul(q: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact integer contraction of integer codes -> f32. Products of codes
    accumulate in float64, exact below 2^53 (|acc| < 2^25 here), which is
    the reference's int32 accumulation on every device (CUDA has no
    integer matmul in PyTorch)."""
    return (q.to(torch.float64) @ w.to(torch.float64)).to(torch.float32)


def quant_range(x: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """r(x) from the paper, the full quantized interval: max - min
    (asymmetric) or 2·max|x| (symmetric), per row for per-token/channel
    specs, with the reduced dims squeezed out."""
    dims = _reduce_dims(x, spec)
    if spec.symmetric:
        return 2.0 * torch.amax(torch.abs(x), dim=dims)
    return torch.amax(x, dim=dims) - torch.amin(x, dim=dims)


# ---------------------------------------------------------------------------
# Paper defaults (Section 6 experimental setup)
# ---------------------------------------------------------------------------

def act_spec(bits: int = 4) -> QuantSpec:
    """Activations: dynamic, per-token, asymmetric."""
    return QuantSpec(bits=bits, symmetric=False, per="token", dynamic=True)


def weight_spec(bits: int = 4, range_p: Optional[float] = 2.4) -> QuantSpec:
    """Weights: static, per-channel, symmetric, L2.4 range estimation."""
    return QuantSpec(bits=bits, symmetric=True, per="channel", dynamic=False,
                     range_p=range_p)


def kv_spec(bits: int = 8) -> QuantSpec:
    """KV cache: dynamic per-token asymmetric (paper setup)."""
    return QuantSpec(bits=bits, symmetric=False, per="token", dynamic=True)
