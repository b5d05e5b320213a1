"""Function-preserving linear transforms for quantization (paper Section
3-4), in PyTorch — counterpart of ``repro.core.transforms``.

A transform T acts on a linear layer as  Wx = (W T⁻¹)(T x):
  apply(t, x)          = x @ Tᵀ
  fuse_weight(t, W)    = W @ T⁻¹          for W of shape (d_out, d_in)
  fuse_cov(t, Σ)       = T Σ Tᵀ

Transforms are frozen dataclasses of tensors; ``to_device`` moves one
and ``index_layer`` slices a layer-stacked one.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from . import cat as cat_lib
from .hadamard import hadamard_factors


@dataclasses.dataclass(frozen=True)
class Identity:
    pass


@dataclasses.dataclass(frozen=True)
class Scale:
    """T = Diag(s): per-channel scaling."""
    s: torch.Tensor  # (d,)


@dataclasses.dataclass(frozen=True)
class Dense:
    """Arbitrary invertible T."""
    t: torch.Tensor      # (d, d)
    t_inv: torch.Tensor  # (d, d)


@dataclasses.dataclass(frozen=True)
class Hadamard:
    """Randomized orthonormal Hadamard T = (Ha ⊗ Hb) · Diag(sign)."""
    ha: torch.Tensor    # (a, a)
    hb: torch.Tensor    # (b, b)
    sign: torch.Tensor  # (d,) ±1


@dataclasses.dataclass(frozen=True)
class BlockDiag:
    """T = Diag(M_1..M_{d/k}) — the CAT block transform."""
    blocks: torch.Tensor      # (n, k, k)
    inv_blocks: torch.Tensor  # (n, k, k)


@dataclasses.dataclass(frozen=True)
class Compose:
    """T = parts[-1] · ... · parts[0]  (parts[0] applied first)."""
    parts: Tuple


Transform = (Identity, Scale, Dense, Hadamard, BlockDiag, Compose)


def map_tensors(t, fn):
    """Apply ``fn`` to every tensor field of a transform."""
    if isinstance(t, Compose):
        return Compose(tuple(map_tensors(p, fn) for p in t.parts))
    if isinstance(t, Identity):
        return t
    return dataclasses.replace(t, **{
        f.name: fn(getattr(t, f.name)) for f in dataclasses.fields(t)})


# ---------------------------------------------------------------------------
# Constructors
# ---------------------------------------------------------------------------

def make_hadamard(d: int, rng: np.random.Generator | None = None,
                  device="cpu") -> Hadamard:
    ha, hb = hadamard_factors(d)
    sign = (rng.integers(0, 2, size=d).astype(np.float32) * 2 - 1
            if rng is not None else np.ones(d, dtype=np.float32))
    f32 = dict(dtype=torch.float32, device=device)
    return Hadamard(torch.tensor(ha, **f32), torch.tensor(hb, **f32),
                    torch.tensor(sign, **f32))


def make_rotation(d: int, rng: np.random.Generator, device="cpu") -> Dense:
    """Random orthogonal matrix (SpinQuant-style, untrained): numpy QR of a
    standard normal draw from ``rng`` with the R diagonal's signs folded
    in, so the same ``rng`` gives the reference's matrix."""
    q, r = np.linalg.qr(rng.standard_normal((d, d)))
    q = q * np.sign(np.diag(r))[None, :]
    t = torch.tensor(q, dtype=torch.float32, device=device)
    return Dense(t, t.T)


def make_smoothquant(act_absmax: torch.Tensor, weight_absmax: torch.Tensor,
                     alpha: float = 0.5) -> Scale:
    """SmoothQuant: s_i = max|x_i|^α / max_j|w_ji|^(1-α), T = Diag(1/s)
    (activations divided by s, weights multiplied)."""
    s = (torch.clamp_min(act_absmax, 1e-5) ** alpha
         / torch.clamp_min(weight_absmax, 1e-5) ** (1 - alpha))
    return Scale(1.0 / torch.clamp_min(s, 1e-5))


def make_cat_full(sigma_w, sigma_x) -> Dense:
    """The full-rank alignment-optimal transform M̂ and its inverse."""
    m = cat_lib.cat_optimal(sigma_w, sigma_x)
    return Dense(m, torch.linalg.inv(m))


def cat_block_size(d: int, k: int) -> int:
    """The CAT block of width d for block k: min(k, d), or the largest
    divisor of d below it."""
    k = min(k, d)
    return k if d % k == 0 else max(j for j in range(1, k + 1) if d % j == 0)


def cat_from_blocks(sw_blocks, sx_blocks):
    """M̂ᵏ_block from the (n, k, k) diagonal blocks of Σ_w and Σ_x, all it
    reads of them: at k = 1 the per-channel closed form
    (``cat_lib.cat_diagonal``), else the stacked blocks and inverses."""
    n, k, _ = sw_blocks.shape
    if k == 1:
        return Scale((sw_blocks.reshape(n) / torch.clamp_min(
            sx_blocks.reshape(n), 1e-30)) ** 0.25)
    blocks = cat_lib.cat_optimal(sw_blocks, sx_blocks)
    return BlockDiag(blocks, cat_lib.inv_blocks(blocks))


def make_cat_block(sigma_w, sigma_x, k: int = 128, hadamard: bool = True,
                   rng: np.random.Generator | None = None):
    """The paper's T̂ᵏ_block = H · M̂ᵏ_block (eq. 10)."""
    d = sigma_w.shape[0]
    k = cat_block_size(d, k)
    mt = cat_from_blocks(*(cat_lib.diag_blocks(s, k)
                           for s in (sigma_w, sigma_x)))
    if not hadamard:
        return mt
    return Compose((mt, make_hadamard(d, rng, device=sigma_w.device)))


# ---------------------------------------------------------------------------
# Application / fusion
# ---------------------------------------------------------------------------

def apply(t, x: torch.Tensor) -> torch.Tensor:
    """Online activation transform: x -> x @ Tᵀ (leading dims preserved)."""
    if isinstance(t, Identity):
        return x
    if isinstance(t, Scale):
        return x * t.s.to(x.dtype)
    if isinstance(t, Dense):
        return x @ t.t.T.to(x.dtype)
    if isinstance(t, Hadamard):
        return _hadamard_apply(x * t.sign.to(x.dtype), t.ha, t.hb)
    if isinstance(t, BlockDiag):
        return cat_lib.apply_block_diag(x, t.blocks.to(x.dtype))
    if isinstance(t, Compose):
        for p in t.parts:
            x = apply(p, x)
        return x
    raise TypeError(type(t))


def _hadamard_apply(x: torch.Tensor, ha: torch.Tensor,
                    hb: torch.Tensor) -> torch.Tensor:
    """y = x @ Hᵀ with H = ha ⊗ hb: Y = ha @ X @ hbᵀ on X = x.reshape(a, b).
    The factors are cast to the activation dtype, as in the reference."""
    a, b = ha.shape[0], hb.shape[0]
    shape = x.shape
    xr = x.reshape(*shape[:-1], a, b)
    y = torch.einsum("ij,...jk,lk->...il", ha.to(x.dtype), xr, hb.to(x.dtype))
    return y.reshape(shape)


def fuse_weight(t, w: torch.Tensor) -> torch.Tensor:
    """Offline: W -> W T⁻¹ so that (W T⁻¹)(T x) = W x. W: (d_out, d_in)."""
    if isinstance(t, Identity):
        return w
    if isinstance(t, Scale):
        return w / t.s[None, :].to(w.dtype)
    if isinstance(t, Dense):
        return w @ t.t_inv.to(w.dtype)
    if isinstance(t, Hadamard):
        return _hadamard_apply(w * t.sign[None, :].to(w.dtype), t.ha, t.hb)
    if isinstance(t, BlockDiag):
        n, k, _ = t.inv_blocks.shape
        d_out = w.shape[0]
        wb = w.reshape(d_out, n, k)
        out = torch.einsum("onk,nkb->onb", wb, t.inv_blocks.to(w.dtype))
        return out.reshape(d_out, n * k)
    if isinstance(t, Compose):
        for p in t.parts:
            w = fuse_weight(p, w)
        return w
    raise TypeError(type(t))


def fuse_cov(t, sigma: torch.Tensor) -> torch.Tensor:
    """Σ -> T Σ Tᵀ (autocorrelation of transformed activations)."""
    if isinstance(t, Identity):
        return sigma
    if isinstance(t, Scale):
        return sigma * t.s[:, None] * t.s[None, :]
    if isinstance(t, Dense):
        return t.t @ sigma @ t.t.T
    if isinstance(t, Hadamard):
        s = sigma * t.sign[:, None] * t.sign[None, :]
        s = _hadamard_apply(s, t.ha, t.hb)       # rows
        return _hadamard_apply(s.T, t.ha, t.hb).T   # cols
    if isinstance(t, BlockDiag):
        dense = cat_lib.blocks_to_dense(t.blocks)
        return dense @ sigma @ dense.T
    if isinstance(t, Compose):
        for p in t.parts:
            sigma = fuse_cov(p, sigma)
        return sigma
    raise TypeError(type(t))


def as_dense_matrix(t, d: int) -> torch.Tensor:
    """Materialize T as a (d, d) matrix (tests and small models only)."""
    return apply(t, torch.eye(d, dtype=torch.float32)).T


def online_flops(t, d: int) -> float:
    """Serving-time FLOPs per token of the online transform."""
    if isinstance(t, Identity):
        return 0.0
    if isinstance(t, Scale):
        return d
    if isinstance(t, Dense):
        return 2.0 * d * d
    if isinstance(t, Hadamard):
        a, b = t.ha.shape[0], t.hb.shape[0]
        return 2.0 * d * (a + b) + d
    if isinstance(t, BlockDiag):
        n, k, _ = t.blocks.shape
        return 2.0 * n * k * k
    if isinstance(t, Compose):
        return sum(online_flops(p, d) for p in t.parts)
    raise TypeError(type(t))
