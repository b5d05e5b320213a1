"""CAT: Concentration-Alignment Transforms (paper Section 4), in PyTorch.

Counterpart of ``repro.core.cat``: the alignment-optimal transform
M̂ = (Σ_w # Σ_x⁻¹)^(1/2) via eigendecompositions, its block-diagonal
approximation (as a (d, d) matrix or as stacked (n, k, k) blocks), the
matrix geometric mean, and the streaming Σ_x accumulator (host numpy,
float64). Batched over leading dims where the
reference vmaps.
"""
from __future__ import annotations

import numpy as np
import torch


def _sym(a):
    return (a + a.transpose(-1, -2)) / 2.0


def spd_power(a: torch.Tensor, p: float, eps: float = 1e-9) -> torch.Tensor:
    """A^p for symmetric PSD A (batched over leading dims) via eigh, with
    eigenvalue floor eps * max(eig)."""
    a = _sym(a.to(torch.float64 if a.dtype == torch.float64
                  else torch.float32))
    lam, q = torch.linalg.eigh(a)
    floor = torch.clamp_min(lam.amax(-1, keepdim=True), 0.0) * eps + 1e-30
    lam = torch.maximum(lam, floor)
    return _sym((q * lam.pow(p).unsqueeze(-2)) @ q.transpose(-1, -2))


def geometric_mean(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Matrix geometric mean A # B = A^½ (A^-½ B A^-½)^½ A^½ for SPD A, B."""
    a_h = spd_power(a, 0.5)
    a_mh = spd_power(a, -0.5)
    mid = spd_power(a_mh @ _sym(b) @ a_mh, 0.5)
    return _sym(a_h @ mid @ a_h)


def cat_optimal(sigma_w: torch.Tensor, sigma_x: torch.Tensor) -> torch.Tensor:
    """M̂ = (Σ_w # Σ_x⁻¹)^(1/2) in the closed form
    M̂² = Σ_x^(-1/2) (Σ_x^(1/2) Σ_w Σ_x^(1/2))^(1/2) Σ_x^(-1/2)."""
    x_h = spd_power(sigma_x, 0.5)
    x_mh = spd_power(sigma_x, -0.5)
    mid = spd_power(x_h @ _sym(sigma_w) @ x_h, 0.5)
    m2 = _sym(x_mh @ mid @ x_mh)
    return spd_power(m2, 0.5)


def cat_diagonal(sigma_w: torch.Tensor, sigma_x: torch.Tensor) -> torch.Tensor:
    """k=1 closed form: M̂¹ = Diag(m), m_i = (Σw_ii / Σx_ii)^(1/4)."""
    dw = torch.diagonal(sigma_w)
    dx = torch.diagonal(sigma_x)
    return torch.diag((dw / torch.clamp_min(dx, 1e-30)) ** 0.25)


def block_slices(d: int, k: int):
    """Partition [0, d) into ceil(d/k) contiguous blocks (the last may be
    short)."""
    return [(i, min(i + k, d)) for i in range(0, d, k)]


def cat_block(sigma_w: torch.Tensor, sigma_x: torch.Tensor,
              k: int = 128) -> torch.Tensor:
    """Block-diagonal M̂ᵏ_block as a full (d, d) matrix: each k×k diagonal
    block of (Σ_w, Σ_x) gets its own optimal transform (any k; the last
    block may be short)."""
    d = sigma_w.shape[0]
    if k >= d:
        return cat_optimal(sigma_w, sigma_x)
    if k == 1:
        return cat_diagonal(sigma_w, sigma_x)
    return torch.block_diag(*[
        cat_optimal(sigma_w[lo:hi, lo:hi], sigma_x[lo:hi, lo:hi])
        for lo, hi in block_slices(d, k)])


def _extract_diag_blocks(a: torch.Tensor, n: int, k: int) -> torch.Tensor:
    a = a.reshape(n, k, n, k)
    idx = torch.arange(n, device=a.device)
    return a[idx, :, idx, :]


def diag_blocks(a: torch.Tensor, k: int) -> torch.Tensor:
    """The (d//k, k, k) diagonal blocks of a (d, d) matrix; k | d."""
    return _extract_diag_blocks(a, a.shape[0] // k, k)


def cat_block_stacked(sigma_w: torch.Tensor, sigma_x: torch.Tensor,
                      k: int) -> torch.Tensor:
    """(d//k, k, k) stacked block-diagonal CAT factors. Requires k | d."""
    d = sigma_w.shape[0]
    if d % k:
        raise ValueError(f"block size {k} must divide {d}")
    n = d // k
    return cat_optimal(_extract_diag_blocks(sigma_w, n, k),
                       _extract_diag_blocks(sigma_x, n, k))


def blocks_to_dense(blocks: torch.Tensor) -> torch.Tensor:
    return torch.block_diag(*blocks.unbind(0))


def apply_block_diag(x: torch.Tensor, blocks: torch.Tensor) -> torch.Tensor:
    """y = x @ Mᵀ_blockdiag for x (..., d), blocks (n, k, k):
    y[..., i, a] = Σ_b blocks[i, a, b] x[..., i, b]."""
    n, k, _ = blocks.shape
    shape = x.shape
    xb = x.reshape(*shape[:-1], n, k)
    yb = torch.einsum("...nk,nak->...na", xb, blocks)
    return yb.reshape(shape)


def inv_blocks(blocks: torch.Tensor) -> torch.Tensor:
    return torch.linalg.inv(blocks.to(torch.float32))


class CovAccumulator:
    """Streaming E[xxᵀ] (autocorrelation, not centered), E[x²] and the
    per-channel absmax, host-side numpy in float64 (calibration runs
    once, offline)."""

    def __init__(self, d: int):
        self.d = d
        self.sigma = np.zeros((d, d), dtype=np.float64)
        self.sq = np.zeros((d,), dtype=np.float64)
        self.amax = np.zeros((d,), dtype=np.float64)
        self.n = 0

    def update(self, x) -> None:
        x = np.asarray(x, dtype=np.float64).reshape(-1, self.d)
        self.sigma += x.T @ x
        self.sq += (x**2).sum(0)
        self.amax = np.maximum(self.amax, np.abs(x).max(0))
        self.n += x.shape[0]

    def cov(self) -> np.ndarray:
        if self.n == 0:
            raise ValueError("no calibration data accumulated")
        return self.sigma / self.n

    def mean_sq(self) -> np.ndarray:
        return self.sq / self.n
