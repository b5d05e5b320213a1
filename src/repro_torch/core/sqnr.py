"""SQNR / concentration / alignment framework (paper Section 2) — the
counterpart of ``repro.core.sqnr``, in f32 torch.

Every quantity takes a weight matrix ``W`` (d_out, d_in) and a batch of
activations ``X`` (n, d_in), the rows being samples of p(x); expectations
are empirical means over the rows. Results are 0-dim f32 tensors.
Decibels: dB(v) = 10 log10(v).
"""
from __future__ import annotations

import torch

from .quantizers import (QuantSpec, act_spec, fake_quant, quant_range,
                         weight_spec)

_EPS = 1e-30


def _f32(a) -> torch.Tensor:
    return torch.as_tensor(a).to(torch.float32)


def db(v):
    return 10.0 * torch.log10(torch.clamp_min(_f32(v), _EPS))


def parallel(a, b):
    """Harmonic sum a ∥ b = (1/a + 1/b)^-1 (Lemma 2.1)."""
    return 1.0 / (1.0 / a + 1.0 / b)


# ---------------------------------------------------------------------------
# Measured SQNR (definition, eq. 1)
# ---------------------------------------------------------------------------

def sqnr_measured(W, X, Wq, Xq):
    """SQNR(W̃x̃) = E||Wx||² / E||Wx - W̃x̃||² over the rows of X."""
    y = X @ W.T
    yq = Xq @ Wq.T
    sig = torch.mean(torch.sum(_f32(y) ** 2, dim=-1))
    noise = torch.mean(torch.sum(_f32(y - yq) ** 2, dim=-1))
    return sig / torch.clamp_min(noise, _EPS)


def sqnr_quantized_layer(W, X, wspec: QuantSpec, xspec: QuantSpec):
    """Measured joint SQNR under fake quantization of both operands."""
    return sqnr_measured(W, X, fake_quant(W, wspec), fake_quant(X, xspec))


def sqnr_act_only(W, X, xspec: QuantSpec):
    return sqnr_measured(W, X, W, fake_quant(X, xspec))


def sqnr_weight_only(W, X, wspec: QuantSpec):
    return sqnr_measured(W, X, fake_quant(W, wspec), X)


# ---------------------------------------------------------------------------
# The three factors (Lemmas 2.2, 2.3)
# ---------------------------------------------------------------------------

def n_levels(bits: int) -> float:
    return float(2**bits - 1)


def concentration_act(X, xspec: QuantSpec):
    """C(x) = E||x||² / E[r(x)²]; r per token for per-token quant."""
    norm2 = torch.mean(torch.sum(_f32(X) ** 2, dim=-1))
    r = _f32(quant_range(X, xspec))
    return norm2 / torch.clamp_min(torch.mean(r**2), _EPS)


def concentration_weight(W, wspec: QuantSpec):
    """C(W) = Σᵢ||wᵢ||² / Σᵢ r(wᵢ)² over rows (output channels)."""
    norms = torch.sum(_f32(W) ** 2, dim=-1)
    r = _f32(quant_range(W, wspec))
    return torch.sum(norms) / torch.clamp_min(torch.sum(r**2), _EPS)


def alignment(W, X):
    """A(x, W) = E||Wx||² / (||W||_F² E||x||²) (second-order alignment)."""
    Wf, Xf = _f32(W), _f32(X)
    num = torch.mean(torch.sum((Xf @ Wf.T) ** 2, dim=-1))
    den = torch.sum(Wf**2) * torch.mean(torch.sum(Xf**2, dim=-1))
    return num / torch.clamp_min(den, _EPS)


def alignment_from_cov(W, sigma_x):
    """A(x, W) from Σ_x = E[xxᵀ]: Tr(W Σ_x Wᵀ) / (||W||_F² Tr(Σ_x))."""
    Wf, S = _f32(W), _f32(sigma_x)
    num = torch.trace(Wf @ S @ Wf.T)
    den = torch.sum(Wf**2) * torch.trace(S)
    return num / torch.clamp_min(den, _EPS)


def alignment_optimal(W, sigma_x):
    """Best achievable alignment (eq. 9, in the form CAT attains): A* =
    Σμᵢ² / (Σμᵢ)² with μᵢ = √λᵢ, λ the eigenvalues of Σ_y = W Σ_x Wᵀ (see
    the reference's docstring for why not the printed Σλ²/(Σλ)²)."""
    Wf = _f32(W)
    sy = Wf @ _f32(sigma_x) @ Wf.T
    lam = torch.linalg.eigvalsh((sy + sy.T) / 2.0)
    mu = torch.sqrt(torch.clamp_min(lam, 0.0))
    return torch.sum(mu**2) / torch.clamp_min(torch.sum(mu) ** 2, _EPS)


# ---------------------------------------------------------------------------
# Theorem 2.4 approximation
# ---------------------------------------------------------------------------

def sqnr_approx_act(W, X, xspec: QuantSpec):
    """Lemma 2.2: SQNR(Wx̃) ≈ 12 N(b_x)² C(x) A(x,W)."""
    return (12.0 * n_levels(xspec.bits) ** 2 * concentration_act(X, xspec)
            * alignment(W, X))


def sqnr_approx_weight(W, X, wspec: QuantSpec):
    """Lemma 2.3: SQNR(W̃x) ≈ 12 N(b_w)² C(W) A(x,W)."""
    return (12.0 * n_levels(wspec.bits) ** 2
            * concentration_weight(W, wspec) * alignment(W, X))


def sqnr_approx_joint(W, X, wspec: QuantSpec, xspec: QuantSpec):
    """Theorem 2.4: 12 (N(b_x)²C(x) ∥ N(b_w)²C(W)) A(x,W)."""
    cx = n_levels(xspec.bits) ** 2 * concentration_act(X, xspec)
    cw = n_levels(wspec.bits) ** 2 * concentration_weight(W, wspec)
    return 12.0 * parallel(cx, cw) * alignment(W, X)


def sqnr_ratio(W, X, wspec: QuantSpec, xspec: QuantSpec):
    """r(x, W) = SQNR(Wx̃)/SQNR(W̃x) (eq. 2): < 1 ⇒ activations dominate."""
    return (sqnr_approx_act(W, X, xspec)
            / sqnr_approx_weight(W, X, wspec))


def layer_report(W, X, bits_w=4, bits_x=4) -> dict:
    """The per-layer diagnostic of the benchmarks and tests, in dB."""
    wspec, xspec = weight_spec(bits_w), act_spec(bits_x)
    Xf = _f32(X)
    sigma_x = (Xf.T @ Xf) / X.shape[0]
    return {
        "sqnr_measured_db": db(sqnr_quantized_layer(W, X, wspec, xspec)),
        "sqnr_approx_db": db(sqnr_approx_joint(W, X, wspec, xspec)),
        "sqnr_act_db": db(sqnr_act_only(W, X, xspec)),
        "sqnr_weight_db": db(sqnr_weight_only(W, X, wspec)),
        "concentration_x_db": db(concentration_act(X, xspec)),
        "concentration_w_db": db(concentration_weight(W, wspec)),
        "alignment_db": db(alignment(W, X)),
        "alignment_optimal_db": db(alignment_optimal(W, sigma_x)),
    }
