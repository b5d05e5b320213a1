"""Weight rounding — counterpart of ``repro.core.gptq``: GPTQ (Frantar et
al. 2022), column-sequential error-compensated rounding with the
inverse-Hessian Cholesky recursion, and the round-to-nearest baseline.

H = E[xxᵀ] (the Σ_x collected for CAT calibration) is the Hessian proxy;
per-output-channel symmetric scales follow the paper's L2.4 range
estimation. This is calibration-time work, serial per column, so it is
plain torch in f32 on the weights' device, as the reference keeps it in
``jnp`` rather than a Pallas kernel.
"""
from __future__ import annotations

import torch

from .quantizers import QuantSpec, compute_scale_zp, weight_spec


def _code_dtype(spec: QuantSpec):
    return torch.int8 if spec.bits <= 8 else torch.int32


def _damped_hinv_chol(sigma_x: torch.Tensor,
                      damp: float = 0.01) -> torch.Tensor:
    """Upper Cholesky factor U of H⁻¹ = Uᵀ U, H damped by ``damp`` times
    its mean diagonal."""
    d = sigma_x.shape[0]
    h = sigma_x.to(torch.float32)
    mean_diag = torch.mean(torch.diagonal(h))
    h = h + (damp * mean_diag + 1e-8) * torch.eye(d, dtype=torch.float32,
                                                  device=h.device)
    hinv = torch.linalg.inv(h)
    hinv = (hinv + hinv.T) / 2.0
    return torch.linalg.cholesky(hinv).T


@torch.no_grad()
def gptq_quantize(w: torch.Tensor, sigma_x: torch.Tensor,
                  spec: QuantSpec = None, damp: float = 0.01):
    """Quantize W (d_out, d_in) minimizing ||(W - Ŵ)X||² column by column,
    in the reference's order: code the column, divide its error by
    U[i, i], subtract the error's outer product with U's row i from the
    columns not yet coded. -> (codes (d_out, d_in), scale (d_out, 1))."""
    if spec is None:
        spec = weight_spec(4)
    w = w.to(torch.float32)
    scale, _ = compute_scale_zp(w, spec)     # (d_out, 1), symmetric
    u = _damped_hinv_chol(sigma_x.to(w.device), damp)
    s = scale[:, 0]
    d_in = w.shape[1]
    cols = torch.arange(d_in, device=w.device)
    w_work = w.clone()
    q_acc = torch.zeros_like(w)
    for i in range(d_in):
        col = w_work[:, i]
        q = torch.clamp(torch.round(col / s), spec.qmin, spec.qmax)
        err = (col - q * s) / u[i, i]
        row = u[i, :] * (cols > i).to(w.dtype)
        w_work = w_work - torch.outer(err, row)
        q_acc[:, i] = q
    return q_acc.to(_code_dtype(spec)), scale


def gptq_dequant(q: torch.Tensor, scale: torch.Tensor,
                 dtype=torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


def rtn_quantize(w: torch.Tensor, spec: QuantSpec = None):
    """W (d_out, d_in) -> (codes (d_out, d_in), scale (d_out, 1)), with
    the spec's range estimation (L2.4 grid search by default)."""
    if spec is None:
        spec = weight_spec(4)
    w = w.to(torch.float32)
    scale, _ = compute_scale_zp(w, spec)
    q = torch.clamp(torch.round(w / scale), spec.qmin, spec.qmax)
    return q.to(_code_dtype(spec)), scale
