"""Weight rounding — counterpart of ``repro.core.gptq``. This slice ports
round-to-nearest (``rtn_quantize``); GPTQ's error-compensated rounding is
a later slice."""
from __future__ import annotations

import torch

from .quantizers import QuantSpec, compute_scale_zp, weight_spec


def rtn_quantize(w: torch.Tensor, spec: QuantSpec = None):
    """W (d_out, d_in) -> (codes (d_out, d_in), scale (d_out, 1)), with
    the spec's range estimation (L2.4 grid search by default)."""
    if spec is None:
        spec = weight_spec(4)
    w = w.to(torch.float32)
    scale, _ = compute_scale_zp(w, spec)
    q = torch.clamp(torch.round(w / scale), spec.qmin, spec.qmax)
    return q.to(torch.int8 if spec.bits <= 8 else torch.int32), scale
