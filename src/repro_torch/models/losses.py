"""Sequence-chunked cross-entropy — counterpart of ``repro.models.losses``.

The (B, S, V) logits tensor is never materialized: a loop over sequence
chunks computes each chunk's logits and log-sum-exp and accumulates two
f32 scalars, through autograd (the trainer differentiates it).
"""
from __future__ import annotations

import torch


def chunked_ce(logits_fn, hidden: torch.Tensor, labels: torch.Tensor,
               aux=0.0, aux_coef: float = 0.01, loss_chunk: int = 512):
    """``logits_fn``: hidden chunk (B, c, D) -> logits (B, c, V). Labels
    < 0 are masked. -> (total loss, {"ce", "aux"})."""
    b, s, _ = hidden.shape
    c = min(loss_chunk, s)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for lo in range(0, s, c):
        h, lab = hidden[:, lo:lo + c], labels[:, lo:lo + c].long()
        logits = logits_fn(h).to(torch.float32)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lab.clamp_min(0)[..., None])[..., 0]
        mask = (lab >= 0).to(torch.float32)
        tot = tot + torch.sum((lse - gold) * mask)
        cnt = cnt + torch.sum(mask)
    ce = tot / torch.clamp_min(cnt, 1.0)
    aux = torch.as_tensor(aux, dtype=torch.float32, device=hidden.device)
    return ce + aux_coef * aux, {"ce": ce, "aux": aux}
