"""AdamW with a warmup-cosine schedule and global-norm clipping —
counterpart of ``repro.optim.optimizer``, on trees of tensors (dicts,
lists and tuples of tensors, as the port's params are).

The update is the reference's formula, not ``torch.optim.AdamW``'s (which
decays the weights before its step and places eps differently): grads in
f32, clipped by their global norm, then
``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2) g g``,
``u = m / (1 - b1^t) / (sqrt(v / (1 - b2^t)) + eps) + wd p`` and
``p - lr u``, in f32, cast back to the param's dtype. The state is
``{"m", "v", "step"}`` (``AdamWMaster``: plus ``"master"``, the f32 copy of
bf16 working params), with ``step`` an int32 scalar, as the reference's,
so checkpoints carry it across packages. Every function is functional:
new tensors out, nothing updated in place.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch


def tree_map(fn, *trees):
    """``fn`` over the tensor leaves of trees of one structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(tree_map(fn, *(t[i] for t in trees))
                           for i in range(len(first)))
    return fn(*trees)


def tree_leaves(tree) -> list:
    """The tensor leaves in the reference's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def warmup_cosine(base_lr: float, warmup: int, total: int,
                  min_frac: float = 0.1) -> Callable:
    """step -> f32 learning rate: linear warmup to ``base_lr`` over
    ``warmup`` steps, then a cosine down to ``min_frac * base_lr`` at
    ``total``."""
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1),
                           0.0, 1.0)
        cos = base_lr * (min_frac + (1 - min_frac) * 0.5
                         * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)
    return lr


def _zeros_like_f32(p):
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0

    def init(self, params) -> dict:
        device = tree_leaves(params)[0].device
        return {"m": tree_map(_zeros_like_f32, params),
                "v": tree_map(_zeros_like_f32, params),
                "step": torch.zeros((), dtype=torch.int32, device=device)}

    def _moments(self, grads, state):
        """-> (step, lr, m, v, bias corrections) of one update."""
        step = state["step"] + 1
        gf = tree_map(lambda g: g.to(torch.float32), grads)
        if self.clip_norm:
            gn = torch.sqrt(sum(torch.sum(g * g) for g in tree_leaves(gf)))
            scale = torch.clamp_max(self.clip_norm / (gn + 1e-9), 1.0)
            gf = tree_map(lambda g: g * scale, gf)
        lr = self.lr(step) if callable(self.lr) else self.lr
        b1, b2 = self.b1, self.b2
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g, state["m"], gf)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * g * g,
                     state["v"], gf)
        t = step.to(torch.float32)
        mhat_c = 1.0 / (1 - b1 ** t)
        vhat_c = 1.0 / (1 - b2 ** t)
        return step, lr, m, v, mhat_c, vhat_c

    def update(self, params, grads, state):
        """-> (new params, new state)."""
        step, lr, m, v, mhat_c, vhat_c = self._moments(grads, state)

        def upd(p, m_, v_):
            u = (m_ * mhat_c) / (torch.sqrt(v_ * vhat_c) + self.eps)
            u = u + self.weight_decay * p.to(torch.float32)
            return (p.to(torch.float32) - lr * u).to(p.dtype)

        return (tree_map(upd, params, m, v),
                {"m": m, "v": v, "step": step})


@dataclasses.dataclass(frozen=True)
class AdamWMaster(AdamW):
    """Mixed precision: bf16 working params, their f32 master copy in the
    optimizer state; the update runs on the master and the params are its
    cast."""

    def init(self, params) -> dict:
        state = super().init(params)
        state["master"] = tree_map(lambda p: p.to(torch.float32), params)
        return state

    def update(self, params, grads, state):
        step, lr, m, v, mhat_c, vhat_c = self._moments(grads, state)

        def upd(mast, m_, v_):
            u = (m_ * mhat_c) / (torch.sqrt(v_ * vhat_c) + self.eps)
            return mast - lr * (u + self.weight_decay * mast)

        master = tree_map(upd, state["master"], m, v)
        new_params = tree_map(lambda mast, p: mast.to(p.dtype), master,
                              params)
        return new_params, {"m": m, "v": v, "master": master, "step": step}


def cast_params(params, dtype):
    """Float leaves to ``dtype`` (integer leaves as they are)."""
    def cast(p):
        return p.to(dtype) if p.is_floating_point() else p
    return tree_map(cast, params)
