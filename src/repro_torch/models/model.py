"""Unified model API — counterpart of ``repro.models.model``:
``build(cfg) -> Model``, a bundle of functions over (params, tensors).
It builds the dense, moe and vlm families (``models.dense``, the moe
family's expert MLP in ``models.moe``); the ssm, hybrid and encdec
families are refused with ``NotImplementedError``."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.models import dense


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: Any
    init: Callable              # (generator, device) -> params
    forward: Callable           # (params, tokens, **kw) -> (hidden, aux, cache)
    logits: Callable            # (params, hidden) -> logits
    loss: Callable              # (params, batch) -> (loss, metrics)
    init_cache: Callable        # (batch_size, max_len, device) -> slots
    init_paged_cache: Callable  # (n_pages, page_size, device) -> pools
    prefill: Callable           # (params, tokens, cache, **kw) -> (logits, cache)
    decode: Callable            # (params, token, cache, **kw) -> (logits, cache)
    copy_paged_pages: Callable  # (cache, src, dst) -> cache, in place
    ragged_step: Callable       # (params, tokens, cache, logit_rows, **kw)
    make_serving_params: Callable   # (params, keep_packed=None) -> params


def build(cfg) -> Model:
    dense.check_supported(cfg)
    return Model(
        cfg=cfg,
        init=lambda gen, device="cpu": dense.init(cfg, gen, device),
        forward=lambda params, tokens, **kw: dense.forward(cfg, params,
                                                           tokens, **kw),
        logits=lambda params, hidden: dense.logits_fn(cfg, params, hidden),
        loss=lambda params, batch: dense.loss(cfg, params, batch),
        init_cache=lambda batch_size, max_len, device="cpu": (
            dense.init_cache(cfg, batch_size, max_len, device)),
        init_paged_cache=lambda n_pages, page_size, device="cpu": (
            dense.init_paged_cache(cfg, n_pages, page_size, device)),
        prefill=lambda params, tokens, cache, **kw: dense.prefill(
            cfg, params, tokens, cache, **kw),
        decode=lambda params, token, cache, **kw: dense.decode(
            cfg, params, token, cache, **kw),
        copy_paged_pages=lambda cache, src, dst: dense.copy_paged_pages(
            cfg, cache, src, dst),
        ragged_step=lambda params, tokens, cache, logit_rows, **kw: (
            dense.ragged_step(cfg, params, tokens, cache, logit_rows, **kw)),
        make_serving_params=lambda params, **kw: dense.make_serving_params(
            cfg, params, **kw),
    )


def _tensors(node):
    """Every tensor of a params tree (dicts, lists, QLinears: codes,
    scales, transform and serving tensors)."""
    import torch

    from repro_torch.core.qlinear import QLinear

    if isinstance(node, dict):
        return [t for v in node.values() for t in _tensors(v)]
    if isinstance(node, (list, tuple)):
        return [t for v in node for t in _tensors(v)]
    if isinstance(node, QLinear):
        out = []
        node.map_tensors(lambda t: out.append(t) or t)
        return out
    return [node] if isinstance(node, torch.Tensor) else []


def param_count(params) -> int:
    return sum(t.numel() for t in _tensors(params))


def active_param_count(cfg, params) -> int:
    """MoE: routed experts count only top_k/E of expert params."""
    total = param_count(params)
    if not cfg.n_experts:
        return total
    expert = sum(param_count(lp[name]) for lp in params.get("layers", [])
                 for name in ("we_g", "we_u", "we_d") if name in lp)
    return total - expert + int(expert * cfg.top_k / cfg.n_experts)


def to_device(params, device):
    """Move a params tree (dicts, lists, tensors, QLinears) to ``device``."""
    import torch

    from repro_torch.core.qlinear import QLinear

    if isinstance(params, dict):
        return {k: to_device(v, device) for k, v in params.items()}
    if isinstance(params, list):
        return [to_device(v, device) for v in params]
    if isinstance(params, QLinear):
        return params.map_tensors(lambda t: t.to(device))
    if isinstance(params, torch.Tensor):
        return params.to(device)
    return params
