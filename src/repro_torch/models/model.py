"""Unified model API — counterpart of ``repro.models.model``:
``build(cfg) -> Model``, a bundle of functions over (params, tensors).
This slice builds the dense family (catlm features)."""
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
    init_cache: Callable        # (batch_size, max_len, device) -> slots
    init_paged_cache: Callable  # (n_pages, page_size, device) -> pools
    prefill: Callable           # (params, tokens, cache, **kw) -> (logits, cache)
    decode: Callable            # (params, token, cache, **kw) -> (logits, cache)
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
        init_cache=lambda batch_size, max_len, device="cpu": (
            dense.init_cache(cfg, batch_size, max_len, device)),
        init_paged_cache=lambda n_pages, page_size, device="cpu": (
            dense.init_paged_cache(cfg, n_pages, page_size, device)),
        prefill=lambda params, tokens, cache, **kw: dense.prefill(
            cfg, params, tokens, cache, **kw),
        decode=lambda params, token, cache, **kw: dense.decode(
            cfg, params, token, cache, **kw),
        ragged_step=lambda params, tokens, cache, logit_rows, **kw: (
            dense.ragged_step(cfg, params, tokens, cache, logit_rows, **kw)),
        make_serving_params=lambda params, **kw: dense.make_serving_params(
            cfg, params, **kw),
    )


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
