"""Device side of the unified serve loop — counterpart of
``repro.launch.executor.RaggedExecutor`` (single device, synchronous).

``RaggedExecutor`` owns the params and the paged KV pools on its device
and runs one engine step per call: the flat packed (T, 1) batch of decode
and prefill-chunk rows through ``model.ragged_step`` (``step``), or — for
plans that are pure decode — the compact (n_slots, 1) batch through
``model.decode`` (``decode_step``). Both return the greedy token ids as a
device tensor without synchronising; the pools update in place.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.dense import greedy_tokens


def _inject_prev(tokens, prev_toks, tok_src):
    """Rows with ``tok_src >= 0`` take their token from the previous
    step's device token vector (pipelined serving); ``-1`` rows keep the
    host-packed token."""
    if prev_toks is None:
        return tokens
    fetched = prev_toks[tok_src.clamp_min(0).long()]
    return torch.where(tok_src[:, None] >= 0, fetched[:, None], tokens)


class RaggedExecutor:
    """The unified token-budget step over the paged pools (see module
    docstring and ``scheduler.TokenBudgetScheduler.pack``)."""

    def __init__(self, model, params, cache, *, n_slots: int = 1,
                 paged_kernel: bool = False, device="cpu"):
        self.model, self.params, self.cache = model, params, cache
        self.n_slots = n_slots
        self.paged_kernel = paged_kernel
        self.device = torch.device(device)
        self.n_dispatch = 0     # device calls issued (hot-loop accounting)
        self._prev = None       # previous step's device token vector

    def _dev(self, a) -> torch.Tensor:
        """Host array -> a fresh device tensor (copied: the scheduler
        reuses its packing buffers)."""
        return torch.tensor(np.asarray(a), device=self.device)

    def _prev_arr(self, width: int) -> torch.Tensor:
        if self._prev is None or self._prev.shape[0] != width:
            self._prev = torch.zeros((width,), dtype=torch.int32,
                                     device=self.device)
        return self._prev

    def reset_pipeline(self) -> None:
        """Forget the previous step's device tokens (engine reset)."""
        self._prev = None

    @torch.no_grad()
    def step(self, packed: dict) -> torch.Tensor:
        """Run one packed unified step; returns the greedy token ids at the
        packed logit rows as a device (R,) int32 tensor (the first
        ``packed['n_logits']`` are real)."""
        self.n_dispatch += 1
        lrows = self._dev(packed["logit_rows"])
        tokens = _inject_prev(self._dev(packed["tokens"]),
                              self._prev_arr(lrows.shape[0]),
                              self._dev(packed["tok_src"]))
        desc = packed.get("ragged_desc")
        if desc is not None:
            desc = {k: self._dev(v) for k, v in desc.items()}
        cache = dict(self.cache, pos=self._dev(packed["pos"]),
                     page_table=self._dev(packed["page_table"]))
        toks, cache = self.model.ragged_step(
            self.params, tokens, cache, lrows, paged_kernel=self.paged_kernel,
            greedy=True, ragged_desc=desc)
        self.cache = {k: v for k, v in cache.items()
                      if k not in ("pos", "page_table")}
        self._prev = toks
        return toks

    @property
    def supports_decode_step(self) -> bool:
        """True when decode-only plans may dispatch via ``decode_step``."""
        return self.paged_kernel

    @torch.no_grad()
    def decode_step(self, tokens: np.ndarray, pos: np.ndarray,
                    table: np.ndarray, tok_src=None) -> torch.Tensor:
        """One batched decode over the compact (n_slots, 1) layout (the
        pure-decode fast path). Non-decoding slots carry a dummy token at
        position 0 against the null table row. Returns the greedy token
        per slot as a device (n_slots,) int32 tensor."""
        self.n_dispatch += 1
        if tok_src is None:
            tok_src = np.full((self.n_slots,), -1, np.int32)
        toks = _inject_prev(self._dev(tokens), self._prev_arr(self.n_slots),
                            self._dev(tok_src))
        cache = dict(self.cache, pos=self._dev(pos),
                     page_table=self._dev(table))
        logits, cache = self.model.decode(self.params, toks, cache,
                                          paged_kernel=True)
        self.cache = {k: v for k, v in cache.items()
                      if k not in ("pos", "page_table")}
        out = greedy_tokens(logits)
        self._prev = out
        return out
