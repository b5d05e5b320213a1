"""Device side of the serve loop — counterpart of
``repro.launch.executor`` (single device): ``LegacyExecutor`` and
``RaggedExecutor``.

``LegacyExecutor`` is the prefill-on-admit + batched-decode pair of the
legacy schedule: a bucketed prefill written in place into one slot of the
shared slot cache (``prefill_slot``), paged prefill spans
(``prefill_paged_span``) and one batched decode over every slot
(``decode``), whose greedy tokens it waits for. ``RaggedExecutor`` is the
unified step.

``RaggedExecutor`` owns the params and the paged KV pools on its device
and runs one engine step per call: the flat packed (T, 1) batch of decode
and prefill-chunk rows through ``model.ragged_step`` (``step``), or — for
plans that are pure decode — the compact (n_slots, 1) batch through
``model.decode`` (``decode_step``). Both return a ``TokenFetch`` of the
greedy token ids without synchronising; the pools update in place. With a
draft model (speculative decoding) it also writes packed draft-prefill
steps into the draft pool (``draft_prefill``) and proposes ``spec_k + 1``
greedy tokens per slot (``draft_k``). Both executors copy prefix-cache
pages copy-on-write (``copy_pages``).

Nothing in a unified dispatch waits for the card. The packed host inputs
reach it from a 2-deep ring of pinned staging buffers, copied with
``non_blocking=True``; a buffer is written again two dispatches later,
after the engine has observed the step that read it (at pipeline depth 1
that holds by construction, and the synchronous loop observes every step
before the next). The step's tokens copy into a pinned host buffer of the
same ring, behind a recorded CUDA event that ``TokenFetch.result`` waits
on. On the CPU both are plain copies.
"""
from __future__ import annotations

import time

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


def route_rows(packed: dict, desc: dict) -> dict:
    """The routing ``ops.step_paged_attention`` reads, added to a packed
    step's ragged descriptor (host arrays): the step's logit rows (decode
    rows, verify rows, a completing chunk's last row) as one-row decode
    items at their own positions — ``dec_rows``, ``dec_table`` and
    ``dec_len`` at the logit buffer's fixed width, the first ``n_dec``
    real — masked out of the ragged blocks (``qpos`` -1), and
    ``n_ragged``, the rows left to the ragged kernel."""
    n = int(packed["n_logits"])
    width = packed["logit_rows"].shape[0]
    rows = packed["logit_rows"][:n]
    ptab = packed["page_table"]
    dec_rows = np.zeros((width,), np.int32)
    dec_len = np.zeros((width,), np.int32)
    dec_table = np.zeros((width, ptab.shape[1]), np.int32)
    dec_rows[:n] = rows
    dec_len[:n] = packed["pos"][rows] + 1
    dec_table[:n] = ptab[rows]
    qpos = desc["qpos"].copy()
    qpos[desc["inv_seq"][rows], desc["inv_qi"][rows]] = -1
    return dict(desc, qpos=qpos, dec_rows=dec_rows, dec_len=dec_len,
                dec_table=dec_table, n_dec=n,
                n_ragged=int((qpos >= 0).sum()))


class TokenFetch:
    """One step's greedy token ids on their way to the host: ``result()``
    waits for the copy and returns them as numpy."""

    def __init__(self, host: torch.Tensor, event=None):
        self._host, self._event = host, event

    def result(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy().copy()


class _CopyPagesMixin:
    """The copy-on-write page copy both executors share (reference
    ``executor._CopyPagesMixin``)."""

    def copy_pages(self, pairs) -> None:
        """Copy each (src, dst) page pair on every pool leaf in one
        dispatch, issued on the current stream before the step or prefill
        that writes past the shared boundary (stream order is device
        order, so a source freed and reused within the same plan is read
        before its new owner writes it). The pairs are padded with (0, 0)
        to the power-of-two width the reference uses, ceil2(max(pairs,
        n_slots))."""
        if not pairs:
            return
        self.n_dispatch += 1
        width = 1 << (max(len(pairs), self.n_slots) - 1).bit_length()
        idx = np.zeros((2, width), np.int32)
        idx[:, :len(pairs)] = np.asarray(pairs, np.int32).T
        src, dst = self._page_pairs(idx)
        self.cache = self.model.copy_paged_pages(self.cache, src, dst)


class LegacyExecutor(_CopyPagesMixin):
    """Prefill-on-admit + batched decode (reference ``executor.py:290``),
    on one device: the legacy schedule's device path, which the reference
    keeps as the oracle its unified step is tested against. ``cache`` is
    the slot cache ((L, n_slots, max_len, ...) tensors) or, with
    ``paged``, the paged pools; both update in place."""

    def __init__(self, model, params, cache, *, n_slots: int,
                 paged: bool = False, paged_kernel: bool = False,
                 device="cpu"):
        self.model, self.params, self.cache = model, params, cache
        self.n_slots, self.paged = n_slots, paged
        self.paged_kernel = paged_kernel
        self.device = torch.device(device)
        self.n_dispatch = 0     # device calls issued (hot-loop accounting)
        self.d2h_s = 0.0        # token D2H seconds (attributed separately)

    def _dev(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _page_pairs(self, idx: np.ndarray):
        pairs = self._dev(idx)
        return pairs[0], pairs[1]

    @torch.no_grad()
    def prefill_slot(self, toks: np.ndarray, slot: int, last: int):
        """Slot-cache prefill of ``toks`` (P,) into slot ``slot``, in place:
        the model writes the slot's rows straight into the shared cache
        through a view of slot ``slot`` along axis 1. (The reference
        slices the slot out, prefills it and writes it back in one jitted
        program, ``_prefill_slot_fused`` over ``_take_slot`` /
        ``_put_slot``; in-place writes need neither copy.) Returns the
        logits (1, 1, V) at row ``last``."""
        self.n_dispatch += 1
        part = {k: v[:, slot:slot + 1] for k, v in self.cache.items()}
        logits, _ = self.model.prefill(self.params, self._dev(toks[None]),
                                       dict(part, pos=0), logits_at=last)
        return logits

    @torch.no_grad()
    def prefill_paged_span(self, toks: np.ndarray, row, off: int,
                           last: int):
        """One paged prefill span: ``toks`` (C,) at cache offset ``off``
        against the page-table row ``row`` (1, n_ptab), in place. Returns
        (logits (1, 1, V) at row ``last``, row)."""
        self.n_dispatch += 1
        cache = dict(self.cache, page_table=self._dev(row), pos=off)
        logits, _ = self.model.prefill(self.params, self._dev(toks[None]),
                                       cache, logits_at=last)
        return logits, row

    @torch.no_grad()
    def decode(self, toks: np.ndarray, pos: np.ndarray,
               table=None) -> np.ndarray:
        """One batched decode step over all slots (``toks`` (n_slots, 1)
        at per-slot positions ``pos``; with the paged pools, ``table``
        (n_slots, n_ptab)); returns the greedy next token per slot as
        (n_slots,) int32 numpy. The argmax runs on the device (the lowest
        index wins ties, as the reference's ``_greedy_rows``), so only
        n_slots ints cross to the host; the wait for the step is the
        engine's device span, the copy itself is timed into ``d2h_s``."""
        self.n_dispatch += 1
        cache = dict(self.cache, pos=self._dev(pos))
        if table is not None:
            cache["page_table"] = self._dev(table)
        kw = {"paged_kernel": True} if self.paged_kernel else {}
        logits, _ = self.model.decode(self.params, self._dev(toks), cache,
                                      **kw)
        tokens = greedy_tokens(logits)
        if tokens.is_cuda:
            torch.cuda.current_stream(tokens.device).synchronize()
        td = time.perf_counter()
        out = tokens.cpu().numpy()
        self.d2h_s += time.perf_counter() - td
        return out


class RaggedExecutor(_CopyPagesMixin):
    """The unified token-budget step over the paged pools (see module
    docstring and ``scheduler.TokenBudgetScheduler.pack``). ``draft`` is
    the speculative draft's (model, params, paged pools) on the same
    device, ``spec_k`` its draft depth."""

    def __init__(self, model, params, cache, *, n_slots: int = 1,
                 paged_kernel: bool = False, device="cpu", draft=None,
                 spec_k: int = 0):
        self.model, self.params, self.cache = model, params, cache
        self.n_slots = n_slots
        self.paged_kernel = paged_kernel
        self.device = torch.device(device)
        self.n_dispatch = 0     # device calls issued (hot-loop accounting)
        # the previous step's device token vector: n_slots * (spec_k + 1)
        # wide after a ragged step, n_slots after a pure-decode step (the
        # fast path, which speculative plans never take)
        self._prev = None
        self._pinned = {}       # (ring slot, name) -> pinned host buffer
        self._ring = 0          # ring slot of the current dispatch
        self.spec_k = spec_k
        self.draft_model = self.draft_params = self.draft_cache = None
        if draft is not None:
            self.draft_model, self.draft_params, self.draft_cache = draft

    def _stage(self, name: str, a: np.ndarray, ring=None) -> torch.Tensor:
        """The pinned host buffer ``name`` of ring slot ``ring`` (default:
        the current dispatch's), shaped and typed like ``a``."""
        key = (self._ring if ring is None else ring, name)
        buf = self._pinned.get(key)
        if (buf is None or tuple(buf.shape) != a.shape
                or buf.numpy().dtype != a.dtype):
            buf = torch.from_numpy(np.empty(a.shape, a.dtype)).pin_memory()
            self._pinned[key] = buf
        return buf

    def _dev(self, name: str, a, ring=None) -> torch.Tensor:
        """Host array -> a device tensor of its own (the scheduler reuses
        its packing buffers): through the pinned ring with a non-blocking
        copy on the card, a plain copy on the CPU."""
        a = np.ascontiguousarray(a)
        if self.device.type != "cuda":
            return torch.tensor(a, device=self.device)
        buf = self._stage(name, a, ring)
        buf.numpy()[...] = a
        return buf.to(self.device, non_blocking=True)

    def _page_pairs(self, idx: np.ndarray):
        # staged in the ring slot of the step that follows the copy: its
        # buffer is written again only after that step was observed
        pairs = self._dev("cow", idx, ring=self._ring ^ 1)
        return pairs[0], pairs[1]

    def _draft_dev(self, a) -> torch.Tensor:
        """A draft-side host array as a device tensor of its own, by a
        plain copy: a speculative cycle blocks on its drafts anyway, and
        the pinned ring belongs to the target steps."""
        return torch.tensor(np.ascontiguousarray(a), device=self.device)

    def _fetch(self, toks: torch.Tensor) -> TokenFetch:
        """Start the step's token copy to the host without blocking."""
        self._prev = toks
        if self.device.type != "cuda":
            return TokenFetch(toks)
        host = self._stage("toks", np.empty(tuple(toks.shape), np.int32))
        host.copy_(toks, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return TokenFetch(host, event)

    def _begin_dispatch(self) -> None:
        """Count the dispatch and move to the other ring slot."""
        self.n_dispatch += 1
        self._ring ^= 1

    def _prev_arr(self, width: int) -> torch.Tensor:
        if self._prev is None or self._prev.shape[0] != width:
            self._prev = torch.zeros((width,), dtype=torch.int32,
                                     device=self.device)
        return self._prev

    def reset_pipeline(self) -> None:
        """Forget the previous step's device tokens and the ring position
        (engine reset)."""
        self._prev = None
        self._ring = 0

    @torch.no_grad()
    def step(self, packed: dict) -> TokenFetch:
        """Run one packed unified step; its tokens are the greedy ids at
        the packed logit rows, (R,) int32 (the first ``packed['n_logits']``
        are real)."""
        self._begin_dispatch()
        lrows = self._dev("logit_rows", packed["logit_rows"])
        tokens = _inject_prev(self._dev("tokens", packed["tokens"]),
                              self._prev_arr(lrows.shape[0]),
                              self._dev("tok_src", packed["tok_src"]))
        desc = packed.get("ragged_desc")
        if desc is not None:
            desc = route_rows(packed, desc)
            desc = {k: (self._dev(f"desc.{k}", v)
                        if isinstance(v, np.ndarray) else v)
                    for k, v in desc.items()}
        cache = dict(self.cache, pos=self._dev("pos", packed["pos"]),
                     page_table=self._dev("page_table",
                                          packed["page_table"]))
        toks, cache = self.model.ragged_step(
            self.params, tokens, cache, lrows, paged_kernel=self.paged_kernel,
            greedy=True, ragged_desc=desc)
        self.cache = {k: v for k, v in cache.items()
                      if k not in ("pos", "page_table")}
        return self._fetch(toks)

    @property
    def supports_decode_step(self) -> bool:
        """True when decode-only plans may dispatch via ``decode_step``."""
        return self.paged_kernel

    @torch.no_grad()
    def decode_step(self, tokens: np.ndarray, pos: np.ndarray,
                    table: np.ndarray, tok_src=None) -> TokenFetch:
        """One batched decode over the compact (n_slots, 1) layout (the
        pure-decode fast path). Non-decoding slots carry a dummy token at
        position 0 against the null table row. Its tokens are the greedy
        id per slot, (n_slots,) int32."""
        self._begin_dispatch()
        if tok_src is None:
            tok_src = np.full((self.n_slots,), -1, np.int32)
        toks = _inject_prev(self._dev("tokens", tokens),
                            self._prev_arr(self.n_slots),
                            self._dev("tok_src", tok_src))
        cache = dict(self.cache, pos=self._dev("pos", pos),
                     page_table=self._dev("page_table", table))
        logits, cache = self.model.decode(self.params, toks, cache,
                                          paged_kernel=True)
        self.cache = {k: v for k, v in cache.items()
                      if k not in ("pos", "page_table")}
        return self._fetch(greedy_tokens(logits))

    # ---------------------------------------------------- speculative draft

    @torch.no_grad()
    def draft_prefill(self, packed: dict) -> None:
        """Write one packed draft-prefill step (``scheduler.pack_draft``:
        the target step's ragged shape, against the draft tables) into the
        draft pool; the logits are discarded. It carries no kernel
        descriptor, so its attention takes the gather path, as the
        reference's does."""
        self.n_dispatch += 1
        cache = dict(self.draft_cache,
                     pos=self._draft_dev(packed["pos"]),
                     page_table=self._draft_dev(packed["page_table"]))
        _, cache = self.draft_model.ragged_step(
            self.draft_params, self._draft_dev(packed["tokens"]), cache,
            self._draft_dev(packed["logit_rows"]), greedy=True)
        self.draft_cache = {k: v for k, v in cache.items()
                            if k not in ("pos", "page_table")}

    @torch.no_grad()
    def draft_k(self, tok0: np.ndarray, pos0: np.ndarray, table: np.ndarray,
                tok_src=None) -> np.ndarray:
        """Propose ``spec_k + 1`` greedy tokens per slot in one host call
        (the reference's ``_draft_scan``): ``spec_k + 1`` batched
        ``decode`` calls of the draft model on its pool, each fed the
        previous one's argmax at the next position, then one blocking
        fetch. -> (spec_k + 1, n_slots) int32 numpy. The extra step leaves
        no draft-KV hole at pos0 + k when a block is wholly accepted.
        ``tok_src`` (pipelined loop) injects the in-flight base tokens from
        the previous target step's device vector, n_slots * (spec_k + 1)
        wide; the fetch therefore also waits out that step. The draft
        decodes with the engine's ``paged_kernel`` (the decode attention
        and, where ``ops.use_fused_decode`` allows it, the two-launch
        decode); drafts set only the acceptance rate, never the output."""
        self.n_dispatch += 1
        tok = self._draft_dev(tok0)
        if tok_src is not None:
            tok = _inject_prev(tok, self._prev_arr(
                self.n_slots * (self.spec_k + 1)), self._draft_dev(tok_src))
        pos = self._draft_dev(pos0)
        table = self._draft_dev(table)
        kw = {"paged_kernel": True} if self.paged_kernel else {}
        drafts = []
        for _ in range(self.spec_k + 1):
            cache = dict(self.draft_cache, pos=pos, page_table=table)
            logits, cache = self.draft_model.decode(self.draft_params, tok,
                                                    cache, **kw)
            self.draft_cache = {k: v for k, v in cache.items()
                                if k not in ("pos", "page_table")}
            nxt = greedy_tokens(logits)
            drafts.append(nxt)
            tok, pos = nxt[:, None], pos + 1
        return torch.stack(drafts).cpu().numpy()
