"""Host-side serving policy: request types + the unified token-budget
scheduler.

``TokenBudgetScheduler`` is the vLLM-style planner behind
``ServeEngine(schedule="unified")``: each engine step it packs up to
``max_batch_tokens`` of work — one decode token for every running slot
plus prefill chunks for admitting/in-flight ones — into a single
:class:`StepPlan` that the device executor (``repro_torch.launch.executor``)
runs as ONE ragged model invocation. Splitting prompts into
budget-bounded chunks decouples time-to-first-token of a long admission
from the inter-token latency of in-flight decodes (no head-of-line
prefill stall), while the fixed packing width keeps the step at O(1)
compile shapes.

Everything here is pure host-side bookkeeping (numpy + python); the only
device-adjacent state it touches is the paged-KV page table
(``repro_torch.launch.paged``), which it grows/releases exactly like the legacy
engine does.

Planning order per step (all FIFO-preserving):

1. **decode** — every slot that finished its prompt contributes exactly
   one token (its last generated token, written at its position). Decode
   goes first so ITL stays flat regardless of admission pressure;
   ``max_batch_tokens >= n_slots`` guarantees decodes always fit.
2. **in-flight prefill** — slots still mid-prompt (admitted on an earlier
   step) get up to ``min(remaining prompt, remaining budget[,
   prefill_chunk])`` tokens, oldest admission first.
3. **admission** — while the queue head fits (free slot, page reservation
   for its worst case, budget left), pop it and schedule its first
   chunk. The head never yields to a younger request (head-of-line wait,
   FIFO preserved — same rule as the legacy paged engine).

Invariants (property-tested in ``tests/test_scheduler_properties.py``):
every plan's packed token count is <= ``max_batch_tokens``; admission
order is submission order; no slot is both prefilling and decoding in
one plan; every admitted request retires exactly once.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

import numpy as np


# ----------------------------------------------------------- request types

@dataclasses.dataclass
class Request:
    """One generation request: ``prompt`` (P,) int32, decode budget."""
    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    submit_time: float = 0.0


@dataclasses.dataclass
class RequestResult:
    rid: int
    tokens: np.ndarray            # (P + G,) prompt followed by G generated
    prompt_len: int
    ttft_s: float                 # submit -> first token (prefill) latency
    admit_step: int
    retire_step: int


@dataclasses.dataclass
class SeqState:
    """Unified-mode per-sequence state (the chunked-admission state
    machine): ``prefill_done`` counts prompt tokens already written to the
    KV pool; the sequence is *prefilling* until it reaches the prompt
    length, then *decoding* until retirement."""
    req: Request
    slot: int
    prefill_done: int = 0
    generated: list = dataclasses.field(default_factory=list)
    admit_step: int = 0
    admit_order: int = 0
    ttft_s: float = 0.0
    # pipelined (one-step-ahead) bookkeeping: ``inflight`` counts tokens
    # this slot is PREDICTED to append in the dispatched-but-unobserved
    # step (0 in synchronous mode); ``pending_src`` is the index of the
    # slot's next fed token inside that step's device token vector
    # (consumer-row index for a ragged step, slot index for the
    # slot-major fused decode step; -1 when nothing is in flight).
    inflight: int = 0
    pending_src: int = -1

    @property
    def prompt_len(self) -> int:
        return len(self.req.prompt)

    @property
    def decoding(self) -> bool:
        return self.prefill_done >= self.prompt_len


@dataclasses.dataclass
class StepPlan:
    """One step's packed work. ``decode``: (slot, fed token, write pos)
    triples, one per running slot. ``spec`` (speculative mode): (slot,
    fed token, base pos) triples — each packs ``spec_width`` = k+1
    verify rows (the last generated token plus k drafted tokens) instead
    of one decode row; ``spec_drafts`` maps slot -> the (k,) drafted
    tokens, filled by the engine after the draft pass and before
    ``pack``. ``prefill``: (slot, offset, q_len, tokens) chunks;
    ``draft_prefill`` mirrors them (plus prefix-hit backfill) into the
    draft pool. ``admitted``: (rid, slot) pairs admitted this step.
    ``cow``: (src, dst) page pairs the executor must device-copy BEFORE
    running the step (copy-on-write splits of partially-shared prefix
    pages). Logits are consumed in packing order: every decode row,
    every spec item's k+1 rows, then every prefill chunk that
    *completes* its prompt (``logit_consumers``)."""
    decode: list = dataclasses.field(default_factory=list)
    spec: list = dataclasses.field(default_factory=list)
    spec_width: int = 1
    spec_drafts: dict = dataclasses.field(default_factory=dict)
    # slot -> this step's draft count k' (adaptive speculation may plan
    # fewer than the configured spec_k per slot; absent -> spec_width-1)
    spec_k_of: dict = dataclasses.field(default_factory=dict)
    prefill: list = dataclasses.field(default_factory=list)
    draft_prefill: list = dataclasses.field(default_factory=list)
    admitted: list = dataclasses.field(default_factory=list)
    cow: list = dataclasses.field(default_factory=list)
    # pipelined mode: slot -> index of the slot's fed token inside the
    # PREVIOUS (in-flight) step's device token vector, -1 when the fed
    # token is a host value (``pack`` emits these as ``tok_src``)
    srcs: dict = dataclasses.field(default_factory=dict)
    # slots whose rows in THIS plan were invalidated by the previous
    # step's observation (the slot retired, or a speculative verify
    # accepted fewer rows than predicted): ``observe`` discards their
    # outputs, ``note_dispatch`` already charged them — see
    # ``_mark_stale``
    stale: set = dataclasses.field(default_factory=set)

    def spec_rows(self, slot: int) -> int:
        """Verify rows slot's item packs this step (its k' + 1)."""
        return self.spec_k_of.get(slot, self.spec_width - 1) + 1

    @property
    def n_tokens(self) -> int:
        return (len(self.decode)
                + sum(self.spec_rows(s) for s, _, _ in self.spec)
                + sum(n for _, _, n, _ in self.prefill))

    @property
    def logit_consumers(self) -> list:
        """[("decode"|"spec"|"first", slot)] aligned with the packed
        logit rows ("spec" consumes ``spec_width`` rows, others one)."""
        out = [("decode", slot) for slot, _, _ in self.decode]
        out += [("spec", slot) for slot, _, _ in self.spec]
        for slot, off, n, toks in self.prefill:
            if off + n >= self._prompt_lens[slot]:
                out.append(("first", slot))
        return out

    # slot -> prompt length, filled by the scheduler (completion test)
    _prompt_lens: dict = dataclasses.field(default_factory=dict)


class TokenBudgetScheduler:
    """Token-budget packing policy over the paged-KV bookkeeping (see the
    module docstring for the step algorithm).

    The scheduler owns the FIFO queue, the free-slot list, the active
    ``SeqState`` map, and the page pool/tables; the engine façade calls
    ``plan()``, executes the packed step on the device, then feeds the
    argmax tokens back through ``observe()`` which returns the sequences
    that retired."""

    def __init__(self, n_slots: int, max_batch_tokens: int, *, pool,
                 tables, prefill_chunk: int = 0,
                 eos_id: Optional[int] = None, plan_log_cap: int = 4096,
                 prefix=None, spec_k: int = 0, draft_tables=None,
                 adaptive_spec: bool = False):
        if adaptive_spec and not spec_k:
            raise ValueError("adaptive_spec needs spec_k > 0 (there is "
                             "no draft count to adapt)")
        if max_batch_tokens < n_slots * (spec_k + 1):
            raise ValueError(
                f"max_batch_tokens={max_batch_tokens} must be >= "
                f"n_slots*(spec_k+1)={n_slots * (spec_k + 1)} (every "
                f"running slot packs {spec_k + 1} token(s) per step)")
        if spec_k and draft_tables is None:
            raise ValueError("spec_k needs draft_tables (the draft "
                             "model's parallel paged pool)")
        self.n_slots = n_slots
        self.max_batch_tokens = max_batch_tokens
        self.prefill_chunk = prefill_chunk
        self.eos_id = eos_id
        self.pool, self.tables = pool, tables
        # speculative decoding: k drafted tokens per decoding slot per
        # cycle, verified as k+1 packed rows; the draft model's KV lives
        # in its own pool behind draft_tables (admitted/grown/shrunk/
        # released in lockstep with the target tables)
        self.spec_k = spec_k
        self.draft_tables = draft_tables
        # adaptive speculation: shrink a slot's per-step draft count k'
        # toward what its running acceptance rate earns (k' = ceil(rate ·
        # spec_k), floored at 1 so acceptance evidence keeps flowing) —
        # a slot whose drafts keep missing stops paying k wasted verify
        # rows per cycle. spec_k stays the hard cap; buffers, page
        # reservations, and the draft scan are sized for it, so adapting
        # never moves the worst case. EMA per SLOT, cleared on retire
        # (slot reuse must not inherit the last occupant's rate).
        self.adaptive_spec = adaptive_spec
        self._accept_ema: dict = {}     # slot -> acceptance-rate EMA
        self.spec_drafted = 0       # drafted tokens offered to verify
        self.spec_accepted = 0      # drafted tokens the target agreed on
        self.spec_cycles = 0        # draft/verify cycles run
        self.gen_tokens = 0         # tokens actually appended (all modes)
        # optional launch.paged.PrefixCache: admission looks up the
        # longest cached prefix and plans prefill only from the first
        # miss token (the hit's pages are mapped shared into the slot)
        self.prefix = prefix
        self.queue: deque = deque()
        self.free = list(range(n_slots))
        self.active: dict = {}          # slot -> SeqState
        self._admit_order = 0
        # lightweight per-step log for invariant tests / benchmarks:
        # (n_tokens, decode slots, prefill slots, admitted rids). A RING
        # (maxlen=plan_log_cap) so a sustained serve doesn't grow host
        # memory one tuple per step forever; running aggregates that must
        # survive eviction live in counters (packed_tokens_max, n_plans).
        self.plan_log: deque = deque(maxlen=plan_log_cap or None)
        self.packed_tokens_max = 0
        self.n_plans = 0
        # pack()/_kernel_desc() write into preallocated buffers reused
        # across steps (shapes are fixed per engine config). A 2-DEEP
        # RING, not a single set: with one-step-ahead dispatch, step N's
        # descriptors may still be in flight (jnp.asarray of a numpy
        # buffer can alias it on CPU) while pack() fills step N+1's —
        # a single reused set would let the fill race the dispatch.
        # Alternating parity means a buffer is only rewritten after the
        # NEXT step was dispatched, i.e. after its own step's arrays
        # were consumed. Allocated lazily (n_ptab comes from the tables).
        self._bufs: list = [{}, {}]
        self._buf_parity = 0
        self.mispredicts = 0    # optimistic plans invalidated by observe

    def reset(self) -> None:
        """Drop per-run bookkeeping (log, counters, admission order,
        descriptor-ring parity) on an idle scheduler — the engine's
        warmup/steady-state ``reset()`` hook. Slot and page state are
        already back at rest when idle."""
        assert self.idle, "reset() needs an idle scheduler"
        self.plan_log.clear()
        self.packed_tokens_max = 0
        self.n_plans = 0
        self._admit_order = 0
        self.free = list(range(self.n_slots))
        self.spec_drafted = self.spec_accepted = self.spec_cycles = 0
        self._accept_ema.clear()
        self.gen_tokens = 0
        self.mispredicts = 0
        self._buf_parity = 0

    # ------------------------------------------------------------ planning

    def _slot_k(self, slot: int) -> int:
        """This step's draft count for a slot: the configured ``spec_k``,
        or — with ``adaptive_spec`` — what the slot's acceptance-rate EMA
        earns, clamped to [1, spec_k] (see ``__init__``)."""
        if not self.adaptive_spec:
            return self.spec_k
        rate = self._accept_ema.get(slot)
        if rate is None:
            return self.spec_k          # no evidence yet: be optimistic
        return max(1, min(self.spec_k,
                          int(np.ceil(rate * self.spec_k))))

    def _chunk(self, want: int, budget: int) -> int:
        # Budget-remainder audit (the "sliced chunk rounds to 0" worry):
        # callers only reach here with budget >= 1 (the in-flight loop
        # breaks at budget <= 0, admission requires budget > 0) and
        # want >= 1 (an in-flight prefilling seq has prompt_len >
        # prefill_done; admission prompts are non-empty), so n >= 1
        # always — a slot can never stall a cycle receiving a 0-token
        # chunk while budget remains. Property-tested in
        # tests/test_scheduler_properties.py (chunks are never empty).
        n = min(want, budget)
        if self.prefill_chunk:
            n = min(n, self.prefill_chunk)
        return n

    def plan(self, step_idx: int) -> StepPlan:
        plan = StepPlan()
        plan.spec_width = self.spec_k + 1
        budget = self.max_batch_tokens
        # 1. decode: one token per running slot (slot order = packing
        # order, deterministic). Page growth happens here, mirroring the
        # legacy engine's pre-step ``ensure``. In speculative mode every
        # decoding slot instead packs a k+1-row verify item (its last
        # token plus k drafts, positions pos..pos+k) and BOTH pools grow
        # to cover the drafted positions up front — observe() shrinks the
        # rejected tail back so page state matches a never-drafted run.
        for slot in sorted(self.active):
            seq = self.active[slot]
            if not seq.decoding:
                continue
            # pipelined (one-step-ahead) planning is OPTIMISTIC: a slot
            # with an unobserved step in flight is assumed to append its
            # predicted ``inflight`` tokens and continue, so this plan
            # packs it at the predicted next position with its fed token
            # sourced from the in-flight step's device vector
            # (``srcs``). A slot the in-flight step is predicted to
            # RETIRE (budget exhausted) is simply not packed. observe()
            # reconciles: eos retirement or a short speculative accept
            # marks the optimistic rows stale and rewinds page state
            # (``_mark_stale`` / the shrink in ``_observe_spec``).
            # Synchronous mode never sets ``inflight``, so n_eff and
            # src degenerate to the original values.
            n_eff = len(seq.generated) + seq.inflight
            if seq.inflight and n_eff >= seq.req.max_new_tokens:
                continue        # predicted to retire in the in-flight step
            pos = seq.prompt_len + n_eff - 1
            fed = seq.generated[-1] if seq.generated else 0
            plan.srcs[slot] = seq.pending_src if seq.inflight else -1
            if self.spec_k:
                kx = self._slot_k(slot)
                # target pages cover the k' verify rows this step packs;
                # the DRAFT scan always runs spec_k + 1 fixed-length
                # steps (one compile), so its pages cover the full cap
                self.tables.ensure(slot, pos + kx)
                self.draft_tables.ensure(slot, pos + self.spec_k)
                plan.spec.append((slot, fed, pos))
                plan.spec_k_of[slot] = kx
                budget -= kx + 1
            else:
                self.tables.ensure(slot, pos)
                plan.decode.append((slot, fed, pos))
                budget -= 1
        # 2. in-flight prefill chunks, oldest admission first (mirrored
        # into the draft pool in speculative mode: the draft model needs
        # the full prompt's KV before it can propose)
        inflight = sorted((s for s in self.active.values()
                           if not s.decoding), key=lambda s: s.admit_order)
        for seq in inflight:
            if budget <= 0:
                break
            off = seq.prefill_done
            n = self._chunk(seq.prompt_len - off, budget)
            self.tables.ensure(seq.slot, off + n - 1)
            self.tables.assert_writable(seq.slot, off, off + n - 1)
            toks = np.asarray(seq.req.prompt[off:off + n], np.int32)
            plan.prefill.append((seq.slot, off, n, toks))
            if self.spec_k:
                self.draft_tables.ensure(seq.slot, off + n - 1)
                plan.draft_prefill.append((seq.slot, off, n, toks))
            seq.prefill_done += n
            budget -= n
        # 3. admission: queue head only (FIFO head-of-line wait). With a
        # prefix cache, admission looks up the longest cached prefix
        # first: its pages are mapped shared (read-only, refcount-bumped)
        # and the first chunk starts at the first miss token — cached
        # tokens are never prefilled at all.
        while self.queue and self.free and budget > 0:
            head = self.queue[0]
            # speculative verify writes k rows past the last decode
            # position, so the worst-case reservation covers them too
            budget_tokens = (len(head.prompt) + head.max_new_tokens
                             + self.spec_k)
            hit, pages = 0, []
            if self.prefix is not None:
                hit, pages = self.prefix.lookup(head.prompt)
                ok = self.prefix.make_room(self.tables, budget_tokens,
                                           hit_tokens=hit, protect=pages)
                if not ok and not self.active:
                    # nothing live will free a page: shorten the hit
                    # rather than wait forever (the reference stalls)
                    hit, pages, ok = self.prefix.shorter_hit(
                        self.tables, budget_tokens, hit, pages)
            else:
                ok = self.tables.can_admit(budget_tokens)
            if ok and self.spec_k:
                # the draft pool shares no prefix pages — it needs full
                # worst-case capacity even on a target-pool cache hit
                ok = self.draft_tables.can_admit(budget_tokens)
            if not ok:
                break
            slot = min(self.free)       # deterministic: lowest free slot
            self.free.remove(slot)
            req = self.queue.popleft()
            n = self._chunk(len(req.prompt) - hit, budget)
            self.tables.admit_prefix(slot, pages, hit, hit + n,
                                     budget_tokens=budget_tokens)
            if self.prefix is not None:
                self.prefix.note(hit, len(req.prompt))
                cow = self.tables.ensure_writable(slot, hit)
                self.prefix.cow_copies += len(cow)
                plan.cow.extend(cow)
            self.tables.assert_writable(slot, hit, hit + n - 1)
            if self.spec_k:
                self.draft_tables.admit(slot, 0,
                                        budget_tokens=budget_tokens)
                # the draft pool never shares prefix pages, so a target
                # cache hit still needs the hit region prefilled into the
                # draft pool — backfill it as extra draft-only chunks
                # (they ride outside the token budget: draft work is a
                # separate cheap dispatch, not verify-batch rows)
                cap = self._chunk(self.max_batch_tokens,
                                  self.max_batch_tokens)
                off = 0
                while off < hit:
                    dn = min(cap, hit - off)
                    self.draft_tables.ensure(slot, off + dn - 1)
                    plan.draft_prefill.append(
                        (slot, off, dn,
                         np.asarray(req.prompt[off:off + dn], np.int32)))
                    off += dn
                self.draft_tables.ensure(slot, hit + n - 1)
                plan.draft_prefill.append(
                    (slot, hit, n,
                     np.asarray(req.prompt[hit:hit + n], np.int32)))
            seq = SeqState(req, slot, prefill_done=hit + n,
                           admit_step=step_idx,
                           admit_order=self._admit_order)
            self._admit_order += 1
            self.active[slot] = seq
            plan.admitted.append((req.rid, slot))
            plan.prefill.append((slot, hit, n,
                                 np.asarray(req.prompt[hit:hit + n],
                                            np.int32)))
            budget -= n
        plan._prompt_lens = {s: seq.prompt_len
                             for s, seq in self.active.items()}
        self.packed_tokens_max = max(self.packed_tokens_max, plan.n_tokens)
        self.n_plans += 1
        self.plan_log.append((plan.n_tokens,
                              tuple(s for s, _, _ in plan.decode)
                              + tuple(s for s, _, _ in plan.spec),
                              tuple(s for s, _, _, _ in plan.prefill),
                              tuple(r for r, _ in plan.admitted)))
        return plan

    # ------------------------------------------------------------- packing

    def _buffers(self, kernel_desc: bool) -> dict:
        """The preallocated host arrays ``pack`` fills — a 2-deep ring
        (see ``__init__``: step N's arrays may still back an in-flight
        dispatch while step N+1 packs), each set allocated once (shapes
        are fixed per engine config) and RESET + reused every other
        step, so the serving hot loop stops paying a numpy allocation
        per descriptor per step. The returned views are valid until the
        next-but-one ``pack()`` call; the executor copies (or aliases)
        them to device (``jnp.asarray``) immediately."""
        buf = self._bufs[self._buf_parity]
        self._buf_parity ^= 1
        if not buf:
            T, R, n_ptab = (self.max_batch_tokens, self.n_slots,
                            self.tables.n_ptab)
            q_width = min(T, self.prefill_chunk) if self.prefill_chunk else T
            # a spec verify item is k+1 rows (and its consumer reads k+1
            # logit rows) — widen the per-item and logit buffers for it
            q_width = max(q_width, self.spec_k + 1)
            buf.update({
                "tokens": np.zeros((T,), np.int32),
                "pos": np.zeros((T,), np.int32),
                "slot_of": np.empty((T,), np.int32),
                "tok_src": np.empty((T,), np.int32),
                "logit_rows": np.zeros((R * (self.spec_k + 1),), np.int32),
                "ptab": np.zeros((T, n_ptab), np.int32),
                "qidx": np.zeros((R, q_width), np.int32),
                "qpos": np.empty((R, q_width), np.int32),
                "lengths": np.zeros((R,), np.int32),
                "table": np.zeros((R, n_ptab), np.int32),
                "inv_seq": np.zeros((T,), np.int32),
                "inv_qi": np.zeros((T,), np.int32),
            })
        b = buf
        for name in ("tokens", "pos", "logit_rows", "ptab"):
            b[name][...] = 0
        b["slot_of"].fill(-1)
        b["tok_src"].fill(-1)
        if kernel_desc:
            for name in ("qidx", "lengths", "table", "inv_seq", "inv_qi"):
                b[name][...] = 0
            b["qpos"].fill(-1)
        return b

    def pack(self, plan: StepPlan, *, kernel_desc: bool = False) -> dict:
        """Flatten a plan into the fixed-shape arrays the ragged device
        step consumes (ONE compile shape per engine): ``tokens`` (T, 1),
        ``pos`` (T,), ``page_table`` (T, n_ptab) per-token table rows
        (null rows for padding), ``logit_rows`` (n_slots,) packed-row
        indices of the logit consumers. ``kernel_desc`` additionally
        emits the per-work-item query-block descriptors the ragged
        paged-attention kernel wants (``ragged_desc``).

        The arrays are views of buffers reused across steps (see
        ``_buffers``): read/copy them before the next ``pack()``."""
        T = self.max_batch_tokens
        buf = self._buffers(kernel_desc)
        tokens = buf["tokens"]
        pos = buf["pos"]
        slot_of = buf["slot_of"]
        tok_src = buf["tok_src"]
        items = []                      # (slot, start row, q_len, last pos)
        last_row = {}                   # slot -> its item's last packed row
        i = 0
        for slot, tok, p in plan.decode:
            tokens[i], pos[i], slot_of[i] = tok, p, slot
            tok_src[i] = plan.srcs.get(slot, -1)
            items.append((slot, i, 1, p))
            last_row[slot] = i
            i += 1
        spec_start = {}                 # slot -> its verify item's first row
        for slot, tok, p in plan.spec:
            # verify item: [last token, k' drafts] at positions p..p+k'
            # (k' <= spec_k when adaptive speculation trimmed the slot);
            # only the BASE row can be an in-flight device token — the
            # draft rows are host values from this cycle's draft scan
            w = plan.spec_rows(slot)
            tokens[i] = tok
            tok_src[i] = plan.srcs.get(slot, -1)
            tokens[i + 1:i + w] = plan.spec_drafts[slot][:w - 1]
            pos[i:i + w] = p + np.arange(w)
            slot_of[i:i + w] = slot
            items.append((slot, i, w, p + w - 1))
            spec_start[slot] = i
            i += w
        for slot, off, n, toks in plan.prefill:
            tokens[i:i + n] = toks
            pos[i:i + n] = off + np.arange(n)
            slot_of[i:i + n] = slot
            items.append((slot, i, n, off + n - 1))
            last_row[slot] = i + n - 1
            i += n
        # logit rows derive from the SAME consumer list observe() zips
        # over — single-sourced so the row/consumer alignment cannot
        # drift (each consumer reads its slot's last packed row; a spec
        # consumer reads all k'+1 of its item's rows)
        consumers = plan.logit_consumers
        logit_rows = buf["logit_rows"]
        j = 0
        for kind, slot in consumers:
            if kind == "spec":
                w = plan.spec_rows(slot)
                logit_rows[j:j + w] = spec_start[slot] + np.arange(w)
                j += w
            else:
                logit_rows[j] = last_row[slot]
                j += 1
        ptab = buf["ptab"]
        valid = slot_of >= 0
        ptab[valid] = self.tables.table[slot_of[valid]]
        packed = {"tokens": tokens[:, None], "pos": pos,
                  "page_table": ptab, "logit_rows": logit_rows,
                  "tok_src": tok_src, "n_logits": j}
        if kernel_desc:
            packed["ragged_desc"] = self._kernel_desc(items, buf)
        return packed

    def _kernel_desc(self, items, buf: dict) -> dict:
        """Per-work-item query blocks for the ragged paged-attention
        kernel: row j holds work item j's packed-row indices and absolute
        positions (padded with qpos=-1 -> fully masked), its page-table
        row, and its kv length; ``inv_*`` maps each packed row back to
        its (item, row-in-item) so the blocked output scatters into the
        flat layout.

        The block width is the largest q_len any single item can reach —
        ``prefill_chunk`` when set (a decode item is 1 row), the whole
        budget otherwise — still a fixed shape per engine config (O(1)
        compiles) but without padding every item to the full packed
        width. Set ``prefill_chunk`` alongside ``paged_kernel`` to keep
        the kernel's masked padding rows small."""
        # block width Q bounds one ITEM's q_len; the inv_* maps stay at
        # the full packed width T (they are indexed by packed row).
        # All arrays are the reused _buffers views, already reset.
        qidx, qpos = buf["qidx"], buf["qpos"]
        lengths, table = buf["lengths"], buf["table"]
        inv_seq, inv_qi = buf["inv_seq"], buf["inv_qi"]
        for j, (slot, start, n, last) in enumerate(items):
            qidx[j, :n] = start + np.arange(n)
            qpos[j, :n] = last - n + 1 + np.arange(n)
            lengths[j] = last + 1
            table[j] = self.tables.table[slot]
            inv_seq[start:start + n] = j
            inv_qi[start:start + n] = np.arange(n)
        return {"qidx": qidx, "qpos": qpos, "lengths": lengths,
                "table": table, "inv_seq": inv_seq, "inv_qi": inv_qi}

    # ------------------------------------------------------- draft packing

    def _draft_buf(self) -> dict:
        """Separate reused buffers for draft-prefill packing — ``pack``
        runs after the draft dispatches each cycle, so the main ``_buf``
        views must stay untouched until then."""
        if not hasattr(self, "_dbuf") or not self._dbuf:
            T, n_ptab = self.max_batch_tokens, self.draft_tables.n_ptab
            self._dbuf = {
                "tokens": np.zeros((T,), np.int32),
                "pos": np.zeros((T,), np.int32),
                "slot_of": np.empty((T,), np.int32),
                "ptab": np.zeros((T, n_ptab), np.int32),
                "logit_rows": np.zeros(
                    (self.n_slots * (self.spec_k + 1),), np.int32),
            }
        b = self._dbuf
        for name in ("tokens", "pos", "ptab"):
            b[name][...] = 0
        b["slot_of"].fill(-1)
        return b

    def pack_draft(self, plan: StepPlan):
        """Yield packed draft-prefill steps (same fixed (T, 1) ragged
        shape as the target step, against the DRAFT page tables). Chunks
        are grouped greedily up to the token budget; logits are never
        consumed (the draft only needs its KV written). Each yielded dict
        reuses one buffer set — the executor copies to device before the
        next iteration."""
        entries = plan.draft_prefill
        gi = 0
        while gi < len(entries):
            buf = self._draft_buf()
            tokens, pos, slot_of = (buf["tokens"], buf["pos"],
                                    buf["slot_of"])
            i = 0
            while gi < len(entries):
                slot, off, n, toks = entries[gi]
                if i + n > self.max_batch_tokens:
                    assert i > 0, (n, self.max_batch_tokens)
                    break
                tokens[i:i + n] = toks
                pos[i:i + n] = off + np.arange(n)
                slot_of[i:i + n] = slot
                i += n
                gi += 1
            ptab = buf["ptab"]
            valid = slot_of >= 0
            ptab[valid] = self.draft_tables.table[slot_of[valid]]
            yield {"tokens": tokens[:, None], "pos": pos,
                   "page_table": ptab, "logit_rows": buf["logit_rows"],
                   "n_logits": 0}

    def draft_inputs(self, plan: StepPlan):
        """Host inputs for the k-step draft scan: (tok0 (n_slots, 1),
        pos0 (n_slots,), table (n_slots, n_ptab), src (n_slots,)).
        Non-drafting slots (free, or mid-prefill) feed a dummy token at
        position 0 against the NULL table row so their scan writes are
        inert — their real draft pages must not be touched. ``src``
        carries the plan's device-token sources (pipelined mode; -1
        rows keep the host token)."""
        tok0 = np.zeros((self.n_slots, 1), np.int32)
        pos0 = np.zeros((self.n_slots,), np.int32)
        table = np.zeros_like(self.draft_tables.table)
        src = np.full((self.n_slots,), -1, np.int32)
        for slot, tok, p in plan.spec:
            tok0[slot, 0] = tok
            pos0[slot] = p
            table[slot] = self.draft_tables.table[slot]
            src[slot] = plan.srcs.get(slot, -1)
        return tok0, pos0, table, src

    def pack_decode(self, plan: StepPlan):
        """Compact slot-major inputs for the pure-decode fast path:
        (tokens (n_slots, 1), pos (n_slots,), table (n_slots, n_ptab),
        src (n_slots,)). One row per SLOT (not per token) — the fused
        decode step runs at batch = n_slots, a single fixed compile
        shape. Non-decoding slots feed a dummy token at position 0
        against the NULL table row so their cache writes land on the
        null page. ``src`` carries the plan's device-token sources
        (pipelined mode). Only valid for plans that are pure decode (no
        prefill/spec/cow work)."""
        tok = np.zeros((self.n_slots, 1), np.int32)
        pos = np.zeros((self.n_slots,), np.int32)
        table = np.zeros_like(self.tables.table)
        src = np.full((self.n_slots,), -1, np.int32)
        for slot, t, p in plan.decode:
            tok[slot, 0] = t
            pos[slot] = p
            table[slot] = self.tables.table[slot]
            src[slot] = plan.srcs.get(slot, -1)
        return tok, pos, table, src

    # --------------------------------------------------- pipelined dispatch

    def note_dispatch(self, plan: StepPlan, *, slot_major: bool = False
                      ) -> None:
        """Record that ``plan`` was dispatched without waiting for its
        tokens (one-step-ahead mode): every logit consumer's slot now
        has predicted-but-unobserved tokens in flight, and its next fed
        token lives in the dispatched step's device token vector —
        ``pending_src`` is the index the NEXT plan's rows inject it
        from (consumer-row order for a ragged step; ``slot_major=True``
        for the fused decode step, whose output vector is indexed by
        slot)."""
        i = 0
        for kind, slot in plan.logit_consumers:
            w = plan.spec_rows(slot) if kind == "spec" else 1
            seq = self.active[slot]
            seq.inflight += w
            # a spec item's base token for the FOLLOWING step is its
            # last verify row's argmax (the bonus/continuation row)
            seq.pending_src = slot if slot_major else i + w - 1
            i += w

    # ---------------------------------------------------------- observation

    def _finished(self, seq: SeqState) -> bool:
        # Guard the empty-generated case explicitly (a spec verify step
        # can consult this mid-append) and never treat eos_id=None as
        # token 0 — ``None == tok`` is False today only by accident of
        # int/None comparison, so make the intent structural.
        if len(seq.generated) >= seq.req.max_new_tokens:
            return True
        return (self.eos_id is not None and bool(seq.generated)
                and seq.generated[-1] == self.eos_id)

    def _retire_slot(self, seq: SeqState, retired: list) -> None:
        retired.append(seq)
        del self.active[seq.slot]
        self._accept_ema.pop(seq.slot, None)
        self.tables.release(seq.slot)
        if self.draft_tables is not None:
            self.draft_tables.release(seq.slot)
        self.free.append(seq.slot)

    def _mark_stale(self, slot: int, ahead: Optional[StepPlan]) -> None:
        """Invalidate a slot's optimistically-packed rows in the already-
        dispatched next plan (``ahead``): the prediction they were packed
        under just failed (the slot retired on eos, or a speculative
        verify accepted fewer rows than planned). ``observe`` will skip
        the stale consumers — their device writes land strictly past the
        true valid length (or in released pages) and are overwritten
        before they are ever attendable (see launch/README.md)."""
        if ahead is None or slot in ahead.stale:
            return
        if any(s == slot for _, s in ahead.logit_consumers):
            ahead.stale.add(slot)
            self.mispredicts += 1
            seq = self.active.get(slot)
            if seq is not None:
                seq.inflight = 0
                seq.pending_src = -1

    def _observe_spec(self, plan: StepPlan, seq: SeqState,
                      ys: np.ndarray, retired: list,
                      ahead: Optional[StepPlan] = None) -> None:
        """Greedy acceptance for one verify item: every row of ``ys`` is
        the target's argmax given [prompt, generated, drafts[:j]] — append
        row j while the drafts keep matching (longest accepted prefix),
        then the first mismatching row IS the target's correction, and a
        fully-accepted block earns the bonus token from the last row.
        Every appended token is a target argmax, which is the whole
        token-identity argument. Afterwards both pools shrink back to the
        true sequence length so page tables and refcounts equal a
        never-drafted run's — UNLESS the prediction fully held and the
        next step is already in flight over the predicted extent, in
        which case the pages past the true length are exactly the ones
        that step is using and the shrink is deferred to its own
        observation."""
        slot = seq.slot
        k = plan.spec_k_of.get(slot, self.spec_k)
        drafts = plan.spec_drafts[slot][:k]
        self.spec_cycles += 1
        self.spec_drafted += k
        n_acc = 0
        n_app = 0
        done = False
        for j in range(k):
            tok = int(ys[j])
            seq.generated.append(tok)
            n_app += 1
            self.gen_tokens += 1
            accepted = tok == int(drafts[j])
            if accepted:
                self.spec_accepted += 1
                n_acc += 1
            done = self._finished(seq)
            if done or not accepted:
                break
        else:
            # all k drafts accepted -> the k+1-th row is a free token
            seq.generated.append(int(ys[k]))
            n_app += 1
            self.gen_tokens += 1
            done = self._finished(seq)
        if self.adaptive_spec:
            # per-slot acceptance EMA drives the next cycle's k' (see
            # _slot_k). Fraction of THIS cycle's offered drafts accepted.
            frac = n_acc / k
            old = self._accept_ema.get(slot)
            self._accept_ema[slot] = (frac if old is None
                                      else 0.5 * old + 0.5 * frac)
        if done:
            self._mark_stale(slot, ahead)
            self._retire_slot(seq, retired)
            return
        if n_app == k + 1 and seq.inflight > n_app:
            # the optimistic prediction held AND the next step is in
            # flight at the predicted positions — its pages must stay
            seq.inflight -= n_app
            return
        # short acceptance (or nothing in flight): the continuation rows
        # packed ahead (if any) assumed a longer sequence — discard them
        # and rewind both pools to the true length, leaving page tables
        # and refcounts equal to a synchronous trajectory's
        self._mark_stale(slot, ahead)
        seq.inflight = 0
        seq.pending_src = -1
        valid = seq.prompt_len + len(seq.generated) - 1
        self.tables.shrink(slot, valid)
        self.draft_tables.shrink(slot, valid)

    def observe(self, plan: StepPlan, toks: np.ndarray, now: float,
                ahead: Optional[StepPlan] = None) -> list:
        """Apply one step's argmax tokens (aligned with
        ``plan.logit_consumers``; a "spec" consumer takes its
        ``spec_rows(slot)`` rows); returns the retired ``SeqState``s (slot freed, pages
        released — the engine turns them into results).

        ``ahead`` (pipelined mode) is the NEXT plan, already dispatched
        under the optimistic assumption that every slot here continues:
        when that assumption fails (eos retirement, short speculative
        accept) the slot's rows in ``ahead`` are marked stale and its
        page state rewound (``_mark_stale``/``_observe_spec``). Rows of
        ``plan`` itself that an EARLIER observation marked stale are
        skipped — their slot retired (or rewound) before this step's
        tokens arrived, so its outputs here belong to a dead
        prediction."""
        retired = []
        i = 0
        for kind, slot in plan.logit_consumers:
            w = plan.spec_rows(slot) if kind == "spec" else 1
            if slot in plan.stale:
                i += w
                continue
            seq = self.active[slot]
            if kind == "spec":
                self._observe_spec(plan, seq, toks[i:i + w], retired,
                                   ahead)
                i += w
                continue
            seq.generated.append(int(toks[i]))
            self.gen_tokens += 1
            i += 1
            if seq.inflight:
                seq.inflight -= 1
            if kind == "first":
                seq.ttft_s = now - seq.req.submit_time
                if self.prefix is not None:
                    # prefill complete -> its full prompt pages hold real
                    # KV on device; adopt them into the prefix cache
                    self.prefix.register(seq.req.prompt,
                                         self.tables.owned_pages(slot))
            if self._finished(seq):
                self._mark_stale(slot, ahead)
                self._retire_slot(seq, retired)
        return retired

    @property
    def idle(self) -> bool:
        return not self.queue and not self.active
