"""Continuous-batching serve engine — counterpart of
``repro.launch.engine.ServeEngine``, unified schedule.

Each step the token-budget scheduler (``launch/scheduler.py``, a copy of
the reference's) packs up to ``max_batch_tokens`` of work — one decode
token per running slot plus prefill chunks for admitting ones — into one
ragged model invocation against the paged KV pool
(``launch/executor.py``); plans that are pure decode run as one batched
``model.decode`` instead (two launches per layer's attention block where
``ops.use_fused_decode`` allows the decode prologue).

The loop is pipelined at depth 1 by default, as the reference's: plan,
pack and dispatch step N+1 while step N runs, then observe step N's
tokens, rolling back step N+1's rows of any slot whose prediction failed
(``TokenBudgetScheduler.observe(ahead=)``). ``pipeline=False``, or
``REPRO_SYNC_STEP`` set with ``pipeline=None``, runs the synchronous
loop: dispatch, block on the step's token ids, observe.

The legacy prefill-on-admit schedule, prefix caching, speculative
decoding and tensor-parallel meshes are later slices of the port and
raise ``NotImplementedError``.

The engine runs on ``device`` (default ``"cuda"``); params are moved
there. Without a CUDA device it raises unless ``device="cpu"`` was asked
for.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.launch.executor import RaggedExecutor, TokenFetch
from repro_torch.launch.paged import PagePool, SlotPageTables
from repro_torch.launch.scheduler import (RequestResult, Request, SeqState,
                                          TokenBudgetScheduler)
from repro_torch.models.layers import KV_QUANT_GROUP
from repro_torch.models.model import to_device


def resolve_device(device) -> torch.device:
    """``device`` as a torch device; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found; pass device='cpu' (or "
                           "--device cpu) to run on the host")
    return dev


@dataclasses.dataclass
class _InFlight:
    """One dispatched-but-unobserved step: its plan, its token fetch, and
    whether the token vector is slot-major (pure-decode fast path) or
    consumer-row major (ragged step)."""
    plan: object
    toks: TokenFetch
    slot_major: bool


def _later_slice(what: str):
    return NotImplementedError(f"{what} is not ported yet: a later slice of "
                               f"the PyTorch port brings it")


class ServeEngine:
    """Continuous-batching greedy-decode engine over the paged KV pool (see
    module docstring). ``max_len`` bounds prompt + generated tokens per
    slot."""

    def __init__(self, model, params, *, n_slots: int = 4,
                 max_len: int = 256, eos_id: Optional[int] = None,
                 page_size: int = 16, prefill_chunk: int = 0,
                 n_pages: int = 0, paged_kernel: bool = False,
                 schedule: str = "unified", max_batch_tokens: int = 0,
                 fused: bool = True, device="cuda",
                 pipeline: Optional[bool] = None,
                 prefix_cache: bool = False, speculative_k: int = 0,
                 draft=None, mesh=None):
        if schedule == "legacy":
            raise _later_slice("schedule='legacy' (prefill-on-admit)")
        if schedule != "unified":
            raise ValueError(f"schedule must be 'legacy' or 'unified', "
                             f"got {schedule!r}")
        if prefix_cache:
            raise _later_slice("prefix_cache")
        if speculative_k or draft is not None:
            raise _later_slice("speculative decoding")
        if mesh is not None:
            raise _later_slice("mesh (tensor-parallel) serving")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if prefill_chunk < 0:
            raise ValueError(f"prefill_chunk must be >= 0, got "
                             f"{prefill_chunk}")
        if model.cfg.kv_quant_bits and page_size % KV_QUANT_GROUP:
            raise ValueError(f"page_size={page_size} must be a multiple of "
                             f"the KV quant scale group ({KV_QUANT_GROUP})")
        self.device = resolve_device(device)
        self.model = model
        self.schedule = schedule
        # depth-1 pipelined loop by default, as the reference's;
        # REPRO_SYNC_STEP selects the synchronous loop when pipeline=None
        if pipeline is None:
            pipeline = not os.environ.get("REPRO_SYNC_STEP")
        self.pipeline = bool(pipeline)
        self._inflight: Optional[_InFlight] = None
        self._host_s = 0.0      # host planning/pack/observe seconds
        self._hidden_s = 0.0    # ... of which while a step was in flight
        self.n_slots, self.max_len, self.eos_id = n_slots, max_len, eos_id
        self.paged = True
        self.prefill_chunk, self.paged_kernel = prefill_chunk, paged_kernel
        self._kv_len = -(-max_len // page_size) * page_size
        n_ptab = self._kv_len // page_size
        n_pages = n_pages or 1 + n_slots * n_ptab    # worst case + null
        self.pool = PagePool(n_pages, page_size)
        self.tables = SlotPageTables(self.pool, n_slots, n_ptab)
        cache = dict(model.init_paged_cache(n_pages, page_size, self.device))
        self.quantized_kv = "k_scale" in cache
        self._page_bytes = (sum(v.numel() * v.element_size()
                                for v in cache.values()) // n_pages)
        params = to_device(params, self.device)
        self.fused = bool(fused)
        if self.fused:
            params = model.make_serving_params(params)
        self.max_batch_tokens = max_batch_tokens or max(16, 2 * n_slots)
        if self.max_batch_tokens < n_slots:
            raise ValueError(
                f"max_batch_tokens={self.max_batch_tokens} must be >= "
                f"n_slots={n_slots} (every decoding slot packs one row per "
                f"step)")
        self.sched = TokenBudgetScheduler(
            n_slots, self.max_batch_tokens, pool=self.pool,
            tables=self.tables, prefill_chunk=prefill_chunk, eos_id=eos_id)
        self.exec = RaggedExecutor(model, params, cache, n_slots=n_slots,
                                   paged_kernel=paged_kernel,
                                   device=self.device)
        self._queue = self.sched.queue
        self._active = self.sched.active
        self.params = self.exec.params
        self.step_count = 0
        self._next_rid = 0
        self.events: list = []
        self.results: dict = {}
        self.metrics = self._fresh_metrics()

    @staticmethod
    def _fresh_metrics() -> dict:
        return {"queue_depth": [], "occupancy": [],
                "resident_kv_bytes": [], "step_s": [], "device_s": [],
                "generated_tokens": 0, "decode_steps": 0}

    def reset(self) -> None:
        """Return an idle engine to its just-built state (metrics, results,
        scheduler counters) without touching params or pools — the
        warmup/steady-state benchmark hook."""
        if not self.idle:
            raise RuntimeError("reset() needs an idle engine "
                               "(drain the queue first)")
        self.step_count = 0
        self._next_rid = 0
        self._inflight = None
        self._host_s = self._hidden_s = 0.0
        self.exec.reset_pipeline()
        self.exec.n_dispatch = 0
        self.events = []
        self.results = {}
        self.metrics = self._fresh_metrics()
        self.sched.reset()
        self.pool.peak_in_use = self.pool.in_use

    @property
    def _cache(self):
        return self.exec.cache

    # ------------------------------------------------------------- intake

    def submit(self, prompt, max_new_tokens: int, rid: Optional[int] = None
               ) -> int:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if not len(prompt):
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, "
                             f"got {max_new_tokens}")
        if len(prompt) + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt({len(prompt)}) + max_new_tokens({max_new_tokens}) "
                f"exceeds max_len={self.max_len}")
        need = self.tables.pages_for(len(prompt) + max_new_tokens)
        if need > self.pool.n_pages - 1:
            raise ValueError(
                f"request needs {need} pages but the pool only has "
                f"{self.pool.n_pages - 1} allocatable (raise n_pages "
                f"or max_len/page_size)")
        if rid is None:
            rid = self._next_rid
        elif (rid in self.results
              or any(r.req.rid == rid for r in self._active.values())
              or any(r.rid == rid for r in self._queue)):
            raise ValueError(f"duplicate request id {rid}")
        self._next_rid = max(self._next_rid, rid) + 1
        self._queue.append(Request(rid, prompt, max_new_tokens,
                                   submit_time=time.perf_counter()))
        return rid

    # --------------------------------------------------------------- step

    def resident_kv_bytes(self) -> int:
        """KV bytes reserved for live sequences (allocated pages)."""
        return self.pool.in_use * self._page_bytes

    def step(self) -> dict:
        """One unified engine cycle: plan one token-budgeted step, run it,
        feed tokens back, retire (pipelined: one step ahead)."""
        if self.pipeline:
            return self._step_pipelined()
        return self._step_sync()

    def _plan_and_dispatch(self):
        """Front half of a cycle: plan, account metrics and dispatch the
        packed step without blocking. -> (plan, in_flight or None for an
        empty plan)."""
        plan = self.sched.plan(self.step_count)
        for rid, slot in plan.admitted:
            self.events.append(("admit", rid, slot, self.step_count))
        self.metrics["queue_depth"].append(len(self._queue))
        self.metrics["occupancy"].append(len(self._active) / self.n_slots)
        self.metrics["resident_kv_bytes"].append(self.resident_kv_bytes())
        if not plan.n_tokens:
            return plan, None
        if (plan.decode and not plan.prefill
                and self.exec.supports_decode_step):
            # pure-decode fast path: one batched model.decode
            tok, dpos, table, src = self.sched.pack_decode(plan)
            inf = _InFlight(plan, self.exec.decode_step(tok, dpos, table,
                                                        src), True)
        else:
            packed = self.sched.pack(plan, kernel_desc=self.paged_kernel)
            inf = _InFlight(plan, self.exec.step(packed), False)
        if plan.decode:
            self.metrics["decode_steps"] += 1
        return plan, inf

    def _observe_tokens(self, inf: _InFlight, toks: np.ndarray,
                        ahead=None) -> None:
        """Back half: feed a step's fetched tokens through the scheduler
        and retire what finished."""
        plan = inf.plan
        if inf.slot_major:
            toks = toks[[slot for slot, _, _ in plan.decode]]
        gen_before = self.sched.gen_tokens
        retired = self.sched.observe(plan, toks, time.perf_counter(),
                                     ahead=ahead)
        self.metrics["generated_tokens"] += (self.sched.gen_tokens
                                             - gen_before)
        for seq in retired:
            self._retire_seq(seq)

    def _step_stats(self, plan) -> dict:
        return {"queue_depth": self.metrics["queue_depth"][-1],
                "occupancy": self.metrics["occupancy"][-1],
                "active": len(self._active),
                "packed_tokens": plan.n_tokens}

    def _step_sync(self) -> dict:
        """The synchronous cycle: dispatch, block on the step's tokens,
        observe — the device span is an honest blocked wait."""
        t0 = time.perf_counter()
        plan, inf = self._plan_and_dispatch()
        if inf is not None:
            td = time.perf_counter()
            toks = inf.toks.result()
            dev_s = time.perf_counter() - td
            self._observe_tokens(inf, toks)
            self.metrics["step_s"].append(time.perf_counter() - t0)
            self.metrics["device_s"].append(dev_s)
        self.step_count += 1
        return self._step_stats(plan)

    def _step_pipelined(self) -> dict:
        """The depth-1 asynchronous cycle (reference ``engine.py:721``):
        plan + pack + dispatch step N with decoding slots assumed to
        continue (fed tokens injected on the card from step N-1's
        vector), then wait for step N-1's tokens and observe them,
        rolling back step N's rows of any slot whose prediction failed.
        A (step_s, device_s) span is recorded only on cycles that observe
        a step, device_s being the wait for its tokens."""
        t0 = time.perf_counter()
        prev = self._inflight
        self._inflight = None
        plan, inf = self._plan_and_dispatch()
        if inf is not None:
            self.sched.note_dispatch(inf.plan, slot_major=inf.slot_major)
        seg = time.perf_counter() - t0
        self._host_s += seg
        if prev is not None:
            self._hidden_s += seg       # packed under step N-1's compute
        if prev is not None:
            tw = time.perf_counter()
            toks = prev.toks.result()
            wait_s = time.perf_counter() - tw
            t1 = time.perf_counter()
            self._observe_tokens(prev, toks,
                                 ahead=inf.plan if inf else None)
            seg = time.perf_counter() - t1
            self._host_s += seg
            if inf is not None:
                self._hidden_s += seg   # observed under step N's compute
            self.metrics["step_s"].append(time.perf_counter() - t0)
            self.metrics["device_s"].append(wait_s)
        self._inflight = inf
        self.step_count += 1
        return self._step_stats(plan)

    def _retire_seq(self, seq: SeqState) -> None:
        rid = seq.req.rid
        if rid in self.results:
            raise RuntimeError(f"request {rid} retired twice")
        self.results[rid] = RequestResult(
            rid=rid,
            tokens=np.concatenate([seq.req.prompt,
                                   np.asarray(seq.generated, np.int32)]),
            prompt_len=seq.prompt_len,
            ttft_s=seq.ttft_s,
            admit_step=seq.admit_step,
            retire_step=self.step_count,
        )
        self.events.append(("retire", rid, seq.slot, self.step_count))

    @property
    def idle(self) -> bool:
        # an in-flight pipelined step keeps the engine busy even when
        # every slot already retired (after an eos mispredict the last
        # plan can be all-stale; one more cycle discards it)
        return (not self._queue and not self._active
                and self._inflight is None)

    def run(self, requests=None) -> dict:
        """Submit ``requests`` (dicts with tokens/max_new_tokens, see
        ``repro_torch.data.request_workload``) and step until drained."""
        for r in requests or ():
            self.submit(r["tokens"], r["max_new_tokens"], rid=r.get("rid"))
        t0 = time.perf_counter()
        while not self.idle:
            self.step()
        self.metrics["wall_s"] = time.perf_counter() - t0
        return self.results

    # ------------------------------------------------------------ metrics

    def summary(self) -> dict:
        m = self.metrics
        ttfts = [r.ttft_s for r in self.results.values()]
        if any(t < 0 for t in ttfts):
            raise RuntimeError(f"negative TTFT: {min(ttfts)}")
        step_s, dev_s = m["step_s"], m["device_s"]
        device_ms = 1e3 * float(np.mean(dev_s)) if dev_s else 0.0
        host_ms = (1e3 * float(np.mean(step_s)) - device_ms
                   if step_s else 0.0)
        kv_cap = sum(v.numel() * v.element_size()
                     for v in self._cache.values())
        return {
            "n_requests": len(self.results),
            "n_slots": self.n_slots,
            "steps": self.step_count,
            "decode_steps": m["decode_steps"],
            "generated_tokens": m["generated_tokens"],
            "wall_s": m.get("wall_s", 0.0),
            "tok_per_s": (m["generated_tokens"] / m["wall_s"]
                          if m.get("wall_s") else 0.0),
            "ttft_s_mean": float(np.mean(ttfts)) if ttfts else 0.0,
            "ttft_s_max": float(np.max(ttfts)) if ttfts else 0.0,
            "itl_p50_s": float(np.percentile(step_s, 50)) if step_s else 0.0,
            "itl_p95_s": float(np.percentile(step_s, 95)) if step_s else 0.0,
            "occupancy_mean": (float(np.mean(m["occupancy"]))
                               if m["occupancy"] else 0.0),
            "queue_depth_max": (int(np.max(m["queue_depth"]))
                                if m["queue_depth"] else 0),
            "quantized_kv": self.quantized_kv,
            "paged": True,
            "schedule": self.schedule,
            "fused": self.fused,
            "device": str(self.device),
            # host-clock split of a timed step: the blocked wait for the
            # step's token ids vs. the rest (plan, pack, dispatch, observe)
            "device_ms_mean": device_ms,
            "host_ms_mean": max(0.0, host_ms),
            "n_dispatch": self.exec.n_dispatch,
            "dispatch_per_step": (self.exec.n_dispatch
                                  / max(1, self.step_count)),
            "launches_per_token": (self.exec.n_dispatch
                                   / max(1, m["generated_tokens"])),
            "kv_capacity_bytes": kv_cap,
            "resident_kv_bytes_mean": (float(np.mean(m["resident_kv_bytes"]))
                                       if m["resident_kv_bytes"] else 0),
            "resident_kv_bytes_peak": (int(np.max(m["resident_kv_bytes"]))
                                       if m["resident_kv_bytes"] else 0),
            "page_size": self.pool.page_size,
            "n_pages": self.pool.n_pages,
            "pages_peak": self.pool.peak_in_use,
            "prefill_chunk": self.prefill_chunk,
            "prefix_cache": False,
            "max_batch_tokens": self.max_batch_tokens,
            "packed_tokens_max": self.sched.packed_tokens_max,
            "pipeline": self.pipeline,
            # share of host planning/pack/observe seconds spent while a
            # step was in flight on the card (0.0 when synchronous)
            "overlap_frac": (self._hidden_s / self._host_s
                             if self._host_s else 0.0),
            # hidden host milliseconds per observed step
            "host_ms_hidden": (1e3 * self._hidden_s / len(dev_s)
                               if dev_s else 0.0),
            "mispredicts": self.sched.mispredicts,
            "mesh": None,
        }
