"""Prefix-cache admission in the port never waits forever, on the CPU.

The reference's admission (``launch/scheduler.py`` and the legacy
``ServeEngine._admit``) waits whenever ``PrefixCache.make_room`` fails. When
no slot is live, nothing will ever free a page, and the pages the hit
protects can be the very pages the reservation needs: on the workload
``seed=2, n_reqs=6, n_slots=1, budget_extra=0, prefill_chunk=0,
page_size=4, tight_pool=False`` of
``tests/test_prefix_cache_properties.py``, request 5 hits one full page and
one partial page of a four-page pool, needs three pages reserved while two
are free, and every later plan is empty. The port's admission then retries
with a shorter hit (``PrefixCache.shorter_hit``: first without the partial
page, then with none).

Everything here is exact (integer bookkeeping and a pure next-token rule):

- the example drains through the port's scheduler, with the reference
  property test's invariants after every step (refcount conservation,
  shared pages at refcount >= 2, tokens equal to the per-request
  simulation, a drained pool), while the reference's scheduler, given the
  same step budget, stalls on it (the fault stays on record);
- the property test's space (seed, requests 1..8, slots 1..3, budget
  extra 0..10, prefill chunk 0..5, page 2 or 4, tight pool or not), as
  seeded cases drawn with numpy, drains through the port; on every case
  the reference also drains, the port's plans, page tables and every
  page's refcount equal the reference's after every step;
- the port's one-slot ``ServeEngine(prefix_cache=True)``, legacy and
  unified, drains the example on a seeded smoke model.

No test here uses Hypothesis or its example database.
"""
import numpy as np
import pytest
import torch

from repro.launch.paged import PagePool as JPool
from repro.launch.paged import PrefixCache as JPrefix
from repro.launch.paged import SlotPageTables as JTables
from repro.launch.scheduler import Request as JRequest
from repro.launch.scheduler import TokenBudgetScheduler as JSched
from repro_torch import configs as tconfigs
from repro_torch.launch.engine import ServeEngine
from repro_torch.launch.paged import NULL_PAGE, PagePool, PrefixCache
from repro_torch.launch.paged import SlotPageTables
from repro_torch.launch.scheduler import Request, TokenBudgetScheduler
from repro_torch.models import build as t_build

torch.set_num_threads(1)

_V = 64
GUARD = 2000
EXAMPLE = dict(seed=2, n_reqs=6, n_slots=1, budget_extra=0, prefill_chunk=0,
               page_size=4, tight_pool=False)


def _next_token(tok, pos):
    return (tok * 7 + pos * 13 + 1) % _V


def _simulate(prompt, max_new):
    toks = list(prompt)
    tok, pos = int(prompt[-1]), len(prompt) - 1
    for _ in range(max_new):
        tok = _next_token(tok, pos)
        toks.append(tok)
        pos += 1
    return toks


def _workload(seed, n_reqs, page_size):
    """The reference property test's ``_shared_workload``: requests over
    two seeded system prompts, as (rid, prompt, max_new)."""
    rng = np.random.default_rng(seed)
    G = page_size
    sys1 = rng.integers(0, _V, 3 * G + 1).astype(np.int32)
    sys2 = rng.integers(0, _V, G).astype(np.int32)
    reqs = []
    for rid in range(n_reqs):
        kind = rng.integers(0, 4)
        head = (sys1, sys1[:G + 1], sys2, sys1[:0])[kind]
        tail = rng.integers(0, _V, int(rng.integers(0, 2 * G + 1)))
        prompt = np.concatenate([head, tail]).astype(np.int32)
        if not len(prompt):
            prompt = np.asarray([int(rng.integers(0, _V))], np.int32)
        reqs.append((rid, prompt, int(rng.integers(1, 6))))
    return reqs


class _Drive:
    """One package's scheduler with a prefix cache over a workload,
    stepped by a pure python executor."""

    def __init__(self, classes, case):
        pool_cls, tables_cls, prefix_cls, sched_cls, req_cls = classes
        self.case = case
        reqs = _workload(case["seed"], case["n_reqs"], case["page_size"])
        self.reqs = reqs
        ps, n_slots = case["page_size"], case["n_slots"]
        max_len = max(len(p) + n for _, p, n in reqs) + 1
        n_ptab = -(-max_len // ps)
        n_pages = 1 + n_slots * n_ptab
        if case["tight_pool"]:
            n_pages = 1 + max(-(-(len(p) + n) // ps) for _, p, n in reqs) + 1
        self.pool = pool_cls(n_pages, ps)
        self.tables = tables_cls(self.pool, n_slots, n_ptab)
        self.prefix = prefix_cls(self.pool, ps)
        self.sched = sched_cls(n_slots, n_slots + case["budget_extra"],
                               pool=self.pool, tables=self.tables,
                               prefill_chunk=case["prefill_chunk"],
                               prefix=self.prefix)
        for rid, prompt, n in reqs:
            self.sched.queue.append(req_cls(rid, prompt, n))
        self.done = {}
        self.steps = 0

    def step(self):
        self.steps += 1
        plan = self.sched.plan(self.steps)
        packed = self.sched.pack(plan)
        toks = [_next_token(int(packed["tokens"][row, 0]),
                            int(packed["pos"][row]))
                for row in packed["logit_rows"][:packed["n_logits"]]]
        for seq in self.sched.observe(plan, np.asarray(toks), now=0.0):
            assert seq.req.rid not in self.done, "retired twice"
            self.done[seq.req.rid] = list(seq.req.prompt) + seq.generated
        return plan

    def state(self):
        return (self.sched.plan_log[-1], self.tables.table.tolist(),
                [self.pool.refcount(p) for p in range(self.pool.n_pages)],
                self.prefix.stats())

    def check_refcounts(self):
        pool, tables, prefix = self.pool, self.tables, self.prefix
        n_slots = self.case["n_slots"]
        slot_pages = [p for s in range(n_slots)
                      for p in tables.owned_pages(s)]
        trie_pages = [n.page for n in prefix._walk()]
        assert pool.total_refs == len(slot_pages) + len(trie_pages)
        assert prefix.resident == len(trie_pages)
        assert pool.in_use == len(set(slot_pages) | set(trie_pages))
        assert pool.refcount(NULL_PAGE) == 0
        assert NULL_PAGE not in slot_pages and NULL_PAGE not in trie_pages
        assert pool.available + pool.in_use == pool.n_pages - 1
        for s in range(n_slots):
            for p in tables._shared[s]:
                assert p in tables.owned_pages(s)
                assert pool.refcount(p) >= 2

    def check_drained(self):
        for rid, prompt, n in self.reqs:
            assert self.done[rid] == _simulate(prompt, n), rid
        assert sorted(self.sched.free) == list(range(self.case["n_slots"]))
        assert self.tables.reserved_unallocated == 0
        assert self.pool.in_use == self.prefix.resident
        self.prefix.clear()
        assert self.pool.in_use == 0 and self.pool.total_refs == 0
        assert self.pool.allocs == self.pool.frees


PORT = (PagePool, SlotPageTables, PrefixCache, TokenBudgetScheduler,
        Request)
REFERENCE = (JPool, JTables, JPrefix, JSched, JRequest)


def _drain_port(case):
    d = _Drive(PORT, case)
    while not d.sched.idle:
        assert d.steps < GUARD, f"port scheduler failed to drain {case}"
        d.step()
        d.check_refcounts()
    d.check_drained()
    return d


def test_livelock_example_drains_in_the_port_and_stalls_the_reference():
    d = _drain_port(EXAMPLE)
    assert d.prefix.stats()["prefix_hits"] > 0
    ref = _Drive(REFERENCE, EXAMPLE)
    while not ref.sched.idle and ref.steps < GUARD:
        ref.step()
    assert not ref.sched.idle, "the reference drained: the fault is gone"
    assert len(ref.done) == 5 and 5 not in ref.done


def _cases(n):
    rng = np.random.default_rng(0xC0FFEE)
    out = [dict(EXAMPLE)]
    while len(out) < n:
        out.append(dict(seed=int(rng.integers(0, 2 ** 16)),
                        n_reqs=int(rng.integers(1, 9)),
                        n_slots=int(rng.integers(1, 4)),
                        budget_extra=int(rng.integers(0, 11)),
                        prefill_chunk=int(rng.integers(0, 6)),
                        page_size=int(rng.choice([2, 4])),
                        tight_pool=bool(rng.integers(0, 2))))
    return out


@pytest.mark.parametrize("case", _cases(48),
                         ids=lambda c: "-".join(str(int(v))
                                                for v in c.values()))
def test_property_space_drains_and_matches_the_reference(case):
    """Port and reference in lockstep until the reference stalls (it
    never moves again once its plans are empty and no slot is live):
    plans, tables, refcounts and prefix stats equal after every step;
    then the port drains alone."""
    port, ref = _Drive(PORT, case), _Drive(REFERENCE, case)
    ref_stalled = False
    while not port.sched.idle:
        assert port.steps < GUARD, f"port scheduler failed to drain {case}"
        port.step()
        port.check_refcounts()
        if ref_stalled or ref.sched.idle:
            continue
        plan = ref.step()
        if ref.state() != port.state():
            # only the shorter-hit retry may make them part, and only
            # where the reference has stopped for good: nothing live and
            # an empty plan
            assert not ref.sched.active and not plan.admitted, (
                case, port.steps)
            ref_stalled = True
    port.check_drained()
    if not ref_stalled:
        assert ref.sched.idle and ref.done == port.done


def _engine_requests():
    return [{"tokens": prompt, "max_new_tokens": n, "rid": rid}
            for rid, prompt, n in _workload(2, 6, 4)]


@pytest.mark.parametrize("kw", [dict(), dict(schedule="unified",
                                             max_batch_tokens=1,
                                             pipeline=False)],
                         ids=["legacy", "unified"])
def test_one_slot_engine_drains_the_example(kw):
    """The engine's pool is ``1 + n_slots * n_ptab`` pages, as the
    scheduler drive's: with one slot the example's request 5 would wait
    forever in the reference's admission."""
    cfg = tconfigs.get_config("catlm_60m").smoke()
    model = t_build(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    reqs = _engine_requests()
    max_len = max(len(r["tokens"]) + r["max_new_tokens"] for r in reqs) + 1
    eng = ServeEngine(model, params, n_slots=1, max_len=max_len, paged=True,
                      page_size=4, prefix_cache=True, device="cpu", **kw)
    for r in reqs:
        eng.submit(r["tokens"], r["max_new_tokens"], rid=r["rid"])
    steps = 0
    while not eng.idle:
        steps += 1
        assert steps < GUARD, "engine failed to drain"
        eng.step()
    assert sorted(eng.results) == [r["rid"] for r in reqs]
    for r in reqs:
        out = eng.results[r["rid"]].tokens
        assert len(out) == len(r["tokens"]) + r["max_new_tokens"]
    assert eng.prefix.stats()["prefix_hits"] > 0
