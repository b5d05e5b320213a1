"""The port's depth-1 pipelined serving loop, on the CPU.

- Pipelined against synchronous, in the port, on the golden workload and
  the params of ``regenerate.build_case`` (fp, int8_kv, w4_packed), with
  and without ``paged_kernel``: tokens identical. After every observed
  step of the pipelined engine (which has then already planned and run
  the next step) its page state is consistent — each page a slot table
  maps has refcount 1, every other page 0, ``in_use`` their count — and
  every live sequence's KV rows up to its last fed token are bitwise
  equal to the synchronous engine's rows for the same request. The two
  loops' plans are not step-for-step equal: pipelined admission lags one
  cycle behind a retirement it has not observed yet (as in the
  reference), so state is compared per request, not per step index.
- Pipelined against the live JAX pipelined engine in f32: plan logs equal
  after every step, tokens exact.
- A forced eos retirement (a mispredict) rolls the in-flight step back to
  the synchronous trajectory: tokens and the drained pool equal.
- ``REPRO_SYNC_STEP`` selects the synchronous loop for ``pipeline=None``;
  an explicit ``pipeline=True`` still wins. ``summary()`` reports
  ``pipeline``, ``overlap_frac``, ``host_ms_hidden`` and ``mispredicts``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from golden import regenerate

from repro.data import request_workload
from repro.launch.engine import ServeEngine as JEngine
from repro.models import build as j_build
from repro_torch import configs as tconfigs
from repro_torch.convert import from_reference
from repro_torch.launch.engine import ServeEngine
from repro_torch.models import build as t_build

torch.set_num_threads(1)

KW = dict(n_slots=regenerate.N_SLOTS, max_len=regenerate.MAX_LEN,
          schedule="unified", page_size=8, max_batch_tokens=6)


@pytest.fixture(scope="module")
def cases():
    built = {}

    def get(name):
        if name not in built:
            built[name] = regenerate.build_case(name)
        return built[name]
    return get


def _workload(cfg):
    return request_workload(cfg, regenerate.N_REQUESTS, gen=regenerate.GEN,
                            lengths=regenerate.LENGTHS,
                            seed=regenerate.SEED)


def _port(cfg, params, dtype=None, **kw):
    if dtype:
        cfg = cfg.scaled(dtype=dtype)
    tcfg = tconfigs.ArchConfig(**dataclasses.asdict(cfg))
    return ServeEngine(t_build(tcfg), from_reference(params), device="cpu",
                       **{**KW, **kw})


def _kv_rows(eng, seq, n):
    """The KV pool rows [0, n) of a live sequence, gathered through its
    page table: {leaf: (L, n, KVH, ·)}."""
    ps = eng.pool.page_size
    pos = np.arange(n)
    pages = torch.as_tensor(eng.tables.table[seq.slot][pos // ps]).long()
    rows = torch.as_tensor(pos % ps).long()
    return {k: v[:, pages, rows].clone() for k, v in eng.exec.cache.items()}


def _check_page_state(eng):
    """Every page a slot table maps is owned once; no other page is."""
    mapped = eng.tables.table[eng.tables.table > 0]
    assert len(set(mapped.tolist())) == len(mapped)
    assert eng.pool.in_use == len(mapped)
    for p in range(1, eng.pool.n_pages):
        assert eng.pool.refcount(p) == int(p in set(mapped.tolist())), p


def _record_sync_rows(eng):
    """Before each observation of the synchronous engine, keep every live
    sequence's written KV rows (prompt rows written so far plus one row
    per fed generated token), per request id."""
    rows = {}
    real = eng._observe_tokens

    def wrapped(*a, **kw):
        for seq in eng.sched.active.values():
            n = seq.prefill_done + len(seq.generated)
            rows[seq.req.rid] = _kv_rows(eng, seq, n)
        return real(*a, **kw)
    eng._observe_tokens = wrapped
    return rows


def _check_after_observations(eng, want_rows):
    """After each observation of the pipelined engine (the next step is
    already planned and run): page state consistent, and every live
    sequence's rows up to its last fed token equal the synchronous
    engine's rows of the same request."""
    count = {"n": 0}
    real = eng._observe_tokens

    def wrapped(*a, **kw):
        out = real(*a, **kw)
        count["n"] += 1
        _check_page_state(eng)
        for seq in eng.sched.active.values():
            n = seq.prefill_done + max(0, len(seq.generated) - 1)
            want = want_rows[seq.req.rid]
            for key, got in _kv_rows(eng, seq, n).items():
                assert torch.equal(got, want[key][:, :n]), (key, n)
        return out
    eng._observe_tokens = wrapped
    return count


def _drain(eng, reqs):
    for r in reqs:
        eng.submit(r["tokens"], r["max_new_tokens"], rid=r["rid"])
    while not eng.idle:
        eng.step()
    assert eng.pool.in_use == 0
    return eng.results


@pytest.mark.parametrize("paged_kernel", [False, True],
                         ids=["gather", "paged_kernel"])
@pytest.mark.parametrize("name", sorted(regenerate.CASES))
def test_pipelined_equals_sync_state_after_every_step(cases, name,
                                                      paged_kernel):
    cfg, _, params = cases(name)
    reqs = _workload(cfg)
    sync = _port(cfg, params, pipeline=False, paged_kernel=paged_kernel)
    pipe = _port(cfg, params, pipeline=True, paged_kernel=paged_kernel)
    sync_rows = _record_sync_rows(sync)
    want = _drain(sync, reqs)
    observed = _check_after_observations(pipe, sync_rows)
    got = _drain(pipe, reqs)
    for r in reqs:
        np.testing.assert_array_equal(got[r["rid"]].tokens,
                                      want[r["rid"]].tokens)
    assert observed["n"] == pipe.exec.n_dispatch > 0
    _check_page_state(pipe)
    s = pipe.summary()
    assert s["pipeline"] is True and s["mispredicts"] == 0
    assert sync.summary()["overlap_frac"] == 0.0


def test_pipelined_matches_live_jax_pipelined_f32(cases):
    cfg, _, params = cases("w4_packed")
    cfg = cfg.scaled(dtype="float32")
    reqs = _workload(cfg)
    jeng = JEngine(j_build(cfg), params, pipeline=True, **KW)
    teng = _port(cfg, params, pipeline=True)
    for r in reqs:
        jeng.submit(r["tokens"], r["max_new_tokens"], rid=r["rid"])
        teng.submit(r["tokens"], r["max_new_tokens"], rid=r["rid"])
    while not (jeng.idle and teng.idle):
        jeng.step()
        teng.step()
        assert list(teng.sched.plan_log) == list(jeng.sched.plan_log)
        np.testing.assert_array_equal(teng.tables.table, jeng.tables.table)
    for r in reqs:
        np.testing.assert_array_equal(teng.results[r["rid"]].tokens,
                                      jeng.results[r["rid"]].tokens)
    assert teng.summary()["mispredicts"] == jeng.summary()["mispredicts"]


def test_eos_mispredict_rolls_back_to_sync_trajectory(cases):
    """As the reference's ``test_pipelined_engine.py:233``: the second
    generated token of request 0 becomes eos, so its slot retires while
    its next decode row is already in flight; that row is discarded and
    its pages released."""
    cfg, _, params = cases("fp")
    reqs = request_workload(cfg, 4, gen=6, lengths=(6, 10), seed=11)
    kw = dict(n_slots=2, max_len=24, page_size=8, max_batch_tokens=0)
    base = _drain(_port(cfg, params, pipeline=False, **kw), reqs)
    eos = int(base[0].tokens[base[0].prompt_len + 1])
    engines = [_port(cfg, params, pipeline=p, eos_id=eos, **kw)
               for p in (False, True)]
    runs = [_drain(e, reqs) for e in engines]
    for r in reqs:
        np.testing.assert_array_equal(runs[1][r["rid"]].tokens,
                                      runs[0][r["rid"]].tokens)
    sync_eng, pipe_eng = engines
    assert pipe_eng.summary()["mispredicts"] > 0
    assert sync_eng.summary()["mispredicts"] == 0
    assert (pipe_eng.metrics["generated_tokens"]
            == sync_eng.metrics["generated_tokens"])
    assert pipe_eng._inflight is None
    assert pipe_eng.pool.available == pipe_eng.pool.n_pages - 1


def test_sync_env_var_and_summary_fields(cases, monkeypatch):
    cfg, _, params = cases("fp")
    eng = _port(cfg, params)
    assert eng.pipeline is True
    reqs = _workload(cfg)
    eng.run(reqs)
    s = eng.summary()
    assert s["pipeline"] is True and s["mispredicts"] == 0
    assert 0.0 < s["overlap_frac"] <= 1.0 and s["host_ms_hidden"] > 0.0
    assert len(eng.metrics["step_s"]) == len(eng.metrics["device_s"]) > 0
    for ss, d in zip(eng.metrics["step_s"], eng.metrics["device_s"]):
        assert 0.0 <= d <= ss
    # reset() drops the in-flight state; a rerun repeats the first run
    first = {r["rid"]: eng.results[r["rid"]].tokens.copy() for r in reqs}
    eng.reset()
    assert eng._inflight is None and eng.exec._prev is None
    assert eng.summary()["overlap_frac"] == 0.0
    res = eng.run(reqs)
    for r in reqs:
        np.testing.assert_array_equal(res[r["rid"]].tokens, first[r["rid"]])
    monkeypatch.setenv("REPRO_SYNC_STEP", "1")
    assert _port(cfg, params).pipeline is False
    assert _port(cfg, params, pipeline=True).pipeline is True
