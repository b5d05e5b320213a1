"""The port's prefix cache against the live JAX engine, on the CPU.

Both engines serve a shared-prefix version of the golden workload
(``regenerate.N_REQUESTS, GEN, LENGTHS, SEED`` with a 12-token common
prefix: one full page and a partial one at page size 8) on the params of
``regenerate.build_case``, converted with ``from_reference``, on an f32
copy of the config, with ``prefix_cache=True`` and the same engine kwargs,
stepped in lockstep on the synchronous loop. Schedules: the unified one
(page 8, budget 8) and the legacy paged pool (page 8, without and with
prefill chunks of 8), on int8_kv; the unified one also on w4_packed and
with the paged kernels (``paged_kernel=True``: the suffix prefill after a
hit takes the ragged attention's plain version).

- After every step: the events, the page tables, every page's refcount
  and the prefix-cache stats (lookups, hits, hit tokens, COW copies,
  cached pages, evictions) are equal; at the end every request's tokens
  are equal, and the workload hit the cache and split a page.
- Cache on and cache off serve identical tokens (the port alone), and
  after the drain every page still live is held by the trie.
- A second prompt that repeats the first for 10 of 16 tokens diverges
  inside its second page: admission copies that page (a COW copy), and
  the tokens still equal the cache-off run.
- ``prefix_cache`` without the paged pool raises the reference's
  ``ValueError``.
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

SCHEDULES = [
    ("unified", dict(schedule="unified", page_size=8, max_batch_tokens=8,
                     pipeline=False)),
    ("legacy_nochunk", dict(paged=True, page_size=8)),
    ("legacy_chunk8", dict(paged=True, page_size=8, prefill_chunk=8)),
]
IDS = [n for n, _ in SCHEDULES]
MAX_LEN = 40


def _f32_case(name):
    """A golden case on an f32 copy: (JAX cfg, params, port model, port
    params)."""
    cfg, _, params = regenerate.build_case(name)
    cfg = cfg.scaled(dtype="float32")
    tcfg = tconfigs.ArchConfig(**dataclasses.asdict(cfg))
    return cfg, params, t_build(tcfg), from_reference(params)


@pytest.fixture(scope="module")
def cases():
    built = {}

    def get(name):
        if name not in built:
            built[name] = _f32_case(name)
        return built[name]
    return get


@pytest.fixture(scope="module")
def int8_kv(cases):
    return cases("int8_kv")


def _shared_workload(cfg):
    return request_workload(cfg, regenerate.N_REQUESTS, gen=regenerate.GEN,
                            lengths=regenerate.LENGTHS, seed=regenerate.SEED,
                            shared_prefix=12)


def _refcounts(pool):
    return [pool.refcount(p) for p in range(pool.n_pages)]


LOCKSTEP = ([("int8_kv", kw) for _, kw in SCHEDULES]
            + [("w4_packed", SCHEDULES[0][1]),
               ("int8_kv", dict(SCHEDULES[0][1], paged_kernel=True))])


@pytest.mark.parametrize("name,kw", LOCKSTEP,
                         ids=IDS + ["unified-w4_packed",
                                    "unified-paged_kernel"])
def test_prefix_cache_lockstep_matches_live_jax(cases, name, kw):
    cfg, params, tmodel, tparams = cases(name)
    common = dict(n_slots=regenerate.N_SLOTS, max_len=MAX_LEN,
                  prefix_cache=True, **kw)
    jeng = JEngine(j_build(cfg), params, **common)
    teng = ServeEngine(tmodel, tparams, device="cpu", **common)
    reqs = _shared_workload(cfg)
    for r in reqs:
        jeng.submit(r["tokens"], r["max_new_tokens"], rid=r["rid"])
        teng.submit(r["tokens"], r["max_new_tokens"], rid=r["rid"])
    while not (jeng.idle and teng.idle):
        jeng.step()
        teng.step()
        assert teng.events == [tuple(int(v) if i else v
                                     for i, v in enumerate(e))
                               for e in jeng.events]
        np.testing.assert_array_equal(teng.tables.table, jeng.tables.table)
        assert _refcounts(teng.pool) == _refcounts(jeng.pool)
        assert teng.prefix.stats() == jeng.prefix.stats()
    assert teng.step_count == jeng.step_count
    for r in reqs:
        np.testing.assert_array_equal(teng.results[r["rid"]].tokens,
                                      jeng.results[r["rid"]].tokens,
                                      err_msg=f"rid={r['rid']}")
    ts, js = teng.summary(), jeng.summary()
    assert ts["prefix_hits"] > 0 and ts["prefix_hit_tokens"] > 0
    assert ts["cow_copies"] > 0
    for key in ("prefix_cache", "cached_kv_bytes", "resident_kv_bytes_peak",
                "resident_kv_bytes_mean", "pages_peak", "cow_copies"):
        assert ts[key] == js[key], key


@pytest.mark.parametrize("kw", [kw for _, kw in SCHEDULES], ids=IDS)
def test_prefix_cache_on_equals_off(int8_kv, kw):
    cfg, _, tmodel, tparams = int8_kv
    reqs = _shared_workload(cfg)
    common = dict(n_slots=regenerate.N_SLOTS, max_len=MAX_LEN, device="cpu",
                  **kw)
    off = ServeEngine(tmodel, tparams, **common).run(reqs)
    on_eng = ServeEngine(tmodel, tparams, prefix_cache=True, **common)
    on = on_eng.run(reqs)
    for r in reqs:
        np.testing.assert_array_equal(on[r["rid"]].tokens,
                                      off[r["rid"]].tokens,
                                      err_msg=f"rid={r['rid']}")
    assert on_eng.summary()["prefix_hits"] > 0
    assert on_eng.pool.in_use == on_eng.prefix.resident


@pytest.mark.parametrize("kw", [kw for _, kw in SCHEDULES], ids=IDS)
def test_midpage_divergence_copies_the_page(int8_kv, kw):
    cfg, _, tmodel, tparams = int8_kv
    rng = np.random.default_rng(5)
    a = rng.integers(0, cfg.vocab, 16).astype(np.int32)
    b = np.concatenate([a[:10],
                        rng.integers(0, cfg.vocab, 6)]).astype(np.int32)
    assert (a[:10] == b[:10]).all() and a[10] != b[10]
    reqs = [{"rid": 0, "tokens": a, "max_new_tokens": 4},
            {"rid": 1, "tokens": b, "max_new_tokens": 4}]
    common = dict(n_slots=1, max_len=32, device="cpu", **kw)
    off = ServeEngine(tmodel, tparams, **common).run(reqs)
    on_eng = ServeEngine(tmodel, tparams, prefix_cache=True, **common)
    on = on_eng.run(reqs)
    for r in reqs:
        np.testing.assert_array_equal(on[r["rid"]].tokens,
                                      off[r["rid"]].tokens,
                                      err_msg=f"rid={r['rid']}")
    stats = on_eng.summary()
    assert stats["cow_copies"] >= 1
    assert stats["prefix_hit_tokens"] >= 10
    assert on_eng.exec.n_dispatch > 0


def test_copy_paged_pages_pads_and_copies(int8_kv):
    """``copy_pages`` pads the pairs with (0, 0) to the reference's
    power-of-two width and moves codes and scales of whole pages on every
    pool leaf, in one dispatch."""
    _, _, tmodel, tparams = int8_kv
    eng = ServeEngine(tmodel, tparams, n_slots=3, max_len=16, paged=True,
                      page_size=8, prefix_cache=True, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for k, v in eng.exec.cache.items():
        v.copy_(torch.randint(-100, 100, v.shape, generator=gen).to(v.dtype))
    before = {k: v.clone() for k, v in eng.exec.cache.items()}
    seen = {}
    real = tmodel.copy_paged_pages

    def spy(cache, src, dst):
        seen["src"], seen["dst"] = src.tolist(), dst.tolist()
        return real(cache, src, dst)
    eng.exec.model = dataclasses.replace(tmodel, copy_paged_pages=spy)
    eng.exec.copy_pages([(2, 5), (3, 6)])
    assert seen == {"src": [2, 3, 0, 0], "dst": [5, 6, 0, 0]}
    assert eng.exec.n_dispatch == 1
    for k, v in eng.exec.cache.items():
        want = before[k].clone()
        want[:, [5, 6]] = before[k][:, [2, 3]]
        assert torch.equal(v, want), k


def test_prefix_cache_requires_paged(int8_kv):
    cfg, params, tmodel, tparams = int8_kv
    kw = dict(n_slots=2, max_len=24, prefix_cache=True)
    with pytest.raises(ValueError, match="prefix_cache needs paged=True"):
        JEngine(j_build(cfg), params, **kw)
    with pytest.raises(ValueError, match="prefix_cache needs paged=True"):
        ServeEngine(tmodel, tparams, device="cpu", **kw)
