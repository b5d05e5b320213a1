"""The port's speculative decoding against the live JAX engine, on the CPU.

The target is a golden case (``regenerate.build_case``), the draft the
reference's ``build_draft_model("catlm_60m", smoke, 0)`` (CAT, int4-packed
weights, 8-bit activations, int8 KV pool); both are converted with
``from_reference`` and served on f32 copies of their configs, so the
port's drafts are the reference's and the acceptance counts can be held
exactly.

- For k in {1, 2, 4} and with ``adaptive_spec`` (k 4), on the golden
  workload: every request's tokens, ``spec_drafted`` and
  ``spec_accepted`` equal the live JAX speculative engine's (unified
  schedule, page 8, budget 12, the synchronous loop on both sides, and
  the pipelined loop on both sides for k 2); and the tokens equal the
  port's own target-only run.
- The port's ``build_draft_model`` builds the reference's draft: the same
  config (int8 KV, the target's widths) and QLinears with the reference's
  paths, shapes, bit widths and transform structure.
- A shared-prefix workload with the port's own draft (a different
  checkpoint, so drafts are rejected): speculative tokens equal the
  non-speculative engine's with the prefix cache off and on; after the
  drain only the trie holds target pages and the draft pool is empty.
- The KV-rewind invariant on the synchronous loop: after every step each
  decoding slot's pages, in both pools, cover exactly the positions a
  never-drafted run holds; rejections happen; the pools drain.
- The pipelined and synchronous loops serve identical tokens.
- Every speculative ``ValueError`` is raised by both engines for the same
  kwargs.
"""
import dataclasses

import numpy as np
import pytest
import torch

from golden import regenerate

from repro.data import request_workload
from repro.launch.engine import ServeEngine as JEngine
from repro.launch.serve import build_draft_model as j_build_draft_model
from repro.models import build as j_build
from repro_torch import configs as tconfigs
from repro_torch.convert import from_reference
from repro_torch.core import transforms as T
from repro_torch.core.qlinear import iter_qlinear
from repro_torch.launch.engine import ServeEngine
from repro_torch.launch.serve import build_draft_model
from repro_torch.models import build as t_build

torch.set_num_threads(1)

SPEC_KW = dict(n_slots=regenerate.N_SLOTS, max_len=regenerate.MAX_LEN,
               schedule="unified", page_size=8, max_batch_tokens=12)


def _port_cfg(cfg):
    return tconfigs.ArchConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def setup():
    """(JAX target (model, params), JAX draft, port target, port draft,
    the golden workload): the int8_kv case and the reference's draft, on
    f32 copies."""
    cfg, _, params = regenerate.build_case("int8_kv")
    cfg = cfg.scaled(dtype="float32")
    dmodel, dparams = j_build_draft_model("catlm_60m", True, 0)
    dcfg = dmodel.cfg.scaled(dtype="float32")
    reqs = request_workload(cfg, regenerate.N_REQUESTS, gen=regenerate.GEN,
                            lengths=regenerate.LENGTHS, seed=regenerate.SEED)
    return {"j": (j_build(cfg), params), "jd": (j_build(dcfg), dparams),
            "t": (t_build(_port_cfg(cfg)), from_reference(params)),
            "td": (t_build(_port_cfg(dcfg)), from_reference(dparams)),
            "cfg": cfg, "reqs": reqs}


def _tokens_equal(reqs, got, want, what):
    for r in reqs:
        np.testing.assert_array_equal(got[r["rid"]].tokens,
                                      want[r["rid"]].tokens,
                                      err_msg=f"{what} rid={r['rid']}")


@pytest.mark.parametrize("k,adaptive,pipeline", [
    (1, False, False), (2, False, False), (4, False, False),
    (4, True, False), (2, False, True)],
    ids=["k1", "k2", "k4", "k4-adaptive", "k2-pipelined"])
def test_speculative_matches_live_jax(setup, k, adaptive, pipeline):
    reqs = setup["reqs"]
    kw = dict(SPEC_KW, speculative_k=k, adaptive_spec=adaptive,
              pipeline=pipeline)
    jeng = JEngine(*setup["j"], draft=setup["jd"], **kw)
    jres = jeng.run(reqs)
    teng = ServeEngine(*setup["t"], draft=setup["td"], device="cpu", **kw)
    tres = teng.run(reqs)
    _tokens_equal(reqs, tres, jres, f"k={k}")
    ts, js = teng.summary(), jeng.summary()
    for key in ("spec_drafted_tokens", "spec_accepted_tokens", "spec_cycles",
                "generated_tokens", "decode_steps", "speculative_k",
                "adaptive_spec", "draft_pages_peak", "pages_peak"):
        assert ts[key] == js[key], key
    assert ts["spec_drafted_tokens"] > 0
    base = ServeEngine(*setup["t"], device="cpu",
                       **dict(SPEC_KW, pipeline=pipeline)).run(reqs)
    _tokens_equal(reqs, tres, base, f"k={k} vs target-only")


def test_port_draft_is_the_reference_draft():
    dmodel, dparams = j_build_draft_model("catlm_60m", True, 0)
    tmodel, tparams = build_draft_model("catlm_60m", True, 0, device="cpu")
    assert dataclasses.asdict(tmodel.cfg) == dataclasses.asdict(dmodel.cfg)
    assert tmodel.cfg.kv_quant_bits == 8
    ref = from_reference(dparams)
    mine, theirs = sorted(iter_qlinear(tparams)), sorted(iter_qlinear(ref))
    assert [p for p, _ in mine] == [p for p, _ in theirs]
    for (path, a), (_, b) in zip(mine, theirs):
        assert (a.w_bits, a.act_bits, a.d_in, a.packed) == \
            (b.w_bits, b.act_bits, b.d_in, b.packed) == (4, 8, a.d_in, True)
        assert a.qweight.shape == b.qweight.shape, path
        assert a.scale.shape == b.scale.shape, path
        assert isinstance(a.transform, T.Compose), path
        assert [type(p).__name__ for p in a.transform.parts] == \
            [type(p).__name__ for p in b.transform.parts], path
        for pa, pb in zip(a.transform.parts, b.transform.parts):
            for f in dataclasses.fields(pa):
                assert getattr(pa, f.name).shape == \
                    getattr(pb, f.name).shape, (path, f.name)


@pytest.mark.parametrize("prefix_cache", [False, True],
                         ids=["prefix_off", "prefix_on"])
def test_speculative_shared_prefix_identity(setup, prefix_cache):
    cfg = setup["cfg"]
    reqs = request_workload(cfg, 6, gen=5, lengths=(6, 10), seed=11,
                            shared_prefix=6)
    kw = dict(n_slots=2, max_len=24, schedule="unified",
              max_batch_tokens=12, page_size=8, prefix_cache=prefix_cache,
              device="cpu")
    base = ServeEngine(*setup["t"], **kw).run(reqs)
    draft = build_draft_model("catlm_60m", True, 0, device="cpu")
    spec_eng = ServeEngine(*setup["t"], speculative_k=3, draft=draft, **kw)
    spec = spec_eng.run(reqs)
    _tokens_equal(reqs, spec, base, f"prefix_cache={prefix_cache}")
    s = spec_eng.summary()
    assert s["spec_drafted_tokens"] > s["spec_accepted_tokens"]
    if prefix_cache:
        assert s["prefix_hits"] > 0
        assert spec_eng.pool.in_use == spec_eng.sched.prefix.resident
    else:
        assert spec_eng.pool.in_use == 0
    assert spec_eng.draft_pool.in_use == 0


def test_speculative_kv_rewind_invariant(setup):
    reqs = setup["reqs"]
    draft = build_draft_model("catlm_60m", True, 1, device="cpu")
    eng = ServeEngine(*setup["t"], speculative_k=2, draft=draft,
                      pipeline=False, device="cpu",
                      **SPEC_KW)
    for r in reqs:
        eng.submit(r["tokens"], r["max_new_tokens"], rid=r["rid"])
    sched = eng.sched
    while not eng.idle:
        eng.step()
        for slot, seq in sched.active.items():
            if not seq.decoding:
                continue
            want = sched.tables.pages_for(seq.prompt_len
                                          + len(seq.generated) - 1)
            assert sched.tables.n_owned(slot) == want, slot
            assert sched.draft_tables.n_owned(slot) == want, slot
    assert sched.spec_drafted > sched.spec_accepted
    for pool in (eng.pool, eng.draft_pool):
        assert pool.in_use == 0
        assert pool.allocs == pool.frees


def test_speculative_pipelined_equals_sync(setup):
    reqs = setup["reqs"]
    draft = build_draft_model("catlm_60m", True, 1, device="cpu")
    out = {}
    for pipeline in (False, True):
        eng = ServeEngine(*setup["t"], speculative_k=2, draft=draft,
                          pipeline=pipeline, device="cpu", **SPEC_KW)
        out[pipeline] = eng.run(reqs)
        assert eng.summary()["pipeline"] == pipeline
    _tokens_equal(reqs, out[True], out[False], "pipelined vs sync")


@pytest.mark.parametrize("kw,match", [
    (dict(speculative_k=2), "speculative_k needs schedule='unified'"),
    (dict(speculative_k=2, schedule="unified"), "speculative_k needs draft="),
    (dict(speculative_k=-1), "speculative_k must be >= 0"),
    (dict(adaptive_spec=True, schedule="unified"),
     "adaptive_spec needs speculative_k"),
    (dict(speculative_k=2, schedule="unified", max_batch_tokens=4,
          draft="draft"), "max_batch_tokens=4 must be >= n_slots"),
], ids=["legacy", "no-draft", "negative", "adaptive-alone", "budget"])
def test_speculative_value_errors_match_reference(setup, kw, match):
    kw = dict(kw)
    jdraft = tdraft = None
    if kw.pop("draft", None):
        jdraft, tdraft = setup["jd"], setup["td"]
    base = dict(n_slots=2, max_len=24, page_size=8)
    with pytest.raises(ValueError, match=match):
        JEngine(*setup["j"], draft=jdraft, **base, **kw)
    with pytest.raises(ValueError, match=match):
        ServeEngine(*setup["t"], draft=tdraft, device="cpu", **base, **kw)
