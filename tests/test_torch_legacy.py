"""The port's legacy schedule (prefill-on-admit, slot caches, bucketed
prefill) against the live JAX engine, on the CPU.

Both engines serve the golden workload (``regenerate.N_REQUESTS, GEN,
LENGTHS, N_SLOTS, MAX_LEN, SEED``) on the params of
``regenerate.build_case`` (fp, int8_kv, w4_packed), converted with
``repro_torch.convert.from_reference``, with the same engine kwargs and
the reference's default schedule, stepped in lockstep. The reference is
the live engine in the same test, never the JSON fixtures (a function of
the pinned jax version), though the fixtures are made by this very
engine (``regenerate.run_case``).

- On an f32 copy of the config, events and every request's tokens are
  equal: the slot cache with ``bucket`` True and False, the paged pool
  (page 8), chunked paged prefill (chunk 8), the paged decode kernels
  (``paged_kernel=True``) and, with ``REPRO_DECODE_FUSED=1`` on both
  sides, the two-launch decode (QKV prologue + paged attention; w4_packed,
  whose wqkv the prologue takes).
- After every step the page tables are equal (paged), and the slot
  caches hold the same values (slot): int8 scales at rtol 1e-6, codes
  bitwise up to a one-step move on <= 1e-3 of them, fp rows at rtol 1e-5
  of the scale (the k/v rows are f32 products that XLA and torch sum in
  different orders; see ``_same_cache``).
- In bf16 (the golden configs as they are), token agreement is >= 0.9,
  the JAX suite's bar for its rtol-level paths.
- The port's legacy tokens equal its unified tokens in f32, as
  ``test_unified_matches_golden_bitwise`` holds for the reference.
- Each legacy ``ValueError`` is raised by both engines for the same
  kwargs, and both bucket prompts to the same widths.
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

BASE_KW = dict(n_slots=regenerate.N_SLOTS, max_len=regenerate.MAX_LEN)


@pytest.fixture(scope="module")
def cases():
    """Lazily built golden cases, shared by this module's tests."""
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


def _port_cfg(cfg):
    return tconfigs.ArchConfig(**dataclasses.asdict(cfg))


def _same_cache(jeng, teng):
    """The slot caches hold the same values. The k/v rows are outputs of
    f32 products, which XLA and torch sum in different orders, so an
    ulp apart at most: an fp cache's rows agree at rtol 1e-5 of the
    cache's scale (the JAX suite's f32 bound for a linear); the int8
    scales at rtol 1e-6; the int8 codes bitwise but where such an ulp
    moves a value across a rounding boundary, by one code step, on at
    most 1e-3 of the entries (the bound of the quant tests)."""
    jc = {k: np.asarray(v) for k, v in jeng._cache.items()}
    assert set(jc) == set(teng._cache)
    quantized = "k_scale" in jc
    for k, want in jc.items():
        got = teng._cache[k].float().numpy()
        if want.dtype == np.int8:
            shift = np.abs(got - want)
            assert shift.max() <= 1 and (shift > 0).mean() <= 1e-3, k
        elif quantized:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=0,
                                       err_msg=k)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5,
                                       atol=1e-5 * np.abs(want).max(),
                                       err_msg=k)


def _lockstep(jeng, teng, reqs, check_cache):
    """Step both engines together, holding events equal and, after every
    step, the page tables (paged) or the slot caches (``check_cache``)."""
    for r in reqs:
        jeng.submit(r["tokens"], r["max_new_tokens"], rid=r["rid"])
        teng.submit(r["tokens"], r["max_new_tokens"], rid=r["rid"])
    while not (jeng.idle and teng.idle):
        jeng.step()
        teng.step()
        assert teng.events == [tuple(int(v) if i else v
                                     for i, v in enumerate(e))
                               for e in jeng.events]
        if teng.paged:
            np.testing.assert_array_equal(teng.tables.table,
                                          jeng.tables.table)
            assert teng.pool.in_use == jeng.pool.in_use
        elif check_cache:
            _same_cache(jeng, teng)
    assert teng.step_count == jeng.step_count
    return jeng.results, teng.results


def _serve_both(cases, name, dtype=None, **kw):
    cfg, _, params = cases(name)
    if dtype:
        cfg = cfg.scaled(dtype=dtype)
    jeng = JEngine(j_build(cfg), params, **BASE_KW, **kw)
    teng = ServeEngine(t_build(_port_cfg(cfg)), from_reference(params),
                       device="cpu", **BASE_KW, **kw)
    assert teng.schedule == jeng.schedule == "legacy"
    assert teng.paged == jeng.paged
    reqs = _workload(cfg)
    jres, tres = _lockstep(jeng, teng, reqs, check_cache=dtype == "float32")
    return reqs, jres, tres, teng


def _assert_tokens_equal(reqs, jres, tres, what):
    for r in reqs:
        np.testing.assert_array_equal(tres[r["rid"]].tokens,
                                      jres[r["rid"]].tokens,
                                      err_msg=f"{what} rid={r['rid']}")


def _agreement(reqs, jres, tres):
    return float(np.mean([
        (np.asarray(tres[r["rid"]].tokens)
         == np.asarray(jres[r["rid"]].tokens)).mean() for r in reqs]))


@pytest.mark.parametrize("name,kw", [
    ("fp", {}), ("int8_kv", {}), ("w4_packed", {}),
    ("int8_kv", dict(bucket=False)),
    ("w4_packed", dict(paged=True, page_size=8)),
    ("int8_kv", dict(paged=True, page_size=8, prefill_chunk=8)),
    ("int8_kv", dict(paged=True, page_size=8, paged_kernel=True)),
], ids=["slot-fp", "slot-int8_kv", "slot-w4_packed", "slot-nobucket",
        "paged8", "paged8chunk8", "paged_kernel"])
def test_legacy_f32_matches_live_jax(cases, name, kw):
    reqs, jres, tres, teng = _serve_both(cases, name, dtype="float32", **kw)
    _assert_tokens_equal(reqs, jres, tres, name)
    s = teng.summary()
    assert s["schedule"] == "legacy" and s["paged"] == bool(kw.get("paged"))
    assert s["generated_tokens"] == regenerate.N_REQUESTS * regenerate.GEN
    assert "d2h_ms_mean" in s and "max_batch_tokens" not in s


def test_legacy_fused_decode_f32_matches_live_jax(cases, monkeypatch):
    """The two-launch decode on both sides (``REPRO_DECODE_FUSED=1``,
    paged pool, ``paged_kernel=True``): every legacy decode step runs the
    QKV prologue — the reference's Pallas kernel in interpret mode, the
    port's plain version — and the paged decode attention. Events, page
    tables and tokens exact in f32."""
    from repro.kernels import ops as jops
    from repro_torch.kernels import ops
    monkeypatch.setenv("REPRO_DECODE_FUSED", "1")
    counts = {}
    for mod, key in ((jops, "jax"), (ops, "port")):
        real = mod.decode_qkv_prologue
        counts[key] = 0

        def counted(*a, _real=real, _key=key, **kw):
            counts[_key] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(mod, "decode_qkv_prologue", counted)
    reqs, jres, tres, teng = _serve_both(cases, "w4_packed", dtype="float32",
                                         paged=True, page_size=8,
                                         paged_kernel=True)
    _assert_tokens_equal(reqs, jres, tres, "fused decode")
    assert counts["jax"] > 0
    n_layers = teng.model.cfg.n_layers
    assert counts["port"] == n_layers * teng.summary()["decode_steps"]


@pytest.mark.parametrize("name,kw", [
    ("w4_packed", {}),
    ("int8_kv", dict(paged=True, page_size=8, paged_kernel=True)),
], ids=["slot-w4_packed", "paged_kernel-int8_kv"])
def test_legacy_bf16_agrees_with_live_jax(cases, name, kw):
    reqs, jres, tres, _ = _serve_both(cases, name, **kw)
    assert _agreement(reqs, jres, tres) >= 0.9


@pytest.mark.parametrize("name", ["int8_kv", "w4_packed"])
def test_port_legacy_equals_port_unified_f32(cases, name):
    """The two schedules of the port serve the same tokens (f32), as the
    reference's unified step equals its legacy engine."""
    cfg, _, params = cases(name)
    tcfg = _port_cfg(cfg.scaled(dtype="float32"))
    model, tparams = t_build(tcfg), from_reference(params)
    reqs = _workload(cfg)
    out = {}
    for kw in (dict(), dict(schedule="unified", max_batch_tokens=8,
                            page_size=8, pipeline=False)):
        eng = ServeEngine(model, tparams, device="cpu", **BASE_KW, **kw)
        res = eng.run(reqs)
        out[eng.schedule] = res
    _assert_tokens_equal(reqs, out["unified"], out["legacy"], name)


@pytest.mark.parametrize("kw,match", [
    (dict(pipeline=True), "pipeline=True needs schedule='unified'"),
    (dict(max_batch_tokens=8), "max_batch_tokens needs"),
    (dict(paged=True, page_size=8, prefill_chunk=4), "must be a multiple"),
    (dict(prefill_chunk=8), "prefill_chunk needs paged=True"),
    (dict(paged_kernel=True), "paged_kernel needs paged=True"),
    (dict(schedule="ragged"), "schedule must be"),
])
def test_legacy_value_errors_match_reference(cases, kw, match):
    cfg, _, params = cases("fp")
    with pytest.raises(ValueError, match=match):
        JEngine(j_build(cfg), params, **BASE_KW, **kw)
    with pytest.raises(ValueError, match=match):
        ServeEngine(t_build(_port_cfg(cfg)), from_reference(params),
                    device="cpu", **BASE_KW, **kw)


@pytest.mark.parametrize("kw", [dict(), dict(bucket=False),
                                dict(paged=True, page_size=8),
                                dict(max_len=20)])
def test_bucketed_widths_match_reference(cases, kw):
    cfg, _, params = cases("fp")
    kw = {**BASE_KW, **kw}
    jeng = JEngine(j_build(cfg), params, **kw)
    teng = ServeEngine(t_build(_port_cfg(cfg)), from_reference(params),
                       device="cpu", **kw)
    for p in range(1, kw["max_len"] + 1):
        prompt = np.arange(1, p + 1, dtype=np.int32)
        jt, jl = jeng._bucketed(prompt)
        tt, tl = teng._bucketed(prompt)
        np.testing.assert_array_equal(tt, jt)
        assert tl == jl


def test_prefill_logits_at_forms_match_reference(cases):
    """``prefill(logits_at=)`` in the reference's forms, on a fresh slot
    cache (f32): an int and a 0-dim tensor read one row (clamped into the
    rows, as ``dynamic_slice_in_dim``), a (R,) tensor gathers R rows; the
    logits agree at rtol 1e-5 of their scale and the slot cache holds the
    same k/v."""
    import jax.numpy as jnp
    cfg, _, params = cases("fp")
    cfg = cfg.scaled(dtype="float32")
    jmodel, tmodel = j_build(cfg), t_build(_port_cfg(cfg))
    tparams = from_reference(params)
    toks = np.asarray(_workload(cfg)[0]["tokens"][:8], np.int32)[None]
    for jat, tat in ((jnp.int32(5), 5), (jnp.int32(5), torch.tensor(5)),
                     (jnp.int32(20), 20), (jnp.asarray([2, 7]),
                                           torch.tensor([2, 7]))):
        jlog, jcache = jmodel.prefill(params, jnp.asarray(toks),
                                      jmodel.init_cache(1, 16),
                                      logits_at=jat)
        tlog, tcache = tmodel.prefill(tparams, torch.from_numpy(toks),
                                      tmodel.init_cache(1, 16),
                                      logits_at=tat)
        want = np.asarray(jlog)
        assert tlog.shape == want.shape
        np.testing.assert_allclose(tlog.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
        assert tcache["pos"] == int(jcache["pos"]) == 8
        for k in ("k", "v"):
            w = np.asarray(jcache[k])
            np.testing.assert_allclose(tcache[k].numpy(), w, rtol=1e-5,
                                       atol=1e-5 * np.abs(w).max())
