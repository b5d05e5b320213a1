"""The port's serving slice against the live JAX engine, on the CPU.

Both engines serve the golden workload (``regenerate.N_REQUESTS, GEN,
LENGTHS, N_SLOTS, MAX_LEN, SEED``) on the params of
``regenerate.build_case`` (fp, int8_kv, w4_packed), converted with
``repro_torch.convert.from_reference``, with the same engine kwargs,
stepped in lockstep. The reference is the live engine in the same test
(the checked-in golden tokens are a function of the pinned jax version).

- Scheduler plans and page tables are equal after every step.
- Tokens are exactly equal on an f32 copy of the config.
- In bf16 (fp, int8_kv and w4_packed on the default route 2; int8_kv
  also with ``paged_kernel=True``), token agreement over the request
  sequences is >= 0.9 — the bar the JAX suite uses for its rtol-level
  paths (``tests/test_unified_engine.py``). Route 2's bf16 activation
  fake quant follows the jitted reference (``core/quantizers.py``).
- w4_packed with ``paged_kernel=True``, and with route 1 forced through
  the fused kernels' plain versions, is held at exact token equality in
  f32, and at the 0.9 bar in bf16. This random-init model's 4-bit
  activation quant turns one-ulp differences into different tokens (the
  reference's own ragged-kernel and gather paths agree on 0.864 of them),
  so the bf16 path needs the port to round where the reference's
  compiled step rounds: the KV quant scale as a multiply by the f32
  reciprocal, and the post-attention norm on the unrounded residual sum.
- With ``REPRO_DECODE_FUSED=1`` on both sides, pure-decode steps take
  the two-launch decode (QKV prologue + paged attention) and the f32
  tokens stay exact.
- PTQ: the port's ``quantize_model`` on the same fp params and calibration
  batches gives weight codes equal to the reference's on >= 99 % of
  entries and scales at rtol 1e-4 on >= 99 % of channels (eigh differs
  between the libraries, so the bound is stated, not bitwise).
"""
import dataclasses

import numpy as np
import pytest
import torch

from golden import regenerate

from repro.core.pipeline import QuantizeConfig as JQuantizeConfig
from repro.data import calibration_batches as j_calibration_batches
from repro.data import request_workload
from repro.launch.engine import ServeEngine as JEngine
from repro.models import build as j_build
from repro.models import dense as j_dense
from repro_torch import configs as tconfigs
from repro_torch.convert import from_reference
from repro_torch.core import qlinear as tq
from repro_torch.core.pipeline import QuantizeConfig, quantize_model
from repro_torch.core.quantizers import unpack_int4
from repro_torch.data import calibration_batches
from repro_torch.launch.engine import ServeEngine
from repro_torch.launch import serve as tserve
from repro_torch.models import build as t_build

torch.set_num_threads(1)

BASE_KW = dict(n_slots=regenerate.N_SLOTS, max_len=regenerate.MAX_LEN,
               schedule="unified", pipeline=False)


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


def _lockstep(jeng, teng, reqs):
    """Step both engines together, holding plans and page tables equal."""
    for r in reqs:
        jeng.submit(r["tokens"], r["max_new_tokens"], rid=r["rid"])
        teng.submit(r["tokens"], r["max_new_tokens"], rid=r["rid"])
    while not (jeng.idle and teng.idle):
        jeng.step()
        teng.step()
        np.testing.assert_array_equal(teng.tables.table, jeng.tables.table)
        assert list(teng.sched.plan_log) == list(jeng.sched.plan_log)
        assert teng.pool.in_use == jeng.pool.in_use
    assert teng.step_count == jeng.step_count
    return jeng.results, teng.results


def _serve_both(cases, name, dtype=None, port_kw=None, **kw):
    cfg, _, params = cases(name)
    if dtype:
        cfg = cfg.scaled(dtype=dtype)
    jeng = JEngine(j_build(cfg), params, **BASE_KW, **kw)
    teng = ServeEngine(t_build(_port_cfg(cfg)), from_reference(params),
                       device="cpu", **BASE_KW, **kw, **(port_kw or {}))
    reqs = _workload(cfg)
    jres, tres = _lockstep(jeng, teng, reqs)
    return reqs, jres, tres, teng


def _agreement(reqs, jres, tres):
    return float(np.mean([
        (np.asarray(tres[r["rid"]].tokens)
         == np.asarray(jres[r["rid"]].tokens)).mean() for r in reqs]))


@pytest.mark.parametrize("name", sorted(regenerate.CASES))
@pytest.mark.parametrize("kw", [
    dict(max_batch_tokens=6, page_size=8),
    dict(max_batch_tokens=8, prefill_chunk=4, page_size=8),
], ids=["budget6", "budget8chunk4"])
def test_engine_f32_tokens_equal_live_jax(cases, name, kw):
    reqs, jres, tres, _ = _serve_both(cases, name, dtype="float32", **kw)
    for r in reqs:
        np.testing.assert_array_equal(tres[r["rid"]].tokens,
                                      jres[r["rid"]].tokens,
                                      err_msg=f"{name} rid={r['rid']}")


@pytest.mark.parametrize("name", ["fp", "int8_kv", "w4_packed"])
def test_engine_bf16_agrees_with_live_jax(cases, name):
    reqs, jres, tres, _ = _serve_both(cases, name, max_batch_tokens=6,
                                      page_size=8)
    assert _agreement(reqs, jres, tres) >= 0.9


def test_engine_paged_kernel_bf16_agrees_with_live_jax(cases):
    """paged_kernel=True on the int8 pool: ragged steps go through the
    ragged attention path and pure-decode plans through ``decode_step``
    and the decode attention path (plain versions on the CPU)."""
    reqs, jres, tres, teng = _serve_both(cases, "int8_kv",
                                         max_batch_tokens=8, page_size=8,
                                         paged_kernel=True)
    assert _agreement(reqs, jres, tres) >= 0.9
    assert teng.exec.supports_decode_step
    assert teng.summary()["dispatch_per_step"] <= 1.0


def test_engine_paged_kernel_bf16_w4_packed_agrees_with_live_jax(cases):
    """bf16 W4A4 with ``paged_kernel=True``: the ragged and decode
    attentions' plain versions (page-by-page online softmax) against the
    reference's Pallas kernels in interpret mode, on the golden workload."""
    reqs, jres, tres, teng = _serve_both(cases, "w4_packed",
                                         max_batch_tokens=8, page_size=8,
                                         paged_kernel=True)
    assert teng.exec.supports_decode_step
    assert _agreement(reqs, jres, tres) >= 0.9


def test_engine_paged_kernel_f32_tokens_equal_live_jax(cases):
    reqs, jres, tres, _ = _serve_both(cases, "w4_packed", dtype="float32",
                                      max_batch_tokens=8, page_size=8,
                                      paged_kernel=True)
    for r in reqs:
        np.testing.assert_array_equal(tres[r["rid"]].tokens,
                                      jres[r["rid"]].tokens)


def test_engine_fused_decode_f32_tokens_equal_live_jax(cases, monkeypatch):
    """The two-launch decode on both sides (``REPRO_DECODE_FUSED=1``,
    ``paged_kernel=True``): pure-decode steps run the QKV prologue — the
    reference's Pallas kernel in interpret mode, the port's plain version
    — and paged decode attention. Plans, page tables and tokens exact in
    f32 on the golden workload (4 requests)."""
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
    reqs, jres, tres, teng = _serve_both(
        cases, "w4_packed", dtype="float32", max_batch_tokens=8,
        page_size=8, paged_kernel=True)
    for r in reqs:
        np.testing.assert_array_equal(tres[r["rid"]].tokens,
                                      jres[r["rid"]].tokens)
    # both engines took the two-launch decode (the JAX count is per trace)
    assert counts["jax"] > 0 and counts["port"] > 0
    assert counts["port"] % teng.model.cfg.n_layers == 0


def test_engine_route1_forced_f32_tokens_equal_live_jax(cases, monkeypatch):
    """Route 1 forced on the CPU: every quantized linear goes through
    ``ops.fused_cat_matmul`` (the fused kernels' plain versions here),
    against the reference's integer-accumulation route 3 (the kernels'
    numerics; serving params built with keep_packed=True)."""
    from repro_torch.kernels import ops
    calls = {"n": 0}
    orig = ops.fused_cat_matmul

    def counted(*a, **kw):
        calls["n"] += 1
        return orig(*a, **kw)

    monkeypatch.setattr(tq, "_use_fused_kernel", lambda x: True)
    monkeypatch.setattr(ops, "fused_cat_matmul", counted)
    cfg, _, params = cases("w4_packed")
    cfg = cfg.scaled(dtype="float32")
    kw = dict(max_batch_tokens=8, page_size=8, paged_kernel=True)
    jeng = JEngine(j_build(cfg), j_dense.make_serving_params(
        cfg, params, keep_packed=True), fused=False, **BASE_KW, **kw)
    teng = ServeEngine(t_build(_port_cfg(cfg)), from_reference(params),
                       device="cpu", **BASE_KW, **kw)
    reqs = _workload(cfg)
    jres, tres = _lockstep(jeng, teng, reqs)
    assert calls["n"] > 0
    for r in reqs:
        np.testing.assert_array_equal(tres[r["rid"]].tokens,
                                      jres[r["rid"]].tokens)


def test_engine_route3_f32_tokens_equal_live_jax(cases):
    """Serving params built with keep_packed=True (colsum, no w_eff) take
    the integer-accumulation route 3 in both packages."""
    cfg, _, params = cases("w4_packed")
    cfg = cfg.scaled(dtype="float32")
    jparams = j_dense.make_serving_params(cfg, params, keep_packed=True)
    tmodel = t_build(_port_cfg(cfg))
    tparams = tmodel.make_serving_params(from_reference(params),
                                         keep_packed=True)
    assert tparams["layers"][0]["wqkv"].w_eff is None
    kw = dict(max_batch_tokens=6, page_size=8, fused=False)
    jeng = JEngine(j_build(cfg), jparams, **BASE_KW, **kw)
    teng = ServeEngine(tmodel, tparams, device="cpu", **BASE_KW, **kw)
    reqs = _workload(cfg)
    jres, tres = _lockstep(jeng, teng, reqs)
    for r in reqs:
        np.testing.assert_array_equal(tres[r["rid"]].tokens,
                                      jres[r["rid"]].tokens)


def test_ptq_matches_reference(cases):
    """The port's CAT W4A4 RTN PTQ on the golden fp params and the same
    calibration batches vs the reference's (build_case("w4_packed"))."""
    base, _, fp_params = cases("fp")
    _, _, jq_params = cases("w4_packed")
    jqcfg = JQuantizeConfig(w_bits=4, a_bits=4, transform="cat",
                            cat_block=16)
    tcfg = _port_cfg(base)
    qcfg = QuantizeConfig(**dataclasses.asdict(jqcfg))
    tq_params = quantize_model(t_build(tcfg), from_reference(fp_params), qcfg,
                               calibration_batches(tcfg, n_seqs=2,
                                                   seq_len=16, batch=2))
    ref = from_reference(jq_params)
    codes_eq, scales_ok = [], []
    for lp_t, lp_r in zip(tq_params["layers"], ref["layers"]):
        for name in ("wq", "wk", "wv", "wo", "wg", "wu", "wd"):
            a, b = lp_t[name], lp_r[name]
            assert a.packed and b.packed and a.d_in == b.d_in
            ca = unpack_int4(a.qweight, a.d_in).numpy()
            cb = unpack_int4(b.qweight, b.d_in).numpy()
            codes_eq.append((ca == cb).ravel())
            scales_ok.append(np.isclose(a.scale.numpy(), b.scale.numpy(),
                                        rtol=1e-4, atol=0).ravel())
    assert np.concatenate(codes_eq).mean() >= 0.99
    assert np.concatenate(scales_ok).mean() >= 0.99
    # the calibration batches are the reference's, by construction
    jb = next(iter(j_calibration_batches(base, n_seqs=2, seq_len=16,
                                         batch=2)))
    tb = next(iter(calibration_batches(tcfg, n_seqs=2, seq_len=16, batch=2)))
    np.testing.assert_array_equal(tb["tokens"], jb["tokens"])


def test_engine_scope_and_device_rules():
    """What the port still refuses (meshes), the reference's ValueErrors
    for the prefix cache on the slot cache and for speculative decoding
    without a draft or on the legacy schedule, the device rule, and both
    schedules built and drained: the legacy one, now the default as in the
    reference, on the slot cache; the unified one when asked for."""
    cfg = tconfigs.get_config("catlm_60m").smoke().scaled(kv_quant_bits=8)
    model = t_build(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    for schedule in ("legacy", "unified"):
        with pytest.raises(NotImplementedError, match="later slice"):
            ServeEngine(model, params, device="cpu", schedule=schedule,
                        mesh=object())
    for kw, match in (
            (dict(prefix_cache=True), r"prefix_cache needs paged=True"),
            (dict(speculative_k=2), r"speculative_k needs schedule="),
            (dict(speculative_k=2, schedule="unified"),
             r"speculative_k needs draft=")):
        with pytest.raises(ValueError, match=match):
            ServeEngine(model, params, device="cpu", **kw)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServeEngine(model, params)
    with pytest.raises(ValueError, match="max_batch_tokens"):
        ServeEngine(model, params, n_slots=4, max_batch_tokens=2,
                    schedule="unified", device="cpu")
    reqs = request_workload(cfg, 3, gen=2, lengths=(6,), seed=0)
    leg = ServeEngine(model, params, n_slots=2, max_len=32, device="cpu")
    leg.run(reqs)
    s = leg.summary()
    assert s["schedule"] == "legacy" and not s["paged"]
    assert s["device"] == "cpu" and "pipeline" not in s
    assert s["generated_tokens"] == 6 and s["n_requests"] == 3
    assert s["resident_kv_bytes_peak"] == s["kv_capacity_bytes"]
    leg.reset()
    assert leg.summary()["n_requests"] == 0 and leg._free == [0, 1]
    eng = ServeEngine(model, params, n_slots=2, max_len=32, device="cpu",
                      schedule="unified", max_batch_tokens=8, page_size=8)
    eng.run(reqs)
    s = eng.summary()
    assert s["schedule"] == "unified" and s["device"] == "cpu"
    assert s["generated_tokens"] == 6 and s["n_requests"] == 3
    assert s["packed_tokens_max"] <= 8 and s["pipeline"] is True
    assert eng.pool.in_use == 0
    eng.reset()
    assert eng.summary()["n_requests"] == 0


def test_serve_cli_and_static_oracle_on_cpu(capsys):
    """The CLI serves on the CPU when asked, and the engine's tokens equal
    the static-batch greedy oracle on the same f32 model."""
    tserve.main(["--device", "cpu", "--requests", "2", "--n-slots", "2",
                 "--gen", "3", "--prompt-len", "8", "--transform", "cat"])
    assert "tok/s" in capsys.readouterr().out
    cfg = tconfigs.get_config("catlm_60m").smoke().scaled(dtype="float32")
    model = t_build(cfg)
    params = model.init(torch.Generator().manual_seed(1))
    prompts = torch.tensor(np.stack([r["tokens"] for r in request_workload(
        cfg, 2, gen=4, lengths=(8,), seed=2)]))
    want = tserve.greedy_generate(model, params, prompts, gen=4, max_len=16)
    eng = ServeEngine(model, params, n_slots=2, max_len=16, device="cpu",
                      schedule="unified", max_batch_tokens=8)
    res = eng.run([{"rid": i, "tokens": prompts[i].numpy(),
                    "max_new_tokens": 4} for i in range(2)])
    for i in range(2):
        np.testing.assert_array_equal(res[i].tokens, want[i].numpy())
