"""The rest of the paper's PTQ in the port — GPTQ, SmoothQuant, random
rotation, full CAT — and its SQNR analysis, against the reference on the
CPU. Inputs are seeded with numpy; models are the golden ``fp`` case
(``regenerate.build_case``) on an f32 copy, its params converted with
``from_reference``, and the calibration batches the reference's (equal by
construction).

Tolerances:
- ``make_rotation`` bitwise equal to the reference's from the same rng;
  ``make_smoothquant`` at rtol 1e-6; ``make_cat_full`` (eigh in both) at
  rtol 1e-4, as are ``geometric_mean`` and ``cat_block``, on covariances
  of condition number ~10² (at ~10⁵ f32 eigh leaves both libraries ~3e-3
  from the f64 result, so there the port is held to no more than twice
  the reference's distance from it); the calibration
  stats (absmax, E[x²], sample rows) at rtol 1e-5;
  ``as_dense_matrix`` at rtol 1e-6 and ``online_flops`` exactly.
- ``_damped_hinv_chol`` at rtol 1e-4 of its largest entry. Given the
  reference's upper factor, ``gptq_quantize``'s codes equal the
  reference's exactly (d_in 64, d_out 32) and its scales at rtol 1e-6;
  with its own factor, its ‖(W − Ŵ)X‖² is within 1 % of the reference's
  and no worse than RTN's.
- ``quantize_model`` with smoothquant and rotation (RTN): weight codes
  equal the reference's but for at most 1e-3 of them, one code step
  apart, and scales at rtol 1e-5; the converted params served in f32
  (int8 KV pool, unified schedule) give the live JAX engine's tokens.
  With GPTQ (cat, rotation): codes equal on >= 99 % of entries (a code
  that moves feeds its error to every later column).
- ``eval_quantized``'s CE and perplexity at rtol 1e-5.
- Every public function of ``core/sqnr.py`` at rtol 1e-5 on seeded f32 W
  and X (heavy-tailed correlated activations), ``alignment_optimal`` (an
  eigen-solve) at rtol 1e-4.
- The CLI on the CPU with ``--transform smoothquant``, with ``--schedule
  unified --prefix-cache --shared-prefix 8`` and with ``--schedule
  unified --speculative 2``; its flag errors for the new options equal
  the reference's.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden import regenerate

from repro.core import calibration as jcal
from repro.core import cat as jcat
from repro.core import gptq as jgptq
from repro.core import pipeline as jpipe
from repro.core import quantizers as jquant
from repro.core import sqnr as jsqnr
from repro.core import transforms as jT
from repro.data import calibration_batches as j_calibration_batches
from repro.data import make_batch as j_make_batch
from repro.data import request_workload
from repro.launch.engine import ServeEngine as JEngine
from repro.models import build as j_build
from repro_torch import configs as tconfigs
from repro_torch.convert import from_reference
from repro_torch.core import calibration as tcal
from repro_torch.core import cat as tcat
from repro_torch.core import gptq as tgptq
from repro_torch.core import pipeline as tpipe
from repro_torch.core import quantizers as tquant
from repro_torch.core import sqnr as tsqnr
from repro_torch.core import transforms as tT
from repro_torch.core.qlinear import iter_qlinear, unpacked_qweight
from repro_torch.data import calibration_batches, make_batch
from repro_torch.launch import serve as tserve
from repro_torch.launch.engine import ServeEngine
from repro_torch.models import build as t_build

torch.set_num_threads(1)


def _np(a):
    return np.asarray(a.detach().cpu().numpy() if torch.is_tensor(a) else a)


def _close(got, want, rtol):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(_np(got).astype(np.float64), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def _spd(rng, d, n=1024, mix=None):
    """E[xxᵀ] of n correlated samples. By default the channels are mixed
    by I + 0.3·G/√d and scaled over [0.5, 2] (condition number ~10²);
    ``mix=1`` mixes by G/√d alone (~10⁴–10⁵)."""
    g = rng.standard_normal((d, d)) / np.sqrt(d)
    m = g if mix == 1 else np.eye(d) + 0.3 * g
    x = rng.standard_normal((n, d)) @ m * np.linspace(0.5, 2.0, d)
    return (x.T @ x / n).astype(np.float32)


# --------------------------------------------------------------- transforms

def test_make_rotation_bitwise():
    for d in (16, 128):
        j = jT.make_rotation(d, np.random.default_rng(3))
        t = tT.make_rotation(d, np.random.default_rng(3))
        np.testing.assert_array_equal(t.t.numpy(), np.asarray(j.t))
        np.testing.assert_array_equal(t.t_inv.numpy(), np.asarray(j.t_inv))


def test_make_smoothquant_and_cat_full():
    rng = np.random.default_rng(0)
    d = 48
    amax = (np.abs(rng.standard_normal(d)) * 10).astype(np.float32)
    wmax = np.abs(rng.standard_normal(d)).astype(np.float32)
    amax[3] = 0.0
    for alpha in (0.5, 0.8):
        j = jT.make_smoothquant(jnp.asarray(amax), jnp.asarray(wmax), alpha)
        t = tT.make_smoothquant(torch.tensor(amax), torch.tensor(wmax), alpha)
        _close(t.s, j.s, 1e-6)
    sw, sx = _spd(rng, d), _spd(rng, d)
    j = jT.make_cat_full(jnp.asarray(sw), jnp.asarray(sx))
    t = tT.make_cat_full(torch.tensor(sw), torch.tensor(sx))
    _close(t.t, j.t, 1e-4)
    _close(t.t_inv, j.t_inv, 1e-4)
    sw, sx = _spd(rng, d, mix=1), _spd(rng, d, mix=1)
    exact = tcat.cat_optimal(torch.tensor(sw, dtype=torch.float64),
                             torch.tensor(sx, dtype=torch.float64)).numpy()
    j = np.asarray(jT.make_cat_full(jnp.asarray(sw), jnp.asarray(sx)).t)
    t = tT.make_cat_full(torch.tensor(sw), torch.tensor(sx)).t.numpy()
    assert np.abs(t - exact).max() <= 2 * np.abs(j - exact).max()


def test_cat_members_match_reference():
    rng = np.random.default_rng(1)
    d = 24
    a, b = _spd(rng, d), _spd(rng, d)
    _close(tcat.geometric_mean(torch.tensor(a), torch.tensor(b)),
           jcat.geometric_mean(jnp.asarray(a), jnp.asarray(b)), 1e-4)
    for k in (1, 5, 8, 24, 32):
        assert tcat.block_slices(d, k) == jcat.block_slices(d, k)
        _close(tcat.cat_block(torch.tensor(a), torch.tensor(b), k),
               jcat.cat_block(jnp.asarray(a), jnp.asarray(b), k), 1e-4)


@pytest.mark.parametrize("kind", ["identity", "scale", "dense", "hadamard",
                                  "blockdiag", "compose"])
def test_as_dense_matrix_and_online_flops(kind):
    rng = np.random.default_rng(2)
    d = 32
    sw, sx = _spd(rng, d), _spd(rng, d)
    jt = {"identity": lambda: jT.Identity(),
          "scale": lambda: jT.Scale(jnp.asarray(rng.standard_normal(d),
                                                jnp.float32)),
          "dense": lambda: jT.make_rotation(d, np.random.default_rng(0)),
          "hadamard": lambda: jT.make_hadamard(d, np.random.default_rng(0)),
          "blockdiag": lambda: jT.make_cat_block(
              jnp.asarray(sw), jnp.asarray(sx), 8, hadamard=False),
          "compose": lambda: jT.make_cat_block(
              jnp.asarray(sw), jnp.asarray(sx), 8,
              rng=np.random.default_rng(0))}[kind]()
    tt = from_reference({"t": jt})["t"]
    _close(tT.as_dense_matrix(tt, d), jT.as_dense_matrix(jt, d), 1e-6)
    assert tT.online_flops(tt, d) == jT.online_flops(jt, d)


def test_calibration_stats_match_reference():
    rng = np.random.default_rng(4)
    jt, tt = jcal.Taps(max_sample_rows=50), tcal.Taps(max_sample_rows=50)
    for n in (30, 40):
        x = rng.standard_normal((n, 16)).astype(np.float32) * 3
        jt.record("a", jnp.asarray(x))
        tt.record("a", torch.tensor(x))
    j, t = jt["a"], tt["a"]
    _close(t.absmax, j.absmax, 1e-5)
    _close(t.mean_sq, j.mean_sq, 1e-5)
    _close(t.sigma, j.sigma, 1e-5)
    _close(t.sample_matrix(), j.sample_matrix(), 1e-5)
    assert t.sample_matrix().shape == (50, 16)


# --------------------------------------------------------------------- GPTQ

def _gptq_layer(seed=0, d_in=64, d_out=32, n=512):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((d_out, d_in)).astype(np.float32)
    x = (rng.standard_normal((n, d_in))
         * np.linspace(0.2, 3.0, d_in)).astype(np.float32)
    return w, x, (x.T @ x / n).astype(np.float32)


def test_damped_hinv_chol_matches_reference():
    _, _, sig = _gptq_layer()
    for damp in (0.01, 0.1):
        _close(tgptq._damped_hinv_chol(torch.tensor(sig), damp),
               jgptq._damped_hinv_chol(jnp.asarray(sig), damp), 1e-4)


def test_gptq_codes_exact_given_reference_factor(monkeypatch):
    w, _, sig = _gptq_layer()
    u = np.asarray(jgptq._damped_hinv_chol(jnp.asarray(sig)))
    monkeypatch.setattr(tgptq, "_damped_hinv_chol",
                        lambda s, damp=0.01: torch.tensor(u))
    for bits in (4, 8):
        jq, js = jgptq.gptq_quantize(jnp.asarray(w), jnp.asarray(sig),
                                     jquant.weight_spec(bits))
        tq, ts = tgptq.gptq_quantize(torch.tensor(w), torch.tensor(sig),
                                     tquant.weight_spec(bits))
        assert tq.dtype == torch.int8
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        _close(ts, js, 1e-6)
        _close(tgptq.gptq_dequant(tq, ts),
               jgptq.gptq_dequant(jq, js), 1e-6)


def test_gptq_layer_error_end_to_end():
    w, x, sig = _gptq_layer(seed=1)

    def err(wq):
        return float(np.sum(((w - _np(wq)) @ x.T).astype(np.float64) ** 2))
    spec = tquant.weight_spec(4)
    tq, ts = tgptq.gptq_quantize(torch.tensor(w), torch.tensor(sig), spec)
    jq, js = jgptq.gptq_quantize(jnp.asarray(w), jnp.asarray(sig),
                                 jquant.weight_spec(4))
    rq, rs = tgptq.rtn_quantize(torch.tensor(w), spec)
    e_port = err(tgptq.gptq_dequant(tq, ts))
    e_ref = err(jgptq.gptq_dequant(jq, js))
    e_rtn = err(tgptq.gptq_dequant(rq, rs))
    assert abs(e_port - e_ref) <= 0.01 * e_ref
    assert e_port <= e_rtn


# ----------------------------------------------------------------- pipeline

@pytest.fixture(scope="module")
def fp32():
    """The fp golden case on an f32 copy: (JAX cfg, params, port cfg,
    port params)."""
    cfg, _, params = regenerate.build_case("fp")
    cfg = cfg.scaled(dtype="float32")
    tcfg = tconfigs.ArchConfig(**dataclasses.asdict(cfg))
    return cfg, params, tcfg, from_reference(params)


def _quantize_both(fp32, **qkw):
    cfg, params, tcfg, tparams = fp32
    jq = jpipe.quantize_model(
        j_build(cfg), params, jpipe.QuantizeConfig(cat_block=16, **qkw),
        j_calibration_batches(cfg, n_seqs=2, seq_len=16, batch=2))
    tq = tpipe.quantize_model(
        t_build(tcfg), tparams, tpipe.QuantizeConfig(cat_block=16, **qkw),
        calibration_batches(tcfg, n_seqs=2, seq_len=16, batch=2))
    return jq, tq


def _code_shift(tq, jq_converted):
    """-> (share of codes that differ, largest difference in code steps,
    largest relative scale difference)."""
    mine, theirs = dict(iter_qlinear(tq)), dict(iter_qlinear(jq_converted))
    assert sorted(mine) == sorted(theirs)
    diff, steps, srel = [], 0, 0.0
    for k, a in mine.items():
        b = theirs[k]
        assert (a.w_bits, a.act_bits, a.d_in) == (b.w_bits, b.act_bits,
                                                  b.d_in)
        assert type(a.transform).__name__ == type(b.transform).__name__
        ca = unpacked_qweight(a).numpy().astype(np.int32)
        cb = unpacked_qweight(b).numpy().astype(np.int32)
        diff.append((ca != cb).ravel())
        steps = max(steps, int(np.abs(ca - cb).max()))
        sb = b.scale.numpy()
        srel = max(srel, float(np.abs(a.scale.numpy() - sb).max()
                               / np.abs(sb).max()))
    return float(np.concatenate(diff).mean()), steps, srel


@pytest.mark.parametrize("transform", ["smoothquant", "rotation"])
def test_quantize_model_matches_reference_and_serves(fp32, transform):
    jq, tq = _quantize_both(fp32, transform=transform)
    ref = from_reference(jq)
    share, steps, srel = _code_shift(tq, ref)
    assert share <= 1e-3 and steps <= 1 and srel <= 1e-5
    for _, layer in iter_qlinear(tq):
        kind = tT.Scale if transform == "smoothquant" else tT.Dense
        assert isinstance(layer.transform, kind)
    cfg = fp32[0].scaled(kv_quant_bits=8)
    kw = dict(n_slots=regenerate.N_SLOTS, max_len=regenerate.MAX_LEN,
              schedule="unified", page_size=8, max_batch_tokens=8,
              pipeline=False)
    reqs = request_workload(cfg, regenerate.N_REQUESTS, gen=regenerate.GEN,
                            lengths=regenerate.LENGTHS, seed=regenerate.SEED)
    jres = JEngine(j_build(cfg), jq, **kw).run(reqs)
    tcfg = tconfigs.ArchConfig(**dataclasses.asdict(cfg))
    tres = ServeEngine(t_build(tcfg), ref, device="cpu", **kw).run(reqs)
    for r in reqs:
        np.testing.assert_array_equal(tres[r["rid"]].tokens,
                                      jres[r["rid"]].tokens,
                                      err_msg=f"{transform} rid={r['rid']}")


@pytest.mark.parametrize("transform", ["cat", "rotation"])
def test_quantize_model_gptq_matches_reference(fp32, transform):
    jq, tq = _quantize_both(fp32, transform=transform, w_method="gptq")
    share, _, srel = _code_shift(tq, from_reference(jq))
    assert share <= 0.01 and srel <= 1e-4
    rtn = tpipe.quantize_model(
        t_build(fp32[2]), fp32[3],
        tpipe.QuantizeConfig(cat_block=16, transform=transform),
        calibration_batches(fp32[2], n_seqs=2, seq_len=16, batch=2))
    gptq_codes = [unpacked_qweight(l) for _, l in sorted(iter_qlinear(tq))]
    rtn_codes = [unpacked_qweight(l) for _, l in sorted(iter_qlinear(rtn))]
    assert any(not torch.equal(a, b) for a, b in zip(gptq_codes, rtn_codes))


def test_eval_quantized_matches_reference(fp32):
    cfg, params, tcfg, tparams = fp32
    jq, _ = _quantize_both(fp32, transform="cat")
    jbatches = [j_make_batch(cfg, 24, 2, seed=s) for s in (0, 1)]
    tbatches = [make_batch(tcfg, 24, 2, seed=s) for s in (0, 1)]
    for jb, tb in zip(jbatches, tbatches):
        np.testing.assert_array_equal(tb["tokens"], np.asarray(jb["tokens"]))
    want = jpipe.eval_quantized(j_build(cfg), params, jq, jbatches)
    got = tpipe.eval_quantized(t_build(tcfg), tparams, from_reference(jq),
                               tbatches)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if k == "delta":
            assert abs(got[k] - v) <= 1e-5 * abs(want["ce_quant"]), k
        else:
            np.testing.assert_allclose(got[k], v, rtol=1e-5, err_msg=k)


# --------------------------------------------------------------------- SQNR

def _sqnr_layer(seed, n=512, d_in=128, d_out=96):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d_in)) @ (rng.standard_normal((d_in, d_in))
                                          / np.sqrt(d_in))
    x[:, rng.choice(d_in, size=3, replace=False)] *= 20.0
    w = rng.standard_normal((d_out, d_in)) / np.sqrt(d_in)
    return w.astype(np.float32), x.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_sqnr_functions_match_reference(seed):
    w, x = _sqnr_layer(seed)
    jw, jx, tw, tx = jnp.asarray(w), jnp.asarray(x), torch.tensor(w), \
        torch.tensor(x)
    sig = (x.T @ x / x.shape[0]).astype(np.float32)
    wq = np.asarray(jquant.fake_quant(jw, jquant.weight_spec(4)))
    xq = np.asarray(jquant.fake_quant(jx, jquant.act_spec(4)))
    for bw, bx in ((4, 4), (4, 8), (8, 8)):
        jws, jxs = jquant.weight_spec(bw), jquant.act_spec(bx)
        tws, txs = tquant.weight_spec(bw), tquant.act_spec(bx)
        pairs = [
            (tsqnr.sqnr_quantized_layer(tw, tx, tws, txs),
             jsqnr.sqnr_quantized_layer(jw, jx, jws, jxs)),
            (tsqnr.sqnr_act_only(tw, tx, txs),
             jsqnr.sqnr_act_only(jw, jx, jxs)),
            (tsqnr.sqnr_weight_only(tw, tx, tws),
             jsqnr.sqnr_weight_only(jw, jx, jws)),
            (tsqnr.concentration_act(tx, txs),
             jsqnr.concentration_act(jx, jxs)),
            (tsqnr.concentration_weight(tw, tws),
             jsqnr.concentration_weight(jw, jws)),
            (tsqnr.sqnr_approx_act(tw, tx, txs),
             jsqnr.sqnr_approx_act(jw, jx, jxs)),
            (tsqnr.sqnr_approx_weight(tw, tx, tws),
             jsqnr.sqnr_approx_weight(jw, jx, jws)),
            (tsqnr.sqnr_approx_joint(tw, tx, tws, txs),
             jsqnr.sqnr_approx_joint(jw, jx, jws, jxs)),
            (tsqnr.sqnr_ratio(tw, tx, tws, txs),
             jsqnr.sqnr_ratio(jw, jx, jws, jxs)),
        ]
        for i, (got, want) in enumerate(pairs):
            _close(got, want, 1e-5)
            assert got.dtype == torch.float32, i
        assert tsqnr.n_levels(bw) == jsqnr.n_levels(bw)
        report = tsqnr.layer_report(tw, tx, bw, bx)
        want = jsqnr.layer_report(jw, jx, bw, bx)
        assert sorted(report) == sorted(want)
        for k, v in want.items():
            _close(report[k], v, 1e-4 if k == "alignment_optimal_db"
                   else 1e-5)
    _close(tsqnr.sqnr_measured(tw, tx, torch.tensor(wq), torch.tensor(xq)),
           jsqnr.sqnr_measured(jw, jx, jnp.asarray(wq), jnp.asarray(xq)),
           1e-5)
    _close(tsqnr.alignment(tw, tx), jsqnr.alignment(jw, jx), 1e-5)
    _close(tsqnr.alignment_from_cov(tw, torch.tensor(sig)),
           jsqnr.alignment_from_cov(jw, jnp.asarray(sig)), 1e-5)
    _close(tsqnr.alignment_optimal(tw, torch.tensor(sig)),
           jsqnr.alignment_optimal(jw, jnp.asarray(sig)), 1e-4)
    _close(tsqnr.db(torch.tensor([3.0, 0.0])),
           jsqnr.db(jnp.asarray([3.0, 0.0])), 1e-6)
    _close(tsqnr.parallel(torch.tensor(2.0), torch.tensor(6.0)),
           jsqnr.parallel(2.0, 6.0), 1e-6)
    for spec in (tquant.act_spec(4), tquant.weight_spec(4)):
        jspec = jquant.QuantSpec(**dataclasses.asdict(spec))
        _close(tquant.quant_range(tx, spec), jquant.quant_range(jx, jspec),
               1e-6)


# ---------------------------------------------------------------------- CLI

@pytest.mark.parametrize("argv,note", [
    (["--transform", "smoothquant"], "[smoothquant]"),
    (["--schedule", "unified", "--prefix-cache", "--shared-prefix", "8"],
     "prefix["),
    (["--schedule", "unified", "--speculative", "2"], "spec[k=2"),
], ids=["smoothquant", "prefix-cache", "speculative"])
def test_serve_cli_new_options_on_cpu(capsys, argv, note):
    tserve.main(["--device", "cpu", "--requests", "3", "--n-slots", "2",
                 "--gen", "3", "--prompt-len", "8", *argv])
    out = capsys.readouterr().out
    assert "tok/s" in out and note in out


@pytest.mark.parametrize("argv", [
    ["--prefix-cache"],
    ["--speculative", "2"],
    ["--speculative", "-1"],
    ["--schedule", "unified", "--n-slots", "4", "--speculative", "2",
     "--max-batch-tokens", "6"],
    ["--schedule", "unified", "--adaptive-spec"],
], ids=["prefix-legacy", "spec-legacy", "spec-negative", "spec-budget",
        "adaptive-alone"])
def test_serve_cli_flag_errors_match_reference(capsys, monkeypatch, argv):
    """The CLI refuses what the reference's ``validate_flags`` refuses,
    with the same message, before building a model."""
    from repro.launch import serve as jserve
    monkeypatch.setattr("sys.argv", ["serve", *argv])
    with pytest.raises(SystemExit):
        jserve.main()
    want = capsys.readouterr().err.strip().splitlines()[-1]
    with pytest.raises(SystemExit):
        tserve.main(["--device", "cpu", *argv])
    got = capsys.readouterr().err.strip().splitlines()[-1]
    assert got == want and "error:" in got
