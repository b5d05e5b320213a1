"""Shared cases and checks of ``test_torch_families.py`` and
``test_torch_families_2.py``: the dense family's five configs and the moe
family's two through the port against the live JAX reference, on the CPU
(see the former's docstring).
"""
import dataclasses
import json
import os

import jax
import numpy as np
import torch

from repro.configs import get_config as j_get_config
from repro.core.pipeline import QuantizeConfig as JQuantizeConfig
from repro.core.pipeline import quantize_model as j_quantize_model
from repro.data import calibration_batches as j_calibration_batches
from repro.data import make_batch, request_workload
from repro.launch.engine import ServeEngine as JEngine
from repro.models import build as j_build
from repro_torch import configs as tconfigs
from repro_torch.convert import from_reference
from repro_torch.launch.engine import ServeEngine
from repro_torch.models import build as t_build

torch.set_num_threads(1)

SEQ = 24          # forward tokens, longer than the smoke window (16)
ENGINE_KW = dict(n_slots=2, max_len=40)


def make_cases():
    """(cfg, fp params, CAT-W4A4 params) of the reference per arch, built
    once: f32 smoke config, ``init`` at PRNGKey(0), PTQ on two
    calibration sequences (as the golden cases are built)."""
    built = {}

    def get(arch):
        if arch not in built:
            cfg = j_get_config(arch).smoke().scaled(dtype="float32")
            model = j_build(cfg)
            params = model.init(jax.random.PRNGKey(0))
            qcfg = JQuantizeConfig(w_bits=4, a_bits=4, transform="cat",
                                   cat_block=16)
            qparams = j_quantize_model(model, params, qcfg,
                                       j_calibration_batches(
                                           cfg, n_seqs=2, seq_len=16,
                                           batch=2))
            built[arch] = (cfg, params, qparams)
        return built[arch]
    return get


def _port_cfg(cfg):
    return tconfigs.ArchConfig(**dataclasses.asdict(cfg))


def _batch(cfg):
    return make_batch(cfg, SEQ, 2, seed=3)


def _extra(cfg, batch):
    return batch.get("patch_embed") if cfg.n_patches else None


def _logits_both(cfg, params, batch):
    """Logits of every position of ``batch`` through both packages."""
    extra = _extra(cfg, batch)
    jm = j_build(cfg)
    hidden, _, _ = jm.forward(params, jax.numpy.asarray(batch["tokens"]),
                              extra_embed=None if extra is None
                              else jax.numpy.asarray(extra))
    want = np.asarray(jm.logits(params, hidden))
    tm = t_build(_port_cfg(cfg))
    with torch.no_grad():
        th, _, _ = tm.forward(
            from_reference(params), torch.as_tensor(batch["tokens"]),
            extra_embed=None if extra is None else torch.as_tensor(extra))
        got = tm.logits(from_reference(params), th).numpy()
    return got, want


def check_fp_logits(cases, arch):
    cfg, params, _ = cases(arch)
    got, want = _logits_both(cfg, params, _batch(cfg))
    assert got.shape == want.shape == (
        2, SEQ + cfg.n_patches, cfg.vocab)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def check_cat_w4a4_logits(cases, arch):
    cfg, _, qparams = cases(arch)
    got, want = _logits_both(cfg, qparams, _batch(cfg))
    np.testing.assert_allclose(got, want, rtol=5e-2, atol=5e-2)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def check_loss(cases, arch):
    cfg, params, _ = cases(arch)
    batch = _batch(cfg)
    assert (cfg.family == "vlm") == ("patch_embed" in batch)
    jloss, jm = j_build(cfg).loss(params, {
        k: jax.numpy.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        tloss, tm = t_build(_port_cfg(cfg)).loss(from_reference(params),
                                                 batch)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(tm["ce"]), float(jm["ce"]), rtol=1e-5)


SCHEDULES = {
    # the unified token-budget step on the int8 paged pool, prompts split
    # into chunks of the budget
    "unified": dict(schedule="unified", pipeline=False, page_size=8,
                    max_batch_tokens=16),
    # the reference's default: prefill on admit, bucketed, slot cache
    "legacy": dict(schedule="legacy"),
}


def check_engine_tokens(cases, arch, schedule):
    cfg, _, qparams = cases(arch)
    cfg = cfg.scaled(kv_quant_bits=8)
    reqs = request_workload(cfg, 3, gen=6, lengths=(18, 20, 24), seed=0)
    assert min(len(r["tokens"]) for r in reqs) > cfg.window if \
        cfg.window else True
    kw = dict(ENGINE_KW, **SCHEDULES[schedule])
    jres = JEngine(j_build(cfg), qparams, **kw).run(reqs)
    tres = ServeEngine(t_build(_port_cfg(cfg)), from_reference(qparams),
                       device="cpu", **kw).run(reqs)
    for r in reqs:
        assert len(tres[r["rid"]].tokens) == len(r["tokens"]) + 6
        np.testing.assert_array_equal(tres[r["rid"]].tokens,
                                      jres[r["rid"]].tokens,
                                      err_msg=f"{arch} rid={r['rid']}")


# the moe family's serving features, held the same way: the unified
# schedule with the prefix cache on a workload sharing 12 tokens, and with
# speculative decoding (k 2, the reference's CAT-W4A8 draft of the same
# checkpoint, converted)
MOE_FEATURES = {
    "prefix": dict(schedule="unified", pipeline=False, page_size=8,
                   max_batch_tokens=16, prefix_cache=True),
    "speculative": dict(schedule="unified", pipeline=False, page_size=8,
                        max_batch_tokens=16, speculative_k=2),
}


def check_engine_feature(cases, arch, feature):
    """The engine's tokens with ``MOE_FEATURES[feature]`` equal the live
    JAX engine's, and the feature ran (prefix hits; drafted tokens)."""
    from repro.launch.serve import build_draft_model as j_build_draft_model
    cfg, _, qparams = cases(arch)
    cfg = cfg.scaled(kv_quant_bits=8)
    kw = dict(ENGINE_KW, **MOE_FEATURES[feature])
    jkw, tkw = dict(kw), dict(kw)
    if feature == "speculative":
        dmodel, dparams = j_build_draft_model(arch, True, 0)
        dcfg = dmodel.cfg.scaled(dtype="float32")
        jkw["draft"] = (j_build(dcfg), dparams)
        tkw["draft"] = (t_build(_port_cfg(dcfg)), from_reference(dparams))
    reqs = request_workload(cfg, 3, gen=6, lengths=(6, 9), seed=0,
                            shared_prefix=12 if feature == "prefix" else 0)
    jeng = JEngine(j_build(cfg), qparams, **jkw)
    jres = jeng.run(reqs)
    teng = ServeEngine(t_build(_port_cfg(cfg)), from_reference(qparams),
                       device="cpu", **tkw)
    tres = teng.run(reqs)
    for r in reqs:
        np.testing.assert_array_equal(tres[r["rid"]].tokens,
                                      jres[r["rid"]].tokens,
                                      err_msg=f"{arch} {feature} "
                                              f"rid={r['rid']}")
    ts, js = teng.summary(), jeng.summary()
    keys = (("prefix_hits", "prefix_hit_tokens") if feature == "prefix"
            else ("spec_drafted_tokens", "spec_accepted_tokens"))
    for key in keys:
        assert ts[key] == js[key], key
    assert ts[keys[0]] > 0


def port_leaves(tree):
    """The tensors of a port tree, dict keys sorted and dataclass fields in
    order (the reference's flattening order)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in port_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in port_leaves(v)]
    if dataclasses.is_dataclass(tree):
        return [x for f in dataclasses.fields(tree)
                for x in port_leaves(getattr(tree, f.name))]
    return []


def _same_torch(a, b):
    """The port trees' tensors bitwise equal, in one walk."""
    la, lb = port_leaves(a), port_leaves(b)
    assert len(la) == len(lb) and la
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.reshape(-1).view(torch.uint8),
                           y.reshape(-1).view(torch.uint8))


def check_checkpoint_round_trip(cases, arch, tmp_path):
    """The CAT-W4A4 params (with the config's own leaves: unembed,
    q_norm / k_norm, ln1_post / ln2_post) cross both ways on the
    reference's layout: the reference's checkpoint restores into the port
    bitwise, the port's has the reference's manifest and restores into
    the reference bitwise."""
    from repro import checkpoint as j_ck
    from repro_torch import checkpoint as t_ck
    _, _, qparams = cases(arch)
    like = from_reference(qparams)
    jd, td = str(tmp_path / "j"), str(tmp_path / "t")
    os.makedirs(jd)
    j_ck.save(jd, 3, qparams, meta={"quant": "w4a4-cat"})
    out = t_ck.restore(jd, None, like, device="cpu")
    _same_torch(out["params"], like)
    t_ck.save(td, 3, like, meta={"quant": "w4a4-cat"})
    manifests = []
    for d in (jd, td):
        with open(f"{d}/step_{3:08d}/manifest.json") as f:
            manifests.append(json.load(f))
    assert manifests[0] == manifests[1]
    back = j_ck.restore(td, 3, qparams)["params"]
    la, lb = jax.tree.leaves(back), jax.tree.leaves(qparams)
    assert jax.tree.structure(back) == jax.tree.structure(qparams)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(
            np.asarray(x).reshape(-1).view(np.uint8),
            np.asarray(y).reshape(-1).view(np.uint8))
