"""The dense family's five configs and the moe family's two through the
port against the live JAX reference, on the CPU: mistral-nemo-12b,
granite-34b, gemma2-2b and granite-moe-1b-a400m here, gemma3-12b,
paligemma-3b and moonshot-v1-16b-a3b in ``test_torch_families_2.py``
(the checks are ``_families.py``'s), and the port's layer-at-a-time PTQ.

mistral-nemo-12b (untied embeddings), granite-34b (MQA, ungated GELU
MLP), gemma2-2b (local/global alternation, attention and logit softcaps,
sandwich norms, GELU), gemma3-12b (5:1 local/global, qk-norm) and the
paligemma-3b backbone (a prefix of patch embeddings), each at its
``smoke()`` width (2 layers, d 128; the window 16, 8 patches) in f32.
The same seeded params (the reference's ``init``, converted with
``convert.from_reference``) and inputs go through both packages:

- fp and CAT-W4A4 (the reference's ``quantize_model``, cat block 16, int4
  packed) logits of ``forward`` over 24 tokens, longer than the window so
  local layers mask: fp at rtol 1e-4 of the largest logit; CAT-W4A4 at
  the JAX suite's rtol-level bar for its quantized paths (rtol and atol
  5e-2, ``tests/test_models_smoke.py``), with the greedy token of every
  position equal;
- ``loss`` on a training batch (paligemma with ``patch_embed``, whose
  rows the loss leaves out) at rtol 1e-5;
- greedy tokens of the unified (paged, int8 KV, chunked prompts) and the
  legacy (slot cache, bucketed prefill) engines on the CAT-W4A4 params,
  exactly equal to the live JAX engine's, with prompts of 18-24 tokens so
  local layers mask, and more requests than slots;
- for the moe configs (4 experts, top-2, dropless at ``smoke()``), also
  the unified engine with the prefix cache and with speculative decoding
  (k 2, the reference's CAT-W4A8 draft converted): tokens, prefix hits
  and drafted/accepted counts equal the live JAX engine's
  (``MOE_FEATURES``).
"""
import dataclasses

import pytest
import torch

from _families import (MOE_FEATURES, SCHEDULES, check_cat_w4a4_logits,
                       check_checkpoint_round_trip, check_engine_feature,
                       check_engine_tokens, check_fp_logits, check_loss,
                       make_cases)

from repro.configs import get_config as j_get_config
from repro_torch.configs import ArchConfig, get_config
from repro_torch.core.pipeline import (QuantizeConfig, quantize_model,
                                       quantize_model_layerwise)
from repro_torch.core.qlinear import iter_qlinear
from repro_torch.data import calibration_batches
from repro_torch.launch import serve
from repro_torch.launch.engine import ServeEngine
from repro_torch.models import build as t_build
from repro_torch.models import dense

torch.set_num_threads(1)

ARCHS = ["mistral_nemo_12b", "granite_34b", "gemma2_2b",
         "granite_moe_1b_a400m"]


@pytest.fixture(scope="module")
def cases():
    return make_cases()


@pytest.mark.parametrize("arch", ARCHS)
def test_fp_logits_match_live_jax(cases, arch):
    check_fp_logits(cases, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_cat_w4a4_logits_match_live_jax(cases, arch):
    check_cat_w4a4_logits(cases, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_live_jax(cases, arch):
    check_loss(cases, arch)


@pytest.mark.parametrize("arch", ["mistral_nemo_12b", "gemma2_2b",
                                  "granite_moe_1b_a400m"])
def test_checkpoint_round_trips_on_the_reference_layout(cases, arch,
                                                        tmp_path):
    check_checkpoint_round_trip(cases, arch, tmp_path)


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tokens_equal_live_jax(cases, arch, schedule):
    check_engine_tokens(cases, arch, schedule)


@pytest.mark.parametrize("feature", sorted(MOE_FEATURES))
def test_moe_engine_features_equal_live_jax(cases, feature):
    check_engine_feature(cases, "granite_moe_1b_a400m", feature)


def test_moe_is_refused_loudly():
    """What the port still refuses for the moe family is what the
    reference refuses: serving it on a mesh (no expert parallelism)."""
    cfg = ArchConfig(**dataclasses.asdict(
        j_get_config("granite_moe_1b_a400m").smoke()))
    model = t_build(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="non-MoE"):
        ServeEngine(model, params, mesh=object(), device="cpu")


@pytest.mark.parametrize("arch", ["mistral_nemo_12b", "gemma2_2b",
                                  "paligemma_3b", "granite_moe_1b_a400m",
                                  "moonshot_v1_16b_a3b"])
def test_layerwise_ptq_matches_quantize_model(arch):
    """``quantize_model_layerwise`` (draw, calibrate, quantize and free
    one layer at a time, Σ_x and Σ_w kept as their CAT diagonal blocks)
    against ``quantize_model`` on the same fp params and calibration
    batches: the same Hadamard signs, codes equal on >= 99.9 % of
    entries, scales and CAT blocks at rtol 1e-5 (the two sum Σ in other
    orders)."""
    cfg = get_config(arch).smoke().scaled(dtype="float32")
    model = t_build(cfg)
    gen = torch.Generator().manual_seed(0)
    rest = dense.init_rest(cfg, gen)
    layers = [dense.init_layer(cfg, gen) for _ in range(cfg.n_layers)]
    qcfg = QuantizeConfig(w_bits=4, a_bits=4, transform="cat",
                          cat_block=16)
    whole = quantize_model(
        model, dict(rest, layers=[dict(lp) for lp in layers]), qcfg,
        calibration_batches(cfg, n_seqs=4, seq_len=16, batch=2))
    drawn = []
    lw = quantize_model_layerwise(
        model, qcfg, calibration_batches(cfg, n_seqs=4, seq_len=16,
                                         batch=2), rest,
        lambda i: drawn.append(i) or dict(layers[i]))
    assert drawn == list(range(cfg.n_layers))
    pairs = list(zip(iter_qlinear(whole), iter_qlinear(lw)))
    assert len(pairs) == 7 * cfg.n_layers
    for (path, a), (path_b, b) in pairs:
        assert path == path_b
        assert (a.qweight == b.qweight).float().mean() >= 0.999, path
        torch.testing.assert_close(b.scale, a.scale, rtol=1e-5, atol=0)
        (ma, ha), (mb, hb) = a.transform.parts, b.transform.parts
        torch.testing.assert_close(mb.blocks, ma.blocks, rtol=1e-5,
                                   atol=1e-6)
        assert torch.equal(hb.sign, ha.sign)


@pytest.mark.parametrize("arch,layerwise", [
    ("catlm_60m", False), ("gemma2_2b", True), ("mistral_nemo_12b", True),
    ("granite_34b", True)])
def test_served_model_takes_the_layerwise_ptq_by_size(arch, layerwise):
    """``build_served_model`` quantizes one layer at a time exactly the
    configs whose fp32 layer weights exceed ``LAYERWISE_BYTES`` (the
    full-width LLMs), never catlm or a ``smoke()`` config."""
    cfg = get_config(arch)
    assert (serve.layer_weight_bytes(cfg) > serve.LAYERWISE_BYTES) \
        == layerwise
    assert serve.layer_weight_bytes(cfg.smoke()) <= serve.LAYERWISE_BYTES
    n_lin = sum(v.numel() for k, v in dense.init_layer(
        cfg.smoke(), torch.Generator().manual_seed(0)).items()
        if k.startswith("w"))
    assert serve.layer_weight_bytes(cfg.smoke()) \
        == 4 * cfg.smoke().n_layers * n_lin


def test_layerwise_served_model_draws_the_reference_init(monkeypatch):
    """With the size rule forced (``LAYERWISE_BYTES`` 0), a smoke
    mistral-nemo is served from ``quantize_model_layerwise`` over one
    generator's draws in the order embed, unembed, layers: its params
    equal a direct call's, and its untied unembed is its own draw (std
    1/sqrt(d), as the reference's ``_init_linear``), not a copy of
    embedᵀ."""
    monkeypatch.setattr(serve, "LAYERWISE_BYTES", 0)
    cfg, model, params, mem = serve.build_served_model(
        "mistral_nemo_12b", "cat", 4, 4, 8, smoke=True, seed=0,
        device="cpu")
    gen = torch.Generator().manual_seed(0)
    rest = dense.init_rest(cfg, gen, "cpu", dense.compute_dtype(cfg))
    qcfg = QuantizeConfig(w_bits=4, a_bits=4, transform="cat",
                          cat_block=min(cfg.cat_block, 32))
    want = quantize_model_layerwise(
        model, qcfg, calibration_batches(cfg, n_seqs=8, seq_len=64,
                                         batch=4), rest,
        lambda i: dense.init_layer(cfg, gen))
    assert torch.equal(params["unembed"], want["unembed"])
    assert not torch.equal(params["unembed"], params["embed"].T)
    std = params["unembed"].float().std().item()
    assert abs(std * cfg.d_model ** 0.5 - 1) < 0.05
    got_q, want_q = list(iter_qlinear(params)), list(iter_qlinear(want))
    assert len(got_q) == len(want_q) == mem["qlinear_layers"]
    for (path, a), (_, b) in zip(got_q, want_q):
        assert torch.equal(a.qweight, b.qweight), path
        assert torch.equal(a.scale, b.scale), path
