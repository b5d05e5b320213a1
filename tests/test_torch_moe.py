"""The moe family's expert MLP and expert PTQ in the port against the live
JAX reference, on the CPU, for granite-moe-1b-a400m and
moonshot-v1-16b-a3b at ``smoke()`` width (2 layers, d 128, 4 experts,
top-2, d_ff 64) in f32. Params are the reference's ``init`` at
PRNGKey(0), converted with ``convert.from_reference``; activations are
drawn from a seeded numpy generator.

- ``moe_mlp`` on layer 0: the routing state (each (token, slot) pair's
  expert ``sel``, its queue position ``pos`` and ``keep``) bitwise equal
  to the reference's routing lines (``repro/models/moe.py:60-75``, run in
  JAX on the same router inputs); the dispatched rows (the
  ``expert_in`` tap of the reference's own ``moe_mlp``: G·E·C rows, empty
  slots zero) bitwise; the ``down_in`` tap, the output and the
  load-balance ``aux`` at ``RTOL`` (1e-4 of the largest value, the dense
  forward's bar in ``tests/_families.py``).
- The same with capacity drops: ``capacity_factor`` 0.5 and
  ``GROUP_SIZE`` 8 in both packages (``monkeypatch``), 42 tokens, so the
  last group is padded and some pairs are dropped.
- A zero router, where every probability ties: the port picks the
  experts ``jax.lax.top_k`` picks (the lower index first), and
  ``moe.top_k`` on rows of many ties equals ``jax.lax.top_k``.
- ``from_reference`` on a CAT-W4A4 MoE tree: stacked (E, ...) expert
  QLinears per layer, and ``stack_layers`` gives back every leaf of the
  reference's tree bitwise.
- Expert PTQ: given the reference's fused (E, d_in, d_out) weights, RTN
  and GPTQ (with the reference's Cholesky factor) codes and the int4
  packed bytes bitwise, scales at rtol 1e-6; Σ_w over the experts
  bitwise; SmoothQuant's weight maxima (``smooth_wmax``) through both
  ``build_transform``s where the reference's rule broadcasts (d_in ==
  d_out), and refused where it does not, as the reference fails there.
  ``quantize_model`` end to end (CAT, RTN and GPTQ): codes equal but for
  at most 1e-3 (RTN) / 1e-2 (GPTQ) of them, the Hadamard signs equal; the
  expert groups' scales at rtol 1e-5 and CAT blocks within 1e-5 of their
  largest entry (the attention groups as the dense family's tests hold
  them; see the test).
- ``loss`` with its ``aux`` at rtol 1e-5; ``active_param_count``
  exactly; the size rule of ``build_served_model`` (both configs are
  quantized one layer at a time at full width, never at ``smoke()``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _families import port_leaves

from repro.configs import get_config as j_get_config
from repro.core import gptq as jgptq
from repro.core import pipeline as jpipe
from repro.core import qlinear as jqlinear
from repro.data import calibration_batches as j_calibration_batches
from repro.data import make_batch
from repro.models import build as j_build
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro_torch import configs as tconfigs
from repro_torch.convert import from_reference, stack_layers
from repro_torch.core import gptq as tgptq
from repro_torch.core import pipeline as tpipe
from repro_torch.core.qlinear import QLinear, iter_qlinear, unpacked_qweight
from repro_torch.data import calibration_batches
from repro_torch.launch import serve
from repro_torch.models import build as t_build
from repro_torch.models import dense
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe

torch.set_num_threads(1)

ARCHS = ["granite_moe_1b_a400m", "moonshot_v1_16b_a3b"]
RTOL = 1e-4


@pytest.fixture(scope="module")
def cases():
    """arch -> (JAX cfg, port cfg, reference params, port params)."""
    built = {}

    def get(arch):
        if arch not in built:
            cfg = j_get_config(arch).smoke().scaled(dtype="float32")
            params = j_build(cfg).init(jax.random.PRNGKey(0))
            tcfg = tconfigs.ArchConfig(**dataclasses.asdict(cfg))
            built[arch] = (cfg, tcfg, params, from_reference(params))
        return built[arch]
    return get


class _Taps:
    def __init__(self):
        self.rows = {}

    def record(self, name, x):
        self.rows[name.split(".")[-1]] = np.asarray(
            x.detach() if isinstance(x, torch.Tensor) else x)


def _ref_routing(cfg, lp, x):
    """(sel, pos, keep) of the reference's ``moe_mlp`` on x (B, S, D):
    its lines 49-75, run in JAX."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    gs = min(jmoe.GROUP_SIZE, t)
    pad = (-t) % gs
    xf = x.reshape(t, d)
    if pad:
        xf = jnp.pad(xf, ((0, pad), (0, 0)))
    g = xf.shape[0] // gs
    xg = xf.reshape(g, gs, d)
    cap = jmoe.group_capacity(cfg, gs)
    gate_logits = jnp.einsum("gtd,de->gte", xg, lp["router"].astype(xg.dtype),
                             preferred_element_type=jnp.float32)
    probs = jax.nn.softmax(gate_logits, axis=-1)
    _, sel = jax.lax.top_k(probs, k)
    sel_oh = jax.nn.one_hot(sel, e, dtype=jnp.float32)
    pos = jnp.cumsum(sel_oh.reshape(g, gs * k, e), axis=1
                     ).reshape(g, gs, k, e) - 1.0
    pos = jnp.sum(pos * sel_oh, axis=-1)
    return (np.asarray(sel), np.asarray(pos).astype(np.int64),
            np.asarray(pos < cap))


def _hold_moe_mlp(cfg, tcfg, params, tparams, x):
    """The port's ``moe_mlp`` on layer 0 against the reference's."""
    lp = jax.tree.map(lambda a: a[0], params["layers"])
    jt, tt = _Taps(), _Taps()
    jout, jaux = jmoe.moe_mlp(cfg, lp, jnp.asarray(x), taps=jt, layer_idx=0)
    with torch.no_grad():
        tout, taux = tmoe.moe_mlp(tcfg, tparams["layers"][0],
                                  torch.as_tensor(x), taps=tt, layer_idx=0)
        t = x.shape[0] * x.shape[1]
        gs = min(tmoe.GROUP_SIZE, t)
        xf = torch.nn.functional.pad(torch.as_tensor(x).reshape(t, -1),
                                     (0, 0, 0, (-t) % gs))
        _, _, sel, pos, keep = tmoe.route(
            tcfg, xf.reshape(-1, gs, x.shape[-1]),
            tparams["layers"][0]["router"])
    want = _ref_routing(cfg, lp, jnp.asarray(x))
    for name, got, ref in zip(("sel", "pos", "keep"), (sel, pos, keep), want):
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=name)
    np.testing.assert_array_equal(tt.rows["expert_in"], jt.rows["expert_in"])
    for name, got, ref in (("down_in", tt.rows["down_in"],
                            jt.rows["down_in"]),
                           ("out", tout.numpy(), np.asarray(jout))):
        np.testing.assert_allclose(got, ref, rtol=RTOL,
                                   atol=RTOL * np.abs(ref).max(),
                                   err_msg=name)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    return keep.numpy()


def _activations(cfg, shape, seed=0):
    return np.random.default_rng(seed).standard_normal(
        shape + (cfg.d_model,)).astype(np.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_mlp_matches_reference(cases, arch):
    cfg, tcfg, params, tparams = cases(arch)
    keep = _hold_moe_mlp(cfg, tcfg, params, tparams,
                         _activations(cfg, (2, 24)))
    assert keep.all()      # smoke(): capacity E/k, dropless


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_mlp_with_capacity_drops(cases, arch, monkeypatch):
    cfg, tcfg, params, tparams = cases(arch)
    monkeypatch.setattr(jmoe, "GROUP_SIZE", 8)
    monkeypatch.setattr(tmoe, "GROUP_SIZE", 8)
    cfg = cfg.scaled(capacity_factor=0.5)
    tcfg = tcfg.scaled(capacity_factor=0.5)
    keep = _hold_moe_mlp(cfg, tcfg, params, tparams,
                         _activations(cfg, (2, 21), seed=1))
    assert keep.shape == (6, 8, cfg.top_k)     # 42 tokens, the last padded
    assert not keep.all()


@pytest.mark.parametrize("arch", ARCHS)
def test_zero_router_picks_the_reference_experts(cases, arch):
    cfg, tcfg, params, tparams = cases(arch)
    layers = dict(params["layers"],
                  router=jnp.zeros_like(params["layers"]["router"]))
    tlayers = [dict(lp, router=torch.zeros_like(lp["router"]))
               for lp in tparams["layers"]]
    keep = _hold_moe_mlp(cfg, tcfg, dict(params, layers=layers),
                         dict(tparams, layers=tlayers),
                         _activations(cfg, (2, 24), seed=2))
    assert keep.all()
    # rows of many ties: values from a set of three
    probs = np.random.default_rng(3).integers(0, 3, (64, 16)).astype(
        np.float32) / 4
    for k in (1, 2, 6, 8):
        jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
        tv, ti = tmoe.top_k(torch.as_tensor(probs), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def _quantized(arch, transform="cat", w_method="rtn"):
    cfg = j_get_config(arch).smoke().scaled(dtype="float32")
    model = j_build(cfg)
    params = model.init(jax.random.PRNGKey(0))
    qcfg = dict(transform=transform, w_method=w_method, cat_block=16)
    jq = jpipe.quantize_model(
        model, params, jpipe.QuantizeConfig(**qcfg),
        j_calibration_batches(cfg, n_seqs=2, seq_len=16, batch=2))
    tcfg = tconfigs.ArchConfig(**dataclasses.asdict(cfg))
    tq = tpipe.quantize_model(
        t_build(tcfg), from_reference(params), tpipe.QuantizeConfig(**qcfg),
        calibration_batches(tcfg, n_seqs=2, seq_len=16, batch=2))
    return cfg, jq, tq


def test_from_reference_round_trips_a_quantized_moe_tree():
    cfg, jq, _ = _quantized("granite_moe_1b_a400m")
    tq = from_reference(jq)
    assert len(tq["layers"]) == cfg.n_layers
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    lp = tq["layers"][1]
    assert lp["router"].shape == (d, e)
    for name, d_in, d_out in (("we_g", d, f), ("we_u", d, f),
                              ("we_d", f, d)):
        p = lp[name]
        assert isinstance(p, QLinear) and p.packed and p.d_in == d_in
        assert p.qweight.shape == (e, d_in // 2, d_out)
        assert p.scale.shape == (e, 1, d_out)
        assert unpacked_qweight(p).shape == (e, d_in, d_out)
        np.testing.assert_array_equal(
            unpacked_qweight(p).numpy(),
            np.asarray(jqlinear.unpacked_qweight(jq["layers"][name]))[1])
    back, want = port_leaves(stack_layers(tq)), jax.tree.leaves(jq)
    assert len(back) == len(want)
    for x, y in zip(back, want):
        y = np.asarray(y)
        assert tuple(x.shape) == y.shape
        np.testing.assert_array_equal(x.numpy().reshape(-1).view(np.uint8),
                                      y.reshape(-1).view(np.uint8))


def _shifts(tq, jq) -> dict:
    """Per QLinear path: (share of codes that differ, largest difference
    in code steps, shares of output channels whose scale is off by more
    than rtol 1e-5 and than rtol 1e-4, the CAT blocks' largest difference
    relative to their largest entry); the Hadamard signs and the shapes
    held equal."""
    mine, theirs = dict(iter_qlinear(tq)), dict(iter_qlinear(
        from_reference(jq)))
    assert sorted(mine) == sorted(theirs)
    out = {}
    for k, a in mine.items():
        b = theirs[k]
        assert (a.w_bits, a.act_bits, a.d_in) == (b.w_bits, b.act_bits,
                                                  b.d_in)
        assert a.qweight.shape == b.qweight.shape, k
        ca = unpacked_qweight(a).numpy().astype(np.int32)
        cb = unpacked_qweight(b).numpy().astype(np.int32)
        sa, sb = a.scale.numpy(), b.scale.numpy()
        (ma, ha), (mb, hb) = a.transform.parts, b.transform.parts
        assert torch.equal(ha.sign, hb.sign), k
        out[k] = (float((ca != cb).mean()), int(np.abs(ca - cb).max()),
                  float((np.abs(sa - sb) > 1e-5 * np.abs(sb)).mean()),
                  float((np.abs(sa - sb) > 1e-4 * np.abs(sb)).mean()),
                  float((ma.blocks - mb.blocks).abs().max()
                        / mb.blocks.abs().max()))
    return out


@pytest.mark.parametrize("w_method,max_share",
                         [("rtn", 1e-3), ("gptq", 1e-2)])
@pytest.mark.parametrize("arch", ARCHS)
def test_quantize_model_matches_reference(arch, w_method, max_share):
    """The expert groups (Σ_w summed over every expert): codes equal but
    for ``max_share`` (RTN: one step apart), every scale at rtol 1e-5,
    the CAT blocks within 1e-5 of their largest entry. The attention
    groups, as the dense family's PTQ tests hold them: the codes' share,
    scales at rtol 1e-4 on >= 99 % of channels (a channel whose L2.4 grid
    pick flips on an ulp moves more), the blocks within 2e-3 of their
    largest entry (the o_in tap's Σ_x is near singular at this width)."""
    cfg, jq, tq = _quantized(arch, w_method=w_method)
    shifts = _shifts(tq, jq)
    assert len(shifts) == 7 * cfg.n_layers
    for k, (share, steps, off_5, off_4, blocks) in shifts.items():
        assert share <= max_share, k
        if w_method == "rtn":
            assert steps <= 1, k
        if ".we_" in k:
            assert off_5 == 0 and blocks <= 1e-5, k
        else:
            assert off_4 <= 0.01 and blocks <= 2e-3, k


@pytest.mark.parametrize("w_method", ["rtn", "gptq"])
@pytest.mark.parametrize("arch", ARCHS)
def test_expert_weights_quantize_bitwise(cases, arch, w_method,
                                         monkeypatch):
    """Layer 0's expert groups through both packages' quantizer from the
    same fused weights and Σ: codes, packed bytes, Σ_w bitwise."""
    cfg, _, params, _ = cases(arch)
    rng = np.random.default_rng(4)
    for name in ("we_g", "we_d"):
        ws = [np.asarray(params["layers"][name][0])]
        d_in = ws[0].shape[-2]
        np.testing.assert_array_equal(tpipe._sigma_w_of(ws),
                                      jpipe._sigma_w_of(ws))
        x = rng.standard_normal((256, d_in)).astype(np.float32)
        sigma = (x.T @ x / 256).astype(np.float32)
        jqc = jpipe.QuantizeConfig(w_method=w_method)
        tqc = tpipe.QuantizeConfig(w_method=w_method)
        if w_method == "gptq":
            u = np.asarray(jgptq._damped_hinv_chol(jnp.asarray(sigma)))
            monkeypatch.setattr(tgptq, "_damped_hinv_chol",
                                lambda s, damp=0.01: torch.tensor(u))
        jcodes, jscale = jpipe._quantize_weight(jnp.asarray(ws[0]),
                                                jnp.asarray(sigma), jqc)
        tcodes, tscale = tpipe._quantize_weight(torch.tensor(ws[0]),
                                                torch.tensor(sigma), tqc)
        assert tcodes.shape == (cfg.n_experts,) + ws[0].shape[1:]
        assert tscale.shape == (cfg.n_experts, 1, ws[0].shape[-1])
        np.testing.assert_array_equal(tcodes.numpy(), np.asarray(jcodes))
        np.testing.assert_allclose(tscale.numpy(), np.asarray(jscale),
                                   rtol=1e-6)
        jl = jpipe._make_qlinear(jcodes, jscale, None, jqc)
        tl = tpipe._make_qlinear(tcodes, tscale, None, tqc)
        assert tl.d_in == jl.d_in == d_in
        np.testing.assert_array_equal(tl.qweight.numpy(),
                                      np.asarray(jl.qweight))


class _Stats:
    def __init__(self, absmax):
        self.absmax = absmax


def test_smoothquant_weight_maxima_follow_the_reference():
    """An expert stack's maxima by the reference's rule: where d_in ==
    d_out the reference's SmoothQuant builds, and the port's scale equals
    it; at the moe configs' widths the reference fails on the broadcast
    and the port refuses."""
    cfg = j_get_config("granite_moe_1b_a400m").smoke()
    rng = np.random.default_rng(5)
    ws = [rng.standard_normal((3, 16, 16)).astype(np.float32)
          for _ in range(2)]
    stats = _Stats(np.abs(rng.standard_normal(16)).astype(np.float32) + 0.1)
    qcfg = dict(transform="smoothquant")
    jt = jpipe.build_transform(jpipe.QuantizeConfig(**qcfg), cfg, stats, ws,
                               np.random.default_rng(0))
    tt = tpipe.build_transform(tpipe.QuantizeConfig(**qcfg), cfg, stats, ws,
                               np.random.default_rng(0), "cpu")
    np.testing.assert_allclose(tt.s.numpy(), np.asarray(jt.s), rtol=1e-6)
    np.testing.assert_array_equal(
        tpipe.smooth_wmax(ws), np.abs(np.stack(ws)).max(axis=(0, 1, 2)))
    wide = [rng.standard_normal((3, 16, 8)).astype(np.float32)]
    with pytest.raises(TypeError):
        jpipe.build_transform(jpipe.QuantizeConfig(**qcfg), cfg, stats,
                              wide, np.random.default_rng(0))
    with pytest.raises(ValueError, match="smoothquant"):
        tpipe.build_transform(tpipe.QuantizeConfig(**qcfg), cfg, stats,
                              wide, np.random.default_rng(0), "cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_aux_match_reference(cases, arch):
    cfg, tcfg, params, tparams = cases(arch)
    batch = make_batch(cfg, 24, 2, seed=3)
    jloss, jm = j_build(cfg).loss(params, {
        k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        tloss, tm = t_build(tcfg).loss(tparams, batch)
    assert float(jm["aux"]) > 0
    np.testing.assert_allclose(float(tm["aux"]), float(jm["aux"]), rtol=1e-5)
    np.testing.assert_allclose(float(tm["ce"]), float(jm["ce"]), rtol=1e-5)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_active_param_count_matches_reference(cases, arch):
    cfg, tcfg, params, tparams = cases(arch)
    assert tmodel.param_count(tparams) == jmodel.param_count(params)
    assert (tmodel.active_param_count(tcfg, tparams)
            == jmodel.active_param_count(cfg, params)
            < tmodel.param_count(tparams))


@pytest.mark.parametrize("arch", ARCHS)
def test_served_moe_takes_the_layerwise_ptq_by_size(arch):
    """Both configs' fp32 layer weights (router and every expert) exceed
    ``LAYERWISE_BYTES`` at full width and not at ``smoke()``; the full
    width keeps the reference's capacity factor (1.25: tokens drop)."""
    cfg = tconfigs.get_config(arch)
    assert cfg.capacity_factor == 1.25
    assert cfg.smoke().capacity_factor == 2.0
    assert serve.layer_weight_bytes(cfg) > serve.LAYERWISE_BYTES
    small = cfg.smoke()
    n_lin = sum(v.numel() for k, v in dense.init_layer(
        small, torch.Generator().manual_seed(0)).items() if v.ndim >= 2)
    assert serve.layer_weight_bytes(small) == 4 * small.n_layers * n_lin
    assert serve.layer_weight_bytes(small) <= serve.LAYERWISE_BYTES

