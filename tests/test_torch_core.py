"""The port's core (quantizers, transforms, QLinear routes, converter) and
its import rule, against the JAX reference on the CPU.

Inputs come from numpy seeds and go to both packages; reference params
cross with ``repro_torch.convert.from_reference``.

- quantize / pack_int4 / unpack_int4: bitwise. The L2.4 weight-range grid
  search differs: ``jnp.linspace`` and numpy's linspace round some grid
  points 1 ulp apart, so its scales are held at rtol 1e-6 and its codes
  at >= 99.9 % equal.
- transforms apply / fuse_weight / fuse_cov: f32 rtol 1e-5.
- ``dense_fused`` routes 2 (``w_eff`` fake quant) and 3 (integer
  accumulation) against the same routes of the reference: f32 rtol 1e-5
  (route 3 on rows whose activation codes agree; a value on a rounding
  boundary may move one code step, allowed on <= 0.1 % of rows). Route 3
  quantizes as ``jax.jit`` compiles the reference
  (``core.quantizers.quantize_dynamic``: codes, scales and zero points
  bitwise), and its epilogue takes the unrounded f32 act scale, as XLA's
  does: with the transform taken out, bitwise equal to ``jax.jit`` of the
  reference route in f32 and in bf16.
"""
import dataclasses
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import qlinear as jq
from repro.core import quantizers as jqz
from repro.core import transforms as jT
from repro_torch.convert import from_reference
from repro_torch.core import qlinear as tq
from repro_torch.core import quantizers as tqz
from repro_torch.core import transforms as tT

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


# ------------------------------------------------------------ quantizers

@pytest.mark.parametrize("spec_name,bits", [
    ("act", 4), ("act", 8), ("kv", 8), ("sym_channel", 4), ("sym_tensor", 8)])
def test_quantize_bitwise(spec_name, bits):
    r = np.random.default_rng(bits)
    x = (r.standard_normal((37, 48)) * r.uniform(0.1, 4, (37, 1))).astype(
        np.float32)
    make = {"act": lambda m: m.act_spec(bits),
            "kv": lambda m: m.kv_spec(bits),
            "sym_channel": lambda m: m.weight_spec(bits, range_p=None),
            "sym_tensor": lambda m: m.QuantSpec(bits=bits)}[spec_name]
    jqv, js, jz = jqz.quantize(jnp.asarray(x), make(jqz))
    tqv, ts, tz = tqz.quantize(_t(x), make(tqz))
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    jf = jqz.fake_quant(jnp.asarray(x), make(jqz))
    np.testing.assert_array_equal(tqz.fake_quant(_t(x), make(tqz)).numpy(),
                                  np.asarray(jf))


def _bf16_pair(x):
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    return jx, _t(np.asarray(jx.astype(jnp.float32))).to(torch.bfloat16)


def _jitted_fake_quant(jx, spec):
    """The reference's fake quant as its engine runs it: under jax.jit."""
    return np.asarray(jax.jit(lambda v: jqz.fake_quant(v, spec))(jx)
                      .astype(jnp.float32))


def test_quantize_bf16_bitwise():
    """bf16 activations fake-quantize as the jitted reference does (bf16
    division scale, unrounded f32 dequant scale): bitwise."""
    r = np.random.default_rng(11)
    jx, tx = _bf16_pair(r.standard_normal((16, 64)).astype(np.float32))
    for bits in (4, 8):
        np.testing.assert_array_equal(
            tqz.fake_quant(tx, tqz.act_spec(bits)).float().numpy(),
            _jitted_fake_quant(jx, jqz.act_spec(bits)), err_msg=f"{bits}")


@pytest.mark.parametrize("bits", [4, 8])
def test_act_fake_quant_bf16_matches_jitted_reference(bits):
    """The route-2 repair at the serving width: the port's bf16 per-token
    asymmetric fake quant equals ``jax.jit(fake_quant)`` bitwise on a
    (256, 512) input with per-row magnitudes, where the eager reference
    (every op rounded to bf16) differs on a large share of entries."""
    r = np.random.default_rng(bits)
    x = (r.standard_normal((256, 512)) * r.uniform(0.01, 30, (256, 1))
         ).astype(np.float32)
    jx, tx = _bf16_pair(x)
    want = _jitted_fake_quant(jx, jqz.act_spec(bits))
    got = tqz.fake_quant(tx, tqz.act_spec(bits)).float().numpy()
    np.testing.assert_array_equal(got, want)
    eager = np.asarray(jqz.fake_quant(jx, jqz.act_spec(bits))
                       .astype(jnp.float32))
    assert (eager != want).mean() > 0.01


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_kv_quant_matches_jitted_reference(dtype):
    """The KV-cache quantizer as the reference's engine runs it (under
    jax.jit, where XLA turns ``/ qmax`` into a multiply by the f32
    reciprocal): codes and scales bitwise, from bf16 and f32 inputs."""
    from repro.models.layers import quantize_kv as j_quantize_kv
    from repro_torch.models.layers import quantize_kv
    r = np.random.default_rng(11)
    x = (r.standard_normal((3, 9, 4, 64)) * r.uniform(0.01, 30, (3, 9, 4, 1))
         ).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    tx = _t(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    jc, js = jax.jit(lambda v: j_quantize_kv(v, 8))(jx)
    tc, ts = quantize_kv(tx, 8)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_residual_norm_matches_jitted_reference():
    """bf16 residual add then RMS norm as the reference's compiled step
    computes them (the norm reads the unrounded f32 sum, the residual
    stream keeps the rounded one): both bitwise; the eager reference
    (the sum rounded before the norm) differs on a large share."""
    from repro.models.layers import rms_norm as j_rms_norm
    from repro_torch.models.layers import add_rms_norm
    r = np.random.default_rng(12)
    x = r.standard_normal((8, 3, 512)).astype(np.float32)
    a = (r.standard_normal((8, 3, 512)) * 0.3).astype(np.float32)
    sc = (r.standard_normal(512) * 0.1).astype(np.float32)
    jx, tx = _bf16_pair(x)
    ja, ta = _bf16_pair(a)

    def step(v, u, s):
        y = v + u
        return y, j_rms_norm(y, s)
    jy, jn = jax.jit(step)(jx, ja, jnp.asarray(sc))
    ty, tn = add_rms_norm(tx, ta, _t(sc))
    np.testing.assert_array_equal(ty.float().numpy(),
                                  np.asarray(jy.astype(jnp.float32)))
    np.testing.assert_array_equal(tn.float().numpy(),
                                  np.asarray(jn.astype(jnp.float32)))
    eager = np.asarray(j_rms_norm(jx + ja, jnp.asarray(sc))
                       .astype(jnp.float32))
    assert (eager != tn.float().numpy()).mean() > 0.05


def test_weight_range_search_l24():
    r = np.random.default_rng(5)
    w = (r.standard_normal((64, 96)) * r.uniform(0.2, 2, (64, 1))).astype(
        np.float32)
    jqv, js, _ = jqz.quantize(jnp.asarray(w), jqz.weight_spec(4))
    tqv, ts, _ = tqz.quantize(_t(w), tqz.weight_spec(4))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
    assert (tqv.numpy() == np.asarray(jqv)).mean() >= 0.999


@pytest.mark.parametrize("shape,axis", [((7, 5), 0), ((8, 3), -2),
                                        ((2, 9, 4), -2), ((3, 6), 1)])
def test_pack_unpack_int4_bitwise(shape, axis):
    r = np.random.default_rng(sum(shape))
    q = r.integers(-8, 8, shape).astype(np.int8)
    jp = np.asarray(jqz.pack_int4(jnp.asarray(q), axis=axis))
    tp = tqz.pack_int4(_t(q), axis=axis).numpy()
    np.testing.assert_array_equal(tp, jp)
    n = shape[axis]
    np.testing.assert_array_equal(
        tqz.unpack_int4(_t(jp), n, axis=axis).numpy(),
        np.asarray(jqz.unpack_int4(jnp.asarray(jp), n, axis=axis)))
    np.testing.assert_array_equal(tqz.unpack_int4(_t(tp), n, axis=axis)
                                  .numpy(), q)


# ------------------------------------------------------------ transforms

def _cat_pair(d=64, k=16, seed=1):
    """The same CAT transform in both packages (built by the reference,
    carried across by the converter)."""
    r = np.random.default_rng(seed)
    mix = r.standard_normal((d, d)) / np.sqrt(d)
    x = r.standard_normal((512, d)) @ mix
    w = r.standard_normal((48, d)) / np.sqrt(d)
    sx = jnp.asarray(x.T @ x / x.shape[0], jnp.float32)
    sw = jnp.asarray(w.T @ w, jnp.float32)
    jt = jT.make_cat_block(sw, sx, k=k, hadamard=True, rng=r)
    return jt, from_reference({"t": jt})["t"], (sx, sw)


def _transform_zoo():
    r = np.random.default_rng(2)
    d = 24
    s = jnp.asarray(r.uniform(0.5, 2.0, d), jnp.float32)
    blocks = jnp.asarray(r.standard_normal((3, 8, 8)) * 0.2 + np.eye(8),
                         jnp.float32)
    return {
        "identity": jT.Identity(),
        "scale": jT.Scale(s),
        "dense": jT.make_rotation(d, r),
        "hadamard": jT.make_hadamard(d, r),
        "blockdiag": jT.BlockDiag(blocks, jnp.linalg.inv(blocks)),
        "compose": jT.Compose((jT.Scale(s), jT.make_hadamard(d, r))),
    }


@pytest.mark.parametrize("name", ["identity", "scale", "dense", "hadamard",
                                  "blockdiag", "compose"])
def test_transforms_match(name):
    jt = _transform_zoo()[name]
    tt = from_reference({"t": jt})["t"]
    r = np.random.default_rng(3)
    x = r.standard_normal((5, 24)).astype(np.float32)
    w = r.standard_normal((10, 24)).astype(np.float32)
    a = r.standard_normal((24, 24))
    sigma = (a @ a.T / 24).astype(np.float32)
    for jfn, tfn, arg in ((jT.apply, tT.apply, x),
                          (jT.fuse_weight, tT.fuse_weight, w),
                          (jT.fuse_cov, tT.fuse_cov, sigma)):
        np.testing.assert_allclose(tfn(tt, _t(arg)).numpy(),
                                   np.asarray(jfn(jt, jnp.asarray(arg))),
                                   rtol=1e-5, atol=1e-5)


def test_cat_block_transform_matches():
    """The port's own CAT construction vs the reference's (eigh differs
    between libraries: rtol 1e-3 on the blocks' action)."""
    jt, tt, (sx, sw) = _cat_pair()
    mine = tT.make_cat_block(_t(np.asarray(sw)), _t(np.asarray(sx)), k=16,
                             hadamard=True, rng=np.random.default_rng(1))
    x = np.random.default_rng(4).standard_normal((6, 64)).astype(np.float32)
    want = np.asarray(jT.apply(jt, jnp.asarray(x)))
    np.testing.assert_allclose(tT.apply(tt, _t(x)).numpy(), want,
                               rtol=1e-5, atol=1e-5)
    assert isinstance(mine, tT.Compose)
    np.testing.assert_allclose(mine.parts[0].blocks.numpy(),
                               np.asarray(jt.parts[0].blocks), rtol=1e-3,
                               atol=1e-3)


# ------------------------------------------------------ QLinear routes

def _qlinear_pair(packed: bool, act_bits: int = 4, seed: int = 0):
    jt, _, _ = _cat_pair(seed=seed)
    r = np.random.default_rng(seed + 10)
    codes = r.integers(-8, 8, (64, 40)).astype(np.int8)
    scale = r.uniform(0.01, 0.05, (1, 40)).astype(np.float32)
    if packed:
        p = jq.QLinear(jqz.pack_int4(jnp.asarray(codes), axis=-2),
                       jnp.asarray(scale), jt, act_bits=act_bits, w_bits=4,
                       d_in=64)
    else:
        p = jq.QLinear(jnp.asarray(codes), jnp.asarray(scale), jt,
                       act_bits=act_bits, w_bits=8)
    return p, from_reference({"p": p})["p"]


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("act_bits", [4, 8])
def test_dense_route2_matches(packed, act_bits):
    jp, tp = _qlinear_pair(packed, act_bits)
    x = np.random.default_rng(7).standard_normal((2, 3, 64)).astype(
        np.float32)
    want = np.asarray(jq.dense(jq.make_serving(jp, keep_packed=False),
                               jnp.asarray(x)))
    got = tq.dense(tq.make_serving(tp, keep_packed=False), _t(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # route 2 is bitwise the unprepared portable path in both packages
    np.testing.assert_array_equal(
        got, tq.dense(tp, _t(x)).numpy())


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("act_bits", [4, 8])
def test_dense_route3_matches(packed, act_bits):
    """Route 3 (integer accumulation) against the reference's route 3.

    Its activation quant is the compiled reference's
    (``quantizers.quantize_dynamic``: the range times the f32 reciprocal
    of the level count). On the port's transformed activation its codes,
    scales and zero points equal those of ``jax.jit`` of the reference's
    ``quantize`` bitwise on every row; with the transform taken out
    (``Identity`` in both packages) the route's output equals
    ``jax.jit(jq.dense)``'s bitwise on every row, since XLA-CPU rounds the
    f32 epilogue s·sw·(acc − zp·colsum) op by op, as torch does. With the
    CAT transform the two packages' transform dots associate their f32
    sums differently (XLA-CPU's ``jnp.dot``, see
    ``test_torch_kernels.test_dot_association``), so the whole route is
    held against the eager reference at rtol 1e-5 on the rows whose codes
    agree."""
    jp, tp = _qlinear_pair(packed, act_bits, seed=1)
    x = np.random.default_rng(8).standard_normal((9, 64)).astype(np.float32)
    js = jq.make_serving(jp, keep_packed=True)
    ts = tq.make_serving(tp, keep_packed=True)
    assert ts.w_eff is None and js.w_eff is None
    np.testing.assert_array_equal(ts.colsum.numpy(), np.asarray(js.colsum))
    # the whole route, CAT transform included, against the eager reference
    want = np.asarray(jq.dense(js, jnp.asarray(x)))
    got = tq.dense(ts, _t(x)).numpy()
    xt = tT.apply(tp.transform, _t(x))
    jcodes = np.asarray(jqz.quantize(jT.apply(jp.transform, jnp.asarray(x)),
                                     jqz.act_spec(act_bits))[0])
    tcodes = tqz.quantize_dynamic(xt, tqz.act_spec(act_bits))[0].numpy()
    same = (jcodes == tcodes).all(axis=1)
    assert same.mean() >= 1 - 1e-3 or same.sum() >= len(same) - 1
    np.testing.assert_allclose(got[same], want[same], rtol=1e-5, atol=1e-5)
    # the act quant against the compiled reference's, bitwise, every row
    jit_quant = jax.jit(lambda v: jqz.quantize(v, jqz.act_spec(act_bits)))
    for mine, ref_v in zip(tqz.quantize_dynamic(xt, tqz.act_spec(act_bits)),
                           jit_quant(jnp.asarray(xt.numpy()))):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(ref_v))
    # the route without the transform against jax.jit(jq.dense), bitwise
    js_id = dataclasses.replace(js, transform=jT.Identity())
    ts_id = dataclasses.replace(ts, transform=tT.Identity())
    np.testing.assert_array_equal(
        tq.dense(ts_id, xt).numpy(),
        np.asarray(jax.jit(jq.dense)(js_id, jnp.asarray(xt.numpy()))))


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("act_bits", [4, 8])
def test_dense_route3_bf16_matches_jitted_reference(packed, act_bits):
    """Route 3 with bf16 activations against ``jax.jit`` of the
    reference's ``dense_fused``, bitwise, at the shapes of
    ``test_dense_route3_matches``. The transform is ``Identity``, which
    the fused kernel does not decompose, in both packages (so no
    transform dot enters). XLA computes the epilogue
    s·sw·(acc − zp·colsum) in f32 with the act scale unrounded (it drops
    the scale's round trip through bf16) and rounds once to bf16; the
    port does the same (``quantizers.quantize_dynamic``)."""
    jp, tp = _qlinear_pair(packed, act_bits, seed=1)
    js = dataclasses.replace(jq.make_serving(jp, keep_packed=True),
                             transform=jT.Identity())
    ts = dataclasses.replace(tq.make_serving(tp, keep_packed=True),
                             transform=tT.Identity())
    assert ts.w_eff is None
    x = np.random.default_rng(8).standard_normal((9, 64)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = tq.dense_fused(ts, xb)
    want = np.asarray(jax.jit(jq.dense_fused)(
        js, jnp.asarray(x).astype(jnp.bfloat16)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  want.astype(np.float32))


def test_make_serving_and_concat_match():
    jps, tps = zip(*(_qlinear_pair(True, seed=s) for s in (0, 0, 0)))
    jc = jq.concat_out(list(jps), keep_packed=False)
    tc = tq.concat_out(list(tps), keep_packed=False)
    np.testing.assert_array_equal(tc.qweight.numpy(), np.asarray(jc.qweight))
    np.testing.assert_array_equal(tc.colsum.numpy(), np.asarray(jc.colsum))
    np.testing.assert_array_equal(tc.w_eff.numpy(), np.asarray(jc.w_eff))
    assert (tc.act_bits, tc.w_bits, tc.d_in) == (jc.act_bits, jc.w_bits,
                                                 jc.d_in)


def test_from_reference_converts_layers():
    """Layer-stacked reference params become a list of per-layer dicts,
    QLinear meta and transform classes carried across."""
    jp, _ = _qlinear_pair(True)
    stacked = jq.QLinear(jnp.stack([jp.qweight] * 2),
                         jnp.stack([jp.scale] * 2),
                         jT.Compose(tuple(
                             dataclasses.replace(part, **{
                                 f.name: jnp.stack([getattr(part, f.name)] * 2)
                                 for f in dataclasses.fields(part)})
                             for part in jp.transform.parts)),
                         act_bits=4, w_bits=4, d_in=64)
    tree = {"embed": jnp.ones((5, 4), jnp.bfloat16),
            "layers": {"ln1": jnp.zeros((2, 4)), "wqkv": stacked}}
    out = from_reference(tree)
    assert out["embed"].dtype == torch.bfloat16
    assert len(out["layers"]) == 2
    lin = out["layers"][1]["wqkv"]
    assert isinstance(lin, tq.QLinear) and lin.packed and lin.d_in == 64
    assert isinstance(lin.transform.parts[0], tT.BlockDiag)
    np.testing.assert_array_equal(lin.qweight.numpy(),
                                  np.asarray(jp.qweight))


# ----------------------------------------------------------- import rule

def test_port_imports_neither_jax_nor_reference():
    """No module of repro_torch, and not chip_smoke.py, imports jax or the
    reference package."""
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    bad = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b"
                     r"(?!_torch)|from\s+repro\b(?!_torch))", re.M)
    found = {str(f.relative_to(ROOT)): bad.findall(f.read_text())
             for f in files}
    assert len(files) > 20
    assert not {k: v for k, v in found.items() if v}, found
