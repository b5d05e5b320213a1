"""The port's checkpoints against the reference's, on the CPU.

Both packages write the same layout (``step_XXXXXXXX/manifest.json`` and
npz groups, bf16 as raw bytes, layers stacked on a leading axis), so each
restores the other's. Everything compares bitwise:

- the reference's CAT-W4A4 checkpoint (the ``w4_packed`` golden case:
  int4-packed QLinears with block-CAT and Hadamard transforms) restores
  into the port equal to ``from_reference`` of the same params, and the
  port's save of those params writes the reference's manifest (keys in
  order, shapes, dtypes, ``packed_int4`` and ``packed_int4_layers``) and
  restores into the reference equal to its own params;
- an f32 model and its AdamW state (``m``, ``v``, int32 ``step``) after one
  reference update cross both ways; bf16 params (``cast_params``) too, as
  raw bytes under the dtype string ``bfloat16``;
- a restored CAT-W4A4 model serves the same tokens in f32 as the params
  it was saved from (the port's engine);
- ``latest_step`` and ``prune_old`` leave the same steps as the
  reference's on the same directories.

Every file is written under ``tmp_path``.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden import regenerate

from repro import checkpoint as j_ck
from repro.data import request_workload
from repro.optim import optimizer as j_opt
from repro_torch import checkpoint as t_ck
from repro_torch import configs as tconfigs
from repro_torch.convert import from_reference
from repro_torch.core.qlinear import QLinear
from repro_torch.launch.engine import ServeEngine
from repro_torch.models import build as t_build
from repro_torch.optim import optimizer as t_opt

torch.set_num_threads(1)


def _leaves(tree):
    """The port tree's tensors in a fixed walk (QLinear and transform
    fields by name)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    if dataclasses.is_dataclass(tree):
        return [x for f in dataclasses.fields(tree)
                for x in _leaves(getattr(tree, f.name))]
    return []


def _same(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb) and la
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.reshape(-1).view(torch.uint8),
                           y.reshape(-1).view(torch.uint8))


def _same_jax(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert jax.tree.structure(a) == jax.tree.structure(b) and la
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(
            np.asarray(x).reshape(-1).view(np.uint8),
            np.asarray(y).reshape(-1).view(np.uint8))


def _manifest(d, step):
    with open(os.path.join(d, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def w4():
    cfg, _, params = regenerate.build_case("w4_packed")
    return cfg, params


@pytest.fixture(scope="module")
def fp_and_state():
    """An f32 smoke model and its AdamW state after one reference update
    on seeded grads."""
    cfg, _, params = regenerate.build_case("int8_kv")
    opt = j_opt.AdamW(lr=j_opt.warmup_cosine(1e-3, 2, 10))
    state = opt.init(params)
    rng = np.random.default_rng(3)
    grads = jax.tree.map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape), p.dtype),
        params)
    params, state = opt.update(params, grads, state)
    return params, state


def test_reference_w4_checkpoint_restores_into_the_port(tmp_path, w4):
    _, params = w4
    j_ck.save(str(tmp_path), 5, params, meta={"quant": "w4a4-cat"})
    like = from_reference(params)
    out = t_ck.restore(str(tmp_path), None, like, device="cpu")
    assert out["step"] == 5 and out["meta"]["quant"] == "w4a4-cat"
    _same(out["params"], like)
    ql = out["params"]["layers"][1]["wq"]
    assert isinstance(ql, QLinear) and ql.packed and ql.act_bits == 4


def test_port_w4_checkpoint_is_the_reference_layout(tmp_path, w4):
    _, params = w4
    jd, td = str(tmp_path / "j"), str(tmp_path / "t")
    os.makedirs(jd)
    j_ck.save(jd, 7, params, meta={"quant": "w4a4-cat"})
    t_ck.save(td, 7, from_reference(params), meta={"quant": "w4a4-cat"})
    jm, tm = _manifest(jd, 7), _manifest(td, 7)
    assert list(tm["groups"]["params"]) == list(jm["groups"]["params"])
    assert tm == jm
    assert tm["meta"]["packed_int4"] is True
    out = j_ck.restore(td, 7, params)
    _same_jax(out["params"], params)


def test_opt_state_crosses_both_ways(tmp_path, fp_and_state):
    params, state = fp_and_state
    tparams, tstate = from_reference(params), from_reference(state)
    jd, td = str(tmp_path / "j"), str(tmp_path / "t")
    os.makedirs(jd)
    j_ck.save(jd, 1, params, state)
    like_state = t_opt.AdamW().init(tparams)
    out = t_ck.restore(jd, 1, tparams, like_state, device="cpu")
    _same(out["params"], tparams)
    _same(out["opt_state"], tstate)
    assert out["opt_state"]["step"].dtype == torch.int32
    assert int(out["opt_state"]["step"]) == 1
    t_ck.save(td, 1, tparams, tstate)
    assert _manifest(td, 1) == _manifest(jd, 1)
    back = j_ck.restore(td, 1, params, state)
    _same_jax(back["params"], params)
    _same_jax(back["opt_state"], state)


def test_bf16_params_round_trip(tmp_path, fp_and_state):
    params, _ = fp_and_state
    jb = j_opt.cast_params(params, jnp.bfloat16)
    tb = from_reference(jb)
    assert tb["embed"].dtype == torch.bfloat16
    jd, td = str(tmp_path / "j"), str(tmp_path / "t")
    os.makedirs(jd)
    j_ck.save(jd, 2, jb)
    t_ck.save(td, 2, tb)
    assert _manifest(td, 2) == _manifest(jd, 2)
    assert _manifest(td, 2)["groups"]["params"]["embed"]["dtype"] == \
        "bfloat16"
    _same(t_ck.restore(td, 2, tb, device="cpu")["params"], tb)
    _same(t_ck.restore(jd, 2, tb, device="cpu")["params"], tb)
    _same_jax(j_ck.restore(td, 2, jb)["params"], jb)


def test_restored_w4_model_serves_the_same_tokens(tmp_path, w4):
    cfg, params = w4
    cfg = cfg.scaled(dtype="float32")
    tcfg = tconfigs.ArchConfig(**dataclasses.asdict(cfg))
    model = t_build(tcfg)
    tparams = from_reference(params)
    t_ck.save(str(tmp_path), 3, tparams)
    restored = t_ck.restore(str(tmp_path), 3, tparams, device="cpu")

    def serve(p):
        eng = ServeEngine(model, p, n_slots=regenerate.N_SLOTS,
                          max_len=regenerate.MAX_LEN, device="cpu")
        reqs = request_workload(cfg, regenerate.N_REQUESTS,
                                gen=regenerate.GEN,
                                lengths=regenerate.LENGTHS,
                                seed=regenerate.SEED)
        res = eng.run(reqs)
        return {r["rid"]: res[r["rid"]].tokens.tolist() for r in reqs}
    assert serve(restored["params"]) == serve(tparams)


def test_latest_step_and_prune_old_match_the_reference(tmp_path):
    tree_j = {"w": jnp.arange(4, dtype=jnp.float32)}
    tree_t = {"w": torch.arange(4, dtype=torch.float32)}
    jd, td = str(tmp_path / "j"), str(tmp_path / "t")
    os.makedirs(jd)
    assert t_ck.latest_step(td) is None and j_ck.latest_step(td) is None
    for step in (3, 10, 7, 1):
        j_ck.save(jd, step, tree_j)
        t_ck.save(td, step, tree_t)
    for d in (jd, td):
        assert t_ck.latest_step(d) == j_ck.latest_step(d) == 10
    j_ck.prune_old(jd, keep=2)
    t_ck.prune_old(td, keep=2)
    assert sorted(os.listdir(jd)) == sorted(os.listdir(td)) == [
        "step_00000007", "step_00000010"]
    with pytest.raises(FileNotFoundError):
        t_ck.restore(str(tmp_path / "none"), None, tree_t, device="cpu")
