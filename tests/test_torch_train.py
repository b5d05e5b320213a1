"""The port's optimizer and trainer against the reference's, on the CPU.

The model is ``catlm_60m().smoke()`` in f32 (2 layers, d 128, vocab 512)
with the reference's seeded params converted by ``from_reference``, and
batches from ``make_batch(seed, step)``. Tolerances, and why:

- ``warmup_cosine`` at steps 0..130: rtol 1e-6 (XLA's and torch's f32
  ``cos`` may differ by an ulp);
- two AdamW updates on the same grads: params, ``m`` and ``v`` at rtol
  1e-6 with atol 1e-6 of the leaf's largest magnitude: the clip's global
  norm sums the leaves in another order (the reference over layer-stacked
  leaves), which moves the clip scale by ulps, and ``p - lr u`` cancels
  near zero;
- ``jax.value_and_grad(model.loss)`` against autograd: the loss at rtol
  1e-5, each gradient leaf at rtol 1e-4 with atol 1e-5 of the leaf's
  largest |g| (f32 dots and reductions associate differently; the
  embedding's gradient is a scatter-add there and a one-hot GEMM here);
- five AdamW steps: every loss at rtol 1e-4;
- ``AdamWMaster`` on bf16 params (bf16 compute): three steps' losses at
  rtol 2e-2, since XLA and torch round bf16 intermediates at different
  places; the master copy stays f32 and the params are its bf16 cast
  (checked exactly);
- a run that fails at step 7 and resumes from its step-5 checkpoint
  equals the uninterrupted run bitwise (losses and final params);
- the CLI trains on the CPU, and the reference restores its checkpoint;
- ``mesh`` is refused, as is ``surviving_mesh``.

Every file is written under ``tmp_path``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as j_ck
from repro.configs import get_config as j_get_config
from repro.data import make_batch
from repro.models import build as j_build
from repro.optim import optimizer as j_opt
from repro_torch import checkpoint as t_ck
from repro_torch import configs as tconfigs
from repro_torch.convert import from_reference
from repro_torch.distributed import fault_tolerance as ft
from repro_torch.launch import train as t_train
from repro_torch.models import build as t_build
from repro_torch.optim import optimizer as t_opt

torch.set_num_threads(1)

SEQ, BATCH = 32, 2


@pytest.fixture(scope="module")
def setup():
    cfg = j_get_config("catlm_60m").smoke().scaled(dtype="float32")
    jmodel = j_build(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = t_build(tconfigs.ArchConfig(**dataclasses.asdict(cfg)))
    return cfg, jmodel, jparams, tmodel


def _batch(cfg, step):
    return make_batch(cfg, SEQ, BATCH, seed=0, step=step)


def _close(tree_t, tree_j, rtol, atol_of=lambda a: 0.0):
    got = t_opt.tree_leaves(tree_t)
    want = t_opt.tree_leaves(from_reference(tree_j))
    assert len(got) == len(want) and got
    for g, w in zip(got, want):
        w = w.to(g.dtype)
        torch.testing.assert_close(g, w, rtol=rtol, atol=atol_of(w))


def test_warmup_cosine_matches_the_reference():
    j, t = j_opt.warmup_cosine(1e-3, 10, 120), t_opt.warmup_cosine(
        1e-3, 10, 120)
    steps = np.arange(0, 131)
    want = np.asarray(jax.vmap(j)(jnp.asarray(steps)))
    got = np.array([float(t(int(s))) for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_adamw_updates_match_the_reference(setup):
    _, _, jparams, _ = setup
    rng = np.random.default_rng(1)
    jgrads = jax.tree.map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape) * 3, p.dtype),
        jparams)
    jo = j_opt.AdamW(lr=j_opt.warmup_cosine(1e-3, 2, 10))
    to = t_opt.AdamW(lr=t_opt.warmup_cosine(1e-3, 2, 10))
    jstate = jo.init(jparams)
    tparams, tstate = from_reference(jparams), to.init(from_reference(jparams))
    for _ in range(2):
        jparams_n, jstate = jo.update(jparams, jgrads, jstate)
        tparams_n, tstate = to.update(tparams, from_reference(jgrads),
                                      tstate)
        scale = lambda w: 1e-6 * float(w.abs().max())  # noqa: E731
        _close(tparams_n, jparams_n, 1e-6, scale)
        _close(tstate["m"], jstate["m"], 1e-6, scale)
        _close(tstate["v"], jstate["v"], 1e-6, scale)
        assert int(tstate["step"]) == int(jstate["step"])
        assert tstate["step"].dtype == torch.int32
        jparams, tparams = jparams_n, tparams_n


def test_value_and_grad_matches_jax(setup):
    cfg, jmodel, jparams, tmodel = setup
    b = _batch(cfg, 0)
    (jl, jm), jg = jax.value_and_grad(jmodel.loss, has_aux=True)(
        jparams, {k: jnp.asarray(v) for k, v in b.items()})
    (tl, tm), tg = t_train.value_and_grad(
        lambda p: tmodel.loss(p, b), from_reference(jparams))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tm["ce"]), float(jm["ce"]), rtol=1e-5)
    _close(tg, jg, 1e-4, lambda w: 1e-5 * float(w.abs().max()))


def _reference_losses(jmodel, params, opt, steps, cfg):
    state = opt.init(params)

    @jax.jit
    def step_fn(p, s, batch):
        (l, _), g = jax.value_and_grad(jmodel.loss, has_aux=True)(p, batch)
        p, s = opt.update(p, g, s)
        return p, s, l

    out = []
    for step in range(steps):
        batch = {k: jnp.asarray(v) for k, v in _batch(cfg, step).items()}
        params, state, loss = step_fn(params, state, batch)
        out.append(float(loss))
    return out, params, state


def _port_losses(tmodel, params, opt, steps, cfg):
    state = opt.init(params)
    step_fn = t_train.make_train_step(tmodel, opt)
    out = []
    for step in range(steps):
        params, state, m = step_fn(params, state, _batch(cfg, step))
        out.append(float(m["loss"]))
    return out, params, state


def test_five_steps_match_jax_training(setup):
    cfg, jmodel, jparams, tmodel = setup
    want, _, _ = _reference_losses(
        jmodel, jparams, j_opt.AdamW(lr=j_opt.warmup_cosine(1e-3, 2, 5)),
        5, cfg)
    got, _, _ = _port_losses(
        tmodel, from_reference(jparams),
        t_opt.AdamW(lr=t_opt.warmup_cosine(1e-3, 2, 5)), 5, cfg)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]


def test_adamw_master_bf16_matches_jax_at_bf16_bound(setup):
    cfg, _, jparams, _ = setup
    bcfg = cfg.scaled(dtype="bfloat16")
    jmodel = j_build(bcfg)
    tmodel = t_build(tconfigs.ArchConfig(**dataclasses.asdict(bcfg)))
    jb = j_opt.cast_params(jparams, jnp.bfloat16)
    want, _, _ = _reference_losses(
        jmodel, jb, j_opt.AdamWMaster(lr=j_opt.warmup_cosine(1e-3, 2, 3)),
        3, cfg)
    tb = t_opt.cast_params(from_reference(jparams), torch.bfloat16)
    got, params, state = _port_losses(
        tmodel, tb, t_opt.AdamWMaster(lr=t_opt.warmup_cosine(1e-3, 2, 3)),
        3, cfg)
    np.testing.assert_allclose(got, want, rtol=2e-2)
    for p, mast in zip(t_opt.tree_leaves(params),
                       t_opt.tree_leaves(state["master"])):
        assert p.dtype == torch.bfloat16 and mast.dtype == torch.float32
        assert torch.equal(p, mast.to(torch.bfloat16))


def test_resumed_run_equals_uninterrupted(tmp_path):
    kw = dict(steps=12, batch=BATCH, seq=SEQ, lr=1e-3, ckpt_every=5,
              device="cpu", log_every=0)
    a_dir, b_dir = str(tmp_path / "a"), str(tmp_path / "b")
    final_a, losses_a = t_train.train(ckpt_dir=a_dir, **kw)
    final_b, losses_b = t_train.train(ckpt_dir=b_dir, fail_at=(7,), **kw)
    assert final_a == final_b == 12
    # the failed attempt ran steps 0..6, the resumed one 5..11
    assert len(losses_a) == 12 and len(losses_b) == 7 + 7
    assert losses_b[:7] == losses_a[:7]
    assert losses_b[7:] == losses_a[5:]
    model = t_build(tconfigs.get_config("catlm_60m").smoke())
    like = model.init(torch.Generator().manual_seed(0))
    like_state = t_opt.AdamW().init(like)
    a = t_ck.restore(a_dir, None, like, like_state, device="cpu")
    b = t_ck.restore(b_dir, None, like, like_state, device="cpu")
    assert a["step"] == b["step"] == 12
    for x, y in zip(t_opt.tree_leaves([a["params"], a["opt_state"]]),
                    t_opt.tree_leaves([b["params"], b["opt_state"]])):
        assert torch.equal(x, y)


def test_cli_trains_on_the_cpu(tmp_path, capsys):
    d = str(tmp_path / "ck")
    t_train.main(["--device", "cpu", "--steps", "3", "--batch", "2",
                  "--seq", "16", "--ckpt-dir", d, "--ckpt-every", "2"])
    assert "finished at step 3" in capsys.readouterr().out
    assert t_ck.latest_step(d) == 3
    cfg = j_get_config("catlm_60m").smoke()
    like = j_build(cfg).init(jax.random.PRNGKey(0))
    out = j_ck.restore(d, None, like, j_opt.AdamW().init(like))
    assert int(out["opt_state"]["step"]) == 3
    assert out["meta"]["arch"] == "catlm_60m"


def test_mesh_is_refused():
    with pytest.raises(NotImplementedError, match="tensor-parallel"):
        t_train.train(steps=1, device="cpu", mesh=object())
    with pytest.raises(NotImplementedError, match="tensor-parallel"):
        t_train.make_train_step(None, None, mesh=object())
    with pytest.raises(NotImplementedError, match="tensor-parallel"):
        ft.surviving_mesh()
