"""The paged attentions (rows 3 and 4) at every head dim they take, on the
CPU: their plans, their wrappers' launches, their plain versions against
the JAX reference's Pallas kernels, and the engine at paligemma-3b's
heads against the live JAX engine.

Both kernels take every head dim that is a multiple of 8 from 8 to 256
(``csrc/attention_plan.h``, ``padded_hd``): each is built at 32, 64, 128
or 256 and carries the real head dim at run time, the query's dims past
it zero. The header is compiled here with the host's C++ compiler, as
``test_torch_attention.py`` does, and read through the same Python
functions as on the card. Held: every position of every item (decode
splits) and every query row (ragged tiles) owned once at the new head
dims; shared memory within the card's 227 KiB at g 1, 2, 4 and 8 for
every head dim taken; the decode split a function of the table's width
and the head shape only (at hd 256 and g 8 its layout fits 4 splits,
not 8), never of the batch; every other head dim refused with "does not
take", by the plans and by the launch.

The plain versions (the CPU path of both wrappers, and what
``chip_smoke.py`` holds the kernels against on the card) are held
against the reference kernels in interpret mode at paligemma-3b's heads
(1 KV head of 256, 8 query heads), at 4 KV heads of 112 (1 each) and at
a padded width (40: built at 64): f32 queries at rtol 1e-5 (atol 1e-5 of
the output's scale), bf16 queries within one bf16 ulp with at least 99 %
bitwise, as ``test_torch_attention.py`` holds the other widths, but for
outputs near zero, which are held at the f32 check's atol (``_hold``).

The port's engine at paligemma-3b's head geometry (its ``smoke()`` depth
and width, then 8 query heads of 256 on 1 KV head, f32 weights, int8
KV) with ``paged_kernel=True`` on both schedules serves the same tokens
as the live JAX engine, whose paged kernels run in interpret mode. The
weights are the reference's seeded fp ones: CAT-W4A4 at these heads puts
one request's first token on a tie that the order of wo's f32
contraction over its 2048 inputs decides (MKL's at one thread against
XLA's), on every attention path alike, the slot cache's too, so it
would test that order and not the paged attentions.
"""
import ctypes
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.data import request_workload
from repro.kernels.paged_attention import paged_attention_decode as j_decode
from repro.kernels.paged_attention import paged_attention_ragged as j_ragged
from repro.launch.engine import ServeEngine as JEngine
from repro.models import build as j_build
from repro_torch import configs as tconfigs
from repro_torch.convert import from_reference
from repro_torch.kernels import build
from repro_torch.kernels import paged_attention as P
from repro_torch.launch.engine import ServeEngine
from repro_torch.models import build as t_build
from test_torch_attention import (SMEM_OPTIN, SMS, _bf16_ulps, _FakeLib,
                                  _pool, _ragged_case, _t, plan_lib)

torch.set_num_threads(1)

TAKEN = tuple(range(8, 257, 8))
# (KV heads, query heads per KV head, head dim): paligemma-3b's, 112 dims
# at 4 KV heads of 1, and a padded width
HEADS = [(1, 8, 256), (4, 1, 112), (2, 2, 40)]


@pytest.mark.parametrize("g", [1, 2, 4, 8])
def test_plans_take_every_multiple_of_8_and_fit(plan_lib, g):
    """At every head dim taken, both plans fit the card's 227 KiB (decode
    at every forced split its layout fits and at the plan's own), and the
    decode split at a long table is 8 but where 8 splits' states do not
    fit (hd above 128 at g 8: 4), at any batch."""
    for hd in TAKEN:
        for b in (1, 8, 40):
            own = P.decode_plan(b, 1, g, hd, 16, 128, SMS, SMEM_OPTIN,
                                lib=plan_lib)
            assert own.smem <= SMEM_OPTIN
            assert own.split == (4 if hd > 128 and g == 8 else 8)
        assert P.decode_plan(8, 1, g, hd, 16, 4, SMS, SMEM_OPTIN,
                             lib=plan_lib).split == 1
        rag = P.ragged_plan(8, 128, 1, g, hd, 16, SMEM_OPTIN, lib=plan_lib)
        assert rag.smem <= SMEM_OPTIN
        assert rag.ctas == 8 * rag.tiles == 8 * -(-128 * g // 64)


def test_plans_keep_their_shape_at_the_parent_widths(plan_lib):
    """A head dim padded to 32, 64 or 128 takes the plan of that width:
    the same splits, CTAs and shared memory (the layouts are the padded
    width's)."""
    for hd in TAKEN:
        hp = 32 if hd <= 32 else 64 if hd <= 64 else 128 if hd <= 128 \
            else 256
        for g in (1, 2, 8):
            assert (P.decode_plan(8, 2, g, hd, 16, 64, SMS, SMEM_OPTIN,
                                  lib=plan_lib)
                    == P.decode_plan(8, 2, g, hp, 16, 64, SMS, SMEM_OPTIN,
                                     lib=plan_lib))
            assert (P.ragged_plan(8, 40, 2, g, hd, 16, SMEM_OPTIN,
                                  lib=plan_lib)
                    == P.ragged_plan(8, 40, 2, g, hp, 16, SMEM_OPTIN,
                                     lib=plan_lib))


@pytest.mark.parametrize("hd", [256, 112, 40, 8])
def test_plans_own_every_row_and_position_once(plan_lib, hd):
    """At the new head dims: the decode splits tile [0, length) in rank
    order (pages unshared), and the ragged tiles own every query row once,
    at paligemma's group of 8 and at 1 and 3."""
    for g in (1, 3, 8):
        split = P.decode_plan(1, 1, g, hd, 16, 128, SMS, SMEM_OPTIN,
                              lib=plan_lib).split
        for length in range(0, 128 * 16 + 1, 97):
            owned = np.zeros(length, int)
            for rank in range(split):
                rng = P.split_range(length, 16, split, rank, lib=plan_lib)
                owned[rng.start:rng.stop] += 1
                assert rng.start % 16 == 0 or len(rng) == 0
            assert (owned == 1).all()
        for nq in (1, 7, 33, 128):
            plan = P.ragged_plan(4, nq, 1, g, hd, 16, SMEM_OPTIN,
                                 lib=plan_lib)
            rows = np.zeros(nq * g, int)
            for tile in range(plan.tiles):
                rows[list(P.ragged_rows(nq, g, tile, lib=plan_lib))] += 1
            assert (rows == 1).all()


def test_plans_refuse_every_other_head_dim(plan_lib):
    for hd in [h for h in range(0, 300) if h not in TAKEN]:
        with pytest.raises(ValueError, match="does not take"):
            P.decode_plan(8, 1, 8, hd, 16, 10, SMS, SMEM_OPTIN,
                          lib=plan_lib)
        with pytest.raises(ValueError, match="does not take"):
            P.ragged_plan(8, 128, 1, 8, hd, 16, SMEM_OPTIN, lib=plan_lib)


class _RefusingLib:
    """A library whose launches refuse every shape (as the C entries do
    for a head dim their plan does not take) and whose plans are the
    header's."""

    def __init__(self, plan_lib):
        self.plan_lib, self.calls = plan_lib, []

    def __getattr__(self, name):
        if name.startswith("pa_"):
            return getattr(self.plan_lib, name)

        def fn(*args):
            self.calls.append(name)
            return 1   # cudaErrorInvalidValue
        return fn


@pytest.mark.parametrize("hd", [20, 264])
def test_launches_refuse_a_head_dim_not_taken(plan_lib, monkeypatch, hd):
    """On the card a head dim not taken raises ValueError ("does not
    take") from the launch; no other path runs."""
    lib = _RefusingLib(plan_lib)
    monkeypatch.setattr(build, "load", lambda name, sigs: lib)
    monkeypatch.setattr(build, "stream_of", lambda t: ctypes.c_void_p(0))
    monkeypatch.setattr(build, "sm_count", lambda device: SMS)
    dec = [_t(a) for a in _pool(0, 2, 1, 8, hd, 16, 2, (17, 5))]
    with pytest.raises(ValueError, match="does not take"):
        P._launch_decode(*dec)
    rag = [_t(a) for a in _ragged_case(1, [(3, 9), (1, 17)], 5, 1, 8, hd,
                                       16)]
    with pytest.raises(ValueError, match="does not take"):
        P._launch_ragged(*rag)
    assert lib.calls == ["paged_attention_decode", "paged_attention_ragged"]


@pytest.mark.parametrize("kvh,g,hd", HEADS)
def test_wrappers_pass_the_head_dim(monkeypatch, kvh, g, hd):
    """Both launches pass the real head dim and its hd^-1/2 in the order
    of the C prototypes."""
    lib = _FakeLib()
    monkeypatch.setattr(build, "load", lambda name, sigs: lib)
    monkeypatch.setattr(build, "stream_of", lambda t: ctypes.c_void_p(0))
    monkeypatch.setattr(build, "sm_count", lambda device: SMS)
    P._launch_decode(*[_t(a) for a in _pool(2, 2, kvh, g, hd, 16, 3,
                                            (40, 7))])
    P._launch_ragged(*[_t(a) for a in _ragged_case(
        3, [(3, 9), (1, 17)], 5, kvh, g, hd, 16)])
    (dn, dargs), (rn, rargs) = lib.calls
    assert dn == "paged_attention_decode" and rn == "paged_attention_ragged"
    assert dargs[9:14] == (2, kvh, g, hd, 16)
    assert rargs[10:16] == (2, 5, kvh, g, hd, 16)
    for q_scale in (dargs[14], rargs[16]):
        assert q_scale == pytest.approx(hd ** -0.5)


def _hold(run_j, run_t, args, valid):
    """f32 queries at rtol 1e-5 (atol 1e-5 of the output's scale); bf16
    queries at least 99 % bitwise, each output within one bf16 ulp of
    the reference's or within that same atol of it, on the valid rows.
    (An output a thousandth of the scale or less is the cancellation of
    terms of the scale's size: the f32 dots and sums in the two
    packages' orders differ there by up to a few 1e-6 of the scale, which
    is many of its own ulps. On these grids of up to 55,000 outputs such
    values occur; at hd 256 and g 8 on the edge items, pages of 8, one
    output 2.5e-5 of the scale differs by 30 ulps. The smaller grids of
    ``test_torch_attention.py`` hold no such value.)"""
    want = np.asarray(run_j(*map(jnp.asarray, args)))
    got = run_t(*map(_t, args)).numpy()
    np.testing.assert_allclose(got[valid], want[valid], rtol=1e-5,
                               atol=1e-5 * np.abs(want[valid]).max())
    jq = jnp.asarray(args[0]).astype(jnp.bfloat16)
    want = np.asarray(run_j(jq, *map(jnp.asarray, args[1:]))
                      .astype(jnp.float32))
    tq = _t(np.asarray(jq.astype(jnp.float32))).to(torch.bfloat16)
    got = run_t(tq, *map(_t, args[1:])).float().numpy()
    ulps = _bf16_ulps(got[valid], want[valid])
    near = np.abs(got[valid] - want[valid]) <= 1e-5 * np.abs(
        want[valid]).max()
    assert ((ulps <= 1).numpy() | near).all()
    assert (ulps == 0).float().mean() >= 0.99


@pytest.mark.parametrize("kvh,g,hd", HEADS)
def test_plain_decode_matches_pallas_at_head_dims(kvh, g, hd):
    """Row 4's plain version at lengths over up to five pages of 16,
    length 1 and a page's edge among them."""
    lengths = (80, 1, 17, 16, 33, 64)
    args = _pool(hd + g, len(lengths), kvh, g, hd, 16, 5, lengths)
    _hold(lambda *a: j_decode(*a, interpret=True),
          P.paged_attention_decode, args, slice(None))


@pytest.mark.parametrize("ps", [8, 16])
@pytest.mark.parametrize("kvh,g,hd", HEADS)
def test_plain_ragged_matches_pallas_at_head_dims(kvh, g, hd, ps):
    """Row 3's plain version at the card's edge items
    (``test_torch_attention.py``'s): mixed decode and prefill items,
    q_pos at ps - 1, ps, ps + 1, a prefill chunk ending past a page, an
    item of length 0 and padding rows, pages of 8 and 16."""
    items = [(1, ps), (ps + 2, ps + 2), (1, ps + 1), (0, 0),
             (5, 3 * ps + 5), (1, ps + 2), (1, 1)]
    args = _ragged_case(hd * 10 + g + ps, items, ps + 5, kvh, g, hd, ps)
    _hold(lambda *a: j_ragged(*a, interpret=True),
          P.paged_attention_ragged, args, args[-1] >= 0)


SCHEDULES = {
    "unified": dict(schedule="unified", pipeline=False, page_size=8,
                    max_batch_tokens=16, paged_kernel=True),
    "legacy": dict(schedule="legacy", paged=True, page_size=8,
                   paged_kernel=True),
}


@pytest.fixture(scope="module")
def paligemma_heads():
    """paligemma-3b at ``smoke()`` depth and width with its heads (8 query
    heads of 256 on 1 KV head), f32, int8 KV, the reference's ``init`` at
    PRNGKey(0)."""
    cfg = j_get_config("paligemma_3b").smoke().scaled(
        dtype="float32", n_heads=8, n_kv_heads=1, head_dim=256,
        kv_quant_bits=8)
    return cfg, j_build(cfg).init(jax.random.PRNGKey(0))


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_engine_at_paligemma_heads_equals_live_jax(paligemma_heads,
                                                   schedule):
    """The family tests' workload (3 requests of 18, 20 and 24 tokens, 6
    new each), tokens exactly equal."""
    cfg, params = paligemma_heads
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim) == (8, 1, 256)
    reqs = request_workload(cfg, 3, gen=6, lengths=(18, 20, 24), seed=0)
    kw = dict(n_slots=2, max_len=40, **SCHEDULES[schedule])
    jres = JEngine(j_build(cfg), params, **kw).run(reqs)
    tcfg = tconfigs.ArchConfig(**dataclasses.asdict(cfg))
    teng = ServeEngine(t_build(tcfg), from_reference(params), device="cpu",
                       **kw)
    calls = {"decode": 0, "ragged": 0}
    real = {"decode": P.paged_attention_decode_plain,
            "ragged": P.paged_attention_ragged_plain}

    def counted(name):
        def fn(*a):
            calls[name] += 1
            return real[name](*a)
        return fn
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(P, "paged_attention_decode_plain", counted("decode"))
        mp.setattr(P, "paged_attention_ragged_plain", counted("ragged"))
        tres = teng.run(reqs)
    for r in reqs:
        assert len(tres[r["rid"]].tokens) == len(r["tokens"]) + 6
        np.testing.assert_array_equal(tres[r["rid"]].tokens,
                                      jres[r["rid"]].tokens,
                                      err_msg=f"{schedule} rid={r['rid']}")
    # the paged attentions served the steps (the legacy schedule's
    # prefill attends on its gathered path, as the reference's)
    assert calls["decode"] > 0
    assert calls["ragged"] > 0 or schedule == "legacy"
