"""The port's two-launch decode against the JAX reference, on the CPU.

- ``kernels.decode_layer.decode_qkv_prologue`` (the plain version on CPU
  tensors) against the reference's Pallas kernel in interpret mode and its
  eager oracle ``ref.decode_qkv_prologue``, over the cases of
  ``tests/test_decode_layer.py``: packed and unpacked weights, with and
  without the block-CAT stage, B in {1, 3, 8}, a ragged last page, rows
  straddling a page boundary and an explicit null-page target.
  Every case is held against both. Tolerances: q at rtol 1e-5 (atol
  1e-6), since the kernel and the oracle associate the f32 transform dots
  differently from the port's plain version; int8 KV codes bitwise on
  pages >= 1; KV scales at rtol 1e-5 (atol 1e-8), since they follow the
  k and v values those dots give. The port's activation quant is the
  compiled kernel's (scale by the f32 reciprocal of the level count, zp
  and codes by division), and the eager oracle's division by the level
  count moves no code of these cases. Page 0 is the null page, outside
  the pool contract, and is not compared.
- Routing: with ``REPRO_DECODE_FUSED=1`` the port's ``dense.decode(...,
  paged_kernel=True)`` calls the prologue once per layer, and pages no
  slot owns stay bitwise equal to the composed path's; unset, on the
  CPU, it calls it never.
- The engine with the fused decode against the live JAX engine is in
  ``tests/test_torch_engine.py`` (it shares that file's golden cases).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quantizers import pack_int4
from repro.kernels import ref
from repro.kernels.decode_layer import decode_qkv_prologue as j_prologue
from repro_torch.kernels import ops
from repro_torch.kernels.decode_layer import decode_qkv_prologue
from repro_torch.models import dense

torch.set_num_threads(1)

HD, N_Q, N_KV, PAGE, PAGES = 8, 32, 16, 4, 10   # as test_decode_layer.py


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a, copy=True))


def _operands(b, d, seed, n_blocks, a=4):
    """Prologue operands and a pre-filled pool, made with numpy (Kronecker
    factors a x d / a)."""
    r = np.random.default_rng(seed)
    x = r.standard_normal((b, d)).astype(np.float32)
    blocks = None
    if n_blocks:
        bk = d // n_blocks
        blocks = (r.standard_normal((n_blocks, bk, bk)) * 0.3
                  + np.eye(bk)).astype(np.float32)
    bb = d // a
    ha = (r.standard_normal((a, a)) / np.sqrt(a)).astype(np.float32)
    hb = (r.standard_normal((bb, bb)) / np.sqrt(bb)).astype(np.float32)
    sign = (r.integers(0, 2, d) * 2 - 1).astype(np.float32)
    n = N_Q + 2 * N_KV
    qw = r.integers(-8, 8, (d, n)).astype(np.int8)
    sw = r.uniform(0.01, 0.1, (1, n)).astype(np.float32)
    shape = (PAGES, PAGE, N_KV // HD, HD)
    pools = (r.integers(-128, 128, shape).astype(np.int8),
             r.uniform(0.01, 1.0, shape[:-1] + (1,)).astype(np.float32),
             r.integers(-128, 128, shape).astype(np.int8),
             r.uniform(0.01, 1.0, shape[:-1] + (1,)).astype(np.float32))
    return x, blocks, ha, hb, sign, qw, sw, pools


def _run_three(b, seed, n_blocks=3, packed=True, pids=None, rows=None,
               positions=None, d=24, a=4):
    """-> (port, JAX kernel, oracle) outputs and the original pools."""
    x, blocks, ha, hb, sign, qw, sw, pools = _operands(b, d, seed,
                                                       n_blocks, a)
    pids = np.arange(1, 1 + b) if pids is None else pids
    rows = np.full(b, 1) if rows is None else rows
    positions = np.arange(3, 3 + b) if positions is None else positions
    ids = [np.asarray(v, np.int32) for v in (pids, rows, positions)]
    qw = pack_int4(qw, axis=0) if packed else qw
    kw = dict(n_q=N_Q, head_dim=HD, rope_theta=1e4, kv_bits=8, act_bits=8,
              packed=packed)
    jargs = [None if v is None else jnp.asarray(v)
             for v in (x, blocks, ha, hb, sign, qw, sw, *pools, *ids)]
    kern = j_prologue(*jargs, interpret=True, **kw)
    oracle = ref.decode_qkv_prologue(*jargs, **kw)
    port = decode_qkv_prologue(*[_t(v) for v in (x, blocks, ha, hb, sign,
                                                 qw, sw, *pools, *ids)],
                               **kw)
    return port, kern, oracle, pools


def _assert_matches(port, want):
    np.testing.assert_allclose(port[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-6)
    for i in (1, 3):
        np.testing.assert_array_equal(port[i].numpy()[1:],
                                      np.asarray(want[i])[1:])
    for i in (2, 4):
        np.testing.assert_allclose(port[i].numpy()[1:],
                                   np.asarray(want[i])[1:], rtol=1e-5,
                                   atol=1e-8)


@pytest.mark.parametrize("n_blocks", [0, 3])
@pytest.mark.parametrize("packed", [True, False])
def test_prologue_matches_reference(n_blocks, packed):
    port, kern, oracle, _ = _run_three(8, 0, n_blocks, packed)
    _assert_matches(port, kern)
    _assert_matches(port, oracle)


@pytest.mark.parametrize("d,a,n_blocks", [(24, 4, 3), (63, 7, 7),
                                           (96, 8, 16), (48, 4, 0)])
@pytest.mark.parametrize("packed", [True, False])
def test_prologue_matches_reference_at_general_widths(d, a, n_blocks,
                                                      packed):
    """Widths the card takes on its general path (odd D, CAT blocks and
    factors that are not multiples of 4): the plain prologue against the
    Pallas kernel in interpret mode and the oracle."""
    port, kern, oracle, _ = _run_three(8, d, n_blocks, packed, d=d, a=a)
    _assert_matches(port, kern)
    _assert_matches(port, oracle)


@pytest.mark.parametrize("packed", [True, False])
def test_prologue_matches_reference_at_a_family_width(packed):
    """D 2304 = 64 x 36 (gemma2-2b's d_model; the card's streamed path at
    this D and 128-wide heads), 72 CAT blocks of 32, B 8: the plain
    prologue against the Pallas kernel in interpret mode and the
    oracle."""
    port, kern, oracle, _ = _run_three(8, 5, 72, packed, d=2304, a=64)
    _assert_matches(port, kern)
    _assert_matches(port, oracle)


@pytest.mark.parametrize("b", [1, 3, 8])
def test_prologue_batch_sizes(b):
    port, kern, oracle, _ = _run_three(b, 2)
    assert port[0].shape == (b, N_Q)
    _assert_matches(port, kern)
    _assert_matches(port, oracle)


def test_prologue_ragged_last_page_and_straddle():
    """One row on a page's last slot, the next on the following page's
    first slot (a position straddling the boundary), one mid-page."""
    pids, rows = np.array([1, 2, 3]), np.array([PAGE - 1, 0, 2])
    port, kern, oracle, pools = _run_three(
        3, 3, pids=pids, rows=rows, positions=[PAGE - 1, PAGE, 2])
    _assert_matches(port, kern)
    _assert_matches(port, oracle)
    for p, r in zip(pids, rows):
        assert not np.array_equal(port[1].numpy()[p, r], pools[0][p, r])


def test_prologue_null_target_leaves_real_pages():
    port, kern, oracle, pools = _run_three(3, 4, pids=np.zeros(3),
                                           rows=np.zeros(3))
    _assert_matches(port, kern)
    _assert_matches(port, oracle)
    for got, orig in zip(port[1:], pools):
        np.testing.assert_array_equal(got.numpy()[1:], orig[1:])


# ------------------------------------------------------------- routing

def _served_smoke_model():
    from repro_torch.launch.serve import build_served_model
    cfg, model, params, _ = build_served_model(
        "catlm_60m", "cat", 4, 4, 8, smoke=True, seed=0, device="cpu")
    return cfg, model, model.make_serving_params(params)


def test_fused_layer_routing(monkeypatch):
    cfg, model, msp = _served_smoke_model()
    b, n_ptab, n_pages = 3, 4, 32
    table = torch.arange(1, 1 + b * n_ptab, dtype=torch.int32).reshape(
        b, n_ptab)
    tok = torch.tensor([[5], [7], [11]], dtype=torch.int32)
    calls = {"n": 0}
    real = ops.decode_qkv_prologue

    def counted(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)
    monkeypatch.setattr(ops, "decode_qkv_prologue", counted)

    def step(env):
        if env is None:
            monkeypatch.delenv("REPRO_DECODE_FUSED", raising=False)
        else:
            monkeypatch.setenv("REPRO_DECODE_FUSED", env)
        calls["n"] = 0
        cache = dict(dense.init_paged_cache(cfg, n_pages, PAGE),
                     pos=torch.full((b,), 2, dtype=torch.int32),
                     page_table=table)
        logits, cache = dense.decode(cfg, msp, tok, cache, paged_kernel=True)
        return logits, cache, calls["n"]

    logits_c, cache_c, n_c = step("0")
    logits_f, cache_f, n_f = step("1")
    _, _, n_unset = step(None)
    assert n_c == 0 and n_unset == 0 and n_f == cfg.n_layers
    assert torch.isfinite(logits_f).all()
    assert logits_f.shape == logits_c.shape
    used = set(table.flatten().tolist()) | {0}
    mask = torch.tensor([p not in used for p in range(n_pages)])
    for key in ("k", "k_scale", "v", "v_scale"):
        assert torch.equal(cache_c[key][:, mask], cache_f[key][:, mask])


def test_use_fused_decode_switch(monkeypatch):
    monkeypatch.delenv("REPRO_DECODE_FUSED", raising=False)
    assert ops.use_fused_decode(torch.device("cuda")) is True
    assert ops.use_fused_decode(torch.device("cpu")) is False
    monkeypatch.setenv("REPRO_DECODE_FUSED", "1")
    assert ops.use_fused_decode(torch.device("cpu")) is True
    monkeypatch.setenv("REPRO_DECODE_FUSED", "off")
    assert ops.use_fused_decode(torch.device("cuda")) is False
