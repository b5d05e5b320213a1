"""The port's kernel modules against the JAX reference kernels, on the CPU.

On the CPU each port wrapper takes its plain PyTorch version (the CUDA
kernels run only on the card, where ``chip_smoke.py`` holds them against
these same plain versions). Here the plain versions are held against the
reference's Pallas kernels in interpret mode and its ``kernels.ref``
oracles, on inputs drawn from numpy seeds and handed to both packages:

- fused CAT linear (``fused_cat_gemv_w4`` M <= 8, ``fused_cat_matmul_w4``
  M > 8) over the edge cases of ``tests/test_fused_cat.py``: M in
  {7, 8, 9}, odd K, K not a multiple of the CAT block, packed/unpacked
  weights, act_bits 4/8. ``jax.jit(ref.kernel_transform_quant)`` (the
  kernel's op order, compiled) equals the Pallas kernels' transform-quant
  body in interpret mode bitwise: codes, scales and zero points (checked
  in each case). The port's ``transform_quant_plain`` equals it bitwise in
  codes and zero points; its scales agree at rtol 1e-6, since XLA-CPU's
  ``jnp.dot`` does not sum in order while the port's plain dots (and the
  CUDA kernels) are in-order fma chains, so a row's range moves by a few
  ulps. The eager ``ref.kernel_transform_quant`` divides by the level
  count: at most 1 code step on at most 0.1 % of entries. Outputs agree
  with the Pallas kernel at rtol 1e-5 (the JAX suite's kernel-vs-oracle
  bound) on every row, and with the eager oracle on rows whose codes it
  equals. At the serving widths (D 512 and 1536, M 1, 8, 128, act bits 4
  and 8, f32 and bf16 inputs) the plain transform-quant equals a jitted
  in-order mirror of ``ref.kernel_transform_quant`` (each ``jnp.dot`` a
  ``lax.scan`` fma chain) bitwise in codes, scales and zero points
  (``test_transform_quant_kernel_order_bitwise``); against the compiled
  reference its scales stay within 8 ulps, a dequantized code one step
  away on at most 1e-4 of entries (``test_transform_quant_scale_gap``),
  and ``test_dot_association`` shows that the gap is the dot's.
- paged attention (ragged and decode) over the cases of
  ``tests/test_ragged_attention.py``: mixed q_len, ragged pages, one
  page, padding rows, exact causal horizon, q_len=1 vs decode, fp-pool
  dispatch. Valid rows only, rtol 1e-5 / atol 1e-5 for f32 queries; bf16
  queries at bf16 resolution (rtol 1e-2, one bf16 ulp of the output).
  The plain versions walk the pages with the kernels' online softmax: in
  bf16 on one int8 pool, >= 99 % of outputs bitwise equal to the Pallas
  kernels' and the rest one bf16 ulp apart.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quantizers import pack_int4 as j_pack_int4
from repro.kernels import ref
from jax import lax
from jax.experimental import pallas as pl
from repro.kernels.fused_cat_matmul import (_transform_quant,
                                            fused_cat_gemv_w4 as j_gemv,
                                            fused_cat_matmul_w4 as j_matmul)
from repro.kernels.paged_attention import (
    paged_attention_decode as j_decode,
    paged_attention_ragged as j_ragged,
    paged_attention_ragged_fallback as j_ragged_fallback)
from repro_torch.core.hadamard import hadamard_factors
from repro_torch.kernels import block_matmul as B
from repro_torch.kernels import fused_cat_matmul as F
from repro_torch.kernels import hadamard as H
from repro_torch.kernels import ops
from repro_torch.kernels.fma_chain import chain_dot
from repro_torch.kernels import paged_attention as P

torch.set_num_threads(1)

RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


# ------------------------------------------------------- fused CAT linear

def _factor(d):
    a = int(np.sqrt(d))
    while d % a:
        a -= 1
    return a, d // a


def _fused_operands(m, d, n, seed, n_blocks=0, packed=True):
    r = np.random.default_rng(seed)
    x = r.standard_normal((m, d)).astype(np.float32)
    blocks = None
    if n_blocks:
        bk = d // n_blocks
        blocks = (r.standard_normal((n_blocks, bk, bk)) * 0.3
                  + np.eye(bk)).astype(np.float32)
    a, b = _factor(d)
    ha = (r.standard_normal((a, a)) / np.sqrt(a)).astype(np.float32)
    hb = (r.standard_normal((b, b)) / np.sqrt(b)).astype(np.float32)
    sign = (r.integers(0, 2, d) * 2 - 1).astype(np.float32)
    qw = r.integers(-8, 8, (d, n)).astype(np.int8)
    if packed:
        qw = np.asarray(j_pack_int4(jnp.asarray(qw), axis=0))
    sw = r.uniform(0.01, 0.1, (1, n)).astype(np.float32)
    return x, blocks, ha, hb, sign, qw, sw


_jit_transform_quant = jax.jit(ref.kernel_transform_quant,
                               static_argnames=("act_bits",))


def _pallas_transform_quant(x, blocks, ha, hb, sign, act_bits):
    """The fused Pallas kernels' transform-quant body (run once per M tile)
    alone, in interpret mode, on whole arrays -> (q, scale, zp)."""
    m, d = x.shape
    has_blocks = blocks is not None

    def kernel(*refs):
        x_ref, s_ref, ha_ref, hb_ref = refs[:4]
        b_ref = refs[4] if has_blocks else None
        _transform_quant(x_ref, s_ref, ha_ref, hb_ref, b_ref, *refs[-3:],
                         act_bits=act_bits, k_pad=d)

    args = [x, sign.reshape(1, d), ha, hb] + ([blocks] if has_blocks else [])
    out = pl.pallas_call(
        kernel, interpret=True,
        out_shape=[jax.ShapeDtypeStruct((m, d), jnp.int8),
                   jax.ShapeDtypeStruct((m, 1), jnp.float32),
                   jax.ShapeDtypeStruct((m, 1), jnp.float32)])(*args)
    return [np.asarray(v) for v in out]


def _check_fused(m, d, n, seed, n_blocks=0, packed=True, act_bits=8):
    ops_np = _fused_operands(m, d, n, seed, n_blocks, packed)
    x, blocks, ha, hb, sign, qw, sw = ops_np
    jx = [None if a is None else jnp.asarray(a) for a in ops_np]
    tx = [None if a is None else _t(a) for a in ops_np]
    # activation codes: the compiled kernel-order helper equals the Pallas
    # kernels' transform-quant bitwise; the port's plain transform-quant
    # equals it in codes and zero points, its scales at f32 dot association
    q_jit, s_jit, z_jit = (np.asarray(v) for v in _jit_transform_quant(
        *jx[:5], act_bits=act_bits))
    for got, want in zip((q_jit, s_jit, z_jit),
                         _pallas_transform_quant(*jx[:5], act_bits)):
        np.testing.assert_array_equal(got, want)
    q_pt, s_pt, z_pt = (v.numpy() for v in F.transform_quant_plain(
        *tx[:5], act_bits))
    np.testing.assert_array_equal(q_pt, q_jit)
    np.testing.assert_array_equal(z_pt, z_jit)
    np.testing.assert_allclose(s_pt, s_jit, rtol=1e-6)
    # the eager helper divides by the level count: one step at most
    q_ref, s_ref, z_ref = (np.asarray(v) for v in ref.kernel_transform_quant(
        *jx[:5], act_bits=act_bits))
    diff = np.abs(q_pt.astype(np.int32) - q_ref.astype(np.int32))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 1e-3
    same = (diff == 0).all(axis=1)
    np.testing.assert_allclose(s_pt[same], s_ref[same], rtol=1e-6)
    np.testing.assert_array_equal(z_pt[same], z_ref[same])
    # outputs: the port wrapper (plain on the CPU) vs the Pallas kernel in
    # interpret mode and vs the composed oracle
    run_j = j_gemv if m <= F.GEMV_M else j_matmul
    run_t = F.fused_cat_gemv_w4 if m <= F.GEMV_M else F.fused_cat_matmul_w4
    got = run_t(*tx, act_bits=act_bits, packed=packed).numpy()
    kern = np.asarray(run_j(*jx, act_bits=act_bits, packed=packed,
                            interpret=True))
    want = np.asarray(ref.fused_cat_matmul_w4(*jx, act_bits=act_bits,
                                              packed=packed))
    assert got.shape == (m, n)
    np.testing.assert_allclose(got, kern, rtol=RTOL, atol=RTOL)
    np.testing.assert_allclose(got[same], want[same], rtol=RTOL, atol=RTOL)


def _chain(x, w):
    """x (..., K) · w (..., N, K) over k as in-order f32 chains from 0:
    ``lax.scan`` of acc + x_k·w_k, which XLA-CPU contracts to one fma per
    step — the order of the CUDA kernels' ``fmaf`` chains."""
    def step(acc, xw):
        xk, wk = xw
        return acc + xk[..., None] * wk, None

    shape = jnp.broadcast_shapes(x.shape[:-1] + (1,), w.shape[:-1])
    return lax.scan(step, jnp.zeros(shape, jnp.float32),
                    (jnp.moveaxis(x, -1, 0), jnp.moveaxis(w, -1, 0)))[0]


@functools.partial(jax.jit, static_argnames=("act_bits",))
def _mirror_transform_quant(x, blocks, ha, hb, sign, act_bits):
    """``ref.kernel_transform_quant`` with each ``jnp.dot`` an in-order
    f32 chain (``_chain``): the same per-block dots, sign, reshape and
    transpose walk and ``ref.dynamic_quant``, compiled."""
    xf = x.astype(jnp.float32)
    m, d = xf.shape
    if blocks is not None:
        nblk, bk, _ = blocks.shape
        xf = _chain(xf.reshape(m, nblk, bk),
                    blocks.astype(jnp.float32)).reshape(m, d)
    xf = xf * sign.astype(jnp.float32)
    a, b = ha.shape[0], hb.shape[0]
    y = _chain(xf.reshape(m * a, b), hb.astype(jnp.float32))
    y = y.reshape(m, a, b).swapaxes(1, 2).reshape(m * b, a)
    y = _chain(y, ha.astype(jnp.float32))
    y = y.reshape(m, b, a).swapaxes(1, 2).reshape(m, d)
    return ref.dynamic_quant(y, bits=act_bits, symmetric=False)


def _serving_transform(m, d, seed, dtype="float32"):
    """Serving-width transform operands: x (M, D) in ``dtype``, 32-wide
    CAT blocks, Gaussian Kronecker factors of the serving shapes
    (``hadamard_factors``: (32, 16) at D 512, (32, 48) at D 1536) and a
    sign -> torch tensors."""
    r = np.random.default_rng(seed)
    a, b = (len(h) for h in hadamard_factors(d))
    x = torch.from_numpy(r.standard_normal((m, d)).astype(np.float32))
    blocks = (r.standard_normal((d // 32, 32, 32)) * 0.2
              + np.eye(32)).astype(np.float32)
    ha = (r.standard_normal((a, a)) / np.sqrt(a)).astype(np.float32)
    hb = (r.standard_normal((b, b)) / np.sqrt(b)).astype(np.float32)
    sign = (r.integers(0, 2, d) * 2 - 1).astype(np.float32)
    return [x.to(getattr(torch, dtype))] + [_t(v) for v in
                                            (blocks, ha, hb, sign)]


def _jax(t):
    """A torch tensor (f32 or bf16) as a JAX array of the same dtype."""
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act_bits", [4, 8])
@pytest.mark.parametrize("m", [1, 8, 128])
@pytest.mark.parametrize("d", [512, 1536])
def test_transform_quant_kernel_order_bitwise(d, m, act_bits, dtype):
    """The plain transform-quant (the fused linear's and the prologue's
    plain version, which the card holds the CUDA kernels to bitwise)
    equals the in-order mirror of ``ref.kernel_transform_quant`` bitwise:
    codes, scales and zero points, at the serving widths and every row
    count, one row included."""
    args = _serving_transform(m, d, m + d + act_bits, dtype)
    mine = F.transform_quant_plain(*args, act_bits)
    want = _mirror_transform_quant(*map(_jax, args), act_bits=act_bits)
    for got, w in zip(mine, want):
        np.testing.assert_array_equal(got.numpy(), np.asarray(w))


def test_dot_association():
    """What ``test_transform_quant_scale_gap`` holds is XLA-CPU's
    ``jnp.dot``: at the factor and block depths of the serving widths (16,
    32, 48) its f32 sums are not the in-order chain, while the port's plain
    dots are, at every row count. ``fma_chain.chain_dot``, ``hadamard_f32``
    and the plain Hadamard and block-CAT at one row equal the chain
    bitwise."""
    r = np.random.default_rng(0)
    jit_dot = jax.jit(lambda x, w: jnp.dot(
        x, w.T, preferred_element_type=jnp.float32))
    jit_chain = jax.jit(_chain)
    differ = 0
    for k in (16, 32, 48):
        x = r.standard_normal((128, k)).astype(np.float32)
        w = (r.standard_normal((k, k)) / np.sqrt(k)).astype(np.float32)
        chain = np.asarray(jit_chain(x, w))
        differ += int((np.asarray(jit_dot(x, w)) != chain).sum())
        np.testing.assert_array_equal(chain_dot(_t(x), _t(w)).numpy(), chain)
    assert differ > 0
    for m in (1, 8):
        x, blocks, ha, hb, sign = _serving_transform(m, 1536, m)
        xs = (x * sign).numpy()
        a, b = ha.shape[0], hb.shape[0]
        y = jit_chain(xs.reshape(m * a, b), hb.numpy())
        y = y.reshape(m, a, b).swapaxes(1, 2).reshape(m * b, a)
        y = jit_chain(y, ha.numpy()).reshape(m, b, a).swapaxes(1, 2)
        want = np.asarray(y).reshape(m, -1)
        np.testing.assert_array_equal(
            H.hadamard_f32(x * sign, ha, hb).numpy(), want)
        np.testing.assert_array_equal(
            H.hadamard_transform_plain(x, ha, hb, sign).numpy(), want)
        want_blk = np.asarray(jit_chain(x.numpy().reshape(m, -1, 32),
                                        blocks.numpy())).reshape(m, -1)
        np.testing.assert_array_equal(
            B.block_diag_matmul_plain(x, blocks).numpy(), want_blk)


@pytest.mark.parametrize("act_bits", [4, 8])
@pytest.mark.parametrize("m", [8, 128])
@pytest.mark.parametrize("d,n_blocks", [(512, 16), (1536, 48)])
def test_transform_quant_scale_gap(d, n_blocks, m, act_bits):
    """The plain transform-quant against ``jax.jit(ref.kernel_transform_
    quant)`` at the serving widths. The gap is XLA-CPU's ``jnp.dot``, not
    the port: the compiled reference's dots do not sum in order, the
    plain version's do (``test_transform_quant_kernel_order_bitwise``
    holds it bitwise to the in-order mirror, ``test_dot_association``
    shows the dot). A row's range, and with it its scale, lands a few
    ulps away on many rows. Held here: scales within 8 ulps, and a
    dequantized code (q - zp) one step away on at most 1e-4 of entries."""
    x, blocks, ha, hb, sign, _, _ = _fused_operands(m, d, 8, m + d + act_bits,
                                                    n_blocks)
    args = (x, blocks, ha, hb, sign)
    q_j, s_j, z_j = (np.asarray(v) for v in _jit_transform_quant(
        *map(jnp.asarray, args), act_bits=act_bits))
    q_p, s_p, z_p = (v.numpy() for v in F.transform_quant_plain(
        *map(_t, args), act_bits))
    ulps = np.abs(s_p.view(np.int32).astype(np.int64)
                  - s_j.view(np.int32).astype(np.int64))
    assert ulps.max() <= 8
    shift = np.abs((q_p.astype(np.float32) - z_p)
                   - (q_j.astype(np.float32) - z_j))
    assert shift.max() <= 1
    assert (shift > 0).mean() <= 1e-4


@pytest.mark.parametrize("m", [7, 8, 9])
def test_fused_gemv_tiled_boundary(m):
    _check_fused(m, 64, 96, seed=m, n_blocks=4)


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("m,d,n,n_blocks", [
    (5, 64, 96, 0),        # bare Hadamard transform
    (17, 96, 80, 6),       # tiled, blocks, K not a multiple of 64
    (33, 63, 40, 0),       # odd K: the padded nibble stays inert
    (3, 63, 40, 7),        # odd K through the GEMV variant, with blocks
])
def test_fused_matches_reference(packed, m, d, n, n_blocks):
    _check_fused(m, d, n, seed=m * 100 + d, n_blocks=n_blocks,
                 packed=packed)


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("m,d,n,n_blocks", [
    (3, 96, 40, 16),       # CAT block 6 (not a multiple of 4), GEMV
    (17, 96, 40, 16),      # the same, tiled
    (5, 24, 40, 3),        # the prologue's reference width, GEMV
    (12, 24, 40, 3),       # ... tiled
    (4, 48, 40, 0),        # D 48 = 6 x 8
    (11, 63, 40, 7),       # odd K, tiled, with blocks
])
def test_fused_matches_reference_at_general_widths(packed, m, d, n,
                                                   n_blocks):
    """Widths the cluster transform splits over no cluster of, which the
    card takes on its general path (one CTA per cluster, scalar chains):
    the plain version, which the card is held to bitwise, against the
    Pallas kernels in interpret mode and the oracle."""
    _check_fused(m, d, n, seed=m * 100 + d + n_blocks, n_blocks=n_blocks,
                 packed=packed)


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("m", [8, 17])
def test_fused_matches_reference_at_a_family_width(packed, m):
    """D 2304 (gemma2-2b's d_model, 72 CAT blocks of 32), N 64, which the
    card serves on the streamed path at M <= 8 and the tiled stage's:
    the plain version, which the card is held to bitwise, against the
    Pallas kernels in interpret mode and the oracle."""
    _check_fused(m, 2304, 64, seed=2304 + m, n_blocks=72, packed=packed)


@pytest.mark.parametrize("act_bits", [4, 8])
def test_fused_act_bits(act_bits):
    _check_fused(9, 64, 48, seed=act_bits, n_blocks=4, act_bits=act_bits)


def test_fused_dispatch_and_counters():
    """ops picks the GEMV variant up to 8 rows and the tiled one above;
    on CPU tensors neither counts a kernel launch."""
    x, blocks, ha, hb, sign, qw, sw = (
        None if a is None else _t(a)
        for a in _fused_operands(12, 64, 32, 5, n_blocks=4))
    before = (F.fused_cat_gemv_w4.launches, F.fused_cat_matmul_w4.launches)
    y_small = ops.fused_cat_matmul(x[:8], blocks, ha, hb, sign, qw, sw,
                                   act_bits=4)
    y_big = ops.fused_cat_matmul(x, blocks, ha, hb, sign, qw, sw, act_bits=4)
    assert torch.equal(y_small, y_big[:8])
    assert (F.fused_cat_gemv_w4.launches,
            F.fused_cat_matmul_w4.launches) == before
    with pytest.raises(ValueError, match="M <= 8"):
        F.fused_cat_gemv_w4(x, blocks, ha, hb, sign, qw, sw, act_bits=4)


def test_fused_transform_operands_decomposes():
    from repro_torch.core import transforms as T
    r = np.random.default_rng(3)
    had = T.make_hadamard(32, r)
    s = torch.from_numpy(r.uniform(0.5, 2.0, 32).astype(np.float32))
    blocks, ha, hb, sign = ops.fused_transform_operands(
        T.Compose((T.Scale(s), had)))
    assert blocks is None
    assert torch.equal(sign, had.sign * s)
    bd = T.BlockDiag(torch.eye(8).repeat(4, 1, 1), torch.eye(8).repeat(4, 1, 1))
    assert ops.fused_transform_operands(T.Compose((bd, had)))[0] is bd.blocks
    assert ops.fused_transform_operands(T.Dense(torch.eye(4),
                                                torch.eye(4))) is None
    assert ops.fused_transform_operands(T.Identity()) is None


# -------------------------------------------------------- paged attention

def _attn_case(seed, b, nq, kvh, g, hd, page_size, n_ptab, q_lens, lengths):
    r = np.random.default_rng(seed)
    n_pages = 1 + b * n_ptab
    k_pages = r.integers(-127, 128, (n_pages, page_size, kvh, hd)).astype(
        np.int8)
    v_pages = r.integers(-127, 128, (n_pages, page_size, kvh, hd)).astype(
        np.int8)
    k_scale = r.uniform(0.01, 0.1, (n_pages, page_size, kvh, 1)).astype(
        np.float32)
    v_scale = r.uniform(0.01, 0.1, (n_pages, page_size, kvh, 1)).astype(
        np.float32)
    q = r.standard_normal((b, nq, kvh, g, hd)).astype(np.float32)
    table = np.zeros((b, n_ptab), np.int32)
    nxt = 1
    for i in range(b):
        for j in range(-(-int(lengths[i]) // page_size)):
            table[i, j] = nxt
            nxt += 1
    qpos = np.full((b, nq), -1, np.int32)
    for i, (ql, ln) in enumerate(zip(q_lens, lengths)):
        qpos[i, :ql] = ln - ql + np.arange(ql)
    return [q, k_pages, k_scale, v_pages, v_scale, table,
            np.asarray(lengths, np.int32), qpos]


CASES = {
    "mixed": ((1, 3, 6), (9, 7, 6), 4, 3),
    "ragged-pages": ((2, 5, 1), (11, 5, 13), 4, 4),
    "one-page": ((1, 2, 2), (1, 2, 8), 8, 1),
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", sorted(CASES))
def test_ragged_matches_reference_kernel(seed, case):
    q_lens, lengths, page_size, n_ptab = CASES[case]
    args = _attn_case(seed, len(q_lens), max(q_lens), 2, 2, 8, page_size,
                      n_ptab, q_lens, lengths)
    got = P.paged_attention_ragged(*map(_t, args)).numpy()
    want = np.asarray(j_ragged(*map(jnp.asarray, args), interpret=True))
    valid = args[-1] >= 0
    np.testing.assert_allclose(got[valid], want[valid], rtol=RTOL, atol=RTOL)


def test_ragged_bf16_queries_round_like_the_kernel():
    """bf16 q: the kernel scales by hd^-½ in f32 and rounds back to bf16
    before the dots; the port's plain version does the same."""
    q_lens, lengths, page_size, n_ptab = CASES["mixed"]
    args = _attn_case(4, 3, 6, 2, 2, 32, page_size, n_ptab, q_lens, lengths)
    jq = jnp.asarray(args[0]).astype(jnp.bfloat16)
    want = np.asarray(j_ragged(jq, *map(jnp.asarray, args[1:]),
                               interpret=True).astype(jnp.float32))
    tq = _t(np.asarray(jq.astype(jnp.float32))).to(torch.bfloat16)
    got = P.paged_attention_ragged(tq, *map(_t, args[1:])).float().numpy()
    valid = args[-1] >= 0
    np.testing.assert_allclose(got[valid], want[valid], rtol=1e-2,
                               atol=1e-2)


def _bf16_ulps(a, b):
    """bf16 ulp distance between two f32 arrays of bf16 values."""
    ai, bi = _t(a).to(torch.bfloat16), _t(b).to(torch.bfloat16)
    return (ai.view(torch.int16).int() - bi.view(torch.int16).int()).abs()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_plain_attention_follows_pallas_kernels(seed, case):
    """bf16 queries on one int8 pool: both plain versions walk the pages
    with the Pallas kernels' online softmax (interpret mode), so >= 99 %
    of valid outputs are bitwise equal and the rest one bf16 ulp apart
    (f32 dot association moves a value across a rounding boundary)."""
    q_lens, lengths, page_size, n_ptab = CASES[case]
    args = _attn_case(seed, len(q_lens), max(q_lens), 2, 2, 32, page_size,
                      n_ptab, q_lens, lengths)
    jq = jnp.asarray(args[0]).astype(jnp.bfloat16)
    tq = _t(np.asarray(jq.astype(jnp.float32))).to(torch.bfloat16)
    valid = args[-1] >= 0
    want = np.asarray(j_ragged(jq, *map(jnp.asarray, args[1:]),
                               interpret=True).astype(jnp.float32))
    got = P.paged_attention_ragged_plain(tq, *map(_t, args[1:]))
    ulps = _bf16_ulps(got.float().numpy()[valid], want[valid])
    assert ulps.max() <= 1 and (ulps == 0).float().mean() >= 0.99
    pool = args[1:7]
    want = np.asarray(j_decode(jq[:, 0], *map(jnp.asarray, pool),
                               interpret=True).astype(jnp.float32))
    got = P.paged_attention_decode_plain(tq[:, 0], *map(_t, pool))
    ulps = _bf16_ulps(got.float().numpy(), want)
    assert ulps.max() <= 1 and (ulps == 0).float().mean() >= 0.99


def test_padded_query_rows_do_not_contaminate():
    """Padding rows (q_pos = -1) added to a query block leave the real rows
    as they were, up to f32 association: the plain version's batched
    einsum may block the sum differently for a wider block (rtol 1e-6)."""
    args = _attn_case(3, 2, 2, 2, 2, 8, 4, 2, (2, 1), (6, 3))
    small = P.paged_attention_ragged(*map(_t, args)).numpy()
    wide = list(args)
    pad = np.random.default_rng(9).standard_normal((2, 3, 2, 2, 8))
    wide[0] = np.concatenate([args[0], pad.astype(np.float32)], axis=1)
    wide[-1] = np.concatenate([args[-1], np.full((2, 3), -1, np.int32)],
                              axis=1)
    out_wide = P.paged_attention_ragged(*map(_t, wide)).numpy()
    valid = args[-1] >= 0
    np.testing.assert_allclose(small[valid], out_wide[:, :2][valid],
                               rtol=1e-6, atol=1e-6)


def test_causal_horizon_masking_is_exact():
    """Poisoned rows past every query's horizon (and the null page) get
    exactly zero weight."""
    args = _attn_case(5, 2, 3, 2, 2, 8, 4, 3, (3, 1), (5, 9))
    out = P.paged_attention_ragged(*map(_t, args)).numpy()
    q, kp, ks, vp, vs, table, ln, qpos = [np.array(a) for a in args]
    page_size = kp.shape[1]
    for i in range(2):
        horizon = int(qpos[i].max())
        for j in range(table.shape[1]):
            page = table[i, j]
            for r in range(page_size):
                if page and j * page_size + r > horizon:
                    kp[page, r], vp[page, r] = 127, -127
                    ks[page, r], vs[page, r] = 1e8, 1e8
    kp[0], vp[0], ks[0], vs[0] = 127, -127, 1e8, 1e8
    out2 = P.paged_attention_ragged(*map(_t, (q, kp, ks, vp, vs, table, ln,
                                              qpos))).numpy()
    valid = qpos >= 0
    np.testing.assert_array_equal(out[valid], out2[valid])


def test_qlen1_reduces_to_decode():
    """q_len=1 rows at q_pos = length-1 are the decode contract: the port's
    decode path matches the reference decode kernel and the ragged path."""
    args = _attn_case(7, 3, 1, 2, 2, 8, 4, 3, (1, 1, 1), (5, 12, 1))
    q, kp, ks, vp, vs, table, ln, qpos = args
    dec = P.paged_attention_decode(*map(_t, (q[:, 0], kp, ks, vp, vs, table,
                                             ln))).numpy()
    ragged = P.paged_attention_ragged(*map(_t, args)).numpy()[:, 0]
    want = np.asarray(j_decode(*map(jnp.asarray, (q[:, 0], kp, ks, vp, vs,
                                                  table, ln)),
                               interpret=True))
    np.testing.assert_allclose(dec, want, rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(ragged, dec, rtol=RTOL, atol=1e-6)


def test_ops_dispatch_fp_pool_falls_back():
    """fp pools (no scales) go to the gather fallback, which matches the
    reference's fallback and a quantized pool dequantized up front."""
    args = _attn_case(11, 2, 3, 2, 2, 8, 4, 2, (3, 2), (7, 4))
    q, kp, ks, vp, vs, table, ln, qpos = args
    k_fp = kp.astype(np.float32) * ks
    v_fp = vp.astype(np.float32) * vs
    via_ops = ops.ragged_paged_attention(*map(_t, (q, k_fp)), None,
                                         _t(v_fp), None,
                                         *map(_t, (table, ln, qpos))).numpy()
    want = np.asarray(j_ragged_fallback(
        *map(jnp.asarray, (q, k_fp)), None, jnp.asarray(v_fp), None,
        *map(jnp.asarray, (table, ln, qpos))))
    valid = qpos >= 0
    np.testing.assert_allclose(via_ops[valid], want[valid], rtol=RTOL,
                               atol=RTOL)
    quant = ops.ragged_paged_attention(*map(_t, args)).numpy()
    np.testing.assert_allclose(via_ops[valid], quant[valid], rtol=1e-4,
                               atol=1e-5)
    before = (P.paged_attention_ragged.launches,
              P.paged_attention_decode.launches)
    ops.paged_attention(*map(_t, (q[:, 0], kp, ks, vp, vs, table, ln)))
    assert (P.paged_attention_ragged.launches,
            P.paged_attention_decode.launches) == before
