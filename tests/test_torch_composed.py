"""The port's composed CAT linear and its six stand-alone kernels against
the JAX reference, on the CPU.

On the CPU each port wrapper takes its plain PyTorch version (the CUDA
kernels run only on the card, where ``chip_smoke.py`` holds them against
these same plain versions). Here the plain versions are held against the
reference's Pallas kernels in interpret mode and its ``kernels.ref``
oracles, on inputs drawn from numpy seeds and handed to both packages:

- Hadamard (D in {64, 96, 512}, 1, 7 and 300 tokens — past the Pallas
  kernel's 256-token block) and block-diag ((n, k) in {(4, 8), (16, 32)}):
  f32 at rtol 1e-5 of the output's scale (XLA-CPU's f32 dot association;
  the plain versions sum in order, as the CUDA kernels do); bf16 outputs
  within one bf16 ulp plus that bound, >= 99 % of them bitwise.
  A row's block-CAT is bitwise the same whatever rows share its call.
- dynamic quant (bits 2–8, symmetric and asymmetric, f32 and bf16
  inputs, rows with a zero point on a .5 tie and an all-zero row): codes,
  scales and zero points bitwise against the Pallas kernel in interpret
  mode, which XLA compiles with the scale as a multiply by the f32
  reciprocal of the level count and zp and codes as divisions by the
  scale. The eager oracle ``ref.dynamic_quant`` divides by the level
  count: its scales are within one f32 ulp, and the dequantized code
  q − zp moves by one step on <= 0.1 % of entries (<= 1 % from bf16
  inputs, whose coarse values land on rounding ties more often; a zero
  point on a tie moves with the scale, and the row's codes with it).
- the contractions (W8A8 ``quant_matmul``, W4A8 ``quant_matmul_w4`` and
  the ``quant_gemv_w4`` GEMV at M in {1, 7, 8}, raising at 9) with ragged
  M/N, K > 512 and odd K: bitwise against the oracle (exact integer
  accumulation, one epilogue); rtol 1e-5 of the output's scale against the
  Pallas kernels, which add one f32 epilogue per 512-deep K tile. The
  W8A8 plain version is also bitwise against the oracle at int8 extremes
  over K 1536, where each sum passes 2^24, and the W4A8 one at nibble
  extremes over K 1536 and at odd K (the card's K splits are checked by
  ``chip_smoke.py``, where the CUDA source plans them).
- ``ops.cat_transform_matmul`` against the reference's at M in {7, 8, 9},
  packed and unpacked: dequantized activation codes q − zp within one step
  on <= 0.1 % of entries (f32) or <= 1 % (bf16, where a one-ulp difference
  of a rounded intermediate moves a value across a rounding boundary),
  outputs at rtol 1e-4 (f32, the JAX suite's bound) or one bf16 ulp of the
  row's scale (bf16) on rows where they all agree. In f32 the port's composed linear
  equals its fused one bitwise on the CPU (the plain versions share every
  step).
- the slice: every QLinear of a CAT-PTQ'd ``catlm_60m().smoke()`` (W4
  packed and W8 unpacked), converted with ``from_reference``, through both
  composed entry points on the same activations, at the bounds above.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden import regenerate

from repro.core.quantizers import pack_int4 as j_pack_int4
from repro.kernels import ops as jops
from repro.kernels import ref
from repro.kernels.block_matmul import block_diag_matmul as j_block
from repro.kernels.dynamic_quant import dynamic_quant as j_dyn_quant
from repro.kernels.hadamard import hadamard_transform as j_hadamard
from repro.kernels.quant_matmul import quant_matmul as j_qmm
from repro.kernels.quant_matmul_w4 import (quant_gemv_w4 as j_gemv,
                                           quant_matmul_w4 as j_qmm_w4)
from repro_torch.convert import from_reference
from repro_torch.core.qlinear import iter_qlinear
from repro_torch.kernels import block_matmul as B
from repro_torch.kernels import dynamic_quant as DQ
from repro_torch.kernels import hadamard as H
from repro_torch.kernels import ops
from repro_torch.kernels import quant_matmul as QM
from repro_torch.kernels import quant_matmul_w4 as QW

torch.set_num_threads(1)

RTOL = 1e-5
KERNELS = (B.block_diag_matmul, H.hadamard_transform, DQ.dynamic_quant,
           QM.quant_matmul, QW.quant_matmul_w4, QW.quant_gemv_w4)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _pair(x, dtype):
    """The same values as a jax array and a torch tensor of ``dtype``."""
    jx = jnp.asarray(x).astype(dtype)
    return jx, _t(np.asarray(jx.astype(jnp.float32))).to(getattr(torch,
                                                                 dtype))


def _np(a):
    """f32 numpy view of a jax array or torch tensor of any float dtype."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy() if a.is_floating_point() else a.numpy()
    return np.asarray(a.astype(jnp.float32) if jnp.issubdtype(
        a.dtype, jnp.floating) else a)


def _close(got, want, dtype):
    """f32: rtol 1e-5 of the output's scale (f32 association); bf16: one
    bf16 ulp (2^-7 relative) plus that f32 bound — near zero the f32
    difference spans several ulps of a small value — with >= 99 % of the
    outputs bitwise."""
    atol = RTOL * np.abs(want).max()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol)
    else:
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=atol)
        assert (got == want).mean() >= 0.99


def _factors(d, r):
    a = int(np.sqrt(d))
    while d % a:
        a -= 1
    b = d // a
    ha = (r.standard_normal((a, a)) / np.sqrt(a)).astype(np.float32)
    hb = (r.standard_normal((b, b)) / np.sqrt(b)).astype(np.float32)
    return ha, hb


# -------------------------------------------------------------- Hadamard

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [1, 7, 300])
@pytest.mark.parametrize("d", [64, 96, 512])
def test_hadamard_matches_reference(d, m, dtype):
    r = np.random.default_rng(d * 1000 + m)
    ha, hb = _factors(d, r)
    sign = (r.integers(0, 2, d) * 2 - 1).astype(np.float32)
    jx, tx = _pair(r.standard_normal((m, d)).astype(np.float32), dtype)
    got = _np(H.hadamard_transform(tx, _t(ha), _t(hb), _t(sign)))
    kern = _np(j_hadamard(jx, jnp.asarray(ha), jnp.asarray(hb),
                          jnp.asarray(sign), interpret=True))
    orac = _np(ref.hadamard_transform(jx, jnp.asarray(ha), jnp.asarray(hb),
                                      jnp.asarray(sign)))
    _close(got, kern, dtype)
    _close(got, orac, dtype)


def test_hadamard_sign_none_and_lead_dims():
    """``sign=None`` means ones; leading dims pass through."""
    r = np.random.default_rng(5)
    ha, hb = _factors(64, r)
    x = r.standard_normal((2, 3, 64)).astype(np.float32)
    got = H.hadamard_transform(_t(x), _t(ha), _t(hb))
    ones = H.hadamard_transform(_t(x), _t(ha), _t(hb), torch.ones(64))
    assert got.shape == (2, 3, 64) and torch.equal(got, ones)
    want = _np(j_hadamard(jnp.asarray(x), jnp.asarray(ha), jnp.asarray(hb),
                          interpret=True))
    _close(got.numpy(), want, "float32")


# ------------------------------------------------------------ block-diag

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [7, 300])
@pytest.mark.parametrize("n,k", [(4, 8), (16, 32)])
def test_block_diag_matches_reference(n, k, m, dtype):
    r = np.random.default_rng(n * 100 + k + m)
    blocks = (r.standard_normal((n, k, k)) * 0.3 + np.eye(k)).astype(
        np.float32)
    jx, tx = _pair(r.standard_normal((m, n * k)).astype(np.float32), dtype)
    got = _np(B.block_diag_matmul(tx, _t(blocks)))
    kern = _np(j_block(jx, jnp.asarray(blocks), interpret=True))
    orac = _np(ref.block_diag_matmul(jx, jnp.asarray(blocks)))
    _close(got, kern, dtype)
    _close(got, orac, dtype)


@pytest.mark.parametrize("m", [1, 7, 9, 300])
def test_block_diag_rows_do_not_depend_on_batch(m):
    """Each row's block-CAT is the same whatever rows share its call (the
    plain version's in-order fma chains, like the CUDA kernel's fmaf
    chains, do not depend on the batch)."""
    r = np.random.default_rng(m)
    blocks = _t((r.standard_normal((16, 32, 32)) * 0.3 + np.eye(32))
                .astype(np.float32))
    x = _t(r.standard_normal((301, 512)).astype(np.float32))
    full = B.block_diag_matmul(x, blocks)
    for start in (0, 1):
        np.testing.assert_array_equal(
            B.block_diag_matmul(x[start:start + m], blocks).numpy(),
            full[start:start + m].numpy())


# --------------------------------------------------------- dynamic quant

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("bits", [4, 8])
def test_dynamic_quant_matches_reference(bits, symmetric, dtype):
    r = np.random.default_rng(bits + 10 * symmetric)
    x = (r.standard_normal((2, 150, 96)) * r.uniform(0.01, 30, (2, 150, 1))
         ).astype(np.float32)
    x[0, 0] = 0.0                    # an all-zero row: the 1e-12 floor
    jx, tx = _pair(x, dtype)
    got = [v.numpy() for v in DQ.dynamic_quant(tx, bits, symmetric)]
    orac = [np.asarray(v) for v in ref.dynamic_quant(jx, bits, symmetric)]
    kern = [np.asarray(v) for v in j_dyn_quant(jx, bits=bits,
                                               symmetric=symmetric,
                                               interpret=True)]
    assert got[0].shape == (2, 150, 96) and got[1].shape == (2, 150, 1)
    for g, k in zip(got, kern):
        np.testing.assert_array_equal(g, k)
    assert np.all(np.abs(got[1].view(np.int32) - orac[1].view(np.int32))
                  <= 1)
    shift = _dequant_shift(got[0], got[2], orac[0], orac[2])
    assert shift.max() <= 1
    assert (shift > 0).mean() <= (1e-3 if dtype == "float32" else 1e-2)


def _tie_rows(bits, d=64):
    """Rows whose asymmetric zero point −ymin/scale falls exactly on a .5
    tie (ymin = −0.1875 and a bf16-exact ymax found by search, with the
    scale computed as the kernels compute it), an all-zero row (the 1e-12
    floor), a constant row, rows of one sign and random rows, at width
    ``d``; every value is exact in bf16."""
    r = np.random.default_rng(bits)
    recip = np.float32(1) / np.float32(2 ** bits - 1)
    ymin = np.float32(-0.1875)
    rows = []
    for e in range(-4, 6):
        for mant in range(128):
            ymax = np.float32((1 + mant / 128) * 2.0 ** e)
            t = -ymin / (np.float32(ymax - ymin) * recip)
            if t - np.floor(t) == 0.5:
                row = r.uniform(ymin, ymax, d).astype(np.float32)
                row[0], row[1] = ymin, ymax
                rows.append(row)
    assert rows
    rows += [np.zeros(d, np.float32), np.full(d, 2.5, np.float32),
             r.uniform(0.1, 4.0, d).astype(np.float32),
             -r.uniform(0.1, 4.0, d).astype(np.float32)]
    rand = r.standard_normal((24, d)) * r.uniform(0.01, 30, (24, 1))
    rows = np.concatenate([np.stack(rows), rand.astype(np.float32)])
    return np.asarray(jnp.asarray(rows).astype(jnp.bfloat16)
                      .astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("bits", [2, 3, 4, 5, 6, 7, 8])
def test_dynamic_quant_bitwise_to_pallas(bits, symmetric, dtype):
    """The plain version (and so the CUDA kernel, which chip_smoke holds
    bitwise to it) equals the Pallas kernel in interpret mode bitwise:
    scale = range times the f32 reciprocal of the level count, zp and
    codes by IEEE division by that scale."""
    jx, tx = _pair(_tie_rows(bits), dtype)
    got = [v.numpy() for v in DQ.dynamic_quant(tx, bits, symmetric)]
    kern = [np.asarray(v) for v in j_dyn_quant(jx, bits=bits,
                                               symmetric=symmetric,
                                               interpret=True)]
    for g, k in zip(got, kern):
        np.testing.assert_array_equal(g, k)
    if not symmetric:   # the tie rows really put −ymin/scale on a .5 tie
        t = -np.asarray(jx, np.float32).min(-1) / got[1][:, 0]
        assert np.any(t - np.floor(t) == 0.5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("symmetric", [False, True])
def test_dynamic_quant_wide_rows_bitwise_to_pallas(symmetric, dtype):
    """D 12,289: a width the CUDA wrapper used to refuse (its 48 KiB
    shared-memory row) and that the kernel now runs on its general path
    (odd, past the register path). The plain version, which the card
    holds the kernel to bitwise, equals the Pallas kernel in interpret
    mode bitwise at that width, a constant row (the 1e-12 floor) among
    the rows."""
    r = np.random.default_rng(12289 + symmetric)
    x = (r.standard_normal((3, 12289)) * r.uniform(0.01, 30, (3, 1))
         ).astype(np.float32)
    x[1] = 0.75
    jx, tx = _pair(x, dtype)
    got = [v.numpy() for v in DQ.dynamic_quant(tx, 4, symmetric)]
    kern = [np.asarray(v) for v in j_dyn_quant(jx, bits=4,
                                               symmetric=symmetric,
                                               interpret=True)]
    assert got[0].shape == (3, 12289)
    for g, k in zip(got, kern):
        np.testing.assert_array_equal(g, k)


def test_reciprocal_quotient_is_the_ieee_division():
    """The CUDA quant divides each value by its row's scale without the
    IEEE division's per-element range check (``tq::quot`` of
    ``csrc/transform_quant.cuh``): rcp = RN(1 / scale), q = RN(y·rcp),
    then q + fma(-scale, q, y)·rcp by fma (Markstein). Emulated exactly
    here (numpy f32 division and product, each fma as the f64 product
    rounded once to f32, ``fma_chain._round_sum``), over 2e6 values whose
    quotients sit on and near integers and half-integers (the ties a code
    rounds at) and random ones, at scales from the quant's floor 1e-12/255
    to 1e6: the quotient equals IEEE y / scale bitwise wherever it is at
    least 1/4, and every code, with and without a zero point, is equal."""
    from repro_torch.kernels.fma_chain import _round_sum
    r = np.random.default_rng(23)
    n = 2_000_000
    scale = (10.0 ** r.uniform(-14.5, 6, n)).astype(np.float32)
    k = r.integers(-300, 300, n) + r.choice([0.0, 0.5], n)
    near = k * scale.astype(np.float64) * (1 + r.uniform(-3e-7, 3e-7, n))
    rand = r.standard_normal(n) * 100 * scale.astype(np.float64)
    y = np.where(r.random(n) < 0.7, near, rand).astype(np.float32)
    rcp = np.float32(1) / scale
    q = y * rcp
    rem = _round_sum(torch.from_numpy(-scale.astype(np.float64)
                                      * q.astype(np.float64)),
                     torch.from_numpy(y)).numpy()
    got = _round_sum(torch.from_numpy(rem.astype(np.float64)
                                      * rcp.astype(np.float64)),
                     torch.from_numpy(q)).numpy()
    want = y / scale
    big = np.abs(want) >= 0.25
    assert big.mean() > 0.9
    np.testing.assert_array_equal(got[big], want[big])
    zp = r.integers(-8, 8, n).astype(np.float32)
    for z in (np.float32(0), zp):
        np.testing.assert_array_equal(np.rint(got + z), np.rint(want + z))


def _dequant_shift(q_a, zp_a, q_b, zp_b):
    """|(q_a − zp_a) − (q_b − zp_b)| per element: how far two quantizations
    of the same row move a dequantized value, in code steps. A zero point
    on a rounding tie (a row with ymax = −ymin puts −ymin/scale on 7.5 at
    4 bits) moves with a one-ulp scale, and every code of the row moves
    with it: the dequantized values, and the contraction, stay put."""
    return np.abs((q_a.astype(np.float32) - zp_a)
                  - (q_b.astype(np.float32) - zp_b))


# ---------------------------------------------------------- contractions

def _codes(m, k, n, seed, packed, act_bits=8):
    r = np.random.default_rng(seed)
    half = 2 ** (act_bits - 1)
    qx = r.integers(-half, half, (m, k)).astype(np.int8)
    sx = r.uniform(0.01, 0.1, (m, 1)).astype(np.float32)
    zx = r.integers(-half, half, (m, 1)).astype(np.float32)
    if packed:
        qw = np.asarray(j_pack_int4(jnp.asarray(
            r.integers(-8, 8, (k, n)).astype(np.int8)), axis=0))
    else:
        qw = r.integers(-127, 128, (k, n)).astype(np.int8)
    sw = r.uniform(0.001, 0.01, (1, n)).astype(np.float32)
    return [qx, sx, zx, qw, sw]


def _check_contraction(port, kernel, oracle, args):
    got = port(*map(_t, args)).numpy()
    want = np.asarray(oracle(*map(jnp.asarray, args)))
    kern = np.asarray(kernel(*map(jnp.asarray, args), interpret=True))
    assert got.shape == want.shape == kern.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, kern, rtol=RTOL,
                               atol=RTOL * np.abs(kern).max())


@pytest.mark.parametrize("m,k,n", [
    (9, 64, 40),        # ragged M and N
    (130, 1536, 72),    # K > 512: three Pallas K tiles
    (33, 63, 24),       # odd K
])
@pytest.mark.parametrize("packed", [True, False])
def test_contractions_match_reference(m, k, n, packed):
    args = _codes(m, k, n, m * 7 + k, packed)
    if packed:
        _check_contraction(QW.quant_matmul_w4, j_qmm_w4,
                           ref.quant_matmul_w4, args)
    else:
        _check_contraction(QM.quant_matmul, j_qmm, ref.quant_matmul, args)


@pytest.mark.parametrize("m,k,n", [(9, 1536, 40), (130, 1536, 24)])
@pytest.mark.parametrize("pattern", ["min", "alternating", "random"])
def test_w8a8_extreme_codes_exact(m, k, n, pattern):
    """The W8A8 plain version, which the card's tensor-core kernel is held
    to bitwise, equals ``ref.quant_matmul``'s int32 accumulation bitwise
    at int8 extremes over K 1536: codes −128 but the last three, 1, on
    both sides (acc = 1533·2^14 + 3 lies above 2^24, where an f32 running
    sum drops each trailing unit; only the exact sum, rounded once, is the
    reference's), codes alternating −128/127 along K, and full-range
    random codes, weights included."""
    r = np.random.default_rng(m + n)
    if pattern == "min":
        qx = np.full((m, k), -128, np.int8)
        qw = np.full((k, n), -128, np.int8)
        qx[:, -3:], qw[-3:, :] = 1, 1
    elif pattern == "alternating":
        qx = np.where(np.arange(k) % 2, 127, -128).astype(np.int8)
        qx = np.broadcast_to(qx, (m, k)).copy()
        qw = np.where(np.arange(k)[:, None] % 2, -128, 127
                      ).astype(np.int8).repeat(n, axis=1)
    else:
        qx = r.integers(-128, 128, (m, k)).astype(np.int8)
        qw = r.integers(-128, 128, (k, n)).astype(np.int8)
    sx = r.uniform(0.01, 0.1, (m, 1)).astype(np.float32)
    zx = r.integers(-128, 128, (m, 1)).astype(np.float32)
    sw = r.uniform(0.001, 0.01, (1, n)).astype(np.float32)
    args = [qx, sx, zx, qw, sw]
    got = QM.quant_matmul(*map(_t, args)).numpy()
    want = np.asarray(ref.quant_matmul(*map(jnp.asarray, args)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("m,k,n", [(9, 1536, 40), (130, 1536, 24),
                                   (33, 1535, 24)])
@pytest.mark.parametrize("pattern", ["min", "alternating", "random"])
def test_w4_extreme_codes_exact(m, k, n, pattern):
    """The W4A8 plain version, which the card's tensor-core kernel is held
    to bitwise, equals ``ref.quant_matmul_w4`` bitwise at nibble extremes
    over K 1536 and at odd K (the packed weight's last high nibble is 0
    and the missing code reads as 0): activation codes −128 and weight
    nibbles −8 but the last three, 1, on both sides; codes alternating
    −128/127 against nibbles 7/−8 along K; and full-range random codes
    and nibbles."""
    r = np.random.default_rng(m + k + n)
    if pattern == "min":
        qx = np.full((m, k), -128, np.int8)
        qw = np.full((k, n), -8, np.int8)
        qx[:, -3:], qw[-3:, :] = 1, 1
    elif pattern == "alternating":
        qx = np.where(np.arange(k) % 2, 127, -128).astype(np.int8)
        qx = np.broadcast_to(qx, (m, k)).copy()
        qw = np.where(np.arange(k)[:, None] % 2, -8, 7
                      ).astype(np.int8).repeat(n, axis=1)
    else:
        qx = r.integers(-128, 128, (m, k)).astype(np.int8)
        qw = r.integers(-8, 8, (k, n)).astype(np.int8)
    sx = r.uniform(0.01, 0.1, (m, 1)).astype(np.float32)
    zx = r.integers(-128, 128, (m, 1)).astype(np.float32)
    sw = r.uniform(0.001, 0.01, (1, n)).astype(np.float32)
    packed = np.asarray(j_pack_int4(jnp.asarray(qw), axis=0))
    args = [qx, sx, zx, packed, sw]
    got = QW.quant_matmul_w4(*map(_t, args)).numpy()
    want = np.asarray(ref.quant_matmul_w4(*map(jnp.asarray, args)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("m", [1, 7, 8])
@pytest.mark.parametrize("k", [512, 1535])
def test_gemv_matches_reference(m, k):
    args = _codes(m, k, 96, m + k, packed=True, act_bits=4)
    _check_contraction(QW.quant_gemv_w4, j_gemv, ref.quant_gemv_w4, args)


def test_gemv_raises_above_eight_rows():
    args = [_t(a) for a in _codes(9, 64, 32, 1, packed=True)]
    with pytest.raises(ValueError, match="M <= 8"):
        QW.quant_gemv_w4(*args)


# ---------------------------------------------------- composed linear

def _linear_operands(m, d, n, seed, packed):
    r = np.random.default_rng(seed)
    x = r.standard_normal((m, d)).astype(np.float32)
    k = 16
    blocks = (r.standard_normal((d // k, k, k)) / np.sqrt(k) + np.eye(k)
              ).astype(np.float32)
    ha, hb = _factors(d, r)
    sign = (r.integers(0, 2, d) * 2 - 1).astype(np.float32)
    qw = r.integers(-8, 8, (d, n)).astype(np.int8)
    if packed:
        qw = np.asarray(j_pack_int4(jnp.asarray(qw), axis=0))
    sw = r.uniform(0.01, 0.05, (1, n)).astype(np.float32)
    return x, blocks, ha, hb, sign, qw, sw


def _composed_codes(mod, x, blocks, ha, hb, sign, act_bits, **kw):
    """(codes, zero points) of one package's composed linear, as f32."""
    if blocks is not None:
        x = mod.block_matmul(x, blocks, **kw)
    x = mod.hadamard(x, ha, hb, sign, **kw)
    q, _, zp = mod.dyn_quant(x, bits=act_bits, symmetric=False, **kw)
    return _np(q), _np(zp)


def _check_composed(x, blocks, ha, hb, sign, qw, sw, act_bits, packed,
                    dtype):
    """Port vs reference composed linear on the same operands, at the
    bounds of the module docstring."""
    jx, tx = _pair(x, dtype)
    jops_ = [None if a is None else jnp.asarray(a)
             for a in (blocks, ha, hb, sign, qw, sw)]
    tops = [None if a is None else _t(a)
            for a in (blocks, ha, hb, sign, qw, sw)]
    got = ops.cat_transform_matmul(tx, *tops, act_bits=act_bits,
                                   packed_int4=packed)
    assert got.dtype == tx.dtype and got.shape == (x.shape[0], qw.shape[1])
    want = _np(jops.cat_transform_matmul(jx, *jops_, act_bits=act_bits,
                                         packed_int4=packed))
    diff = _dequant_shift(
        *_composed_codes(ops, tx, tops[0], *tops[1:4], act_bits),
        *_composed_codes(jops, jx, jops_[0], *jops_[1:4], act_bits,
                         interpret=True))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= (1e-3 if dtype == "float32" else 1e-2)
    same = (diff == 0).all(axis=1)
    got = _np(got)
    if dtype == "float32":
        np.testing.assert_allclose(got[same], want[same], rtol=1e-4,
                                   atol=1e-4)
    else:
        row_scale = np.abs(want).max(axis=1, keepdims=True)
        assert (np.abs(got - want) <= 2 ** -7 * row_scale)[same].all()
    return same


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("m", [7, 8, 9])
def test_cat_transform_matmul_matches_reference(m, packed, dtype):
    ops_np = _linear_operands(m, 128, 96, seed=m + 10 * packed, packed=packed)
    same = _check_composed(*ops_np, act_bits=4, packed=packed, dtype=dtype)
    assert same.mean() >= 0.5


@pytest.mark.parametrize("packed", [True, False])
def test_composed_equals_fused_in_f32(packed):
    """f32: the composed linear is the fused linear (its plain versions
    share every step), for both the GEMV and the tiled row counts."""
    for m in (5, 40):
        x, *rest = _linear_operands(m, 128, 64, seed=m, packed=packed)
        args = [_t(x)] + [_t(a) for a in rest]
        composed = ops.cat_transform_matmul(*args, act_bits=4,
                                            packed_int4=packed)
        fused = ops.fused_cat_matmul(*args, act_bits=4, packed=packed)
        assert torch.equal(composed, fused)


def test_composed_routes_and_cpu_counters(monkeypatch):
    """Packed weights go to the GEMV up to 8 rows and to the tiled W4A8
    contraction above; int8 weights to the W8A8 one. On CPU tensors no
    kernel counts a launch."""
    calls = []
    for name in ("qgemv_w4", "qmatmul_w4", "qmatmul"):
        real = getattr(ops, name)

        def spy(*a, _real=real, _name=name):
            calls.append(_name)
            return _real(*a)
        monkeypatch.setattr(ops, name, spy)
    before = [k.launches for k in KERNELS]
    for m, packed in ((8, True), (9, True), (3, False), (12, False)):
        x, *rest = _linear_operands(m, 64, 32, seed=m, packed=packed)
        ops.cat_transform_matmul(_t(x), *map(_t, rest), act_bits=4,
                                 packed_int4=packed)
    assert calls == ["qgemv_w4", "qmatmul_w4", "qmatmul", "qmatmul"]
    assert [k.launches for k in KERNELS] == before == [0] * 6


# ---------------------------------------------------------------- slice

@pytest.fixture(scope="module")
def ptq_models():
    """CAT-PTQ'd catlm_60m().smoke() params: W4A4 int4-packed (the golden
    w4_packed case) and W8A4 int8 codes, with the same calibration."""
    from repro.core.pipeline import QuantizeConfig, quantize_model
    from repro.data import calibration_batches
    from repro.models import build
    _, _, w4 = regenerate.build_case("w4_packed")
    cfg, _, fp = regenerate.build_case("fp")
    qcfg = QuantizeConfig(w_bits=8, a_bits=4, transform="cat", cat_block=16)
    w8 = quantize_model(build(cfg), fp, qcfg, calibration_batches(
        cfg, n_seqs=2, seq_len=16, batch=2))
    return {"w4": w4, "w8": w8}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", ["w4", "w8"])
def test_every_ptq_linear_through_both_composed_paths(ptq_models, bits,
                                                      dtype):
    """Every QLinear of the PTQ'd model: its transform decomposes into the
    same (blocks, ha, hb, sign) in both packages, and 8 decode rows and 24
    prefill rows of seeded activations give the same codes and outputs in
    both composed linears."""
    jparams = ptq_models[bits]
    linears = iter_qlinear(from_reference(jparams))
    names = {path.split(".")[-1] for path, _ in linears}
    assert names == {"wq", "wk", "wv", "wo", "wg", "wu", "wd"}
    r = np.random.default_rng(0)
    for path, tp in linears:
        _, layer, name = path.split(".")
        jp = jparams["layers"][name]
        tdec = ops.fused_transform_operands(tp.transform)
        jdec = jops.fused_transform_operands(jp.transform)
        assert tdec is not None and jdec is not None
        assert tp.packed == (bits == "w4") and tp.act_bits == 4
        for a, b in zip(tdec, jdec):
            assert (a is None) == (b is None), path
            if a is not None:
                np.testing.assert_array_equal(a.numpy(),
                                              np.asarray(b)[int(layer)])
        operands = [None if a is None else a.numpy() for a in tdec]
        d_in = tp.d_in if tp.packed else tp.qweight.shape[0]
        for m in (8, 24):
            x = r.standard_normal((m, d_in)).astype(np.float32)
            same = _check_composed(x, *operands, tp.qweight.numpy(),
                                   tp.scale.numpy(), tp.act_bits, tp.packed,
                                   dtype)
            assert same.mean() >= 0.5, path
