"""The paged attentions (rows 3 and 4) on the CPU: their plans, their
wrappers' launches, and their plain versions against the JAX reference.

The CUDA decode kernel (``csrc/paged_attention.cu``) splits an item's key
positions over the CTAs of a thread-block cluster on the plan of
``csrc/attention_plan.h``, which its entry runs on every call. The header
is plain C++ apart from CUDA marks, so here it is compiled with the
host's C++ compiler and read through the same Python functions as on the
card (``paged_attention.decode_plan`` and ``split_range``): every key
position, and so every page, of every item is owned by one split; a
short prefix (what the table holds fits one unit) takes one split; long
ones split up to 8 ways, by the table's width alone (never by the batch,
so a row's bits do not depend on the rows beside it). The wrapper passes the
card's SM count and the forced split and allocates only its output.

The plain decode attention (the only path for CPU tensors, and what
``chip_smoke.py`` holds the kernel against on the card) is held against
the reference's Pallas ``paged_attention_decode`` in interpret mode at
the serving dims (KVH 4, g 2, hd 64, page 16, lengths up to 160 over ten
pages): f32 queries at rtol 1e-5 (atol 1e-5 of the output's scale, for
values near zero: the two einsums associate the f32 dots differently),
bf16 queries within one bf16 ulp with at least 99 % of the outputs
bitwise equal, as ``test_torch_kernels.
test_bf16_plain_attention_follows_pallas_kernels`` holds the smaller
cases.

The ragged attention (row 3) tiles each item's query rows (qi, gi) in
order, 64 per CTA, on the plan of the same header (``ragged_plan``,
``ragged_rows``): every row of every item is owned by one tile. Its plain
version is held against the reference's Pallas ``paged_attention_ragged``
in interpret mode at the edges the card's check runs (mixed decode and
prefill items, padding rows, an item of length 0, q_pos at page
boundaries, hd 32 and 64, g 1, 2, 4, pages of 8 and 16) on the valid
rows, at the tolerances above; its wrapper passes the shapes in the
order of the C prototype and allocates only its output.
"""
import ctypes
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import paged_attention_decode as j_decode
from repro.kernels.paged_attention import paged_attention_ragged as j_ragged
from repro_torch.kernels import build
from repro_torch.kernels import paged_attention as P

torch.set_num_threads(1)

SMS = 132                   # H100 SXM
SMEM_OPTIN = 227 * 1024     # shared memory a CTA may opt into on the H100


@pytest.fixture(scope="module")
def plan_lib(tmp_path_factory):
    """csrc/attention_plan.h built for the host, its exports bound."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build csrc/attention_plan.h")
    out = tmp_path_factory.mktemp("plan") / "attention_plan.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-x", "c++",
                    str(build.CSRC / "attention_plan.h"), "-o", str(out)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    for name in ("pa_decode_plan", "pa_split_range", "pa_ragged_plan",
                 "pa_ragged_rows"):
        fn = getattr(lib, name)
        fn.argtypes = P._SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib


@pytest.mark.parametrize("page_size", [8, 16, 32, 48, 256])
@pytest.mark.parametrize("split", [1, 2, 4, 8])
def test_split_owns_every_position_and_page_once(plan_lib, page_size, split):
    """Over every length up to 20 pages, the splits' ranges tile [0,
    length) in rank order without overlap, and no page is read by two
    splits."""
    for length in range(0, 20 * page_size + 1, 7):
        owner_pos = np.zeros(length, int)
        owner_page = {}
        last = 0
        for rank in range(split):
            rng = P.split_range(length, page_size, split, rank, lib=plan_lib)
            assert rng.start == last or len(rng) == 0
            last = max(last, rng.stop)
            owner_pos[rng.start:rng.stop] += 1
            for page in {p // page_size for p in rng}:
                assert owner_page.setdefault(page, rank) == rank
        assert (owner_pos == 1).all() and last == length


def test_plan_takes_one_split_for_short_prefixes(plan_lib):
    """Serving dims (8 items of 4 KV heads, g 2, hd 64, page 16): the
    table's width sets the split. Up to one 128-position unit (the served
    tables hold 4 pages) one split; then one unit per split at least, up to
    8, at any batch (the split orders a row's combine, so it may not hang
    on the batch); forced splits 1..8 taken, others refused; shared memory
    within the card's 227 KiB at every hd and g."""
    def plan(n_ptab, split=0, b=8, g=2, hd=64, ps=16):
        return P.decode_plan(b, 4, g, hd, ps, n_ptab, SMS, SMEM_OPTIN,
                             split, lib=plan_lib)
    assert [plan(n).split for n in (1, 4, 8, 10, 16, 32, 64, 128)] == [
        1, 1, 1, 2, 2, 4, 8, 8]
    assert plan(4).ctas == 32 and plan(128).ctas == 256
    for b in (1, 5, 40, 64):                    # not by the batch
        assert plan(10, b=b).split == 2 and plan(128, b=b).split == 8
    assert plan(128, b=64).ctas == 64 * 4 * 8
    assert plan(128, g=9) == P.DecodePlan(8, 8 * 4 * 2 * 8,     # two row
                                          plan(128, 8, g=8).smem)  # groups
    for split in range(1, 9):
        assert plan(10, split).split == split
    for hd in range(8, 257, 8):
        for g in (1, 2, 4, 8):
            assert plan(128, 0, g=g, hd=hd).smem <= SMEM_OPTIN
            if hd <= 128 or g < 8:      # 8 splits' states fit
                assert plan(128, 8, g=g, hd=hd).smem <= SMEM_OPTIN
    for bad in (dict(split=9), dict(split=-1), dict(hd=20),
                dict(n_ptab=0), dict(ps=0)):
        kw = dict(n_ptab=10) | bad
        with pytest.raises(ValueError, match="does not take"):
            plan(**kw)


def _pool(seed, b, kvh, g, hd, ps, n_ptab, lengths):
    r = np.random.default_rng(seed)
    n_pages = 1 + b * n_ptab
    kp = r.integers(-127, 128, (n_pages, ps, kvh, hd)).astype(np.int8)
    vp = r.integers(-127, 128, (n_pages, ps, kvh, hd)).astype(np.int8)
    ks = r.uniform(0.01, 0.1, (n_pages, ps, kvh, 1)).astype(np.float32)
    vs = r.uniform(0.01, 0.1, (n_pages, ps, kvh, 1)).astype(np.float32)
    table = np.zeros((b, n_ptab), np.int32)
    nxt = 1
    for i, ln in enumerate(lengths):
        for j in range(-(-ln // ps)):
            table[i, j] = nxt
            nxt += 1
    q = r.standard_normal((b, kvh, g, hd)).astype(np.float32)
    return q, kp, ks, vp, vs, table, np.asarray(lengths, np.int32)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _bf16_ulps(a, b):
    ai, bi = _t(a).to(torch.bfloat16), _t(b).to(torch.bfloat16)
    return (ai.view(torch.int16).int() - bi.view(torch.int16).int()).abs()


SERVED = (160, 1, 17, 64, 100, 33, 5, 128)   # lengths over ten pages of 16


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_decode_matches_pallas_at_serving_dims(seed):
    args = _pool(seed, 8, 4, 2, 64, 16, 10, SERVED)
    want = np.asarray(j_decode(*map(jnp.asarray, args), interpret=True))
    got = P.paged_attention_decode(*map(_t, args)).numpy()
    # f32 association of the score dots and P.V sums (einsum orders
    # differ): rtol 1e-5, and 1e-5 of the output's scale near zero
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    jq = jnp.asarray(args[0]).astype(jnp.bfloat16)
    want = np.asarray(j_decode(jq, *map(jnp.asarray, args[1:]),
                               interpret=True).astype(jnp.float32))
    tq = _t(np.asarray(jq.astype(jnp.float32))).to(torch.bfloat16)
    got = P.paged_attention_decode(tq, *map(_t, args[1:])).float().numpy()
    ulps = _bf16_ulps(got, want)
    assert ulps.max() <= 1 and (ulps == 0).float().mean() >= 0.99


class _FakeLib:
    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def fn(*args):
            self.calls.append((name, args))
            return 0
        return fn


def test_decode_wrapper_passes_the_card_and_the_split(monkeypatch):
    """The launch passes the card's SM count and the forced split (0: the
    plan's), in the order of the C prototype, and allocates the output
    and nothing else."""
    args = [_t(a) for a in _pool(3, 2, 4, 2, 64, 16, 3, (40, 7))]
    lib = _FakeLib()
    monkeypatch.setattr(build, "load", lambda name, sigs: lib)
    monkeypatch.setattr(build, "stream_of", lambda t: ctypes.c_void_p(0))
    monkeypatch.setattr(build, "sm_count", lambda device: SMS)
    allocs = []
    for name in ("empty", "zeros", "empty_like", "zeros_like", "full"):
        real = getattr(torch, name)

        def spy(*a, _real=real, _name=name, **kw):
            allocs.append(_name)
            return _real(*a, **kw)
        monkeypatch.setattr(torch, name, spy)
    out = P._launch_decode(*args)
    P._launch_decode(*args, split=4)
    assert allocs == ["empty_like", "empty_like"]
    assert out.shape == args[0].shape
    (name, first), (_, second) = lib.calls
    assert name == "paged_attention_decode"
    assert len(first) == len(P._SIGNATURES[name])
    # ..., lengths, B, KVH, g, hd, page_size, q_scale, sms, split, out, stream
    assert first[9:14] == (2, 4, 2, 64, 16)
    assert first[15:17] == (SMS, 0) and second[15:17] == (SMS, 4)


@pytest.mark.parametrize("nq,g", [(1, 1), (1, 8), (32, 2), (33, 2),
                                  (128, 2), (40, 3), (7, 8), (256, 1)])
def test_ragged_plan_owns_every_row_once(plan_lib, nq, g):
    """Every query row r = qi·g + gi of an item lies in one tile of 64
    rows, in order, with no empty tile; one CTA per (item, KV head,
    tile); shared memory within the card's at every head dim taken (a
    multiple of 8 up to 256)."""
    plan = P.ragged_plan(8, nq, 4, g, 64, 16, SMEM_OPTIN, lib=plan_lib)
    assert plan.tiles == -(-nq * g // 64)
    assert plan.ctas == 8 * 4 * plan.tiles
    owned = np.zeros(nq * g, int)
    for tile in range(plan.tiles):
        rows = P.ragged_rows(nq, g, tile, lib=plan_lib)
        assert len(rows) and rows.start == 64 * tile
        owned[list(rows)] += 1
    assert (owned == 1).all()
    for hd in range(8, 257, 8):
        assert P.ragged_plan(8, nq, 4, g, hd, 16, SMEM_OPTIN,
                             lib=plan_lib).smem <= SMEM_OPTIN


def test_ragged_plan_refuses_what_the_kernel_does_not_take(plan_lib):
    for bad in (dict(hd=20), dict(hd=264), dict(nq=0), dict(g=0),
                dict(ps=0), dict(n=0), dict(smem=32 * 1024)):
        kw = dict(n=8, nq=128, g=2, hd=64, ps=16, smem=SMEM_OPTIN) | bad
        with pytest.raises(ValueError, match="does not take"):
            P.ragged_plan(kw["n"], kw["nq"], 4, kw["g"], kw["hd"], kw["ps"],
                          kw["smem"], lib=plan_lib)


def _ragged_case(seed, items, nq, kvh, g, hd, ps):
    """Work items (q_len, length) in a query block of nq rows: distinct
    pages per item, null pages past each length, padding rows q_pos -1."""
    r = np.random.default_rng(seed)
    n_ptab = max(1, max(-(-ln // ps) for _, ln in items))
    n_pages = 1 + len(items) * n_ptab
    kp = r.integers(-127, 128, (n_pages, ps, kvh, hd)).astype(np.int8)
    vp = r.integers(-127, 128, (n_pages, ps, kvh, hd)).astype(np.int8)
    ks = r.uniform(0.01, 0.1, (n_pages, ps, kvh, 1)).astype(np.float32)
    vs = r.uniform(0.01, 0.1, (n_pages, ps, kvh, 1)).astype(np.float32)
    table = np.zeros((len(items), n_ptab), np.int32)
    qpos = np.full((len(items), nq), -1, np.int32)
    for i, (ql, ln) in enumerate(items):
        used = -(-ln // ps)
        table[i, :used] = 1 + i * n_ptab + np.arange(used)
        qpos[i, :ql] = np.arange(ln - ql, ln)
    lengths = np.asarray([ln for _, ln in items], np.int32)
    q = r.standard_normal((len(items), nq, kvh, g, hd)).astype(np.float32)
    return [q, kp, ks, vp, vs, table, lengths, qpos]


RAGGED_EDGES = [  # (hd, g, ps): the card's edge grid, cut to CPU size
    (32, 1, 8), (32, 4, 16), (64, 2, 8), (64, 1, 16), (32, 2, 8)]


@pytest.mark.parametrize("hd,g,ps", RAGGED_EDGES)
def test_plain_ragged_matches_pallas_at_edges(hd, g, ps):
    """Mixed decode and prefill items, q_pos at ps - 1, ps, ps + 1, a
    prefill chunk ending past a page, an item of length 0 and padding
    rows past the longest item, on the valid rows: f32 queries at rtol
    1e-5 (atol 1e-5 of the scale), bf16 queries within one bf16 ulp with
    at least 99 % bitwise."""
    items = [(1, ps), (ps + 2, ps + 2), (1, ps + 1), (0, 0),
             (5, 3 * ps + 5), (1, ps + 2), (1, 1)]
    nq = ps + 5
    args = _ragged_case(hd * 10 + g + ps, items, nq, 2, g, hd, ps)
    valid = args[-1] >= 0
    want = np.asarray(j_ragged(*map(jnp.asarray, args), interpret=True))
    got = P.paged_attention_ragged(*map(_t, args)).numpy()
    np.testing.assert_allclose(got[valid], want[valid], rtol=1e-5,
                               atol=1e-5 * np.abs(want[valid]).max())
    jq = jnp.asarray(args[0]).astype(jnp.bfloat16)
    want = np.asarray(j_ragged(jq, *map(jnp.asarray, args[1:]),
                               interpret=True).astype(jnp.float32))
    tq = _t(np.asarray(jq.astype(jnp.float32))).to(torch.bfloat16)
    got = P.paged_attention_ragged(tq, *map(_t, args[1:])).float().numpy()
    ulps = _bf16_ulps(got[valid], want[valid])
    assert ulps.max() <= 1 and (ulps == 0).float().mean() >= 0.99


def test_ragged_wrapper_passes_the_shapes(monkeypatch):
    """The ragged launch passes (R, Q, KVH, g, hd, page_size) in the order
    of the C prototype and allocates the output and nothing else; a
    device that is neither CUDA nor the CPU raises."""
    args = [_t(a) for a in _ragged_case(4, [(3, 9), (1, 17)], 5, 4, 2, 64,
                                        16)]
    with pytest.raises(TypeError, match="CUDA tensors"):
        P.paged_attention_ragged(args[0].to("meta"), *args[1:])
    lib = _FakeLib()
    monkeypatch.setattr(build, "load", lambda name, sigs: lib)
    monkeypatch.setattr(build, "stream_of", lambda t: ctypes.c_void_p(0))
    allocs = []
    for name in ("empty", "zeros", "empty_like", "zeros_like", "full"):
        real = getattr(torch, name)

        def spy(*a, _real=real, _name=name, **kw):
            allocs.append(_name)
            return _real(*a, **kw)
        monkeypatch.setattr(torch, name, spy)
    out = P._launch_ragged(*args)
    assert allocs == ["empty_like"] and out.shape == args[0].shape
    (name, call), = lib.calls
    assert name == "paged_attention_ragged"
    assert len(call) == len(P._SIGNATURES[name])
    # q, bf16, k, ks, v, vs, table, n_ptab, lengths, q_pos, R, Q, KVH, g,
    # hd, page_size, q_scale, out, stream
    assert call[7] == 2 and call[10:16] == (2, 5, 4, 2, 64, 16)
