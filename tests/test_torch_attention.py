"""The decode paged attention (row 4) on the CPU: its split plan, its
wrapper's launch, and its plain version against the JAX reference.

The CUDA decode kernel (``csrc/paged_attention.cu``) splits an item's key
positions over the CTAs of a thread-block cluster on the plan of
``csrc/attention_plan.h``, which its entry runs on every call. The header
is plain C++ apart from CUDA marks, so here it is compiled with the
host's C++ compiler and read through the same Python functions as on the
card (``paged_attention.decode_plan`` and ``split_range``): every key
position, and so every page, of every item is owned by one split; a
short prefix (what the table holds fits one unit) takes one split; long
ones split up to 8 ways while the card has room. The wrapper passes the
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
"""
import ctypes
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import paged_attention_decode as j_decode
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
    for name in ("pa_decode_plan", "pa_split_range"):
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
    8, with at most two CTAs per SM; forced splits 1..8 taken, others
    refused; shared memory within the card's 227 KiB at every hd and g."""
    def plan(n_ptab, split=0, b=8, g=2, hd=64, ps=16):
        return P.decode_plan(b, 4, g, hd, ps, n_ptab, SMS, SMEM_OPTIN,
                             split, lib=plan_lib)
    assert [plan(n).split for n in (1, 4, 8, 10, 16, 32, 64, 128)] == [
        1, 1, 1, 2, 2, 4, 8, 8]
    assert plan(4).ctas == 32 and plan(128).ctas == 256
    assert plan(128, b=64).split == 1           # 256 CTAs fill the card
    assert plan(128, g=9) == P.DecodePlan(4, 8 * 4 * 2 * 4,     # two row
                                          plan(128, 4, g=8).smem)  # groups
    for split in range(1, 9):
        assert plan(10, split).split == split
    for hd in (32, 64, 128):
        for g in (1, 2, 4, 8):
            assert plan(128, 8, g=g, hd=hd).smem <= SMEM_OPTIN
    for bad in (dict(split=9), dict(split=-1), dict(hd=48),
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
    monkeypatch.setattr(P, "sm_count", lambda index: SMS)
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
