"""The launch plans of the port's thread-block cluster kernels, their
wrappers' checks and the ctypes bindings of every CUDA entry point, on
the CPU (no card, no CUDA compiler).

The decode fused CAT linear (``fused_cat_gemv_w4``, one launch), the
tiled fused linear's transform-quant stage (``fused_cat_matmul_w4``, M >
8) and the decode QKV prologue run in clusters of CTAs whose shape is the
CUDA source's plan (``csrc/cluster_plan.h``: which shapes the transform
splits over, the shared-memory layout, the plans), which their entries
compute on every call. The header is plain C++ apart from CUDA marks, so
here it is compiled with the host's C++ compiler and its plans are read
through the same Python functions as on the card
(``fused_cat_matmul.gemv_plan`` and ``tiled_plan``,
``decode_layer.prologue_plan``). At the serving widths (D 512 and 1536,
the four serving (D, N) shapes and ragged N) and the smoke and other
power-of-two-times-three widths (D 128, 256, 384, 768), every M in 1..8,
int4-packed and int8 weights: every output column and every K element is
owned exactly once, shared memory per CTA stays within the H100's 227
KiB, clusters stay at the portable size (8), and each prologue head is
owned by one CTA. The tiled stage's plan owns every row of a step and
every K of each row once at ragged M and every rows-per-cluster choice,
and takes exactly the widths the decode kernel's split rule takes. The bindings' argument lists are held against the
``extern "C"`` prototypes of ``csrc/*.cu`` and the headers they include.
"""
import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from repro_torch.core.hadamard import hadamard_factors
from repro_torch.core.quantizers import pack_int4
from repro_torch.kernels import block_matmul, build, decode_layer
from repro_torch.kernels import dynamic_quant, hadamard, paged_attention
from repro_torch.kernels import fused_cat_matmul as F
from repro_torch.kernels import quant_matmul

torch.set_num_threads(1)

SMS = 132                   # H100 SXM
SMEM_OPTIN = 227 * 1024     # shared memory a CTA may opt into on the H100
SERVING = [(512, 1024), (512, 512), (512, 3072), (1536, 512)]
RAGGED = [(512, 520), (1536, 1000), (512, 40)]
# the smoke config's widths (d_model 128 = 16 x 8, d_ff 256) and widths
# whose factor is 24 (384 = 16 x 24, 768 = 32 x 24)
OTHER = [(128, 256), (128, 128), (256, 128), (384, 1000), (768, 3072)]


@pytest.fixture(scope="module")
def plan_lib(tmp_path_factory):
    """csrc/cluster_plan.h built for the host, its plan exports bound."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build csrc/cluster_plan.h")
    out = tmp_path_factory.mktemp("plan") / "cluster_plan.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-x", "c++",
                    str(build.CSRC / "cluster_plan.h"), "-o", str(out)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    for name, sig in (("ctq_gemv_plan", F._SIGNATURES["ctq_gemv_plan"]),
                      ("ctq_tiled_plan", F._SIGNATURES["ctq_tiled_plan"]),
                      ("ctq_prologue_plan",
                       decode_layer._SIGNATURES["ctq_prologue_plan"])):
        fn = getattr(lib, name)
        fn.argtypes = sig
        fn.restype = ctypes.c_int
    return lib


def _factors(d):
    ha, hb = hadamard_factors(d)
    return ha.shape[0], hb.shape[0]


def _gemv_plan(lib, m, d, n, bk, packed, cols=0):
    a, b = _factors(d)
    return F.gemv_plan(m, d, n, a, b, bk, packed, SMS, SMEM_OPTIN, cols,
                       lib=lib)


@pytest.mark.parametrize("d,n", SERVING + RAGGED + OTHER)
@pytest.mark.parametrize("packed", [True, False])
def test_gemv_plan_owns_every_column_and_k_once(plan_lib, d, n, packed):
    a, b = _factors(d)
    for m in range(1, 9):
        plan = _gemv_plan(plan_lib, m, d, n, 32, packed)
        assert 1 <= plan.cluster <= 8
        assert plan.cols % 16 == 0 and 16 <= plan.cols <= 256
        assert plan.smem <= SMEM_OPTIN
        k_owned = np.zeros(d, int)
        for rank in range(plan.cluster):
            k_set = plan.k_set(rank, a, b)
            assert len(k_set) == d // plan.cluster
            k_owned[k_set] += 1
        assert (k_owned == 1).all()
        col_owned = np.zeros(n, int)
        for g in range(plan.clusters):
            for rank in range(plan.cluster):
                col_owned[list(plan.columns(g, rank, n))] += 1
        assert (col_owned == 1).all()
        # no cluster is idle: its first CTA has columns
        assert plan.clusters == 1 or len(plan.columns(plan.clusters - 1, 0,
                                                      n))
        # at most one CTA per SM
        assert plan.clusters == 1 or plan.clusters * plan.cluster <= SMS
    # the serving shapes take clusters of 8
    if (d, n) in SERVING:
        assert plan.cluster == 8
        assert plan.clusters == {1024: 8, 512: 4, 3072: 12}[n]


@pytest.mark.parametrize("cols", [4, 8, 12, 16, 32, 64, 128])
def test_gemv_plan_takes_forced_columns(plan_lib, cols):
    """The column sweep's plans (a multiple of 4 up to 128 columns per
    CTA) own each of wd's 512 columns once; other counts are refused."""
    plan = _gemv_plan(plan_lib, 8, 1536, 512, 32, True, cols)
    assert plan.cols == cols and plan.cluster == 8
    assert plan.clusters == -(-512 // (8 * cols))
    owned = np.zeros(512, int)
    for g in range(plan.clusters):
        for rank in range(8):
            owned[list(plan.columns(g, rank, 512))] += 1
    assert (owned == 1).all()
    for bad in (cols + 2, 260):
        with pytest.raises(ValueError, match="does not take"):
            _gemv_plan(plan_lib, 8, 1536, 512, 32, True, bad)


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("d,hd,n_q,kvh,cluster", [
    (512, 64, 512, 4, 8),       # catlm-60m: 8 q + 4 k + 4 v heads of 64
    (128, 32, 128, 2, 4)])      # its smoke config: 4 q + 2 k + 2 v of 32
def test_prologue_plan_owns_each_head_once(plan_lib, packed, d, hd, n_q, kvh,
                                           cluster):
    a, b = _factors(d)
    n = n_q + 2 * kvh * hd
    for m in range(1, 9):
        plan = decode_layer.prologue_plan(m, d, n, hd, a, b, 32, packed,
                                          SMEM_OPTIN, lib=plan_lib)
        assert plan.cluster == cluster and plan.cols == hd
        assert plan.clusters * plan.cluster == n // hd
        assert plan.smem <= SMEM_OPTIN
        owned = np.zeros(n // hd, int)
        for g in range(plan.clusters):
            owned[list(plan.heads(g))] += 1
        assert (owned == 1).all()
    # no blocks (a bare Hadamard) splits the same way
    assert decode_layer.prologue_plan(8, d, n, hd, a, b, 0, True, SMEM_OPTIN,
                                      lib=plan_lib).cluster == cluster


def test_plans_refuse_what_the_kernels_do_not_take(plan_lib):
    with pytest.raises(ValueError, match="does not take"):
        _gemv_plan(plan_lib, 9, 512, 64, 32, True)
    with pytest.raises(ValueError, match="does not take"):
        F.gemv_plan(4, 48, 64, 4, 12, 0, True, SMS, SMEM_OPTIN,
                    lib=plan_lib)                 # D/c never % 32
    with pytest.raises(ValueError, match="does not take"):
        F.gemv_plan(4, 512, 64, 32, 16, 6, True, SMS, SMEM_OPTIN,
                    lib=plan_lib)                 # CAT block not % 4
    with pytest.raises(ValueError, match="does not take"):
        F.gemv_plan(8, 1536, 512, 32, 48, 32, True, SMS, 64 * 1024,
                    lib=plan_lib)                 # shared memory too small
    a, b = _factors(512)
    with pytest.raises(ValueError, match="does not take"):
        decode_layer.prologue_plan(0, 512, 1024, 64, a, b, 32, True,
                                   SMEM_OPTIN, lib=plan_lib)
    # a cluster of c needs D/c a multiple of 32 and of the CAT block, and
    # b/c even: 4 at D 128 = 16 x 8, 8 at 256 = 16 x 16, 4 at D 384 =
    # 16 x 24 and 768 = 32 x 24, 1 at 96 = 8 x 12
    for d, bk, c in ((128, 32, 4), (128, 0, 4), (256, 32, 8), (384, 32, 4),
                     (768, 32, 4), (96, 32, 1)):
        assert _gemv_plan(plan_lib, 8, d, 64, bk, True).cluster == c, d


TILED_ROWS = (9, 15, 17, 100, 128, 129, 255)


@pytest.mark.parametrize("d", [512, 1536, 128, 256, 384, 768])
@pytest.mark.parametrize("rows", [0, 1, 2, 4, 8])
def test_tiled_plan_owns_every_row_and_k_once(plan_lib, d, rows):
    """Each row of a ragged step falls in exactly one cluster's row group
    and each K of it in exactly one CTA's K set, with the decode kernel's
    cluster size for the width; 8 rows per cluster unless forced."""
    a, b = _factors(d)
    for m in TILED_ROWS:
        plan = F.tiled_plan(m, d, a, b, 32, SMEM_OPTIN, rows, lib=plan_lib)
        assert plan.rows == (rows or 8)
        assert plan.cluster == _gemv_plan(plan_lib, 8, d, 64, 32,
                                          True).cluster
        assert plan.smem <= SMEM_OPTIN
        owned = np.zeros(m, int)
        for g in range(plan.clusters):
            group = plan.row_group(g, m)
            assert len(group)                # no idle cluster
            owned[list(group)] += 1
        assert (owned == 1).all()
        k_owned = np.zeros(d, int)
        for rank in range(plan.cluster):
            k_owned[plan.k_set(rank, a, b)] += 1
        assert (k_owned == 1).all()


def test_tiled_plan_refuses_what_the_kernel_does_not_take(plan_lib):
    """The tiled stage refuses exactly the widths the cluster transform
    does not split (as the decode plan does), rows per cluster outside
    1..8 and a step of no rows; a wide D that the old one-row-per-CTA
    stage refused in Python (over 48 KiB of shared memory) is taken."""
    for d, a, b, bk in ((48, 4, 12, 0), (512, 32, 16, 6), (96, 8, 12, 32),
                        (128, 16, 8, 32), (512, 32, 16, 0), (768, 32, 24, 0)):
        try:
            c = F.gemv_plan(8, d, 64, a, b, bk, True, SMS, SMEM_OPTIN,
                            lib=plan_lib).cluster
        except ValueError:
            c = 0
        if c:
            plan = F.tiled_plan(128, d, a, b, bk, SMEM_OPTIN, lib=plan_lib)
            assert (plan.cluster, plan.clusters) == (c, 16)
        else:
            with pytest.raises(ValueError, match="does not take"):
                F.tiled_plan(128, d, a, b, bk, SMEM_OPTIN, lib=plan_lib)
    # D 4096: 4 * (2 D + a^2 + b^2) bytes, over the old stage's 48 KiB
    assert 4 * (2 * 4096 + 64 * 64 * 2) > 48 * 1024
    assert F.tiled_plan(128, 4096, 64, 64, 32, SMEM_OPTIN,
                        lib=plan_lib).cluster == 8
    for m, rows in ((0, 0), (128, 9), (128, -1)):
        with pytest.raises(ValueError, match="does not take"):
            F.tiled_plan(m, 512, 32, 16, 32, SMEM_OPTIN, rows, lib=plan_lib)
    with pytest.raises(ValueError, match="does not take"):
        F.tiled_plan(128, 1536, 32, 48, 32, 32 * 1024, lib=plan_lib)


def _gemv_operands(m, d, n, seed=0):
    r = np.random.default_rng(seed)
    ha, hb = (torch.from_numpy(h.astype(np.float32))
              for h in hadamard_factors(d))
    x = torch.from_numpy(r.standard_normal((m, d)).astype(np.float32))
    blocks = torch.from_numpy((r.standard_normal((d // 32, 32, 32)) * 0.2
                               + np.eye(32)).astype(np.float32))
    sign = torch.from_numpy(r.choice([-1.0, 1.0], d).astype(np.float32))
    codes = torch.from_numpy(r.integers(-8, 8, (d, n)).astype(np.int8))
    sw = torch.from_numpy(r.uniform(0.001, 0.02, (1, n)).astype(np.float32))
    return x, blocks, ha, hb, sign, pack_int4(codes, axis=0), sw


class _FakeLib:
    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def fn(*args):
            self.calls.append((name, args))
            return 0
        return fn


def test_gemv_wrapper_checks_and_allocates_no_scratch(monkeypatch):
    """The decode wrapper raises above 8 rows and for a device that is
    neither CUDA nor the CPU; its launch passes the card's SM count (the
    entry computes its plan) and allocates the output and nothing else
    (no code scratch)."""
    x, blocks, ha, hb, sign, qw, sw = _gemv_operands(8, 512, 1000)
    with pytest.raises(ValueError, match="M <= 8"):
        F.fused_cat_gemv_w4(torch.cat([x, x[:1]]), blocks, ha, hb, sign, qw,
                            sw, act_bits=4)
    with pytest.raises(TypeError, match="CUDA tensors"):
        F.fused_cat_gemv_w4(x.to("meta"), blocks, ha, hb, sign, qw, sw,
                            act_bits=4)
    with pytest.raises(TypeError, match="qw must be on"):
        F._launch_gemv(x, blocks, ha, hb, sign, qw.to("meta"), sw, 4, True)
    lib = _FakeLib()
    monkeypatch.setattr(build, "load", lambda name, sigs: lib)
    monkeypatch.setattr(build, "stream_of", lambda t: ctypes.c_void_p(0))
    monkeypatch.setattr(F, "sm_count", lambda index: SMS)
    allocs = []
    for name in ("empty", "zeros", "empty_like", "zeros_like", "full"):
        real = getattr(torch, name)

        def spy(*args, _real=real, _name=name, **kw):
            allocs.append(_name)
            return _real(*args, **kw)
        monkeypatch.setattr(torch, name, spy)
    out = F._launch_gemv(x, blocks, ha, hb, sign, qw, sw, 4, True)
    assert allocs == ["empty"] and out.shape == (8, 1000)
    (name, args), = lib.calls
    assert name == "fused_cat_gemv_w4"
    assert len(args) == len(F._SIGNATURES[name])
    assert args[-4:-2] == (SMS, 0)   # the card's SMs; the plan's columns


def test_tiled_wrapper_passes_rows_and_checks_no_shared_memory(
        monkeypatch):
    """The tiled wrapper leaves the stage-1 plan to the CUDA entry: it
    passes the rows per cluster (0: the plan's) and the code scratch, and
    no longer refuses a wide D in Python (the old 48 KiB check)."""
    lib = _FakeLib()
    monkeypatch.setattr(build, "load", lambda name, sigs: lib)
    monkeypatch.setattr(build, "stream_of", lambda t: ctypes.c_void_p(0))
    monkeypatch.setattr(F, "w8a8_plan", lambda m, k, n, dev: (1, None))
    x, blocks, ha, hb, sign, qw, sw = _gemv_operands(128, 4096, 64)
    out = F._launch_tiled(x, blocks, ha, hb, sign, qw, sw, 4, True)
    assert out.shape == (128, 64)
    out = F._launch_tiled(x, blocks, ha, hb, sign, qw, sw, 4, True, rows=2)
    (name, args0), (_, args1) = lib.calls
    assert name == "fused_cat_matmul_w4"
    assert len(args0) == len(F._SIGNATURES[name])
    # x, x_is_bf16, m, d, k_pad, ..., sw, n (16), rows, splits
    assert (args0[4], args0[16]) == (4096, 64)               # k_pad, n
    assert (args0[17], args1[17], args0[18]) == (0, 2, 1)    # rows, splits


def test_prologue_wrapper_refuses_other_devices():
    x = torch.zeros((2, 512), device="meta")
    with pytest.raises(TypeError, match="CUDA tensors"):
        decode_layer.decode_qkv_prologue(
            x, None, x, x, x, x, x, x, x, x, x, x, x, x, n_q=512,
            head_dim=64, rope_theta=1e4)


_CTYPES = {"int": ctypes.c_int, "float": ctypes.c_float,
           "int*": ctypes.POINTER(ctypes.c_int),
           "longlong*": ctypes.POINTER(ctypes.c_longlong)}


def _prototypes(name: str) -> dict:
    """{name: [ctypes type of each parameter]} of the ``extern "C"``
    functions of a CUDA source or header and the local headers it
    includes."""
    text = (build.CSRC / name).read_text()
    out = {}
    for header in re.findall(r'#include "([\w.]+)"', text):
        out.update(_prototypes(header))
    for fn, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text):
        types = []
        for param in params.split(","):
            ctype = re.match(r"(.*?)\w+$", param.replace("const ", "")
                             .strip()).group(1).replace(" ", "")
            types.append(_CTYPES.get(ctype, ctypes.c_void_p
                                     if ctype.endswith("*") else None))
        out[fn] = types
    return out


@pytest.mark.parametrize("module,source", [
    (F, "fused_cat_matmul"), (decode_layer, "decode_layer"),
    (paged_attention, "paged_attention"), (block_matmul, "block_matmul"),
    (hadamard, "hadamard"), (dynamic_quant, "dynamic_quant"),
    (quant_matmul, "quant_matmul")])
def test_bindings_match_the_sources(module, source):
    """Each wrapper's ctypes argument list equals its C prototype, type by
    type (a pointer as c_void_p, an int as c_int): a mismatch would pass
    a cut pointer or shifted arguments to the card. Every entry of the
    source itself is bound; of its headers' entries, those it uses."""
    protos = _prototypes(f"{source}.cu")
    own = re.findall(r'extern "C" int (\w+)\(',
                     (build.CSRC / f"{source}.cu").read_text())
    assert set(own) <= set(module._SIGNATURES) <= set(protos)
    for name, types in module._SIGNATURES.items():
        assert types == protos[name], name
