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
and takes exactly the widths the decode kernel's plan takes. Widths that
split over no cluster (odd D, factors or CAT blocks that are not
multiples of 4: the reference's own test widths) take the general path on
a cluster of one CTA, which owns every K; only what the reference refuses
(a CAT block that does not divide D), M or rows outside 1..8 and shared
memory that does not fit are refused. The code GEMV of rows 7 and 8
(``quant_matmul.gemv_plan``, the same header) owns every output column
once and spreads N 3072 over more CTAs than the card has SMs. The
bindings' argument lists are held against the ``extern "C"`` prototypes
of ``csrc/*.cu`` and the headers they include.
"""
import ctypes
import hashlib
import importlib.util
import re
import shutil
import subprocess
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
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
                       decode_layer._SIGNATURES["ctq_prologue_plan"]),
                      ("ctq_code_gemv_plan",
                       quant_matmul._SIGNATURES["ctq_code_gemv_plan"]),
                      ("ctq_stream_plan",
                       quant_matmul._SIGNATURES["ctq_stream_plan"]),
                      ("ctq_stream_totals",
                       quant_matmul._SIGNATURES["ctq_stream_totals"]),
                      ("ctq_wide_scratch", F._SIGNATURES["ctq_wide_scratch"])):
        fn = getattr(lib, name)
        fn.argtypes = sig
        fn.restype = ctypes.c_int
    return lib


# (D, N) of the serving linears of the dense family's configs at full
# width (the concatenated wqkv, wo, wgu or the ungated wu, wd) and their
# QKV heads (D, N, head_dim)
FAMILY_ARCHS = ("mistral_nemo_12b", "granite_34b", "gemma2_2b",
                "gemma3_12b", "paligemma_3b")


def _family_shapes():
    linears, qkv = [], []
    for arch in FAMILY_ARCHS:
        cfg = get_config(arch)
        up = 2 * cfg.d_ff if cfg.gated_mlp else cfg.d_ff
        for shape in ((cfg.d_model, cfg.q_dim + 2 * cfg.kv_dim),
                      (cfg.q_dim, cfg.d_model), (cfg.d_model, up),
                      (cfg.d_ff, cfg.d_model)):
            if shape not in linears:
                linears.append(shape)
        qkv.append((cfg.d_model, cfg.q_dim + 2 * cfg.kv_dim, cfg.head_dim))
    return linears, qkv


FAMILY_LINEARS, FAMILY_QKV = _family_shapes()


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


def _owned_once(plan, n, a, b, d):
    """Every output column of an N-column linear in one CTA's columns (on
    the streamed path: one column tile), and every K of D in one CTA's K
    set; every (column, K) pair of the contraction in one work item (on
    the streamed path: one K split of its tile; on the cluster path the
    CTA owning the column contracts all of K)."""
    col_owned = np.zeros(n, int)
    for g in range(plan.clusters):
        for rank in range(plan.cluster):
            col_owned[list(plan.columns(g, rank, n))] += 1
    k_owned = np.zeros(d, int)
    for rank in range(plan.cluster):
        k_owned[plan.k_set(rank, a, b)] += 1
    return ((col_owned == 1).all() and (k_owned == 1).all()
            and _splits_partition(plan, d))


def _splits_partition(plan, d):
    """The K splits of a tile (the same for every tile) are non-empty and
    cover [0, D) end to end, so with every column in one tile every
    (column, K) pair is in one work item."""
    ks = [plan.k_range(s, d) for s in range(plan.splits)]
    return (all(len(r) for r in ks) and ks[0].start == 0
            and ks[-1].stop == d
            and all(x.stop == y.start for x, y in zip(ks, ks[1:])))


def _streamed_ok(plan, m, d, smem_optin=SMEM_OPTIN):
    """A streamed plan's invariants: two CTAs per SM where a ring fits in
    half an SM's shared memory, else one (cluster 1), columns per tile a
    multiple of 4 (the plan's own: 32, 64 or 128), stages of a power of
    two K in 32..2048 in a ring of 2..16, within the CTA's share of shared
    memory beside the kernels' static 4 KiB, no more splits than
    stages."""
    assert plan.path == 1 and getattr(plan, "cluster", 1) == 1
    assert plan.cols % 4 == 0 and 4 <= plan.cols <= 256
    assert plan.ktile in (32, 64, 128, 256, 512, 1024, 2048)
    assert 2 <= plan.stages <= 16 and plan.splits >= 1
    assert plan.per_sm in (1, 2)     # CTAs per SM, in their share of it
    share = (smem_optin if plan.per_sm == 1
             else (smem_optin + 1024) // 2 - 1024)
    assert plan.smem + 4096 <= share
    steps = -(-d // plan.ktile)
    assert plan.splits <= steps


@pytest.mark.parametrize("d,n", FAMILY_LINEARS)
@pytest.mark.parametrize("packed", [True, False])
def test_family_widths_take_every_plan(plan_lib, d, n, packed):
    """Every serving linear of the dense family's configs: the decode plan
    at M 1..8 and the tiled stage's at ragged M 9..255 own every output
    column (rows of the step) and every K once, fit in the H100's 227 KiB
    beside the kernels' static shared memory and keep clusters at the
    portable 8; what a cluster cannot hold takes the streamed path (one
    CTA per SM: cluster 1, tiles of 32, 64 or 128 columns, each tile's K
    split into non-empty stage runs that own every (column, K) pair once,
    a ring of 2..16 stages of 32..2048 K), whose scratch holds the
    transform's two f32 planes, the codes and, split, every split's int32
    partial sums. The same header also forced to 64 KiB
    takes every shape on a shallower ring."""
    a, b = _factors(d)
    for m in range(1, 9):
        plan = _gemv_plan(plan_lib, m, d, n, 32, packed)
        assert plan.path in (0, 1) and 1 <= plan.cluster <= 8
        assert plan.smem + 4096 <= SMEM_OPTIN
        assert _owned_once(plan, n, a, b, d)
        if plan.path:
            _streamed_ok(plan, m, d)
            assert plan.cols in (32, 64, 128)
            scratch = F.wide_scratch(m, d, plan, lib=plan_lib)
            totals = (4 * plan.clusters * plan.splits * (m + 1)
                      * plan.cols if plan.splits > 1 else 0)
            assert scratch >= (8 * m * d + m * -(-d // plan.ktile)
                               * plan.ktile + totals)
        small = F.gemv_plan(m, d, n, a, b, 32, packed, SMS, 64 * 1024,
                            lib=plan_lib)
        _streamed_ok(small, m, d, 64 * 1024)
        assert _owned_once(small, n, a, b, d)
    for m in (9, 37, 100, 128, 255):
        plan = F.tiled_plan(m, d, a, b, 32, SMEM_OPTIN, lib=plan_lib)
        assert plan.smem + 4096 <= SMEM_OPTIN and 1 <= plan.cluster <= 8
        owned = np.zeros(m, int)
        for g in range(plan.clusters):
            group = plan.row_group(g, m)
            assert len(group)
            owned[list(group)] += 1
        assert (owned == 1).all()
        k_owned = np.zeros(d, int)
        for rank in range(plan.cluster):
            k_owned[plan.k_set(rank, a, b)] += 1
        assert (k_owned == 1).all()
        if plan.path:
            assert (plan.cluster, plan.clusters, plan.rows) == (1, 1, m)


@pytest.mark.parametrize("d,n,hd", FAMILY_QKV)
@pytest.mark.parametrize("packed", [True, False])
def test_family_qkv_take_the_prologue_plan(plan_lib, d, n, hd, packed):
    """The prologue takes the dense family's QKV at B 1..8 (mistral-nemo's
    32 + 8 + 8 heads of 128, granite's 48 + 1 + 1, gemma's and
    paligemma's heads of 256): each head in one tile, each (head, K) pair
    in one work item (on the streamed path: one of the head's K splits,
    none empty), within 227 KiB, and within 64 KiB where that is
    forced."""
    a, b = _factors(d)
    for m in range(1, 9):
        for optin in (SMEM_OPTIN, 64 * 1024):
            plan = decode_layer.prologue_plan(m, d, n, hd, a, b, 32, packed,
                                              optin, lib=plan_lib, sms=SMS)
            assert plan.cols == hd and plan.smem + 4096 <= optin
            assert 1 <= plan.cluster <= 8
            if plan.path:
                _streamed_ok(plan, m, d, optin)
            owned = np.zeros(n // hd, int)
            for g in range(plan.clusters):
                owned[list(plan.heads(g))] += 1
            assert (owned == 1).all() and _splits_partition(plan, d)


def _today_plans(lib):
    """Every plan at today's widths (SERVING, RAGGED, OTHER): the decode
    plan at M 1..8 with the plan's and forced columns, the prologue at
    heads of 32 and 64, the tiled stage at ragged M with every rows per
    cluster; (return code, the first four plan fields)."""
    out = (ctypes.c_int * F.PLAN_FIELDS)()
    rows = []
    for d, n in SERVING + RAGGED + OTHER:
        a, b = _factors(d)
        for packed in (1, 0):
            for m in range(1, 9):
                for cols in (0, 16, 32, 64):
                    rc = lib.ctq_gemv_plan(m, d, n, a, b, 32, packed, SMS,
                                           SMEM_OPTIN, cols, out)
                    rows.append(("g", d, n, packed, m, cols, rc,
                                 tuple(out)[:4] if rc == 0 else None))
                    assert rc or out[4] == 0        # the cluster path
            for hd in (32, 64):
                if n % hd == 0:
                    for m in range(1, 9):
                        rc = lib.ctq_prologue_plan(m, d, n, hd, a, b, 32,
                                                   packed, SMS, SMEM_OPTIN,
                                                   out)
                        rows.append(("p", d, n, hd, packed, m, rc,
                                     tuple(out)[:4] if rc == 0 else None))
                        assert rc or out[4] == 0
        for m in (9, 15, 17, 100, 128, 129, 255):
            for r in range(0, 9):
                rc = lib.ctq_tiled_plan(m, d, a, b, 32, SMEM_OPTIN, r, out)
                rows.append(("t", d, m, r, rc,
                             tuple(out)[:4] if rc == 0 else None))
                assert rc or out[4] == 0
    return rows


def test_today_widths_keep_their_plans(plan_lib):
    """The streamed path serves only what the cluster plans refuse: at
    today's widths all 1,780 plans (decode, prologue, tiled) are taken on
    the cluster path and equal, field for field, the plans of the header
    before the streamed path was added (the SHA-1 of their list, computed
    then)."""
    rows = _today_plans(plan_lib)
    assert len(rows) == 1780 and all(r[-2] == 0 for r in rows)
    assert hashlib.sha1(repr(rows).encode()).hexdigest() == (
        "06cd9eb2a55b7acb49bf2dab5bed6c6d41df3991")


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
    # D 48 at factors 4 x 12 (D/c never % 32) is the reference's width:
    # the general path takes it, on a cluster of one CTA owning every K
    plan = F.gemv_plan(4, 48, 64, 4, 12, 0, True, SMS, SMEM_OPTIN,
                       lib=plan_lib)
    assert plan.cluster == 1 and sorted(plan.k_set(0, 4, 12)) == list(
        range(48))
    with pytest.raises(ValueError, match="does not take"):
        F.gemv_plan(4, 512, 64, 32, 16, 6, True, SMS, SMEM_OPTIN,
                    lib=plan_lib)                 # CAT block 6 !| D 512
    # shared memory that holds no cluster plan: the streamed path takes
    # the shape; memory that holds not even its smallest K tile refuses it
    plan = F.gemv_plan(8, 1536, 512, 32, 48, 32, True, SMS, 64 * 1024,
                       lib=plan_lib)
    assert plan.path == 1 and plan.smem + 4096 <= 64 * 1024
    with pytest.raises(ValueError, match="does not take"):
        F.gemv_plan(8, 1536, 512, 32, 48, 32, True, SMS, 16 * 1024,
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
    """The tiled stage refuses exactly the widths the decode plan refuses
    (a CAT block that does not divide D), rows per cluster outside 1..8
    and a step of no rows, and takes the rest on the decode plan's
    cluster (the general path's one CTA for D 48 at 4 x 12); a wide D
    that the old one-row-per-CTA stage refused in Python (over 48 KiB of
    shared memory) is taken."""
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
        assert (c == 0) == (d == 512 and bk == 6)   # 6 !| 512 only
    # D 4096: 4 * (2 D + a^2 + b^2) bytes, over the old stage's 48 KiB
    assert 4 * (2 * 4096 + 64 * 64 * 2) > 48 * 1024
    assert F.tiled_plan(128, 4096, 64, 64, 32, SMEM_OPTIN,
                        lib=plan_lib).cluster == 8
    for m, rows in ((0, 0), (128, 9), (128, -1)):
        with pytest.raises(ValueError, match="does not take"):
            F.tiled_plan(m, 512, 32, 16, 32, SMEM_OPTIN, rows, lib=plan_lib)
    # 32 KiB holds no cluster plan at D 1536: the streamed stage 1, whose
    # dynamic shared memory is the transform's tile (step 2's 16 rows of Y
    # and of Hb, 49 floats each), takes it (forced rows it refuses)
    plan = F.tiled_plan(128, 1536, 32, 48, 32, 32 * 1024, lib=plan_lib)
    assert (plan.path, plan.cluster, plan.clusters, plan.rows, plan.smem,
            plan.per_sm) == (1, 1, 1, 128, 4 * 32 * 49, 2)
    with pytest.raises(ValueError, match="does not take"):
        F.tiled_plan(128, 1536, 32, 48, 32, 32 * 1024, 8, lib=plan_lib)


# (D, a, b, CAT block) the reference's fused kernels take that split over
# no cluster: its tests' widths (a the largest divisor of D <= sqrt(D)),
# CAT blocks that are not multiples of 4, and D 48 at 4 x 12
GENERAL = [(63, 7, 9, 0), (63, 7, 9, 9), (96, 8, 12, 0), (96, 8, 12, 16),
           (96, 8, 12, 6), (24, 4, 6, 0), (24, 4, 6, 8), (48, 6, 8, 0),
           (48, 4, 12, 0), (1, 1, 1, 0), (1001, 7, 143, 0)]


@pytest.mark.parametrize("d,a,b,bk", GENERAL)
@pytest.mark.parametrize("packed", [True, False])
def test_general_widths_own_every_k_once(plan_lib, d, a, b, bk, packed):
    """The plans take every width the reference's kernels take on a
    cluster of one CTA (the general path), whose K set is all of D in
    order, with every output column (decode), row (tiled) and head
    (prologue) owned once and shared memory within the card's."""
    for m in range(1, 9):
        plan = F.gemv_plan(m, d, 40, a, b, bk, packed, SMS, SMEM_OPTIN,
                           lib=plan_lib)
        assert plan.cluster == 1 and plan.smem <= SMEM_OPTIN
        assert plan.k_set(0, a, b) == list(range(d))
        owned = np.zeros(40, int)
        for g in range(plan.clusters):
            owned[list(plan.columns(g, 0, 40))] += 1
        assert (owned == 1).all()
        pro = decode_layer.prologue_plan(m, d, 64, 8, a, b, bk, packed,
                                         SMEM_OPTIN, lib=plan_lib)
        assert (pro.cluster, pro.clusters, pro.cols) == (1, 8, 8)
    for m in (9, 40, 129):
        plan = F.tiled_plan(m, d, a, b, bk, SMEM_OPTIN, lib=plan_lib)
        assert plan.cluster == 1 and plan.smem <= SMEM_OPTIN
        owned = np.zeros(m, int)
        for g in range(plan.clusters):
            owned[list(plan.row_group(g, m))] += 1
        assert (owned == 1).all()


def test_general_path_refuses_what_the_reference_refuses(plan_lib):
    """A CAT block that does not divide D, factors that do not span it,
    and shared memory too small for the general path are refused."""
    for m, d, a, b, bk in ((8, 96, 8, 12, 5), (8, 63, 7, 9, 2),
                           (8, 63, 7, 8, 0), (8, 96, 0, 96, 0)):
        with pytest.raises(ValueError, match="does not take"):
            F.gemv_plan(m, d, 40, a, b, bk, True, SMS, SMEM_OPTIN,
                        lib=plan_lib)
        with pytest.raises(ValueError, match="does not take"):
            F.tiled_plan(16, d, a, b, bk, SMEM_OPTIN, lib=plan_lib)
    # shared memory too small for the general path's cluster of one: the
    # streamed path; too small for its smallest tile: refused
    assert F.gemv_plan(8, 1001, 40, 7, 143, 0, True, SMS, 64 * 1024,
                       lib=plan_lib).path == 1
    with pytest.raises(ValueError, match="does not take"):
        F.gemv_plan(8, 1001, 40, 7, 143, 0, True, SMS, 16 * 1024,
                    lib=plan_lib)


# (K, N) of the code GEMV: the serving shapes, odd K, K not a multiple of
# 16, narrow and ragged N, a deep K, and a deep K at a wide N (where 64
# columns of int8 weights no longer fit in shared memory)
CODE_GEMV = [(512, 3072), (512, 1024), (512, 512), (1536, 512), (63, 40),
             (1535, 520), (24, 1000), (16, 8), (4096, 64), (4096, 32000)]


def _code_gemv_fits(m, k, n, packed, cols, lib):
    """Whether ``cols`` columns' tile of all of K fits in a CTA's shared
    memory (the one-tile plan; else the plan streams K)."""
    try:
        plan = quant_matmul.gemv_plan(m, k, n, packed, SMS, SMEM_OPTIN, cols,
                                      lib=lib)
    except ValueError:
        return False
    return plan.path == 0


@pytest.mark.parametrize("k,n", CODE_GEMV)
@pytest.mark.parametrize("packed", [True, False])
def test_code_gemv_plan_owns_every_column_once(plan_lib, k, n, packed):
    """The code GEMV's plan (rows 7 and 8 at M <= 8) owns each output
    column once at every M in 1..8, with a power-of-two number of columns
    per CTA that still gives every SM a CTA where N allows it (192 CTAs at
    N 3072, where the old GEMV's 32-column CTAs left 36 SMs idle), and
    shared memory within the card's: twice the columns either leaves SMs
    idle or does not fit."""
    for m in range(1, 9):
        plan = quant_matmul.gemv_plan(m, k, n, packed, SMS, SMEM_OPTIN,
                                      lib=plan_lib)
        assert plan.cols in (4, 8, 16, 32, 64)
        assert plan.smem <= SMEM_OPTIN
        owned = np.zeros(n, int)
        for i in range(plan.ctas):
            owned[list(plan.columns(i, n))] += 1
        assert (owned == 1).all()
        if n >= 4 * SMS:
            assert plan.ctas >= SMS
            wider = 2 * plan.cols
            assert (plan.cols == 64 or -(-n // wider) < SMS
                    or not _code_gemv_fits(m, k, n, packed, wider, plan_lib))
    if (k, n) == (512, 3072):
        assert (plan.cols, plan.ctas) == (16, 192)
    if (k, n) == (4096, 32000):
        assert (plan.cols, plan.ctas) == ((64, 500) if packed
                                          else (32, 1000))


def test_code_gemv_plan_forced_columns_and_refusals(plan_lib):
    """Forced columns per CTA (a multiple of 4 up to 256) are taken and own
    every column; M outside 1..8, other column counts and shared memory
    too small for the streamed ring are refused; the plan's own columns
    shrink for a deep K, and a K so deep that even 4 columns' tile of all
    of K does not fit (K 9,600 int8, 14,400 packed at M 8) takes the
    streamed plan, as do forced columns whose tile does not fit."""
    for cols in (4, 8, 12, 16, 32, 64, 128, 256):
        plan = quant_matmul.gemv_plan(8, 512, 3072, True, SMS, SMEM_OPTIN,
                                      cols, lib=plan_lib)
        assert plan.cols == cols and plan.ctas == -(-3072 // cols)
        assert plan.path == 0
    for m, cols, smem in ((0, 0, SMEM_OPTIN), (9, 0, SMEM_OPTIN),
                          (8, 6, SMEM_OPTIN), (8, 260, SMEM_OPTIN),
                          (8, 0, 16 * 1024)):
        with pytest.raises(ValueError, match="does not take"):
            quant_matmul.gemv_plan(m, 4096, 3072, False, SMS, smem, cols,
                                   lib=plan_lib)
    for k, packed, cols in ((9000, False, 16), (9600, False, None),
                            (13500, True, 16), (14400, True, None)):
        plan = quant_matmul.gemv_plan(8, k, 32000, packed, SMS, SMEM_OPTIN,
                                      lib=plan_lib)
        if cols is None:
            _streamed_ok(plan, 8, k)
            assert _code_gemv_owned_once(plan, k, 32000)
        else:
            assert (plan.path, plan.cols) == (0, cols)
    for cols in (4, 32, 96, 256):
        plan = quant_matmul.gemv_plan(8, 14400, 3072, True, SMS, SMEM_OPTIN,
                                      cols, lib=plan_lib)
        assert plan.cols == cols
        _streamed_ok(plan, 8, 14400)
        assert _code_gemv_owned_once(plan, 14400, 3072)


def _code_gemv_owned_once(plan, k, n):
    """Every output column in one column tile (one CTA on the one-tile
    plan) and, on the streamed plan, every K of it in one of the tile's
    splits."""
    owned = np.zeros(n, int)
    for i in range(plan.ctas):
        owned[list(plan.columns(i, n))] += 1
    return (owned == 1).all() and _splits_partition(plan, k)


def _code_gemv_plans(lib):
    """The code GEMV's plans at CODE_GEMV, today's widths (SERVING, RAGGED,
    OTHER as (K, N)), the deep-K edges of the column plan and mistral-nemo
    12B's decode widths: M 1..8, packed and int8, the plan's and forced
    columns; (K, N, packed, M, cols, the first four plan fields) of each
    plan on the one-tile path."""
    shapes = []
    for shape in (CODE_GEMV + SERVING + RAGGED + OTHER
                  + [(9000, 32000), (13500, 32000), (5120, 6144),
                     (4096, 5120), (5120, 28672)]):
        if shape not in shapes:
            shapes.append(shape)
    out = (ctypes.c_int * quant_matmul.PLAN_FIELDS)()
    rows, streamed = [], 0
    for k, n in shapes:
        for packed in (1, 0):
            for m in range(1, 9):
                for cols in (0, 4, 16, 32, 64):
                    rc = lib.ctq_code_gemv_plan(m, k, n, packed, SMS,
                                                SMEM_OPTIN, cols, out)
                    assert rc == 0
                    if out[4] == 0:
                        rows.append((k, n, packed, m, cols, tuple(out)[:4]))
                    else:
                        streamed += 1
    return rows, streamed


def test_code_gemv_keeps_its_plans(plan_lib):
    """Every shape the code GEMV's plan took before it streamed a deep K
    keeps its plan field for field: of the 1,840 plans listed, the 1,720
    it took then (the SHA-1 of their list, computed with the header
    before the streamed plan was added), and the 120 it refused (a deep K
    at 64 forced columns) are now streamed."""
    rows, streamed = _code_gemv_plans(plan_lib)
    assert (len(rows), streamed) == (1720, 120)
    assert hashlib.sha1(repr(rows).encode()).hexdigest() == (
        "7aed2525cd969bcf8c1c0d5b02a87d94f26865c4")


# (K, N) of the code GEMV at the deep K of the dense family's wd (the
# configs' d_ff at their d_model), and at a narrow N
DEEP_K = [(14336, 5120), (15360, 3840), (16384, 2048), (24576, 6144),
          (14336, 96), (24576, 96)]


@pytest.mark.parametrize("k,n", DEEP_K)
@pytest.mark.parametrize("packed", [True, False])
def test_code_gemv_streams_a_deep_k(plan_lib, k, n, packed):
    """Rows 7 and 8 take the family's deep K at every M in 1..8: where
    the tile of all of K does not fit (always at M 8 and at 64 KiB), the
    streamed plan (two CTAs per SM, K through a ring of stages), whose
    tiles own every column once and whose K splits own every K of each
    tile once, within 227 KiB and, forced, 64 KiB; the plan equals the
    streamed contraction's own (ctq_stream_plan), which the decode
    linear's streamed path runs."""
    out = (ctypes.c_int * quant_matmul.PLAN_FIELDS)()
    for m in range(1, 9):
        for optin in (SMEM_OPTIN, 64 * 1024):
            plan = quant_matmul.gemv_plan(m, k, n, packed, SMS, optin,
                                          lib=plan_lib)
            assert plan.smem + 4096 <= optin
            assert _code_gemv_owned_once(plan, k, n)
            if plan.path == 0:                 # all of K in one tile
                assert m < 8 and optin == SMEM_OPTIN
                continue
            _streamed_ok(plan, m, k, optin)
            assert _code_gemv_owned_once(plan, k, n)
            assert plan_lib.ctq_stream_plan(m, k, n, int(packed), 0, SMS,
                                            optin, out) == 0
            assert (plan.ctas, plan.cols, plan.smem, plan.ktile,
                    plan.splits, plan.stages) == (
                out[1], out[2], out[3], out[5], out[6], out[7])
            totals = ctypes.c_longlong(0)
            plan_lib.ctq_stream_totals(m, plan.ctas, plan.cols, plan.splits,
                                       ctypes.byref(totals))
            assert totals.value == (
                -(-4 * plan.ctas * plan.splits * (m + 1) * plan.cols // 16)
                * 16 if plan.splits > 1 else 0)


def test_code_gemv_wrappers_pass_the_card_and_columns(monkeypatch):
    """Rows 7 and 8's wrappers run the plain version for CPU tensors and
    raise for a device that is neither CUDA nor the CPU; their launches
    pass the card's SM count and the forced columns per CTA (0: the
    plan's), W8A8 also its K splits, in the order of the C prototypes,
    and allocate the output and nothing else."""
    from repro_torch.kernels import quant_matmul_w4 as QW
    r = np.random.default_rng(5)
    qx = torch.from_numpy(r.integers(-8, 8, (8, 63)).astype(np.int8))
    sx = torch.from_numpy(r.uniform(0.01, 0.1, (8, 1)).astype(np.float32))
    zx = torch.from_numpy(r.integers(-8, 8, (8, 1)).astype(np.float32))
    w = torch.from_numpy(r.integers(-8, 8, (63, 40)).astype(np.int8))
    sw = torch.from_numpy(r.uniform(0.01, 0.1, (1, 40)).astype(np.float32))
    packed = pack_int4(w, axis=0)
    assert torch.equal(QW.quant_gemv_w4(qx, sx, zx, packed, sw),
                       QW.quant_matmul_w4_plain(qx, sx, zx, packed, sw))
    assert torch.equal(quant_matmul.quant_matmul(qx, sx, zx, w, sw),
                       quant_matmul.quant_matmul_plain(qx, sx, zx, w, sw))
    with pytest.raises(TypeError, match="CUDA tensors"):
        QW.quant_gemv_w4(qx.to("meta"), sx, zx, packed, sw)
    with pytest.raises(TypeError, match="CUDA tensors"):
        quant_matmul.quant_matmul(qx.to("meta"), sx, zx, w, sw)
    lib = _FakeLib()
    monkeypatch.setattr(build, "load", lambda name, sigs: lib)
    monkeypatch.setattr(build, "stream_of", lambda t: ctypes.c_void_p(0))
    monkeypatch.setattr(build, "sm_count", lambda device: SMS)
    monkeypatch.setattr(quant_matmul, "w8a8_plan",
                        lambda m, k, n, device: (1, None))
    allocs = []
    for name in ("empty", "zeros", "empty_like", "zeros_like", "full"):
        real = getattr(torch, name)

        def spy(*args, _real=real, _name=name, **kw):
            allocs.append(_name)
            return _real(*args, **kw)
        monkeypatch.setattr(torch, name, spy)
    out = quant_matmul.launch("quant_gemv_w4", qx, sx, zx, packed, sw,
                              gemv=True)
    quant_matmul.launch("quant_matmul", qx, sx, zx, w, sw, planned=True,
                        gemv=True, cols=32)
    assert allocs == ["empty", "empty"] and out.shape == (8, 40)
    # each launch reads its plan first (a streamed plan needs a scratch)
    assert [c[0] for c in lib.calls] == [
        "ctq_code_gemv_plan", "quant_gemv_w4", "ctq_code_gemv_plan",
        "quant_matmul"]
    (w4, a4), (w8, a8) = lib.calls[1], lib.calls[3]
    assert len(a4) == len(quant_matmul._SIGNATURES[w4])
    assert len(a8) == len(quant_matmul._SIGNATURES[w8])
    # qx, m, k, sx, zx, qw, sw, n, [splits, ws,] sms, cols, gws, out,
    # stream; no streamed-path scratch on the one-tile plan
    assert a4[1:3] == (8, 63) and a4[7:10] == (40, SMS, 0)
    assert a8[7:9] == (40, 1) and a8[10:12] == (SMS, 32)
    assert a4[10].value is None and a8[12].value is None


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
    monkeypatch.setattr(build, "sm_count", lambda device: SMS)
    allocs = []
    for name in ("empty", "zeros", "empty_like", "zeros_like", "full"):
        real = getattr(torch, name)

        def spy(*args, _real=real, _name=name, **kw):
            allocs.append(_name)
            return _real(*args, **kw)
        monkeypatch.setattr(torch, name, spy)
    out = F._launch_gemv(x, blocks, ha, hb, sign, qw, sw, 4, True)
    assert allocs == ["empty"] and out.shape == (8, 1000)
    # the plan is read first (its path decides the scratch), then one launch
    assert [c[0] for c in lib.calls] == ["ctq_gemv_plan",
                                         "fused_cat_gemv_w4"]
    (name, args) = lib.calls[1]
    assert name == "fused_cat_gemv_w4"
    assert len(args) == len(F._SIGNATURES[name])
    # the card's SMs; the plan's columns; no streamed-path scratch
    assert args[-5:-3] == (SMS, 0) and args[-3].value is None


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
    (name, args0), (_, args1) = [c for c in lib.calls
                                 if c[0] != "ctq_tiled_plan"]
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


@pytest.fixture(scope="module")
def dq_lib(tmp_path_factory):
    """csrc/dq_plan.h built for the host, its plan export bound."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build csrc/dq_plan.h")
    out = tmp_path_factory.mktemp("dq") / "dq_plan.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-x", "c++",
                    str(build.CSRC / "dq_plan.h"), "-o", str(out)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    lib.dq_plan.argtypes = dynamic_quant._SIGNATURES["dq_plan"]
    lib.dq_plan.restype = ctypes.c_int
    return lib


# (D, vectors per lane in f32, in bf16; 0: the general path)
DQ_WIDTHS = [(24, 1, 1), (63, 0, 0), (512, 4, 2), (768, 8, 4),
             (1536, 16, 8), (2048, 16, 8), (4096, 0, 16), (12289, 0, 0),
             (16384, 0, 0)]


@pytest.mark.parametrize("d,vecs_f32,vecs_bf16", DQ_WIDTHS)
def test_dq_plan_vectors_rows_and_general_path(dq_lib, d, vecs_f32,
                                               vecs_bf16):
    """One warp per row: each lane holds ceil(D / 32 / E) 16-byte vectors
    (E = 4 f32 or 8 bf16 values) rounded up to a power of two, up to 16
    (the kernel masks the vectors past the row's end); a width that is not
    a whole number of vectors, more vectors per lane, or a row start off a
    16-byte boundary takes the general path (vecs 0), so every width runs.
    Four rows per CTA at every M: M 128 is 32 CTAs, M 8 two."""
    for elt, vecs in ((4, vecs_f32), (2, vecs_bf16)):
        per = 16 // elt
        for m, rows, ctas in ((1, 4, 1), (7, 4, 2), (8, 4, 2),
                              (128, 4, 32), (300, 4, 75),
                              (5000, 4, 1250)):
            p = dynamic_quant.plan(m, d, elt, lib=dq_lib)
            assert p == (rows, vecs, ctas)
            # the register path covers the row, at the fewest vectors per
            # lane that a power of two allows
            if p.vecs:
                assert p.vecs in (1, 2, 4, 8, 16)
                assert (d % per == 0
                        and 32 * (p.vecs // 2) < d // per <= 32 * p.vecs)
        assert dynamic_quant.plan(8, d, elt, aligned=False,
                                  lib=dq_lib).vecs == 0


def test_dq_plan_forced_rows_and_refusals(dq_lib):
    """Forced rows per CTA 1..8 give ceil(M / rows) CTAs; the plan
    refuses M or D of 0, element sizes other than 2 and 4, and more than
    8 rows per CTA."""
    for rows in range(1, 9):
        assert dynamic_quant.plan(128, 512, 2, rows=rows, lib=dq_lib) == (
            rows, 2, -(-128 // rows))
    for bad in (dict(m=0), dict(d=0), dict(elt=3), dict(elt=1),
                dict(rows=9), dict(rows=-1)):
        args = dict(m=8, d=512, elt=4, rows=0) | bad
        with pytest.raises(ValueError, match="does not take"):
            dynamic_quant.plan(args["m"], args["d"], args["elt"],
                               rows=args["rows"], lib=dq_lib)


def test_dynamic_quant_wrapper_passes_the_plan_arguments(monkeypatch):
    """The wrapper runs the plain version for CPU tensors and raises for a
    device that is neither CUDA nor the CPU (no width refusal is left:
    the old 48 KiB shared-memory check is gone); its launch passes the
    shape, the bits, the symmetric flag and the forced rows per CTA (0:
    the plan's) in the order of the C prototype, and allocates the three
    outputs and nothing else."""
    r = np.random.default_rng(9)
    x = torch.from_numpy(r.standard_normal((3, 16384)).astype(np.float32))
    got = dynamic_quant.dynamic_quant(x, 4)
    want = dynamic_quant.dynamic_quant_plain(x, 4)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(TypeError, match="CUDA tensors"):
        dynamic_quant.dynamic_quant(x.to("meta"), 4)
    lib = _FakeLib()
    monkeypatch.setattr(build, "load", lambda name, sigs: lib)
    monkeypatch.setattr(build, "stream_of", lambda t: ctypes.c_void_p(0))
    allocs = []
    for name in ("empty", "zeros", "empty_like", "zeros_like", "full"):
        real = getattr(torch, name)

        def spy(*args, _real=real, _name=name, **kw):
            allocs.append(_name)
            return _real(*args, **kw)
        monkeypatch.setattr(torch, name, spy)
    # a counter of its own for this test, restored after it: the fake
    # launches must not show in another test's count
    monkeypatch.setattr(dynamic_quant.dynamic_quant, "launches", 0)
    q, scale, zp = dynamic_quant._launch(x.to(torch.bfloat16), 3, True, 0)
    dynamic_quant._launch(x[:1, :12289], 8, False, 2)
    assert allocs == ["empty"] * 6
    assert (q.shape, scale.shape, zp.shape) == ((3, 16384), (3, 1), (3, 1))
    assert dynamic_quant.dynamic_quant.launches == 2
    (n0, a0), (n1, a1) = lib.calls
    assert n0 == n1 == "dynamic_quant"
    assert len(a0) == len(dynamic_quant._SIGNATURES["dynamic_quant"])
    # x, x_is_bf16, m, d, bits, symmetric, rows, q, scale, zp, stream
    assert a0[1:7] == (1, 3, 16384, 3, 1, 0)
    assert a1[1:7] == (0, 1, 12289, 8, 0, 2)


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


def _chip_smoke_floor():
    """chip_smoke.py's binding of the quant's floor library (the script
    imports only the standard library at its top)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return types.SimpleNamespace(_SIGNATURES=mod.DQ_FLOOR_SIGNATURES)


@pytest.mark.parametrize("module,source", [
    (F, "fused_cat_matmul"), (decode_layer, "decode_layer"),
    (paged_attention, "paged_attention"), (block_matmul, "block_matmul"),
    (hadamard, "hadamard"), (dynamic_quant, "dynamic_quant"),
    (quant_matmul, "quant_matmul"), (_chip_smoke_floor(), "dq_floor")])
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
