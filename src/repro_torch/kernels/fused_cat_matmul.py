"""The fused CAT serving linear: transform -> act quant -> W4 contraction.

Replaces the Pallas TPU kernels ``fused_cat_gemv_w4`` and
``fused_cat_matmul_w4`` of ``src/repro/kernels/fused_cat_matmul.py``:

    block-CAT (per-block dots) -> ⊙ sign -> Kronecker Hadamard (two factor
    dots) -> per-token asymmetric act quant (signed-shifted codes) ->
    int4-unpack -> exact integer dot -> sx·sw·(acc − zx·colsum)

The CUDA source is ``src/repro_torch/csrc/fused_cat_matmul.cu``. For
M <= 8 rows (decode) it is ONE launch in thread-block clusters
(``csrc/cluster_tq.cuh``): each cluster computes the transform and quant
once, split over its CTAs, which push their codes into every CTA of the
cluster (distributed shared memory); each CTA then contracts all of them
against its own output columns, whose weight bytes it stages in shared
memory by 16-byte loads while the transform runs, and applies the
epilogue. The plan (cluster size, columns per CTA) is the CUDA source's
(``csrc/cluster_plan.h``); ``gemv_plan`` reads it. Widths that split over
no cluster (odd D, factors or a CAT block that are not multiples of 4)
run on clusters of one CTA through the general path, bitwise alike.
Widths whose operands one cluster's shared memory cannot hold (the
plan's ``path`` 1: d_ff 14336 and up, or N 28672 at M 8) take the
streamed path (``csrc/wide_tq.cuh``): one cooperative launch of one CTA
per SM that issues its first weight stages before the transform, the
transform's intermediates and the contraction's split sums in a device
scratch buffer this wrapper allocates (``wide_scratch`` bytes), each
transform output still one in-order fma chain, then each column tile's K
split over CTAs and streamed through a deep ring onto the tensor cores,
the splits' exact int32 sums added in split order and the epilogue applied
once per tile. Above 8 rows the same cluster
transform runs on groups of up to eight rows, one cluster each
(``tiled_plan``; on its streamed path one cooperative launch over all
rows), every CTA storing the codes of its own K values to a scratch
buffer; the tensor-core contraction of ``quant_matmul`` and
``quant_matmul_w4`` follows, for int8 or packed int4 weights, the codes
crossing HBM once ((K_pad + 8) bytes per row). What bounds both on the
H100 is the packed weight stream (D/2 x N bytes); each weight byte is
read once per CTA or row tile.

Each wrapper launches its kernel for CUDA tensors (and counts the launch
in ``<wrapper>.launches``), takes the plain PyTorch version, which
repeats the kernel's arithmetic in the kernel's op order
(``ref.kernel_transform_quant`` in the reference), for CPU tensors, and
raises for any other device.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.core.quantizers import unpack_int4

from . import build
from .block_matmul import block_diag_f32
from .dynamic_quant import dynamic_quant_plain
from .hadamard import hadamard_f32
from .quant_matmul import (PLAN_FIELDS, quant_matmul_plain, split_k_range,
                           w8a8_plan)
from .quant_matmul_w4 import GEMV_M

_INVALID_VALUE = 1   # cudaErrorInvalidValue

_C = ctypes.c_int
_P = ctypes.c_void_p
_PLAN = ctypes.POINTER(ctypes.c_int)
# x, x_is_bf16, m, d, blocks, bk, sign, ha, a, hb, b, act_bits, qw, packed,
# sw, n; the decode entry adds the SM count, its columns per CTA (0: the
# plan's) and the streamed path's scratch, the tiled one k_pad, its rows
# per cluster (0: the plan's), the contraction's K splits and their
# scratch, the streamed stage 1's scratch and the code scratch (qx, sx,
# zx)
_OPS = [_P, _C, _C, _C, _P, _C, _P, _P, _C, _P, _C, _C, _P, _C, _P, _C]
_SIGNATURES = {
    "fused_cat_gemv_w4": _OPS + [_C, _C, _P, _P, _P],
    "fused_cat_matmul_w4": (_OPS[:4] + [_C] + _OPS[4:] + [_C, _C]
                            + [_P] * 7),
    "fused_cat_gemv_capacity": [_C, _C],
    "ctq_gemv_plan": [_C] * 10 + [_PLAN],
    "ctq_tiled_plan": [_C] * 7 + [_PLAN],
    "ctq_wide_scratch": [_C] * 6 + [ctypes.POINTER(ctypes.c_longlong)]}


# ------------------------------------------------------- cluster plan

def k_set(cluster: int, rank: int, a: int, b: int) -> list:
    """K of the transform values of CTA ``rank`` of a cluster: columns
    [rank·b/c, (rank+1)·b/c) of every row of the (a, b) view, in its
    order."""
    bl = b // cluster
    return [p * b + rank * bl + ll for p in range(a) for ll in range(bl)]


@dataclasses.dataclass(frozen=True)
class GemvPlan:
    """Launch plan of the one-launch decode linear: ``clusters`` clusters
    of ``cluster`` CTAs; CTA ``rank`` of cluster g computes the transform
    values of its K set (``k_set``: D/cluster of them) and owns the output
    columns ``columns(g, rank, n)``, ``cols`` of them; ``smem`` bytes of
    dynamic shared memory per CTA. On the streamed path (``path`` 1) the
    launch is ``per_sm`` CTAs per SM, ``clusters`` is the number of
    column tiles ``columns(g, 0, n)``, every K of the transform is one
    work item's, and each tile's K is split ``splits`` ways
    (``k_range``), each split a work item the CTAs take in turn, streamed
    in stages of ``ktile`` K through a ring of ``stages``."""
    cluster: int
    clusters: int
    cols: int
    smem: int
    path: int = 0
    ktile: int = 0
    splits: int = 1
    stages: int = 0
    per_sm: int = 1

    def k_set(self, rank: int, a: int, b: int) -> list:
        return k_set(self.cluster, rank, a, b)

    def columns(self, g: int, rank: int, n: int) -> range:
        n0 = (g * self.cluster + rank) * self.cols
        return range(min(n0, n), min(n0 + self.cols, n))

    def k_range(self, split: int, d: int) -> range:
        """The K of D that split ``split`` of a tile contracts (all of D
        on the cluster path)."""
        return split_k_range(self, split, d)


def read_plan(fn, what: str, *args) -> tuple:
    """Call a plan export of ``csrc/cluster_plan.h`` (``ctq_gemv_plan``,
    ``ctq_tiled_plan``, ``ctq_prologue_plan``) -> (cluster, clusters, cols
    or rows, smem, path, ktile, splits, stages, per_sm); raises
    ValueError for a shape the kernel does not take."""
    out = (ctypes.c_int * PLAN_FIELDS)()
    if fn(*args, out):
        raise ValueError(f"{what} does not take this shape {args}: the "
                         f"transform needs D = a·b and a CAT block that "
                         f"divides D; M (decode) or the rows per cluster "
                         f"(tiled) in 1..8; the decode columns per CTA a "
                         f"multiple of 4 up to 256; and its shared memory "
                         f"must fit (csrc/cluster_plan.h)")
    return tuple(out)


def wide_scratch(m: int, d: int, plan=None, lib=None) -> int:
    """Bytes of the streamed path's device scratch for M rows of D on a
    streamed ``plan`` (its K stages and its splits' sums; None: the
    tiled stage 1, which writes its codes to the code scratch):
    ``ctq::WideScratch`` and ``ctq::stream_totals`` of
    ``csrc/cluster_plan.h``."""
    lib = lib or build.load("fused_cat_matmul", _SIGNATURES)
    out = ctypes.c_longlong(0)
    if plan is None:
        lib.ctq_wide_scratch(m, d, 0, 0, 0, 1, ctypes.byref(out))
    else:
        lib.ctq_wide_scratch(m, d, plan.ktile, plan.clusters, plan.cols,
                             plan.splits, ctypes.byref(out))
    return int(out.value)


def gemv_plan(m: int, d: int, n: int, a: int, b: int, bk: int,
              packed: bool, sms: int, smem_optin: int = 0, cols: int = 0,
              lib=None) -> GemvPlan:
    """The decode kernel's plan for M rows of D = a·b against N columns on
    a card of ``sms`` SMs (``ctq::gemv_plan``, which the kernel's entry
    runs on every call): the largest cluster the transform splits over and
    ``cols`` columns per CTA (0: the plan's own). ``smem_optin`` (0: the
    current card's) bounds the shared memory per CTA. ``lib``: a library
    exporting ``ctq_gemv_plan`` (default: the built CUDA library). Raises
    ValueError for a shape the kernel does not take."""
    lib = lib or build.load("fused_cat_matmul", _SIGNATURES)
    return GemvPlan(*read_plan(lib.ctq_gemv_plan, "the decode kernel", m, d,
                               n, a, b, bk, int(packed), sms, smem_optin,
                               cols))


@dataclasses.dataclass(frozen=True)
class TiledPlan:
    """Launch plan of the tiled linear's transform-quant stage:
    ``clusters`` clusters of ``cluster`` CTAs; cluster g transforms the
    rows ``row_group(g, m)``, and its CTA ``rank`` computes and stores the
    codes of the K set ``k_set(rank, a, b)`` of each; ``smem`` bytes of
    dynamic shared memory per CTA. On the streamed path (``path`` 1) one
    group of all M rows, transformed by ``per_sm`` CTAs per SM through
    the device scratch."""
    cluster: int
    clusters: int
    rows: int
    smem: int
    path: int = 0
    ktile: int = 0
    splits: int = 1
    stages: int = 0
    per_sm: int = 1

    def row_group(self, g: int, m: int) -> range:
        return range(min(g * self.rows, m), min((g + 1) * self.rows, m))

    def k_set(self, rank: int, a: int, b: int) -> list:
        return k_set(self.cluster, rank, a, b)


def tiled_plan(m: int, d: int, a: int, b: int, bk: int,
               smem_optin: int = 0, rows: int = 0, lib=None) -> TiledPlan:
    """The tiled stage 1's plan for M rows of D = a·b (``ctq::tiled_plan``,
    which the kernel's entry runs on every call): the largest cluster the
    transform splits over and ``rows`` rows per cluster (0: the plan's
    own). ``smem_optin`` and ``lib`` as in ``gemv_plan``. Raises
    ValueError for a shape the kernel does not take."""
    lib = lib or build.load("fused_cat_matmul", _SIGNATURES)
    return TiledPlan(*read_plan(lib.ctq_tiled_plan, "the tiled stage 1", m,
                                d, a, b, bk, smem_optin, rows))


# ------------------------------------------------------------ plain version

def transform_quant_plain(x, blocks, ha, hb, sign, act_bits: int):
    """CAT transform + dynamic per-token asymmetric quant in the kernel's
    op order (per-block dots, the two Kronecker-factor dots, then the
    signed-shifted quant), all in f32. -> (q int8 (M, D), scale (M, 1),
    zp (M, 1))."""
    xf = x.to(torch.float32)
    if blocks is not None:
        xf = block_diag_f32(xf, blocks)
    if sign is not None:
        xf = xf * sign.to(torch.float32)
    return dynamic_quant_plain(hadamard_f32(xf, ha, hb), act_bits)


def fused_cat_linear_plain(x, blocks, ha, hb, sign, qw, sw, *,
                           act_bits: int = 8, packed: bool = True):
    """Plain PyTorch version of both fused-linear kernels -> (M, N) f32."""
    q, sx, zx = transform_quant_plain(x, blocks, ha, hb, sign, act_bits)
    w = unpack_int4(qw, x.shape[1], axis=0) if packed else qw
    return quant_matmul_plain(q, sx, zx, w, sw)


# ------------------------------------------------------------ CUDA launch

def _validate(x, blocks, ha, hb, sign, qw, sw, act_bits, packed):
    m, d = x.shape
    n = qw.shape[1]
    if packed and qw.shape[0] != (d + 1) // 2:
        raise ValueError(f"packed qw {tuple(qw.shape)} needs ceil(D/2) rows "
                         f"for D={d}")
    if not packed and qw.shape[0] != d:
        raise ValueError(f"qw {tuple(qw.shape)} needs D={d} rows")
    if ha.shape[0] * hb.shape[0] != d:
        raise ValueError(f"Hadamard factors {tuple(ha.shape)}x"
                         f"{tuple(hb.shape)} do not span D={d}")
    if blocks is not None and blocks.shape[0] * blocks.shape[1] != d:
        raise ValueError(f"CAT blocks {tuple(blocks.shape)} do not span "
                         f"D={d}")
    if not 2 <= act_bits <= 8:
        raise ValueError(f"act_bits must be in [2, 8], got {act_bits}")
    if sw.shape != (1, n):
        raise ValueError(f"sw {tuple(sw.shape)} must be (1, {n})")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be f32 or bf16, got {x.dtype}")
    if qw.dtype != torch.int8:
        raise TypeError(f"qw must be int8, got {qw.dtype}")
    dev = x.device
    for name, t in (("blocks", blocks), ("ha", ha), ("hb", hb),
                    ("sign", sign), ("sw", sw)):
        if t is not None and (t.dtype != torch.float32 or t.device != dev):
            raise TypeError(f"{name} must be f32 on {dev}")
    if qw.device != dev:
        raise TypeError(f"qw must be on {dev}")


def _contiguous(*ts):
    """Contiguous and 16-byte aligned (the cluster kernels stage their
    operands by 16-byte copies)."""
    out = []
    for t in ts:
        if t is not None:
            t = t.contiguous()
            if t.data_ptr() % 16:
                t = t.clone()
        out.append(t)
    return out


@functools.lru_cache(maxsize=1024)
def _served_plan(kind: str, lib, *args):
    """A plan of the built library for a served shape, read once (the
    streamed path's scratch depends on it); None for a shape the plan
    refuses (the entry then reports it)."""
    try:
        if kind == "gemv":
            return gemv_plan(*args, lib=lib)
        return tiled_plan(*args, lib=lib)
    except ValueError:
        return None


def _wide_ws(plan, m, d, device, lib, tiled=False):
    """The streamed path's scratch (None on the cluster path)."""
    if plan is None or plan.path != 1:
        return None
    return torch.empty(wide_scratch(m, d, None if tiled else plan, lib=lib),
                       dtype=torch.uint8, device=device)


def _launch_gemv(x, blocks, ha, hb, sign, qw, sw, act_bits, packed,
                 cols=0):
    """One launch of the decode kernel, on its plan with ``cols`` columns
    per CTA (0: the plan's own); allocates the output and, on the
    streamed path, its scratch."""
    _validate(x, blocks, ha, hb, sign, qw, sw, act_bits, packed)
    x, blocks, ha, hb, sign, qw, sw = _contiguous(x, blocks, ha, hb, sign,
                                                  qw, sw)
    m, d = x.shape
    n = qw.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return out
    bk = 0 if blocks is None else blocks.shape[1]
    sms = build.sm_count(x.device)
    lib = build.load("fused_cat_matmul", _SIGNATURES)
    plan = _served_plan("gemv", lib, m, d, n, ha.shape[0], hb.shape[0], bk,
                        bool(packed), sms, 0, cols)
    ws = _wide_ws(plan, m, d, x.device, lib)
    code = lib.fused_cat_gemv_w4(
        build.ptr(x), int(x.dtype == torch.bfloat16), m, d,
        build.ptr(blocks), bk, build.ptr(sign), build.ptr(ha), ha.shape[0],
        build.ptr(hb), hb.shape[0], act_bits, build.ptr(qw), int(packed),
        build.ptr(sw), n, sms, cols, build.ptr(ws), build.ptr(out),
        build.stream_of(x))
    if code == _INVALID_VALUE:   # a shape the plan refuses: say why
        gemv_plan(m, d, n, ha.shape[0], hb.shape[0], bk, packed, sms,
                  cols=cols, lib=lib)
    build.check(code, "fused_cat_gemv_w4")
    return out


def _launch_tiled(x, blocks, ha, hb, sign, qw, sw, act_bits, packed,
                  rows=0):
    """Stage 1 (the cluster transform-quant into code scratch, ``rows``
    rows per cluster, 0: the plan's), then the tensor-core contraction."""
    _validate(x, blocks, ha, hb, sign, qw, sw, act_bits, packed)
    x, blocks, ha, hb, sign, qw, sw = _contiguous(x, blocks, ha, hb, sign,
                                                  qw, sw)
    m, d = x.shape
    n = qw.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return out
    lib = build.load("fused_cat_matmul", _SIGNATURES)
    k_pad = 2 * qw.shape[0] if packed else d
    qx = torch.empty((m, k_pad), dtype=torch.int8, device=x.device)
    sx = torch.empty((m,), dtype=torch.float32, device=x.device)
    zx = torch.empty((m,), dtype=torch.float32, device=x.device)
    bk = 0 if blocks is None else blocks.shape[1]
    splits, ws = w8a8_plan(m, k_pad, n, x.device)
    plan = _served_plan("tiled", lib, m, d, ha.shape[0], hb.shape[0], bk, 0,
                        rows)
    tws = _wide_ws(plan, m, d, x.device, lib, tiled=True)
    code = lib.fused_cat_matmul_w4(
        build.ptr(x), int(x.dtype == torch.bfloat16), m, d, k_pad,
        build.ptr(blocks), bk, build.ptr(sign), build.ptr(ha), ha.shape[0],
        build.ptr(hb), hb.shape[0], act_bits, build.ptr(qw), int(packed),
        build.ptr(sw), n, rows, splits, build.ptr(ws), build.ptr(tws),
        build.ptr(qx), build.ptr(sx), build.ptr(zx), build.ptr(out),
        build.stream_of(x))
    if code == _INVALID_VALUE:   # a shape the plan refuses: say why
        tiled_plan(m, d, ha.shape[0], hb.shape[0], bk, rows=rows, lib=lib)
    build.check(code, "fused_cat_matmul_w4")
    return out


def fused_cat_gemv_w4(x, blocks, ha, hb, sign, qw, sw, *, act_bits: int = 8,
                      packed: bool = True) -> torch.Tensor:
    """Decode-shaped fused CAT linear for M <= 8 rows, one launch.

    x (M, D) f32/bf16; blocks (n, k, k) f32 CAT factors or None; ha/hb
    Kronecker Hadamard factors; sign (D,) (a Scale CAT factor folded in)
    or None for ones; qw (ceil(D/2), N) nibble-packed int4 codes — or (D,
    N) int8 codes with ``packed=False``; sw (1, N) f32 -> (M, N) f32."""
    if x.shape[0] > GEMV_M:
        raise ValueError(f"GEMV variant is for M <= {GEMV_M}, got "
                         f"M={x.shape[0]}")
    if build.off_card(x, "fused_cat_gemv_w4"):
        return fused_cat_linear_plain(x, blocks, ha, hb, sign, qw, sw,
                                      act_bits=act_bits, packed=packed)
    out = _launch_gemv(x, blocks, ha, hb, sign, qw, sw, act_bits, packed)
    fused_cat_gemv_w4.launches += 1
    return out


def fused_cat_matmul_w4(x, blocks, ha, hb, sign, qw, sw, *,
                        act_bits: int = 8, packed: bool = True
                        ) -> torch.Tensor:
    """Tiled fused CAT linear for M > 8 rows (operands as in
    ``fused_cat_gemv_w4``)."""
    if build.off_card(x, "fused_cat_matmul_w4"):
        return fused_cat_linear_plain(x, blocks, ha, hb, sign, qw, sw,
                                      act_bits=act_bits, packed=packed)
    out = _launch_tiled(x, blocks, ha, hb, sign, qw, sw, act_bits, packed)
    fused_cat_matmul_w4.launches += 1
    return out


fused_cat_gemv_w4.launches = 0
fused_cat_matmul_w4.launches = 0
