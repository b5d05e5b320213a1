"""W8A8 contraction from precomputed activation codes.

Replaces the Pallas TPU kernel ``quant_matmul`` of
``src/repro/kernels/quant_matmul.py:42``:

    y[m, n] = sx[m]·sw[n]·(Σ_k qx[m, k]·qw[k, n] − zpx[m]·Σ_k qw[k, n])

for int8 activation codes qx (M, K), sx/zpx (M, 1) f32, int8 weight codes
qw (K, N) and sw (1, N) f32 -> (M, N) f32.

The CUDA source is ``src/repro_torch/csrc/quant_matmul.cu``: for M <= 8
the code GEMV, one CTA per few output columns on a plan that fills every
SM (``gemv_plan``), its weight columns and the codes staged by 16-byte
``cp.async`` and contracted by the dp4a contraction the decode fused
linear runs (``csrc/cluster_tq.cuh`` ``contract_codes``); at a K too deep
for one CTA's tile of all of K (the plan's ``path`` 1: the wd of an LLM)
the streamed contraction of the decode linear's streamed path
(``csrc/wide_tq.cuh``: K through a ring onto the tensor cores, split over
CTAs, the splits' exact int32 sums added from a scratch this wrapper
allocates, ``stream_totals`` bytes); above 8 rows a
tensor-core kernel: 64x64 output tiles, each product an ``mma.sync``
m16n8k32 s8 x s8 -> s32, the (K, N) weight tile copied raw into shared
memory (``cp.async``, a four-deep ring over K) and transposed there with
byte permutes; K is split across CTAs where the tiles alone would leave
the card's SMs idle (``w8a8_plan``). ``quant_matmul_w4`` and the fused
linear's stage 2 run the same contraction, packed int4 weights unpacked
to s8 in shared memory. The Pallas kernel adds one f32
epilogue per K tile (three partial sums at K 1536 with its default
``block_k`` 512); the kernel and the plain version here accumulate exact
integers over all of K (the splits' int32 partial sums are added exactly)
and apply the epilogue once, as ``ref.quant_matmul`` does. What bounds it
on the H100 is the weight bytes (K x N) over HBM bandwidth.

The wrapper launches the kernel for CUDA tensors (counted in
``quant_matmul.launches``), takes the plain PyTorch version only for CPU
tensors and raises for any other device.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.core.quantizers import int_matmul

from . import build

GEMV_M = 8   # rows served by the GEMV (the reference's _GEMV_M)

_INVALID_VALUE = 1   # cudaErrorInvalidValue

_C = ctypes.c_int
_P = ctypes.c_void_p
# every entry of quant_matmul.cu: qx, m, k, sx, zx, qw, sw, n, then the
# tensor-core contraction's K splits and their scratch, the GEMV's SM
# count and columns per CTA (0: the plan's), out, stream
_OPS = [_P, _C, _C, _P, _P, _P, _P, _C]
_SPLIT = [_C, _P]
_GEMV = [_C, _C]
# (the GEMV's streamed plan also its split sums' scratch, before out)
_SIGNATURES = {"quant_gemv_w4": _OPS + _GEMV + [_P, _P, _P],
               "quant_gemv_stream": _OPS[:6] + [_C, _P, _C] + _GEMV
               + [_P, _P, _P],
               "quant_matmul_w4": _OPS + _SPLIT + [_P, _P],
               "quant_matmul": _OPS + _SPLIT + _GEMV + [_P, _P, _P],
               "quant_matmul_plan": [_C, _C, _C, _C,
                                     ctypes.POINTER(ctypes.c_longlong)],
               "ctq_code_gemv_plan": [_C] * 7
               + [ctypes.POINTER(ctypes.c_int)],
               "ctq_stream_plan": [_C] * 7
               + [ctypes.POINTER(ctypes.c_int)],
               "ctq_stream_totals": [_C] * 4
               + [ctypes.POINTER(ctypes.c_longlong)]}
PLAN_FIELDS = 9   # ctq::write_plan's


def quant_matmul_plain(qx, sx, zpx, qw, sw) -> torch.Tensor:
    """Plain PyTorch version: exact integer contraction, one epilogue."""
    acc = int_matmul(qx, qw)
    colsum = qw.to(torch.float32).sum(0, keepdim=True)
    return sx * sw * (acc - zpx * colsum)


def validate(qx, sx, zpx, qw, sw, w_rows: int) -> None:
    """Operand checks of the code contractions (``w_rows``: the weight's
    expected row count)."""
    if qx.ndim != 2 or qx.dtype != torch.int8:
        raise TypeError(f"qx must be int8 (M, K), got {qx.dtype} "
                        f"{tuple(qx.shape)}")
    if qw.ndim != 2 or qw.dtype != torch.int8:
        raise TypeError(f"qw must be int8 2-D, got {qw.dtype} "
                        f"{tuple(qw.shape)}")
    m, n = qx.shape[0], qw.shape[1]
    if qw.shape[0] != w_rows:
        raise ValueError(f"qw {tuple(qw.shape)} needs {w_rows} rows for "
                         f"K={qx.shape[1]}")
    for name, t, shape in (("sx", sx, (m, 1)), ("zpx", zpx, (m, 1)),
                           ("sw", sw, (1, n))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise TypeError(f"{name} must be f32 {shape}, got {t.dtype} "
                            f"{tuple(t.shape)}")
    for t in (sx, zpx, qw, sw):
        if t.device != qx.device:
            raise TypeError(f"all operands must be on {qx.device}")


@dataclasses.dataclass(frozen=True)
class GemvPlan:
    """Launch plan of the code GEMV (M <= 8): ``ctas`` CTAs, CTA i owning
    the output columns ``columns(i, n)``, ``cols`` of them, each
    contracting all of K; ``smem`` bytes of dynamic shared memory per
    CTA. On the streamed plan (``path`` 1, a deep K) ``ctas`` counts the
    column tiles ``columns(i, n)``, whose K each of ``splits`` work items
    takes a part of (``k_range``), in stages of ``ktile`` K through a ring
    of ``stages``; ``per_sm`` CTAs per SM take the work items in turn."""
    ctas: int
    cols: int
    smem: int
    path: int = 0
    ktile: int = 0
    splits: int = 1
    stages: int = 0
    per_sm: int = 1

    def columns(self, i: int, n: int) -> range:
        return range(min(i * self.cols, n), min((i + 1) * self.cols, n))

    def k_range(self, split: int, k: int) -> range:
        """The K of split ``split`` of a tile (all of K on path 0)."""
        return split_k_range(self, split, k)


def split_k_range(plan, split: int, k: int) -> range:
    """The K that split ``split`` of a streamed plan's tile contracts:
    stages [s·per, (s+1)·per) of ``ktile`` K, per = ceil(steps /
    splits), cut at K (``ctq::stream_per`` of ``csrc/cluster_plan.h``);
    all of K for a plan that does not split."""
    if plan.path != 1:
        return range(k)
    steps = -(-k // plan.ktile)
    per = -(-steps // plan.splits)
    lo = split * per * plan.ktile
    return range(min(lo, k), min(lo + per * plan.ktile, k))


def gemv_plan(m: int, k: int, n: int, packed: bool, sms: int,
              smem_optin: int = 0, cols: int = 0, lib=None) -> GemvPlan:
    """The code GEMV's plan (``ctq::code_gemv_plan`` of
    ``csrc/cluster_plan.h``, which the entries run on every call) for M
    rows of K codes against N columns on a card of ``sms`` SMs: ``cols``
    columns per CTA (0: the plan's own, the most that still give every SM
    a CTA). ``smem_optin`` (0: the current card's) bounds the shared
    memory per CTA; ``lib`` a library exporting ``ctq_code_gemv_plan``
    (default: the built CUDA library). Raises ValueError for a shape the
    kernel does not take."""
    lib = lib or build.load("quant_matmul", _SIGNATURES)
    out = (ctypes.c_int * PLAN_FIELDS)()
    if lib.ctq_code_gemv_plan(m, k, n, int(packed), sms, smem_optin, cols,
                              out):
        raise ValueError(f"the code GEMV does not take M={m}, K={k}, N={n},"
                         f" cols={cols}: it needs M in 1..8, the columns "
                         f"per CTA a multiple of 4 up to 256 and shared "
                         f"memory for its streamed ring at least "
                         f"(csrc/cluster_plan.h)")
    return GemvPlan(*out[1:4], *out[4:9])


def stream_totals(m: int, plan: GemvPlan, lib=None) -> int:
    """Bytes of the streamed plan's device scratch (each split's int32
    partial sums, ``ctq::stream_totals``); 0 for one split."""
    lib = lib or build.load("quant_matmul", _SIGNATURES)
    out = ctypes.c_longlong(0)
    lib.ctq_stream_totals(m, plan.ctas, plan.cols, plan.splits,
                          ctypes.byref(out))
    return int(out.value)


@functools.lru_cache(maxsize=1024)
def _served_plan(lib, *args):
    """The code GEMV's plan for a served shape, read once (its streamed
    path needs a scratch); None for a shape the plan refuses (the entry
    then reports it)."""
    try:
        return gemv_plan(*args, lib=lib)
    except ValueError:
        return None


def _gemv_scratch(lib, m, k, n, packed, sms, cols, device):
    """The streamed GEMV's scratch for its splits' partial sums (None on
    the one-tile plan, or for one split)."""
    plan = _served_plan(lib, m, k, n, packed, sms, 0, cols)
    if plan is None or plan.path != 1:
        return None
    nbytes = stream_totals(m, plan, lib=lib)
    return (torch.empty(nbytes, dtype=torch.uint8, device=device)
            if nbytes else None)


def launch(fn_name, qx, sx, zpx, qw, sw, planned: bool = False,
           gemv: bool = False, cols: int = 0) -> torch.Tensor:
    """Run entry ``fn_name`` of ``quant_matmul.cu`` -> (M, N) f32; a
    ``planned`` entry also takes the K splits of ``w8a8_plan`` and their
    scratch, a ``gemv`` one the card's SM count, ``cols`` columns per CTA
    (0: the plan's) and, on the GEMV's streamed plan, its totals'
    scratch."""
    m, k = qx.shape
    n = qw.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=qx.device)
    if m == 0 or n == 0:
        return out
    lib = build.load("quant_matmul", _SIGNATURES)
    extra = ()
    if planned:
        splits, ws = w8a8_plan(m, k, n, qx.device)
        extra = (splits, build.ptr(ws))
    if gemv:
        sms = build.sm_count(qx.device)
        gws = (_gemv_scratch(lib, m, k, n, fn_name == "quant_gemv_w4", sms,
                             cols, qx.device) if m <= GEMV_M else None)
        extra += (sms, cols, build.ptr(gws))
    qx, sx, zpx, qw, sw = (t.contiguous() for t in (qx, sx, zpx, qw, sw))
    code = getattr(lib, fn_name)(
        build.ptr(qx), m, k, build.ptr(sx), build.ptr(zpx), build.ptr(qw),
        build.ptr(sw), n, *extra, build.ptr(out), build.stream_of(qx))
    if code == _INVALID_VALUE and gemv and m <= GEMV_M:   # say why
        gemv_plan(m, k, n, fn_name == "quant_gemv_w4", sms, cols=cols,
                  lib=lib)
    build.check(code, fn_name)
    return out


def w8a8_plan(m: int, k: int, n: int, device):
    """K splits of the tensor-core contraction (W8A8, or W4A8 with K the
    unpacked depth) of an (M, K) x (K, N) product on ``device`` and their
    zeroed int32 scratch (None for one split). The CUDA source decides
    both (``quant_matmul_plan``), from its tile shape and the card's SM
    count."""
    lib = build.load("quant_matmul", _SIGNATURES)
    sms = build.sm_count(device)
    ints = ctypes.c_longlong(0)
    splits = lib.quant_matmul_plan(m, k, n, sms, ctypes.byref(ints))
    ws = (torch.zeros(ints.value, dtype=torch.int32, device=device)
          if ints.value else None)
    return splits, ws


def quant_matmul(qx, sx, zpx, qw, sw) -> torch.Tensor:
    """qx (M, K) int8, sx/zpx (M, 1) f32, qw (K, N) int8, sw (1, N) f32
    -> (M, N) f32."""
    if build.off_card(qx, "quant_matmul"):
        return quant_matmul_plain(qx, sx, zpx, qw, sw)
    validate(qx, sx, zpx, qw, sw, qx.shape[1])
    out = launch("quant_matmul", qx, sx, zpx, qw, sw, planned=True,
                 gemv=True)
    quant_matmul.launches += 1
    return out


quant_matmul.launches = 0


def gemv_stream(qx, sx, zpx, qw, sw, packed: bool):
    """The streamed contraction alone (entry ``quant_gemv_stream``: the
    code GEMV on ``ctq::stream_plan`` whatever the K, the decomposition
    the decode linear's streamed path runs), for timing it apart from the
    transform; CUDA tensors only -> (M, N) f32, bitwise the code GEMV's."""
    m, k = qx.shape
    n = qw.shape[1]
    validate(qx, sx, zpx, qw, sw, (k + 1) // 2 if packed else k)
    lib = build.load("quant_matmul", _SIGNATURES)
    sms = build.sm_count(qx.device)
    out = (ctypes.c_int * PLAN_FIELDS)()
    lib.ctq_stream_plan(m, k, n, int(packed), 0, sms, 0, out)
    plan = GemvPlan(*out[1:4], *out[4:9])
    nbytes = stream_totals(m, plan, lib=lib)
    gws = (torch.empty(nbytes, dtype=torch.uint8, device=qx.device)
           if nbytes else None)
    y = torch.empty((m, n), dtype=torch.float32, device=qx.device)
    qx, sx, zpx, qw, sw = (t.contiguous() for t in (qx, sx, zpx, qw, sw))
    build.check(lib.quant_gemv_stream(
        build.ptr(qx), m, k, build.ptr(sx), build.ptr(zpx), build.ptr(qw),
        int(packed), build.ptr(sw), n, sms, 0, build.ptr(gws),
        build.ptr(y), build.stream_of(qx)), "quant_gemv_stream")
    return y
