#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the final line):

1. device  — require ``torch.cuda.is_available()``; print the card's name
             and power limit as ``nvidia-smi`` reports them.
2. build   — compile every CUDA kernel of the serving path from
             ``src/repro_torch/csrc`` (one ``nvcc`` per source, in parallel).
3. kernels — each of the eleven kernels (the fused CAT linear's two
             entry points, both paged attentions, the decode QKV prologue,
             and the composed linear's block-CAT, Hadamard, dynamic quant
             and three code contractions) at its path's shapes against its
             plain PyTorch version on the same card, with its stated
             tolerance, its time, its plain version's time, its lower
             bound (bytes over 3.35 TB/s or operations over the peak rate
             for their type, H100 SXM data sheet) and, where one PyTorch
             call computes the same function, that call's time. Held
             bitwise: the fused linear and the decode prologue on f32
             inputs at every timed shape (the plain transform sums each
             dot as the kernels' in-order fmaf chain; bf16 inputs: the
             bitwise share is recorded and a two-code-step bound held);
             the one-launch cluster kernels (the fused linear at M <= 8,
             the prologue) also at every M in 1..8, ragged N, the bare
             Hadamard and int8 weights, and at the smoke config's widths
             (D 128 = 16 x 8, 256) and D 384, 768 (a factor of 24)
             (``check_gemv_edges``, ``check_prologue_edges``), each shown
             to be one kernel per call (the nodes of a CUDA graph
             capturing one call, and the kernels the profiler records),
             with its cluster plan and the clusters the card can hold at
             once; the fused linear at M 8 also timed with every forced
             number of columns per CTA from 4 to 128 (the column sweep,
             each bitwise to the plan's own);
             the block-CAT and the Hadamard on f32 inputs, also at ragged
             row counts (``check_block_edges``, ``check_hadamard_edges``,
             the Hadamard with every forced row tile, which is also
             timed); W4A8 ``quant_matmul_w4`` and W8A8 ``quant_matmul`` at
             ragged (M, K, N), odd K, several K splits, 4-bit and
             full-range int8 codes and code extremes
             (``check_w4_edges``, ``check_w8a8_edges``); the code GEMV of
             rows 7 and 8 (``quant_gemv_w4``, ``quant_matmul`` at M <= 8)
             bitwise at every M in 1..8, odd K, K not a multiple of 16,
             ragged N, int4 and int8 weights and code extremes, with its
             plan, one kernel per call, and at M 8, D 512, N 3072 every
             forced number of columns per CTA timed; at the dense
             family's deep K (the wd of mistral-nemo-12b, gemma3-12b,
             paligemma-3b, granite-34b) at M 1 and 8 on its streamed plan,
             mistral-nemo-12b's timed at M 8
             (``check_code_gemv_edges``, ``code_gemv_cols_sweep``); the
             fused linear (both entries) and the prologue at the widths
             the reference takes that split over no cluster (D 63 = 7 x
             9, 96 = 8 x 12, 24 = 4 x 6, 48 = 6 x 8 and 4 x 12, with and
             without CAT blocks, blocks of 6, 7, 8, 16), packed and int8,
             bitwise on f32, one kernel per call (the tiled linear: its
             two) (``check_width_edges``); the fused linear
             with int8 weights too; the tiled fused linear (M > 8) also at
             ragged M (9 to 255) and the widths D 128, 256, 384, 768, with
             its stage-1 plan, and at M 128 timed with every forced number
             of rows per cluster (the rows sweep, each bitwise to the
             plan's) (``check_tiled_edges``). The decode paged attention
             at the kernels-phase lengths (<= 160), the served ones (<=
             56) and 8 items of 1024 and of 2048 positions: within 4 bf16
             ulps of the output's scale (bitwise share recorded), f32
             queries within 1e-4 of the scale, two calls bitwise equal,
             one kernel node per call, its split plan, and every forced
             split timed (the split sweep); at every length of a table
             (``DECODE_LENGTHS``); and at its edges (B 1..8, hd 32/64/128,
             g 1/2/4/8, page 8/16/32, lengths 0, 1, ps, ps + 1, null pages
             and rows past each length poisoned, which must not change a
             bit) (``check_decode_edges``). The ragged attention at the
             kernels-phase step (8 items, Q 128, len <= 160) and the
             served one (len <= 56) (``RAGGED_SHAPES``): within 4 bf16
             ulps of the scale, f32 queries within 1e-4 of it, padding
             rows zeros, two calls bitwise equal, one kernel node per
             call, its plan; and at its edges (mixed decode and prefill
             items, padding rows, an item of length 0, q_pos at ps - 1,
             ps, ps + 1, hd 32/64/128, g 1/2/4/8, page 8/16/32, null
             pages and positions past each item's horizon poisoned, which
             must not change a bit) (``check_ragged_edges``). Both
             attentions' library yardstick is
             ``scaled_dot_product_attention`` on K and V gathered and
             dequantized outside the timed call; both also at
             granite-34b's heads (1 KV head of 128, 48 query heads) and
             mistral-nemo-12b's (8 of 128, 4 each), and timed at the moe
             family's (16 KV heads of 128, 1 each; 8 of 64, 2 each).
             Rows 1, 2 and 5 at every serving linear of the dense and moe
             families' seven configs
             (``check_family_widths``: M 1..8, 37, 128, packed and int8,
             the QKV heads for row 5; the streamed path where no cluster
             fits), bitwise on f32 with their plans and one kernel per
             call, mistral-nemo-12b's four linears timed.
4. serving — full-width catlm-60m (8 layers, d 512, 8/4 heads, d_ff 1536,
             vocab 8192), seeded random init, CAT W4A4 int4-packed PTQ on
             the card, 8 mixed requests (32 new tokens each) through the
             unified paged engine with the kernels, in two configurations:
             (a) the synchronous loop with composed decode layers
             (``REPRO_DECODE_FUSED=0``, ``pipeline=False``) and (b) the
             default: the pipelined loop with the two-launch decode. Every
             kernel must have launched during (b)'s counted pass, and (b)
             must be token-identical to its synchronous loop. Warm
             passes of (a), (b) and (b) with the synchronous loop then
             alternate five times (host time varies between passes). The
             synchronising CUDA calls in (b)'s dispatch half are counted
             (``torch.cuda.set_sync_debug_mode("warn")``). The reference
             routes (route 2 ``w_eff`` fake quant and gather attention, on
             the card), run teacher-forced over the served sequences, must
             predict >= 90 % of (a)'s and (b)'s tokens. (b) served
             free-running through the reference routes is reported too: on
             random weights one different token changes every later one,
             so that number measures divergence more than the path.
   Then the legacy schedule, the reference's default engine (prefill on
             admit, power-of-two buckets, one batched decode per step;
             ``legacy_phase``), on the same model and requests: (c) the
             slot cache, (c') the paged pool through the gather path, (d)
             the paged pool with the paged kernels (the decode attention
             and the two-launch decode). Each: a counted pass and two
             warm passes (tok/s, TTFT, ITL, host ms and dispatches per
             step). (c) and (c') must be token-identical, (d)'s counted
             pass must launch rows 1, 2, 4 and 5, and the reference
             routes, teacher-forced, must predict >= 90 % of (c)'s and
             (d)'s tokens.
   Then the prefix cache and speculative decoding (``prefix_spec_phase``),
             same model, 8 slots, 32 new tokens: (e) (b)'s engine with
             the prefix cache on 8 requests sharing 40 tokens, (e') (d)'s
             with it, each beside the same engine with the cache off;
             (f) (b)'s with ``speculative_k=4`` and a full-width draft
             (``build_draft_model``: the same checkpoint, CAT W4A8) on
             (b)'s requests, beside (b); (f') (f) with ``adaptive_spec``.
             Each: a counted pass and two warm passes, with the feature's
             counters. Held: well-formed tokens; teacher-forced agreement
             >= 0.9; (e) and (e') hit and copy a page in their counted
             pass and drain to the trie's pages; (f) launches rows 2 and
             3 (40 verify rows a step) and both pools drain. Reported: the
             share of tokens equal to the yardstick's, and the same rows
             through rows 1 and 2, and rows 4 and 3 (the kernels the two
             step shapes pick), compared bit for bit.
   Then training (``train_phase``): full-width catlm-60m, 120 AdamW
             steps, a bitwise resume, the trained model served.
   Then the dense family at full width (``families_phase``):
             seeded weights drawn, calibrated and CAT-W4A4-quantized one
             layer at a time on the card, served through (b)'s engine:
             (g) mistral-nemo-12b (10 of its 40 layers) on (b)'s 8
             requests, through all five serving kernels at its widths;
             (h) gemma2-2b (14 of 26 layers) on them and a
             4,160-token prompt past its 4096-token window (its attention
             on the gathered path, rows 1 and 2 for its linears). Printed:
             PTQ seconds, peak device memory, tok/s, TTFT, ITL, launches,
             and against the reference routes (built one layer at a time)
             the teacher-forced agreement, the reference's top-2 margins,
             the served token's rank and gap, the share of served tokens
             that repeat their input, and the reference's own response to
             a one-ulp rounding of its input, layer by layer and at the
             logits. Held: well-formed tokens, the rows launched,
             pipelined == synchronous tokens, the served path within 1.5x
             of that one-ulp response at every layer and at the logits
             (full depth, and the first layer alone served through the
             engine, whose served tokens are in the reference's top 5 at
             >= 0.9 of positions); (h) also teacher-forced agreement >=
             0.9. Then the moe family the same way: (i)
             granite-moe-1b-a400m and (j) moonshot-v1-16b-a3b (capacity
             factor 1.25: tokens drop, as in the reference) through all
             five serving kernels (their attention; the experts are
             batched GEMMs on codes dequantized per call, timed apart by
             ``expert_ms``), the dispatch half's synchronising calls held
             at 0; (i) also served dropless (capacity factor E/k), with
             the prefix cache and speculative decoding with and without
             drops (token shares printed, not held), and its dropless
             model held by ``batch_shape_probe``.
5. composed — ``ops.cat_transform_matmul`` (block-CAT -> Hadamard ->
             dynamic quant -> W4A8 GEMV / tiled or W8A8 contraction, four
             launches) on all 32 serving linears of the served CAT-W4A4
             params and of a CAT-W8A4 PTQ of the same seeded model, at 8
             and 128 rows: bf16 against the plain composition, f32 bitwise
             against the fused linear, each timed beside the fused linear;
             and mistral-nemo-12b's four linears at 8 rows of f32 (its wd
             on the code GEMV's streamed plan), bitwise against the fused
             linear. All six of its kernels must have launched in its
             counted pass.

The second line from the end is the per-kernel JSON summary, the last line
``{"ok": true, "device": {...}}``. Full results also go to
``chiprun_out/chip_smoke.json``.

    python3 chip_smoke.py --rows-2-4 [SRC]

times rows 1-5, 7, 8 and 9 only (the flag keeps its first name, from when it
timed rows 2 and 4), of the port package under SRC (another checkout's
``src``, such as the parent commit's; default this one's), at this
script's timed shapes and ``DECODE_LENGTHS``, and the streamed path's
halves at mistral-nemo-12b's widths (rows 1 and 5, row 2's streamed
stage 1, the transform alone and the contraction alone, ``stream_split``):
run it for two packages in turns within one call for a before/after of
those kernels (``compare_rows``).

    python3 chip_smoke.py --serve-g [SRC]

serves (g) mistral-nemo-12b with the port package under SRC (warm-up,
counted and profiled passes, no holds), for a before/after end to end in
one call (``serve_g``).
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_S = 3.35e12       # H100 SXM, HBM3
F32_FLOP_S = 67e12          # f32 outside the tensor cores
BF16_FLOP_S = 989e12        # bf16 tensor-core peak (dense)
INT8_OP_S = 1979e12         # int8 tensor-core peak (dense)

# main-path shapes: (D, N) of wqkv, wo, wgu, wd at catlm-60m's full width
LINEAR_SHAPES = [(512, 1024), (512, 512), (512, 3072), (1536, 512)]
GEMV_ROWS = (4, 8)            # decode steps run n_slots = 8 rows
TILED_ROWS = (64, 128, 256)   # the unified step packs 128 rows
CAT_BLOCK = 32                # min(cfg.cat_block, 32), as the PTQ uses
PROLOGUE_N = 1024             # wqkv columns: 8 q + 4 k + 4 v heads of 64
COMPOSED_ROWS = (8, 128)      # the composed linear at decode and step rows
SERVING_LINEARS = ("wqkv", "wo", "wgu", "wd")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def call_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean milliseconds per call of ``fn`` in a loop, between two CUDA
    events: the host's launch cost included when it exceeds the device's
    work (what the serving loop pays per call)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, calls: int = 20, replays: int = 10) -> float:
    """Device milliseconds per call of ``fn``: ``calls`` calls captured in
    one CUDA graph, replayed ``replays`` times between two CUDA events, so
    no host time enters the measurement."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def bound(nbytes: float, op_seconds: float) -> tuple:
    """(bound_ms, bound_by): the larger of bytes over HBM bandwidth and
    the operations' time at peak."""
    t_bytes = nbytes / HBM_BYTES_S
    if op_seconds > t_bytes:
        return 1e3 * op_seconds, "operations"
    return 1e3 * t_bytes, "bytes"


# ---------------------------------------------------------------- kernels

def fused_linear_operands(m, d, n, gen, dev):
    import torch

    from repro_torch.core.hadamard import hadamard_factors
    from repro_torch.core.quantizers import pack_int4
    x = torch.randn((m, d), generator=gen).to(torch.bfloat16)
    blocks = (torch.randn((d // CAT_BLOCK, CAT_BLOCK, CAT_BLOCK),
                          generator=gen) * 0.2 + torch.eye(CAT_BLOCK))
    ha, hb = (torch.tensor(h, dtype=torch.float32)
              for h in hadamard_factors(d))
    sign = torch.randint(0, 2, (d,), generator=gen).float() * 2 - 1
    codes = torch.randint(-8, 8, (d, n), generator=gen, dtype=torch.int8)
    qw = pack_int4(codes, axis=0)
    sw = torch.rand((1, n), generator=gen) * 0.02 + 0.001
    return [t.to(dev) for t in (x, blocks, ha, hb, sign, qw, sw)]


def check_fused_linear(name, run, rows, card, gen, dev):
    """Hold one fused-linear entry point against its plain version at
    every main-path (D, N) and each row count in ``rows``, timed with
    packed int4 weights and checked untimed with int8 weights too. On f32
    inputs: bitwise (the plain transform sums each dot as the kernel's
    in-order fmaf chain, the quant and the contraction are the kernel's
    ops). On bf16 inputs (timed): the share of bitwise outputs, and within
    two activation-code steps of the row's largest weight term
    (sx·sw·|q_w|) plus 1e-5 of the output's scale."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels import fused_cat_matmul as F
    out = []
    for d, n in LINEAR_SHAPES:
        for m in rows:
            args = fused_linear_operands(m, d, n, gen, dev)
            got = run(*args, act_bits=4, packed=True)
            want = F.fused_cat_linear_plain(*args, act_bits=4, packed=True)
            _, sx, _ = F.transform_quant_plain(*args[:5], 4)
            err = (got - want).abs().max().item()
            tol = (2 * sx.max().item() * args[6].max().item() * 8
                   + 1e-5 * want.abs().max().item())
            rows_off = int(((got - want).abs() > 1e-5 * want.abs().max())
                           .any(dim=1).sum().item())
            f32_args = (args[0].float(), *args[1:])
            f32_diff = int((run(*f32_args, act_bits=4, packed=True)
                            != F.fused_cat_linear_plain(
                                *f32_args, act_bits=4, packed=True))
                           .sum().item())
            call = lambda: run(*args, act_bits=4, packed=True)  # noqa: E731
            ms, per_call = device_ms(call), call_ms(call)
            plain_ms = device_ms(lambda: F.fused_cat_linear_plain(
                *args, act_bits=4, packed=True))
            a, b = args[2].shape[0], args[3].shape[0]
            nbytes = (m * d * 2 + d * CAT_BLOCK * 4 + (a * a + b * b) * 4
                      + d * 4 + ((d + 1) // 2) * n + n * 4 + m * n * 4)
            f32_flops = m * (2 * d * CAT_BLOCK + 2 * d * (a + b) + 6 * d)
            int_ops = 2 * m * d * n
            b_ms, b_by = bound(nbytes, f32_flops / F32_FLOP_S
                               + int_ops / INT8_OP_S)
            rec = {"kernel": name, "m": m, "d": d, "n": n,
                   "max_err": err, "tol": tol, "rows_off": rows_off,
                   "bf16_bitwise_share": (got == want).float().mean()
                   .item(), "f32_differing": f32_diff,
                   "kernel_ms": ms, "call_ms": per_call,
                   "plain_ms": plain_ms, "library_ms": None,
                   "bound_ms": b_ms, "bound_by": b_by, "card": card}
            # int8 weights (stage 2 is the same tensor-core contraction)
            w8 = torch.randint(-128, 128, (d, n), generator=gen,
                               dtype=torch.int8).to(dev)
            w8_args = (*args[:5], w8, args[6])
            got = run(*w8_args, act_bits=4, packed=False)
            want = F.fused_cat_linear_plain(*w8_args, act_bits=4,
                                            packed=False)
            rec["w8_max_err"] = (got - want).abs().max().item()
            rec["w8_tol"] = (2 * sx.max().item() * args[6].max().item()
                             * 128 + 1e-5 * want.abs().max().item())
            f32_w8 = (f32_args[0], *w8_args[1:])
            rec["w8_f32_differing"] = int(
                (run(*f32_w8, act_bits=4, packed=False)
                 != F.fused_cat_linear_plain(*f32_w8, act_bits=4,
                                             packed=False)).sum().item())
            if run is F.fused_cat_gemv_w4:
                # one launch per call, in clusters that can be resident
                plan = F.gemv_plan(m, d, n, a, b, CAT_BLOCK, True,
                                   build.sm_count(0))
                lib = build.load("fused_cat_matmul", F._SIGNATURES)
                rec["plan"] = dataclasses.asdict(plan)
                rec["resident_clusters"] = lib.fused_cat_gemv_capacity(
                    plan.cluster, plan.smem)
                rec["one_call"] = one_launch(call, "fused_cat_gemv_kernel")
                if m == max(rows):
                    rec["cols_sweep_ms"] = cols_sweep(args)
                if not rec["one_call"]["ok"]:
                    fail(f"{name} m={m} d={d} n={n} is not one launch: "
                         f"{json.dumps(rec['one_call'])}")
            if run is F.fused_cat_matmul_w4:
                rec["plan"] = dataclasses.asdict(F.tiled_plan(
                    m, d, a, b, CAT_BLOCK))
                if m == 128:
                    rec["rows_sweep_ms"] = rows_sweep(args)
            print(json.dumps(rec))
            if not err <= tol:
                fail(f"{name} m={m} d={d} n={n}: max error {err} > {tol}")
            if not rec["w8_max_err"] <= rec["w8_tol"]:
                fail(f"{name} W8 m={m} d={d} n={n}: {json.dumps(rec)}")
            if f32_diff or rec["w8_f32_differing"]:
                fail(f"{name} m={m} d={d} n={n}: not bitwise on f32 "
                     f"inputs: {json.dumps(rec)}")
            out.append(rec)
    return out


def attention_operands(items, nq, gen, dev, decode, kvh=4, g=2, hd=64,
                       ps=16):
    """A pool of int8 pages (by default page 16, 4 KV heads of hd 64, g 2
    query rows each) and work items (q_len, length): pages distinct per
    item, the table as wide as the longest item needs, null pages (0)
    past each length, padding rows q_pos = -1."""
    import torch
    n_ptab = max(1, max(-(-ln // ps) for _, ln in items))
    n_pages = 1 + len(items) * n_ptab
    kp = torch.randint(-127, 128, (n_pages, ps, kvh, hd), generator=gen,
                       dtype=torch.int8)
    vp = torch.randint(-127, 128, (n_pages, ps, kvh, hd), generator=gen,
                       dtype=torch.int8)
    ks = torch.rand((n_pages, ps, kvh, 1), generator=gen) * 0.02 + 0.001
    vs = torch.rand((n_pages, ps, kvh, 1), generator=gen) * 0.02 + 0.001
    table = torch.zeros((len(items), n_ptab), dtype=torch.int32)
    qpos = torch.full((len(items), nq), -1, dtype=torch.int32)
    lengths = torch.zeros((len(items),), dtype=torch.int32)
    for i, (ql, ln) in enumerate(items):
        used = -(-ln // ps)
        table[i, :used] = 1 + i * n_ptab + torch.arange(used)
        qpos[i, :ql] = torch.arange(ln - ql, ln)
        lengths[i] = ln
    shape = ((len(items), kvh, g, hd) if decode
             else (len(items), nq, kvh, g, hd))
    q = torch.randn(shape, generator=gen).to(torch.bfloat16)
    ts = [t.to(dev) for t in (q, kp, ks, vp, vs, table, lengths, qpos)]
    return ts, (kvh, g, hd, ps)


def attention_bound(items, dims, nq, q_parts=1):
    """Bound of a paged attention over bf16 queries (``q_parts`` 1) or f32
    queries split into two bf16 parts (2): the score products q·k and the
    P·V products on the bf16 tensor cores (int8 codes are exact in bf16;
    P times the V scale is split into two bf16 parts to hold f32
    accuracy), and five f32 operations per score outside them (K scale,
    max, exp, sum, V scale)."""
    kvh, g, hd, ps = dims
    nbytes = mma_flops = scores = 0
    for ql, ln in items:
        pages = -(-ln // ps)
        nbytes += pages * ps * kvh * (2 * hd + 2 * 4)   # K, V codes + scales
        nbytes += pages * 4 + 4 + nq * 4                 # table row, len, qpos
        nbytes += ql * kvh * g * hd * 2 * 2              # q in, out
        for j in range(ql):
            horizon = ln - ql + j + 1
            scores += kvh * g * horizon
            mma_flops += kvh * g * 2 * horizon * hd * (q_parts + 2)
    return bound(nbytes, mma_flops / BF16_FLOP_S + 5 * scores / F32_FLOP_S)


def sdpa_yardstick(args, decode):
    """The library call for an attention check: one
    ``scaled_dot_product_attention`` over K and V gathered from the pages
    and dequantized to q's dtype, with a boolean mask (decode: p < length;
    ragged: p <= q_pos and p < length), all built outside the timed call;
    grouped heads by ``enable_gqa`` where this torch has it, else K and V
    repeated per query head outside the call too. -> (call, what it leaves
    out, its output in the kernel's layout)."""
    import torch
    import torch.nn.functional as tf
    q, kp, ks, vp, vs, table, lengths, qpos = args
    if decode:
        q = q[:, None]
        qpos = (lengths - 1)[:, None]
    r, nq, kvh, g, hd = q.shape
    idx = table.long()
    k = (kp[idx].float() * ks[idx]).reshape(r, -1, kvh, hd)
    v = (vp[idx].float() * vs[idx]).reshape(r, -1, kvh, hd)
    k = k.transpose(1, 2).to(q.dtype).contiguous()      # (R, KVH, S, hd)
    v = v.transpose(1, 2).to(q.dtype).contiguous()
    pos = torch.arange(k.shape[2], device=q.device)
    mask = ((pos[None, None, :] <= qpos[:, :, None])
            & (pos[None, None, :] < lengths[:, None, None])
            & (qpos[:, :, None] >= 0))[:, None]          # (R, 1, Q, S)
    qh = q.permute(0, 2, 3, 1, 4).reshape(r, kvh * g, nq, hd).contiguous()
    what = ("torch.nn.functional.scaled_dot_product_attention on K, V "
            "gathered from the pages and dequantized to q's dtype outside "
            "the timed call (the gather and the dequant left out), boolean "
            "length/causal mask")
    try:
        tf.scaled_dot_product_attention(qh, k, v, attn_mask=mask,
                                        enable_gqa=True)

        def call():
            return tf.scaled_dot_product_attention(qh, k, v, attn_mask=mask,
                                                   enable_gqa=True)
    except RuntimeError as exc:
        return None, f"unavailable ({exc}): " + what, None
    except TypeError:
        k = k.repeat_interleave(g, dim=1)
        v = v.repeat_interleave(g, dim=1)
        what += ", K and V repeated per query head outside the call"

        def call():
            return tf.scaled_dot_product_attention(qh, k, v, attn_mask=mask)
    if usable(call) is None:
        return None, "unavailable: " + what, None
    out = call().reshape(r, kvh, g, nq, hd).permute(0, 3, 1, 2, 4)
    return call, what, out[:, 0] if decode else out


def profiled_kernels(fn) -> list:
    """Names of the device kernels that one call of ``fn`` runs."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA})


def check_attention(name, run, plain, items, nq, card, gen, dev, decode,
                    label="", heads=(4, 2, 64)):
    """Hold a paged-attention entry point against its plain version on the
    valid query rows (length 0 decode rows and ragged padding rows:
    zeros). Tolerance: 4 bf16 ulps of the output's scale (1.6e-2
    relative), since both round their f32 result to bf16; the bitwise
    share is recorded, and a second call on the same inputs must give the
    same bits; f32 queries within 1e-4 of the scale; one kernel node per
    call (CUDA graph); its plan. Decode also: the device ms of every
    forced split (``SPLITS``), each within the tolerance. The library
    yardstick is ``sdpa_yardstick``. ``heads``: (KV heads, query heads
    per KV head, head_dim)."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels import fused_cat_matmul as F
    kvh, g, hd = heads
    args, dims = attention_operands(items, nq, gen, dev, decode, kvh=kvh,
                                    g=g, hd=hd)
    call = args[:7] if decode else args
    got = run(*call)
    want = plain(*call)
    valid = (args[6] > 0) if decode else args[7] >= 0
    diff = (got.float() - want.float()).abs()[valid]
    err = diff.max().item()
    tol = 1.6e-2 * want.float()[valid].abs().max().item()
    again = run(*call)
    library, what, lib_out = sdpa_yardstick(args, decode)
    ms, per_call = device_ms(lambda: run(*call)), call_ms(lambda: run(*call))
    plain_ms = device_ms(lambda: plain(*call))
    b_ms, b_by = attention_bound(items, dims, 1 if decode else nq)
    rec = {"kernel": name, "shape": label, "items": len(items),
           "heads": list(heads), "q_block": 1 if decode else nq,
           "max_len": max(ln for _, ln in items), "max_err": err,
           "tol": tol, "bf16_bitwise_share":
           (got == want)[valid].float().mean().item(),
           "repeat_bitwise": bool(torch.equal(got, again)),
           "kernel_ms": ms, "call_ms": per_call, "plain_ms": plain_ms,
           "library_ms": None if library is None else device_ms(library),
           "library": what,
           "library_kernels": None if library is None
           else profiled_kernels(library),
           "library_max_err": None if library is None
           else (lib_out.float() - want.float()).abs()[valid].max().item(),
           "bound_ms": b_ms, "bound_by": b_by, "card": card}
    ok = err <= tol and rec["repeat_bitwise"]
    from repro_torch.kernels import paged_attention as P
    if not bool((got[~valid] == 0).all()):
        fail(f"{name} {label}: a length-0 item or padding row is not zeros")
    q32 = args[0].float()
    f32_err = (run(q32, *call[1:]) - plain(q32, *call[1:])).abs()[
        valid].max().item()
    rec["f32_max_err"] = f32_err
    rec["f32_tol"] = 1e-4 * want.float()[valid].abs().max().item()
    ok = ok and f32_err <= rec["f32_tol"]
    kvh, g, hd, ps = dims
    if decode:
        rec["plan"] = dataclasses.asdict(P.decode_plan(
            len(items), kvh, g, hd, ps, args[5].shape[1], build.sm_count(0)))
    else:
        rec["plan"] = dataclasses.asdict(P.ragged_plan(
            len(items), nq, kvh, g, hd, ps))
    rec["one_call"] = one_launch(
        lambda: run(*call),
        "paged_attn_decode" if decode else "paged_attn_ragged")
    ok = ok and rec["one_call"]["ok"]
    if decode:
        rec["split_sweep_ms"], rec["split_sweep_max_err"] = {}, {}
        # the most splits whose layout fits this head shape (a table wide
        # enough for 8)
        most = P.decode_plan(1, kvh, g, hd, ps, 1024, build.sm_count(0)
                             ).split
        for split in [s for s in SPLITS if s <= most]:
            out = P._launch_decode(*call, split=split)
            e = (out.float() - want.float()).abs()[valid].max().item()
            rec["split_sweep_max_err"][split] = e
            rec["split_sweep_ms"][split] = device_ms(
                lambda s=split: P._launch_decode(*call, split=s))
            ok = ok and e <= tol
    print(json.dumps(rec))
    if not ok:
        fail(f"{name} {label}: {json.dumps(rec)}")
    return [rec]


# row 4's timed shapes: (label, lengths of the items); decode rows attend
# p < length
DECODE_SHAPES = [
    ("kernels phase, len <= 160", (160, 1, 17, 64, 100, 33, 5, 128)),
    ("served, len <= 56", (56, 9, 33, 41, 24, 50, 17, 48)),
    ("long, 8 x 1024", (1024,) * 8),
    ("long, 8 x 2048", (2048,) * 8)]
SPLITS = (1, 2, 4, 8)
# row 4 at one length for all 8 items, page 16
DECODE_LENGTHS = (1, 16, 56, 128, 160, 256, 512, 1024, 2048)


def time_decode_lengths(P, gen, dev) -> list:
    """Row 4 of the package ``P`` (its ``paged_attention`` module) with 8
    items all at each length of ``DECODE_LENGTHS`` (bf16 q, 4 KV heads of
    2 rows, hd 64): device ms per call, the byte bound, and the max error
    against its plain version (held within 4 bf16 ulps of the scale)."""
    recs = []
    for ln in DECODE_LENGTHS:
        items = [(1, ln)] * 8
        args, dims = attention_operands(items, 1, gen, dev, True)
        args = args[:7]
        want = P.paged_attention_decode_plain(*args)
        err = (P.paged_attention_decode(*args).float() - want.float()).abs(
            ).max().item()
        tol = 1.6e-2 * want.float().abs().max().item()
        b_ms, b_by = attention_bound(items, dims, 1)
        recs.append({"kernel": "paged_attention_decode", "length": ln,
                     "items": 8, "kernel_ms": device_ms(
                         lambda: P.paged_attention_decode(*args)),
                     "bound_ms": b_ms, "bound_by": b_by, "max_err": err,
                     "tol": tol})
        if not err <= tol:
            fail(f"paged_attention_decode at length {ln}: {recs[-1]}")
    return recs


# (KV heads, head_dim, query heads per KV head, page size) of the
# attentions' edge grids, and the dense family's heads at page 16:
# granite-34b (MQA: 1 KV head of 128 for 48 query heads) and
# mistral-nemo-12b (8 of 128, 4 each); and the moe family's:
# moonshot-v1-16b-a3b (multi-head: 16 KV heads of 128, 1 each) and
# granite-moe-1b-a400m (8 of 64, 2 each)
ATTENTION_EDGE_HEADS = ([(2, hd, g, ps) for hd in (32, 64, 128)
                         for g in (1, 2, 4, 8) for ps in (8, 16, 32)]
                        + [(1, 128, 48, 16), (8, 128, 4, 16),
                           (16, 128, 1, 16), (8, 64, 2, 16)]
                        # the head dims the kernels take at a padded
                        # width: paligemma-3b's (1 KV head of 256, group
                        # 8), 256 at other groups, 112, and widths built
                        # at 32, 64 and 256
                        + [(1, 256, 8, 16), (1, 256, 8, 8), (2, 256, 1, 32),
                           (2, 256, 4, 16), (4, 112, 1, 16), (2, 112, 2, 8),
                           (2, 40, 2, 16), (2, 24, 4, 8), (2, 8, 8, 16),
                           (2, 200, 3, 32)])
# rows 3 and 4 timed at the moe family's heads (KV heads, query heads per
# KV head, head_dim), at the served shapes
MOE_HEADS = {"moonshot-v1-16b-a3b": (16, 1, 128),
             "granite-moe-1b-a400m": (8, 2, 64)}
# and at head dims the kernels take at a padded width: paligemma-3b's,
# 112 (4 KV heads of 1 query head), and 40 (built at 64)
HEADDIM_HEADS = {"paligemma-3b": (1, 8, 256), "hd 112": (4, 1, 112),
                 "hd 40": (2, 2, 40)}
# paligemma's heads also at long prefixes: row 4 on 8 items of 2048
# positions, row 3 on a prefill chunk of 128 rows and 7 decode rows, each
# item ending at 2048
HEADDIM_LONG = ("long, 8 x 2048", [(128, 2048)] + [(1, 2048)] * 7)


def check_decode_edges(gen, dev):
    """The decode attention (row 4) at its edges, against the plain
    version on the valid rows (4 bf16 ulps of the scale for bf16 q, 1e-4
    of the scale for f32 q; length-0 items zeros): B 1..8, hd 32, 64,
    128, g 1, 2, 4, 8, page sizes 8, 16, 32, lengths 0, 1, ps, ps + 1 and
    longer, each on the plan's split and forced to 4 (so empty splits and
    length 0 run in a cluster); two calls bitwise equal; and with the null
    page 0 and every row past each length poisoned (codes +-127, scales
    1e8) bitwise equal to the clean call, so no such row is read."""
    import torch

    from repro_torch.kernels import paged_attention as P
    recs = []
    case = 0
    for kvh, hd, g, ps in ATTENTION_EDGE_HEADS:
        b = 1 + case % 8
        case += 1
        lens = [(0, 1, ps, ps + 1, 3 * ps + 5, 1, 2 * ps, 0)[
            (i + case) % 8] for i in range(b)]
        items = [(1, ln) for ln in lens]
        args, _ = attention_operands(items, 1, gen, dev, True,
                                     kvh=kvh, g=g, hd=hd, ps=ps)
        call = args[:7]
        valid = args[6] > 0
        poisoned = [t.clone() for t in call]
        kp, ks, vp, vs = poisoned[1:5]
        past = torch.zeros(kp.shape[:2], dtype=torch.bool)
        past[0] = True                  # the null page
        for i, ln in enumerate(lens):
            for j, page in enumerate(args[5][i].tolist()):
                if page:
                    past[page, max(0, ln - j * ps):] = True
        past = past.to(dev)
        kp[past], vp[past], ks[past], vs[past] = 127, -127, 1e8, 1e8
        for q in (args[0], args[0].float()):
            want = P.paged_attention_decode_plain(q, *call[1:])
            scale = want.float()[valid].abs().max().item() \
                if bool(valid.any()) else 0.0
            tol = (1.6e-2 if q.dtype == torch.bfloat16
                   else 1e-4) * scale
            for split in (0, 4):
                got = P._launch_decode(q, *call[1:], split=split)
                err = ((got.float() - want.float()).abs()[valid]
                       .max().item() if bool(valid.any()) else 0.0)
                rec = {"kernel": "paged_attention_decode", "b": b,
                       "kvh": kvh, "hd": hd, "g": g, "ps": ps,
                       "lengths": lens,
                       "dtype": str(q.dtype), "split": split,
                       "max_err": err, "tol": tol,
                       "zeros_at_len_0": bool(
                           (got[~valid] == 0).all()),
                       "repeat_bitwise": bool(torch.equal(
                           got, P._launch_decode(q, *call[1:],
                                                 split=split))),
                       "poison_bitwise": bool(torch.equal(
                           got, P._launch_decode(q, *poisoned[1:],
                                                 split=split)))}
                recs.append(rec)
                if not (err <= tol and rec["zeros_at_len_0"]
                        and rec["repeat_bitwise"]
                        and rec["poison_bitwise"]):
                    fail(f"paged_attention_decode edge: "
                         f"{json.dumps(rec)}")
    print("paged_attention_decode edges " + json.dumps(recs))
    return recs


# row 3's timed shapes: (label, work items (q_len, length)) in a query
# block of RAGGED_Q rows per item, as the unified step packs them
RAGGED_Q = 128
RAGGED_SHAPES = [
    ("kernels phase, len <= 160",
     [(128, 160), (1, 97), (64, 64), (1, 33), (24, 150), (0, 0), (16, 40),
      (1, 160)]),
    ("served, len <= 56",
     [(24, 24), (8, 8), (20, 20), (1, 40), (16, 16), (1, 56), (12, 12),
      (1, 33)])]


def check_ragged_edges(gen, dev):
    """The ragged attention (row 3) at its edges, against the plain
    version on the valid rows (q_pos >= 0; 4 bf16 ulps of the scale for
    bf16 q, 1e-4 of the scale for f32 q; padding rows zeros): mixed decode
    and prefill items, padding rows past the longest item, an item of
    length 0 (all rows padding), q_pos at page boundaries (ps - 1, ps, ps
    + 1), prefill chunks ending mid-page and mid-tile, hd 32, 64, 128, g
    1, 2, 4, 8, page sizes 8, 16, 32; two calls bitwise equal; and with the
    null page 0 and every position past each item's horizon (its length)
    poisoned (codes +-127, scales 1e8) bitwise equal to the clean call, so
    no such position is read."""
    import torch

    from repro_torch.kernels import paged_attention as P
    recs = []
    case = 0
    for kvh, hd, g, ps in ATTENTION_EDGE_HEADS:
        case += 1
        pattern = [(1, ps), (ps + 2, ps + 2), (1, ps + 1), (0, 0),
                   (5, 3 * ps + 5), (1, ps + 2), (2 * ps, 2 * ps + 3),
                   (1, 1)]
        b = 2 + case % 7
        items = [pattern[(i + case) % 8] for i in range(b)]
        nq = max(ql for ql, _ in items) + 3 * (case % 3)
        args, _ = attention_operands(items, nq, gen, dev, False,
                                     kvh=kvh, g=g, hd=hd, ps=ps)
        valid = args[7] >= 0
        poisoned = [t.clone() for t in args]
        kp, ks, vp, vs = poisoned[1:5]
        past = torch.zeros(kp.shape[:2], dtype=torch.bool)
        past[0] = True                  # the null page
        for i, (_, ln) in enumerate(items):
            for j, page in enumerate(args[5][i].tolist()):
                if page:
                    past[page, max(0, ln - j * ps):] = True
        past = past.to(dev)
        kp[past], vp[past], ks[past], vs[past] = 127, -127, 1e8, 1e8
        for q in (args[0], args[0].float()):
            want = P.paged_attention_ragged_plain(q, *args[1:])
            scale = want.float()[valid].abs().max().item() \
                if bool(valid.any()) else 0.0
            tol = (1.6e-2 if q.dtype == torch.bfloat16
                   else 1e-4) * scale
            got = P._launch_ragged(q, *args[1:])
            err = ((got.float() - want.float()).abs()[valid]
                   .max().item() if bool(valid.any()) else 0.0)
            rec = {"kernel": "paged_attention_ragged", "items": items,
                   "q_block": nq, "kvh": kvh, "hd": hd, "g": g, "ps": ps,
                   "dtype": str(q.dtype), "max_err": err,
                   "tol": tol,
                   "zeros_at_padding": bool(
                       (got[~valid] == 0).all()),
                   "repeat_bitwise": bool(torch.equal(
                       got, P._launch_ragged(q, *args[1:]))),
                   "poison_bitwise": bool(torch.equal(
                       got, P._launch_ragged(q, *poisoned[1:])))}
            recs.append(rec)
            if not (err <= tol and rec["zeros_at_padding"]
                    and rec["repeat_bitwise"]
                    and rec["poison_bitwise"]):
                fail(f"paged_attention_ragged edge: "
                     f"{json.dumps(rec)}")
    print("paged_attention_ragged edges " + json.dumps(recs))
    return recs


# (K, N) of the code GEMV's edges: the main-path shapes, odd K, K not a
# multiple of 16, narrow and ragged N, and a deep K
GEMV_CODE_EDGES = [(512, 3072), (1536, 512), (63, 40), (1535, 520),
                   (24, 1000), (16, 8), (4096, 64)]
# a deep K at a wide N, where 64 columns of int8 weights do not fit in a
# CTA's shared memory and the plan takes fewer (held at M 1 and 8)
GEMV_DEEP_WIDE = (4096, 32000)
# (K, N) of the dense family's wd (d_ff at d_model): mistral-nemo-12b,
# gemma3-12b, paligemma-3b, granite-34b; a K no CTA's tile of all of K
# holds at M 8, which the code GEMV streams (held at M 1 and 8)
GEMV_DEEP_K = [(14336, 5120), (15360, 3840), (16384, 2048), (24576, 6144)]
GEMV_SWEEP_COLS = (4, 8, 16, 32, 64, 128)


def code_gemv_cols_sweep(args, packed) -> dict:
    """Device ms of the code GEMV (row 7 packed, row 8 int8) on ``args``
    with each forced number of output columns per CTA
    (``GEMV_SWEEP_COLS``), bitwise to the plan's own choice; the plan's
    choice under key "plan"."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels import quant_matmul as QM
    m, k = args[0].shape
    n = args[3].shape[1]
    fn = "quant_gemv_w4" if packed else "quant_matmul"
    extra = dict(gemv=True, planned=not packed)
    want = QM.launch(fn, *args, **extra)
    out = {"plan": QM.gemv_plan(m, k, n, packed,
                                build.sm_count(args[0].device)).cols}
    for cols in GEMV_SWEEP_COLS:
        got = QM.launch(fn, *args, cols=cols, **extra)
        if not torch.equal(got, want):
            fail(f"{fn} with {cols} columns per CTA differs from the "
                 f"plan's at m={m} k={k} n={n}")
        out[cols] = device_ms(lambda c=cols: QM.launch(fn, *args, cols=c,
                                                       **extra))
    return out


def check_code_gemv_edges(gen, dev):
    """The code GEMV of rows 7 (``quant_gemv_w4``, packed int4 weights,
    4-bit codes) and 8 (``quant_matmul`` at M <= 8, int8 weights,
    full-range int8 codes) bitwise against their plain versions (exact
    integer accumulation and one epilogue in the same op order) at every
    M in 1..8 and each (K, N) of ``GEMV_CODE_EDGES`` (odd K: the missing
    code reads as 0 against the zero high nibble) and at M 1 and 8 at
    ``GEMV_DEEP_WIDE`` and the family's deep K (``GEMV_DEEP_K``: the
    streamed plan at M 8, one launch of its kernel), with its plan; and at
    code extremes, where each sum passes 2^24: codes -128 against -8 (int8:
    -128) but the last three (1), and alternating -128 / 127 against 7 /
    -8 (int8: 127 / -128) along K. -> (row 7's records, row 8's)."""
    import torch

    from repro_torch.core.quantizers import pack_int4
    from repro_torch.kernels import build
    from repro_torch.kernels import quant_matmul as QM
    from repro_torch.kernels import quant_matmul_w4 as QW
    recs = {True: [], False: []}
    sms = build.sm_count(dev)

    def held(args, packed, rec):
        run = QW.quant_gemv_w4 if packed else QM.quant_matmul
        plain = QW.quant_matmul_w4_plain if packed else QM.quant_matmul_plain
        got, want = run(*args), plain(*args)
        m, k = args[0].shape
        n = args[3].shape[1]
        rec.update({"kernel": "quant_gemv_w4" if packed else "quant_matmul",
                    "m": m, "d": k, "n": n,
                    "plan": dataclasses.asdict(QM.gemv_plan(m, k, n, packed,
                                                            sms)),
                    "max_err": (got - want).abs().max().item(),
                    "differing": int((got != want).sum().item())})
        recs[packed].append(rec)
        if rec["differing"]:
            fail(f"{rec['kernel']} GEMV edge not bitwise: {json.dumps(rec)}")

    cases = [(m, k, n) for k, n in GEMV_CODE_EDGES for m in range(1, 9)]
    for m, k, n in cases + [(m, *GEMV_DEEP_WIDE) for m in (1, 8)]:
        for packed in (True, False):
            args, _ = contraction_operands(m, k, n, gen, dev, packed,
                                           4 if packed else 8)
            held(args, packed, {})
    run = {True: QW.quant_gemv_w4, False: QM.quant_matmul}
    for k, n in GEMV_DEEP_K:
        for packed in (True, False):
            args8, _ = contraction_operands(8, k, n, gen, dev, packed,
                                            4 if packed else 8)
            for m in (1, 8):
                args = [t[:m] for t in args8[:3]] + args8[3:]
                rec = {"deep_k": True}
                held(args, packed, rec)
                if m == 8:
                    rec["one_call"] = one_launch(
                        lambda: run[packed](*args),
                        "code_gemv_stream_kernel")
                    if rec["plan"]["path"] != 1 or not rec["one_call"]["ok"]:
                        fail(f"deep K not one streamed launch: "
                             f"{json.dumps(rec)}")
            del args, args8
    for m, k, n, pattern in ((8, 1536, 40, "min"), (3, 1535, 24, "min"),
                             (8, 1536, 72, "alternating"),
                             (5, 1535, 24, "alternating")):
        for packed in (True, False):
            lo, hi = (-8, 7) if packed else (-128, 127)
            if pattern == "min":
                qx = torch.full((m, k), -128, dtype=torch.int8)
                w = torch.full((k, n), lo, dtype=torch.int8)
                qx[:, -3:], w[-3:] = 1, 1
            else:
                qx = torch.where(torch.arange(k) % 2 == 1, 127, -128).to(
                    torch.int8).expand(m, k).contiguous()
                w = torch.where(torch.arange(k)[:, None] % 2 == 1, lo,
                                hi).to(torch.int8).expand(k, n).contiguous()
            sx = torch.rand((m, 1), generator=gen) * 0.02 + 0.001
            zx = torch.randint(-128, 128, (m, 1), generator=gen).float()
            sw = torch.rand((1, n), generator=gen) * 0.02 + 0.001
            qw = pack_int4(w, axis=0) if packed else w
            args = [t.to(dev) for t in (qx, sx, zx, qw, sw)]
            held(args, packed, {"codes": pattern})
    print("code GEMV edges " + json.dumps(recs[True] + recs[False]))
    return recs[True], recs[False]


# (D, a, b, CAT blocks) the reference's fused kernels take that split over
# no cluster: a the largest divisor of D <= sqrt(D), as the reference's
# tests factor D, and D 48 also at 4 x 12
WIDTH_EDGES = [(63, 7, 9, 0), (63, 7, 9, 7), (96, 8, 12, 0), (96, 8, 12, 6),
               (96, 8, 12, 16), (24, 4, 6, 0), (24, 4, 6, 3), (48, 6, 8, 0),
               (48, 4, 12, 0)]


def width_operands(m, d, a, b, nblk, n, gen, dev, packed):
    """Fused-linear operands at any width, as the reference's tests make
    them: f32 rows, CAT blocks (nblk of D / nblk, or None), arbitrary
    Kronecker factors (the kernels need no Hadamard structure), a sign,
    int4-packed or int8 weight codes and their scales."""
    import torch

    from repro_torch.core.quantizers import pack_int4
    x = torch.randn((m, d), generator=gen)
    blocks = None
    if nblk:
        bk = d // nblk
        blocks = (torch.randn((nblk, bk, bk), generator=gen) * 0.3
                  + torch.eye(bk))
    ha = torch.randn((a, a), generator=gen) / a ** 0.5
    hb = torch.randn((b, b), generator=gen) / b ** 0.5
    sign = torch.randint(0, 2, (d,), generator=gen).float() * 2 - 1
    if packed:
        qw = pack_int4(torch.randint(-8, 8, (d, n), generator=gen,
                                     dtype=torch.int8), axis=0)
    else:
        qw = torch.randint(-128, 128, (d, n), generator=gen,
                           dtype=torch.int8)
    sw = torch.rand((1, n), generator=gen) * 0.02 + 0.001
    return [None if t is None else t.to(dev)
            for t in (x, blocks, ha, hb, sign, qw, sw)]


def check_width_edges(gen, dev):
    """Rows 1, 2 and 5 at the widths of ``WIDTH_EDGES`` (odd D, factors
    and CAT blocks that are not multiples of 4), with int4-packed and int8
    weights, bitwise against their plain versions on f32 inputs: the
    decode linear at M 1, 5, 8 and the tiled one at M 9, 40 (N 40), the
    prologue at B 1, 3, 8 (4 q + 2 k + 2 v heads of 8, the reference
    test's); each with its plan, and the decode linear and the prologue
    one kernel per call (the tiled linear: its two, stage 1 and the
    contraction). -> {kernel: records}."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels import decode_layer as L
    from repro_torch.kernels import fused_cat_matmul as F
    out = {"fused_cat_gemv_w4": [], "fused_cat_matmul_w4": [],
           "decode_qkv_prologue": []}
    kw = dict(n_q=32, head_dim=8, rope_theta=10000.0, kv_bits=8, act_bits=4)
    for d, a, b, nblk in WIDTH_EDGES:
        bk = d // nblk if nblk else 0
        for packed in (True, False):
            base = {"d": d, "a": a, "b": b, "blocks": nblk, "packed": packed}
            for name, rows in (("fused_cat_gemv_w4", (1, 5, 8)),
                               ("fused_cat_matmul_w4", (9, 40))):
                run = getattr(F, name)
                for m in rows:
                    args = width_operands(m, d, a, b, nblk, 40, gen, dev,
                                          packed)
                    got = run(*args, act_bits=4, packed=packed)
                    want = F.fused_cat_linear_plain(*args, act_bits=4,
                                                    packed=packed)
                    plan = (F.gemv_plan(m, d, 40, a, b, bk, packed,
                                        build.sm_count(0))
                            if m <= 8 else F.tiled_plan(m, d, a, b, bk))
                    rec = dict(base, kernel=name, m=m,
                               plan=dataclasses.asdict(plan),
                               max_err=(got - want).abs().max().item(),
                               differing=int((got != want).sum().item()))
                    if m in (8, 40):
                        rec["one_call"] = one_launch(
                            lambda: run(*args, act_bits=4, packed=packed),
                            "fused_cat_gemv_kernel" if m <= 8 else
                            ("cluster_transform_quant_kernel",
                             "mma_kernel"))
                    out[name].append(rec)
                    if rec["differing"] or not rec.get(
                            "one_call", {"ok": True})["ok"]:
                        fail(f"{name} width edge: {json.dumps(rec)}")
            for m in (1, 3, 8):
                args = width_operands(m, d, a, b, nblk, 64, gen, dev, packed)
                shape = (40, 16, 2, 8)
                pools = [torch.randint(-127, 128, shape, generator=gen,
                                       dtype=torch.int8),
                         torch.rand(shape[:3] + (1,), generator=gen),
                         torch.randint(-127, 128, shape, generator=gen,
                                       dtype=torch.int8),
                         torch.rand(shape[:3] + (1,), generator=gen)]
                pools = [t.to(dev) for t in pools]
                ids = [torch.tensor(v, dtype=torch.int32, device=dev)
                       for v in ([1 + i for i in range(m)],
                                 [(5 * i) % 16 for i in range(m)],
                                 [16 * i + (5 * i) % 16 for i in range(m)])]
                got = [t.clone() for t in pools]
                want = [t.clone() for t in pools]
                q = L.decode_qkv_prologue(*args, *got, *ids, packed=packed,
                                          **kw)[0]
                q_want = L.decode_qkv_prologue_plain(*args, *want, *ids,
                                                     packed=packed, **kw)[0]
                diff = int((q != q_want).sum().item()) + sum(
                    int((g_ != w_).sum().item()) for g_, w_ in zip(got, want))
                plan = L.prologue_plan(m, d, 64, 8, a, b, bk, packed)
                rec = dict(base, kernel="decode_qkv_prologue", m=m,
                           plan=dataclasses.asdict(plan),
                           max_err=(q - q_want).abs().max().item(),
                           differing=diff)
                if m == 8:
                    rec["one_call"] = one_launch(
                        lambda: L.decode_qkv_prologue(
                            *args, *got, *ids, packed=packed, **kw),
                        "decode_qkv_prologue_kernel")
                out["decode_qkv_prologue"].append(rec)
                if diff or not rec.get("one_call", {"ok": True})["ok"]:
                    fail(f"decode_qkv_prologue width edge: {json.dumps(rec)}")
    print("width edges " + json.dumps(out))
    return out


def prologue_operands(m, gen, dev, targets, d=512, n_q=512, kvh=4, hd=64):
    """Decode-prologue operands, by default at the path's shapes (D 512, N
    1024 = 8 q + 4 k + 4 v heads of 64), over a pool of 40 pages of 16
    rows, and the rows' (page, row, position) targets."""
    import torch
    args = fused_linear_operands(m, d, n_q + 2 * kvh * hd, gen, dev)
    ps = 16
    shape = (40, ps, kvh, hd)
    pools = [torch.randint(-127, 128, shape, generator=gen,
                           dtype=torch.int8),
             torch.rand(shape[:3] + (1,), generator=gen) * 0.02 + 0.001,
             torch.randint(-127, 128, shape, generator=gen,
                           dtype=torch.int8),
             torch.rand(shape[:3] + (1,), generator=gen) * 0.02 + 0.001]
    ids = [torch.tensor([t[i] for t in targets], dtype=torch.int32)
           for i in range(3)]
    return args, [t.to(dev) for t in pools], [t.to(dev) for t in ids]


def check_prologue(card, gen, dev):
    """Hold the decode QKV prologue against its plain version at the
    path's shapes for B = 1, 4 and 8, with padded rows (page 0) and rows on
    the ragged last slot of a page. On f32 inputs: q and every page but 0
    (which takes the padded rows' writes in no fixed order) bitwise. On bf16 inputs (timed; the
    share of bitwise q recorded): q within rtol 1e-5 of its row's largest
    |q| (RoPE's two terms cancel near zero); KV codes bitwise and scales
    at rtol 1e-5 on the targeted rows — or, where an activation code
    moved, codes off by 1 on at most 0.1 % of entries and q within two
    activation-code steps; every page other than 0 and every untargeted
    row unchanged."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels import decode_layer as L
    from repro_torch.kernels import fused_cat_matmul as F
    out = []
    layouts = {1: [(5, 15, 15)],
               4: [(3, 15, 31), (7, 0, 32), (9, 4, 4), (0, 0, 0)],
               8: [(1 + i, (5 * i) % 16, 16 * i + (5 * i) % 16)
                   for i in range(6)] + [(0, 0, 0), (0, 0, 0)]}
    kw = dict(n_q=512, head_dim=64, rope_theta=10000.0, kv_bits=8,
              act_bits=4, packed=True)
    for m, targets in layouts.items():
        args, pools, ids = prologue_operands(m, gen, dev, targets)
        got_pools = [t.clone() for t in pools]
        want_pools = [t.clone() for t in pools]
        q = L.decode_qkv_prologue(*args, *got_pools, *ids, **kw)[0]
        q_want = L.decode_qkv_prologue_plain(*args, *want_pools, *ids,
                                             **kw)[0]
        torch.cuda.synchronize()
        real = [(p, r) for p, r, _ in targets if p != 0]
        sel = (torch.tensor([p for p, _ in real], device=dev).long(),
               torch.tensor([r for _, r in real], device=dev).long())
        codes_got = torch.cat([got_pools[i][sel].flatten() for i in (0, 2)])
        codes_want = torch.cat([want_pools[i][sel].flatten()
                                for i in (0, 2)])
        dcode = (codes_got.int() - codes_want.int()).abs()
        code_frac = (dcode > 0).float().mean().item()
        scale_err = max(((got_pools[i][sel] - want_pools[i][sel]).abs()
                         / want_pools[i][sel].abs()).max().item()
                        for i in (1, 3))
        # rtol 1e-5 of each row's scale: f32 dot association moves the
        # act scale by ulps, and RoPE's differences cancel near zero
        row_scale = q_want.abs().amax(dim=1, keepdim=True)
        rows_off = int(((q - q_want).abs() > 1e-5 * row_scale)
                       .any(dim=1).sum().item())
        _, sx, _ = F.transform_quant_plain(*args[:5], 4)
        step_tol = 2 * sx.max().item() * args[6].max().item() * 8
        q_err = (q - q_want).abs().max().item()
        # untouched: every page but 0 outside the targeted rows
        mask = torch.ones(pools[0].shape[:2], dtype=torch.bool, device=dev)
        mask[0] = False
        mask[sel] = False
        untouched = all(torch.equal(g[mask], o[mask])
                        for g, o in zip(got_pools, pools))
        exact = rows_off == 0 and code_frac == 0 and scale_err <= 1e-5
        code_moved = (dcode.max().item() <= 1 and code_frac <= 1e-3
                      and q_err <= step_tol)
        ok = untouched and (exact or code_moved)
        f32_args = (args[0].float(), *args[1:])
        f32_got = [t.clone() for t in pools]
        f32_want = [t.clone() for t in pools]
        q32 = L.decode_qkv_prologue(*f32_args, *f32_got, *ids, **kw)[0]
        q32_want = L.decode_qkv_prologue_plain(*f32_args, *f32_want, *ids,
                                               **kw)[0]
        # page 0 takes the padded rows' writes in no fixed order
        f32_diff = int((q32 != q32_want).sum().item()) + sum(
            int((g[1:] != w[1:]).sum().item())
            for g, w in zip(f32_got, f32_want))
        targets_t = [t.clone() for t in pools]
        call = lambda: L.decode_qkv_prologue(  # noqa: E731
            *args, *targets_t, *ids, **kw)
        ms, per_call = device_ms(call), call_ms(call)
        plain_ms = device_ms(lambda: L.decode_qkv_prologue_plain(
            *args, *targets_t, *ids, **kw))
        d, n, bk, hd = 512, PROLOGUE_N, CAT_BLOCK, 64
        a, b = args[2].shape[0], args[3].shape[0]
        nbytes = (m * d * 2 + d * bk * 4 + (a * a + b * b) * 4 + d * 4
                  + (d // 2) * n + n * 4 + hd // 2 * 4 + 3 * m * 4
                  + m * 512 * 4 + m * 2 * 4 * (hd + 4))
        f32_flops = (m * (2 * d * bk + 2 * d * (a + b) + 6 * d)
                     + m * n * 4 + m * 768 * 6 + m * 512 * 3)
        b_ms, b_by = bound(nbytes, f32_flops / F32_FLOP_S
                           + 2 * m * d * n / INT8_OP_S)
        plan = L.prologue_plan(m, d, n, hd, a, b, bk, True)
        lib = build.load("decode_layer", L._SIGNATURES)
        one_call = one_launch(call, "decode_qkv_prologue_kernel")
        if not one_call["ok"]:
            fail(f"decode_qkv_prologue m={m} is not one launch: "
                 f"{json.dumps(one_call)}")
        rec = {"kernel": "decode_qkv_prologue", "m": m, "d": d, "n": n,
               "plan": dataclasses.asdict(plan),
               "resident_clusters": lib.decode_qkv_prologue_capacity(
                   plan.cluster, plan.smem), "one_call": one_call,
               "max_err": q_err, "tol": "f32: bitwise; bf16: q within 1e-5 "
               "of its row's max |q|, KV codes bitwise, scales rtol 1e-5; "
               "where an act code moved: codes |d|<=1 on <=0.1%, q within "
               "two code steps",
               "f32_differing": f32_diff,
               "bf16_q_bitwise_share": (q == q_want).float().mean().item(),
               "q_rows_off": rows_off, "code_diff_frac": code_frac,
               "scale_max_rel_err": scale_err, "two_step_tol": step_tol,
               "untouched": untouched, "kernel_ms": ms, "call_ms": per_call,
               "plain_ms": plain_ms, "library_ms": None, "bound_ms": b_ms,
               "bound_by": b_by, "card": card}
        print(json.dumps(rec))
        if not ok or f32_diff:
            fail(f"decode_qkv_prologue m={m}: {json.dumps(rec)}")
        out.append(rec)
    return out


# the dense family's configs whose serving linears rows 1, 2 and 5 take
FAMILY_ARCHS = ("mistral_nemo_12b", "granite_34b", "gemma2_2b",
                "gemma3_12b", "paligemma_3b", "granite_moe_1b_a400m",
                "moonshot_v1_16b_a3b")
# the configs whose linears and QKV are timed for rows 1, 2 and 5
TIMED_ARCHS = ("mistral_nemo_12b", "granite_moe_1b_a400m",
               "moonshot_v1_16b_a3b")
FAMILY_TILED_ROWS = (128, 37)   # a unified step's rows, and ragged ones


def family_linears(arch) -> list:
    """(name, D, N) of the serving linears of ``arch`` at full width that
    rows 1 and 2 serve: the concatenated wqkv, wo, wgu (wu where the MLP
    is ungated), wd; of an moe config wqkv and wo (its experts are
    batched GEMMs on dequantized weights, as in the reference)."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    attn = [("wqkv", cfg.d_model, cfg.q_dim + 2 * cfg.kv_dim),
            ("wo", cfg.q_dim, cfg.d_model)]
    if cfg.n_experts:
        return attn
    up = (("wgu", cfg.d_model, 2 * cfg.d_ff) if cfg.gated_mlp
          else ("wu", cfg.d_model, cfg.d_ff))
    return attn + [up, ("wd", cfg.d_ff, cfg.d_model)]


def wide_operands(m, d, n, dev, seed, packed):
    """Fused-linear operands drawn on the card (the widths reach 24576 x
    32768): f32 rows, CAT blocks of 32, the Hadamard factors of D, a
    sign, int4-packed or int8 codes and their scales."""
    import torch

    from repro_torch.core.hadamard import hadamard_factors
    from repro_torch.core.quantizers import pack_int4
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((m, d), generator=gen, device=dev)
    blocks = (torch.randn((d // CAT_BLOCK, CAT_BLOCK, CAT_BLOCK),
                          generator=gen, device=dev) * 0.2
              + torch.eye(CAT_BLOCK, device=dev))
    ha, hb = (torch.tensor(h, dtype=torch.float32, device=dev)
              for h in hadamard_factors(d))
    sign = torch.randint(0, 2, (d,), generator=gen, device=dev).float() * 2 - 1
    lo, hi = (-8, 8) if packed else (-128, 128)
    qw = torch.randint(lo, hi, (d, n), generator=gen, device=dev,
                       dtype=torch.int8)
    if packed:
        qw = pack_int4(qw, axis=0)
    sw = torch.rand((1, n), generator=gen, device=dev) * 0.02 + 0.001
    return [x, blocks, ha, hb, sign, qw, sw]


def linear_bound(m, d, n, a, b, packed, out_bytes=None):
    """(bound_ms, bound_by) of one fused-linear call on bf16 rows: x, the
    CAT blocks, both Hadamard factors, the signs, the weight codes and
    scales read once, and ``out_bytes`` written (default: the (m, n)
    output in x's dtype)."""
    if out_bytes is None:
        out_bytes = m * n * 2
    nbytes = (m * d * 2 + d * CAT_BLOCK * 4 + (a * a + b * b) * 4 + d * 4
              + (((d + 1) // 2) if packed else d) * n + n * 4 + out_bytes)
    f32_flops = m * (2 * d * CAT_BLOCK + 2 * d * (a + b) + 6 * d)
    return bound(nbytes, f32_flops / F32_FLOP_S + 2 * m * d * n / INT8_OP_S)


def prologue_bound(m, d, cfg, a, b, packed):
    """(bound_ms, bound_by) of one decode-prologue call on bf16 rows:
    ``linear_bound``'s reads at the QKV width plus the rows' positions,
    pages and slots, and its writes: q in f32 and each row's K and V
    codes (int8) and per-head f32 scales."""
    n = cfg.q_dim + 2 * cfg.kv_dim
    out = m * (cfg.q_dim * 4 + 2 * cfg.kv_dim + 2 * cfg.n_kv_heads * 4
               + 3 * 4)
    return linear_bound(m, d, n, a, b, packed, out_bytes=out)


def check_family_widths(card, dev, archs=FAMILY_ARCHS,
                        gemv_rows=tuple(range(1, 9)),
                        tiled_rows=FAMILY_TILED_ROWS, timed=True):
    """Rows 1, 2 and 5 at every serving linear of the dense family's
    configs (``family_linears``): the decode linear at every M in
    ``gemv_rows`` and the tiled one at ``tiled_rows``, int4-packed and
    int8, and the prologue at the configs' QKV (their heads and
    head_dim) at every B in 1..8, each bitwise against its plain version
    on f32 inputs, with its plan (``path`` 1: the streamed path) and,
    packed, one kernel per call (the tiled linear: its two, and the fill
    of the contraction's split scratch). The plain versions compute each
    row alone (in-order fma chains, a per-row quant, an exact integer
    product), so one plain call over the largest M gives every smaller
    M's rows. With ``timed``, the linears of ``TIMED_ARCHS`` (mistral-
    nemo-12b's four, the moe configs' wqkv and wo) are timed for rows 1
    and 2 (M 8 and 128, bf16 rows) and their QKV for row 5 (B 8), beside
    their plain versions and bounds. -> {kernel: records}."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import fused_cat_matmul as F
    from repro_torch.kernels import quant_matmul as QM
    out = {"fused_cat_gemv_w4": [], "fused_cat_matmul_w4": [],
           "decode_qkv_prologue": []}
    sms = build.sm_count(0)
    seen = set()
    seed = 0
    rows_max = max(tiled_rows)
    for arch in archs:
        for lin, d, n in family_linears(arch):
            for packed in (True, False):
                if (d, n, packed) in seen:
                    continue
                seen.add((d, n, packed))
                seed += 1
                args = wide_operands(rows_max, d, n, dev, seed, packed)
                a, b = args[2].shape[0], args[3].shape[0]
                want_all = F.fused_cat_linear_plain(*args, act_bits=4,
                                                    packed=packed)
                base = {"arch": arch, "linear": lin, "d": d, "n": n,
                        "packed": packed, "card": card}
                for m in (*gemv_rows, *tiled_rows):
                    name = ("fused_cat_gemv_w4" if m <= 8
                            else "fused_cat_matmul_w4")
                    run = getattr(F, name)
                    sub = (args[0][:m], *args[1:])
                    got = run(*sub, act_bits=4, packed=packed)
                    want = want_all[:m]
                    plan = (F.gemv_plan(m, d, n, a, b, CAT_BLOCK, packed,
                                        sms) if m <= 8 else
                            F.tiled_plan(m, d, a, b, CAT_BLOCK))
                    rec = dict(base, kernel=name, m=m,
                               plan=dataclasses.asdict(plan),
                               max_err=(got - want).abs().max().item(),
                               differing=int((got != want).sum().item()))
                    if packed and m in (max(gemv_rows), rows_max):
                        # the tiled linear: stage 1 and the contraction,
                        # whose K splits add into a zeroed scratch
                        stage1 = ("wide_transform_quant_kernel"
                                  if plan.path else
                                  "cluster_transform_quant_kernel")
                        zeroed = ("FillFunctor",) if QM.w8a8_plan(
                            m, d + d % 2, n, dev)[0] > 1 else ()
                        rec["one_call"] = one_launch(
                            lambda: run(*sub, act_bits=4, packed=packed),
                            ("wide_gemv_kernel" if plan.path else
                             "fused_cat_gemv_kernel") if m <= 8
                            else (stage1, "mma_kernel", *zeroed))
                    if timed and packed and arch in TIMED_ARCHS \
                            and m in (8, 128):
                        xb = (args[0][:m].to(torch.bfloat16), *args[1:])
                        call = lambda: run(  # noqa: E731
                            *xb, act_bits=4, packed=True)
                        rec["kernel_ms"] = device_ms(call)
                        rec["call_ms"] = call_ms(call)
                        rec["plain_ms"] = call_ms(
                            lambda: F.fused_cat_linear_plain(
                                *xb, act_bits=4, packed=True), iters=2,
                            warmup=1)
                        # bf16 rows, as served: check_fused_linear's hold
                        got_b, want_b = call(), F.fused_cat_linear_plain(
                            *xb, act_bits=4, packed=True)
                        _, sx, _ = F.transform_quant_plain(*xb[:5], 4)
                        rec["bf16_max_err"] = (got_b - want_b).abs().max(
                            ).item()
                        rec["bf16_tol"] = (
                            2 * sx.max().item() * xb[6].max().item() * 8
                            + 1e-5 * want_b.abs().max().item())
                        rec["bf16_bitwise_share"] = (
                            got_b == want_b).float().mean().item()
                        if rec["bf16_max_err"] > rec["bf16_tol"]:
                            fail(f"{name} on bf16 rows at a family width: "
                                 f"{json.dumps(rec)}")
                        rec["bound_ms"], rec["bound_by"] = linear_bound(
                            m, d, n, a, b, True)
                        rec["library_ms"] = None
                    print(json.dumps(rec))
                    out[name].append(rec)
                    if rec["differing"] or not rec.get(
                            "one_call", {"ok": True})["ok"]:
                        fail(f"{name} at a family width: {json.dumps(rec)}")
                del args, want_all
        cfg = get_config(arch)
        for packed in (True, False):
            out["decode_qkv_prologue"] += family_prologue(
                cfg, packed, card, dev, seed, timed and packed
                and arch in TIMED_ARCHS)
    print("family widths: " + json.dumps(
        {k: len(v) for k, v in out.items()}))
    return out


def family_prologue(cfg, packed, card, dev, seed, timed):
    """Row 5 at ``cfg``'s QKV (its heads and head_dim) at every B in 1..8,
    each row on its own page of a 16-row pool: q and every pool but page
    0 bitwise against the plain version on f32 rows (one plain call over
    8 rows: its first B rows' q and targets are B rows' own), its plan,
    one kernel per call (packed, B 8); with ``timed`` the B 8 call timed
    on bf16 rows beside the plain version and the bound."""
    import torch

    from repro_torch.kernels import decode_layer as L
    d, hd, kvh = cfg.d_model, cfg.head_dim, cfg.n_kv_heads
    n = cfg.q_dim + 2 * cfg.kv_dim
    kw = dict(n_q=cfg.q_dim, head_dim=hd, rope_theta=float(cfg.rope_theta),
              kv_bits=8, act_bits=4, packed=packed)
    args = wide_operands(8, d, n, dev, 1000 + seed, packed)
    a, b = args[2].shape[0], args[3].shape[0]
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (12, 16, kvh, hd)
    pools = [torch.randint(-127, 128, shape, generator=gen, device=dev,
                           dtype=torch.int8),
             torch.rand(shape[:3] + (1,), generator=gen, device=dev),
             torch.randint(-127, 128, shape, generator=gen, device=dev,
                           dtype=torch.int8),
             torch.rand(shape[:3] + (1,), generator=gen, device=dev)]
    pages = [1 + i for i in range(8)]
    rows = [(5 * i) % 16 for i in range(8)]
    ids = [torch.tensor(v, dtype=torch.int32, device=dev)
           for v in (pages, rows, [1000 * i + 37 for i in range(8)])]
    want8 = [t.clone() for t in pools]
    q8 = L.decode_qkv_prologue_plain(*args, *want8, *ids, **kw)[0]
    recs = []
    for m in range(1, 9):
        sub = (args[0][:m], *args[1:])
        sub_ids = [t[:m] for t in ids]
        got = [t.clone() for t in pools]
        want = [t.clone() for t in pools]
        for w, w8 in zip(want, want8):
            w[pages[:m], rows[:m]] = w8[pages[:m], rows[:m]]
        q = L.decode_qkv_prologue(*sub, *got, *sub_ids, **kw)[0]
        diff = int((q != q8[:m]).sum().item()) + sum(
            int((g_[1:] != w_[1:]).sum().item()) for g_, w_ in zip(got,
                                                                 want))
        plan = L.prologue_plan(m, d, n, hd, a, b, CAT_BLOCK, packed)
        rec = {"kernel": "decode_qkv_prologue", "arch": cfg.name, "m": m,
               "d": d, "n": n, "head_dim": hd, "packed": packed,
               "plan": dataclasses.asdict(plan),
               "max_err": (q - q8[:m]).abs().max().item(),
               "differing": diff, "card": card}
        if m == 8 and packed:
            call = lambda: L.decode_qkv_prologue(  # noqa: E731
                *sub, *got, *sub_ids, **kw)
            rec["one_call"] = one_launch(
                call, "wide_prologue_kernel" if plan.path
                else "decode_qkv_prologue_kernel")
        if m == 8 and timed:
            xb = (sub[0].to(torch.bfloat16), *sub[1:])
            bcall = lambda: L.decode_qkv_prologue(  # noqa: E731
                *xb, *got, *sub_ids, **kw)
            rec["kernel_ms"] = device_ms(bcall)
            rec["call_ms"] = call_ms(bcall)
            rec["plain_ms"] = call_ms(
                lambda: L.decode_qkv_prologue_plain(*xb, *want, *sub_ids,
                                                    **kw),
                iters=2, warmup=1)
            rec["bound_ms"], rec["bound_by"] = prologue_bound(m, d, cfg, a,
                                                              b, True)
            rec["library_ms"] = None
        print(json.dumps(rec))
        recs.append(rec)
        if diff or not rec.get("one_call", {"ok": True})["ok"]:
            fail(f"decode_qkv_prologue at a family width: "
                 f"{json.dumps(rec)}")
    return recs


GEMV_EDGES = [(512, 1024), (1536, 512), (512, 520), (1536, 1000), (512, 40),
              (128, 256), (128, 512), (256, 128), (384, 1000), (768, 520)]
SWEEP_COLS = (4, 8, 16, 32, 64, 128)


def cols_sweep(args) -> dict:
    """Device ms of the one-launch decode linear on ``args`` with each
    forced number of output columns per CTA (``SWEEP_COLS``; fewer
    columns, more clusters, each repeating the transform), bitwise to the
    plan's own choice; the plan's choice under key "plan"."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels import fused_cat_matmul as F
    m, d = args[0].shape
    n = args[5].shape[1]
    plan = F.gemv_plan(m, d, n, args[2].shape[0], args[3].shape[0],
                       CAT_BLOCK, True, build.sm_count(0))
    want = F._launch_gemv(*args, 4, True)
    out = {"plan": plan.cols}
    for cols in SWEEP_COLS:
        got = F._launch_gemv(*args, 4, True, cols=cols)
        if not torch.equal(got, want):
            fail(f"fused_cat_gemv_w4 with {cols} columns per CTA differs "
                 f"from the plan's {plan.cols} at m={m} d={d} n={n}")
        out[cols] = device_ms(lambda c=cols: F._launch_gemv(
            *args, 4, True, cols=c))
    return out


SWEEP_ROWS = (1, 2, 4, 8)
TILED_EDGE_ROWS = (9, 15, 17, 100, 129, 255)
TILED_EDGE_WIDTHS = ((128, 256), (256, 128), (384, 1000), (768, 520),
                     (512, 520), (1536, 512))


def rows_sweep(args) -> dict:
    """Device ms of the tiled fused linear on ``args`` with each forced
    number of rows per cluster of its transform-quant stage
    (``SWEEP_ROWS``: fewer rows, more clusters, each staging the factors
    anew), bitwise to the plan's own choice; the plan's under "plan"."""
    import torch

    from repro_torch.kernels import fused_cat_matmul as F
    m, d = args[0].shape
    want = F._launch_tiled(*args, 4, True)
    out = {"plan": F.tiled_plan(m, d, args[2].shape[0], args[3].shape[0],
                                CAT_BLOCK).rows}
    for rows in SWEEP_ROWS:
        got = F._launch_tiled(*args, 4, True, rows=rows)
        if not torch.equal(got, want):
            fail(f"fused_cat_matmul_w4 with {rows} rows per cluster differs "
                 f"from the plan's at m={m} d={d}")
        out[rows] = device_ms(lambda r=rows: F._launch_tiled(
            *args, 4, True, rows=r))
    return out


def check_tiled_edges(gen, dev):
    """The tiled fused linear (row 2) bitwise against its plain version on
    f32 inputs at ragged row counts (``TILED_EDGE_ROWS``: a partial last
    row group, more groups than the timed shapes) and the repo's other
    widths (the smoke config's D 128 = 16 x 8 and 256, D 384 and 768 with a
    factor of 24, ragged N), with int4-packed and int8 weights, and the
    bare Hadamard (no blocks, no sign) at D 128 and 1536. Each case
    records its stage-1 plan."""
    import torch

    from repro_torch.kernels import fused_cat_matmul as F
    recs = []

    def held(args, packed, rec):
        got = F.fused_cat_matmul_w4(*args, act_bits=4, packed=packed)
        want = F.fused_cat_linear_plain(*args, act_bits=4, packed=packed)
        m, d = args[0].shape
        plan = F.tiled_plan(m, d, args[2].shape[0], args[3].shape[0],
                            0 if args[1] is None else CAT_BLOCK)
        rec.update({"kernel": "fused_cat_matmul_w4", "m": m, "d": d,
                    "n": args[5].shape[1], "packed": packed,
                    "plan": dataclasses.asdict(plan),
                    "max_err": (got - want).abs().max().item(),
                    "differing": int((got != want).sum().item())})
        recs.append(rec)
        if rec["differing"]:
            fail(f"fused_cat_matmul_w4 edge not bitwise: {json.dumps(rec)}")

    for d, n in TILED_EDGE_WIDTHS:
        for m in TILED_EDGE_ROWS:
            args = fused_linear_operands(m, d, n, gen, dev)
            args[0] = args[0].float()
            held(args, True, {})
            w8 = torch.randint(-128, 128, (d, n), generator=gen,
                               dtype=torch.int8).to(dev)
            held((*args[:5], w8, args[6]), False, {})
    for d in (128, 1536):
        for m in (9, 129):
            args = fused_linear_operands(m, d, 512, gen, dev)
            args[0] = args[0].float()
            args[1] = args[4] = None
            held(args, True, {"transform": "bare Hadamard, no sign"})
    print("fused_cat_matmul_w4 edges " + json.dumps(recs))
    return recs


def one_launch(fn, kernel, calls: int = 5) -> dict:
    """Whether one call of ``fn`` is one launch of the kernel whose name
    contains ``kernel`` (a tuple of names: one launch of each, nothing
    else): the nodes of a CUDA graph that captures one call (torch's debug
    dump, ``cudaGraphDebugDotPrint``), by node type, and the device events
    that ``torch.profiler`` records over ``calls`` calls (the profiler may
    drop events of short kernels, so only their names are held: all of
    them these kernels'). -> a record with ``ok``."""
    import os
    import re
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)   # keeps the cudaGraph_t
    with torch.cuda.graph(graph):
        fn()
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "call.dot")
        graph.debug_dump(path)
        dot = open(path).read()
    del graph
    kinds: dict = {}
    for line in dot.splitlines():
        found = re.search(r'label="\{?\s*([A-Za-z_]+)', line)
        if found and "node" in line:
            kinds[found.group(1)] = kinds.get(found.group(1), 0) + 1
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    names = sorted({e.name for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA})
    # the graph holds one kernel node per kernel, these kernels'; the
    # profiler, which may drop every event of a short kernel, saw no other
    kernels = (kernel,) if isinstance(kernel, str) else tuple(kernel)
    ok = (kinds == {"KERNEL": len(kernels)}
          and all(k in dot for k in kernels)
          and all(any(k in n for k in kernels) for n in names))
    return {"ok": ok, "graph_nodes": kinds, "profiled_device_kernels": names,
            "dot_head": None if kinds else dot[:400]}


def check_gemv_edges(gen, dev):
    """The one-launch decode linear (row 1) bitwise against its plain
    version on f32 inputs at every M in 1..8, at the serving shapes wqkv
    (D 512, N 1024) and wd (D 1536, N 512), at N not a multiple of the
    cluster's column tile (520, 1000, 40), at the smoke config's linears
    (D 128 = 16 x 8 at N 256 and 512, D 256 at N 128) and at D 384 = 16 x
    24 and 768 = 32 x 24, with int4-packed and int8 weights; and for the
    bare Hadamard transform (no blocks, no sign) at D 128, 512 and 1536.
    Each case records its cluster plan."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels import fused_cat_matmul as F
    recs = []

    def held(args, packed, rec):
        got = F.fused_cat_gemv_w4(*args, act_bits=4, packed=packed)
        want = F.fused_cat_linear_plain(*args, act_bits=4, packed=packed)
        m, d = args[0].shape
        n = args[5].shape[1]
        plan = F.gemv_plan(m, d, n, args[2].shape[0], args[3].shape[0],
                           0 if args[1] is None else CAT_BLOCK, packed,
                           build.sm_count(0))
        rec.update({"kernel": "fused_cat_gemv_w4", "m": m, "d": d, "n": n,
                    "packed": packed, "cluster": plan.cluster,
                    "clusters": plan.clusters, "cols": plan.cols,
                    "max_err": (got - want).abs().max().item(),
                    "differing": int((got != want).sum().item())})
        recs.append(rec)
        if rec["differing"]:
            fail(f"fused_cat_gemv_w4 edge not bitwise: {json.dumps(rec)}")

    for d, n in GEMV_EDGES:
        for m in range(1, 9):
            args = fused_linear_operands(m, d, n, gen, dev)
            args[0] = args[0].float()
            held(args, True, {})
            w8 = torch.randint(-128, 128, (d, n), generator=gen,
                               dtype=torch.int8).to(dev)
            held((*args[:5], w8, args[6]), False, {})
    for d in (128, 512, 1536):
        for m in (1, 8):
            args = fused_linear_operands(m, d, 1024, gen, dev)
            args[0] = args[0].float()
            args[1] = args[4] = None
            held(args, True, {"transform": "bare Hadamard, no sign"})
    print("fused_cat_gemv_w4 edges " + json.dumps(recs))
    return recs


def check_prologue_edges(gen, dev):
    """The decode prologue (row 5) bitwise on f32 inputs (q, and every
    page but 0, which takes the padded rows' writes in no fixed order) at
    every B in 1..8 over the page layouts of ``check_prologue`` (B 1 and
    4 as there; others the first B targets of B 8's, whose last two are
    padded rows), with int4-packed weights, int8 weights and the bare
    Hadamard transform (no blocks, no sign), at full width and at the
    smoke config's (D 128 = 16 x 8, 4 q + 2 k + 2 v heads of 32)."""
    layout8 = [(1 + i, (5 * i) % 16, 16 * i + (5 * i) % 16)
               for i in range(6)] + [(0, 0, 0), (0, 0, 0)]
    layouts = {1: [(5, 15, 15)],
               4: [(3, 15, 31), (7, 0, 32), (9, 4, 4), (0, 0, 0)]}
    widths = {"full": dict(d=512, n_q=512, kvh=4, hd=64),
              "smoke": dict(d=128, n_q=128, kvh=2, hd=32)}
    recs = []
    for width, shape in widths.items():
        for m in range(1, 9):
            targets = layouts.get(m, layout8[:m])
            for variant in ("packed", "int8", "bare Hadamard"):
                recs.append(prologue_edge(m, targets, variant, width, shape,
                                          gen, dev))
    print("decode_qkv_prologue edges " + json.dumps(recs))
    return recs


def prologue_edge(m, targets, variant, width, shape, gen, dev):
    """One case of ``check_prologue_edges``."""
    import torch

    from repro_torch.kernels import decode_layer as L
    d, hd = shape["d"], shape["hd"]
    n = shape["n_q"] + 2 * shape["kvh"] * hd
    kw = dict(n_q=shape["n_q"], head_dim=hd, rope_theta=10000.0, kv_bits=8,
              act_bits=4)
    args, pools, ids = prologue_operands(m, gen, dev, targets, **shape)
    args[0] = args[0].float()
    packed = variant != "int8"
    if not packed:
        args[5] = torch.randint(-128, 128, (d, n), generator=gen,
                                dtype=torch.int8).to(dev)
    if variant == "bare Hadamard":
        args[1] = args[4] = None
    got = [t.clone() for t in pools]
    want = [t.clone() for t in pools]
    q = L.decode_qkv_prologue(*args, *got, *ids, packed=packed, **kw)[0]
    q_want = L.decode_qkv_prologue_plain(*args, *want, *ids, packed=packed,
                                         **kw)[0]
    diff = int((q != q_want).sum().item()) + sum(
        int((g[1:] != w[1:]).sum().item()) for g, w in zip(got, want))
    rec = {"kernel": "decode_qkv_prologue", "m": m, "width": width, "d": d,
           "n": n, "variant": variant, "targets": targets,
           "max_err": (q - q_want).abs().max().item(), "differing": diff}
    if diff:
        fail(f"decode_qkv_prologue edge not bitwise: {json.dumps(rec)}")
    return rec


def bf16_close(got, want):
    """Float outputs in x's dtype: within one bf16 unit of each value
    (2^-7 relative) plus 1e-5 of the output's scale for f32 dot
    association. -> (max abs error, share bitwise, ok)."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    ok = bool((err <= 2 ** -7 * w.abs() + 1e-5 * w.abs().max()).all())
    return err.max().item(), (err == 0).float().mean().item(), ok


def usable(library):
    """``library`` when one call of it runs on this card, else None (the
    yardstick is then reported as missing; the port never calls it)."""
    import torch
    try:
        library()
        torch.cuda.synchronize()
    except RuntimeError as exc:
        print(f"library call unavailable: {exc}".splitlines()[0])
        return None
    return library


def stage_operands(m, d, gen, dev):
    """Activation rows and the CAT stage operands at the path's shapes."""
    import torch

    from repro_torch.core.hadamard import hadamard_factors
    x = torch.randn((m, d), generator=gen).to(torch.bfloat16)
    blocks = (torch.randn((d // CAT_BLOCK, CAT_BLOCK, CAT_BLOCK),
                          generator=gen) * 0.2 + torch.eye(CAT_BLOCK))
    ha, hb = (torch.tensor(h, dtype=torch.float32)
              for h in hadamard_factors(d))
    sign = torch.randint(0, 2, (d,), generator=gen).float() * 2 - 1
    return [t.to(dev) for t in (x, blocks, ha, hb, sign)]


def timed_record(name, shape, run, plain, library, nbytes, op_seconds,
                 card, checks):
    """Times of one kernel call at one shape (device ms by CUDA-graph
    replay, the plain version's, and the library call's where there is
    one) with its bound, merged with the comparison ``checks``."""
    ms, per_call = device_ms(run), call_ms(run)
    plain_ms = device_ms(plain)
    b_ms, b_by = bound(nbytes, op_seconds)
    rec = {"kernel": name, **shape, **checks, "kernel_ms": ms,
           "call_ms": per_call, "plain_ms": plain_ms,
           "library_ms": None if library is None else device_ms(library),
           "bound_ms": b_ms, "bound_by": b_by, "card": card}
    print(json.dumps(rec))
    return rec


def check_block_edges(gen, dev):
    """Block-CAT (row 11) at ragged row counts (1, 7, 300: a partial row
    tile, and more tiles than the timed shapes) and D 512 and 1536, in f32
    (bitwise against the plain version: each output is one fmaf chain over
    the block's row from 0, as cuBLAS's f32 product of depth 32 is) and
    bf16 (one bf16 unit plus 1e-5 of the scale)."""
    from repro_torch.kernels import block_matmul as B
    recs = []
    for d in (512, 1536):
        for m in (1, 7, 300):
            x, blocks = stage_operands(m, d, gen, dev)[:2]
            for xt in (x, x.float()):
                got = B.block_diag_matmul(xt, blocks)
                want = B.block_diag_matmul_plain(xt, blocks)
                err, same, ok = bf16_close(got, want)
                if xt.dtype != x.dtype:
                    ok = same == 1.0
                rec = {"kernel": "block_diag_matmul", "m": m, "d": d,
                       "dtype": str(xt.dtype), "max_err": err,
                       "bitwise_share": same}
                recs.append(rec)
                if not ok:
                    fail(f"block_diag_matmul edge: {json.dumps(rec)}")
    print("block_diag_matmul edges " + json.dumps(recs))
    return recs


def check_hadamard_edges(gen, dev):
    """Sign ⊙ Hadamard (row 10) at D 512 and 1536 and M 1, 7, 8, 128 and
    300 (a partial row tile, and more tiles than the timed shapes), in f32
    (bitwise against the plain version, whose emulated fma chains follow
    the kernel's order: over j, then over i, from 0) and bf16 (one bf16
    unit plus 1e-5 of the scale; the bitwise share recorded), with the
    CUDA source's rows per CTA; each forced choice of 1, 2, 4 or 8 rows
    must give the same output bitwise."""
    import torch

    from repro_torch.kernels import hadamard as H
    recs = []
    for d in (512, 1536):
        for m in (1, 7, 8, 128, 300):
            x, _, ha, hb, sign = stage_operands(m, d, gen, dev)
            for xt in (x, x.float()):
                got = H.hadamard_transform(xt, ha, hb, sign)
                err, same, ok = bf16_close(
                    got, H.hadamard_transform_plain(xt, ha, hb, sign))
                if xt.dtype != x.dtype:
                    ok = same == 1.0
                forced = all(torch.equal(H.hadamard_transform(
                    xt, ha, hb, sign, rows=r), got) for r in (1, 2, 4, 8))
                rec = {"kernel": "hadamard_transform", "m": m, "d": d,
                       "dtype": str(xt.dtype), "max_err": err,
                       "bitwise_share": same, "forced_rows_equal": forced}
                recs.append(rec)
                if not (ok and forced):
                    fail(f"hadamard_transform edge: {json.dumps(rec)}")
    print("hadamard_transform edges " + json.dumps(recs))
    return recs


def check_stages(card, gen, dev):
    """Block-CAT, sign ⊙ Hadamard and dynamic quant (rows 11, 10, 9) at
    the composed path's shapes (8 and 128 rows, D 512 and 1536, bf16)
    against their plain versions. Tolerances: block-CAT and Hadamard
    outputs within one bf16 unit plus 1e-5 of the scale, and bitwise on
    f32 inputs (also at the edges of ``check_block_edges`` and
    ``check_hadamard_edges``); dynamic quant codes, scales and zero points
    bitwise. The Hadamard is also timed with each forced row tile (1, 2,
    4, 8 rows per CTA). Library calls: ``torch.bmm`` on the blocked f32
    view for block-CAT (the view and the cast made outside the timed
    call), one ``torch.matmul`` against the materialised diag(sign)·(ha ⊗
    hb)ᵀ for the Hadamard; none for the quant."""
    import torch

    from repro_torch.kernels import block_matmul as B
    from repro_torch.kernels import dynamic_quant as DQ
    from repro_torch.kernels import hadamard as H
    out = {"block_diag_matmul": [], "hadamard_transform": [],
           "dynamic_quant": []}
    edges = check_block_edges(gen, dev)
    had_edges = check_hadamard_edges(gen, dev)
    for d in (512, 1536):
        for m in COMPOSED_ROWS:
            x, blocks, ha, hb, sign = stage_operands(m, d, gen, dev)
            shape = {"m": m, "d": d}
            a, b = ha.shape[0], hb.shape[0]
            # block-CAT
            err, same, ok = bf16_close(B.block_diag_matmul(x, blocks),
                                       B.block_diag_matmul_plain(x, blocks))
            xf = x.float()
            f32_same = (B.block_diag_matmul(xf, blocks)
                        == B.block_diag_matmul_plain(xf, blocks)
                        ).float().mean().item()
            xb = xf.reshape(m, d // CAT_BLOCK, CAT_BLOCK
                            ).transpose(0, 1).contiguous()
            bt = blocks.transpose(1, 2).contiguous()
            out["block_diag_matmul"].append(timed_record(
                "block_diag_matmul", shape,
                lambda: B.block_diag_matmul(x, blocks),
                lambda: B.block_diag_matmul_plain(x, blocks),
                lambda: torch.bmm(xb, bt),
                4 * m * d + 4 * d * CAT_BLOCK,
                2 * m * d * CAT_BLOCK / F32_FLOP_S, card,
                {"max_err": err, "bitwise_share": same,
                 "f32_bitwise_share": f32_same,
                 "tol": "one bf16 unit + 1e-5 of scale; f32 bitwise",
                 "library": "torch.bmm on the blocked f32 view"}))
            if not ok or f32_same != 1.0:
                fail(f"block_diag_matmul m={m} d={d}: max error {err}, "
                     f"f32 bitwise share {f32_same}")
            # sign ⊙ Hadamard, with the times of each forced row tile
            err, same, ok = bf16_close(
                H.hadamard_transform(x, ha, hb, sign),
                H.hadamard_transform_plain(x, ha, hb, sign))
            f32_same = (H.hadamard_transform(xf, ha, hb, sign)
                        == H.hadamard_transform_plain(xf, ha, hb, sign)
                        ).float().mean().item()
            dense = (sign[:, None] * torch.kron(ha, hb).T).contiguous()
            sweep = {r: device_ms(lambda r=r: H.hadamard_transform(
                x, ha, hb, sign, rows=r)) for r in (1, 2, 4, 8)}
            out["hadamard_transform"].append(timed_record(
                "hadamard_transform", shape,
                lambda: H.hadamard_transform(x, ha, hb, sign),
                lambda: H.hadamard_transform_plain(x, ha, hb, sign),
                lambda: torch.matmul(xf, dense),
                4 * m * d + 4 * (a * a + b * b + d),
                2 * m * d * (a + b) / F32_FLOP_S, card,
                {"max_err": err, "bitwise_share": same,
                 "f32_bitwise_share": f32_same, "rows_sweep_ms": sweep,
                 "tol": "one bf16 unit + 1e-5 of scale; f32 bitwise",
                 "library": "torch.matmul against diag(sign)(ha kron hb)^T"
                 " on an f32 copy of x"}))
            if not ok or f32_same != 1.0:
                fail(f"hadamard_transform m={m} d={d}: max error {err}, "
                     f"f32 bitwise share {f32_same}")
            # dynamic quant (the Hadamard output, as on the path), beside
            # its floor: an empty kernel and a copy of its bytes at its
            # grid, and its time at each forced number of rows per CTA
            y = H.hadamard_transform(x, ha, hb, sign)
            got = DQ.dynamic_quant(y, 4)
            want = DQ.dynamic_quant_plain(y, 4)
            diffs = [int((g != w).sum().item()) for g, w in zip(got, want)]
            floor = {k: device_ms(lambda k=k: dq_floor(y, k))
                     for k in ("empty", "copy")}
            sweep = {r: device_ms(lambda r=r: DQ.dynamic_quant(
                y, 4, rows=r)) for r in (1, 2, 4, 8)}
            out["dynamic_quant"].append(timed_record(
                "dynamic_quant", shape, lambda: DQ.dynamic_quant(y, 4),
                lambda: DQ.dynamic_quant_plain(y, 4), None,
                3 * m * d + 8 * m, 6 * m * d / F32_FLOP_S, card,
                {"max_err": (got[0].int() - want[0].int()).abs().max()
                 .item(), "codes_scales_zps_differing": diffs,
                 "tol": "bitwise", "plan": DQ.plan(m, d, 2)._asdict(),
                 "empty_kernel_ms": floor["empty"],
                 "copy_kernel_ms": floor["copy"], "rows_sweep_ms": sweep,
                 "one_call": one_launch(lambda: DQ.dynamic_quant(y, 4),
                                        "dynamic_quant_kernel"),
                 "library": "none: no one PyTorch call computes a per-row "
                            "asymmetric quant (torch.aminmax gives only "
                            "the range)"}))
            if any(diffs) or not out["dynamic_quant"][-1]["one_call"][
                    "ok"]:
                fail(f"dynamic_quant m={m} d={d}: {diffs} codes/scales/zps "
                     f"differ from the plain version, or not one kernel "
                     f"per call")
    out["block_diag_matmul"] += edges
    out["hadamard_transform"] += had_edges
    out["dynamic_quant"] += check_dq_edges(gen, dev)
    return out


DQ_FLOOR_SIGNATURES = {"dq_floor": [ctypes.c_int, ctypes.c_void_p,
                                     ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_void_p, ctypes.c_void_p]}


def dq_floor(x, kind: str):
    """The floor of ``dynamic_quant`` on a CUDA x (m, d) at the kernel's
    grid (``csrc/dq_floor.cu``, a library of its own that the port never
    loads): ``kind`` "empty" launches an empty kernel, "copy" a kernel
    that moves the quant's bytes (x in; one byte per element and 8 bytes
    per row out) with no arithmetic. -> the copy's outputs (q, scale,
    zp)."""
    import torch

    from repro_torch.kernels import build
    m, d = x.shape
    q = torch.empty((m, d), dtype=torch.int8, device=x.device)
    scale = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    zp = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    lib = build.load("dq_floor", DQ_FLOOR_SIGNATURES)
    build.check(lib.dq_floor(
        {"empty": 0, "copy": 1}[kind], build.ptr(x),
        int(x.dtype == torch.bfloat16), m, d, 0, build.ptr(q),
        build.ptr(scale), build.ptr(zp), build.stream_of(x)), "dq_floor")
    return q, scale, zp


DQ_EDGE_ROWS = (1, 7, 8, 128, 300)
DQ_EDGE_WIDTHS = (24, 63, 512, 1536, 12289)


def check_dq_edges(gen, dev):
    """Dynamic quant (row 9) bitwise against its plain version (codes,
    scales and zero points) at M 1, 7, 8, 128, 300, D 24, 63, 512, 1536
    and 12,289 (the register path's widths and the general path's: odd D
    and a D past the register path, which the old kernel refused), bits
    2, 4 and 8, symmetric and asymmetric, f32 and bf16 inputs, each block
    with constant rows (the 1e-12 clamp: an all-zero row and a row of one
    value), every forced number of rows per CTA at one shape, rows whose
    scale passes 2^100 (their codes take the IEEE division instead of the
    reciprocal's), a row start off a 16-byte boundary (the general path
    at D 512), and one kernel node per call at each width and type."""
    import torch

    from repro_torch.kernels import dynamic_quant as DQ
    recs, bad = [], []

    def held(x, bits, sym, label, rows=0):
        got = DQ.dynamic_quant(x, bits, sym, rows=rows)
        want = DQ.dynamic_quant_plain(x, bits, sym)
        diffs = [int((g != w).sum().item()) for g, w in zip(got, want)]
        if any(diffs):
            bad.append({"case": label, "bits": bits, "symmetric": sym,
                        "rows": rows, "differing": diffs})
        return (got[0].int() - want[0].int()).abs().max().item()

    for d in DQ_EDGE_WIDTHS:
        for dtype in (torch.float32, torch.bfloat16):
            err = 0
            for m in DQ_EDGE_ROWS:
                x = (torch.randn((m, d), generator=gen)
                     * torch.rand((m, 1), generator=gen) * 30).to(dtype)
                x[0] = 0.0
                if m > 2:
                    x[m // 2] = 2.5
                x = x.to(dev)
                for bits in (2, 4, 8):
                    for sym in (False, True):
                        err = max(err, held(x, bits, sym, f"m{m}"))
            one = one_launch(lambda: DQ.dynamic_quant(x, 4),
                             "dynamic_quant")
            if not one["ok"]:
                bad.append({"case": "one kernel per call", "d": d,
                            "one_call": one})
            recs.append({"kernel": "dynamic_quant", "edge": "widths",
                         "d": d, "dtype": str(dtype), "m": DQ_EDGE_ROWS,
                         "plan": DQ.plan(max(DQ_EDGE_ROWS), d,
                                         x.element_size())._asdict(),
                         "max_err": err, "one_call": one["ok"]})
    x = torch.randn((128, 512), generator=gen).to(torch.bfloat16).to(dev)
    recs.append({"kernel": "dynamic_quant", "edge": "forced rows 1..8",
                 "max_err": max(held(x, 4, False, "forced rows", rows)
                                for rows in range(1, 9))})
    # rows whose scale passes 2^100: their codes take the IEEE division
    x = (torch.randn((8, 512), generator=gen) * 1e35).to(dev)
    recs.append({"kernel": "dynamic_quant", "edge": "scale past 2^100",
                 "max_err": max(held(x.to(dt), bits, sym, "scale past 2^100")
                                for dt in (torch.float32, torch.bfloat16)
                                for bits in (4, 8) for sym in (False, True))})
    flat = torch.randn((128 * 512 + 1,), generator=gen).to(dev)
    x = flat[1:].view(128, 512)              # 4 bytes off a 16-byte line
    recs.append({"kernel": "dynamic_quant", "edge": "misaligned",
                 "max_err": held(x, 4, False, "misaligned"),
                 "plan": DQ.plan(128, 512, 4, aligned=False)._asdict()})
    print("dynamic_quant edges " + json.dumps(recs))
    if bad:
        fail(f"dynamic_quant edges not bitwise: {json.dumps(bad)}")
    return recs


def contraction_operands(m, k, n, gen, dev, packed, act_bits=4):
    """``act_bits`` activation codes (signed, full range) with their
    scales and zero points, and int4 (packed) or int8 weight codes with
    per-channel scales."""
    import torch

    from repro_torch.core.quantizers import pack_int4
    half = 2 ** (act_bits - 1)
    qx = torch.randint(-half, half, (m, k), generator=gen, dtype=torch.int8)
    sx = torch.rand((m, 1), generator=gen) * 0.02 + 0.001
    zx = torch.randint(-half, half, (m, 1), generator=gen).float()
    if packed:
        w = torch.randint(-8, 8, (k, n), generator=gen, dtype=torch.int8)
        qw = pack_int4(w, axis=0)
    else:
        w = torch.randint(-128, 128, (k, n), generator=gen,
                          dtype=torch.int8)
        qw = w
    sw = torch.rand((1, n), generator=gen) * 0.02 + 0.001
    return [t.to(dev) for t in (qx, sx, zx, qw, sw)], w.to(dev)


QMM_EDGES = [(9, 64, 40), (130, 1536, 72), (33, 63, 24),   # (M, K, N)
             (9, 4096, 16)]


def check_w8a8_edges(gen, dev):
    """W8A8 ``quant_matmul`` (row 8) at the CPU tests' ragged shapes, one
    tile over a deep K (64 splits of one 64-deep K tile each) and the
    main-path shapes, with 4-bit and full-range int8 activation codes,
    bitwise against the plain version (exact integer accumulation, split
    K included, and one epilogue in the same op order); every K split
    holds at least one K tile. Also at int8 extremes, where each sum
    passes 2^24."""
    import torch

    from repro_torch.kernels import quant_matmul as QM
    recs = []
    shapes = QMM_EDGES + [(m, k, n) for k, n in LINEAR_SHAPES
                          for m in COMPOSED_ROWS]
    for m, k, n in shapes:
        for act_bits in (4, 8):
            args, _ = contraction_operands(m, k, n, gen, dev, False,
                                           act_bits)
            got, want = QM.quant_matmul(*args), QM.quant_matmul_plain(*args)
            splits = QM.w8a8_plan(m, k, n, dev)[0]
            k_tiles = -(-k // 64)                 # 64-deep K tiles
            per = -(-k_tiles // splits)
            rec = {"kernel": "quant_matmul", "m": m, "d": k, "n": n,
                   "act_bits": act_bits, "splits": splits,
                   "max_err": (got - want).abs().max().item(),
                   "differing": int((got != want).sum().item())}
            recs.append(rec)
            if rec["differing"]:
                fail(f"quant_matmul not bitwise: {json.dumps(rec)}")
            if not (splits - 1) * per < k_tiles <= splits * per:
                fail(f"quant_matmul split of {k_tiles} K tiles into "
                     f"{splits} leaves one empty: {json.dumps(rec)}")
    # int8 extremes: codes -128 but the last three (1) on both sides, so
    # each sum is 1533 * 2^14 + 3, above 2^24 (exact int32 or nothing)
    for m, k, n in ((9, 1536, 40), (130, 1536, 24)):
        qx = torch.full((m, k), -128, dtype=torch.int8)
        qw = torch.full((k, n), -128, dtype=torch.int8)
        qx[:, -3:], qw[-3:] = 1, 1
        sx = torch.rand((m, 1), generator=gen) * 0.02 + 0.001
        zx = torch.randint(-128, 128, (m, 1), generator=gen).float()
        sw = torch.rand((1, n), generator=gen) * 0.02 + 0.001
        args = [t.to(dev) for t in (qx, sx, zx, qw, sw)]
        got, want = QM.quant_matmul(*args), QM.quant_matmul_plain(*args)
        rec = {"kernel": "quant_matmul", "m": m, "d": k, "n": n,
               "codes": "-128 but the last three",
               "splits": QM.w8a8_plan(m, k, n, dev)[0],
               "max_err": (got - want).abs().max().item(),
               "differing": int((got != want).sum().item())}
        recs.append(rec)
        if rec["differing"]:
            fail(f"quant_matmul not bitwise: {json.dumps(rec)}")
    print("quant_matmul edges " + json.dumps(recs))
    return recs


def check_w4_edges(gen, dev):
    """W4A8 ``quant_matmul_w4`` (row 6) at the ragged shapes of
    ``QMM_EDGES`` (odd K included: the missing code reads as 0) and the
    main-path shapes, with 4-bit and full-range int8 activation codes
    against random nibbles, bitwise against the plain version (exact
    integer accumulation on the tensor cores, split K included, one
    epilogue in the same op order); every K split holds at least one K
    tile. Also at nibble extremes: codes -128 against nibbles -8 but the
    last three (1), and codes alternating -128/127 against nibbles 7/-8
    along K."""
    import torch

    from repro_torch.core.quantizers import pack_int4
    from repro_torch.kernels import quant_matmul as QM
    from repro_torch.kernels import quant_matmul_w4 as QW
    recs = []

    def held(args, rec):
        got = QW.quant_matmul_w4(*args)
        want = QW.quant_matmul_w4_plain(*args)
        m, k = args[0].shape
        n = args[3].shape[1]
        splits = QM.w8a8_plan(m, k, n, dev)[0]
        k_tiles = -(-k // 64)                     # 64-deep K tiles
        per = -(-k_tiles // splits)
        rec.update({"kernel": "quant_matmul_w4", "m": m, "d": k, "n": n,
                    "splits": splits,
                    "max_err": (got - want).abs().max().item(),
                    "differing": int((got != want).sum().item())})
        recs.append(rec)
        if rec["differing"]:
            fail(f"quant_matmul_w4 not bitwise: {json.dumps(rec)}")
        if not (splits - 1) * per < k_tiles <= splits * per:
            fail(f"quant_matmul_w4 split of {k_tiles} K tiles into "
                 f"{splits} leaves one empty: {json.dumps(rec)}")

    shapes = QMM_EDGES + [(m, k, n) for k, n in LINEAR_SHAPES
                          for m in COMPOSED_ROWS]
    for m, k, n in shapes:
        for act_bits in (4, 8):
            args, _ = contraction_operands(m, k, n, gen, dev, True,
                                           act_bits)
            held(args, {"act_bits": act_bits})
    for m, k, n, pattern in ((9, 1536, 40, "min"), (130, 1536, 24, "min"),
                             (33, 1535, 24, "alternating"),
                             (130, 1536, 72, "alternating")):
        if pattern == "min":
            qx = torch.full((m, k), -128, dtype=torch.int8)
            w = torch.full((k, n), -8, dtype=torch.int8)
            qx[:, -3:], w[-3:] = 1, 1
        else:
            qx = torch.where(torch.arange(k) % 2 == 1, 127, -128).to(
                torch.int8).expand(m, k).contiguous()
            w = torch.where(torch.arange(k)[:, None] % 2 == 1, -8, 7).to(
                torch.int8).expand(k, n).contiguous()
        sx = torch.rand((m, 1), generator=gen) * 0.02 + 0.001
        zx = torch.randint(-128, 128, (m, 1), generator=gen).float()
        sw = torch.rand((1, n), generator=gen) * 0.02 + 0.001
        args = [t.to(dev) for t in (qx, sx, zx, pack_int4(w, axis=0), sw)]
        held(args, {"codes": pattern})
    print("quant_matmul_w4 edges " + json.dumps(recs))
    return recs


def check_contractions(card, gen, dev):
    """The code contractions (rows 6, 7, 8) at every main-path (D, N):
    ``quant_gemv_w4`` at 8 rows, ``quant_matmul_w4`` at 128, W8A8
    ``quant_matmul`` at both (8 rows: the code GEMV), against their plain
    versions, bitwise (exact integer accumulation, one epilogue in the
    same op order), also at ragged shapes, odd K, several K splits and
    code extremes (``check_w4_edges``, ``check_w8a8_edges``,
    ``check_code_gemv_edges``); the code GEMV at M 8 records its plan and,
    at D 512, N 3072, the device ms of every forced number of columns per
    CTA (``code_gemv_cols_sweep``). Library: ``torch._int_mm`` of the
    codes against the unpacked int8 weight, which covers the integer
    product only (no nibble unpacking, no epilogue); it needs more than 16
    rows."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels import quant_matmul as QM
    from repro_torch.kernels import quant_matmul_w4 as QW
    cases = [("quant_gemv_w4", QW.quant_gemv_w4, QW.quant_matmul_w4_plain,
              True, (8,)),
             ("quant_matmul_w4", QW.quant_matmul_w4,
              QW.quant_matmul_w4_plain, True, (128,)),
             ("quant_matmul", QM.quant_matmul, QM.quant_matmul_plain, False,
              COMPOSED_ROWS)]
    out = {name: [] for name, *_ in cases}
    for name, run, plain, packed, rows in cases:
        for k, n in LINEAR_SHAPES:
            for m in rows:
                args, w = contraction_operands(m, k, n, gen, dev, packed)
                got, want = run(*args), plain(*args)
                err = (got - want).abs().max().item()
                differing = int((got != want).sum().item())
                library = None
                if m > 16:
                    library = usable(lambda a=args[0], b=w:
                                     torch._int_mm(a, b))
                w_bytes = k * n // 2 if packed else k * n
                extra = {"max_err": err, "tol": 0.0, "differing": differing,
                         "library": None if library is None else
                         "torch._int_mm: the integer product only"}
                if m <= 8:
                    extra["plan"] = dataclasses.asdict(QM.gemv_plan(
                        m, k, n, packed, build.sm_count(dev)))
                    extra["one_call"] = one_launch(lambda: run(*args),
                                                   "code_gemv_kernel")
                    if (k, n) == (512, 3072):
                        extra["cols_sweep_ms"] = code_gemv_cols_sweep(
                            args, packed)
                out[name].append(timed_record(
                    name, {"m": m, "d": k, "n": n},
                    lambda: run(*args), lambda: plain(*args), library,
                    m * k + w_bytes + 4 * n + 8 * m + 4 * m * n,
                    2 * m * k * n / INT8_OP_S, card, extra))
                if differing or not extra.get("one_call", {"ok": True})[
                        "ok"]:
                    fail(f"{name} m={m} k={k} n={n}: max error {err}, "
                         f"{differing} outputs differ: {json.dumps(extra)}")
    # rows 7 and 8 at mistral-nemo-12b's wd (K 14336, N 5120), M 8: the
    # streamed code GEMV, timed
    k, n = GEMV_DEEP_K[0]
    for name, run, plain, packed, _ in (cases[0], cases[2]):
        args, _ = contraction_operands(8, k, n, gen, dev, packed)
        got, want = run(*args), plain(*args)
        differing = int((got != want).sum().item())
        w_bytes = k * n // 2 if packed else k * n
        extra = {"max_err": (got - want).abs().max().item(), "tol": 0.0,
                 "differing": differing, "deep_k": True,
                 "plan": dataclasses.asdict(QM.gemv_plan(
                     8, k, n, packed, build.sm_count(dev)))}
        out[name].append(timed_record(
            name, {"m": 8, "d": k, "n": n}, lambda: run(*args),
            lambda: plain(*args), None,
            8 * k + w_bytes + 4 * n + 8 * 8 + 4 * 8 * n,
            2 * 8 * k * n / INT8_OP_S, card, extra))
        if differing:
            fail(f"{name} at a deep K: {json.dumps(extra)}")
        del args, got, want
    w4_gemv, w8_gemv = check_code_gemv_edges(gen, dev)
    out["quant_gemv_w4"] += w4_gemv
    out["quant_matmul_w4"] += check_w4_edges(gen, dev)
    out["quant_matmul"] += check_w8a8_edges(gen, dev) + w8_gemv
    return out


# ---------------------------------------------------------------- serving

def agreement(reqs, a, b) -> float:
    """Mean over requests of the fraction of equal tokens (prompt and
    generated), as the JAX suite computes it."""
    import numpy as np
    return float(np.mean([
        (np.asarray(a[r["rid"]].tokens) == np.asarray(b[r["rid"]].tokens))
        .mean() for r in reqs]))


@contextlib.contextmanager
def reference_routes():
    """Switch route 1 (the fused kernel) off for the duration, so QLinears
    with ``w_eff`` take route 2 on the card."""
    from repro_torch.core import qlinear
    use_kernel = qlinear._use_fused_kernel
    qlinear._use_fused_kernel = lambda x: False
    try:
        yield
    finally:
        qlinear._use_fused_kernel = use_kernel


class ServingLayers:
    """The layers of quantized ``params`` as serving params, built one
    layer at a time as a forward reaches it and dropped after it (a 12B
    model's route-2 ``w_eff`` is 21.8 GB in bf16): by default as the
    reference routes take them (``make_serving_params(keep_packed=False)``:
    the concatenated linears with route 2's dequantized ``w_eff``), with
    ``keep_packed=None`` as the engine serves them (route 1)."""

    def __init__(self, model, params, keep_packed=False):
        self.model, self.layers = model, params["layers"]
        self.keep_packed = keep_packed

    def __len__(self):
        return len(self.layers)

    def __getitem__(self, i):
        return self.model.make_serving_params(
            {"layers": [self.layers[i]]},
            keep_packed=self.keep_packed)["layers"][0]

    def __iter__(self):
        return (self[i] for i in range(len(self)))


def teacher_forced_reference(model, params, reqs, served) -> float:
    """Per generated position, the reference routes' greedy token given
    the served prefix: each served sequence (prompt + generated) is run
    as one prefill through route 2 (``w_eff`` fake quant) and gather
    attention over a fresh int8 paged pool; returns the fraction of
    generated positions whose reference argmax equals the served token."""
    import numpy as np
    import torch

    ref_params = model.make_serving_params(params, keep_packed=False)
    agree = []
    with reference_routes(), torch.no_grad():
        for r in reqs:
            toks = torch.tensor(np.asarray(served[r["rid"]].tokens),
                                device="cuda")[None]
            n_prompt = len(r["tokens"])
            logits = prefill_logits(model, ref_params, toks)
            pred = torch.argmax(logits[n_prompt - 1:], dim=-1)
            agree.append((pred == toks[0, n_prompt:]).float().mean().item())
    return float(np.mean(agree))


def prefill_logits(model, params, toks, start: int = 0):
    """toks (1, S) as one prefill over a fresh int8 paged pool (page 16,
    gather attention) -> the logits of positions start..S-2 (those that
    predict tokens start+1..S-1), (S-1-start, vocab) in f32."""
    import torch

    n_ptab = -(-toks.shape[1] // 16)
    cache = dict(model.init_paged_cache(1 + n_ptab, 16, "cuda"))
    cache["page_table"] = (1 + torch.arange(n_ptab, dtype=torch.int32,
                                            device="cuda"))[None]
    cache["pos"] = 0
    hidden, _, _ = model.forward(params, toks, cache=cache)
    return model.logits(params, hidden[:, start:])[0, :-1].float()


def quantiles(t, qs=(0.1, 0.5, 0.9)) -> dict:
    """{"p10": ..., "p50": ..., "p90": ...} of a 1-D tensor."""
    import torch

    t = t.double().flatten()
    return {f"p{round(q * 100)}": torch.quantile(t, q).item() for q in qs}


def teacher_forced_stats(model, params, reqs, served) -> dict:
    """Each served sequence (prompt + generated) as one prefill (as
    ``teacher_forced_reference``) through the reference routes (route 2)
    and through the served linears (route 1, the fused kernels), their
    layers built one at a time (``ServingLayers``). Per generated
    position: ``agreement`` (``teacher_forced_reference``'s: route 2's
    argmax is the served token, mean over requests); the served token's
    rank in route 2's logits (``served_top5``: the share of rank < 5) and
    its gap below route 2's max; route 2's top-2 ``margin``; route 1's
    argmax against route 2's on the same prefix (``route1_agreement``) and
    their logits' relative L2 distance (``route1_logit_rel``); and the
    share of served tokens that equal the token before them
    (``served_repeats_input``: a random model that echoes its input
    agrees with any numerics). -> dict."""
    import numpy as np
    import torch

    ref = dict(params, layers=ServingLayers(model, params))
    srv = dict(params, layers=ServingLayers(model, params, keep_packed=None))
    ulp = dict(ref, embed=ulp_flip(params["embed"]))
    agree, cols = [], {k: [] for k in ("gap", "rank", "margin", "same",
                                       "rel", "repeat", "ulp", "ulp_rel")}
    with torch.no_grad():
        for r in reqs:
            toks = torch.tensor(np.asarray(served[r["rid"]].tokens),
                                device="cuda")[None]
            n_prompt = len(r["tokens"])
            with reference_routes():
                z2 = prefill_logits(model, ref, toks, n_prompt - 1)
                z3 = prefill_logits(model, ulp, toks, n_prompt - 1)
            z1 = prefill_logits(model, srv, toks, n_prompt - 1)
            tgt = toks[0, n_prompt:]
            at = z2.gather(1, tgt[:, None])[:, 0]
            top2 = z2.topk(2, dim=-1).values
            agree.append((z2.argmax(-1) == tgt).float().mean().item())
            cols["gap"].append(top2[:, 0] - at)
            cols["rank"].append((z2 > at[:, None]).sum(-1))
            cols["margin"].append(top2[:, 0] - top2[:, 1])
            cols["same"].append(z1.argmax(-1) == z2.argmax(-1))
            cols["rel"].append((z1 - z2).norm(dim=-1) / z2.norm(dim=-1))
            cols["repeat"].append(tgt == toks[0, n_prompt - 1:-1])
            cols["ulp"].append(z3.argmax(-1) == z2.argmax(-1))
            cols["ulp_rel"].append((z3 - z2).norm(dim=-1) / z2.norm(dim=-1))
    c = {k: torch.cat(v) for k, v in cols.items()}
    return {"agreement": float(np.mean(agree)),
            "positions": int(c["gap"].numel()),
            "served_top5": (c["rank"] < 5).float().mean().item(),
            "served_rank": quantiles(c["rank"]),
            "served_gap": dict(quantiles(c["gap"]),
                               max=c["gap"].max().item()),
            "margin": quantiles(c["margin"]),
            "route1_agreement": c["same"].float().mean().item(),
            "route1_logit_rel": dict(quantiles(c["rel"]),
                                     max=c["rel"].max().item()),
            "served_repeats_input": c["repeat"].float().mean().item(),
            "ulp_agreement": c["ulp"].float().mean().item(),
            "ulp_logit_rel": dict(quantiles(c["ulp_rel"]),
                                  max=c["ulp_rel"].max().item())}


def ulp_flip(t, seed: int = 0):
    """``t`` with the lowest bit of half its entries flipped (one ulp of
    its dtype), the entries drawn from ``seed``."""
    import torch

    ints = {torch.bfloat16: torch.int16, torch.float16: torch.int16,
            torch.float32: torch.int32}[t.dtype]
    gen = torch.Generator(device=t.device).manual_seed(seed)
    flip = torch.randint(0, 2, t.shape, generator=gen, device=t.device,
                         dtype=ints)
    return (t.view(ints) ^ flip).view(t.dtype)


def depth_divergence(model, params, reqs, served, n_seqs: int = 4) -> dict:
    """Layer by layer, without a cache (the plain attention over
    fake-quantized K/V), on the first ``n_seqs`` served sequences cut to
    the shortest: three hidden streams from one embedding — route 1 (the
    served linears), route 2 (the reference routes) and route 2 from an
    input one bf16 ulp off in half its entries (how far this model's own
    rounding moves it). Per layer, ``step_rel``: route 1 on route 2's
    input against route 2, relative to route 2's update (the layer's own
    error), and ``step_ulp``: route 2 on its input one bf16 ulp off in
    half its entries against route 2 (the same measure for a rounding of
    the input alone). At depths 1, 2, 4, ... and the last, each stream's argmax
    through the final norm and the unembedding against route 2's
    (``lens_route1``, ``lens_ulp``) and its relative distance to route
    2's hidden state (``rel_route1``, ``rel_ulp``). -> dict."""
    import numpy as np
    import torch

    from repro_torch.models import dense
    cfg = model.cfg
    n = min(len(served[r["rid"]].tokens) for r in reqs[:n_seqs])
    toks = torch.tensor(np.stack([np.asarray(served[r["rid"]].tokens)[:n]
                                  for r in reqs[:n_seqs]]), device="cuda")
    ref = ServingLayers(model, params)
    srv = ServingLayers(model, params, keep_packed=None)
    x2 = dense.embed(cfg, params, toks)
    x3 = ulp_flip(x2)
    x1 = x2
    out = {"seqs": n_seqs, "positions": n, "step_rel": [], "step_ulp": [],
           "depth": [],
           "lens_route1": [], "lens_ulp": [], "rel_route1": [],
           "rel_ulp": []}

    def lens(x):
        return model.logits(params, dense.rms_norm(
            x, params["final_norm"])).argmax(-1)

    with torch.no_grad():
        for i in range(cfg.n_layers):
            lp1, lp2 = srv[i], ref[i]
            with reference_routes():
                y2 = dense.layer_forward(cfg, x2, lp2, i)
                y3 = dense.layer_forward(cfg, ulp_flip(x2, i + 1), lp2, i)
                x3 = dense.layer_forward(cfg, x3, lp2, i)
            y1 = dense.layer_forward(cfg, x2, lp1, i)
            for key, y in (("step_rel", y1), ("step_ulp", y3)):
                out[key].append(((y.float() - y2.float()).norm()
                                 / (y2.float() - x2.float()).norm()).item())
            x1 = dense.layer_forward(cfg, x1, lp1, i)
            x2 = y2
            del lp1, lp2
            if ((i + 1) & i) == 0 or i + 1 == cfg.n_layers:
                want = lens(x2)
                out["depth"].append(i + 1)
                for key, x in (("route1", x1), ("ulp", x3)):
                    out[f"lens_{key}"].append(
                        (lens(x) == want).float().mean().item())
                    out[f"rel_{key}"].append(
                        ((x.float() - x2.float()).norm()
                         / x2.float().norm()).item())
    out["step_rel_max"] = max(out["step_rel"])
    out["step_ulp_max"] = max(out["step_ulp"])
    return out


def reference_run(model, params, reqs, kw):
    """Serve free-running through the reference routes on the card: route
    2 (the ``w_eff`` fake-quant matmul) and gather attention."""
    from repro_torch.launch.engine import ServeEngine
    ref_params = model.make_serving_params(params, keep_packed=False)
    with reference_routes():
        return ServeEngine(model, ref_params, fused=False,
                           paged_kernel=False, **kw).run(reqs)


def profile_serving(engine, reqs, cpu: bool = True) -> dict:
    """One more drained pass under ``torch.profiler``: device time of the
    port's kernels (by CUDA kernel name) and of everything else, against
    the pass's wall time. Device time of 0 means the profiler saw no
    device activity here: reported as not measured. ``cpu=False`` records
    the device activity alone (the host's ops of a full-width model's pass
    take a minute or more to trace)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    groups = {"decode_qkv_prologue": "decode prologue",
              "wide_prologue": "decode prologue",
              "fused_cat_gemv": "fused linear decode (one launch)",
              "wide_gemv": "fused linear decode (one launch)",
              "transform_quant": "fused linear tiled stage 1",
              "mma_kernel": "fused linear tiled contraction",
              "paged_attn_decode": "paged attention decode",
              "paged_attn_ragged": "paged attention ragged"}
    engine.reset()
    with profile(activities=[ProfilerActivity.CPU] * cpu
                 + [ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.run(reqs)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by = {v: 0.0 for v in groups.values()}
    other = 0.0
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0.0))
        if not us:
            continue
        name = next((v for k, v in groups.items() if k in evt.key), None)
        if name is None:
            other += us / 1e3
        else:
            by[name] += us / 1e3
    device_ms = sum(by.values()) + other
    if device_ms == 0:
        return {"device_ms": "not measured", "wall_ms": wall_ms}
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "busy_share": device_ms / wall_ms, "kernels_ms": by,
            "other_device_ms": other}


def serve_config(label, model, params, reqs, kw, counters, card,
                 decode_fused, pipeline):
    """One serving configuration: a warm-up pass, then the counted and
    timed pass (every counter set to 0 just before it, read just after),
    then a profiled pass. -> (engine, results, record)."""
    import os

    import numpy as np
    import torch

    from repro_torch.launch.engine import ServeEngine
    if decode_fused is None:
        os.environ.pop("REPRO_DECODE_FUSED", None)
    else:
        os.environ["REPRO_DECODE_FUSED"] = decode_fused
    engine = ServeEngine(model, params, paged_kernel=True, pipeline=pipeline,
                         **kw)
    engine.run(reqs)
    engine.reset()
    for fn in counters:
        fn.launches = 0
    res = engine.run(reqs)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counters}
    s = engine.summary()
    out = {"config": label, "pipeline": s["pipeline"],
           "decode_fused_env": decode_fused,
           "tok_per_s": s["tok_per_s"], "ttft_s_mean": s["ttft_s_mean"],
           "itl_p50_s": s["itl_p50_s"], "itl_p95_s": s["itl_p95_s"],
           "device_ms_mean": s["device_ms_mean"],
           "host_ms_mean": s["host_ms_mean"],
           "overlap_frac": s["overlap_frac"],
           "host_ms_hidden": s["host_ms_hidden"],
           "mispredicts": s["mispredicts"], "steps": s["steps"],
           "decode_steps": s["decode_steps"],
           "generated_tokens": s["generated_tokens"],
           "wall_s": s["wall_s"], "launches": launches, "card": card}
    print(f"serving {label}: " + json.dumps(out))
    out["profile"] = profile_serving(engine, reqs)
    print(f"serving {label}: profiled pass " + json.dumps(out["profile"]))
    if s["generated_tokens"] != 8 * 32:
        fail(f"{label}: served {s['generated_tokens']} tokens, expected "
             f"{8 * 32}")
    for r in reqs:
        toks = np.asarray(res[r["rid"]].tokens)
        if not (len(toks) == len(r["tokens"]) + 32
                and (0 <= toks).all() and (toks < model.cfg.vocab).all()):
            fail(f"{label} request {r['rid']}: malformed output {toks}")
    return engine, res, out


def alternate_passes(engines: dict, reqs, rounds: int = 5) -> dict:
    """Host time varies from pass to pass on a shared host, so compare
    the configurations on warm engines in alternation: ``rounds`` drained
    passes each, the order rotated every round. -> per configuration the
    median and quartiles of tok/s, ITL p50 and TTFT (ms) and the raw
    values."""
    import os

    import numpy as np
    names = list(engines)
    runs = {n: {"tok_per_s": [], "itl_p50_ms": [], "ttft_ms": []}
            for n in names}
    for i in range(rounds):
        for n in names[i % len(names):] + names[:i % len(names)]:
            engine, fused_env = engines[n]
            if fused_env is None:
                os.environ.pop("REPRO_DECODE_FUSED", None)
            else:
                os.environ["REPRO_DECODE_FUSED"] = fused_env
            engine.reset()
            engine.run(reqs)
            s = engine.summary()
            runs[n]["tok_per_s"].append(s["tok_per_s"])
            runs[n]["itl_p50_ms"].append(1e3 * s["itl_p50_s"])
            runs[n]["ttft_ms"].append(1e3 * s["ttft_s_mean"])
    os.environ.pop("REPRO_DECODE_FUSED", None)
    out = {}
    for n, r in runs.items():
        out[n] = {}
        for k, v in r.items():
            q1, med, q3 = np.percentile(v, [25, 50, 75])
            out[n][k] = {"median": float(med), "q1": float(q1),
                         "q3": float(q3), "runs": v}
    return out


def count_dispatch_syncs(engine, reqs) -> dict:
    """Synchronising CUDA calls in the dispatch half of each pipelined
    cycle (``_plan_and_dispatch`` under ``torch.cuda.set_sync_debug_mode(
    "warn")``), over one drained pass: the count for the first cycle (a
    ragged prefill step), the largest over the pure-decode cycles, and the
    distinct warning texts."""
    import warnings

    import torch
    real = engine._plan_and_dispatch
    per_cycle, texts = [], set()

    def counted():
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                plan, inf = real()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        hits = [str(w.message) for w in caught
                if "called a synchronizing" in str(w.message)]
        texts.update(h.splitlines()[0][:200] for h in hits)
        per_cycle.append((bool(inf is not None and inf.slot_major),
                          len(hits)))
        return plan, inf

    engine.reset()
    engine._plan_and_dispatch = counted
    try:
        engine.run(reqs)
    finally:
        del engine._plan_and_dispatch
    decode = [n for slot_major, n in per_cycle if slot_major]
    return {"first_cycle": per_cycle[0][1],
            "decode_cycle_max": max(decode) if decode else None,
            "cycles": len(per_cycle), "total": sum(n for _, n in per_cycle),
            "texts": sorted(texts)}


def serve(counters, card):
    import numpy as np
    import torch

    from repro_torch.data import request_workload
    from repro_torch.launch.serve import build_served_model

    t0 = time.perf_counter()
    cfg, model, params, mem = build_served_model(
        "catlm_60m", "cat", 4, 4, 8, smoke=False, seed=0, device="cuda")
    torch.cuda.synchronize()
    ptq_s = time.perf_counter() - t0
    print(f"serving: catlm-60m full width ({cfg.n_layers} layers, d "
          f"{cfg.d_model}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
          f"{cfg.dtype}), PTQ on the card in {ptq_s:.1f} s, "
          f"{mem['qlinear_layers']} int4-packed linears, "
          f"{mem['weight_bytes'] / 2**20:.2f} MiB")
    reqs = request_workload(cfg, 8, gen=32, seed=0)
    max_len = max(len(r["tokens"]) for r in reqs) + 32 + 8
    kw = dict(n_slots=8, max_len=max_len, schedule="unified",
              max_batch_tokens=128, page_size=16, device="cuda")

    # (a) the slice-1 configuration: synchronous, composed decode layers
    eng_a, res_a, out_a = serve_config("(a) sync, fused decode off", model,
                                       params, reqs, kw, counters, card, "0",
                                       False)
    # (b) the default: pipelined, two-launch decode — the main path
    eng_b, res_b, out_b = serve_config("(b) default", model, params, reqs,
                                       kw, counters, card, None, None)
    out = {"a": out_a, "b": out_b}
    for name, n in out_b["launches"].items():
        if n <= 0:
            fail(f"kernel {name} never launched in the default serving "
                 f"configuration")
    if not out_b["pipeline"]:
        fail("the default configuration did not run the pipelined loop")

    # (b) with the synchronous loop: the same tokens; its warm pass's
    # summary separates the two-launch decode's share of (b)'s gain from
    # the pipelined loop's
    from repro_torch.launch.engine import ServeEngine
    eng_bs = ServeEngine(model, params, paged_kernel=True, pipeline=False,
                         **kw)
    eng_bs.run(reqs)
    eng_bs.reset()
    res_sync = eng_bs.run(reqs)
    s_bs = eng_bs.summary()
    out["b_sync"] = {k: s_bs[k] for k in (
        "tok_per_s", "ttft_s_mean", "itl_p50_s", "itl_p95_s",
        "device_ms_mean", "host_ms_mean")}
    diff = [r["rid"] for r in reqs
            if not np.array_equal(res_sync[r["rid"]].tokens,
                                  res_b[r["rid"]].tokens)]
    out["b_pipelined_equals_sync"] = not diff
    print(f"serving: (b) with pipeline=False {json.dumps(out['b_sync'])}; "
          f"token-identical to (b): {not diff}")
    if diff:
        fail(f"(b) pipelined and synchronous tokens differ for {diff}")

    out["alternating"] = alternate_passes(
        {"a": (eng_a, "0"), "b": (eng_b, None), "b_sync": (eng_bs, None)},
        reqs)
    print("serving: alternating warm passes " + json.dumps(
        out["alternating"]))

    out["dispatch_syncs"] = count_dispatch_syncs(eng_b, reqs)
    print("serving: synchronising calls in the dispatch half (b) "
          + json.dumps(out["dispatch_syncs"]))

    # the reference routes (route 2 w_eff fake quant + gather attention):
    # teacher-forced on the served sequences (held), and free-running
    # (reported: on random weights one changed token changes every later
    # one, so free-running agreement measures divergence, not the path)
    for key, res in (("a", res_a), ("b", res_b)):
        out[key]["reference_agreement_teacher_forced"] = \
            teacher_forced_reference(model, params, reqs, res)
    out["b"]["reference_agreement_free_running"] = agreement(
        reqs, res_b, reference_run(model, params, reqs, kw))
    print("serving: token agreement with the reference routes " + json.dumps(
        {"a_teacher_forced":
         out["a"]["reference_agreement_teacher_forced"],
         "b_teacher_forced": out["b"]["reference_agreement_teacher_forced"],
         "b_free_running": out["b"]["reference_agreement_free_running"]}))
    for key in ("a", "b"):
        agree = out[key]["reference_agreement_teacher_forced"]
        if agree < 0.9:
            fail(f"({key}) teacher-forced agreement with the reference "
                 f"routes {agree} < 0.9")
    return out, model, params


LEGACY_CONFIGS = {
    # (c) the reference's default engine: legacy schedule, slot cache,
    # power-of-two prefill buckets
    "c": dict(paged=False, bucket=True),
    # (c') the same on the paged pool through the gather path
    "c_paged": dict(paged=True, paged_kernel=False, page_size=16),
    # (d) the paged pool with the paged kernels: the decode attention and,
    # on the card, the two-launch decode
    "d": dict(paged=True, paged_kernel=True, page_size=16),
}


SERVED_KEYS = ("tok_per_s", "ttft_s_mean", "itl_p50_s", "itl_p95_s",
               "host_ms_mean", "device_ms_mean", "dispatch_per_step",
               "n_dispatch", "steps", "decode_steps", "generated_tokens",
               "wall_s")


def served_passes(engine, reqs, counters, keys=SERVED_KEYS):
    """A warm-up pass, the counted pass (every kernel counter set to 0 just
    before it, read just after) and two warm passes of ``engine`` over
    ``reqs``. -> (the counted pass's results, its launches, its whole
    ``summary()``, the three passes' ``keys`` of ``summary()``)."""
    import torch
    engine.run(reqs)
    engine.reset()
    for fn in counters:
        fn.launches = 0
    res = engine.run(reqs)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counters}
    counted = engine.summary()
    passes = [{k: counted[k] for k in keys}]
    for _ in range(2):
        engine.reset()
        engine.run(reqs)
        passes.append({k: engine.summary()[k] for k in keys})
    return res, launches, counted, passes


def check_well_formed(label, reqs, res, vocab, gen=32):
    """Every request served ``gen`` new tokens, all in the vocabulary."""
    import numpy as np
    for r in reqs:
        toks = np.asarray(res[r["rid"]].tokens)
        if not (len(toks) == len(r["tokens"]) + gen
                and (0 <= toks).all() and (toks < vocab).all()):
            fail(f"{label} request {r['rid']}: malformed output {toks}")


def token_share(reqs, got, want) -> dict:
    """The share of equal tokens (prompt and generated, as ``agreement``)
    and, per request that differs, its first differing generated step."""
    import numpy as np
    equal, first = [], {}
    for r in reqs:
        a = np.asarray(got[r["rid"]].tokens)
        b = np.asarray(want[r["rid"]].tokens)
        equal.append(float(np.mean(a == b)))
        if equal[-1] < 1.0:
            first[r["rid"]] = int(np.argmax(a != b)) - len(r["tokens"])
    return {"share": float(np.mean(equal)), "first_differing_step": first}


def legacy_phase(model, params, counters, card):
    """The legacy schedule (prefill on admit, bucketed; one batched decode
    per step) at full width on the serving phase's model and 8 requests,
    8 slots, ``max_len`` a multiple of 16, in the three configurations of
    ``LEGACY_CONFIGS``. Each: a warm-up pass, the counted pass (every
    kernel counter set to 0 just before it, read just after), two more
    warm passes; tok/s, TTFT, ITL p50/p95, host ms and dispatches per
    step of each. Held: (c) and (c') token-identical (the gathered paged
    view has the slot cache's content and shape); (d)'s counted pass
    launches the decode linear, the tiled linear (prefill buckets 16 and
    32), the decode attention and the prologue; the reference routes,
    teacher-forced over (c)'s and (d)'s served sequences, predict >= 0.9
    of their tokens."""
    import os

    from repro_torch.data import request_workload
    from repro_torch.launch.engine import ServeEngine
    os.environ.pop("REPRO_DECODE_FUSED", None)     # on for CUDA: the default
    reqs = request_workload(model.cfg, 8, gen=32, seed=0)
    max_len = -(-(max(len(r["tokens"]) for r in reqs) + 32 + 8) // 16) * 16
    out, served = {}, {}
    for name, cfg_kw in LEGACY_CONFIGS.items():
        engine = ServeEngine(model, params, n_slots=8, max_len=max_len,
                             schedule="legacy", device="cuda", **cfg_kw)
        res, launches, s, passes = served_passes(
            engine, reqs, counters, SERVED_KEYS + ("d2h_ms_mean",))
        if s["schedule"] != "legacy" or s["paged"] != cfg_kw["paged"]:
            fail(f"legacy ({name}): the engine ran {s['schedule']}, paged "
                 f"{s['paged']}")
        check_well_formed(f"legacy ({name})", reqs, res, model.cfg.vocab)
        served[name] = res
        out[name] = {"engine": cfg_kw, "max_len": max_len,
                     "launches": launches, "passes": passes, "card": card}
        print(f"legacy ({name}) {card}: " + json.dumps(out[name]))
    out["c_equals_c_paged"] = same = token_share(reqs, served["c_paged"],
                                                 served["c"])
    print("legacy: (c) vs (c') tokens " + json.dumps(same))
    if same["first_differing_step"]:
        fail(f"legacy (c) and (c') tokens differ: share equal "
             f"{same['share']}, first differing generated step per request "
             f"{same['first_differing_step']}")
    for fn_name, n in out["d"]["launches"].items():
        if fn_name != "paged_attention_ragged" and n <= 0:
            fail(f"legacy (d): kernel {fn_name} never launched in its "
                 f"counted pass")
    for name in ("c", "d"):
        agree = teacher_forced_reference(model, params, reqs, served[name])
        out[name]["reference_agreement_teacher_forced"] = agree
        print(f"legacy ({name}): teacher-forced agreement with the "
              f"reference routes {agree}")
        if agree < 0.9:
            fail(f"legacy ({name}) teacher-forced agreement with the "
                 f"reference routes {agree} < 0.9")
    return out


def _compare(a, b) -> dict:
    a, b = a.float(), b.float()
    return {"bitwise": bool(torch_equal(a, b)),
            "bitwise_share": (a == b).float().mean().item(),
            "max_abs": (a - b).abs().max().item()}


def torch_equal(a, b) -> bool:
    import torch
    return a.shape == b.shape and bool(torch.equal(a, b))


def step_arrays(items, q_width):
    """A unified step's host arrays as ``TokenBudgetScheduler.pack`` and
    ``_kernel_desc`` lay them out, for ``items`` of (table row, first
    position, tokens, logits: "all" | "last" | "none"): (packed, desc) as
    numpy, for ``launch.executor.route_rows``."""
    import numpy as np
    t = sum(len(toks) for _, _, toks, _ in items)
    n_ptab = len(items[0][0])
    tokens = np.zeros((t, 1), np.int32)
    pos = np.zeros((t,), np.int32)
    ptab = np.zeros((t, n_ptab), np.int32)
    qidx = np.zeros((len(items), q_width), np.int32)
    qpos = np.full((len(items), q_width), -1, np.int32)
    lengths = np.zeros((len(items),), np.int32)
    table = np.zeros((len(items), n_ptab), np.int32)
    inv_seq = np.zeros((t,), np.int32)
    inv_qi = np.zeros((t,), np.int32)
    logit_rows = []
    i = 0
    for j, (row, first, toks, logits) in enumerate(items):
        n = len(toks)
        tokens[i:i + n, 0] = toks
        pos[i:i + n] = first + np.arange(n)
        ptab[i:i + n] = row
        qidx[j, :n] = i + np.arange(n)
        qpos[j, :n] = first + np.arange(n)
        lengths[j] = first + n
        table[j] = row
        inv_seq[i:i + n] = j
        inv_qi[i:i + n] = np.arange(n)
        logit_rows += {"all": list(range(i, i + n)), "last": [i + n - 1],
                       "none": []}[logits]
        i += n
    packed = {"tokens": tokens, "pos": pos, "page_table": ptab,
              "logit_rows": np.asarray(logit_rows, np.int32),
              "n_logits": len(logit_rows)}
    desc = {"qidx": qidx, "qpos": qpos, "lengths": lengths, "table": table,
            "inv_seq": inv_seq, "inv_qi": inv_qi}
    return packed, desc


def routed_desc(packed, desc, dev):
    """``route_rows`` of a step, its arrays on the card."""
    import numpy as np
    import torch

    from repro_torch.launch.executor import route_rows
    return {k: torch.as_tensor(v).to(dev) if isinstance(v, np.ndarray)
            else v for k, v in route_rows(packed, desc).items()}


def attention_identity(gen, dev, heads=(4, 2, 64)) -> dict:
    """Rows 4 and 3 on the same query rows: 8 sequences at the served
    lengths (<= 56) and at long prefixes (130..2048, the table 128 pages
    wide, so row 4 splits as many ways as its layout fits, up to 8), 5
    query rows each (a k 4 verify item's positions), bf16 q, ``heads``
    (KV heads, query heads per KV head, head_dim) as
    ``attention_operands`` takes them. The yardstick is row 4 at 8 rows,
    one launch per
    query position. Held bitwise: row 4 at 1 and at 40 rows a launch; a
    unified step's attention (``ops.step_paged_attention`` on
    ``route_rows``) for one-row items, for 5-row verify items and for
    one-row items beside a 64-row prefill chunk. Reported: row 3 alone
    (unrouted) on one-row items against row 4, and on rows of 5-row items
    against the same rows as one-row items."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as P
    out, held = {}, []
    for label, lens in (("served", (9, 17, 24, 31, 40, 47, 53, 56)),
                        ("long", (130, 257, 513, 700, 1025, 1500, 2047,
                                  2048))):
        items = [(5, ln) for ln in lens] + [(64, 64)]
        kvh, g, hd = heads
        args, _ = attention_operands(items, 64, gen, dev, decode=False,
                                     kvh=kvh, g=g, hd=hd)
        q, kp, ks, vp, vs, table, lengths, qpos = args
        pools = (kp, ks, vp, vs)
        want = torch.stack([P.paged_attention_decode(
            q[:8, j], *pools, table[:8], (qpos[:8, j] + 1).to(torch.int32))
            for j in range(5)], 1)                       # (8, 5, ...)
        rec = {}
        one = torch.cat([P.paged_attention_decode(
            q[i:i + 1, j], *pools, table[i:i + 1],
            (qpos[i:i + 1, j] + 1).to(torch.int32))
            for i in range(8) for j in range(5)]).reshape(want.shape)
        rec["row4_1_row_launches"] = _compare(one, want)
        forty = P.paged_attention_decode(
            q[:8, :5].reshape(40, kvh, g, hd), *pools,
            table[:8].repeat_interleave(5, 0),
            (qpos[:8, :5].reshape(-1) + 1).to(torch.int32))
        rec["row4_40_rows"] = _compare(forty.reshape(want.shape), want)
        host_table = table.cpu().numpy()
        host_qpos = qpos.cpu().numpy()

        def step(shape, rows_of):
            """-> the step attention's output for the 8 sequences' rows."""
            packed, desc = step_arrays(shape, 64)
            flat = q[rows_of[0], rows_of[1]]
            qf = torch.cat([flat, q[8, :64]]) if len(shape) > 8 else flat
            got = ops.step_paged_attention(qf, *pools,
                                           routed_desc(packed, desc, dev))
            return got[:flat.shape[0]]
        prefill = (host_table[8], 0, [0] * 64, "last")
        ones = [(host_table[i], int(host_qpos[i, 4]), [0], "all")
                for i in range(8)]
        idx = (torch.arange(8, device=dev), torch.full((8,), 4, device=dev))
        rec["step_one_row_items"] = _compare(step(ones, idx), want[:, 4])
        rec["step_one_row_items_beside_prefill"] = _compare(
            step(ones + [prefill], idx), want[:, 4])
        verify = [(host_table[i], int(host_qpos[i, 0]), [0] * 5, "all")
                  for i in range(8)]
        vidx = (torch.arange(8, device=dev).repeat_interleave(5),
                torch.arange(5, device=dev).repeat(8))
        rec["step_verify_items"] = _compare(
            step(verify, vidx).reshape(want.shape), want)
        held += [rec[k]["bitwise"] for k in rec]
        # reported: row 3 itself
        r3_one = P.paged_attention_ragged(
            q[:8, 4:5], *pools, table[:8], lengths[:8], qpos[:8, 4:5])
        rec["row3_one_row_items_vs_row4"] = _compare(r3_one[:, 0],
                                                     want[:, 4])
        r3_five = P.paged_attention_ragged(
            q[:8, :5], *pools, table[:8], lengths[:8], qpos[:8, :5])
        rec["row3_verify_rows_vs_row3_one_row_items"] = _compare(
            r3_five[:, 4], r3_one[:, 0])
        out[label] = rec
    out["ok"] = all(held)
    return out


def layer_identity(gen, dev) -> dict:
    """The linear and the K/V write of the same rows in the two step
    shapes, bf16, at the serving widths: row 1 (8 rows) against row 2
    (the same rows in a 40-row batch); and row 5 (the two-launch decode's
    prologue) against the unified step's composed path on those rows (row
    1's output in bf16, RoPE, ``quantize_kv``): q, the KV codes and their
    scales. All held bitwise."""
    import torch

    from repro_torch.kernels import decode_layer as L
    from repro_torch.kernels import fused_cat_matmul as F
    from repro_torch.models.layers import quantize_kv, rope
    x, *w = fused_linear_operands(40, 512, 3072, gen, dev)
    rec = {"rows_1_vs_2": _compare(
        F.fused_cat_gemv_w4(x[:8], *w, act_bits=4),
        F.fused_cat_matmul_w4(x, *w, act_bits=4)[:8])}
    targets = [(1 + i, (5 * i) % 16, 16 * i + (5 * i) % 16)
               for i in range(8)]
    args, pools, ids = prologue_operands(8, gen, dev, targets)
    kw = dict(n_q=512, head_dim=64, rope_theta=10000.0, kv_bits=8,
              act_bits=4, packed=True)
    got = [t.clone() for t in pools]
    q5 = L.decode_qkv_prologue(*args, *got, *ids, **kw)[0]
    y = F.fused_cat_gemv_w4(*args, act_bits=4).to(torch.bfloat16)
    y40 = F.fused_cat_matmul_w4(
        torch.cat([args[0], args[0][:1].expand(32, -1)]), *args[1:],
        act_bits=4)[:8].to(torch.bfloat16)
    pos = ids[2][:, None]
    q = rope(y[:, :512].reshape(8, 1, 8, 64), pos, 10000.0)
    k = rope(y[:, 512:768].reshape(8, 1, 4, 64), pos, 10000.0)
    kq, ks = quantize_kv(k, 8)
    vq, vs = quantize_kv(y[:, 768:].reshape(8, 1, 4, 64), 8)
    sel = (ids[0].long(), ids[1].long())
    rec["row5_vs_rows_1_2_output"] = _compare(y, y40)
    rec["row5_q_vs_composed"] = _compare(q5, q.reshape(8, 512).float())
    rec["row5_k_codes_vs_composed"] = _compare(got[0][sel], kq[:, 0])
    rec["row5_k_scales_vs_composed"] = _compare(got[1][sel], ks[:, 0])
    rec["row5_v_codes_vs_composed"] = _compare(got[2][sel], vq[:, 0])
    rec["row5_v_scales_vs_composed"] = _compare(got[3][sel], vs[:, 0])
    rec["ok"] = all(v["bitwise"] for v in rec.values())
    return rec


def model_identity(model, params, gen, dev) -> dict:
    """The whole served model (full width, CAT W4A4, bf16, int8 pages of
    16) on the same rows in three step shapes, against the pure-decode
    step (``model.decode`` with the two-launch decode, 8 rows): a unified
    step of 8 one-row decode items; the same beside a 40-row prefill
    chunk; and 8 verify items of 5 rows against five successive decode
    steps. Every row's logits and the pools after the step, held
    bitwise. The pools start with random codes and scales, the table 8
    pages a sequence."""
    import numpy as np
    import torch

    sp = model.make_serving_params(params)
    cfg = model.cfg
    n_ptab, ps = 8, 16
    pools = model.init_paged_cache(1 + 9 * n_ptab, ps, dev)
    for k, v in pools.items():
        if v.dtype == torch.int8:
            v.copy_(torch.randint(-127, 128, v.shape, generator=gen,
                                  dtype=torch.int8))
        else:
            v.copy_(torch.rand(v.shape, generator=gen) * 0.02 + 0.001)
    table = (1 + torch.arange(9 * n_ptab, dtype=torch.int32)
             ).reshape(9, n_ptab)
    host_table = table.numpy()
    table = table.to(dev)
    first = np.asarray([9, 17, 24, 31, 40, 47, 53, 56], np.int32)
    toks = torch.randint(0, cfg.vocab, (8, 5), generator=gen,
                         dtype=torch.int32)

    def fresh():
        return {k: v.clone() for k, v in pools.items()}

    def decode(cache, j):
        c = dict(cache, pos=torch.as_tensor(first + j).to(dev),
                 page_table=table[:8])
        logits, c = model.decode(sp, toks[:, j:j + 1].to(dev), c,
                                 paged_kernel=True)
        return logits[:, 0], {k: v for k, v in c.items()
                              if k not in ("pos", "page_table")}

    def ragged(cache, items):
        packed, desc = step_arrays(items, 40)
        c = dict(cache, pos=torch.as_tensor(packed["pos"]).to(dev),
                 page_table=torch.as_tensor(packed["page_table"]).to(dev))
        logits, c = model.ragged_step(
            sp, torch.as_tensor(packed["tokens"]).to(dev), c,
            torch.as_tensor(packed["logit_rows"]).to(dev),
            paged_kernel=True, ragged_desc=routed_desc(packed, desc, dev))
        return logits[:, 0], {k: v for k, v in c.items()
                              if k not in ("pos", "page_table")}

    def same(a, b):
        diff = [k for k in a if not torch.equal(a[k], b[k])]
        return diff

    out = {"layers": cfg.n_layers}
    with torch.no_grad():
        want, want_pools = decode(fresh(), 0)
        ones = [(host_table[i], int(first[i]), [int(toks[i, 0])], "all")
                for i in range(8)]
        got, got_pools = ragged(fresh(), ones)
        out["one_row_items"] = {"bitwise": torch_equal(got, want),
                                "pools_differ": same(got_pools,
                                                     want_pools)}
        prefill = (host_table[8], 0, [int(t) for t in torch.randint(
            0, cfg.vocab, (40,), generator=gen)], "last")
        got, got_pools = ragged(fresh(), ones + [prefill])
        # the prefill writes its own pages: compare the 8 rows' pages
        keep = table[:8].reshape(-1).long()
        out["beside_prefill"] = {
            "bitwise": torch_equal(got[:8], want),
            "pools_differ": [k for k in want_pools if not torch.equal(
                got_pools[k][:, keep], want_pools[k][:, keep])]}
        cache = fresh()
        steps = []
        for j in range(5):
            logits, cache = decode(cache, j)
            steps.append(logits)
        want5 = torch.stack(steps, 1).reshape(40, -1)
        verify = [(host_table[i], int(first[i]),
                   [int(t) for t in toks[i]], "all") for i in range(8)]
        got, got_pools = ragged(fresh(), verify)
        out["verify_items"] = {"bitwise": torch_equal(got, want5),
                               "pools_differ": same(got_pools, cache)}
    out["ok"] = all(v["bitwise"] and not v["pools_differ"]
                    for k, v in out.items() if isinstance(v, dict))
    return out


def batch_shape_probe(model, params, gen, dev,
                      parts=("attention", "layers", "model"),
                      heads=(4, 2, 64)) -> dict:
    """A query row's bits may not depend on the step shape that carried
    it: ``attention_identity`` (at ``heads``), ``layer_identity`` and
    ``model_identity`` (those of ``parts``; the kernels' two do not
    depend on the model), each held (its ``ok``)."""
    probes = {"attention": lambda: attention_identity(gen, dev, heads),
              "layers": lambda: layer_identity(gen, dev),
              "model": lambda: model_identity(model, params, gen, dev)}
    out = {part: probes[part]() for part in parts}
    out["ok"] = all(v["ok"] for v in out.values())
    return out


PREFIX_KEYS = ("prefix_lookups", "prefix_hits", "prefix_hit_tokens",
               "prefix_hit_rate", "cow_copies", "cached_pages",
               "cached_kv_bytes", "resident_kv_bytes_peak", "pages_peak")
SPEC_KEYS = ("spec_acceptance_rate", "spec_drafted_tokens",
             "spec_accepted_tokens", "spec_cycles", "draft_pages_peak")


def prefix_spec_phase(model, params, counters, card):
    """The prefix cache and speculative decoding at full width, on the
    serving phase's model (CAT W4A4 RTN, bf16), 8 slots, 32 new tokens per
    request, the paged kernels:
    (e) (b)'s engine (unified, pipelined, page 16, budget 128) with
        ``prefix_cache=True`` on 8 requests sharing a 40-token prefix (2.5
        pages), beside the same engine with the cache off;
    (e') (d)'s engine (legacy, paged, ``max_len`` a multiple of 16) with
        the cache, beside it without;
    (f) (b)'s engine with ``speculative_k=4`` and ``build_draft_model``'s
        draft (the same checkpoint, CAT W4A8, int8 KV), built at full
        width on the card, on (b)'s requests, beside (b) itself;
    (f') (f) with ``adaptive_spec=True``.
    Each configuration: ``served_passes`` (tok/s, TTFT mean, ITL p50/p95,
    steps, dispatches) and its feature counters. Held: tokens well-formed;
    the reference routes, teacher-forced over the served sequences,
    predict >= 0.9 of them; (e) and (e') hit and split a page copy-on-write
    in their counted pass and, drained, hold only the trie's pages; (f)'s
    counted pass launches the tiled linear and the ragged attention (40
    verify rows a step) and both pools drain; every served token equals
    its yardstick's ((e) and (e') the cache-off run's, (f) and (f') (b)'s:
    share 1.000, the reference's identities), and ``batch_shape_probe``
    holds a row's bits across step shapes."""
    import os

    import torch

    from repro_torch.data import request_workload
    from repro_torch.launch.engine import ServeEngine
    from repro_torch.launch.serve import build_draft_model
    os.environ.pop("REPRO_DECODE_FUSED", None)
    cfg = model.cfg
    shared = request_workload(cfg, 8, gen=32, seed=0, shared_prefix=40)
    plain = request_workload(cfg, 8, gen=32, seed=0)

    def max_len(reqs):
        return -(-(max(len(r["tokens"]) for r in reqs) + 32 + 8) // 16) * 16
    unified = dict(n_slots=8, schedule="unified", max_batch_tokens=128,
                   page_size=16, paged_kernel=True, device="cuda")
    legacy = dict(n_slots=8, schedule="legacy", paged=True, page_size=16,
                  paged_kernel=True, device="cuda")
    t0 = time.perf_counter()
    draft = build_draft_model("catlm_60m", smoke=False, seed=0,
                              device="cuda")
    draft_s = time.perf_counter() - t0
    configs = {      # name: (engine kwargs, requests, yardstick or None)
        "e_off": (dict(unified, max_len=max_len(shared)), shared, None),
        "e": (dict(unified, max_len=max_len(shared), prefix_cache=True),
              shared, "e_off"),
        "e_legacy_off": (dict(legacy, max_len=max_len(shared)), shared,
                         None),
        "e_legacy": (dict(legacy, max_len=max_len(shared),
                          prefix_cache=True), shared, "e_legacy_off"),
        "b": (dict(unified, max_len=max_len(plain)), plain, None),
        "f": (dict(unified, max_len=max_len(plain), speculative_k=4,
                   draft=draft), plain, "b"),
        "f_adaptive": (dict(unified, max_len=max_len(plain),
                            speculative_k=4, draft=draft,
                            adaptive_spec=True), plain, "b"),
    }
    out, served = {"draft_ptq_s": draft_s}, {}
    for name, (kw, reqs, yard) in configs.items():
        engine = ServeEngine(model, params, **kw)
        res, launches, s, passes = served_passes(engine, reqs, counters)
        check_well_formed(f"prefix/spec ({name})", reqs, res, cfg.vocab)
        served[name] = res
        rec = {"engine": {k: v for k, v in kw.items() if k != "draft"},
               "launches": launches, "passes": passes, "card": card,
               **{k: s[k] for k in PREFIX_KEYS + SPEC_KEYS if k in s}}
        if engine.prefix is not None:
            rec["pool_in_use"] = engine.pool.in_use
            rec["trie_resident"] = engine.prefix.resident
            if not (s["prefix_hit_tokens"] and s["cow_copies"]):
                fail(f"prefix/spec ({name}): no hit or no copy-on-write "
                     f"split ({s['prefix_hit_tokens']} hit tokens, "
                     f"{s['cow_copies']} copies)")
            if engine.pool.in_use != engine.prefix.resident:
                fail(f"prefix/spec ({name}): {engine.pool.in_use} pages "
                     f"live after the drain, the trie holds "
                     f"{engine.prefix.resident}")
        if engine.spec_k:
            rec["pools_in_use"] = [engine.pool.in_use,
                                   engine.draft_pool.in_use]
            if rec["pools_in_use"] != [0, 0]:
                fail(f"prefix/spec ({name}): pools not drained "
                     f"{rec['pools_in_use']}")
        if yard is not None:
            rec["tokens_equal_" + yard] = token_share(reqs, res,
                                                      served[yard])
        out[name] = rec
        print(f"prefix/spec ({name}) {card}: " + json.dumps(rec))
    probe = batch_shape_probe(model, params,
                              torch.Generator().manual_seed(1),
                              torch.device("cuda"))
    out["batch_shape_probe"] = probe
    for part in ("attention", "layers", "model"):
        print(f"batch-shape probe ({part}): " + json.dumps(probe[part]))
    if not probe["ok"]:
        fail("batch-shape probe: a row's bits depend on the step shape "
             "that carried it")
    for name, yard in (("e", "e_off"), ("e_legacy", "e_legacy_off"),
                       ("f", "b"), ("f_adaptive", "b")):
        share = out[name]["tokens_equal_" + yard]
        if share["share"] != 1.0:
            fail(f"prefix/spec ({name}): tokens equal to ({yard})'s on "
                 f"{share['share']} of positions, not 1.000: "
                 f"{json.dumps(share)}")
    for fn_name in ("fused_cat_matmul_w4", "paged_attention_ragged"):
        if out["f"]["launches"][fn_name] <= 0:
            fail(f"prefix/spec (f): kernel {fn_name} never launched in its "
                 f"counted pass")
    for name in ("e", "e_legacy", "f", "f_adaptive"):
        reqs = configs[name][1]
        agree = teacher_forced_reference(model, params, reqs, served[name])
        out[name]["reference_agreement_teacher_forced"] = agree
        print(f"prefix/spec ({name}): teacher-forced agreement with the "
              f"reference routes {agree}")
        if agree < 0.9:
            fail(f"prefix/spec ({name}) teacher-forced agreement with the "
                 f"reference routes {agree} < 0.9")
    return out


def train_phase(counters, card) -> dict:
    """Training on the card: full-width catlm-60m (``configs/catlm_60m.py``,
    f32 params, bf16 compute), batch 8 x 128 tokens of ``make_batch(0,
    step)``, ``benchmarks/common.py``'s recipe (``AdamW(warmup_cosine(1e-3,
    10, 120))``, 120 steps; it is ``launch.train``'s default at
    ``lr=1e-3``). Held: every loss finite and the mean of the last 10 below
    that of the first 10; a save and restore of the trained params and
    optimizer state bitwise; ``launch.train.train`` with a checkpoint every
    50 steps and a failure injected at step 60 resumes from step 50 and
    ends bitwise equal to the uninterrupted run (losses and final
    checkpoint: the data are a function of (seed, step) and every gradient
    sum has a fixed order); the trained model, CAT-W4A4 RTN-quantized on
    the card, served through (b)'s engine on (b)'s requests with the
    teacher-forced agreement of the reference routes >= 0.9. Reported: ms
    per train step (CUDA events, the median after 5 steps) and tokens per
    second, beside the card."""
    import shutil

    import numpy as np
    import torch

    from repro_torch import checkpoint as ck
    from repro_torch.configs import get_config
    from repro_torch.core.pipeline import QuantizeConfig, quantize_model
    from repro_torch.data import calibration_batches, request_workload
    from repro_torch.launch import train as T
    from repro_torch.launch.engine import ServeEngine
    from repro_torch.models import build
    from repro_torch.optim.optimizer import AdamW, tree_leaves, warmup_cosine
    steps, batch, seq, lr = 120, 8, 128, 1e-3
    cfg = get_config("catlm_60m")
    model = build(cfg)
    work = ROOT / "build" / "train_phase"
    shutil.rmtree(work, ignore_errors=True)
    params = model.init(torch.Generator().manual_seed(0), "cuda")
    opt = AdamW(lr=warmup_cosine(lr, 10, steps))
    state = opt.init(params)
    step_fn = T.make_train_step(model, opt)
    losses, ms = [], []
    t0 = time.perf_counter()
    for step in range(steps):
        b = T.device_batch(cfg, seq, batch, 0, step, "cuda")
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        params, state, m = step_fn(params, state, b)
        e1.record()
        losses.append(float(m["loss"]))
        ms.append(e0.elapsed_time(e1))
    wall_s = time.perf_counter() - t0
    first10, last10 = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    ms_step = float(np.median(ms[5:]))
    out = {"config": "catlm-60m full width, batch 8 x 128, AdamW "
           "warmup_cosine(1e-3, 10, 120)", "steps": steps, "wall_s": wall_s,
           "ms_per_step": ms_step,
           "train_tok_per_s": batch * seq / (ms_step / 1e3),
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
           "loss_first": losses[0], "loss_last": losses[-1],
           "loss_first10": first10, "loss_last10": last10, "card": card}
    print(f"train {card}: " + json.dumps(out))
    if not all(np.isfinite(losses)) or not last10 < first10:
        fail(f"train: losses not finite or not falling: {losses}")
    ck.save(str(work / "saved"), steps, params, state)
    back = ck.restore(str(work / "saved"), None, params, state,
                      device="cuda")
    pairs = list(zip(tree_leaves([params, state]),
                     tree_leaves([back["params"], back["opt_state"]])))
    out["save_restore_bitwise"] = all(
        a.dtype == b.dtype and torch.equal(a, b) for a, b in pairs)
    if not out["save_restore_bitwise"] or back["step"] != steps:
        fail("train: a save and restore of the trained params and "
             "optimizer state is not bitwise")
    kw = dict(steps=steps, batch=batch, seq=seq, lr=lr, ckpt_every=50,
              smoke=False, device="cuda", log_every=0)
    _, whole = T.train(ckpt_dir=str(work / "whole"), **kw)
    _, resumed = T.train(ckpt_dir=str(work / "resumed"), fail_at=(60,), **kw)
    ends = [ck.restore(str(work / d), None, params, state, device="cuda")
            for d in ("whole", "resumed")]
    same_end = all(torch.equal(a, b) for a, b in zip(
        tree_leaves([ends[0]["params"], ends[0]["opt_state"]]),
        tree_leaves([ends[1]["params"], ends[1]["opt_state"]])))
    out["resume"] = {
        "fail_at": 60, "resumed_from": 50,
        "losses_bitwise": resumed[:60] == whole[:60]
        and resumed[60:] == whole[50:],
        "final_checkpoint_bitwise": same_end,
        "train_equals_the_timed_loop": whole == losses}
    print(f"train (resumed) {card}: " + json.dumps(out["resume"]))
    if not (out["resume"]["losses_bitwise"] and same_end
            and len(resumed) == 130):
        fail(f"train: the resumed run differs from the uninterrupted one: "
             f"{json.dumps(out['resume'])}")
    scfg = cfg.scaled(kv_quant_bits=8)
    smodel = build(scfg)
    t0 = time.perf_counter()
    with torch.no_grad():
        qparams = quantize_model(
            smodel, params, QuantizeConfig(w_bits=4, a_bits=4,
                                           transform="cat", cat_block=32),
            calibration_batches(scfg, n_seqs=8, seq_len=64, batch=4))
    torch.cuda.synchronize()
    reqs = request_workload(scfg, 8, gen=32, seed=0)
    max_len = max(len(r["tokens"]) for r in reqs) + 32 + 8
    engine = ServeEngine(smodel, qparams, n_slots=8, max_len=max_len,
                         schedule="unified", max_batch_tokens=128,
                         page_size=16, paged_kernel=True, device="cuda")
    res, launches, summ, passes = served_passes(engine, reqs, counters)
    check_well_formed("train (served)", reqs, res, scfg.vocab)
    agree = teacher_forced_reference(smodel, qparams, reqs, res)
    out["served"] = {"ptq_s": time.perf_counter() - t0,
                     "launches": launches, "passes": passes,
                     "reference_agreement_teacher_forced": agree,
                     "card": card}
    print(f"train (served b, trained CAT W4A4) {card}: "
          + json.dumps(out["served"]))
    if agree < 0.9:
        fail(f"train: the trained CAT-W4A4 model's teacher-forced "
             f"agreement with the reference routes {agree} < 0.9")
    shutil.rmtree(work, ignore_errors=True)
    return out


# ---------------------------------------------------------- the family

FAMILY_LONG_PROMPT = 4160   # (h): 4 pages of 16 past gemma2-2b's window


def serve_family(arch, counters, card, rows, long_prompt=0, warm=True,
                 min_agreement=None, tag=None, syncs=False, extra=None,
                 layers=None):
    """One dense-family config at full width on the card: seeded random
    init and CAT-W4A4 int4-packed RTN PTQ drawn and quantized one layer
    at a time (``build_served_model``, which takes that path for these
    sizes: cat block 32, calibration 8 x 64 tokens), then (b)'s engine
    (unified, int8 paged KV, page 16, ``paged_kernel=True``, pipelined,
    the two-launch decode) on (b)'s 8 requests, and with ``long_prompt``
    a ninth whose seeded prompt has that many tokens (16 new). With
    ``warm`` a warm-up pass, then the counted pass (counters at 0 just
    before, read just after), with ``warm`` a profiled pass, then the
    synchronous loop's pass, the reference routes teacher-forced one layer
    at a time (``teacher_forced_stats``), the layer-by-layer divergence
    (``depth_divergence``) and the model cut to its first layer, served
    through the same engine and teacher-forced.

    Held: well-formed tokens, the kernel rows ``rows`` launched,
    pipelined == synchronous tokens, and, against the reference routes,
    the served path within ``NOISE_FACTOR`` of the reference's own
    response to a one-ulp rounding of its input: every layer's
    ``step_rel`` against its ``step_ulp``, and the teacher-forced logits'
    median relative distance (``route1_logit_rel``) against
    ``ulp_logit_rel``, at full depth and on the first layer alone, where
    the served token is also in the reference's top 5 at >=
    ``WITNESS_TOP5`` of the positions. With ``min_agreement``, the
    teacher-forced agreement at full depth is held at it too. With
    ``syncs``, the pipelined engine's synchronising calls in the dispatch
    half (``count_dispatch_syncs``) are counted over a pass and held at 0.
    ``extra(cfg, model, params, reqs, kw, res, out)`` runs last, on the
    quantized params. ``tag`` names the cell. The profiled pass records
    the device activity alone (``profile_serving``'s ``cpu=False``).
    ``layers`` cuts the depth to that many layers (the full config's
    first layers: the same draws). -> the record."""
    import os

    import numpy as np
    import torch

    from repro_torch.data import request_workload, token_stream
    from repro_torch.launch.engine import ServeEngine
    from repro_torch.launch.serve import build_served_model
    from repro_torch.models import build
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, model, params, mem = build_served_model(
        arch, "cat", 4, 4, 8, smoke=False, seed=0, device="cuda",
        cfg_overrides=None if layers is None else {"n_layers": layers})
    torch.cuda.synchronize()
    ptq_s = time.perf_counter() - t0
    ptq_peak = torch.cuda.max_memory_allocated()
    reqs = request_workload(cfg, 8, gen=32, seed=0)
    if long_prompt:
        reqs.append({"rid": 8, "tokens": token_stream(
            cfg.vocab, long_prompt, 1, seed=0, step=2000)[0],
            "max_new_tokens": 16})
    max_len = max(len(r["tokens"]) + r["max_new_tokens"] for r in reqs) + 8
    kw = dict(n_slots=8, max_len=max_len, schedule="unified",
              max_batch_tokens=128, page_size=16, device="cuda")
    label = f"({tag}) {cfg.name}"
    print(f"families: {label} full width ({cfg.n_layers} layers, d "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
          f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}), layerwise "
          f"PTQ on the card in {ptq_s:.1f} s, {mem['qlinear_layers']} "
          f"int4-packed linears, {mem['weight_bytes'] / 2**30:.2f} GiB, "
          f"peak {ptq_peak / 2**30:.2f} GiB", flush=True)
    os.environ.pop("REPRO_DECODE_FUSED", None)
    engine = ServeEngine(model, params, paged_kernel=True, pipeline=None,
                         **kw)
    if warm:
        engine.run(reqs)
        engine.reset()
    for fn in counters:
        fn.launches = 0
    t_warm = time.perf_counter()
    res = engine.run(reqs)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counters}
    summ = engine.summary()
    stages = {"ptq": ptq_s, "warm_up": t_warm - t0 - ptq_s}
    t_last = [time.perf_counter()]
    stages["counted"] = t_last[0] - t_warm

    def stage(name):
        now = time.perf_counter()
        stages[name] = now - t_last[0]
        t_last[0] = now
    out = {"config": label, "arch": arch, "layers": cfg.n_layers,
           "depth_cut": layers, "ptq_s": ptq_s,
           "ptq_peak_gib": ptq_peak / 2**30,
           "weight_gib": mem["weight_bytes"] / 2**30,
           "requests": len(reqs), "max_len": max_len,
           "launches": launches, "card": card,
           **{k: summ[k] for k in SERVED_KEYS if k in summ},
           "pipeline": summ["pipeline"]}
    print(f"families: {label} counted pass " + json.dumps(out), flush=True)
    if not summ["pipeline"]:
        fail(f"{label}: the pipelined loop did not run")
    for r in reqs:
        toks = np.asarray(res[r["rid"]].tokens)
        if not (len(toks) == len(r["tokens"]) + r["max_new_tokens"]
                and (0 <= toks).all() and (toks < cfg.vocab).all()):
            fail(f"{label} request {r['rid']}: malformed output {toks}")
    for name in rows:
        if launches[name] <= 0:
            fail(f"{label}: kernel {name} never launched")
    if warm:
        out["profile"] = profile_serving(engine, reqs, cpu=False)
        print(f"families: {label} profiled pass "
              + json.dumps(out["profile"]), flush=True)
        stage("profiled")
    if syncs:
        out["dispatch_syncs"] = count_dispatch_syncs(engine, reqs)
        stage("sync_count")
        print(f"families: {label} synchronising calls in the dispatch "
              f"half " + json.dumps(out["dispatch_syncs"]), flush=True)
        if out["dispatch_syncs"]["total"]:
            fail(f"{label}: {out['dispatch_syncs']['total']} synchronising "
                 f"calls in the pipelined loop's dispatch half")
    del engine
    sync = ServeEngine(model, params, paged_kernel=True, pipeline=False,
                       **kw)
    res_sync = sync.run(reqs)
    s_sync = sync.summary()
    stage("synchronous")
    out["sync"] = {k: s_sync[k] for k in ("tok_per_s", "ttft_s_mean",
                                          "itl_p50_s", "itl_p95_s")}
    del sync
    diff = [r["rid"] for r in reqs
            if not np.array_equal(res_sync[r["rid"]].tokens,
                                  res[r["rid"]].tokens)]
    out["pipelined_equals_sync"] = not diff
    if diff:
        fail(f"{label}: pipelined and synchronous tokens differ for {diff}")
    torch.cuda.empty_cache()
    tf = teacher_forced_stats(model, params, reqs, res)
    stage("teacher_forced")
    out["teacher_forced"] = tf
    out["reference_agreement_teacher_forced"] = tf["agreement"]
    print(f"families: {label} pipelined == sync: {not diff}; sync pass "
          f"{json.dumps(out['sync'])}; teacher-forced "
          + json.dumps(tf), flush=True)
    out["depth"] = depth_divergence(model, params, reqs, res)
    stage("depth")
    print(f"families: {label} depth " + json.dumps(out["depth"]),
          flush=True)
    cut = build(cfg.scaled(n_layers=1))
    cut_params = dict(params, layers=params["layers"][:1])
    engine = ServeEngine(cut, cut_params, paged_kernel=True, pipeline=None,
                         **kw)
    res_cut = engine.run(reqs)
    del engine
    out["first_layer"] = teacher_forced_stats(cut, cut_params, reqs, res_cut)
    stage("first_layer")
    print(f"families: {label} first layer alone teacher-forced "
          + json.dumps(out["first_layer"]), flush=True)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print(f"families: {label} peak {out['peak_gib']:.2f} GiB", flush=True)
    hold_family(label, out, min_agreement)
    if extra is not None:
        extra(cfg, model, params, reqs, kw, res, out)
        stage("extra")
    out["stage_s"] = stages
    print(f"families: {label} seconds by stage " + json.dumps(stages),
          flush=True)
    del params, model
    torch.cuda.empty_cache()
    return out


# (g), (h) and (j) cut in depth to keep the whole script well inside its
# time limit beside (i) and (k), which keep theirs; each cut keeps its
# fp32 layers above LAYERWISE_BYTES, so the layer-at-a-time PTQ (at 12 of
# its 24 layers (i) would fall below it and take the other PTQ path), and
# (h) keeps 14 of 26 layers, both kinds of its alternating layers
FAMILY_DEPTH_CUT = {"g": 10, "h": 14, "j": 16}
NOISE_FACTOR = 1.5   # the served path against the reference's ulp response
WITNESS_TOP5 = 0.9   # served tokens in the reference's top 5, cut model


def hold_family(label, out, min_agreement=None) -> None:
    """``serve_family``'s holds against the reference routes."""
    depth = out["depth"]
    over = [i for i, (r, u) in enumerate(zip(depth["step_rel"],
                                               depth["step_ulp"]))
            if r > NOISE_FACTOR * u]
    if over:
        fail(f"{label}: layers {over}: the served linears' error exceeds "
             f"{NOISE_FACTOR} x the reference's one-ulp response")
    for key, st in (("full depth", out["teacher_forced"]),
                    ("first layer", out["first_layer"])):
        rel, ulp = st["route1_logit_rel"]["p50"], st["ulp_logit_rel"]["p50"]
        if rel > NOISE_FACTOR * ulp:
            fail(f"{label} {key}: teacher-forced logits {rel} from the "
                 f"reference's, over {NOISE_FACTOR} x its one-ulp "
                 f"response {ulp}")
        if key != "full depth" and st["served_top5"] < WITNESS_TOP5:
            fail(f"{label} {key}: served tokens in the reference's top 5 "
                 f"at {st['served_top5']} < {WITNESS_TOP5}")
    agree = out["teacher_forced"]["agreement"]
    if min_agreement is not None and agree < min_agreement:
        fail(f"{label}: teacher-forced agreement {agree} < {min_agreement}")


def dequant_on_card(dev) -> dict:
    """The experts' per-call dequant on the card: ``quantizers.unpack_int4``
    (arithmetic shifts of the int8 byte) against the nibbles' two's-
    complement values for every byte, computed on the host in int32; and
    ``moe.dequant`` of a stacked int4-packed and an int8 QLinear against
    the reference's formulation (codes cast, times the scale cast), in
    bf16 and f32, bitwise."""
    import torch

    from repro_torch.core import transforms as T
    from repro_torch.core.qlinear import QLinear, unpacked_qweight
    from repro_torch.core.quantizers import pack_int4, unpack_int4
    from repro_torch.models import moe
    p = torch.arange(-128, 128, dtype=torch.int8).reshape(16, 16)
    pi = p.to(torch.int32)
    want = torch.stack([((pi & 0xF) ^ 8) - 8, (((pi >> 4) & 0xF) ^ 8) - 8],
                       1).reshape(32, 16).to(torch.int8)
    out = {"unpack_bytes": 256, "unpack": bool(torch.equal(
        unpack_int4(p.to(dev), 32, axis=0).cpu(), want))}
    gen = torch.Generator(device=dev).manual_seed(3)
    codes = torch.randint(-8, 8, (4, 63, 40), generator=gen, device=dev,
                          dtype=torch.int8)
    scale = torch.rand((4, 1, 40), generator=gen, device=dev)
    for name, q in (("packed", QLinear(pack_int4(codes, -2), scale,
                                        T.Identity(), w_bits=4, d_in=63)),
                    ("int8", QLinear(codes * 16, scale, T.Identity()))):
        for cd in (torch.bfloat16, torch.float32):
            ref = unpacked_qweight(q).to(cd) * q.scale.to(cd)
            out[f"dequant_{name}_{cd}"] = bool(torch.equal(
                moe.dequant(q, cd), ref))
    if not all(out[k] for k in out if k != "unpack_bytes"):
        fail(f"the experts' dequant on the card: {json.dumps(out)}")
    return out


def expert_ms(cfg, params, dev, card) -> dict:
    """The experts' device time, apart from the five kernels: layer 0's
    ``moe.moe_mlp`` (routing, dispatch, the three expert linears with
    their codes dequantized on every call, the combine) on 8 decode rows
    of bf16, and the three expert linears alone (``moe._expert_dense``)
    at the capacity 8 rows give, each by CUDA-graph replay; per decode
    step (x the layers). ``floor_ms``: the reference formulation's bytes
    per layer (the int4 codes read, the bf16 weights written and read
    back) over 3.35 TB/s."""
    import torch

    from repro_torch.models import moe
    lp = params["layers"][0]
    gen = torch.Generator(device=dev).manual_seed(7)
    cap = moe.group_capacity(cfg, 8)

    def rows(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)
    x = rows(8, 1, cfg.d_model)
    xe = rows(1, cfg.n_experts, cap, cfg.d_model)
    he = rows(1, cfg.n_experts, cap, cfg.d_ff)

    def linears():
        moe._expert_dense(lp["we_g"], xe)
        moe._expert_dense(lp["we_u"], xe)
        moe._expert_dense(lp["we_d"], he)
    with torch.no_grad():
        mlp = device_ms(lambda: moe.moe_mlp(cfg, lp, x), calls=5,
                        replays=4)
        lin = device_ms(linears, calls=5, replays=4)
    weights = 3 * cfg.n_experts * cfg.d_model * cfg.d_ff
    floor = 1e3 * weights * (0.5 + 2 + 2) / HBM_BYTES_S
    return {"capacity_at_8_rows": cap, "moe_mlp_ms": mlp,
            "expert_linears_ms": lin, "floor_ms": floor,
            "moe_mlp_ms_per_step": mlp * cfg.n_layers,
            "expert_linears_ms_per_step": lin * cfg.n_layers,
            "floor_ms_per_step": floor * cfg.n_layers, "card": card}


def moe_experts(cfg, model, params, reqs, kw, res, out) -> None:
    """(j)'s extra: the experts' device ms (``expert_ms``)."""
    import torch
    out["experts"] = expert_ms(cfg, params, torch.device("cuda"),
                               out["card"])
    print(f"families: {out['config']} experts " + json.dumps(
        out["experts"]), flush=True)


def moe_diagnostics(cfg, model, params, reqs, kw, res, out) -> None:
    """(i)'s extras on its quantized params: the experts' device ms; the
    same weights served with ``capacity_factor`` E/k, which drops no
    (token, slot) pair (a diagnostic, printed and not held: its tokens
    against the cell's, the teacher-forced stats against the reference
    routes); ``model_identity`` on that dropless model, held (a row's
    bits may not depend on the step shape); and the token shares of
    prefix-cached serving (40 shared tokens, cache on against off) and
    of speculative serving (k 4, ``build_draft_model``'s CAT-W4A8 draft,
    against the cell's counted pass), with drops and without, printed and
    not held: with drops the reference's own output depends on the
    batch."""
    import torch

    from repro_torch.data import request_workload
    from repro_torch.launch.engine import ServeEngine
    from repro_torch.launch.serve import build_draft_model
    from repro_torch.models import build
    dev = torch.device("cuda")
    moe_experts(cfg, model, params, reqs, kw, res, out)
    label = out["config"]
    dropless = build(cfg.scaled(capacity_factor=cfg.n_experts / cfg.top_k))
    engine = ServeEngine(dropless, params, paged_kernel=True, pipeline=None,
                         **kw)
    res_dl = engine.run(reqs)
    check_well_formed(f"{label} dropless", reqs, res_dl, cfg.vocab)
    summ = engine.summary()
    del engine
    diag = {"capacity_factor": dropless.cfg.capacity_factor,
            "tokens_equal_cell": token_share(reqs, res_dl, res),
            **{k: summ[k] for k in ("tok_per_s", "itl_p50_s",
                                    "ttft_s_mean")},
            "teacher_forced": teacher_forced_stats(dropless, params, reqs,
                                                   res_dl)}
    print(f"families: {label} dropless diagnostic " + json.dumps(diag),
          flush=True)
    probe = batch_shape_probe(dropless, params,
                              torch.Generator().manual_seed(1), dev,
                              parts=("model",))
    diag["batch_shape_probe"] = probe
    print(f"families: {label} dropless batch-shape probe (model) "
          + json.dumps(probe), flush=True)
    if not probe["ok"]:
        fail(f"{label} dropless: a row's bits depend on the step shape "
             f"that carried it")
    shared = request_workload(cfg, 8, gen=32, seed=0, shared_prefix=40)
    skw = dict(kw, max_len=max(len(r["tokens"]) + r["max_new_tokens"]
                               for r in shared) + 8)
    t0 = time.perf_counter()
    draft = build_draft_model(out["arch"], smoke=False, seed=0,
                              device="cuda")
    diag["draft_ptq_s"] = time.perf_counter() - t0
    shares = {}
    for name, m, base in (("drops", model, res), ("dropless", dropless,
                                                  res_dl)):
        off = ServeEngine(m, params, paged_kernel=True, **skw).run(shared)
        on_eng = ServeEngine(m, params, paged_kernel=True,
                             prefix_cache=True, **skw)
        on = on_eng.run(shared)
        spec_eng = ServeEngine(m, params, paged_kernel=True,
                               speculative_k=4, draft=draft, **kw)
        spec = spec_eng.run(reqs)
        for lbl, r_, rs in (("prefix", shared, on), ("speculative", reqs,
                                                     spec)):
            check_well_formed(f"{label} {name} {lbl}", r_, rs, cfg.vocab)
        shares[name] = {
            "prefix_cache": dict(token_share(shared, on, off), **{
                k: on_eng.summary()[k] for k in ("prefix_hits",
                                                 "prefix_hit_tokens")}),
            "speculative": dict(token_share(reqs, spec, base), **{
                k: spec_eng.summary()[k] for k in (
                    "spec_acceptance_rate", "spec_drafted_tokens")})}
        del on_eng, spec_eng
    diag["token_shares"] = shares
    out["dropless"] = diag
    print(f"families: {label} token shares (not held) " + json.dumps(
        shares), flush=True)


def prefix_and_probe(cfg, model, params, reqs, kw, res, out) -> None:
    """(k)'s extras on its quantized params: (b)'s engine with the prefix
    cache on 8 requests sharing 40 tokens, beside the same engine with the
    cache off (as (e)): held, a hit and a copy-on-write split, the pool
    drained to the trie's pages, and every token equal to the cache-off
    run's (share 1.000: the model is dense, nothing depends on the
    batch); and ``batch_shape_probe`` at the config's heads (rows 4 and 3
    on the same query rows; the whole model's logits and pools across
    step shapes), held."""
    import torch

    from repro_torch.data import request_workload
    from repro_torch.launch.engine import ServeEngine
    label = out["config"]
    shared = request_workload(cfg, 8, gen=32, seed=0, shared_prefix=40)
    skw = dict(kw, max_len=-(-(max(len(r["tokens"]) for r in shared)
                               + 32 + 8) // 16) * 16)
    off = ServeEngine(model, params, paged_kernel=True, **skw).run(shared)
    engine = ServeEngine(model, params, paged_kernel=True,
                         prefix_cache=True, **skw)
    on = engine.run(shared)
    summ = engine.summary()
    check_well_formed(f"{label} prefix", shared, on, cfg.vocab)
    rec = {"tokens_equal_cache_off": token_share(shared, on, off),
           "pool_in_use": engine.pool.in_use,
           "trie_resident": engine.prefix.resident,
           **{k: summ[k] for k in PREFIX_KEYS if k in summ}}
    del engine
    out["prefix_cache"] = rec
    print(f"families: {label} prefix cache " + json.dumps(rec), flush=True)
    if not (summ["prefix_hit_tokens"] and summ["cow_copies"]):
        fail(f"{label} prefix cache: no hit or no copy-on-write split")
    if rec["pool_in_use"] != rec["trie_resident"]:
        fail(f"{label} prefix cache: {rec['pool_in_use']} pages live after "
             f"the drain, the trie holds {rec['trie_resident']}")
    if rec["tokens_equal_cache_off"]["share"] != 1.0:
        fail(f"{label} prefix cache: tokens equal to the cache-off run's "
             f"on {json.dumps(rec['tokens_equal_cache_off'])}, not 1.000")
    heads = (cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim)
    probe = batch_shape_probe(model, params,
                              torch.Generator().manual_seed(1),
                              torch.device(kw["device"]),
                              parts=("attention", "model"), heads=heads)
    out["batch_shape_probe"] = dict(probe, heads=list(heads))
    print(f"families: {label} batch-shape probe at heads {heads} "
          + json.dumps(probe), flush=True)
    if not probe["ok"]:
        fail(f"{label}: a row's bits depend on the step shape that carried "
             f"it")


def families_phase(counters, card) -> dict:
    """(g) mistral-nemo-12b at full width (10 of its 40 layers,
    ``FAMILY_DEPTH_CUT``) through all five serving kernels; (h) gemma2-2b
    at full width (14 of 26 layers) (its windowed, softcapped
    attention on the gathered path, rows 1 and 2 for its linears) with a
    prompt past its 4096-token window; each gathered step reads the
    whole 263-page table of every row, so (h) runs its counted and
    synchronous passes only (no warm-up or profiled pass). (h), whose
    embeddings are tied, is also held at a teacher-forced agreement >=
    0.9; (g)'s untied random head has top-2 margins of ~0.15 and is not
    (``serve_family``). The moe family: (i) granite-moe-1b-a400m and (j)
    moonshot-v1-16b-a3b at full width (all 24 layers; 16 of 48,
    ``FAMILY_DEPTH_CUT``) through all five serving
    kernels (their attention linears, QKV prologue and attentions; the
    experts are batched GEMMs on codes dequantized per call, as in the
    reference), (i)'s dispatch half's synchronising calls held at 0 (the
    two run the same step code), the
    experts' device ms (``expert_ms``), and (i)'s diagnostics
    (``moe_diagnostics``). (i), whose embeddings are tied, is also held
    at a teacher-forced agreement >= 0.9, as (h); (j)'s head is untied
    and random, as (g)'s, and is not. (k) paligemma-3b's text backbone
    at full width and depth (1 KV head of 256 for 8 query heads) through
    all five serving kernels, tied, held at >= 0.9 too, with the prefix
    cache and ``batch_shape_probe`` at its heads (``prefix_and_probe``).
    """
    rows_all = [fn.__name__ for fn in counters]
    out = {"g": serve_family("mistral_nemo_12b", counters, card, rows_all,
                             tag="g", layers=FAMILY_DEPTH_CUT["g"]),
           "h": serve_family("gemma2_2b", counters, card,
                             ["fused_cat_gemv_w4", "fused_cat_matmul_w4"],
                             long_prompt=FAMILY_LONG_PROMPT, warm=False,
                             min_agreement=0.9, tag="h",
                             layers=FAMILY_DEPTH_CUT["h"])}
    out["dequant_on_card"] = dequant_on_card("cuda")
    out["i"] = serve_family("granite_moe_1b_a400m", counters, card,
                            rows_all, min_agreement=0.9, tag="i",
                            syncs=True, extra=moe_diagnostics)
    out["j"] = serve_family("moonshot_v1_16b_a3b", counters, card,
                            rows_all, tag="j", extra=moe_experts,
                            layers=FAMILY_DEPTH_CUT["j"])
    out["k"] = serve_family("paligemma_3b", counters, card, rows_all,
                            min_agreement=0.9, tag="k",
                            extra=prefix_and_probe)
    return out


def composed_plain(x, blocks, ha, hb, sign, qw, sw, act_bits, packed):
    """The composed linear through the six plain versions -> (y in x's
    dtype, codes, scales, zero points)."""
    from repro_torch.kernels import block_matmul as B
    from repro_torch.kernels import dynamic_quant as DQ
    from repro_torch.kernels import hadamard as H
    from repro_torch.kernels import quant_matmul as QM
    from repro_torch.kernels import quant_matmul_w4 as QW
    y = H.hadamard_transform_plain(B.block_diag_matmul_plain(x, blocks),
                                   ha, hb, sign)
    q, sx, zx = DQ.dynamic_quant_plain(y, act_bits)
    run = QW.quant_matmul_w4_plain if packed else QM.quant_matmul_plain
    return run(q, sx, zx, qw, sw).to(x.dtype), q, sx, zx


def composed_phase(model, params_w4, counters, card, gen):
    """The composed linear ``ops.cat_transform_matmul`` (four launches:
    block-CAT, Hadamard, dynamic quant, contraction) on every one of the
    32 serving linears of full-width catlm-60m (wqkv, wo, wgu, wd of 8
    layers), for the served CAT-W4A4 int4-packed params and a CAT-W8A4
    PTQ (int8 codes) of the same seeded model, at 8 and 128 rows of
    activations made from a seed (N(0, 1) in bf16). The counted pass runs
    every call in bf16 and in f32 with the six counters set to 0 just
    before; then each bf16 call is held against the plain composition
    (dequantized codes q - zp within one step on <= 1 % of entries — a
    one-ulp difference of a bf16 intermediate may move a code — and each
    output within its row's moved steps, sx·max(sw)·max|w| each, plus one
    bf16 unit and 1e-5 of the scale), each f32 call against
    ``ops.fused_cat_matmul`` bitwise (the same f32 transform chains, the
    same quant and the same contractions: above 8 rows both run the
    tensor-core contraction, W4 and W8), and each call is timed beside the
    fused linear (device ms). The counted pass also runs mistral-nemo-12b's
    four linears (wqkv, wo, wgu, wd) at 8 rows of f32 activations on
    seeded int4-packed weights, each held bitwise against the fused
    linear and timed beside it: its wd (K 14336) takes the code GEMV's
    streamed plan."""
    import torch

    from repro_torch.kernels import block_matmul as B
    from repro_torch.kernels import dynamic_quant as DQ
    from repro_torch.kernels import hadamard as H
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import build_served_model
    t0 = time.perf_counter()
    _, _, params_w8, _ = build_served_model(
        "catlm_60m", "cat", 8, 4, 8, smoke=False, seed=0, device="cuda")
    torch.cuda.synchronize()
    ptq8_s = time.perf_counter() - t0
    linears = []
    for bits, params in (("w4", params_w4), ("w8", params_w8)):
        served = model.make_serving_params(params, keep_packed=True)
        for li, lp in enumerate(served["layers"]):
            for name in SERVING_LINEARS:
                ql = lp[name]
                dec = ops.fused_transform_operands(ql.transform)
                if dec is None or dec[0] is None:
                    fail(f"{bits} layer {li} {name}: transform "
                         f"{type(ql.transform).__name__} has no block-CAT")
                if ql.packed != (bits == "w4"):
                    fail(f"{bits} layer {li} {name}: packed={ql.packed}")
                linears.append((bits, li, name, ql, dec))
    if len(linears) != 2 * 32:
        fail(f"composed phase found {len(linears)} linears, expected 64")
    xs = {d: torch.randn((max(COMPOSED_ROWS), d), generator=gen)
          .to(torch.bfloat16).cuda() for d in (512, 1536)}

    def call(x, ql, dec):
        return ops.cat_transform_matmul(x, *dec, ql.qweight, ql.scale,
                                        act_bits=ql.act_bits,
                                        packed_int4=ql.packed)

    # the counted pass
    for fn in counters:
        fn.launches = 0
    runs = []
    for bits, li, name, ql, dec in linears:
        for m in COMPOSED_ROWS:
            x = xs[ql.d_in if ql.packed else ql.qweight.shape[0]][:m]
            runs.append((bits, li, name, ql, dec, x, call(x, ql, dec),
                         call(x.float(), ql, dec)))
    wide = []
    for seed, (lin, d, n) in enumerate(family_linears("mistral_nemo_12b")):
        args = wide_operands(8, d, n, torch.device("cuda"), 500 + seed, True)
        wide.append((lin, d, n, args, ops.cat_transform_matmul(
            *args, act_bits=4, packed_int4=True)))
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counters}
    print("composed: counted pass launches " + json.dumps(launches))
    for fn_name, n in launches.items():
        if n <= 0:
            fail(f"kernel {fn_name} never launched in the composed phase")

    recs = []
    for bits, li, name, ql, dec, x, y16, y32 in runs:
        m, n = x.shape[0], ql.qweight.shape[1]
        want, q_p, sx_p, zx_p = composed_plain(x, *dec, ql.qweight,
                                               ql.scale, ql.act_bits,
                                               ql.packed)
        q_k, _, zx_k = DQ.dynamic_quant(H.hadamard_transform(
            B.block_diag_matmul(x, dec[0]), *dec[1:]), ql.act_bits)
        shift = ((q_k.float() - zx_k) - (q_p.float() - zx_p)).abs()
        wmax = 8.0 if ql.packed else 127.0
        step = sx_p * ql.scale.max() * wmax                 # (m, 1)
        moved = (shift > 0).sum(dim=1, keepdim=True).float()
        err16 = (y16.float() - want.float()).abs()
        tol16 = ((moved + 1) * step + 2 ** -7 * want.float().abs()
                 + 1e-5 * want.float().abs().max())
        fused32 = ops.fused_cat_matmul(x.float(), *dec, ql.qweight,
                                       ql.scale, act_bits=ql.act_bits,
                                       packed=ql.packed)
        err32 = (y32 - fused32).abs().max().item()
        rec = {"bits": bits, "layer": li, "linear": name, "m": m,
               "d": x.shape[1], "n": n,
               "bf16_max_err": err16.max().item(),
               "bf16_within_tol": bool((err16 <= tol16).all()),
               "code_shift_max": shift.max().item(),
               "code_shift_share": (shift > 0).float().mean().item(),
               "f32_vs_fused_max_err": err32, "f32_tol": 0.0,
               "composed_ms": device_ms(lambda: call(x, ql, dec)),
               "fused_ms": device_ms(lambda: ops.fused_cat_matmul(
                   x, *dec, ql.qweight, ql.scale, act_bits=ql.act_bits,
                   packed=ql.packed)),
               "card": card}
        recs.append(rec)
        if not (rec["bf16_within_tol"] and rec["code_shift_max"] <= 1
                and rec["code_shift_share"] <= 1e-2 and err32 == 0):
            fail(f"composed linear: {json.dumps(rec)}")
    wide_recs = []
    for lin, d, n, args, y in wide:
        fused = ops.fused_cat_matmul(*args, act_bits=4, packed=True)
        rec = {"arch": "mistral_nemo_12b", "linear": lin, "m": 8, "d": d,
               "n": n, "differing": int((y != fused).sum().item()),
               "f32_vs_fused_max_err": (y - fused).abs().max().item(),
               "composed_ms": device_ms(lambda: ops.cat_transform_matmul(
                   *args, act_bits=4, packed_int4=True)),
               "fused_ms": device_ms(lambda: ops.fused_cat_matmul(
                   *args, act_bits=4, packed=True)),
               "card": card}
        print("composed: " + json.dumps(rec))
        wide_recs.append(rec)
        if rec["differing"]:
            fail(f"composed linear at mistral-nemo-12b's {lin}: "
                 f"{json.dumps(rec)}")
    del wide
    summary = {}
    for bits in ("w4", "w8"):
        for m in COMPOSED_ROWS:
            sel = [r for r in recs if r["bits"] == bits and r["m"] == m]
            summary[f"{bits}_m{m}"] = {
                "calls": len(sel),
                "composed_ms_sum": sum(r["composed_ms"] for r in sel),
                "fused_ms_sum": sum(r["fused_ms"] for r in sel),
                "bf16_max_err": max(r["bf16_max_err"] for r in sel),
                "code_shift_share_max": max(r["code_shift_share"]
                                            for r in sel),
                "f32_vs_fused_max_err": max(r["f32_vs_fused_max_err"]
                                            for r in sel)}
    out = {"ptq_w8_s": ptq8_s, "launches": launches, "summary": summary,
           "calls": recs, "mistral_m8": wide_recs}
    print("composed: 32 linears x {W4, W8} x {8, 128} rows, activations "
          "from a seed " + json.dumps(summary))
    return out


# A probe of the streamed path's two halves, built against the csrc/
# headers of the package being compared (``-I``), so the same source
# times the parent's and this checkout's: the transform and quant alone
# (``wide::transform_quant`` as the decode linear's streamed kernel runs
# it, its codes into the scratch) and, where the headers still have it,
# the earlier two-stage contraction alone (this checkout's is the code
# GEMV's streamed entry, ``quant_matmul.gemv_stream``).
STREAM_PROBE_CU = r"""
#include "wide_tq.cuh"

// the launch bounds of the checkout's own streamed kernels
#ifdef REPRO_WIDE_STREAM_RING
#define PROBE_BOUNDS __launch_bounds__(ctq::kThreads, ctq::kStreamCtasPerSm)
#else
#define PROBE_BOUNDS __launch_bounds__(ctq::kThreads)
#endif

namespace {
template <typename T>
__global__ void PROBE_BOUNDS probe_transform_kernel(
    const T* x, int m, int d, const float* blocks, int bk,
    const float* sign, const float* ha, int a, const float* hb, int b,
    int bits, void* ws, int kt) {
  const wide::Regions s(ws, m, d, kt);
  const size_t ldq = ctq::wide_ldq(d, kt);
#ifdef REPRO_WIDE_STREAM_RING
  extern __shared__ float4 probe_tile[];
  wide::transform_quant(x, m, d, blocks, bk, sign, ha, a, hb, b, bits, s.y,
                        s.z, s.mm, s.q, ldq, (int)ldq, nullptr, nullptr,
                        reinterpret_cast<float*>(probe_tile));
#else
  wide::transform_quant(x, m, d, blocks, bk, sign, ha, a, hb, b, bits, s.y,
                        s.z, s.mm, s.q, ldq, (int)ldq, nullptr, nullptr);
#endif
}

#ifndef REPRO_WIDE_STREAM_RING
template <bool PACKED>
__global__ void __launch_bounds__(ctq::kThreads) probe_contract_kernel(
    const int8_t* q, size_t ldq, int m, int kt, const int8_t* w, int n,
    int d, int tc, int vw, const float* sx, const float* zx,
    const float* sw, float* out) {
  extern __shared__ float4 probe_smem[];
  char* smem = reinterpret_cast<char*>(probe_smem);
  const ctq::WideLayout lay(m, kt, PACKED, tc, false);
  const int* s_tot = reinterpret_cast<const int*>(smem + lay.tot);
  const int tiles = (n + tc - 1) / tc;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int n0 = tile * tc, cols = min(tc, n - n0);
    wide::contract_stream<PACKED>(q, ldq, m, kt, w, n, d, n0, tc, vw, lay,
                                  smem);
    for (int t = threadIdx.x; t < m * cols; t += ctq::kThreads) {
      const int r = t / cols, j = t - r * cols;
      out[(size_t)r * n + n0 + j] = contract::epilogue(
          sx[r], sw[n0 + j], s_tot[r * tc + j], zx[r], s_tot[m * tc + j]);
    }
    __syncthreads();
  }
}
#endif
}  // namespace

extern "C" int probe_transform(const void* x, int bf16, int m, int d,
                               const void* blocks, int bk, const void* sign,
                               const void* ha, int a, const void* hb, int b,
                               int bits, void* ws, int kt, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#ifdef REPRO_WIDE_STREAM_RING   // the tile, two CTAs per SM, as row 1 runs it
  const size_t smem = ctq::wide_tq_bytes(a, b, blocks != nullptr ? bk : 0);
  const int grid = ctq::kStreamCtasPerSm * ctq::device_sms();
#else
  const size_t smem = 0;
  const int grid = wide::device_sms();
#endif
  auto f = [&](auto kernel, auto xp) {
    return (int)wide::launch(kernel, grid, smem, st, xp, m, d,
                             static_cast<const float*>(blocks), bk,
                             static_cast<const float*>(sign),
                             static_cast<const float*>(ha), a,
                             static_cast<const float*>(hb), b, bits, ws, kt);
  };
  if (bf16)
    return f(probe_transform_kernel<__nv_bfloat16>,
             static_cast<const __nv_bfloat16*>(x));
  return f(probe_transform_kernel<float>, static_cast<const float*>(x));
}

extern "C" long long probe_scratch(int m, int d, int kt) {
  return (long long)ctq::WideScratch(m, d, kt).end;
}

// The earlier streamed contraction alone on its own plan: codes (m, ldq)
// with ldq = probe_ldq (zero past d); 1 where the headers no longer
// have it.
extern "C" long long probe_ldq(int m, int d, int n, int packed) {
#ifndef REPRO_WIDE_STREAM_RING
  ctq::Plan p;
  if (!ctq::wide_gemv_plan(m, d, n, 1, d, 0, packed, wide::device_sms(),
                           ctq::device_smem_optin(), 0, &p))
    return -1;
  return (long long)ctq::wide_ldq(d, p.ktile);
#else
  return -1;
#endif
}

extern "C" int probe_contract(const void* q, int m, int d, const void* w,
                              int packed, int n, const void* sx,
                              const void* zx, const void* sw, void* out,
                              void* stream) {
#ifndef REPRO_WIDE_STREAM_RING
  ctq::Plan p;
  if (!ctq::wide_gemv_plan(m, d, n, 1, d, 0, packed, wide::device_sms(),
                           ctq::device_smem_optin(), 0, &p))
    return 1;
  const size_t ldq = ctq::wide_ldq(d, p.ktile);   // the parent's plan
  const int vw = ctq::weight_vector(w, n, p.cols);
  auto kernel = packed ? probe_contract_kernel<true>
                       : probe_contract_kernel<false>;
  return (int)wide::launch(
      kernel, wide::device_sms(), (size_t)p.smem,
      static_cast<cudaStream_t>(stream), static_cast<const int8_t*>(q), ldq,
      m, p.ktile, static_cast<const int8_t*>(w), n, d, p.cols, vw,
      static_cast<const float*>(sx), static_cast<const float*>(zx),
      static_cast<const float*>(sw), static_cast<float*>(out));
#else
  return 1;
#endif
}
"""
STREAM_PROBE_SIGNATURES = {
    "probe_transform": [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                        ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p],
    "probe_scratch": [ctypes.c_int] * 3,
    "probe_ldq": [ctypes.c_int] * 4,
    "probe_contract": [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p]}


def stream_probe(tag: str):
    """``STREAM_PROBE_CU`` built with nvcc against the imported package's
    csrc/ headers into build/probe_<tag>/ -> the loaded library."""
    from repro_torch.kernels import build
    out_dir = ROOT / "build" / f"probe_{tag}"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / "probe.cu"
    cu.write_text(STREAM_PROBE_CU)
    lib_path = out_dir / "probe.so"
    res = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I",
                          str(build.CSRC), "-o", str(lib_path), str(cu)],
                         capture_output=True, text=True, timeout=600)
    if res.returncode:
        fail(f"the stream probe did not build:\n{res.stdout}{res.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    for name, sig in STREAM_PROBE_SIGNATURES.items():
        getattr(lib, name).argtypes = sig
        getattr(lib, name).restype = (ctypes.c_longlong if name in (
            "probe_scratch", "probe_ldq") else ctypes.c_int)
    return lib


def stream_split(tag: str, dev) -> list:
    """The streamed path at mistral-nemo-12b's widths, its halves apart:
    row 1 (the decode linear) at each of the four linears and row 5 (the
    prologue, QKV of 32 + 8 + 8 heads of 128) at M 8 on bf16 rows; row 2
    (the tiled linear, its stage 1 streamed) at wd, M 128; the transform
    and quant alone (``stream_probe``) at M 8 for each D, and at wd, M 128
    (row 2's streamed stage 1); and the contraction alone at each linear's
    K, N and M 8 (this checkout: the code GEMV's streamed entry, the plan
    row 1 runs; an earlier checkout: its two-stage contraction through the
    probe), bitwise against the plain contraction. Device ms by CUDA-graph
    replay. -> records."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_layer as L
    from repro_torch.kernels import fused_cat_matmul as F
    from repro_torch.kernels import quant_matmul as QM
    from repro_torch.kernels import quant_matmul_w4 as QW
    probe = stream_probe(tag)
    sms = build.sm_count(dev)
    recs = []

    def transform_ms(args, m, kt):
        x = args[0][:m].to(torch.bfloat16)
        a, b = args[2].shape[0], args[3].shape[0]
        d = x.shape[1]
        ws = torch.empty(probe.probe_scratch(m, d, kt), dtype=torch.uint8,
                         device=dev)

        def run():
            build.check(probe.probe_transform(
                build.ptr(x), 1, m, d, build.ptr(args[1]), CAT_BLOCK,
                build.ptr(args[4]), build.ptr(args[2]), a,
                build.ptr(args[3]), b, 4, build.ptr(ws), kt,
                build.stream_of(x)), "probe_transform")
        return device_ms(run)

    cfg = get_config("mistral_nemo_12b")
    for seed, (lin, d, n) in enumerate(family_linears("mistral_nemo_12b")):
        rows = 128 if lin == "wd" else 8
        args = wide_operands(rows, d, n, dev, 700 + seed, True)
        a, b = args[2].shape[0], args[3].shape[0]
        x8 = (args[0][:8].to(torch.bfloat16), *args[1:])
        plan = F.gemv_plan(8, d, n, a, b, CAT_BLOCK, True, sms)
        rec = {"kernel": "stream_split", "linear": lin, "m": 8, "d": d,
               "n": n, "plan": dataclasses.asdict(plan),
               "row1_ms": device_ms(lambda: F.fused_cat_gemv_w4(
                   *x8, act_bits=4, packed=True)),
               "transform_ms": transform_ms(args, 8, plan.ktile or 64)}
        gen = torch.Generator(device=dev).manual_seed(seed)
        qx = torch.randint(-8, 8, (8, d), generator=gen, device=dev,
                           dtype=torch.int8)
        sx = torch.rand((8, 1), generator=gen, device=dev) * 0.02 + 0.001
        zx = torch.randint(-8, 8, (8, 1), generator=gen,
                           device=dev).float()
        cargs = (qx, sx, zx, args[5], args[6])
        want = QW.quant_matmul_w4_plain(*cargs)
        if hasattr(QM, "gemv_stream"):
            run = lambda: QM.gemv_stream(*cargs, packed=True)  # noqa: E731
        else:
            ldq = probe.probe_ldq(8, d, n, 1)
            qpad = torch.zeros((8, ldq), dtype=torch.int8, device=dev)
            qpad[:, :d] = qx
            y = torch.empty((8, n), dtype=torch.float32, device=dev)

            def run():
                build.check(probe.probe_contract(
                    build.ptr(qpad), 8, d, build.ptr(args[5]), 1, n,
                    build.ptr(sx), build.ptr(zx), build.ptr(args[6]),
                    build.ptr(y), build.stream_of(qx)), "probe_contract")
                return y
        rec["contract_differing"] = int((run() != want).sum().item())
        rec["contract_ms"] = device_ms(run)
        if lin == "wd":
            xt = (args[0].to(torch.bfloat16), *args[1:])
            rec["row2_m128_ms"] = device_ms(lambda: F.fused_cat_matmul_w4(
                *xt, act_bits=4, packed=True))
            rec["transform_m128_ms"] = transform_ms(args, 128, 64)
        recs.append(rec)
        del args, cargs, want
    # row 5 at mistral-nemo-12b's QKV, B 8
    d, hd = cfg.d_model, cfg.head_dim
    n = cfg.q_dim + 2 * cfg.kv_dim
    args = wide_operands(8, d, n, dev, 800, True)
    gen = torch.Generator(device=dev).manual_seed(8)
    shape = (12, 16, cfg.n_kv_heads, hd)
    pools = [torch.zeros(shape, dtype=torch.int8, device=dev),
             torch.zeros(shape[:3] + (1,), device=dev),
             torch.zeros(shape, dtype=torch.int8, device=dev),
             torch.zeros(shape[:3] + (1,), device=dev)]
    ids = [torch.tensor(v, dtype=torch.int32, device=dev)
           for v in ([1 + i for i in range(8)],
                     [(5 * i) % 16 for i in range(8)],
                     [1000 * i + 37 for i in range(8)])]
    kw = dict(n_q=cfg.q_dim, head_dim=hd, rope_theta=float(cfg.rope_theta),
              kv_bits=8, act_bits=4, packed=True)
    xb = (args[0].to(torch.bfloat16), *args[1:])
    recs.append({"kernel": "stream_split", "linear": "qkv_prologue",
                 "m": 8, "d": d, "n": n, "row5_ms": device_ms(
                     lambda: L.decode_qkv_prologue(*xb, *pools, *ids,
                                                   **kw))})
    for rec in recs:
        print("stream split " + json.dumps(rec))
    return recs


def attention_bits(P, dev) -> dict:
    """The bits of rows 3 and 4 of the package ``P`` (its
    ``paged_attention`` module) at the edge grid's head dims 32, 64 and
    128 (``ATTENTION_EDGE_HEADS``), bf16 and f32 queries, on inputs drawn
    from one seed in one order: {case: sha1 of the outputs' bytes}, so
    two packages' outputs compare bit for bit."""
    import hashlib

    import torch
    gen = torch.Generator().manual_seed(5)
    bits = {}
    for kvh, hd, g, ps in ATTENTION_EDGE_HEADS:
        if hd not in (32, 64, 128):
            continue
        items = [(1, ps), (ps + 2, ps + 2), (0, 0), (5, 3 * ps + 5),
                 (1, 2048)]
        args, _ = attention_operands(items, ps + 5, gen, dev, False,
                                     kvh=kvh, g=g, hd=hd, ps=ps)
        dec = [args[0][:, 0].contiguous(), *args[1:6],
               (args[7][:, 0] + 1).clamp_min(0).to(torch.int32)]
        for q_dt in (torch.bfloat16, torch.float32):
            for name, out in (
                    ("ragged", P.paged_attention_ragged(
                        args[0].to(q_dt), *args[1:])),
                    ("decode", P.paged_attention_decode(
                        dec[0].to(q_dt), *dec[1:]))):
                key = f"{name} kvh {kvh} hd {hd} g {g} ps {ps} {q_dt}"
                bits[key] = hashlib.sha1(
                    out.float().cpu().numpy().tobytes()).hexdigest()
    return bits


def compare_rows(src: Path, card: str, out_dir: Path) -> None:
    """Time rows 1-5, 7, 8 and 9 of the port package under ``src`` (another
    checkout's ``src``, such as the parent commit's, or this one's) at
    this script's timed shapes, on inputs drawn from one seed in one order
    (the same for every package), through entry points both packages
    have: the decode attention (row 4) at ``DECODE_SHAPES`` and each
    length of ``DECODE_LENGTHS`` and the ragged one (row 3) at
    ``RAGGED_SHAPES`` (max error against the plain version on valid
    rows), both also at the served shapes at ``MOE_HEADS``; the tiled
    fused linear (row 2) at every main-path (D, N) and
    ``TILED_ROWS`` and the decode fused linear (row 1) at 8 rows (f32
    outputs differing from the plain version); the decode prologue (row
    5) at 8 rows; the code GEMV of rows 7 and 8 (``quant_gemv_w4``,
    ``quant_matmul``) at 8 rows of every main-path (D, N) (outputs
    differing from the plain version); the dynamic quant (row 9) at the
    composed phase's shapes (M 8 and 128, D 512 and 1536, bf16; codes,
    scales and zero points differing); and the streamed path's halves at
    mistral-nemo-12b's widths (``stream_split``); and the bits of rows 3
    and 4 at head dims 32, 64 and 128 (``attention_bits``). Run it for two
    packages in one call, in turns, for a before/after; writes
    ``chiprun_out/compare_<tag>.json`` and, for the libraries it built,
    the compiler's output ``chiprun_out/nvcc_<tag>.log``."""
    import hashlib

    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels import decode_layer as L
    from repro_torch.kernels import dynamic_quant as DQ
    from repro_torch.kernels import fused_cat_matmul as F
    from repro_torch.kernels import paged_attention as P
    from repro_torch.kernels import quant_matmul as QM
    from repro_torch.kernels import quant_matmul_w4 as QW
    t0 = time.perf_counter()
    report = build.build_all()
    recs = []
    gen = torch.Generator().manual_seed(0)
    dev = torch.device("cuda")
    for label, lens in DECODE_SHAPES:
        items = [(1, ln) for ln in lens]
        args = attention_operands(items, 1, gen, dev, True)[0][:7]
        got = P.paged_attention_decode(*args)
        want = P.paged_attention_decode_plain(*args)
        valid = args[6] > 0
        recs.append({"kernel": "paged_attention_decode", "shape": label,
                     "max_err": (got.float() - want.float()).abs()[valid]
                     .max().item(),
                     "kernel_ms": device_ms(
                         lambda: P.paged_attention_decode(*args))})
    recs += time_decode_lengths(P, gen, dev)
    recs.append({"kernel": "paged_attention", "bits": attention_bits(P,
                                                                      dev)})
    for label, items in RAGGED_SHAPES:
        args = attention_operands(items, RAGGED_Q, gen, dev, False)[0]
        got = P.paged_attention_ragged(*args)
        want = P.paged_attention_ragged_plain(*args)
        valid = args[7] >= 0
        recs.append({"kernel": "paged_attention_ragged", "shape": label,
                     "max_err": (got.float() - want.float()).abs()[valid]
                     .max().item(),
                     "kernel_ms": device_ms(
                         lambda: P.paged_attention_ragged(*args))})
    # both attentions at the moe heads (head dim 128 and 64), served
    for name, (kvh, g, hd) in MOE_HEADS.items():
        for decode, items, nq in (
                (True, [(1, ln) for ln in DECODE_SHAPES[1][1]], 1),
                (False, RAGGED_SHAPES[1][1], RAGGED_Q)):
            args = attention_operands(items, nq, gen, dev, decode, kvh=kvh,
                                      g=g, hd=hd)[0]
            run = (P.paged_attention_decode if decode
                   else P.paged_attention_ragged)
            call = args[:7] if decode else args
            recs.append({"kernel": run.__name__, "shape": f"{name}, served",
                         "heads": [kvh, g, hd], "kernel_ms": device_ms(
                             lambda: run(*call))})
    for d, n in LINEAR_SHAPES:
        for run, rows in ((F.fused_cat_matmul_w4, TILED_ROWS),
                          (F.fused_cat_gemv_w4, (8,))):
            for m in rows:
                args = fused_linear_operands(m, d, n, gen, dev)
                f32 = (args[0].float(), *args[1:])
                differing = int((run(*f32, act_bits=4)
                                 != F.fused_cat_linear_plain(*f32,
                                                             act_bits=4))
                                .sum().item())
                recs.append({"kernel": run.__name__, "m": m, "d": d,
                             "n": n, "f32_differing": differing,
                             "kernel_ms": device_ms(
                                 lambda: run(*args, act_bits=4))})
        for name, run, plain, packed in (
                ("quant_gemv_w4", QW.quant_gemv_w4,
                 QW.quant_matmul_w4_plain, True),
                ("quant_matmul", QM.quant_matmul, QM.quant_matmul_plain,
                 False)):
            args, _ = contraction_operands(8, d, n, gen, dev, packed)
            recs.append({"kernel": name, "m": 8, "d": d, "n": n,
                         "differing": int((run(*args) != plain(*args))
                                          .sum().item()),
                         "kernel_ms": device_ms(lambda: run(*args))})
    for d in (512, 1536):
        for m in COMPOSED_ROWS:
            y = torch.randn((m, d), generator=gen).to(torch.bfloat16).to(dev)
            got = DQ.dynamic_quant(y, 4)
            want = DQ.dynamic_quant_plain(y, 4)
            recs.append({"kernel": "dynamic_quant", "m": m, "d": d,
                         "differing": sum(int((g != w).sum().item())
                                          for g, w in zip(got, want)),
                         "kernel_ms": device_ms(
                             lambda: DQ.dynamic_quant(y, 4))})
    targets = [(1 + i, (5 * i) % 16, 16 * i + (5 * i) % 16)
               for i in range(6)] + [(0, 0, 0), (0, 0, 0)]
    args, pools, ids = prologue_operands(8, gen, dev, targets)
    kw = dict(n_q=512, head_dim=64, rope_theta=10000.0, kv_bits=8,
              act_bits=4, packed=True)
    recs.append({"kernel": "decode_qkv_prologue", "m": 8, "kernel_ms":
                 device_ms(lambda: L.decode_qkv_prologue(*args, *pools,
                                                         *ids, **kw))})
    tag = hashlib.sha1(str(src.resolve()).encode()).hexdigest()[:8]
    recs += stream_split(tag, dev)
    res = {"src": str(src), "card": card, "records": recs,
           "seconds": time.perf_counter() - t0}
    for rec in recs:
        print("compare " + json.dumps(rec))
    out_dir.mkdir(exist_ok=True)
    (out_dir / f"compare_{tag}.json").write_text(json.dumps(res, indent=1))
    # the compiler's statistics of the libraries built in this run (the
    # first run of a package), to set two packages' registers and spills
    # side by side
    if report:
        (out_dir / f"nvcc_{tag}.log").write_text("".join(
            f"== {name} ({r['s']:.1f} s)\n{r['log']}\n"
            for name, r in sorted(report.items())))


def serve_g(src: Path, card: str, out_dir: Path) -> None:
    """(g) mistral-nemo-12b served by the port package under ``src``
    (another checkout's ``src``, such as the parent commit's, or this
    one's), as ``serve_family`` serves it (seeded layerwise PTQ, (b)'s
    engine and 8 requests): a warm-up pass, the counted pass (tok/s, ITL,
    TTFT, launches of rows 1-5) and the profiled pass (device ms by
    kernel, busy share), without the reference's holds. Run it for two
    packages in turns within one call for a before/after end to end;
    writes ``chiprun_out/serve_g_<tag>.json``."""
    import hashlib
    import os

    import torch

    from repro_torch.data import request_workload
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_layer as L
    from repro_torch.kernels import fused_cat_matmul as F
    from repro_torch.kernels import paged_attention as P
    from repro_torch.launch.engine import ServeEngine
    from repro_torch.launch.serve import build_served_model
    build.build_all()
    counters = [F.fused_cat_gemv_w4, F.fused_cat_matmul_w4,
                P.paged_attention_ragged, P.paged_attention_decode,
                L.decode_qkv_prologue]
    cfg, model, params, _ = build_served_model(
        "mistral_nemo_12b", "cat", 4, 4, 8, smoke=False, seed=0,
        device="cuda")
    reqs = request_workload(cfg, 8, gen=32, seed=0)
    max_len = max(len(r["tokens"]) + r["max_new_tokens"] for r in reqs) + 8
    os.environ.pop("REPRO_DECODE_FUSED", None)
    engine = ServeEngine(model, params, paged_kernel=True, pipeline=None,
                         n_slots=8, max_len=max_len, schedule="unified",
                         max_batch_tokens=128, page_size=16, device="cuda")
    engine.run(reqs)
    engine.reset()
    for fn in counters:
        fn.launches = 0
    engine.run(reqs)
    torch.cuda.synchronize()
    summ = engine.summary()
    rec = {"src": str(src), "card": card,
           "launches": {fn.__name__: fn.launches for fn in counters},
           **{k: summ[k] for k in SERVED_KEYS if k in summ},
           "profile": profile_serving(engine, reqs)}
    print("serve g " + json.dumps(rec))
    tag = hashlib.sha1(str(src.resolve()).encode()).hexdigest()[:8]
    out_dir.mkdir(exist_ok=True)
    (out_dir / f"serve_g_{tag}.json").write_text(json.dumps(rec, indent=1))


# a timed record's fields in the summary line's ``shapes``
SHAPE_KEYS = ("shape", "heads", "length", "m", "d", "n", "kernel_ms",
              "plain_ms", "bound_ms", "library_ms", "max_err")


def main() -> None:
    compare = mode = None
    if sys.argv[1:2] in (["--rows-2-4"], ["--serve-g"]):
        mode = sys.argv[1]
        compare = Path(sys.argv[2]) if len(sys.argv) > 2 else SRC
    elif sys.argv[1:]:
        fail(f"unknown arguments {sys.argv[1:]}: run with none, or with "
             f"--rows-2-4 [SRC] or --serve-g [SRC]")
    src = compare or SRC
    if not (src / "repro_torch").is_dir():
        fail(f"{src / 'repro_torch'} not found: run from a checkout of the "
             f"repository")
    sys.path.insert(0, str(src))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0].strip()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if mode == "--rows-2-4":
        compare_rows(compare, card, ROOT / "chiprun_out")
        return
    if mode == "--serve-g":
        serve_g(compare, card, ROOT / "chiprun_out")
        return

    from repro_torch.kernels import build
    t0 = time.perf_counter()

    def stamp(phase):
        print(f"elapsed: {time.perf_counter() - t0:.1f} s after {phase}",
              flush=True)
    report = build.build_all((*build.SOURCES, "dq_floor"))
    print(f"build: {time.perf_counter() - t0:.1f} s for "
          f"{sorted(report)} (parallel nvcc)")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "nvcc.log").write_text("".join(
        f"== {name} ({r['s']:.1f} s)\n{r['log']}\n"
        for name, r in sorted(report.items())))

    from repro_torch.kernels import block_matmul as B
    from repro_torch.kernels import decode_layer as L
    from repro_torch.kernels import dynamic_quant as DQ
    from repro_torch.kernels import fused_cat_matmul as F
    from repro_torch.kernels import hadamard as H
    from repro_torch.kernels import paged_attention as P
    from repro_torch.kernels import quant_matmul as QM
    from repro_torch.kernels import quant_matmul_w4 as QW
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    widths = check_width_edges(gen, dev)
    results = {
        "fused_cat_gemv_w4": check_fused_linear(
            "fused_cat_gemv_w4", F.fused_cat_gemv_w4, GEMV_ROWS, card, gen,
            dev) + check_gemv_edges(gen, dev) + widths["fused_cat_gemv_w4"],
        "fused_cat_matmul_w4": check_fused_linear(
            "fused_cat_matmul_w4", F.fused_cat_matmul_w4, TILED_ROWS, card,
            gen, dev) + check_tiled_edges(gen, dev)
        + widths["fused_cat_matmul_w4"],
        # a unified step: 8 work items (q_len, length) in a 128-row query
        # block — prefill chunks, decode singletons and an empty (padding)
        # item; lengths up to 160, and as served (<= 56)
        "paged_attention_ragged": [
            rec for label, items in RAGGED_SHAPES
            for rec in check_attention(
                "paged_attention_ragged", P.paged_attention_ragged,
                P.paged_attention_ragged_plain, items, RAGGED_Q, card, gen,
                dev, decode=False, label=label)]
        + [rec for name, heads in MOE_HEADS.items()
           for rec in check_attention(
               "paged_attention_ragged", P.paged_attention_ragged,
               P.paged_attention_ragged_plain, RAGGED_SHAPES[1][1],
               RAGGED_Q, card, gen, dev, decode=False,
               label=f"{name}, {RAGGED_SHAPES[1][0]}", heads=heads)]
        + [rec for name, heads in HEADDIM_HEADS.items()
           for rec in check_attention(
               "paged_attention_ragged", P.paged_attention_ragged,
               P.paged_attention_ragged_plain, RAGGED_SHAPES[1][1],
               RAGGED_Q, card, gen, dev, decode=False,
               label=f"{name}, {RAGGED_SHAPES[1][0]}", heads=heads)]
        + check_attention(
            "paged_attention_ragged", P.paged_attention_ragged,
            P.paged_attention_ragged_plain, HEADDIM_LONG[1], RAGGED_Q, card,
            gen, dev, decode=False,
            label=f"paligemma-3b, {HEADDIM_LONG[0]}",
            heads=HEADDIM_HEADS["paligemma-3b"])
        + check_ragged_edges(gen, dev),
        "paged_attention_decode": [
            rec for label, lens in DECODE_SHAPES
            for rec in check_attention(
                "paged_attention_decode", P.paged_attention_decode,
                P.paged_attention_decode_plain, [(1, ln) for ln in lens], 1,
                card, gen, dev, decode=True, label=label)]
        + [rec for name, heads in MOE_HEADS.items()
           for rec in check_attention(
               "paged_attention_decode", P.paged_attention_decode,
               P.paged_attention_decode_plain,
               [(1, ln) for ln in DECODE_SHAPES[1][1]], 1, card, gen, dev,
               decode=True, label=f"{name}, {DECODE_SHAPES[1][0]}",
               heads=heads)]
        + [rec for name, heads in HEADDIM_HEADS.items()
           for label, lens in (DECODE_SHAPES[1],) + (
               (DECODE_SHAPES[3],) if name == "paligemma-3b" else ())
           for rec in check_attention(
               "paged_attention_decode", P.paged_attention_decode,
               P.paged_attention_decode_plain, [(1, ln) for ln in lens], 1,
               card, gen, dev, decode=True, label=f"{name}, {label}",
               heads=heads)]
        + check_decode_edges(gen, dev)
        + [dict(rec, plan=dataclasses.asdict(P.decode_plan(
            8, 4, 2, 64, 16, -(-rec["length"] // 16), build.sm_count(0))))
           for rec in time_decode_lengths(P, gen, dev)],
        "decode_qkv_prologue": check_prologue(card, gen, dev)
        + check_prologue_edges(gen, dev) + widths["decode_qkv_prologue"],
        **check_contractions(card, gen, dev),
        **check_stages(card, gen, dev),
    }
    stamp("the kernels phase")
    for name, recs in check_family_widths(card, dev).items():
        results[name] += recs
    stamp("the family widths")
    counters = [F.fused_cat_gemv_w4, F.fused_cat_matmul_w4,
                P.paged_attention_ragged, P.paged_attention_decode,
                L.decode_qkv_prologue]
    serving, model, params = serve(counters, card)
    stamp("serving (a), (b)")
    serving["legacy"] = legacy_phase(model, params, counters, card)
    stamp("the legacy phase")
    serving["prefix_spec"] = prefix_spec_phase(model, params, counters,
                                               card)
    stamp("the prefix/spec phase")
    serving["train"] = train_phase(counters, card)
    stamp("the train phase")
    serving["families"] = families_phase(counters, card)
    stamp("the families phase")
    composed_counters = [QW.quant_matmul_w4, QW.quant_gemv_w4,
                         QM.quant_matmul, DQ.dynamic_quant,
                         H.hadamard_transform, B.block_diag_matmul]
    composed = composed_phase(model, params, composed_counters, card, gen)
    stamp("the composed phase")

    # the summary: the main-path shape of each kernel (decode GEMV at 8
    # rows, the 128-row unified step, wgu's D=512 x N=3072), errors over
    # every checked shape
    pick = {"fused_cat_gemv_w4": dict(m=8, d=512, n=3072),
            "paged_attention_decode": dict(shape=DECODE_SHAPES[0][0]),
            "paged_attention_ragged": dict(shape=RAGGED_SHAPES[0][0]),
            "fused_cat_matmul_w4": dict(m=128, d=512, n=3072),
            "decode_qkv_prologue": dict(m=8),
            "quant_matmul_w4": dict(m=128, d=512, n=3072),
            "quant_gemv_w4": dict(m=8, d=512, n=3072),
            "quant_matmul": dict(m=128, d=512, n=3072),
            "dynamic_quant": dict(m=128, d=512),
            "hadamard_transform": dict(m=128, d=512),
            "block_diag_matmul": dict(m=128, d=512)}
    sources = {
        "fused_cat_gemv_w4": ("src/repro_torch/csrc/fused_cat_matmul.cu",
                              "src/repro/kernels/fused_cat_matmul.py:235"),
        "fused_cat_matmul_w4": ("src/repro_torch/csrc/fused_cat_matmul.cu",
                                "src/repro/kernels/fused_cat_matmul.py:174"),
        "paged_attention_ragged": ("src/repro_torch/csrc/paged_attention.cu",
                                   "src/repro/kernels/paged_attention.py:190"),
        "paged_attention_decode": ("src/repro_torch/csrc/paged_attention.cu",
                                   "src/repro/kernels/paged_attention.py:88"),
        "decode_qkv_prologue": ("src/repro_torch/csrc/decode_layer.cu",
                                "src/repro/kernels/decode_layer.py:162"),
        "quant_matmul_w4": ("src/repro_torch/csrc/quant_matmul.cu",
                            "src/repro/kernels/quant_matmul_w4.py:72"),
        "quant_gemv_w4": ("src/repro_torch/csrc/quant_matmul.cu",
                          "src/repro/kernels/quant_matmul_w4.py:127"),
        "quant_matmul": ("src/repro_torch/csrc/quant_matmul.cu",
                         "src/repro/kernels/quant_matmul.py:42"),
        "dynamic_quant": ("src/repro_torch/csrc/dynamic_quant.cu",
                          "src/repro/kernels/dynamic_quant.py:44"),
        "hadamard_transform": ("src/repro_torch/csrc/hadamard.cu",
                               "src/repro/kernels/hadamard.py:37"),
        "block_diag_matmul": ("src/repro_torch/csrc/block_matmul.cu",
                              "src/repro/kernels/block_matmul.py:26"),
    }
    kernels = []
    for name, recs in results.items():
        rep = recs[0]
        if name in pick:
            rep = next(r for r in recs
                       if all(r.get(k) == v for k, v in pick[name].items()))
        source, replaces = sources[name]
        # rows 1-5 count serving (b)'s launches, rows 6-11 the composed
        # phase's
        launches = (serving["b"]["launches"] | composed["launches"])[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_err"] for r in recs),
            "ms": rep["kernel_ms"], "plain_ms": rep["plain_ms"],
            "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
            "library_ms": rep["library_ms"],
            # every timed shape of the kernel beside the main path's
            "shapes": [{k: r[k] for k in SHAPE_KEYS if k in r}
                       for r in recs if "kernel_ms" in r]})
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "kernels": results, "summary": kernels,
         "serving": serving, "composed": composed}, indent=1))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
