#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the final line):

1. device  — require ``torch.cuda.is_available()``; print the card's name
             and power limit as ``nvidia-smi`` reports them.
2. build   — compile every CUDA kernel of the serving path from
             ``src/repro_torch/csrc`` (one ``nvcc`` per source, in parallel).
3. kernels — each kernel at the serving path's shapes against its plain
             PyTorch version on the same card, with its stated tolerance,
             its time, its plain version's time and its lower bound
             (bytes over 3.35 TB/s or operations over the peak rate for
             their type, H100 SXM data sheet).
4. serving — full-width catlm-60m (8 layers, d 512, 8/4 heads, d_ff 1536,
             vocab 8192), seeded random init, CAT W4A4 int4-packed PTQ on
             the card, 8 mixed requests (32 new tokens each) through the
             unified paged engine with the kernels; every kernel must have
             launched during that run. The reference routes (route 2
             ``w_eff`` fake quant and gather attention, on the card), run
             teacher-forced over the served sequences, must predict >= 90 %
             of the served tokens. The same requests served free-running
             through the reference routes are reported too: on random
             weights one different token changes every later one, so that
             number measures divergence more than the path.

The second line from the end is the per-kernel JSON summary, the last line
``{"ok": true, "device": {...}}``. Full results also go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_S = 3.35e12       # H100 SXM, HBM3
F32_FLOP_S = 67e12          # f32 outside the tensor cores
INT8_OP_S = 1979e12         # int8 tensor-core peak (dense)

# main-path shapes: (D, N) of wqkv, wo, wgu, wd at catlm-60m's full width
LINEAR_SHAPES = [(512, 1024), (512, 512), (512, 3072), (1536, 512)]
GEMV_ROWS = (4, 8)            # decode steps run n_slots = 8 rows
TILED_ROWS = (64, 128, 256)   # the unified step packs 128 rows
CAT_BLOCK = 32                # min(cfg.cat_block, 32), as the PTQ uses


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
    every main-path (D, N) and each row count in ``rows``. Tolerance: two
    activation-code steps of the row's largest weight term (sx·sw·|q_w|),
    since f32 dot association may move a transformed value across a
    rounding boundary, plus 1e-5 of the output's scale."""
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
                   "kernel_ms": ms, "call_ms": per_call,
                   "plain_ms": plain_ms, "library_ms": None,
                   "bound_ms": b_ms, "bound_by": b_by, "card": card}
            print(json.dumps(rec))
            if not err <= tol:
                fail(f"{name} m={m} d={d} n={n}: max error {err} > {tol}")
            out.append(rec)
    return out


def attention_operands(items, nq, gen, dev, decode):
    """A pool of int8 pages (page 16, 4 KV heads, hd 64) and work items
    (q_len, length): pages distinct per item, padding rows q_pos = -1."""
    import torch
    kvh, g, hd, ps = 4, 2, 64, 16
    n_ptab = 10
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


def attention_bound(items, dims, nq):
    kvh, g, hd, ps = dims
    nbytes = flops = 0
    for ql, ln in items:
        pages = -(-ln // ps)
        nbytes += pages * ps * kvh * (2 * hd + 2 * 4)   # K, V codes + scales
        nbytes += pages * 4 + 4 + nq * 4                 # table row, len, qpos
        nbytes += ql * kvh * g * hd * 2 * 2              # q in, out
        for j in range(ql):
            horizon = ln - ql + j + 1
            flops += kvh * g * 4 * horizon * hd
    return bound(nbytes, flops / F32_FLOP_S)


def check_attention(name, run, plain, items, nq, card, gen, dev, decode):
    """Hold a paged-attention entry point against its plain version on the
    valid query rows. Tolerance: 4 bf16 ulps of the output's scale
    (1.6e-2 relative), since both round their f32 result to bf16."""
    args, dims = attention_operands(items, nq, gen, dev, decode)
    call = args[:7] if decode else args
    got = run(*call)
    want = plain(*call)
    valid = (args[7] >= 0)[:, 0] if decode else args[7] >= 0
    diff = (got.float() - want.float()).abs()[valid]
    err = diff.max().item()
    tol = 1.6e-2 * want.float()[valid].abs().max().item()
    ms, per_call = device_ms(lambda: run(*call)), call_ms(lambda: run(*call))
    plain_ms = device_ms(lambda: plain(*call))
    b_ms, b_by = attention_bound(items, dims, 1 if decode else nq)
    rec = {"kernel": name, "items": len(items), "q_block": 1 if decode
           else nq, "max_len": max(ln for _, ln in items), "max_err": err,
           "tol": tol, "kernel_ms": ms, "call_ms": per_call,
           "plain_ms": plain_ms,
           "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
           "card": card}
    print(json.dumps(rec))
    if not err <= tol:
        fail(f"{name}: max error {err} > {tol}")
    return [rec]


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
            n_tok, n_prompt = toks.shape[1], len(r["tokens"])
            n_ptab = -(-n_tok // 16)
            cache = dict(model.init_paged_cache(1 + n_ptab, 16, "cuda"))
            cache["page_table"] = (1 + torch.arange(
                n_ptab, dtype=torch.int32, device="cuda"))[None]
            cache["pos"] = 0
            hidden, _, _ = model.forward(ref_params, toks, cache=cache)
            pred = torch.argmax(model.logits(ref_params, hidden)[0], dim=-1)
            agree.append((pred[n_prompt - 1:n_tok - 1]
                          == toks[0, n_prompt:]).float().mean().item())
    return float(np.mean(agree))


def reference_run(model, params, reqs, kw):
    """Serve free-running through the reference routes on the card: route
    2 (the ``w_eff`` fake-quant matmul) and gather attention."""
    from repro_torch.launch.engine import ServeEngine
    ref_params = model.make_serving_params(params, keep_packed=False)
    with reference_routes():
        return ServeEngine(model, ref_params, fused=False,
                           paged_kernel=False, **kw).run(reqs)


def profile_serving(engine, reqs) -> dict:
    """One more drained pass under ``torch.profiler``: device time of the
    port's kernels (by CUDA kernel name) and of everything else, against
    the pass's wall time. Device time of 0 means the profiler saw no
    device activity here: reported as not measured."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    groups = {"transform_quant": "fused linear stage 1",
              "contract_gemv": "fused linear GEMV contraction",
              "contract_tiled": "fused linear tiled contraction",
              "paged_attn": "paged attention"}
    engine.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
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


def serve(counters, card):
    import numpy as np
    import torch

    from repro_torch.data import request_workload
    from repro_torch.launch.engine import ServeEngine
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

    # the main path through the kernels: a warm-up pass, then the counted
    # and timed pass
    engine = ServeEngine(model, params, paged_kernel=True, **kw)
    engine.run(reqs)
    engine.reset()
    for fn in counters:
        fn.launches = 0
    res = engine.run(reqs)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counters}
    s = engine.summary()
    out = {"tok_per_s": s["tok_per_s"], "ttft_s_mean": s["ttft_s_mean"],
           "itl_p50_s": s["itl_p50_s"], "itl_p95_s": s["itl_p95_s"],
           "device_ms_mean": s["device_ms_mean"],
           "host_ms_mean": s["host_ms_mean"], "steps": s["steps"],
           "decode_steps": s["decode_steps"],
           "generated_tokens": s["generated_tokens"],
           "wall_s": s["wall_s"], "launches": launches, "card": card}
    print("serving: " + json.dumps(out))
    out["profile"] = profile_serving(engine, reqs)
    print("serving: profiled pass " + json.dumps(out["profile"]))
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} never launched while serving")
    if s["generated_tokens"] != 8 * 32:
        fail(f"served {s['generated_tokens']} tokens, expected {8 * 32}")
    for r in reqs:
        toks = np.asarray(res[r["rid"]].tokens)
        if not (len(toks) == len(r["tokens"]) + 32
                and (0 <= toks).all() and (toks < cfg.vocab).all()):
            fail(f"request {r['rid']}: malformed output {toks}")

    # the reference routes (route 2 w_eff fake quant + gather attention):
    # teacher-forced on the served sequences (held), and free-running
    # (reported: on random weights one changed token changes every later
    # one, so free-running agreement measures divergence, not the path)
    out["reference_agreement_teacher_forced"] = teacher_forced_reference(
        model, params, reqs, res)
    out["reference_agreement_free_running"] = agreement(
        reqs, res, reference_run(model, params, reqs, kw))
    print("serving: token agreement with the reference routes " + json.dumps(
        {k: out[k] for k in ("reference_agreement_teacher_forced",
                             "reference_agreement_free_running")}))
    if out["reference_agreement_teacher_forced"] < 0.9:
        fail(f"teacher-forced agreement with the reference routes "
             f"{out['reference_agreement_teacher_forced']} < 0.9")
    return out


def main() -> None:
    if not (SRC / "repro_torch").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout of the "
             f"repository")
    sys.path.insert(0, str(SRC))
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

    from repro_torch.kernels import build
    t0 = time.perf_counter()
    report = build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for "
          f"{sorted(report)} (parallel nvcc)")

    from repro_torch.kernels import fused_cat_matmul as F
    from repro_torch.kernels import paged_attention as P
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    results = {
        "fused_cat_gemv_w4": check_fused_linear(
            "fused_cat_gemv_w4", F.fused_cat_gemv_w4, GEMV_ROWS, card, gen,
            dev),
        "fused_cat_matmul_w4": check_fused_linear(
            "fused_cat_matmul_w4", F.fused_cat_matmul_w4, TILED_ROWS, card,
            gen, dev),
        # a unified step: 8 work items (q_len, length) in a 128-row query
        # block — prefill chunks, decode singletons and an empty (padding)
        # item; lengths up to 160
        "paged_attention_ragged": check_attention(
            "paged_attention_ragged", P.paged_attention_ragged,
            P.paged_attention_ragged_plain,
            [(128, 160), (1, 97), (64, 64), (1, 33), (24, 150), (0, 0),
             (16, 40), (1, 160)], 128, card, gen, dev, decode=False),
        "paged_attention_decode": check_attention(
            "paged_attention_decode", P.paged_attention_decode,
            P.paged_attention_decode_plain,
            [(1, ln) for ln in (160, 1, 17, 64, 100, 33, 5, 128)], 1, card,
            gen, dev, decode=True),
    }
    counters = [F.fused_cat_gemv_w4, F.fused_cat_matmul_w4,
                P.paged_attention_ragged, P.paged_attention_decode]
    serving = serve(counters, card)

    # the summary: the main-path shape of each kernel (decode GEMV at 8
    # rows, the 128-row unified step, wgu's D=512 x N=3072), errors over
    # every checked shape
    pick = {"fused_cat_gemv_w4": dict(m=8, d=512, n=3072),
            "fused_cat_matmul_w4": dict(m=128, d=512, n=3072)}
    sources = {
        "fused_cat_gemv_w4": ("src/repro_torch/csrc/fused_cat_matmul.cu",
                              "src/repro/kernels/fused_cat_matmul.py:235"),
        "fused_cat_matmul_w4": ("src/repro_torch/csrc/fused_cat_matmul.cu",
                                "src/repro/kernels/fused_cat_matmul.py:174"),
        "paged_attention_ragged": ("src/repro_torch/csrc/paged_attention.cu",
                                   "src/repro/kernels/paged_attention.py:190"),
        "paged_attention_decode": ("src/repro_torch/csrc/paged_attention.cu",
                                   "src/repro/kernels/paged_attention.py:88"),
    }
    kernels = []
    for name, recs in results.items():
        rep = recs[0]
        if name in pick:
            rep = next(r for r in recs
                       if all(r[k] == v for k, v in pick[name].items()))
        source, replaces = sources[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": serving["launches"][name],
            "max_abs_err": max(r["max_err"] for r in recs),
            "ms": rep["kernel_ms"], "plain_ms": rep["plain_ms"],
            "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
            "library_ms": None})
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "kernels": results, "summary": kernels,
         "serving": serving}, indent=1))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
