"""Quantized serving CLI — counterpart of ``repro.launch.serve``: the
paper's deployed pipeline (CAT-transformed int4-packed weights, dynamic
act quant, int8 paged KV pool) served by the unified engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch catlm_60m \
        --requests 8 --n-slots 4 --gen 32 --mixed --kv-bits 8

Runs on the CUDA device unless ``--device cpu`` is given, through the
depth-1 pipelined loop unless ``--no-pipeline`` (or ``REPRO_SYNC_STEP``)
selects the synchronous one. The reference CLI's flags are accepted;
those of later slices (legacy schedule, mesh, prefix cache, speculative
decoding) make the engine raise ``NotImplementedError``.
"""
from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.pipeline import QuantizeConfig, quantize_model
from repro_torch.core.qlinear import iter_qlinear, num_weight_bytes
from repro_torch.data import calibration_batches, make_batch, request_workload
from repro_torch.launch.engine import ServeEngine, resolve_device
from repro_torch.models import build
from repro_torch.models.layers import KV_QUANT_GROUP


def weight_memory_report(params) -> dict:
    """Quantized-weight storage accounting."""
    leaves = [l for _, l in iter_qlinear(params)]
    return {"qlinear_layers": len(leaves),
            "weight_bytes": int(sum(num_weight_bytes(l) for l in leaves)),
            "packed_int4": any(l.packed for l in leaves)}


@torch.no_grad()
def greedy_generate(model, params, prompts: torch.Tensor, gen: int,
                    max_len: int, page_size: int = 16) -> torch.Tensor:
    """prompts (B, P) -> tokens (B, P+gen): static-batch greedy decode (the
    per-request oracle for the engine) over a paged pool where row b owns
    pages 1 + b*n_ptab ... contiguously."""
    b, p = prompts.shape
    device = prompts.device
    n_ptab = -(-max_len // page_size)
    cache = dict(model.init_paged_cache(1 + b * n_ptab, page_size, device))
    cache["page_table"] = (1 + torch.arange(b * n_ptab, dtype=torch.int32,
                                            device=device)).reshape(b, n_ptab)
    cache["pos"] = 0
    logits, cache = model.prefill(params, prompts, cache)
    out = [prompts]
    for _ in range(gen):
        tok = torch.argmax(logits[:, -1:], dim=-1).to(prompts.dtype)
        out.append(tok)
        logits, cache = model.decode(params, tok, cache)
    return torch.cat(out, dim=1)


def run_steady(engine: ServeEngine, requests, passes: int = 1) -> tuple:
    """Drain the workload ``1 + passes`` times through the same engine;
    the first pass warms up (allocator, kernel builds), then the fastest
    steady pass is reported with ``summary["compile_s"] = wall_first -
    wall_best``. Every pass runs the engine's own loop (``pipeline``)."""
    engine.run(requests)
    wall_first = engine.summary()["wall_s"]
    best = None
    for _ in range(max(1, passes)):
        engine.reset()
        results = engine.run(requests)
        summary = engine.summary()
        if best is None or summary["wall_s"] < best[1]["wall_s"]:
            best = (results, summary)
    results, summary = best
    summary["compile_s"] = max(0.0, wall_first - summary["wall_s"])
    return results, summary


def build_served_model(arch: str, transform: str, w_bits: int, a_bits: int,
                       kv_bits: int, smoke: bool, seed: int,
                       cfg_overrides: Optional[dict] = None,
                       device="cuda"):
    """-> (cfg, model, params, weight-memory report): seeded torch init on
    ``device`` and, unless ``transform='fp'``, PTQ there (CAT block
    min(cfg.cat_block, 32), RTN, int4-packed at w_bits=4)."""
    device = resolve_device(device)
    cfg = get_config(arch)
    if smoke:
        cfg = cfg.smoke()
    cfg = cfg.scaled(kv_quant_bits=kv_bits, **(cfg_overrides or {}))
    model = build(cfg)
    gen = torch.Generator().manual_seed(seed)
    params = model.init(gen, device)
    mem = {}
    if transform != "fp":
        qcfg = QuantizeConfig(w_bits=w_bits, a_bits=a_bits,
                              transform=transform,
                              cat_block=min(cfg.cat_block, 32))
        calib = calibration_batches(cfg, n_seqs=8, seq_len=64, batch=4)
        params = quantize_model(model, params, qcfg, calib)
        mem = weight_memory_report(params)
    return cfg, model, params, mem


def serve_benchmark(arch: str = "catlm_60m", batch: int = 4,
                    prompt_len: int = 32, gen: int = 32,
                    transform: str = "cat", w_bits: int = 4,
                    a_bits: int = 4, smoke: bool = True, seed: int = 0,
                    kv_bits: int = 8, n_slots: int = 0,
                    n_requests: int = 0, mixed: bool = False,
                    page_size: int = 16, prefill_chunk: int = 0,
                    max_len: int = 0, schedule: str = "unified",
                    max_batch_tokens: int = 0, warmup: int = 0,
                    shared_prefix: int = 0, device="cuda",
                    pipeline: Optional[bool] = None, **later):
    """Quantize then serve a workload through the engine (see the
    reference's ``serve_benchmark``). ``pipeline`` selects the loop as
    ``ServeEngine``'s does (None: pipelined unless REPRO_SYNC_STEP is
    set). ``later`` carries options of later slices (mesh, prefix_cache,
    speculative_k) to the engine, which raises on them."""
    cfg, model, params, mem = build_served_model(
        arch, transform, w_bits, a_bits, kv_bits, smoke, seed, device=device)
    n_requests = n_requests or batch
    if mixed or shared_prefix:
        requests = request_workload(cfg, n_requests, gen=gen, seed=seed,
                                    shared_prefix=shared_prefix)
    else:
        toks = np.asarray(make_batch(cfg, prompt_len, n_requests,
                                     seed=seed)["tokens"])
        requests = [{"rid": i, "tokens": toks[i], "max_new_tokens": gen}
                    for i in range(n_requests)]
    max_prompt = max(len(r["tokens"]) for r in requests)
    engine = ServeEngine(model, params, n_slots=n_slots or batch,
                         max_len=max_len or max_prompt + gen + 8,
                         page_size=page_size, prefill_chunk=prefill_chunk,
                         schedule=schedule,
                         max_batch_tokens=max_batch_tokens, device=device,
                         pipeline=pipeline, **later)
    if warmup:
        results, summary = run_steady(engine, requests, passes=int(warmup))
    else:
        results = engine.run(requests)
        summary = engine.summary()
    out = {"arch": arch, "transform": transform, "results": results,
           "wall_s": summary["wall_s"], "tok_per_s": summary["tok_per_s"],
           "engine": summary, **mem}
    if not (mixed or shared_prefix):
        out["tokens"] = np.stack([results[i].tokens
                                  for i in range(n_requests)])
    return out


def validate_flags(ap: argparse.ArgumentParser, args) -> None:
    """Flag admissibility checks surfaced as argparse errors."""
    if args.page_size < 1:
        ap.error(f"--page-size must be >= 1 (got {args.page_size})")
    if args.kv_bits and args.page_size % KV_QUANT_GROUP:
        ap.error(f"--page-size must be a multiple of the KV quant scale "
                 f"group (got {args.page_size}, group {KV_QUANT_GROUP})")
    if args.prefill_chunk < 0:
        ap.error(f"--prefill-chunk must be >= 0 (got {args.prefill_chunk})")
    if args.shared_prefix < 0:
        ap.error(f"--shared-prefix must be >= 0 (got {args.shared_prefix})")
    if args.max_batch_tokens and args.max_batch_tokens < args.batch:
        ap.error(f"--max-batch-tokens must be >= --n-slots (got "
                 f"{args.max_batch_tokens}, slots {args.batch}; every "
                 f"running slot decodes one token per step)")
    if args.speculative < 0:
        ap.error(f"--speculative must be >= 0 (got {args.speculative})")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="catlm_60m")
    ap.add_argument("--batch", "--n-slots", dest="batch", type=int,
                    default=4, help="engine slot count")
    ap.add_argument("--requests", type=int, default=0,
                    help="queue depth (default: slot count)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--mixed", action="store_true",
                    help="mixed-prompt-length workload")
    ap.add_argument("--transform", default="cat",
                    choices=["fp", "none", "smoothquant", "hadamard", "cat"])
    ap.add_argument("--w-bits", "--bits-w", dest="w_bits", type=int,
                    default=4)
    ap.add_argument("--a-bits", "--bits-a", dest="a_bits", type=int,
                    default=4)
    ap.add_argument("--kv-bits", type=int, default=8,
                    help="KV-cache quant bits (0 = fp cache)")
    ap.add_argument("--mesh", default="",
                    help="dp,tp device mesh (a later slice of the port)")
    ap.add_argument("--paged", action="store_true",
                    help="accepted for the reference's CLI; the port always "
                         "serves from the paged pool")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="cap on per-step prefill chunks")
    ap.add_argument("--schedule", default="unified",
                    choices=["legacy", "unified"],
                    help="unified token-budget steps (legacy is a later "
                         "slice of the port)")
    ap.add_argument("--max-batch-tokens", type=int, default=0,
                    help="token budget per step (>= --n-slots)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="a later slice of the port")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="prepend this many common system-prompt tokens "
                         "to every request (implies the mixed workload)")
    ap.add_argument("--speculative", type=int, default=0, metavar="K",
                    help="a later slice of the port")
    ap.add_argument("--adaptive-spec", action="store_true",
                    help="a later slice of the port")
    ap.add_argument("--pipeline", default=None,
                    action=argparse.BooleanOptionalAction,
                    help="depth-1 asynchronous unified loop: pack + "
                         "dispatch step N+1 while N runs on device "
                         "(token-identical; default ON for --schedule "
                         "unified unless REPRO_SYNC_STEP is set); "
                         "--no-pipeline forces the synchronous loop with "
                         "blocked per-step timing spans")
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda; cpu only "
                         "when asked)")
    args = ap.parse_args(argv)
    validate_flags(ap, args)
    later = {}
    if args.mesh:
        later["mesh"] = args.mesh
    if args.prefix_cache:
        later["prefix_cache"] = True
    if args.speculative or args.adaptive_spec:
        later["speculative_k"] = args.speculative or 1
    out = serve_benchmark(arch=args.arch, batch=args.batch,
                          prompt_len=args.prompt_len, gen=args.gen,
                          transform=args.transform, w_bits=args.w_bits,
                          a_bits=args.a_bits, smoke=not args.full_config,
                          kv_bits=args.kv_bits, n_requests=args.requests,
                          mixed=args.mixed, page_size=args.page_size,
                          prefill_chunk=args.prefill_chunk,
                          schedule=args.schedule,
                          max_batch_tokens=args.max_batch_tokens,
                          shared_prefix=args.shared_prefix,
                          device=args.device, pipeline=args.pipeline,
                          **later)
    eng = out["engine"]
    pipe = (f", pipelined {eng['overlap_frac']:.0%} overlap"
            if eng["pipeline"] else ", sync")
    print(f"{out['arch']} [{out['transform']}] on {eng['device']}: "
          f"{out['tok_per_s']:.1f} tok/s ({out['wall_s']:.2f}s wall) | "
          f"{eng['n_requests']} reqs on {eng['n_slots']} slots, "
          f"ttft {eng['ttft_s_mean'] * 1e3:.0f}ms, "
          f"occupancy {eng['occupancy_mean']:.2f}, "
          f"kv={'int8' if eng['quantized_kv'] else 'fp'}, "
          f"unified[{eng['max_batch_tokens']}t budget, "
          f"itl p95 {eng['itl_p95_s'] * 1e3:.0f}ms{pipe}]")
    if out.get("qlinear_layers"):
        kind = "int4-packed" if out["packed_int4"] else "int8"
        print(f"  weights: {out['weight_bytes'] / 2**20:.2f} MiB across "
              f"{out['qlinear_layers']} quantized linears ({kind})")


if __name__ == "__main__":
    main()
