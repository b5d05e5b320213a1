"""Quantized serving CLI — counterpart of ``repro.launch.serve``: the
paper's deployed pipeline (CAT-transformed int4-packed weights, dynamic
act quant, int8 KV cache) served by the engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch catlm_60m \
        --requests 8 --n-slots 4 --gen 32 --mixed --kv-bits 8

The defaults are the reference's: the legacy schedule (prefill-on-admit,
bucketed, one batched decode per step) on the slot cache; ``--paged``
serves it from the paged pool, ``--paged-kernel`` adds the paged
attention kernels and the two-launch decode there. ``--schedule
unified`` runs the token-budget engine on the paged pool, through the
depth-1 pipelined loop unless ``--no-pipeline`` (or ``REPRO_SYNC_STEP``)
selects the synchronous one; ``--schedule unified --paged-kernel`` is
the card's fast path. ``--prefix-cache`` shares cached prompt-prefix
pages across requests (paged pool, either schedule; ``--shared-prefix S``
gives the workload an S-token common prefix to hit), ``--speculative K``
drafts K tokens per slot per cycle with ``build_draft_model``'s int4 draft
and verifies them in the unified step (``--adaptive-spec`` adapts K per
slot). Runs on the CUDA device unless ``--device cpu`` is given. The
reference CLI's flags are accepted; ``--mesh`` (a later slice) makes the
engine raise ``NotImplementedError``.
"""
from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.pipeline import (QuantizeConfig, quantize_model,
                                       quantize_model_layerwise)
from repro_torch.core.qlinear import iter_qlinear, num_weight_bytes
from repro_torch.data import calibration_batches, make_batch, request_workload
from repro_torch.launch.engine import ServeEngine, resolve_device
from repro_torch.models import build, dense
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


# fp32 layer weights above this many bytes are drawn, calibrated and
# quantized one layer at a time (mistral-nemo-12b's are 43.6 GB,
# moonshot-v1-16b-a3b's 109.5 GB)
LAYERWISE_BYTES = 4 << 30


def layer_weight_bytes(cfg) -> int:
    """The fp32 bytes of the layers' linear weights (an MoE layer's: the
    router and every expert)."""
    d, f = cfg.d_model, cfg.d_ff
    mlp = (3 if cfg.gated_mlp else 2) * d * f
    if cfg.n_experts:
        mlp = d * cfg.n_experts + 3 * cfg.n_experts * d * f
    per_layer = d * (cfg.q_dim + 2 * cfg.kv_dim) + cfg.q_dim * d + mlp
    return 4 * cfg.n_layers * per_layer


def build_served_model(arch: str, transform: str, w_bits: int, a_bits: int,
                       kv_bits: int, smoke: bool, seed: int,
                       cfg_overrides: Optional[dict] = None,
                       device="cuda"):
    """-> (cfg, model, params, weight-memory report): seeded torch init on
    ``device`` and, unless ``transform='fp'``, PTQ there (CAT block
    min(cfg.cat_block, 32), RTN, int4-packed at w_bits=4).

    A model whose fp32 layer weights exceed ``LAYERWISE_BYTES`` (the
    full-width LLMs: gemma2-2b's are 8.1 GB, mistral-nemo-12b's 43.6 GB) is
    CAT-quantized one layer at a time (``quantize_model_layerwise``; the
    CAT transforms only): its params are drawn in the order embed,
    [unembed,] layers by one generator on ``device`` (the host generator
    draws a 12B model for minutes), embed and unembed stored in the
    compute dtype they are read in, and each layer is drawn, calibrated,
    quantized and freed in turn."""
    device = resolve_device(device)
    cfg = get_config(arch)
    if smoke:
        cfg = cfg.smoke()
    cfg = cfg.scaled(kv_quant_bits=kv_bits, **(cfg_overrides or {}))
    model = build(cfg)
    qcfg = QuantizeConfig(w_bits=w_bits, a_bits=a_bits, transform=transform,
                          cat_block=min(cfg.cat_block, 32))
    calib = calibration_batches(cfg, n_seqs=8, seq_len=64, batch=4)
    if layer_weight_bytes(cfg) > LAYERWISE_BYTES:
        gen = torch.Generator(device=device).manual_seed(seed)
        rest = dense.init_rest(cfg, gen, device, dense.compute_dtype(cfg))
        params = quantize_model_layerwise(
            model, qcfg, calib, rest,
            lambda i: dense.init_layer(cfg, gen, device))
        return cfg, model, params, weight_memory_report(params)
    gen = torch.Generator().manual_seed(seed)
    params = model.init(gen, device)
    mem = {}
    if transform != "fp":
        params = quantize_model(model, params, qcfg, calib)
        mem = weight_memory_report(params)
    return cfg, model, params, mem


def build_draft_model(arch: str, smoke: bool, seed: int,
                      cfg_overrides: Optional[dict] = None,
                      a_bits: int = 8, device="cuda"):
    """The speculative-decoding draft (reference ``build_draft_model``):
    the same checkpoint as the target (same arch and seed), CAT-quantized
    to int4-packed weights at ``a_bits``, served from its own int8 KV pool
    whatever the target's cache. -> (draft_model, draft_params) for
    ``ServeEngine(draft=...)``."""
    _, model, params, _ = build_served_model(
        arch, "cat", 4, a_bits, 8, smoke, seed, cfg_overrides=cfg_overrides,
        device=device)
    return model, params


def serve_benchmark(arch: str = "catlm_60m", batch: int = 4,
                    prompt_len: int = 32, gen: int = 32,
                    transform: str = "cat", w_bits: int = 4,
                    a_bits: int = 4, smoke: bool = True, seed: int = 0,
                    kv_bits: int = 8, n_slots: int = 0,
                    n_requests: int = 0, mixed: bool = False,
                    paged: bool = False, page_size: int = 16,
                    prefill_chunk: int = 0, max_len: int = 0,
                    schedule: str = "legacy", max_batch_tokens: int = 0,
                    warmup: int = 0, prefix_cache: bool = False,
                    shared_prefix: int = 0, speculative: int = 0,
                    adaptive_spec: bool = False,
                    paged_kernel: bool = False, device="cuda",
                    pipeline: Optional[bool] = None, mesh=None):
    """Quantize then serve a workload through the engine (see the
    reference's ``serve_benchmark``): by default the legacy schedule on
    the slot cache; ``paged`` serves from the paged pool (implied by
    ``schedule="unified"``). ``prefix_cache`` shares cached prefix pages
    (pair it with ``shared_prefix=S``, an S-token common system prompt);
    ``speculative=k`` drafts k tokens per slot per cycle with
    ``build_draft_model``'s draft (unified only), ``adaptive_spec`` adapts
    k per slot; the output stays the target-only output. ``pipeline``
    selects the unified loop as ``ServeEngine``'s does (None: pipelined
    unless REPRO_SYNC_STEP is set). ``mesh`` (a later slice) makes the
    engine raise."""
    cfg, model, params, mem = build_served_model(
        arch, transform, w_bits, a_bits, kv_bits, smoke, seed, device=device)
    draft = None
    if speculative:
        draft = build_draft_model(arch, smoke, seed, device=device)
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
                         paged=paged, page_size=page_size,
                         prefill_chunk=prefill_chunk, schedule=schedule,
                         max_batch_tokens=max_batch_tokens,
                         prefix_cache=prefix_cache,
                         speculative_k=speculative, draft=draft,
                         adaptive_spec=adaptive_spec,
                         paged_kernel=paged_kernel, device=device,
                         pipeline=pipeline, mesh=mesh)
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
    """Flag admissibility checks surfaced as argparse errors (the
    reference's, for the flags the port serves)."""
    unified = args.schedule == "unified"
    if (args.page_size != 16 or args.prefill_chunk or args.paged_kernel) \
            and not (args.paged or unified):
        ap.error("--page-size/--prefill-chunk/--paged-kernel need --paged "
                 "(or --schedule unified, which serves from the paged "
                 "pool)")
    if args.page_size < 1:
        ap.error(f"--page-size must be >= 1 (got {args.page_size})")
    if args.kv_bits and args.page_size % KV_QUANT_GROUP:
        ap.error(f"--page-size must be a multiple of the KV quant scale "
                 f"group (got {args.page_size}, group {KV_QUANT_GROUP})")
    if args.prefill_chunk < 0:
        ap.error(f"--prefill-chunk must be >= 0 (got {args.prefill_chunk})")
    if args.prefill_chunk and args.prefill_chunk % args.page_size \
            and not unified:
        ap.error(f"--prefill-chunk must be a multiple of --page-size "
                 f"(got {args.prefill_chunk}, page {args.page_size}); "
                 f"legacy chunks write whole pages — only --schedule "
                 f"unified slices chunks freely")
    if args.prefix_cache and not (args.paged or unified):
        ap.error("--prefix-cache needs --paged (or --schedule unified): "
                 "cached prefixes are shared pages of the paged KV pool")
    if args.shared_prefix < 0:
        ap.error(f"--shared-prefix must be >= 0 (got {args.shared_prefix})")
    if args.max_batch_tokens and not unified:
        ap.error(f"--max-batch-tokens needs --schedule unified "
                 f"(got {args.max_batch_tokens} with --schedule "
                 f"{args.schedule})")
    if args.max_batch_tokens and args.max_batch_tokens < args.batch:
        ap.error(f"--max-batch-tokens must be >= --n-slots (got "
                 f"{args.max_batch_tokens}, slots {args.batch}; every "
                 f"running slot decodes one token per step)")
    if args.speculative < 0:
        ap.error(f"--speculative must be >= 0 (got {args.speculative})")
    if args.speculative and not unified:
        ap.error(f"--speculative needs --schedule unified (got "
                 f"--schedule {args.schedule}; the draft/verify cycle "
                 f"runs inside the token-budgeted ragged step)")
    if (args.speculative and args.max_batch_tokens
            and args.max_batch_tokens < args.batch *
            (args.speculative + 1)):
        ap.error(f"--max-batch-tokens must be >= --n-slots × "
                 f"(--speculative + 1) (got {args.max_batch_tokens}, "
                 f"need {args.batch * (args.speculative + 1)}; every "
                 f"decoding slot packs k+1 verify rows per step)")
    if args.adaptive_spec and not args.speculative:
        ap.error("--adaptive-spec needs --speculative K (it tunes the "
                 "per-slot draft depth below K)")
    if args.pipeline and not unified:
        ap.error("--pipeline needs --schedule unified (legacy "
                 "prefill-on-admit is inherently synchronous)")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="catlm_60m", choices=ARCH_IDS)
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
                    help="serve from the paged KV pool (lazy per-page "
                         "allocation) instead of the slot cache")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page (a multiple of the KV quant "
                         "scale group; needs --paged)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="feed prompts through prefill in fixed chunks of "
                         "this many tokens (a multiple of --page-size; "
                         "needs --paged); in unified mode, a cap on "
                         "per-step prefill chunks")
    ap.add_argument("--paged-kernel", action="store_true",
                    help="paged attention kernels and, on the card, the "
                         "two-launch decode (needs --paged or --schedule "
                         "unified)")
    ap.add_argument("--schedule", default="legacy",
                    choices=["legacy", "unified"],
                    help="legacy (default, the reference's): prefill on "
                         "admit + one batched decode per step; unified: "
                         "pack decode tokens + prefill chunks into one "
                         "token-budgeted ragged step per cycle (implies "
                         "the paged KV pool)")
    ap.add_argument("--max-batch-tokens", type=int, default=0,
                    help="unified-schedule token budget per step (>= "
                         "--n-slots)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="share cached prompt-prefix pages across "
                         "requests (refcounted, copy-on-write) and skip "
                         "their prefill — needs --paged or --schedule "
                         "unified")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="prepend this many common system-prompt tokens "
                         "to every request (implies the mixed workload)")
    ap.add_argument("--speculative", type=int, default=0, metavar="K",
                    help="draft K tokens per slot per cycle with the "
                         "int4-packed quantization of the same checkpoint "
                         "and verify all K+1 positions in one ragged "
                         "target step (greedy acceptance — output stays "
                         "token-identical; needs --schedule unified)")
    ap.add_argument("--adaptive-spec", action="store_true",
                    help="lower each slot's per-cycle draft depth toward "
                         "its running acceptance rate (K stays the hard "
                         "cap; needs --speculative)")
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
    out = serve_benchmark(arch=args.arch, batch=args.batch,
                          prompt_len=args.prompt_len, gen=args.gen,
                          transform=args.transform, w_bits=args.w_bits,
                          a_bits=args.a_bits, smoke=not args.full_config,
                          kv_bits=args.kv_bits, n_requests=args.requests,
                          mixed=args.mixed, paged=args.paged,
                          page_size=args.page_size,
                          prefill_chunk=args.prefill_chunk,
                          schedule=args.schedule,
                          max_batch_tokens=args.max_batch_tokens,
                          prefix_cache=args.prefix_cache,
                          shared_prefix=args.shared_prefix,
                          speculative=args.speculative,
                          adaptive_spec=args.adaptive_spec,
                          paged_kernel=args.paged_kernel,
                          device=args.device, pipeline=args.pipeline,
                          mesh=args.mesh or None)
    eng = out["engine"]
    if eng["schedule"] == "unified":
        pipe = (f", pipelined {eng['overlap_frac']:.0%} overlap"
                if eng["pipeline"] else ", sync")
        sched_note = (f", unified[{eng['max_batch_tokens']}t budget, "
                      f"itl p95 {eng['itl_p95_s'] * 1e3:.0f}ms{pipe}]")
    else:
        sched_note = (f", legacy[itl p95 {eng['itl_p95_s'] * 1e3:.0f}ms, "
                      f"{eng['dispatch_per_step']:.2f} dispatches/step]")
    spec_note = ""
    if eng.get("speculative_k"):
        adapt = ", adaptive" if eng["adaptive_spec"] else ""
        spec_note = (f", spec[k={eng['speculative_k']}{adapt}, "
                     f"{eng['spec_acceptance_rate']:.0%} accepted, "
                     f"{eng['spec_drafted_tokens']}t drafted]")
    prefix_note = ""
    if eng.get("prefix_cache"):
        prefix_note = (f", prefix[{eng['prefix_hit_rate']:.0%} hit, "
                       f"{eng['prefix_hit_tokens']}t prefill skipped, "
                       f"{eng['cow_copies']} cow]")
    kv_note = (f", paged[{eng['page_size']}t/page, "
               f"{eng['resident_kv_bytes_mean'] / 2**10:.0f}KiB "
               f"resident vs {eng['kv_capacity_bytes'] / 2**10:.0f}"
               f"KiB slot-equivalent]") if eng["paged"] else (
               f", slot[{eng['resident_kv_bytes_mean'] / 2**10:.0f}KiB "
               f"resident = capacity]")
    print(f"{out['arch']} [{out['transform']}] on {eng['device']}: "
          f"{out['tok_per_s']:.1f} tok/s ({out['wall_s']:.2f}s wall) | "
          f"{eng['n_requests']} reqs on {eng['n_slots']} slots, "
          f"ttft {eng['ttft_s_mean'] * 1e3:.0f}ms, "
          f"occupancy {eng['occupancy_mean']:.2f}, "
          f"kv={'int8' if eng['quantized_kv'] else 'fp'}"
          f"{kv_note}{spec_note}{prefix_note}{sched_note}")
    if out.get("qlinear_layers"):
        kind = "int4-packed" if out["packed_int4"] else "int8"
        print(f"  weights: {out['weight_bytes'] / 2**20:.2f} MiB across "
              f"{out['qlinear_layers']} quantized linears ({kind})")


if __name__ == "__main__":
    main()
