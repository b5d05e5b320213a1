"""Deterministic synthetic data pipeline.

Structured synthetic tokens (a mixture of Zipfian unigrams and repeated
motifs) so models trained on it exhibit non-trivial, learnable statistics
(the PTQ benchmarks need a trained model whose activations have realistic
correlations/outliers). Deterministic per (seed, step) => bit-exact
restart after failure, any host can regenerate any shard (fault tolerance
without a data service).
"""
from __future__ import annotations

import numpy as np


def _zipf_probs(vocab: int, alpha: float = 1.1) -> np.ndarray:
    r = np.arange(1, vocab + 1, dtype=np.float64)
    p = r ** (-alpha)
    return p / p.sum()


def token_stream(vocab: int, seq_len: int, batch: int, *, seed: int = 0,
                 step: int = 0, motif_len: int = 16, n_motifs: int = 64):
    """-> tokens (batch, seq_len) int32. Mixture: 60% motif copies (learnable
    structure), 40% zipf noise."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    motif_rng = np.random.default_rng(seed)  # motifs fixed across steps
    motifs = motif_rng.integers(0, vocab, size=(n_motifs, motif_len))
    probs = _zipf_probs(vocab)
    out = np.empty((batch, seq_len), dtype=np.int64)
    for b in range(batch):
        toks = []
        while sum(len(t) for t in toks) < seq_len:
            if rng.random() < 0.6:
                toks.append(motifs[rng.integers(n_motifs)])
            else:
                toks.append(rng.choice(vocab, size=motif_len, p=probs))
        out[b] = np.concatenate(toks)[:seq_len]
    return out.astype(np.int32)


def make_batch(cfg, seq_len: int, batch: int, *, seed: int = 0,
               step: int = 0) -> dict:
    """Training batch for any arch family (adds stub modality inputs)."""
    toks = token_stream(cfg.vocab, seq_len + 1, batch, seed=seed, step=step)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "encdec":
        rng = np.random.default_rng(np.random.SeedSequence([seed, step, 1]))
        out["enc_embed"] = rng.standard_normal(
            (batch, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        rng = np.random.default_rng(np.random.SeedSequence([seed, step, 2]))
        out["patch_embed"] = rng.standard_normal(
            (batch, cfg.n_patches, cfg.d_model)).astype(np.float32) * 0.02
    return out


def request_workload(cfg, n_requests: int = 8, *, gen: int = 16,
                     lengths: tuple = (8, 12, 16, 24), min_gen: int = 0,
                     seed: int = 0, shared_prefix: int = 0) -> list:
    """Mixed-prompt-length serving workload for the continuous-batching
    engine: a list of ``{"rid", "tokens" (P,) int32, "max_new_tokens"}``.

    Prompt lengths are drawn from the small ``lengths`` set (every
    distinct length costs one prefill compile in the engine); decode
    budgets are uniform in [min_gen or gen, gen]. Deterministic per
    (seed, rid): request ``rid``'s tokens do not depend on n_requests, so
    a prefix of the workload is a smaller workload.

    ``shared_prefix > 0`` prepends that many common "system prompt"
    tokens (identical across all requests, deterministic per seed) to
    every per-request suffix — the workload the paged engine's prefix
    cache deduplicates."""
    common = (token_stream(cfg.vocab, shared_prefix, 1, seed=seed,
                           step=999)[0] if shared_prefix else None)
    reqs = []
    for rid in range(n_requests):
        rng = np.random.default_rng(np.random.SeedSequence([seed, 7, rid]))
        p = int(rng.choice(lengths))
        toks = token_stream(cfg.vocab, p, 1, seed=seed, step=1000 + rid)[0]
        if common is not None:
            toks = np.concatenate([common, toks])
        g = int(rng.integers(min_gen, gen + 1)) if min_gen else gen
        reqs.append({"rid": rid, "tokens": toks, "max_new_tokens": g})
    return reqs


def calibration_batches(cfg, n_seqs: int = 16, seq_len: int = 128,
                        batch: int = 4, seed: int = 1234):
    """The paper uses 128 x 2048-token calibration sequences; smoke-scale
    defaults here, overridable."""
    for step in range(-(-n_seqs // batch)):
        yield make_batch(cfg, seq_len, batch, seed=seed, step=step)
