"""End-to-end PTQ pipeline — counterpart of ``repro.core.pipeline`` for the
dense family:

  calibrate -> build one transform per layer group -> fuse T⁻¹ into the
  weights -> quantize weights (RTN or GPTQ, L2.4 ranges) -> QLinears
  (int4 nibble-packed at w_bits=4).

Groups follow the paper: projections sharing an input activation (q/k/v;
gate/up) share one transform. Every transform of the reference's
``QuantizeConfig`` is built: none, smoothquant, hadamard, rotation, cat
and cat_nohad. The loop order (groups outer, layers inner) matches the
reference so the shared numpy rng draws the same Hadamard signs and
rotations. ``eval_quantized`` is the paper's Table-1 metric: held-out CE
and perplexity of fp against quantized params.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from . import transforms as T
from .calibration import calibrate
from .gptq import gptq_quantize, rtn_quantize
from .qlinear import QLinear, fuse_weight_in
from .quantizers import pack_int4, weight_spec


@dataclasses.dataclass(frozen=True)
class GroupSpec:
    """One transform group inside one layer."""
    tap: str            # tap suffix, e.g. "attn_in"
    weights: tuple      # param names in a layer dict, e.g. ("wq","wk","wv")


def layer_groups(cfg) -> List[GroupSpec]:
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} PTQ is a later "
                                  f"slice of the port")
    mlp_in = ("wg", "wu") if cfg.gated_mlp else ("wu",)
    return [GroupSpec("attn_in", ("wq", "wk", "wv")),
            GroupSpec("o_in", ("wo",)),
            GroupSpec("mlp_in", mlp_in),
            GroupSpec("down_in", ("wd",))]


@dataclasses.dataclass(frozen=True)
class QuantizeConfig:
    w_bits: int = 4
    a_bits: int = 4
    w_method: str = "rtn"            # rtn | gptq
    transform: str = "cat"           # none|smoothquant|hadamard|rotation|cat|cat_nohad
    cat_block: int = 0               # 0 => cfg.cat_block
    smooth_alpha: float = 0.5
    range_p: Optional[float] = 2.4
    seed: int = 0
    pack_int4: bool = True


def _sigma_w_of(ws: List[np.ndarray]) -> np.ndarray:
    """Σ_w of a group: Σ over members of V Vᵀ for input-major V."""
    d = ws[0].shape[0]
    sw = np.zeros((d, d), np.float64)
    for v in ws:
        v2 = np.asarray(v, np.float64)
        sw += v2 @ v2.T
    return sw


def build_transform(qcfg: QuantizeConfig, cfg, stats, ws: List[np.ndarray],
                    rng: np.random.Generator, device):
    d = ws[0].shape[0]
    kind = qcfg.transform
    f32 = dict(dtype=torch.float32, device=device)
    if kind == "none":
        return T.Identity()
    if kind == "smoothquant":
        # the group's per-input-channel weight absmax
        wmax = np.max([np.abs(np.asarray(w)).max(axis=1) for w in ws],
                      axis=0)
        return T.make_smoothquant(torch.tensor(stats.absmax, **f32),
                                  torch.tensor(wmax, **f32),
                                  alpha=qcfg.smooth_alpha)
    if kind == "hadamard":
        return T.make_hadamard(d, rng, device=device)
    if kind == "rotation":
        return T.make_rotation(d, rng, device=device)
    if kind in ("cat", "cat_nohad"):
        k = qcfg.cat_block or cfg.cat_block
        sw = torch.tensor(_sigma_w_of(ws), **f32)
        sx = torch.tensor(stats.sigma, **f32)
        return T.make_cat_block(sw, sx, k=min(k, d),
                                hadamard=(kind == "cat"), rng=rng)
    raise ValueError(kind)


def _make_qlinear(codes, scale, t, qcfg: QuantizeConfig) -> QLinear:
    """Wrap quantized codes; at w_bits=4 pack two nibbles per int8 byte."""
    if qcfg.w_bits == 4 and qcfg.pack_int4:
        return QLinear(pack_int4(codes, axis=-2), scale, t,
                       act_bits=qcfg.a_bits, w_bits=4, d_in=codes.shape[-2])
    return QLinear(codes, scale, t, act_bits=qcfg.a_bits, w_bits=qcfg.w_bits)


def _quantize_weight(v: torch.Tensor, sigma_t: Optional[torch.Tensor],
                     qcfg: QuantizeConfig):
    """v (d_in, d_out) -> (codes (d_in, d_out), scale (1, d_out)); GPTQ
    takes the transformed activations' Σ, ``sigma_t`` = T Σ_x Tᵀ."""
    spec = weight_spec(qcfg.w_bits, qcfg.range_p)
    w = v.T                     # (d_out, d_in), the quantizers' convention
    if qcfg.w_method == "gptq" and sigma_t is not None:
        q, s = gptq_quantize(w, sigma_t, spec)
    else:
        q, s = rtn_quantize(w, spec)
    return q.T, s.T


@torch.no_grad()
def quantize_model(model, params, qcfg: QuantizeConfig,
                   calib_batches) -> dict:
    """A new params tree with the group linears replaced by QLinears,
    computed on the params' device."""
    if qcfg.w_method not in ("rtn", "gptq"):
        raise ValueError(f"w_method must be 'rtn' or 'gptq', got "
                         f"{qcfg.w_method!r}")
    cfg = model.cfg
    device = params["embed"].device
    taps = calibrate(model, params, calib_batches)
    rng = np.random.default_rng(qcfg.seed)
    layers = [dict(lp) for lp in params["layers"]]
    for group in layer_groups(cfg):
        for i, lp in enumerate(layers):
            stats = taps[f"layers.{i}.{group.tap}"]
            ws = [lp[name].detach().cpu().numpy() for name in group.weights]
            t = build_transform(qcfg, cfg, stats, ws, rng, device)
            sigma_t = None
            if qcfg.w_method == "gptq":
                sigma_t = T.fuse_cov(t, torch.tensor(
                    stats.sigma, dtype=torch.float32, device=device))
            for name in group.weights:
                vf = fuse_weight_in(t, lp[name].to(torch.float32))
                codes, scale = _quantize_weight(vf, sigma_t, qcfg)
                lp[name] = _make_qlinear(codes, scale, t, qcfg)
    return dict(params, layers=layers)


@torch.no_grad()
def eval_quantized(model, params, qparams, eval_batches) -> dict:
    """Held-out CE of fp against quantized params (the Table-1 metric):
    mean CE over the batches and its perplexity, for each."""
    losses_fp, losses_q = [], []
    for batch in eval_batches:
        losses_fp.append(float(model.loss(params, batch)[1]["ce"]))
        losses_q.append(float(model.loss(qparams, batch)[1]["ce"]))
    fp, q = float(np.mean(losses_fp)), float(np.mean(losses_q))
    return {"ce_fp": fp, "ce_quant": q, "delta": q - fp,
            "ppl_fp": float(np.exp(fp)), "ppl_quant": float(np.exp(q))}
