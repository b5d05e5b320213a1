"""End-to-end PTQ pipeline — counterpart of ``repro.core.pipeline`` for the
dense, moe and vlm families:

  calibrate -> build one transform per layer group -> fuse T⁻¹ into the
  weights -> quantize weights (RTN or GPTQ, L2.4 ranges) -> QLinears
  (int4 nibble-packed at w_bits=4).

Groups follow the paper: projections sharing an input activation (q/k/v;
gate/up; every expert's gate/up) share one transform. An MoE layer's
expert stacks (E, d_in, d_out) are one group member each: one transform
aligns the dispatched activation with Σ_w summed over all E experts, and
every expert is fused and quantized on its own. Every transform of the
reference's ``QuantizeConfig`` is built: none, smoothquant, hadamard,
rotation, cat and cat_nohad. The loop order (groups outer, layers inner) matches the
reference so the shared numpy rng draws the same Hadamard signs and
rotations. ``eval_quantized`` is the paper's Table-1 metric: held-out CE
and perplexity of fp against quantized params.

``quantize_model_layerwise`` runs the CAT PTQ one layer at a time for a
model whose fp weights do not fit at once (mistral-nemo-12b is 49 GB in
f32): each layer is drawn, calibrated on the fp activations of the layers
before it, quantized and freed; it keeps only the k x k diagonal blocks
of Σ_x and Σ_w, the part the CAT block transform reads.
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
    if cfg.family == "moe":
        return [GroupSpec("attn_in", ("wq", "wk", "wv")),
                GroupSpec("o_in", ("wo",)),
                GroupSpec("expert_in", ("we_g", "we_u")),
                GroupSpec("down_in", ("we_d",))]
    if cfg.family not in ("dense", "vlm"):
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
    """Σ_w of a group: Σ over members of V Vᵀ for input-major V (d_in,
    d_out), over every expert of an (E, d_in, d_out) stack."""
    d = ws[0].shape[-2]
    sw = np.zeros((d, d), np.float64)
    for v in ws:
        v2 = np.asarray(v, np.float64)
        for ve in (v2 if v2.ndim == 3 else [v2]):
            sw += ve @ ve.T
    return sw


def smooth_wmax(ws: List[np.ndarray]) -> np.ndarray:
    """SmoothQuant's weight maxima of a group, by the reference's rule: a
    (d_in, d_out) member's per-input-channel absmax; an (E, d_in, d_out)
    expert stack's absmax over its experts and input channels, which is
    per output channel."""
    return np.max([np.abs(np.asarray(w, np.float64)).max(axis=(0, 1))
                   if w.ndim == 3 else np.abs(np.asarray(w)).max(axis=1)
                   for w in ws], axis=0)


def build_transform(qcfg: QuantizeConfig, cfg, stats, ws: List[np.ndarray],
                    rng: np.random.Generator, device):
    d = ws[0].shape[-2]
    kind = qcfg.transform
    f32 = dict(dtype=torch.float32, device=device)
    if kind == "none":
        return T.Identity()
    if kind == "smoothquant":
        wmax = smooth_wmax(ws)
        if wmax.shape != stats.absmax.shape:
            # the reference fails here too, on the broadcast of the two
            raise ValueError(
                f"smoothquant: weight maxima {wmax.shape} do not match the "
                f"activation's {stats.absmax.shape} (an expert stack's "
                f"maxima are per output channel, as in the reference)")
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
    takes the transformed activations' Σ, ``sigma_t`` = T Σ_x Tᵀ. An
    expert stack (E, d_in, d_out) is quantized expert by expert (RTN's
    per-channel rows in one call) -> (E, d_in, d_out), (E, 1, d_out)."""
    spec = weight_spec(qcfg.w_bits, qcfg.range_p)
    w = v.transpose(-1, -2)     # (d_out, d_in), the quantizers' convention
    if qcfg.w_method == "gptq" and sigma_t is not None:
        if v.ndim == 3:
            qs = [gptq_quantize(we, sigma_t, spec) for we in w]
            q, s = (torch.stack(t) for t in zip(*qs))
        else:
            q, s = gptq_quantize(w, sigma_t, spec)
    else:
        q, s = rtn_quantize(w, spec)
    return q.transpose(-1, -2), s.transpose(-1, -2)


def _fuse(t, v: torch.Tensor) -> torch.Tensor:
    """``fuse_weight_in`` of a (d_in, d_out) weight, or of each expert of
    an (E, d_in, d_out) stack."""
    if v.ndim == 3:
        return torch.stack([fuse_weight_in(t, ve) for ve in v])
    return fuse_weight_in(t, v)


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
                vf = _fuse(t, lp[name].to(torch.float32))
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


# ------------------------------------------------- layer-at-a-time PTQ

class BlockTaps:
    """Calibration taps keeping, per tap point, the k x k diagonal blocks
    of Σ_x = E[x xᵀ] (block ``transforms.cat_block_size(d, k)``), summed
    in f64 on the activations' device."""

    def __init__(self, k: int):
        self.k = k
        self.sums: dict = {}
        self.rows: dict = {}

    def record(self, name: str, x: torch.Tensor) -> None:
        xf = x.detach().reshape(-1, x.shape[-1]).to(torch.float64)
        d = xf.shape[1]
        k = T.cat_block_size(d, self.k)
        xb = xf.reshape(-1, d // k, k)
        s = torch.einsum("rni,rnj->nij", xb, xb)
        self.sums[name] = self.sums.get(name, 0) + s
        self.rows[name] = self.rows.get(name, 0) + xf.shape[0]

    def sigma_blocks(self, name: str) -> torch.Tensor:
        return self.sums[name] / self.rows[name]


def _weight_blocks(ws, k: int) -> torch.Tensor:
    """The k x k diagonal blocks of Σ_w = Σ V Vᵀ over a group's input-major
    weights V (d_in, d_out), summed over every expert of an (E, d_in,
    d_out) stack, in f64 on the weights' device."""
    out = 0
    for v in ws:
        if v.ndim == 3:
            e, d_in, d_out = v.shape
            vb = v.to(torch.float64).reshape(e, d_in // k, k, d_out)
            out = out + torch.einsum("enid,enjd->nij", vb, vb)
            continue
        vb = v.to(torch.float64).reshape(v.shape[0] // k, k, v.shape[1])
        out = out + torch.einsum("nid,njd->nij", vb, vb)
    return out


@torch.no_grad()
def quantize_model_layerwise(model, qcfg: QuantizeConfig, calib_batches,
                             rest: dict, draw_layer) -> dict:
    """CAT PTQ (``transform`` "cat" or "cat_nohad", RTN) of a dense or moe
    model one layer at a time: ``rest`` holds the model's other params on the
    device (embed, final_norm, unembed), ``draw_layer(i)`` returns layer
    i's fp params there, called once per layer in order. Each layer is
    calibrated on the fp activations of the layers before it (the taps of
    ``calibrate``), its groups quantized as ``quantize_model`` does, and
    its fp weights dropped. The Hadamard signs are drawn up front in
    ``quantize_model``'s order (groups outer, layers inner), so given the
    same fp params the two differ only in how Σ_x and Σ_w are summed
    (their diagonal blocks here, in f64 on the device)."""
    from repro_torch.models import dense
    cfg = model.cfg
    kind = qcfg.transform
    if kind not in ("cat", "cat_nohad") or qcfg.w_method != "rtn":
        raise ValueError(f"the layer-at-a-time PTQ takes the RTN CAT "
                         f"transforms, got {kind!r} / {qcfg.w_method!r}")
    device = rest["embed"].device
    k = qcfg.cat_block or cfg.cat_block
    in_dim = {"attn_in": cfg.d_model, "o_in": cfg.q_dim,
              "mlp_in": cfg.d_model, "expert_in": cfg.d_model,
              "down_in": cfg.d_ff}
    groups = layer_groups(cfg)
    hads = {}
    if kind == "cat":
        rng = np.random.default_rng(qcfg.seed)
        for group in groups:
            for i in range(cfg.n_layers):
                hads[group.tap, i] = T.make_hadamard(in_dim[group.tap], rng,
                                                     device=device)
    xs = []
    for batch in calib_batches:
        tokens = torch.as_tensor(np.asarray(batch["tokens"]), device=device)
        extra = batch.get("patch_embed")
        if extra is not None:
            extra = torch.as_tensor(np.asarray(extra), device=device)
        xs.append(dense.embed(cfg, rest, tokens, extra))
    layers = []
    for i in range(cfg.n_layers):
        lp = draw_layer(i)
        taps = BlockTaps(k)
        xs = [dense.layer_forward(cfg, x, lp, i, taps=taps) for x in xs]
        for group in groups:
            ws = [lp[name].to(torch.float32) for name in group.weights]
            d = ws[0].shape[-2]
            kk = T.cat_block_size(d, k)
            sx = taps.sigma_blocks(f"layers.{i}.{group.tap}")
            mt = T.cat_from_blocks(_weight_blocks(ws, kk).float(),
                                   sx.float())
            t = mt if kind == "cat_nohad" else T.Compose(
                (mt, hads[group.tap, i]))
            for name, v in zip(group.weights, ws):
                codes, scale = _quantize_weight(_fuse(t, v), None, qcfg)
                lp[name] = _make_qlinear(codes, scale, t, qcfg)
        layers.append(lp)
    return dict(rest, layers=layers)
