"""Mixture-of-Experts MLP — counterpart of ``repro.models.moe``: grouped,
capacity-based dispatch with the reference's routing semantics.

Tokens are cut into groups of ``GROUP_SIZE`` (the last padded with zero
rows, which are routed too, as in the reference); each group gives every
expert ``group_capacity`` slots, filled in token-major order of the
(token, slot) pairs, and a pair past its expert's capacity is dropped.
The reference builds one-hot (G, Tg, E, C) dispatch and combine masks and
contracts them; here the same routing is computed in integers (the queue
positions a cumsum of one-hot rows) and applied as gathers: each expert
slot takes its token's row (or zeros), and each token sums its kept
slots' outputs times their gates in slot order, in f32, rounded once to
the compute dtype — the function of the reference's combine contraction,
whose f32 sums add zeros to the same k products.

A row's bits do not depend on the step that carries it: the router's
logits are summed in f64 from the bf16 (or f32) products, which are
exact, so their f32 rounding does not depend on a GEMM's order (a cuBLAS
f32 GEMM changes its order with the number of rows); the top-k is a
stable sort (ties to the lower index, as ``jax.lax.top_k``); the gates'
sum and the combine add in slot order, elementwise (a reduction kernel's
order may change with the number of rows); the experts' products are one
batched GEMM per linear on the dequantized weights, as the reference's
``_expert_dense`` computes them (a bf16 batched GEMM whose rows' bits
held at every row count on the card). Static shapes
throughout: no host sync in a step. ``_constrain_ep`` (expert
parallelism over a mesh) waits for the port's tensor-parallel slice.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import qlinear
from repro_torch.core import transforms as T
from repro_torch.core.quantizers import act_spec, fake_quant
from repro_torch.models.layers import activation

GROUP_SIZE = 4096  # tokens per dispatch group


def init_layer(cfg, gen: torch.Generator) -> dict:
    """One layer's seeded f32 router (D, E) and experts we_g, we_u (E, D,
    F) and we_d (E, F, D), each N(0, 1)/sqrt(fan_in), drawn by ``gen`` on
    its device."""
    D, F, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    dev = gen.device

    def lin(*shape):
        return (torch.randn(shape, generator=gen, device=dev)
                / math.sqrt(shape[-2]))

    return {"router": lin(D, E), "we_g": lin(E, D, F),
            "we_u": lin(E, D, F), "we_d": lin(E, F, D)}


def group_capacity(cfg, group_size: int) -> int:
    c = int(cfg.capacity_factor * group_size * cfg.top_k / cfg.n_experts)
    return max(4, -(-c // 4) * 4)  # round up to a multiple of 4


def top_k(probs: torch.Tensor, k: int):
    """-> (values, indices) of the k largest entries of the last dim, in
    descending order, equal values lowest index first (as
    ``jax.lax.top_k``), on every device."""
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    return order.values[..., :k], order.indices[..., :k]


def route(cfg, xg: torch.Tensor, router: torch.Tensor):
    """The reference's routing of the groups ``xg`` (G, Tg, D): the router
    on inputs in their dtype with f32 logits, the f32 softmax, top-k, the
    gate renormalised with max(sum, 1e-9), and each (token, slot) pair's
    position in its expert's queue. -> (probs (G, Tg, E) f32, gate_w (G,
    Tg, k) f32, sel (G, Tg, k) int64, pos (G, Tg, k) int64, keep (G, Tg,
    k) bool)."""
    g, gs, _ = xg.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = group_capacity(cfg, gs)
    logits = (xg.double() @ router.to(xg.dtype).double()).float()
    probs = torch.softmax(logits, dim=-1)
    gate_w, sel = top_k(probs, k)
    total = gate_w[..., 0]
    for j in range(1, k):       # in slot order: a row's sum is its own
        total = total + gate_w[..., j]
    gate_w = gate_w / torch.clamp_min(total[..., None], 1e-9)
    experts = torch.arange(e, device=xg.device)
    sel_oh = (sel[..., None] == experts).to(torch.int32)   # (G, Tg, k, E)
    # position of each (token, slot) within its expert's per-group queue
    pos = torch.cumsum(sel_oh.reshape(g, gs * k, e), dim=1,
                       dtype=torch.int32).reshape(g, gs, k, e) - 1
    pos = (pos * sel_oh).sum(-1).to(torch.int64)
    return probs, gate_w, sel, pos, pos < cap


def moe_mlp(cfg, lp, x: torch.Tensor, taps=None, layer_idx=None):
    """x (B, S, D) -> (out (B, S, D), aux_loss scalar f32)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    gs = min(GROUP_SIZE, t)
    pad = (-t) % gs
    xf = x.reshape(t, d)
    if pad:
        xf = torch.nn.functional.pad(xf, (0, 0, 0, pad))
    g = xf.shape[0] // gs
    xg = xf.reshape(g, gs, d)
    cap = group_capacity(cfg, gs)
    cd = x.dtype
    probs, gate_w, sel, pos, keep = route(cfg, xg, lp["router"])

    # dispatch: slot sel·C + pos of each kept pair takes its token's row;
    # dropped pairs go to distinct spare columns past the E·C slots, and
    # empty slots read the zero row gs
    n_slots = e * cap
    pairs = torch.arange(gs * k, device=x.device).reshape(gs, k)
    kept_slot = sel * cap + pos
    slot = torch.where(keep, kept_slot, n_slots + pairs)
    src = torch.full((g, n_slots + gs * k), gs, dtype=torch.int64,
                     device=x.device)
    src.scatter_(1, slot.reshape(g, -1), (pairs // k).expand(g, -1, -1)
                 .reshape(g, -1))
    xz = torch.cat([xg, xg.new_zeros(g, 1, d)], dim=1)
    xe = torch.gather(xz, 1, src[:, :n_slots, None].expand(-1, -1, d))
    xe = xe.reshape(g, e, cap, d)
    _tap(taps, layer_idx, "expert_in", xe.reshape(-1, d))
    act = activation(cfg.act)
    wg, wu = lp["we_g"], lp["we_u"]
    xin = _expert_input(wg, xe)
    xin_u = xin if _same_input(wg, wu) else _expert_input(wu, xe)
    he = act(_expert_matmul(wg, xin)) * _expert_matmul(wu, xin_u)
    _tap(taps, layer_idx, "down_in", he.reshape(-1, cfg.d_ff))
    ye = _expert_dense(lp["we_d"], he)                      # (G, E, C, D)

    # combine: each token's kept slots times their gates (rounded to the
    # compute dtype, as the reference's combine mask), summed in slot
    # order in f32
    yz = torch.cat([ye.reshape(g, n_slots, d), ye.new_zeros(g, 1, d)], 1)
    idx = torch.where(keep, kept_slot, n_slots)
    yk = torch.gather(yz, 1, idx.reshape(g, gs * k, 1).expand(-1, -1, d)
                      ).reshape(g, gs, k, d)
    terms = gate_w.to(cd).float()[..., None] * yk.float()
    out = terms[:, :, 0]
    for j in range(1, k):
        out = out + terms[:, :, j]
    out = out.to(cd).reshape(g * gs, d)[:t]

    # switch load-balance aux: E · Σ_e f_e · p_e (averaged over groups);
    # f_e in the compute dtype, as the reference's dispatch mask
    experts = torch.arange(e, device=x.device)
    kept = ((sel[..., None] == experts) & keep[..., None]).sum(2)
    frac = kept.to(torch.float32).mean(dim=(0, 1)).to(cd).float()
    pmean = probs.mean(dim=(0, 1))
    aux = e * torch.sum(frac / max(float(k), 1.0) * pmean)
    return out.reshape(b, s, d), aux


def _tap(taps, layer_idx, name, x):
    if taps is not None and layer_idx is not None:
        taps.record(f"layers.{layer_idx}.{name}", x)


def _expert_dense(p, xe: torch.Tensor) -> torch.Tensor:
    """Per-expert matmul: p (E, d_in, d_out), or a QLinear of stacked
    (E, ...) leaves (transform, dynamic act fake quant, then the codes
    dequantized to the compute dtype on every call); xe (G, E, C, d_in)."""
    return _expert_matmul(p, _expert_input(p, xe))


def _expert_input(p, xe: torch.Tensor) -> torch.Tensor:
    """What an expert linear multiplies: for a QLinear xe transformed and
    fake-quantized (its act bits), in xe's dtype; else xe."""
    if not isinstance(p, qlinear.QLinear):
        return xe
    x = T.apply(p.transform, xe)
    if p.act_bits:
        x = fake_quant(x, act_spec(p.act_bits))
    return x.to(xe.dtype)


def _same_input(a, b) -> bool:
    """Whether two expert linears of one group read the same input: fp
    weights, or QLinears with the same act bits whose transforms hold the
    same tensors (the group's one transform, as the PTQ shares it) — then
    the transform and the quant run once."""
    if not isinstance(a, qlinear.QLinear):
        return not isinstance(b, qlinear.QLinear)
    if not isinstance(b, qlinear.QLinear) or a.act_bits != b.act_bits:
        return False
    ta, tb = [], []
    T.map_tensors(a.transform, lambda v: ta.append(v) or v)
    T.map_tensors(b.transform, lambda v: tb.append(v) or v)
    return (type(a.transform) is type(b.transform) and len(ta) == len(tb)
            and all(x is y for x, y in zip(ta, tb)))


def _expert_matmul(p, x: torch.Tensor) -> torch.Tensor:
    """x (G, E, C, d_in) times each expert's weights, in x's dtype."""
    w = dequant(p, x.dtype) if isinstance(p, qlinear.QLinear) \
        else p.to(x.dtype)
    return torch.einsum("gecd,edf->gecf", x, w)


def dequant(p: qlinear.QLinear, cd) -> torch.Tensor:
    """``unpacked_qweight(p).to(cd) * p.scale.to(cd)``, the same values in
    fewer passes over the weights: each code times the scale in ``cd``
    (one rounding, as the reference's product of the two casts), written
    straight into its row of the output; int4 nibbles sign-extended by
    int8 shifts."""
    scale = p.scale.to(cd)
    q = p.qweight
    if not p.packed:
        return torch.mul(q, scale)
    w = torch.empty((*q.shape[:-2], 2 * q.shape[-2], q.shape[-1]), dtype=cd,
                    device=q.device)
    lo = torch.bitwise_right_shift(torch.bitwise_left_shift(q, 4), 4)
    torch.mul(lo, scale, out=w[..., 0::2, :])
    torch.mul(torch.bitwise_right_shift(q, 4), scale, out=w[..., 1::2, :])
    return w[..., :p.d_in, :]
