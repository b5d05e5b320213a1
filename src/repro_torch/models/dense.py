"""Dense decoder-only transformer — counterpart of ``repro.models.dense``
for the dense and vlm families: catlm-60m, mistral-nemo-12b, granite-34b
(MQA, ungated GELU MLP), gemma2-2b (local/global alternation, both
softcaps, sandwich norms), gemma3-12b (5:1 local/global, qk-norm), the
paligemma-3b backbone (a prefix of patch embeddings), and the MoE family
(granite-moe-1b-a400m, moonshot-v1-16b-a3b: the same skeleton with
``models.moe``'s expert MLP).

Params are a dict ``{"embed" (V, D), "final_norm" (D,), ["unembed" (D,
V),] "layers": [one dict per layer]}``; layers run as a Python loop. A
cache with a ``page_table`` is a paged KV pool ((L, n_pages,
page_size, KV, hd) tensors, updated in place); one without is a slot
cache ((L, B, max_len, KV, hd), updated in place: ``init_cache``), whose
batch row b is slot b. ``paged_kernel`` routes
single-row attention on int8 pools through the paged-attention kernels:
with a ``ragged_desc``, ``ops.step_paged_attention`` (the rows whose
logits the step reads through the decode kernel, the rest through the
ragged one), the decode one otherwise — and, where
``ops.use_fused_decode`` allows it, a pure-decode layer's attention block
through the two-launch path (``decode_qkv_prologue`` + decode attention).
As in the reference, a sliding window or an attention softcap keeps
attention on the gathered path, and qk-norm keeps the decode prologue
off.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import qlinear
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import (_paged_indices, activation,
                                       add_rms_norm, cache_update,
                                       cache_update_quantized,
                                       chunked_attention, copy_pool_pages,
                                       fake_quant_kv, gather_pages,
                                       paged_cache_update,
                                       paged_cache_update_quantized,
                                       rms_norm, rope, softcap)

def compute_dtype(cfg):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


FAMILIES = ("dense", "moe", "vlm")


def check_supported(cfg) -> None:
    """The port serves the dense, moe and vlm families; the ssm, hybrid
    and encdec families are later slices."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet "
                                  f"(the port covers the families "
                                  f"{FAMILIES})")


def is_global_flags(cfg) -> list:
    """Per layer, whether it attends globally (no sliding window): all
    layers without a window or with ``local_ratio`` 0, else every
    (local_ratio + 1)-th, after local_ratio local ones."""
    if not cfg.window or cfg.local_ratio == 0:
        return [True] * cfg.n_layers
    return [i % (cfg.local_ratio + 1) == cfg.local_ratio
            for i in range(cfg.n_layers)]


def _init_linear(gen, d_in, d_out, device="cpu"):
    return (torch.randn((d_in, d_out), generator=gen, device=device)
            / math.sqrt(d_in))


def init_layer(cfg, gen: torch.Generator, device="cpu") -> dict:
    """One layer's seeded f32 params, drawn by ``gen`` on its device, in
    the order ``init`` draws them: the MoE family's router and experts
    (``moe.init_layer``) in place of the MLP."""
    D, F = cfg.d_model, cfg.d_ff
    dev = gen.device
    lp = {"ln1": torch.zeros(D), "ln2": torch.zeros(D),
          "wq": _init_linear(gen, D, cfg.q_dim, dev),
          "wk": _init_linear(gen, D, cfg.kv_dim, dev),
          "wv": _init_linear(gen, D, cfg.kv_dim, dev),
          "wo": _init_linear(gen, cfg.q_dim, D, dev)}
    if cfg.post_norms:
        lp["ln1_post"] = torch.zeros(D)
        lp["ln2_post"] = torch.zeros(D)
    if cfg.qk_norm:
        lp["q_norm"] = torch.zeros(cfg.head_dim)
        lp["k_norm"] = torch.zeros(cfg.head_dim)
    if cfg.n_experts:
        lp.update(moe_lib.init_layer(cfg, gen))
    else:
        if cfg.gated_mlp:
            lp["wg"] = _init_linear(gen, D, F, dev)
        lp["wu"] = _init_linear(gen, D, F, dev)
        lp["wd"] = _init_linear(gen, F, D, dev)
    return {k: v.to(device) for k, v in lp.items()}


def init_rest(cfg, gen: torch.Generator, device="cpu",
              dtype=torch.float32) -> dict:
    """The params outside the layers, drawn by ``gen`` on its device in
    ``init``'s order and stored in ``dtype``: embed, final_norm and, for
    untied embeddings, unembed (its own draw, as the reference's)."""
    D, dev = cfg.d_model, gen.device
    rest = {"embed": (torch.randn((cfg.vocab, D), generator=gen, device=dev)
                      * 0.02).to(device=device, dtype=dtype),
            "final_norm": torch.zeros(D, device=device)}
    if not cfg.tie_embeddings:
        rest["unembed"] = _init_linear(gen, D, cfg.vocab, dev).to(
            device=device, dtype=dtype)
    return rest


def init(cfg, gen: torch.Generator, device="cpu") -> dict:
    """Seeded f32 params (drawn on the host generator, then moved)."""
    check_supported(cfg)
    layers = [init_layer(cfg, gen, device) for _ in range(cfg.n_layers)]
    return dict(init_rest(cfg, gen, device), layers=layers)


# ----------------------------------------------------------------- forward

def _paged_attention(cfg, q, k, v, cache_sl, page_table, pos, s,
                     paged_kernel, ragged_desc):
    """Write k/v into the paged pools and attend. Returns (o or None,
    k_att, v_att) — o is set when a paged-attention kernel ran."""
    from repro_torch.kernels import ops
    b = q.shape[0]
    if "k_scale" not in cache_sl:
        ck, cv = paged_cache_update(cache_sl["k"], cache_sl["v"], k, v,
                                    page_table, pos)
        cd = q.dtype
        return (None, gather_pages(ck, page_table).to(cd),
                gather_pages(cv, page_table).to(cd))
    ck, cks, cv, cvs = paged_cache_update_quantized(
        cache_sl["k"], cache_sl["k_scale"], cache_sl["v"],
        cache_sl["v_scale"], k, v, page_table, pos, cfg.kv_quant_bits)
    if not (paged_kernel and s == 1 and not cfg.window
            and not cfg.attn_softcap):
        return (None, (gather_pages(ck, page_table),
                       gather_pages(cks, page_table)),
                (gather_pages(cv, page_table), gather_pages(cvs, page_table)))
    kvh = ck.shape[2]
    qf = q.reshape(b, kvh, q.shape[2] // kvh, cfg.head_dim)
    if ragged_desc is not None:
        # unified step: rows whose logits are read attend through the
        # decode kernel (as a pure-decode step's rows do), the rest in
        # per-work-item query blocks through the ragged kernel
        o = ops.step_paged_attention(qf, ck, cks, cv, cvs, ragged_desc)
    else:
        if torch.is_tensor(pos) and pos.ndim:
            lengths = pos + 1
        else:
            lengths = torch.full((b,), int(pos) + 1, device=q.device)
        o = ops.paged_attention(qf, ck, cks, cv, cvs, page_table,
                                lengths.to(torch.int32))
    return o.reshape(b, 1, -1), None, None


def _attention(cfg, lp, h, cache_sl, pos, positions, page_table,
               paged_kernel, ragged_desc, is_global=True):
    """The composed attention block: QKV projection (qk-norm), RoPE, KV
    write (or fake quant without a cache) and attention (a sliding window
    on local layers, the attention softcap). -> o (B, S, Hq·hd)."""
    b, s, _ = h.shape
    if "wqkv" in lp:
        qkv = qlinear.dense(lp["wqkv"], h)
        hq, hkv = cfg.q_dim, cfg.kv_dim
        q, k, v = qkv[..., :hq], qkv[..., hq:hq + hkv], qkv[..., hq + hkv:]
    else:
        q = qlinear.dense(lp["wq"], h)
        k = qlinear.dense(lp["wk"], h)
        v = qlinear.dense(lp["wv"], h)
    q = q.reshape(b, s, -1, cfg.head_dim)
    k = k.reshape(b, s, -1, cfg.head_dim)
    v = v.reshape(b, s, -1, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, lp["q_norm"])
        k = rms_norm(k, lp["k_norm"])
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    quant_cache = (bool(cfg.kv_quant_bits) and cache_sl is not None
                   and "k_scale" in cache_sl)
    if cfg.kv_quant_bits and not quant_cache:
        k = fake_quant_kv(k, cfg.kv_quant_bits)
        v = fake_quant_kv(v, cfg.kv_quant_bits)

    o = None
    if cache_sl is not None and page_table is not None:
        o, k_att, v_att = _paged_attention(cfg, q, k, v, cache_sl,
                                           page_table, pos, s, paged_kernel,
                                           ragged_desc)
    elif cache_sl is not None and quant_cache:
        # the slot cache (reference dense.py:308): write the rows at pos,
        # attend over the slot's whole max_len rows (stale rows past each
        # slot's position are masked by the causal test)
        ck, cks, cv, cvs = cache_update_quantized(
            cache_sl["k"], cache_sl["k_scale"], cache_sl["v"],
            cache_sl["v_scale"], k, v, pos, cfg.kv_quant_bits)
        k_att, v_att = (ck, cks), (cv, cvs)
    elif cache_sl is not None:
        ck, cv = cache_update(cache_sl["k"], cache_sl["v"], k, v, pos)
        k_att, v_att = ck.to(q.dtype), cv.to(q.dtype)
    else:
        k_att, v_att = k, v
    if o is None:
        window = None
        if cfg.window:
            window = 2 ** 30 if is_global else cfg.window
        o = chunked_attention(q, k_att, v_att, q_positions=positions,
                              window=window,
                              attn_softcap=cfg.attn_softcap
                              ).reshape(b, s, -1)
    return o


def _fused_decode_operands(cfg, lp, cache_sl, s, b, ragged_desc,
                           page_table, paged_kernel, device):
    """Two-launch decode gate (the reference's ``dense.py:92``): returns
    (wqkv QLinear, (blocks, ha, hb, sign)) when this layer's attention
    block can run the QKV prologue + paged attention, else None.

    The prologue covers single-token rows (s == 1, B <= 8) on int8 paged
    pools, with a concatenated QKV QLinear with act bits whose transform
    ``fused_transform_operands`` decomposes; mixed-q_len (ragged) steps
    keep the composed path, as do layers with a sliding window, an
    attention softcap or qk-norm. ``ops.use_fused_decode`` decides the
    routing (on for CUDA devices, ``REPRO_DECODE_FUSED`` overrides)."""
    if not (paged_kernel and s == 1 and ragged_desc is None
            and page_table is not None and cache_sl is not None
            and "k_scale" in cache_sl and bool(cfg.kv_quant_bits)
            and b <= 8 and not cfg.window and not cfg.attn_softcap
            and not cfg.qk_norm):
        return None
    p = lp.get("wqkv")
    if not isinstance(p, qlinear.QLinear) or not p.act_bits:
        return None
    from repro_torch.kernels import ops
    if not ops.use_fused_decode(device):
        return None
    dec = ops.fused_transform_operands(p.transform)
    if dec is None:
        return None
    return p, dec


def _fused_decode_attn(cfg, fd, h, cache_sl, page_table, pos, b):
    """The two-launch decode attention block: the prologue (CAT -> quant
    -> W4A8 QKV GEMV -> RoPE -> int8 KV quant -> paged scatter into the
    layer's pools, in place) feeding the paged decode attention.
    Returns o (B, 1, Hq·hd) in h's dtype."""
    from repro_torch.kernels import ops
    p, (blocks, ha, hb, sign) = fd
    cd = h.dtype
    if torch.is_tensor(pos) and pos.ndim:
        pos_vec = pos.to(torch.int32)
    else:
        pos_vec = torch.full((b,), int(pos), dtype=torch.int32,
                             device=h.device)
    pids, rows = _paged_indices(page_table, pos_vec, b, 1,
                                cache_sl["k"].shape[1])
    q, ck, cks, cv, cvs = ops.decode_qkv_prologue(
        h.reshape(b, -1), blocks, ha, hb, sign, p.qweight, p.scale,
        cache_sl["k"], cache_sl["k_scale"], cache_sl["v"],
        cache_sl["v_scale"], pids, rows, pos_vec, n_q=cfg.q_dim,
        head_dim=cfg.head_dim, rope_theta=float(cfg.rope_theta),
        kv_bits=cfg.kv_quant_bits, act_bits=p.act_bits, packed=p.packed)
    kvh = ck.shape[2]
    qk = q.to(cd).reshape(b, kvh, cfg.q_dim // cfg.head_dim // kvh,
                          cfg.head_dim)
    o = ops.paged_attention(qk, ck, cks, cv, cvs, page_table, pos_vec + 1)
    return o.reshape(b, 1, -1).to(cd)


def _layer_body(cfg, x, lp, cache_sl, pos, positions, taps=None,
                layer_idx=None, page_table=None, paged_kernel=False,
                ragged_desc=None, is_global=True):
    """-> (x, aux): the layer's output and its MoE load-balance loss (0
    for a dense MLP)."""
    b, s, _ = x.shape
    h = rms_norm(x, lp["ln1"])
    _tap(taps, layer_idx, "attn_in", h)
    fd = _fused_decode_operands(cfg, lp, cache_sl, s, b, ragged_desc,
                                page_table, paged_kernel, h.device)
    if fd is not None:
        # two-launch decode: the prologue replaces the QKV projection,
        # RoPE, KV quant and scatter below; its numerics are the integer-
        # accumulation route's (the kernels'), as in the reference
        o = _fused_decode_attn(cfg, fd, h, cache_sl, page_table, pos, b)
    else:
        o = _attention(cfg, lp, h, cache_sl, pos, positions, page_table,
                       paged_kernel, ragged_desc, is_global)
    _tap(taps, layer_idx, "o_in", o)
    a = qlinear.dense(lp["wo"], o)
    if cfg.post_norms:
        a = rms_norm(a, lp["ln1_post"])
    if taps is None:
        # the reference compiles its steps (the norm takes the f32 sum);
        # it collects taps only in its eager calibration forward
        x, h2 = add_rms_norm(x, a, lp["ln2"])
    else:
        x = x + a
        h2 = rms_norm(x, lp["ln2"])
    _tap(taps, layer_idx, "mlp_in", h2)
    if cfg.n_experts:
        mlp_out, aux = moe_lib.moe_mlp(cfg, lp, h2, taps=taps,
                                       layer_idx=layer_idx)
    else:
        mlp_out, aux = _mlp(cfg, lp, h2, taps, layer_idx), torch.zeros(
            (), device=x.device)
    if cfg.post_norms:
        mlp_out = rms_norm(mlp_out, lp["ln2_post"])
    return x + mlp_out, aux


def _mlp(cfg, lp, h2, taps, layer_idx):
    """The dense MLP: act(gate) * up (or act(up)), then down."""
    if "wgu" in lp:
        gu = qlinear.dense(lp["wgu"], h2)
        f = gu.shape[-1] // 2
        hmid = _gate(cfg, gu[..., :f], gu[..., f:])
    elif cfg.gated_mlp:
        hmid = _gate(cfg, qlinear.dense(lp["wg"], h2),
                     qlinear.dense(lp["wu"], h2))
    else:
        hmid = _gate(cfg, qlinear.dense(lp["wu"], h2), None)
    _tap(taps, layer_idx, "down_in", hmid)
    return qlinear.dense(lp["wd"], hmid)


def _gate(cfg, g, u):
    """act(g) * u (u None: ungated), in the activations' dtype."""
    out = activation(cfg.act)(g)
    return out if u is None else out * u


def _tap(taps, layer_idx, name, x):
    if taps is not None and layer_idx is not None:
        taps.record(f"layers.{layer_idx}.{name}", x)


class _EmbedRows(torch.autograd.Function):
    """``embed[tokens]`` whose gradient is deterministic on the card: the
    gather's own backward adds rows into the table with atomics, in no
    fixed order; here the table's gradient is one GEMM,
    one_hot(tokens)ᵀ · grad, whose sums have a fixed order."""

    @staticmethod
    def forward(ctx, embed, tokens):
        ctx.save_for_backward(tokens)
        ctx.vocab = embed.shape[0]
        return embed[tokens]

    @staticmethod
    def backward(ctx, grad):
        (tokens,) = ctx.saved_tensors
        onehot = torch.nn.functional.one_hot(tokens.reshape(-1), ctx.vocab)
        g = grad.reshape(-1, grad.shape[-1])
        return onehot.to(g.dtype).T @ g, None


def embed_rows(embed, tokens):
    """The embedding rows of ``tokens`` (a deterministic gradient when
    ``embed`` requires one)."""
    tokens = tokens.long()
    if embed.requires_grad and torch.is_grad_enabled():
        return _EmbedRows.apply(embed, tokens)
    return embed[tokens]


def embed(cfg, params, tokens, extra_embed=None):
    """The first layer's input: the embedding rows of ``tokens`` in the
    compute dtype times sqrt(d_model), after the vlm prefix if any."""
    cd = compute_dtype(cfg)
    # a 0-dim host tensor enters a device op as a scalar: no copy, no sync
    scale = torch.tensor(math.sqrt(float(cfg.d_model)),
                         dtype=torch.float32).to(cd)
    x = embed_rows(params["embed"], tokens).to(cd) * scale
    if extra_embed is not None:
        x = torch.cat([extra_embed.to(cd), x], dim=1)
    return x


def layer_forward(cfg, x, lp, layer_idx, taps=None):
    """Layer ``layer_idx`` (params ``lp``) on x (B, S, D) without a cache,
    at positions 0..S-1, collecting ``taps`` — a calibration forward one
    layer at a time (``core.pipeline.quantize_model_layerwise``)."""
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    return _layer_body(cfg, x, lp, None, 0, positions, taps=taps,
                       layer_idx=layer_idx,
                       is_global=is_global_flags(cfg)[layer_idx])[0]


def forward(cfg, params, tokens, *, extra_embed=None, cache=None,
            taps=None, paged_kernel: bool = False, ragged_desc=None):
    """-> (hidden (B, S, D), aux_loss, cache). ``tokens`` (B, S) int;
    ``extra_embed`` (B, P, D) is prepended (the vlm prefix); with
    ``cache`` (paged pools + ``pos`` int or (B,) + ``page_table``) k/v
    are written at [pos, pos+S) before attention."""
    x = embed(cfg, params, tokens, extra_embed)
    b, s, _ = x.shape
    pos = cache["pos"] if cache is not None else 0
    steps = torch.arange(s, dtype=torch.int32, device=x.device)
    if torch.is_tensor(pos) and pos.ndim:
        positions = pos.to(torch.int32)[:, None] + steps
    else:
        positions = int(pos) + steps

    page_table = None
    pools = None
    if cache is not None:
        page_table = cache.get("page_table")
        pools = {k: v for k, v in cache.items()
                 if k not in ("pos", "page_table")}
    flags = is_global_flags(cfg)
    aux = torch.zeros((), device=x.device)
    for i, lp in enumerate(params["layers"]):
        csl = ({k: v[i] for k, v in pools.items()}
               if pools is not None else None)
        x, a = _layer_body(cfg, x, lp, csl, pos, positions, taps=taps,
                           layer_idx=i, page_table=page_table,
                           paged_kernel=paged_kernel,
                           ragged_desc=ragged_desc, is_global=flags[i])
        aux = aux + a
    new_cache = None
    if cache is not None:
        new_cache = dict(pools, pos=pos + s)
        if page_table is not None:
            new_cache["page_table"] = page_table
    x = rms_norm(x, params["final_norm"])
    return x, aux, new_cache


def logits_fn(cfg, params, hidden):
    """hidden @ unembed (the embedding's transpose when tied), softcapped.
    A tied vocabulary that is not a multiple of 8 (granite-moe-1b-a400m's
    49155) is padded with zero rows for the product and cut after it: at
    such a width a cuBLAS GEMM's bits for a row depend on how many rows
    it takes (held on the card, ``chip_smoke.model_identity``), at a
    multiple of 8 they do not."""
    if not cfg.tie_embeddings:
        return softcap(hidden @ params["unembed"].to(hidden.dtype),
                       cfg.logit_softcap)
    pad = -cfg.vocab % 8
    w = params["embed"]
    if pad:
        w = torch.nn.functional.pad(w, (0, 0, 0, pad))
    logits = hidden @ w.T.to(hidden.dtype)
    return softcap(logits[..., :cfg.vocab] if pad else logits,
                   cfg.logit_softcap)


def loss(cfg, params, batch, *, loss_chunk: int = 512):
    """Chunked CE over the sequence (reference ``dense.loss``), through
    autograd: ``batch`` holds ``tokens`` and ``labels`` (B, S) tensors or
    arrays, and for a vlm config ``patch_embed`` (B, P, D), the prefix
    whose rows the loss leaves out. -> (total loss, {"ce", "aux"}).
    Callers that only evaluate wrap it in ``torch.no_grad``."""
    from repro_torch.models.losses import chunked_ce
    device = params["embed"].device
    tokens = torch.as_tensor(batch["tokens"], device=device)
    labels = torch.as_tensor(batch["labels"], device=device)
    extra = batch.get("patch_embed") if cfg.n_patches else None
    if extra is not None:
        extra = torch.as_tensor(extra, device=device)
    hidden, aux, _ = forward(cfg, params, tokens, extra_embed=extra)
    if extra is not None:
        hidden = hidden[:, extra.shape[1]:]
    return chunked_ce(lambda h: logits_fn(cfg, params, h), hidden, labels,
                      aux, loss_chunk=loss_chunk)


# ----------------------------------------------------------------- serving

def make_serving_params(cfg, params, keep_packed=None) -> dict:
    """Fused-serving params: wq|wk|wv -> ``wqkv`` and, where the MLP is
    gated and dense, wg|wu -> ``wgu`` column concats (exact), and every
    QLinear (the stacked experts too) gains ``colsum`` (plus ``w_eff``
    where route 1 will not serve it; see ``qlinear.make_serving``)."""
    from repro_torch.core.qlinear import QLinear, concat_out, make_serving

    cd = compute_dtype(cfg)
    out_layers = []
    for lp in params["layers"]:
        layers = dict(lp)

        def try_concat(names, out_name):
            if not all(n in layers for n in names):
                return
            cat = concat_out([layers[n] for n in names], keep_packed, cd)
            if cat is None:
                return
            for n in names:
                del layers[n]
            layers[out_name] = cat

        try_concat(("wq", "wk", "wv"), "wqkv")
        if cfg.gated_mlp and not cfg.n_experts:
            try_concat(("wg", "wu"), "wgu")
        out_layers.append({
            k: (make_serving(v, keep_packed, cd)
                if isinstance(v, QLinear) and v.colsum is None else v)
            for k, v in layers.items()})
    return dict(params, layers=out_layers)


def init_cache(cfg, batch_size: int, max_len: int, device="cpu") -> dict:
    """Slot cache: (L, batch_size, max_len, KV, hd) k/v in the compute
    dtype, or int8 codes with congruent f32 per-token scales when
    ``kv_quant_bits`` is set, and ``pos`` 0."""
    shape = (cfg.n_layers, batch_size, max_len, cfg.n_kv_heads,
             cfg.head_dim)
    if cfg.kv_quant_bits:
        sshape = shape[:-1] + (1,)
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(sshape, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "v_scale": torch.zeros(sshape, device=device), "pos": 0}
    cd = compute_dtype(cfg)
    return {"k": torch.zeros(shape, dtype=cd, device=device),
            "v": torch.zeros(shape, dtype=cd, device=device), "pos": 0}


def init_paged_cache(cfg, n_pages: int, page_size: int,
                     device="cpu") -> dict:
    """Global paged KV pool: (L, n_pages, page_size, KV, hd) codes (+
    congruent per-token scale pools when quantized). Page 0 is the null
    page (never owned by a request)."""
    shape = (cfg.n_layers, n_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
    if cfg.kv_quant_bits:
        sshape = shape[:-1] + (1,)
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(sshape, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "v_scale": torch.zeros(sshape, device=device)}
    cd = compute_dtype(cfg)
    return {"k": torch.zeros(shape, dtype=cd, device=device),
            "v": torch.zeros(shape, dtype=cd, device=device)}


def copy_paged_pages(cfg, cache, src, dst) -> dict:
    """Copy-on-write page copy: pool pages ``src`` into ``dst`` on every
    paged-cache leaf, codes and scales in lockstep (a cached int8 page is
    reusable only with its per-token scales), in place. ``src``/``dst``
    (C,) int, padded with (0, 0) null-page self-copies."""
    return {k: copy_pool_pages(v, src, dst) for k, v in cache.items()}


def prefill(cfg, params, tokens, cache, logits_at=None, **fwd_kw):
    """-> (logits (B, 1, V), cache). Logits come from the last row, or
    from row ``logits_at`` (an int or a 0-dim tensor, clamped into the
    rows as the reference's ``dynamic_slice_in_dim``): bucketed and
    chunked prefill pad tokens on the right and read the true last prompt
    row. A (R,) tensor ``logits_at`` gathers R rows -> (B, R, V)."""
    hidden, _, cache = forward(cfg, params, tokens, cache=cache, **fwd_kw)
    s = hidden.shape[1]
    if logits_at is None:
        hidden = hidden[:, -1:]
    elif torch.is_tensor(logits_at):
        rows = logits_at.reshape(-1).to(device=hidden.device,
                                        dtype=torch.int64)
        if logits_at.ndim == 0:
            rows = rows.clamp(0, s - 1)
        hidden = hidden.index_select(1, rows)
    else:
        at = min(max(int(logits_at), 0), s - 1)
        hidden = hidden[:, at:at + 1]
    return logits_fn(cfg, params, hidden), cache


def decode(cfg, params, token, cache, **fwd_kw):
    """token (B, 1) -> (logits (B, 1, V), cache)."""
    hidden, _, cache = forward(cfg, params, token, cache=cache, **fwd_kw)
    return logits_fn(cfg, params, hidden), cache


def greedy_tokens(logits):
    """Greedy ids of the last position; the lowest index wins ties."""
    return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)


def ragged_step(cfg, params, tokens, cache, logit_rows, greedy=False,
                **fwd_kw):
    """Unified token-budget step over a flat ragged batch: ``tokens`` (T, 1)
    packed rows, per-row ``pos`` (T,) and ``page_table`` (T, n_ptab) in
    ``cache``; logits only at ``logit_rows`` (R,). -> (logits (R, 1, V),
    cache), or (greedy ids (R,) int32, cache) with ``greedy``."""
    hidden, _, cache = forward(cfg, params, tokens, cache=cache, **fwd_kw)
    sel = hidden[:, 0][logit_rows.long()][:, None]
    logits = logits_fn(cfg, params, sel)
    if greedy:
        return greedy_tokens(logits), cache
    return logits, cache
