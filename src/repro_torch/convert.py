"""Carry the reference's params across: ``from_reference(tree, device)``.

Turns a params pytree of the JAX package into the port's params: dicts
and sequences are walked, every array leaf is read with ``np.asarray``
and becomes a torch tensor on ``device``, ``QLinear`` and the transform
classes (Identity, Scale, Dense, Hadamard, BlockDiag, Compose) are
recognised by class name and attributes — so this module imports neither
``jax`` nor the reference package. The reference stacks layers on a
leading axis (``params["layers"]`` leaves are (L, ...)); the port keeps a
list of per-layer dicts, so that subtree is split by layer
(``split_layers``); ``stack_layers`` is the inverse, for writing the
reference's layout (``checkpoint``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import transforms as T
from repro_torch.core.qlinear import QLinear

_TRANSFORM_FIELDS = {
    "Identity": (T.Identity, ()),
    "Scale": (T.Scale, ("s",)),
    "Dense": (T.Dense, ("t", "t_inv")),
    "Hadamard": (T.Hadamard, ("ha", "hb", "sign")),
    "BlockDiag": (T.BlockDiag, ("blocks", "inv_blocks")),
}


def _tensor(a, device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        raw = np.ascontiguousarray(arr).view(np.uint16).astype(np.int16)
        return torch.from_numpy(raw).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def _convert(node, device):
    name = type(node).__name__
    if node is None:
        return None
    if isinstance(node, dict):
        return {k: _convert(v, device) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_convert(v, device) for v in node)
    if name == "QLinear" and hasattr(node, "qweight"):
        return QLinear(qweight=_tensor(node.qweight, device),
                       scale=_tensor(node.scale, device),
                       transform=_convert(node.transform, device),
                       colsum=_convert(node.colsum, device),
                       w_eff=_convert(node.w_eff, device),
                       act_bits=int(node.act_bits), w_bits=int(node.w_bits),
                       d_in=int(node.d_in))
    if name == "Compose" and hasattr(node, "parts"):
        return T.Compose(tuple(_convert(p, device) for p in node.parts))
    if name in _TRANSFORM_FIELDS:
        cls, fields = _TRANSFORM_FIELDS[name]
        return cls(*(_tensor(getattr(node, f), device) for f in fields))
    if isinstance(node, (bool, int, float, str)):
        return node
    if hasattr(node, "__array__") or isinstance(node, np.generic):
        return _tensor(node, device)
    raise TypeError(f"cannot convert a {name} leaf")


def _layer(node, i):
    if isinstance(node, dict):
        return {k: _layer(v, i) for k, v in node.items()}
    if isinstance(node, QLinear):
        return node.map_tensors(lambda t: t[i])
    if isinstance(node, T.Transform):
        return T.map_tensors(node, lambda t: t[i])
    if isinstance(node, torch.Tensor):
        return node[i]
    return node


def split_layers(tree):
    """Every ``"layers"`` dict of stacked (L, ...) leaves in ``tree`` (a
    params tree, or an optimizer state of such trees) -> a list of L
    per-layer dicts (views of the stacked leaves)."""
    if not isinstance(tree, dict):
        return tree
    out = {k: split_layers(v) for k, v in tree.items()}
    layers = out.get("layers")
    if isinstance(layers, dict):
        n_layers = next(v.shape[0] for v in layers.values()
                        if isinstance(v, torch.Tensor))
        out["layers"] = [_layer(layers, i) for i in range(n_layers)]
    return out


def _stack(nodes, fn):
    first = nodes[0]
    if isinstance(first, torch.Tensor):
        return fn(nodes)
    if isinstance(first, dict):
        return {k: _stack([n[k] for n in nodes], fn) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_stack([n[i] for n in nodes], fn)
                           for i in range(len(first)))
    if dataclasses.is_dataclass(first):
        return dataclasses.replace(first, **{
            f.name: _stack([getattr(n, f.name) for n in nodes], fn)
            for f in dataclasses.fields(first)
            if isinstance(getattr(first, f.name),
                          (torch.Tensor, tuple, list))
            or dataclasses.is_dataclass(getattr(first, f.name))})
    return first     # None and metadata: the first layer's


def stack_layers(tree):
    """The inverse of ``split_layers``: every ``"layers"`` list of
    per-layer dicts -> one dict of (L, ...) leaves, the reference's
    layout."""
    if not isinstance(tree, dict):
        return tree
    out = {k: stack_layers(v) for k, v in tree.items()}
    layers = out.get("layers")
    if isinstance(layers, list) and layers:
        out["layers"] = _stack(layers, torch.stack)
    return out


def from_reference(tree, device="cpu"):
    """The port's params for the reference's params ``tree``."""
    return split_layers(_convert(tree, device))
