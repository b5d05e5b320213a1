"""Checkpoints on the reference's on-disk layout — counterpart of
``repro.checkpoint.checkpoint``.

Layout:  <dir>/step_<N>/   (N zero-padded to 8 digits)
           manifest.json   — step, meta, and per group the shape and
                             dtype of every flat key
           params.npz      — the params' arrays by flat key
           opt_state.npz   — the optimizer state's, when given

Either package restores the other's checkpoints. The reference keeps the
layers stacked on a leading axis (its model scans over them) where the
port keeps a list of per-layer dicts, so ``save`` stacks the port's
layers (``convert.stack_layers``) and ``restore`` splits them again. The
flat keys are the reference's ``_path_key`` of each leaf's pytree path:
dict keys (sorted) and sequence indices as they are, the data fields of
``QLinear`` and of the transform dataclasses as ``.<field>`` (``None``
fields are no leaves), joined by ``/``. npz cannot store bfloat16: such
arrays go as their raw bytes (``uint8``), and the manifest's dtype string
``"bfloat16"`` says how to read them back (through ``torch.uint8`` ->
``.view(torch.bfloat16)``, so no numpy bfloat16 type is needed). A save
writes into a temporary directory and renames it into place.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import tempfile
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.convert import split_layers, stack_layers
from repro_torch.core.qlinear import QLinear

_SEP = "/"
_QLINEAR_DATA = ("qweight", "scale", "transform", "colsum", "w_eff")
_DTYPES = {torch.float32: "float32", torch.float64: "float64",
           torch.float16: "float16", torch.bfloat16: "bfloat16",
           torch.int8: "int8", torch.uint8: "uint8", torch.int16: "int16",
           torch.int32: "int32", torch.int64: "int64", torch.bool: "bool"}
_TORCH = {v: k for k, v in _DTYPES.items()}


def _fields(node) -> tuple:
    """The pytree data fields of a QLinear or transform dataclass."""
    if isinstance(node, QLinear):
        return _QLINEAR_DATA
    return tuple(f.name for f in dataclasses.fields(node))


def _walk(tree, path=()):
    """(flat key parts, node) for every node of ``tree`` in the reference's
    leaf order: dict keys sorted, sequence indices, dataclass data fields
    as ``.<field>``; ``None`` is no node."""
    if tree is None:
        return
    yield path, tree
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (str(i),))
    elif dataclasses.is_dataclass(tree):
        for f in _fields(tree):
            yield from _walk(getattr(tree, f), path + (f".{f}",))
    elif not isinstance(tree, torch.Tensor):
        raise TypeError(f"cannot checkpoint a {type(tree).__name__} leaf "
                        f"at {_SEP.join(path)!r}")


def _flatten(tree) -> dict:
    """Flat key -> tensor, in the reference's leaf order."""
    return {_SEP.join(p): t for p, t in _walk(tree)
            if isinstance(t, torch.Tensor)}


def _rebuild(like, load, path=()):
    """``like``'s structure with every tensor leaf replaced by
    ``load(flat key)``."""
    if like is None:
        return None
    if isinstance(like, torch.Tensor):
        return load(_SEP.join(path))
    if isinstance(like, dict):
        return {k: _rebuild(v, load, path + (str(k),))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, load, path + (str(i),))
                          for i, v in enumerate(like))
    if dataclasses.is_dataclass(like):
        return dataclasses.replace(like, **{
            f: _rebuild(getattr(like, f), load, path + (f".{f}",))
            for f in _fields(like)})
    raise TypeError(f"cannot restore into a {type(like).__name__} leaf")


def _encode(t: torch.Tensor) -> np.ndarray:
    """A tensor as what npz stores: its array, or its raw bytes for
    bfloat16 (as the reference stores every non-numpy dtype)."""
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint8).numpy() if t.ndim else (
            t.reshape(1).view(torch.uint8).numpy())
    return t.numpy()


def _decode(raw: np.ndarray, dtype: str, shape) -> torch.Tensor:
    if dtype not in _TORCH:
        raise TypeError(f"checkpoint dtype {dtype!r} is not supported")
    want = _TORCH[dtype]
    t = torch.from_numpy(np.array(raw, copy=True))
    if t.dtype != want:
        t = t.view(torch.uint8).view(want)
    return t.reshape(tuple(shape))


def packed_int4_layers(params) -> list:
    """Flat keys of the int4-packed QLinear leaves of ``params`` (port
    layout), as the reference's manifest names them (stacked layers)."""
    return [_SEP.join(p) for p, node in _walk(stack_layers(params))
            if isinstance(node, QLinear) and node.packed]


def save(ckpt_dir: str, step: int, params, opt_state=None,
         meta: Optional[dict] = None) -> str:
    """Write ``params`` (and ``opt_state``) as step ``step`` under
    ``ckpt_dir``; atomic (a temporary directory renamed into place).
    -> the step's directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_ckpt_")
    groups = {"params": params}
    if opt_state is not None:
        groups["opt_state"] = opt_state
    meta = dict(meta or {})
    packed = packed_int4_layers(params)
    meta["packed_int4"] = bool(packed)
    if packed:
        meta["packed_int4_layers"] = packed
    manifest: dict[str, Any] = {"step": step, "meta": meta, "groups": {}}
    for gname, tree in groups.items():
        flat = _flatten(stack_layers(tree))
        np.savez(os.path.join(tmp, f"{gname}.npz"),
                 **{k: _encode(v) for k, v in flat.items()})
        manifest["groups"][gname] = {
            k: {"shape": list(v.shape), "dtype": _DTYPES[v.dtype]}
            for k, v in flat.items()}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_")]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: Optional[int], like_params,
            like_opt_state=None, device="cuda") -> dict:
    """Read step ``step`` (None: the latest) into the structure of
    ``like_params`` / ``like_opt_state`` (port layout; their QLinear
    metadata is kept, their tensors only name the leaves), on ``device``.
    -> {"step", "params", "meta"} (+ "opt_state")."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)

    def load_group(gname, like):
        info = manifest["groups"][gname]
        with np.load(os.path.join(d, f"{gname}.npz")) as data:
            def load(key):
                if key not in info:
                    raise KeyError(f"{gname} has no leaf {key!r} in "
                                   f"{d}/manifest.json")
                return _decode(data[key], info[key]["dtype"],
                               info[key]["shape"]).to(device)
            return split_layers(_rebuild(stack_layers(like), load))

    out = {"step": manifest["step"],
           "params": load_group("params", like_params),
           "meta": manifest["meta"]}
    if like_opt_state is not None:
        out["opt_state"] = load_group("opt_state", like_opt_state)
    return out


def prune_old(ckpt_dir: str, keep: int = 3) -> None:
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                   if d.startswith("step_"))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
