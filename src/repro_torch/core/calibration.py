"""Calibration — counterpart of ``repro.core.calibration``: run the model
(layers are a Python loop, so every tap is observable) on a small
calibration set and collect, per tap point (layer-group input), Σ_x =
E[xxᵀ] (CAT, GPTQ), E[x²] and the per-channel absmax (SmoothQuant) and a
bounded reservoir of rows (the SQNR analysis)."""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from .cat import CovAccumulator


@dataclasses.dataclass
class TapStats:
    cov: CovAccumulator
    samples: list
    max_sample_rows: int = 2048

    def update(self, x: np.ndarray) -> None:
        self.cov.update(x)
        have = sum(s.shape[0] for s in self.samples)
        if have < self.max_sample_rows:
            take = min(self.max_sample_rows - have, x.shape[0])
            idx = np.linspace(0, x.shape[0] - 1, take).astype(int)
            self.samples.append(x[idx].astype(np.float32))

    @property
    def sigma(self) -> np.ndarray:
        return self.cov.cov()

    @property
    def absmax(self) -> np.ndarray:
        return self.cov.amax

    @property
    def mean_sq(self) -> np.ndarray:
        return self.cov.mean_sq()

    def sample_matrix(self) -> np.ndarray:
        return np.concatenate(self.samples, axis=0)


class Taps:
    """Passed through the model forward; collects named stats on the
    host."""

    def __init__(self, max_sample_rows: int = 2048,
                 max_rows_per_call: int = 4096):
        self.stats: Dict[str, TapStats] = {}
        self.max_sample_rows = max_sample_rows
        self.max_rows_per_call = max_rows_per_call

    def record(self, name: str, x: torch.Tensor) -> None:
        arr = x.detach().to(torch.float32).cpu().numpy().reshape(
            -1, x.shape[-1])
        if arr.shape[0] > self.max_rows_per_call:
            idx = np.linspace(0, arr.shape[0] - 1,
                              self.max_rows_per_call).astype(int)
            arr = arr[idx]
        st = self.stats.get(name)
        if st is None:
            st = TapStats(CovAccumulator(arr.shape[1]), [],
                          self.max_sample_rows)
            self.stats[name] = st
        st.update(arr)

    def __getitem__(self, name: str) -> TapStats:
        return self.stats[name]

    def names(self):
        return sorted(self.stats)


@torch.no_grad()
def calibrate(model, params, batches: Iterable[dict],
              taps: Optional[Taps] = None) -> Taps:
    """Run the model over calibration batches (on the device of the
    embedding), collecting taps."""
    taps = taps or Taps()
    device = params["embed"].device
    for batch in batches:
        tokens = torch.as_tensor(np.asarray(batch["tokens"]), device=device)
        kw = {}
        if "patch_embed" in batch:   # the vlm prefix
            kw["extra_embed"] = torch.as_tensor(
                np.asarray(batch["patch_embed"]), device=device)
        model.forward(params, tokens, taps=taps, **kw)
    return taps
