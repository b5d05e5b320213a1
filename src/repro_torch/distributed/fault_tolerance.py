"""Fault tolerance & straggler mitigation (host-side control plane) —
counterpart of ``repro.distributed.fault_tolerance``, whose watchdog,
monitor, injector and restart loop are plain Python and numpy and are
copied as they are; ``surviving_mesh`` waits for the tensor-parallel
slice of the port.

Components:
  * StepWatchdog     — thread-based hang detection with configurable
                       timeout; fires a callback (alert / abort / re-mesh)
  * StragglerMonitor — per-step wall-time EWMA + z-score outlier flags;
                       on a real cluster the flagged host triggers
                       checkpoint-and-re-mesh, here it drives tests/logs
  * FailureInjector  — deterministic fault injection for tests/drills
  * elastic_restart  — rebuild a (possibly smaller) mesh from surviving
                       devices and restore the latest checkpoint onto it;
                       works because checkpoints are stored unsharded per
                       host group and the data pipeline is (seed, step)-
                       deterministic (bit-exact resume)

The training loop (launch/train.py) wires these together: every step is
`watchdog.beat()`-ed, timed into the monitor, checkpointed every N steps,
and the whole loop is wrapped in `run_with_restarts`.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np


class StepWatchdog:
    def __init__(self, timeout_s: float, on_timeout: Callable[[], None]):
        self.timeout_s = timeout_s
        self.on_timeout = on_timeout
        self._timer: Optional[threading.Timer] = None
        self._lock = threading.Lock()
        self.fired = False

    def beat(self) -> None:
        with self._lock:
            if self._timer is not None:
                self._timer.cancel()
            self._timer = threading.Timer(self.timeout_s, self._fire)
            self._timer.daemon = True
            self._timer.start()

    def _fire(self) -> None:
        self.fired = True
        self.on_timeout()

    def stop(self) -> None:
        with self._lock:
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None


@dataclass
class StragglerMonitor:
    alpha: float = 0.1            # EWMA factor
    z_threshold: float = 3.0
    warmup_steps: int = 5
    mean: float = 0.0
    var: float = 0.0
    n: int = 0
    flagged: list = field(default_factory=list)

    def record(self, step: int, dt: float) -> bool:
        """Returns True if this step is a straggler outlier."""
        self.n += 1
        if self.n <= self.warmup_steps:
            self.mean = dt if self.n == 1 else \
                (1 - self.alpha) * self.mean + self.alpha * dt
            self.var = max(self.var, (dt - self.mean) ** 2)
            return False
        std = max(np.sqrt(self.var), 1e-6, 0.05 * self.mean)
        is_outlier = (dt - self.mean) > self.z_threshold * std
        if is_outlier:
            self.flagged.append((step, dt))
        else:
            self.mean = (1 - self.alpha) * self.mean + self.alpha * dt
            self.var = (1 - self.alpha) * self.var \
                + self.alpha * (dt - self.mean) ** 2
        return is_outlier


class FailureInjector:
    """Deterministically fail at given steps (for restart drills)."""

    def __init__(self, fail_at_steps=(), exc=RuntimeError):
        self.fail_at = set(fail_at_steps)
        self.exc = exc
        self.tripped = []

    def check(self, step: int) -> None:
        if step in self.fail_at:
            self.fail_at.discard(step)
            self.tripped.append(step)
            raise self.exc(f"injected failure at step {step}")


def run_with_restarts(run_fn: Callable[[Optional[int]], int],
                      max_restarts: int = 3,
                      on_restart: Optional[Callable[[int, Exception], None]]
                      = None) -> int:
    """run_fn(resume_step|None) -> final_step; restarts from the latest
    checkpoint on failure (the trainer reads it internally)."""
    attempts = 0
    resume = None
    while True:
        try:
            return run_fn(resume)
        except Exception as e:  # noqa: BLE001 — survive any step failure
            attempts += 1
            if attempts > max_restarts:
                raise
            if on_restart is not None:
                on_restart(attempts, e)
            resume = -1  # sentinel: resume from latest checkpoint


def surviving_mesh(n_lost: int = 0, axis_names=("data", "model"),
                   prefer_model: int = None):
    """Elastic re-mesh onto the surviving devices: it needs the port's
    meshes, which come with tensor-parallel serving."""
    raise NotImplementedError(
        "surviving_mesh needs device meshes, which the port gains with "
        "tensor-parallel serving (a later slice); this slice trains and "
        "serves on one card")
