"""The trainer — counterpart of ``repro.launch.train``, on one card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch catlm_60m \\
        --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt

Wires the reference's substrate on PyTorch autograd: the config-driven
dense model (seeded params from a ``torch.Generator``, drawn on the host
and moved to ``device``), AdamW (``AdamWMaster`` with bf16 params under
``--mixed-precision``) on the warmup-cosine schedule, deterministic data
(``data.make_batch(seed, step)``), a checkpoint every ``ckpt_every`` steps
on the reference's layout (``repro_torch.checkpoint``; the two newest
kept) and restart-on-failure through ``run_with_restarts``, with the step
watchdog and the straggler monitor. A restarted run resumes from the
newest checkpoint and, the data being a function of (seed, step) and every
gradient sum having a fixed order (the embedding's included:
``dense.embed_rows``), continues bit for bit as the uninterrupted run.
The reference's training path reaches no Pallas kernel, and neither does
this one. ``mesh`` (data/tensor-parallel training) waits for the
tensor-parallel slice.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch import checkpoint as ckpt_lib
from repro_torch.configs import get_config
from repro_torch.data import make_batch
from repro_torch.distributed.fault_tolerance import (FailureInjector,
                                                     StepWatchdog,
                                                     StragglerMonitor,
                                                     run_with_restarts)
from repro_torch.models import build
from repro_torch.optim.optimizer import (AdamW, AdamWMaster, cast_params,
                                         tree_map, warmup_cosine)


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "mesh: data- and tensor-parallel training come with the port's "
            "tensor-parallel slice; this slice trains on one card")


def value_and_grad(loss_fn, params):
    """((loss, metrics), grads): ``loss_fn(params) -> (loss, metrics)``
    differentiated by autograd with respect to every leaf of ``params``
    (grads in the params' structure; loss and metrics detached)."""
    leaves = []

    def mark(t):
        t = t.detach().requires_grad_(True)
        leaves.append(t)
        return t

    loss, metrics = loss_fn(tree_map(mark, params))
    grads = iter(torch.autograd.grad(loss, leaves))
    return ((loss.detach(), {k: v.detach() for k, v in metrics.items()}),
            tree_map(lambda _: next(grads), params))


def make_train_step(model, opt, grad_compress: bool = False, mesh=None):
    """(params, opt_state, batch) -> (params, opt_state, metrics + loss).
    ``grad_compress`` belongs to the data-parallel all-reduce, which one
    card does not run."""
    _no_mesh(mesh)

    def train_step(params, opt_state, batch):
        (loss, metrics), grads = value_and_grad(
            lambda p: model.loss(p, batch), params)
        params, opt_state = opt.update(params, grads, opt_state)
        return params, opt_state, dict(metrics, loss=loss)
    return train_step


def device_batch(cfg, seq: int, batch: int, seed: int, step: int,
                 device) -> dict:
    """``make_batch(seed, step)`` as int64 tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device)
            for k, v in make_batch(cfg, seq, batch, seed=seed,
                                   step=step).items()}


def train(arch: str = "catlm_60m", steps: int = 100, batch: int = 8,
          seq: int = 128, lr: float = 3e-4, ckpt_dir: Optional[str] = None,
          ckpt_every: int = 50, smoke: bool = True, mesh=None,
          mixed_precision: bool = False, seed: int = 0,
          fail_at: tuple = (), log_every: int = 10,
          watchdog_timeout: float = 600.0, device="cuda"):
    """-> (final step, losses of every executed step). Restart-safe: with
    a checkpoint in ``ckpt_dir`` it resumes from the newest."""
    _no_mesh(mesh)
    device = torch.device(device)
    cfg = get_config(arch)
    if smoke:
        cfg = cfg.smoke()
    model = build(cfg)
    opt_cls = AdamWMaster if mixed_precision else AdamW
    opt = opt_cls(lr=warmup_cosine(lr, warmup=max(10, steps // 20),
                                   total=steps))
    injector = FailureInjector(fail_at_steps=fail_at)
    monitor = StragglerMonitor()
    losses: list = []

    def run(resume) -> int:
        params = model.init(torch.Generator().manual_seed(seed), device)
        if mixed_precision:
            params = cast_params(params, torch.bfloat16)
        opt_state = opt.init(params)
        start = 0
        if ckpt_dir and ckpt_lib.latest_step(ckpt_dir) is not None:
            out = ckpt_lib.restore(ckpt_dir, None, params, opt_state,
                                   device=device)
            params, opt_state, start = (out["params"], out["opt_state"],
                                        out["step"])
        step_fn = make_train_step(model, opt)
        wd = StepWatchdog(watchdog_timeout,
                          lambda: print("WATCHDOG: step hang detected",
                                        flush=True))
        try:
            for step in range(start, steps):
                wd.beat()
                t0 = time.time()
                injector.check(step)
                b = device_batch(cfg, seq, batch, seed, step, device)
                params, opt_state, metrics = step_fn(params, opt_state, b)
                loss = float(metrics["loss"])
                losses.append(loss)
                dt = time.time() - t0
                if monitor.record(step, dt):
                    print(f"STRAGGLER: step {step} took {dt:.2f}s "
                          f"(ewma {monitor.mean:.2f}s)", flush=True)
                if ckpt_dir and (step + 1) % ckpt_every == 0:
                    ckpt_lib.save(ckpt_dir, step + 1, params, opt_state,
                                  meta={"arch": arch, "loss": loss})
                    ckpt_lib.prune_old(ckpt_dir, keep=2)
                if log_every and step % log_every == 0:
                    print(f"step {step:5d} loss {loss:.4f} "
                          f"({dt * 1000:.0f} ms)", flush=True)
        finally:
            wd.stop()
        if ckpt_dir:
            ckpt_lib.save(ckpt_dir, steps, params, opt_state,
                          meta={"arch": arch,
                                "loss": losses[-1] if losses else None})
        return steps

    final = run_with_restarts(
        run, max_restarts=3,
        on_restart=lambda n, e: print(f"RESTART #{n} after: {e}",
                                      flush=True))
    return final, losses


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="catlm_60m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--mixed-precision", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, default) or cpu")
    args = ap.parse_args(argv)
    final, losses = train(arch=args.arch, steps=args.steps,
                             batch=args.batch, seq=args.seq, lr=args.lr,
                             ckpt_dir=args.ckpt_dir,
                             ckpt_every=args.ckpt_every,
                             smoke=not args.full_config,
                             mixed_precision=args.mixed_precision,
                             seed=args.seed, device=args.device)
    print(f"finished at step {final}; loss {losses[0]:.3f} -> "
          f"{losses[-1]:.3f}")


if __name__ == "__main__":
    main()
