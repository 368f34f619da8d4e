"""Training driver: elastic, fault-tolerant, with the paper's dedup pipeline.

    python -m repro_torch.launch.train --arch smoke-lm --reduced \
        --device cpu --steps 100 --batch 8 --seq 256 --ckpt-dir <dir>

The counterpart of ``repro.launch.train``: configs registry -> LMModel
(weights from ``np.random.default_rng(--seed)``) -> AdamW -> the train
step -> TokenPipeline (optional self-join dedup, which launches the
fused-join kernel on the card) -> CheckpointManager (async, atomic,
keep-last-k) -> StragglerMonitor -> elastic restore from the latest
complete checkpoint. Runs on CUDA unless ``--device`` names another
device. Only ``--mesh none`` runs: the meshes and ``--compress-pods`` come
with ROADMAP A17 (ii b).

Each step's time ends in the read of its loss, which waits for the step's
work on the device: the driver's one sync point a step, as the reference's
``float(loss)`` is. ``main`` returns the final loss (NaN when the latest
checkpoint is already at ``--steps``, so that no step runs); ``run``
returns the whole ``TrainReport``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.ckpt import CheckpointManager, latest_step, restore_checkpoint
from repro_torch.configs import get_config
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.models.lm import LMModel
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.steps import make_train_step
from repro_torch.train.straggler import StragglerMonitor

MESH_TODO = "ROADMAP A17 (ii b)"


@dataclasses.dataclass
class TrainReport:
    """What one run measured. ``step_ms``: host-clock ms of each step run,
    ending in its loss's read; ``batch_ms``: the pipeline's ms for each
    batch (the dedup's join included); ``peak_bytes``: the device's peak
    allocation (None on the CPU: not measured)."""
    device: str
    start: int                   # the step the run began at (a restore's)
    losses: list
    step_ms: list
    batch_ms: list
    tokens_per_step: int
    peak_bytes: Optional[int]
    loss: float                  # the final loss

    def tokens_per_s(self) -> float:
        """What a user of the driver gets: tokens over each iteration's
        batch and step, after the first (which sets up the libraries)."""
        timed = [b + s for b, s in zip(self.batch_ms[1:], self.step_ms[1:])]
        return self.tokens_per_step * len(timed) / (sum(timed) / 1000)

    def step_tokens_per_s(self) -> float:
        """The train step's own rate (a per-layer number): tokens over the
        steps' time alone, the batches' left out."""
        timed = self.step_ms[1:]
        return self.tokens_per_step * len(timed) / (sum(timed) / 1000)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smoke-lm")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", choices=["none", "smoke", "single", "multi"],
                    default="none")
    ap.add_argument("--dedup", action="store_true",
                    help="self-join near-duplicate filter in the pipeline")
    ap.add_argument("--compress-pods", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="CUDA by default; 'cpu' runs every kernel's plain "
                         "version on the CPU")
    return ap.parse_args(argv)


def build(args):
    if args.mesh != "none":
        raise NotImplementedError(f"--mesh {args.mesh}: the LM meshes come "
                                  f"with {MESH_TODO}")
    if args.compress_pods:
        raise NotImplementedError(f"--compress-pods needs a pod mesh: "
                                  f"{MESH_TODO}")
    cfg = get_config(args.arch, reduced=args.reduced)
    model = LMModel(cfg, device=args.device)
    ocfg = AdamWConfig(lr=args.lr, warmup_steps=args.warmup)
    return cfg, model, ocfg


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(argv=None) -> TrainReport:
    args = parse_args(argv)
    cfg, model, ocfg = build(args)
    dev = model.device
    pipe = TokenPipeline(vocab=cfg.vocab, batch=args.batch, seq=args.seq,
                         seed=args.seed, dedup=args.dedup,
                         input_kind=cfg.input_kind, d_model=cfg.d_model,
                         device=dev)

    params, _ = model.init(np.random.default_rng(args.seed))
    opt_state = adamw_init(params, ocfg)

    start = 0
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    if mgr is not None:
        last = latest_step(args.ckpt_dir)
        if last is not None:
            tree = restore_checkpoint(args.ckpt_dir, last,
                                      {"params": params, "opt": opt_state})
            params, opt_state = tree["params"], tree["opt"]
            start = last
            print(f"[train] elastic restore from step {last} onto {dev}")

    step_fn = make_train_step(model, ocfg)
    if dev.type == "cuda":
        _sync(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    mon = StragglerMonitor()
    losses, step_ms, batch_ms = [], [], []
    loss = float("nan")
    for step in range(start, args.steps):
        t0 = time.perf_counter()
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in pipe.batch_at(step).items()}
        batch_ms.append((time.perf_counter() - t0) * 1000)
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])  # sync point
        dt = time.perf_counter() - t0
        losses.append(loss)
        step_ms.append(dt * 1000)
        slow = mon.record(dt)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"[train] step {step} loss {loss:.4f} "
                  f"{dt*1000:.0f}ms gnorm {float(metrics['grad_norm']):.3f}"
                  + (" SLOW" if slow else ""), flush=True)
        if mon.should_rebalance():
            print("[train] straggler threshold exceeded -> checkpoint + "
                  "rebalance requested", flush=True)
            mon.reset()
            if mgr is not None:
                mgr.save_async(step + 1, {"params": params, "opt": opt_state})
        if mgr is not None and (step + 1) % args.ckpt_every == 0:
            mgr.save_async(step + 1, {"params": params, "opt": opt_state})
    if mgr is not None:
        mgr.save_async(args.steps, {"params": params, "opt": opt_state})
        mgr.wait()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    print(f"[train] done at step {args.steps}, final loss {loss:.4f}")
    return TrainReport(
        device=str(dev), start=start, losses=losses, step_ms=step_ms,
        batch_ms=batch_ms, tokens_per_step=args.batch * args.seq,
        peak_bytes=peak, loss=loss)


def main(argv=None) -> float:
    return run(argv).loss


if __name__ == "__main__":
    main()
