"""Training driver: elastic, fault-tolerant, with the paper's dedup pipeline.

    python -m repro_torch.launch.train --arch smoke-lm --reduced \
        --device cpu --steps 100 --batch 8 --seq 256 --ckpt-dir <dir>

The counterpart of ``repro.launch.train``: configs registry -> LMModel
(weights from ``np.random.default_rng(--seed)``) -> AdamW -> the train
step -> TokenPipeline (optional self-join dedup, which launches the
fused-join kernel on the card) -> CheckpointManager (async, atomic,
keep-last-k) -> StragglerMonitor -> elastic restore from the latest
complete checkpoint. Runs on CUDA unless ``--device`` names another
device.

``--mesh smoke|single|multi`` runs SPMD over the ranks of the process
group (``launch/mesh.py``; a one-rank group when none is initialized):
every rank runs this driver, builds the same whole batch (the dedup's
join included), keeps its rows, and holds its blocks of the parameters
and the optimizer state. Start the ranks with ``torchrun`` or with
``repro_torch.launch.mesh.spawn(train_rank, n, argv)``:

    torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch smoke-lm --reduced --mesh smoke --device cpu

``--compress-pods`` adds the error-feedback buffers to the state and, on
a mesh with a 'pod' axis, compresses the cross-pod exchange. A checkpoint
holds whole arrays, so a run restores onto any mesh: the elastic restore
prints ``[train] elastic restore from step N onto K rank(s)``. Only rank 0
prints the steps.

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
from repro_torch.launch.mesh import (init_world, make_production_mesh,
                                     make_smoke_mesh)
from repro_torch.models.lm import LMModel
from repro_torch.train.compression import init_error_state
from repro_torch.train.optimizer import (AdamWConfig, adamw_init,
                                         opt_state_specs)
from repro_torch.train.steps import make_train_step
from repro_torch.train.straggler import StragglerMonitor


@dataclasses.dataclass
class TrainReport:
    """What one run measured. ``step_ms``: host-clock ms of each step run,
    ending in its loss's read; ``batch_ms``: the pipeline's ms for each
    batch (the dedup's join included); ``peak_bytes``: the device's peak
    allocation (None on the CPU: not measured); ``mesh``: the mesh's
    axis sizes (None without one); ``collective``: the mesh's collectives
    over the run, kind -> (calls, seconds, bytes)."""
    device: str
    start: int                   # the step the run began at (a restore's)
    losses: list
    step_ms: list
    batch_ms: list
    tokens_per_step: int
    peak_bytes: Optional[int]
    loss: float                  # the final loss
    rank: int = 0
    ranks: int = 1
    mesh: Optional[dict] = None
    collective: Optional[dict] = None

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
    cfg = get_config(args.arch, reduced=args.reduced)
    if args.mesh == "single":
        mesh = make_production_mesh(multi_pod=False, device=args.device)
    elif args.mesh == "multi":
        mesh = make_production_mesh(multi_pod=True, device=args.device)
    elif args.mesh == "smoke":
        _, world = init_world(args.device)
        mesh = make_smoke_mesh(world, device=args.device)
    else:
        mesh = None
    model = LMModel(cfg, mesh, device=args.device)
    ocfg = AdamWConfig(lr=args.lr, warmup_steps=args.warmup)
    return cfg, mesh, model, ocfg


def _agreed(mesh, fn):
    """``fn()``, and on a mesh every rank raises if any rank's call did."""
    err = None
    try:
        out = fn()
    except Exception as e:          # noqa: BLE001 -- raised below
        err = e
    if mesh is not None and mesh.any(err is not None):
        raise err if err is not None else RuntimeError(
            "another rank failed; see its error")
    if err is not None:
        raise err
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(argv=None) -> TrainReport:
    args = parse_args(argv)
    cfg, mesh, model, ocfg = build(args)
    dev = model.device
    lead = mesh is None or mesh.rank == 0
    say = print if lead else (lambda *a, **k: None)
    pipe = TokenPipeline(vocab=cfg.vocab, batch=args.batch, seq=args.seq,
                         seed=args.seed, dedup=args.dedup,
                         input_kind=cfg.input_kind, d_model=cfg.d_model,
                         device=dev)

    params, specs = model.init(np.random.default_rng(args.seed))
    opt_state = adamw_init(params, ocfg)
    ospecs = opt_state_specs(specs, ocfg, params)
    if args.compress_pods:
        opt_state["grad_error"] = init_error_state(params)
        ospecs = {**ospecs, "grad_error": specs}
    tree_specs = {"params": specs, "opt": ospecs} if mesh else None
    n_ranks = mesh.size if mesh is not None else 1

    start = 0
    mgr = (CheckpointManager(args.ckpt_dir, mesh=mesh) if args.ckpt_dir
           else None)
    if mgr is not None:
        last = latest_step(args.ckpt_dir)
        if last is not None:
            tree = _agreed(mesh, lambda: restore_checkpoint(
                args.ckpt_dir, last, {"params": params, "opt": opt_state},
                mesh=mesh, specs=tree_specs))
            params, opt_state = tree["params"], tree["opt"]
            start = last
            say(f"[train] elastic restore from step {last} onto {n_ranks} "
                f"rank(s) ({dev})")

    def save(at: int):
        mgr.save_async(at, {"params": params, "opt": opt_state},
                       specs=tree_specs)

    step_fn = make_train_step(model, ocfg, compress_pods=args.compress_pods,
                              param_specs=specs if mesh is not None else None)
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
            say(f"[train] step {step} loss {loss:.4f} "
                f"{dt*1000:.0f}ms gnorm {float(metrics['grad_norm']):.3f}"
                + (" SLOW" if slow else ""), flush=True)
        rebalance = mon.should_rebalance()
        if mesh is not None:        # the ranks decide together
            rebalance = mesh.any(rebalance)
        if rebalance:
            say("[train] straggler threshold exceeded -> checkpoint + "
                "rebalance requested", flush=True)
            mon.reset()
            if mgr is not None:
                save(step + 1)
        if mgr is not None and (step + 1) % args.ckpt_every == 0:
            save(step + 1)
    if mgr is not None:
        save(args.steps)
        mgr.wait()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    say(f"[train] done at step {args.steps}, final loss {loss:.4f}")
    return TrainReport(
        device=str(dev), start=start, losses=losses, step_ms=step_ms,
        batch_ms=batch_ms, tokens_per_step=args.batch * args.seq,
        peak_bytes=peak, loss=loss,
        rank=mesh.rank if mesh is not None else 0, ranks=n_ranks,
        mesh=dict(mesh.shape) if mesh is not None else None,
        collective=dict(mesh.stats) if mesh is not None else None)


def train_rank(rank: int, argv) -> TrainReport:
    """One rank of a meshed run (a worker for ``launch.mesh.spawn``)."""
    return run(list(argv))


def main(argv=None) -> float:
    return run(argv).loss


if __name__ == "__main__":
    main()
