"""The slab mesh of the collective slab join, over ``torch.distributed``.

The counterpart of the slab half of ``repro.launch.mesh``
(``make_slab_mesh``): a ``(slab, model)`` grid of ranks, one process each.
A rank's slab index is ``rank // n_model`` and its model index
``rank % n_model``, the row-major device order of a JAX ``("slab",
"model")`` mesh. ``core.distributed`` takes a ``SlabMesh`` where it takes a
slab count, and then runs the join SPMD: every rank calls it with the same
points and keeps its own slab.

``spawn`` starts the ranks on this host. The process group meets through a
file in a temporary directory (no network, no MASTER_ADDR), has a timeout,
and each rank runs one torch thread. The backend follows a stated rule:
"nccl" when the ranks run on CUDA and there are at least as many cards as
ranks, "gloo" otherwise; an explicit ``backend=`` wins, and "nccl" with
fewer cards than ranks raises. A rank's device is ``cuda:{rank %
device_count}`` unless the caller asks for the CPU, so several gloo ranks
may share one card: their joins run on the card, and only the halo parcels,
flags and pairs pass through host memory, as gloo's sends take CPU tensors.

    python -m repro_torch.launch.mesh --slabs 4 [--model 2] [--count] \\
        [--device cpu] --points N --dims d --eps e --seed s

runs the collective join from the shell and prints one JSON line.
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os
import pickle
import tempfile
import time
from pathlib import Path
from typing import Any, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core.grid import resolve_device

# a collective that waits longer than this raises on its rank
DEFAULT_TIMEOUT_S = 300.0


@dataclasses.dataclass(frozen=True)
class SlabMesh:
    """One rank's view of the ``(slab, model)`` grid of ranks."""

    group: Any                 # the process group (None: the default one)
    n_slabs: int
    n_model: int
    rank: int
    device: torch.device       # where this rank's joins run
    backend: str

    @property
    def slab(self) -> int:
        return self.rank // self.n_model

    @property
    def model(self) -> int:
        return self.rank % self.n_model

    @property
    def wire(self) -> torch.device:
        """Where tensors must lie to cross the group: gloo's sends and
        receives take CPU tensors."""
        return self.device if self.backend == "nccl" else torch.device("cpu")

    def peer(self, slab: int) -> int:
        """The group rank of ``slab``'s rank at this rank's model index."""
        return slab * self.n_model + self.model


def _rank_device(rank: int, device) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def make_slab_mesh(n_slabs: int, n_model: int = 1, group=None,
                   device=None) -> SlabMesh:
    """This rank's ``SlabMesh``, called after ``init_process_group``.
    Refuses a group whose size is not ``n_slabs * n_model``. ``device``
    defaults to ``cuda:{rank % device_count}``; ``"cpu"`` runs the plain
    versions."""
    if n_slabs < 1 or n_model < 1:
        raise ValueError(f"a slab mesh needs n_slabs, n_model >= 1, got "
                         f"({n_slabs}, {n_model})")
    size = dist.get_world_size(group)
    if size != n_slabs * n_model:
        raise ValueError(f"a ({n_slabs}, {n_model}) slab mesh needs "
                         f"{n_slabs * n_model} ranks, the group has {size}")
    rank = dist.get_rank(group)
    dev = _rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.init()
        torch.cuda.set_device(dev)
    return SlabMesh(group, n_slabs, n_model, rank, dev,
                    dist.get_backend(group))


def choose_backend(n_ranks: int, device=None,
                   backend: Optional[str] = None) -> str:
    """The rule: an explicit backend wins; "nccl" needs CUDA ranks and a
    card for each; otherwise "gloo"."""
    on_cuda = torch.device("cuda" if device is None else device).type == "cuda"
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if backend == "nccl" and (not on_cuda or cards < n_ranks):
        raise ValueError(f"nccl needs a card for each of {n_ranks} CUDA "
                         f"ranks; {cards} card(s), device {device!r}")
    if backend is not None:
        return backend
    return "nccl" if on_cuda and cards >= n_ranks else "gloo"


def _rank_main(rank, n_ranks, backend, store, timeout_s, out_dir, fn, args):
    """One spawned rank: join the group, run ``fn(rank, *args)``, save its
    result or its exception under ``out_dir``."""
    torch.set_num_threads(1)
    dist.init_process_group(
        backend, init_method=f"file://{store}", rank=rank,
        world_size=n_ranks, timeout=datetime.timedelta(seconds=timeout_s))
    path = Path(out_dir) / f"rank{rank}.pkl"
    try:
        out = ("ok", fn(rank, *args))
    except BaseException as err:
        try:
            blob = pickle.dumps(("err", err))
        except Exception:            # noqa: BLE001 -- an unpicklable error
            blob = pickle.dumps(("err", RuntimeError(
                f"rank {rank}: {type(err).__name__}: {err}")))
        path.write_bytes(blob)
        raise
    finally:
        dist.destroy_process_group()
    path.write_bytes(pickle.dumps(out))


def _saved_error(out_dir: str, n_ranks: int):
    """The exception the lowest rank saved, if any saved one."""
    for rank in range(n_ranks):
        path = Path(out_dir) / f"rank{rank}.pkl"
        try:
            kind, err = pickle.loads(path.read_bytes())
        except (OSError, EOFError, pickle.UnpicklingError):
            continue                 # none, or cut short by a stop
        if kind == "err":
            return err
    return None


def spawn(fn, n_ranks: int, *args, backend: Optional[str] = None,
          device=None, timeout_s: float = DEFAULT_TIMEOUT_S) -> list:
    """Run ``fn(rank, *args)`` on ``n_ranks`` new processes that form one
    process group, and return their results in rank order.

    ``fn`` must be importable by name (a module-level function), as a
    spawned process imports it afresh. ``device`` is checked here and is
    what ``fn`` should pass to ``make_slab_mesh``; ``backend`` follows
    ``choose_backend``. The group's collectives time out after
    ``timeout_s``, and so does the whole run: then every rank is stopped
    and ``TimeoutError`` raised. A rank's exception is raised here."""
    if device is None or torch.device(device).type == "cuda":
        resolve_device(device)       # raises here, not in every rank
    backend = choose_backend(n_ranks, device, backend)
    with tempfile.TemporaryDirectory(prefix="slab_mesh_") as tmp:
        ctx = mp.start_processes(
            _rank_main, nprocs=n_ranks, join=False, start_method="spawn",
            args=(n_ranks, backend, os.path.join(tmp, "store"), timeout_s,
                  tmp, fn, args))
        deadline = time.monotonic() + timeout_s + 60.0
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{n_ranks} ranks of {fn.__name__} "
                                       f"ran past {timeout_s + 60.0:.0f} s")
        except mp.ProcessRaisedException as failed:
            err = _saved_error(tmp, n_ranks)
            if err is None:
                raise
            raise err from failed
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                p.join(timeout=10.0)
                if p.is_alive():
                    p.kill()
        return [pickle.loads((Path(tmp) / f"rank{rank}.pkl").read_bytes())[1]
                for rank in range(n_ranks)]


# ---------------------------------------------------------------------------
# The collective join from the shell
# ---------------------------------------------------------------------------

def _run_steps(mesh: SlabMesh, points, eps, steps, check: bool) -> dict:
    """``run_rank``'s work on one mesh."""
    from repro_torch.core import distributed as slab_join
    from repro_torch.kernels import fused_join

    cuda = mesh.device.type == "cuda"
    out = dict(slab=mesh.slab, model=mesh.model)
    pairs = None
    for name in steps:
        if cuda:
            torch.cuda.reset_peak_memory_stats(mesh.device)
        fused_join.GID_LAUNCHES = 0
        t0 = time.perf_counter()
        if name == "pairs":
            pairs = slab_join.distributed_self_join(points, eps, mesh)
            value = int(pairs.shape[0])
        elif name == "count_only":
            value = slab_join.distributed_self_join(points, eps, mesh,
                                                    return_pairs=False)
        elif name == "plain_count":
            value = slab_join.distributed_self_join_count(
                points, eps, mesh,
                model_axis="model" if mesh.n_model > 1 else None)
        else:
            raise ValueError(f"unknown step {name!r}")
        if cuda:
            torch.cuda.synchronize(mesh.device)
        out[name] = dict(
            value=value, seconds=time.perf_counter() - t0,
            peak_bytes=(torch.cuda.max_memory_allocated(mesh.device)
                        if cuda else None),
            gid_launches=fused_join.GID_LAUNCHES)
    if check:
        t0 = time.perf_counter()
        mine = slab_join.candidate_blocks(points, eps, mesh)
        if cuda:
            torch.cuda.synchronize(mesh.device)
        out["partition_exchange_s"] = time.perf_counter() - t0
        every = slab_join.candidate_blocks(points, eps, mesh.n_slabs,
                                           device=mesh.device)
        differ = not all(torch.equal(a[0], b[mesh.slab])
                         for a, b in zip(mine, every))
        out["blocks_equal"] = not slab_join._any(mesh, differ)
        if mesh.rank == 0 and pairs is not None:
            fused_join.GID_LAUNCHES = 0
            ref = slab_join.distributed_self_join(points, eps, mesh.n_slabs,
                                                  device=mesh.device)
            out["one_process_gid_launches"] = fused_join.GID_LAUNCHES
            out["pairs_equal"] = bool(torch.equal(pairs, ref))
    return out


def run_rank(rank, grids, device, points, eps, check=False) -> dict:
    """One rank of the collective slab join of ``points`` (a worker for
    ``spawn``). ``grids`` holds ``(n_slabs, n_model, steps)`` tuples, each a
    mesh over the same ranks and the steps run on it: "pairs"
    (``distributed_self_join``), "count_only" (its ``return_pairs=False``)
    and "plain_count" (``distributed_self_join_count``, its offsets sharded
    over the model index when ``n_model > 1``). Each step reports its
    value, seconds (ending in a synchronize), the rank's peak device memory
    and B1 (d)'s launches; ``entered_at`` / ``left_at`` (``time.time()``)
    bound the rank's work, so a caller can tell start-up from work.

    ``check`` holds the collective against the one-process slab join on
    the rank's device: the rank's candidate block (timed with the
    partition, ``partition_exchange_s``) against block ``slab`` of the
    one-process exchange (``blocks_equal``, the mismatch flag all-reduced
    over the ranks), and on rank 0 the gathered pairs against
    the one-process ``distributed_self_join``'s (``pairs_equal``) with
    that join's B1 (d) launches (``one_process_gid_launches``)."""
    entered = time.time()
    out = dict(rank=rank, entered_at=entered, grids=[])
    for n_slabs, n_model, steps in grids:
        mesh = make_slab_mesh(n_slabs, n_model, device=device)
        out.update(backend=mesh.backend, device=str(mesh.device))
        out["grids"].append(_run_steps(mesh, points, eps, steps, check))
    out["left_at"] = time.time()
    return out


def main(argv=None):
    import numpy as np

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--slabs", type=int, default=2)
    ap.add_argument("--model", type=int, default=1,
                    help="ranks a slab: the count's offset-parallel axis")
    ap.add_argument("--count", action="store_true",
                    help="the plain offset-sweep count "
                         "(distributed_self_join_count), not the pairs")
    ap.add_argument("--device", default=None,
                    help="CUDA by default; 'cpu' runs the plain versions")
    ap.add_argument("--backend", default=None, choices=("gloo", "nccl"))
    ap.add_argument("--points", type=int, default=20000)
    ap.add_argument("--dims", type=int, default=2)
    ap.add_argument("--eps", type=float, default=0.5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.model > 1 and not args.count:
        raise SystemExit("--model > 1 shards the count's offsets: add "
                         "--count")
    pts = np.random.default_rng(args.seed).uniform(
        0, 100, (args.points, args.dims))
    t0 = time.perf_counter()
    step = "plain_count" if args.count else "pairs"
    ranks = spawn(run_rank, args.slabs * args.model,
                  [(args.slabs, args.model, (step,))], args.device, pts,
                  args.eps, backend=args.backend, device=args.device)
    out = {("total" if args.count else "pairs"):
           ranks[0]["grids"][0][step]["value"],
           "slabs": args.slabs, "model": args.model,
           "backend": ranks[0]["backend"],
           "devices": sorted({r["device"] for r in ranks}),
           "rank_seconds": [r["grids"][0][step]["seconds"] for r in ranks],
           "seconds": time.perf_counter() - t0}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    # the package's own module, not this __main__ copy: the ranks unpickle
    # ``run_rank`` and the joins check ``SlabMesh`` by that name
    from repro_torch.launch import mesh as _mesh
    _mesh.main()
