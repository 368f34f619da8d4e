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

The LM meshes (``LMMesh``) are the counterparts of JAX's named meshes for
training: ``make_production_mesh`` ((16, 16) ``("data", "model")`` or
(2, 16, 16) ``("pod", "data", "model")``), ``make_smoke_mesh``,
``make_mesh_compat`` and ``make_selfjoin_mesh``. JAX counts devices; these
count the ranks of the default process group (a one-rank group on a file
store when none is initialized), lay them out row-major over the mesh's
axes, as ``jax.make_mesh`` does on the CPU, and refuse a mesh that needs
more ranks than the world has. Every collective of an ``LMMesh`` passes
through host memory on gloo (``wire``), so that ranks sharing one card
run their compute on it.

A ``PlanMesh`` (``plan_mesh``, ``make_production_mesh(plan=True)``) is one
rank of an ``LMMesh`` of any size with no world: it records each
collective, with its bytes and member ranks, and returns meta tensors, so
that ``launch/dryrun.py`` plans a step of the production meshes on a
machine with no card and no process group.
"""
from __future__ import annotations

import argparse
import atexit
import contextlib
import dataclasses
import datetime
import itertools
import json
import math
import os
import pickle
import shutil
import tempfile
import time
from pathlib import Path
from typing import Any, Optional, Sequence

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
# The LM meshes
# ---------------------------------------------------------------------------

def init_world(device=None, timeout_s: float = DEFAULT_TIMEOUT_S) -> tuple:
    """(rank, world size) of the default process group, which is made here
    when none is: from torchrun's environment (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``) when it is set, with ``choose_backend``'s backend,
    else a one-rank gloo group on a file store in a temporary directory,
    as ``spawn``'s ranks meet."""
    if not dist.is_initialized():
        timeout = datetime.timedelta(seconds=timeout_s)
        env = os.environ
        if all(k in env for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR")):
            dist.init_process_group(
                choose_backend(int(env["WORLD_SIZE"]), device),
                init_method="env://", timeout=timeout)
        else:
            tmp = tempfile.mkdtemp(prefix="lm_mesh_")
            atexit.register(shutil.rmtree, tmp, True)
            dist.init_process_group(
                "gloo", init_method=f"file://{tmp}/store", rank=0,
                world_size=1, timeout=timeout)
    return dist.get_rank(), dist.get_world_size()


def spec_axes(entry) -> tuple:
    """The mesh axes of one spec entry: ``None``, a name or a tuple of
    names (major first)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


def _from_bytes(buf: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return buf.clone().view(like.dtype).reshape(like.shape)


class LMMesh:
    """One rank's view of a named grid of ranks, the counterpart of a JAX
    ``Mesh`` for the LM substrate. ``axis_names`` and ``shape`` (axis name
    to size, in mesh order) are what ``make_shard_ctx`` and
    ``choose_layout`` read; ``coords`` is this rank's place on each axis,
    the rank being the row-major index of its coordinates.

    A spec tuple (``models/layers.py``) names, for each dimension of a
    tensor, the axes it is split over: a rank holds the block of its
    coordinates (``local``), and ``gather`` puts the blocks back together.
    The collectives run over the sub-grid of the ranks that differ only on
    the named axes (one process group each, made when the mesh is), pass
    through host memory on gloo (``wire``), and add their calls, seconds
    (ending in a synchronize of the device) and bytes to ``stats`` under a
    kind: "params" (parameter gathers), "grads" (gradient sums), "loss",
    "expert" (the moe all-to-all, and the decode fold's row and expert
    gathers), "tp" (the activation collectives of tensor parallelism over
    'model': the cut points' sums, the vocab's logsumexp combine, the
    decode's head gathers, and the KV cache's heads-to-sequence
    all-to-all at prefill, which moves 'model' like any other 'model'
    collective), "cache" (a decode's partial-softmax combine over the
    cache's sequence axes), "logits" (the inference logits gathered over
    the batch axes and 'model'), "pods" (the compressed exchange),
    "state" (checkpoints, optimizer norms), each in a ``mesh.<kind>``
    profiler span."""

    def __init__(self, shape, axes, rank: int, device: torch.device,
                 backend: str, groups: dict):
        self.axis_names = tuple(axes)
        self.sizes = tuple(int(n) for n in shape)
        self.shape = dict(zip(self.axis_names, self.sizes))
        self.size = math.prod(self.sizes)
        self.rank = rank
        self.device = device
        self.backend = backend
        self._groups = groups
        self.coords = self.coords_of(rank)
        self.stats: dict = {}

    def __repr__(self) -> str:
        return (f"LMMesh({self.shape}, rank={self.rank}, "
                f"device={self.device}, backend={self.backend})")

    @property
    def wire(self) -> torch.device:
        return self.device if self.backend == "nccl" else torch.device("cpu")

    def coords_of(self, rank: int) -> dict:
        out, rest = {}, rank
        for name, n in reversed(list(zip(self.axis_names, self.sizes))):
            out[name] = rest % n
            rest //= n
        return {a: out[a] for a in self.axis_names}

    def live(self, axes) -> tuple:
        """``axes`` of more than one rank, in mesh order; an axis the mesh
        lacks raises."""
        axes = set(axes)
        unknown = axes - set(self.axis_names)
        if unknown:
            raise ValueError(f"axes {sorted(unknown)} are not on the mesh "
                             f"{self.axis_names}")
        return tuple(a for a in self.axis_names
                     if a in axes and self.shape[a] > 1)

    def group(self, axes):
        """(process group, member ranks in rank order) of the ranks that
        share this rank's coordinates off ``axes``; None when ``axes``
        holds no axis of more than one rank."""
        live = self.live(axes)
        return self._groups[frozenset(live)] if live else None

    def spec_live(self, spec) -> tuple:
        return self.live(a for e in spec for a in spec_axes(e))

    def entry_live(self, entry) -> tuple:
        """The live axes of one spec entry, in the entry's order (its
        first axis major, as in JAX's ``PartitionSpec``)."""
        live = set(self.live(spec_axes(entry)))
        return tuple(a for a in spec_axes(entry) if a in live)

    def owner(self, spec) -> bool:
        """Whether this rank holds the first copy of its block of a tensor
        laid out by ``spec`` (coordinate 0 on every axis the spec leaves
        out)."""
        named = set(self.spec_live(spec))
        return all(self.coords[a] == 0 for a in self.live(self.axis_names)
                   if a not in named)

    # -- blocks -------------------------------------------------------------

    def _index(self, axes, coords) -> tuple:
        """(block index, block count) over ``axes``, the first major."""
        idx, n = 0, 1
        for a in axes:
            idx = idx * self.shape[a] + coords[a]
            n *= self.shape[a]
        return idx, n

    def block(self, spec, shape, coords=None, over=None) -> tuple:
        """The slices of this rank's block (or ``coords``') of a tensor of
        the whole ``shape`` laid out by ``spec``; with ``over``, split
        over those axes only."""
        coords = self.coords if coords is None else coords
        spec = tuple(spec) + (None,) * (len(shape) - len(spec))
        out = []
        for d, (entry, size) in enumerate(zip(spec, shape)):
            axes = [a for a in self.entry_live(entry)
                    if over is None or a in over]
            idx, n = self._index(axes, coords)
            if size % n:
                raise ValueError(f"dimension {d} of {tuple(shape)} does not "
                                 f"split over {spec_axes(entry)} ({n} ranks)")
            step = size // n
            out.append(slice(idx * step, (idx + 1) * step))
        return tuple(out)

    def local(self, full: torch.Tensor, spec) -> torch.Tensor:
        """This rank's block of ``full`` (a copy on ``device``)."""
        return full[self.block(spec, full.shape)].to(
            self.device, copy=True).contiguous()

    def local_tree(self, tree, specs):
        from repro_torch.models.layers import tree_at, tree_map_with_path
        return tree_map_with_path(
            lambda path, t: self.local(t, tree_at(specs, path)), tree)

    # -- collectives --------------------------------------------------------

    @contextlib.contextmanager
    def timed(self, kind: str, nbytes: int = 0):
        from torch.profiler import record_function
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        with record_function(f"mesh.{kind}"):
            yield
        if cuda:
            torch.cuda.synchronize(self.device)
        calls, secs, moved = self.stats.get(kind, (0, 0.0, 0))
        self.stats[kind] = (calls + 1, secs + time.perf_counter() - t0,
                            moved + nbytes)

    def calls_and_bytes(self, since=None) -> dict:
        """``stats`` as kind -> [calls, bytes], less ``since`` (an earlier
        copy of ``stats``): what a stretch of work issued."""
        since = since or {}
        out = {}
        for kind, (calls, _, moved) in self.stats.items():
            c0, _, m0 = since.get(kind, (0, 0.0, 0))
            out[kind] = [calls - c0, moved - m0]
        return out

    def _issue(self, op: str, kind: str, nbytes: int, group, call) -> None:
        """Run ``call``, one collective ``op`` (a ``roofline.KINDS`` name)
        over ``group``, counted under ``kind`` with ``nbytes`` (S of the
        roofline's ring model)."""
        with self.timed(kind, nbytes):
            call()

    def _gather_bytes(self, buf: torch.Tensor, group, kind: str) -> list:
        """Every member's ``buf`` (uint8), in member order."""
        g, members = group
        w = buf.to(self.wire)
        outs = [torch.empty_like(w) for _ in members]
        self._issue("all-gather", kind, buf.numel() * len(members), group,
                    lambda: dist.all_gather(outs, w, group=g))
        return [o.to(self.device) for o in outs]

    def gather_many(self, tensors: Sequence[torch.Tensor], specs,
                    keep=None, kind: str = "params") -> list:
        """Each tensor's blocks put together over the live axes its spec
        names, except those its ``keep`` spec names (kept: the result is
        still this rank's block over them): one all-gather for each set of
        axes gathered over, whatever the dtypes."""
        keep = keep or [()] * len(tensors)
        out = list(tensors)
        by_axes: dict = {}
        for i, (t, spec, kp) in enumerate(zip(tensors, specs, keep)):
            kept = set(self.spec_live(kp))
            over = tuple(a for a in self.spec_live(spec) if a not in kept)
            if over:
                by_axes.setdefault(over, []).append(i)
        for over, idx in by_axes.items():
            group = self.group(over)
            bufs = self._gather_bytes(
                torch.cat([_bytes(tensors[i]) for i in idx]), group, kind)
            _, members = group
            off = 0
            for i in idx:
                t, spec = tensors[i], tuple(specs[i])
                spec = spec + (None,) * (t.ndim - len(spec))
                nb = t.numel() * t.element_size()
                dims = [self._index([a for a in spec_axes(e) if a in over],
                                    self.coords)[1] for e in spec]
                whole = torch.empty([n * m for n, m in zip(t.shape, dims)],
                                    dtype=t.dtype, device=self.device)
                for r, b in zip(members, bufs):
                    c = self.coords_of(r)
                    sl = []
                    for e, size in zip(spec, t.shape):
                        axes = self.entry_live(e)
                        moved = [a for a in axes if a in over]
                        kept = tuple(a for a in axes if a not in over)
                        if moved and axes[:len(kept)] != kept:
                            raise ValueError(f"spec entry {e}: a kept axis "
                                             f"must be major")
                        j, _ = self._index(moved, c)
                        sl.append(slice(j * size, (j + 1) * size))
                    whole[tuple(sl)] = _from_bytes(b[off:off + nb], t)
                out[i] = whole
                off += nb
        return out

    def gather(self, t: torch.Tensor, spec, kind: str = "state"):
        return self.gather_many([t], [spec], kind=kind)[0]

    def gather_tree(self, tree, specs, kind: str = "state"):
        """The whole tensors of a tree of blocks (a collective)."""
        from repro_torch.models.layers import (tree_at,
                                               tree_flatten_with_path,
                                               tree_map_with_path)
        flat = tree_flatten_with_path(tree)
        whole = self.gather_many([t for _, t in flat],
                                 [tree_at(specs, p) for p, _ in flat],
                                 kind=kind)
        by_path = {p: w for (p, _), w in zip(flat, whole)}
        return tree_map_with_path(lambda path, _: by_path[path], tree)

    def all_reduce_many(self, tensors: Sequence[torch.Tensor], axes,
                        op: str = "sum", kind: str = "grads") -> list:
        """Each tensor reduced over ``axes`` in one float32 buffer (the sum
        of bfloat16 gradients in float32, cast back to their dtype)."""
        group = self.group(axes)
        if group is None or not tensors:
            return list(tensors)
        flat = torch.cat([t.detach().float().reshape(-1) for t in tensors])
        w = flat.to(self.wire)
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        self._issue("all-reduce", kind, flat.numel() * 4, group,
                    lambda: dist.all_reduce(w, op=red, group=group[0]))
        w = w.to(self.device)
        out, off = [], 0
        for t in tensors:
            out.append(w[off:off + t.numel()].reshape(t.shape).to(t.dtype))
            off += t.numel()
        return out

    def all_reduce(self, t: torch.Tensor, axes, op: str = "sum",
                   kind: str = "loss") -> torch.Tensor:
        return self.all_reduce_many([t], axes, op, kind)[0]

    def all_gather_stack(self, t: torch.Tensor, axis: str,
                         kind: str = "pods") -> torch.Tensor:
        """(n, *t.shape): every rank's ``t`` along ``axis``, by coordinate."""
        group = self.group((axis,))
        if group is None:
            return t[None]
        bufs = self._gather_bytes(_bytes(t), group, kind)
        return torch.stack([_from_bytes(b, t) for b in bufs])

    def all_to_all(self, x: torch.Tensor, axis: str, split_dim: int,
                   cat_dim: int, kind: str = "expert") -> torch.Tensor:
        """Split ``x`` along ``split_dim`` into one chunk a rank of
        ``axis`` (by coordinate), send each its chunk, and concatenate what
        arrives along ``cat_dim`` (by the sender's coordinate)."""
        group = self.group((axis,))
        if group is None:
            return x
        g, members = group
        n = len(members)
        chunks = [c.contiguous() for c in torch.tensor_split(x, n, split_dim)]
        send = torch.stack([_bytes(c) for c in chunks]).to(self.wire)
        recv = torch.empty_like(send)
        self._issue("all-to-all", kind, send.numel(), group,
                    lambda: dist.all_to_all_single(recv, send, group=g))
        recv = recv.to(self.device)
        return torch.cat([_from_bytes(recv[i], chunks[0]) for i in range(n)],
                         dim=cat_dim)

    def any(self, flag: bool) -> bool:
        """Whether ``flag`` is set on any rank of the mesh (a collective:
        every rank calls it before any raises)."""
        t = torch.tensor([1.0 if flag else 0.0])
        return bool(self.all_reduce(t.to(self.device), self.axis_names,
                                    "max", kind="state")[0] > 0)


class PlanMesh(LMMesh):
    """A planning mesh: one rank's view of an ``LMMesh`` with no process
    group, no world and no device. Its tensors live on ``meta``; each
    collective the model and the step issue is recorded in ``plan`` as
    ``(kind, op, bytes, member ranks)`` (``kind`` the ``stats`` kind,
    ``op`` a ``roofline.KINDS`` name, ``bytes`` what ``timed`` counts) and
    in ``stats`` with 0 seconds, and its result is a meta tensor of the
    shape the real collective gives. ``any`` is recorded as its
    all-reduce and returns False. Every rank of an ``LMMesh`` issues the
    same collectives (SPMD: a skipped one hangs the others), so one rank's
    plan is the step's schedule. ``launch/dryrun.py`` runs the train step
    on one to count its FLOPs, bytes and collectives."""

    def __init__(self, shape, axes, rank: int = 0):
        super().__init__(shape, axes, rank, torch.device("meta"), "plan", {})
        self.plan: list = []

    @property
    def wire(self) -> torch.device:
        return self.device

    def group(self, axes):
        live = self.live(axes)
        if not live:
            return None
        key = frozenset(live)
        if key not in self._groups:
            fixed = {a: c for a, c in self.coords.items() if a not in key}
            members = [r for r in range(self.size)
                       if all(self.coords_of(r)[a] == c
                              for a, c in fixed.items())]
            self._groups[key] = (None, members)
        return self._groups[key]

    @contextlib.contextmanager
    def timed(self, kind: str, nbytes: int = 0):
        yield
        calls, secs, moved = self.stats.get(kind, (0, 0.0, 0))
        self.stats[kind] = (calls + 1, secs, moved + nbytes)

    def _issue(self, op: str, kind: str, nbytes: int, group, call) -> None:
        with self.timed(kind, nbytes):
            self.plan.append((kind, op, int(nbytes), tuple(group[1])))

    def any(self, flag: bool) -> bool:
        self.all_reduce(torch.zeros(1, device=self.device), self.axis_names,
                        "max", kind="state")
        return False


def plan_mesh(shape, axes, rank: int = 0) -> PlanMesh:
    """Rank ``rank``'s ``PlanMesh`` of ``shape`` over the named ``axes``
    (any size: no world is asked)."""
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes) or len(set(axes)) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} do not match")
    if not 0 <= rank < math.prod(shape):
        raise ValueError(f"rank {rank} is not on a {shape} mesh")
    return PlanMesh(shape, axes, rank)


def make_mesh_compat(shape, axes, *, device=None) -> Optional[LMMesh]:
    """This rank's ``LMMesh`` of ``shape`` over the named ``axes``, laid
    over the first ``prod(shape)`` ranks of the world (a rank past them
    gets None). Raises ``ValueError`` when the world has fewer ranks.
    Every rank of the world calls it: the sub-grids' process groups are
    made together. ``device``: as ``make_slab_mesh``'s."""
    import numpy as np

    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes) or len(set(axes)) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} do not match")
    rank, world = init_world(device)
    need = math.prod(shape)
    if need > world:
        raise ValueError(f"a {shape} mesh over {axes} needs {need} ranks, "
                         f"the world has {world}")
    grid = np.arange(need).reshape(shape)
    live = [a for a, n in zip(axes, shape) if n > 1]
    groups = {}
    for k in range(1, len(live) + 1):
        for sub in itertools.combinations(live, k):
            dims = [axes.index(a) for a in sub]
            moved = np.moveaxis(grid, dims, range(len(shape) - k, len(shape)))
            for members in moved.reshape(-1, math.prod(moved.shape[-k:])):
                members = sorted(int(r) for r in members)
                g = dist.new_group(members)
                if rank in members:
                    groups[frozenset(sub)] = (g, members)
    if rank >= need:
        return None
    dev = _rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.init()
        torch.cuda.set_device(dev)
    return LMMesh(shape, axes, rank, dev, dist.get_backend(), groups)


def make_production_mesh(*, multi_pod: bool = False, device=None,
                         plan: bool = False) -> LMMesh:
    """(16, 16) ``("data", "model")``, or (2, 16, 16) ``("pod", "data",
    "model")``: batch over ('pod', 'data'), FSDP over 'data', tensor and
    expert parallelism over 'model'. ``plan=True``: rank 0's
    ``PlanMesh`` of that shape, which needs no world (the dry run's)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if plan:
        return plan_mesh(shape, axes)
    return make_mesh_compat(shape, axes, device=device)


def make_smoke_mesh(n_devices: int = 1, *, device=None) -> LMMesh:
    """A small mesh over the world's ranks (tests, the chip smoke):
    ``(n // model, model)`` ``("data", "model")``, n the smaller of
    ``n_devices`` and the world, model 2 when n is even."""
    _, world = init_world(device)
    n = min(n_devices, world)
    model = 2 if n % 2 == 0 else 1
    return make_mesh_compat((n // model, model), ("data", "model"),
                            device=device)


def make_selfjoin_mesh(*, multi_pod: bool = False, device=None,
                       plan: bool = False) -> SlabMesh:
    """The self-join's ``("slab", "model")`` mesh: (16, 16), or (32, 16)
    with pod x data flattened into 'slab'. ``plan=True``: rank 0's place
    on it with no process group (backend "plan", device ``meta``), which
    ``launch/dryrun.py`` plans the ring of the slab join on."""
    n_slabs = 32 if multi_pod else 16
    if plan:
        return SlabMesh(None, n_slabs, 16, 0, torch.device("meta"), "plan")
    init_world(device)
    return make_slab_mesh(n_slabs, 16, device=device)


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
