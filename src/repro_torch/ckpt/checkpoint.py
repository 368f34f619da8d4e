"""Fault-tolerant checkpointing: one .npy a leaf + an atomic manifest.

The counterpart of ``repro.ckpt.checkpoint``, on JAX's on-disk layout, so
that either package restores the other's checkpoints:

    <dir>/step_<N>/
        manifest.json      step, leaves [{name, file, shape, dtype}],
                           extra, complete
        leaf_<i>.npy       one file a leaf, in JAX's flatten order
    <dir>/step_<N>.tmp/    staging; renamed on completion

Leaf names are the ``/``-joined dict keys from the root. bfloat16 leaves
are stored as their raw 2-byte words (numpy's ``V2``, as ``np.save``
writes JAX's ``ml_dtypes`` arrays), with ``"bfloat16"`` in the manifest;
restore views them back through ``torch.Tensor.view(torch.bfloat16)``, so
the port needs no ``ml_dtypes``.

Guarantees, as the reference's: a step directory either fully exists
(rename is atomic on POSIX) or is ignored staging, and readers trust only
a manifest whose ``complete`` flag is set; ``CheckpointManager`` snapshots
to the host on the caller's thread, writes on a background thread, keeps
one save in flight, raises a save's error on the next ``wait()`` and keeps
the last k steps.

On a mesh (``launch.mesh.LMMesh``) the leaves are this rank's blocks. A
save gathers the whole arrays, in JAX's layout, with a collective that
every rank joins on the caller's thread; rank 0 alone writes, renames and
garbage-collects, and ``wait()`` ends with every rank learning whether it
failed (an all-reduced flag), so that every rank raises or none does and
no rank reads a step before its rename. A leaf that the spec leaves whole
over an axis is taken from coordinate 0 of that axis, as JAX's logical
array reads it: a pod-compressed run's ``grad_error`` is pod 0's (ROADMAP
§C, C10). ``restore_checkpoint(..., mesh=, specs=)`` keeps each rank's
block of every stored leaf: the elastic path, from any mesh to any other.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.models.layers import (tree_flatten_with_path, tree_map,
                                       tree_map_with_path)

_BF16_WORD = np.dtype("V2")


def _name(path: tuple) -> str:
    return "/".join(str(k) for k in path)


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A leaf as a numpy array on the host; bfloat16 as its raw words."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_WORD)
    return t.numpy()


def save_checkpoint(directory: str, step: int, tree: Any, *,
                    extra: Optional[dict] = None) -> str:
    """Blocking save. Returns the final path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": [], "extra": extra or {},
                "complete": False}
    for i, (path, leaf) in enumerate(tree_flatten_with_path(tree)):
        arr = _to_host(leaf)
        fn = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fn), arr)
        manifest["leaves"].append(
            {"name": _name(path), "file": fn, "shape": list(arr.shape),
             "dtype": ("bfloat16" if leaf.dtype == torch.bfloat16
                       else str(arr.dtype))})
    manifest["complete"] = True
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for d in os.listdir(directory):
        if d.startswith("step_") and not d.endswith(".tmp"):
            man = os.path.join(directory, d, "manifest.json")
            if os.path.exists(man):
                try:
                    with open(man) as f:
                        if json.load(f).get("complete"):
                            steps.append(int(d.split("_")[1]))
                except (ValueError, json.JSONDecodeError):
                    continue
    return max(steps) if steps else None


def _from_host(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if arr.dtype.kind == "V" or dtype_name == "bfloat16":
        if dtype_name != "bfloat16" or arr.dtype.itemsize != 2:
            raise ValueError(f"cannot read a {arr.dtype} leaf recorded as "
                             f"{dtype_name!r}")
        words = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(words.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def restore_checkpoint(directory: str, step: int, like: Any, *,
                       mesh=None, specs: Any = None) -> Any:
    """Restore into the structure of ``like``: each leaf takes the dtype
    and device of ``like``'s leaf of the same name. With ``mesh`` and
    ``specs`` (a tree of spec tuples over ``like``'s keys), each rank
    keeps its block of every stored leaf."""
    if (mesh is None) != (specs is None):
        raise ValueError("restoring onto a mesh needs both mesh and specs")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["complete"], f"incomplete checkpoint at {path}"
    by_name = {e["name"]: e for e in manifest["leaves"]}

    def load(lpath, leaf):
        e = by_name[_name(lpath)]
        t = _from_host(np.load(os.path.join(path, e["file"])), e["dtype"])
        if mesh is not None:
            spec = specs
            for k in lpath:
                spec = spec[k]
            t = t[mesh.block(spec, t.shape)].contiguous()
        return t.to(device=leaf.device, dtype=leaf.dtype)

    return tree_map_with_path(load, like)


class CheckpointManager:
    """Async saves + retention. One in-flight save at a time. With
    ``mesh``, every rank calls ``save_async`` and ``wait`` at the same
    points, with ``specs`` for the tree's blocks."""

    def __init__(self, directory: str, keep_last_k: int = 3, *, mesh=None):
        self.directory = directory
        self.keep = keep_last_k
        self.mesh = mesh
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    @property
    def writes(self) -> bool:
        return self.mesh is None or self.mesh.rank == 0

    def save_async(self, step: int, tree: Any, extra: Optional[dict] = None,
                   *, specs: Any = None):
        self.wait()
        if self.mesh is not None:       # every rank gathers the blocks
            if specs is None:
                raise ValueError("a save from a mesh needs the tree's specs")
            tree = self.mesh.gather_tree(tree, specs)
        if not self.writes:
            return
        # snapshot on the caller thread (device to host), write on the
        # background thread
        host_tree = tree_map(
            lambda t: t.detach().to("cpu", copy=True), tree)

        def work():
            try:
                save_checkpoint(self.directory, step, host_tree, extra=extra)
                self._gc()
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        err, self._error = self._error, None
        if self.mesh is not None and self.mesh.any(err is not None):
            raise err if err is not None else RuntimeError(
                f"a checkpoint save under {self.directory} failed on "
                f"rank 0")
        if err is not None:
            raise err

    def _gc(self):
        steps = sorted(
            int(d.split("_")[1]) for d in os.listdir(self.directory)
            if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

