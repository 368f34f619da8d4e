"""Weights across packages and devices.

``params_from_jax`` takes the JAX package's parameter tree as numpy arrays
(``jax.tree.map(np.asarray, params)``) and returns the port's parameters on
a device; ``params_to_numpy`` goes back, bit for bit. Both keep the stacked
(L, ...) leaves stacked: the two packages' trees have the same keys.

bfloat16 arrives as ``ml_dtypes.bfloat16``, which ``torch.from_numpy``
refuses; its bits go through a ``uint16`` view, so the port needs no
``ml_dtypes`` import. ``seeded_params`` draws one set of weights with
numpy (JAX's distributions, ``LMModel.init``), so that the same weights
reach JAX, the CPU and the card from one seed.

On a mesh (``launch.mesh.LMMesh``): ``seeded_params(..., mesh=)`` keeps
this rank's block of every leaf, and ``params_from_mesh`` gathers the
blocks back to whole numpy arrays (a collective: every rank calls it), so
that the port and JAX start from, and are compared on, the same weights
on any mesh. ``caches_to_mesh`` and ``caches_from_mesh`` do the same for
serving caches (a JAX cache tree as numpy, or the unmeshed port's),
laid out by ``LMModel.cache_specs``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.attention import KVCache
from repro_torch.models.layers import tree_map


def _from_numpy(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        host = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        host = torch.from_numpy(np.array(a, copy=True))
    return host.to(device)


def params_from_jax(tree, device=None):
    """The port's parameters, on ``device`` (CUDA unless given), from a
    tree of numpy arrays (dicts nest as JAX's do)."""
    from repro_torch.core.grid import resolve_device

    dev = resolve_device(device)
    return tree_map(lambda a: _from_numpy(a, dev), tree)


def _to_numpy(t: torch.Tensor, bfloat16):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        bits = t.view(torch.int16).numpy().view(np.uint16)
        return bits.view(bfloat16) if bfloat16 is not None else bits
    return t.numpy()


def params_to_numpy(params, bfloat16=None):
    """The parameters as numpy arrays on the host. bfloat16 leaves come
    back as their ``uint16`` bits, or viewed as ``bfloat16`` when given a
    numpy bfloat16 dtype (``ml_dtypes.bfloat16``, which JAX registers)."""
    return tree_map(lambda t: _to_numpy(t, bfloat16), params)


def seeded_params(cfg, seed: int, device=None, *, mesh=None):
    """(params on ``device``, specs) drawn from ``np.random.default_rng(seed)``
    in JAX's distributions: the same values on every device. With
    ``mesh``, this rank's blocks on the mesh's device."""
    from repro_torch.models.lm import LMModel

    return LMModel(cfg, mesh, device=device).init(
        np.random.default_rng(seed))


def params_from_mesh(params, specs, mesh, bfloat16=None):
    """The whole arrays of a tree of blocks, as numpy on every rank."""
    return params_to_numpy(mesh.gather_tree(params, specs), bfloat16)


def _is_length(t) -> bool:
    """A cache's lengths or ``max_len``: int32 counters of at most one
    dimension, kept on the host by the port."""
    return t.ndim <= 1 and str(t.dtype).endswith("int32")


def _with_max_len(kv):
    """A KV cache as the port's: JAX's (k, v, length) gains the whole
    ``max_len`` on the host, which a rank's block does not tell."""
    if len(kv) != 3:        # the port's, or () where the family has none
        return kv
    return KVCache(k=kv.k, v=kv.v, length=kv.length,
                   max_len=np.int32(np.shape(kv.k)[2]))


def caches_to_mesh(tree, model, layout):
    """This rank's block of whole caches (the port's, as tensors or numpy
    arrays, or JAX's ``StackCaches`` as numpy), laid out by ``layout`` on
    the model's mesh of ranks; the lengths stay on the host."""
    from repro_torch.models.layers import tree_at, tree_map_with_path

    tree = tree._replace(kv=_with_max_len(tree.kv),
                         shared_kv=_with_max_len(tree.shared_kv))
    specs = model.cache_specs(layout)

    def one(path, a):
        t = a if isinstance(a, torch.Tensor) else _from_numpy(a, "cpu")
        if _is_length(t):
            return t.cpu()
        return model.ranks.local(t, tree_at(specs, path))

    return tree_map_with_path(one, tree)


def caches_from_mesh(caches, model, layout, bfloat16=None):
    """The whole caches of the ranks' blocks as numpy, on every rank (a
    collective: every rank calls it)."""
    whole = model.ranks.gather_tree(caches, model.cache_specs(layout))
    return params_to_numpy(whole, bfloat16)
