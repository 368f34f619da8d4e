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
"""
from __future__ import annotations

import numpy as np
import torch

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


def seeded_params(cfg, seed: int, device=None):
    """(params on ``device``, specs) drawn from ``np.random.default_rng(seed)``
    in JAX's distributions: the same values on every device."""
    from repro_torch.models.lm import LMModel

    return LMModel(cfg, device=device).init(np.random.default_rng(seed))
