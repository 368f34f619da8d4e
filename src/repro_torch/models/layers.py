"""Shared layers: parameters carry sharding specs as a parallel tree.

The counterpart of ``repro.models.layers``. Every parameter-creating helper
returns ``(tensor, spec)``, where a spec is a plain tuple with one mesh axis
name (or ``None``) a dimension, mirroring JAX's ``PartitionSpec``; model init
assembles parallel (params, specs) trees of nested dicts. The convention for
2-D weights is (fsdp, tp): the input dimension over the FSDP ('data') axis,
the output over the tensor ('model') axis, unless a dimension does not
divide its axis, and then that dimension is replicated.

Values come from a ``ParamInit``: a ``torch.Generator`` (normal draws on the
host), a numpy ``Generator`` (the same distributions drawn by numpy, so that
one seeded set of weights reaches JAX and every device alike), or nothing
(tensors on the ``meta`` device: shapes, dtypes and specs only). JAX's
``shard`` has no counterpart: off a mesh it is the identity.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name ("bfloat16", "float32")."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def tree_map(fn, tree):
    """``fn`` over the tensor leaves of a tree, as ``tree_map_with_path``
    walks it."""
    return tree_map_with_path(lambda _, t: fn(t), tree)


def tree_flatten_with_path(tree, path: tuple = ()) -> list:
    """``(path, leaf)`` pairs in JAX's flatten order: dict keys sorted,
    sequences by index, ``None`` and ``()`` holding no leaf. A path is the
    tuple of keys and indices from the root."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in tree_flatten_with_path(tree[k], path + (k,))]
    if isinstance(tree, (tuple, list)):
        return [pl for i, v in enumerate(tree)
                for pl in tree_flatten_with_path(v, path + (i,))]
    if tree is None:
        return []
    return [(path, tree)]


def tree_map_with_path(fn, tree, path: tuple = ()):
    """``fn(path, leaf)`` over the leaves of nested dicts, tuples,
    NamedTuples and lists, keeping the structure (``None`` and ``()`` stay);
    paths as in ``tree_flatten_with_path``."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        out = [tree_map_with_path(fn, v, path + (i,))
               for i, v in enumerate(tree)]
        if isinstance(tree, list):
            return out
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    if tree is None:
        return None
    return fn(path, tree)


class ParamInit:
    """Where parameter values come from, and where they go.

    ``source``: a ``torch.Generator`` (CPU), a ``numpy.random.Generator``,
    or ``None`` for ``meta`` tensors. Normal draws are float32 on the host,
    scaled there and cast to the parameter's dtype, then moved to
    ``device``. ``lead`` is prepended to every shape (the stacked layer
    dimension)."""

    def __init__(self, source, device, lead: tuple = ()):
        self.source = source
        self.device = torch.device("meta") if source is None else device
        self.lead = tuple(lead)

    def stacked(self, n: int) -> "ParamInit":
        return ParamInit(self.source, self.device, (n,) + self.lead)

    def _put(self, host: torch.Tensor, dtype) -> torch.Tensor:
        return host.to(dtype).to(self.device)

    def normal(self, shape, scale: float, dtype) -> torch.Tensor:
        shape = self.lead + tuple(shape)
        if self.source is None:
            return torch.empty(shape, dtype=dtype, device="meta")
        if isinstance(self.source, np.random.Generator):
            draw = torch.from_numpy(
                self.source.standard_normal(shape, dtype=np.float32))
        else:
            draw = torch.randn(shape, generator=self.source,
                               dtype=torch.float32)
        return self._put(draw * scale, dtype)

    def full(self, shape, value: float, dtype) -> torch.Tensor:
        shape = self.lead + tuple(shape)
        if self.source is None:
            return torch.empty(shape, dtype=dtype, device="meta")
        return self._put(torch.full(shape, value, dtype=torch.float32), dtype)

    def value(self, array: np.ndarray, dtype) -> torch.Tensor:
        """A fixed per-layer value, broadcast over ``lead``."""
        shape = self.lead + tuple(array.shape)
        if self.source is None:
            return torch.empty(shape, dtype=dtype, device="meta")
        host = torch.from_numpy(np.ascontiguousarray(array))
        return self._put(host.expand(shape).contiguous(), dtype)


def _divisible(dim: int, axis_size: int) -> bool:
    return axis_size > 0 and dim % axis_size == 0


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Mesh axis names/sizes the init code uses to pick legal specs."""

    fsdp_axis: Optional[str]   # usually 'data'
    tp_axis: Optional[str]     # usually 'model'
    fsdp_size: int
    tp_size: int

    def axis(self, kind: str, dim: int):
        """Return the axis name for ``kind`` if ``dim`` divides, else None."""
        if kind == "tp" and self.tp_axis and _divisible(dim, self.tp_size):
            return self.tp_axis
        if kind == "fsdp" and self.fsdp_axis and _divisible(dim, self.fsdp_size):
            return self.fsdp_axis
        return None


def dense_param(init: ParamInit, d_in: int, d_out: int, ctx: ShardCtx, dtype,
                *, tp_dim: str = "out", scale: Optional[float] = None):
    """Weight (d_in, d_out); TP on ``tp_dim``, FSDP on the other dim."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = init.normal((d_in, d_out), scale, dtype)
    if tp_dim == "out":
        spec = (ctx.axis("fsdp", d_in), ctx.axis("tp", d_out))
    else:
        spec = (ctx.axis("tp", d_in), ctx.axis("fsdp", d_out))
    return w, spec


def bias_param(init: ParamInit, d: int, ctx: ShardCtx, dtype, *, tp: bool):
    return init.full((d,), 0.0, dtype), (ctx.axis("tp", d) if tp else None,)


def embed_param(init: ParamInit, vocab: int, d_model: int, ctx: ShardCtx,
                dtype):
    w = init.normal((vocab, d_model), 0.02, dtype)
    return w, (ctx.axis("tp", vocab), None)


def norm_param(init: ParamInit, d: int, dtype):
    return init.full((d,), 1.0, dtype), (None,)


def rms_norm(x, w, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w.float()).to(dt)


def rope_frequencies(head_dim: int, theta: float = 10000.0, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float = 10000.0):
    """x: (..., S, H, hd); positions: broadcastable to (..., S). The
    half-split form (the first and second halves of hd rotate together),
    angles in float32."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)              # (hd/2,)
    angles = positions[..., None].float() * freqs              # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                      # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def cross_entropy(logits, labels, *, z_loss: float = 0.0):
    """Mean token CE in f32; labels < 0 are masked out."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.clamp(min=0)[..., None].long())[..., 0]
    loss = lse - ll
    if z_loss:
        loss = loss + z_loss * lse ** 2
    mask = labels >= 0
    return torch.sum(loss * mask) / torch.clamp(mask.sum(), min=1)


def swiglu(x, w_gate, w_up, w_down):
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down
