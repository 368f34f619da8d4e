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
(tensors on the ``meta`` device: shapes, dtypes and specs only).

On a mesh (``launch.mesh.LMMesh``) the port computes with explicit
collectives, not with GSPMD. A parameter is stored as this rank's block of
its spec; ``constrain_tree``, JAX's ``with_sharding_constraint`` over a
parameter slice, gathers the blocks where the model reads them and, in the
backward, sums the gradient over the batch axes and keeps this rank's
block (JAX's reduce-scatter into the FSDP shards). An activation holds this
rank's rows of the batch, split over the layout's batch axes, and is whole
on every other dimension.

The 'model' axis computes (tensor parallelism, as JAX's layouts state it
and GSPMD runs it): ``constrain_tree``'s ``keep`` leaves the column-split
and row-split weights' compute views split over 'model', so their
gradients need no sum over 'model', and two cut points bracket each split
product. ``tp_copy`` is the identity in the forward and sums the gradient
over 'model' in the backward: it stands before a column-split product,
whose input every 'model' rank holds whole. ``tp_sum`` sums the partial
outputs of a row-split product over 'model' in the forward and is the
identity in the backward. Both issue their collectives under the "tp"
kind. ``shard`` is JAX's cut point where the layout moves: off a mesh the
identity, on one it moves a batch axis from one dimension to another (the
moe's expert all-to-all), and moves 'model' between dimensions of an
activation (a KV cache's heads to its sequence).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional

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


def tree_at(tree, path: tuple):
    """The subtree of ``tree`` at ``path`` (as ``tree_flatten_with_path``
    gives it)."""
    for k in path:
        tree = tree[k]
    return tree


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


# ---------------------------------------------------------------------------
# meshes: placements, the cut points, parameter gathers
# ---------------------------------------------------------------------------

def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def placements(spec, mesh) -> list:
    """DTensor's placements of a spec tuple on ``mesh``: for each mesh
    axis, ``Shard(d)`` where the spec names it on dimension d, else
    ``Replicate()``. ``('data', 'model')`` on a ``(data, model)`` mesh is
    ``[Shard(0), Shard(1)]``; an axis the spec leaves out is replicated."""
    from torch.distributed.tensor.placement_types import Replicate, Shard

    dim_of = {}
    for d, entry in enumerate(spec):
        for a in _entry_axes(entry):
            if a not in mesh.axis_names:
                raise ValueError(f"spec {tuple(spec)} names {a!r}, not an "
                                 f"axis of {tuple(mesh.axis_names)}")
            if a in dim_of:
                raise ValueError(f"spec {tuple(spec)} names {a!r} twice")
            dim_of[a] = d
    return [Shard(dim_of[a]) if a in dim_of else Replicate()
            for a in mesh.axis_names]


class MeshCtx(NamedTuple):
    """The mesh a model runs on; ``batch_axes``: the live axes (major
    first) that split an activation's rows and that the cut points move
    and sum over; ``tp_axis``: 'model' when it is live and not run by
    hand, the axis of tensor parallelism; ``manual``: the axes the caller
    runs by hand."""
    mesh: Any
    batch_axes: tuple
    tp_axis: Optional[str] = None
    manual: tuple = ()


# a process-wide setting, not a context variable: autograd's device thread
# runs the backward and the checkpoints' recomputation, and must see it
_MESH: Optional[MeshCtx] = None


def current_mesh() -> Optional[MeshCtx]:
    return _MESH


class mesh_context:
    """``with mesh_context(mesh, batch_axes, manual=()):`` runs the model on
    ``mesh`` (a no-op for ``mesh=None``); ``manual`` names axes the caller
    runs by hand (the compressed step's 'pod'), which no cut point moves
    or sums over. Nests, and restores the outer setting on exit."""

    def __init__(self, mesh, batch_axes, manual=()):
        self.ctx = None
        if mesh is not None:
            manual = tuple(manual)
            live = tuple(a for a in mesh.live(_entry_axes(batch_axes))
                         if a not in manual)
            tp = ("model" if "model" in mesh.live(mesh.axis_names)
                  and "model" not in manual else None)
            self.ctx = MeshCtx(mesh, live, tp, manual)

    def __enter__(self):
        global _MESH
        self.outer = _MESH
        if self.ctx is not None:
            _MESH = self.ctx
        return self.ctx

    def __exit__(self, *exc):
        global _MESH
        _MESH = self.outer
        return False


def _activation_dims(spec, mc: MeshCtx) -> dict:
    """Where ``spec`` puts each batch axis: the dimension that names it,
    else dimension 0, where the batch layout holds it."""
    out = {a: 0 for a in mc.batch_axes}
    for d, entry in enumerate(spec):
        for a in _entry_axes(entry):
            if a in out:
                out[a] = d
    return out


class _Move(torch.autograd.Function):
    """Move mesh axis ``axis`` of an activation from dimension ``src`` to
    ``dst`` (an all-to-all); the backward moves it back."""

    @staticmethod
    def forward(ctx, x, mesh, axis, src, dst, kind):
        ctx.mesh, ctx.axis, ctx.src, ctx.dst = mesh, axis, src, dst
        ctx.kind = kind
        return mesh.all_to_all(x, axis, split_dim=dst, cat_dim=src, kind=kind)

    @staticmethod
    def backward(ctx, g):
        return (ctx.mesh.all_to_all(g.contiguous(), ctx.axis,
                                    split_dim=ctx.src, cat_dim=ctx.dst,
                                    kind=ctx.kind),
                None, None, None, None, None)


def _named_dim(spec, axis):
    for d, entry in enumerate(spec):
        if axis in _entry_axes(entry):
            return d
    return None


def shard(x, *spec, src=None):
    """JAX's ``with_sharding_constraint`` cut point. Off a mesh the
    identity. On one, ``x`` is laid out as ``src`` says (the batch layout
    when None: rows over the batch axes, whole on every other axis) and
    leaves laid out as ``spec`` says. A batch axis that the spec names on
    another dimension moves there (an all-to-all, "expert"), one it leaves
    out goes to (or stays on) the rows. An axis that is not a batch axis
    moves from the dimension ``src`` names to the one ``spec`` names (an
    all-to-all, "tp": a KV cache's heads to its sequence); one that either
    leaves out is left as it is."""
    mc = _MESH
    if mc is None:
        return x
    have = _activation_dims(src if src is not None else (), mc)
    want = _activation_dims(spec, mc)
    for axis in reversed(mc.batch_axes):       # the minor axis first
        if have[axis] != want[axis]:
            x = _Move.apply(x, mc.mesh, axis, have[axis], want[axis],
                            "expert")
    if src is None:
        return x
    for axis in mc.mesh.live(mc.mesh.axis_names):
        if axis in mc.batch_axes or axis in mc.manual:
            continue
        a, b = _named_dim(src, axis), _named_dim(spec, axis)
        if a is not None and b is not None and a != b:
            x = _Move.apply(x, mc.mesh, axis, a, b, "tp")
    return x


class _TPSum(torch.autograd.Function):
    """The forward sums each tensor over mesh axis ``axis`` (one
    all-reduce); the backward is the identity."""

    @staticmethod
    def forward(ctx, mesh, axis, *xs):
        return tuple(mesh.all_reduce_many(xs, (axis,), kind="tp"))

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, *gs)


class _TPCopy(torch.autograd.Function):
    """The identity in the forward; the backward sums each gradient over
    mesh axis ``axis`` (one all-reduce)."""

    @staticmethod
    def forward(ctx, mesh, axis, *xs):
        ctx.mesh, ctx.axis = mesh, axis
        ctx.shapes = [(x.shape, x.dtype, x.device) for x in xs]
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        gs = [torch.zeros(shape, dtype=dt, device=dev) if g is None else g
              for g, (shape, dt, dev) in zip(gs, ctx.shapes)]
        return (None, None, *ctx.mesh.all_reduce_many(gs, (ctx.axis,),
                                                       kind="tp"))


def _tp_apply(fn, xs):
    mc = _MESH
    if mc is None or mc.tp_axis is None:
        return xs[0] if len(xs) == 1 else xs
    out = fn.apply(mc.mesh, mc.tp_axis, *xs)
    return out[0] if len(xs) == 1 else out


def tp_sum(*xs):
    """The row-split product's cut point: ``xs`` summed over 'model' (one
    all-reduce, float32 on the wire); the identity off a mesh or where
    'model' is not live."""
    return _tp_apply(_TPSum, xs)


def tp_copy(*xs):
    """The column-split product's cut point: ``xs`` as they are, their
    gradients summed over 'model' in the backward (one all-reduce)."""
    return _tp_apply(_TPCopy, xs)


def tp_index(axis) -> tuple:
    """(this rank's coordinate on ``axis``, its size) on the current mesh;
    (0, 1) off a mesh or for ``axis`` None."""
    mc = _MESH
    if mc is None or axis is None:
        return 0, 1
    return mc.mesh.coords[axis], mc.mesh.shape[axis]


class _GatherParams(torch.autograd.Function):
    """Parameter blocks -> the compute views (whole but on the ``keep``
    axes); the backward sums each view's gradient over the batch axes it
    is not kept on and returns this rank's block of the sum."""

    @staticmethod
    def forward(ctx, mesh, specs, keep, reduce_axes, *blocks):
        ctx.mesh, ctx.specs, ctx.keep = mesh, specs, keep
        ctx.reduce_axes = reduce_axes
        views = mesh.gather_many(blocks, specs, keep, kind="params")
        ctx.shapes = [(v.shape, v.dtype) for v in views]
        return tuple(v.clone() if v is b else v
                     for v, b in zip(views, blocks))

    @staticmethod
    def backward(ctx, *grads):
        mesh = ctx.mesh
        grads = [torch.zeros(shape, dtype=dt, device=mesh.device)
                 if g is None else g for g, (shape, dt) in
                 zip(grads, ctx.shapes)]
        by_axes: dict = {}
        for i, axes in enumerate(ctx.reduce_axes):
            by_axes.setdefault(axes, []).append(i)
        summed = list(grads)
        for axes, idx in by_axes.items():
            for i, t in zip(idx, mesh.all_reduce_many(
                    [grads[i] for i in idx], axes, kind="grads")):
                summed[i] = t
        out = []
        for g, spec, kp in zip(summed, ctx.specs, ctx.keep):
            kept = set(mesh.spec_live(kp))
            over = [a for a in mesh.spec_live(spec) if a not in kept]
            sl = mesh.block(spec, g.shape, over=over)
            out.append(g[sl].contiguous())
        return (None, None, None, None, *out)


def constrain_tree(params, specs, keep=None):
    """JAX's ``_constrain_tree``: off a mesh (or with ``specs`` None)
    ``params`` as they are; on one, the compute view of each block
    (``keep``: a tree of spec tuples, over the same keys, of the axes a
    view stays split on; the moe's experts over their expert axis)."""
    mc = _MESH
    if mc is None or specs is None:
        return params
    flat = tree_flatten_with_path(params)
    if not flat:
        return params

    def at(tree, path):
        for k in path:
            if tree is None:
                return ()
            tree = tree.get(k) if isinstance(tree, dict) else tree[k]
        return () if tree is None else tree

    specs_l = tuple(tuple(at(specs, p)) for p, _ in flat)
    keep_l = tuple(tuple(at(keep, p)) if keep is not None else ()
                   for p, _ in flat)
    red = tuple(tuple(a for a in mc.batch_axes
                      if a not in set(mc.mesh.spec_live(k)))
                for k in keep_l)
    views = _GatherParams.apply(mc.mesh, specs_l, keep_l, red,
                                *[t for _, t in flat])
    by_path = {p: v for (p, _), v in zip(flat, views)}
    return tree_map_with_path(lambda path, _: by_path[path], params)
