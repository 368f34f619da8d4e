"""AdamW with float32 master weights (bf16 compute params) + Adafactor option.

The counterpart of ``repro.train.optimizer``. Parameters and optimizer
state are trees of nested dicts of tensors; the state mirrors the
parameters' specs (``opt_state_specs``: master, m and v each get the
param's spec tuple), as JAX's mirrors their ``PartitionSpec``.

The arithmetic is JAX's, in JAX's order and in float32: the schedule and
the bias corrections are float32 tensors, not Python doubles, the global
norm sums the leaves in JAX's flatten order (sorted dict keys), and each
leaf takes the clip scale, then ``m``, then ``v`` (or its factors), then
``mh / (sqrt(vh) + eps) + weight_decay * master`` on the master, cast back
to the param's dtype. ``torch.optim.AdamW`` is not used: it decays before
the step, and has neither the factored ``v`` nor ``m_dtype``.

On a mesh (``mesh=``, ``specs=``) every leaf of the gradients, parameters
and state is this rank's block of its spec, and the update runs on the
blocks. The global norm sums each leaf's squares over its blocks, each
counted once (by the rank at coordinate 0 of every axis the spec leaves
out), in one all-reduce, then over the leaves in the sorted-key order. A
factored ``v`` takes its row and column means over whole dimensions: the
gradient and the factors are gathered for them, and the blocks kept.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.models.layers import (torch_dtype, tree_at,
                                       tree_flatten_with_path, tree_map,
                                       tree_map_with_path)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    # factored second moment (Adafactor-style) for giant models: v is stored
    # as row+col factors for 2-D+ weights, ~halving optimizer bytes.
    factored: bool = False
    # storage dtype for the first moment (compute stays f32): 'bfloat16'
    # drops optimizer bytes 4->2 per param.
    m_dtype: str = "float32"


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``cfg.lr``, in float32 (``step``: an int tensor)."""
    warm = torch.clamp(step.float() / float(max(cfg.warmup_steps, 1)),
                       max=1.0)
    return cfg.lr * warm


def adamw_init(params, cfg: Optional[AdamWConfig] = None):
    cfg = cfg or AdamWConfig()
    m_dt = torch_dtype(cfg.m_dtype)

    def v_like(p):
        if cfg.factored and p.ndim >= 2:
            return {
                "row": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                   device=p.device),
                "col": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                   dtype=torch.float32, device=p.device),
            }
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    device = tree_flatten_with_path(params)[0][1].device
    return {
        "step": torch.zeros((), dtype=torch.int32, device=device),
        "master": tree_map(lambda p: p.detach().to(torch.float32, copy=True),
                           params),
        "m": tree_map(lambda p: torch.zeros(p.shape, dtype=m_dt,
                                            device=p.device), params),
        "v": tree_map(v_like, params),
    }


def opt_state_specs(param_specs, cfg: Optional[AdamWConfig] = None,
                    param_shapes=None):
    """Spec tuples for the optimizer state (mirrors the param specs)."""
    cfg = cfg or AdamWConfig()

    def v_spec(path, shape):
        sp = tree_at(param_specs, path)
        if len(shape.shape) >= 2:
            return {"row": tuple(sp[:-1]), "col": tuple(sp[:-2] + sp[-1:])}
        return sp

    if cfg.factored and param_shapes is not None:
        v = tree_map_with_path(v_spec, param_shapes)
    else:
        v = param_specs
    return {"step": (), "master": param_specs, "m": param_specs, "v": v}


def _global_norm(tree, mesh=None, specs=None) -> torch.Tensor:
    parts = [torch.sum(torch.square(g.float()))
             for _, g in tree_flatten_with_path(tree)]
    if mesh is not None and parts:
        owner = [mesh.owner(tree_at(specs, path))
                 for path, _ in tree_flatten_with_path(tree)]
        parts = [p if own else torch.zeros_like(p)
                 for p, own in zip(parts, owner)]
        summed = mesh.all_reduce(torch.stack(parts), mesh.axis_names,
                                 kind="state")
        parts = list(summed.unbind(0))
    total = 0
    for p in parts:
        total = total + p
    return torch.sqrt(total)


def adamw_update(grads, state, params, cfg: Optional[AdamWConfig] = None, *,
                 mesh=None, specs=None):
    """Returns (new_params, new_state, metrics); nothing is updated in
    place. ``mesh``/``specs``: an ``LMMesh`` and the parameters' spec
    tree, when the leaves are this rank's blocks."""
    cfg = cfg or AdamWConfig()
    step = state["step"] + 1
    gnorm = _global_norm(grads, mesh, specs)
    if cfg.grad_clip:
        clip = torch.full_like(gnorm, cfg.grad_clip)
        scale = torch.clamp(clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    else:
        scale = 1.0
    lr = _schedule(cfg, step)
    b1c = 1.0 - torch.pow(cfg.b1, step.float())
    b2c = 1.0 - torch.pow(cfg.b2, step.float())
    m_dt = torch_dtype(cfg.m_dtype)

    def factored_blocks(path, g, v):
        """The factored v of a block: whole-dimension means, kept blocks."""
        sp = tuple(tree_at(specs, path))
        vs = {"row": sp[:-1], "col": sp[:-2] + sp[-1:]}
        gw = mesh.gather(g, sp)
        g2 = gw * gw
        vw = {"row": cfg.b2 * mesh.gather(v["row"], vs["row"])
                     + (1 - cfg.b2) * g2.mean(dim=-1),
              "col": cfg.b2 * mesh.gather(v["col"], vs["col"])
                     + (1 - cfg.b2) * g2.mean(dim=-2)}
        r = vw["row"] / torch.clamp(vw["row"].mean(dim=-1, keepdim=True),
                                    min=1e-30)
        vhat = mesh.local(r[..., None] * vw["col"][..., None, :], sp)
        return {k: mesh.local(vw[k], vs[k]) for k in vw}, vhat

    def upd(path, g, m, v, master):
        g = g.float() * scale
        m = cfg.b1 * m.float() + (1 - cfg.b1) * g
        if isinstance(v, dict) and mesh is not None:
            v, vhat = factored_blocks(path, g, v)
        elif isinstance(v, dict):  # factored second moment
            g2 = g * g
            v = {
                "row": cfg.b2 * v["row"] + (1 - cfg.b2) * g2.mean(dim=-1),
                "col": cfg.b2 * v["col"] + (1 - cfg.b2) * g2.mean(dim=-2),
            }
            r = v["row"] / torch.clamp(v["row"].mean(dim=-1, keepdim=True),
                                       min=1e-30)
            vhat = r[..., None] * v["col"][..., None, :]
        else:
            v = cfg.b2 * v + (1 - cfg.b2) * g * g
            vhat = v
        mh = m / b1c
        vh = vhat / b2c
        new_master = master - lr * (mh / (torch.sqrt(vh) + cfg.eps)
                                    + cfg.weight_decay * master)
        return m.to(m_dt), v, new_master

    out = {path: upd(path, g, tree_at(state["m"], path),
                     tree_at(state["v"], path), tree_at(state["master"], path))
           for path, g in tree_flatten_with_path(grads)}
    def part(i):
        return tree_map_with_path(lambda path, _: out[path][i], params)

    new_m, new_v, new_master = part(0), part(1), part(2)
    new_params = tree_map_with_path(
        lambda path, p: out[path][2].to(p.dtype), params)
    new_state = {"step": step, "master": new_master, "m": new_m, "v": new_v}
    return new_params, new_state, {"grad_norm": gnorm, "lr": lr}
