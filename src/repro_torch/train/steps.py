"""Train / eval / serve step builders.

The counterpart of ``repro.train.steps``: ``make_train_step`` wires
``model.train_loss`` -> ``torch.autograd.grad`` over every parameter leaf
-> AdamW into one step. JAX jits and donates the step; here it is eager,
and returns new parameter and state trees without writing the old ones.
The step's stages run in profiler spans (``train_step.loss``, ``.grad``,
``.update``, and ``.exchange`` for the pods), as the joins' stages do.

On a model of an ``LMMesh`` the step runs SPMD: every rank calls it with
the whole batch and its own blocks of the parameters and the state. With
``compress_pods=True`` on a mesh with a 'pod' axis it is JAX's
``shard_map`` form, manual over 'pod': each pod's mean gradient over its
own rows, the loss and aux averaged over pods, the int8 exchange of
``train/compression.py``, then AdamW on ``step``, ``master``, ``m`` and
``v``, with ``grad_error`` carried in the state. On a mesh without 'pod'
(or none) it is the plain step, as in JAX.
"""
from __future__ import annotations

import contextlib

import torch
from torch.profiler import record_function

from repro_torch.models.layers import (mesh_context, tree_flatten_with_path,
                                       tree_map, tree_map_with_path)
from repro_torch.train import compression as comp
from repro_torch.train.optimizer import AdamWConfig, adamw_update


def make_train_step(model, opt_cfg: AdamWConfig, *,
                    compress_pods: bool = False, param_specs=None):
    """Returns step(params, opt_state, batch) -> (params, opt_state,
    metrics), metrics holding ``loss``, ``dropped_frac``, ``grad_norm`` and
    ``lr`` as 0-d tensors on the model's device: reading one is the
    caller's sync point.

    ``param_specs`` pins each gradient to its parameter's layout, as JAX's
    ``constrain`` does: on a mesh the gradients come back as this rank's
    blocks of those specs (the model's own when None), and AdamW counts
    each block once in the global norm."""
    mesh = getattr(model, "ranks", None)
    specs = (param_specs if param_specs is not None or mesh is None
             else model.param_specs)
    has_pod = mesh is not None and "pod" in mesh.axis_names

    def context(batch, manual=()):
        if mesh is None:
            return contextlib.nullcontext()
        return mesh_context(mesh, model.default_layout(batch).batch_axes,
                            manual)

    def loss_and_grads(params, batch):
        with torch.enable_grad():
            live = tree_map(lambda t: t.detach().requires_grad_(), params)
            with record_function("train_step.loss"):
                loss, aux = model.train_loss(live, batch)
            paths, leaves = zip(*tree_flatten_with_path(live))
            with record_function("train_step.grad"):
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        by_path = {path: torch.zeros_like(t) if g is None else g
                   for path, t, g in zip(paths, leaves, grads)}
        grads = tree_map_with_path(lambda path, _: by_path[path], params)
        return loss.detach(), {k: v.detach() for k, v in aux.items()}, grads

    def update(grads, opt_state, params):
        with record_function("train_step.update"):
            return adamw_update(grads, opt_state, params, opt_cfg,
                                mesh=mesh, specs=specs)

    if not (compress_pods and has_pod):
        def step(params, opt_state, batch):
            with context(batch):
                loss, aux, grads = loss_and_grads(params, batch)
            params, opt_state, om = update(grads, opt_state, params)
            metrics = {"loss": loss, **aux, **om}
            return params, opt_state, metrics
        return step

    n_pods = mesh.shape["pod"]

    def step(params, opt_state, batch):
        with context(batch, manual=("pod",)):
            loss, aux, grads = loss_and_grads(params, batch)
        with record_function("train_step.exchange"):
            loss = mesh.all_reduce(loss, ("pod",)) / n_pods
            aux = {k: mesh.all_reduce(v, ("pod",)) / n_pods
                   for k, v in aux.items()}
            grads, new_errors = comp.compressed_psum_mean(
                grads, opt_state["grad_error"], "pod", n_pods, mesh=mesh)
        opt_state = dict(opt_state)
        opt_state["grad_error"] = new_errors
        inner = {k: opt_state[k] for k in ("step", "master", "m", "v")}
        params, inner, om = update(grads, inner, params)
        opt_state.update(inner)
        metrics = {"loss": loss, **aux, **om}
        return params, opt_state, metrics

    return step


def aux_struct(model):
    return {"dropped_frac": 0.0}


def make_eval_step(model):
    def step(params, batch):
        with torch.no_grad():
            loss, aux = model.train_loss(params, batch)
        return {"loss": loss, **aux}
    return step


def make_decode_step(model):
    def step(params, tokens, caches):
        return model.decode_step(params, tokens, caches)
    return step


def make_prefill_step(model):
    def step(params, batch, caches):
        return model.prefill(params, batch, caches)
    return step
