"""Train / eval / serve step builders.

The counterpart of ``repro.train.steps``, without a mesh:
``make_train_step`` wires ``model.train_loss`` -> ``torch.autograd.grad``
over every parameter leaf -> AdamW into one step. JAX jits and donates
the step; here it is eager, and returns new parameter and state trees
without writing the old ones. The pod-compressed step
(``compress_pods=True``, ``train/compression.py``) comes with the meshes,
ROADMAP A17 (ii b). The step's three stages run in profiler spans
(``train_step.loss``, ``.grad``, ``.update``), as the joins' stages do.
"""
from __future__ import annotations

import torch
from torch.profiler import record_function

from repro_torch.models.layers import (tree_flatten_with_path, tree_map,
                                       tree_map_with_path)
from repro_torch.train.optimizer import AdamWConfig, adamw_update


def make_train_step(model, opt_cfg: AdamWConfig, *,
                    compress_pods: bool = False):
    """Returns step(params, opt_state, batch) -> (params, opt_state,
    metrics), metrics holding ``loss``, ``dropped_frac``, ``grad_norm`` and
    ``lr`` as 0-d tensors on the model's device: reading one is the
    caller's sync point."""
    if compress_pods:
        raise NotImplementedError(
            "compress_pods needs a mesh with a 'pod' axis: ROADMAP A17 (ii b)")

    def step(params, opt_state, batch):
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
        with record_function("train_step.update"):
            params, opt_state, om = adamw_update(grads, opt_state, params,
                                                 opt_cfg)
        metrics = {"loss": loss.detach(),
                   **{k: v.detach() for k, v in aux.items()}, **om}
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
