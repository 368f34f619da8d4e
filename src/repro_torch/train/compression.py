"""Cross-pod gradient compression: int8 all-gather with error feedback.

The counterpart of ``repro.train.compression``. Within a pod, gradients
are summed over the pod's ranks by the parameter gathers' backward
(``models/layers.py``); across pods, the link is the slow one, so the
exchange is explicit and compressed:

  1. each pod has its own mean gradient over its own batch rows;
  2. each tensor is quantized to int8 against a shared scale: the max
     over pods of each pod's whole-gradient absmax;
  3. the int8 payloads are all-gathered over 'pod' and summed in int32;
  4. the quantization error is fed back into the next step's gradient.

``torch.round`` rounds half to even, as ``jnp.round`` does, so the int8
codes are JAX's bit for bit. The error buffers live in the optimizer state
(``grad_error``) and are laid out as the parameters. Each pod keeps its
own residual on its own ranks, as JAX's ``shard_map`` does (ROADMAP §C,
C10).
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import (tree_flatten_with_path, tree_map,
                                       tree_map_with_path)


def quantize(x: torch.Tensor, scale) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def dequantize(q: torch.Tensor, scale) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _scale(absmax: torch.Tensor) -> torch.Tensor:
    return torch.clamp(absmax, min=1e-12) / 127.0


def compressed_psum_mean(grads, errors, axis: str, n_pods: int, *, mesh):
    """Per-tensor int8 all-gather mean over ``axis`` of ``mesh`` (an
    ``LMMesh``) with error feedback, on this rank's blocks of ``grads`` and
    ``errors`` (two trees of the same keys). A collective: every rank of
    ``mesh`` calls it. One all-reduce takes every tensor's absmax over
    the whole mesh (a pod's ranks hold the blocks of its gradient); one
    all-gather over ``axis`` moves the int8 codes. Returns (mean_grads,
    new_errors)."""
    flat = tree_flatten_with_path(grads)
    errs = dict(tree_flatten_with_path(errors))
    g32 = [g.to(torch.float32) + errs[path] for path, g in flat]
    local = torch.stack([torch.max(torch.abs(g)) for g in g32])
    shared = mesh.all_reduce(local, mesh.axis_names, "max", kind="pods")
    scales = [_scale(shared[i]) for i in range(len(g32))]
    qs = [quantize(g, s) for g, s in zip(g32, scales)]
    gathered = mesh.all_gather_stack(
        torch.cat([q.reshape(-1) for q in qs]), axis)
    total = gathered.to(torch.int32).sum(dim=0)
    means, new_errs, off = {}, {}, 0
    for (path, g), g_, q, s in zip(flat, g32, qs, scales):
        part = total[off:off + q.numel()].reshape(q.shape)
        off += q.numel()
        means[path] = (dequantize(part, s) / n_pods).to(g.dtype)
        new_errs[path] = g_ - dequantize(q, s)
    return (tree_map_with_path(lambda path, _: means[path], grads),
            tree_map_with_path(lambda path, _: new_errs[path], grads))


def compressed_mean_gspmd(pod_grads, errors, n_pods: int):
    """The same int8 exchange over explicit per-pod gradients, in one
    process: ``pod_grads`` is a list of ``n_pods`` gradient trees. The
    shared residual carries the mean error. Returns (mean_grads,
    new_errors), ``new_errors`` shaped like ``errors``."""
    flat_e = tree_flatten_with_path(errors)
    flat_gs = [dict(tree_flatten_with_path(g)) for g in pod_grads]

    def one(e, gs):
        g32 = [g.to(torch.float32) + e for g in gs]
        smax = torch.abs(g32[0]).max()
        for g in g32[1:]:
            smax = torch.maximum(smax, torch.abs(g).max())
        scale = _scale(smax)
        qs = [quantize(g, scale) for g in g32]
        recon = dequantize(sum(q.to(torch.int32) for q in qs), scale)
        mean = recon / n_pods
        new_e = (sum(g32) - recon) / n_pods       # mean residual feedback
        return mean.to(gs[0].dtype), new_e

    out = {path: one(e, [fg[path] for fg in flat_gs]) for path, e in flat_e}
    return (tree_map_with_path(lambda path, _: out[path][0], errors),
            tree_map_with_path(lambda path, _: out[path][1], errors))


def init_error_state(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
