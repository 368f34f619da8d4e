"""LMModel: init / encode / prefill / decode for every model family.

The counterpart of ``repro.models.lm``. Parameters are a tree of nested
dicts of tensors with a parallel tree of specs (``layers.py``), as JAX's
are; ``LMModel`` holds the config and the device, and its methods take the
parameters explicitly. The layout choice (``make_shard_ctx``,
``choose_layout``) is a pure function of the mesh's axis names and sizes,
as the reference's reads only ``mesh.axis_names`` and ``mesh.shape``.

On an ``LMMesh`` (``launch/mesh.py``) the model runs on this rank's
device: ``init`` keeps this rank's block of each parameter, and
``train_loss`` takes the whole batch, as JAX's takes the logical array,
keeps the rows of this rank (the layout's batch axes), gathers the
parameters at JAX's cut points (``layers.constrain_tree``) and returns the
loss of the whole batch: the token count and the losses are summed over
the batch axes, and the gradient that reaches this rank's parameters is
this rank's share, summed in the backward.

``train_loss`` is differentiable: ``train/steps.py`` takes its gradients
with ``torch.autograd.grad``. Prefill and decode run under
``torch.inference_mode`` and write the KV caches in place. The model runs
on CUDA unless the caller passes ``device="cpu"``, and raises when CUDA is
asked for and absent.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.grid import resolve_device
from repro_torch.models import mamba2 as mamba_lib
from repro_torch.models import transformer as tf
from repro_torch.models.attention import KVCache
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (ParamInit, ShardCtx, constrain_tree,
                                       current_mesh, embed_param,
                                       mesh_context, norm_param, rms_norm,
                                       torch_dtype)


@dataclasses.dataclass(frozen=True)
class Layout:
    batch_axes: Any          # axis (or tuple) for the batch dim, or None
    head_tp: Optional[str]   # 'model' when n_heads divides the TP axis
    cache_seq: Any           # axes for the KV-cache sequence dim


def make_shard_ctx(mesh=None) -> ShardCtx:
    """``mesh``: anything with ``axis_names`` and a ``shape`` mapping of
    axis name to size (or None)."""
    if mesh is None:
        return ShardCtx(fsdp_axis=None, tp_axis=None, fsdp_size=1, tp_size=1)
    names = mesh.axis_names
    fsdp = "data" if "data" in names else None
    tp = "model" if "model" in names else None
    return ShardCtx(
        fsdp_axis=fsdp,
        tp_axis=tp,
        fsdp_size=mesh.shape[fsdp] if fsdp else 1,
        tp_size=mesh.shape[tp] if tp else 1,
    )


def choose_layout(cfg: ModelConfig, mesh, batch: int, seq: int) -> Layout:
    if mesh is None:
        return Layout(batch_axes=None, head_tp=None, cache_seq=None)
    names = mesh.axis_names
    sizes = dict(zip(names, tuple(mesh.shape[n] for n in names)))
    dp_candidates = []
    if "pod" in names and "data" in names:
        dp_candidates.append(("pod", "data"))
    if "data" in names:
        dp_candidates.append(("data",))
    batch_axes = None
    for cand in dp_candidates:
        n = 1
        for a in cand:
            n *= sizes[a]
        if batch % n == 0:
            batch_axes = cand if len(cand) > 1 else cand[0]
            break
    tp = sizes.get("model", 1)
    head_tp = "model" if ("model" in names and cfg.n_heads % tp == 0) else None
    cache_seq = None
    if "model" in names and seq % tp == 0:
        cache_seq = "model"
        if (batch_axes is None and "data" in names
                and seq % (tp * sizes["data"]) == 0):
            cache_seq = ("data", "model")
    return Layout(batch_axes=batch_axes, head_tp=head_tp, cache_seq=cache_seq)


class LMModel(torch.nn.Module):
    """The model of one config on one device. ``forward`` is ``encode``."""

    def __init__(self, cfg: ModelConfig, mesh=None, *, device=None):
        super().__init__()
        self.cfg = cfg
        self.mesh = mesh
        self.ctx = make_shard_ctx(mesh)
        # a mesh of ranks (launch.mesh.LMMesh), not only axis names and sizes
        self.ranks = mesh if hasattr(mesh, "local_tree") else None
        self.device = resolve_device(
            self.ranks.device if self.ranks is not None and device is None
            else device)
        self.dtype = torch_dtype(cfg.dtype)
        self._specs_cache = None

    @property
    def param_specs(self):
        """The spec tree (cached; from ``abstract_params``)."""
        if self._specs_cache is None:
            _, self._specs_cache = self.abstract_params()
        return self._specs_cache

    def _stack_kwargs(self) -> dict:
        if self.mesh is None:
            return {}
        s = self.param_specs
        return dict(block_specs=s.get("blocks"),
                    shared_specs=s.get("shared_attn"))

    def _no_ranks(self, what: str):
        """Inference runs on one device: the mesh of ranks trains only."""
        if self.ranks is not None:
            raise ValueError(f"LMModel.{what} does not run on a mesh of "
                             f"ranks; build the model with mesh=None")

    # -- parameters ---------------------------------------------------------

    def init(self, generator) -> Tuple[Any, Any]:
        """(params, specs) parallel trees. ``generator``: a CPU
        ``torch.Generator``, or a ``numpy.random.Generator`` (the same
        distributions drawn by numpy; ``convert.seeded_params``). On a
        mesh of ranks every rank draws the same weights and keeps its
        block of each."""
        if self.ranks is None:
            return self._init(ParamInit(generator, self.device))
        params, specs = self._init(ParamInit(generator, torch.device("cpu")))
        return self.ranks.local_tree(params, specs), specs

    def abstract_params(self):
        """(params on the ``meta`` device, specs): shapes, dtypes and specs
        without allocating."""
        return self._init(ParamInit(None, self.device))

    def _init(self, init: ParamInit):
        cfg, ctx = self.cfg, self.ctx
        dt = self.dtype
        p, s = {}, {}
        if cfg.input_kind == "tokens" or cfg.has_decode:
            p["embed"], s["embed"] = embed_param(init, cfg.vocab, cfg.d_model,
                                                 ctx, dt)
        p["blocks"], s["blocks"] = tf.init_stack(init, cfg, ctx)
        sp, ss = tf.init_shared_attn(init, cfg, ctx)
        if sp is not None:
            p["shared_attn"], s["shared_attn"] = sp, ss
        p["final_norm"], s["final_norm"] = norm_param(init, cfg.d_model, dt)
        p["head"], s["head"] = embed_param(init, cfg.vocab, cfg.d_model, ctx,
                                           dt)
        return p, s

    # -- embedding / head ---------------------------------------------------

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device).long()

    def _embed_in(self, p, batch):
        if self.cfg.input_kind == "tokens":
            return p["embed"][self._tokens(batch["tokens"])].to(self.dtype)
        return torch.as_tensor(batch["embeds"], device=self.device).to(
            self.dtype)

    def _head(self, p, x):
        x = rms_norm(x, p["final_norm"])
        return x @ p["head"].T.to(x.dtype)

    def _loss_from_hidden(self, p, x, labels):
        """Sequence-chunked CE against the head (memory-bounded): each
        chunk's logits are recomputed in the backward, as JAX's
        ``jax.checkpoint`` on the scan body does."""
        cfg = self.cfg
        B, S, _ = x.shape
        chunk = min(cfg.loss_chunk, S)
        if S % chunk:
            chunk = S
        head = p["head"]

        def body(xc, lc):
            logits = xc @ head.T.to(xc.dtype)
            mask = lc >= 0
            lo = logits.float()
            lse = torch.logsumexp(lo, dim=-1)
            ll = torch.gather(lo, -1, lc.clamp(min=0)[..., None])[..., 0]
            loss = (lse - ll) * mask
            if cfg.z_loss:
                loss = loss + cfg.z_loss * (lse * mask) ** 2
            return loss.sum(), mask.sum(dtype=torch.int32)

        lsum = torch.zeros((), dtype=torch.float32, device=x.device)
        cnt = torch.zeros((), dtype=torch.int32, device=x.device)
        for c in range(0, S, chunk):
            ls, n = checkpoint(body, x[:, c:c + chunk], labels[:, c:c + chunk],
                               use_reentrant=False)
            lsum, cnt = lsum + ls, cnt + n
        mc = current_mesh()
        if mc is not None:      # the tokens of every rank's rows
            cnt = mc.mesh.all_reduce(cnt, mc.batch_axes)
        return lsum / torch.clamp(cnt, min=1)

    # -- training -----------------------------------------------------------

    def train_loss(self, p, batch):
        """(mean token CE, aux) of a batch with ``labels`` (< 0 masked);
        aux holds the stack's ``dropped_frac``. Differentiable in ``p``:
        the caller enables or disables the graph. On a mesh of ranks
        ``batch`` is the whole batch, ``p`` this rank's blocks, and the
        loss's gradient this rank's share (see the module's note); a
        caller that runs the step by hand (``train/steps.py``'s pod
        step) enters its own ``mesh_context`` first."""
        layout = self.default_layout(batch)
        if self.ranks is None or current_mesh() is not None:
            outer = contextlib.nullcontext()
        else:
            outer = mesh_context(self.ranks, layout.batch_axes)
        with outer:
            return self._train_loss(p, batch, layout)

    def _rows(self, t, layout: Layout) -> torch.Tensor:
        t = torch.as_tensor(t, device=self.device)
        if self.ranks is None:
            return t
        return self.ranks.local(t, (layout.batch_axes,))

    def _train_loss(self, p, batch, layout: Layout):
        cfg = self.cfg
        if self.ranks is not None:
            batch = {k: self._rows(v, layout) for k, v in batch.items()}
            specs = self.param_specs
            top = [k for k in p if k not in ("blocks", "shared_attn")]
            p = {**p, **constrain_tree({k: p[k] for k in top},
                                       {k: specs[k] for k in top})}
        x = self._embed_in(p, batch)
        x, _, aux = tf.stack_forward(p["blocks"], p.get("shared_attn"), x,
                                     cfg, self.ctx, mode="train",
                                     **self._stack_kwargs())
        x = rms_norm(x, p["final_norm"])
        labels = torch.as_tensor(batch["labels"], device=self.device).long()
        loss = self._loss_from_hidden(p, x, labels)
        mc = current_mesh()
        if mc is not None and mc.batch_axes:
            # the value of the whole batch's loss, the gradient of this
            # rank's share; aux averaged over the rows' ranks
            whole = mc.mesh.all_reduce(loss.detach(), mc.batch_axes)
            loss = loss + (whole - loss.detach())
            n = math.prod(mc.mesh.shape[a] for a in mc.batch_axes)
            aux = {k: mc.mesh.all_reduce(v.detach(), mc.batch_axes) / n
                   for k, v in aux.items()}
        return loss, aux

    def default_layout(self, batch) -> Layout:
        leaf = batch["tokens"] if "tokens" in batch else batch["embeds"]
        return choose_layout(self.cfg, self.mesh, leaf.shape[0],
                             leaf.shape[1])

    @torch.inference_mode()
    def encode(self, p, batch):
        """Full forward -> (B, S, vocab) logits (the teacher-forced
        reference of the decode tests; an encoder's 'prefill')."""
        self._no_ranks("encode")
        x = self._embed_in(p, batch)
        x, _, _ = tf.stack_forward(p["blocks"], p.get("shared_attn"), x,
                                   self.cfg, mode="train")
        return self._head(p, x)

    def forward(self, p, batch):
        return self.encode(p, batch)

    # -- serving ------------------------------------------------------------

    def init_caches(self, batch: int, max_len: int) -> tf.StackCaches:
        cfg = self.cfg
        L = cfg.n_layers
        dev, dt = self.device, self.dtype

        def stack_kv(n, length):
            shape = (n, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
            return KVCache(k=torch.zeros(shape, dtype=dt, device=dev),
                           v=torch.zeros(shape, dtype=dt, device=dev),
                           length=length)

        if cfg.family in tf.ATTN_FAMILIES:
            return tf.StackCaches(kv=stack_kv(
                L, torch.zeros((L,), dtype=torch.int32)))
        if cfg.family == "ssm":
            H = cfg.n_heads
            dh = cfg.d_inner // H
            ml = torch.zeros((L, batch, H, dh, dh), dtype=torch.float32,
                             device=dev)
            sl = (torch.zeros((L, batch, cfg.d_model), dtype=torch.float32,
                              device=dev),
                  torch.zeros((L, batch, cfg.d_model), dtype=torch.float32,
                              device=dev))
            return tf.StackCaches(mlstm=ml, slstm=sl)
        if cfg.family == "hybrid":
            mamba = mamba_lib.mamba2_state(cfg, batch, dev, lead=(L,))
            kv = stack_kv(tf.shared_invocations(cfg),
                          torch.zeros((), dtype=torch.int32))
            return tf.StackCaches(mamba=mamba, shared_kv=kv)
        raise ValueError(cfg.family)

    @torch.inference_mode()
    def prefill(self, p, batch, caches: tf.StackCaches):
        """Process a prompt; returns (last-position logits, filled caches)."""
        self._no_ranks("prefill")
        x = self._embed_in(p, batch)
        x, caches, _ = tf.stack_forward(p["blocks"], p.get("shared_attn"), x,
                                        self.cfg, mode="prefill",
                                        caches=caches)
        logits = self._head(p, x[:, -1, :])
        if self.cfg.family == "hybrid":
            caches = caches._replace(shared_kv=caches.shared_kv._replace(
                length=torch.tensor(x.shape[1], dtype=torch.int32)))
        return logits, caches

    @torch.inference_mode()
    def decode_step(self, p, tokens, caches: tf.StackCaches):
        """One token for every sequence. tokens: (B,) ints."""
        self._no_ranks("decode_step")
        x = p["embed"][self._tokens(tokens)][:, None, :].to(self.dtype)
        x, caches, _ = tf.stack_forward(p["blocks"], p.get("shared_attn"), x,
                                        self.cfg, mode="decode",
                                        caches=caches)
        logits = self._head(p, x[:, 0, :])
        if self.cfg.family == "hybrid":
            caches = caches._replace(shared_kv=caches.shared_kv._replace(
                length=caches.shared_kv.length + 1))
        return logits, caches

    def _cache_len(self, caches):
        cfg = self.cfg
        if cfg.family in tf.ATTN_FAMILIES:
            return caches.kv.k.shape[2]
        if cfg.family == "hybrid" and cfg.shared_attn_every:
            return caches.shared_kv.k.shape[2]
        return 0
