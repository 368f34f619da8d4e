"""LMModel: init / encode / prefill / decode for every model family.

The counterpart of ``repro.models.lm``. Parameters are a tree of nested
dicts of tensors with a parallel tree of specs (``layers.py``), as JAX's
are; ``LMModel`` holds the config and the device, and its methods take the
parameters explicitly. The layout choice (``make_shard_ctx``,
``choose_layout``) is a pure function of the mesh's axis names and sizes,
as the reference's reads only ``mesh.axis_names`` and ``mesh.shape``; no
mesh runs the model here, and training (``train_loss``) comes with ROADMAP
A17 (ii).

Prefill and decode run under ``torch.inference_mode`` and write the KV
caches in place. The model runs on CUDA unless the caller passes
``device="cpu"``, and raises when CUDA is asked for and absent.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch.core.grid import resolve_device
from repro_torch.models import mamba2 as mamba_lib
from repro_torch.models import transformer as tf
from repro_torch.models.attention import KVCache
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (ParamInit, ShardCtx, embed_param,
                                       norm_param, rms_norm, torch_dtype)


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
        self.device = resolve_device(device)
        self.dtype = torch_dtype(cfg.dtype)

    # -- parameters ---------------------------------------------------------

    def init(self, generator) -> Tuple[Any, Any]:
        """(params, specs) parallel trees. ``generator``: a CPU
        ``torch.Generator``, or a ``numpy.random.Generator`` (the same
        distributions drawn by numpy; ``convert.seeded_params``)."""
        return self._init(ParamInit(generator, self.device))

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

    @torch.inference_mode()
    def encode(self, p, batch):
        """Full forward -> (B, S, vocab) logits (the teacher-forced
        reference of the decode tests; an encoder's 'prefill')."""
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
