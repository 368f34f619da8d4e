"""LMModel: init / encode / prefill / decode for every model family.

The counterpart of ``repro.models.lm``. Parameters are a tree of nested
dicts of tensors with a parallel tree of specs (``layers.py``), as JAX's
are; ``LMModel`` holds the config and the device, and its methods take the
parameters explicitly. The layout choice (``make_shard_ctx``,
``choose_layout``) is a pure function of the mesh's axis names and sizes,
as the reference's reads only ``mesh.axis_names`` and ``mesh.shape``.

On an ``LMMesh`` (``launch/mesh.py``) the model runs on this rank's
device: ``init`` keeps this rank's block of each parameter, and
``train_loss``, ``encode``, ``prefill`` and ``decode_step`` take the whole
batch, as JAX's take the logical array, keep the rows of this rank (the
layout's batch axes), gather the parameters at JAX's cut points
(``layers.constrain_tree``) and compute with tensor parallelism over
'model' where JAX's layout splits (``models/transformer.py``). The head is
split over 'model' where the vocab divides it: each rank computes the
logits of its vocab block, the loss's ``logsumexp`` combines over 'model'
(a max, then a sum), and the rank that owns each label's logit supplies
it. The embedding is looked up the same way: each rank reads the rows of
its vocab block, zero elsewhere, and one sum over 'model' puts the rows
together (exact: one term a row is not zero). ``train_loss``
returns the loss of the whole batch (the token count and the losses
summed over the batch axes; the gradient that reaches this rank's
parameters is this rank's share, summed in the backward); ``encode``,
``prefill`` and ``decode_step`` return the whole batch's logits on every
rank. ``init_caches`` returns this rank's block of the caches
(``cache_specs``: rows over the batch axes, the KV caches' sequence over
``cache_seq``); a KV cache keeps its whole ``max_len`` on the host, which
a rank's block does not tell, and ``prefill`` and ``decode_step`` lay
the caches out by ``choose_layout(cfg, mesh, B, max_len)`` when no
layout is passed, as JAX's ``decode_step`` does (JAX's ``prefill`` takes
the prompt's length: the port's caches are blocks of that layout).

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
                                       torch_dtype, tp_copy, tp_index, tp_sum,
                                       tree_at, tree_map_with_path)


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

    def _stack_kwargs(self, layout: "Layout") -> dict:
        if self.mesh is None:
            return {}
        s = self.param_specs
        return dict(block_specs=s.get("blocks"),
                    shared_specs=s.get("shared_attn"),
                    head_tp=layout.head_tp, seq_axes=layout.cache_seq,
                    dp_spec=layout.batch_axes)

    def _context(self, layout: "Layout"):
        """The mesh context of a call on a mesh of ranks (unless the
        caller entered one)."""
        if self.ranks is None or current_mesh() is not None:
            return contextlib.nullcontext()
        return mesh_context(self.ranks, layout.batch_axes)

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

    def _lookup(self, p, tokens) -> torch.Tensor:
        """The embedding rows of ``tokens``. Where the vocab splits over
        'model', the masked lookup of this rank's vocab block, summed
        over 'model' (one term a row is not zero: the sum is exact)."""
        tok = self._tokens(tokens)
        tp = self._vocab_tp()
        if tp is None:
            return p["embed"][tok].to(self.dtype)
        block = p["embed"]
        own = tok - tp_index(tp)[0] * block.shape[0]
        mine = (own >= 0) & (own < block.shape[0])
        rows = block[own.clamp(0, block.shape[0] - 1)]
        return tp_sum(torch.where(mine[..., None], rows,
                                  torch.zeros((), dtype=rows.dtype,
                                              device=rows.device))
                      ).to(self.dtype)

    def _embed_in(self, p, batch):
        if self.cfg.input_kind == "tokens":
            return self._lookup(p, batch["tokens"])
        return torch.as_tensor(batch["embeds"], device=self.device).to(
            self.dtype)

    def _vocab_tp(self) -> Optional[str]:
        """The live 'model' axis where the head's vocab splits over it."""
        mc = current_mesh()
        if mc is None or mc.tp_axis is None:
            return None
        tp = mc.tp_axis
        return tp if self.ctx.axis("tp", self.cfg.vocab) == tp else None

    def _top_params(self, p):
        """On a mesh of ranks, the compute views of the parameters outside
        the stack: gathered whole, the head and the embedding kept split
        over 'model' where the vocab splits."""
        if self.ranks is None:
            return p
        specs = self.param_specs
        top = [k for k in p if k not in ("blocks", "shared_attn")]
        tp = self._vocab_tp()
        keep = {"head": (tp, None), "embed": (tp, None)} if tp else None
        return {**p, **constrain_tree({k: p[k] for k in top},
                                      {k: specs[k] for k in top}, keep)}

    def _head(self, p, x):
        """Logits of ``x`` (of this rank's vocab block where it splits)."""
        x = rms_norm(x, p["final_norm"])
        if self._vocab_tp():
            x = tp_copy(x)
        return x @ p["head"].T.to(x.dtype)

    def _whole(self, logits):
        """The whole batch's logits on every rank: this rank's rows and
        vocab block gathered over the batch axes and 'model' (one
        all-gather, the "logits" kind)."""
        mc = current_mesh()
        if mc is None:
            return logits
        spec = ((mc.batch_axes or None,) + (None,) * (logits.ndim - 2)
                + (self._vocab_tp(),))
        return mc.mesh.gather_many([logits], [spec], kind="logits")[0]

    def _loss_from_hidden(self, p, x, labels):
        """Sequence-chunked CE against the head (memory-bounded): each
        chunk's logits are recomputed in the backward, as JAX's
        ``jax.checkpoint`` on the scan body does. Where the vocab splits
        over 'model', each rank's logits are its vocab block's."""
        cfg = self.cfg
        B, S, _ = x.shape
        chunk = min(cfg.loss_chunk, S)
        if S % chunk:
            chunk = S
        head = p["head"]
        tp = self._vocab_tp()

        def terms(lo, lc):
            """(logsumexp, the label's logit) over the whole vocab."""
            if tp is None:
                lse = torch.logsumexp(lo, dim=-1)
                ll = torch.gather(lo, -1, lc.clamp(min=0)[..., None])[..., 0]
                return lse, ll
            mesh = current_mesh().mesh
            top = mesh.all_reduce(lo.detach().amax(-1), (tp,), "max",
                                  kind="tp")
            own = lc.clamp(min=0) - tp_index(tp)[0] * lo.shape[-1]
            mine = (own >= 0) & (own < lo.shape[-1])
            ll = torch.gather(lo, -1, own.clamp(0, lo.shape[-1] - 1)[..., None])
            ll = torch.where(mine, ll[..., 0], 0.0)
            total, ll = tp_sum(torch.exp(lo - top[..., None]).sum(-1), ll)
            return top + torch.log(total), ll

        def body(xc, lc):
            if tp is not None:
                xc = tp_copy(xc)
            logits = xc @ head.T.to(xc.dtype)
            mask = lc >= 0
            lse, ll = terms(logits.float(), lc)
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
        with self._context(layout):
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
            p = self._top_params(p)
        x = self._embed_in(p, batch)
        x, _, aux = tf.stack_forward(p["blocks"], p.get("shared_attn"), x,
                                     cfg, self.ctx, mode="train",
                                     **self._stack_kwargs(layout))
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
    def encode(self, p, batch, layout: Optional[Layout] = None):
        """Full forward -> (B, S, vocab) logits (the teacher-forced
        reference of the decode tests; an encoder's 'prefill')."""
        layout = layout or self.default_layout(batch)
        with self._context(layout):
            p, batch = self._serving_inputs(p, batch, layout)
            x = self._embed_in(p, batch)
            x, _, _ = tf.stack_forward(p["blocks"], p.get("shared_attn"), x,
                                       self.cfg, self.ctx, mode="train",
                                       **self._stack_kwargs(layout))
            return self._whole(self._head(p, x))

    def forward(self, p, batch):
        return self.encode(p, batch)

    def _serving_inputs(self, p, batch, layout: Layout):
        """On a mesh of ranks: the top parameters' compute views and this
        rank's rows of ``batch`` (a dict, or the decode's tokens)."""
        if self.ranks is None:
            return p, batch
        if isinstance(batch, dict):
            batch = {k: self._rows(v, layout) for k, v in batch.items()}
        else:
            batch = self._rows(batch, layout)
        return self._top_params(p), batch

    # -- serving ------------------------------------------------------------

    def _caches(self, batch: int, max_len: int, dev) -> tf.StackCaches:
        cfg = self.cfg
        L = cfg.n_layers
        dt = self.dtype

        def stack_kv(n, length):
            shape = (n, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
            return KVCache(k=torch.zeros(shape, dtype=dt, device=dev),
                           v=torch.zeros(shape, dtype=dt, device=dev),
                           length=length,
                           max_len=torch.tensor(max_len, dtype=torch.int32))

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

    def init_caches(self, batch: int, max_len: int,
                    layout: Optional[Layout] = None) -> tf.StackCaches:
        """Zeroed caches for ``batch`` sequences of up to ``max_len``
        tokens. On a mesh of ranks, this rank's block of them, laid out
        by ``layout`` (``choose_layout(cfg, mesh, batch, max_len)`` when
        None)."""
        if self.ranks is None:
            return self._caches(batch, max_len, self.device)
        layout = layout or choose_layout(self.cfg, self.mesh, batch, max_len)
        specs = self.cache_specs(layout)
        meta = self._caches(batch, max_len, torch.device("meta"))

        def block(path, t):
            if t.device.type != "meta":         # the lengths, on the host
                return t
            sl = self.ranks.block(tree_at(specs, path), t.shape)
            return torch.zeros([s.stop - s.start for s in sl],
                               dtype=t.dtype, device=self.device)

        return tree_map_with_path(block, meta)

    def cache_specs(self, layout: Layout) -> tf.StackCaches:
        """The spec tree of the caches (JAX's): rows over the batch axes,
        the KV caches' sequence over ``cache_seq``."""
        cfg = self.cfg
        b, s_ = layout.batch_axes, layout.cache_seq
        kv = (None, b, s_, None, None)
        if cfg.family in tf.ATTN_FAMILIES:
            return tf.StackCaches(kv=KVCache(k=kv, v=kv, length=(None,),
                                             max_len=()))
        if cfg.family == "ssm":
            return tf.StackCaches(mlstm=(None, b, None, None, None),
                                  slstm=((None, b, None), (None, b, None)))
        if cfg.family == "hybrid":
            return tf.StackCaches(
                mamba=mamba_lib.Mamba2State(conv=(None, b, None, None),
                                            ssm=(None, b, None, None, None)),
                shared_kv=KVCache(k=kv, v=kv, length=(), max_len=()))
        raise ValueError(cfg.family)

    def _cache_layout(self, caches, batch: int) -> Layout:
        """JAX's decode default: the layout of ``batch`` rows and the
        caches' whole ``max_len``."""
        return choose_layout(self.cfg, self.mesh, batch,
                             self._cache_len(caches))

    @torch.inference_mode()
    def prefill(self, p, batch, caches: tf.StackCaches,
                layout: Optional[Layout] = None):
        """Process a prompt; returns (last-position logits, filled caches)."""
        leaf = batch["tokens"] if "tokens" in batch else batch["embeds"]
        layout = layout or self._cache_layout(caches, leaf.shape[0])
        with self._context(layout):
            p, batch = self._serving_inputs(p, batch, layout)
            x = self._embed_in(p, batch)
            x, caches, _ = tf.stack_forward(p["blocks"], p.get("shared_attn"),
                                            x, self.cfg, self.ctx,
                                            mode="prefill", caches=caches,
                                            **self._stack_kwargs(layout))
            logits = self._whole(self._head(p, x[:, -1, :]))
        if self.cfg.family == "hybrid":
            caches = caches._replace(shared_kv=caches.shared_kv._replace(
                length=torch.tensor(x.shape[1], dtype=torch.int32)))
        return logits, caches

    @torch.inference_mode()
    def decode_step(self, p, tokens, caches: tf.StackCaches,
                    layout: Optional[Layout] = None):
        """One token for every sequence. tokens: (B,) ints."""
        layout = layout or self._cache_layout(caches, tokens.shape[0])
        with self._context(layout):
            p, tokens = self._serving_inputs(p, tokens, layout)
            x = self._lookup(p, tokens)[:, None, :]
            x, caches, _ = tf.stack_forward(p["blocks"], p.get("shared_attn"),
                                            x, self.cfg, self.ctx,
                                            mode="decode", caches=caches,
                                            **self._stack_kwargs(layout))
            logits = self._whole(self._head(p, x[:, 0, :]))
        if self.cfg.family == "hybrid":
            caches = caches._replace(shared_kv=caches.shared_kv._replace(
                length=caches.shared_kv.length + 1))
        return logits, caches

    def _cache_len(self, caches):
        cfg = self.cfg
        if cfg.family in tf.ATTN_FAMILIES:
            return int(caches.kv.max_len)
        if cfg.family == "hybrid" and cfg.shared_attn_every:
            return int(caches.shared_kv.max_len)
        return 0
