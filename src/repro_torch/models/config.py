"""Architecture configuration shared by models/, configs/ and launch/: a copy
of ``repro.models.config`` (the port imports nothing of ``repro``)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    encoder_only: bool = False
    input_kind: str = "tokens"   # tokens | embeddings (audio/vlm stub frontends)
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 2
    moe_dense_residual: bool = False   # arctic: dense FFN in parallel with MoE
    capacity_factor: float = 1.25
    # --- SSM / hybrid ---
    ssm_state: int = 0           # mamba2 N
    ssm_head_dim: int = 64       # mamba2 P
    ssm_expand: int = 2
    conv_width: int = 4
    slstm_every: int = 0         # xlstm: every k-th layer is sLSTM (0 = none)
    shared_attn_every: int = 0   # zamba2: shared attn block every k layers
    # --- numerics / scheduling ---
    dtype: str = "bfloat16"
    attn_chunk: int = 512        # query chunk for memory-efficient attention
    ssm_chunk: int = 256         # chunk for mLSTM / SSD scan
    loss_chunk: int = 2048       # sequence chunk for the CE loss
    remat: bool = True
    z_loss: float = 0.0
    # JAX's config carries ``unroll_scans`` for its dry run, whose XLA cost
    # analysis counts a while body once. The port's stack is a Python loop
    # that runs every layer, and its dry run (launch/dryrun.py) counts the
    # eager step on meta tensors, so it has no such field.

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (no full-attention over the whole context).

        zamba2 qualifies: its Mamba2 backbone is linear; the single shared
        attention block holds the only full KV cache, which is O(S) memory
        and O(S) work per decoded token.
        """
        return self.family in ("ssm", "hybrid")

    @property
    def has_decode(self) -> bool:
        return not self.encoder_only

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kind, e.g. ('attn',)*L or mLSTM/sLSTM pattern."""
        kinds = []
        for l in range(self.n_layers):
            if self.family == "ssm" and self.slstm_every:
                kinds.append("slstm" if (l % self.slstm_every == self.slstm_every - 1)
                             else "mlstm")
            elif self.family == "ssm":
                kinds.append("mlstm")
            elif self.family == "hybrid":
                kinds.append("mamba2")
            else:
                kinds.append("attn")
        return tuple(kinds)

    def param_count(self) -> int:
        """Allocated parameter count (embedding + blocks + head).

        For mixed-kind SSM stacks (xlstm), every scanned layer carries the
        UNION of block parameter sets (the stack is one homogeneous lax.scan;
        the per-layer kind flag selects the live branch). The dead branch's
        weights are allocated but untrained -- counted here, excluded from
        ``active_param_count`` (which feeds MODEL_FLOPS). Recorded in
        DESIGN.md as a deliberate scan-homogeneity trade-off.
        """
        d, V, L = self.d_model, self.vocab, self.n_layers
        emb = V * d if (self.input_kind == "tokens" or self.has_decode) else 0
        head = d * V
        total = emb + head + d  # + final norm
        kinds_per_layer = self.layer_kinds()
        union = sorted(set(kinds_per_layer))
        effective = (union * L if len(union) > 1 else list(kinds_per_layer))
        total += sum(self._block_params(k) for k in effective)
        if self.family == "hybrid" and self.shared_attn_every:
            H, KV, hd = self.n_heads, self.n_kv_heads, self.head_dim
            total += (2 * d + d * H * hd + 2 * d * KV * hd + H * hd * d
                      + 3 * d * self.d_ff)
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k experts; mixed SSM
        stacks: only each layer's live branch)."""
        d, ff, L = self.d_model, self.d_ff, self.n_layers
        total = self.param_count()
        if self.n_experts:
            total -= L * (self.n_experts - self.top_k) * 3 * d * ff
        kinds = self.layer_kinds()
        union = sorted(set(kinds))
        if len(union) > 1:  # subtract each layer's dead branch
            sizes = {k: self._block_params(k) for k in union}
            for k in kinds:
                for other in union:
                    if other != k:
                        total -= sizes[other]
        return total

    def _block_params(self, kind: str) -> int:
        """Exact per-layer parameter count of one block kind (matches
        models/transformer._init_layer)."""
        d, ff = self.d_model, self.d_ff
        H, KV, hd = self.n_heads, self.n_kv_heads, self.head_dim
        if kind == "attn":
            blk = d + d  # ln1, ln2
            blk += d * H * hd + 2 * d * KV * hd + H * hd * d
            if self.qkv_bias:
                blk += H * hd + 2 * KV * hd
            if self.n_experts:
                blk += d * self.n_experts + self.n_experts * 3 * d * ff
                if self.moe_dense_residual:
                    blk += 3 * d * ff
            else:
                blk += 3 * d * ff
            return blk
        if kind == "mlstm":
            di = self.d_inner
            return d + d * 3 * di + d * 2 * self.n_heads + di * d
        if kind == "slstm":
            return d + 8 * d * d
        if kind == "mamba2":
            di = self.d_inner
            nheads = di // self.ssm_head_dim
            blk = d + d * (2 * di + 2 * self.ssm_state + nheads) + di * d
            return blk + self.conv_width * (di + 2 * self.ssm_state) + 3 * nheads
        raise ValueError(kind)
