"""The port's LM building blocks (ROADMAP A17 (i)) against the JAX package's.

Same inputs, made from a seed with numpy; JAX's weights reach the port
through ``models.convert.params_from_jax``. At float32 every output is held
to atol = rtol = 1e-4; at bfloat16 to ``tests/test_models.py``'s band
(rtol = atol = 0.15). The whole-model checks per family are in
``test_torch_model_families.py``; the decode service in
``test_torch_lm_serve.py``.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import lm as jlm
from repro.models import mamba2 as jmamba
from repro.models import moe as jmoe
from repro.models import xlstm as jxlstm
from repro.models.config import ModelConfig as JaxConfig
from repro.models.layers import ShardCtx as JaxShardCtx
from repro.models.layers import apply_rope as j_apply_rope
from repro.models.layers import cross_entropy as j_cross_entropy
from repro.models.layers import rms_norm as j_rms_norm
from repro.models.layers import swiglu as j_swiglu
from repro_torch.configs.smoke_lm import CONFIG, FAMILY_SMOKES, REDUCED
from repro_torch.models import attention as tattn
from repro_torch.models import lm as tlm
from repro_torch.models import mamba2 as tmamba
from repro_torch.models import moe as tmoe
from repro_torch.models import xlstm as txlstm
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import (params_from_jax, params_to_numpy,
                                        seeded_params)
from repro_torch.models.layers import (ParamInit, ShardCtx, apply_rope,
                                       cross_entropy, rms_norm, swiglu,
                                       tree_map)
from torch_workloads import one_torch_thread  # noqa: F401

F32_TOL = 1e-4
BF16_TOL = 0.15      # tests/test_models.py's band
DTYPES = ("float32", "bfloat16")
NO_CTX = ShardCtx(None, None, 1, 1)
J_NO_CTX = JaxShardCtx(None, None, 1, 1)


def jax_cfg(cfg: ModelConfig) -> JaxConfig:
    return JaxConfig(**dataclasses.asdict(cfg))


def as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def close(port, ref, dtype: str) -> float:
    """Port against JAX at the dtype's tolerance; the largest difference."""
    a, b = as_np(port), as_np(ref)
    assert a.shape == b.shape, (a.shape, b.shape)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol)
    return float(np.abs(a - b).max()) if a.size else 0.0


def seeded(init_fn, cfg, seed=0):
    """(port params, JAX params) of one block, drawn by the port's init
    from a numpy seed (JAX's distributions; drawing them through
    ``jax.random`` costs seconds of compiling a test), carried to the port
    through ``params_from_jax``."""
    tree = params_to_numpy(
        init_fn(ParamInit(np.random.default_rng(seed), "cpu"), cfg,
                NO_CTX)[0], bfloat16=jnp.bfloat16)
    return params_from_jax(tree, "cpu"), jax.tree.map(jnp.asarray, tree)


def both(a: np.ndarray, dtype: str):
    """One numpy array as (port tensor, JAX array) of ``dtype``."""
    j = jnp.asarray(a, jnp.dtype(dtype))
    return params_from_jax(np.asarray(j), "cpu"), j


def small_cfg(**kw) -> ModelConfig:
    base = dict(name="unit", family="dense", n_layers=1, d_model=32,
                n_heads=4, n_kv_heads=4, d_ff=48, vocab=64, qkv_bias=True,
                attn_chunk=4, ssm_chunk=4, dtype="float32")
    base.update(kw)
    return ModelConfig(**base)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_rms_norm(dtype):
    rng = np.random.default_rng(0)
    x_t, x_j = both(rng.normal(size=(3, 5, 16)) * 3, dtype)
    w_t, w_j = both(rng.normal(size=(16,)), dtype)
    out = rms_norm(x_t, w_t)
    assert out.dtype == x_t.dtype
    close(out, j_rms_norm(x_j, w_j), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("batch_positions", [False, True])
def test_apply_rope(dtype, batch_positions):
    rng = np.random.default_rng(1)
    x_t, x_j = both(rng.normal(size=(2, 7, 3, 8)), dtype)
    pos = (rng.integers(0, 100, (2, 7)) if batch_positions
           else np.arange(7)[None, :])
    out = apply_rope(x_t, torch.as_tensor(pos), 500.0)
    assert out.dtype == x_t.dtype
    close(out, j_apply_rope(x_j, jnp.asarray(pos), 500.0), dtype)


def test_rope_is_half_split():
    """Lane i rotates with lane i + hd/2 (not with its neighbour)."""
    x = torch.zeros(1, 1, 1, 8)
    x[..., 1] = 1.0
    out = apply_rope(x, torch.tensor([[3]]))
    nonzero = set(torch.nonzero(out[0, 0, 0].abs() > 1e-6).flatten().tolist())
    assert nonzero == {1, 5}


@pytest.mark.parametrize("z_loss", [0.0, 1e-3])
def test_cross_entropy(z_loss):
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(2, 6, 11)) * 2
    labels = rng.integers(0, 11, (2, 6))
    labels[0, 2] = labels[1, 5] = -1
    out = cross_entropy(torch.as_tensor(logits, dtype=torch.float32),
                        torch.as_tensor(labels), z_loss=z_loss)
    ref = j_cross_entropy(jnp.asarray(logits, jnp.float32),
                          jnp.asarray(labels), z_loss=z_loss)
    close(out, ref, "float32")


@pytest.mark.parametrize("dtype", DTYPES)
def test_swiglu(dtype):
    rng = np.random.default_rng(3)
    arrs = [rng.normal(size=s) * 0.3 for s in
            ((2, 5, 16), (16, 24), (16, 24), (24, 16))]
    ts, js = zip(*(both(a, dtype) for a in arrs))
    close(swiglu(*ts), j_swiglu(*js), dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv", [4, 2, 1])
@pytest.mark.parametrize("masked", [False, True])
def test_sdpa_block(kv, masked):
    cfg = small_cfg(n_kv_heads=kv)
    rng = np.random.default_rng(4 + kv)
    q = rng.normal(size=(2, 3, 4, 8))
    k = rng.normal(size=(2, 9, kv, 8))
    v = rng.normal(size=(2, 9, kv, 8))
    mask = rng.random((3, 9)) < 0.6 if masked else None
    mask_t = None if mask is None else torch.as_tensor(mask)
    mask_j = None if mask is None else jnp.asarray(mask)
    out = tattn._sdpa_block(*(torch.as_tensor(a, dtype=torch.float32)
                              for a in (q, k, v)), mask_t, cfg)
    ref = jattn._sdpa_block(*(jnp.asarray(a, jnp.float32)
                              for a in (q, k, v)), mask_j, jax_cfg(cfg))
    close(out, ref, "float32")


def test_sdpa_gqa_grouping():
    """Query head h reads kv head h // G: with KV = 2 and H = 4, heads 0-1
    see kv head 0 only."""
    cfg = small_cfg(n_kv_heads=2)
    q = torch.randn(1, 1, 4, 8)
    k = torch.randn(1, 5, 2, 8)
    v = torch.zeros(1, 5, 2, 8)
    v[:, :, 1] = 1.0
    out = tattn._sdpa_block(q, k, v, None, cfg)
    assert torch.all(out[0, 0, :2] == 0) and torch.allclose(
        out[0, 0, 2:], torch.ones(2, 8))


def _attn_params(cfg, seed=0):
    return seeded(tattn.init_attention, cfg, seed)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("seq", [16, 7])     # chunked by 4; odd: unchunked
@pytest.mark.parametrize("causal", [True, False])
def test_attention_forward(dtype, seq, causal):
    cfg = small_cfg(n_kv_heads=2, dtype=dtype)
    tp, jp = _attn_params(cfg)
    x_t, x_j = both(np.random.default_rng(5).normal(size=(2, seq, 32)),
                    dtype)
    out = tattn.attention_forward(tp, x_t, cfg, causal=causal)
    ref = jattn.attention_forward(jp, x_j, jax_cfg(cfg), causal=causal,
                                  head_tp=None, dp_spec=None)
    close(out, ref, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_cache_and_decode(dtype):
    cfg = small_cfg(n_kv_heads=2, dtype=dtype)
    jcfg = jax_cfg(cfg)
    tp, jp = _attn_params(cfg, seed=1)
    rng = np.random.default_rng(6)
    B, S, max_len = 2, 8, 12
    x_t, x_j = both(rng.normal(size=(B, S, 32)), dtype)
    cache = tattn.init_kv_cache(cfg, B, max_len, x_t.dtype, "cpu")
    cache.k.fill_(7.0)     # a used cache: prefill must clear the tail
    out, cache = tattn.prefill_cache(tp, x_t, cfg, cache=cache)
    ref, jcache = jattn.prefill_cache(jp, x_j, jcfg, head_tp=None,
                                      seq_axes=None, dp_spec=None,
                                      max_len=max_len)
    close(out, ref, dtype)
    assert cache.k.dtype == x_t.dtype and cache.length == int(jcache.length)
    close(cache.k, jcache.k, dtype)
    close(cache.v, jcache.v, dtype)
    for step in range(3):
        x1_t, x1_j = both(rng.normal(size=(B, 1, 32)), dtype)
        out, cache = tattn.attention_decode(tp, x1_t, cache, cfg)
        ref, jcache = jattn.attention_decode(jp, x1_j, jcache, jcfg,
                                             head_tp=None, seq_axes=None,
                                             dp_spec=None)
        close(out, ref, dtype)
        assert cache.length == int(jcache.length) == S + step + 1
        close(cache.k, jcache.k, dtype)
        close(cache.v, jcache.v, dtype)


# ---------------------------------------------------------------------------
# ROADMAP C7: a decode past the cache's max_len
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def c7_model():
    """The reduced smoke-lm at float32: config, port and JAX params, the
    port's model and JAX's."""
    cfg = dataclasses.replace(REDUCED, dtype="float32")
    tree = params_to_numpy(seeded_params(cfg, 0, "cpu")[0])
    return (cfg, params_from_jax(tree, "cpu"),
            jax.tree.map(jnp.asarray, tree), tlm.LMModel(cfg, device="cpu"),
            jlm.LMModel(jax_cfg(cfg)))


def test_c7_jax_clamps_a_decode_past_max_len(c7_model):
    """The reference's fault: at max_len 8 a prompt of 8 fills the cache,
    and the next decode clamps its write onto the last slot, reports length
    9 and returns finite, wrong logits (against the same decode with room,
    which the port gives as JAX would). The port refuses it."""
    cfg, tp, jp, tm, jm = c7_model
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 9))
    caches = jm.init_caches(2, 8)
    _, caches = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :8])}, caches)
    clamped, caches = jm.decode_step(jp, jnp.asarray(toks[:, 8]), caches)
    assert np.all(np.asarray(caches.kv.length) == 9)
    assert np.all(np.isfinite(np.asarray(clamped)))
    roomy = tm.init_caches(2, 9)
    _, roomy = tm.prefill(tp, {"tokens": toks[:, :8]}, roomy)
    roomy, _ = tm.decode_step(tp, toks[:, 8], roomy)
    assert np.abs(as_np(clamped) - as_np(roomy)).max() > 1e-2
    full = tm.init_caches(2, 8)
    _, full = tm.prefill(tp, {"tokens": toks[:, :8]}, full)
    with pytest.raises(ValueError, match="max_len 8"):
        tm.decode_step(tp, toks[:, 8], full)


def test_c7_prompt_longer_than_max_len(c7_model):
    cfg, tp, jp, tm, jm = c7_model
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 9))
    with pytest.raises(TypeError):
        jm.prefill(jp, {"tokens": jnp.asarray(toks)}, jm.init_caches(2, 8))
    with pytest.raises(ValueError, match="does not fit"):
        tm.prefill(tp, {"tokens": toks}, tm.init_caches(2, 8))


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def _moe(cfg, seed=0):
    return seeded(tmoe.init_moe, cfg, seed)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("capacity_factor", [100.0, 1.25, 0.5])
def test_moe_ffn(dtype, capacity_factor):
    cfg = small_cfg(family="moe", n_experts=4, top_k=2, dtype=dtype,
                    capacity_factor=capacity_factor)
    tp, jp = _moe(cfg)
    x_t, x_j = both(np.random.default_rng(7).normal(size=(3, 24, 32)), dtype)
    out, aux = tmoe.moe_ffn(tp, x_t, cfg)
    ref, jaux = jmoe.moe_ffn(jp, x_j, jax_cfg(cfg), ep_axis=None,
                             dp_spec=None)
    close(out, ref, dtype)
    drop = float(aux["dropped_frac"])
    if dtype == "float32":
        assert drop == pytest.approx(float(jaux["dropped_frac"]), abs=1e-7)
        close(aux["router_entropy"], jaux["router_entropy"], dtype)
    if capacity_factor == 0.5:
        assert drop > 0.2       # capacity 8 of 12 expected a row per expert
    if capacity_factor == 100.0:
        assert drop == 0.0


def test_moe_decode_folds_the_batch():
    """S = 1 and B > 1: one routing row across the batch (capacity shared),
    against JAX's fold."""
    cfg = small_cfg(family="moe", n_experts=4, top_k=2, capacity_factor=0.5)
    tp, jp = _moe(cfg, seed=1)
    x_t, x_j = both(np.random.default_rng(8).normal(size=(20, 1, 32)),
                    "float32")
    out, aux = tmoe.moe_ffn(tp, x_t, cfg)
    ref, jaux = jmoe.moe_ffn(jp, x_j, jax_cfg(cfg), ep_axis=None,
                             dp_spec=None)
    close(out, ref, "float32")
    assert tmoe.capacity(20, cfg) == 8
    assert float(aux["dropped_frac"]) == pytest.approx(
        float(jaux["dropped_frac"]), abs=1e-7)
    # folded: not each row routed alone (which would drop nothing)
    assert float(aux["dropped_frac"]) > 0


def test_moe_capacity():
    for S, k, E, cf, want in ((24, 2, 4, 1.25, 16), (1, 2, 4, 1.25, 8),
                              (100, 2, 8, 1.0, 32), (17, 2, 4, 1.25, 16)):
        cfg = small_cfg(family="moe", n_experts=E, top_k=k,
                        capacity_factor=cf)
        assert tmoe.capacity(S, cfg) == want


# ---------------------------------------------------------------------------
# chunked gated linear (mLSTM, Mamba2) and Mamba2
# ---------------------------------------------------------------------------

def _gated_inputs(seed, S, shared=False):
    rng = np.random.default_rng(seed)
    B, H, dk, dv = 2, 3, 4, 5
    q = rng.normal(size=(B, S, 1 if shared else H, dk))
    k = rng.normal(size=(B, S, 1 if shared else H, dk))
    if shared:
        q, k = (np.broadcast_to(a, (B, S, H, dk)).copy() for a in (q, k))
    v = rng.normal(size=(B, S, H, dv))
    log_f = -rng.uniform(0.01, 1.0, (B, S, H))
    i_gate = rng.uniform(0.1, 1.0, (B, S, H))
    return [a.astype(np.float32) for a in (q, k, v, log_f, i_gate)]


@pytest.mark.parametrize("S", [16, 10])      # chunks of 4; odd: one chunk
@pytest.mark.parametrize("shared_qk", [False, True])
def test_chunked_gated_linear(S, shared_qk):
    arrs = _gated_inputs(9, S, shared_qk)
    ts = [torch.as_tensor(a) for a in arrs]
    y, state = txlstm.chunked_gated_linear(*ts, 4, shared_qk=shared_qk)
    jy, jstate = jxlstm.chunked_gated_linear(*(jnp.asarray(a) for a in arrs),
                                             4, shared_qk=shared_qk)
    close(y, jy, "float32")
    close(state, jstate, "float32")
    # against the recurrence, one token at a time
    st = torch.zeros_like(state)
    ys = []
    for t in range(S):
        st, yt = txlstm.gated_linear_step(st, *(a[:, t] for a in ts))
        ys.append(yt)
    close(y, torch.stack(ys, dim=1), "float32")
    close(state, st, "float32")


def test_gated_linear_step():
    arrs = _gated_inputs(10, 1)
    state = np.random.default_rng(11).normal(size=(2, 3, 4, 5)).astype(
        np.float32)
    st, y = txlstm.gated_linear_step(torch.as_tensor(state),
                                     *(torch.as_tensor(a[:, 0])
                                       for a in arrs))
    jst, jy = jxlstm.gated_linear_step(jnp.asarray(state),
                                       *(jnp.asarray(a[:, 0]) for a in arrs))
    close(st, jst, "float32")
    close(y, jy, "float32")


def _mamba_cfg(dtype="float32"):
    return small_cfg(family="hybrid", ssm_state=8, ssm_head_dim=8,
                     conv_width=4, dtype=dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba2_forward_chunked_and_step(dtype):
    cfg = _mamba_cfg(dtype)
    jcfg = jax_cfg(cfg)
    tp, jp = seeded(tmamba.init_mamba2, cfg, 2)
    rng = np.random.default_rng(12)
    x_t, x_j = both(rng.normal(size=(2, 12, 32)), dtype)
    out, st = tmamba.mamba2_forward(tp, x_t, cfg)
    ref, jst = jmamba.mamba2_forward(jp, x_j, jcfg)
    close(out, ref, dtype)
    close(st.conv, jst.conv, dtype)
    close(st.ssm, jst.ssm, dtype)
    for _ in range(2):
        x1_t, x1_j = both(rng.normal(size=(2, 1, 32)), dtype)
        out, st = tmamba.mamba2_forward(tp, x1_t, cfg, state=st)
        ref, jst = jmamba.mamba2_forward(jp, x1_j, jcfg, state=jst)
        close(out, ref, dtype)
        close(st.conv, jst.conv, dtype)
        close(st.ssm, jst.ssm, dtype)


def test_mamba2_steps_equal_the_chunked_scan():
    """Token-by-token decode from a zero state reproduces the chunked
    forward (the port alone)."""
    cfg = _mamba_cfg()
    tp, _ = seeded_params(dataclasses.replace(cfg, n_layers=1), 0, "cpu")
    p = tree_map(lambda a: a[0], tp["blocks"]["mamba"])
    x = torch.as_tensor(np.random.default_rng(13).normal(size=(2, 12, 32)),
                        dtype=torch.float32)
    full, _ = tmamba.mamba2_forward(p, x, cfg)
    st = tmamba.mamba2_state(cfg, 2, "cpu")
    outs = []
    for t in range(12):
        o, st = tmamba.mamba2_forward(p, x[:, t:t + 1], cfg, state=st)
        outs.append(o)
    close(torch.cat(outs, dim=1), full, "float32")


def test_causal_conv_order():
    rng = np.random.default_rng(14)
    u, w, prev = (rng.normal(size=s).astype(np.float32)
                  for s in ((2, 6, 5), (4, 5), (2, 3, 5)))
    for pv in (None, prev):
        out, win = tmamba._causal_conv(
            torch.as_tensor(u), torch.as_tensor(w),
            None if pv is None else torch.as_tensor(pv))
        jout, jwin = jmamba._causal_conv(
            jnp.asarray(u), jnp.asarray(w), None if pv is None
            else jnp.asarray(pv))
        assert np.array_equal(out.numpy(), np.asarray(jout))
        assert np.array_equal(win.numpy(), np.asarray(jwin))


# ---------------------------------------------------------------------------
# init: shapes, dtypes and specs against JAX's abstract params
# ---------------------------------------------------------------------------

def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


CONFIGS = {"smoke-lm": CONFIG, "smoke-lm-reduced": REDUCED, **FAMILY_SMOKES}
CTXS = {"none": (None, None, 1, 1), "data4-model2": ("data", "model", 4, 2)}


@pytest.mark.parametrize("ctx", list(CTXS))
@pytest.mark.parametrize("name", list(CONFIGS))
def test_abstract_params_match_jax(name, ctx):
    cfg = CONFIGS[name]
    jm = jlm.LMModel(jax_cfg(cfg))
    jm.ctx = JaxShardCtx(*CTXS[ctx])
    jshapes, jspecs = jm.abstract_params()
    tm = tlm.LMModel(cfg, device="cpu")
    tm.ctx = ShardCtx(*CTXS[ctx])
    tparams, tspecs = tm.abstract_params()
    js, jsp = _flat(jshapes), _flat(
        jax.tree.map(tuple, jspecs, is_leaf=lambda s: isinstance(
            s, jax.sharding.PartitionSpec)))
    ts, tsp = _flat(tparams), _flat(tspecs)
    assert set(js) == set(ts) == set(jsp) == set(tsp)
    for path in js:
        assert tuple(ts[path].shape) == tuple(js[path].shape), path
        assert str(ts[path].dtype) == f"torch.{js[path].dtype.name}", path
        assert ts[path].device.type == "meta"
        assert tuple(tsp[path]) == tuple(jsp[path]), path
    total = sum(int(np.prod(t.shape)) for t in ts.values())
    assert total == sum(int(np.prod(s.shape)) for s in js.values())
    assert abs(total - cfg.param_count()) / cfg.param_count() < 0.03


@pytest.mark.parametrize("source", ["torch", "numpy"])
def test_init_values(source):
    """JAX's distributions: normal x 1/sqrt(d_in), 0.02 for the embed and
    head, zero biases, unit norms; one seed gives one set of weights."""
    cfg = REDUCED
    gen = (lambda: torch.Generator().manual_seed(3)) if source == "torch" \
        else (lambda: np.random.default_rng(3))
    tm = tlm.LMModel(cfg, device="cpu")
    p, _ = tm.init(gen())
    q, _ = tm.init(gen())
    for path, a in _flat(p).items():
        assert torch.equal(a, _flat(q)[path]), path
        assert a.dtype == torch.bfloat16
    wq = p["blocks"]["attn"]["wq"].float()
    assert wq.shape == (2, 128, 128)
    assert wq.std().item() == pytest.approx(1 / np.sqrt(128), rel=0.05)
    assert p["embed"].float().std().item() == pytest.approx(0.02, rel=0.05)
    assert torch.all(p["blocks"]["attn"]["bq"] == 0)
    assert torch.all(p["blocks"]["ln1"] == 1) and torch.all(
        p["final_norm"] == 1)
    assert not torch.equal(p["blocks"]["attn"]["wq"][0],
                           p["blocks"]["attn"]["wq"][1])


# ---------------------------------------------------------------------------
# layout and the weight carry-over
# ---------------------------------------------------------------------------

MESHES = [("data", "model"), ("pod", "data", "model"), ("data",),
          ("model",)]


@pytest.mark.parametrize("names", MESHES)
def test_choose_layout_matches_jax(names):
    sizes = {"pod": 2, "data": 4, "model": 2}
    mesh = types.SimpleNamespace(axis_names=names,
                                 shape={n: sizes[n] for n in names})
    for cfg in (CONFIG, REDUCED, dataclasses.replace(REDUCED, n_heads=3)):
        jcfg = jax_cfg(cfg)
        assert dataclasses.astuple(tlm.make_shard_ctx(mesh)) == \
            dataclasses.astuple(jlm.make_shard_ctx(mesh))
        for batch in (1, 2, 4, 8, 6):
            for seq in (1, 2, 16, 12):
                got = tlm.choose_layout(cfg, mesh, batch, seq)
                want = jlm.choose_layout(jcfg, mesh, batch, seq)
                assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert tlm.choose_layout(CONFIG, None, 4, 8) == tlm.Layout(None, None,
                                                               None)


@pytest.mark.parametrize("dtype", DTYPES)
def test_params_round_trip_bit_for_bit(dtype):
    cfg = dataclasses.replace(FAMILY_SMOKES["hybrid"], dtype=dtype)
    # JAX's tree as jax.tree.map(np.asarray, params) gives it: bfloat16
    # leaves as ml_dtypes.bfloat16
    jp = jax.tree.map(jnp.asarray, params_to_numpy(
        seeded_params(cfg, 4, "cpu")[0], bfloat16=jnp.bfloat16))
    tree = jax.tree.map(np.asarray, jp)
    tp = params_from_jax(tree, "cpu")
    back = params_to_numpy(tp, bfloat16=jnp.bfloat16)
    bits = params_to_numpy(tp)
    flat_in, flat_back, flat_bits = _flat(tree), _flat(back), _flat(bits)
    assert set(flat_in) == set(flat_back)
    assert tp["blocks"]["mamba"]["win"].shape[0] == cfg.n_layers
    for path, a in flat_in.items():
        b = flat_back[path]
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path
        if a.dtype.name == "bfloat16":
            assert flat_bits[path].dtype == np.uint16
            assert np.array_equal(flat_bits[path], a.view(np.uint16))
        assert str(_flat(tp)[path].dtype) == f"torch.{a.dtype.name}"
