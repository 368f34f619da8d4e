"""The port's model stack per family (ROADMAP A17 (i)) against the JAX
package's: ``stack_forward``, ``LMModel.encode``, ``prefill`` and
``decode_step`` with their caches, on the reduced smoke-lm and the small
moe, ssm and hybrid configs, at float32 (atol = rtol = 1e-4) and bfloat16
(``tests/test_models.py``'s band: rtol = atol = 0.15, argmax agreement >=
0.95). One set of numpy-seeded weights (``convert.seeded_params``) reaches
JAX as arrays and the port through ``params_from_jax``. JAX runs eagerly:
at these sizes compiling whole programs costs more than it saves.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import lm as jlm
from repro.models import transformer as jtf
from repro.models.config import ModelConfig as JaxConfig
from repro.models.layers import rms_norm as j_rms_norm
from repro_torch.configs.smoke_lm import FAMILY_SMOKES, REDUCED
from repro_torch.models import lm as tlm
from repro_torch.models import transformer as ttf
from repro_torch.models.convert import (params_from_jax, params_to_numpy,
                                        seeded_params)
from repro_torch.models.layers import tree_map
from torch_workloads import one_torch_thread  # noqa: F401

F32_TOL = 1e-4
BF16_TOL = 0.15
ARGMAX_AGREE = 0.95
B, S = 4, 15        # prompt; the forward covers S + 1 tokens: at most 16
DECODE_STEPS = 2    # a moe row, so no expert passes its 16 slots
# where the reference is EagerLayers with a decisive router (see there)
EAGER_LAYERS = {("moe", "bfloat16")}
ROUTER_SCALE = 50.0
CONFIGS = {"smoke-lm-reduced": REDUCED, **FAMILY_SMOKES}
CASES = [(name, dtype) for name in CONFIGS
         for dtype in ("float32", "bfloat16")]
_RUNS = {}


def as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def close(port, ref, dtype, argmax: bool = False):
    a, b = as_np(port), as_np(ref)
    assert a.shape == b.shape, (a.shape, b.shape)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol)
    if argmax and dtype == "bfloat16":
        agree = (a.argmax(-1) == b.argmax(-1)).mean()
        assert agree >= ARGMAX_AGREE, agree


def cache_leaves(caches):
    """The caches' arrays in field order, the lengths as ints."""
    out = []

    def walk(t):
        if isinstance(t, tuple):
            for v in t:
                walk(v)
        elif t is not None:
            out.append(t)

    walk(tuple(caches))
    return out


def close_caches(port, ref, dtype):
    tl, jl = cache_leaves(port), cache_leaves(ref)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        b = np.asarray(b)
        if b.dtype.kind == "i":        # a length: exact
            assert np.array_equal(np.asarray(a), b)
        else:
            close(a, b, dtype)


class EagerLayers(jlm.LMModel):
    """JAX's model with its attention-family layers applied one at a time,
    eagerly, where ``stack_forward`` scans them: the moe family's bf16
    reference. A router's top-2 of 4 experts is a discrete choice, and
    at bfloat16 two things break it differently for single tokens, each
    moving that token's output past the band:
    - at JAX's router scale (0.02) the top-2 sits within bf16 rounding of a
      tie, and the port and JAX's eager layers broke one the other way
      (0.79 on the forward); a router scaled by ROUTER_SCALE is decisive;
    - XLA's compiled scan body departs from the per-operation rounding of
      the same layers run op by op, by 0.73 on layer 0 even with the
      decisive router (``test_jax_scan_departs_at_moe_bf16``).
    The port rounds per operation, as the eager layers do."""

    def stack_forward(self, p, x, *, mode, caches=None):
        kv, lengths, ks, vs = (caches.kv if caches is not None else None,
                               [], [], [])
        for i in range(self.cfg.n_layers):
            bp = jax.tree.map(lambda a: a[i], p["blocks"])
            cache = None if kv is None else jattn.KVCache(
                k=kv.k[i], v=kv.v[i], length=kv.length[i])
            x, nc, _ = jtf._apply_attn_layer(
                bp, x, self.cfg, mode=mode, head_tp=None, seq_axes=None,
                dp_spec=None, cache=cache)
            if nc is not None:
                ks.append(nc.k)
                vs.append(nc.v)
                lengths.append(nc.length)
        if mode == "train":
            return x, None, {}
        return x, jtf.StackCaches(kv=jattn.KVCache(
            k=jnp.stack(ks), v=jnp.stack(vs), length=jnp.stack(lengths))), {}

    def prefill(self, p, batch, caches):
        x = self._embed_in(p, batch, self._default_layout(batch))
        x, caches, _ = self.stack_forward(p, x, mode="prefill", caches=caches)
        x = j_rms_norm(x, p["final_norm"])
        return x[:, -1, :] @ p["head"].T.astype(x.dtype), caches

    def decode_step(self, p, tokens, caches):
        x = p["embed"][tokens][:, None, :].astype(jnp.dtype(self.cfg.dtype))
        x, caches, _ = self.stack_forward(p, x, mode="decode", caches=caches)
        x = j_rms_norm(x, p["final_norm"])
        return x[:, 0, :] @ p["head"].T.astype(x.dtype), caches


def jax_stack(jm, jp, x, **kw):
    """JAX's own scanned stack_forward (or EagerLayers')."""
    if isinstance(jm, EagerLayers):
        return jm.stack_forward(jp, x, **kw)
    return jtf.stack_forward(jp["blocks"], jp.get("shared_attn"), x,
                             jm.cfg, jm.ctx, head_tp=None, seq_axes=None,
                             dp_spec=None, **kw)


def snapshot(caches):
    """A copy of the port's caches, which later steps write in place."""
    return tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor)
                    else t, caches)


def run(name: str, dtype: str) -> dict:
    """Both packages on one config and dtype, computed once a module."""
    if (name, dtype) in _RUNS:
        return _RUNS[name, dtype]
    cfg = dataclasses.replace(CONFIGS[name], dtype=dtype)
    tree = params_to_numpy(seeded_params(cfg, 0, "cpu")[0],
                           bfloat16=jnp.bfloat16)
    if (name, dtype) in EAGER_LAYERS:
        tree["blocks"]["moe"]["router"] *= ROUTER_SCALE
    tp = params_from_jax(tree, "cpu")
    jp = jax.tree.map(jnp.asarray, tree)
    toks = np.random.default_rng(2).integers(0, cfg.vocab,
                                             (B, S + DECODE_STEPS))
    jcfg = JaxConfig(**dataclasses.asdict(cfg))
    jm = jlm.LMModel(jcfg)
    if (name, dtype) in EAGER_LAYERS:
        jm = EagerLayers(jcfg)
    tm = tlm.LMModel(cfg, device="cpu")
    r = {"cfg": cfg, "toks": toks, "jp": jp, "jcfg": jcfg}
    # the teacher-forced forward over the prompt and the first decoded token
    full = {"tokens": jnp.asarray(toks[:, :S + 1])}
    x = jm._embed_in(jp, full, jm._default_layout(full))
    jx, _, _ = jax_stack(jm, jp, x, mode="train")
    r["jax_x"] = jx
    r["jax_logits"] = (j_rms_norm(jx, jp["final_norm"])
                       @ jp["head"].T.astype(jx.dtype))
    with torch.inference_mode():
        tx = tm._embed_in(tp, {"tokens": toks[:, :S + 1]})
        r["port_x"], none, aux = ttf.stack_forward(
            tp["blocks"], tp.get("shared_attn"), tx, cfg, mode="train")
    assert none is None and float(aux["dropped_frac"]) == 0.0
    r["port_logits"] = tm.encode(tp, {"tokens": toks[:, :S + 1]})
    # prefill, then decode steps
    jc = jm.init_caches(B, S + DECODE_STEPS + 1)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :S])}, jc)
    tc = tm.init_caches(B, S + DECODE_STEPS + 1)
    tl, tc = tm.prefill(tp, {"tokens": toks[:, :S]}, tc)
    # the caches are written in place by later steps: copy what is compared
    r["prefill"] = (tl, jl, snapshot(tc), jc)
    r["decode"] = []
    for t in range(DECODE_STEPS):
        jl, jc = jm.decode_step(jp, jnp.asarray(toks[:, S + t]), jc)
        tl, tc = tm.decode_step(tp, toks[:, S + t], tc)
        r["decode"].append((tl, jl, snapshot(tc), jc))
    _RUNS[name, dtype] = r
    return r


@pytest.mark.parametrize("name,dtype", CASES)
def test_stack_forward(name, dtype):
    r = run(name, dtype)
    assert r["port_x"].dtype == getattr(torch, dtype)
    close(r["port_x"], r["jax_x"], dtype)


@pytest.mark.parametrize("name,dtype", CASES)
def test_encode(name, dtype):
    r = run(name, dtype)
    close(r["port_logits"], r["jax_logits"], dtype, argmax=True)


@pytest.mark.parametrize("name,dtype", CASES)
def test_prefill(name, dtype):
    tl, jl, tc, jc = run(name, dtype)["prefill"]
    close(tl, jl, dtype, argmax=True)
    close_caches(tc, jc, dtype)


@pytest.mark.parametrize("name,dtype", CASES)
def test_decode_steps(name, dtype):
    for tl, jl, tc, jc in run(name, dtype)["decode"]:
        close(tl, jl, dtype, argmax=True)
        close_caches(tc, jc, dtype)


@pytest.mark.parametrize("name,dtype", CASES)
def test_decode_matches_forward(name, dtype):
    """The port alone, as tests/test_models.py holds JAX: the prefill's and
    the first decode step's logits against the teacher-forced forward at
    their positions."""
    r = run(name, dtype)
    close(r["prefill"][0], r["port_logits"][:, S - 1], dtype, argmax=True)
    close(r["decode"][0][0], r["port_logits"][:, S], dtype, argmax=True)


def test_jax_scan_departs_at_moe_bf16():
    """Why the moe family's bf16 reference is EagerLayers: JAX's scanned
    stack leaves the band against the same layers run op by op, and the
    port stays in it."""
    r = run("moe", "bfloat16")
    x = r["jp"]["embed"][jnp.asarray(r["toks"][:, :S + 1])]
    scanned = jax_stack(jlm.LMModel(r["jcfg"]), r["jp"], x, mode="train")[0]
    eager = jax_stack(EagerLayers(r["jcfg"]), r["jp"], x, mode="train")[0]
    assert np.abs(as_np(scanned) - as_np(eager)).max() > BF16_TOL
    close(r["port_x"], eager, "bfloat16")
