"""The port's training state (ROADMAP A17 (ii a)) against the JAX
package's: AdamW (``adamw_init``, ``adamw_update``, ``opt_state_specs``),
three steps of ``make_train_step`` against JAX's jitted step, the token
pipeline bit for bit, checkpoints in both directions, and the straggler
monitor.

Tolerances: AdamW on the same gradients holds every state leaf and
parameter to JAX's within ADAMW_RTOL relative, and within ADAMW_RTOL of
the leaf's largest magnitude where a moment cancels to near zero (float32
arithmetic in the same order; the last bits of a norm's sum, ``pow`` and
``sqrt`` may differ), and bf16 leaves within one bf16 ulp; the train
steps hold the losses to STEP_RTOL relative and the parameters to F32_TOL
(rtol = atol, the forward's band). Pipelines and checkpoints are exact.
"""
import dataclasses
import json
import os
import time
from collections import namedtuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jckpt
from repro.data.pipeline import TokenPipeline as JaxPipeline
from repro.models.config import ModelConfig as JaxConfig
from repro.models.lm import LMModel as JaxLM
from repro.train import optimizer as jopt
from repro.train.steps import make_train_step as j_make_train_step
from repro.train.straggler import StragglerMonitor as JaxMonitor
from repro_torch.ckpt import (CheckpointManager, latest_step,
                              restore_checkpoint, save_checkpoint)
from repro_torch.configs.smoke_lm import FAMILY_SMOKES, REDUCED
from repro_torch.data import TokenPipeline
from repro_torch.models.convert import (params_from_jax, params_to_numpy,
                                        seeded_params)
from repro_torch.models.layers import tree_flatten_with_path, tree_map
from repro_torch.models.lm import LMModel
from repro_torch.train import optimizer as topt
from repro_torch.train.steps import make_train_step
from repro_torch.train.straggler import StragglerMonitor
from torch_workloads import one_torch_thread  # noqa: F401

ADAMW_RTOL = 1e-6
BF16_ULP = 2.0 ** -8
F32_TOL = 1e-4
STEP_RTOL = 1e-5
ADAMW_STEPS = 5
TRAIN_STEPS = 3
# the driver's defaults: lr 3e-4 reached after 20 warmup steps
DRIVER_OPT = dict(lr=3e-4, warmup_steps=20)
OPT_CASES = {
    "default": {},
    "factored": {"factored": True},
    "m-bfloat16": {"m_dtype": "bfloat16"},
    "no-clip": {"grad_clip": 0.0},
    "tight-clip": {"grad_clip": 0.05, "warmup_steps": 2},
}
FakeMesh = namedtuple("FakeMesh", "axis_names shape")


def np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def as_jax(tree):
    return jax.tree.map(jnp.asarray, params_to_numpy(tree,
                                                     bfloat16=jnp.bfloat16))


def small_params(dtype=torch.float32):
    """A tree with 1-D, 2-D and 3-D leaves, nested dicts out of key order."""
    rng = np.random.default_rng(0)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(dtype)

    return {"w": t(6, 5), "b": {"z": t(5), "a": t(3, 4, 2)}, "e": t(7)}


def grads_at(step, params):
    rng = np.random.default_rng(100 + step)
    return tree_map(lambda p: torch.from_numpy((rng.normal(
        size=tuple(p.shape)) * 0.3).astype(np.float32)).to(p.dtype), params)


def assert_tree_close(port, ref, rtol):
    pl = tree_flatten_with_path(port)
    jl = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert len(pl) == len(jl)
    for (path, a), (_, b) in zip(pl, jl):
        if a.dtype == torch.bfloat16:
            assert np.asarray(b).dtype == jnp.bfloat16
            np.testing.assert_allclose(np32(a), np32(b), rtol=BF16_ULP,
                                       atol=0, err_msg=str(path))
        else:
            assert str(a.dtype).removeprefix("torch.") == \
                str(np.asarray(b).dtype), path
            b = np32(b)
            np.testing.assert_allclose(np32(a), b, rtol=rtol,
                                       atol=rtol * np.abs(b).max(),
                                       err_msg=str(path))


@pytest.mark.parametrize("case", OPT_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_matches_jax(case, dtype):
    """ADAMW_STEPS updates on the same gradients: params, master, m, v,
    step, grad_norm and lr. bf16 params keep their f32 master."""
    cfg_kw = OPT_CASES[case]
    tcfg, jcfg = topt.AdamWConfig(**cfg_kw), jopt.AdamWConfig(**cfg_kw)
    params = small_params(getattr(torch, dtype))
    state = topt.adamw_init(params, tcfg)
    jparams = as_jax(params)
    jstate = jopt.adamw_init(jparams, jcfg)
    assert_tree_close(state, jstate, 0)
    for step in range(ADAMW_STEPS):
        g = grads_at(step, params)
        params, state, m = topt.adamw_update(g, state, params, tcfg)
        jparams, jstate, jm = jopt.adamw_update(as_jax(g), jstate, jparams,
                                                jcfg)
        assert int(state["step"]) == int(jstate["step"]) == step + 1
        assert state["step"].dtype == torch.int32
        for k in ("grad_norm", "lr"):
            assert m[k].dtype == torch.float32
            np.testing.assert_allclose(np32(m[k]), np32(jm[k]),
                                       rtol=ADAMW_RTOL)
        assert_tree_close(state, jstate, ADAMW_RTOL)
        assert_tree_close(params, jparams, ADAMW_RTOL)
    assert all(p.dtype == getattr(torch, dtype)
               for _, p in tree_flatten_with_path(params))
    assert all(p.dtype == torch.float32
               for _, p in tree_flatten_with_path(state["master"]))


def test_adamw_moves_toward_the_minimum():
    """tests/test_optimizer.py's convergence check, on the port: a
    quadratic bowl is descended, and clipping bounds the first update."""
    cfg = topt.AdamWConfig(lr=0.1, warmup_steps=1, weight_decay=0.0)
    params = {"x": torch.tensor([3.0, -2.0])}
    state = topt.adamw_init(params, cfg)
    for _ in range(200):
        params, state, _ = topt.adamw_update({"x": 2 * params["x"]}, state,
                                             params, cfg)
    assert float(params["x"].abs().max()) < 0.05
    big = {"x": torch.tensor([1e6, 0.0])}
    p1, _, m = topt.adamw_update(big, topt.adamw_init({"x": torch.zeros(2)},
                                                      cfg),
                                 {"x": torch.zeros(2)}, cfg)
    assert float(m["grad_norm"]) == 1e6
    assert float(p1["x"].abs().max()) <= 0.1 + 1e-6


@pytest.mark.parametrize("factored", [False, True])
def test_opt_state_specs_match_jax(factored):
    """On a (data 2, model 4) layout, the state's spec tuples equal JAX's
    PartitionSpecs, factored v included."""
    mesh = FakeMesh(("data", "model"), {"data": 2, "model": 4})
    cfg = REDUCED
    shapes, specs = LMModel(cfg, mesh, device="cpu").abstract_params()
    jshapes, jspecs = JaxLM(JaxConfig(**dataclasses.asdict(cfg)),
                            mesh).abstract_params()
    got = topt.opt_state_specs(specs, topt.AdamWConfig(factored=factored),
                               shapes)
    want = jopt.opt_state_specs(jspecs, jopt.AdamWConfig(factored=factored),
                                jshapes)
    is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)
    want = jax.tree.map(tuple, want, is_leaf=is_spec)
    assert got == want
    assert {"data", "model"} <= set(spec_axes(got))
    state = topt.adamw_init(shapes, topt.AdamWConfig(factored=factored))
    v_specs = got["v"]
    for path, t in tree_flatten_with_path(state["v"]):
        spec = v_specs
        for k in path:
            spec = spec[k]
        assert len(spec) == t.ndim, path


def spec_axes(tree):
    if isinstance(tree, dict):
        return [a for v in tree.values() for a in spec_axes(v)]
    return [a for a in tree if a is not None]


def pipeline_batches(steps, seed=0, **kw):
    pipe = TokenPipeline(seed=seed, device="cpu", **kw)
    return [pipe.batch_at(s) for s in steps]


def train_both(cfg, n_steps, opt_kw):
    """n_steps of the port's step and JAX's jitted step from the same
    seeded weights over the same pipeline batches."""
    tree = params_to_numpy(seeded_params(cfg, 0, "cpu")[0],
                           bfloat16=jnp.bfloat16)
    batches = pipeline_batches(range(n_steps), vocab=cfg.vocab, batch=2,
                               seq=16)
    jm = JaxLM(JaxConfig(**dataclasses.asdict(cfg)))
    jcfg = jopt.AdamWConfig(**opt_kw)
    jstep = jax.jit(j_make_train_step(jm, jcfg))
    jp = jax.tree.map(jnp.asarray, tree)
    js = jopt.adamw_init(jp, jcfg)
    model = LMModel(cfg, device="cpu")
    tcfg = topt.AdamWConfig(**opt_kw)
    step = make_train_step(model, tcfg)
    tp = params_from_jax(tree, "cpu")
    ts = topt.adamw_init(tp, tcfg)
    out = []
    for b in batches:
        jp, js, jmet = jstep(jp, js, jax.tree.map(jnp.asarray, b))
        tp, ts, tmet = step(tp, ts, b)
        out.append((tmet, jmet))
    return tp, ts, jp, js, out


@pytest.mark.parametrize("name", ["smoke-lm-reduced", "moe"])
def test_train_steps_match_jax(name):
    cfg = dataclasses.replace({"smoke-lm-reduced": REDUCED,
                               **FAMILY_SMOKES}[name], dtype="float32")
    tp, ts, jp, js, out = train_both(cfg, TRAIN_STEPS, DRIVER_OPT)
    for tmet, jmet in out:
        assert set(tmet) == {"loss", "dropped_frac", "grad_norm", "lr"}
        assert all(not v.requires_grad for v in tmet.values())
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(np32(tmet[k]), np32(jmet[k]),
                                       rtol=STEP_RTOL)
        np.testing.assert_allclose(np32(tmet["lr"]), np32(jmet["lr"]),
                                   rtol=ADAMW_RTOL)
        assert float(tmet["dropped_frac"]) == float(jmet["dropped_frac"])
    for (path, a), (_, b) in zip(tree_flatten_with_path(tp),
                                 jax.tree_util.tree_flatten_with_path(jp)[0]):
        np.testing.assert_allclose(np32(a), np32(b), rtol=F32_TOL,
                                   atol=F32_TOL, err_msg=str(path))
    assert int(ts["step"]) == int(js["step"]) == TRAIN_STEPS


def test_train_step_bf16_params_keep_f32_master():
    cfg = REDUCED   # bfloat16
    model = LMModel(cfg, device="cpu")
    params, _ = model.init(np.random.default_rng(0))
    ocfg = topt.AdamWConfig(**DRIVER_OPT)
    state = topt.adamw_init(params, ocfg)
    batch = pipeline_batches([0], vocab=cfg.vocab, batch=2, seq=16)[0]
    new, state, met = make_train_step(model, ocfg)(params, state, batch)
    for (path, p), (_, q), (_, ma) in zip(
            tree_flatten_with_path(params), tree_flatten_with_path(new),
            tree_flatten_with_path(state["master"])):
        assert q.dtype == p.dtype and ma.dtype == torch.float32, path
        assert torch.equal(q, ma.to(p.dtype)), path
    assert np.isfinite(float(met["loss"]))


def test_compress_pods_without_pod_axis():
    """Off a mesh with a 'pod' axis, ``compress_pods=True`` is the plain
    step, as JAX's is: the same parameters and state, bit for bit."""
    cfg = dataclasses.replace(REDUCED, dtype="float32")
    model = LMModel(cfg, device="cpu")
    ocfg = topt.AdamWConfig(warmup_steps=2)
    batch = pipeline_batches([0], vocab=cfg.vocab, batch=2, seq=16)[0]
    outs = []
    for compress in (False, True):
        params, _ = seeded_params(cfg, 0, "cpu")
        step = make_train_step(model, ocfg, compress_pods=compress)
        outs.append(step(params, topt.adamw_init(params, ocfg), batch))
    (p0, s0, m0), (p1, s1, m1) = outs
    assert all(torch.equal(a, b) for (_, a), (_, b) in
               zip(tree_flatten_with_path(p0), tree_flatten_with_path(p1)))
    assert all(torch.equal(a, b) for (_, a), (_, b) in
               zip(tree_flatten_with_path(s0), tree_flatten_with_path(s1)))
    assert all(torch.equal(m0[k], m1[k]) for k in m0)


# -- the token pipeline -------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3, 2**20 + 7])
def test_pipeline_batches_bit_for_bit(seed):
    kw = dict(vocab=512, batch=4, seq=32)
    steps = [0, 1, 7, 1000]
    got = pipeline_batches(steps, seed=seed, **kw)
    pipe = JaxPipeline(seed=seed, **kw)
    for g, s in zip(got, steps):
        want = pipe.batch_at(s)
        assert g.keys() == want.keys()
        for k in want:
            assert g[k].dtype == want[k].dtype
            assert np.array_equal(g[k], want[k]), (s, k)
    emb_kw = dict(vocab=100, batch=2, seq=8, input_kind="embeddings",
                  d_model=16)
    got = pipeline_batches(steps, seed=seed, **emb_kw)
    pipe = JaxPipeline(seed=seed, **emb_kw)
    for g, s in zip(got, steps):
        want = pipe.batch_at(s)
        for k in ("embeds", "labels"):
            assert g[k].dtype == want[k].dtype
            assert np.array_equal(g[k], want[k]), (s, k)
    it = iter(TokenPipeline(seed=seed, device="cpu", **kw))
    assert np.array_equal(next(it)["tokens"], pipe_tokens(seed, kw, 0))
    assert np.array_equal(next(it)["tokens"], pipe_tokens(seed, kw, 1))


def test_pipeline_steps_overlap_as_jax():
    """ROADMAP §C, C8: the reference keys a step's stream by Philox's
    counter, which advances one block every four 64-bit draws, so step
    s + 1 draws step s's zipf samples a few draws on: consecutive batches
    share all but a few tokens. The port keeps the reference's batches,
    this overlap included."""
    kw = dict(vocab=8192, batch=2, seq=64)
    for pipe in (TokenPipeline(seed=0, device="cpu", **kw),
                 JaxPipeline(seed=0, **kw)):
        for s in (0, 1, 10):
            a = pipe.batch_at(s)["tokens"].ravel()
            b = pipe.batch_at(s + 1)["tokens"].ravel()
            shifts = [k for k in range(1, 9)
                      if np.array_equal(a[k:], b[:a.size - k])]
            assert len(shifts) == 1, (s, shifts)


def pipe_tokens(seed, kw, step):
    return JaxPipeline(seed=seed, **kw).batch_at(step)["tokens"]


def test_pipeline_dedup_matches_jax():
    """Planted duplicate rows go through ``_dedup`` in both packages: the
    same rows are replaced, by the same reserve draws; the batch keeps its
    shape and no planted copy survives."""
    kw = dict(vocab=512, batch=16, seq=64)
    tokens = TokenPipeline(seed=1, device="cpu", **kw).batch_at(5)["tokens"]
    planted = tokens.copy()
    copies = [3, 7, 8, 15]
    planted[copies] = planted[[0, 1, 1, 2]]
    got = TokenPipeline(seed=1, dedup=True, device="cpu", **kw)._dedup(
        planted, 5)
    want = JaxPipeline(seed=1, dedup=True, **kw)._dedup(planted, 5)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert got.shape == planted.shape
    for c in copies:
        assert not np.array_equal(got[c], planted[c])
    # and through batch_at, whose batches are drawn with the dedup on
    for s in (0, 9):
        g = TokenPipeline(seed=1, dedup=True, device="cpu", **kw).batch_at(s)
        w = JaxPipeline(seed=1, dedup=True, **kw).batch_at(s)
        assert all(np.array_equal(g[k], w[k]) for k in w)


# -- checkpoints ---------------------------------------------------------

def ckpt_tree():
    rng = np.random.default_rng(5)
    return {
        "params": {"w": torch.from_numpy(rng.normal(size=(4, 3)).astype(
                       np.float32)),
                   "h": torch.from_numpy(rng.normal(size=(5,)).astype(
                       np.float32)).to(torch.bfloat16),
                   "blocks": {"b": torch.from_numpy(rng.normal(
                       size=(2, 3, 2)).astype(np.float32)).to(
                       torch.bfloat16)}},
        "opt": {"step": torch.tensor(7, dtype=torch.int32),
                "ids": torch.arange(6, dtype=torch.int32).reshape(2, 3)},
    }


def same_tree(a, b):
    la, lb = tree_flatten_with_path(a), tree_flatten_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape, path
        assert torch.equal(x, y), path


def test_checkpoint_round_trip(tmp_path):
    t = ckpt_tree()
    final = save_checkpoint(str(tmp_path), 3, t, extra={"note": "x"})
    assert os.path.basename(final) == "step_00000003"
    assert latest_step(str(tmp_path)) == 3
    with open(os.path.join(final, "manifest.json")) as f:
        man = json.load(f)
    assert man["complete"] and man["extra"] == {"note": "x"}
    assert [e["name"] for e in man["leaves"]] == [
        "opt/ids", "opt/step", "params/blocks/b", "params/h", "params/w"]
    assert [e["dtype"] for e in man["leaves"]] == [
        "int32", "int32", "bfloat16", "bfloat16", "float32"]
    assert sorted(os.listdir(final)) == ["leaf_00000.npy", "leaf_00001.npy",
                                         "leaf_00002.npy", "leaf_00003.npy",
                                         "leaf_00004.npy", "manifest.json"]
    same_tree(restore_checkpoint(str(tmp_path), 3, t), t)
    # restore casts to the like tree's dtype, as JAX's does
    like = {"params": {**t["params"], "w": t["params"]["w"].double()},
            "opt": t["opt"]}
    got = restore_checkpoint(str(tmp_path), 3, like)
    assert got["params"]["w"].dtype == torch.float64
    assert torch.equal(got["params"]["w"].float(), t["params"]["w"])
    # onto a mesh: both the mesh and the specs, or neither
    with pytest.raises(ValueError, match="both mesh and specs"):
        restore_checkpoint(str(tmp_path), 3, t, mesh=object())


def test_incomplete_checkpoint_ignored(tmp_path):
    t = ckpt_tree()
    save_checkpoint(str(tmp_path), 1, t)
    os.makedirs(tmp_path / "step_00000002.tmp")        # a crashed save
    os.makedirs(tmp_path / "step_00000003")             # no manifest
    save_checkpoint(str(tmp_path), 4, t)
    with open(tmp_path / "step_00000004" / "manifest.json") as f:
        man = json.load(f)
    man["complete"] = False
    with open(tmp_path / "step_00000004" / "manifest.json", "w") as f:
        json.dump(man, f)
    with open(tmp_path / "step_00000005", "w"):
        pass
    assert latest_step(str(tmp_path)) == jckpt.latest_step(str(tmp_path)) == 1
    assert latest_step(str(tmp_path / "absent")) is None


def test_retention_and_async_errors(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last_k=2)
    t = ckpt_tree()
    for s in (1, 2, 3, 4):
        mgr.save_async(s, t)
    mgr.wait()
    assert sorted(os.listdir(tmp_path)) == ["step_00000003", "step_00000004"]
    same_tree(restore_checkpoint(str(tmp_path), 4, t), t)
    # the snapshot is taken when save_async returns
    mine = ckpt_tree()
    mgr.save_async(5, mine)
    mine["params"]["w"].add_(1.0)
    mgr.wait()
    same_tree(restore_checkpoint(str(tmp_path), 5, t), t)
    # a save that cannot write raises on wait(), once
    blocker = tmp_path / "blocker"
    blocker.write_text("not a directory")
    bad = CheckpointManager(str(blocker / "ckpt"))
    bad.save_async(1, t)
    with pytest.raises(OSError):
        bad.wait()
    bad.wait()


def test_checkpoints_cross_restore(tmp_path):
    """A checkpoint JAX writes (bf16 stored by np.save as V2) restores in
    the port, and one the port writes restores in JAX, bit for bit."""
    t = ckpt_tree()
    jt = jax.tree.map(jnp.asarray, params_to_numpy(t, bfloat16=jnp.bfloat16))
    jckpt.save_checkpoint(str(tmp_path / "jax"), 2, jt)
    assert latest_step(str(tmp_path / "jax")) == 2
    same_tree(restore_checkpoint(str(tmp_path / "jax"), 2, t), t)
    save_checkpoint(str(tmp_path / "port"), 2, t)
    got = jckpt.restore_checkpoint(str(tmp_path / "port"), 2, jt)
    for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                                 jax.tree_util.tree_flatten_with_path(jt)[0]):
        assert a.dtype == b.dtype, path
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes(), path
    # the two packages write the same manifests and the same words (bf16
    # as 2-byte voids: '<V2' from ml_dtypes, '|V2' from the port)
    mans = {}
    for d in ("jax", "port"):
        with open(tmp_path / d / "step_00000002" / "manifest.json") as f:
            mans[d] = [(e["name"], e["file"], e["dtype"], e["shape"])
                       for e in json.load(f)["leaves"]]
    assert mans["jax"] == mans["port"]
    for _, fn, dtype, _ in mans["port"]:
        a, b = (np.load(tmp_path / d / "step_00000002" / fn)
                for d in ("jax", "port"))
        assert a.dtype.itemsize == b.dtype.itemsize and a.shape == b.shape
        assert a.tobytes() == b.tobytes(), fn
        assert (a.dtype.kind == "V") == (dtype == "bfloat16")


# -- the straggler monitor -----------------------------------------------

def test_straggler_monitor_matches_jax():
    rng = np.random.default_rng(0)
    times = np.concatenate([[10.0, 9.0], rng.uniform(0.9, 1.1, 20),
                            [5.0, 5.0, 1.0, 4.0, 4.0, 4.0],
                            rng.uniform(0.9, 1.1, 10)])
    for kw in ({}, {"threshold": 1.5, "patience": 2, "warmup_steps": 1,
                    "alpha": 0.3}):
        mon, jmon = StragglerMonitor(**kw), JaxMonitor(**kw)
        for t in times:
            assert mon.record(t) == jmon.record(t)
            assert mon.should_rebalance() == jmon.should_rebalance()
            if mon.should_rebalance():
                mon.reset()
                jmon.reset()
            assert dataclasses.asdict(mon) == dataclasses.asdict(jmon)
        assert mon.slow_steps > 0


def test_heartbeats_match_jax(tmp_path):
    mon, jmon = StragglerMonitor(dead_after=60.0), JaxMonitor(dead_after=60.0)
    StragglerMonitor.heartbeat(str(tmp_path), 0, step=5)
    JaxMonitor.heartbeat(str(tmp_path), 1, step=5)
    with open(tmp_path / "host_0.json") as f:
        assert json.load(f)["step"] == 5
    now = time.time()
    for t in (now, now + 120):
        assert mon.dead_hosts(str(tmp_path), now=t) == \
            jmon.dead_hosts(str(tmp_path), now=t)
    assert mon.dead_hosts(str(tmp_path), now=now + 120) == [0, 1]
    assert mon.dead_hosts(str(tmp_path / "absent")) == []
