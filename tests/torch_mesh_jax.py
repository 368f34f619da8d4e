"""JAX's side of the meshed-training and meshed-inference tests, run in a
subprocess on four placeholder CPU devices (the caller sets
``XLA_FLAGS=--xla_force_host_platform_device_count=4``):

    python tests/torch_mesh_jax.py IN.pkl OUT.pkl

IN holds ``{name: (function name, kwargs)}``; OUT gets ``{name: result}``.
The weights are the port's ``seeded_params`` (numpy draws), so both
packages start from the same values.
"""
import dataclasses
import math
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from repro.models.config import ModelConfig as JaxConfig
from repro.models.lm import LMModel as JaxLM
from repro.train import compression as jcomp
from repro.train.optimizer import AdamWConfig, adamw_init, opt_state_specs
from repro.train.steps import make_train_step
from repro_torch.models.convert import params_to_numpy, seeded_params
from torch_train_mesh_ranks import (INFER_MAX_LEN, INFER_SHAPE, INFER_STEPS,
                                    batches, config, prompt_tokens)

IS_SPEC = lambda x: isinstance(x, P)   # noqa: E731


def mesh_of(shape, axes):
    devs = np.asarray(jax.devices()[:math.prod(shape)]).reshape(shape)
    return Mesh(devs, tuple(axes))


def weights(cfg, seed=0):
    return jax.tree.map(jnp.asarray, params_to_numpy(
        seeded_params(cfg, seed, "cpu")[0], bfloat16=jnp.bfloat16))


def named(mesh, specs):
    return jax.tree.map(lambda sp: NamedSharding(mesh, sp), specs,
                        is_leaf=IS_SPEC)


def flat(tree) -> dict:
    paths, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", k)) for k in path):
            np.asarray(v, np.float32) for path, v in paths}


def train(fam, dtype, shape, axes, steps=3, batch=(4, 32), compress=False,
          lr=3e-4, warmup=2, seed=1):
    """JAX's jitted meshed ``make_train_step``, as ``launch/train.py``
    places it; ``grad_error`` read by pod from its device buffers."""
    cfg = config(fam, dtype)
    return _train(cfg, shape, axes, compress, batches(cfg, steps, batch, seed),
                  AdamWConfig(lr=lr, warmup_steps=warmup))


def _train(cfg, shape, axes, compress, todo, ocfg):
    mesh = mesh_of(shape, axes)
    model = JaxLM(JaxConfig(**dataclasses.asdict(cfg)), mesh)
    params = weights(cfg)
    _, specs = model.abstract_params()
    state = adamw_init(params, ocfg)
    ospecs = opt_state_specs(specs, ocfg, params)
    if compress:
        state["grad_error"] = jcomp.init_error_state(params)
        ospecs = dict(ospecs, grad_error=specs)
    params = jax.device_put(params, named(mesh, specs))
    state = jax.device_put(state, named(mesh, ospecs))
    step = jax.jit(make_train_step(model, ocfg, compress_pods=compress,
                                   param_specs=specs),
                   in_shardings=(named(mesh, specs), named(mesh, ospecs),
                                 None),
                   out_shardings=(named(mesh, specs), named(mesh, ospecs),
                                  None))
    out = {"loss": [], "grad_norm": [], "dropped_frac": []}
    stats = []
    with mesh:
        for b in todo:
            params, state, met = step(params, state,
                                      jax.tree.map(jnp.asarray, b))
            for k in out:
                out[k].append(float(met[k]))
            if compress:
                stats.append(residual_stats(
                    pod_residuals(state, mesh, shape[0])[0]))
    out["master"] = flat(state["master"])
    if compress:
        out["grad_error_pods"] = pod_residuals(state, mesh, shape[0])
        out["grad_error_logical"] = flat(state["grad_error"])
        out["grad_error_norm"] = [n for n, _ in stats]
        out["grad_error_sum"] = [t for _, t in stats]
    return out


def pod_residuals(state, mesh, n_pods) -> dict:
    """Each pod's ``grad_error``, put together from its devices' buffers."""
    pods = {}
    for name, arr in flat_arrays(state["grad_error"]).items():
        for pod in range(n_pods):
            whole = np.zeros(arr.shape, np.float32)
            for s in arr.addressable_shards:
                if pod_of(mesh, s.device) == pod:
                    whole[s.index] = np.asarray(s.data)
            pods.setdefault(pod, {})[name] = whole
    return pods


def residual_stats(tree: dict) -> tuple:
    """(norm, sum) of every element of a residual tree, in float64."""
    leaves = [np.asarray(v, np.float64).ravel() for v in tree.values()]
    return (float(np.sqrt(sum((v * v).sum() for v in leaves))),
            float(sum(v.sum() for v in leaves)))


def pod_pin(steps=3):
    """JAX's compressed step at smoke-lm's full CONFIG, float32, on a
    (pod 2, data 1, model 2) mesh over the chip smoke's LM_TRAIN_PIN
    batches, from its weights and optimizer settings: the source of
    ``chip_smoke.LM_TRAIN_POD_PIN`` (pod 0's residual's norm and sum after
    each step among it)."""
    import os
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as cs
    from repro_torch.configs.smoke_lm import CONFIG

    cfg = dataclasses.replace(CONFIG, dtype="float32")
    out = _train(cfg, (2, 1, 2), ("pod", "data", "model"), True,
                 [cs.pin_batch(i) for i in range(steps)],
                 AdamWConfig(**cs.LM_TRAIN_OPT))
    return {k: out[k] for k in ("loss", "grad_norm", "grad_error_norm",
                                "grad_error_sum")}


def flat_arrays(tree) -> dict:
    paths, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", k)) for k in path): v
            for path, v in paths}


def pod_of(mesh, device) -> int:
    where = np.argwhere(mesh.devices == device)
    return int(where[0][0])


def grads(fam, dtype, shape, axes, batch=(4, 32), seed=1):
    """The loss and gradient of one batch under ``jax.jit`` on a mesh."""
    cfg = config(fam, dtype)
    mesh = mesh_of(shape, axes)
    model = JaxLM(JaxConfig(**dataclasses.asdict(cfg)), mesh)
    _, specs = model.abstract_params()
    params = jax.device_put(weights(cfg), named(mesh, specs))
    b = jax.tree.map(jnp.asarray, batches(cfg, 1, batch, seed)[0])
    with mesh:
        (loss, _), g = jax.jit(jax.value_and_grad(
            model.train_loss, has_aux=True))(params, b)
    return {"loss": float(loss), "grads": flat(g)}


def psum(g, e, n_pods=2):
    """``compressed_psum_mean`` under JAX's ``shard_map`` over a ('pod',)
    mesh: device r holds ``g[r]`` and ``e[r]``."""
    from repro.compat import shard_map
    mesh = mesh_of((n_pods,), ("pod",))
    stack = lambda trees: {k: jnp.stack([jnp.asarray(t[k]) for t in trees])
                           for k in trees[0]}

    def body(g, e):
        g = jax.tree.map(lambda a: a[0], g)
        e = jax.tree.map(lambda a: a[0], e)
        m, ne = jcomp.compressed_psum_mean(g, e, "pod", n_pods)
        return (jax.tree.map(lambda a: a[None], m),
                jax.tree.map(lambda a: a[None], ne))

    spec = {k: P("pod") for k in g[0]}
    m, ne = jax.jit(shard_map(body, mesh=mesh, in_specs=(spec, spec),
                              out_specs=(spec, spec)))(stack(g), stack(e))
    return ({k: np.asarray(v) for k, v in m.items()},
            {k: np.asarray(v) for k, v in ne.items()})


def restore(directory, step):
    """JAX's ``restore_checkpoint`` of a port checkpoint, unsharded."""
    from repro.ckpt import restore_checkpoint
    import json
    import os
    with open(os.path.join(directory, f"step_{step:08d}",
                           "manifest.json")) as f:
        leaves = json.load(f)["leaves"]
    like = {}
    for e in leaves:
        node = like
        *head, last = e["name"].split("/")
        for k in head:
            node = node.setdefault(k, {})
        dt = jnp.bfloat16 if e["dtype"] == "bfloat16" else jnp.dtype(e["dtype"])
        node[last] = jax.ShapeDtypeStruct(tuple(e["shape"]), dt)
    got = restore_checkpoint(directory, step, like)
    return flat(got)


def mesh_shapes(worlds=(1, 2, 4, 8)):
    """JAX's smoke mesh at each device count (of the four), and what the
    production meshes raise on four devices."""
    from repro.launch import mesh as jmesh
    out = {}
    for n in worlds:
        m = jmesh.make_smoke_mesh(n)
        out[n] = (tuple(m.axis_names), dict(m.shape))
    for name, fn in (("single", lambda: jmesh.make_production_mesh()),
                     ("multi", lambda: jmesh.make_production_mesh(
                         multi_pod=True))):
        try:
            fn()
            out[name] = None
        except Exception as err:        # noqa: BLE001 -- recorded
            out[name] = type(err).__name__
    return out


def infer(fam, dtype, shape, axes, batch=INFER_SHAPE, steps=INFER_STEPS,
          max_len=INFER_MAX_LEN, seed=2):
    """JAX's jitted meshed ``prefill``, ``decode_step`` (teacher-forced,
    ``steps`` times) and ``encode``, laid out as JAX's dry run lays out
    its prefill and decode cells (``lower_lm_cell``: the layout of
    (batch, max_len), the parameters, the batch and the caches placed by
    their specs, the caches' out_shardings theirs): the logits as
    float32, the layout, and each cache leaf's shards after the prefill
    by device coordinates, as (index as (start, stop) pairs, float32
    values)."""
    from repro.models.lm import choose_layout

    cfg = config(fam, dtype)
    mesh = mesh_of(shape, axes)
    model = JaxLM(JaxConfig(**dataclasses.asdict(cfg)), mesh)
    _, specs = model.abstract_params()
    B, S = batch
    layout = choose_layout(model.cfg, mesh, B, max_len)
    b = layout.batch_axes
    cspecs = model.cache_specs(layout)
    toks = prompt_tokens(cfg, batch, steps, seed)
    ns = lambda sp: NamedSharding(mesh, sp)   # noqa: E731
    with mesh:
        params = jax.device_put(weights(cfg), named(mesh, specs))
        caches = jax.device_put(model.init_caches(B, max_len),
                                named(mesh, cspecs))
        prefill = jax.jit(lambda p, t, c: model.prefill(p, t, c, layout),
                          in_shardings=(named(mesh, specs),
                                        {"tokens": ns(P(b, None))},
                                        named(mesh, cspecs)),
                          out_shardings=(None, named(mesh, cspecs)))
        decode = jax.jit(lambda p, t, c: model.decode_step(p, t, c, layout),
                         in_shardings=(named(mesh, specs), ns(P(b)),
                                       named(mesh, cspecs)),
                         out_shardings=(None, named(mesh, cspecs)))
        encode = jax.jit(lambda p, t: model.encode(p, t, layout),
                         in_shardings=(named(mesh, specs),
                                       {"tokens": ns(P(b, None))}))
        logits, caches = prefill(params, {"tokens": jnp.asarray(toks[:, :S])},
                                 caches)
        out = {"prefill": np.asarray(logits, np.float32),
               "layout": (layout.batch_axes, layout.head_tp,
                          layout.cache_seq),
               "shards": cache_shards(caches, mesh), "decode": []}
        for t in range(steps):
            logits, caches = decode(params, jnp.asarray(toks[:, S + t]),
                                    caches)
            out["decode"].append(np.asarray(logits, np.float32))
        out["encode"] = np.asarray(
            encode(params, {"tokens": jnp.asarray(toks[:, :S])}), np.float32)
    return out


def cache_shards(caches, mesh) -> dict:
    """{leaf path: {device coordinates: (index, float32 values)}} of
    every cache leaf of more than one dimension, copied: a CPU buffer that
    a later step reuses would change under a view."""
    out = {}
    for name, arr in flat_arrays(caches).items():
        if arr.ndim < 2:
            continue                 # the lengths
        by = {}
        for s in arr.addressable_shards:
            coords = tuple(int(c) for c in
                           np.argwhere(mesh.devices == s.device)[0])
            by[coords] = ([(i.start or 0, arr.shape[d] if i.stop is None
                            else i.stop) for d, i in enumerate(s.index)],
                          np.array(s.data, np.float32, copy=True))
        out[name] = by
    return out


def shard_shapes(fam, dtype, shape, axes) -> dict:
    """Each parameter's shard shape on the mesh, by its specs
    ({"a/b/c": shape})."""
    cfg = config(fam, dtype)
    mesh = mesh_of(shape, axes)
    model = JaxLM(JaxConfig(**dataclasses.asdict(cfg)), mesh)
    shapes, specs = model.abstract_params()
    sh = jax.tree.map(lambda a, sp: NamedSharding(mesh, sp).shard_shape(
        a.shape), shapes, specs, is_leaf=IS_SPEC)
    paths, _ = jax.tree_util.tree_flatten_with_path(
        sh, is_leaf=lambda x: isinstance(x, tuple))
    return {"/".join(str(getattr(k, "key", k)) for k in path): tuple(v)
            for path, v in paths}


def main():
    with open(sys.argv[1], "rb") as f:
        cases = pickle.load(f)
    out = {name: globals()[fn](**kw) for name, (fn, kw) in cases.items()}
    with open(sys.argv[2], "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main()
