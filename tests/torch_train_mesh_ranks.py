"""Rank workers of the meshed-training tests (``test_torch_mesh_lm.py``,
``test_torch_train_mesh.py``, ``test_torch_compression.py``).

``repro_torch.launch.mesh.spawn`` starts each rank in a new process, which
imports its function by name; these live here, on the tests' path, for
that reason. ``run_cases`` runs a dict of named cases on the CPU ranks of
one spawn (gloo), in order; each case builds the meshes it needs over the
world's first ranks, and a rank outside a case's mesh returns None for it.
Results are numpy arrays, lists and dicts, or ``("error", type, text)``.
"""
import collections
import dataclasses
import os

import numpy as np
import torch

from repro_torch.configs.smoke_lm import FAMILY_SMOKES, REDUCED
from repro_torch.launch import mesh as tmesh

CPU = "cpu"
CONFIGS = {"dense": REDUCED, **FAMILY_SMOKES}


def config(fam: str, dtype: str):
    return dataclasses.replace(CONFIGS[fam], dtype=dtype)


def batches(cfg, n: int, shape, seed: int = 1) -> list:
    """``n`` next-token batches of ``shape`` (the last label masked)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        tokens = rng.integers(0, cfg.vocab, shape).astype(np.int32)
        labels = np.roll(tokens, -1, axis=1)
        labels[:, -1] = -1
        out.append({"tokens": tokens, "labels": labels.astype(np.int32)})
    return out


def to_numpy(tree):
    from repro_torch.models.convert import params_to_numpy
    return params_to_numpy(tree)


def mesh_shapes() -> dict:
    """What each constructor gives on this world, or the error it raises."""
    out = {}
    _, world = tmesh.init_world(CPU)
    calls = {"smoke_world": lambda: tmesh.make_smoke_mesh(world, device=CPU),
             "smoke_2": lambda: tmesh.make_smoke_mesh(2, device=CPU),
             "smoke_8": lambda: tmesh.make_smoke_mesh(8, device=CPU),
             "compat": lambda: tmesh.make_mesh_compat((world,), ("data",),
                                                      device=CPU),
             "single": lambda: tmesh.make_production_mesh(device=CPU),
             "multi": lambda: tmesh.make_production_mesh(multi_pod=True,
                                                         device=CPU),
             "selfjoin": lambda: tmesh.make_selfjoin_mesh(device=CPU)}
    for name, fn in calls.items():
        try:
            m = fn()
            out[name] = (None if m is None else
                         (tuple(m.axis_names), dict(m.shape), m.coords))
        except ValueError as err:
            out[name] = ("error", "ValueError", str(err))
    return out


def train(fam, dtype, shape, axes, steps=3, batch=(4, 32), compress=False,
          lr=3e-4, warmup=2, seed=1, save_dir=None):
    """``steps`` train steps of ``make_train_step`` on a mesh from
    ``seeded_params(cfg, 0)``: each step's loss, grad norm and
    dropped_frac, the gathered master weights (rank 0), the mesh's
    collective calls and this rank's coordinates. With ``compress``, this
    rank's pod's whole ``grad_error`` and the last step's quantization
    scales (leaf by leaf, recorded from ``compression.quantize``); with
    ``save_dir``, a checkpoint of the params and state at the end."""
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.models.convert import params_from_mesh, seeded_params
    from repro_torch.models.lm import LMModel
    from repro_torch.train import compression
    from repro_torch.train.compression import init_error_state
    from repro_torch.train.optimizer import (AdamWConfig, adamw_init,
                                             opt_state_specs)
    from repro_torch.train.steps import make_train_step

    scales = []
    quantize = compression.quantize

    def recording(x, scale):
        scales.append(float(scale))
        return quantize(x, scale)

    compression.quantize = recording

    cfg = config(fam, dtype)
    mesh = tmesh.make_mesh_compat(shape, axes, device=CPU) if shape else None
    if shape and mesh is None:
        return None
    model = LMModel(cfg, mesh, device=CPU)
    params, specs = seeded_params(cfg, 0, CPU, mesh=mesh)
    ocfg = AdamWConfig(lr=lr, warmup_steps=warmup)
    state = adamw_init(params, ocfg)
    if compress:
        state["grad_error"] = init_error_state(params)
    step = make_train_step(model, ocfg, compress_pods=compress,
                           param_specs=specs)
    out = {"loss": [], "grad_norm": [], "dropped_frac": []}
    try:
        for b in batches(cfg, steps, batch, seed):
            scales.clear()
            params, state, met = step(params, state, b)
            for k in out:
                out[k].append(float(met[k]))
    finally:
        compression.quantize = quantize
    if save_dir is not None:
        ospecs = opt_state_specs(specs, ocfg, params)
        if compress:
            ospecs = dict(ospecs, grad_error=specs)
        mgr = CheckpointManager(save_dir, mesh=mesh)
        mgr.save_async(steps, {"params": params, "opt": state},
                       specs={"params": specs, "opt": ospecs})
        mgr.wait()
    if mesh is None:
        out["master"] = to_numpy(state["master"])
        return out
    master = params_from_mesh(state["master"], specs, mesh)
    out["master"] = master if mesh.rank == 0 else None
    if compress:
        out["grad_error"] = to_numpy(mesh.gather_tree(state["grad_error"],
                                                      specs))
        out["scales"] = list(scales)
    out["coords"] = mesh.coords
    out["calls"] = {k: v[0] for k, v in mesh.stats.items()}
    return out


def grads(fam, dtype, shape, axes, batch=(4, 32), seed=1):
    """The loss and the gradient of one batch on a mesh, gathered."""
    from repro_torch.models.convert import seeded_params
    from repro_torch.models.layers import (mesh_context,
                                           tree_flatten_with_path, tree_map)
    from repro_torch.models.lm import LMModel

    cfg = config(fam, dtype)
    mesh = tmesh.make_mesh_compat(shape, axes, device=CPU) if shape else None
    if shape and mesh is None:
        return None
    model = LMModel(cfg, mesh, device=CPU)
    params, specs = seeded_params(cfg, 0, CPU, mesh=mesh)
    b = batches(cfg, 1, batch, seed)[0]
    live = tree_map(lambda t: t.detach().requires_grad_(), params)
    with mesh_context(mesh, model.default_layout(b).batch_axes):
        loss, _ = model.train_loss(live, b)
        paths, leaves = zip(*tree_flatten_with_path(live))
        gs = torch.autograd.grad(loss, leaves)
    whole = (mesh.gather_many(gs, [_at(specs, p) for p in paths]) if mesh
             else gs)
    return {"loss": float(loss.detach()),
            "grads": {"/".join(map(str, p)): g.float().numpy()
                      for p, g in zip(paths, whole)}}


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def psum(g, e, n_pods=2):
    """``compressed_psum_mean`` over a ('pod',) mesh of the first
    ``n_pods`` ranks, rank r holding ``g[r]`` and ``e[r]`` (trees of
    numpy)."""
    from repro_torch.train.compression import compressed_psum_mean

    mesh = tmesh.make_mesh_compat((n_pods,), ("pod",), device=CPU)
    if mesh is None:
        return None
    t = lambda tree: {k: torch.as_tensor(v) for k, v in tree.items()}
    mean, new_e = compressed_psum_mean(t(g[mesh.rank]), t(e[mesh.rank]),
                                       "pod", n_pods, mesh=mesh)
    return ({k: v.numpy() for k, v in mean.items()},
            {k: v.numpy() for k, v in new_e.items()})


def save(directory, fam, dtype, shape, axes, step=2):
    """A checkpoint of seeded parameters and their AdamW state written
    from a mesh (every rank gathers, rank 0 writes); returns the whole
    tree as numpy on rank 0."""
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.models.convert import seeded_params
    from repro_torch.train.optimizer import (AdamWConfig, adamw_init,
                                             opt_state_specs)

    cfg = config(fam, dtype)
    mesh = tmesh.make_mesh_compat(shape, axes, device=CPU)
    if mesh is None:
        return None
    params, specs = seeded_params(cfg, 0, CPU, mesh=mesh)
    ocfg = AdamWConfig()
    state = adamw_init(params, ocfg)
    tree = {"params": params, "opt": state}
    tspecs = {"params": specs, "opt": opt_state_specs(specs, ocfg, params)}
    mgr = CheckpointManager(directory, mesh=mesh)
    mgr.save_async(step, tree, specs=tspecs)
    mgr.wait()
    whole = mesh.gather_tree(tree, tspecs)
    return {"files": sorted(os.listdir(directory)),
            "tree": to_numpy(whole) if mesh.rank == 0 else None}


def restore(directory, step, shape, axes, spec):
    """``restore_checkpoint`` of a one-leaf tree {"w": (8, 4) float32}
    onto a mesh with ``spec``: this rank's block."""
    from repro_torch.ckpt import restore_checkpoint

    mesh = tmesh.make_mesh_compat(shape, axes, device=CPU)
    if mesh is None:
        return None
    like = {"w": torch.zeros(mesh.block(spec, (8, 4))[0].stop
                             - mesh.block(spec, (8, 4))[0].start, 4)}
    got = restore_checkpoint(directory, step, like, mesh=mesh,
                             specs={"w": spec})
    return {"block": got["w"].numpy(), "coords": mesh.coords,
            "slices": [(s.start, s.stop) for s in mesh.block(spec, (8, 4))]}


def driver(argv):
    """``launch.train.run(argv)`` on this rank: its report's fields."""
    from repro_torch.launch import train as ttrain
    rep = ttrain.run(list(argv))
    return dataclasses.asdict(rep)


def pod_pin():
    """The chip smoke's pod check on this spawn's four CPU ranks:
    ``chip_smoke.mesh_f32_steps`` of the full CONFIG on (2, 1, 2) with
    the compressed step (LM_TRAIN_POD_PIN's run)."""
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as cs

    return cs.mesh_f32_steps("cpu", *cs.POD_MESH, compress=True)


INFER_SHAPE = (4, 16)     # (batch, prompt) of the meshed inference cases
INFER_STEPS = 4
INFER_MAX_LEN = 24        # divides 'model' 2 and ('data', 'model') 4


def prompt_tokens(cfg, batch=INFER_SHAPE, steps=INFER_STEPS, seed=2):
    """The prompt and the teacher-forced decode tokens, (B, S + steps)."""
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (batch[0], batch[1] + steps)).astype(np.int32)


def jax_name(tree, path) -> str:
    """A cache leaf's path as ``tests/torch_mesh_jax.py::flat`` names JAX's
    (".kv/.k", ".slstm/[0]")."""
    parts = []
    for k in path:
        parts.append(f".{tree._fields[k]}" if hasattr(tree, "_fields")
                     else f"[{k}]")
        tree = tree[k]
    return "/".join(parts)


def _cache_blocks(caches, block_of) -> dict:
    """{JAX's leaf name: (this rank's slices of the whole shape as
    (start, stop) pairs, a float32 copy of its values)} of every cache
    tensor but the lengths (the decode writes the caches in place);
    ``block_of(path, t)`` gives the slices."""
    from repro_torch.models.layers import tree_flatten_with_path
    return {jax_name(caches, path): (block_of(path, t),
                                     t.float().numpy().copy())
            for path, t in tree_flatten_with_path(caches) if t.ndim > 1}


# JAX's KV cache tuple: no max_len
JaxKV = collections.namedtuple("KVCache", "k v length")


def _carried(cfg, model, caches, layout, toks, S, max_len) -> dict:
    """Caches across the mesh (``convert``): the whole caches gathered
    from the ranks' blocks after the prefill (rank 0's, float32 numpy),
    and the first decode step's logits from this rank's block of the
    unmeshed model's prefilled caches, carried as JAX's tree (numpy,
    KV caches of (k, v, length))."""
    from repro_torch.models.convert import (caches_from_mesh,
                                            caches_to_mesh, params_to_numpy,
                                            seeded_params)
    from repro_torch.models.layers import tree_flatten_with_path
    from repro_torch.models.lm import LMModel

    whole = caches_from_mesh(caches, model, layout)
    plain = LMModel(cfg, device=CPU)
    pp, _ = seeded_params(cfg, 0, CPU)
    _, mine = plain.prefill(pp, {"tokens": toks[:, :S]},
                            plain.init_caches(toks.shape[0], max_len))
    mine = params_to_numpy(mine)
    as_jax = lambda kv: JaxKV(*kv[:3]) if kv else kv   # noqa: E731
    mine = mine._replace(kv=as_jax(mine.kv),
                         shared_kv=as_jax(mine.shared_kv))
    params, _ = seeded_params(cfg, 0, CPU, mesh=model.ranks)
    blocks = caches_to_mesh(mine, model, layout)
    logits, _ = model.decode_step(params, toks[:, S], blocks)
    return {"gathered": ({jax_name(whole, p): np.asarray(a, np.float32)
                          for p, a in tree_flatten_with_path(whole)
                          if np.ndim(a) > 1}
                         if model.ranks.rank == 0 else None),
            "carried": logits.float().numpy()}


def infer(fam, dtype, shape, axes, batch=INFER_SHAPE, steps=INFER_STEPS,
          max_len=INFER_MAX_LEN, seed=2):
    """Meshed inference from ``seeded_params(cfg, 0)``: the prefill's
    last-position logits, each decode step's logits (teacher-forced),
    the cache blocks after the prefill (``_cache_blocks``), ``encode``'s
    logits of the prompt, the mesh's collectives of the last decode step
    (kind -> [calls, bytes]) and of the prefill, the layout, and this
    rank's coordinates. ``shape`` None runs without a mesh."""
    from repro_torch.models.convert import seeded_params
    from repro_torch.models.lm import LMModel, choose_layout

    cfg = config(fam, dtype)
    mesh = tmesh.make_mesh_compat(shape, axes, device=CPU) if shape else None
    if shape and mesh is None:
        return None
    model = LMModel(cfg, mesh, device=CPU)
    params, _ = seeded_params(cfg, 0, CPU, mesh=mesh)
    toks = prompt_tokens(cfg, batch, steps, seed)
    S = batch[1]
    caches = model.init_caches(batch[0], max_len)
    f32 = lambda t: t.float().numpy()    # noqa: E731
    before = dict(mesh.stats) if mesh else {}
    logits, caches = model.prefill(params, {"tokens": toks[:, :S]}, caches)
    out = {"prefill": f32(logits), "decode": []}
    if mesh is not None:
        out["prefill_stats"] = mesh.calls_and_bytes(before)
        layout = choose_layout(cfg, mesh, batch[0], max_len)
        specs = model.cache_specs(layout)
        whole = LMModel(cfg, device="meta").init_caches(batch[0], max_len)
        out["blocks"] = _cache_blocks(caches, lambda path, t: [
            (s.start, s.stop) for s in mesh.block(
                _at(specs, path), _at(whole, path).shape)])
        out["layout"] = dataclasses.astuple(layout)
        out["coords"] = mesh.coords
    else:
        out["blocks"] = _cache_blocks(
            caches, lambda path, t: [(0, n) for n in t.shape])
    if mesh is not None:
        out.update(_carried(cfg, model, caches, layout, toks, S, max_len))
    for t in range(steps):
        before = dict(mesh.stats) if mesh else {}
        logits, caches = model.decode_step(params, toks[:, S + t], caches)
        out["decode"].append(f32(logits))
    if mesh is not None:
        out["decode_stats"] = {k: v for k, v in
                               mesh.calls_and_bytes(before).items() if v[0]}
        out["rank"] = mesh.rank
    out["encode"] = f32(model.encode(params, {"tokens": toks[:, :S]}))
    return out


def tp_views(shape, axes):
    """On a mesh: the compute views ``constrain_tree`` gives one
    ``encode`` of the reduced dense config ({path: shape}), and the
    matrix-product FLOPs that ``FlopCounterMode`` counts on this rank
    ({op: flops}); ``shape`` None runs without a mesh (FLOPs only)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.models import lm as lm_mod
    from repro_torch.models import transformer as tf_mod
    from repro_torch.models.convert import seeded_params
    from repro_torch.models.layers import tree_flatten_with_path
    from repro_torch.models.lm import LMModel

    cfg = config("dense", "float32")
    mesh = tmesh.make_mesh_compat(shape, axes, device=CPU) if shape else None
    if shape and mesh is None:
        return None
    model = LMModel(cfg, mesh, device=CPU)
    params, _ = seeded_params(cfg, 0, CPU, mesh=mesh)
    views, real = {}, tf_mod.constrain_tree

    def recording(tree, specs, keep=None, prefix=()):
        out = real(tree, specs, keep)
        for path, t in tree_flatten_with_path(out):
            views["/".join(map(str, prefix + path))] = tuple(t.shape)
        return out

    tf_mod.constrain_tree = lambda t, s, k=None: recording(t, s, k,
                                                         ("blocks",))
    lm_mod.constrain_tree = recording
    toks = prompt_tokens(cfg)[:, :INFER_SHAPE[1]]
    try:
        fc = FlopCounterMode(display=False)
        with fc:
            model.encode(params, {"tokens": toks})
    finally:
        tf_mod.constrain_tree = lm_mod.constrain_tree = real
    flops = {str(op): int(n) for op, n in fc.get_flop_counts()["Global"]
             .items()}
    return {"views": views, "flops": flops}


def inference_refused(shape, axes):
    """What meshed inference refuses, on every rank, each as (type name,
    message): a decode past the caches' ``max_len`` (ROADMAP C7, taken
    by every rank before any collective) and a prompt longer than it;
    and that the calls run otherwise (``ran``: the shapes of ``encode``'s
    and the prefill's logits, and of a decode's from a copy of caches
    that ``init_caches`` made, whose layout comes from their ``max_len``
    as from the originals')."""
    from repro_torch.models.convert import seeded_params
    from repro_torch.models.lm import LMModel

    cfg = config("dense", "float32")
    mesh = tmesh.make_mesh_compat(shape, axes, device=CPU)
    if mesh is None:
        return None
    model = LMModel(cfg, mesh, device=CPU)
    params, _ = seeded_params(cfg, 0, CPU, mesh=mesh)
    toks = torch.zeros((2, 8), dtype=torch.long)
    full = model.init_caches(2, 8)
    ran = {"encode": tuple(model.encode(params, {"tokens": toks}).shape)}
    logits, full = model.prefill(params, {"tokens": toks}, full)
    ran["prefill"] = tuple(logits.shape)
    short = model.init_caches(2, 4)
    fresh = model.init_caches(2, 8)
    copied = type(fresh)(kv=fresh.kv._replace(k=fresh.kv.k.clone(),
                                              v=fresh.kv.v.clone()))
    ran["decode"] = tuple(model.decode_step(params, toks[:, 0],
                                            copied)[0].shape)
    calls = {"decode_past_max_len": lambda: model.decode_step(
                 params, toks[:, 0], full),
             "prompt_past_max_len": lambda: model.prefill(
                 params, {"tokens": toks}, short)}
    out = {"ran": ran}
    for name, call in calls.items():
        try:
            call()
            out[name] = None
        except Exception as e:  # noqa: BLE001  (the test reads the type)
            out[name] = (type(e).__name__, str(e))
    return out


def blocks(shape, axes, specs):
    """Each spec's block of a (8, 4, 6) arange tensor on this rank, and
    the whole tensor gathered back from the blocks."""
    mesh = tmesh.make_mesh_compat(shape, axes, device=CPU)
    if mesh is None:
        return None
    whole = torch.arange(8 * 4 * 6, dtype=torch.float32).reshape(8, 4, 6)
    out = {"coords": mesh.coords}
    for spec in specs:
        mine = mesh.local(whole, spec)
        back = mesh.gather(mine, spec)
        out[spec] = {"block": mine.numpy(), "back": back.numpy(),
                     "owner": mesh.owner(spec)}
    return out


def moved(shape, axes, batch_axes):
    """``shard`` on a (4, 4, 3) activation: the batch axis moved from rows
    to dimension 1 (the expert all-to-all) and back, and the gradient
    through both moves."""
    from repro_torch.models.layers import mesh_context, shard

    mesh = tmesh.make_mesh_compat(shape, axes, device=CPU)
    if mesh is None:
        return None
    whole = torch.arange(4 * 4 * 3, dtype=torch.float32).reshape(4, 4, 3)
    x = mesh.local(whole, (batch_axes,)).requires_grad_()
    with mesh_context(mesh, batch_axes):
        same = shard(x, batch_axes, None, "model")
        there = shard(x, None, "data", None)
        back = shard(there, batch_axes, None, None, src=(None, "data", None))
        (g,) = torch.autograd.grad((there * there).sum(), x)
    return {"same_is_x": same is x, "there": there.detach().numpy(),
            "back": back.detach().numpy(), "x": x.detach().numpy(),
            "grad": g.numpy(), "coords": mesh.coords}


def step_stats(fam, dtype, shape, axes, batch=(4, 32), compress=False,
               seed=1):
    """One train step of ``make_train_step`` on a mesh, as
    ``dryrun.lower_lm_cell`` plans it (AdamWConfig(warmup_steps=2)): the
    difference of the mesh's ``stats`` across the step (kind -> [calls,
    bytes]) and this rank's argument bytes (its blocks of the parameters
    and the state, and its rows of the batch)."""
    from repro_torch.launch.dryrun import tree_bytes
    from repro_torch.models.convert import seeded_params
    from repro_torch.models.lm import LMModel
    from repro_torch.train.compression import init_error_state
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.steps import make_train_step

    cfg = config(fam, dtype)
    mesh = tmesh.make_mesh_compat(shape, axes, device=CPU)
    if mesh is None:
        return None
    model = LMModel(cfg, mesh, device=CPU)
    params, specs = seeded_params(cfg, 0, CPU, mesh=mesh)
    ocfg = AdamWConfig(warmup_steps=2)
    state = adamw_init(params, ocfg)
    if compress:
        state["grad_error"] = init_error_state(params)
    step = make_train_step(model, ocfg, compress_pods=compress,
                           param_specs=specs)
    b = batches(cfg, 1, batch, seed)[0]
    layout = model.default_layout(b)
    rows = sum(tree_bytes(model._rows(v, layout)) for v in b.values())
    before = dict(mesh.stats)
    step(params, state, b)
    return {"rank": mesh.rank, "stats": mesh.calls_and_bytes(before),
            "argument_bytes": tree_bytes(params) + tree_bytes(state) + rows}


def selfjoin_sends(n_slabs, n_model, eps, npts=400, dims=2, seed=0):
    """``distributed_self_join_count`` on a (slab, model) mesh with
    ``torch.distributed``'s all-reduce, all-gather and batched sends
    wrapped: the collectives this rank issued, in order, as (op, bytes,
    group size or peer), and the ``DistJoinConfig`` its count step ran
    with."""
    import torch.distributed as dist

    from repro_torch.core import distributed as slab_join

    mesh = tmesh.make_slab_mesh(n_slabs, n_model, device=CPU)
    pts = np.random.default_rng(seed).uniform(0, 100, (npts, dims))
    sent, cfgs = [], []
    real = {k: getattr(dist, k) for k in ("all_reduce", "all_gather",
                                          "batch_isend_irecv")}
    make_step = slab_join.make_distributed_count_step

    def all_reduce(t, *a, group=None, **kw):
        sent.append(("all-reduce", t.numel() * t.element_size(),
                     dist.get_world_size(group)))
        return real["all_reduce"](t, *a, group=group, **kw)

    def all_gather(outs, t, *a, group=None, **kw):
        sent.append(("all-gather", t.numel() * t.element_size() * len(outs),
                     dist.get_world_size(group)))
        return real["all_gather"](outs, t, *a, group=group, **kw)

    def batch_isend_irecv(ops):
        by_peer = {}
        for op in ops:
            if op.op is dist.isend:
                by_peer[op.peer] = by_peer.get(op.peer, 0) + (
                    op.tensor.numel() * op.tensor.element_size())
        sent.extend(("collective-permute", nb, peer)
                    for peer, nb in by_peer.items())
        return real["batch_isend_irecv"](ops)

    def recording_step(m, cfg):
        cfgs.append(dataclasses.asdict(cfg))
        return make_step(m, cfg)

    dist.all_reduce, dist.all_gather = all_reduce, all_gather
    dist.batch_isend_irecv = batch_isend_irecv
    slab_join.make_distributed_count_step = recording_step
    try:
        total = slab_join.distributed_self_join_count(
            pts, eps, mesh, model_axis="model" if n_model > 1 else None)
    finally:
        for k, fn in real.items():
            setattr(dist, k, fn)
        slab_join.make_distributed_count_step = make_step
    return {"rank": mesh.rank, "sent": sent, "cfg": cfgs[0],
            "total": int(total)}


def run_cases(rank, cases) -> dict:
    """Each case ``name -> (function name, kwargs)``, in order."""
    out = {}
    for name, (fn, kw) in cases.items():
        out[name] = globals()[fn](**kw)
    return out


# ---------------------------------------------------------------------------
# the two sides' subprocesses
# ---------------------------------------------------------------------------

def start(tmp, torch_cases: dict, jax_cases: dict, n_ranks: int = 4):
    """Start the torch ranks (``n_ranks`` gloo ranks running
    ``run_cases``; with ``n_ranks=0``, ``torch_cases`` maps world sizes to
    cases, one spawn each) and JAX (four placeholder devices running
    ``torch_mesh_jax``) as subprocesses now; returns ``get(side)`` ->
    ``side``'s results ("torch": one dict a rank; "jax": a dict), waited
    for at first use, and ``stop()``."""
    import pickle
    import subprocess
    import sys
    from pathlib import Path

    tests = Path(__file__).resolve().parent
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(tests.parent / "src"), str(tests)]))
    tmp = Path(tmp)
    procs = {}
    for side, cases, argv, extra in (
            ("torch", torch_cases, [str(tests / "torch_train_mesh_ranks.py"),
                                    str(n_ranks)], {}),
            ("jax", jax_cases, [str(tests / "torch_mesh_jax.py")],
             {"XLA_FLAGS": "--xla_force_host_platform_device_count=4",
              "JAX_PLATFORMS": "cpu"})):
        if not cases:
            continue
        (tmp / f"{side}_in.pkl").write_bytes(pickle.dumps(cases))
        procs[side] = (subprocess.Popen(
            [sys.executable, *argv, str(tmp / f"{side}_in.pkl"),
             str(tmp / f"{side}_out.pkl")], env={**env, **extra},
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
            tmp / f"{side}_out.pkl")
    cache = {}

    def get(side):
        if side not in cache:
            proc, path = procs[side]
            _, err = proc.communicate(timeout=420)
            assert proc.returncode == 0, err[-4000:]
            cache[side] = pickle.loads(path.read_bytes())
        return cache[side]

    def stop():
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
            proc.communicate()

    return get, stop


if __name__ == "__main__":
    import pickle
    import sys

    from torch_train_mesh_ranks import run_cases as _run_cases

    n, src, dst = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    with open(src, "rb") as f:
        todo = pickle.load(f)
    if n:
        got = tmesh.spawn(_run_cases, n, todo, device=CPU, timeout_s=300)
    else:       # {world size: cases}: one spawn each
        got = {w: tmesh.spawn(_run_cases, w, c, device=CPU, timeout_s=300)
               for w, c in todo.items()}
    with open(dst, "wb") as f:
        pickle.dump(got, f)
