"""Multi-node dry run: plan every (arch x shape x mesh) cell with no card.

    python -m repro_torch.launch.dryrun --arch smoke-lm --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --all --mesh both --out results/dryrun.json
    python -m repro_torch.launch.dryrun --arch selfjoin --shape syn6d2m --mesh single

The counterpart of ``repro.launch.dryrun``, with its CLI (``--out``
resumes: a cell already there without an error is not planned again), its
``[dryrun] <key>: OK ...`` lines and its exit code (1 when any cell
failed). JAX lowers and compiles each cell for 512 placeholder devices and
reads XLA's ``cost_analysis()`` and the optimized HLO. The port has
neither: it runs each cell's step eagerly on ``meta`` tensors, which hold
shapes and dtypes and allocate nothing, with no process group and no card,
and takes its costs from three sources:

1. FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` (matrix products,
   two flops a multiply-add) plus ``CostMode``'s elementwise count (one
   flop an output element of each pointwise op, copies, casts and selects
   left out, and one an input element of each reduction), which is what
   XLA counts for the same operations. An eager run executes every layer, so
   the count at the full depth is exact for what the port runs; JAX's
   while-loop bodies, counted once, forced it to extrapolate from an
   unrolled two-point probe. ``cost_probe`` keeps that probe's form and
   keys (``flops_probe`` and ``bytes_probe`` at ``probe_layers`` L1 =
   pattern, L2 = 2 x pattern) beside the full-depth ``flops_total`` and
   ``bytes_total``.
2. Bytes: ``CostMode`` sums the bytes of the inputs and outputs of each
   aten op that is not a view. Each op of an eager program is its own
   kernel, so this is what the port moves through HBM
   (``bytes_per_device``, ``memory_s``). ``roofline.traffic_floor``, JAX's
   analytic floor, gives ``bytes_floor_per_device`` and ``memory_s_lower``.
3. Collectives: the train step runs on rank 0 of a ``PlanMesh`` of the
   production mesh (``make_production_mesh(plan=True)``), which records
   each collective with its bytes and member ranks; the roofline's ring
   model times each at NVLink or InfiniBand rates by its members' nodes.

Train cells run ``train.steps.make_train_step`` with meta parameters and
state (``LMModel.abstract_params``, this rank's blocks of them, and
``adamw_init``); prefill cells run ``LMModel.prefill`` (``encode`` for an
encoder) and decode cells one ``LMModel.decode_step``, laid out as JAX's
``lower_lm_cell`` lays them out: the layout of (global batch, seq_len),
this rank's blocks of the parameters and of the caches
(``init_caches``: the KV caches' sequence over ``cache_seq``), its rows of
the batch. ``flops_per_device`` is rank 0's counted step. The 'model'
ranks compute with tensor parallelism where the layout splits (the
attention when ``head_tp`` is set, the FFN and the moe experts where
``d_ff`` divides 'model', the head where the vocab does); the recurrent
layers, and the attention without ``head_tp`` (smoke-lm's 8 heads on
'model' 16), repeat over 'model', and ``model_check``'s
``useful_fraction`` reads that repeat as it is. ``memory_analysis``
gives ``argument_size_in_bytes`` (rank 0's blocks of the parameters, the
state or the caches, and its rows of the batch), the step's outputs, and
``temp_size_in_bytes``: the peak of the bytes of the meta storages the
step made that something still held (nothing is donated in the eager
step, so the new parameters and state are part of it).

Self-join cells take their FLOPs and bytes from JAX's
analytic work model (``selfjoin_analytic_cost``) and their collectives
from the ring of ``core.distributed``'s count step, planned from its
``DistJoinConfig`` (``selfjoin_ring_plan``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.configs import SHAPES, ShapeCell, all_cells, get_config
from repro_torch.launch import roofline
from repro_torch.launch.mesh import make_production_mesh, make_selfjoin_mesh

META = torch.device("meta")
# the self-join cells' points: uniform in [0, SPAN]^n (configs/selfjoin.py)
SELFJOIN_SPAN = 100.0

# pointwise ops that copy, cast or select values: not counted as flops
_COPIES = frozenset({"aten.clone", "aten._to_copy", "aten.copy_",
                     "aten.copy", "aten.fill_", "aten.fill",
                     "aten.lift_fresh", "aten.masked_fill",
                     "aten.masked_fill_", "aten.where"})
# reductions: one flop an input element
_REDUCTIONS = frozenset({"aten.sum", "aten.mean", "aten.amax", "aten.amin",
                         "aten.max", "aten.min", "aten.logsumexp",
                         "aten._softmax", "aten._log_softmax",
                         "aten._softmax_backward_data",
                         "aten._log_softmax_backward_data", "aten.cumsum",
                         "aten.prod", "aten.norm", "aten.linalg_vector_norm",
                         "aten.var", "aten.std", "aten.var_mean"})
# ops that make a tensor without writing it: no bytes
_UNWRITTEN = frozenset({"aten.empty", "aten.empty_like", "aten.empty_strided",
                        "aten.new_empty", "aten.new_empty_strided"})


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


class CostMode(TorchDispatchMode):
    """Counts what the aten ops run under it cost: ``bytes``, the inputs'
    and outputs' bytes of each op that is not a view (an eager op is one
    kernel: it reads its inputs and writes its outputs once); ``flops``,
    one an output element of each pointwise op but copies, casts and
    selects, and one an input element of each reduction (matrix products
    are ``FlopCounterMode``'s). With ``track_live``, ``peak_bytes``: the peak
    of the bytes of the storages its ops made that something besides this
    mode still holds. The mode keeps a handle on each such storage and
    reads its use count when the count could set a new peak, so a storage
    held only by autograd's saved tensors stays counted."""

    def __init__(self, track_live: bool = False):
        super().__init__()
        self.bytes = 0
        self.flops = 0
        self.track_live = track_live
        self.live = 0
        self.peak_bytes = 0
        self._held: dict = {}

    def _drop_freed(self) -> None:
        use_count = torch._C._storage_Use_Count
        for key in [k for k, (s, _) in self._held.items()
                    if use_count(s._cdata) == 1]:
            self.live -= self._held.pop(key)[1]

    def _hold(self, out) -> None:
        for t in out:
            if not isinstance(t, torch.Tensor):
                continue
            s = t.untyped_storage()
            if s._cdata in self._held:
                continue
            nb = s.nbytes()
            if self.live + nb > self.peak_bytes:
                self._drop_freed()
            self._held[s._cdata] = (s, nb)
            self.live += nb
            self.peak_bytes = max(self.peak_bytes, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.is_view:
            return out
        name = str(func.overloadpacket)
        outs = tree_leaves(out)
        if name not in _UNWRITTEN:
            self.bytes += (sum(_nbytes(t) for t in tree_leaves((args, kwargs)))
                           + sum(_nbytes(t) for t in outs))
        if torch.Tag.pointwise in func.tags and name not in _COPIES:
            self.flops += sum(t.numel() for t in outs
                              if isinstance(t, torch.Tensor))
        elif name in _REDUCTIONS:
            self.flops += sum(t.numel() for t in tree_leaves(args)
                              if isinstance(t, torch.Tensor))
        if self.track_live:
            self._hold(outs)
        return out


def count_costs(fn, *, track_live: bool = False):
    """``(fn(), costs)``: ``costs`` holds ``flops`` (``matmul_flops`` +
    ``pointwise_flops``), ``bytes`` and, with ``track_live``,
    ``peak_bytes`` (``CostMode``)."""
    from torch.utils.flop_counter import FlopCounterMode

    fc = FlopCounterMode(display=False)
    with fc, CostMode(track_live) as cm:
        out = fn()
    mm = int(fc.get_total_flops())
    return out, {"flops": mm + cm.flops, "matmul_flops": mm,
                 "pointwise_flops": cm.flops, "bytes": cm.bytes,
                 "peak_bytes": cm.peak_bytes if track_live else None}


def tree_bytes(tree) -> int:
    from repro_torch.models.layers import tree_flatten_with_path
    return sum(_nbytes(t) for _, t in tree_flatten_with_path(tree))


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------

def batch_struct(cfg, cell: ShapeCell, device=META) -> dict:
    """The cell's whole batch: meta tensors by default."""
    B, S = cell.global_batch, cell.seq_len
    i32 = dict(dtype=torch.int32, device=device)
    if cfg.input_kind == "embeddings":
        return {"embeds": torch.empty((B, S, cfg.d_model),
                                      dtype=torch.bfloat16, device=device),
                "labels": torch.empty((B, S), **i32)}
    return {"tokens": torch.empty((B, S), **i32),
            "labels": torch.empty((B, S), **i32)}


def opt_config_for(cfg):
    """Factored v and a bf16 m for the 300B+ MoEs (state compression);
    plain AdamW elsewhere (JAX's rule)."""
    from repro_torch.train.optimizer import AdamWConfig

    if cfg.param_count() > 100e9:
        return AdamWConfig(factored=True, m_dtype="bfloat16")
    return AdamWConfig()


def _pattern_len(cfg) -> int:
    pat = 1
    if cfg.slstm_every:
        pat = max(pat, cfg.slstm_every)
    if cfg.shared_attn_every:
        pat = max(pat, cfg.shared_attn_every)
    return pat


def _probe(cfg, cell: ShapeCell) -> dict:
    """The mesh-free step of one cell on meta tensors: its counted costs."""
    from repro_torch.models.lm import LMModel
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.steps import make_train_step

    model = LMModel(cfg, device=META)
    params, _ = model.abstract_params()
    batch = batch_struct(cfg, cell)
    if cell.kind == "train":
        ocfg = opt_config_for(cfg)
        state = adamw_init(params, ocfg)
        step = make_train_step(model, ocfg)
        run = lambda: step(params, state, batch)          # noqa: E731
    elif cell.kind == "prefill" and cfg.encoder_only:
        run = lambda: model.encode(params, batch)         # noqa: E731
    elif cell.kind == "prefill":
        caches = model.init_caches(cell.global_batch, cell.seq_len)
        run = lambda: model.prefill(params, batch, caches)  # noqa: E731
    elif cell.kind == "decode":
        caches = model.init_caches(cell.global_batch, cell.seq_len)
        tokens = torch.empty((cell.global_batch,), dtype=torch.int32,
                             device=META)
        run = lambda: model.decode_step(params, tokens, caches)  # noqa: E731
    else:
        raise ValueError(cell.kind)
    return count_costs(run)[1]


def cost_probe(arch: str, cell: ShapeCell, cfg=None) -> dict:
    """The mesh-free cell's counted FLOPs and bytes at the probe depths
    (L1 = pattern, L2 = 2 x pattern layers: ``*_probe``, JAX's two-point
    form) and at the full depth (``*_total``, exact for the eager step)."""
    cfg = cfg if cfg is not None else get_config(arch)
    pat = _pattern_len(cfg)
    depths = (pat, 2 * pat)
    probes = [_probe(dataclasses.replace(cfg, n_layers=n), cell)
              for n in depths]
    full = (probes[1] if cfg.n_layers == depths[1] else
            probes[0] if cfg.n_layers == depths[0] else _probe(cfg, cell))
    out = {}
    for key in ("flops", "bytes"):
        out[key + "_total"] = float(full[key])
        out[key + "_probe"] = [float(p[key]) for p in probes]
    out["matmul_flops_total"] = float(full["matmul_flops"])
    out["matmul_flops_probe"] = [float(p["matmul_flops"]) for p in probes]
    out["probe_layers"] = list(depths)
    return out


def _rows_bytes(mesh, batch: dict, layout) -> int:
    """Bytes of this rank's rows of the whole ``batch`` (the layout's batch
    axes split dimension 0)."""
    total = 0
    for t in batch.values():
        sl = mesh.block((layout.batch_axes,), t.shape)
        total += math.prod(s.stop - s.start for s in sl) * t.element_size()
    return total


def lower_lm_cell(arch: str, cell: ShapeCell, mesh, cfg=None, *,
                  compress_pods: bool = False, opt_cfg=None, batch=None):
    """Plan one step of ``cell`` on ``mesh`` (a ``PlanMesh``): a train
    step, a prefill (``encode`` for an encoder) or one decode step.
    Returns ``(cfg, layout, plan)``, ``plan`` holding the counted
    ``costs`` of the rank's step (``count_costs`` with the live peak),
    its collective ``records`` (``PlanMesh.plan``), the ``mesh`` and
    ``memory`` (``memory_analysis``'s keys). ``opt_cfg`` defaults to
    ``opt_config_for(cfg)``, ``batch`` to the cell's meta batch."""
    from repro_torch.models.lm import LMModel, choose_layout
    from repro_torch.train.compression import init_error_state
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.steps import make_train_step

    cfg = cfg if cfg is not None else get_config(arch)
    model = LMModel(cfg, mesh)
    whole, specs = model.abstract_params()
    params = mesh.local_tree(whole, specs)
    batch = batch if batch is not None else batch_struct(cfg, cell)
    B = cell.global_batch
    layout = choose_layout(cfg, mesh, B, cell.seq_len)
    arg = {"params_bytes": tree_bytes(params)}
    if cell.kind == "train":
        ocfg = opt_cfg if opt_cfg is not None else opt_config_for(cfg)
        state = adamw_init(params, ocfg)
        if compress_pods:
            state["grad_error"] = init_error_state(params)
        arg["opt_state_bytes"] = tree_bytes(state)
        step = make_train_step(model, ocfg, compress_pods=compress_pods,
                               param_specs=specs)
        run = lambda: step(params, state, batch)              # noqa: E731
    else:
        batch = {k: v for k, v in batch.items() if k != "labels"}
        if cell.kind == "prefill" and cfg.encoder_only:
            run = lambda: model.encode(params, batch, layout)   # noqa: E731
        elif cell.kind == "prefill":
            caches = model.init_caches(B, cell.seq_len, layout)
            arg["cache_bytes"] = tree_bytes(caches)
            run = lambda: model.prefill(params, batch, caches,  # noqa: E731
                                        layout)
        elif cell.kind == "decode":
            caches = model.init_caches(B, cell.seq_len, layout)
            arg["cache_bytes"] = tree_bytes(caches)
            batch = {"tokens": torch.empty((B,), dtype=torch.int32,
                                           device=META)}
            run = lambda: model.decode_step(  # noqa: E731
                params, batch["tokens"], caches, layout)
        else:
            raise ValueError(cell.kind)
    arg["batch_bytes"] = _rows_bytes(mesh, batch, layout)
    n_records = len(mesh.plan)
    out, costs = count_costs(run, track_live=True)
    memory = {
        "argument_size_in_bytes": sum(arg.values()),
        "output_size_in_bytes": tree_bytes(out),
        "temp_size_in_bytes": costs["peak_bytes"],
        **arg,
    }
    plan = {"costs": costs, "records": list(mesh.plan[n_records:]),
            "mesh": mesh, "memory": memory}
    return cfg, layout, plan


def collectives_of(records) -> list:
    """``roofline.Collective`` of each ``(stat, op, bytes, members)``."""
    return [roofline.collective(op, nbytes, members, stat)
            for stat, op, nbytes, members in records]


def _with_bottleneck(r: dict) -> dict:
    r["bottleneck"] = roofline.bottleneck(r["compute_s"], r["memory_s"],
                                          r["collective_s"])
    return r


def _lm_cell(arch, cell, mesh, probe_cache) -> dict:
    probe_key = f"{arch}|{cell.name}"
    if probe_key not in probe_cache:
        probe_cache[probe_key] = cost_probe(arch, cell)
    probe = probe_cache[probe_key]
    chips = mesh.size
    shape = dict(mesh.shape)
    t0 = time.time()
    cfg, layout, plan = lower_lm_cell(arch, cell, mesh)
    costs = plan["costs"]
    colls = collectives_of(plan["records"])
    r = roofline.summarize(costs["flops"], costs["bytes"], colls, chips)
    floor = roofline.traffic_floor(cfg, cell, chips)
    r.update(
        matmul_flops_per_device=costs["matmul_flops"],
        bytes_floor_per_device=floor,
        memory_s_lower=floor / roofline.HBM_BW,
        collective_schedule=roofline.schedule(colls),
        cost_source=(
            "flops: FlopCounterMode (matmuls) + one flop an element of each "
            "pointwise op and reduction, rank 0's eager step on meta "
            "tensors; bytes: each non-view aten op's inputs and outputs "
            "(memory_s), roofline.traffic_floor (memory_s_lower); "
            "collectives: the PlanMesh's records at rank 0, ring model"),
        probe=probe,
    )
    return {
        "chips": chips, "mesh": shape,
        "memory_analysis": plan["memory"],
        "plan_seconds": time.time() - t0,
        "roofline": _with_bottleneck(r),
        "model_check": roofline.model_flops_check(cfg, cell, costs["flops"],
                                                  chips),
        "layout": {"batch_axes": str(layout.batch_axes),
                   "head_tp": str(layout.head_tp),
                   "cache_seq": str(layout.cache_seq)},
    }


# ---------------------------------------------------------------------------
# Self-join cells
# ---------------------------------------------------------------------------

def selfjoin_analytic_cost(cfg, npts, ndims, eps, n_slab, n_model):
    """Analytic per-device flops/bytes for the distributed count step
    (JAX's work model, term for term).

    Uniform data in [0,100]^n (the paper's Syn- datasets): offsets
    ~ (3^n+1)/2 (UNICOMP), candidate window C per cell, candidates per
    device per offset = P_cand = P_loc + 2H. Each candidate slot costs
    ~3n flops (sub, mul, add) + compare; gathers dominate bytes.
    """
    p_loc = -(-npts // n_slab)
    halo = max(64, int(p_loc * 0.25))
    p_cand = p_loc + 2 * halo
    n_off = (3 ** ndims + 1) // 2 if cfg.unicomp else 3 ** ndims
    n_off_local = -(-n_off // n_model)
    C = cfg.max_per_cell
    per_slot_flops = 3 * ndims + 2
    flops = p_cand * C * n_off_local * per_slot_flops
    bytes_per_slot = 8 * ndims + 8        # f64 coords + ids/masks
    bytes_ = p_cand * C * n_off_local * bytes_per_slot
    return {"flops_total": flops * n_slab * n_model,
            "bytes_total": bytes_ * n_slab * n_model,
            "flops_per_device": flops, "bytes_per_device": bytes_}


def selfjoin_ring_plan(cfg, mesh, rank: int = 0, item: int = 8) -> list:
    """The collectives one rank of ``core.distributed``'s count step
    (``make_distributed_count_step``) issues, as ``(stat, op, bytes,
    members)`` records, from its ``DistJoinConfig`` and the mesh's
    ``n_slabs`` and ``n_model`` alone; ``item`` is the points' dtype's
    size. For each hop h, ``_RankRing._swap`` sends the slab h to the
    left and the one h to the right (where they exist) first one value of
    the boundary along dimension 0, then the parcel that
    ``_assemble_candidates`` sizes: ``halo_capacity`` rows of ``n_dims``
    coordinates and their int32 ids. Then four all-reduces over every
    rank: the halo-overflow flag (one int64), the geometry's minima and
    maxima (``n_dims`` float64 each), the total and the cell-overflow flag
    (one int64 each)."""
    n_slabs, n_model = mesh.n_slabs, mesh.n_model
    slab, model = divmod(rank, n_model)
    h_cap, n = cfg.halo_capacity, cfg.n_dims
    out = []
    for h in range(1, cfg.k_hops + 1):
        for stat, nbytes in (("bounds", item),
                             ("halo", h_cap * n * item + h_cap * 4)):
            for step in (-h, h):
                if 0 <= slab + step < n_slabs:
                    peer = (slab + step) * n_model + model
                    out.append((stat, "collective-permute", nbytes,
                                (rank, peer)))
    world = tuple(range(n_slabs * n_model))
    for stat, nbytes in (("flags", 8), ("geometry", 8 * n),
                         ("geometry", 8 * n), ("total", 8), ("flags", 8)):
        out.append((stat, "all-reduce", nbytes, world))
    return out


def selfjoin_config(shape_name: str, mesh):
    """The cell's ``(DistJoinConfig, npts, ndims, eps)``, as JAX's
    ``lower_selfjoin_cell`` builds it; ``k_hops`` covers eps with slabs of
    the uniform data's width along dimension 0."""
    from repro_torch.configs.selfjoin import CONFIG, SHAPES as SJ_SHAPES
    from repro_torch.core.distributed import DistJoinConfig

    _, npts, ndims, eps = {s[0]: s for s in SJ_SHAPES}[shape_name]
    n_slab = mesh.n_slabs
    pts_per_dev = -(-npts // n_slab)
    cfg = DistJoinConfig(
        pts_per_device=pts_per_dev,
        n_dims=ndims,
        halo_capacity=max(64, int(pts_per_dev * CONFIG.halo_frac)),
        max_per_cell=CONFIG.max_per_cell,
        k_hops=max(1, math.ceil(eps * n_slab / SELFJOIN_SPAN)),
        unicomp=CONFIG.unicomp,
        model_axis="model",
    )
    return cfg, npts, ndims, eps


def _selfjoin_cell(shape: str, mesh) -> dict:
    cfg, npts, ndims, eps = selfjoin_config(shape, mesh)
    chips = mesh.n_slabs * mesh.n_model
    ana = selfjoin_analytic_cost(cfg, npts, ndims, eps, mesh.n_slabs,
                                 mesh.n_model)
    # an inner slab sends both ways: the busiest rank
    rank = min(1, mesh.n_slabs - 1) * mesh.n_model
    colls = collectives_of(selfjoin_ring_plan(cfg, mesh, rank))
    r = roofline.summarize(ana["flops_per_device"], ana["bytes_per_device"],
                           colls, chips)
    r.update(collective_schedule=roofline.schedule(colls), planned_rank=rank,
             k_hops=cfg.k_hops,
             cost_source="flops, bytes: the analytic work model "
                         "(selfjoin_analytic_cost); collectives: the ring "
                         "of the count step from DistJoinConfig "
                         "(selfjoin_ring_plan), ring model")
    P, H = cfg.pts_per_device, cfg.halo_capacity
    return {
        "chips": chips, "mesh": {"slab": mesh.n_slabs, "model": mesh.n_model},
        "memory_analysis": {
            "argument_size_in_bytes": P * ndims * 8 + P * 4,
            "output_size_in_bytes": 8,
            # the halo step's candidate block: coords, ids, valid, owned
            "candidate_block_bytes": ((P + 2 * H * cfg.k_hops)
                                      * (ndims * 8 + 4 + 1 + 1)),
            "temp_size_in_bytes": None,
            "temp_note": "the plan does not run the count sweep's "
                         "per-offset candidate gathers",
        },
        "roofline": _with_bottleneck(r),
    }


# ---------------------------------------------------------------------------
# The driver
# ---------------------------------------------------------------------------

def run_cell(arch: str, shape: str, mesh_kind: str, probe_cache: dict):
    """One cell on the (16, 16) or (2, 16, 16) production mesh ("single",
    "multi"), or the self-join's (16, 16) or (32, 16) mesh, planned at
    rank 0 with no world (``plan=True``)."""
    multi = mesh_kind == "multi"
    if arch == "selfjoin":
        return _selfjoin_cell(shape, make_selfjoin_mesh(multi_pod=multi,
                                                        plan=True))
    cell = {c.name: c for c in SHAPES}[shape]
    mesh = make_production_mesh(multi_pod=multi, plan=True)
    return _lm_cell(arch, cell, mesh, probe_cache)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    jobs = []
    if args.all:
        for arch, cell, skip in all_cells():
            for mk in meshes:
                jobs.append((arch, cell.name, mk, skip))
        from repro_torch.configs.selfjoin import SHAPES as SJ_SHAPES
        for s in SJ_SHAPES:
            for mk in meshes:
                jobs.append(("selfjoin", s[0], mk, None))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        for mk in meshes:
            jobs.append((args.arch, args.shape, mk, None))

    results = {}
    if args.out and os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)  # resume support
    probe_cache = results.setdefault("_probe_cache", {})
    for arch, shape, mk, skip in jobs:
        key = f"{arch}|{shape}|{mk}"
        if key in results and "error" not in results[key]:
            print(f"[dryrun] {key}: cached", flush=True)
            continue
        if skip is not None:
            results[key] = {"skipped": skip}
            print(f"[dryrun] {key}: SKIP ({skip})", flush=True)
            continue
        print(f"[dryrun] {key}: planning...", flush=True)
        t0 = time.time()
        try:
            res = run_cell(arch, shape, mk, probe_cache)
            results[key] = res
            if "skipped" in res:
                print(f"[dryrun] {key}: SKIP ({res['skipped']}) in "
                      f"{time.time()-t0:.1f}s", flush=True)
            else:
                r = res["roofline"]
                print(f"[dryrun] {key}: OK in {time.time()-t0:.1f}s "
                      f"compute={r['compute_s']:.3e}s "
                      f"memory={r['memory_s']:.3e}s "
                      f"collective={r['collective_s']:.3e}s "
                      f"bottleneck={r['bottleneck']}", flush=True)
        except Exception as e:      # noqa: BLE001 -- recorded, exit code 1
            results[key] = {"error": f"{type(e).__name__}: {e}",
                            "traceback": traceback.format_exc()[-2000:]}
            print(f"[dryrun] {key}: FAIL {type(e).__name__}: {e}",
                  flush=True)
        if args.out:
            tmp = args.out + ".tmp"
            with open(tmp, "w") as f:
                json.dump(results, f, indent=1)
            os.replace(tmp, args.out)
    n_ok = sum(1 for v in results.values() if "roofline" in v)
    n_skip = sum(1 for v in results.values() if "skipped" in v)
    n_err = sum(1 for v in results.values() if "error" in v)
    print(f"[dryrun] done: {n_ok} ok, {n_skip} skipped, {n_err} failed",
          flush=True)
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
