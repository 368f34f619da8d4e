"""The port's roofline (``repro_torch.launch.roofline``) against JAX's.

* ``wire_bytes`` of every collective kind equals the wire bytes JAX's
  ``parse_collectives`` gives for a synthetic optimized-HLO line of that
  kind and size, tuple results included;
* ``traffic_floor`` and ``model_flops_check`` equal JAX's exactly for the
  smoke-lm CONFIG and REDUCED and the three ``FAMILY_SMOKES``, at train,
  prefill and decode;
* the dry run's ``selfjoin_analytic_cost`` equals JAX's for the four
  self-join SHAPES on (16, 16) and (32, 16);
* a group crosses nodes exactly when its ranks span more than one block
  of ``NODE_SIZE``;
* the H100 constants, and C6's limit defined once.
"""
import dataclasses
import math
import os

import pytest

from repro_torch.configs import SHAPES
from repro_torch.configs.selfjoin import CONFIG as SJ_CONFIG
from repro_torch.configs.selfjoin import SHAPES as SJ_SHAPES
from repro_torch.configs.smoke_lm import CONFIG, FAMILY_SMOKES, REDUCED
from repro_torch.core.distributed import DistJoinConfig
from repro_torch.launch import dryrun, roofline

CONFIGS = {"smoke-lm": CONFIG, "smoke-lm-reduced": REDUCED, **FAMILY_SMOKES}
CELLS = [c for c in SHAPES if c.name != "long_500k"]
HLO_DTYPES = {"f32": 4, "bf16": 2}


@pytest.fixture(scope="module")
def jax_side():
    """JAX's roofline and dry-run modules, the dry run imported with the
    process's XLA flags kept (it sets 512 placeholder devices at import,
    which the backend, made first here, no longer reads)."""
    import jax
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jd
        from repro.launch import roofline as jr
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return jr, jd


def _jax_cfg(cfg):
    from repro.models.config import ModelConfig as JaxConfig
    return JaxConfig(**dataclasses.asdict(cfg))


def _jax_cell(cell):
    from repro.configs import ShapeCell as JaxCell
    return JaxCell(cell.name, cell.seq_len, cell.global_batch, cell.kind)


# ---------------------------------------------------------------------------
# the ring model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", roofline.KINDS)
@pytest.mark.parametrize("group", [2, 8, 16, 256])
@pytest.mark.parametrize("tuple_result", [False, True])
def test_wire_bytes_against_parse_collectives(jax_side, kind, group,
                                              tuple_result):
    jr, _ = jax_side
    shapes = [("f32", (16, 4096)), ("bf16", (3, 5, 7))]
    if not tuple_result:
        shapes = shapes[:1]
    text = ", ".join(f"{dt}[{','.join(map(str, dims))}]{{1,0}}"
                     for dt, dims in shapes)
    if tuple_result:
        text = f"({text})"
    ids = ",".join(str(i) for i in range(group))
    groups = ("source_target_pairs={{0,1}}" if kind == "collective-permute"
              else f"replica_groups={{{{{ids}}}}}")
    line = f"%c.1 = {text} {kind}(%p.0, %p.1), {groups}, channel_id=1"
    (parsed,) = jr.parse_collectives(line)
    nbytes = sum(HLO_DTYPES[dt] * math.prod(dims) for dt, dims in shapes)
    assert parsed.bytes_result == nbytes
    g = 1 if kind == "collective-permute" else group
    assert roofline.wire_bytes(kind, nbytes, g) == parsed.wire_bytes


def test_wire_bytes_refuses_an_unknown_kind():
    with pytest.raises(ValueError, match="unknown collective kind"):
        roofline.wire_bytes("all_reduce", 8, 2)


@pytest.mark.parametrize("members,cross", [
    ((0, 1, 2, 3, 4, 5, 6, 7), False),
    ((8, 15), False),
    ((7, 8), True),
    (tuple(range(16)), True),              # a 'model' group of 16
    (tuple(range(0, 256, 16)), True),      # a 'data' group
    ((24,), False),
])
def test_crosses_nodes(members, cross):
    assert roofline.crosses_nodes(members) is cross
    c = roofline.collective("all-reduce", 1 << 20, members, "grads")
    assert c.cross_node is cross
    bw = roofline.IB_BW if cross else roofline.NVLINK_BW
    assert c.seconds == c.wire_bytes / bw
    assert c.group_size == len(members) and c.stat == "grads"


def test_summarize_terms_and_bottleneck():
    colls = [roofline.collective("all-gather", 1 << 30, range(16)),
             roofline.collective("collective-permute", 1 << 20, (0, 16))]
    s = roofline.summarize(1e12, 1e9, colls, 256)
    assert s["compute_s"] == 1e12 / roofline.PEAK_FLOPS
    assert s["memory_s"] == 1e9 / roofline.HBM_BW
    assert s["collective_s"] == sum(c.seconds for c in colls)
    assert s["wire_bytes_per_device"] == (2 ** 30 * 15 / 16 + 2 ** 20)
    assert s["n_collectives"] == 2 and s["chips"] == 256
    assert s["bottleneck"] == "collective"
    sched = roofline.schedule(colls + colls[:1])
    assert [e["count"] for e in sched] == [2, 1]


# ---------------------------------------------------------------------------
# analytic terms against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("cell", CELLS, ids=[c.name for c in CELLS])
@pytest.mark.parametrize("chips", [1, 256, 512])
def test_traffic_floor_and_model_flops_equal_jax(jax_side, name, cell,
                                                 chips):
    jr, _ = jax_side
    cfg = CONFIGS[name]
    jcfg, jcell = _jax_cfg(cfg), _jax_cell(cell)
    assert (roofline.traffic_floor(cfg, cell, chips)
            == jr.traffic_floor(jcfg, jcell, chips))
    flops = 1.2345e15 / chips
    assert (roofline.model_flops_check(cfg, cell, flops, chips)
            == jr.model_flops_check(jcfg, jcell, flops, chips))


@pytest.mark.parametrize("shape", SJ_SHAPES, ids=[s[0] for s in SJ_SHAPES])
@pytest.mark.parametrize("mesh", [(16, 16), (32, 16)])
def test_selfjoin_analytic_cost_equals_jax(jax_side, shape, mesh):
    from repro.core.distributed import DistJoinConfig as JaxJoinConfig

    _, jd = jax_side
    name, npts, ndims, eps = shape
    n_slab, n_model = mesh
    p = -(-npts // n_slab)
    kw = dict(pts_per_device=p, n_dims=ndims,
              halo_capacity=max(64, int(p * SJ_CONFIG.halo_frac)),
              max_per_cell=SJ_CONFIG.max_per_cell, unicomp=SJ_CONFIG.unicomp,
              model_axis="model")
    got = dryrun.selfjoin_analytic_cost(DistJoinConfig(**kw), npts, ndims,
                                        eps, n_slab, n_model)
    want = jd.selfjoin_analytic_cost(JaxJoinConfig(**kw), npts, ndims, eps,
                                     n_slab, n_model)
    assert got == want


def test_selfjoin_cell_config_is_jaxs():
    """The dry run's self-join config is the one JAX's
    ``lower_selfjoin_cell`` builds (P, H, C, UNICOMP, the model axis), with
    the hop count the uniform data needs (one at every production cell)."""
    mesh = dryrun.make_selfjoin_mesh(multi_pod=True, plan=True)
    assert (mesh.n_slabs, mesh.n_model, mesh.rank) == (32, 16, 0)
    for name, npts, ndims, eps in SJ_SHAPES:
        cfg, *_ = dryrun.selfjoin_config(name, mesh)
        p = -(-npts // 32)
        assert (cfg.pts_per_device, cfg.n_dims, cfg.halo_capacity,
                cfg.max_per_cell, cfg.unicomp, cfg.model_axis, cfg.k_hops) \
            == (p, ndims, max(64, int(p * 0.25)), 64, True, "model", 1)


# ---------------------------------------------------------------------------
# constants
# ---------------------------------------------------------------------------

def test_h100_constants():
    assert roofline.PEAK_FLOPS == 989.4e12
    assert (roofline.PEAK_FLOPS_FP32, roofline.PEAK_FLOPS_FP64_TENSOR,
            roofline.PEAK_FLOPS_FP64) == (67e12, 67e12, 34e12)
    assert roofline.HBM_BW == 3.35e12
    assert (roofline.NVLINK_BW, roofline.IB_BW) == (450e9, 50e9)
    assert roofline.NODE_SIZE == 8
    names = {k for k in vars(roofline) if k.isupper()}
    assert not names & {"ICI_BW", "DCN_BW", "POD_SIZE", "VMEM_BYTES"}
    values = {v for k, v in vars(roofline).items()
              if k.isupper() and isinstance(v, (int, float))}
    assert not values & {197e12, 819e9, 25e9, 128 * 2 ** 20}


def test_smem_limit_defined_once():
    from repro_torch.analysis import contracts
    assert contracts.SMEM_OPTIN_H100 is roofline.SMEM_OPTIN_H100
    assert roofline.SMEM_OPTIN_H100 == 227 * 1024
    src = open(contracts.__file__).read()
    assert "SMEM_OPTIN_H100 =" not in src
