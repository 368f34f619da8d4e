"""The port's dry run (``repro_torch.launch.dryrun``, ROADMAP A17 (iii))
against JAX's counts and against real steps on gloo ranks on the CPU.

* ``cost_probe``'s counted FLOPs of the mesh-free train step at the probe
  depths (L1 = pattern, L2 = 2 x pattern layers) against JAX's
  ``_lower_probe`` (XLA's cost analysis of the unrolled step), within
  FLOP_BANDS: the port counts matrix products and one flop an element of
  each pointwise op and reduction; XLA also counts the elementwise work
  the port's ops fold away (the scans' gates weigh most in the ssm
  family).
* The plan of one train step on a ``PlanMesh`` against a real step of
  the reduced smoke-lm on 2 and 4 gloo ranks, (1, 2), (2, 1), (2, 2) and
  the pod-compressed (2, 1, 2): every kind's calls and bytes equal the
  real rank's ``LMMesh.stats`` difference, and the planned
  ``argument_size_in_bytes`` the real rank's blocks and rows.
* ``selfjoin_ring_plan`` against what ``distributed_self_join_count``
  sends on 2 and 4 ranks (``torch.distributed`` wrapped in the ranks),
  one hop and two.
* ``python -m repro_torch.launch.dryrun --all --mesh both`` in a
  subprocess: every cell, the meshed prefill and decode cells planned
  (only long_500k skipped, full attention), exit code 0.

The gloo ranks (``tests/torch_train_mesh_ranks.py``) and the CLI start
as subprocesses when the module does.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.configs import ShapeCell, all_cells
from repro_torch.configs.selfjoin import SHAPES as SJ_SHAPES
from repro_torch.configs.smoke_lm import FAMILY_SMOKES, REDUCED
from repro_torch.core.distributed import DistJoinConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import SlabMesh, plan_mesh
from repro_torch.train.optimizer import AdamWConfig
from torch_train_mesh_ranks import start
from torch_workloads import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parent.parent
# the port's counted FLOPs over JAX's at the probe depths
FLOP_BANDS = {"dense": (0.98, 1.02), "moe": (0.97, 1.02),
              "hybrid": (0.97, 1.02), "ssm": (0.88, 0.95)}
PROBE_CONFIGS = {"dense": REDUCED, **FAMILY_SMOKES}
PROBE_CELL = ShapeCell("probe", 64, 4, "train")
BATCH = (4, 32)
AXES = ("data", "model")
POD_AXES = ("pod", "data", "model")
STEP_CASES = {
    2: {"1x2": (AXES, (1, 2), False), "2x1": (AXES, (2, 1), False)},
    4: {"2x2": (AXES, (2, 2), False), "pods": (POD_AXES, (2, 1, 2), True)},
}
# (n_slabs, n_model, eps): eps 30 over slabs 25 wide takes two hops
RING_CASES = {2: {"ring2": (2, 1, 5.0)},
              4: {"ring4": (4, 1, 30.0), "ring2x2": (2, 2, 5.0)}}


@pytest.fixture(scope="module", autouse=True)
def procs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun")
    cases = {}
    for world in (2, 4):
        cases[world] = {
            name: ("step_stats", dict(fam="dense", dtype="float32",
                                      shape=shape, axes=axes, batch=BATCH,
                                      compress=compress))
            for name, (axes, shape, compress) in STEP_CASES[world].items()}
        cases[world].update({
            name: ("selfjoin_sends", dict(n_slabs=s, n_model=m, eps=eps))
            for name, (s, m, eps) in RING_CASES[world].items()})
    get, stop = start(d, cases, {}, n_ranks=0)
    out = d / "dryrun.json"
    cli = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--mesh", "both", "--out", str(out)],
        env=dict(os.environ, OMP_NUM_THREADS="1",
                 PYTHONPATH=str(ROOT / "src")),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    cache = {}

    def dryrun_cli():
        if "cli" not in cache:
            so, se = cli.communicate(timeout=300)
            cache["cli"] = (cli.returncode, so, se,
                            json.loads(out.read_text()) if out.exists()
                            else None)
        return cache["cli"]

    yield get, dryrun_cli
    stop()
    if cli.poll() is None:
        cli.kill()
    cli.communicate()


@pytest.fixture(scope="module")
def jax_dryrun():
    """JAX's dry-run module, imported with the process's XLA flags kept:
    it sets 512 placeholder devices at import, which the backend (made
    first here) no longer reads, and which must not reach subprocesses."""
    import jax
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jd
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return jd


# ---------------------------------------------------------------------------
# FLOPs against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", sorted(PROBE_CONFIGS))
def test_probe_flops_against_jax(jax_dryrun, family):
    from repro.configs import ShapeCell as JaxCell
    from repro.models.config import ModelConfig as JaxConfig

    cfg = PROBE_CONFIGS[family]
    probe = dryrun.cost_probe("smoke-lm", PROBE_CELL, cfg=cfg)
    lo, hi = FLOP_BANDS[family]
    cell = JaxCell(PROBE_CELL.name, PROBE_CELL.seq_len,
                   PROBE_CELL.global_batch, "train")
    for n, port in zip(probe["probe_layers"], probe["flops_probe"]):
        jcfg = JaxConfig(**dict(dataclasses.asdict(cfg), n_layers=n,
                                unroll_scans=True))
        ref = jax_dryrun._lower_probe(jcfg, cell)["flops"]
        assert lo <= port / ref <= hi, (family, n, port, ref, port / ref)


def test_probe_total_is_the_full_depth():
    """The full-depth count is the eager step's own. Its matrix products
    lie on the two-point line exactly; its elementwise work lies above
    it: the backward of each layer's slice of a stacked parameter adds a
    gradient of the whole stack, so that work grows as L^2."""
    cfg = dataclasses.replace(REDUCED, n_layers=3)
    probe = dryrun.cost_probe("smoke-lm", PROBE_CELL, cfg=cfg)
    assert probe["probe_layers"] == [1, 2]
    m1, m2 = probe["matmul_flops_probe"]
    assert probe["matmul_flops_total"] == m1 + 2 * (m2 - m1)
    c1, c2 = probe["flops_probe"]
    assert probe["flops_total"] > c1 + 2 * (c2 - c1)
    assert c2 > c1 > 0
    assert probe["bytes_total"] > probe["bytes_probe"][1] > 0


# ---------------------------------------------------------------------------
# Planned collectives against real steps
# ---------------------------------------------------------------------------

def _plan(shape, axes, rank, compress):
    cell = ShapeCell("step", BATCH[1], BATCH[0], "train")
    cfg = dataclasses.replace(REDUCED, dtype="float32")
    _, _, plan = dryrun.lower_lm_cell(
        "smoke-lm", cell, plan_mesh(shape, axes, rank), cfg=cfg,
        compress_pods=compress, opt_cfg=AdamWConfig(warmup_steps=2))
    return plan


@pytest.mark.parametrize("world,name", [(w, n) for w in STEP_CASES
                                        for n in STEP_CASES[w]])
def test_planned_collectives_equal_a_real_step(procs, world, name):
    get, _ = procs
    axes, shape, compress = STEP_CASES[world][name]
    ranks = [r[name] for r in get("torch")[world] if r[name] is not None]
    assert len(ranks) == world
    for real in ranks:
        plan = _plan(shape, axes, real["rank"], compress)
        planned = plan["mesh"].calls_and_bytes()
        assert planned == real["stats"], (name, real["rank"])
        assert (plan["memory"]["argument_size_in_bytes"]
                == real["argument_bytes"]), (name, real["rank"])
        # the records are what the stats count, kind by kind
        by_kind = {}
        for kind, _, nbytes, _ in plan["records"]:
            c, b = by_kind.get(kind, (0, 0))
            by_kind[kind] = (c + 1, b + nbytes)
        assert {k: list(v) for k, v in by_kind.items()} == planned
    if compress:
        assert "pods" in real["stats"]


def test_plan_records_member_ranks():
    """Rank 5 of a (2, 2, 2) plan: each record's members are the ranks
    that share its coordinates off the collective's axes."""
    plan = _plan((2, 2, 2), POD_AXES, 5, compress=True)
    groups = {tuple(m) for _, _, _, m in plan["records"]}
    # pod x data x model: rank 5 is (1, 0, 1); the compressed step runs
    # 'pod' by hand, so its rows' sums go over 'data' alone; every weight
    # of the reduced config splits over 'model' and stays split, so no
    # parameter is gathered over 'data' and 'model' together
    assert groups == {(5, 7), (4, 5), (1, 5), (0, 1, 2, 3, 4, 5, 6, 7)}
    kinds = {(kind, tuple(m)) for kind, _, _, m in plan["records"]}
    assert ("tp", (4, 5)) in kinds and ("params", (5, 7)) in kinds


# ---------------------------------------------------------------------------
# The self-join's ring
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world,name", [(w, n) for w in RING_CASES
                                        for n in RING_CASES[w]])
def test_selfjoin_ring_plan_equals_sends(procs, world, name):
    get, _ = procs
    n_slabs, n_model, _ = RING_CASES[world][name]
    ranks = [r[name] for r in get("torch")[world]]
    assert len({r["total"] for r in ranks}) == 1
    if name == "ring4":
        assert ranks[0]["cfg"]["k_hops"] == 2
    for real in ranks:
        cfg = DistJoinConfig(**real["cfg"])
        mesh = SlabMesh(None, n_slabs, n_model, 0, None, "plan")
        plan = dryrun.selfjoin_ring_plan(cfg, mesh, real["rank"])
        want = [(op, nbytes, m[1] if op == "collective-permute" else len(m))
                for _, op, nbytes, m in plan]
        assert [tuple(s) for s in real["sent"]] == want, real["rank"]


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

def test_cli_all_cells(procs):
    _, dryrun_cli = procs
    rc, out, err, results = dryrun_cli()
    assert rc == 0, err[-3000:]
    assert "done: 14 ok, 2 skipped, 0 failed" in out
    keys = {f"{a}|{c.name}|{m}" for a, c, _ in all_cells()
            for m in ("single", "multi")}
    keys |= {f"selfjoin|{s[0]}|{m}" for s in SJ_SHAPES
             for m in ("single", "multi")}
    assert keys <= set(results)
    for key in keys:
        res = results[key]
        kind = key.split("|")[1].split("_")[0]
        if kind in ("prefill", "decode"):
            assert res["roofline"]["probe"]["flops_total"] > 0, key
            assert res["memory_analysis"]["cache_bytes"] > 0, key
        if key.startswith("smoke-lm|long_500k"):
            assert "quadratic" in res["skipped"]
        else:
            r = res["roofline"]
            for term in ("compute_s", "memory_s", "collective_s"):
                assert r[term] > 0, (key, term)
            assert r["bottleneck"] in ("compute", "memory", "collective")
            assert res["chips"] in (256, 512)
    single = results["smoke-lm|train_4k|single"]
    assert single["mesh"] == {"data": 16, "model": 16}
    assert single["memory_analysis"]["temp_size_in_bytes"] > 0
    # every 'model' group of 16 spans two nodes of 8: InfiniBand
    assert all(c["cross_node"] for c in
               single["roofline"]["collective_schedule"])
    assert "OK" in out and "bottleneck=" in out


def test_cli_resumes(procs, tmp_path):
    """A second run over the first one's file plans nothing again."""
    _, dryrun_cli = procs
    _, _, _, results = dryrun_cli()
    path = tmp_path / "dryrun.json"
    path.write_text(json.dumps(results))
    rc = dryrun.main(["--arch", "smoke-lm", "--shape", "train_4k",
                      "--mesh", "both", "--out", str(path)])
    assert rc == 0
    assert json.loads(path.read_text()) == results
