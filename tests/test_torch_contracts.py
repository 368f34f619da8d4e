"""The port's contract prover and linter (``repro_torch.analysis``), held to
the JAX package's on the CPU.

* The independent re-derivations (coordinate-space window caps, the
  external cap, the CSR cell of each row) equal JAX's arrays, and the
  prover's finding keys equal JAX's prover's for every contract but C6, on
  the canned datasets and the bench smoke workloads, clean and with the
  mutation check's seeded plans, partitions, run plans and forged indexes,
  and for the halo contracts at 4 slabs.
* C6, re-based from the TPU's VMEM budget to the H100's shared memory a
  block, has its own cases: the opt-in limit, both layouts of the self-join
  kernel at four dtypes, a wide Jaccard vocabulary, a mirror out of step.
* Each lint rule on a flagged and a clean snippet; the port's tree shows no
  finding beyond ``scripts/analysis_baseline_torch.json``, and no accepted
  key is stale; the static no-retrace key sets equal JAX's.
* ``scripts/mutation_check_torch.py`` and ``python -m repro_torch.analysis``
  exit 0 in subprocesses.

Both packages read empty measured tables (``torch_workloads.both_tables``),
so every class launches the default 128-row tile.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.analysis import contracts as jc
from repro.analysis import lint as jl
from repro.core import grid as jgrid
from repro.core import query_join as jqj
from repro_torch.analysis import contracts as tc
from repro_torch.analysis import findings as tfind
from repro_torch.analysis import lint as tl
from repro_torch.analysis.__main__ import (DEFAULT_BASELINE,
                                           canned_datasets,
                                           collect_findings)
from repro_torch.core import grid as tgrid
from repro_torch.core import query_join as tqj
from repro_torch.kernels import fused_join as tfj
from torch_workloads import SMOKE, both_tables, syn
from torch_workloads import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parent.parent
CPU = "cpu"
DATASETS = dict({tag: (pts, eps) for tag, pts, eps in canned_datasets()},
                **SMOKE)
C6_RULES = ("vmem-budget", "smem-budget")


@pytest.fixture(autouse=True, scope="module")
def empty_tables(tmp_path_factory):
    with both_tables(tmp_path_factory.mktemp("tables")):
        yield


_INDEXES = {}


def indexes(name):
    """(JAX index, port index) of a dataset, built once."""
    if name not in _INDEXES:
        pts, eps = DATASETS[name]
        _INDEXES[name] = (jgrid.build_grid_host(pts, float(eps)),
                          tgrid.build_grid(pts, float(eps), device=CPU))
    return _INDEXES[name]


def keys(found):
    return sorted(f.key for f in found if f.rule not in C6_RULES)


# ---------------------------------------------------------------------------
# the prover against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(DATASETS))
def test_rederivations_match_jax(name):
    ji, ti = indexes(name)
    for merged in (False, True):
        np.testing.assert_array_equal(
            tc.recompute_cell_caps(ti, merged),
            jc.recompute_cell_caps(ji, merged))
    assert tc.recompute_external_cap(ti) == jc.recompute_external_cap(ji)
    np.testing.assert_array_equal(tc._oracle_cell_of_row(ti),
                                  jc._oracle_cell_of_row(ji))
    assert tc.key_dtype(ti) == np.dtype(ji.key_dtype)


@pytest.mark.parametrize("name", sorted(DATASETS))
def test_index_contract_keys_match_jax(name):
    ji, ti = indexes(name)
    got = tc.prove_index_contracts(ti, tag=f"index:{name}")
    want = jc.prove_index_contracts(ji, tag=f"index:{name}")
    assert keys(got) == keys(want)
    assert not [f for f in got if f.rule == "smem-budget"]


HALO = {"auto": {}, "one-hop": {"k_hops": 1}, "capacity": {"halo_capacity": 1}}


@pytest.mark.parametrize("variant", sorted(HALO))
@pytest.mark.parametrize("name", sorted(DATASETS))
def test_halo_contract_keys_match_jax(name, variant):
    pts, eps = DATASETS[name]
    kw = HALO[variant]
    got = tc.prove_halo_contracts(pts, float(eps), 4, tag=f"halo:{name}",
                                  **kw)
    want = jc.prove_halo_contracts(pts, float(eps), 4, tag=f"halo:{name}",
                                   **kw)
    assert keys(got) == keys(want)
    if variant == "capacity":
        assert got


def _plans(mod, index, merged):
    """The mutation check's tampered plans, built alike for either
    package's ``BucketPlan`` (``mod``: a grid module)."""
    plan = mod.occupancy_plan(index, merged=merged)
    npts = int(index.num_points)
    rows = np.arange(npts, dtype=np.int32)
    half = npts // 2
    return {
        "undersized": mod.BucketPlan(caps=(8,), sel=(None,),
                                     cap_global=plan.cap_global,
                                     hist={8: npts}),
        "duplicate-row": mod.BucketPlan(
            caps=(plan.cap_global, plan.cap_global),
            sel=(rows[:half + 1], rows[half:]), cap_global=plan.cap_global,
            hist={}),
        "unaligned": mod.BucketPlan(caps=(plan.cap_global + 3,), sel=(None,),
                                    cap_global=plan.cap_global, hist={}),
        "descending": mod.BucketPlan(
            caps=(plan.cap_global, 8), sel=(rows[:half], rows[half:]),
            cap_global=plan.cap_global, hist={}),
        "ceiling": mod.BucketPlan(caps=(plan.cap_global * 2,), sel=(None,),
                                  cap_global=plan.cap_global, hist={}),
    }


@pytest.mark.parametrize("mutation", ["undersized", "duplicate-row",
                                      "unaligned", "descending", "ceiling"])
@pytest.mark.parametrize("name", ["clustered-3d", "clustered-2d", "expo-3d"])
def test_seeded_plan_keys_match_jax(name, mutation):
    ji, ti = indexes(name)
    found = []
    for merged in (False, True):
        jp = _plans(jgrid, ji, merged)[mutation]
        tp = _plans(tgrid, ti, merged)[mutation]
        tiles = {int(c): 128 for c in tp.caps}
        got = (tc.check_window_caps(ti, merged=merged, plan=tp, tag="m")
               + tc.check_slot_base(ti, merged=merged, plan=tp, tiles=tiles,
                                    tag="m"))
        want = (jc.check_window_caps(ji, merged=merged, plan=jp, tag="m")
                + jc.check_slot_base(ji, merged=merged, plan=jp, tiles=tiles,
                                     tag="m"))
        assert keys(got) == keys(want)
        found += got
    # the canned clustered set is skewed enough for every seeded plan
    assert found or name != "clustered-3d"


def _run_ords(index_rank, npts, tq=128):
    """A healthy run plan of the whole range and its corruptions."""
    qp = -(-npts // tq) * tq
    rank = np.asarray(index_rank)[np.minimum(np.arange(qp), npts - 1)]
    clean = tgrid.cell_run_plan(torch.from_numpy(rank.astype(np.int64)),
                                tq).run_ord.numpy()
    ro = clean.reshape(-1, tq)
    cells = rank.reshape(-1, tq)
    t = int(np.flatnonzero(ro.max(axis=1) > 0)[0])
    merged, no_reset, step, split = (ro.copy() for _ in range(4))
    merged[t][merged[t] >= 1] -= 1            # two cells share a run
    no_reset[1, 0] = 1                        # the tile does not reset
    step[t][step[t] >= 1] += 1                # an ordinal skips
    r = int(np.flatnonzero(cells[t, 1:] == cells[t, :-1])[0]) + 1
    split[t, r:] += 1                         # a cell split across runs
    return {"clean": clean, "merged-run": merged.reshape(-1),
            "no-reset": no_reset.reshape(-1), "step": step.reshape(-1),
            "split-cell": split.reshape(-1)}


@pytest.mark.parametrize("corruption", ["clean", "merged-run", "no-reset",
                                        "step", "split-cell"])
@pytest.mark.parametrize("name", ["clustered-3d", "clustered-2d"])
def test_run_plan_keys_match_jax(name, corruption):
    ji, ti = indexes(name)
    ro = _run_ords(ti.point_cell_rank.numpy(), ti.num_points)[corruption]
    got = tc.check_run_plan(ti, run_ord=ro, tq=128, tag="m")
    want = jc.check_run_plan(ji, run_ord=ro, tq=128, tag="m")
    assert keys(got) == keys(want)
    assert bool(got) == (corruption != "clean")


@pytest.mark.parametrize("forgery", ["probe-headroom", "key-dtype",
                                     "thin-dimension"])
def test_forged_index_keys_match_jax(forgery):
    ji, ti = indexes("clustered-3d")
    if forgery == "probe-headroom":
        # volume 2^31 - 2: int32 keys, a sentinel margin of 2
        jf = dataclasses.replace(
            ji, dims=jnp.asarray([2, 2**30 - 1], jnp.int64),
            cell_keys=ji.cell_keys.astype(jnp.int32))
        tf = dataclasses.replace(
            ti, dims=torch.tensor([2, 2**30 - 1], dtype=torch.int64),
            cell_keys=ti.cell_keys.to(torch.int32))
    elif forgery == "key-dtype":
        jf = dataclasses.replace(ji, cell_keys=ji.cell_keys.astype(jnp.int64))
        tf = dataclasses.replace(ti, cell_keys=ti.cell_keys.to(torch.int64))
    else:
        dims = [2, 500, 500]
        jf = dataclasses.replace(ji, dims=jnp.asarray(dims, jnp.int64))
        tf = dataclasses.replace(ti, dims=torch.tensor(dims,
                                                       dtype=torch.int64))
    for check in ("check_key_sentinel", "check_device_sentinel"):
        got = getattr(tc, check)(tf, tag="forged")
        want = getattr(jc, check)(jf, tag="forged")
        assert keys(got) == keys(want)
    assert keys(tc.check_key_sentinel(tf, tag="forged")
                + tc.check_device_sentinel(tf, tag="forged"))


# ---------------------------------------------------------------------------
# C6, re-based: shared memory a block
# ---------------------------------------------------------------------------

def test_smem_constants():
    assert tc.SMEM_OPTIN_H100 == 227 * 1024
    assert tfj.SMEM_DEFAULT == 48 * 1024
    src = (REPO / "src/repro_torch/kernels/csrc/fused_join.cu").read_text()
    assert "smem > 48 * 1024" in src
    assert "cudaFuncAttributeMaxDynamicSharedMemorySize" in src


@pytest.mark.parametrize("layout,points", [("spread", 3000),
                                           ("tile", 96 * 128 + 500)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.float16, torch.bfloat16])
def test_smem_self_kernel_layouts(layout, points, dtype):
    """The mirror equals a tile's rows on launches of SPREAD_TILES tiles or
    more, stays within them below, and fits the limit; a limit below a
    launch's need is reported."""
    pts = torch.from_numpy(syn(points, 3, seed=11) / 100).to(dtype)
    index = tgrid.build_grid(pts, 0.02, device=CPU)
    plan = tgrid.occupancy_plan(index, merged=True)
    launch_tiles = -(-int(index.num_points) // 128)
    assert (launch_tiles >= tfj.SPREAD_TILES) == (layout == "tile")
    assert plan.sel[0] is None
    assert tc.check_smem(index, merged=True) == []
    need = tc.self_smem_need(128, 3, True, pts.element_size())
    mirror = tfj.self_stage_bytes(launch_tiles * 128, 128, plan.caps[0], 3,
                                  True, False, pts.element_size())
    assert (mirror == need) == (layout == "tile") and mirror <= need
    low = tc.check_smem(index, merged=True, limit=need - 1)
    assert [f.site for f in low] == [f"index:c{plan.caps[0]}:t128"]


@pytest.mark.parametrize("n_feat,flagged", [(16, False), (816, False),
                                            (824, True), (4096, True)])
def test_smem_jaccard_vocabulary(n_feat, flagged):
    """A Jaccard vocabulary of 16 x n_feat tokens: a 128-row query tile's
    records pass the opt-in limit past 13,056 tokens (n_feat 816)."""
    sizes = np.sort(np.random.default_rng(2).integers(1, 64, 300))
    index = tgrid.build_grid(sizes.astype(np.float32)[:, None], 1.0,
                             device=CPU)
    n_classes = len(tgrid.occupancy_plan(index).caps)
    need = tc.jaccard_smem_need(128, n_feat)
    assert need == tfj.shared_bytes(128, tfj.packed_width(n_feat), True)
    assert (need > tc.SMEM_OPTIN_H100) == flagged
    for found in (tc.check_smem(index, merged=False, metric="jaccard",
                                n_feat=n_feat, tag="jaccard"),
                  [f for f in tc.prove_index_contracts(
                      index, metric="jaccard", n_feat=n_feat, tag="jaccard")
                   if f.rule == "smem-budget"]):
        assert [f.rule for f in found] == ["smem-budget"] * (
            n_classes * flagged)
        assert not any(f.site.endswith(":mirror") for f in found)


def test_smem_mirror_out_of_step(monkeypatch):
    _, ti = indexes("uniform-2d")
    real = tfj.self_stage_bytes
    monkeypatch.setattr(tfj, "self_stage_bytes",
                        lambda *a: real(*a) + 10 ** 6)
    found = tc.check_smem(ti, merged=True, tag="mirror")
    assert [f.site.endswith(":mirror") for f in found] == [True]


# ---------------------------------------------------------------------------
# the linter
# ---------------------------------------------------------------------------

OPS = "src/repro_torch/kernels/ops.py"
FJ = "src/repro_torch/kernels/fused_join.py"
SJ = "src/repro_torch/core/selfjoin.py"
GRID = "src/repro_torch/core/grid.py"
METRIC = "src/repro_torch/core/metric.py"

SNIPPETS = {
    "compile-in-function": (SJ, "import torch\ndef f(x):\n"
                                "    g = torch.compile(lambda y: y)\n"
                                "    return g(x)\n",
                            "per-call-compile"),
    "script-decorator-in-function": (
        SJ, "import torch\ndef f(x):\n    @torch.jit.script\n"
            "    def g(y):\n        return y\n    return g(x)\n",
        "per-call-compile"),
    "partial-compile-in-function": (
        SJ, "import functools, torch\ndef f(x):\n"
            "    return functools.partial(torch.compile, mode='x')(x)\n",
        "per-call-compile"),
    "compile-at-module-level": (SJ, "import torch\n@torch.compile\n"
                                    "def g(y):\n    return y\n"
                                    "h = torch.jit.script(g)\n", None),
    "item-in-ops": (OPS, "def fused_join_hits(c):\n"
                         "    return c.max().item()\n", "host-sync"),
    "cpu-in-wrapper": (FJ, "def _fused_join_hits_cuda(c):\n"
                           "    return c.cpu()\n", "host-sync"),
    "synchronize-in-launch": (FJ, "import torch\ndef _launch(c):\n"
                                  "    torch.cuda.synchronize()\n",
                              "host-sync"),
    "cast-in-wrapper": (FJ, "def fused_join_hits(c):\n"
                            "    return int(c)\n", "host-sync-cast"),
    "item-off-the-launch-path": (SJ, "def total(c):\n"
                                     "    return c.sum().item()\n", None),
    "item-in-plain-helper": (FJ, "def pad_width(n):\n"
                                 "    return int(n.item())\n", None),
    "cast-of-literal": (OPS, "def fused_join_hits(c):\n"
                             "    return int(3)\n", None),
    "iinfo-int64": (SJ, "import torch\ndef f():\n"
                        "    return torch.iinfo(torch.int64).max\n",
                    "int64-key-literal"),
    "int64-max-literal": (SJ, "def f():\n"
                              "    return 9223372036854775807\n",
                          "int64-key-literal"),
    "int64-key-dtype": (SJ, "import torch\ndef f():\n"
                            "    kd = torch.int64\n    return kd\n",
                        "int64-key-literal"),
    "int64-key-dtype-keyword": (SJ, "import numpy as np\ndef f(g):\n"
                                    "    return g(key_dtype=np.int64)\n",
                                "int64-key-literal"),
    "int64-in-key-dtype-owner": (GRID, "import numpy as np\n"
                                       "def device_key_dtype(d):\n"
                                       "    kd = np.dtype(np.int64)\n"
                                       "    return kd\n", None),
    "int64-not-a-key": (SJ, "import torch\ndef f(c):\n"
                            "    return c.sum(dtype=torch.int64)\n", None),
    "eps-squared": (SJ, "def f(d2, eps):\n    return d2 <= eps * eps\n",
                    "eps-squared-predicate"),
    "eps-power": (SJ, "def f(d2, eps):\n    return d2 <= eps ** 2\n",
                  "eps-squared-predicate"),
    "eps-squared-in-owner": (METRIC, "def f(d2, eps):\n"
                                     "    return d2 <= eps * eps\n", None),
    "steps-squared": (SJ, "def f(steps):\n    return steps * steps\n", None),
}


@pytest.mark.parametrize("name", sorted(SNIPPETS))
def test_lint_rule(name):
    path, text, rule = SNIPPETS[name]
    found = tl.lint_source(text, path)
    assert [f.rule for f in found] == ([rule] if rule else [])
    if rule == "host-sync-cast":
        assert found[0].severity == "warning"


def test_tree_has_no_new_findings_and_no_stale_keys():
    found = collect_findings(device=CPU)
    baseline = tfind.load_baseline(DEFAULT_BASELINE)
    assert [f.render() for f in tfind.new_findings(found, baseline)] == []
    assert baseline <= {f.key for f in found}
    assert all(f.severity == "warning" for f in found)


@pytest.mark.parametrize("name", [tag for tag, _, _ in canned_datasets()])
def test_no_retrace_keys_match_jax(name):
    ji, ti = indexes(name)
    jp, tp = jqj.prepare(ji), tqj.prepare(ti)
    assert (tp.c, tp.classes, tp.bucketed) == (jp.c, tuple(jp.classes),
                                               jp.bucketed)
    sizes = (1, 3, 32, 128, 200, 700)
    for m in sizes:
        for keep in (True, False):
            assert tl.fused_launch_keys(tp, m, keep) == \
                jl.fused_launch_keys(jp, m, keep)
    assert tl.warmed_launch_keys(tp, [1, 128, 512]) == \
        jl.warmed_launch_keys(jp, [1, 128, 512])
    for warm in (None, [32]):
        got = tl.check_no_retrace(tp, max_batch=256, request_sizes=sizes,
                                  warm_sizes=warm, tag=name)
        want = jl.check_no_retrace(jp, max_batch=256, request_sizes=sizes,
                                   warm_sizes=warm, tag=name)
        assert keys(got) == keys(want)
    assert tl.count_distinct_lowerings(tp, sizes) == \
        jl.count_distinct_lowerings(jp, sizes)


@pytest.mark.parametrize("command", ["mutation-check", "cli"])
def test_scripts_exit_zero(command, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    report = tmp_path / "report.json"
    argv = {"mutation-check": [str(REPO / "scripts/mutation_check_torch.py"),
                               "--device", "cpu"],
            "cli": ["-m", "repro_torch.analysis", "--device", "cpu",
                    "--json", str(report)]}[command]
    proc = subprocess.run([sys.executable, *argv], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    if command == "cli":
        assert "0 new" in proc.stdout
        assert json.loads(report.read_text())["findings"]
    else:
        assert "mutation check: OK" in proc.stdout
