"""CPU tests of the benchmark harness: the manifest and the pieces it names,
the work counts, the reference, and a whole run at a small size.

The runs here drive the program's plain PyTorch path on the CPU
(``device="cpu"``) at a few thousand points; the card's runs are the
benchmark's own (``portbench/run.py``).
"""
import json
import math
import re
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import harness, trace as trace_lib, work
from portbench.references import l2_grid

ROOT = Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SMALL = {"syn2d2m": {"points": 3000, "eps": 2.5},
         "syn6d2m": {"points": 2000, "eps": 30.0}}
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def small_run(workload, *, trace=False, root=ROOT, seed=2**31 + 5,
              wrap=None, overrides=None):
    config = workload.split(".")[0]
    return harness.run_cell(root, workload, seed=seed, seconds=0.3,
                            trace=trace, device="cpu", wrap=wrap,
                            overrides=overrides or SMALL.get(config))


def test_manifest_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for x in BENCH[key]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cells_find_their_pieces_by_name(cell):
    spec = harness.resolve(ROOT, cell)
    assert spec.cell["chips"] == 1
    assert len(spec.cell["why"]) <= 200
    for kind, name in (("generators", spec.config["generator"]),
                       ("references", spec.config["reference"]),
                       ("drivers", spec.traffic["driver"]),
                       ("checks", spec.traffic["check"])):
        assert harness.load_module(ROOT, kind, name) is not None
    reported = [m["name"] for m in harness.cell_metrics(BENCH, cell,
                                                        "end_to_end")]
    assert "setup_s" in reported and len(reported) >= 2
    layers = harness.cell_metrics(BENCH, cell, "per_layer")
    assert layers
    assert all(m["moves"] in reported for m in layers)
    for m in layers + harness.cell_metrics(BENCH, cell, "end_to_end"):
        assert callable(harness.load_module(ROOT, "metrics", m["name"]).read)


@pytest.mark.parametrize("config", BENCH["configs"],
                         ids=lambda c: c["name"])
def test_config_files_lie_under_paths(config):
    path = ROOT / config["file"]
    assert path.is_file() and config["file"].startswith("portbench/")
    data = json.loads(path.read_text())
    assert data["name"] == config["name"]
    assert config["reduced"] == []
    assert data["dtype"] == "float64" and data["assumed"]


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        harness.resolve(ROOT, "no.such.cell")


def test_b1_work_by_hand():
    # 10 points in 2-D, 6 ordered pairs: 10*2*8 + 10*4 bytes, 3*2*3 flops
    assert work.b1_work(10, 2, 6) == (200, 18)
    assert work.bound_s(200, 18) == max(200 / 3.35e12, 18 / 34e12)
    # 2 M points in 2-D, 50 M ordered pairs: the bytes bound it
    nbytes, flops = work.b1_work(2_000_000, 2, 50_000_000)
    assert nbytes == 40_000_000 and flops == 150_000_000
    assert math.isclose(work.bound_s(nbytes, flops), 40e6 / 3.35e12)


@pytest.mark.parametrize("d,n,eps", [(1, 200, 1.0), (2, 400, 7.0),
                                     (3, 300, 15.0), (6, 250, 45.0)])
def test_reference_against_a_double_loop(d, n, eps):
    gen = torch.Generator().manual_seed(d)
    pts = torch.rand((n, d), generator=gen, dtype=torch.float64) * 100
    got = l2_grid.pair_keys(pts, eps, chunk=97).tolist()
    p = pts.numpy()
    want = []
    for i in range(n):
        for j in range(n):
            s = 0.0
            for k in range(d):
                t = p[i, k] - p[j, k]
                s = s + t * t
            if i != j and s <= eps * eps:
                want.append(i * n + j)
    assert want and got == sorted(want)


@pytest.mark.parametrize("chunk", [1, 2, 1 << 26])
def test_pair_check_by_hand(chunk):
    from portbench.checks import pair_set
    ref = torch.tensor([1 * 5 + 2, 2 * 5 + 1, 3 * 5 + 4, 4 * 5 + 3])

    def check(rows, sorted_expected=True):
        return pair_set.compare(
            torch.tensor(rows, dtype=torch.int32).reshape(-1, 2), ref, 5,
            sorted_expected=sorted_expected, chunk=chunk)

    assert check([[1, 2], [2, 1], [3, 4], [4, 3]]) == {
        "order_breaks": 0, "extra_pairs": 0, "missing_pairs": 0}
    # a repeat, and a row out of order
    assert check([[1, 2], [2, 1], [3, 4], [4, 3], [4, 3]]) == {
        "order_breaks": 1, "extra_pairs": 1, "missing_pairs": 0}
    assert check([[1, 2], [2, 1], [3, 4]])["missing_pairs"] == 1
    # a self pair and an id out of range, each out of order
    assert check([[2, 1], [1, 2], [3, 4], [4, 3], [0, 0], [7, 1]]) == {
        "order_breaks": 2, "extra_pairs": 2, "missing_pairs": 0}
    assert check([[2, 1], [1, 2], [3, 4], [4, 3]], False) == {
        "extra_pairs": 0, "missing_pairs": 0}
    assert pair_set.compare(torch.tensor([[1, 2]]), ref[:0], 5,
                            sorted_expected=True, chunk=chunk) == {
        "order_breaks": 0, "extra_pairs": 1, "missing_pairs": 0}


def test_trace_reduction_by_hand():
    t = trace_lib.Trace(
        calls=2, window_s=10e-6,
        spans=[(trace_lib.STRETCH, 0.0, 10.0), ("portbench.call", 1.0, 9.0),
               ("self_join.plan", 2.0, 5.0), ("self_join.plan", 4.0, 6.0)],
        device_ops=[("void fused_join_kernel_self<double>", 1.0, 2.0, 0.5),
                    ("sort", 6.0, 8.0, 4.5), ("fill", 7.0, 9.0, 8.0)])
    assert t.span_ms("self_join.plan") == 4.0 / 1e3 / 2
    assert t.device_ms("fused_join_kernel") == 1.0 / 1e3 / 2
    assert trace_lib.union_us([(s, e) for _, s, e, _ in t.device_ops]) == 4.0
    # queued inside planning: the sort (launched at 4.5), 2 us over 2 calls
    assert t.device_ms_launched_in("self_join.plan") == 2.0 / 1e3 / 2
    assert t.device_ms_launched_in("self_join.emit") == 0.0
    gaps = dict(trace_lib.breakdown(t)["idle_gaps"])
    # 0-1 and 9-10 outside the call, 2-6 in the planning span opened last
    assert gaps == {trace_lib.STRETCH: 2e-6 / 2, "self_join.plan": 4e-6 / 2}


@pytest.mark.parametrize("trace", [False, True])
def test_last_line_keys(trace):
    result, lines = small_run("syn2d2m.join", trace=trace)
    keys = list(result)
    assert keys[:5] == RESULT_KEYS and keys[-1] == "checks"
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] >= 1
    assert set(result["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    section = "per_layer" if trace else "end_to_end"
    allowed = {m["name"] for m in harness.cell_metrics(
        BENCH, "syn2d2m.join", section)}
    assert set(result["metrics"]) <= allowed
    if trace:
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"grid_ms", "plan_ms"} <= set(result["metrics"])
    else:
        assert set(result["metrics"]) == allowed - {"peak_gb"}
    for name, v in result["checks"].items():
        assert set(v) == {"value", "limit"}
        assert f"check {name}: {v['value']} (limit {v['limit']})" in lines
    json.dumps(result)


def test_six_dimensions_small():
    result, _ = small_run("syn6d2m.join")
    assert result["correct"] is True
    assert result["checks"]["missing_pairs"]["value"] == 0


def test_a_new_cell_is_new_files_alone(tmp_path):
    """A configuration, a traffic mix and a per-layer metric added as files,
    with their entries in the manifest, run without an edit elsewhere."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "src").symlink_to(ROOT / "src")
    bench = json.loads(json.dumps(BENCH))
    config = json.loads((ROOT / "portbench/configs/syn2d2m.json").read_text())
    config.update(name="tiny3d", dims=3, points=2500, eps=6.0)
    (tmp_path / "portbench/configs/tiny3d.json").write_text(json.dumps(config))
    traffic = json.loads((ROOT / "portbench/traffic/join.json").read_text())
    traffic.update(kwargs={"sort_result": False}, sorted=False)
    (tmp_path / "portbench/traffic/join_unsorted.json").write_text(
        json.dumps(traffic))
    (tmp_path / "portbench/metrics/pairs_a_call.py").write_text(
        "def read(record):\n"
        "    p = record.window.pairs\n"
        "    return sum(p) / len(p) if p else None\n")
    bench["configs"].append({"name": "tiny3d", "source": "a test",
                             "file": "portbench/configs/tiny3d.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny3d.join_unsorted",
                               "config": "tiny3d", "traffic": "join_unsorted",
                               "chips": 1, "why": "a test"})
    join_s = next(m for m in bench["end_to_end"] if m["name"] == "join_s")
    join_s["workloads"].append("tiny3d.join_unsorted")
    bench["per_layer"].append({"name": "pairs_a_call", "unit": "pairs",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "Emit", "moves": "join_s",
                               "workloads": ["tiny3d.join_unsorted"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    result, _ = small_run("tiny3d.join_unsorted", trace=True, root=tmp_path,
                          overrides={})
    assert result["correct"] is True
    assert result["metrics"]["pairs_a_call"]["value"] > 0
    assert "order_breaks" not in result["checks"]
    result, _ = small_run("tiny3d.join_unsorted", root=tmp_path,
                          overrides={})
    assert {"join_s", "setup_s"} <= set(result["metrics"])


QUERY_DRIVER = """
import time
from types import SimpleNamespace

import torch


def run(entry, *, config, traffic, seed, seconds, trace, device, t0, load,
        builds):
    gen = torch.Generator().manual_seed(seed)
    d, eps = int(config["dims"]), float(config["eps"])
    points = torch.rand((int(config["points"]), d), generator=gen,
                        dtype=torch.float64) * 100
    queries = torch.rand((int(traffic["queries"]), d), generator=gen,
                         dtype=torch.float64) * 100
    setup_builds = builds()
    start = time.perf_counter()
    setup_s = start - t0
    out = entry(queries, points, eps, device=device)
    win = SimpleNamespace(
        calls=1, elapsed_s=time.perf_counter() - start,
        process_peak_bytes=0, join_peak_bytes=0,
        setup_builds=setup_builds, builds=builds() - setup_builds,
        kept=[(dict(queries=queries, points=points, eps=eps),
               torch.as_tensor(out.pairs))])
    return setup_s, win, None
"""

QUERY_REFERENCE = """
import torch


def query_keys(queries, points, eps):
    d2 = ((queries[:, None, :] - points[None, :, :]) ** 2).sum(-1)
    q, j = torch.nonzero(d2 <= eps * eps, as_tuple=True)
    return torch.sort(q * points.shape[0] + j).values
"""

QUERY_CHECK = """
import torch

LIMITS = {"wrong_pairs": 0}


def numbers(inputs, result, *, reference, traffic):
    points = inputs["points"]
    want = reference.query_keys(inputs["queries"], points, inputs["eps"])
    got = result.to(torch.int64)
    got = torch.sort(got[:, 0] * points.shape[0] + got[:, 1]).values
    if got.shape != want.shape:
        return {"wrong_pairs": abs(got.numel() - want.numel())}
    return {"wrong_pairs": int((got != want).sum())}
"""


def test_a_new_entry_is_new_files_alone(tmp_path):
    """A traffic whose entry takes other arguments (queries against an
    index), with its own driver, reference and check, added as files."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "src").symlink_to(ROOT / "src")
    pb = tmp_path / "portbench"
    config = json.loads((pb / "configs/syn2d2m.json").read_text())
    config.update(name="tinyq", dims=2, points=1500, eps=3.0,
                  reference="query_brute")
    (pb / "configs/tinyq.json").write_text(json.dumps(config))
    (pb / "traffic/queries.json").write_text(json.dumps(
        {"driver": "queries_once", "entry": "epsilon_join",
         "check": "query_pairs", "queries": 300}))
    (pb / "drivers/queries_once.py").write_text(QUERY_DRIVER)
    (pb / "references/query_brute.py").write_text(QUERY_REFERENCE)
    (pb / "checks/query_pairs.py").write_text(QUERY_CHECK)
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "tinyq", "source": "a test",
                             "file": "portbench/configs/tinyq.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tinyq.queries", "config": "tinyq",
                               "traffic": "queries", "chips": 1,
                               "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    result, lines = small_run("tinyq.queries", root=tmp_path, overrides={})
    assert result["correct"] is True
    assert result["checks"]["wrong_pairs"] == {"value": 0, "limit": 0}
    assert "check wrong_pairs: 0 (limit 0)" in lines
    assert result["metrics"]["setup_s"]["value"] > 0
    wrong, _ = small_run(
        "tinyq.queries", root=tmp_path, overrides={},
        wrap=lambda entry: lambda q, p, eps, **kw: entry(q, p, eps / 2, **kw))
    assert wrong["correct"] is False


def test_no_program_no_run(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    with pytest.raises(SystemExit):
        harness.import_program(tmp_path)


def test_no_card_no_result(monkeypatch, capsys):
    from portbench import run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    # run.main sets the allocator's settings; restored after the test
    monkeypatch.setenv("PYTORCH_CUDA_ALLOC_CONF", "")
    assert run.main(["--workload", "syn2d2m.join", "--seed", "1",
                     "--seconds", "1", "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""


def test_call_seeds_are_fixed_and_distinct():
    from portbench.data import call_seed
    seeds = [call_seed(s, c) for s in (0, 7, 2**31 + 3, 2**40)
             for c in range(4)]
    assert len(set(seeds)) == len(seeds)
    assert all(0 <= s < 2**63 for s in seeds)
    assert call_seed(7, 3) == call_seed(7, 3)
    assert call_seed(-1, 0) == call_seed(2**64 - 1, 0)
    assert isinstance(np.uint64(call_seed(5, 1)), np.uint64)
