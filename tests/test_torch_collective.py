"""The collective slab join (``repro_torch.launch.mesh`` and a ``SlabMesh``
in ``repro_torch.core.distributed``), held to the JAX package on the CPU.

Gloo ranks run through ``mesh.spawn`` inside one subprocess with a timeout
(the rank workers are ``torch_collective_ranks.py``): 2 and 4 slabs, and a
(2, 2) ``(slab, model)`` mesh. A second subprocess with four placeholder
JAX devices computes JAX's ``make_halo_step`` blocks,
``distributed_self_join`` and ``distributed_self_join_count`` at 2 and 4
slabs, the (2, 2) offset-parallel count and the halo-overflow flag of
``make_distributed_count_step``. Both start when the module starts. Zero
tolerance: every rank's block equals JAX's field by field, and every rank
returns JAX's sorted pairs and totals.
"""
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import selfjoin as jsj
from repro_torch.core import distributed as td
from repro_torch.core import selfjoin as tsj
from repro_torch.launch import mesh as tmesh
from torch_workloads import clustered, expo, syn
from torch_workloads import one_torch_thread  # noqa: F401  (autouse)

TESTS = Path(__file__).resolve().parent
SRC = TESTS.parent / "src"
CPU = "cpu"
# test_torch_distributed.py's plans: the skewed one takes 2 hops at 4 slabs
PLANS = {
    "uniform": (syn(600, 2, seed=1) / 10, 0.5),
    "skew": (expo(800, 3, seed=7) / 10, 0.6),
}
# JAX's test_halo_overflow_detected: eps far past a slab's width
OVER = (np.random.default_rng(3).uniform(0, 1.0, size=(800, 2)), 0.5)
TINY = (syn(3, 2, seed=3) / 10, 0.5)        # 3 points on 4 slabs
CROWD = (clustered(600, 2, seed=2) / 10, 0.3)   # cells past 8 points
EMB = np.random.default_rng(8).normal(size=(500, 4))
# float16 ids are exact up to 2,048 (ROADMAP §C, C3)
PROBE = (np.random.default_rng(0).random((3000, 2)) * 20).astype(np.float16)
SLABS = (2, 4)


def _cases(n_slabs):
    """The cases every rank of an (n_slabs, 1) mesh runs."""
    cases = []
    for name, (pts, eps) in PLANS.items():
        cases += [(f"{name}/block", "block", pts, eps, {}),
                  (f"{name}/pairs", "pairs", pts, eps, {}),
                  (f"{name}/count_only", "count_only", pts, eps, {}),
                  (f"{name}/count", "count", pts, eps, {})]
    over_pts, over_eps = OVER
    cases += [
        ("over/step", "count_step", over_pts, over_eps,
         dict(halo_capacity=4, max_per_cell=64)),
        ("over/count", "count", over_pts, over_eps, dict(halo_capacity=4)),
        ("over/pairs", "pairs", over_pts, over_eps, dict(halo_capacity=4)),
        ("over/cell", "count", *CROWD, dict(max_per_cell=1)),
        ("wrong_size", "wrong_size", None, None, {})]
    if n_slabs == 2:
        cases += [
            ("cosine", "pairs", EMB, 0.9, dict(metric="cosine")),
            ("cosine/count", "count", EMB, 0.9, dict(metric="cosine")),
            ("jaccard", "pairs", [[1, 2, 3], [2, 3, 4], [5]], 0.5,
             dict(metric="jaccard")),
            ("f16", "pairs", PROBE[:2049], 2.0, {}),
            ("f16/refused", "pairs", PROBE, 2.0, {}),
            ("bf16", "pairs",
             torch.from_numpy(PROBE[:257].astype(np.float32)).to(
                 torch.bfloat16), 2.0, {})]
    else:
        cases += [("tiny", "pairs", *TINY, {}),
                  ("tiny/count", "count", *TINY, {})]
    return cases


def _model_cases():
    """The (2, 2) mesh's cases: the offset-parallel count, UNICOMP on and
    off, and the fused counts."""
    cases = []
    for name, (pts, eps) in PLANS.items():
        for uni in (True, False):
            cases.append((f"{name}/model/{int(uni)}", "count", pts, eps,
                          dict(unicomp=uni, model_axis="model")))
        cases += [(f"{name}/count", "count", pts, eps, {}),
                  (f"{name}/count_only", "count_only", pts, eps, {}),
                  (f"{name}/pairs", "pairs", pts, eps, {})]
    return cases


TORCH_CODE = textwrap.dedent("""
    import pickle, sys
    import torch_collective_ranks as ranks
    from repro_torch.launch import mesh
    cases = pickle.load(open(sys.argv[1], "rb"))
    out = {}
    for key, (n_slabs, n_model) in (("2", (2, 1)), ("4", (4, 1)),
                                     ("2x2", (2, 2))):
        out[key] = mesh.spawn(ranks.cases_rank, n_slabs * n_model, n_slabs,
                              n_model, cases[key], device="cpu",
                              timeout_s=90)
    try:
        mesh.spawn(ranks.overflow_rank, 2, *cases["raise"], device="cpu",
                   timeout_s=60)
    except RuntimeError as err:
        out["raised"] = f"{type(err).__name__}: {err}"
    out["cli"] = mesh.main(["--slabs", "2", "--device", "cpu", "--points",
                            "3000", "--eps", "2.0"])
    pickle.dump(out, open(sys.argv[2], "wb"))
""")

JAX_CODE = textwrap.dedent("""
    import sys
    import numpy as np
    import jax
    import jax.numpy as jnp
    from repro.core import distributed as jd
    from repro.launch.mesh import make_mesh_compat, make_slab_mesh
    data = dict(np.load(sys.argv[1]))
    out = {}
    for name in ("uniform", "skew"):
        pts, eps = data[name + "/pts"], float(data[name + "/eps"])
        n = pts.shape[1]
        for n_slabs in (2, 4):
            mesh = make_slab_mesh(n_slabs)
            coords, gids, _ = jd.partition_points_host(pts, n_slabs)
            mins, maxs = jd.slab_extents(coords, gids)
            k = jd.halo_reach(mins, maxs, eps)
            need = jd.exact_halo_capacity(coords, gids, mins, maxs, eps, k)
            h = min(jd._next_pow2(need), coords.shape[1])
            cfg = jd.DistJoinConfig(
                pts_per_device=coords.shape[1], n_dims=n, halo_capacity=h,
                max_per_cell=0, model_axis=None, k_hops=k)
            step, sh = jd.make_halo_step(mesh, cfg)
            blocks = step(jax.device_put(coords.reshape(-1, n), sh[0]),
                          jax.device_put(gids.reshape(-1), sh[1]),
                          jnp.asarray(eps, pts.dtype))
            key = f"{name}/{n_slabs}/"
            for f, x in zip(("cand_c", "cand_g", "cand_v", "cand_o"), blocks):
                out[key + f] = np.asarray(x).reshape(n_slabs, -1, *x.shape[1:])
            out[key + "halo_of"] = np.asarray(blocks[4])
            out[key + "pairs"] = jd.distributed_self_join(pts, eps, mesh)
            out[key + "count"] = np.asarray(
                jd.distributed_self_join_count(pts, eps, mesh))
        grid = make_mesh_compat((2, 2), ("slab", "model"))
        for uni in (True, False):
            out[f"{name}/model/{int(uni)}"] = np.asarray(
                jd.distributed_self_join_count(pts, eps, grid, unicomp=uni,
                                               model_axis="model"))
    over, eps = data["over/pts"], float(data["over/eps"])
    mesh = make_slab_mesh(4)
    coords, gids, _ = jd.partition_points_host(over, 4)
    cfg = jd.DistJoinConfig(pts_per_device=coords.shape[1], n_dims=2,
                            halo_capacity=4, max_per_cell=64,
                            model_axis=None)
    step, sh = jd.make_distributed_count_step(mesh, cfg)
    _, halo_of, _ = step(jax.device_put(coords.reshape(-1, 2), sh[0]),
                         jax.device_put(gids.reshape(-1), sh[1]),
                         jnp.asarray(eps, over.dtype))
    out["over/halo_of"] = np.asarray(halo_of)
    for n_slabs in (2, 4):
        try:
            jd.distributed_self_join_count(over, eps, make_slab_mesh(n_slabs),
                                           halo_capacity=4)
        except RuntimeError as err:
            out[f"over/{n_slabs}/msg"] = np.asarray(str(err))
    np.savez(sys.argv[2], **out)
""")


def _started(code, args, env):
    return subprocess.Popen([sys.executable, "-c", code, *map(str, args)],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module", autouse=True)
def runs(tmp_path_factory):
    """``get(side)``: the torch ranks' results ("torch") or JAX's arrays
    ("jax"), each from its subprocess, waited for at first use."""
    d = tmp_path_factory.mktemp("collective")
    with open(d / "cases.pkl", "wb") as f:
        pickle.dump({"2": _cases(2), "4": _cases(4), "2x2": _model_cases(),
                     "raise": PLANS["uniform"]}, f)
    np.savez(d / "jax_in.npz",
             **{f"{k}/{f}": v for k, plan in dict(PLANS, over=OVER).items()
                for f, v in zip(("pts", "eps"), plan)})
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(SRC),
                                                       str(TESTS)]))
    procs = {
        "torch": (_started(TORCH_CODE, (d / "cases.pkl", d / "torch.pkl"),
                           env), d / "torch.pkl"),
        "jax": (_started(JAX_CODE, (d / "jax_in.npz", d / "jax.npz"),
                         dict(env, XLA_FLAGS="--xla_force_host_platform_"
                                             "device_count=4")),
                d / "jax.npz")}
    cache = {}

    def get(side):
        if side not in cache:
            proc, path = procs[side]
            _, err = proc.communicate(timeout=480)
            assert proc.returncode == 0, err[-3000:]
            cache[side] = (pickle.loads(path.read_bytes()) if side == "torch"
                           else dict(np.load(path)))
        return cache[side]

    yield get
    for proc, _ in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def _every_rank(runs, key, name):
    """Case ``name``'s result on every rank of the ``key`` spawn."""
    return [r[name] for r in runs("torch")[key]]


def _same_error(results, *fragments):
    """Every rank raised, with one message holding every fragment."""
    assert all(isinstance(r, str) for r in results), results
    assert len(set(results)) == 1, results
    for frag in fragments:
        assert frag in results[0], results[0]
    return results[0]


def test_backend_rule():
    """gloo unless every rank has a card of its own; an explicit backend
    wins; nccl with too few cards, or on the CPU, raises."""
    assert tmesh.choose_backend(2, CPU) == "gloo"
    assert tmesh.choose_backend(4, CPU, "gloo") == "gloo"
    with pytest.raises(ValueError, match="nccl"):
        tmesh.choose_backend(2, CPU, "nccl")
    if not torch.cuda.is_available():
        assert tmesh.choose_backend(2) == "gloo"
        with pytest.raises(ValueError, match="nccl"):
            tmesh.choose_backend(1, None, "nccl")


def test_spawn_refuses_missing_card_before_starting_ranks():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmesh.spawn(print, 2)


def test_model_axis_needs_a_model_mesh():
    """``model_axis`` with a slab count, with a mesh of one model index, or
    under another name, raises before any collective."""
    pts, eps = PLANS["uniform"]
    one = tmesh.SlabMesh(None, 2, 1, 0, torch.device(CPU), "gloo")
    two = tmesh.SlabMesh(None, 2, 2, 0, torch.device(CPU), "gloo")
    for mesh, axis in ((2, "model"), (one, "model"), (two, "slab")):
        with pytest.raises(ValueError, match="model_axis"):
            td.distributed_self_join_count(pts, eps, mesh, model_axis=axis,
                                           device=None if mesh != 2
                                           else CPU)
    assert (one.slab, two.slab, two.model) == (0, 0, 0)
    assert tmesh.SlabMesh(None, 2, 2, 3, torch.device(CPU),
                          "gloo").peer(0) == 1


@pytest.mark.parametrize("workload", PLANS)
@pytest.mark.parametrize("n_slabs", SLABS)
def test_rank_blocks_match_jax_halo_step(runs, workload, n_slabs):
    """Each rank's candidate block equals block s of JAX's
    ``make_halo_step``, field by field, dtypes included, and
    ``candidate_blocks`` gives the step's block."""
    jax_out = runs("jax")
    key = f"{workload}/{n_slabs}/"
    ranks = runs("torch")[str(n_slabs)]
    assert sorted(r["slab"] for r in ranks) == list(range(n_slabs))
    for r in ranks:
        got = r[f"{workload}/block"]
        assert not isinstance(got, str), got
        for f in ("cand_c", "cand_g", "cand_v", "cand_o"):
            want = jax_out[key + f][r["slab"]]
            assert got[f].dtype == want.dtype, f
            assert np.array_equal(got[f], want), (f, r["slab"])
        assert not got["halo_of"] and not jax_out[key + "halo_of"]
        assert bool(got["blocks_match"])
        assert r["backend"] == "gloo"


@pytest.mark.parametrize("workload", PLANS)
@pytest.mark.parametrize("n_slabs", SLABS)
def test_rank_pairs_and_counts_match_jax(runs, workload, n_slabs):
    """Every rank returns JAX's ``distributed_self_join`` pairs, and its
    count-only and plain-sweep totals equal JAX's."""
    jax_out = runs("jax")
    key = f"{workload}/{n_slabs}/"
    want = jax_out[key + "pairs"]
    assert want.shape[0] > 0
    for r in runs("torch")[str(n_slabs)]:
        got = r[f"{workload}/pairs"]
        assert got.dtype == np.int32 and np.array_equal(got, want)
        assert int(r[f"{workload}/count_only"]) == want.shape[0]
        assert int(r[f"{workload}/count"]) == int(jax_out[key + "count"])


@pytest.mark.parametrize("workload", PLANS)
@pytest.mark.parametrize("unicomp", [True, False])
def test_model_axis_count_matches_jax(runs, workload, unicomp):
    """On a (2, 2) ``(slab, model)`` mesh the offset-parallel count equals
    JAX's ``model_axis="model"`` count on every rank; without the axis,
    and the fused count and pairs, give JAX's 2-slab answers."""
    jax_out = runs("jax")
    ranks = runs("torch")["2x2"]
    assert [(r["slab"], r["model"]) for r in ranks] == [(0, 0), (0, 1),
                                                        (1, 0), (1, 1)]
    want = int(jax_out[f"{workload}/model/{int(unicomp)}"])
    for r in ranks:
        assert int(r[f"{workload}/model/{int(unicomp)}"]) == want
        if unicomp:
            assert want == int(jax_out[f"{workload}/2/count"])
            assert int(r[f"{workload}/count"]) == want
            assert int(r[f"{workload}/count_only"]) == want
            assert np.array_equal(r[f"{workload}/pairs"],
                                  jax_out[f"{workload}/2/pairs"])


@pytest.mark.parametrize("n_slabs", SLABS)
def test_halo_overflow_raises_on_every_rank(runs, n_slabs):
    """At halo capacity 4 (JAX's ``test_halo_overflow_detected``) the count
    step's flag is set on every rank, as JAX's is; the count and the pair
    join raise JAX's message on every rank, and none hangs. A window C
    below a cell's points raises on every rank too."""
    jax_out = runs("jax")
    ranks = runs("torch")[str(n_slabs)]
    assert bool(jax_out["over/halo_of"])
    for r in ranks:
        assert not isinstance(r["over/step"], str), r["over/step"]
        assert bool(r["over/step"][1])
    msg = _same_error([r["over/count"] for r in ranks],
                      "halo capacity overflow")
    assert msg == "RuntimeError: " + str(jax_out[f"over/{n_slabs}/msg"])
    _same_error([r["over/pairs"] for r in ranks], "halo capacity overflow")
    _same_error([r["over/cell"] for r in ranks], "max_per_cell overflow")


def test_spawn_raises_a_rank_error_in_the_caller(runs):
    assert runs("torch")["raised"].startswith(
        "RuntimeError: halo capacity overflow")


def test_mesh_refuses_a_wrong_group_size(runs):
    for key in ("2", "4"):
        _same_error(_every_rank(runs, key, "wrong_size"), "ValueError",
                    "ranks, the group has")


def test_more_slabs_than_points(runs):
    """3 points on 4 ranks: an empty slab's rank joins nothing, and every
    rank returns the brute-force pairs."""
    pts, eps = TINY
    want = tsj.self_join(pts, eps, device=CPU).numpy()
    for r in runs("torch")["4"]:
        assert np.array_equal(r["tiny"], want)
        assert int(r["tiny/count"]) == want.shape[0]


def test_cosine_on_two_ranks(runs):
    want = jsj.self_join(EMB, 0.9, metric="cosine", distance_impl="fused")
    assert want.shape[0] > 0
    for r in runs("torch")["2"]:
        assert np.array_equal(r["cosine"], want)
        assert int(r["cosine/count"]) == want.shape[0]


def test_jaccard_raises_on_every_rank(runs):
    _same_error(_every_rank(runs, "2", "jaccard"), "NotImplementedError",
                "jaccard")


def test_half_points_below_the_id_limit(runs):
    """Float16 and bfloat16 points cross gloo as their raw bits: at the
    largest exact ids every rank returns the one-process join's pairs;
    past them every rank refuses (C3)."""
    mine = tsj.self_join(PROBE[:2049], 2.0, device=CPU).numpy()
    bf = torch.from_numpy(PROBE[:257].astype(np.float32)).to(torch.bfloat16)
    mine_bf = td.distributed_self_join(bf, 2.0, 2, device=CPU).numpy()
    for r in runs("torch")["2"]:
        assert np.array_equal(r["f16"], mine)
        assert np.array_equal(r["bf16"], mine_bf)
    _same_error(_every_rank(runs, "2", "f16/refused"), "ValueError", "C3")


def test_mesh_cli(runs):
    """``python -m repro_torch.launch.mesh`` (its ``main``) on two gloo
    ranks gives the one-process join's pair count."""
    out = runs("torch")["cli"]
    pts = np.random.default_rng(0).uniform(0, 100, (3000, 2))
    assert out["pairs"] == tsj.self_join(pts, 2.0, device=CPU).shape[0]
    assert out["backend"] == "gloo" and out["devices"] == ["cpu"]
