"""The port's CPU baselines (ROADMAP A16) against the JAX package's.

``rtree_join`` and ``ego_join`` are numpy copies in ``repro_torch.core``:
their counts and sorted pairs must equal ``repro.core.baselines``'
exactly, and both must equal the port's grid join on the CPU, as
``tests/test_selfjoin.py::test_baselines_agree`` holds the JAX package's.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.core import baselines as jbase
from repro.core.selfjoin import self_join_count as jax_self_join_count
from repro_torch import core as tcore
from repro_torch.core import baselines as tbase
from torch_workloads import SMOKE, one_torch_thread  # noqa: F401

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def _random(n):
    return np.random.default_rng(7 + n).uniform(0, 10, (300, n)), 0.8


def _both(pts, eps, **kw):
    """(port, JAX) results of both baselines with pairs."""
    return ({"rtree": tbase.rtree_join(pts, eps, return_pairs=True, **kw),
             "ego": tbase.ego_join(pts, eps, return_pairs=True)},
            {"rtree": jbase.rtree_join(pts, eps, return_pairs=True, **kw),
             "ego": jbase.ego_join(pts, eps, return_pairs=True)})


def _check(pts, eps):
    port, jax_ = _both(pts, eps)
    pairs = tcore.self_join(pts, eps, device="cpu")
    pairs = pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))]
    total = tcore.self_join_count(pts, eps, device="cpu").total_pairs
    for name in ("rtree", "ego"):
        (t_n, t_p), (j_n, j_p) = port[name], jax_[name]
        assert t_n == j_n == total == len(pairs), name
        assert np.array_equal(t_p, j_p), name
        assert np.array_equal(t_p, pairs), name
        assert tbase.__dict__[f"{name}_join"](pts, eps) == total
    return total


@pytest.mark.parametrize("n", [2, 3, 4])
def test_baselines_match_jax_random(n):
    pts, eps = _random(n)
    assert _check(pts, eps) > 0


@pytest.mark.parametrize("workload", ["uniform-2d", "expo-3d"])
def test_baselines_match_jax_bench_smoke(workload):
    pts, eps = SMOKE[workload]
    assert _check(pts, eps) > 0


def test_recorded_a16_total():
    """chip_smoke.py's A16_TOTAL: the JAX package's count on the bench's
    expo-3d at its smoke size, which the card's lm phase holds both
    baselines and the card's count to."""
    import chip_smoke as cs

    pts = cs.expo(cs.A16_POINTS, 3)
    assert np.array_equal(pts, SMOKE["expo-3d"][0])
    assert jax_self_join_count(pts, cs.A16_EPS).total_pairs == cs.A16_TOTAL
    assert tbase.ego_join(pts, cs.A16_EPS) == cs.A16_TOTAL


@pytest.mark.parametrize("n", [2, 3])
def test_empty_input(n):
    pts = np.zeros((0, n))
    for mod in (tbase, jbase):
        assert mod.rtree_join(pts, 0.5) == 0
        assert mod.ego_join(pts, 0.5) == 0
        for fn in (mod.rtree_join, mod.ego_join):
            total, pairs = fn(pts, 0.5, return_pairs=True)
            assert total == 0 and pairs.shape == (0, 2)


def test_return_pairs_ordering():
    """Pairs come back ordered by (first, second), unique, excluding self,
    and symmetric; the leaf and block sizes change none of that."""
    pts = np.random.default_rng(11).uniform(0, 5, (400, 2))
    eps = 0.4
    ref = None
    for kw in ({}, {"leaf_size": 5}):
        total, pairs = tbase.rtree_join(pts, eps, return_pairs=True, **kw)
        assert total == len(pairs) > 0
        ref = pairs if ref is None else ref
        assert np.array_equal(pairs, ref)
    for block in (64, 7, 1000):
        total, pairs = tbase.ego_join(pts, eps, block=block,
                                      return_pairs=True)
        assert np.array_equal(pairs, ref)
        assert total == jbase.ego_join(pts, eps, block=block)
    order = np.lexsort((ref[:, 1], ref[:, 0]))
    assert np.array_equal(order, np.arange(len(ref)))
    assert len(np.unique(ref, axis=0)) == len(ref)
    assert not np.any(ref[:, 0] == ref[:, 1])
    assert {tuple(p) for p in ref} == {(b, a) for a, b in ref}


def test_exported_from_core():
    assert tcore.rtree_join is tbase.rtree_join
    assert tcore.ego_join is tbase.ego_join
    assert {"rtree_join", "ego_join"} <= set(tcore.__all__)
