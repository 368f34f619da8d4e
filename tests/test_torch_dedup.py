"""The port's dedup operator (``repro_torch.data.dedup``) and its examples,
held to the JAX package on the CPU.

``embed_ngrams`` is numpy on both sides and must match bit for bit; the
keep masks of ``dedup_batch`` and ``dedup_embeddings`` (each cluster keeps
its lowest id; rows the guard refuses are kept and flagged) must equal the
JAX functions' on the planted batches of ``tests/test_data.py``, and the
device-side min-label propagation must equal JAX's union-find on random
pair graphs. The three torch examples run with ``--device cpu`` and pass
their own asserts; none imports JAX or the JAX package.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.data import dedup as jdd
from repro_torch.data import dedup as tdd
from torch_workloads import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parent.parent
CPU = "cpu"


@pytest.mark.parametrize("n_dims,n,n_hash,seed", [
    (4, 2, 64, 1234), (6, 2, 64, 1234), (2, 3, 32, 7), (5, 1, 128, 99)])
def test_embed_ngrams_bit_for_bit(n_dims, n, n_hash, seed):
    tokens = np.random.default_rng(seed).integers(0, 5000, (40, 96))
    got = tdd.embed_ngrams(tokens, n_dims=n_dims, n=n, n_hash=n_hash,
                           seed=seed)
    want = jdd.embed_ngrams(tokens, n_dims=n_dims, n=n, n_hash=n_hash,
                            seed=seed)
    assert got.dtype == want.dtype == np.float64
    assert np.array_equal(got.view(np.int64), want.view(np.int64))


@pytest.mark.parametrize("seed", range(6))
def test_keep_from_pairs_matches_union_find(seed):
    """Random graphs of chains, stars and isolated ids, as ordered pairs in
    both directions (the join's form) and in one: the lowest id of each
    connected cluster survives, as in JAX's union-find."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 300))
    k = int(rng.integers(0, 2 * n))
    a = rng.integers(0, n, k)
    b = np.where(rng.random(k) < 0.5, (a + 1) % n, rng.integers(0, n, k))
    one_way = np.stack([a, b], 1).astype(np.int32)
    both = np.concatenate([one_way, one_way[:, ::-1]])
    for pairs in (one_way, both):
        want = jdd._keep_from_pairs(n, pairs)
        got = tdd._keep_from_pairs(n, torch.from_numpy(
            np.ascontiguousarray(pairs)))
        assert got.dtype == np.bool_ and np.array_equal(got, want)


def test_dedup_batch_matches_jax_on_planted_batches():
    """``test_data.py``'s planted exact duplicates and a 4-copy cluster."""
    rng = np.random.default_rng(1)
    base = rng.integers(0, 1000, (6, 128))
    rng2 = np.random.default_rng(2)
    doc = rng2.integers(0, 1000, (1, 128))
    batches = [np.concatenate([base, base[:3]]),
               np.concatenate([doc] * 4 + [rng2.integers(0, 1000, (2, 128))])]
    for batch, kept in zip(batches, (6, 3)):
        for unicomp in (True, False):
            got = tdd.dedup_batch(batch, eps=0.05, unicomp=unicomp,
                                  device=CPU)
            assert np.array_equal(got, jdd.dedup_batch(batch, eps=0.05,
                                                       unicomp=unicomp))
            assert got.sum() == kept


def test_guard_embeddings_matches_jax():
    emb = np.array([[1.0, 0.0], [0.0, 0.0], [np.nan, 1.0],
                    [np.inf, 0.5], [0.3, -0.4], [-0.0, 0.0]])
    got = tdd.guard_embeddings(emb)
    assert np.array_equal(got, jdd.guard_embeddings(emb))
    assert np.array_equal(got, [True, False, False, False, True, False])


def test_dedup_embeddings_matches_jax():
    """Scaled copies (cosine catches them, L2 would not), and exact copies
    beside a zero and a NaN row, which are kept and flagged."""
    rng = np.random.default_rng(3)
    base = rng.normal(size=(6, 5))
    scaled = np.concatenate([base, 7.5 * base[:3]])
    rng = np.random.default_rng(4)
    good = rng.normal(size=(5, 4))
    bad = np.concatenate([good, good[:2], np.zeros((1, 4)),
                          np.full((1, 4), np.nan)])
    for emb, kept, n_valid in ((scaled, 6, 9), (bad, 7, 7)):
        keep, valid = tdd.dedup_embeddings(emb, min_cos=0.999, device=CPU)
        jkeep, jvalid = jdd.dedup_embeddings(emb, min_cos=0.999)
        assert np.array_equal(keep, jkeep) and np.array_equal(valid, jvalid)
        assert keep.sum() == kept and valid.sum() == n_valid
    none_valid = np.zeros((3, 4))
    keep, valid = tdd.dedup_embeddings(none_valid, device=CPU)
    assert keep.all() and not valid.any()


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("example", ["torch_quickstart", "torch_serve_join",
                                     "torch_dedup_pipeline"])
def test_torch_example_runs_on_cpu(example):
    """The example imports neither JAX nor the JAX package, and passes its
    asserts with ``--device cpu``."""
    path = ROOT / "examples" / f"{example}.py"
    assert not set(_imported_roots(path)) & {"jax", "jaxlib", "repro"}
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, str(path), "--device", CPU],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "device=cuda" not in proc.stdout
