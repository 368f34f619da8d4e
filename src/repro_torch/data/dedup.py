"""Near-duplicate removal by the epsilon self-join.

The counterpart of ``repro.data.dedup``. Documents are sketched into a low
dimensional space (hashed n-gram counts, then a fixed random projection to
2-6 dimensions, the regime the paper targets), the self-join finds every
pair within eps, and each cluster of near-duplicates keeps its lowest id.
``dedup_embeddings`` does the same on raw embedding rows under cosine
similarity, after quarantining rows the cosine join cannot take.

The joins run through ``repro_torch.self_join`` on ``device`` (CUDA by
default; ``device="cpu"`` runs the plain versions), and the clusters are
found there too, by min-label propagation over the join's pairs. Inputs and
the returned masks are numpy arrays, as the JAX package's are.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.selfjoin import self_join


def embed_ngrams(tokens: np.ndarray, n_dims: int = 4, n: int = 2,
                 n_hash: int = 64, seed: int = 1234) -> np.ndarray:
    """(B, S) int tokens -> (B, n_dims) float64 document sketch: hashed
    n-gram counts (``n_hash`` buckets, L2-normalized) through a fixed
    Gaussian projection to ``n_dims``. Near-identical documents land within
    a small eps of each other; unrelated ones do not. The JAX package's
    numpy arithmetic, bit for bit."""
    B, S = tokens.shape
    t = tokens.astype(np.int64)
    grams = t[:, : S - n + 1].copy()
    for k in range(1, n):
        grams = grams * 1000003 + t[:, k : S - n + 1 + k]
    buckets = (grams % n_hash).astype(np.int64)
    counts = np.zeros((B, n_hash), np.float64)
    rows = np.repeat(np.arange(B), buckets.shape[1])
    np.add.at(counts, (rows, buckets.reshape(-1)), 1.0)
    norms = np.linalg.norm(counts, axis=1, keepdims=True)
    counts /= np.maximum(norms, 1e-12)
    proj = np.random.Generator(np.random.Philox(key=seed)).normal(
        size=(n_hash, n_dims)) / np.sqrt(n_dims)
    return counts @ proj


def _keep_from_pairs(n: int, pairs: torch.Tensor) -> np.ndarray:
    """Keep-mask of ``n`` ids joined by ``pairs``: each connected cluster
    keeps its lowest id (a chain a~b~c keeps one), the JAX package's
    union-find answer.

    Min-label propagation on the pairs' device: every id starts as its own
    label, takes the least label across each pair and then its label's
    label. A label is always an id of the same cluster no larger than the
    id; at the fixed point it is constant over a cluster and its own label,
    so it is the cluster's lowest id."""
    labels = torch.arange(n, device=pairs.device)
    a, b = pairs[:, 0].long(), pairs[:, 1].long()
    while pairs.shape[0]:
        new = labels.scatter_reduce(0, a, labels[b], reduce="amin")
        new = new.scatter_reduce(0, b, labels[a], reduce="amin")
        new = new[new]
        if torch.equal(new, labels):
            break
        labels = new
    return (labels == torch.arange(n, device=labels.device)).cpu().numpy()


def dedup_batch(tokens: np.ndarray, *, eps: float = 0.05, n_dims: int = 4,
                unicomp: bool = True, device=None) -> np.ndarray:
    """Boolean keep-mask over the batch; duplicate clusters keep one doc."""
    emb = embed_ngrams(tokens, n_dims=n_dims)
    pairs = self_join(emb, eps, unicomp=unicomp, device=device)
    return _keep_from_pairs(tokens.shape[0], pairs)


def guard_embeddings(emb: np.ndarray) -> np.ndarray:
    """Boolean mask of rows the cosine join can take: finite in every lane
    and of nonzero norm. A failed encoder emits exactly the others (all
    zero on a timeout, NaN on an overflow), which cosine
    canonicalization refuses by design."""
    emb = np.asarray(emb)
    finite = np.isfinite(emb).all(axis=1)
    norms = np.where(finite, np.abs(emb).sum(axis=1), 0.0)
    return finite & (norms > 0.0)


def dedup_embeddings(emb: np.ndarray, *, min_cos: float = 0.98,
                     unicomp: bool = True, device=None):
    """Cosine near-duplicate removal over raw embedding rows.

    Returns ``(keep, valid)`` boolean masks. ``valid`` marks the rows the
    guard admitted to the join; the others are kept (their similarity is
    unknown, and dropping data on an encoder fault is worse) and flagged
    ``valid=False`` for a retry. Among valid rows every cluster with
    pairwise cosine similarity >= ``min_cos`` keeps its lowest id: the
    cosine self-join (unit rows, then the grid join at the equal chord
    radius)."""
    emb = np.asarray(emb, np.float64)
    valid = guard_embeddings(emb)
    keep = np.ones(emb.shape[0], bool)
    idx = np.flatnonzero(valid)
    if idx.size:
        pairs = self_join(emb[idx], float(min_cos), unicomp=unicomp,
                          metric="cosine", device=device)
        keep[idx] = _keep_from_pairs(idx.size, pairs)
    return keep, valid
