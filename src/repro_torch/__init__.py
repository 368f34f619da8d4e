"""repro_torch -- the epsilon self-join of Gowanlock & Karsin (2018) in
PyTorch, with its kernels written in CUDA for Hopper.

A port of the JAX package ``repro`` (which stays the reference), slice by
slice. The joins take ``metric="l2" | "cosine" | "jaccard"``; the metric
trait (canonicalization, token packing, oracles) is ``repro_torch.core.metric``,
as ``repro.core.metric`` is the JAX package's. This package imports torch and numpy only; it never imports JAX or
anything of ``repro``. Entry points run on CUDA unless the caller passes
``device="cpu"``, where the kernels' plain PyTorch versions run instead.
"""
from repro_torch.core import (GridIndex, JoinStats, brute_force_count,
                              brute_force_join, build_grid, epsilon_join,
                              per_point_neighbor_counts, prepare,
                              range_query, self_join, self_join_batched,
                              self_join_count, self_join_count_compact)

__all__ = ["BatchingJoinService", "GridIndex", "JoinService", "JoinStats",
           "brute_force_count", "brute_force_join", "build_grid",
           "epsilon_join", "per_point_neighbor_counts", "prepare",
           "range_query", "self_join", "self_join_batched", "self_join_count",
           "self_join_count_compact"]


def __getattr__(name):
    # the services load on first use, so ``python -m
    # repro_torch.launch.serve`` does not find its module already imported
    if name in ("BatchingJoinService", "JoinService"):
        from repro_torch.launch import serve
        return getattr(serve, name)
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")
