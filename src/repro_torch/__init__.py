"""repro_torch -- the epsilon self-join of Gowanlock & Karsin (2018) in
PyTorch, with its kernels written in CUDA for Hopper.

A port of the JAX package ``repro`` (which stays the reference), slice by
slice. This package imports torch and numpy only; it never imports JAX or
anything of ``repro``. Entry points run on CUDA unless the caller passes
``device="cpu"``, where the kernels' plain PyTorch versions run instead.
"""
from repro_torch.core import (GridIndex, JoinStats, brute_force_count,
                              brute_force_join, build_grid, self_join,
                              self_join_batched, self_join_count)

__all__ = ["GridIndex", "JoinStats", "brute_force_count", "brute_force_join",
           "build_grid", "self_join", "self_join_batched", "self_join_count"]
