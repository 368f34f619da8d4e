"""Hand-written CUDA kernels of the port, each beside its plain version.

distance_tile.py -- brute-force hits and count tiles (kernels B2, B3)
fused_join.py    -- fused gather-refine sweep (kernel B1)
ops.py           -- the dispatch layer the drivers call
build.py         -- nvcc build and ctypes loading of ``csrc/*.cu``
"""
from repro_torch.kernels.ops import (distance_tile_counts, distance_tile_hits,
                                     fused_join_hits)

__all__ = ["distance_tile_counts", "distance_tile_hits", "fused_join_hits"]
