"""Hand-written CUDA kernels of the port, each beside its plain version.

distance_tile.py -- brute-force hits and count tiles (kernels B2, B3)
cell_join.py     -- the unfused sweep's candidate refine (kernel B4)
fused_join.py    -- fused gather-refine sweep (kernel B1)
emit_pairs.py    -- the self-join's emit: a hit plane into its pairs
ops.py           -- the dispatch layer the drivers call
build.py         -- nvcc build and ctypes loading of ``csrc/*.cu``
"""
from repro_torch.kernels.ops import (cell_join_hits, distance_tile_counts,
                                     distance_tile_hits, fused_join_hits)

__all__ = ["cell_join_hits", "distance_tile_counts", "distance_tile_hits",
           "fused_join_hits"]
