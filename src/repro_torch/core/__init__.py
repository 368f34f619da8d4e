"""Grid index, stencils, refine predicate, self-join and query-join drivers.

Public API, as the JAX package's ``repro.core`` names it:
    build_grid                            -- the epsilon-grid index (paper SIV)
    self_join, self_join_count            -- grid join with UNICOMP (SV-B);
                                             distance_impl "fused" (kernel
                                             B1), or the unfused sweep,
                                             "jnp" (plain) / "pallas" (B4)
    self_join_count_compact               -- count with empty-neighbour
                                             compaction (route "compact")
    self_join_batched                     -- result-set batching (SV-A)
    per_point_neighbor_counts             -- per-point neighbour counts
                                             (the DBSCAN building block)
    brute_force_join, brute_force_count   -- GPU brute-force baseline (SVI-B)
    epsilon_join, prepare, range_query    -- external-query joins against an
                                             index built once
    distributed_self_join,                -- the slab join in one process:
    distributed_self_join_count              equal-count slabs, an eps-halo,
                                             global ids in kernel B1's masks
    rtree_join / ego_join                 -- CPU baselines (paper SVI-B),
                                             numpy on the host
    join_events                           -- (the port's own) the self-join
                                             path's counters
                                             (calls, host syncs, the emit's
                                             slots and hits)
"""
from repro_torch.core.baselines import ego_join, rtree_join
from repro_torch.core.brute import brute_force_count, brute_force_join
from repro_torch.core.distributed import (distributed_self_join,
                                          distributed_self_join_count)
from repro_torch.core.grid import GridIndex, build_grid, join_events
from repro_torch.core.query_join import epsilon_join, prepare
from repro_torch.core.selfjoin import (JoinStats, per_point_neighbor_counts,
                                       range_query, self_join,
                                       self_join_batched, self_join_count,
                                       self_join_count_compact)

__all__ = ["GridIndex", "JoinStats", "build_grid", "self_join",
           "self_join_count", "self_join_count_compact", "self_join_batched",
           "per_point_neighbor_counts", "brute_force_count",
           "brute_force_join", "epsilon_join", "prepare", "range_query",
           "distributed_self_join", "distributed_self_join_count",
           "rtree_join", "ego_join", "join_events"]
