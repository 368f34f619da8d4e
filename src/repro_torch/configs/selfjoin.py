"""The paper's own workload as a selectable 'architecture'.

Shapes mirror the paper's datasets (Table I): |D| in {2M, 10M}, n in 2-6,
uniform [0,100]^n (the grid index's worst case, paper SVI-C). The
distributed step is core/distributed.py's slab join; the mesh's first axis
(pod x data flattened to 'slab') partitions space, 'model' parallelizes
stencil offsets.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class SelfJoinConfig:
    name: str = "selfjoin"
    n_dims: int = 6
    eps: float = 2.0
    n_points: int = 2_000_000
    unicomp: bool = True
    halo_frac: float = 0.25     # halo capacity as fraction of slab size
    max_per_cell: int = 64
    dtype: str = "float64"      # the paper's precision


CONFIG = SelfJoinConfig()
REDUCED = SelfJoinConfig(name="selfjoin-reduced", n_points=4096, eps=5.0,
                         max_per_cell=32)

# dry-run cells for the self-join workload: (name, n_points, n_dims, eps)
SHAPES = (
    ("syn2d2m", 2_000_000, 2, 1.0),
    ("syn6d2m", 2_000_000, 6, 2.0),
    ("syn2d10m", 10_000_000, 2, 0.4),
    ("syn6d10m", 10_000_000, 6, 1.5),
)
