"""The work that a kernel's roofline share is held to, counted from the
inputs and the result alone, never from the program's index or launches, so
that no change to the grid, the stencil or the tiles can make it stale.

B1, the fused join kernel of an L2 self-join of ``n`` points in ``d``
dimensions with ``ordered_pairs`` ordered result pairs:

- bytes: every point read once (``n * d * item``) and one int32 count a
  point written once (``n * 4``);
- operations: 3 a dimension (subtract, multiply, add) for each unordered
  result pair, which UNICOMP evaluates once.
"""
from portbench import hardware


def b1_work(n: int, d: int, ordered_pairs: int, item: int = 8):
    """(bytes, flops) of B1's least work for one join."""
    nbytes = n * d * item + n * 4
    flops = 3 * d * (ordered_pairs // 2)
    return nbytes, flops


def bound_s(nbytes: int, flops: int) -> float:
    """The least time the card could take: the larger of bytes over HBM
    bandwidth and FP64 operations over the FP64 peak."""
    return max(nbytes / hardware.HBM_BYTES_PER_S,
               flops / hardware.FP64_FLOPS_PER_S)
