"""Grid index, stencils, refine predicate and self-join drivers."""
