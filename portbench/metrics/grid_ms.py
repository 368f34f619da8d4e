"""grid_ms (ms a call, program span): host time inside the program's
``self_join.grid`` span (core/selfjoin.py: the grid build,
core/grid.py::build_grid via _resolve_index)."""


def read(record):
    t = record.trace
    if t is None or not any(n == "self_join.grid" for n, _, _ in t.spans):
        return None
    return t.span_ms("self_join.grid")
