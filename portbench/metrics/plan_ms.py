"""plan_ms (ms a call, program span): host time inside the program's
``self_join.plan`` spans (core/grid.py plans and tables,
core/selfjoin.py::_fused_launches, _launch_prep)."""


def read(record):
    t = record.trace
    if t is None or not any(n == "self_join.plan" for n, _, _ in t.spans):
        return None
    return t.span_ms("self_join.plan")
