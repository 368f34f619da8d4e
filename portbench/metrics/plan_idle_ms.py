"""plan_idle_ms (ms a call, program span): the device's idle time while the
host plans: the idle gaps of ``trace.breakdown`` whose innermost host span
is the program's ``self_join.plan`` or one of its ``self_join.plan.*``
children (core/selfjoin.py, core/grid.py), a call. A gap under a
``host_sync`` span inside planning is the host waiting for the device, not
planning, and is not counted."""
from portbench import trace as trace_lib

PLAN = "self_join.plan"


def read(record):
    t = record.trace
    if t is None or not any(n == PLAN for n, _, _ in t.spans):
        return None
    # a top that keeps every span name
    gaps = trace_lib.breakdown(t, top=len(t.spans) + 1)["idle_gaps"]
    return 1e3 * sum(s for name, s in gaps
                     if name == PLAN or name.startswith(PLAN + "."))
