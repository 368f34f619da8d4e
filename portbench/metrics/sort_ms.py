"""sort_ms (ms a call, device trace): device time of the kernels, copies
and fills that the host queued inside the program's ``self_join.emit.sort``
spans (core/selfjoin.py::sort_pairs, the sort of the result), each
operation placed by the runtime call that launched it, as ``emit_ms``
places the emit's."""

SPAN = "self_join.emit.sort"


def read(record):
    t = record.trace
    if t is None or not any(n == SPAN for n, _, _ in t.spans):
        return None
    return t.device_ms_launched_in(SPAN)
