"""emit_ms (ms a call, device trace): device time of the kernels, copies
and fills that the host queued inside the program's ``self_join.emit``
spans (core/selfjoin.py::_emit_from_hits, sort_pairs), each operation
placed by the runtime call that launched it."""


def read(record):
    t = record.trace
    if t is None:
        return None
    ms = t.device_ms_launched_in("self_join.emit")
    return ms if ms else None
