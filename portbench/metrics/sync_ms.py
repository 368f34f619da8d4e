"""sync_ms (ms a call, program span): host time inside the program's
``host_sync`` spans (core/grid.py::host_sync), their overlaps once: the
host waiting for the device on the self-join path, at a read of a device
value or a copy from pageable host memory."""

SPAN = "host_sync"


def read(record):
    t = record.trace
    if t is None or not any(n == SPAN for n, _, _ in t.spans):
        return None
    return t.span_ms(SPAN)
