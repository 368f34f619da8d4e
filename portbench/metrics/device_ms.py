"""device_ms (ms a call, device trace): the union of device activity over
the traced calls, a call: the whole call's device time, which bounds what
any one kernel's or stage's gain can give, and reads steadier than the
host-clock times."""


def read(record):
    t = record.trace
    if t is None or t.busy_s <= 0:
        return None
    return t.busy_s * 1e3 / t.calls
