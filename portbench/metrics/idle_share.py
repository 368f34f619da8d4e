"""idle_share (share, device trace): 1 - the union of device activity over
the traced stretch's length by the host clock."""


def read(record):
    t = record.trace
    if t is None or t.busy_s <= 0:
        return None
    return 1.0 - t.busy_s / t.window_s
