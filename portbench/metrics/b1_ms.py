"""b1_ms (ms a call, device trace): device time of the kernels named
``fused_join_kernel*`` (kernels/csrc/fused_join.cu via
kernels/fused_join.py)."""

KERNEL = "fused_join_kernel"


def read(record):
    t = record.trace
    if t is None:
        return None
    ms = t.device_ms(KERNEL)
    return ms if ms > 0 else None
