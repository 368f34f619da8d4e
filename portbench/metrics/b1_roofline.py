"""b1_roofline (%, device trace): B1's least time over its device time (the
kernels named ``fused_join_kernel*``), over the traced calls. The least time
is ``work.bound_s`` of ``work.b1_work``, counted from the inputs and the
result alone, at the H100's published rates (``hardware``)."""
from portbench import work

KERNEL = "fused_join_kernel"


def read(record):
    t = record.trace
    if t is None:
        return None
    ms = t.device_ms(KERNEL)
    if ms <= 0:
        return None
    bound_s = sum(work.bound_s(*work.b1_work(c["n"], c["d"], c["pairs"]))
                  for c in t.work) / t.calls
    return 100.0 * bound_s * 1e3 / ms
