"""The program's own counters, for the per-layer metrics that read them.

``join_events()`` is ``repro_torch.core.join_events()`` (the self-join
path's ``calls``, ``host_syncs``, ``emit_slots`` and ``emit_hits``, counted
over every call the run's process made), read from the program the harness
has already imported; None where the program is not imported or has no
such counter.
"""
import sys


def join_events():
    snapshot = getattr(sys.modules.get("repro_torch.core"), "join_events",
                       None)
    return snapshot() if snapshot is not None else None
