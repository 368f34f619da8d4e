"""syncs (a call, program counter): the host's waits for the device a call
of the program's self-join, ``host_syncs / calls`` of
``repro_torch.core.join_events()`` (core/grid.py::JOIN_EVENTS) over every
call the run's process made; None where the program has no such counter or
made no call (as under the control's wrapper)."""
from portbench import counters


def read(record):
    events = counters.join_events()
    if not events or not events["calls"]:
        return None
    return events["host_syncs"] / events["calls"]
