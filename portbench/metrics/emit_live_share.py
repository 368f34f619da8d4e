"""emit_live_share (share, program counter): the hits among the hit-plane
slots the emit walks, ``emit_hits / emit_slots`` of
``repro_torch.core.join_events()`` over every call the run's process made
(core/selfjoin.py::_self_join_fused: n_off x c x qp slots a launch); None
where the program has no such counter or walked no slot."""
from portbench import counters


def read(record):
    events = counters.join_events()
    if not events or not events["emit_slots"]:
        return None
    return events["emit_hits"] / events["emit_slots"]
