"""What a ``torch.profiler`` trace of a stretch of the window says, reduced to
plain lists that the per-layer metrics read.

The method is ``chip_smoke.py::profiled_join``'s, applied to a stretch of
calls in the middle of a window: the program's ``record_function`` spans
(``self_join.grid``, ``.plan``, ``.kernel``, ``.emit``) give host time;
device operations are the device-side events, leaving out the profiler's own
activity buffers and the device-side copies of the spans (user
annotations). A device operation belongs to the span in which the host made
the runtime call that queued it. (The spans' ``device_time_total``, which
``profiled_join`` reads, counted more than the device's whole time in 6-D.) The harness opens ``portbench.stretch``
around the traced calls, ``portbench.draw`` around each call's data and
``portbench.call`` around each call.
"""
import bisect
from collections import defaultdict
from dataclasses import dataclass, field

STRETCH = "portbench.stretch"


@dataclass
class Trace:
    calls: int                 # calls inside the traced stretch
    window_s: float            # the stretch's length by the host clock
    busy_s: float = 0.0        # union of device activity inside it
    spans: list = field(default_factory=list)       # (name, start_us, end_us)
    # (name, start_us, end_us, launch_us): launch_us is when the host called
    # the runtime to queue it (None where the trace does not link them)
    device_ops: list = field(default_factory=list)
    # the host operations that took most time outside the spans' own
    # bookkeeping: [name, self host ms a call]
    host_ops: list = field(default_factory=list)
    work: list = field(default_factory=list)        # per traced call: n, d, pairs

    def span_ms(self, name: str) -> float:
        """Host ms inside spans called ``name``, their overlaps once, a call."""
        return union_us([(s, e) for n, s, e in self.spans if n == name]) \
            / 1e3 / self.calls

    def device_ms(self, part: str) -> float:
        """Device ms of the operations whose name holds ``part``, a call."""
        return sum(e - s for n, s, e, _ in self.device_ops if part in n) \
            / 1e3 / self.calls

    def device_ms_launched_in(self, name: str):
        """Device ms of the operations the host queued inside spans called
        ``name``, a call; None where no operation's launch is known."""
        spans = merged([(s, e) for n, s, e in self.spans if n == name])
        starts = [s for s, _ in spans]
        total, linked = 0.0, False
        for _, s, e, at in self.device_ops:
            if at is None:
                continue
            linked = True
            k = bisect.bisect_right(starts, at) - 1
            if k >= 0 and at <= spans[k][1]:
                total += e - s
        return total / 1e3 / self.calls if linked else None


def merged(intervals) -> list:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def union_us(intervals) -> float:
    """The length of the union of (start, end) intervals."""
    return sum(e - s for s, e in merged(intervals))


def collect(prof, *, calls: int, window_s: float, work: list) -> Trace:
    """The Trace of a finished ``torch.profiler.profile``."""
    import torch
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = prof.events()
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in events
             if e.device_type == cpu and e.is_user_annotation]
    names = {n for n, _, _ in spans}
    # a device operation and the runtime call that queued it share the
    # runtime's correlation id
    launch = {e.id: e.time_range.start for e in events
              if e.device_type == cpu and not e.is_user_annotation
              and e.name.startswith("cu")}
    ops = [(e.name, e.time_range.start, e.time_range.end, launch.get(e.id))
           for e in events
           if e.device_type == cuda and not e.is_user_annotation
           and e.name not in names
           and not e.name.startswith("Activity Buffer")
           and e.time_range.end > e.time_range.start]
    host = sorted(([e.key, e.self_cpu_time_total / 1e3 / calls]
                   for e in prof.key_averages()
                   if e.device_type == cpu and e.key not in names),
                  key=lambda kv: -kv[1])
    trace = Trace(calls=calls, window_s=window_s, spans=spans,
                  device_ops=ops, host_ops=host[:10], work=work)
    trace.busy_s = union_us(_clipped(trace)) / 1e6
    return trace


def _stretch(trace: Trace):
    marks = [(s, e) for n, s, e in trace.spans if n == STRETCH]
    if not marks:
        return None
    return min(s for s, _ in marks), max(e for _, e in marks)


def _clipped(trace: Trace) -> list:
    """Device intervals inside the traced stretch."""
    bounds = _stretch(trace)
    ivs = [(s, e) for _, s, e, _ in trace.device_ops]
    if bounds is None:
        return ivs
    lo, hi = bounds
    return [(max(s, lo), min(e, hi)) for s, e in ivs if e > lo and s < hi]


def breakdown(trace: Trace, top: int = 10) -> dict:
    """Seconds a call: the device operations that took most time, by name,
    and the idle gaps of the device summed by the innermost span the host
    was in at each gap's middle."""
    by_op = defaultdict(float)
    for name, s, e, _ in trace.device_ops:
        by_op[name[:120]] += (e - s) / 1e6 / trace.calls
    gaps = defaultdict(float)
    bounds = _stretch(trace)
    if bounds is not None:
        edge = bounds[0]
        for s, e in merged(_clipped(trace)) + [[bounds[1], bounds[1]]]:
            if s > edge:
                gaps[_host_span(trace, (edge + s) / 2)] += \
                    (s - edge) / 1e6 / trace.calls
            edge = max(edge, e)
    return {"device_ops": _top(by_op, top), "idle_gaps": _top(gaps, top)}


def _host_span(trace: Trace, t: float) -> str:
    """The innermost span open at ``t``: the one that opened last."""
    best, name = None, "outside the spans"
    for n, s, e in trace.spans:
        if s <= t <= e and (best is None or s > best):
            best, name = s, n
    return name


def _top(sums: dict, top: int) -> list:
    return [[k, v] for k, v in sorted(sums.items(), key=lambda kv: -kv[1])
            [:top]]
