"""Closed loop: one caller makes back-to-back self-joins, ``entry(points,
eps, device=..., **kwargs)``, each on fresh points, for the window's seconds.

Before the window, ``warmup_calls`` calls of the cell's own shapes load (or,
in a checkout's first run, build) the kernel libraries and grow the
allocator's pools, with the buffers that hold the calls kept for the check
already in place; set-up ends when the window starts. In the window, each
call's points are drawn on the device from (seed, call number) and
synchronised before the call's timer starts; a call counts when its result
is ready after a ``torch.cuda.synchronize()``. The window ends with the
first call to complete at or past ``seconds`` (with ``trace``, not before
the traced stretch is complete).

``checked_calls`` of the window's calls, drawn from the seed by reservoir
sampling, keep their inputs (``points``, ``eps``) and their results for the
check after the window, copied into those buffers. The peak a call holds is read from the allocator
around the call, less the bytes that the calls kept for the check hold, so
the join's own peak is what is reported.

With ``trace``, calls ``trace_skip_calls`` to ``trace_skip_calls +
trace_calls`` of the window run under ``torch.profiler``.
"""
import random
import time
from contextlib import ExitStack, nullcontext
from dataclasses import dataclass, field

import torch

from portbench import trace as trace_lib
from portbench.data import call_seed, make_points


@dataclass
class Window:
    calls: int = 0
    elapsed_s: float = 0.0
    latencies_s: list = field(default_factory=list)
    pairs: list = field(default_factory=list)
    join_peak_bytes: int = 0       # largest call peak, results kept left out
    process_peak_bytes: int = 0    # the process's peak, everything in it
    setup_builds: int = 0          # kernel builds before the window
    builds: int = 0                # kernel builds that fell in the window
    kept: list = field(default_factory=list)   # [(inputs, result)]


class _Slot:
    """A kept call's points and result, copied into buffers made in set-up:
    keeping a call in the window then neither pins one of the program's
    blocks in the allocator's pool nor frees one when a later call takes
    its place, so every call meets the same pool."""

    MARGIN = 1.01     # later calls' results may be a little larger

    def __init__(self, points: torch.Tensor, result: torch.Tensor):
        rows = int(result.shape[0] * self.MARGIN) + 1024
        self.points = torch.empty_like(points)
        self.result = torch.empty((rows, *result.shape[1:]),
                                  dtype=result.dtype, device=result.device)
        self.spill = None     # a result too large for the buffer, as it is

    def hold(self, points, result, eps: float) -> tuple:
        self.points.copy_(points)
        n = result.shape[0]
        self.spill = None if n <= self.result.shape[0] else result
        if self.spill is None:
            self.result[:n].copy_(result)
        kept = result if self.spill is not None else self.result[:n]
        return {"points": self.points, "eps": eps}, kept

    def device_bytes(self) -> int:
        held = [self.points, self.result, self.spill]
        return sum(t.numel() * t.element_size() for t in held
                   if t is not None and t.is_cuda)


def run(entry, *, config: dict, traffic: dict, seed: int, seconds: float,
        trace: bool, device: torch.device, t0: float, load, builds):
    """Returns (setup_s, Window, Trace or None). ``load(kind, name)`` finds
    a module of the benchmark by name; ``builds()`` counts kernel builds."""
    cuda = device.type == "cuda"
    generator = load("generators", config["generator"])
    eps = float(config["eps"])
    kwargs = dict(traffic.get("kwargs", {}))

    def points_of(k):      # warm-up calls first, then the window's
        return make_points(generator, config, seed, k, device)

    def call(points):
        return entry(points, eps, device=device, **kwargs)

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    warmups = int(traffic["warmup_calls"])
    keep = int(traffic["checked_calls"])
    slots = []
    for k in range(warmups):
        points = points_of(k)
        result = call(points)
        sync()
        if not slots:     # sized by the first call, in place for the others
            slots = [_Slot(points, result) for _ in range(keep)]
        del result, points
    win = Window()
    if cuda:
        win.process_peak_bytes = torch.cuda.max_memory_allocated(device)
    pick = random.Random(call_seed(seed, 0, stream=1))
    first = int(traffic["trace_skip_calls"]) if trace else -1
    last = first + int(traffic["trace_calls"]) if trace else -1
    prof = None
    profiling = ExitStack()
    win.setup_builds = builds()
    start = time.perf_counter()
    setup_s = start - t0
    done = start
    i = 0
    while done - start < seconds or i < last:
        if i == first:
            prof = profiling.enter_context(torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU,
                            *([torch.profiler.ProfilerActivity.CUDA]
                              if cuda else [])]))
            profiling.enter_context(
                torch.profiler.record_function(trace_lib.STRETCH))
            stretch_start = time.perf_counter()
        traced = first <= i < last
        with _span(traced, "portbench.draw"):
            points = points_of(warmups + i)
            sync()
        held = sum(slot.device_bytes() for slot in slots)
        if cuda:
            win.process_peak_bytes = max(win.process_peak_bytes,
                                         torch.cuda.max_memory_allocated(device))
            torch.cuda.reset_peak_memory_stats(device)
        t_call = time.perf_counter()
        with _span(traced, "portbench.call"):
            result = call(points)
            sync()
        done = time.perf_counter()
        win.latencies_s.append(done - t_call)
        if cuda:
            peak = torch.cuda.max_memory_allocated(device)
            win.process_peak_bytes = max(win.process_peak_bytes, peak)
            win.join_peak_bytes = max(win.join_peak_bytes, peak - held)
        win.pairs.append(int(result.shape[0]))
        j = len(win.kept) if len(win.kept) < keep else pick.randrange(i + 1)
        if j < keep:
            kept = slots[j].hold(points, result, eps)
            win.kept[j:j + 1] = [kept]
            del kept
        del result, points
        i += 1
        if i == last:
            stretch_s = time.perf_counter() - stretch_start
            profiling.close()
    win.calls = i
    win.elapsed_s = done - start
    win.builds = builds() - win.setup_builds
    traced = None
    if prof is not None:
        n, d = int(config["points"]), int(config["dims"])
        traced = trace_lib.collect(
            prof, calls=last - first, window_s=stretch_s,
            work=[dict(n=n, d=d, pairs=p) for p in win.pairs[first:last]])
    return setup_s, win, traced


def _span(on: bool, name: str):
    return torch.profiler.record_function(name) if on else nullcontext()
