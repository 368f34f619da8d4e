"""CPU tests of the per-layer metrics that read the program's inner spans
and counters (``plan_idle_ms``, ``sync_ms``, ``syncs``,
``emit_live_share``, ``sort_ms``): each read by hand on a synthetic trace
and counter snapshot, and None where its spans or counters are absent, as
on a program without them."""
from pathlib import Path
from types import SimpleNamespace

import pytest

from portbench import counters, harness, trace as trace_lib

ROOT = Path(__file__).resolve().parents[1]
def metric(name):
    return harness.load_module(ROOT, "metrics", name)


def synthetic_trace():
    """Two calls in 40 us. Host: planning 2-19, its tables 3-12 with a sync
    8-10 inside, a launch's descriptors 14-16; the emit 20-35 with its sort
    24-32 and a sync 25-26 inside that. Device ops (start, end, launch):
    idle 4-6, 8-11, 13-17, 18-19.5, 24-27 and 33-40."""
    return trace_lib.Trace(
        calls=2, window_s=40e-6,
        spans=[(trace_lib.STRETCH, 0.0, 40.0), ("self_join", 1.0, 38.0),
               ("self_join.plan", 2.0, 19.0),
               ("self_join.plan.tables", 3.0, 12.0), ("host_sync", 8.0, 10.0),
               ("self_join.plan.launch", 14.0, 16.0),
               ("self_join.emit", 20.0, 35.0),
               ("self_join.emit.sort", 24.0, 32.0),
               ("host_sync", 25.0, 26.0)],
        device_ops=[("fill", 0.0, 4.0, 0.5), ("copy", 6.0, 8.0, 5.0),
                    ("copy", 11.0, 13.0, 10.5), ("gather", 17.0, 18.0, 16.5),
                    ("scatter", 19.5, 24.0, 21.0),
                    ("radix sort", 27.0, 33.0, 26.5)])


def record(trace=None):
    return SimpleNamespace(trace=trace)


def test_span_metrics_by_hand():
    t = synthetic_trace()
    # planning's idle: 4-6 under the tables, 13-17 under the launch's
    # descriptors, 18-19.5 under planning itself; 8-11 falls under the
    # sync inside the tables, the host waiting, and is not planning's
    gaps = dict(trace_lib.breakdown(t, top=99)["idle_gaps"])
    assert gaps["host_sync"] == pytest.approx((3 + 3) * 1e-6 / 2)
    assert metric("plan_idle_ms").read(record(t)) == pytest.approx(
        (2 + 4 + 1.5) / 2 / 1e3)
    # the syncs 8-10 and 25-26, over 2 calls
    assert metric("sync_ms").read(record(t)) == pytest.approx(3 / 2 / 1e3)
    # the sort launched at 26.5 inside the sort span, 6 us over 2 calls;
    # the scatter, launched at 21, is the emit's and not the sort's
    assert metric("sort_ms").read(record(t)) == pytest.approx(6 / 2 / 1e3)


def test_span_metrics_without_their_spans():
    """On a trace of a program without the inner spans (only the stages),
    and without any trace, the span metrics read None, and planning's idle
    reads from ``self_join.plan`` alone."""
    t = synthetic_trace()
    bare = trace_lib.Trace(
        calls=t.calls, window_s=t.window_s, device_ops=t.device_ops,
        spans=[s for s in t.spans
               if s[0] in (trace_lib.STRETCH, "self_join.plan",
                           "self_join.emit")])
    assert metric("sync_ms").read(record(bare)) is None
    assert metric("sort_ms").read(record(bare)) is None
    assert metric("plan_idle_ms").read(record(bare)) == pytest.approx(
        (2 + 3 + 4 + 1.5) / 2 / 1e3)
    for name in ("plan_idle_ms", "sync_ms", "sort_ms"):
        assert metric(name).read(record(None)) is None


@pytest.mark.parametrize("events,syncs,share", [
    ({"calls": 4, "host_syncs": 92, "emit_slots": 2000, "emit_hits": 440},
     23.0, 0.22),
    ({"calls": 0, "host_syncs": 0, "emit_slots": 0, "emit_hits": 0},
     None, None),
    (None, None, None)], ids=["counted", "no-call", "no-counter"])
def test_counter_metrics_by_hand(monkeypatch, events, syncs, share):
    monkeypatch.setattr(counters, "join_events", lambda: events)
    assert metric("syncs").read(record()) == syncs
    assert metric("emit_live_share").read(record()) == share


def test_counters_read_the_program():
    """``counters.join_events`` is the program's snapshot once the harness
    has imported it."""
    core = harness.import_program(ROOT).core
    assert counters.join_events() == core.join_events()
    assert set(counters.join_events()) == {"calls", "host_syncs",
                                           "emit_slots", "emit_hits"}


def test_counters_absent_from_a_program(monkeypatch):
    core = harness.import_program(ROOT).core
    monkeypatch.delattr(core, "join_events")
    assert counters.join_events() is None
    assert metric("syncs").read(record()) is None
    assert metric("emit_live_share").read(record()) is None
