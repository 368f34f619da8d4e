"""CPU tests of what decides ``correct``: a whole run with the control (the
reference one precision below the configuration's) in the program's place
comes out not correct where the program's comes out correct, and so does a
run with the timed path broken underneath, once for each fault the join
cells can have.
"""
from pathlib import Path

import pytest

from portbench import control, harness

ROOT = Path(__file__).resolve().parents[1]
# enough pairs that float32's rounding of eps^2 shows
SIZE = {"points": 30000, "eps": 2.0}


def test_control_fails_where_the_program_passes():
    sound, _ = harness.run_cell(ROOT, "syn2d2m.join", seed=1, seconds=0.01,
                                trace=False, device="cpu", overrides=SIZE)
    ctl, lines = control.run(ROOT, "syn2d2m.join", seed=1, seconds=0.01,
                             device="cpu", overrides=SIZE)
    assert sound["correct"] is True
    assert ctl["correct"] is False and ctl["failed"] >= 1
    checks = ctl["checks"]
    assert checks["missing_pairs"]["value"] + checks["extra_pairs"][
        "value"] > 0
    assert checks["calls_checked"]["value"] >= 1
    assert any(line.startswith("check missing_pairs: ") for line in lines)


def _stale(entry):
    """Every call returns the call before's pairs."""
    last = []

    def join(points, eps, **kw):
        out = entry(points, eps, **kw)
        last.append(out)
        return last[-2] if len(last) > 1 else out
    return join


def _half(entry):
    """Half of the queries' pairs left out."""
    def join(points, eps, **kw):
        out = entry(points, eps, **kw)
        return out[out[:, 0] < points.shape[0] // 2]
    return join


def _altered(entry):
    """One pair altered where it is produced."""
    def join(points, eps, **kw):
        out = entry(points, eps, **kw).clone()
        out[0, 1] = (out[0, 1] + 1) % points.shape[0]
        return out
    return join


def _self_pair(entry):
    """A self pair in place of the last pair."""
    def join(points, eps, **kw):
        out = entry(points, eps, **kw).clone()
        out[-1, 1] = out[-1, 0]
        return out
    return join


@pytest.mark.parametrize("cell", ["syn2d2m.join", "syn6d2m.join"])
@pytest.mark.parametrize("fault", [_stale, _half, _altered, _self_pair],
                         ids=lambda f: f.__name__.strip("_"))
def test_a_broken_join_is_not_correct(cell, fault):
    size = ({"points": 3000, "eps": 2.5} if cell.startswith("syn2d")
            else {"points": 2000, "eps": 30.0})
    result, lines = harness.run_cell(ROOT, cell, seed=11, seconds=0.2,
                                     trace=False, device="cpu", wrap=fault,
                                     overrides=size)
    assert result["correct"] is False
    assert result["failed"] >= 1
    assert any(v["value"] > v["limit"] for k, v in result["checks"].items()
               if k != "calls_checked")


def test_a_sound_join_is_correct():
    result, _ = harness.run_cell(ROOT, "syn2d2m.join", seed=11, seconds=0.2,
                                 trace=False, device="cpu",
                                 overrides={"points": 3000, "eps": 2.5})
    assert result["correct"] is True
