"""The port's meshed train step (ROADMAP A17 (ii b)) on gloo ranks on the
CPU, against the port's unmeshed step and against JAX's meshed step on
placeholder devices.

The reduced smoke-lm at float32 on (data, model) meshes (1, 2), (2, 1)
and (2, 2), for 3 steps: losses and grad norms within F32_TOL relative,
and every gathered master leaf within rtol = atol = F32_TOL, of both. At bfloat16 on (2, 2): one batch's gradient, gathered,
each leaf within ``tests/test_torch_train.py``'s band (BF16_LEAF_REL of
its largest magnitude, cosine >= BF16_LEAF_COS) of the unmeshed port's and
of JAX's meshed gradient, and 3 steps' losses within BF16_TOL. The moe
smoke on (2, 2), whose 4 experts split over 'data': the expert all-to-all
runs, and the f32 steps match; with 3 rows, which do not split, none
runs. The driver's resume from ``--mesh none`` on
one rank to ``--mesh smoke`` on four against an uninterrupted four-rank
run, within the chip smoke's resume bound.

One subprocess spawns four gloo ranks that run every case
(``tests/torch_train_mesh_ranks.py``); another runs JAX on four
placeholder devices (``tests/torch_mesh_jax.py``); both start when the
module does.
"""
import numpy as np
import pytest

from repro_torch.launch import train as ttrain
from torch_train_mesh_ranks import grads, start, train
from torch_workloads import one_torch_thread  # noqa: F401  (autouse)

F32_TOL = 1e-4
BF16_TOL = 0.15
BF16_LEAF_REL = 0.08
BF16_LEAF_COS = 0.999
RESUME_RTOL = 2e-3
AXES = ("data", "model")
SHAPES = {"1x2": (1, 2), "2x1": (2, 1), "2x2": (2, 2)}
DRIVER = ["--arch", "smoke-lm", "--reduced", "--device", "cpu", "--batch",
          "4", "--seq", "32", "--warmup", "2", "--log-every", "100"]

TORCH_CASES = {
    **{f"f32/{k}": ("train", dict(fam="dense", dtype="float32", shape=s,
                                  axes=AXES)) for k, s in SHAPES.items()},
    "bf16/grads": ("grads", dict(fam="dense", dtype="bfloat16",
                                 shape=(2, 2), axes=AXES)),
    "bf16/train": ("train", dict(fam="dense", dtype="bfloat16",
                                 shape=(2, 2), axes=AXES)),
    "moe/train": ("train", dict(fam="moe", dtype="float32", shape=(2, 2),
                                axes=AXES, batch=(4, 16))),
    "moe/odd": ("train", dict(fam="moe", dtype="float32", shape=(2, 2),
                              axes=AXES, batch=(3, 16))),
}
JAX_CASES = {
    **{f"f32/{k}": ("train", dict(fam="dense", dtype="float32", shape=s,
                                  axes=AXES)) for k, s in SHAPES.items()},
    "bf16/grads": ("grads", dict(fam="dense", dtype="bfloat16",
                                 shape=(2, 2), axes=AXES)),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("train_mesh")
    ckpt = d / "ckpt"
    first = ttrain.run(DRIVER + ["--mesh", "none", "--steps", "4",
                                 "--ckpt-dir", str(ckpt),
                                 "--ckpt-every", "4"])
    cases = dict(TORCH_CASES,
                 resume=("driver", dict(argv=DRIVER + [
                     "--mesh", "smoke", "--steps", "8", "--ckpt-dir",
                     str(ckpt)])),
                 whole=("driver", dict(argv=DRIVER + [
                     "--mesh", "smoke", "--steps", "8"])))
    get, stop = start(d, cases, JAX_CASES)
    yield get, first
    stop()


def flat(tree, prefix=()) -> dict:
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree)
                for k, v in flat(tree[key], prefix + (key,)).items()}
    return {"/".join(map(str, prefix)): np.asarray(tree, np.float32)}


def rel(a, b) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def leaves_close(got: dict, want: dict, tol: float) -> None:
    """Every leaf within rtol = atol = ``tol``: the band the unmeshed
    step's master weights meet against JAX's
    (``tests/test_torch_train_state.py``)."""
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=tol, atol=tol,
                                   err_msg=k)


def leaf_band(port, ref) -> tuple:
    a = np.asarray(port, np.float64).ravel()
    b = np.asarray(ref, np.float64).ravel()
    scale = np.abs(b).max()
    cos = a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-300)
    return np.abs(a - b).max() / max(scale, 1e-300), cos


@pytest.fixture(scope="module")
def unmeshed():
    return {"dense": train("dense", "float32", None, None),
            "moe": train("moe", "float32", None, None, batch=(4, 16)),
            "moe/odd": train("moe", "float32", None, None, batch=(3, 16)),
            "bf16": train("dense", "bfloat16", None, None)}


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("against", ["port", "jax"])
def test_f32_steps(runs, unmeshed, shape, against):
    get, _ = runs
    ranks = get("torch")
    mine = [r[f"f32/{shape}"] for r in ranks]
    n = SHAPES[shape][0] * SHAPES[shape][1]
    assert all(m is None for m in mine[n:])
    want = unmeshed["dense"] if against == "port" else get("jax")[
        f"f32/{shape}"]
    for m in mine[:n]:
        assert m["loss"] == mine[0]["loss"]      # every rank, one loss
        for k in ("loss", "grad_norm"):
            assert max(rel(a, b) for a, b in zip(m[k], want[k])) <= F32_TOL
    leaves_close(flat(mine[0]["master"]), flat(want["master"]), F32_TOL)


def test_f32_collectives_ran(runs):
    """(2, 2): parameters gathered over 'data', gradients summed over
    'data', the tensor-parallel cut points over 'model'; (1, 2) sums no
    gradient (one batch shard) and gathers no parameter: every weight of
    the reduced config splits over 'model' and its compute view stays
    split, and 'data' is 1."""
    ranks = runs[0]("torch")
    assert {"params", "grads", "loss", "tp"} <= set(
        ranks[0]["f32/2x2"]["calls"])
    assert "grads" not in ranks[0]["f32/1x2"]["calls"]
    assert "params" not in ranks[0]["f32/1x2"]["calls"]
    assert "tp" in ranks[0]["f32/1x2"]["calls"]


@pytest.mark.parametrize("against", ["port", "jax"])
def test_bf16_grads_in_band(runs, against, tmp_path):
    get, _ = runs
    got = get("torch")[0]["bf16/grads"]
    want = (grads("dense", "bfloat16", None, None) if against == "port"
            else get("jax")["bf16/grads"])
    assert abs(got["loss"] - want["loss"]) <= BF16_TOL
    assert sorted(got["grads"]) == sorted(want["grads"])
    for k, w in want["grads"].items():
        r, cos = leaf_band(got["grads"][k], w)
        assert r <= BF16_LEAF_REL and cos >= BF16_LEAF_COS, (k, r, cos)


def test_bf16_steps(runs, unmeshed):
    mine = runs[0]("torch")[0]["bf16/train"]
    want = unmeshed["bf16"]
    assert max(abs(a - b) for a, b in zip(mine["loss"], want["loss"])) \
        <= BF16_TOL
    assert all(np.isfinite(mine["loss"]))


def test_moe_expert_all_to_all(runs, unmeshed):
    """4 experts over 'data' 2: the dispatched tokens cross ranks."""
    ranks = runs[0]("torch")
    mine = ranks[0]["moe/train"]
    assert mine["calls"].get("expert", 0) > 0
    want = unmeshed["moe"]
    for k in ("loss", "grad_norm", "dropped_frac"):
        assert max(abs(a - b) / max(abs(b), 1.0)
                   for a, b in zip(mine[k], want[k])) <= F32_TOL, k
    leaves_close(flat(mine["master"]), flat(want["master"]), F32_TOL)


def test_moe_rows_not_split(runs, unmeshed):
    """3 rows do not split over 'data' 2: every rank runs every row, the
    experts' weights whole, no all-to-all, no gradient sum."""
    mine = runs[0]("torch")[0]["moe/odd"]
    assert "expert" not in mine["calls"] and "grads" not in mine["calls"]
    want = unmeshed["moe/odd"]
    for k in ("loss", "grad_norm", "dropped_frac"):
        assert max(abs(a - b) / max(abs(b), 1.0)
                   for a, b in zip(mine[k], want[k])) <= F32_TOL, k
    leaves_close(flat(mine["master"]), flat(want["master"]), F32_TOL)


def test_driver_resume_onto_four_ranks(runs):
    """``--mesh none`` on one rank to step 4, then ``--mesh smoke`` on
    four to step 8, against four ranks from step 0."""
    get, first = runs
    ranks = get("torch")
    assert first.start == 0 and len(first.losses) == 4
    resumed = [r["resume"] for r in ranks]
    whole = [r["whole"] for r in ranks]
    for r in resumed:
        assert r["start"] == 4 and r["ranks"] == 4
        assert r["mesh"] == {"data": 2, "model": 2}
        assert r["losses"] == resumed[0]["losses"]
    assert max(rel(a, b) for a, b in zip(resumed[0]["losses"],
                                         whole[0]["losses"][4:])) \
        <= RESUME_RTOL
    assert max(rel(a, b) for a, b in zip(first.losses,
                                         whole[0]["losses"][:4])) \
        <= RESUME_RTOL
