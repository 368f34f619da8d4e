"""The cross-pod int8 exchange (``repro_torch.train.compression``) and the
pod-compressed train step (ROADMAP A17 (ii b)) against the JAX package's.

``quantize`` / ``dequantize`` and ``compressed_mean_gspmd`` (2 and 3 pods)
bit for bit in one process, exact halves included (both round half to
even). ``compressed_psum_mean`` on two gloo ranks against JAX's
``shard_map`` over two placeholder devices: the mean bit for bit, the
residual within one float32 spacing (XLA fuses its multiply-subtract). The compressed
step of the reduced smoke-lm at float32 on a (pod 2, data 1, model 2) mesh
of four ranks against JAX's jitted step on four placeholder devices: the
losses and grad norms within F32_TOL relative, and each pod's
``grad_error`` within one quantization step (the leaf's scale) of JAX's
same pod, element by element: a sum in another order may flip one int8
rounding. ROADMAP §C, C10, pinned on both sides: the pods' residuals
differ, JAX's logical ``grad_error`` is pod 0's, and the port's checkpoint
holds pod 0's. The chip smoke's LM_TRAIN_POD_PIN (the compressed step of
the full smoke-lm CONFIG, pod 0's residual among it) is JAX's, and the
port's CPU ranks meet it within the bounds the card is held to.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import compression as jcomp
from repro_torch.train import compression as tcomp
from torch_train_mesh_ranks import start
from torch_workloads import one_torch_thread  # noqa: F401  (autouse)

F32_TOL = 1e-4
POD_MESH = dict(shape=(2, 1, 2), axes=("pod", "data", "model"))


def draws(seed, shapes, halves=False) -> dict:
    rng = np.random.default_rng(seed)
    out = {k: rng.standard_normal(s).astype(np.float32)
           for k, s in shapes.items()}
    if halves:      # values that quantize to exact halves of the scale
        a = out["a"].reshape(-1)
        a[:6] = np.float32(127) * np.asarray([1, .5, -.5, 1.5 / 127,
                                              2.5 / 127, -2.5 / 127],
                                             np.float32)
    return out


SHAPES = {"a": (6, 5), "b": (7,), "c": (2, 3, 4)}
PSUM_G = [draws(10 + r, SHAPES, halves=True) for r in range(2)]
PSUM_E = [{k: v * np.float32(1e-3) for k, v in draws(20 + r, SHAPES).items()}
          for r in range(2)]
JAX_CASES = {
    "psum": ("psum", dict(g=PSUM_G, e=PSUM_E)),
    "pods": ("train", dict(fam="dense", dtype="float32", compress=True,
                           **POD_MESH)),
    "pod_pin": ("pod_pin", {}),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("compression")
    torch_cases = {
        "psum": ("psum", dict(g=PSUM_G, e=PSUM_E)),
        "pods": ("train", dict(fam="dense", dtype="float32", compress=True,
                               save_dir=str(d / "ckpt"), **POD_MESH)),
        "pod_pin": ("pod_pin", {}),
    }
    get, stop = start(d, torch_cases, JAX_CASES)
    yield get, d
    stop()


@pytest.mark.parametrize("scale", [1.0, 0.37, 2.0 ** -7])
def test_quantize_dequantize_bit_for_bit(scale):
    x = np.concatenate([
        np.arange(-130, 131, 0.5, dtype=np.float32),   # exact halves
        np.random.default_rng(0).standard_normal(500).astype(np.float32)
        * 80]) * np.float32(scale)
    s = np.float32(scale)
    got = tcomp.quantize(torch.as_tensor(x), torch.tensor(s))
    want = np.asarray(jcomp.quantize(jnp.asarray(x), jnp.asarray(s)))
    assert got.dtype == torch.int8
    assert np.array_equal(got.numpy(), want)
    # half to even: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2, -2.5 -> -2
    if scale == 1.0:
        at = {v: got.numpy()[np.flatnonzero(x == v)[0]]
              for v in (0.5, 1.5, 2.5, -2.5, 130.0, -130.0)}
        assert at == {0.5: 0, 1.5: 2, 2.5: 2, -2.5: -2, 130.0: 127,
                      -130.0: -127}
    back = tcomp.dequantize(got, torch.tensor(s))
    assert np.array_equal(back.numpy(), np.asarray(
        jcomp.dequantize(jnp.asarray(want), jnp.asarray(s))))


@pytest.mark.parametrize("n_pods", [2, 3])
def test_compressed_mean_gspmd_bit_for_bit(n_pods):
    pods = [draws(30 + p, SHAPES, halves=p == 0) for p in range(n_pods)]
    errors = {k: v * np.float32(1e-2) for k, v in draws(40, SHAPES).items()}
    t = lambda tree: {k: torch.as_tensor(v) for k, v in tree.items()}
    mean, new_e = tcomp.compressed_mean_gspmd([t(p) for p in pods],
                                              t(errors), n_pods)
    jmean, jnew_e = jcomp.compressed_mean_gspmd(
        [jax.tree.map(jnp.asarray, p) for p in pods],
        jax.tree.map(jnp.asarray, errors), n_pods)
    for k in SHAPES:
        assert np.array_equal(mean[k].numpy(), np.asarray(jmean[k])), k
        assert np.array_equal(new_e[k].numpy(), np.asarray(jnew_e[k])), k


def test_init_error_state():
    p = {"w": torch.ones(2, 3, dtype=torch.bfloat16), "b": torch.ones(4)}
    e = tcomp.init_error_state(p)
    assert all(v.dtype == torch.float32 and not v.any() for v in e.values())
    assert e["w"].shape == (2, 3)


def test_compressed_psum_mean_two_ranks(runs):
    get, _ = runs
    ranks = get("torch")
    jmean, jnew = get("jax")["psum"]
    for r in range(2):
        mean, new_e = ranks[r]["psum"]
        for k in SHAPES:
            assert np.array_equal(mean[k], jmean[k][r]), (r, k)
            # XLA contracts g32 - q * scale into one fused multiply-add
            # inside the jit; the port rounds the product first: the
            # residual is within one float32 spacing of g32
            g32 = PSUM_G[r][k] + PSUM_E[r][k]
            assert (np.abs(new_e[k] - jnew[k][r])
                    <= np.spacing(np.abs(g32))).all(), (r, k)
    # the mean is the same on both ranks, the residuals their own
    for k in SHAPES:
        assert np.array_equal(ranks[0]["psum"][0][k], ranks[1]["psum"][0][k])
    assert any(not np.array_equal(ranks[0]["psum"][1][k],
                                  ranks[1]["psum"][1][k]) for k in SHAPES)
    assert ranks[2]["psum"] is None and ranks[3]["psum"] is None


def flat(tree, prefix=()) -> dict:
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree)
                for k, v in flat(tree[key], prefix + (key,)).items()}
    return {"/".join(map(str, prefix)): np.asarray(tree, np.float32)}


def test_compressed_step_against_jax(runs):
    get, _ = runs
    ranks = [r["pods"] for r in get("torch")]
    want = get("jax")["pods"]
    for r in ranks:
        assert r["loss"] == ranks[0]["loss"]
        for k in ("loss", "grad_norm"):
            got = np.asarray(r[k])
            assert np.abs(got - want[k]).max() <= F32_TOL * np.abs(
                want[k]).max(), (k, r[k], want[k])
        assert r["calls"].get("pods", 0) > 0


def by_pod(ranks) -> dict:
    return {r["coords"]["pod"]: flat(r["grad_error"]) for r in ranks}


def test_grad_error_within_one_step(runs):
    get, _ = runs
    ranks = [r["pods"] for r in get("torch")]
    want = get("jax")["pods"]["grad_error_pods"]
    mine = by_pod(ranks)
    # the scales of the last step, leaf by leaf, the same on every rank
    scales = ranks[0]["scales"]
    assert all(r["scales"] == scales for r in ranks)
    for pod in (0, 1):
        names = sorted(mine[pod])
        assert names == sorted(want[pod]) and len(scales) == len(names)
        for name, scale in zip(names, scales):
            diff = np.abs(mine[pod][name] - want[pod][name]).max()
            assert diff <= scale * (1 + 1e-6), (pod, name, diff, scale)


def test_c10_one_residual_per_pod_checkpoint_holds_pod0(runs):
    """ROADMAP §C, C10: each pod keeps its own residual; a checkpoint
    (JAX's logical array, and the port's save) holds pod 0's."""
    get, d = runs
    ranks = [r["pods"] for r in get("torch")]
    mine = by_pod(ranks)
    jax_pods = get("jax")["pods"]["grad_error_pods"]
    assert any(not np.array_equal(mine[0][k], mine[1][k]) for k in mine[0])
    assert any(not np.array_equal(jax_pods[0][k], jax_pods[1][k])
               for k in jax_pods[0])
    logical = get("jax")["pods"]["grad_error_logical"]
    assert all(np.array_equal(logical[k], jax_pods[0][k]) for k in logical)
    # the port's checkpoint, read leaf by leaf
    step_dir = d / "ckpt" / "step_00000003"
    man = json.loads((step_dir / "manifest.json").read_text())
    assert man["complete"]
    stored = {e["name"][len("opt/grad_error/"):]:
              np.load(step_dir / e["file"]) for e in man["leaves"]
              if e["name"].startswith("opt/grad_error/")}
    assert sorted(stored) == sorted(mine[0])
    assert all(np.array_equal(stored[k], mine[0][k]) for k in stored)
    assert any(not np.array_equal(stored[k], mine[1][k]) for k in stored)
    assert sorted(os.listdir(d / "ckpt")) == ["step_00000003"]


def test_chip_pod_pin(runs):
    """chip_smoke.LM_TRAIN_POD_PIN is JAX's compressed step (recomputed
    here), and the port's four CPU ranks meet it: the losses and grad
    norms within LM_TRAIN_RTOL, pod 0's residual within
    POD_RESIDUAL_RTOL."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs

    get, _ = runs
    want = get("jax")["pod_pin"]
    for k, v in cs.LM_TRAIN_POD_PIN.items():
        np.testing.assert_allclose(want[k], v, rtol=1e-6, err_msg=k)
    ranks = [r["pod_pin"] for r in get("torch")]
    got = cs.pod_vs_pin(ranks[0])
    assert got["residual"] <= cs.POD_RESIDUAL_RTOL, got
    assert max(got["loss"], got["grad_norm"]) <= cs.LM_TRAIN_RTOL, got
    # every rank saw the same losses; pod 1's ranks gathered pod 1's
    # residual, which differs from pod 0's (ROADMAP §C, C10)
    assert all(r["loss"] == ranks[0]["loss"] for r in ranks)
    assert ranks[1]["grad_error_norm"] == ranks[0]["grad_error_norm"]
    assert ranks[2]["grad_error_norm"] != ranks[0]["grad_error_norm"]
