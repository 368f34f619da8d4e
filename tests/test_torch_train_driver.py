"""The port's training driver (``repro_torch.launch.train``, ROADMAP A17
(ii a)) on the CPU: a checkpoint at step 6 and a restart to 8 whose losses
and state equal an uninterrupted run bit for bit, the dedup pipeline, the
mesh flags on one rank (ROADMAP A17 (ii b): ``--mesh smoke``, the
production meshes' refusals, ``--compress-pods`` without a pod axis), the
CLI and the example as
subprocesses, and the chip smoke's recorded JAX losses (LM_TRAIN_PIN)
recomputed through JAX, which the port on the CPU matches within
chip_smoke.LM_TRAIN_RTOL (1e-4 relative)."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import TokenPipeline as JaxPipeline
from repro.models.config import ModelConfig as JaxConfig
from repro.models.lm import LMModel as JaxLM
from repro.train import optimizer as jopt
from repro.train.steps import make_train_step as j_make_train_step
from repro_torch.ckpt import latest_step, restore_checkpoint
from repro_torch.configs.smoke_lm import CONFIG
from repro_torch.data import TokenPipeline
from repro_torch.launch import train
from repro_torch.models.convert import params_to_numpy, seeded_params
from repro_torch.models.layers import tree_flatten_with_path
from torch_workloads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402

ARGS = ["--arch", "smoke-lm", "--reduced", "--device", "cpu", "--batch", "4",
        "--seq", "32", "--log-every", "1"]


def run(*extra):
    return train.run(ARGS + list(extra))


def state_of(ckpt_dir, step):
    """A checkpoint's leaves, restored into the driver's own trees."""
    args = train.parse_args(ARGS)
    _, _, model, ocfg = train.build(args)
    params, _ = model.init(np.random.default_rng(0))
    from repro_torch.train.optimizer import adamw_init
    like = {"params": params, "opt": adamw_init(params, ocfg)}
    return tree_flatten_with_path(restore_checkpoint(ckpt_dir, step, like))


def test_resume_equals_uninterrupted_run(tmp_path):
    whole_dir, part_dir = str(tmp_path / "whole"), str(tmp_path / "part")
    whole = run("--steps", "8", "--ckpt-dir", whole_dir, "--ckpt-every", "4")
    first = run("--steps", "6", "--ckpt-dir", part_dir, "--ckpt-every", "3")
    assert latest_step(part_dir) == 6
    assert sorted(os.listdir(part_dir)) == ["step_00000003", "step_00000006"]
    assert first.losses == whole.losses[:6]
    resumed = run("--steps", "8", "--ckpt-dir", part_dir)
    assert resumed.start == 6 and len(resumed.losses) == 2
    assert resumed.losses == whole.losses[6:]          # bit for bit
    assert resumed.loss == whole.loss
    # a restart at the last step runs no step: no loss
    assert np.isnan(train.main(ARGS + ["--steps", "8", "--ckpt-dir",
                                       part_dir]))
    assert latest_step(part_dir) == latest_step(whole_dir) == 8
    for (path, a), (_, b) in zip(state_of(part_dir, 8),
                                 state_of(whole_dir, 8)):
        assert torch.equal(a, b), path
    assert all(np.isfinite(whole.losses)) and whole.peak_bytes is None
    assert len(whole.step_ms) == len(whole.batch_ms) == 8
    assert whole.tokens_per_step == 4 * 32
    # the end-to-end rate counts each batch's time too
    assert 0 < whole.tokens_per_s() < whole.step_tokens_per_s()


def test_dedup_run(monkeypatch):
    """With --dedup every batch passes through the self-join; the driver
    trains on the pipeline's (JAX's) deduplicated tokens."""
    seen = []
    real = TokenPipeline.batch_at

    def spy(self, step):
        out = real(self, step)
        seen.append((self.dedup, str(self.device), out["tokens"]))
        return out

    monkeypatch.setattr(TokenPipeline, "batch_at", spy)
    rep = run("--steps", "3", "--dedup")
    assert np.isfinite(rep.losses).all() and len(rep.losses) == 3
    assert [s[:2] for s in seen] == [(True, "cpu")] * 3
    jpipe = JaxPipeline(vocab=512, batch=4, seq=32, dedup=True)
    for step, (_, _, tokens) in enumerate(seen):
        assert np.array_equal(tokens, jpipe.batch_at(step)["tokens"])


def test_restart_at_the_last_step(tmp_path):
    """ROADMAP §C, C9: restarted from a checkpoint already at --steps, the
    reference driver runs no step and then reads an unbound loss
    (UnboundLocalError); the port's returns NaN."""
    from repro.launch.train import main as jax_main

    jargs = ["--arch", "smoke-lm", "--reduced", "--batch", "2", "--seq", "16",
             "--steps", "1", "--ckpt-dir", str(tmp_path / "jax")]
    assert np.isfinite(jax_main(jargs))
    with pytest.raises(UnboundLocalError):
        jax_main(jargs)
    targs = ["--batch", "2", "--seq", "16", "--steps", "1", "--ckpt-dir",
             str(tmp_path / "port")]
    assert np.isfinite(run(*targs).loss)
    again = run(*targs)
    assert again.start == 1 and again.losses == [] and np.isnan(again.loss)


@pytest.fixture
def one_rank_group():
    """The driver's meshes make a one-rank process group in this process
    when none exists; it is taken down after the test."""
    import torch.distributed as dist
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("extra", [["--mesh", "smoke"], ["--mesh", "single"],
                                   ["--mesh", "multi"], ["--compress-pods"]])
def test_mesh_flags(extra, tmp_path, one_rank_group):
    """On one rank: the smoke mesh is (1, 1) and trains as ``--mesh none``
    does, bit for bit; the production meshes need 256 and 512 ranks;
    ``--compress-pods`` without a pod axis is the plain step, as JAX's
    is."""
    if extra[-1] in ("single", "multi"):
        need = 256 if extra[-1] == "single" else 512
        with pytest.raises(ValueError, match=f"needs {need} ranks, the "
                                             f"world has 1"):
            run("--steps", "1", *extra)
        return
    ckpt = str(tmp_path / "ckpt")
    rep = run("--steps", "2", "--ckpt-dir", ckpt, *extra)
    plain = run("--steps", "2")
    assert rep.losses == plain.losses
    assert rep.ranks == 1 and rep.rank == 0
    if extra == ["--mesh", "smoke"]:
        assert rep.mesh == {"data": 1, "model": 1}
        return
    assert rep.mesh is None
    # the plain step's AdamW returns step, master, m and v alone, as JAX's
    # does, so the buffers are gone from the saved state (ROADMAP §C, C11)
    import json
    with open(os.path.join(ckpt, "step_00000002", "manifest.json")) as f:
        names = [e["name"] for e in json.load(f)["leaves"]]
    assert names and not any(n.startswith("opt/grad_error") for n in names)


def test_no_cpu_fallback(monkeypatch):
    """Asked for CUDA (the default) where there is none, the driver and
    the dedup pipeline raise; they never fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        TokenPipeline(vocab=64, batch=4, seq=16, dedup=True).batch_at(0)


def test_cli_and_example(tmp_path):
    """``python -m repro_torch.launch.train`` runs and a restart resumes
    from the last step; the example runs with ``--device cpu``."""
    # one intra-op thread a process: the suite runs in parallel workers
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "smoke-lm", "--reduced", "--device", "cpu", "--batch", "2",
           "--seq", "16", "--ckpt-dir", str(tmp_path / "ckpt")]
    procs = [subprocess.Popen(cmd + ["--steps", "2"], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True),
             subprocess.Popen([sys.executable,
                               str(ROOT / "examples" / "torch_train_lm.py"),
                               "--device", "cpu", "--steps", "3",
                               "--ckpt-dir", str(tmp_path / "example")],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    assert "[train] done at step 2" in outs[0][0]
    assert "[train] done at step 3" in outs[1][0]
    assert latest_step(str(tmp_path / "example")) == 3
    out = subprocess.run(cmd + ["--steps", "3"], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert ("[train] elastic restore from step 2 onto 1 rank(s) (cpu)"
            in out.stdout)
    assert "[train] step 2 loss" in out.stdout
    assert "[train] step 1 loss" not in out.stdout


def test_lm_train_pin():
    """chip_smoke.LM_TRAIN_PIN is JAX's jitted train step on the full
    smoke-lm CONFIG at float32 (seeded weights, the driver's AdamW) over
    the pipeline's batches 0-2, whose tokens it records; the port on the
    CPU gives the same losses and gradient norms within LM_TRAIN_RTOL."""
    cfg = dataclasses.replace(CONFIG, dtype="float32")
    B, S = cs.LM_TRAIN_SHAPE
    pipes = (JaxPipeline(vocab=cfg.vocab, batch=B, seq=S, seed=0),
             TokenPipeline(vocab=cfg.vocab, batch=B, seq=S, seed=0,
                           device="cpu"))
    for i in range(cs.LM_TRAIN_STEPS):
        for pipe in pipes:
            want = pipe.batch_at(i)
            got = cs.pin_batch(i)
            assert all(np.array_equal(got[k], want[k]) for k in want)
    tree = params_to_numpy(seeded_params(cfg, cs.LM_WEIGHT_SEED, "cpu")[0])
    jm = JaxLM(JaxConfig(**dataclasses.asdict(cfg)))
    ocfg = jopt.AdamWConfig(**cs.LM_TRAIN_OPT)
    step = jax.jit(j_make_train_step(jm, ocfg))
    p = jax.tree.map(jnp.asarray, tree)
    s = jopt.adamw_init(p, ocfg)
    want = {"loss": [], "grad_norm": []}
    for i in range(cs.LM_TRAIN_STEPS):
        p, s, m = step(p, s, jax.tree.map(jnp.asarray, cs.pin_batch(i)))
        for k in want:
            want[k].append(float(m[k]))
    for k in want:
        np.testing.assert_allclose(want[k], cs.LM_TRAIN_PIN[k], rtol=1e-6)
    port = cs.train_pin_run(torch.device("cpu"), cs.LM_TRAIN_STEPS)
    for k in want:
        np.testing.assert_allclose([r[k] for r in port], cs.LM_TRAIN_PIN[k],
                                   rtol=cs.LM_TRAIN_RTOL)
