"""The PyTorch port stands alone: it imports neither JAX nor the JAX package."""
import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parent.parent / "src"
PORT_MODULES = sorted((SRC / "repro_torch").rglob("*.py"))
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_MODULES,
                         ids=[str(p.relative_to(SRC)) for p in PORT_MODULES])
def test_port_module_imports_no_jax(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(SRC)} imports {bad}"


def test_port_runs_with_jax_and_repro_unimportable():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["jaxlib"] = None
        sys.modules["repro"] = None
        import numpy as np
        import repro_torch
        pts = np.random.default_rng(0).uniform(0, 10, (500, 2))
        pairs = repro_torch.self_join(pts, 0.5, device="cpu")
        stats = repro_torch.self_join_count(pts, 0.5, device="cpu")
        assert pairs.shape[0] == stats.total_pairs > 0
        q = np.random.default_rng(1).uniform(-1, 11, (40, 2))
        res = repro_torch.epsilon_join(q, pts, 0.5, device="cpu")
        svc = repro_torch.JoinService(pts, 0.5, return_pairs=True,
                                      device="cpu")
        served = svc.query(q)
        assert (served.counts == res.counts).all() and res.total > 0
        assert (served.pairs == res.pairs).all()
        assert not any(m.split(".")[0] in ("jax", "jaxlib", "repro")
                       for m, v in sys.modules.items() if v is not None)
        print("ok", pairs.shape[0])
    """)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok ")


def test_training_runs_with_jax_and_repro_unimportable(tmp_path):
    """The training path (train/, ckpt/, data/pipeline.py, launch/train.py)
    imports neither JAX nor the JAX package: two steps with the dedup and
    a checkpoint, then a restart from it."""
    code = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["jaxlib"] = None
        sys.modules["repro"] = None
        from repro_torch.launch import train
        args = ["--arch", "smoke-lm", "--reduced", "--device", "cpu",
                "--batch", "2", "--seq", "16", "--dedup",
                "--ckpt-dir", {str(tmp_path)!r}]
        first = train.run(args + ["--steps", "2"])
        again = train.run(args + ["--steps", "3"])
        assert again.start == 2 and len(again.losses) == 1
        assert not any(m.split(".")[0] in ("jax", "jaxlib", "repro")
                       for m, v in sys.modules.items() if v is not None)
        print("ok", first.loss, again.loss)
    """)
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "ok " in proc.stdout
