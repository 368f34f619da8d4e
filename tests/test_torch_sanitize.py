"""The port's sanitized kernel mode (``repro_torch.analysis.sanitize``), held
to the JAX package's on the CPU.

* ``kernels.fused_join.sanitize_errcodes`` equals JAX's
  ``repro.kernels.fused_join.sanitize_errcodes`` bit for bit on a grid of
  seeded launches (l2, cosine, jaccard; f64 / f32, and f16 / bf16 for l2;
  tq 16 and 128; the hit plane checked or not), each corrupted in turn:
  every bit alone, bits combined, and corruptions that must set no bit.
  Half cosine, which the JAX package refuses to serve (ROADMAP §C), takes
  the port's own rule, pinned on its own.
* JAX's ``TestSanitizer`` cases through the port's ``ops.fused_join_hits``:
  an out-of-buffer descriptor raises ``SanitizerError`` (``oob-gather``) at
  the drain and never ``IndexError``; the drain at ``PendingJoin.result``;
  a clean ``self_join`` equals JAX's pairs with nothing pending; the
  environment gate reads ``REPRO_TORCH_SANITIZE``.
* Every entry point that launches kernel B1 returns with no code pending,
  the slab join over ``torch.distributed`` included (two gloo ranks in a
  subprocess started with the module); where the JAX package leaves codes
  queued (ROADMAP §C, C6), the port drains.
"""
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.analysis import sanitize as jsan
from repro.core import query_join as jqj
from repro.core import selfjoin as jsj
from repro.core.grid import build_grid_host
from repro.kernels import fused_join as jfj
from repro_torch.analysis import sanitize as tsan
from repro_torch.core import distributed as td
from repro_torch.core import query_join as tqj
from repro_torch.core import selfjoin as tsj
from repro_torch.core.grid import build_grid
from repro_torch.data import dedup
from repro_torch.kernels import fused_join as tfj
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as tserve
from torch_workloads import clustered, syn
from torch_workloads import one_torch_thread  # noqa: F401  (autouse)

TESTS = Path(__file__).resolve().parent
SRC = TESTS.parent / "src"
CPU = "cpu"
TORCH = {"f64": torch.float64, "f32": torch.float32, "f16": torch.float16,
         "bf16": torch.bfloat16}
NUMPY = {"f64": np.float64, "f32": np.float32, "f16": np.float16,
         "bf16": ml_dtypes.bfloat16}
UNIFORM = (syn(600, 2, seed=1) / 10, 0.5)
CROWD = (clustered(600, 3, seed=2) / 10, 0.3)   # skewed: bucketed plans


@pytest.fixture(autouse=True)
def sanitized():
    tsan.set_enabled(True)
    tsan.clear()
    yield
    tsan.set_enabled(None)
    tsan.clear()


# ---------------------------------------------------------------------------
# sanitize_errcodes against JAX's
# ---------------------------------------------------------------------------

C = 16


def _launch_arrays(metric, tq, seed=0):
    """A self-consistent launch in float64 numpy: points, queries,
    descriptors, a hit plane inside the windows, its counts and the per-tile
    exclusive scan. (arrays, n_real, n_off)."""
    rng = np.random.default_rng(seed)
    jac = metric == "jaccard"
    n_real, n_off = (1, 3) if jac else (3, 9)
    qp = 2 * tq
    npts = qp + 48
    pts = np.zeros((npts + C, 8))
    if jac:
        pts[:npts, 0] = rng.integers(0, 40, npts)          # set sizes
        pts[:npts, 1:5] = rng.integers(0, 1 << 16, (npts, 4))   # token words
    else:
        x = rng.normal(size=(npts, n_real))
        if metric == "cosine":
            x /= np.linalg.norm(x, axis=1, keepdims=True)
        pts[:npts, :n_real] = x
        pts[:npts, n_real] = rng.integers(0, 5, npts)       # merged lane
    q = pts[:qp].copy()
    ws = rng.integers(0, npts, (n_off, qp))
    wc = rng.integers(0, C + 1, (n_off, qp))
    wc[rng.random((n_off, qp)) < 0.2] = 0
    slots = np.arange(C)
    hits = ((rng.random((n_off, qp, C)) < 0.3)
            & (slots[None, None, :] < wc[:, :, None])).astype(np.int8)
    counts = hits.sum(axis=(0, 2)).astype(np.int64)
    ct = counts.reshape(-1, tq)
    base = (np.cumsum(ct, axis=1) - ct).reshape(-1)
    return dict(pts=pts, q=q, ws=ws, wc=wc, hits=hits, counts=counts,
                base=base), n_real, n_off


def _corrupt(case, a, n_real, n_off):
    """Apply ``case`` in place; returns the bits it must set (None: the
    bits depend on the metric and are checked against JAX only)."""
    npts = a["pts"].shape[0]
    if case == "clean":
        return 0
    if case == "oob":
        a["ws"][0, 0], a["wc"][0, 0] = npts - 3, 2
        return tsan.E_OOB_GATHER
    if case == "oob-negative":
        a["ws"][1, 2], a["wc"][1, 2] = -1, 2
        return tsan.E_OOB_GATHER
    if case == "oob-dead-window":     # count 0: nothing is read
        a["ws"][0, 1], a["wc"][0, 1] = npts + 5, 0
        return 0
    if case == "cap":
        a["wc"][2, 3] = C + 1
        return tsan.E_CAP_OVERFLOW
    if case == "scan":
        a["base"][1] += 1
        return tsan.E_SCAN_MISMATCH
    if case == "hit-flip":            # only the hit plane disagrees
        a["hits"][0, 0, 0] ^= 1
        return None
    if case == "count-negative":
        a["counts"][5] = -1
        return None
    if case == "count-high":
        a["counts"][0] = n_off * C + 1
        return None
    if case == "window-negative":
        a["wc"][0, 4] = -2
        return tsan.E_COUNT_RANGE
    if case == "nan-geometry":
        a["pts"][3, 0] = np.nan
        return tsan.E_NONFINITE
    if case == "inf-query":
        a["q"][1, 0] = np.inf
        return tsan.E_NONFINITE
    if case == "nan-feature-lane":    # jaccard's token lanes are not checked
        a["pts"][3, n_real] = np.nan
        return None
    if case == "off-unit":
        a["q"][0, :n_real] *= 1.1
        return None
    if case == "zero-row":
        a["q"][2] = 0.0
        return 0
    if case == "combined":
        a["ws"][0, 0], a["wc"][0, 0] = npts - 3, 2
        a["wc"][2, 3] = C + 1
        a["pts"][3, 0] = np.nan
        return tsan.E_OOB_GATHER | tsan.E_CAP_OVERFLOW | tsan.E_NONFINITE
    raise ValueError(case)


CASES = ("clean", "oob", "oob-negative", "oob-dead-window", "cap", "scan",
         "hit-flip", "count-negative", "count-high", "window-negative",
         "nan-geometry", "inf-query", "nan-feature-lane", "off-unit",
         "zero-row", "combined")


def _codes(a, dt, *, tq, check_hits, metric, n_real):
    """(port code, JAX code) of one launch's arrays at dtype ``dt``."""
    host = {k: a[k].astype(NUMPY[dt]) for k in ("pts", "q")}
    t = {k: torch.from_numpy(v.astype(np.float32)).to(TORCH[dt])
         for k, v in host.items()}
    ints = {k: a[k].astype(np.int32) for k in ("ws", "wc", "counts", "base")}
    port = tfj.sanitize_errcodes(
        t["pts"], t["q"], *(torch.from_numpy(ints[k])
                            for k in ("ws", "wc", "counts", "base")),
        torch.from_numpy(a["hits"]), c=C, tq=tq, check_hits=check_hits,
        metric=metric, n_real=n_real)
    assert port.shape == () and port.dtype == torch.int32
    ref = jfj.sanitize_errcodes(
        jnp.asarray(host["pts"]), jnp.asarray(host["q"]),
        *(jnp.asarray(ints[k]) for k in ("ws", "wc", "counts", "base")),
        jnp.asarray(a["hits"]), c=C, tq=tq, check_hits=check_hits,
        metric=metric, n_real=n_real)
    return int(port), int(ref)


GRID = [(m, dt, tq, hits) for m in ("l2", "cosine", "jaccard")
        for dt in (("f64", "f32", "f16", "bf16") if m == "l2"
                   else ("f64", "f32"))
        for tq in (16, 128) for hits in (False, True)]


@pytest.mark.parametrize("metric,dt,tq,check_hits", GRID)
def test_errcodes_match_jax_bit_for_bit(metric, dt, tq, check_hits):
    # an infinite cosine row is also off unit; the expected bits leave the
    # cosine bit to the comparison with JAX
    other = tsan.E_UNNORMALIZED if metric == "cosine" else 0
    for case in CASES:
        a, n_real, n_off = _launch_arrays(metric, tq)
        want = _corrupt(case, a, n_real, n_off)
        port, ref = _codes(a, dt, tq=tq, check_hits=check_hits,
                           metric=metric, n_real=n_real)
        assert port == ref, (case, tsan.decode(port), jsan.decode(ref))
        if want is not None:
            assert port & ~other == want, (case, tsan.decode(port))
    # the cases whose bits depend on the launch, by the port's own reading
    for case, bit, flagged in (
            ("hit-flip", tsan.E_SCAN_MISMATCH, check_hits),
            ("nan-feature-lane", tsan.E_NONFINITE, metric != "jaccard"),
            ("off-unit", tsan.E_UNNORMALIZED, metric == "cosine")):
        a, n_real, n_off = _launch_arrays(metric, tq)
        _corrupt(case, a, n_real, n_off)
        port, _ = _codes(a, dt, tq=tq, check_hits=check_hits,
                         metric=metric, n_real=n_real)
        assert bool(port & bit) == flagged, (case, tsan.decode(port))


@pytest.mark.parametrize("dt", ["f16", "bf16"])
def test_half_cosine_rule(dt):
    """The port's own rule for half cosine rows (the JAX package refuses to
    serve them): squared norms summed in float32 against the larger of
    NORM_TOL and twice the dtype's epsilon. Canonical unit rows rounded to
    the dtype pass at every width, where NORM_TOL alone would flag bfloat16
    rows; a row 2 % off unit is flagged."""
    rng = np.random.default_rng(4)
    dtype = TORCH[dt]
    tol = max(tfj.metric_lib.NORM_TOL, 2 * torch.finfo(dtype).eps)
    for n in (2, 3, 8, 33, 64):
        x = rng.normal(size=(512, n))
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        rows = torch.zeros((512, 72), dtype=dtype)
        rows[:, :n] = torch.from_numpy(x).to(dtype)
        ws = torch.zeros((1, 512), dtype=torch.int32)
        zeros = torch.zeros(512, dtype=torch.int32)
        hits = torch.zeros((1, 512, 8), dtype=torch.int8)

        def code(q):
            return int(tfj.sanitize_errcodes(
                rows, q, ws, ws, zeros, zeros, hits, c=8, tq=128,
                metric="cosine", n_real=n))

        n2 = (rows[:, :n].float() ** 2).sum(dim=1)
        assert float((n2 - 1).abs().max()) <= tol
        assert code(rows) == 0
        off = rows.clone()
        off[7, :n] = (torch.from_numpy(x[7]) * 1.02).to(dtype)
        assert code(off) == tsan.E_UNNORMALIZED
        if dt == "bf16" and n >= 8:
            # what NORM_TOL alone would have done to canonical rows
            assert float((n2 - 1).abs().max()) > tfj.metric_lib.NORM_TOL


# ---------------------------------------------------------------------------
# JAX's TestSanitizer cases, through the port's ops.fused_join_hits
# ---------------------------------------------------------------------------

def _launch(ws=None, wc=None, keep_hits=True):
    rng = np.random.default_rng(0)
    pts = np.sort(rng.uniform(0, 1, (64, 2)), axis=0)
    c, tq, qp, n_off = 8, 16, 16, 9
    points_pad = tfj.pad_points(torch.from_numpy(pts), c)
    ws = torch.zeros((n_off, qp), dtype=torch.int32) if ws is None else ws
    wc = torch.zeros((n_off, qp), dtype=torch.int32) if wc is None else wc
    return tops.fused_join_hits(
        points_pad, points_pad[:qp].clone(), ws, wc,
        torch.zeros(n_off, dtype=torch.int32),
        torch.zeros(qp, dtype=torch.int32), 0.1, c=c, n_real=2,
        unicomp=False, external=True, tq=tq, keep_hits=keep_hits)


def _descriptors(**cells):
    ws = torch.zeros((9, 16), dtype=torch.int32)
    wc = torch.zeros((9, 16), dtype=torch.int32)
    for name, (j, r, v) in cells.items():
        (ws if name.startswith("ws") else wc)[j, r] = v
    return ws, wc


def test_clean_launch_passes():
    _launch()
    assert tsan.pending() == 1
    tsan.raise_pending()              # no raise
    assert tsan.pending() == 0


def test_corrupted_window_descriptor_oob_gather():
    """The plain version's gather would raise IndexError on this window
    (the CUDA kernel would read past the buffer); the sanitized launch
    reads nothing there and raises at the drain."""
    ws, wc = _descriptors(ws=(0, 0, 1000), wc=(0, 0, 3))
    tsan.set_enabled(False)
    with pytest.raises(IndexError):
        _launch(ws, wc)
    tsan.set_enabled(True)
    hits, counts, _ = _launch(ws, wc)
    assert int(counts[0]) == 0 and not hits[0, 0].any()
    with pytest.raises(tsan.SanitizerError, match="oob-gather"):
        tsan.raise_pending()
    assert tsan.pending() == 0


def test_undersized_window_cap():
    _launch(*_descriptors(wc=(0, 0, 13)))          # > c = 8
    with pytest.raises(tsan.SanitizerError, match="cap-overflow"):
        tsan.raise_pending()


@pytest.mark.parametrize("keep_hits", [True, False])
def test_sanitized_launch_changes_no_output(keep_hits):
    """Outside a run that raises, the sanitized launch is the plain one."""
    ws, wc = _descriptors(wc=(0, 0, 5), wc2=(4, 3, 8))
    ws[:, :] = torch.arange(16, dtype=torch.int32)[None, :] * 3
    got = _launch(ws, wc, keep_hits)
    tsan.raise_pending()
    tsan.set_enabled(False)
    want = _launch(ws, wc, keep_hits)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert tsan.pending() == 0


def test_driver_drains_at_result():
    """A poisoned queue surfaces from ``PendingJoin.result``."""
    pts, eps = UNIFORM
    pj = tqj.prepare(build_grid(pts, eps, device=CPU))
    pend = pj.join_async(pts[:4])
    tsan.record("poisoned", torch.tensor(7, dtype=torch.int32))
    with pytest.raises(tsan.SanitizerError, match="poisoned"):
        pend.result()
    assert tsan.pending() == 0


def test_self_join_clean_under_sanitize():
    pts, eps = UNIFORM
    ref = jsj.self_join(pts, eps, distance_impl="fused")
    got = tsj.self_join(pts, eps, device=CPU)
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())
    assert tsan.pending() == 0        # drained by the driver


def test_decode():
    assert tsan.decode(3) == ["oob-gather", "cap-overflow"] == jsan.decode(3)
    assert tsan.decode(0) == []
    assert [tsan.decode(1 << k) for k in range(6)] == [
        jsan.decode(1 << k) for k in range(6)]


def test_env_gate(monkeypatch):
    """The port reads REPRO_TORCH_SANITIZE; the JAX package's variable does
    not switch it on."""
    tsan.set_enabled(None)
    monkeypatch.delenv("REPRO_TORCH_SANITIZE", raising=False)
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    assert not tsan.enabled()
    monkeypatch.setenv("REPRO_TORCH_SANITIZE", "1")
    assert tsan.enabled()
    monkeypatch.setenv("REPRO_TORCH_SANITIZE", "0")
    assert not tsan.enabled()


def test_queue_is_per_thread():
    import threading

    tsan.record("main", torch.tensor(0, dtype=torch.int32))
    seen = []
    th = threading.Thread(target=lambda: seen.append(tsan.pending()))
    th.start()
    th.join(timeout=30)
    assert not th.is_alive() and seen == [0] and tsan.pending() == 1


# ---------------------------------------------------------------------------
# every entry point that launches B1 drains what it recorded
# ---------------------------------------------------------------------------

def _jaccard_sets(n=300, vocab=64, seed=6):
    rng = np.random.default_rng(seed)
    base = [rng.choice(vocab, rng.integers(3, 12), replace=False)
            for _ in range(n // 2)]
    return base + [np.unique(np.concatenate([s, rng.choice(vocab, 1)]))
                   for s in base]


def _served(make, n_req=3):
    svc = make()
    svc.warmup(64)
    pts = UNIFORM[0]
    for k in range(n_req):
        svc.query(pts[k * 20:(k + 1) * 20] + 0.01)


def _batched_service():
    pts, eps = UNIFORM
    svc = tserve.BatchingJoinService(pts, eps, return_pairs=True,
                                     max_batch=128, device=CPU)
    svc.warmup()
    tickets = [svc.submit(pts[k * 10:(k + 1) * 10] + 0.01)
               for k in range(4)]
    svc.drain()
    assert all(t.done() for t in tickets)


def _measured_tiles(tmp_path, monkeypatch):
    from repro_torch.kernels import autotune

    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "t.json"))
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE", "1")
    autotune._CACHE.reset()
    try:
        tsj.self_join(*UNIFORM, device=CPU)
    finally:
        autotune._CACHE.reset()


ENTRIES = {
    "self_join": lambda: tsj.self_join(*UNIFORM, device=CPU),
    "self_join/per-cell": lambda: tsj.self_join(*UNIFORM,
                                                merge_last_dim=False,
                                                device=CPU),
    "self_join/run-loop": lambda: tsj.self_join(*CROWD, device=CPU),
    "self_join_batched": lambda: tsj.self_join_batched(*CROWD, device=CPU),
    "count/dense": lambda: tsj.self_join_count(*CROWD, route="dense",
                                               device=CPU),
    "count/dense-run": lambda: tsj.self_join_count(*CROWD,
                                                   route="dense-run",
                                                   device=CPU),
    "count/dense-flat": lambda: tsj.self_join_count(*CROWD,
                                                    route="dense-flat",
                                                    device=CPU),
    "count/compact": lambda: tsj.self_join_count(*CROWD, route="compact",
                                                 device=CPU),
    "count/auto": lambda: tsj.self_join_count(*CROWD, device=CPU),
    "self_join_count_compact": lambda: tsj.self_join_count_compact(
        *UNIFORM, device=CPU),
    "epsilon_join": lambda: tqj.epsilon_join(UNIFORM[0][:50] + 0.01,
                                             *UNIFORM, device=CPU),
    "prepare+warm": lambda: tqj.prepare(build_grid(*CROWD,
                                                   device=CPU)).warm(64),
    "JoinService": lambda: _served(lambda: tserve.JoinService(
        *UNIFORM, return_pairs=True, device=CPU)),
    "ShardedJoinService": lambda: _served(lambda: tserve.ShardedJoinService(
        *UNIFORM, 2, return_pairs=True, device=CPU)),
    "BatchingJoinService": _batched_service,
    "distributed_self_join": lambda: td.distributed_self_join(
        *UNIFORM, 2, device=CPU),
    "distributed_self_join/counts": lambda: td.distributed_self_join(
        *UNIFORM, 2, return_pairs=False, device=CPU),
    "cosine": lambda: tsj.self_join(UNIFORM[0] + 1.0, 0.99,
                                    metric="cosine", device=CPU),
    "jaccard": lambda: tsj.self_join(_jaccard_sets(), 0.6, metric="jaccard",
                                     device=CPU),
    "jaccard/JoinService": lambda: tserve.JoinService(
        _jaccard_sets(), 0.6, metric="jaccard", return_pairs=True,
        device=CPU).query(_jaccard_sets(20, seed=9)),
    "dedup_embeddings": lambda: dedup.dedup_embeddings(
        np.random.default_rng(8).normal(size=(400, 4)), min_cos=0.95,
        device=CPU),
}


@pytest.mark.parametrize("name", sorted(ENTRIES) + ["measured-tiles"])
def test_entry_point_leaves_nothing_pending(name, monkeypatch, tmp_path):
    recorded = []
    record = tsan.record
    monkeypatch.setattr(tsan, "record",
                        lambda label, code: (recorded.append(label),
                                             record(label, code)))
    if name == "measured-tiles":
        _measured_tiles(tmp_path, monkeypatch)
    else:
        ENTRIES[name]()
    assert recorded, f"{name} launched no B1 kernel"
    assert tsan.pending() == 0


@pytest.mark.parametrize("entry", ["self_join_count_compact", "warm"])
def test_jax_leaves_codes_queued_where_the_port_drains(entry):
    """ROADMAP §C, C6: the JAX package records codes at these entry points
    and never drains them; the port's counterparts drain (above)."""
    jsan.set_enabled(True)
    jsan.clear()
    try:
        if entry == "warm":
            jqj.prepare(build_grid_host(*CROWD)).warm(64)
        else:
            jsj.self_join_count_compact(*UNIFORM, distance_impl="fused")
        assert jsan.pending() > 0
    finally:
        jsan.set_enabled(None)
        jsan.clear()


RANKS_CODE = textwrap.dedent("""
    import pickle, sys
    import torch_collective_ranks as ranks
    from repro_torch.launch import mesh
    pts, eps = pickle.load(open(sys.argv[1], "rb"))
    out = mesh.spawn(ranks.sanitized_rank, 2, pts, eps, device="cpu",
                     timeout_s=90)
    pickle.dump(out, open(sys.argv[2], "wb"))
""")


@pytest.fixture(scope="module", autouse=True)
def collective_ranks(tmp_path_factory):
    """Two gloo ranks of the slab join under sanitized mode, started in a
    subprocess when the module starts; ``get()`` waits for their results."""
    d = tmp_path_factory.mktemp("sanitized_ranks")
    with open(d / "in.pkl", "wb") as f:
        pickle.dump(UNIFORM, f)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(SRC),
                                                       str(TESTS)]))
    proc = subprocess.Popen(
        [sys.executable, "-c", RANKS_CODE, str(d / "in.pkl"),
         str(d / "out.pkl")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)

    def get():
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-3000:]
        return pickle.loads((d / "out.pkl").read_bytes())

    yield get
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def test_collective_slab_join_drains_on_every_rank(collective_ranks):
    want = tsj.self_join(*UNIFORM, device=CPU).shape[0]
    for rank in collective_ranks():
        assert rank["recorded"] > 0 and rank["pending"] == 0
        assert rank["pairs"] == want
