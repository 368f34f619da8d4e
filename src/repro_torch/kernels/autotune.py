"""The measured tile and route table of the fused join.

The counterpart of the JAX package's ``repro.kernels.autotune``, with its
names and decisions. Two choices come from a small persisted table:

  * the query tile of kernel B1's launches (``fused_tile``), per (backend,
    n_dims, window capacity c, metric class): a cached winner, a timing of
    the candidate tiles on a synthetic workload when measuring is on, else
    ``DEFAULT_TQ``;
  * the route of ``self_join_count(distance_impl="fused")``
    (``count_route``), per workload class: a cached winner, a timing of the
    candidate routes on the live workload when measuring is on, else the
    occupancy heuristic (``route_heuristic``). Under the merged sweep the
    per-cell sweeps ("dense-flat", "sparse-flat") and the cell-run loop
    ("dense-run") race too.

The backend is the device type of the index, "cuda" or "cpu", so rows
measured on the card and on the CPU never steer each other. The table is a
JSON file: ``$REPRO_TORCH_AUTOTUNE_CACHE`` if set, else
``autotune_cache.json`` beside this module, which ships with the schema
version and no rows. Measuring is on with ``$REPRO_TORCH_AUTOTUNE=1`` or an
explicit ``measure=True``; without it a miss takes the default and costs no
timing. Writes are atomic and best effort: a read-only install keeps a new
row in memory only. The JAX package's table and variables
(``REPRO_AUTOTUNE*``) are its own and never read here.
"""
from __future__ import annotations

import json
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

DEFAULT_TQ = 128
TQ_CANDIDATES = (64, 128, 256)
_ENV_CACHE = "REPRO_TORCH_AUTOTUNE_CACHE"
_ENV_MEASURE = "REPRO_TORCH_AUTOTUNE"
# Stored under "__schema__"; a file of another version is discarded whole.
# 3 is the JAX package's version of the same key semantics: tile rows keyed
# on merged window capacities, route rows carrying the sweep, "dense-run"
# among the raced routes.
SCHEMA_VERSION = 3


def cache_path() -> str:
    return os.environ.get(_ENV_CACHE) or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "autotune_cache.json")


def measure_enabled() -> bool:
    return os.environ.get(_ENV_MEASURE, "").lower() in ("1", "true", "yes")


class _Cache:
    """Lazy-loaded JSON key -> entry store with best-effort persistence."""

    def __init__(self):
        self._data: Optional[dict] = None
        self._path: Optional[str] = None

    def _load(self) -> dict:
        path = cache_path()
        if self._data is None or path != self._path:
            self._path = path
            try:
                with open(path) as f:
                    self._data = json.load(f)
            except (OSError, ValueError):
                self._data = {}
            if self._data.get("__schema__") != SCHEMA_VERSION:
                # rows measured under other key semantics must not steer
                self._data = {"__schema__": SCHEMA_VERSION}
        return self._data

    def get(self, key: str):
        return self._load().get(key)

    def put(self, key: str, entry: dict) -> None:
        data = self._load()
        data["__schema__"] = SCHEMA_VERSION
        data[key] = entry
        try:
            tmp = self._path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(data, f, indent=1, sort_keys=True)
            os.replace(tmp, self._path)
        except OSError:
            pass  # read-only install: keep the entry in memory only

    def reset(self) -> None:  # test hook
        self._data = None


_CACHE = _Cache()


def _backend(backend: Optional[str]) -> str:
    """The table's backend: the device type the join runs on. Callers pass
    their index's; None means the entry points' default device, the card."""
    return "cuda" if backend is None else str(backend)


def _pow2_class(x: float) -> int:
    """Coarse pow2 bucketing for cache keys (1, 2, 4, ...; min 1)."""
    v = 1
    while v < x:
        v *= 2
    return v


def _sync(backend: str) -> None:
    if backend == "cuda":
        torch.cuda.synchronize()


def _timed(fn: Callable, backend: str = "cpu") -> float:
    """Seconds of ``fn()`` by the host clock; on the card the device is
    synchronised before and after, so the time is the call's work."""
    _sync(backend)
    t0 = time.perf_counter()
    fn()
    _sync(backend)
    return time.perf_counter() - t0


# ---------------------------------------------------------------------------
# Query-tile selection
# ---------------------------------------------------------------------------

def metric_class(metric: str) -> str:
    """The metric's table class: cosine shares the l2 rows (its launches are
    the L2 ones on unit rows); jaccard's popcount refine keys its own."""
    return "l2" if metric in ("l2", "cosine") else metric


def tile_key(backend: str, n_dims: int, c: int, metric: str = "l2") -> str:
    mc = metric_class(metric)
    suffix = "" if mc == "l2" else f"/{mc}"
    return f"tile/{backend}/{n_dims}d/c{c}{suffix}"


def fused_tile(n_dims: int, c: int, *, backend: Optional[str] = None,
               measure: Optional[bool] = None, metric: str = "l2") -> int:
    """Query tile for a fused launch of window capacity ``c``: the cached
    row of (backend, n_dims, c, metric class), else a measurement when
    measuring is on, else ``DEFAULT_TQ``. Jaccard classes never measure
    (the synthetic workload refines by L2): a row or the default."""
    backend = _backend(backend)
    key = tile_key(backend, int(n_dims), int(c), metric)
    entry = _CACHE.get(key)
    if entry is not None:
        return int(entry["tq"])
    if measure is None:
        measure = measure_enabled()
    if not measure or metric_class(metric) == "jaccard":
        return DEFAULT_TQ
    tq, timings, refused = _measure_fused_tile(n_dims, int(c),
                                               backend=backend)
    entry = {"tq": tq, "ms": timings}
    if refused:
        entry["refused"] = refused
    _CACHE.put(key, entry)
    return tq


def _measure_fused_tile(n_dims: int, c: int, *, backend: str = "cuda",
                        qp: int = 1024, npts: int = 4096, trials: int = 3):
    """Time the candidate tiles on a synthetic descriptor workload (the JAX
    package's: random but fixed windows and queries, so the comparison
    isolates the tile; counts only). A candidate that does not divide
    ``qp``, or whose launch B1's wrapper refuses (its shared-memory checks),
    is left out. Returns (winner, {tq: best ms}, {tq: refusal})."""
    from repro_torch.analysis import sanitize
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_join import NP_PAD

    dev = torch.device(backend)
    n_off = min(3 ** n_dims, 27)
    rng = np.random.default_rng(0)
    pts = torch.as_tensor(rng.uniform(0, 1, (npts + c, NP_PAD))).to(dev)
    qb = pts[:qp]
    ws = torch.as_tensor(rng.integers(0, npts, (n_off, qp)),
                         dtype=torch.int32).to(dev)
    wc = torch.as_tensor(rng.integers(0, c + 1, (n_off, qp)),
                         dtype=torch.int32).to(dev)
    iz = torch.zeros(n_off, dtype=torch.int32)
    iz[0] = 1
    iz = iz.to(dev)
    qpos = torch.arange(qp, dtype=torch.int32, device=dev)
    timings, refused = {}, {}
    for tq in TQ_CANDIDATES:
        if qp % tq:
            continue

        def run(tq=tq):
            _, counts, _ = ops.fused_join_hits(
                pts, qb, ws, wc, iz, qpos, 0.05, c=c, n_real=n_dims,
                unicomp=True, tq=tq, keep_hits=False)
            return counts.cpu()

        try:
            run()  # loads the kernel library; not timed
        except ValueError as err:
            refused[str(tq)] = str(err)
            continue
        best = min(_timed(run, backend) for _ in range(trials))
        timings[str(tq)] = 1000 * best
    sanitize.raise_pending()   # REPRO_TORCH_SANITIZE: the runs have synced
    winner = min(timings, key=timings.get)
    return int(winner), timings, refused


# ---------------------------------------------------------------------------
# Count-route table
# ---------------------------------------------------------------------------

def route_key(backend: str, n_dims: int, n_off: int, c_class: int,
              live_class: int, merged: bool = False,
              metric: str = "l2") -> str:
    sweep = "merged" if merged else "flat"
    mc = metric_class(metric)
    suffix = "" if mc == "l2" else f"/{mc}"
    return (f"route/{backend}/{n_dims}d/off{n_off}/c{c_class}"
            f"/live{live_class}/{sweep}{suffix}")


def route_heuristic(backend: str, n_dims: int, n_off: int, c: int,
                    occupancy: float, live_frac: float,
                    merged: bool = False) -> str:
    """The fallback when no row is cached. Its TPU and CPU branches are the
    JAX package's rule: on the TPU (kept as a pure function) "compact"
    where nearly every probe is empty, elsewhere "sparse", the
    probe-compacted counter, where nearly all dense window slots are
    padding, else "dense". "cuda" takes "dense": the CPU thresholds were
    never measured on the card, where the merged dense sweep beat "sparse"
    on the one workload they send there (uniform-6d, PERF.md §5), so the
    card keeps the dense sweep until a measured row says otherwise.

    ``merged``: ``n_off`` is the reduced 3^(n-1) count while ``c`` and
    ``live_frac`` stay per-cell features, so the slot volume scales n_off
    back by the 3 merged cells: the regimes describe the data, not the
    sweep."""
    vol = n_off * (3 if merged else 1)
    if backend == "tpu":
        if vol * occupancy < 3.0 and vol * c >= 256:
            return "compact"
        return "dense"
    if backend == "cuda":
        return "dense"
    if live_frac < 0.06 and vol * c >= 512:
        return "sparse"
    return "dense"


def count_route(*, n_dims: int, n_off: int, c: int, occupancy: float,
                live_frac: float, backend: Optional[str] = None,
                merged: bool = False, candidates: Optional[dict] = None,
                measure: Optional[bool] = None,
                metric: str = "l2") -> tuple:
    """Route for ``self_join_count(distance_impl="fused")``.

    Returns ``(route, source)``, source one of "cache", "measured",
    "heuristic", "forced". ``candidates`` maps a route to a zero-argument
    callable running that counter on the live workload; with measuring on,
    each is warmed once and timed (best of 2) and the winner is cached under
    the workload's class key. ``merged`` keys the merged sweep's rows apart.
    Cosine rides the l2 rows; jaccard is forced onto the dense sweep, the
    only one whose kernel refines by popcount.
    """
    backend = _backend(backend)
    if metric_class(metric) == "jaccard":
        return "dense", "forced"
    key = route_key(backend, int(n_dims), int(n_off),
                    _pow2_class(c), _pow2_class(live_frac * n_off),
                    merged, metric)
    entry = _CACHE.get(key)
    if entry is not None:
        return str(entry["route"]), "cache"
    if measure is None:
        measure = measure_enabled()
    if measure and candidates:
        timings = {}
        for name, fn in candidates.items():
            fn()  # warm: the first call's loads must not decide the route
            timings[name] = 1000 * min(_timed(fn, backend),
                                       _timed(fn, backend))
        winner = min(timings, key=timings.get)
        _CACHE.put(key, {"route": winner, "ms": timings})
        return winner, "measured"
    return route_heuristic(backend, n_dims, n_off, c, occupancy,
                           live_frac, merged), "heuristic"
