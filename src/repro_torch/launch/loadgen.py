"""Load generator for the port's epsilon-join serving path.

The port's own copy of ``repro.launch.loadgen`` (which imports no JAX; the
port imports nothing of the JAX package), driving the services of
``repro_torch.launch.serve``. Drives a join service -- per-request
``JoinService`` or continuous-batching ``BatchingJoinService`` -- with a
synthetic request stream and measures the latency/throughput behaviour that
a single fixed-size request loop cannot see:

- **Open loop** (``run_open_loop``): requests arrive on a Poisson process
  at a target offered rate, independent of service completion. Latency is
  measured from the SCHEDULED arrival time, not the submit call, so queue
  delay under overload is charged to the service (coordinated-omission
  safe: a generator that waits for the service before "arriving" hides
  exactly the latencies that matter). Sweeping the offered rate maps the
  latency/throughput frontier.
- **Closed loop** (``run_closed_loop``): a fixed window of outstanding
  requests, next admitted when one completes -- measures service capacity
  (max sustained req/s) without an arrival model.

The request mix (``RequestMix``) draws per-request sizes and epsilon
thresholds from weighted sets, exercising the pow2 bucket ladder and the
traced-eps path exactly as a population of independent callers would.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class RequestMix:
    """Weighted request-size / epsilon population for a synthetic load.

    ``eps_values`` must all be <= the service's build epsilon (the stencil
    only covers the build radius); sizes may exceed the batching service's
    ``max_batch`` (such requests split into parts on admission).
    """

    sizes: tuple = (32, 64, 256)
    size_weights: Optional[tuple] = None
    eps_values: tuple = ()         # empty: always the service build eps
    eps_weights: Optional[tuple] = None
    lo: float = 0.0
    hi: float = 100.0

    def draw(self, rng: np.random.Generator, dims: int):
        n = int(rng.choice(self.sizes, p=self.size_weights))
        eps = (float(rng.choice(self.eps_values, p=self.eps_weights))
               if self.eps_values else None)
        q = rng.uniform(self.lo, self.hi, size=(n, dims))
        return q, eps


def make_request_stream(n_requests: int, mix: RequestMix, dims: int,
                        seed: int = 0) -> list:
    """Pre-draw the whole request stream so generation cost never sits on
    the measured path. Returns [(queries, eps_or_None), ...]."""
    rng = np.random.default_rng(seed)
    return [mix.draw(rng, dims) for _ in range(n_requests)]


@dataclass
class LoadReport:
    """One point on the latency/throughput frontier."""

    mode: str
    offered_rps: Optional[float]
    achieved_rps: float
    p50_ms: float
    p99_ms: float
    mean_ms: float
    n_requests: int
    total_queries: int
    wall_s: float
    coalesce_factor: Optional[float] = None
    latencies_ms: list = field(default_factory=list, repr=False)

    def to_dict(self) -> dict:
        return {
            "mode": self.mode,
            "offered_rps": self.offered_rps,
            "achieved_rps": round(self.achieved_rps, 2),
            "p50_ms": round(self.p50_ms, 3),
            "p99_ms": round(self.p99_ms, 3),
            "mean_ms": round(self.mean_ms, 3),
            "n_requests": self.n_requests,
            "total_queries": self.total_queries,
            "wall_s": round(self.wall_s, 3),
            "coalesce_factor": (None if self.coalesce_factor is None
                                else round(self.coalesce_factor, 2)),
        }


def _report(mode, offered, lat_ms, wall_s, stream, svc) -> LoadReport:
    lat = np.asarray(lat_ms)
    return LoadReport(
        mode=mode, offered_rps=offered,
        achieved_rps=len(lat) / wall_s if wall_s > 0 else float("inf"),
        p50_ms=float(np.percentile(lat, 50)),
        p99_ms=float(np.percentile(lat, 99)),
        mean_ms=float(lat.mean()),
        n_requests=len(lat),
        total_queries=sum(q.shape[0] for q, _ in stream),
        wall_s=wall_s,
        coalesce_factor=getattr(svc, "coalesce_factor", None),
        latencies_ms=[float(x) for x in lat])


def poisson_schedule(n_requests: int, rate_rps: float,
                     seed: int = 0) -> np.ndarray:
    """Scheduled arrival offsets (seconds from start) of a Poisson process
    at ``rate_rps``: i.i.d. exponential inter-arrival gaps."""
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / rate_rps, size=n_requests))


def run_open_loop(svc, stream: list, rate_rps: float, *,
                  seed: int = 0) -> LoadReport:
    """Offer ``stream`` at ``rate_rps`` on a Poisson arrival process.

    A batching service (anything with ``submit``) is driven
    asynchronously: arrivals enter the admission queue the moment they are
    due and ``pump`` advances the launch/resolve pipeline between
    arrivals. A synchronous service serves arrivals in order; if it falls
    behind schedule the backlog delay is charged to every queued request
    (latency counts from the scheduled arrival either way).
    """
    sched = poisson_schedule(len(stream), rate_rps, seed)
    if hasattr(svc, "submit"):
        t0 = time.perf_counter()
        tickets = []
        i = 0
        while i < len(stream):
            now = time.perf_counter() - t0
            while i < len(stream) and sched[i] <= now:
                q, eps = stream[i]
                tickets.append((svc.submit(q, eps=eps), sched[i]))
                i += 1
            svc.pump()
            if i < len(stream):
                now = time.perf_counter() - t0
                if sched[i] > now:
                    time.sleep(min(sched[i] - now, 5e-4))
        svc.drain()
        wall = time.perf_counter() - t0
        lat = [1000 * ((t.t_done - t0) - s) for t, s in tickets]
    else:
        t0 = time.perf_counter()
        lat = []
        for (q, eps), s in zip(stream, sched):
            now = time.perf_counter() - t0
            if now < s:
                time.sleep(s - now)
            svc.query(q, eps=eps)
            lat.append(1000 * ((time.perf_counter() - t0) - s))
        wall = time.perf_counter() - t0
    return _report("open", rate_rps, lat, wall, stream, svc)


def run_closed_loop(svc, stream: list, *,
                    concurrency: int = 1) -> LoadReport:
    """Serve ``stream`` with a fixed window of ``concurrency`` outstanding
    requests -- the service's capacity measurement (no arrival model, so
    no queue delay: latency is pure service time at this concurrency)."""
    if hasattr(svc, "submit"):
        t0 = time.perf_counter()
        tickets = []
        for base in range(0, len(stream), concurrency):
            window = stream[base:base + concurrency]
            ts = [svc.submit(q, eps=eps) for q, eps in window]
            svc.pump()
            svc.drain()
            tickets.extend(ts)
        wall = time.perf_counter() - t0
        lat = [t.latency_ms() for t in tickets]
    else:
        t0 = time.perf_counter()
        lat = []
        for q, eps in stream:
            s0 = time.perf_counter()
            svc.query(q, eps=eps)
            lat.append(1000 * (time.perf_counter() - s0))
        wall = time.perf_counter() - t0
    return _report("closed", None, lat, wall, stream, svc)


def frontier_sweep(svc, stream: list, rates: list, *,
                   seed: int = 0) -> list:
    """Open-loop sweep over offered rates: one LoadReport per rate (the
    latency/throughput frontier). The same stream replays at every rate so
    points differ only in arrival schedule."""
    return [run_open_loop(svc, stream, r, seed=seed) for r in rates]


def main(argv=None):
    from repro_torch.launch.serve import (BatchingJoinService, JoinService,
                                          ShardedJoinService)

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--points", type=int, default=20000)
    ap.add_argument("--dims", type=int, default=4)
    ap.add_argument("--eps", type=float, default=2.0)
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--rate", type=float, default=None,
                    help="open-loop offered req/s (omit for closed loop)")
    ap.add_argument("--conc", type=int, default=1,
                    help="closed-loop outstanding-request window")
    ap.add_argument("--sizes", type=int, nargs="+", default=[32, 64, 256])
    ap.add_argument("--eps-mix", type=float, nargs="+", default=[],
                    help="request eps values drawn uniformly (all <= "
                         "--eps); empty serves every request at --eps")
    ap.add_argument("--batching", action="store_true")
    ap.add_argument("--max-batch", type=int, default=1024)
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    ap.add_argument("--slabs", type=int, default=1,
                    help="slab-sharded serving (ShardedJoinService, or "
                         "BatchingJoinService(n_slabs=) with --batching)")
    ap.add_argument("--return-pairs", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="CUDA by default; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(args.seed)
    pts = rng.uniform(0, 100, size=(args.points, args.dims))
    if args.batching:
        svc = BatchingJoinService(
            pts, args.eps, n_slabs=args.slabs,
            return_pairs=args.return_pairs, max_batch=args.max_batch,
            max_wait_ms=args.max_wait_ms, device=args.device)
        svc.warmup()
    elif args.slabs > 1:
        svc = ShardedJoinService(pts, args.eps, args.slabs,
                                 return_pairs=args.return_pairs,
                                 device=args.device)
        svc.warmup(max(args.sizes))
    else:
        svc = JoinService(pts, args.eps, return_pairs=args.return_pairs,
                          device=args.device)
        svc.warmup(max(args.sizes))
    mix = RequestMix(sizes=tuple(args.sizes),
                     eps_values=tuple(args.eps_mix))
    stream = make_request_stream(args.requests, mix, args.dims,
                                 seed=args.seed + 1)
    if args.rate is not None:
        rep = run_open_loop(svc, stream, args.rate, seed=args.seed + 2)
    else:
        rep = run_closed_loop(svc, stream, concurrency=args.conc)
    svc.assert_no_retrace()
    d = rep.to_dict()
    print("[loadgen] " + " ".join(f"{k}={v}" for k, v in d.items()))
    return rep


if __name__ == "__main__":
    main()
