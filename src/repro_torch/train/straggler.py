"""Straggler detection and mitigation hooks: a copy of
``repro.train.straggler`` (the port imports nothing of ``repro``).

At thousand-node scale the common failure smells are (a) a host whose steps
are consistently slow (bad HBM, thermal throttling, noisy neighbor) and (b) a
host that stops heartbeating entirely. This monitor implements the detection
side and exposes mitigation hooks the launcher wires up:

  * per-step wall time EWMA + variance; a step slower than
    ``threshold x EWMA`` increments a strike counter;
  * ``strikes >= patience`` -> ``should_rebalance()`` flips, and the train
    loop checkpoints + restarts on a smaller 'data' axis (elastic restore,
    ckpt/checkpoint.py) excluding the slow host;
  * heartbeat files (one per host) let any host detect a dead peer without
    a control plane -- missing heartbeat for ``dead_after`` seconds is
    treated like a failed step barrier.

In one process the monitor is exercised by tests with synthetic timings;
the decision logic is identical at scale.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Optional


@dataclasses.dataclass
class StragglerMonitor:
    threshold: float = 2.0      # x EWMA that counts as a slow step
    patience: int = 3           # consecutive strikes before rebalance
    alpha: float = 0.1          # EWMA coefficient
    warmup_steps: int = 5       # ignore compile/jit steps
    dead_after: float = 300.0   # heartbeat staleness -> dead host

    ewma: Optional[float] = None
    strikes: int = 0
    steps: int = 0
    slow_steps: int = 0

    def record(self, step_time: float) -> bool:
        """Feed one step's wall time; returns True if it counted as slow."""
        self.steps += 1
        if self.steps <= self.warmup_steps:
            return False
        if self.ewma is None:
            self.ewma = step_time
            return False
        slow = step_time > self.threshold * self.ewma
        if slow:
            self.strikes += 1
            self.slow_steps += 1
        else:
            self.strikes = 0
            # only fold non-outlier steps into the EWMA
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * step_time
        return slow

    def should_rebalance(self) -> bool:
        return self.strikes >= self.patience

    def reset(self):
        self.strikes = 0

    # -- heartbeat files (cross-host liveness without a control plane) ------

    @staticmethod
    def heartbeat(directory: str, host_id: int, step: int):
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, f"host_{host_id}.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"step": step, "time": time.time()}, f)
        os.replace(tmp, path)

    def dead_hosts(self, directory: str, now: Optional[float] = None) -> list:
        now = now or time.time()
        dead = []
        if not os.path.isdir(directory):
            return dead
        for fn in os.listdir(directory):
            if fn.startswith("host_") and fn.endswith(".json"):
                with open(os.path.join(directory, fn)) as f:
                    hb = json.load(f)
                if now - hb["time"] > self.dead_after:
                    dead.append(int(fn.split("_")[1].split(".")[0]))
        return sorted(dead)
