"""Static analysis and the sanitized kernel mode of the port (DESIGN.md S9).

The counterpart of ``repro.analysis``, over ``repro_torch``:

  * ``analysis.contracts`` -- a contract prover that re-derives the
    bounded-search invariants (window capacities, slot-base arithmetic,
    halo parcels, key sentinels, shared memory per block) from an index's
    geometry with INDEPENDENT algorithms and checks the planners against
    them, without launching a kernel.
  * ``analysis.lint`` -- an AST linter over ``src/repro_torch/`` for
    per-call compiles, host syncs on the launch path, hard-coded int64 key
    sentinels and inlined eps-squared predicates, plus a static
    no-retrace model of ``PreparedJoin.warm``.
  * ``analysis.sanitize`` -- the opt-in ``REPRO_TORCH_SANITIZE=1`` kernel
    mode: every launch of kernel B1 is followed by a device-side
    error-code reduction that the drivers raise at their sync points.

``python -m repro_torch.analysis`` runs the prover and the linter against
the committed findings baseline (``scripts/analysis_baseline_torch.json``);
``scripts/ci_torch.sh`` fails on any NEW finding.
"""
from repro_torch.analysis.findings import (Finding, baseline_keys,
                                           load_baseline, new_findings,
                                           save_baseline)

__all__ = [
    "Finding",
    "baseline_keys",
    "load_baseline",
    "new_findings",
    "save_baseline",
]
