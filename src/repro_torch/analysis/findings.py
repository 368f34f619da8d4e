"""Machine-readable findings and the committed-baseline diff protocol.

The counterpart of ``repro.analysis.findings``, with the same key format:
a finding of one contract on one index compares equal across the two
packages. A finding is one violated (or suspicious) contract instance. Its
``key`` leaves out line numbers and message text: baselines are keyed on
(analyzer, rule, site), where ``site`` is a file-qualified function name or
a geometry tag, so edits that shift lines do not churn the baseline, while
a NEW occurrence of a banned pattern in a new function is always a new key
(the gate: new findings fail ``scripts/ci_torch.sh``).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Iterable, Optional

SEV_ERROR = "error"
SEV_WARNING = "warning"


@dataclasses.dataclass(frozen=True)
class Finding:
    analyzer: str        # "contracts" | "lint"
    rule: str            # e.g. "cap-coverage", "host-sync"
    site: str            # "src/repro_torch/core/grid.py::_pad_probe" or "index:uniform-2d"
    message: str
    severity: str = SEV_ERROR
    line: Optional[int] = None   # informational; NOT part of the key

    @property
    def key(self) -> str:
        return f"{self.analyzer}:{self.rule}:{self.site}"

    def render(self) -> str:
        loc = f"{self.site}:{self.line}" if self.line else self.site
        return f"[{self.severity}] {self.analyzer}/{self.rule} {loc}: {self.message}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def baseline_keys(findings: Iterable[Finding]) -> list:
    """Sorted unique keys: the committed baseline's payload."""
    return sorted({f.key for f in findings})


def save_baseline(findings: Iterable[Finding], path: str) -> None:
    with open(path, "w") as fh:
        json.dump({"version": 1, "accepted": baseline_keys(findings)},
                  fh, indent=1)
        fh.write("\n")


def load_baseline(path: str) -> set:
    with open(path) as fh:
        payload = json.load(fh)
    return set(payload.get("accepted", []))


def new_findings(findings: Iterable[Finding], baseline: set) -> list:
    """Findings whose key the baseline does not accept."""
    return [f for f in findings if f.key not in baseline]


def report_json(findings: Iterable[Finding]) -> str:
    return json.dumps({"findings": [f.to_dict() for f in findings]}, indent=1)
