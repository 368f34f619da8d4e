"""Architecture registry, the counterpart of ``repro.configs``: the paper's
own workload and a generic LM smoke arch.

``smoke_lm`` is the one generic stand-in that keeps the LM substrate
(``models/``, ``launch/serve.py --arch smoke-lm``) drivable. Each
``configs/<arch>.py`` exports:

    CONFIG   -- the arch's full configuration
    REDUCED  -- a small same-family config for CPU smoke tests

``selfjoin`` (the paper's system) carries its own SHAPES/workloads; the LM
shape cells (the dry-run grid) are kept for the smoke arch.
"""
from __future__ import annotations

import dataclasses
import importlib

ARCHS = [
    "smoke_lm",
]

# canonical ids -> module names
ALIASES = {
    "smoke-lm": "smoke_lm",
    "selfjoin": "selfjoin",
}


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES = (
    ShapeCell("train_4k", 4096, 256, "train"),
    ShapeCell("prefill_32k", 32768, 32, "prefill"),
    ShapeCell("decode_32k", 32768, 128, "decode"),
    ShapeCell("long_500k", 524288, 1, "decode"),
)


def get_config(arch: str, *, reduced: bool = False):
    mod_name = ALIASES.get(arch, arch.replace("-", "_").replace(".", "_"))
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.REDUCED if reduced else mod.CONFIG


def cell_plan(arch: str):
    """List of (ShapeCell, skip_reason|None) for an architecture."""
    cfg = get_config(arch)
    plan = []
    for cell in SHAPES:
        skip = None
        if cell.kind == "decode" and not cfg.has_decode:
            skip = "encoder-only: no decode step"
        elif cell.name == "long_500k" and not cfg.sub_quadratic:
            skip = ("full attention is quadratic at 500k context; "
                    "run only for SSM/hybrid (DESIGN.md)")
        elif cell.name == "prefill_32k" and not cfg.has_decode:
            skip = None  # encoder: prefill cell = encoder forward
        plan.append((cell, skip))
    return plan


def all_cells():
    """Every (arch, cell, skip) across the registry."""
    out = []
    canon = {v: k for k, v in ALIASES.items()}
    for arch in ARCHS:
        for cell, skip in cell_plan(arch):
            out.append((canon[arch], cell, skip))
    return out
