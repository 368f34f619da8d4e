"""Uniform points in [low, high)^dims, drawn on the device in one call.

The synthetic sets of Gowanlock & Karsin (arXiv:1803.04120, Table I) are
uniform; the range [0, 100) is the repository's own generators'
(``chip_smoke.py::syn``, ``benchmarks/common.py::syn``, numpy), drawn here
with a ``torch.Generator`` on the card instead, so a call's points cost
microseconds and never cross the host.
"""
import torch

DTYPES = {"float64": torch.float64, "float32": torch.float32}


def make(config: dict, seed: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    low, high = float(config["low"]), float(config["high"])
    pts = torch.rand((int(config["points"]), int(config["dims"])),
                     generator=gen, dtype=DTYPES[config["dtype"]],
                     device=device)
    return pts.mul_(high - low).add_(low)
