"""The comparison that decides ``correct`` for a self-join that returns pairs.

A kept call's inputs are its ``points`` and ``eps``; the configuration's
reference works out the pairs of those points itself, as sorted int64 keys
``i * n + j``, and the program's (K, 2) ids are set against them. Each
number is exact and has the limit 0:

- ``missing_pairs``: pairs the reference finds and the program does not;
- ``extra_pairs``: rows the program returns that are not a reference pair:
  ids out of range, pairs outside eps, self pairs, and repeats of a pair;
- ``order_breaks``: for a traffic whose entry promises sorted pairs, the
  rows that do not come strictly after the row before them.
"""
import torch

LIMITS = {"missing_pairs": 0, "extra_pairs": 0, "order_breaks": 0}


def numbers(inputs: dict, result: torch.Tensor, *, reference,
            traffic: dict) -> dict:
    """The numbers of one kept call, to be summed over the calls checked."""
    points = inputs["points"]
    ref = reference.pair_keys(points, inputs["eps"])
    return compare(result, ref, points.shape[0],
                   sorted_expected=bool(traffic["sorted"]))


def compare(result: torch.Tensor, ref_keys: torch.Tensor, n: int,
            *, sorted_expected: bool, chunk: int = 1 << 26) -> dict:
    """The numbers of ``result`` against the reference's keys, ``chunk``
    rows of the result at a time, so that the check fits on the card
    beside the reference's keys."""
    if result.ndim != 2 or result.shape[-1] != 2:
        raise ValueError(f"a join returned pairs of shape "
                         f"{tuple(result.shape)}")
    dev = ref_keys.device
    seen = torch.zeros(ref_keys.numel(), dtype=torch.bool, device=dev)
    outside = found = breaks = 0
    last = None
    for s in range(0, result.shape[0], chunk):
        pairs = result[s:s + chunk].to(dev, torch.int64)
        keys = pairs[:, 0] * n + pairs[:, 1]
        if sorted_expected:
            run = keys if last is None else torch.cat([last, keys])
            breaks += int((run[1:] <= run[:-1]).sum())
            last = keys[-1:]
        in_range = ((pairs >= 0) & (pairs < n)).all(dim=1)
        outside += int((~in_range).sum())
        keys = keys[in_range]
        if ref_keys.numel() == 0:
            outside += keys.numel()
            continue
        at = torch.searchsorted(ref_keys, keys).clamp_(
            max=ref_keys.numel() - 1)
        hit = ref_keys[at] == keys
        outside += int((~hit).sum())
        found += int(hit.sum())
        seen[at[hit]] = True
    matched = int(seen.sum())
    out = {}
    if sorted_expected:
        out["order_breaks"] = breaks
    # rows beyond the first of a pair are repeats, and extra
    out["extra_pairs"] = outside + found - matched
    out["missing_pairs"] = ref_keys.numel() - matched
    return out
