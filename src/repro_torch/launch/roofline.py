"""Roofline terms of a planned step on NVIDIA H100 SXM GPUs (no card needed).

The counterpart of ``repro.launch.roofline``. Three terms, in seconds a
step on one GPU:

    compute    = flops_per_device / PEAK_FLOPS            [dense bf16 peak]
    memory     = bytes_per_device / HBM_BW                [HBM3]
    collective = sum over the step's collectives of wire_bytes / link rate

``launch/dryrun.py`` supplies the numbers, from three sources of its own:
the FLOPs and the bytes from the step run eagerly on ``meta`` tensors
(``dryrun.CostMode``), and the collectives from a planning mesh
(``launch.mesh.PlanMesh``) that records each collective the step issues,
with its bytes and its member ranks. JAX reads the FLOPs and bytes from
XLA's ``cost_analysis()`` and parses the collectives out of the optimized
HLO text (``parse_collectives``, ``_group_info``, ``_loop_trip_counts``);
the port has no HLO, so the planning mesh's records do that work, and the
group of each is its exact list of member ranks, not a pattern read from
the text. An eager step runs every layer, so nothing is counted once for
a loop.

The ring model gives each collective's wire bytes a device, S being what
``LMMesh.timed`` counts for it:

    all-reduce          2 S (g-1)/g      S = the reduced buffer
    all-gather          S (g-1)/g        S = the gathered result
    reduce-scatter      S (g-1)          S = the scattered shard
    all-to-all          S (g-1)/g        S = the buffer sent
    collective-permute  S                one hop

A group whose member ranks span more than one node of ``NODE_SIZE``
ranks rides InfiniBand (``IB_BW``), one inside a node NVLink
(``NVLINK_BW``). Ranks are numbered node by node, as a launcher places
them, so rank r sits on node r // NODE_SIZE.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

# NVIDIA H100 Tensor Core GPU datasheet, H100 SXM column: 1,979 TFLOP/s of
# BF16 tensor work with 2:4 sparsity, half of it dense; 67 TFLOP/s FP32
# and FP64 tensor; 34 TFLOP/s FP64; 3.35 TB/s of HBM3; NVLink 900 GB/s,
# which is both directions together.
PEAK_FLOPS = 989.4e12            # dense BF16 tensor, flop/s a GPU
PEAK_FLOPS_FP32 = 67e12          # FP32 (CUDA cores)
PEAK_FLOPS_FP64_TENSOR = 67e12   # FP64 tensor
PEAK_FLOPS_FP64 = 34e12          # FP64 (CUDA cores)
HBM_BW = 3.35e12                 # bytes/s a GPU
NVLINK_BW = 450e9                # bytes/s a GPU, one direction
# NVIDIA DGX H100 datasheet: 8 H100 GPUs a node and 8 ConnectX-7 ports at
# 400 Gb/s for the compute fabric, one a GPU: 50 GB/s a GPU off the node.
IB_BW = 50e9                     # bytes/s a GPU, one direction
NODE_SIZE = 8                    # GPUs a node

# The most dynamic shared memory a block may opt in to on the H100
# (``cudaDevAttrMaxSharedMemoryPerBlockOptin``: 227 KiB; the H100 tuning
# guide); without the opt-in attribute a block gets 48 KiB
# (``fused_join.SMEM_DEFAULT``). The fused-join kernels' budget: the
# contract prover (``analysis/contracts.py``, C6) holds every launch's
# footprint (``self_smem_need``, ``jaccard_smem_need``) to it, as JAX's
# prover holds its kernel to ``VMEM_BYTES``.
SMEM_OPTIN_H100 = 232448

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")


def wire_bytes(kind: str, nbytes: float, group: int) -> float:
    """The ring model's wire bytes a device of one collective of ``kind``
    over ``group`` ranks, ``nbytes`` being S (module note)."""
    g = int(group)
    if kind == "all-reduce":
        return 2.0 * nbytes * (g - 1) / g
    if kind in ("all-gather", "all-to-all"):
        return nbytes * (g - 1) / g
    if kind == "reduce-scatter":
        return float(nbytes * (g - 1))
    if kind == "collective-permute":
        return float(nbytes)
    raise ValueError(f"unknown collective kind {kind!r}; one of {KINDS}")


def crosses_nodes(members: Sequence[int]) -> bool:
    """Whether ranks ``members`` span more than one node."""
    return len({int(r) // NODE_SIZE for r in members}) > 1


@dataclasses.dataclass
class Collective:
    kind: str              # one of KINDS
    bytes_result: int      # S
    group_size: int
    cross_node: bool
    wire_bytes: float      # a device
    seconds: float
    stat: str = ""         # the LMMesh.stats kind ("params", "grads", ...)


def collective(kind: str, nbytes: int, members: Sequence[int],
               stat: str = "") -> Collective:
    """One collective over ranks ``members`` (a permute: the sender and the
    receiver), timed at the link its group rides."""
    g = len(members)
    cross = crosses_nodes(members)
    wire = wire_bytes(kind, nbytes, g)
    bw = IB_BW if cross else NVLINK_BW
    return Collective(kind, int(nbytes), g, cross, wire, wire / bw, stat)


def bottleneck(compute_s: float, memory_s: float, collective_s: float) -> str:
    return max([("compute", compute_s), ("memory", memory_s),
                ("collective", collective_s)], key=lambda kv: kv[1])[0]


def summarize(flops: float, bytes_accessed: float,
              collectives: Sequence[Collective], chips: int) -> dict:
    """The three terms of one device's step: ``flops`` and
    ``bytes_accessed`` are a device's, ``collectives`` the step's
    schedule on that device, ``chips`` the mesh's size (recorded)."""
    compute_s = float(flops) / PEAK_FLOPS
    memory_s = float(bytes_accessed) / HBM_BW
    coll_s = sum(c.seconds for c in collectives)
    return {
        "chips": int(chips),
        "flops_per_device": float(flops),
        "bytes_per_device": float(bytes_accessed),
        "collectives": [dataclasses.asdict(c) for c in collectives],
        "n_collectives": len(collectives),
        "wire_bytes_per_device": sum(c.wire_bytes for c in collectives),
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": coll_s,
        "bottleneck": bottleneck(compute_s, memory_s, coll_s),
    }


def schedule(collectives: Sequence[Collective]) -> list:
    """The collectives grouped by (kind, bytes, group, node crossing,
    stat), each with its count, in first-issue order."""
    out: dict = {}
    for c in collectives:
        key = (c.kind, c.bytes_result, c.group_size, c.cross_node, c.stat)
        if key not in out:
            out[key] = {"kind": c.kind, "bytes": c.bytes_result,
                        "group": c.group_size, "cross_node": c.cross_node,
                        "stat": c.stat, "count": 0, "seconds": 0.0}
        out[key]["count"] += 1
        out[key]["seconds"] += c.seconds
    return list(out.values())


def traffic_floor(cfg, cell, chips: int) -> float:
    """Analytic lower bound on HBM bytes a device a step (JAX's, term for
    term): parameter reads (3x for train: fwd, remat-fwd, bwd), gradient
    and optimizer-state traffic (train), KV/SSM cache traffic
    (decode/prefill), boundary activations (train, remat)."""
    P = cfg.param_count()
    PA = cfg.active_param_count()
    bf16 = 2
    B, S = cell.global_batch, cell.seq_len
    if cell.kind == "train":
        act = cfg.n_layers * B * S * cfg.d_model * bf16 * 2   # save + reload
        opt = 2 * (4 + 4 + 4) * P                             # m/v/master r+w
        total = (3 * bf16 + 2 * bf16) * P + opt + act
    elif cell.kind == "prefill":
        cache = 2 * B * S * cfg.n_kv_heads * cfg.head_dim * cfg.n_layers * bf16
        act = cfg.n_layers * B * S * cfg.d_model * bf16
        total = bf16 * P + cache + act
    else:  # decode
        touched = min(1.0, B * max(cfg.top_k, 1) / max(cfg.n_experts, 1)) \
            if cfg.n_experts else 1.0
        params = bf16 * (PA + touched * (P - PA))
        cache = 0.0
        if cfg.family in ("dense", "moe", "vlm"):
            cache = 2 * B * S * cfg.n_kv_heads * cfg.head_dim * cfg.n_layers * bf16
        elif cfg.family == "hybrid":
            n_inv = -(-cfg.n_layers // cfg.shared_attn_every) \
                if cfg.shared_attn_every else 0
            cache = 2 * B * S * cfg.n_kv_heads * cfg.head_dim * n_inv * bf16
            H = cfg.d_inner // cfg.ssm_head_dim
            cache += 2 * B * H * cfg.ssm_state * cfg.ssm_head_dim * 4 * cfg.n_layers
        elif cfg.family == "ssm":
            dh = cfg.d_inner // cfg.n_heads
            cache = 2 * B * cfg.n_heads * dh * dh * 4 * cfg.n_layers
        total = params + cache
    return total / chips


def model_flops_check(cfg, cell, flops_per_device: float, chips: int):
    """MODEL_FLOPS = 6 N D (train; N the active parameters) or 2 N D
    (prefill, decode), against the counted FLOPs of the whole mesh."""
    n = cfg.active_param_count()
    if cell.kind == "train":
        tokens = cell.global_batch * cell.seq_len
        model_flops = 6.0 * n * tokens
    elif cell.kind == "prefill":
        tokens = cell.global_batch * cell.seq_len
        model_flops = 2.0 * n * tokens
    else:  # decode: one token per sequence
        tokens = cell.global_batch
        model_flops = 2.0 * n * tokens
    total = flops_per_device * chips
    return {
        "model_flops": model_flops,
        "hlo_flops_total": total,
        "useful_fraction": model_flops / total if total else 0.0,
    }
