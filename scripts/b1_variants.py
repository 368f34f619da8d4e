#!/usr/bin/env python3
"""Time design variants of B1's self-join kernel (``fused_join_kernel_self``
in ``csrc/fused_join.cu``) on the card.

Run from the repository root on a machine with an NVIDIA H100:

    PYTHONPATH=src python3 scripts/b1_variants.py [NAMES]

Each variant is ``fused_join.cu`` with one change to the self-join kernel,
built with the repository's nvcc flags into ``build/b1_variants/`` (one
nvcc each, started together) and loaded in place of the package's library,
so the launches go through the package's wrapper. Each is timed on B1's
self-join launches by ``chip_smoke.b1_launch_times`` (device time by
kernel name, events over back-to-back passes, the outputs' checksum): the
main path's 3 launches at f64 (row loop; the run loop is the same kernel)
and the float16 main path's 4, slab 1 of the 4-slab join's 3 (global ids)
and the expo-3d bench workload's widest launch, in turns, two rounds.
Every variant must give the kept kernel's checksums. Variants:

  kept        the kernel as it is (at n_real 1-2 five blocks an SM: at
              most 51 registers)
  reload      a lane loads its window slot for every row, as B1 (b) does:
              no slot held across the rows of a run
  q_memory    each row's query lanes read from device memory (through
              L1) at every slot step, not from the block's shared stage
  nr_runtime  every launch through the instance that reads n_real at run
              time (its coordinate loops predicated lane by lane up to 8)
  blocks4     four blocks an SM at n_real 1-2 (at most 64 registers; the
              compiler chose 58 at f64 unbounded)
  blocks6     six blocks an SM at n_real 1-2 (at most 42 registers)
  spread      every launch spread over blocks (kSpreadTiles, and the
              wrapper's mirror SPREAD_TILES, past any launch)
  tile        every self-join launch one block a tile (kSpreadTiles 0)
  wide        no narrow steps: 32 slots of one row a step whatever the
              window (self_layout as for the global-id launches)

Besides the four cases above, every launch of the seven bench workloads'
joins (f64) is timed alone, so the layouts and the narrow steps can be
compared launch by launch, by tiles and window capacity (the
kSpreadTiles threshold, windows of at most 16 slots).
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build, fused_join as fj  # noqa: E402

OUT = ROOT / "build" / "b1_variants"
BLOCKS = "constexpr int self_blocks(int nr) { return nr == 1 || nr == 2 ? 5 : 4; }"
PATCHES = {
    "kept": [],
    "reload": [("if (live && start != held_start) {", "if (live) {")],
    "q_memory": [("const T* q_row = q_s + (rc - r_block + r) * n_use;",
                  "const T* q_row = q_batch + (size_t)(row0 + r) * lanes;")],
    "nr_runtime": [("  switch (a.n_real) {\n    case 1: return launch_self",
                    "  switch (0) {\n    case 1: return launch_self")],
    "blocks4": [(BLOCKS, BLOCKS.replace("? 5 : 4", "? 4 : 4"))],
    "blocks6": [(BLOCKS, BLOCKS.replace("? 5 : 4", "? 6 : 4"))],
}
SPREAD = "constexpr int kSpreadTiles = 96;"
PATCHES.update(
    spread=[(SPREAD, "constexpr int kSpreadTiles = 1 << 30;")],
    tile=[(SPREAD, "constexpr int kSpreadTiles = 0;")],
    wide=[("self_layout(a.qp, a.tq, a.c, !GID)",
           "self_layout(a.qp, a.tq, a.c, false)")])
# the wrapper's mirror of each variant's layout rules
MIRROR = {"spread": dict(SPREAD_TILES=1 << 30), "tile": dict(SPREAD_TILES=0),
          "wide": dict(self_layout=lambda qp, tq, c, gid_pairs=False,
                       f=fj.self_layout: f(qp, tq, c, True))}


def build_variants(names):
    """Each variant's library, built in parallel: {name: (path, log)}."""
    src = (build.CSRC / "fused_join.cu").read_text()
    texts = {}
    for name in names:
        text = src
        for old, new in PATCHES[name]:
            if old not in text:
                raise RuntimeError(f"variant {name}: no {old!r} in the source")
            text = text.replace(old, new)
        texts[name] = text
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        cu = OUT / f"{name}.cu"
        cu.write_text(text)
        lib = OUT / f"lib{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = {name: proc.communicate()[0] for name, (_, proc) in procs.items()}
    failed = [f"nvcc failed on variant {name}:\n{logs[name]}"
              for name, (_, proc) in procs.items() if proc.returncode]
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: (lib, logs[name]) for name, (lib, _) in procs.items()}


def load(path):
    lib = ctypes.CDLL(str(path))
    lib.fused_join_launch.argtypes = fj._ARGTYPES
    lib.fused_join_launch.restype = ctypes.c_int
    lib.fused_join_smem_optin.argtypes = [ctypes.c_int]
    lib.fused_join_smem_optin.restype = ctypes.c_int
    return lib


def cases():
    """The timed launches: (name, launches, run loop)."""
    import repro_torch
    from repro_torch.core import distributed as dist, selfjoin as sj
    pts = cs.syn(cs.MAIN_POINTS, cs.MAIN_DIMS)

    def join(points, eps):
        index = repro_torch.build_grid(points, eps, device=cs.DEVICE)
        return cs.prepared_launches(
            index, merged=sj._resolve_merge(index, None), unicomp=True,
            run_loop=sj._join_run_loop(index))

    out = [("main_float64", join(pts, cs.MAIN_EPS), False),
           ("main_float16", join(cs.as_half(pts, torch.float16),
                                 cs.MAIN_EPS), False)]
    slab, = [s_ for s_ in dist.slab_indexes(pts, cs.MAIN_EPS,
                                            cs.SLAB_HELD[0],
                                            device=cs.DEVICE)
             if s_.slab == cs.SLAB_HELD[1]]
    out.append(("slab_gid", cs.prepared_launches(
        slab.index, merged=True, unicomp=True, slab=slab), False))
    work = cs.bench_workloads()
    expo = join(*work["expo-3d"])
    out.append(("expo3d_widest", [max(expo, key=lambda p: p["kw"]["c"])],
                False))
    bench = []
    for name in work:
        for p in join(*work[name]):
            tiles = p["args"][1].shape[0] // p["kw"]["tq"]
            bench.append((f"{name}_c{p['kw']['c']}_tiles{tiles}", [p],
                          False))
    return out, bench


def main() -> int:
    names = sys.argv[1:] or list(PATCHES) + list(LAYOUT_ONLY)
    if "kept" not in names:
        names.insert(0, "kept")                 # every check is against it
    built = build_variants(sorted(set(names)))
    libs = {n: load(built[n][0]) for n in names}
    ptxas = {n: cs.ptxas_by_kernel(log, cs.B1_KERNEL)
             for n, (_, log) in built.items()}
    print(cs.nvidia_smi_line(), flush=True)
    timed, bench = cases()
    saved = {k: getattr(fj, k) for m in MIRROR.values() for k in m}
    runs, sums = {}, {}
    for _ in range(2):
        for n in names:
            fj._kernel_library = lambda lib=libs[n]: lib
            for k, v in {**saved, **MIRROR.get(n, {})}.items():
                setattr(fj, k, v)
            # the bench launches one by one, for the layouts only
            every = timed + (bench if n in ("kept", "spread", "tile", "wide")
                             else [])
            for case, launches, run_loop in every:
                t = cs.b1_launch_times(launches, run_loop, reps=10)
                runs.setdefault(n, {}).setdefault(case, []).append(
                    t["device_ms"])
                sums.setdefault(case, {})[n] = t["checksum"]
    for k, v in saved.items():
        setattr(fj, k, v)
    for case, by in sums.items():
        cs.check(all(v == by["kept"] for v in by.values()),
                 f"{case}: variants disagree: {by}")
    print(json.dumps({"b1_variants": {
        n: {c: dict(device_ms=statistics.median(r), runs_ms=r)
            for c, r in runs[n].items()} for n in names},
        "ptxas": {n: {k: v for k, v in p.items()
                      if k in ("f64_merged1_gid0_nr2_narrow0",
                               "f16_merged1_gid0_nr2_narrow0",
                               "f64_merged1_gid1_nr2_narrow0",
                               "f64_merged1_gid0_nr4_narrow1",
                               "f64_merged0_gid0_nr0_narrow1")}
                  for n, p in ptxas.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
