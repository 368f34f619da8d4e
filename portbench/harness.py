"""One run of one cell: set-up, the window, the check, the result line.

Everything that belongs to one configuration, traffic mix or metric is found
by name under this folder:

- ``BENCHMARK.json`` (the repository root) lists cells, configurations and
  metrics;
- a configuration is the JSON file the manifest names; it names its data
  ``generator`` (``generators/<name>.py``) and its plain ``reference``
  (``references/<name>.py``);
- a traffic mix is ``traffic/<name>.json``; it names the program's
  ``entry``, its ``driver`` (``drivers/<name>.py``), which makes the calls
  and keeps some as (inputs, result), and its ``check``
  (``checks/<name>.py``), which judges a kept call against the
  configuration's reference on the call's own inputs;
- a metric is read by ``metrics/<name>.py``'s ``read(record)``, which
  returns None where it finds nothing to read.
"""
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

# whole top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(root: Path, kind: str, name: str):
    """``portbench/<kind>/<name>.py`` under ``root``, loaded from its file."""
    path = root / "portbench" / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} module {path}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name}".replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def resolve(root: Path, workload: str) -> SimpleNamespace:
    """The cell's manifest entries, configuration and traffic mix."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"known: {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[cell["config"]]["file"])
    traffic = load_json(root / "portbench" / "traffic" /
                        f"{cell['traffic']}.json")
    return SimpleNamespace(bench=bench, cell=cell, config=config,
                           traffic=traffic)


def cell_metrics(bench: dict, workload: str, section: str) -> list:
    """The entries of ``section`` (``end_to_end`` or ``per_layer``) that the
    cell reports: those without ``workloads`` and those that list it."""
    return [m for m in bench[section]
            if workload in m.get("workloads", [workload])]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def import_program(root: Path):
    """``repro_torch`` from the checkout's ``src``."""
    src = root / "src"
    if not (src / "repro_torch" / "__init__.py").is_file():
        raise SystemExit(f"the program repro_torch is not under {src}")
    if str(src) not in sys.path:
        sys.path.insert(0, str(src))
    import repro_torch
    return repro_torch


def run_cell(root: Path, workload: str, *, seed: int, seconds: float,
             trace: bool, device: str = "cuda", t0: float = None,
             overrides: dict = None, wrap=None) -> tuple:
    """Run the cell once. Returns (result dict, check lines).

    The traffic's driver makes the calls: its ``run(entry, ...)`` returns
    (setup_s, window, trace or None), where the window has ``calls``,
    ``elapsed_s``, ``process_peak_bytes``, ``setup_builds``, ``builds`` and
    ``kept``, the calls kept for the check as (inputs, result). The
    traffic's check judges each with ``numbers(inputs, result, reference=,
    traffic=)`` against its ``LIMITS``. ``overrides`` replaces keys
    of the configuration and ``wrap(entry)`` puts something in the program
    entry's place: for the control, and for the tests, which run the harness
    on a CPU at a small size and with faults planted under it."""
    import torch

    t0 = time.perf_counter() if t0 is None else t0
    spec = resolve(root, workload)
    config = dict(spec.config, **(overrides or {}))
    traffic = spec.traffic
    dev = torch.device(device)
    program = import_program(root)
    from repro_torch.kernels import build
    entry = getattr(program, traffic["entry"])
    if wrap is not None:
        entry = wrap(entry)
    driver = load_module(root, "drivers", traffic["driver"])
    setup_s, window, traced = driver.run(
        entry, config=config, traffic=traffic, seed=seed, seconds=seconds,
        trace=trace, device=dev, t0=t0,
        load=lambda kind, name: load_module(root, kind, name),
        builds=lambda: build.EVENTS["builds"])
    if window.builds:
        raise RuntimeError(f"{window.builds} kernel builds fell inside the "
                           f"measured window")
    memory_peak = window.process_peak_bytes

    # the check, after the window, on the kept calls' own inputs
    reference = load_module(root, "references", config["reference"])
    check = load_module(root, "checks", traffic["check"])
    kept, window.kept = window.kept, []
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    totals = {}
    failed = checked = 0
    while kept:
        inputs, result = kept.pop(0)
        numbers = check.numbers(inputs, result, reference=reference,
                                traffic=traffic)
        failed += any(v > check.LIMITS[k] for k, v in numbers.items())
        for k, v in numbers.items():
            totals[k] = totals.get(k, 0) + v
        checked += 1
        del inputs, result
    reference_s = time.perf_counter() - t_ref
    checks = {k: {"value": v, "limit": check.LIMITS[k]}
              for k, v in totals.items()}
    checks["calls_checked"] = {"value": checked, "limit": 1}
    correct = failed == 0 and checked >= 1

    record = SimpleNamespace(config=config, traffic=traffic, setup_s=setup_s,
                             window=window, trace=traced)
    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell_metrics(spec.bench, workload, section):
        value = load_module(root, "metrics", m["name"]).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    cuda = dev.type == "cuda"
    device_info = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "count": int(spec.cell["chips"]),
        "memory_peak_bytes": int(memory_peak)}
    result = {"correct": bool(correct), "attempted": window.calls,
              "failed": failed, "metrics": metrics, "device": device_info}
    if traced is not None:
        from portbench import trace as trace_lib
        device_info["busy_s"] = traced.busy_s
        device_info["window_s"] = traced.window_s
        result["breakdown"] = trace_lib.breakdown(traced)
    result["run"] = {"calls": window.calls, "window_s": window.elapsed_s,
                     "setup_s": setup_s, "setup_builds": window.setup_builds,
                     "reference_s": reference_s,
                     "card": card_line() if cuda else "cpu"}
    latencies = getattr(window, "latencies_s", [])
    if len(latencies) >= 2:
        result["run"]["latency_quartiles_s"] = statistics.quantiles(
            latencies, n=4)
    if traced is not None:
        result["run"]["host_ops_ms"] = traced.host_ops
    result["checks"] = checks
    lines = [f"check {k}: {v['value']} (limit {v['limit']})"
             for k, v in checks.items()]
    return result, lines


def card_line() -> str:
    """The card's name and power limit, by nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError) as err:
        return f"nvidia-smi failed: {err}"
    return out.strip().splitlines()[0] if out.strip() else "unknown"


def main(args, *, root: Path, t0: float) -> int:
    import torch

    spec = resolve(root, args.workload)
    chips = int(spec.cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    env = {k: v for k, v in os.environ.items()
           if k.startswith("REPRO_TORCH_") or k == "PYTORCH_CUDA_ALLOC_CONF"}
    print(f"portbench: REPRO_TORCH_* and the allocator's settings in the "
          f"environment: {env}", file=sys.stderr)
    result, lines = run_cell(root, args.workload, seed=args.seed,
                             seconds=args.seconds, trace=bool(args.trace),
                             t0=t0)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}; nothing it runs may load "
              f"JAX or the JAX package", file=sys.stderr)
        return 4
    for line in lines:
        print(line, file=sys.stderr, flush=True)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0
