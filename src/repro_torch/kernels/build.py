"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file compiles with ``nvcc`` into a shared library with a
plain C interface, loaded with ``ctypes``: no PyTorch headers, so a build
takes seconds. Libraries go to ``build/repro_torch/`` at the repository
root, named by a hash of the sources and flags, so an edited source
rebuilds and an unchanged one is reused. The build runs at first use.

``-fmad=false`` is part of the contract: the kernels reproduce the plain
PyTorch versions bit for bit, and those never contract a multiply-add.
``-cudart shared`` links the CUDA runtime that PyTorch loads, rather than a
static copy, so the launches go through the runtime the profiler traces.

``build_all`` starts one ``nvcc`` per source at once and waits for all.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-cudart", "shared", "-Xptxas", "-v",
              "-shared", "-Xcompiler", "-fPIC")
SOURCES = ("fused_join", "distance_tile", "cell_join", "emit_pairs")

_LIBS: dict = {}
# nvcc builds started and libraries loaded since import: work a serving
# request must never cause (``core.query_join.executable_cache_stats``).
EVENTS = {"builds": 0, "loads": 0}


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda/bin/nvcc``, else
    ``nvcc`` on the PATH."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on "
                           "the PATH to build the CUDA kernels")
    return found


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_all(names=SOURCES) -> dict:
    """Compile each ``csrc/<name>.cu`` whose library does not exist, all
    at once. Returns {name: (library path, compiler output)}; the output is
    empty when nothing was built (``-Xptxas -v`` reports registers and
    shared memory per kernel)."""
    out, procs = {}, {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            out[name] = (lib, "")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        EVENTS["builds"] += 1
        procs[name] = (lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (lib, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}) building "
                          f"{name}.cu:\n{log}")
            continue
        os.replace(tmp, lib)
        out[name] = (lib, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        path, _ = build_all([name])[name]
        lib = ctypes.CDLL(str(path))
        EVENTS["loads"] += 1
        _LIBS[name] = lib
    return lib
