"""Compile, sync and dtype linter: AST rules + a static no-retrace model.

The counterpart of ``repro.analysis.lint``, its rules re-based for torch.
AST rules over ``src/repro_torch/``:

  per-call-compile    a ``torch.compile``, ``torch.jit.script`` or
                      ``torch.jit.trace`` (called, or as a decorator)
                      inside a function body: every call of the enclosing
                      function compiles afresh (the JAX package's
                      per-call-jit class). Module-level ones are fine; the
                      port has none.
  host-sync           ``.item()``, ``.cpu()``, ``.tolist()``, ``.numpy()``
                      or ``torch.cuda.synchronize()`` on the launch path:
                      ``kernels/ops.py`` and the wrappers, CUDA routes,
                      launches and sanitizer of ``kernels/fused_join.py``,
                      ``distance_tile.py`` and ``cell_join.py``. Each blocks
                      the host on the device; the wrappers must queue work
                      and return. The static half of ``chip_smoke.py``'s
                      ``sync_check``, which runs the wrappers under
                      ``torch.cuda.set_sync_debug_mode("error")``.
  host-sync-cast      (warning) ``int()``, ``float()`` or ``bool()`` of a
                      non-literal on the launch path: it syncs when the
                      value is a tensor, and not when it is a Python flag,
                      which the linter cannot tell apart; accepted sites
                      are named in the baseline.
  int64-key-literal   ``iinfo`` of int64, the bare 2^63-1 literal, a
                      ``PAD_KEY`` read, or an int64 dtype hard-coded as a
                      key dtype (assigned to ``kd`` / ``*key_dtype*`` or
                      passed as ``key_dtype=``) outside
                      ``grid.key_dtype_for`` and ``grid.device_key_dtype``:
                      on int32-keyed grids such a sentinel overflows or
                      never matches; key code goes through
                      ``grid.pad_key_for`` / ``key_dtype_for``.
  eps-squared-predicate  a hard-coded eps-squared comparison (the radius
                      times itself, or to the power 2) outside
                      ``core/metric.py``, which owns every refine predicate:
                      an inlined square evaluates L2 for every metric.

Static no-retrace check (``check_no_retrace``): enumerates, by pure
``bucket_rows`` / capacity-class arithmetic, every fused-launch
configuration a canned request mix can demand -- (capacity, tile, padded
rows, keep_hits), the JAX package's keys -- and proves it a subset of the
warmed set. The port's kernels are built once per process, so a padded row
count needs nothing built; the contract the keys carry is
``query_join.py``'s: ``PreparedJoin.warm`` has launched every class the
mix can reach, so a steady-state request loads no kernel library and
redoes no prepare-time build (``serve.assert_no_retrace`` watches the
counters at run time).
"""
from __future__ import annotations

import ast
import os
import re
from typing import Iterable, Optional

from repro_torch.analysis.findings import SEV_WARNING, Finding

_AN = "lint"
RULE_COMPILE = "per-call-compile"
RULE_SYNC = "host-sync"
RULE_CAST = "host-sync-cast"
RULE_I64 = "int64-key-literal"
RULE_EPS = "eps-squared-predicate"

# the one module allowed to spell the squared-threshold arithmetic: the
# metric trait that owns every refine predicate
_EPS_OWNER = "core/metric.py"

# the functions that decide the key dtype, where an int64 literal belongs
_KEY_DTYPE_OWNERS = {("core/grid.py", "key_dtype_for"),
                     ("core/grid.py", "device_key_dtype")}

# the launch path: every function of ops.py, and in the kernel modules the
# wrappers, their CUDA routes and launches, and the sanitizer's checker
_LAUNCH_MODULES = ("kernels/fused_join.py", "kernels/distance_tile.py",
                   "kernels/cell_join.py")
_LAUNCH_FUNCS = re.compile(
    r"^(_?(fused_join|distance_tile|cell_join)_\w*|_launch\w*"
    r"|sanitize_errcodes|oob_windows)$")

_I64_MAX = (1 << 63) - 1          # spelled as a shift so we don't self-flag
_SYNC_METHODS = ("item", "cpu", "tolist", "numpy")
_CASTS = ("int", "float", "bool")
_KEY_DTYPE_NAME = re.compile(r"^(kd|\w*_kd|\w*key_dtype\w*)$")


def _dotted(node) -> str:
    """'torch.jit.script' for an Attribute chain over a Name, else ''."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


_COMPILERS = ("torch.compile", "torch.jit.script", "torch.jit.trace",
              "jit.script", "jit.trace")


def _is_compile_ref(node) -> bool:
    return _dotted(node) in _COMPILERS


def _is_compile_maker(node) -> bool:
    """A Call expression that creates a compiled callable: a compiler
    called, or ``functools.partial`` of one."""
    if not isinstance(node, ast.Call):
        return False
    if _is_compile_ref(node.func):
        return True
    return (_dotted(node.func).split(".")[-1] == "partial"
            and any(_is_compile_ref(a) for a in node.args))


def _decorator_compiles(dec) -> bool:
    return _is_compile_ref(dec) or _is_compile_maker(dec)


def _is_int64_ref(node) -> bool:
    if isinstance(node, ast.Attribute) and node.attr == "int64":
        return True
    if isinstance(node, ast.Name) and node.id == "int64":
        return True
    # np.dtype(np.int64)
    return (isinstance(node, ast.Call) and _dotted(node.func).endswith("dtype")
            and len(node.args) == 1 and _is_int64_ref(node.args[0]))


_EPS_IDENT = re.compile(r"(?:^|_)eps")   # eps, eps_geom, metric_eps; NOT steps


def _is_eps_ref(node) -> bool:
    """A Name/Attribute whose terminal identifier is an epsilon: 'eps',
    'eps_geom', 'self.eps', 'index.metric_eps', ... The 'eps' token must
    start the identifier or a ``_``-separated word of it, so 'steps' and
    'depth_steps' do not flag."""
    if isinstance(node, ast.Attribute):
        return bool(_EPS_IDENT.search(node.attr.lower()))
    return isinstance(node, ast.Name) and bool(_EPS_IDENT.search(node.id.lower()))


def _is_eps_square(node) -> bool:
    """The banned squaring shapes: an eps reference multiplied by the
    SAME eps reference, or an eps reference raised to the power 2."""
    if not isinstance(node, ast.BinOp):
        return False
    if isinstance(node.op, ast.Mult):
        return (_is_eps_ref(node.left) and _is_eps_ref(node.right)
                and ast.dump(node.left) == ast.dump(node.right))
    if isinstance(node.op, ast.Pow):
        return (_is_eps_ref(node.left)
                and isinstance(node.right, ast.Constant)
                and node.right.value == 2)
    return False


class _Linter(ast.NodeVisitor):
    def __init__(self, relpath: str):
        self.relpath = relpath
        self.stack: list = []        # enclosing class/function names
        self.func_depth = 0
        self.launch_depth = 0        # > 0: inside a launch-path function
        self.skip: set = set()       # decorator node ids (not per-call)
        self.findings: list = []
        self.all_launch = relpath.endswith("kernels/ops.py")
        self.launch_module = self.all_launch or any(
            relpath.endswith(m) for m in _LAUNCH_MODULES)

    def _qual(self) -> str:
        return ".".join(self.stack) if self.stack else "<module>"

    def _site(self) -> str:
        return f"{self.relpath}::{self._qual()}"

    def _add(self, rule: str, message: str, node, severity: str = "error"):
        self.findings.append(Finding(
            _AN, rule, self._site(), message, severity=severity,
            line=getattr(node, "lineno", None)))

    def _key_dtype_owner(self) -> bool:
        return any(self.relpath.endswith(mod) and fn in self.stack
                   for mod, fn in _KEY_DTYPE_OWNERS)

    # -- scopes -------------------------------------------------------------

    def visit_ClassDef(self, node):
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    def _visit_func(self, node):
        compiled = any(_decorator_compiles(d) for d in node.decorator_list)
        for d in node.decorator_list:
            for sub in ast.walk(d):
                self.skip.add(id(sub))
        if self.func_depth > 0 and compiled:
            self._add(RULE_COMPILE,
                      f"per-call compile: '{node.name}' is compiled afresh "
                      f"on every call of '{self._qual()}' (hoist it to "
                      f"module level)", node)
        launch = self.launch_module and (
            self.all_launch or self.launch_depth > 0
            or bool(_LAUNCH_FUNCS.match(node.name)))
        self.stack.append(node.name)
        self.func_depth += 1
        self.launch_depth += int(launch)
        # decorators were evaluated in the ENCLOSING scope; still walk them
        # for int64 literals etc.
        for d in node.decorator_list:
            self.visit(d)
        for item in node.body:
            self.visit(item)
        self.launch_depth -= int(launch)
        self.func_depth -= 1
        self.stack.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    # -- rules --------------------------------------------------------------

    def visit_Call(self, node):
        if (self.func_depth > 0 and id(node) not in self.skip
                and _is_compile_maker(node)):
            self._add(RULE_COMPILE,
                      f"{_dotted(node.func) or 'compile'} called inside a "
                      f"function body: the compiled callable and its cache "
                      f"are rebuilt per call (hoist it to module level)",
                      node)
        if self.launch_depth > 0:
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr in _SYNC_METHODS:
                self._add(RULE_SYNC,
                          f".{f.attr}() on the launch path blocks the host "
                          f"on the device", node)
            elif _dotted(f).endswith("cuda.synchronize"):
                self._add(RULE_SYNC,
                          "torch.cuda.synchronize() on the launch path "
                          "blocks the host on the device", node)
            elif (isinstance(f, ast.Name) and f.id in _CASTS and node.args
                  and not isinstance(node.args[0], ast.Constant)):
                self._add(RULE_CAST,
                          f"{f.id}() of a non-literal on the launch path "
                          f"syncs if the value is a tensor", node,
                          severity=SEV_WARNING)
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr == "iinfo"
                and any(_is_int64_ref(a) for a in node.args)):
            self._add(RULE_I64,
                      "iinfo(int64) sentinel: breaks the int32 key route; "
                      "derive sentinels via grid.pad_key_for(key dtype)",
                      node)
        for kw in node.keywords:
            if (kw.arg == "key_dtype" and _is_int64_ref(kw.value)
                    and not self._key_dtype_owner()):
                self._add(RULE_I64,
                          "key_dtype=int64 hard-coded: the key dtype comes "
                          "from grid.key_dtype_for / device_key_dtype", node)
        self.generic_visit(node)

    def visit_Assign(self, node):
        if _is_int64_ref(node.value) and not self._key_dtype_owner():
            for tgt in node.targets:
                if (isinstance(tgt, ast.Name)
                        and _KEY_DTYPE_NAME.match(tgt.id)):
                    self._add(RULE_I64,
                              f"'{tgt.id}' hard-codes an int64 key dtype: "
                              f"the key dtype comes from "
                              f"grid.key_dtype_for / device_key_dtype", node)
        self.generic_visit(node)

    def visit_Name(self, node):
        if node.id == "PAD_KEY" and isinstance(node.ctx, ast.Load):
            self._add(RULE_I64,
                      "PAD_KEY is the int64-max sentinel: on int32-keyed "
                      "grids it overflows or never matches; use "
                      "grid.pad_key_for(key dtype)", node)
        self.generic_visit(node)

    def visit_Constant(self, node):
        if node.value == _I64_MAX and isinstance(node.value, int):
            self._add(RULE_I64,
                      "bare 2^63-1 literal used as a key sentinel", node)
        self.generic_visit(node)

    def visit_BinOp(self, node):
        if (_is_eps_square(node)
                and not self.relpath.endswith(_EPS_OWNER)):
            self._add(RULE_EPS,
                      "hard-coded eps-squared predicate outside "
                      "core/metric.py: the refine threshold is owned by "
                      "the metric trait (metric.eps_squared / l2_sq_hits / "
                      "plane_refine_hits); an inlined square evaluates L2 "
                      "for every metric", node)
        self.generic_visit(node)


def lint_source(text: str, relpath: str) -> list:
    """Lint one module's source text; findings carry ``relpath`` sites."""
    tree = ast.parse(text, filename=relpath)
    linter = _Linter(relpath)
    linter.visit(tree)
    return linter.findings


def lint_paths(paths: Iterable[str], root: Optional[str] = None) -> list:
    out = []
    for path in paths:
        rel = os.path.relpath(path, root) if root else path
        with open(path) as fh:
            out.extend(lint_source(fh.read(), rel.replace(os.sep, "/")))
    return out


def lint_tree(root: str) -> list:
    """Lint every ``.py`` under ``root`` (sites relative to the parent of
    its parent: ``src/repro_torch/...`` for the package directory)."""
    paths = []
    for dirpath, _, files in os.walk(root):
        for name in sorted(files):
            if name.endswith(".py"):
                paths.append(os.path.join(dirpath, name))
    base = os.path.dirname(os.path.dirname(os.path.abspath(root)))
    return lint_paths(sorted(paths), root=base)


# ---------------------------------------------------------------------------
# static no-retrace check (shape-space model of PreparedJoin.warm)
# ---------------------------------------------------------------------------

def fused_launch_keys(pj, size: int, keep: bool) -> set:
    """Every fused-launch key a request of ``size`` queries can demand from
    ``pj``: (capacity, tile, padded rows, keep_hits). On a bucketed index
    the per-class row split is data-dependent, but its shape space is the
    pow2 tile ladder bounded by the request bucket."""
    from repro_torch.core.query_join import bucket_rows

    qp = bucket_rows(size)
    keys = set()
    if not pj.bucketed:
        tile = pj.tiles[pj.c]
        keys.add((pj.c, tile, qp, keep))
        return keys
    for cb in pj.classes:
        tile = pj.tiles[cb]
        s = tile
        while s <= bucket_rows(qp, tile):
            keys.add((cb, tile, s, keep))
            s *= 2
    return keys


def warmed_launch_keys(pj, warm_sizes: Iterable[int],
                       keep_variants=(True, False)) -> set:
    """The keys ``PreparedJoin.warm(n)`` covers for each warmed size: the
    request-bucket launch (single-class indexes) plus the (class,
    pow2-size) ladder (bucketed indexes), whose every class warm launches
    once."""
    keys = set()
    for n in warm_sizes:
        for keep in keep_variants:
            keys |= fused_launch_keys(pj, int(n), keep)
    return keys


def check_no_retrace(pj, *, max_batch: int, request_sizes: Iterable[int],
                     warm_sizes: Optional[Iterable[int]] = None,
                     keep_variants=(True, False),
                     tag: str = "prepared") -> list:
    """Prove a canned request mix cannot reach past the warmed set.

    ``warm_sizes=None`` models the batching service's full pow2 ladder up
    to ``max_batch`` (``launch/serve.py`` ``BatchingJoinService.warmup``);
    an explicit list models a fixed-size ``JoinService.warmup``. Findings
    name every launch key the mix demands that warm never covered."""
    from repro_torch.core.query_join import bucket_rows

    if warm_sizes is None:
        warm_sizes, s = [], bucket_rows(1)
        while s <= bucket_rows(max_batch):
            warm_sizes.append(s)
            s *= 2
    warmed = warmed_launch_keys(pj, warm_sizes, keep_variants)
    out = []
    for m in request_sizes:
        for keep in keep_variants:
            missing = sorted(fused_launch_keys(pj, int(m), keep) - warmed)
            if missing:
                out.append(Finding(
                    _AN, "static-retrace", f"{tag}:q{int(m)}:keep={keep}",
                    f"request of {int(m)} queries demands un-warmed "
                    f"launches {missing} (warm sizes {sorted(warm_sizes)})"))
    return out


def count_distinct_lowerings(pj, sizes: Iterable[int],
                             keep_variants=(True, False)) -> int:
    """Distinct fused-launch keys a request mix demands in total."""
    keys = set()
    for m in sizes:
        for keep in keep_variants:
            keys |= fused_launch_keys(pj, int(m), keep)
    return len(keys)
