"""Dependency-free AST linter for the PyTorch pitfalls of this port.

The counterpart of ``repro.check.ast_rules``: the same pragma machinery and
entry points, with the JAX rules (numpy in ``jit``, traced ``if``s, host
casts under ``jit``) replaced by their PyTorch hazards.

Rules (ids are stable):

* ``ast.host-sync`` — ``torch.cuda.synchronize()`` or an event's or
  stream's ``.synchronize()`` in library code: the host waits for the card
  and the launch queue drains.  The measurement harnesses (``*_ablation.py``,
  ``examples/``, ``launch/orchestrate_dryrun.py``, ``chip_smoke.py``) time
  on the card by design and are exempt; an intentional sync elsewhere
  carries a pragma with its reason (FAIL).
* ``ast.host-read`` — ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
  ``torch.equal``, or ``int()``/``float()``/``bool()`` of a tensor method's
  result, in ``models/``, ``serve/``, ``train/train_step.py`` and the kernel
  wrappers: each reads a device value on the host (a sync), and a fake
  tensor (the dry run) cannot run it at all.  The counterpart of the
  reference's ``ast.jit-host-cast`` and ``ast.jit-traced-if`` (WARN — the
  heuristic cannot see types).
* ``ast.uint8-index`` — a subscript indexed by a tensor made, cast or
  checked as ``torch.uint8`` in the same function: torch reads a uint8
  index tensor as a boolean mask, not as positions (FAIL).
* ``ast.import-time-build`` — a module-level ``import triton`` or a
  module-level call of ``kernels.build``'s ``load``/``build_all``: kernels
  build lazily, inside the function that launches them, so that every
  module imports on a machine without ``nvcc``, ``triton`` or a card (FAIL).
* ``ast.span-no-with`` — ``obs.span(...)`` / ``tracer.span(...)`` called
  outside a ``with`` statement: the context manager is never entered, so
  the span is never recorded — or, entered manually, leaks the
  per-thread span stack on exceptions (FAIL).
* ``ast.mutable-default`` — mutable default arguments on functions and
  mutable class-level defaults on dataclass fields (use
  ``field(default_factory=...)``) (FAIL).
* ``ast.stale-pragma`` — a ``# check: ignore[...]`` pragma that no
  longer suppresses anything: the offending code was fixed or moved but
  the suppression stayed behind, silently masking future regressions on
  that line (WARN).
* ``ast.uninstrumented-entrypoint`` — a public function in ``serve/``
  or ``train/`` that does host-side work (numpy / filesystem calls, or
  mutating engine state) without ever opening an ``obs`` span or
  recording a metric.  Factories returning closures and private helpers
  are exempt; suppress deliberate host helpers with a pragma (WARN).

Suppression: append ``# check: ignore`` (everything) or
``# check: ignore[rule, rule]`` (specific rules, with or without the
``ast.`` prefix) to the offending line.  Pragmas are recognized only in
real comments (tokenize-level), so pragma examples inside docstrings —
like the ones above — are inert.

:class:`U8Taint` (the uint8-ness of names inside one function) is shared
with the lowered layer's ``lowered.cuda.gf-dtype`` pass.
"""
from __future__ import annotations

import ast
import io
import re
import tokenize
from pathlib import Path
from typing import Iterable, Iterator

from .report import FAIL, WARN, Finding, LintRecord

L_HOST_SYNC = "ast.host-sync"
L_HOST_READ = "ast.host-read"
L_U8_INDEX = "ast.uint8-index"
L_IMPORT_BUILD = "ast.import-time-build"
L_SPAN_WITH = "ast.span-no-with"
L_MUT_DEFAULT = "ast.mutable-default"
L_STALE_PRAGMA = "ast.stale-pragma"
L_UNINSTRUMENTED = "ast.uninstrumented-entrypoint"

ALL_LINT_RULES = (
    L_HOST_SYNC, L_HOST_READ, L_U8_INDEX, L_IMPORT_BUILD, L_SPAN_WITH,
    L_MUT_DEFAULT, L_STALE_PRAGMA, L_UNINSTRUMENTED,
)

_PRAGMA = re.compile(r"#\s*check:\s*ignore(?:\[([^\]]*)\])?")

# Measurement harnesses, where a sync is how a time is taken: path parts,
# file-name suffixes and file names.
_SYNC_EXEMPT_PARTS = ("examples",)
_SYNC_EXEMPT_SUFFIX = "_ablation.py"
_SYNC_EXEMPT_FILES = ("orchestrate_dryrun.py", "chip_smoke.py")

# Where a host read of a device value is a hazard: the hot path a fake
# tensor (the dry run) must also get through.  Directory parts, and files
# as their last two path parts.
_HOST_READ_DIRS = ("models", "serve")
_HOST_READ_FILES = ("train/train_step.py", "kernels/gf_matmul.py",
                    "kernels/flash_attention.py", "kernels/ops.py")
_HOST_READ_METHODS = ("item", "tolist", "cpu", "numpy")
_HOST_CASTS = ("int", "float", "bool")
# methods whose result is a tensor: a host cast of one reads the device
_TENSOR_METHODS = frozenset((
    "sum", "mean", "max", "min", "amax", "amin", "any", "all", "norm", "prod",
    "count_nonzero", "argmax", "argmin", "abs", "std", "var", "nonzero", "eq",
    "ne", "lt", "le", "gt", "ge", "isfinite", "isnan", "logsumexp",
))

# kernels.build's entry points that compile or load a kernel library
_BUILD_CALLS = ("load", "build_all", "compile_sources")

# Directories whose public entry points must self-instrument through
# repro_torch.obs (matched as whole path parts, so launch/train.py is out).
_OBS_SCOPES = ("serve", "train")

# Call prefixes that mark host-side work: the function is an entry point
# the observability story should cover.
_HOST_WORK_PREFIXES = (
    "np.", "numpy.", "os.", "json.", "zlib.", "time.", "io.", "shutil.",
)

# obs recording calls that count as instrumentation besides `with span`.
_OBS_RECORDERS = ("counter_add", "gauge_set", "record_span")


# --------------------------------------------------------------------------
# AST helpers
# --------------------------------------------------------------------------


def _dotted(node: ast.AST) -> str:
    """'torch.cuda.synchronize' for Attribute chains, 'f' for Names, ''
    otherwise."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


_MUTABLE_LITERALS = (ast.List, ast.Dict, ast.Set, ast.ListComp, ast.DictComp,
                     ast.SetComp)
_MUTABLE_CALLS = {"list", "dict", "set", "collections.defaultdict",
                  "defaultdict", "collections.OrderedDict", "OrderedDict"}


def _is_mutable_default(node: ast.expr | None) -> bool:
    if node is None:
        return False
    if isinstance(node, _MUTABLE_LITERALS):
        return True
    if isinstance(node, ast.Call):
        return _dotted(node.func) in _MUTABLE_CALLS
    return False


def _is_dataclass_decorated(cls: ast.ClassDef) -> bool:
    for dec in cls.decorator_list:
        target = dec.func if isinstance(dec, ast.Call) else dec
        if _dotted(target) in ("dataclass", "dataclasses.dataclass"):
            return True
    return False


# --------------------------------------------------------------------------
# uint8 taint (shared with lowered.cuda.gf-dtype)
# --------------------------------------------------------------------------

_DTYPES = frozenset((
    "uint8", "int8", "int16", "int32", "int64", "short", "int", "long", "float16",
    "half", "bfloat16", "float32", "float", "float64", "double", "bool", "complex64",
))
# casts to another dtype, and methods that keep the receiver's dtype
_WIDEN_METHODS = frozenset(("long", "int", "float", "double", "half", "bfloat16",
                            "bool", "short", "char"))
_KEEP_METHODS = frozenset((
    "reshape", "view", "transpose", "permute", "contiguous", "unsqueeze",
    "squeeze", "select", "flatten", "clone", "expand", "expand_as", "repeat",
    "flip", "roll", "narrow", "t", "ravel", "cpu", "cuda", "detach", "numpy",
    "copy", "zeros_like", "empty_like", "ones_like", "full_like",
    "ascontiguousarray", "asarray",
))
_SPLIT_METHODS = frozenset(("unbind", "split", "chunk"))
_WRAP_OPS = (ast.Add, ast.Sub, ast.Mult)
_KEEP_OPS = (ast.BitAnd, ast.BitOr, ast.BitXor, ast.LShift, ast.RShift, *_WRAP_OPS)
_MATMULS = frozenset(("matmul", "mm", "bmm", "einsum", "tensordot", "dot"))


def _dtype_named(node: ast.expr, torch_only: bool = False) -> str | None:
    """The dtype an expression names (``torch.uint8``; unless
    ``torch_only``, also ``np.uint8`` or ``"uint8"``), or None."""
    if isinstance(node, ast.Attribute) and node.attr in _DTYPES:
        if torch_only and _dotted(node.value) != "torch":
            return None
        return node.attr
    if torch_only:
        return None
    if isinstance(node, ast.Name) and node.id in _DTYPES and node.id not in ("int", "float",
                                                                             "bool"):
        return node.id
    if isinstance(node, ast.Constant) and node.value in _DTYPES:
        return node.value
    return None


def _dtype_kw(call: ast.Call) -> ast.expr | None:
    for kw in call.keywords:
        if kw.arg == "dtype":
            return kw.value
    return None


def _is_uint8_check(test: ast.expr, op: type, torch_only: bool) -> list[str]:
    """Names ``x`` whose ``x.dtype <op> uint8`` comparisons appear in
    ``test`` (directly or under ``and``/``or``)."""
    out: list[str] = []
    for node in ast.walk(test):
        if (isinstance(node, ast.Compare) and len(node.ops) == 1
                and isinstance(node.ops[0], op)
                and isinstance(node.left, ast.Attribute) and node.left.attr == "dtype"
                and isinstance(node.left.value, ast.Name)
                and _dtype_named(node.comparators[0], torch_only) == "uint8"):
            out.append(node.left.value.id)
    return out


class U8Taint:
    """Which names of one function hold uint8 tensors or arrays.

    Sources: a construction with ``dtype=torch.uint8`` (or numpy's), a cast
    (``.to(torch.uint8)``, ``.byte()``, ``.astype(np.uint8)``), and a guard
    that raises unless ``x.dtype == torch.uint8`` (or an ``assert`` of it).
    uint8-ness flows through indexing, shape-preserving methods, bitwise and
    arithmetic operators, and the slices a ``for`` takes of ``x.unbind()``;
    a cast to another dtype (``.long()``, ``.to(torch.int64)``) ends it.
    Flow-insensitive inside branches, as the reference's pass.  With
    ``torch_only`` only torch's uint8 counts (a numpy uint8 array indexes by
    position, so only a torch one is a hazard as an index).
    """

    def __init__(self, torch_only: bool = False) -> None:
        self.names: set[str] = set()
        self.torch_only = torch_only

    def is_u8(self, node: ast.expr) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.names
        if isinstance(node, ast.Subscript):
            return self.is_u8(node.value)
        if isinstance(node, ast.BinOp):
            return isinstance(node.op, _KEEP_OPS) and (
                self.is_u8(node.left) or self.is_u8(node.right))
        if isinstance(node, ast.UnaryOp):
            return isinstance(node.op, ast.Invert) and self.is_u8(node.operand)
        if isinstance(node, ast.IfExp):
            return self.is_u8(node.body) or self.is_u8(node.orelse)
        if not isinstance(node, ast.Call):
            return False
        f = node.func
        dtype = _dtype_kw(node)
        if dtype is not None:
            return _dtype_named(dtype, self.torch_only) == "uint8"
        if not isinstance(f, ast.Attribute):
            return False
        if f.attr in ("to", "astype", "type"):
            for arg in node.args:
                if _dtype_named(arg) is not None:
                    return _dtype_named(arg, self.torch_only) == "uint8"
            return f.attr == "to" and self.is_u8(f.value)
        if f.attr == "byte":
            return True
        if f.attr in _WIDEN_METHODS:
            return False
        if f.attr in _KEEP_METHODS:
            if f.attr.endswith("_like") or f.attr in ("ascontiguousarray", "asarray"):
                return bool(node.args) and self.is_u8(node.args[0])
            return self.is_u8(f.value)
        return False

    def learn(self, stmt: ast.stmt) -> None:
        """Update the names after ``stmt`` ran (not its nested blocks)."""
        if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
            targets = stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
            if stmt.value is None:
                return
            u8 = self.is_u8(stmt.value)
            for tgt in targets:
                for name in ast.walk(tgt):
                    if isinstance(name, ast.Name):
                        (self.names.add if u8 and tgt is name else self.names.discard)(name.id)
        elif isinstance(stmt, ast.AugAssign):
            if (isinstance(stmt.target, ast.Name) and isinstance(stmt.op, _KEEP_OPS)
                    and self.is_u8(stmt.value)):
                self.names.add(stmt.target.id)
        elif isinstance(stmt, ast.For) and isinstance(stmt.target, ast.Name):
            it = stmt.iter
            u8 = self.is_u8(it) or (
                isinstance(it, ast.Call) and isinstance(it.func, ast.Attribute)
                and it.func.attr in _SPLIT_METHODS and self.is_u8(it.func.value))
            (self.names.add if u8 else self.names.discard)(stmt.target.id)
        elif isinstance(stmt, ast.If) and stmt.body and isinstance(stmt.body[-1], ast.Raise):
            self.names.update(_is_uint8_check(stmt.test, ast.NotEq, self.torch_only))
        elif isinstance(stmt, ast.Assert):
            self.names.update(_is_uint8_check(stmt.test, ast.Eq, self.torch_only))


def _index_exprs(sub: ast.Subscript) -> list[ast.expr]:
    s = sub.slice
    return list(s.elts) if isinstance(s, ast.Tuple) else [s]


def u8_hazards(fn: ast.FunctionDef | ast.AsyncFunctionDef) -> Iterator[tuple[str, ast.AST]]:
    """(kind, node) of every uint8 hazard in one function's own body (not
    its nested functions): ``index`` (a uint8 index tensor), ``wrap``
    (``+``, ``-``, ``*`` on uint8: wraps mod 256, where GF(2^8) addition is
    XOR) and ``matmul`` (a product accumulating in uint8).  An index is
    judged by torch's uint8 alone, arithmetic by numpy's too."""
    env = U8Taint()
    tenv = U8Taint(torch_only=True)

    def exprs(stmt: ast.stmt) -> Iterator[tuple[str, ast.AST]]:
        if isinstance(stmt, ast.AugAssign):
            if isinstance(stmt.op, _WRAP_OPS) and (env.is_u8(stmt.target)
                                                    or env.is_u8(stmt.value)):
                yield "wrap", stmt
            if isinstance(stmt.op, ast.MatMult) and (env.is_u8(stmt.target)
                                                     or env.is_u8(stmt.value)):
                yield "matmul", stmt
        for child in ast.iter_child_nodes(stmt):
            if not isinstance(child, ast.expr):
                continue
            for sub in ast.walk(child):
                if isinstance(sub, ast.Subscript):
                    if any(tenv.is_u8(e) for e in _index_exprs(sub)):
                        yield "index", sub
                elif isinstance(sub, ast.BinOp):
                    u8 = env.is_u8(sub.left) or env.is_u8(sub.right)
                    if u8 and isinstance(sub.op, _WRAP_OPS):
                        yield "wrap", sub
                    elif u8 and isinstance(sub.op, ast.MatMult):
                        yield "matmul", sub
                elif isinstance(sub, ast.Call):
                    f = sub.func
                    name = f.attr if isinstance(f, ast.Attribute) else _dotted(f)
                    operands = list(sub.args)
                    if isinstance(f, ast.Attribute):
                        operands.append(f.value)
                    if name in _MATMULS and any(env.is_u8(a) for a in operands):
                        yield "matmul", sub

    def block(stmts: Iterable[ast.stmt]) -> Iterator[tuple[str, ast.AST]]:
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                continue
            yield from exprs(stmt)
            env.learn(stmt)
            tenv.learn(stmt)
            for name in ("body", "orelse", "finalbody"):
                inner = getattr(stmt, name, None)
                if inner:
                    yield from block(inner)
            for handler in getattr(stmt, "handlers", ()):
                yield from block(handler.body)

    yield from block(fn.body)


# --------------------------------------------------------------------------
# The linter
# --------------------------------------------------------------------------


class _Linter(ast.NodeVisitor):
    def __init__(self, path: str, lines: list[str]):
        self.path = path
        self.lines = lines
        parts = Path(path).parts
        tail = "/".join(parts[-2:])
        self.obs_scope = any(part in _OBS_SCOPES for part in parts[:-1])
        self.sync_exempt = (
            any(part in _SYNC_EXEMPT_PARTS for part in parts[:-1])
            or parts[-1].endswith(_SYNC_EXEMPT_SUFFIX)
            or parts[-1] in _SYNC_EXEMPT_FILES
        )
        self.read_scope = (any(part in _HOST_READ_DIRS for part in parts[:-1])
                           or tail in _HOST_READ_FILES)
        self.findings: list[Finding] = []
        # pragma line -> rules a pragma on that line actually suppressed
        self.pragma_used: dict[int, set[str]] = {}
        self._depth = 0  # enclosing function definitions
        self._parents: dict[int, ast.AST] = {}

    # ------------------------------------------------------------- plumbing
    def run(self, tree: ast.Module) -> list[Finding]:
        for parent in ast.walk(tree):
            for child in ast.iter_child_nodes(parent):
                self._parents[id(child)] = parent
        self._check_import_time_build(tree)
        self.visit(tree)
        return self.findings

    def _emit(self, rule: str, severity: str, node: ast.AST, message: str) -> None:
        line = getattr(node, "lineno", 0)
        col = getattr(node, "col_offset", 0)
        if self._suppressed(rule, line):
            return
        self.findings.append(Finding(
            rule, severity, f"{self.path}:{line}:{col}: {message}",
            {"path": self.path, "line": line, "col": col},
        ))

    def _suppressed(self, rule: str, line: int) -> bool:
        if not (1 <= line <= len(self.lines)):
            return False
        m = _PRAGMA.search(self.lines[line - 1])
        if not m:
            return False
        if m.group(1) is None:
            self.pragma_used.setdefault(line, set()).add(rule)
            return True
        wanted = {r.strip() for r in m.group(1).split(",") if r.strip()}
        if rule in wanted or rule.removeprefix("ast.") in wanted:
            self.pragma_used.setdefault(line, set()).add(rule)
            return True
        return False

    # ------------------------------------------------------ module level
    def _check_import_time_build(self, tree: ast.Module) -> None:
        """Statements that run at import: the module body and class bodies,
        through ``if``/``try``/``with`` blocks, but not function bodies."""

        def stmts(body: Iterable[ast.stmt]) -> Iterator[ast.stmt]:
            for stmt in body:
                if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                yield stmt
                for name in ("body", "orelse", "finalbody"):
                    yield from stmts(getattr(stmt, name, ()) or ())
                for handler in getattr(stmt, "handlers", ()):
                    yield from stmts(handler.body)

        for stmt in stmts(tree.body):
            if isinstance(stmt, ast.Import):
                for alias in stmt.names:
                    if alias.name.split(".")[0] == "triton":
                        self._emit(L_IMPORT_BUILD, FAIL, stmt,
                                   "module-level `import triton` — import it inside the "
                                   "function that launches the kernel")
            elif isinstance(stmt, ast.ImportFrom) and (stmt.module or "").split(".")[0] == "triton":
                self._emit(L_IMPORT_BUILD, FAIL, stmt,
                           "module-level `from triton import ...` — import it inside the "
                           "function that launches the kernel")
            for child in ast.iter_child_nodes(stmt):
                if not isinstance(child, ast.expr):
                    continue
                for sub in ast.walk(child):
                    if not isinstance(sub, ast.Call):
                        continue
                    callee = _dotted(sub.func)
                    last = callee.rsplit(".", 1)[-1]
                    if last in _BUILD_CALLS and ("build" in callee.split(".")[:-1]
                                                 or callee in ("build_all", "compile_sources")):
                        self._emit(L_IMPORT_BUILD, FAIL, sub,
                                   f"`{callee}(...)` at import time compiles or loads a "
                                   f"kernel — build lazily, at the first launch")

    # ------------------------------------------------------------ functions
    def _visit_function(self, node: ast.FunctionDef | ast.AsyncFunctionDef) -> None:
        for d in [*node.args.defaults, *node.args.kw_defaults]:
            if _is_mutable_default(d):
                self._emit(
                    L_MUT_DEFAULT, FAIL, d,
                    f"mutable default argument in {node.name}() — shared "
                    f"across calls; use None or a tuple",
                )
        self._check_uninstrumented(node)
        for kind, sub in u8_hazards(node):
            if kind == "index":
                self._emit(
                    L_U8_INDEX, FAIL, sub,
                    "subscript indexed by a uint8 tensor — torch reads it as a "
                    "boolean mask, not positions; index with `.long()`",
                )
        self._depth += 1
        self.generic_visit(node)
        self._depth -= 1

    def _check_uninstrumented(
        self, node: ast.FunctionDef | ast.AsyncFunctionDef
    ) -> None:
        """WARN on public serve/train entry points with no obs hook."""
        if not self.obs_scope or node.name.startswith("_"):
            return
        if self._depth:  # nested function: the outer def owns the span
            return
        for dec in node.decorator_list:
            target = dec.func if isinstance(dec, ast.Call) else dec
            if _dotted(target).rsplit(".", 1)[-1] in (
                "property", "cached_property", "staticmethod",
            ):
                return
        nested = {
            c.name
            for c in ast.walk(node)
            if isinstance(c, (ast.FunctionDef, ast.AsyncFunctionDef))
            and c is not node
        }
        for sub in ast.walk(node):
            if (
                isinstance(sub, ast.Return)
                and isinstance(sub.value, ast.Name)
                and sub.value.id in nested
            ):
                return  # factory: the closure it builds is the real step
        if not self._does_host_work(node):
            return
        if self._opens_obs_hook(node):
            return
        self._emit(
            L_UNINSTRUMENTED, WARN, node,
            f"public entry point {node.name}() does host-side work but "
            f"never opens an obs span or records a metric — instrument "
            f"it (see core/repair.py) or suppress with a pragma",
        )

    def _does_host_work(
        self, node: ast.FunctionDef | ast.AsyncFunctionDef
    ) -> bool:
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                callee = _dotted(sub.func)
                if callee == "open" or callee.startswith(_HOST_WORK_PREFIXES):
                    return True
            elif isinstance(sub, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                targets = (
                    sub.targets
                    if isinstance(sub, ast.Assign)
                    else [sub.target]
                )
                for t in targets:
                    for a in ast.walk(t):
                        if (
                            isinstance(a, ast.Attribute)
                            and isinstance(a.value, ast.Name)
                            and a.value.id == "self"
                        ):
                            return True
        return False

    def _opens_obs_hook(
        self, node: ast.FunctionDef | ast.AsyncFunctionDef
    ) -> bool:
        for sub in ast.walk(node):
            if isinstance(sub, (ast.With, ast.AsyncWith)):
                for item in sub.items:
                    ce = item.context_expr
                    if isinstance(ce, ast.Call) and _dotted(
                        ce.func
                    ).rsplit(".", 1)[-1] == "span":
                        return True
            elif isinstance(sub, ast.Call):
                if _dotted(sub.func).rsplit(".", 1)[-1] in _OBS_RECORDERS:
                    return True
        return False

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._visit_function(node)

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        self._visit_function(node)

    # ------------------------------------------------------------- classes
    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        if _is_dataclass_decorated(node):
            for stmt in node.body:
                value = None
                if isinstance(stmt, ast.AnnAssign):
                    value = stmt.value
                elif isinstance(stmt, ast.Assign):
                    value = stmt.value
                if _is_mutable_default(value):
                    assert value is not None
                    self._emit(
                        L_MUT_DEFAULT, FAIL, value,
                        f"mutable default on dataclass {node.name} field — "
                        f"use field(default_factory=...)",
                    )
        self.generic_visit(node)

    # --------------------------------------------------------------- calls
    def visit_Call(self, node: ast.Call) -> None:
        callee = _dotted(node.func)
        attr = node.func.attr if isinstance(node.func, ast.Attribute) else ""
        if attr == "synchronize" and not self.sync_exempt:
            self._emit(
                L_HOST_SYNC, FAIL, node,
                f"`{callee or '.synchronize'}(...)` in library code stalls the host "
                f"until the card drains — drop it, or suppress with a pragma "
                f"that says why it is needed",
            )
        if self.read_scope:
            self._check_host_read(node, callee, attr)
        if attr == "span" and not self._span_is_entered(node):
            self._emit(
                L_SPAN_WITH, FAIL, node,
                f"`{callee}(...)` outside a `with` — the span is never "
                f"recorded (or leaks the per-thread span stack)",
            )
        self.generic_visit(node)

    def _check_host_read(self, node: ast.Call, callee: str, attr: str) -> None:
        what = ""
        if attr in _HOST_READ_METHODS and not node.args and callee.split(".")[0] not in (
                "np", "numpy"):
            what = f"`.{attr}()`"
        elif callee == "torch.equal":
            what = "`torch.equal`"
        elif callee in _HOST_CASTS and len(node.args) == 1:
            for sub in ast.walk(node.args[0]):
                if (isinstance(sub, ast.Call) and isinstance(sub.func, ast.Attribute)
                        and sub.func.attr in _TENSOR_METHODS):
                    what = f"`{callee}()` of `.{sub.func.attr}()`"
                    break
        if what:
            self._emit(
                L_HOST_READ, WARN, node,
                f"{what} reads a device value on the host — a sync on the hot "
                f"path, and a fake tensor cannot run it; keep it on the device "
                f"or compute it from host values",
            )

    def _span_is_entered(self, node: ast.Call) -> bool:
        """span(...) calls must be with-items (or forwarded verbatim)."""
        parent = self._parents.get(id(node))
        if isinstance(parent, ast.withitem):
            return True
        if isinstance(parent, ast.Return):
            return True  # helper forwarding the context manager
        if isinstance(parent, ast.Call) and _dotted(parent.func).endswith(
            "enter_context"
        ):
            return True
        return False


# --------------------------------------------------------------------------
# Stale pragmas
# --------------------------------------------------------------------------


def _pragma_comments(src: str) -> list[tuple[int, str | None]]:
    """(line, rules-or-None) for every *real* pragma comment.

    Tokenize-level on purpose: a raw line regex would flag pragma
    examples embedded in docstrings (this module's own docstring has
    two).  Returns None rules for blanket ``# check: ignore``.
    """
    out: list[tuple[int, str | None]] = []
    try:
        tokens = tokenize.generate_tokens(io.StringIO(src).readline)
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = _PRAGMA.search(tok.string)
            if m:
                out.append((tok.start[0], m.group(1)))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        pass  # unparsable files are already ast.syntax findings
    return out


def _stale_pragma_findings(
    src: str, path: str, pragma_used: dict[int, set[str]]
) -> list[Finding]:
    """WARN for every pragma (or listed rule) that suppressed nothing."""
    out: list[Finding] = []
    for line, rules_text in _pragma_comments(src):
        used = pragma_used.get(line, set())
        if rules_text is None:
            if used:
                continue
            msg = (
                f"{path}:{line}: stale `# check: ignore` — no rule fires "
                f"on this line anymore; drop the pragma so future "
                f"regressions are not silently masked"
            )
            out.append(Finding(
                L_STALE_PRAGMA, WARN, msg,
                {"path": path, "line": line, "rules": []},
            ))
            continue
        listed = [r.strip() for r in rules_text.split(",") if r.strip()]
        used_short = {r.removeprefix("ast.") for r in used}
        stale = [
            r for r in listed
            if r not in used and r.removeprefix("ast.") not in used_short
        ]
        if stale:
            out.append(Finding(
                L_STALE_PRAGMA, WARN,
                f"{path}:{line}: stale pragma — rule(s) {stale} no longer "
                f"fire on this line; drop them from the ignore list",
                {"path": path, "line": line, "rules": stale},
            ))
    return out


# --------------------------------------------------------------------------
# Entry points
# --------------------------------------------------------------------------


def lint_source(src: str, path: str = "<string>") -> list[Finding]:
    """Lint one source string; returns findings sorted by line."""
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        return [Finding(
            "ast.syntax", FAIL, f"{path}:{e.lineno or 0}: {e.msg}",
            {"path": path, "line": e.lineno or 0},
        )]
    linter = _Linter(path, src.splitlines())
    findings = linter.run(tree)
    findings.extend(_stale_pragma_findings(src, path, linter.pragma_used))
    return sorted(findings, key=lambda f: int(f.witness.get("line", 0)))


def lint_file(path: str | Path) -> LintRecord:
    p = Path(path)
    return LintRecord(path=str(p), findings=lint_source(p.read_text(), str(p)))


def lint_paths(paths: Iterable[str | Path]) -> list[LintRecord]:
    return [lint_file(p) for p in paths]


def lint_tree(root: str | Path) -> list[LintRecord]:
    """Lint every ``*.py`` under `root`, sorted for stable reports."""
    files = sorted(Path(root).rglob("*.py"))
    return lint_paths(files)
