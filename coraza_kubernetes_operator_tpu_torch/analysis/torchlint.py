"""Torch hot-path linter over this package's own source.

Python-AST based — no imports of the linted code, so it runs in
milliseconds and can lint broken source. The port of the JAX package's
``analysis/jaxlint.py``, with the same codes and suppression form:

======== =================================================================
code     hazard
======== =================================================================
CKO-J004 host sync inside a declared no-sync hot path (``prepare`` /
         ``prepare_blob`` / ``_dispatch_tiers`` in ``engine/waf.py``, the
         pipelined dispatch contract) or in any function of the same
         module they call, directly or through other calls
         (``self.method()`` and module-level functions): ``.cpu()``,
         ``.numpy()``, ``.synchronize()`` (``torch.cuda.synchronize``, a
         CUDA event's or stream's), and on a tensor ``.item()``,
         ``.tolist()``, ``np.asarray``/``np.array``/``np.copy`` and
         ``int()``/``float()``/``bool()``. A suppression on a call line
         also stops the search from entering that call
CKO-J005 lock-acquire ordering inversion: two locks acquired in opposite
         nesting orders (the dispatch/collector thread deadlock class).
         Whole-package interprocedural: lock identity is class-qualified,
         ``self.method()`` and typed-attribute calls resolve across
         modules, and held-lock edges close over the transitive acquire
         set — scheduler/quarantine/watchdog/restore threads all share
         one graph
CKO-J006 GIL-release safety: a buffer handed to a GIL-released native
         call (``lib.cko_*`` / ``from_buffer``) must be owned by the call
         frame or held by an ``ArenaLease`` — a shared (module-global or
         ``self.``-attribute) bytearray can be resized by another thread
         mid-call, leaving the native side writing through a freed
         backing store
CKO-J007 lease lifetime: every ``ArenaLease`` checked out is released on
         all paths exactly once and never used after release — a leaked
         lease pins an arena slot until GC, a double/early release lets
         the next window overwrite tensors still in flight (must stay
         held until ``collect()``)
======== =================================================================

The JAX linter's tracing codes have no subject here, because PyTorch
traces nothing:

- CKO-J001 (a host sync under ``jax.jit``): no function is jitted; a sync
  on the hot path is J004.
- CKO-J002 (Python branching on a tracer): eager tensors have values, so
  a branch on one is a sync, which J004 covers on the hot path.
- CKO-J003 (a wall-clock read under jit traces a constant): eager code
  reads the clock when it runs.

A *tensor* is the value of a ``torch.*`` call, a parameter annotated
``torch.Tensor``, a name assigned from a tensor, or a method call on one.
Suppression: append ``# torchlint: ignore`` or
``# torchlint: ignore[CODE]`` to the offending line, with the reason.
"""

from __future__ import annotations

import ast
import os
from pathlib import Path

from .findings import SEV_ERROR, AnalysisReport, Finding

PACKAGE_ROOT = Path(__file__).resolve().parents[1]
PACKAGE_NAME = PACKAGE_ROOT.name

# Functions with a no-host-sync contract: the pipelined dispatch stage
# must enqueue and return (any sync here serializes host and device
# again). Keyed by (filename, function name).
NO_SYNC_HOT_PATHS = {
    ("engine/waf.py", "prepare"),
    ("engine/waf.py", "prepare_blob"),
    ("engine/waf.py", "_dispatch_tiers"),
}

# Methods that exist only on tensors, streams and events: always a sync.
_ALWAYS_SYNC_ATTRS = {"cpu", "numpy", "synchronize"}
# Methods numpy shares with torch: a sync on a tensor only.
_TENSOR_SYNC_ATTRS = {"item", "tolist"}
_NP_SYNC_FUNCS = {"asarray", "array", "copy"}
_CAST_FUNCS = {"float", "int", "bool"}


def _dotted(node: ast.AST) -> str:
    """Render a Name/Attribute chain as 'a.b.c' ('' when not a chain)."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


class _Suppressions:
    def __init__(self, source: str):
        self._by_line: dict[int, set[str] | None] = {}
        for i, line in enumerate(source.splitlines(), start=1):
            if "torchlint:" not in line:
                continue
            _, _, directive = line.partition("torchlint:")
            directive = directive.strip()
            if directive.startswith("ignore"):
                rest = directive[len("ignore"):].strip()
                if rest.startswith("["):
                    codes = {c.strip() for c in rest[1:].split("]", 1)[0].split(",") if c.strip()}
                    self._by_line[i] = codes
                else:
                    self._by_line[i] = None  # blanket ignore

    def suppressed(self, line: int, code: str) -> bool:
        if line not in self._by_line:
            return False
        codes = self._by_line[line]
        return codes is None or code in codes


# ---------------------------------------------------------------------------
# Host syncs on the no-sync hot path (CKO-J004)
# ---------------------------------------------------------------------------


def _is_tensor_annotation(node: ast.AST | None) -> bool:
    return node is not None and _dotted(node) in ("torch.Tensor", "Tensor")


class _SyncLinter(ast.NodeVisitor):
    """Lint one function body under the no-sync contract; collect the
    same-module calls it makes (for the caller's transitive walk)."""

    def __init__(
        self,
        rel: str,
        fn: ast.FunctionDef | ast.AsyncFunctionDef,
        findings: list[Finding],
        suppress: _Suppressions,
        chain: tuple[str, ...],
    ):
        self.rel = rel
        self.fn = fn
        self.findings = findings
        self.suppress = suppress
        self.chain = chain
        # Names bound to tensors: the cheap dataflow that lets .item() /
        # np.asarray() flags target tensors instead of numpy values.
        self.tensor_names: set[str] = {
            a.arg for a in fn.args.args + fn.args.kwonlyargs + fn.args.posonlyargs
            if _is_tensor_annotation(a.annotation)
        }
        self.calls: list[tuple[str, int]] = []  # (dotted callee, line)

    def _emit(self, node: ast.AST, message: str) -> None:
        line = getattr(node, "lineno", self.fn.lineno)
        if self.suppress.suppressed(line, "CKO-J004"):
            return
        where = f"in {self.fn.name}()"
        if len(self.chain) > 1:
            where += ", reached from " + " -> ".join(f"{c}()" for c in self.chain[:-1])
        self.findings.append(
            Finding(
                code="CKO-J004",
                severity=SEV_ERROR,
                message=message + " in a no-sync hot path",
                location=f"{self.rel}:{line}",
                detail=where,
            )
        )

    def _is_tensor(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.tensor_names
        if isinstance(node, ast.Call):
            name = _dotted(node.func)
            if name.startswith("torch."):
                return True
            if isinstance(node.func, ast.Attribute):
                return self._is_tensor(node.func.value)
            return False
        if isinstance(node, (ast.Attribute, ast.Subscript)):
            return self._is_tensor(node.value)
        if isinstance(node, ast.BinOp):
            return self._is_tensor(node.left) or self._is_tensor(node.right)
        return False

    def visit_Assign(self, node: ast.Assign) -> None:
        if self._is_tensor(node.value):
            for tgt in node.targets:
                for sub in ast.walk(tgt):
                    if isinstance(sub, ast.Name):
                        self.tensor_names.add(sub.id)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        name = _dotted(node.func)
        leaf = node.func.attr if isinstance(node.func, ast.Attribute) else ""
        if leaf in _ALWAYS_SYNC_ATTRS:
            self._emit(node, f".{leaf}() forces a host sync")
        elif leaf in _TENSOR_SYNC_ATTRS and self._is_tensor(node.func.value):
            self._emit(node, f".{leaf}() on a tensor forces a host sync")
        elif (
            name.startswith(("np.", "numpy."))
            and name.split(".")[-1] in _NP_SYNC_FUNCS
            and node.args
            and self._is_tensor(node.args[0])
        ):
            self._emit(node, f"{name}() on a tensor copies through the host")
        elif name in _CAST_FUNCS and node.args and self._is_tensor(node.args[0]):
            self._emit(node, f"{name}() on a tensor forces a host sync")
        elif name and not self.suppress.suppressed(node.lineno, "CKO-J004"):
            self.calls.append((name, node.lineno))
        self.generic_visit(node)


def _hot_path_findings(rel: str, tree: ast.Module, suppress: _Suppressions) -> list[Finding]:
    """CKO-J004 over the module's hot paths and every same-module function
    they reach: ``self.m()`` resolves in the caller's class, a bare name
    to a module-level function. Each function is linted once, under the
    first call chain that reaches it."""
    funcs: dict[tuple[str | None, str], ast.FunctionDef | ast.AsyncFunctionDef] = {}
    fn_types = (ast.FunctionDef, ast.AsyncFunctionDef)
    for node in tree.body:
        if isinstance(node, fn_types):
            funcs[(None, node.name)] = node
        elif isinstance(node, ast.ClassDef):
            for item in node.body:
                if isinstance(item, fn_types):
                    funcs[(node.name, item.name)] = item
    tail = "/".join(rel.split("/")[-2:])
    queue = [
        (key, (key[1],)) for key in funcs
        if (rel, key[1]) in NO_SYNC_HOT_PATHS or (tail, key[1]) in NO_SYNC_HOT_PATHS
    ]
    seen = {key for key, _ in queue}
    findings: list[Finding] = []
    while queue:
        (cls, name), chain = queue.pop(0)
        linter = _SyncLinter(rel, funcs[(cls, name)], findings, suppress, chain)
        linter.visit(funcs[(cls, name)])
        for callee, _line in linter.calls:
            parts = callee.split(".")
            if parts[0] == "self" and len(parts) == 2 and cls is not None:
                key = (cls, parts[1])
            elif len(parts) == 1:
                key = (None, parts[0])
            else:
                continue
            if key in funcs and key not in seen:
                seen.add(key)
                queue.append((key, chain + (key[1],)))
    return findings


# ---------------------------------------------------------------------------
# Lock-order analysis (CKO-J005) — whole-package interprocedural
# ---------------------------------------------------------------------------


class _LockGraph:
    """One module's contribution to the package-wide lock graph."""

    def __init__(self, rel: str):
        self.rel = rel
        # lock -> {(lock, lineno, rel)}: B acquired while A held, directly.
        self.edges: dict[str, set[tuple[str, int, str]]] = {}
        # fnkey -> locks acquired anywhere in its own body.
        self.acquires: dict[str, set[str]] = {}
        # fnkey -> call descriptors made anywhere in its body (for the
        # transitive acquire-set fixpoint).
        self.calls: dict[str, set[tuple]] = {}
        # (held lock, descriptor, lineno, rel): calls made under a lock.
        self.held_calls: list[tuple[str, tuple, int, str]] = []
        # (class, attr) -> ClassName for ``self.attr = ClassName(...)``.
        self.attr_types: dict[tuple[str, str], str] = {}
        self.classes: set[str] = set()


class _LockGraphVisitor(ast.NodeVisitor):
    """Collect one module's lock graph. Lock identity is class-qualified
    (``Batcher.self._queue_lock``) so two classes' same-named attributes
    stay distinct locks; module-level locks are module-qualified. Call
    descriptors record enough to resolve ``self.m()`` to the same class
    and ``self.attr.m()`` through ``self.attr = OtherClass(...)`` —
    across modules, at merge time."""

    def __init__(self, graph: _LockGraph):
        self.g = graph
        self._class: str | None = None
        self._fn: str | None = None  # qualified fnkey
        self._held: list[str] = []

    @staticmethod
    def _lock_leaf(node: ast.AST) -> str | None:
        name = _dotted(node)
        leaf = name.split(".")[-1].lower() if name else ""
        if any(tag in leaf for tag in ("lock", "sem", "mutex", "cond")):
            return name
        return None

    def _qualify_lock(self, name: str) -> str:
        if name.startswith("self.") and self._class:
            return f"{self._class}.{name[len('self.'):]}"
        if name.startswith("self."):
            return name
        return f"{self.g.rel}::{name}"

    def _fnkey(self, name: str) -> str:
        if self._class:
            return f"{self._class}.{name}"
        return f"{self.g.rel}::{name}"

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        prev, self._class = self._class, node.name
        self.g.classes.add(node.name)
        self.generic_visit(node)
        self._class = prev

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        prev, self._fn = self._fn, self._fnkey(node.name)
        self.g.acquires.setdefault(self._fn, set())
        self.g.calls.setdefault(self._fn, set())
        self.generic_visit(node)
        self._fn = prev

    visit_AsyncFunctionDef = visit_FunctionDef  # type: ignore[assignment]

    def _record_acquire(self, lock: str, lineno: int) -> None:
        if self._fn is None:
            return
        self.g.acquires[self._fn].add(lock)
        for held in self._held:
            if held != lock:
                self.g.edges.setdefault(held, set()).add(
                    (lock, lineno, self.g.rel)
                )

    def visit_With(self, node: ast.With) -> None:
        acquired: list[str] = []
        for item in node.items:
            raw = self._lock_leaf(item.context_expr)
            if raw:
                lock = self._qualify_lock(raw)
                self._record_acquire(lock, node.lineno)
                self._held.append(lock)
                acquired.append(lock)
        self.generic_visit(node)
        for _ in acquired:
            self._held.pop()

    def visit_Assign(self, node: ast.Assign) -> None:
        # self.attr = ClassName(...): attribute type for call resolution.
        if self._class and isinstance(node.value, ast.Call):
            ctor = _dotted(node.value.func).split(".")[-1]
            if ctor and ctor[:1].isupper():
                for tgt in node.targets:
                    if (
                        isinstance(tgt, ast.Attribute)
                        and _dotted(tgt).startswith("self.")
                    ):
                        self.g.attr_types[(self._class, tgt.attr)] = ctor
        self.generic_visit(node)

    def _call_descriptor(self, name: str) -> tuple | None:
        parts = name.split(".")
        if parts[0] == "self" and len(parts) == 2:
            return ("self", parts[1])
        if parts[0] == "self" and len(parts) == 3:
            return ("attr", parts[1], parts[2])
        if len(parts) == 1 and parts[0]:
            return ("name", parts[0])
        return None

    def visit_Call(self, node: ast.Call) -> None:
        if isinstance(node.func, ast.Attribute) and node.func.attr == "acquire":
            raw = self._lock_leaf(node.func.value)
            if raw:
                self._record_acquire(self._qualify_lock(raw), node.lineno)
                self.generic_visit(node)
                return
        name = _dotted(node.func)
        desc = self._call_descriptor(name) if name else None
        if desc is not None and self._fn is not None:
            self.g.calls[self._fn].add(desc)
            for held in self._held:
                self.g.held_calls.append((held, desc, node.lineno, self.g.rel))
        self.generic_visit(node)


def _collect_lock_graph(rel: str, tree: ast.Module) -> _LockGraph:
    graph = _LockGraph(rel)
    _LockGraphVisitor(graph).visit(tree)
    return graph


def _resolve_descriptor(
    desc: tuple,
    caller: str,
    rel: str,
    acquires: dict[str, set[str]],
    attr_types: dict[tuple[str, str], str],
) -> str | None:
    """Map a call descriptor to a known fnkey, or None when unresolvable."""
    cls = caller.split(".")[0] if "." in caller and "::" not in caller else None
    kind = desc[0]
    if kind == "self" and cls:
        key = f"{cls}.{desc[1]}"
        return key if key in acquires else None
    if kind == "attr" and cls:
        target = attr_types.get((cls, desc[1]))
        if target:
            key = f"{target}.{desc[2]}"
            return key if key in acquires else None
        return None
    if kind == "name":
        key = f"{rel}::{desc[1]}"
        return key if key in acquires else None
    return None


def _lock_order_findings(
    graphs: list[_LockGraph],
    suppressions: dict[str, _Suppressions],
) -> list[Finding]:
    """Cycle-detect one merged lock graph. With a single graph this is the
    old per-module analysis; ``lint_paths`` feeds every module at once so
    inversions BETWEEN the scheduler/quarantine/watchdog/restore threads'
    modules are visible too."""
    acquires: dict[str, set[str]] = {}
    attr_types: dict[tuple[str, str], str] = {}
    calls: dict[str, tuple[str, set[tuple]]] = {}  # fnkey -> (rel, descs)
    edges: dict[str, set[tuple[str, int, str]]] = {}
    held_calls: list[tuple[str, tuple, int, str, str]] = []
    for g in graphs:
        for fn, locks in g.acquires.items():
            acquires.setdefault(fn, set()).update(locks)
        attr_types.update(g.attr_types)
        for fn, descs in g.calls.items():
            prev = calls.setdefault(fn, (g.rel, set()))
            prev[1].update(descs)
        for lock, targets in g.edges.items():
            edges.setdefault(lock, set()).update(targets)
        for held, desc, lineno, rel in g.held_calls:
            held_calls.append((held, desc, lineno, rel, rel))

    # Resolve the call graph, then fixpoint the transitive acquire sets:
    # f's set includes every lock reachable through its callees.
    resolved: dict[str, set[str]] = {}
    for fn, (rel, descs) in calls.items():
        outs = set()
        for desc in descs:
            key = _resolve_descriptor(desc, fn, rel, acquires, attr_types)
            if key is not None and key != fn:
                outs.add(key)
        resolved[fn] = outs
    trans: dict[str, set[str]] = {fn: set(locks) for fn, locks in acquires.items()}
    changed = True
    while changed:
        changed = False
        for fn, callees in resolved.items():
            mine = trans.setdefault(fn, set())
            for callee in callees:
                extra = trans.get(callee, set()) - mine
                if extra:
                    mine.update(extra)
                    changed = True

    # Held-call edges: holding A while calling f adds A -> every lock in
    # f's transitive acquire set.
    for held, desc, lineno, rel, _ in held_calls:
        # The caller fnkey was not recorded with the pair; recover it by
        # finding which of that module's functions made this call, then
        # resolve the descriptor in that caller's class context.
        for g in graphs:
            if g.rel != rel:
                continue
            for fn, descs in g.calls.items():
                if desc not in descs:
                    continue
                key = _resolve_descriptor(desc, fn, rel, acquires, attr_types)
                if key is None:
                    continue
                for lock in trans.get(key, ()):
                    if lock != held:
                        edges.setdefault(held, set()).add((lock, lineno, rel))

    findings: list[Finding] = []
    seen_cycles: set[frozenset] = set()
    for start in sorted(edges):
        stack = [(start, [start])]
        while stack:
            node, path = stack.pop()
            for nxt, lineno, rel in sorted(edges.get(node, ())):
                if nxt == start and len(path) > 1:
                    cyc = frozenset(path)
                    if cyc in seen_cycles:
                        continue
                    seen_cycles.add(cyc)
                    sup = suppressions.get(rel)
                    if sup is not None and sup.suppressed(lineno, "CKO-J005"):
                        continue
                    findings.append(
                        Finding(
                            code="CKO-J005",
                            severity=SEV_ERROR,
                            message=(
                                "lock-order inversion: "
                                + " -> ".join(path + [start])
                            ),
                            location=f"{rel}:{lineno}",
                            detail=(
                                "two threads taking these locks in opposite "
                                "orders can deadlock (dispatch/collector class)"
                            ),
                        )
                    )
                elif nxt not in path:
                    stack.append((nxt, path + [nxt]))
    return findings


# ---------------------------------------------------------------------------
# GIL-release buffer safety (CKO-J006)
# ---------------------------------------------------------------------------


def _shared_bytearrays(tree: ast.Module) -> tuple[set[str], set[str]]:
    """(module-global names, self-attribute names) bound to bytearray(...)
    anywhere in the module — the mutable, resizable buffers another
    thread can reach while a native call has dropped the GIL."""

    def _is_ba(value: ast.AST) -> bool:
        return (
            isinstance(value, ast.Call)
            and _dotted(value.func) == "bytearray"
        )

    globals_: set[str] = set()
    for stmt in tree.body:
        if isinstance(stmt, ast.Assign) and _is_ba(stmt.value):
            for tgt in stmt.targets:
                if isinstance(tgt, ast.Name):
                    globals_.add(tgt.id)
    attrs: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and _is_ba(node.value):
            for tgt in node.targets:
                if (
                    isinstance(tgt, ast.Attribute)
                    and _dotted(tgt).startswith("self.")
                ):
                    attrs.add(tgt.attr)
    return globals_, attrs


class _GilReleaseLinter(ast.NodeVisitor):
    """CKO-J006: shared bytearrays handed to GIL-released native calls.

    ctypes drops the GIL for every CDLL call, and ``from_buffer`` pins a
    raw pointer into the bytearray's backing store. A frame-local buffer
    or an ArenaLease-held arena slice is safe (nothing else can reach
    it); a module-global or ``self.``-attribute bytearray is not —
    another thread resizing it mid-call leaves the native side writing
    through freed memory."""

    def __init__(
        self,
        rel: str,
        findings: list[Finding],
        suppress: _Suppressions,
        ba_globals: set[str],
        ba_attrs: set[str],
    ):
        self.rel = rel
        self.findings = findings
        self.suppress = suppress
        self.ba_globals = ba_globals
        self.ba_attrs = ba_attrs

    def visit_Call(self, node: ast.Call) -> None:
        name = _dotted(node.func)
        leaf = name.split(".")[-1] if name else ""
        is_native = leaf.startswith("cko_") and "." in name
        # (ctypes.c_ubyte * n).from_buffer(x) has no dotted chain — match
        # the attribute name itself.
        is_from_buffer = (
            isinstance(node.func, ast.Attribute)
            and node.func.attr == "from_buffer"
        )
        if is_from_buffer:
            name = name or "from_buffer"
        if is_native or is_from_buffer:
            for arg in node.args:
                for sub in ast.walk(arg):
                    shared = None
                    if (
                        isinstance(sub, ast.Attribute)
                        and _dotted(sub).startswith("self.")
                        and sub.attr in self.ba_attrs
                    ):
                        shared = _dotted(sub)
                    elif (
                        isinstance(sub, ast.Name)
                        and sub.id in self.ba_globals
                    ):
                        shared = sub.id
                    if shared is None:
                        continue
                    if self.suppress.suppressed(node.lineno, "CKO-J006"):
                        continue
                    kind = (
                        f"GIL-released native call {name}()"
                        if is_native
                        else "from_buffer() pointer pin"
                    )
                    self.findings.append(
                        Finding(
                            code="CKO-J006",
                            severity=SEV_ERROR,
                            message=(
                                f"shared bytearray {shared} handed to {kind}"
                            ),
                            location=f"{self.rel}:{node.lineno}",
                            detail=(
                                "another thread can resize it mid-call and "
                                "free the backing store under the native "
                                "writer; use a frame-local buffer or an "
                                "ArenaLease-held slice"
                            ),
                        )
                    )
        self.generic_visit(node)


# ---------------------------------------------------------------------------
# ArenaLease lifetime (CKO-J007)
# ---------------------------------------------------------------------------


def _walk_shallow(fn: ast.AST):
    """Walk a function body without descending into nested defs/lambdas
    (their lease lifecycles are their own)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(
            node,
            (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.ClassDef),
        ):
            continue
        stack.extend(ast.iter_child_nodes(node))


def _mentions(node: ast.AST, var: str) -> bool:
    return any(
        isinstance(sub, ast.Name) and sub.id == var for sub in ast.walk(node)
    )


def _lease_lifetime_findings(
    rel: str,
    fn: ast.FunctionDef | ast.AsyncFunctionDef,
    suppress: _Suppressions,
) -> list[Finding]:
    """CKO-J007 for one function: every lease var (assigned from a
    ``.checkout(...)`` call, or a call-result name containing "lease")
    must be released on some path or escape ownership (returned, stored
    to an attribute, passed on); an unconditional release must not be
    followed in the same block by another release or any further use."""
    lease_vars: dict[str, int] = {}  # var -> first checkout/unpack line
    for node in _walk_shallow(fn):
        if not (isinstance(node, ast.Assign) and isinstance(node.value, ast.Call)):
            continue
        leaf = _dotted(node.value.func).split(".")[-1]
        for tgt in node.targets:
            if isinstance(tgt, ast.Name):
                # Only checkout() results: a bare name containing "lease"
                # may be anything (e.g. a Kubernetes coordination Lease).
                if leaf == "checkout":
                    lease_vars.setdefault(tgt.id, node.lineno)
            elif isinstance(tgt, (ast.Tuple, ast.List)):
                for el in tgt.elts:
                    if isinstance(el, ast.Name) and "lease" in el.id.lower():
                        lease_vars.setdefault(el.id, node.lineno)
    if not lease_vars:
        return []

    findings: list[Finding] = []

    def _emit(code_line: int, message: str, detail: str) -> None:
        if suppress.suppressed(code_line, "CKO-J007"):
            return
        findings.append(
            Finding(
                code="CKO-J007",
                severity=SEV_ERROR,
                message=message,
                location=f"{rel}:{code_line}",
                detail=detail,
            )
        )

    for var in sorted(lease_vars):
        released = False
        escaped = False
        first_line = lease_vars[var]
        for node in _walk_shallow(fn):
            if isinstance(node, ast.Call):
                fname = _dotted(node.func)
                if fname == f"{var}.release":
                    released = True
                elif any(_mentions(arg, var) for arg in node.args) or any(
                    _mentions(kw.value, var) for kw in node.keywords
                ):
                    escaped = True  # ownership handed on
            elif isinstance(node, ast.Return):
                if node.value is not None and _mentions(node.value, var):
                    escaped = True
            elif isinstance(node, (ast.Yield, ast.YieldFrom)):
                if node.value is not None and _mentions(node.value, var):
                    escaped = True
            elif isinstance(node, ast.Assign):
                if _mentions(node.value, var):
                    for tgt in node.targets:
                        if isinstance(tgt, (ast.Attribute, ast.Subscript)):
                            escaped = True  # stored: rides the batch object
        if not released and not escaped:
            _emit(
                first_line,
                f"lease {var!r} checked out in {fn.name}() is never "
                f"released and never escapes",
                "a leaked ArenaLease pins its arena slot until GC; "
                "release() in a finally, or hand it to the in-flight batch "
                "for collect() to release",
            )

        # Linear-block ordering: an unconditional release followed in the
        # same statement list by another release or any use of the var.
        # The function node itself owns the outermost statement list.
        for node in [fn, *_walk_shallow(fn)]:
            for field in ("body", "orelse", "finalbody"):
                block = getattr(node, field, None)
                if not (
                    isinstance(block, list)
                    and block
                    and isinstance(block[0], ast.stmt)
                ):
                    continue
                released_line: int | None = None
                for stmt in block:
                    is_release = (
                        isinstance(stmt, ast.Expr)
                        and isinstance(stmt.value, ast.Call)
                        and _dotted(stmt.value.func) == f"{var}.release"
                    )
                    if is_release:
                        if released_line is not None:
                            _emit(
                                stmt.lineno,
                                f"lease {var!r} released twice in "
                                f"{fn.name}() (first at line "
                                f"{released_line})",
                                "the second release can free a slot the "
                                "next window already re-leased",
                            )
                        released_line = stmt.lineno
                        continue
                    if isinstance(stmt, ast.Assign) and any(
                        isinstance(t, ast.Name) and t.id == var
                        for t in stmt.targets
                    ):
                        released_line = None  # rebound: new lease lifecycle
                        continue
                    if released_line is not None and _mentions(stmt, var):
                        _emit(
                            stmt.lineno,
                            f"lease {var!r} used after release in "
                            f"{fn.name}() (released at line "
                            f"{released_line})",
                            "tensors behind a released lease can be "
                            "overwritten by the next window before "
                            "collect() reads them",
                        )
                        released_line = None  # one finding per release
    return findings


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def _parse_module(rel: str, source: str) -> tuple[ast.Module | None, Finding | None]:
    try:
        return ast.parse(source), None
    except SyntaxError as err:
        return None, Finding(
            code="CKO-J000",
            severity=SEV_ERROR,
            message=f"syntax error: {err.msg}",
            location=f"{rel}:{err.lineno or 0}",
        )


def _module_findings(
    rel: str, tree: ast.Module, suppress: _Suppressions
) -> list[Finding]:
    """Everything except lock-order (which wants the whole-package graph):
    hot-path syncs, GIL-release buffer safety, lease lifetimes."""
    findings = _hot_path_findings(rel, tree, suppress)
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            findings.extend(_lease_lifetime_findings(rel, node, suppress))
    ba_globals, ba_attrs = _shared_bytearrays(tree)
    if ba_globals or ba_attrs:
        _GilReleaseLinter(rel, findings, suppress, ba_globals, ba_attrs).visit(tree)
    return findings


def lint_source(rel: str, source: str) -> list[Finding]:
    """Lint one module's source text; ``rel`` is the path used in finding
    locations (and matched against NO_SYNC_HOT_PATHS). Lock-order analysis
    here is single-module; ``lint_paths`` runs it package-wide."""
    tree, err = _parse_module(rel, source)
    if tree is None:
        return [err] if err else []
    suppress = _Suppressions(source)
    findings = _module_findings(rel, tree, suppress)
    findings.extend(
        _lock_order_findings([_collect_lock_graph(rel, tree)], {rel: suppress})
    )
    return findings


def lint_paths(paths: list[Path], root: Path | None = None) -> AnalysisReport:
    report = AnalysisReport()
    root = root or PACKAGE_ROOT.parent
    files: list[Path] = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            files.extend(sorted(p.rglob("*.py")))
        else:
            files.append(p)
    graphs: list[_LockGraph] = []
    suppressions: dict[str, _Suppressions] = {}
    for f in files:
        if "__pycache__" in f.parts:
            continue
        try:
            rel = str(f.resolve().relative_to(Path(root).resolve()))
        except ValueError:
            rel = str(f)
        rel = rel.replace(os.sep, "/")
        # Findings key on package-relative paths so the gate's output is
        # stable no matter where the checkout lives.
        rel = rel.removeprefix(PACKAGE_NAME + "/")
        source = f.read_text()
        tree, err = _parse_module(rel, source)
        if tree is None:
            if err:
                report.add(err)
            continue
        suppress = _Suppressions(source)
        for finding in _module_findings(rel, tree, suppress):
            report.add(finding)
        graphs.append(_collect_lock_graph(rel, tree))
        suppressions[rel] = suppress
    # One lock graph over every module: cross-module inversions between the
    # scheduler/quarantine/watchdog/restore threads are in scope.
    for finding in _lock_order_findings(graphs, suppressions):
        report.add(finding)
    return report.finalize()


def lint_package() -> AnalysisReport:
    """Lint this package's source (the gate's target)."""
    return lint_paths([PACKAGE_ROOT], root=PACKAGE_ROOT)
