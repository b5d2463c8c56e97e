"""Lock-discipline checker for the port's threaded classes.

The port's copy of kubernetes_tpu/analysis/locks.py. The scheduler's host
loop is single-threaded by design; the one class of the port read from
other threads is the API dispatcher (backend/dispatcher.py: its pending
calls and bulk binds are read by a metrics thread's `__len__`). Python
has no -race, so the discipline is declared and lint-checked instead:

- every shared mutable attribute is annotated at its `__init__`
  assignment (or dataclass field) with the lock that guards it:

      self._ring = deque()   # guarded_by: _lock

- the checker verifies every OTHER method touches `self._ring` only
  inside `with self._lock:` (unguarded-shared-state findings otherwise);
- helper methods whose contract is "caller holds the lock" declare it on
  their `def` line — `# torchsan: holds _lock` — and the checker treats
  the whole body as guarded;
- every nesting `with self.A: ... with self.B:` contributes an edge
  A→B to a global acquisition-order graph; a cycle in that graph is a
  latent deadlock (lock-order-cycle finding), reported once per cycle.

`__init__`/`__post_init__`/`__del__` are exempt (construction and
teardown happen-before/after publication).
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

from .findings import Finding, parse_guarded_by, parse_holds

_EXEMPT_METHODS = {"__init__", "__post_init__", "__del__", "__new__"}

# constructors that mark an attribute as a lock (threading module)
_LOCK_CTORS = {"Lock", "RLock", "Condition", "Semaphore",
               "BoundedSemaphore"}


@dataclass
class ClassLockInfo:
    name: str
    module_path: str
    guarded: dict = field(default_factory=dict)   # attr → lock attr
    locks: set = field(default_factory=set)       # attrs that ARE locks


class LockChecker:
    """Runs both lock rules over every class of the loaded modules.

    `modules` is the TorchsanAnalyzer's module map (name → ModuleInfo
    with .tree/.source/.path); the fixture tests can also hand it a
    synthetic map.
    """

    def __init__(self, modules: dict):
        self.modules = modules
        self.findings: list[Finding] = []
        # acquisition-order edges: (lock_id, lock_id) → first With node
        self.edges: dict[tuple[str, str], tuple[str, int]] = {}

    def run(self) -> list[Finding]:
        for mi in self.modules.values():
            lines = mi.source.splitlines()
            for node in ast.walk(mi.tree):
                if isinstance(node, ast.ClassDef):
                    info = self._collect(node, lines, mi.path)
                    self._check_class(node, info, lines)
        self._check_cycles()
        return self.findings

    # -- annotation collection ------------------------------------------------

    def _collect(self, cls: ast.ClassDef, lines: list[str],
                 path: str) -> ClassLockInfo:
        info = ClassLockInfo(name=cls.name, module_path=path)
        for node in ast.walk(cls):
            targets: list[tuple[str, int]] = []
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    attr = self._self_attr(t)
                    if attr:
                        targets.append((attr, node.lineno))
                value = node.value
            elif isinstance(node, ast.AnnAssign):
                attr = self._self_attr(node.target)
                if attr is None and isinstance(node.target, ast.Name):
                    # dataclass field declaration
                    attr = node.target.id
                if attr:
                    targets.append((attr, node.lineno))
                value = node.value
            else:
                continue
            # the annotation comment may sit on any line of a wrapped
            # assignment statement — scan the whole span
            end = getattr(node, "end_lineno", node.lineno)
            for attr, lineno in targets:
                lock = None
                for ln in range(lineno, end + 1):
                    src = lines[ln - 1] if ln - 1 < len(lines) else ""
                    lock = parse_guarded_by(src)
                    if lock:
                        break
                if lock:
                    info.guarded[attr] = lock
                    info.locks.add(lock)
                if self._is_lock_ctor(value):
                    info.locks.add(attr)
        return info

    @staticmethod
    def _self_attr(node: ast.AST) -> str | None:
        if isinstance(node, ast.Attribute) and \
                isinstance(node.value, ast.Name) and \
                node.value.id == "self":
            return node.attr
        return None

    @staticmethod
    def _is_lock_ctor(value: ast.AST | None) -> bool:
        for node in ast.walk(value) if value is not None else []:
            if isinstance(node, ast.Call):
                name = ""
                f = node.func
                while isinstance(f, ast.Attribute):
                    name = f.attr
                    f = f.value
                if isinstance(f, ast.Name) and not name:
                    name = f.id
                if name in _LOCK_CTORS:
                    return True
        return False

    # -- per-method guarded-access check --------------------------------------

    def _check_class(self, cls: ast.ClassDef, info: ClassLockInfo,
                     lines: list[str]) -> None:
        if not info.guarded and not info.locks:
            return
        for node in cls.body:
            if not isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            held: set[str] = set()
            src = lines[node.lineno - 1] if node.lineno - 1 < len(lines) \
                else ""
            holds = parse_holds(src)
            if holds:
                held.add(holds)
            if node.name not in _EXEMPT_METHODS:
                self._walk_method(node, info, held, node.name)
            self._collect_order(node, info, [])

    def _walk_method(self, node: ast.AST, info: ClassLockInfo,
                     held: set, method: str,
                     in_nested: bool = False) -> None:
        if isinstance(node, ast.With):
            new = set(held)
            for item in node.items:
                lock = self._lock_of(item.context_expr, info)
                if lock:
                    new.add(lock)
            for child in node.body:
                self._walk_method(child, info, new, method, in_nested)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and \
                not isinstance(node, ast.Module) and in_nested is False \
                and getattr(node, "_visited_root", False) is False:
            # nested def: does not execute under the enclosing with
            node._visited_root = True
            for child in ast.iter_child_nodes(node):
                self._walk_method(child, info, held if node.name == method
                                  else set(), method, True)
            return
        attr = self._self_attr(node)
        if attr and attr in info.guarded:
            lock = info.guarded[attr]
            if lock not in held:
                self.findings.append(Finding(
                    rule="unguarded-shared-state",
                    path=info.module_path, line=node.lineno,
                    message=f"{info.name}.{attr} (guarded_by {lock}) "
                            f"accessed without holding self.{lock}",
                    func=f"{info.name}.{method}"))
            # do not descend: the attribute access itself is the leaf
        for child in ast.iter_child_nodes(node):
            self._walk_method(child, info, held, method, in_nested)

    def _lock_of(self, expr: ast.AST, info: ClassLockInfo) -> str | None:
        """`with self.<lock>:` (or `self.<lock>.acquire()`-style context
        helpers) → the lock attr name, if it is a known lock."""
        attr = self._self_attr(expr)
        if attr and (attr in info.locks or attr in info.guarded.values()):
            return attr
        if isinstance(expr, ast.Call):
            return self._lock_of(expr.func, info) or (
                self._lock_of(expr.func.value, info)
                if isinstance(expr.func, ast.Attribute) else None)
        return None

    # -- acquisition-order graph ----------------------------------------------

    def _collect_order(self, node: ast.AST, info: ClassLockInfo,
                       stack: list) -> None:
        if isinstance(node, ast.With):
            acquired = []
            for item in node.items:
                lock = self._lock_of(item.context_expr, info)
                if lock:
                    lock_id = f"{info.name}.{lock}"
                    for outer in stack:
                        if outer != lock_id:
                            self.edges.setdefault(
                                (outer, lock_id),
                                (info.module_path, node.lineno))
                    acquired.append(lock_id)
            for child in node.body:
                self._collect_order(child, info, stack + acquired)
            return
        for child in ast.iter_child_nodes(node):
            self._collect_order(child, info, stack)

    def _check_cycles(self) -> None:
        graph: dict[str, set] = {}
        for (a, b) in self.edges:
            graph.setdefault(a, set()).add(b)
        seen: set = set()
        reported: set = set()

        def dfs(n: str, path: list, on_path: set) -> None:
            seen.add(n)
            on_path.add(n)
            path.append(n)
            for m in sorted(graph.get(n, ())):
                if m in on_path:
                    cycle = tuple(path[path.index(m):] + [m])
                    key = frozenset(cycle)
                    if key not in reported:
                        reported.add(key)
                        mod_path, line = self.edges.get(
                            (n, m), ("", 1))
                        self.findings.append(Finding(
                            rule="lock-order-cycle", path=mod_path,
                            line=line,
                            message="lock acquisition order cycle: "
                                    + " -> ".join(cycle)))
                elif m not in seen:
                    dfs(m, path, on_path)
            path.pop()
            on_path.discard(n)

        for n in sorted(graph):
            if n not in seen:
                dfs(n, [], set())
