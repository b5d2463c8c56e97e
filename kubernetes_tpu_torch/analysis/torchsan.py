"""torchsan: static rules for the port's dispatch region.

The port's counterpart of kubernetes_tpu/analysis/jaxsan.py. The JAX
package's hazards live inside traced code; the port's live in the
*dispatch region*: the host code that enqueues a drain's kernels
(`Scheduler._dispatch_runs` and everything it calls) and the kernel
wrappers (`ops/kernels.py`, every `*_cuda` function). That code must only
enqueue: one host wait there serializes the drain behind the card, one
blocking copy from pageable memory waits for every kernel already queued,
and one write into a carry a dispatched run still holds breaks that
run's rewind. The runtime twin is the sync guard of rails.py; this walk
sees the paths a test run does not take.

The analyzer loads every module of the package, indexes its functions,
methods and imports, and takes the call-graph closure of the roots. A
call resolves through a module function, an imported function (local
imports included), `self.<method>` inside a class, a module alias, or an
object attribute named in `ATTR_CLASSES` (the scheduler's collaborators:
`self.compiler`, `.surfaces`, `self.rails`, `RAILS`). The closure stops
at the `_*_plain` functions, which only CPU tensors reach.

Rules, over every function of the closure:

- `host-sync`: `.item()`, `.tolist()`, `.cpu()`, `.numpy()`,
  `torch.cuda.synchronize()`, `<event>.synchronize()`, and int() /
  float() / bool() of a tensor expression (one that calls `torch.*` or
  a reduction method);
- `pageable-h2d`: `torch.tensor(..., device=)`, `torch.as_tensor(...,
  device=)`, or `.to(<device>)` / `.cuda()` of anything but a
  `.pin_memory()` with `non_blocking=True`;
- `carry-write`: an in-place method (`*_`, `__setitem__`), a subscript
  assignment or an augmented assignment on a carry (a parameter named
  `carry` / `carry_in` or annotated `Carry`, an attribute `carry_in` /
  `_device_carry`) or on a name bound from one of its fields.

A receiver the walk can prove to be host data (bound from a numpy call,
a literal, a builtin, or a parameter annotated `int` / `bool` / `float`
/ `str` or with a numpy NamedTuple of state/batch.py, `PodBatch` /
`PodTable`) does not count: `.tolist()` of a numpy array waits for nothing.
Everything else the walk cannot type is flagged; an intended exception
carries a per-line waiver with its reason (findings.py).
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field

from .findings import Finding

# roots, relative to the package: (module, qualname)
ROOTS = (("scheduler", "Scheduler._dispatch_runs"),)
# modules whose every `*_cuda` function is a root (the kernel wrappers)
WRAPPER_MODULES = ("ops.kernels",)
# attribute (or module object) name → (module, class) the resolver follows
ATTR_CLASSES = {
    "compiler": ("compiler.plan", "DrainCompiler"),
    "surfaces": ("compiler.surfaces", "SurfaceCache"),
    "rails": ("analysis.rails", "SanitizerRails"),
    "RAILS": ("analysis.rails", "SanitizerRails"),
}

_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
_REDUCTIONS = {"any", "all", "sum", "max", "min", "prod", "mean", "item",
               "argmax", "argmin", "count_nonzero", "nonzero"}
_HOST_BUILTINS = {"len", "int", "float", "bool", "range", "list", "dict",
                  "tuple", "sorted", "min", "max", "sum", "enumerate", "zip",
                  "str", "set", "abs", "round", "isinstance", "getattr"}
# annotations of host values: Python scalars and the numpy NamedTuples of
# state/batch.py
_HOST_ANNOTATIONS = {"int", "bool", "float", "str", "PodBatch", "PodTable"}
_CARRY_PARAMS = {"carry", "carry_in"}
_CARRY_ATTRS = {"carry_in", "_device_carry"}


def _dotted(node: ast.AST) -> str | None:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


@dataclass
class ModuleInfo:
    name: str                     # dotted module name
    path: str                     # path relative to the analysis root
    tree: ast.Module
    source: str
    funcs: dict = field(default_factory=dict)     # qualname → FunctionDef
    classes: set = field(default_factory=set)
    modules: dict = field(default_factory=dict)   # alias → dotted module
    objects: dict = field(default_factory=dict)   # alias → (module, name)
    numpy: set = field(default_factory=set)       # aliases of numpy
    torch: set = field(default_factory=set)       # aliases of torch


@dataclass
class FnInfo:
    module: ModuleInfo
    qualname: str
    node: ast.FunctionDef

    @property
    def cls(self) -> str | None:
        return self.qualname.split(".")[0] if "." in self.qualname else None

    @property
    def is_plain(self) -> bool:
        name = self.node.name
        return name.startswith("_") and name.endswith("_plain")


class TorchsanAnalyzer:
    """Dispatch-region linter over one package (see module docstring)."""

    def __init__(self, root: str, package: str = "kubernetes_tpu_torch",
                 roots=ROOTS):
        self.root = root
        self.package = package
        self.roots = tuple(roots)
        self.modules: dict[str, ModuleInfo] = {}
        self.fns: dict[str, FnInfo] = {}       # "module:qualname" → FnInfo
        self.closure: list[FnInfo] = []
        self.missing_roots: list[str] = []
        self.findings: list[Finding] = []

    # -- loading --------------------------------------------------------------

    def load(self) -> "TorchsanAnalyzer":
        pkg_dir = os.path.join(self.root, *self.package.split("."))
        for dirpath, dirs, files in os.walk(pkg_dir):
            dirs.sort()
            for fn in sorted(files):
                if not fn.endswith(".py"):
                    continue
                path = os.path.join(dirpath, fn)
                rel = os.path.relpath(path, self.root)
                mod = rel[:-3].replace(os.sep, ".")
                if mod.endswith(".__init__"):
                    mod = mod[: -len(".__init__")]
                with open(path) as f:
                    source = f.read()
                self.modules[mod] = ModuleInfo(
                    name=mod, path=rel, source=source,
                    tree=ast.parse(source, filename=rel))
        for mi in self.modules.values():
            self._index(mi)
        return self

    def _full(self, rel: str) -> str:
        return f"{self.package}.{rel}" if rel else self.package

    def _index(self, mi: ModuleInfo) -> None:
        for node in mi.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                mi.funcs[node.name] = node
            elif isinstance(node, ast.ClassDef):
                mi.classes.add(node.name)
                for item in node.body:
                    if isinstance(item, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                        mi.funcs[f"{node.name}.{item.name}"] = item
        for q, node in mi.funcs.items():
            self.fns[f"{mi.name}:{q}"] = FnInfo(mi, q, node)
        is_pkg = mi.path.endswith("__init__.py")
        parts = mi.name.split(".")
        for node in ast.walk(mi.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    name = alias.asname or alias.name.split(".")[0]
                    mi.modules[name] = alias.name
                    if alias.name == "numpy":
                        mi.numpy.add(name)
                    elif alias.name == "torch":
                        mi.torch.add(name)
            elif isinstance(node, ast.ImportFrom):
                if node.module == "__future__":
                    continue
                if node.level:
                    keep = len(parts) - node.level + (1 if is_pkg else 0)
                    base = ".".join(parts[:keep]
                                    + ([node.module] if node.module else []))
                else:
                    base = node.module or ""
                for alias in node.names:
                    name = alias.asname or alias.name
                    sub = f"{base}.{alias.name}"
                    if sub in self.modules or os.path.exists(os.path.join(
                            self.root, *sub.split("."))):
                        mi.modules[name] = sub
                    else:
                        mi.objects[name] = (base, alias.name)

    # -- call resolution ------------------------------------------------------

    def _fn(self, module: str, qualname: str, hops: int = 0) -> FnInfo | None:
        fi = self.fns.get(f"{module}:{qualname}")
        if fi is not None or hops > 3:
            return fi
        mi = self.modules.get(module)
        if mi is not None and "." not in qualname:
            obj = mi.objects.get(qualname)   # a re-export
            if obj is not None:
                return self._fn(obj[0], obj[1], hops + 1)
        return None

    def resolve(self, fi: FnInfo, call: ast.Call) -> FnInfo | None:
        mi, f = fi.module, call.func
        if isinstance(f, ast.Name):
            if f.id in mi.funcs:
                return self.fns[f"{mi.name}:{f.id}"]
            obj = mi.objects.get(f.id)
            return self._fn(obj[0], obj[1]) if obj else None
        if not isinstance(f, ast.Attribute):
            return None
        base = f.value
        if isinstance(base, ast.Name) and base.id == "self" and fi.cls:
            return self.fns.get(f"{mi.name}:{fi.cls}.{f.attr}")
        if isinstance(base, ast.Name) and base.id in mi.modules:
            return self._fn(mi.modules[base.id], f.attr)
        tail = base.attr if isinstance(base, ast.Attribute) else (
            base.id if isinstance(base, ast.Name) else None)
        if tail in ATTR_CLASSES:
            module, cls = ATTR_CLASSES[tail]
            return self.fns.get(f"{self._full(module)}:{cls}.{f.attr}")
        return None

    def _root_fns(self) -> list[FnInfo]:
        out = []
        for module, qualname in self.roots:
            fi = self.fns.get(f"{self._full(module)}:{qualname}")
            if fi is None:
                self.missing_roots.append(f"{self._full(module)}.{qualname}")
            else:
                out.append(fi)
        for module in WRAPPER_MODULES:
            mi = self.modules.get(self._full(module))
            if mi is None:
                self.missing_roots.append(self._full(module))
                continue
            out.extend(self.fns[f"{mi.name}:{q}"] for q in mi.funcs
                       if "." not in q and q.endswith("_cuda"))
        return out

    def run(self) -> list[Finding]:
        seen: set = set()
        work = self._root_fns()
        while work:
            fi = work.pop()
            key = f"{fi.module.name}:{fi.qualname}"
            if key in seen or fi.is_plain:
                continue
            seen.add(key)
            self.closure.append(fi)
            for node in ast.walk(fi.node):
                if isinstance(node, ast.Call):
                    callee = self.resolve(fi, node)
                    if callee is not None:
                        work.append(callee)
        self.closure.sort(key=lambda f: (f.module.path, f.node.lineno))
        for fi in self.closure:
            self.findings.extend(_FnChecker(fi).run())
        return self.findings


class _FnChecker:
    """The three rules over one function of the closure."""

    def __init__(self, fi: FnInfo):
        self.fi = fi
        self.mi = fi.module
        self.out: list[Finding] = []
        self.host: set = set()
        self.carry: set = set()

    # -- light typing ---------------------------------------------------------

    def _params(self):
        a = self.fi.node.args
        return a.posonlyargs + a.args + a.kwonlyargs

    def _seed(self) -> None:
        for p in self._params():
            ann = _dotted(p.annotation) if p.annotation is not None else None
            if isinstance(p.annotation, ast.Constant):
                ann = str(p.annotation.value)
            tail = (ann or "").split(".")[-1]
            if tail in _HOST_ANNOTATIONS or ann in {
                    f"{n}.ndarray" for n in self.mi.numpy}:
                self.host.add(p.arg)
            if p.arg in _CARRY_PARAMS or tail == "Carry":
                self.carry.add(p.arg)
        for _ in range(3):   # bindings reach a fixpoint in a few passes
            for node in ast.walk(self.fi.node):
                if isinstance(node, ast.Assign):
                    targets, value = node.targets, node.value
                elif isinstance(node, (ast.AnnAssign, ast.AugAssign)) and \
                        node.value is not None:
                    targets, value = [node.target], node.value
                elif isinstance(node, (ast.For, ast.comprehension)):
                    targets, value = [node.target], node.iter
                else:
                    continue
                names = [n.id for t in targets for n in ast.walk(t)
                         if isinstance(n, ast.Name)]
                if self.is_host(value):
                    self.host.update(names)
                elif self.is_carry(value) and not isinstance(node, ast.For):
                    self.carry.update(names)

    def is_host(self, e: ast.AST) -> bool:
        if isinstance(e, ast.Constant):
            return True
        if isinstance(e, ast.Name):
            return e.id in self.host
        if isinstance(e, (ast.List, ast.Tuple, ast.Set)):
            return all(self.is_host(x) for x in e.elts)
        if isinstance(e, (ast.Dict, ast.ListComp, ast.SetComp, ast.DictComp,
                          ast.JoinedStr)):
            return True
        if isinstance(e, (ast.Attribute, ast.Subscript, ast.Starred)):
            return self.is_host(e.value)
        if isinstance(e, ast.BinOp):
            return self.is_host(e.left) and self.is_host(e.right)
        if isinstance(e, ast.UnaryOp):
            return self.is_host(e.operand)
        if isinstance(e, ast.Compare):
            return self.is_host(e.left) and all(
                self.is_host(c) for c in e.comparators)
        if isinstance(e, ast.IfExp):
            return self.is_host(e.body) and self.is_host(e.orelse)
        if isinstance(e, ast.Call):
            name = _dotted(e.func) or ""
            if name.split(".")[0] in self.mi.numpy:
                return True
            if isinstance(e.func, ast.Name) and e.func.id in _HOST_BUILTINS:
                return True
            if isinstance(e.func, ast.Attribute):
                if e.func.attr in ("tolist", "numpy"):
                    return True
                if self.is_host(e.func.value):
                    return True
        return False

    def is_carry(self, e: ast.AST) -> bool:
        if isinstance(e, ast.Name):
            return e.id in self.carry
        if isinstance(e, ast.Attribute):
            return e.attr in _CARRY_ATTRS or self.is_carry(e.value)
        if isinstance(e, ast.Subscript):
            return self.is_carry(e.value)
        return False

    def _torchish(self, e: ast.AST) -> bool:
        for n in ast.walk(e):
            if isinstance(n, ast.Call):
                name = _dotted(n.func) or ""
                if name.split(".")[0] in self.mi.torch:
                    return True
                if isinstance(n.func, ast.Attribute) and \
                        n.func.attr in _REDUCTIONS:
                    return True
        return False

    # -- rules ----------------------------------------------------------------

    def _add(self, rule: str, node: ast.AST, message: str) -> None:
        self.out.append(Finding(rule=rule, path=self.mi.path,
                                line=node.lineno, message=message,
                                func=self.fi.qualname))

    @staticmethod
    def _kw(call: ast.Call, name: str):
        return next((k.value for k in call.keywords if k.arg == name), None)

    def _device_like(self, e: ast.AST | None) -> bool:
        if e is None:
            return False
        if isinstance(e, ast.Constant):
            return isinstance(e.value, str) and e.value.startswith("cuda")
        if isinstance(e, ast.Call):
            return (_dotted(e.func) or "").endswith("device")
        name = _dotted(e) or ""
        return name.split(".")[-1] in ("device", "dev")

    def _pinned_nonblocking(self, call: ast.Call) -> bool:
        recv = call.func.value
        nb = self._kw(call, "non_blocking")
        return (isinstance(recv, ast.Call)
                and isinstance(recv.func, ast.Attribute)
                and recv.func.attr == "pin_memory"
                and isinstance(nb, ast.Constant) and nb.value is True)

    def _check_call(self, call: ast.Call) -> None:
        f = call.func
        name = _dotted(f) or ""
        head = name.split(".")[0]
        if isinstance(f, ast.Attribute):
            if f.attr in _SYNC_METHODS and not call.args and \
                    not self.is_host(f.value):
                self._add("host-sync", call,
                          f"`.{f.attr}()` waits for the device")
            elif f.attr == "synchronize":
                self._add("host-sync", call, f"`{name or '.synchronize'}()`"
                          " blocks the host on the device")
            elif f.attr in ("to", "cuda"):
                moves = f.attr == "cuda" or self._device_like(
                    self._kw(call, "device")) or (
                    call.args and self._device_like(call.args[0]))
                if moves and not self._pinned_nonblocking(call):
                    self._add("pageable-h2d", call,
                              f"`.{f.attr}(...)` of a pageable host value "
                              "blocks until the stream drains")
            if (f.attr == "__setitem__" or (
                    f.attr.endswith("_") and not f.attr.startswith("_"))) \
                    and self.is_carry(f.value):
                self._add("carry-write", call,
                          f"in-place `.{f.attr}` on a carry")
        if head in self.mi.torch and name.split(".")[-1] in (
                "tensor", "as_tensor"):
            dev = self._kw(call, "device")
            if dev is not None and not (isinstance(dev, ast.Constant)
                                        and dev.value == "cpu"):
                self._add("pageable-h2d", call,
                          f"`{name}(..., device=)` copies from pageable "
                          "memory and blocks")
        if isinstance(f, ast.Name) and f.id in ("int", "float", "bool") \
                and len(call.args) == 1:
            arg = call.args[0]
            if not self.is_host(arg) and self._torchish(arg):
                self._add("host-sync", call,
                          f"`{f.id}()` of a tensor expression waits for "
                          "the device")

    def run(self) -> list[Finding]:
        self._seed()
        for node in ast.walk(self.fi.node):
            if isinstance(node, ast.Call):
                self._check_call(node)
            elif isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    if isinstance(t, ast.Subscript) and self.is_carry(
                            t.value):
                        self._add("carry-write", node,
                                  "subscript assignment into a carry")
                    elif isinstance(node, ast.AugAssign) and \
                            self.is_carry(t):
                        self._add("carry-write", node,
                                  "augmented assignment on a carry")
        return self.out


def analyze(root: str, package: str = "kubernetes_tpu_torch"):
    """(findings with waivers applied, analyzer, lines of waivers without a
    reason as (path, line)): torchsan and the lock checker over the
    package."""
    from .findings import (apply_waivers, parse_waivers,
                           waivers_without_reason)
    from .locks import LockChecker
    an = TorchsanAnalyzer(root, package=package).load()
    findings = an.run()
    findings.extend(LockChecker(an.modules).run())
    apply_waivers(findings, {mi.path: parse_waivers(mi.source)
                             for mi in an.modules.values()})
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    bare = [(mi.path, ln) for mi in an.modules.values()
            for ln in waivers_without_reason(mi.source)]
    return findings, an, bare
