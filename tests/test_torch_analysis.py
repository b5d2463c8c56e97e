"""torchsan and the lock checker (kubernetes_tpu_torch/analysis/).

One seeded fixture per rule: a small package written to a temporary
directory with the port's layout (a `Scheduler._dispatch_runs` root, an
`ops/kernels.py` of `*_cuda` wrappers, an `ops/program.py` of entries and
`_*_plain` versions), each violation reached through a different kind of
call (a method, a module alias, an imported function, a function-local
import), and the analyzer must report exactly the seeded findings: none
behind a `_*_plain` function, none on a receiver it can prove is host
data, none on a waived line. Every rule of RULES has a fixture here, so
a rule added without one fails. Then the port itself: `python -m
kubernetes_tpu_torch.analysis` exits 0, every waiver names its reason,
and the walk reaches the dispatch region's known functions."""

import os
import subprocess
import sys
import textwrap

import pytest

from kubernetes_tpu_torch.analysis import RULES, analyze
from kubernetes_tpu_torch.analysis.findings import waivers_without_reason

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCHEDULER = '''
import numpy as np
import torch

from .ops import program as prog
from .ops.program import run_entry


class Scheduler:
    def _dispatch_runs(self, carry, batch, device):
        self._spans(carry, batch, device)
        prog.via_alias(carry, device)
        run_entry(carry, device)
        return carry

    def _spans(self, carry, batch, device):
        {spans}

    def not_reached(self, carry):
        carry.used.add_(1)
        return carry.used.sum().item()
'''

PROGRAM = '''
import torch


def via_alias(carry, device):
    {alias}


def run_entry(carry, device):
    from .kernels import thing_cuda
    if device.type == "cuda":
        return thing_cuda(carry, device)
    return _run_plain(carry)


def _run_plain(carry):
    carry.used.add_(1)
    return carry.used.sum().item()
'''

KERNELS = '''
import numpy as np
import torch


def thing_cuda(carry, device):
    {wrapper}
'''

LOCKS = '''
import threading


class Ring:
    def __init__(self):
        self._lock = threading.Lock()
        self._other = threading.Lock()
        self._items = []   # guarded_by: _lock

    def add(self, x):
        {add}

    def forward(self):
        with self._lock:
            with self._other:
                return len(self._items)

    def backward(self):
        {backward}

    {extra}
'''

PASS = "return None"
CLEAN_LOCKS = dict(
    extra="",
    add="with self._lock:\n            self._items.append(x)",
    backward="with self._lock:\n            with self._other:\n"
             "                return 0")


def _indent(code: str, n: int) -> str:
    return textwrap.indent(textwrap.dedent(code).strip(), " " * n).lstrip()


def _package(tmp_path, spans=PASS, alias=PASS, wrapper=PASS, **locks):
    """Write the fixture package `fakepkg` under tmp_path."""
    pkg = tmp_path / "fakepkg"
    (pkg / "ops").mkdir(parents=True, exist_ok=True)
    (pkg / "__init__.py").write_text("")
    (pkg / "ops" / "__init__.py").write_text("")
    (pkg / "scheduler.py").write_text(
        SCHEDULER.replace("{spans}", _indent(spans, 8)))
    (pkg / "ops" / "program.py").write_text(
        PROGRAM.replace("{alias}", _indent(alias, 4)))
    (pkg / "ops" / "kernels.py").write_text(
        KERNELS.replace("{wrapper}", _indent(wrapper, 4)))
    lk = dict(CLEAN_LOCKS, **locks)
    (pkg / "locks_fixture.py").write_text(
        LOCKS.replace("{add}", _indent(lk["add"], 8))
        .replace("{backward}", _indent(lk["backward"], 8))
        .replace("{extra}", _indent(lk["extra"], 4)))
    findings, an, bare = analyze(str(tmp_path), package="fakepkg")
    return [f for f in findings if not f.waived], an, bare


def _rules(findings):
    return sorted((f.rule, f.func) for f in findings)


def test_clean_fixture_has_no_findings(tmp_path):
    live, an, bare = _package(tmp_path)
    assert live == [] and bare == [] and an.missing_roots == []
    reached = {f.qualname for f in an.closure}
    assert {"Scheduler._dispatch_runs", "Scheduler._spans", "via_alias",
            "run_entry", "thing_cuda"} <= reached
    # the closure stops at the plain version and never reaches a method
    # nobody in the region calls
    assert "_run_plain" not in reached and \
        "Scheduler.not_reached" not in reached


SEEDED = {
    "host-sync": [
        ("spans", "return carry.used.sum().item()", "Scheduler._spans"),
        ("alias", "return carry.npods.tolist()", "via_alias"),
        ("wrapper", "return carry.used.cpu()", "thing_cuda"),
        ("wrapper", "return carry.used.numpy()", "thing_cuda"),
        ("spans", "torch.cuda.synchronize()", "Scheduler._spans"),
        ("alias", "ev = torch.cuda.Event()\nev.synchronize()", "via_alias"),
        ("spans", "return int(carry.npods.max())", "Scheduler._spans"),
        ("wrapper", "return bool(torch.any(carry.used > 0))",
         "thing_cuda"),
    ],
    "pageable-h2d": [
        ("spans", "return torch.tensor([1, 2], device=device)",
         "Scheduler._spans"),
        ("alias", "return torch.as_tensor(batch, device=device)",
         "via_alias"),
        ("wrapper", "return torch.from_numpy(np.zeros(3)).to(device)",
         "thing_cuda"),
        ("wrapper", "return torch.ones(3).pin_memory().to(device)",
         "thing_cuda"),
        ("spans", "return torch.ones(3).cuda()", "Scheduler._spans"),
    ],
    "carry-write": [
        ("spans", "carry.used.add_(1)", "Scheduler._spans"),
        ("alias", "carry.cache.s_fit[0] = 1", "via_alias"),
        ("wrapper", "u = carry.used\nu += 1", "thing_cuda"),
        ("spans", "carry.npods.__setitem__(0, 1)", "Scheduler._spans"),
        ("wrapper", "rec = object()\nrec.carry_in.used.zero_()",
         "thing_cuda"),
    ],
}


@pytest.mark.parametrize("rule,where,code,func", [
    (rule, *case) for rule, cases in SEEDED.items() for case in cases],
    ids=lambda v: v if isinstance(v, str) and len(v) < 20 else None)
def test_seeded_violation_is_detected(tmp_path, rule, where, code, func):
    live, _an, _bare = _package(tmp_path, **{where: code})
    assert _rules(live) == [(rule, func)], [f.format() for f in live]


@pytest.mark.parametrize("where,code", [
    ("spans", "x = np.arange(4)\nreturn x.tolist()"),
    ("wrapper", "idx = np.asarray([1, 2])\nreturn int(idx.max())"),
    ("wrapper", "return torch.ones(3).pin_memory().to(device, "
                "non_blocking=True)"),
    ("spans", "return torch.arange(4, device=device)"),
    ("alias", "out = torch.empty_like(carry.used)\nout.add_(1)\n"
              "return out"),
    ("wrapper", "return carry.used.to(torch.int32)"),
])
def test_host_values_and_safe_idioms_pass(tmp_path, where, code):
    live, _an, _bare = _package(tmp_path, **{where: code})
    assert live == [], [f.format() for f in live]


def test_waiver_suppresses_and_needs_a_reason(tmp_path):
    live, _an, bare = _package(
        tmp_path, spans="# torchsan: waive[host-sync] a test of waivers\n"
                        "return carry.used.sum().item()")
    assert live == [] and bare == []
    live, _an, bare = _package(
        tmp_path, spans="return carry.used.sum().item()  "
                        "# torchsan: waive[host-sync]")
    assert live == [] and len(bare) == 1
    # a waiver names its rule: another rule on the line still stands
    live, _an, _bare = _package(
        tmp_path, spans="carry.used.add_(1)  "
                        "# torchsan: waive[host-sync] wrong rule")
    assert _rules(live) == [("carry-write", "Scheduler._spans")]


def test_unguarded_shared_state_is_detected(tmp_path):
    live, _an, _bare = _package(tmp_path, add="self._items.append(x)")
    assert _rules(live) == [("unguarded-shared-state", "Ring.add")]


def test_holds_annotation_covers_the_body(tmp_path):
    live, _an, _bare = _package(
        tmp_path, add="return self._push(x)",
        extra="def _push(self, x):  # torchsan: holds _lock\n"
              "    self._items.append(x)")
    assert live == []
    live, _an, _bare = _package(
        tmp_path, add="return self._push(x)",
        extra="def _push(self, x):\n    self._items.append(x)")
    assert _rules(live) == [("unguarded-shared-state", "Ring._push")]


def test_lock_order_cycle_is_detected(tmp_path):
    live, _an, _bare = _package(
        tmp_path, backward="with self._other:\n    with self._lock:\n"
                           "        return 0")
    assert [f.rule for f in live] == ["lock-order-cycle"]


def test_every_rule_has_a_fixture():
    fixtured = set(SEEDED) | {"unguarded-shared-state", "lock-order-cycle"}
    assert fixtured == set(RULES)


def test_missing_root_is_a_configuration_error(tmp_path):
    _package(tmp_path)
    from kubernetes_tpu_torch.analysis import TorchsanAnalyzer
    an = TorchsanAnalyzer(str(tmp_path), package="fakepkg",
                          roots=(("scheduler", "Scheduler._gone"),)).load()
    an.run()
    assert an.missing_roots == ["fakepkg.scheduler.Scheduler._gone"]


# ---------------------------------------------------------------------------
# the port itself


def test_port_dispatch_region_is_clean():
    findings, an, bare = analyze(ROOT)
    live = [f.format() for f in findings if not f.waived]
    assert live == [] and bare == [] and an.missing_roots == []
    reached = {f"{f.module.name}.{f.qualname}" for f in an.closure}
    for name in ("kubernetes_tpu_torch.scheduler.Scheduler._dispatch_runs",
                 "kubernetes_tpu_torch.scheduler.Scheduler._scan_dispatch",
                 "kubernetes_tpu_torch.scheduler.Scheduler._gang_dispatch",
                 "kubernetes_tpu_torch.state.convert.pod_xs_from_numpy",
                 "kubernetes_tpu_torch.ops.program.run_uniform",
                 "kubernetes_tpu_torch.ops.gang.run_gang",
                 "kubernetes_tpu_torch.compiler.plan.DrainCompiler."
                 "compile_drain",
                 "kubernetes_tpu_torch.compiler.surfaces.SurfaceCache.get",
                 "kubernetes_tpu_torch.analysis.rails.SanitizerRails.hold",
                 "kubernetes_tpu_torch.ops.kernels.score_probe_cuda",
                 "kubernetes_tpu_torch.ops.kernels.run_uniform_cuda"):
        assert name in reached, name
    assert not any(f.is_plain for f in an.closure)


def test_port_waivers_name_their_reasons():
    pkg = os.path.join(ROOT, "kubernetes_tpu_torch")
    for d, _dirs, names in os.walk(pkg):
        for n in names:
            if n.endswith(".py"):
                with open(os.path.join(d, n)) as f:
                    assert waivers_without_reason(f.read()) == [], n


def test_cli_exits_zero_on_the_port():
    out = subprocess.run(
        [sys.executable, "-m", "kubernetes_tpu_torch.analysis"], cwd=ROOT,
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "0 findings" in out.stdout
