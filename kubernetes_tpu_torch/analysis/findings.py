"""Finding model, rule registry and inline-waiver parsing for torchsan.

The port's copy of kubernetes_tpu/analysis/findings.py. A finding is one
(rule, file, line) hazard with a fix-it hint. Rules are a closed
registry — tests/test_torch_analysis.py seeds one violation per rule and
asserts each is detected, so a rule added here without a fixture is
itself a test failure.

Waiver syntax:

    n = int(batch.sig[i])  # torchsan: waive[host-sync] a numpy row

A waiver comment on the flagged line (or the line directly above, for
findings on long expressions) suppresses the named rule(s) there;
`waive[*]` suppresses every rule on that line. A waiver names its
reason after the bracket; one without a reason is itself a finding
(`check_waiver_reasons`).
"""

from __future__ import annotations

import re
from dataclasses import dataclass

# rule id → (summary, fix-it hint). The first three are the dispatch-region
# rules (torchsan.py); the last two come from the lock checker.
RULES: dict[str, tuple[str, str]] = {
    "host-sync": (
        "host synchronization in the dispatch region",
        "`.item()`, `.tolist()`, `.cpu()`, `.numpy()`, a synchronize, or "
        "int()/float()/bool() of a tensor waits for the device and "
        "serializes the drain; keep the value on the device, or read it "
        "in the commit or a declared host_* phase"),
    "pageable-h2d": (
        "blocking host-to-device copy from pageable memory",
        "torch.tensor(..., device=) / .to(device) of a host value blocks "
        "until the stream drains; build the tensor on the host, then "
        "`.pin_memory().to(device, non_blocking=True)`"),
    "carry-write": (
        "in-place write into a carry",
        "a dispatched run may still hold this carry for rewind or replay "
        "(_RunRec.carry_in); return a fresh carry instead of writing the "
        "input"),
    "unguarded-shared-state": (
        "shared attribute accessed outside its declared lock",
        "this attribute is annotated `# guarded_by: <lock>`; take the "
        "lock (`with self.<lock>:`) around the access, or mark the "
        "helper `# torchsan: holds <lock>` if every caller already "
        "holds it"),
    "lock-order-cycle": (
        "locks acquired in inconsistent order",
        "two code paths nest these locks in opposite orders — a classic "
        "deadlock; pick one global order and acquire in it everywhere"),
}

_WAIVE_RE = re.compile(r"#\s*torchsan:\s*waive\[([^\]]*)\]\s*(.*)$")
_HOLDS_RE = re.compile(r"#\s*torchsan:\s*holds\s+(\w+)")
_GUARDED_RE = re.compile(r"#\s*guarded_by:\s*(\w+)")


@dataclass
class Finding:
    """One hazard at file:line. `waived` findings are kept (so the CLI's
    --list-waivers can audit the baseline) but do not fail the check."""

    rule: str
    path: str
    line: int
    message: str
    func: str = ""          # enclosing function/class qualname
    hint: str = ""
    waived: bool = False

    def __post_init__(self) -> None:
        if not self.hint:
            self.hint = RULES.get(self.rule, ("", ""))[1]

    def format(self, fix_hints: bool = False) -> str:
        loc = f"{self.path}:{self.line}"
        where = f" (in {self.func})" if self.func else ""
        out = f"{loc}: [{self.rule}] {self.message}{where}"
        if self.waived:
            out += "  [waived]"
        if fix_hints and self.hint:
            out += f"\n    fix: {self.hint}"
        return out

    def to_dict(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "message": self.message, "func": self.func,
                "hint": self.hint, "waived": self.waived}


def parse_waivers(source: str) -> dict[int, set[str]]:
    """line number (1-based) → waived rule ids (`{"*"}` = all). A waiver
    comment covers its own line and the line below it, so wrapped
    expressions can carry the waiver on their first line."""
    out: dict[int, set[str]] = {}
    for i, text in enumerate(source.splitlines(), start=1):
        m = _WAIVE_RE.search(text)
        if not m:
            continue
        rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
        for line in (i, i + 1):
            out.setdefault(line, set()).update(rules)
    return out


def waivers_without_reason(source: str) -> list[int]:
    """Lines whose waiver names no reason after its bracket."""
    return [i for i, text in enumerate(source.splitlines(), start=1)
            if (m := _WAIVE_RE.search(text)) and not m.group(2).strip()]


def is_waived(waivers: dict[int, set[str]], line: int, rule: str) -> bool:
    rules = waivers.get(line)
    return bool(rules) and ("*" in rules or rule in rules)


def parse_holds(source_line: str) -> str | None:
    """`# torchsan: holds <lock>` on a def line: the method's contract is
    that every caller already holds <lock> (the lock checker treats the
    whole body as guarded)."""
    m = _HOLDS_RE.search(source_line)
    return m.group(1) if m else None


def parse_guarded_by(source_line: str) -> str | None:
    """`# guarded_by: <lock>` on an attribute assignment."""
    m = _GUARDED_RE.search(source_line)
    return m.group(1) if m else None


def apply_waivers(findings: list[Finding],
                  waivers_by_path: dict[str, dict[int, set[str]]]
                  ) -> list[Finding]:
    for f in findings:
        w = waivers_by_path.get(f.path)
        if w and is_waived(w, f.line, f.rule):
            f.waived = True
    return findings
