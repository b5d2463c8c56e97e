"""torchsan: dispatch-region static analysis and runtime sanitizer rails.

The port's counterpart of kubernetes_tpu/analysis/. The port's device
program is hand-written kernels that a host dispatch region enqueues
without waiting; a host synchronization there, a blocking copy from
pageable memory, a write into a carry a dispatched run still holds, or a
race on a structure another thread reads is a correctness-and-throughput
bug. This package holds that contract:

- `torchsan` — an AST walk over the call-graph closure of the
  scheduler's `_dispatch_runs` and the kernel wrappers, with the rules
  host-sync, pageable-h2d and carry-write;
- `locks` — the lock-discipline checker (`# guarded_by:` annotations →
  unguarded-shared-state findings, plus lock-order cycles);
- `rails` — runtime sanitizer rails behind the `SanitizerRails` feature
  gate (the sync guard on the dispatch region, the retrace budget, the
  held-carry check, the NaN/inf probe).

`python -m kubernetes_tpu_torch.analysis` runs the static half over the
port and exits 0 iff no finding stands unwaived; tests/
test_torch_analysis.py makes it a tier-1 gate.
"""

from .findings import Finding, RULES, parse_waivers
from .locks import LockChecker
from .rails import (SanitizerRails, SanitizerError, RetraceBudgetExceeded,
                    GLOBAL as RAILS)
from .torchsan import TorchsanAnalyzer, analyze

__all__ = [
    "Finding", "RULES", "parse_waivers",
    "TorchsanAnalyzer", "analyze",
    "LockChecker",
    "SanitizerRails", "SanitizerError", "RetraceBudgetExceeded", "RAILS",
]
