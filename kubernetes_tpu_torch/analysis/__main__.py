"""The torchsan command: the dispatch-region rules and the lock checker over
the port.

    python -m kubernetes_tpu_torch.analysis                 # exit 0 iff clean
    python -m kubernetes_tpu_torch.analysis --list-waivers  # and the waived

Exit codes: 0 = no unwaived finding; 1 = findings, or a waiver that names
no reason; 2 = a configured root no longer exists (the walk would
silently lose its coverage)."""

from __future__ import annotations

import argparse
import os
import sys

from .torchsan import analyze

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m kubernetes_tpu_torch.analysis",
        description="torchsan and the lock checker over the port")
    ap.add_argument("--list-waivers", action="store_true",
                    help="also print the waived findings")
    args = ap.parse_args(argv)
    findings, an, bare = analyze(_ROOT)
    live = [f for f in findings if not f.waived]
    for f in (findings if args.list_waivers else live):
        print(f.format(fix_hints=not f.waived))
    for p, ln in bare:
        print(f"{p}:{ln}: waiver names no reason")
    for r in an.missing_roots:
        print(f"missing root: {r}")
    print(f"torchsan: {len(an.closure)} functions in the dispatch region, "
          f"{len(live)} findings, {len(findings) - len(live)} waived")
    if an.missing_roots:
        return 2
    return 1 if live or bare else 0


if __name__ == "__main__":
    sys.exit(main())
