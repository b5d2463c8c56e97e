"""Decision provenance: per-bind plugin-level score decomposition.

The port of kubernetes_tpu/obs/explain.py. `diagnose_row` answers "why
was this pod rejected everywhere"; this module answers the complement
for placed pods, "why did pod X land on node Y instead of Z", through
the `explain_row` kernel (ops/program.py): the winning node and the
top-k runners-up with each plugin's weighted score contribution and the
win margin.

The port answers in the JAX package's `current_state` mode: the
decomposition evaluates against the live post-commit state with the
pod's own RESOURCES removed from its bound node (group counters and port
bookkeeping are not unwound, which the output flags). That is where the
JAX package answers too when its shadow-audit ledger holds no record of
the pod. Its `exact` mode (a replay of the audited drain's prefix)
arrives with the port's audit ledger.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.program import EXPLAIN_COLUMNS, explain_row, initial_carry

# short column headers for the rendered table, EXPLAIN_COLUMNS order
_HEADERS = ("Fit", "Balanced", "Taint", "NodeAffinity", "Image", "Groups")


def _assemble(uid: str, mode: str, names, idx, totals, cols, n_feasible,
              bound: Optional[str], extra: dict, k: int) -> dict:
    idx = np.asarray(idx)
    totals = np.asarray(totals)
    cols = np.asarray(cols)
    ranked = []
    for r in range(min(k, len(idx))):
        if totals[r] < 0:
            break
        node_i = int(idx[r])
        ranked.append({
            "node": names[node_i] if node_i < len(names) else f"#{node_i}",
            "total": int(totals[r]),
            "columns": {name: int(cols[r, c])
                        for c, name in enumerate(EXPLAIN_COLUMNS)},
        })
    margin = (int(totals[0] - totals[1])
              if len(ranked) >= 2 else None)
    out = {
        "pod": uid, "mode": mode, "boundNode": bound,
        "feasibleNodes": int(n_feasible),
        "winner": ranked[0] if ranked else None,
        "margin": margin,
        "runnersUp": ranked[1:],
        **extra,
    }
    out["rendered"] = _render(out)
    return out


def _render(d: dict) -> str:
    """Reference-format text table (the /debug/explain human form)."""
    lines = [f"pod {d['pod']}: "
             + (f"bound to {d['boundNode']}" if d["boundNode"]
                else "not bound")
             + f" [{d['mode']}]"]
    winner = d.get("winner")
    if winner is None:
        lines.append(f"  no feasible node "
                     f"({d['feasibleNodes']} feasible)")
        return "\n".join(lines)
    margin = d.get("margin")
    lines.append(
        f"  top {1 + len(d['runnersUp'])} of {d['feasibleNodes']} "
        "feasible nodes"
        + (f", win margin +{margin}" if margin is not None else ""))
    width = max(len(winner["node"]),
                *(len(r["node"]) for r in d["runnersUp"])) \
        if d["runnersUp"] else len(winner["node"])
    width = max(width, 4)
    header = ("  #  " + "node".ljust(width) + "  total  "
              + "  ".join(h.rjust(len(h)) for h in _HEADERS))
    lines.append(header)
    for rank, row in enumerate([winner] + d["runnersUp"], start=1):
        cells = "  ".join(
            str(row["columns"][name]).rjust(len(h))
            for name, h in zip(EXPLAIN_COLUMNS, _HEADERS))
        lines.append(f"  {rank}  " + row["node"].ljust(width)
                     + f"  {str(row['total']).rjust(5)}  " + cells)
    return "\n".join(lines)


def _explain_current(scheduler, pod, uid: str, k: int) -> dict:
    """Decompose against the live post-commit state, the pod's own
    resources removed from its bound node."""
    from ..framework.types import PodInfo
    from ..ops.groups import to_device
    from ..state.convert import pod_table_from_numpy
    scheduler._drain_pending()
    scheduler.cache.update_snapshot(scheduler.snapshot)
    scheduler.state.apply_snapshot(scheduler.snapshot)
    scheduler.state.ensure_arrays()
    ent = scheduler.builder._lookup(pod)
    if ent[0] != "row":
        return {"pod": uid, "error": "pod signature has no tensor form "
                                     "(host-fallback pod); explain "
                                     "unavailable"}
    tidx = ent[2]
    builder = scheduler.builder
    device = scheduler.device
    na = scheduler.diagnosis_arrays()
    table = pod_table_from_numpy(builder.table, device)
    gd = fam = gcarry = None
    groups_needed = (
        builder.groups.any_groups()
        or bool(scheduler.snapshot.have_pods_with_affinity_list)
        or bool(scheduler.snapshot
                .have_pods_with_required_anti_affinity_list))
    if groups_needed:
        gd_np, gc_np = builder.groups.build_dev(scheduler.snapshot)
        gd, gcarry = to_device(gd_np, device), to_device(gc_np, device)
        fam = builder.groups.families(scheduler.snapshot)
    carry = initial_carry(na, gcarry)
    bound = pod.spec.node_name or None
    self_excluded = False
    if bound:
        b = scheduler.state.node_index.get(bound)
        if b is not None:
            # the carry holds fresh copies (initial_carry), so the pod's
            # own resources come out of its bound row in place
            pi = PodInfo.of(pod)
            req = scheduler.state.rtable.vector(pi.requests)
            vec = np.zeros((int(carry.used.shape[1]),), np.int64)
            vec[:len(req)] = req
            carry.used[b] -= torch.from_numpy(vec).to(device)
            carry.nonzero_used[b] -= torch.tensor(
                [pi.cpu_nonzero, pi.mem_nonzero], dtype=torch.int64,
                device=device)
            carry.npods[b] -= 1
            self_excluded = True
    cfg = scheduler.profiles[pod.spec.scheduler_name].score_config \
        if pod.spec.scheduler_name in scheduler.profiles \
        else next(iter(scheduler.profiles.values())).score_config
    idx, totals, cols, n_feas = explain_row(cfg, na, carry, table, tidx,
                                            k=k, gd=gd, fam=fam)
    names = scheduler.state.node_names
    return _assemble(uid, "current_state", names, idx.cpu(), totals.cpu(),
                     cols.cpu(), int(n_feas), bound,
                     {"selfExcluded": {"resources": self_excluded,
                                       "groups": False, "ports": False}},
                     k)


def explain_pod(scheduler, uid: str, k: int = 5) -> dict:
    """The /debug/explain entry: the current-state decomposition of pod
    `uid` (namespace/name), its top min(max(k, 1), 16) nodes."""
    k = max(1, min(int(k), 16))
    pod = None
    ps = scheduler.cache.pod_states.get(uid)
    if ps is not None:
        pod = ps.pod
    if pod is None:
        pod = getattr(scheduler.client, "pods", {}).get(uid)
    if pod is None:
        return {"pod": uid, "error": "pod not found"}
    return _explain_current(scheduler, pod, uid, k)
