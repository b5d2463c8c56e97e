"""Preemption Evaluator: the PostFilter path.

Counterpart of kubernetes_tpu/framework/preemption.py (which mirrors
pkg/scheduler/framework/preemption/preemption.go):
- `Evaluator.preempt` (:268) — eligibility → candidates → pick; the
  plugin (plugins/defaultpreemption.py) then prepares the candidate.
- `pod_eligible_to_preempt_others` (:431) — preemptionPolicy Never, and
  the nominated-node "victim already terminating" check (a DELETE still
  queued in the dispatcher).
- `dry_run_preemption` (:775) — the batched device dry run
  (ops/program.py dry_run_select_victims, one launch over every candidate
  node) for the cases it represents exactly, the host loop of
  `select_victims_on_node` (default_preemption.go:583) for the rest: a
  preemptor with pod (anti-)affinity, a cluster with required
  anti-affinity pods, a pod without a signature row (or with host
  ports), a node with more than MAX_BATCHED_VICTIMS victims, a resource
  outside the staging table, or a nomination that would add anti vetoes
  or move the preemptor's spread counts. That routing is the JAX
  package's own; `batched_dry_runs` / `host_dry_runs` count it. There is
  no fallback between the two: a failed build or launch raises.
- `pick_one_node` (:658) — the five-step order, step 1 fed by the
  PDB-violating victim partition; victim start times map to
  `creation_index`.

On the node-sharded mesh (`DeviceDryRunContext.mesh`) the batched dry
run gathers the candidate rows out of the host staging arrays into one
block on the mesh's first device and runs the same kernel on that block
(it is row-local over the candidates), as the JAX package does; the
resident shards and their dirty-row tracking are never touched.

The candidate count follows default_preemption.go:174 with a
deterministic offset of 0, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from ..api.types import Pod
from .interface import Code, CycleState, Status
from .types import Diagnosis, NodeInfo, PodInfo

# DefaultPreemptionArgs' minCandidateNodesPercentage and
# minCandidateNodesAbsolute, at their defaults
MIN_CANDIDATE_NODES_PERCENTAGE = 10
MIN_CANDIDATE_NODES_ABSOLUTE = 100


@dataclass
class Candidate:
    """preemption.go:60 candidate: victims + the node."""

    node_name: str
    victims: list[PodInfo] = field(default_factory=list)
    num_pdb_violations: int = 0


@dataclass
class DeviceDryRunContext:
    """Live handles for the batched device dry run, wired by the
    Scheduler: `state` is the tensorized ClusterState (its device is the
    dry run's), `builder` the pod signature BatchBuilder, `snapshot` the
    host Snapshot the candidates come from."""

    state: object
    builder: object
    snapshot: object
    # parallel/sharding.py Mesh when the scheduler runs node-sharded
    mesh: object = None


@dataclass
class _DryRunPlan:
    """Per-(preemptor signature, cluster state) tensors of the batched dry
    run. A preemptor wave (many same-priority pods failing against the
    same snapshot) reuses one plan: only the nominated-pod overlay changes
    between preemptors, so the wave costs one tensor build and one
    full-candidate launch, then one small launch per preemptor over the
    candidate rows its overlay touches."""

    key: tuple
    # per candidate, in `nodes` order:
    #   (node_info, victims-in-reprieve-order, violating-prefix-length)
    cands: list
    cand_idx: object          # i32 [Cp] node-row indices (device)
    cand_pos: dict            # node name → candidate position
    victim_req: object        # i64 [Cp, Vp, R] (device)
    victim_valid: object      # bool [Cp, Vp] (device)
    spread: object            # groups.DryRunSpread (device) | None
    constraints: list         # spread DoNotSchedule constraints (host)
    prow: object = None       # the preemptor's PodRow (device)
    # overlay-free results for every candidate (numpy bool [Cp, Vp+1]),
    # computed once per plan
    base_packed: object = None
    # mesh only: the candidate rows gathered from the staging arrays into
    # one NodeArrays[Cp] block on the mesh's first device; cand_idx then
    # holds positions into this block, not node rows
    cand_na: object = None


class Evaluator:
    """preemption.go:100 — drives one preemption attempt for one pod."""

    # victim-axis cap of the batched path: a node with more potential
    # victims takes the host loop
    MAX_BATCHED_VICTIMS = 128

    def __init__(self, framework, nominator,
                 is_delete_pending: Callable[[str], bool],
                 pdb_lister: Callable[[], list],
                 device_ctx: DeviceDryRunContext):
        self.fwk = framework
        self.nominator = nominator
        self._is_delete_pending = is_delete_pending
        # () → [PodDisruptionBudget] with fresh disruptionsAllowed
        self.pdb_lister = pdb_lister
        self.device_ctx = device_ctx
        self._plan_cache: Optional[_DryRunPlan] = None
        self.batched_dry_runs = 0
        self.host_dry_runs = 0

    # -- entry (preemption.go:268 Preempt) ------------------------------------

    def preempt(self, state: CycleState, pod: Pod,
                nodes: list[NodeInfo], diagnosis: Diagnosis
                ) -> tuple[Optional[Candidate], Status]:
        if not self.pod_eligible_to_preempt_others(pod, nodes):
            return None, Status.unschedulable(
                "pod is not eligible for preemption",
                plugin="DefaultPreemption")
        potential = self.nodes_where_preemption_might_help(nodes, diagnosis)
        if not potential:
            return None, Status.unschedulable(
                "preemption will not help scheduling",
                plugin="DefaultPreemption")
        num = self.get_num_candidates(len(potential))
        candidates = self.dry_run_preemption(state, pod, potential, num,
                                             all_nodes=nodes)
        if not candidates:
            return None, Status.unschedulable(
                "no preemption victims found for incoming pod",
                plugin="DefaultPreemption")
        candidates = self.call_extenders(pod, candidates)
        best = self.pick_one_node(candidates)
        return best, Status.success()

    @staticmethod
    def call_extenders(pod: Pod,
                       candidates: list[Candidate]) -> list[Candidate]:
        """preemption.go:316 callExtenders. The port has no extenders
        (the Scheduler refuses them), so every candidate passes."""
        return candidates

    # -- eligibility (preemption.go:431) ---------------------------------------

    def pod_eligible_to_preempt_others(self, pod: Pod,
                                       nodes: list[NodeInfo]) -> bool:
        if pod.spec.preemption_policy == "Never":
            return False
        nominated = pod.status.nominated_node_name
        if nominated:
            # a lower-priority victim already terminating on the nominated
            # node means preemption is in flight — don't preempt again
            ni = next((n for n in nodes if n.name == nominated), None)
            if ni is not None:
                for pi in ni.pods:
                    if (pi.pod.spec.priority < pod.spec.priority
                            and self._is_delete_pending(pi.pod.uid)):
                        return False
        return True

    # -- candidate universe (preemption.go:291) --------------------------------

    @staticmethod
    def nodes_where_preemption_might_help(nodes: list[NodeInfo],
                                          diagnosis: Diagnosis
                                          ) -> list[NodeInfo]:
        """Nodes that failed resolvably; a node absent from node_to_status
        is assumed resolvable."""
        out = []
        for ni in nodes:
            st = diagnosis.node_to_status.get(ni.name)
            if st is not None and st.code == Code.UNSCHEDULABLE_AND_UNRESOLVABLE:
                continue
            out.append(ni)
        return out

    @staticmethod
    def get_num_candidates(num_nodes: int) -> int:
        """default_preemption.go:174 GetOffsetAndNumCandidates."""
        n = num_nodes * MIN_CANDIDATE_NODES_PERCENTAGE // 100
        n = max(n, MIN_CANDIDATE_NODES_ABSOLUTE)
        return min(n, num_nodes)

    # -- dry run (preemption.go:775) -------------------------------------------

    def dry_run_preemption(self, state: CycleState, pod: Pod,
                           nodes: list[NodeInfo], num_candidates: int,
                           all_nodes: Optional[list[NodeInfo]] = None
                           ) -> list[Candidate]:
        """`nodes` are the preemption candidates, `all_nodes` the FULL
        snapshot list (PreFilter state is seeded over every node, like a
        real scheduling cycle). The batched device dry run takes every
        case it represents exactly; the host loop, with PreFilter seeded
        once and cloned per candidate, takes the rest."""
        pdbs = self.pdb_lister()
        all_nodes = all_nodes or nodes
        batched = self._dry_run_batched(pod, nodes, num_candidates,
                                        all_nodes, pdbs)
        if batched is not None:
            self.batched_dry_runs += 1
            return batched
        return self._dry_run_host(pod, nodes, num_candidates, all_nodes,
                                  pdbs)

    def _dry_run_host(self, pod: Pod, nodes: list[NodeInfo],
                      num_candidates: int, all_nodes: list[NodeInfo],
                      pdbs: list) -> list[Candidate]:
        """The host loop: PreFilter seeded once over `all_nodes` and
        cloned per candidate, then `select_victims_on_node`."""
        self.host_dry_runs += 1
        seeded = CycleState()
        _, status = self.fwk.run_pre_filter_plugins(seeded, pod, all_nodes)
        if not status.is_success():
            return []
        candidates: list[Candidate] = []
        for ni in nodes:
            victims, pdb_violations, ok = self.select_victims_on_node(
                pod, ni, all_nodes=all_nodes, pdbs=pdbs,
                seeded_state=seeded)
            if ok:
                candidates.append(Candidate(
                    node_name=ni.name, victims=victims,
                    num_pdb_violations=pdb_violations))
                if len(candidates) >= num_candidates:
                    break
        return candidates

    # -- batched device dry run ------------------------------------------------

    def _dry_run_batched(self, pod: Pod, nodes: list[NodeInfo],
                         num_candidates: int, all_nodes: list[NodeInfo],
                         pdbs: list) -> Optional[list[Candidate]]:
        """One launch instead of |candidates| host filter sweeps. Returns
        the candidate list, or None when the case has no tensor form (the
        host loop takes it):

        - preemptor: no host ports (sig 0), no pod (anti-)affinity, a
          signature row; DoNotSchedule spread constraints ARE handled
          (ops/groups.py spread_dry_run_tensors);
        - cluster: no existing pods with required anti-affinity (their
          removal could lift a veto the kernel does not model);
        - nominations: ≥-priority nominated pods become a fit-only
          resource overlay; one that would move the preemptor's spread
          counts or add anti-affinity vetoes goes to the host loop."""
        ctx = self.device_ctx
        aff = pod.spec.affinity
        if aff is not None and (aff.pod_affinity is not None
                                or aff.pod_anti_affinity is not None):
            return None
        snapshot = ctx.snapshot
        if snapshot.have_pods_with_required_anti_affinity_list:
            return None
        ent = ctx.builder._lookup(pod)
        if ent[0] != "row" or ent[1] == 0:
            return None
        u = ent[2]
        # staging rows must mirror the snapshot the candidates came from
        ctx.state.apply_snapshot(snapshot)
        arrays = ctx.state.ensure_arrays()
        R = arrays.used.shape[1]
        plan = self._dry_run_plan(pod, nodes, all_nodes, pdbs, u, R, ctx)
        if plan is None:
            return None
        if not plan.cands:
            return []
        ovl = self._dry_run_overlay(pod, plan, ctx)
        if ovl is None:
            return None
        overrides = self._dry_run_overrides(plan, ovl, R, ctx)
        base = plan.base_packed
        out: list[Candidate] = []
        for c, (ni, ordered, nviol) in enumerate(plan.cands):
            row = overrides.get(c)
            if row is None:
                row = base[c]
            if not row[0]:
                continue
            victims = [pi for v, pi in enumerate(ordered)
                       if not row[1 + v]]
            violations = sum(1 for v in range(nviol) if not row[1 + v])
            out.append(Candidate(node_name=ni.name, victims=victims,
                                 num_pdb_violations=violations))
            if len(out) >= num_candidates:
                break
        return out

    def _dry_run_overrides(self, plan: _DryRunPlan, ovl: dict, R: int,
                           ctx) -> dict:
        """Re-evaluate ONLY the overlay-touched candidate rows: gather
        their slices of the device-resident plan tensors and launch over
        the small subset, padded to a power of two by repeating its first
        row (the padded outputs are ignored). Returns {cand_pos: packed
        row}."""
        if not ovl:
            return {}
        from ..ops.program import dry_run_select_victims
        from ..state.tensorize import pow2_at_least

        dev = plan.victim_req.device
        sub = np.fromiter(ovl.keys(), np.int64, count=len(ovl))
        s = len(sub)
        s_pad = pow2_at_least(s)
        sub_pad = np.zeros((s_pad,), np.int64)
        sub_pad[:s] = sub
        ovl_used = np.zeros((s_pad, R), np.int64)
        ovl_npods = np.zeros((s_pad,), np.int32)
        for i, c in enumerate(sub):
            vec, cnt = ovl[int(c)]
            ovl_used[i] = vec
            ovl_npods[i] = cnt
        sub_t = torch.from_numpy(sub_pad).to(dev)
        spread = plan.spread
        if spread is not None:
            spread = spread._replace(
                tv_ok=spread.tv_ok[sub_t], cnt0=spread.cnt0[sub_t],
                other_min=spread.other_min[sub_t],
                vic_match=spread.vic_match[sub_t])
        packed = dry_run_select_victims(
            self._dry_run_rows(plan, ctx), plan.prow, plan.cand_idx[sub_t],
            plan.victim_req[sub_t], plan.victim_valid[sub_t],
            torch.from_numpy(ovl_used).to(dev),
            torch.from_numpy(ovl_npods).to(dev), spread).cpu().numpy()
        return {int(c): packed[i] for i, c in enumerate(sub)}

    def _dry_run_plan(self, pod: Pod, nodes: list[NodeInfo],
                      all_nodes: list[NodeInfo], pdbs: list, u: int,
                      R: int, ctx) -> Optional[_DryRunPlan]:
        """Build (or reuse) the wave plan: candidate rows, victim request
        tensors in reprieve order, PDB partition, spread delta tensors,
        and the overlay-free result of every candidate."""
        from ..state.tensorize import pow2_at_least

        prio = pod.spec.priority
        # snapshot generations cover node content, NodeInfo identities the
        # resolvable-subset membership
        key = (u, prio, R,
               tuple((p.uid, p.disruptions_allowed) for p in pdbs),
               id(ctx.snapshot), ctx.snapshot.generation,
               ctx.snapshot.tree_generation, hash(tuple(map(id, nodes))))
        cached = self._plan_cache
        if cached is not None and cached.key == key:
            return cached
        # one PreFilter over ALL nodes, run once per wave
        cs = CycleState()
        _, status = self.fwk.run_pre_filter_plugins(cs, pod, all_nodes)
        if not status.is_success():
            plan = _DryRunPlan(key=key, cands=[], cand_idx=None,
                               cand_pos={}, victim_req=None,
                               victim_valid=None, spread=None,
                               constraints=[])
            self._plan_cache = plan
            return plan
        from ..plugins import podtopologyspread as pts_mod
        spread_state = cs.read_or_none(pts_mod._PRE_FILTER_KEY)
        constraints = list(spread_state.constraints) if spread_state else []

        def key_fn(pi):
            return (-pi.pod.spec.priority, pi.pod.metadata.creation_index)

        cands = []
        idxs = []
        vmax = 0
        for ni in nodes:
            potential = [pi for pi in ni.pods
                         if pi.pod.spec.priority < prio]
            if not potential:
                continue
            idx = ctx.state.node_index.get(ni.name)
            if idx is None:
                return None   # staging out of sync: host loop
            violating, non_violating = self._filter_pods_with_pdb_violation(
                potential, pdbs)
            ordered = (sorted(violating, key=key_fn)
                       + sorted(non_violating, key=key_fn))
            cands.append((ni, ordered, len(violating)))
            idxs.append(idx)
            vmax = max(vmax, len(ordered))
        if not cands:
            plan = _DryRunPlan(key=key, cands=[], cand_idx=None,
                               cand_pos={}, victim_req=None,
                               victim_valid=None, spread=None,
                               constraints=constraints)
            self._plan_cache = plan
            return plan
        if vmax > self.MAX_BATCHED_VICTIMS:
            return None
        c_pad = pow2_at_least(len(cands))
        v_pad = pow2_at_least(vmax)
        cand_idx = np.zeros((c_pad,), np.int32)
        cand_idx[:len(idxs)] = idxs
        victim_req = np.zeros((c_pad, v_pad, R), np.int64)
        victim_valid = np.zeros((c_pad, v_pad), bool)
        for c, (_ni, ordered, _nv) in enumerate(cands):
            for v, pi in enumerate(ordered):
                vec = ctx.state.request_vector(pi.requests)
                if vec is None:
                    return None   # resource outside the staging table
                victim_req[c, v] = vec
                victim_valid[c, v] = True
        spread = None
        if constraints:
            from ..ops.groups import spread_dry_run_tensors
            spread = spread_dry_run_tensors(
                spread_state, pod, [c[0] for c in cands],
                [c[1] for c in cands], c_pad, v_pad)
        # ship the wave-constant tensors to the device ONCE and run the
        # full-candidate launch overlay-free: every preemptor of the wave
        # then pays only the small overlay-subset launch
        from ..ops.program import dry_run_select_victims, pod_row_from_table
        dev = torch.device(ctx.state.device)

        def up(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

        cand_na = None
        if ctx.mesh is not None:
            from ..state.convert import node_arrays_from_numpy
            a = ctx.state.ensure_arrays()
            cand_na = node_arrays_from_numpy(
                type(a)(*(x[cand_idx] for x in a)), dev)
            cand_idx = np.arange(c_pad, dtype=np.int32)
        plan = _DryRunPlan(
            key=key, cands=cands, cand_idx=up(cand_idx),
            cand_pos={ni.name: c for c, (ni, _o, _n) in enumerate(cands)},
            victim_req=up(victim_req), victim_valid=up(victim_valid),
            spread=(None if spread is None
                    else type(spread)(*(up(x) for x in spread))),
            constraints=constraints,
            prow=pod_row_from_table(ctx.builder.table, u, dev),
            cand_na=cand_na)
        plan.base_packed = dry_run_select_victims(
            self._dry_run_rows(plan, ctx), plan.prow, plan.cand_idx,
            plan.victim_req, plan.victim_valid,
            torch.zeros((c_pad, R), dtype=torch.int64, device=dev),
            torch.zeros((c_pad,), dtype=torch.int32, device=dev),
            plan.spread).cpu().numpy()
        self._plan_cache = plan
        return plan

    @staticmethod
    def _dry_run_rows(plan: _DryRunPlan, ctx):
        """The node rows the dry run reads: the resident device copy, or
        on the mesh the plan's gathered candidate block."""
        return (plan.cand_na if plan.cand_na is not None
                else ctx.state.device_arrays())

    def _dry_run_overlay(self, pod: Pod, plan: _DryRunPlan, ctx):
        """Nominated-pod overlay of the with-nominated filter pass
        (runtime/framework.go:1158): ≥-priority nominations (self
        excluded) fold their resources into the candidate rows. Returns a
        SPARSE {cand_pos: [summed request vec, count]} map, or None when a
        nomination has effects the overlay cannot represent."""
        out: dict = {}
        nom = self.nominator
        if nom is None or not nom.nominated_pods:
            return out
        for node_name, qlist in nom.nominated_per_node.items():
            for q in qlist:
                qpod = q.pod
                if qpod.uid == pod.uid or qpod.spec.priority < pod.spec.priority:
                    continue
                qaff = qpod.spec.affinity
                if (qaff is not None and qaff.pod_anti_affinity is not None
                        and qaff.pod_anti_affinity.required):
                    return None   # would add existing-anti vetoes
                if (plan.spread is not None
                        and qpod.namespace == pod.namespace
                        and any(c.selector.matches(qpod.metadata.labels)
                                for c in plan.constraints)):
                    return None   # would move the preemptor's spread counts
                c = plan.cand_pos.get(node_name)
                if c is None:
                    continue
                vec = ctx.state.request_vector(q.pod_info.requests)
                if vec is None:
                    return None
                cur = out.get(c)
                if cur is None:
                    out[c] = [vec, 1]   # request_vector returns a fresh row
                else:
                    cur[0] += vec
                    cur[1] += 1
        return out

    def select_victims_on_node(self, pod: Pod, node_info: NodeInfo,
                               all_nodes: list[NodeInfo],
                               pdbs: Optional[list] = None,
                               seeded_state: Optional[CycleState] = None
                               ) -> tuple[list[PodInfo], int, bool]:
        """default_preemption.go:583 → (victims, pdbViolations, fits). The
        simulation runs on a structural copy of the NodeInfo and a CLONE
        of the seeded CycleState; nodes with nothing to preempt cost no
        PreFilter work."""
        potential = [pi for pi in node_info.pods
                     if pi.pod.spec.priority < pod.spec.priority]
        if not potential:
            return [], 0, False
        ni = node_info.snapshot_clone()
        if seeded_state is not None:
            state = seeded_state.clone()
        else:
            state = CycleState()
            _, status = self.fwk.run_pre_filter_plugins(state, pod, all_nodes)
            if not status.is_success():
                return [], 0, False
        for pi in potential:
            self._remove_pod(state, pod, pi, ni)
        # the preemptor must fit with ALL lower-priority pods gone
        if not self._fits(state, pod, ni):
            return [], 0, False
        # reprieve most-important-first while the preemptor still fits,
        # PDB-violating pods first (default_preemption.go:640)
        violating, non_violating = self._filter_pods_with_pdb_violation(
            potential, pdbs or [])

        def key(pi):
            return (-pi.pod.spec.priority, pi.pod.metadata.creation_index)

        victims: list[PodInfo] = []
        num_violating = 0
        for group, counts in ((sorted(violating, key=key), True),
                              (sorted(non_violating, key=key), False)):
            for pi in group:
                self._add_pod(state, pod, pi, ni)
                if not self._fits(state, pod, ni):
                    self._remove_pod(state, pod, pi, ni)
                    victims.append(pi)
                    if counts:
                        num_violating += 1
        return victims, num_violating, True

    @staticmethod
    def _filter_pods_with_pdb_violation(pods: list[PodInfo], pdbs: list
                                        ) -> tuple[list[PodInfo], list[PodInfo]]:
        """preemption.go filterPodsWithPDBViolation: a pod is 'violating'
        if evicting it would push some matching PDB past its
        disruptionsAllowed budget. EVERY matching PDB's budget is
        decremented for EVERY pod, violating ones included."""
        if not pdbs:
            return [], list(pods)
        remaining = {id(pdb): pdb.disruptions_allowed for pdb in pdbs}
        violating: list[PodInfo] = []
        non_violating: list[PodInfo] = []
        for pi in pods:
            violates = False
            for pdb in pdbs:
                if not pdb.matches(pi.pod):
                    continue
                remaining[id(pdb)] -= 1
                if remaining[id(pdb)] < 0:
                    violates = True
            (violating if violates else non_violating).append(pi)
        return violating, non_violating

    def _fits(self, state: CycleState, pod: Pod, ni: NodeInfo) -> bool:
        status = self.fwk.run_filter_plugins_with_nominated_pods(
            state, pod, ni, self.nominator)
        return status.is_success()

    def _remove_pod(self, state: CycleState, pod: Pod, pi: PodInfo,
                    ni: NodeInfo) -> None:
        ni.remove_pod(pi)
        self.fwk.run_pre_filter_extensions_remove_pod(state, pod, pi, ni)

    def _add_pod(self, state: CycleState, pod: Pod, pi: PodInfo,
                 ni: NodeInfo) -> None:
        ni.add_pod(pi)
        self.fwk.run_pre_filter_extensions_add_pod(state, pod, pi, ni)

    # -- pick (preemption.go:658 pickOneNodeForPreemption) ---------------------

    @staticmethod
    def pick_one_node(candidates: list[Candidate]) -> Candidate:
        best = candidates
        # 1. fewest PDB violations
        m = min(c.num_pdb_violations for c in best)
        best = [c for c in best if c.num_pdb_violations == m]
        if len(best) == 1:
            return best[0]
        # a node with no victims at all wins outright (preemption.go:672)
        for c in best:
            if not c.victims:
                return c
        # 2. lowest highest-victim priority
        m = min(max(pi.pod.spec.priority for pi in c.victims) for c in best)
        best = [c for c in best
                if max(pi.pod.spec.priority for pi in c.victims) == m]
        if len(best) == 1:
            return best[0]
        # 3. smallest sum of victim priorities
        m = min(sum(pi.pod.spec.priority for pi in c.victims) for c in best)
        best = [c for c in best
                if sum(pi.pod.spec.priority for pi in c.victims) == m]
        if len(best) == 1:
            return best[0]
        # 4. fewest victims
        m = min(len(c.victims) for c in best)
        best = [c for c in best if len(c.victims) == m]
        if len(best) == 1:
            return best[0]
        # 5. latest start time of the highest-priority victim
        def top_victim_start(c: Candidate) -> int:
            top = max(c.victims, key=lambda pi: (pi.pod.spec.priority,
                                                 -pi.pod.metadata.creation_index))
            return top.pod.metadata.creation_index
        m = max(top_victim_start(c) for c in best)
        best = [c for c in best if top_victim_start(c) == m]
        return best[0]
