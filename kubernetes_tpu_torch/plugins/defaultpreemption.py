"""DefaultPreemption: the PostFilter plugin.

Counterpart of kubernetes_tpu/plugins/defaultpreemption.py (which mirrors
pkg/scheduler/framework/plugins/defaultpreemption/default_preemption.go):
- `post_filter` (:107) delegates to the preemption Evaluator
  (framework/preemption.py) and returns the nominated node name;
- `_prepare` is the reference's Evaluator.prepareCandidate
  (preemption.go:180): victims go to the API dispatcher as DELETE calls,
  and lower-priority pods nominated on the chosen node lose their
  nomination (preemption.go:210).

The Scheduler hands the plugin its framework and live handles
(dispatcher, nominator, snapshot, PDB lister, the device dry-run context)
through `wire`, which builds the Evaluator."""

from __future__ import annotations

from typing import Optional

from ..api.types import Pod
from ..framework.interface import CycleState, Status
from ..framework.preemption import DeviceDryRunContext, Evaluator
from ..framework.types import Diagnosis


class DefaultPreemption:
    def __init__(self):
        self.dispatcher = self.nominator = self.snapshot = None
        self._evaluator: Optional[Evaluator] = None

    def name(self) -> str:
        return "DefaultPreemption"

    def wire(self, fwk, dispatcher, nominator, snapshot, pdb_lister,
             device_ctx: DeviceDryRunContext) -> None:
        """Called by the Scheduler after the Framework exists (the
        Evaluator needs the full plugin set for its dry-run filters)."""
        self.dispatcher = dispatcher
        self.nominator = nominator
        self.snapshot = snapshot
        self._evaluator = Evaluator(
            fwk, nominator, dispatcher.is_delete_pending, pdb_lister,
            device_ctx)

    def post_filter(self, state: CycleState, pod: Pod,
                    filtered_node_status_map) -> tuple[Optional[str], Status]:
        """default_preemption.go:107 → (nominated node name, status)."""
        diagnosis = Diagnosis(node_to_status=dict(filtered_node_status_map))
        nodes = self.snapshot.node_info_list
        candidate, status = self._evaluator.preempt(state, pod, nodes,
                                                    diagnosis)
        if not status.is_success() or candidate is None:
            return None, status
        self._prepare(pod, candidate)
        return candidate.node_name, Status.success()

    def _prepare(self, pod: Pod, candidate) -> None:
        """preemption.go:180 prepareCandidate: delete victims, demote
        lower-priority nominations on the node."""
        from ..backend.dispatcher import APICall, CallType
        for pi in candidate.victims:
            self.dispatcher.add(APICall(CallType.DELETE, pi.pod))
        for q in self.nominator.pods_for_node(candidate.node_name):
            if q.pod.spec.priority < pod.spec.priority:
                self.nominator.delete(q.pod)
                # clear the live object too: Nominator.add falls back to
                # pod.status.nominated_node_name on requeue and must not
                # resurrect the demoted nomination
                q.pod.status.nominated_node_name = ""
                self.dispatcher.add(APICall(
                    CallType.STATUS_PATCH, q.pod,
                    condition={}, nominated_node_name=""))
