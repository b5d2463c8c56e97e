"""Pod-batch tensorization: compile a queue drain into device tensors.

KEP-5598 taken to its limit (reference runtime/batch.go + signers.go): pods
are interned by SIGNATURE — the canonical tuple of everything the device
kernels can see (requests, nodeName, tolerations, selectors, affinity,
ports). Each distinct signature fills ONE row of a compact PodTable; a drain
of B pods ships only `(valid[B], sig[B], tidx[B])` plus whatever table rows
are new. The scan gathers the row per step, and its signature cache makes
consecutive same-signature pods skip the heavy kernels entirely.

This matters twice over:
- host: `_fill_row`'s selector compilation runs once per signature, not per
  pod (a homogeneous 10k-pod benchmark fills exactly one row);
- transfer: the per-batch upload is O(unique signatures), not O(B·row-width),
  which is what keeps large drains from being PCIe/tunnel-bound.

Arbitrary label selectors compile to padded (term × requirement × value) id
tables evaluated against the node label arrays on device (SURVEY §7
hard-part 6). Pods whose constraints exceed the padding (or use semantics
with no tensor form yet) get `host_fallback=True`; the PyTorch port has no
host scheduling path, so its scheduler refuses such pods with the reason
`fallback_reason` gives. Topology spread and inter-pod affinity rows are
parsed by `groups` (ops/groups.py GroupManager), row for row with the
PodTable.

Selector op encoding (0 = padding → vacuously true):
  1=In  2=NotIn  3=Exists  4=DoesNotExist  5=Gt  6=Lt
Toleration op: 1=Equal 2=Exists.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np

from ..api import resources as res
from ..api.types import NodeSelectorTerm, Pod, SelectorOperator
from ..state.tensorize import _EFFECTS, ClusterState, pow2_at_least
from ..plugins.node_basics import NodeUnschedulable

OP_IN = 1
OP_NOT_IN = 2
OP_EXISTS = 3
OP_DOES_NOT_EXIST = 4
OP_GT = 5
OP_LT = 6

_SEL_OPS = {
    SelectorOperator.IN.value: OP_IN,
    SelectorOperator.NOT_IN.value: OP_NOT_IN,
    SelectorOperator.EXISTS.value: OP_EXISTS,
    SelectorOperator.DOES_NOT_EXIST.value: OP_DOES_NOT_EXIST,
    SelectorOperator.GT.value: OP_GT,
    SelectorOperator.LT.value: OP_LT,
}

TOL_EQUAL = 1
TOL_EXISTS = 2


@dataclass
class BatchDims:
    table_rows: int = 16   # U — distinct signatures (grows by doubling)
    # growth cap: reaching this many used rows triggers a between-builds
    # reset (compaction) instead of further doubling
    max_table_rows: int = 4096
    images_per_pod: int = 8  # IC — container images per pod
    sel_terms: int = 4     # T — required node affinity terms
    sel_reqs: int = 6      # Q — requirements per term (incl. nodeSelector merge)
    sel_vals: int = 8      # V — values per requirement
    pref_terms: int = 4    # PT — preferred node affinity terms
    tolerations: int = 8   # TT
    ports: int = 8         # P


class PodTable(NamedTuple):
    """One row per distinct pod signature ([U, ...])."""

    req: object              # i64 [U, R]
    nonzero_req: object      # i64 [U, 2]
    node_name_id: object     # i32 [U] (0 = unset)
    tol_key: object          # i32 [U, TT]
    tol_val: object          # i32 [U, TT]
    tol_eff: object          # i32 [U, TT] (0 = all effects)
    tol_op: object           # i32 [U, TT] (0 = padding)
    tolerates_unsched: object  # bool [U]
    ns_sel_val: object       # i32 [U, Q] (kv id; 0 = padding)
    aff_has: object          # bool [U]
    aff_term_valid: object   # bool [U, T]
    aff_key: object          # i32 [U, T, Q]
    aff_op: object           # i32 [U, T, Q]
    aff_num: object          # i64 [U, T, Q]
    aff_val: object          # i32 [U, T, Q, V]
    pref_weight: object      # i64 [U, PT] (0 = unused term)
    pref_key: object         # i32 [U, PT, Q]
    pref_op: object          # i32 [U, PT, Q]
    pref_num: object         # i64 [U, PT, Q]
    pref_val: object         # i32 [U, PT, Q, V]
    port_ids: object         # i32 [U, P]
    skip_balanced: object    # bool [U]
    img_ids: object          # i32 [U, IC] — interned container images (0 = pad)
    img_containers: object   # i32 [U] — container count (score threshold)


class PodBatch(NamedTuple):
    valid: object            # bool [B]
    host_fallback: object    # bool [B] (numpy only; never shipped to device)
    sig: object              # i32 [B] — signature id (0 = fast path ineligible)
    tidx: object             # i32 [B] — row in the table
    table: PodTable          # shared builder table (numpy)
    table_version: int       # bumps when rows are added/table rebuilt


class BatchCapacityError(ValueError):
    pass


class BatchBuilder:
    def __init__(self, state: ClusterState, dims: Optional[BatchDims] = None,
                 spread_plugin=None, ipa_plugin=None, group_dims=None,
                 columnar: bool = True):
        from ..ops.groups import GroupManager
        self.state = state
        self.dims = dims or BatchDims()
        # the ColumnarIngest gate: `build` interns a drain's new
        # signatures in one chunk (ingest/columns.py) when True, one pod
        # at a time through `_lookup` (the serial oracle) when False
        self.columnar = columnar
        # bumped whenever existing rows are INVALIDATED (reset), as opposed
        # to appended; device-side consumers must reseed their group state
        # and signature caches when this moves
        self.reset_count = 0
        # signature key → ("row", sig_id, tidx) | ("fallback", reason)
        self._sig_cache: dict[tuple, tuple] = {}
        # identity fast path: pods stamped from a shared template (the
        # reference's typical controller-replica shape) share their spec and
        # label dict OBJECTS; (id(spec), id(labels), ns) then implies an
        # identical signature without recomputing the content key. Values
        # hold strong refs to the keyed objects so ids can't be recycled.
        # Relies on the object-model aliasing contract (api/types.py): specs
        # and label dicts are immutable once a pod is created.
        self._ident_cache: dict[tuple, tuple] = {}
        self._next_sig = 1
        self.table = _zero_table(self.dims.table_rows,
                                 state.dims.resources, self.dims)
        self.table_used = 0
        self.table_version = 0
        # columnar pod store, commit-side column (ingest/columns.py): one
        # CommitFacts per interned row, aligned with table_used — the
        # batched assume path reads facts by tidx instead of re-walking
        # the pod object graph per commit. REPLACED (not cleared) on
        # reset: in-flight drains hold the old list by reference.
        self.row_facts: list = []
        self.groups = GroupManager(state, spread_plugin=spread_plugin,
                                   ipa_plugin=ipa_plugin, dims=group_dims,
                                   table_rows=self.dims.table_rows)

    # -- table lifecycle ------------------------------------------------------

    def _reset_table(self) -> None:
        self.reset_count += 1
        self._sig_cache.clear()
        self._ident_cache.clear()
        self.table = _zero_table(self.dims.table_rows,
                                 self.state.dims.resources, self.dims)
        self.table_used = 0
        self.table_version += 1
        self.row_facts = []
        self.groups.reset()

    def _grow_table(self) -> None:
        self.dims.table_rows *= 2
        old = self.table
        self.table = _zero_table(self.dims.table_rows,
                                 self.state.dims.resources, self.dims)
        for name in PodTable._fields:
            getattr(self.table, name)[: self.table_used] = getattr(old, name)[
                : self.table_used]
        self.table_version += 1
        self.groups.grow(self.dims.table_rows)

    # -- build ---------------------------------------------------------------

    def build(self, pods: list[Pod], snapshot=None,
              pad_to: int = 0) -> PodBatch:
        # pad to the caller's standing batch size when given: residual drains
        # then reuse the same compiled program instead of minting a new
        # (smaller) shape bucket
        B = pow2_at_least(max(len(pods), pad_to))
        if self.table_used >= self.dims.max_table_rows:
            # compaction happens BETWEEN builds only (a mid-build reset
            # would zero rows this batch already references): drop every
            # row; the signatures still in use re-intern immediately, dead
            # ones don't come back. Row capacity stays at its high-water
            # bucket, so memory is bounded by MAX_TABLE_ROWS growth.
            self._reset_table()
        if self.table.req.shape[1] != self.state.dims.resources:
            self._reset_table()  # resource table grew: row widths changed
        valid = np.zeros((B,), bool)
        fallback = np.zeros((B,), bool)
        sig = np.zeros((B,), np.int32)
        tidx = np.zeros((B,), np.int32)
        last = -1
        if self.columnar:
            # Chunked interning (ingest/columns.py): ONE identity pass
            # groups the chunk's positions per table entry, new signatures
            # intern through the columnar row filler in first-appearance
            # order (the order mints sig ids — parity with the per-pod
            # path), and the per-pod scalar stores collapse to one
            # scatter per distinct entry
            groups: dict = {}
            misses: dict = {}        # content key → (ident, pod, placeholder)
            # ident → placeholder of a signature new in this chunk: the
            # pods stamped from one template after its first resolve
            # without recomputing the content key (the ident cache learns
            # them only once `_intern_misses` has interned the row)
            pending: dict = {}
            ident_cache = self._ident_cache
            for i, pod in enumerate(pods):
                ident = (id(pod.spec), id(pod.metadata.labels),
                         pod.metadata.namespace)
                hit = ident_cache.get(ident)
                if hit is not None:
                    ent = hit[2]
                else:
                    ent = pending.get(ident)
                    if ent is None:
                        ent = self._intern_key(pod, ident, misses)
                        if ent[0] == "miss":
                            pending[ident] = ent
                lst = groups.get(ent)
                if lst is None:
                    groups[ent] = [i]
                else:
                    lst.append(i)
            if misses:
                self._intern_misses(misses, groups)
            for ent, idxs in groups.items():
                if ent[0] == "fallback":
                    fallback[idxs] = True
                    continue
                valid[idxs] = True
                sig[idxs] = ent[1]
                tidx[idxs] = ent[2]
                if idxs[-1] > last:
                    last = idxs[-1]
        else:
            # the serial oracle: one `_lookup` a pod
            for i, pod in enumerate(pods):
                ent = self._lookup(pod)
                if ent[0] == "fallback":
                    fallback[i] = True
                    continue
                valid[i] = True
                sig[i] = ent[1]
                tidx[i] = ent[2]
                last = i
        if last >= 0 and len(pods) < B:
            # padding rows inherit the last real pod's signature: valid=False
            # keeps them unassigned while the scan's cached fast step makes
            # them near-free instead of running the full kernel set per row
            sig[len(pods):] = sig[last]
            tidx[len(pods):] = tidx[last]
        return PodBatch(valid=valid, host_fallback=fallback, sig=sig,
                        tidx=tidx, table=self.table,
                        table_version=self.table_version)

    def _intern_key(self, pod: Pod, ident: tuple, misses: dict) -> tuple:
        """Identity-miss path of the chunked build: resolve via the
        content key, deferring genuinely NEW signatures to the columnar
        chunk filler. Returns the entry when known, else a per-key
        placeholder entry that `_intern_misses` resolves in place.
        `misses` maps content key → (ident, pod, placeholder) in
        first-appearance order (dicts preserve insertion order)."""
        key = self._sig_key(pod)
        ent = self._sig_cache.get(key)
        if ent is None:
            pending = misses.get(key)
            if pending is not None:
                return pending[2]
            ent = ("miss", len(misses))
            misses[key] = (ident, pod, ent)
            return ent
        if len(self._ident_cache) < 65536:
            self._ident_cache[ident] = (pod.spec, pod.metadata.labels, ent)
        return ent

    def _intern_misses(self, misses: dict, groups: dict) -> None:
        """Resolve the chunk's new signatures through the columnar filler
        (ingest/columns.py fill_rows) and rewrite the placeholder group
        keys to the real entries."""
        from ..ingest.columns import fill_rows
        items = list(misses.items())
        ents = fill_rows(self, [pod for _key, (_i, pod, _e) in items])
        for (key, (ident, pod, placeholder)), ent in zip(items, ents):
            self._sig_cache[key] = ent
            if len(self._ident_cache) < 65536:
                self._ident_cache[ident] = (pod.spec, pod.metadata.labels,
                                            ent)
            idxs = groups.pop(placeholder)
            have = groups.get(ent)
            if have is None:
                groups[ent] = idxs
            else:
                # two content keys can map to one fallback entry; merge
                # the position lists preserving drain order
                have.extend(idxs)
                have.sort()

    def _lookup(self, pod: Pod) -> tuple:
        ident = (id(pod.spec), id(pod.metadata.labels),
                 pod.metadata.namespace)
        hit = self._ident_cache.get(ident)
        if hit is not None:
            return hit[2]
        key = self._sig_key(pod)
        ent = self._sig_cache.get(key)
        if ent is not None:
            if len(self._ident_cache) < 65536:
                self._ident_cache[ident] = (pod.spec, pod.metadata.labels,
                                            ent)
            return ent
        if self.table_used >= self.table.req.shape[0]:
            self._grow_table()
        u = self.table_used
        try:
            self._fill_row(self.table, u, pod)
            self.groups.add_row(u, pod)
        except BatchCapacityError as e:
            for name in PodTable._fields:
                getattr(self.table, name)[u] = 0
            ent = ("fallback", str(e))
        else:
            # host-port pods get signature 0: their feasibility depends on
            # the evolving port carry, which the cached fast step does not
            # refresh — they still share a table row
            sig_id = 0 if self.table.port_ids[u].any() else self._next_sig
            if sig_id:
                self._next_sig += 1
            self.table_used += 1
            self.table_version += 1
            from ..ingest.columns import commit_facts_for_row
            self.row_facts.append(commit_facts_for_row(pod))
            ent = ("row", sig_id, u)
        self._sig_cache[key] = ent
        if len(self._ident_cache) < 65536:
            self._ident_cache[ident] = (pod.spec, pod.metadata.labels, ent)
        return ent

    def peek(self, pod: Pod):
        """`_lookup`'s entry for `pod` when its signature is already
        interned, else None; interns nothing (the table does not move)."""
        hit = self._ident_cache.get((id(pod.spec), id(pod.metadata.labels),
                                     pod.metadata.namespace))
        if hit is not None:
            return hit[2]
        return self._sig_cache.get(self._sig_key(pod))

    # -- signature (signers.go analog, content-level) -------------------------

    @staticmethod
    def _sig_key(pod: Pod) -> tuple:
        """Canonical content key. Namespace + labels are part of it because
        spread/affinity matching is SYMMETRIC: a pod's labels determine how
        it feeds other pods' selectors (signers.go includes labels for the
        same reason).

        Cardinality caveat: per-pod-unique labels (statefulset pod-name,
        controller hashes) mint one row each, and every new row costs O(U)
        host selector matching plus a possible table doubling (carry
        reseed). A conditional key (labels only when groups are active) is
        NOT safe — rows persist across the groups on/off transition — so
        high-churn unique-label workloads should bound table growth
        instead; see PodTable growth handling."""
        spec = pod.spec
        aff = spec.affinity
        na = aff.node_affinity if aff else None
        return (
            pod.namespace,
            tuple(sorted(pod.metadata.labels.items())),
            tuple(sorted(res.pod_requests(pod).items())),
            res.pod_requests_nonzero(pod),
            spec.node_name,
            tuple((t.key, t.operator, t.value, t.effect)
                  for t in spec.tolerations),
            tuple(sorted(spec.node_selector.items())),
            _node_affinity_key(na),
            tuple(sorted((p.protocol or "TCP", p.host_port, p.host_ip)
                         for c in spec.containers for p in c.ports
                         if p.host_port > 0)),
            tuple(spec.topology_spread_constraints),
            (aff.pod_affinity, aff.pod_anti_affinity) if aff else None,
            tuple(c.image for c in (list(spec.init_containers)
                                    + list(spec.containers))),
            tuple((v.name, v.claim_name, v.csi_driver)
                  for v in spec.volumes),
            spec.required_node_features,
            spec.resource_claims,
        )

    # -- row compilation ------------------------------------------------------

    def fallback_reason(self, pod: Pod) -> str:
        """Why `pod` has no device row ("" when it has one)."""
        ent = self._lookup(pod)
        return ent[1] if ent[0] == "fallback" else ""

    def _fill_row(self, b: PodTable, i: int, pod: Pod) -> None:
        d = self.dims
        intr = self.state.interner
        aff = pod.spec.affinity
        if pod.spec.volumes:
            # the PVC/PV binding state machine is API-coupled (SURVEY §2.4
            # volumebinding): volume-bearing pods keep host semantics
            raise BatchCapacityError("pod has volumes")
        if pod.spec.required_node_features:
            raise BatchCapacityError("pod requires declared node features")
        if pod.spec.resource_claims:
            # DRA claims are an API-coupled allocation state machine
            # (plugins/dynamicresources.py): host path, like volumes
            raise BatchCapacityError("pod has resource claims")
        # resources
        reqs = res.pod_requests(pod)
        row = self.state.rtable.vector(reqs)
        if len(row) > b.req.shape[1]:
            raise BatchCapacityError("resource table grew past batch width")
        b.req[i, :len(row)] = row
        nz_cpu, nz_mem = res.pod_requests_nonzero(pod)
        b.nonzero_req[i, 0] = nz_cpu
        b.nonzero_req[i, 1] = nz_mem
        b.skip_balanced[i] = all(v == 0 for v in reqs.values())
        # nodeName
        if pod.spec.node_name:
            b.node_name_id[i] = self.state.node_id(pod.spec.node_name)
        # tolerations
        tols = pod.spec.tolerations
        if len(tols) > d.tolerations:
            raise BatchCapacityError("too many tolerations")
        for t, tol in enumerate(tols):
            b.tol_key[i, t] = intr.key.intern(tol.key) if tol.key else 0
            b.tol_val[i, t] = intr.kv.intern(f"tv:{tol.value}")
            b.tol_eff[i, t] = _EFFECTS.get(tol.effect, 0) if tol.effect else 0
            op = tol.operator or "Equal"
            b.tol_op[i, t] = TOL_EXISTS if op == "Exists" else TOL_EQUAL
        b.tolerates_unsched[i] = any(
            t.tolerates(NodeUnschedulable.TAINT) for t in tols)
        # nodeSelector → equality conjuncts
        sel = pod.spec.node_selector
        if len(sel) > d.sel_reqs:
            raise BatchCapacityError("nodeSelector too wide")
        for q, (k, v) in enumerate(sorted(sel.items())):
            b.ns_sel_val[i, q] = intr.label_kv(k, v)
        # required node affinity
        na = aff.node_affinity if aff else None
        if na and na.required is not None:
            terms = na.required.terms
            if len(terms) > d.sel_terms:
                raise BatchCapacityError("too many nodeAffinity terms")
            b.aff_has[i] = True
            for t, term in enumerate(terms):
                b.aff_term_valid[i, t] = True
                self._fill_term(term, b.aff_key[i, t], b.aff_op[i, t],
                                b.aff_num[i, t], b.aff_val[i, t])
        # preferred node affinity
        if na and na.preferred:
            prefs = na.preferred
            if len(prefs) > d.pref_terms:
                raise BatchCapacityError("too many preferred terms")
            for t, p in enumerate(prefs):
                if p.weight == 0:
                    continue
                b.pref_weight[i, t] = p.weight
                self._fill_term(p.preference, b.pref_key[i, t], b.pref_op[i, t],
                                b.pref_num[i, t], b.pref_val[i, t])
        # ports
        ports = [(p.protocol or "TCP", p.host_port, p.host_ip)
                 for c in pod.spec.containers for p in c.ports if p.host_port > 0]
        if any(ip not in ("", "0.0.0.0") for (_, _, ip) in ports):
            # host-IP-scoped ports keep reference semantics via host path
            raise BatchCapacityError("host-IP-scoped port")
        if len(ports) > d.ports:
            raise BatchCapacityError("too many host ports")
        for q, (proto, port, _ip) in enumerate(ports):
            b.port_ids[i, q] = intr.port_id(proto, port)
        # container images (ImageLocality device kernel; init containers
        # score too, image_locality.go:95)
        from ..plugins.imagelocality import normalized_image_name
        containers = (list(pod.spec.init_containers)
                      + list(pod.spec.containers))
        imgs = [normalized_image_name(c.image) for c in containers if c.image]
        if imgs and len(imgs) > d.images_per_pod:
            raise BatchCapacityError("too many container images")
        b.img_containers[i] = len(containers) if imgs else 0
        for q, img in enumerate(imgs):
            b.img_ids[i, q] = intr.image.intern(img)

    def _fill_term(self, term: NodeSelectorTerm, key_row, op_row, num_row, val_row) -> None:
        d = self.dims
        intr = self.state.interner
        reqs = list(term.match_expressions)
        # matchFields (metadata.name) compile to ordinary requirements against
        # the synthetic metadata.name label (tensorize.py)
        for f in term.match_fields:
            reqs.append(f)
        if len(reqs) > d.sel_reqs:
            raise BatchCapacityError("too many requirements in term")
        for q, r in enumerate(reqs):
            opc = _SEL_OPS.get(r.operator)
            if opc is None:
                raise BatchCapacityError(f"unsupported operator {r.operator}")
            if r.key == "metadata.name":
                key = intr.key.intern("metadata.name")
            else:
                key = intr.key.intern(r.key)
            key_row[q] = key
            op_row[q] = opc
            if opc in (OP_IN, OP_NOT_IN):
                if len(r.values) > d.sel_vals:
                    raise BatchCapacityError("too many values in requirement")
                for v, value in enumerate(r.values):
                    val_row[q, v] = intr.label_kv(r.key, value)
            elif opc in (OP_GT, OP_LT):
                if len(r.values) != 1:
                    raise BatchCapacityError("Gt/Lt needs exactly one value")
                try:
                    num_row[q] = int(r.values[0])
                except ValueError:
                    raise BatchCapacityError("non-integer Gt/Lt value")


def _node_affinity_key(na) -> Optional[tuple]:
    if na is None:
        return None

    def term_key(term):
        return (tuple((r.key, r.operator, tuple(r.values))
                      for r in term.match_expressions),
                tuple((f.key, f.operator, tuple(f.values))
                      for f in term.match_fields))

    required = None
    if na.required is not None:
        required = tuple(term_key(t) for t in na.required.terms)
    preferred = tuple((p.weight, term_key(p.preference))
                      for p in (na.preferred or ()))
    return (required, preferred)


def _zero_table(U: int, R: int, d: BatchDims) -> PodTable:
    return PodTable(
        req=np.zeros((U, R), np.int64),
        nonzero_req=np.zeros((U, 2), np.int64),
        node_name_id=np.zeros((U,), np.int32),
        tol_key=np.zeros((U, d.tolerations), np.int32),
        tol_val=np.zeros((U, d.tolerations), np.int32),
        tol_eff=np.zeros((U, d.tolerations), np.int32),
        tol_op=np.zeros((U, d.tolerations), np.int32),
        tolerates_unsched=np.zeros((U,), bool),
        ns_sel_val=np.zeros((U, d.sel_reqs), np.int32),
        aff_has=np.zeros((U,), bool),
        aff_term_valid=np.zeros((U, d.sel_terms), bool),
        aff_key=np.zeros((U, d.sel_terms, d.sel_reqs), np.int32),
        aff_op=np.zeros((U, d.sel_terms, d.sel_reqs), np.int32),
        aff_num=np.zeros((U, d.sel_terms, d.sel_reqs), np.int64),
        aff_val=np.zeros((U, d.sel_terms, d.sel_reqs, d.sel_vals), np.int32),
        pref_weight=np.zeros((U, d.pref_terms), np.int64),
        pref_key=np.zeros((U, d.pref_terms, d.sel_reqs), np.int32),
        pref_op=np.zeros((U, d.pref_terms, d.sel_reqs), np.int32),
        pref_num=np.zeros((U, d.pref_terms, d.sel_reqs), np.int64),
        pref_val=np.zeros((U, d.pref_terms, d.sel_reqs, d.sel_vals), np.int32),
        port_ids=np.zeros((U, d.ports), np.int32),
        skip_balanced=np.zeros((U,), bool),
        img_ids=np.zeros((U, d.images_per_pod), np.int32),
        img_containers=np.zeros((U,), np.int32),
    )
