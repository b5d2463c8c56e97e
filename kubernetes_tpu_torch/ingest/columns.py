"""Vectorized signature tensorize + the per-row commit-facts column.

`fill_rows` is the columnar twin of `BatchBuilder._fill_row`
(state/batch.py): one chunk of NEW signatures is extracted into per-chunk
column buffers (Python walks the small padded dims exactly like the
serial filler — the interners force that), and each PodTable column is
then written with ONE numpy scatter for the whole chunk instead of ~30
scalar array stores per row. The serial `_fill_row` stays as the
reference implementation, and the serial path the `ColumnarIngest`
gate (off) selects; tests/test_torch_ingest.py holds the two bit for bit
(affinity term tables included), and both to the JAX package's build.

`CommitFacts` is the columnar pod store's commit-side column: everything
the batched assume/bind path (ingest/commit.py) needs per pod, hoisted
per SIGNATURE ROW at interning time — request items, nonzero cpu/mem,
and the port/affinity membership flags `NodeInfo.add_pod` would
otherwise re-derive from the object graph on every single commit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..api import resources as res
from ..plugins.node_basics import NodeUnschedulable


class CommitFacts(NamedTuple):
    """Per-signature-row facts consumed by the batched commit path."""

    req_items: tuple        # ((resource, qty), ...) — pod_requests items
    cpu_nz: int             # NonZeroRequested cpu contribution
    mem_nz: int             # NonZeroRequested memory contribution
    has_ports: bool         # pod occupies host ports (used_ports update)
    has_affinity: bool      # NodeInfo.pods_with_affinity membership
    has_anti_affinity: bool  # pods_with_required_anti_affinity membership


def commit_facts_for_row(pod) -> CommitFacts:
    """Facts from a row's representative pod. Every field below is part
    of the signature key (state/batch.py _sig_key), so all pods interned
    into the row share them."""
    reqs = res.pod_requests(pod)
    cpu_nz, mem_nz = res.pod_requests_nonzero(pod)
    aff = pod.spec.affinity
    pa = aff.pod_affinity if aff else None
    paa = aff.pod_anti_affinity if aff else None
    has_ports = any(p.host_port > 0 for c in pod.spec.containers
                    for p in c.ports)
    return CommitFacts(
        req_items=tuple(reqs.items()),
        cpu_nz=cpu_nz, mem_nz=mem_nz,
        has_ports=has_ports,
        has_affinity=bool((pa and pa.required)
                          or (pa and pa.preferred)
                          or (paa and paa.preferred)),
        has_anti_affinity=bool(paa and paa.required),
    )


class _RowCols(NamedTuple):
    """Per-chunk extraction buffers (K rows), one per PodTable column."""

    req: np.ndarray
    nonzero_req: np.ndarray
    node_name_id: np.ndarray
    tol_key: np.ndarray
    tol_val: np.ndarray
    tol_eff: np.ndarray
    tol_op: np.ndarray
    tolerates_unsched: np.ndarray
    ns_sel_val: np.ndarray
    aff_has: np.ndarray
    aff_term_valid: np.ndarray
    aff_key: np.ndarray
    aff_op: np.ndarray
    aff_num: np.ndarray
    aff_val: np.ndarray
    pref_weight: np.ndarray
    pref_key: np.ndarray
    pref_op: np.ndarray
    pref_num: np.ndarray
    pref_val: np.ndarray
    port_ids: np.ndarray
    skip_balanced: np.ndarray
    img_ids: np.ndarray
    img_containers: np.ndarray


def _chunk_buffers(K: int, R: int, d) -> _RowCols:
    return _RowCols(
        req=np.zeros((K, R), np.int64),
        nonzero_req=np.zeros((K, 2), np.int64),
        node_name_id=np.zeros((K,), np.int32),
        tol_key=np.zeros((K, d.tolerations), np.int32),
        tol_val=np.zeros((K, d.tolerations), np.int32),
        tol_eff=np.zeros((K, d.tolerations), np.int32),
        tol_op=np.zeros((K, d.tolerations), np.int32),
        tolerates_unsched=np.zeros((K,), bool),
        ns_sel_val=np.zeros((K, d.sel_reqs), np.int32),
        aff_has=np.zeros((K,), bool),
        aff_term_valid=np.zeros((K, d.sel_terms), bool),
        aff_key=np.zeros((K, d.sel_terms, d.sel_reqs), np.int32),
        aff_op=np.zeros((K, d.sel_terms, d.sel_reqs), np.int32),
        aff_num=np.zeros((K, d.sel_terms, d.sel_reqs), np.int64),
        aff_val=np.zeros((K, d.sel_terms, d.sel_reqs, d.sel_vals), np.int32),
        pref_weight=np.zeros((K, d.pref_terms), np.int64),
        pref_key=np.zeros((K, d.pref_terms, d.sel_reqs), np.int32),
        pref_op=np.zeros((K, d.pref_terms, d.sel_reqs), np.int32),
        pref_num=np.zeros((K, d.pref_terms, d.sel_reqs), np.int64),
        pref_val=np.zeros((K, d.pref_terms, d.sel_reqs, d.sel_vals), np.int32),
        port_ids=np.zeros((K, d.ports), np.int32),
        skip_balanced=np.zeros((K,), bool),
        img_ids=np.zeros((K, d.images_per_pod), np.int32),
        img_containers=np.zeros((K,), np.int32),
    )


def _extract_row(builder, cols: _RowCols, k: int, pod) -> None:
    """One pod's fields → buffer row k. Field-for-field mirror of
    `BatchBuilder._fill_row` (the bit-for-bit parity contract); raises
    BatchCapacityError exactly where the serial filler does."""
    from ..state.batch import BatchCapacityError, TOL_EQUAL, TOL_EXISTS
    from ..state.tensorize import _EFFECTS

    d = builder.dims
    intr = builder.state.interner
    aff = pod.spec.affinity
    if pod.spec.volumes:
        raise BatchCapacityError("pod has volumes")
    if pod.spec.required_node_features:
        raise BatchCapacityError("pod requires declared node features")
    if pod.spec.resource_claims:
        raise BatchCapacityError("pod has resource claims")
    reqs = res.pod_requests(pod)
    row = builder.state.rtable.vector(reqs)
    if len(row) > cols.req.shape[1]:
        raise BatchCapacityError("resource table grew past batch width")
    cols.req[k, :len(row)] = row
    nz_cpu, nz_mem = res.pod_requests_nonzero(pod)
    cols.nonzero_req[k, 0] = nz_cpu
    cols.nonzero_req[k, 1] = nz_mem
    cols.skip_balanced[k] = all(v == 0 for v in reqs.values())
    if pod.spec.node_name:
        cols.node_name_id[k] = builder.state.node_id(pod.spec.node_name)
    tols = pod.spec.tolerations
    if len(tols) > d.tolerations:
        raise BatchCapacityError("too many tolerations")
    for t, tol in enumerate(tols):
        cols.tol_key[k, t] = intr.key.intern(tol.key) if tol.key else 0
        cols.tol_val[k, t] = intr.kv.intern(f"tv:{tol.value}")
        cols.tol_eff[k, t] = _EFFECTS.get(tol.effect, 0) if tol.effect else 0
        op = tol.operator or "Equal"
        cols.tol_op[k, t] = TOL_EXISTS if op == "Exists" else TOL_EQUAL
    cols.tolerates_unsched[k] = any(
        t.tolerates(NodeUnschedulable.TAINT) for t in tols)
    sel = pod.spec.node_selector
    if len(sel) > d.sel_reqs:
        raise BatchCapacityError("nodeSelector too wide")
    for q, (key, v) in enumerate(sorted(sel.items())):
        cols.ns_sel_val[k, q] = intr.label_kv(key, v)
    na = aff.node_affinity if aff else None
    if na and na.required is not None:
        terms = na.required.terms
        if len(terms) > d.sel_terms:
            raise BatchCapacityError("too many nodeAffinity terms")
        cols.aff_has[k] = True
        for t, term in enumerate(terms):
            cols.aff_term_valid[k, t] = True
            builder._fill_term(term, cols.aff_key[k, t], cols.aff_op[k, t],
                               cols.aff_num[k, t], cols.aff_val[k, t])
    if na and na.preferred:
        prefs = na.preferred
        if len(prefs) > d.pref_terms:
            raise BatchCapacityError("too many preferred terms")
        for t, p in enumerate(prefs):
            if p.weight == 0:
                continue
            cols.pref_weight[k, t] = p.weight
            builder._fill_term(p.preference, cols.pref_key[k, t],
                               cols.pref_op[k, t], cols.pref_num[k, t],
                               cols.pref_val[k, t])
    ports = [(p.protocol or "TCP", p.host_port, p.host_ip)
             for c in pod.spec.containers for p in c.ports if p.host_port > 0]
    if any(ip not in ("", "0.0.0.0") for (_, _, ip) in ports):
        raise BatchCapacityError("host-IP-scoped port")
    if len(ports) > d.ports:
        raise BatchCapacityError("too many host ports")
    for q, (proto, port, _ip) in enumerate(ports):
        cols.port_ids[k, q] = intr.port_id(proto, port)
    from ..plugins.imagelocality import normalized_image_name
    containers = (list(pod.spec.init_containers) + list(pod.spec.containers))
    imgs = [normalized_image_name(c.image) for c in containers if c.image]
    if imgs and len(imgs) > d.images_per_pod:
        raise BatchCapacityError("too many container images")
    cols.img_containers[k] = len(containers) if imgs else 0
    for q, img in enumerate(imgs):
        cols.img_ids[k, q] = intr.image.intern(img)


def fill_rows(builder, pods: list) -> list:
    """Intern a chunk of NEW-signature pods into the builder's PodTable
    with columnar writes. `pods` are the chunk's first-appearance
    representatives in drain order (the order mints signature ids, so it
    must match what the serial per-pod path would do).

    Returns one entry per input pod:
      ("row", sig_id, row) — interned (the builder's table/groups/facts
                             all updated, table_used advanced);
      ("fallback", reason) — the pod exceeds a padded dim / keeps host
                             semantics (no table row consumed).

    Capacity growth happens exactly like the serial path: a row is
    assigned only after BOTH the field extraction and the group-row parse
    succeed, so a mid-chunk failure never strands a half-written row.
    """
    from ..state.batch import BatchCapacityError

    K = len(pods)
    if not K:
        return []
    # column width follows the TABLE, not the live resource dims: a
    # mid-chunk resource interning past the table width must fall back
    # exactly like the serial filler's width check
    cols = _chunk_buffers(K, builder.table.req.shape[1], builder.dims)
    out: list = [None] * K
    kept: list = []          # (k, pod) that passed extraction
    for k, pod in enumerate(pods):
        try:
            _extract_row(builder, cols, k, pod)
        except BatchCapacityError as e:
            out[k] = ("fallback", str(e))
            continue
        kept.append((k, pod))
    rows: list = []          # (k, assigned row) for the final scatter
    for k, pod in enumerate(pods):
        # grow-before-attempt for EVERY new-signature candidate —
        # including ones whose extraction already fell back — exactly
        # like the serial _lookup (parity of table capacity and the
        # growth-driven carry reseeds)
        if builder.table_used >= builder.table.req.shape[0]:
            builder._grow_table()
        if out[k] is not None:
            continue
        u = builder.table_used
        try:
            builder.groups.add_row(u, pod)
        except BatchCapacityError as e:
            out[k] = ("fallback", str(e))
            continue
        sig_id = 0 if cols.port_ids[k].any() else builder._next_sig
        if sig_id:
            builder._next_sig += 1
        builder.table_used += 1
        builder.table_version += 1
        builder.row_facts.append(commit_facts_for_row(pod))
        rows.append((k, u))
        out[k] = ("row", sig_id, u)
    if rows:
        ks = np.array([k for k, _ in rows], np.intp)
        us = np.array([u for _, u in rows], np.intp)
        table = builder.table
        for name in _RowCols._fields:
            getattr(table, name)[us] = getattr(cols, name)[ks]
    return out
