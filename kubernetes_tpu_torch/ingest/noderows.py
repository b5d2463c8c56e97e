"""Columnar node-row tensorize: batch twin of ClusterState._write_row.

`apply_snapshot` walks the generation-dirty NodeInfos and rewrites one
row per node — ~20 scalar array stores each. At prime/resync (every row
dirty) and after mass node events that is the dominant host cost. The
two writers here extract the dirty rows into per-chunk column buffers
(Python still walks the small padded dims — interning forces that) and
then write each NodeArrays field with ONE fancy-index scatter.

Both return False when a capacity edge wants the serial path (resource
or image growth, taint/label/port overflow): the caller then falls back
to the per-row writers, which own growth and raise the same
CapacityError they always did. Both keep the row writers' bookkeeping:
every written row joins `_dirty_rows` (the dirty-row upload reads
exactly that set), and a full write bumps `statics_gen` once a row (the
SurfaceCache and the group label columns key on it).
tests/test_torch_ingest.py holds NodeArrays, dirty rows and statics_gen
bit for bit against the serial writers and the JAX package's.
"""

from __future__ import annotations

import numpy as np

from ..api import resources as res
from ..state.tensorize import _EFFECTS, NON_NUMERIC


def write_rows(state, items: list) -> bool:
    """Full-row columnar write of [(idx, NodeInfo)]. Mirrors
    `ClusterState._write_row` field-for-field; returns False (no writes)
    when any row needs growth or exceeds a padded dim."""
    a = state.arrays
    d = state.dims
    K = len(items)
    if not K:
        return True
    R = a.cap.shape[1]
    vector = state.rtable.vector
    intr = state.interner
    rows: list = []              # (idx, cap_row, used_row, ni, node)
    for idx, ni in items:
        node = ni.node
        cap_row = vector(ni.allocatable)
        used_row = vector(ni.requested)
        if len(cap_row) > R or len(used_row) > R:
            return False         # resource growth: serial path owns it
        if len(node.spec.taints) > d.taints:
            return False
        if len(ni.image_sizes) > d.images:
            return False         # image growth: serial path owns it
        rows.append((idx, cap_row, used_row, ni, node))
    cap = np.zeros((K, R), np.int64)
    used = np.zeros((K, R), np.int64)
    nonzero = np.zeros((K, 2), np.int64)
    npods = np.zeros((K,), np.int32)
    allowed = np.zeros((K,), np.int32)
    unsched = np.zeros((K,), bool)
    name_id = np.zeros((K,), np.int32)
    taint_key = np.zeros((K, d.taints), np.int32)
    taint_val = np.zeros((K, d.taints), np.int32)
    taint_eff = np.zeros((K, d.taints), np.int32)
    L = a.label_key.shape[1]
    label_key = np.zeros((K, L), np.int32)
    label_kv = np.zeros((K, L), np.int32)
    label_num = np.full((K, L), NON_NUMERIC, np.int64)
    P = a.ports.shape[1]
    ports = np.zeros((K, P), np.int32)
    I = a.image_id.shape[1]
    image_id = np.zeros((K, I), np.int32)
    image_size = np.zeros((K, I), np.int64)
    from ..state.tensorize import METADATA_NAME_KEY
    key_intern = intr.key.intern
    kv_intern = intr.kv.intern
    lab_kv = intr.label_kv
    port_id = intr.port_id
    img_intern = intr.image.intern
    node_id = state.node_id
    for k, (idx, cap_row, used_row, ni, node) in enumerate(rows):
        cap[k, :len(cap_row)] = cap_row
        used[k, :len(used_row)] = used_row
        nonzero[k, 0] = ni.non_zero_cpu
        nonzero[k, 1] = ni.non_zero_mem
        npods[k] = len(ni.pods)
        allowed[k] = ni.allocatable.get(res.PODS, 0)
        unsched[k] = node.spec.unschedulable
        name_id[k] = node_id(node.metadata.name)
        for t, taint in enumerate(node.spec.taints):
            taint_key[k, t] = key_intern(taint.key)
            taint_val[k, t] = kv_intern(f"tv:{taint.value}")
            taint_eff[k, t] = _EFFECTS.get(taint.effect, 0)
        labels = dict(node.metadata.labels)
        labels[METADATA_NAME_KEY] = node.metadata.name
        if len(labels) > d.labels:
            return False         # serial path raises CapacityError
        for li, (lk, lv) in enumerate(sorted(labels.items())):
            label_key[k, li] = key_intern(lk)
            label_kv[k, li] = lab_kv(lk, lv)
            try:
                label_num[k, li] = int(lv)
            except ValueError:
                pass             # buffer pre-filled with NON_NUMERIC
        pids = sorted({port_id(p, pt)
                       for (p, pt, _ip) in ni.used_ports.ports})
        if len(pids) > P:
            return False
        ports[k, :len(pids)] = pids
        for ii, (img, size) in enumerate(sorted(ni.image_sizes.items())):
            image_id[k, ii] = img_intern(img)
            image_size[k, ii] = size
    idxs = np.array([idx for idx, *_ in rows], np.intp)
    a.cap[idxs] = cap
    a.used[idxs] = used
    a.nonzero_used[idxs] = nonzero
    a.npods[idxs] = npods
    a.allowed_pods[idxs] = allowed
    a.valid[idxs] = True
    a.unschedulable[idxs] = unsched
    a.name_id[idxs] = name_id
    a.taint_key[idxs] = taint_key
    a.taint_val[idxs] = taint_val
    a.taint_eff[idxs] = taint_eff
    a.label_key[idxs] = label_key
    a.label_kv[idxs] = label_kv
    a.label_num[idxs] = label_num
    a.ports[idxs] = ports
    a.image_id[idxs] = image_id
    a.image_size[idxs] = image_size
    # bookkeeping the serial writer does per row
    state.statics_gen += K
    if state._dirty_rows is not None:
        state._dirty_rows.update(int(i) for i in idxs)
    return True


def write_aggregate_rows(state, items: list) -> bool:
    """Columnar `_write_row_aggregates` for [(idx, NodeInfo)] whose Node
    object is unchanged (pod aggregates only). Rows with live host ports
    keep the serial path (set-rebuild per row is rare and stateful).
    Returns False (no writes) when any row wants the serial writer."""
    a = state.arrays
    K = len(items)
    if not K:
        return True
    R = a.used.shape[1]
    vector = state.rtable.vector
    rows: list = []
    for idx, ni in items:
        if ni.used_ports.ports or a.ports[idx, 0]:
            return False         # port carry: serial path
        used_row = vector(ni.requested)
        if len(used_row) > R:
            return False         # resource growth: serial path
        rows.append((idx, used_row, ni))
    used = np.zeros((K, R), np.int64)
    nonzero = np.zeros((K, 2), np.int64)
    npods = np.zeros((K,), np.int32)
    for k, (idx, used_row, ni) in enumerate(rows):
        used[k, :len(used_row)] = used_row
        nonzero[k, 0] = ni.non_zero_cpu
        nonzero[k, 1] = ni.non_zero_mem
        npods[k] = len(ni.pods)
    idxs = np.array([idx for idx, *_ in rows], np.intp)
    a.used[idxs] = used
    a.nonzero_used[idxs] = nonzero
    a.npods[idxs] = npods
    if state._dirty_rows is not None:
        state._dirty_rows.update(int(i) for i in idxs)
    return True
