"""Tensorized cluster state: the device-resident mirror of the cache.

The reference's NodeInfo (pkg/scheduler/framework/types.go:165-208) becomes a
row across a set of padded, statically-shaped arrays:

- cap/used [N, R] int64      — Allocatable / Requested per resource column
- nonzero_used [N, 2] int64  — NonZeroRequested (cpu, mem) for LeastAllocated
- npods / allowed_pods [N]   — pod count vs allocatable "pods"
- taints  [N, T] ×3          — interned (key, value, effect) triples
- labels  [N, L] ×3          — interned (key, key=value, numeric) triples;
  node name is injected as a synthetic `metadata.name` label so NodeAffinity
  matchFields compile to ordinary requirements
- ports   [N, P]             — interned (protocol, port) ids in use
- images  [N, I] ×2          — interned image ids + sizes

Shapes are padded to power-of-two buckets (SURVEY §7 hard-part 3: avoid
recompilation storms); `valid[N]` masks padding rows.

Update path mirrors the incremental snapshot (backend/cache/snapshot.go):
`apply_snapshot` consumes `Snapshot.dirty_nodes` and scatter-writes only the
changed rows. During a batch the *device program itself* carries used/npods/
ports forward (ops/program.py), so steady-state scheduling moves no node
state across PCIe at all — the host only reconciles informer deltas.

The staging arrays are numpy; `device_arrays()` mirrors them as torch
tensors on the state's device with the dtypes written out per field (i64
quantities, i32 ids, bool masks).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np

from ..api import resources as res
from ..api.types import TaintEffect
from ..backend.cache import Snapshot
from ..framework.types import NodeInfo
from ..utils.interning import ClusterInterner

# effect encoding (0 = padding)
EFFECT_NO_SCHEDULE = 1
EFFECT_PREFER_NO_SCHEDULE = 2
EFFECT_NO_EXECUTE = 3

_EFFECTS = {
    TaintEffect.NO_SCHEDULE.value: EFFECT_NO_SCHEDULE,
    TaintEffect.PREFER_NO_SCHEDULE.value: EFFECT_PREFER_NO_SCHEDULE,
    TaintEffect.NO_EXECUTE.value: EFFECT_NO_EXECUTE,
}

# sentinel for "label value is not an integer" (Gt/Lt never match)
NON_NUMERIC = np.int64(np.iinfo(np.int64).min)

METADATA_NAME_KEY = "metadata.name"


def pow2_at_least(n: int, floor: int = 8) -> int:
    v = floor
    while v < n:
        v *= 2
    return v


class NodeArrays(NamedTuple):
    """The device (or staging-numpy) arrays. All shapes static."""

    cap: object            # i64 [N, R]
    used: object           # i64 [N, R]
    nonzero_used: object   # i64 [N, 2]
    npods: object          # i32 [N]
    allowed_pods: object   # i32 [N]
    valid: object          # bool [N]
    unschedulable: object  # bool [N]
    name_id: object        # i32 [N] (interned node name, NodeName filter)
    taint_key: object      # i32 [N, T]
    taint_val: object      # i32 [N, T]
    taint_eff: object      # i32 [N, T]
    label_key: object      # i32 [N, L]
    label_kv: object       # i32 [N, L]
    label_num: object      # i64 [N, L]
    ports: object          # i32 [N, P]
    image_id: object       # i32 [N, I]
    image_size: object     # i64 [N, I]


@dataclass
class Dims:
    nodes: int = 8
    resources: int = 16
    taints: int = 8
    labels: int = 16
    ports: int = 8
    images: int = 8


class CapacityError(ValueError):
    """A node exceeded a padded per-row capacity; caller re-pads + rebuilds."""


@dataclass
class ClusterState:
    """Host owner of the tensorized state."""

    interner: ClusterInterner = field(default_factory=ClusterInterner)
    rtable: res.ResourceTable = field(default_factory=res.ResourceTable)
    dims: Dims = field(default_factory=Dims)
    node_index: dict[str, int] = field(default_factory=dict)
    node_names: list[str] = field(default_factory=list)
    row_gen: dict[str, int] = field(default_factory=dict)
    _free: list[int] = field(default_factory=list)
    arrays: Optional[NodeArrays] = None  # numpy staging
    _device: Optional[NodeArrays] = None  # torch device copy (lazy)
    # the node-sharded mesh's copy (parallel/sharding.py Shards); a
    # scheduler uses one of the two, so they share the dirty-row tracking
    _device_sharded: Optional[tuple] = None
    _device_dirty: bool = True
    # torch device the resident copy lives on ("cuda" or "cpu")
    device: str = "cuda"
    # monotonic generation of the STATIC node columns only (valid, name,
    # labels, taints, images, capacity — everything the carry-independent
    # signature surfaces read): bumped by full row writes, row
    # invalidations and shape growth, but not by the per-commit aggregate
    # updates (used/npods/ports). The compiler's SurfaceCache and the
    # group label columns key on it.
    statics_gen: int = 0
    # name → the Node object whose static fields row `name` reflects
    # (strong refs: identity comparison is only safe while we hold them)
    _row_node: dict = field(default_factory=dict)
    # generation-diff device upload: row indices written since
    # the device copy was last refreshed. When the set is small and no
    # shape moved, device_arrays() scatters ONLY these rows through
    # scatter_rows instead of re-uploading the full matrices;
    # None = tracking lost (fall back to a full upload).
    _dirty_rows: Optional[set] = field(default_factory=set)
    rows_scattered_total: int = 0
    full_uploads_total: int = 0
    # scatter only when dirty rows ≤ max(N >> scatter_shift, 32): beyond
    # that the full upload's one big copy beats many-row gathers
    scatter_shift: int = 3
    # (id(snapshot), generation, tree_generation) of the last fully
    # consumed apply_snapshot: an unchanged snapshot skips the O(N) walk
    # entirely (the preemption path applies per failed pod)
    _applied_key: tuple = (0, -1, -1)

    # -- index management -----------------------------------------------------

    def _slot(self, name: str) -> int:
        idx = self.node_index.get(name)
        if idx is not None:
            return idx
        if self._free:
            idx = self._free.pop()
        else:
            idx = len(self.node_names)
            self.node_names.append("")
            if idx >= self.dims.nodes:
                self._grow_nodes()
        self.node_index[name] = idx
        self.node_names[idx] = name
        return idx

    def _grow_nodes(self) -> None:
        old = self.dims.nodes
        self.dims.nodes = pow2_at_least(len(self.node_names), max(8, old * 2))
        if self.arrays is not None:
            self.arrays = _pad_rows(self.arrays, self.dims.nodes)
            self.statics_gen += 1   # [N]-shaped surfaces are stale
            self._dirty_rows = None  # shape moved: full upload

    def node_id(self, name: str) -> int:
        """Interned id used for NodeName filter / matchFields."""
        return self.interner.kv.intern(f"node:{name}")

    # -- build / update -------------------------------------------------------

    def ensure_arrays(self) -> NodeArrays:
        if self.arrays is None:
            self.arrays = _zero_arrays(self.dims)
        return self.arrays

    def apply_snapshot(self, snapshot: Snapshot, full: bool = False) -> None:
        """Scatter-update rows whose NodeInfo generation moved since the last
        apply (pull-based incremental consumption: this consumer owns its own
        progress in `row_gen`, so it never depends on how often the host
        refreshed the snapshot in between)."""
        applied_key = (id(snapshot), snapshot.generation,
                       snapshot.tree_generation)
        if not full and self.arrays is not None \
                and applied_key == self._applied_key:
            return
        self.ensure_arrays()
        list_order = {n.name: i for i, n in enumerate(snapshot.node_info_list)}
        schedulable_names = set(list_order)
        # removed or non-schedulable nodes → invalidate rows
        for name in list(self.node_index):
            if name not in schedulable_names:
                idx = self.node_index.pop(name, None)
                self.row_gen.pop(name, None)
                self._row_node.pop(name, None)
                if idx is not None:
                    self.arrays.valid[idx] = False
                    self.node_names[idx] = ""
                    self._free.append(idx)
                    self.statics_gen += 1
                    # the cleared valid bit must reach the device even
                    # when no other row was written this apply
                    self._device_dirty = True
                    if self._dirty_rows is not None:
                        self._dirty_rows.add(idx)
        # write in snapshot-list order so freshly-assigned row indices track
        # the host iteration order (argmax tie-breaks then usually agree)
        dirty_writes = False
        full_items: list = []
        agg_items: list = []
        for ni in snapshot.node_info_list:
            prev_gen = self.row_gen.get(ni.name)
            if not full and prev_gen == ni.generation:
                continue
            idx = self._slot(ni.name)
            # fast path: the Node OBJECT is unchanged (labels/taints/
            # capacity/images identical by identity — _row_node holds a
            # strong ref so the id can't be recycled), so only the pod
            # aggregates moved (assume/add/remove): rewrite those alone.
            # This is the common per-drain case — every commit bumps its
            # node's generation, and a full row rewrite costs ~7× the
            # aggregate update.
            if (not full and prev_gen is not None
                    and self._row_node.get(ni.name) is ni.node):
                agg_items.append((idx, ni))
            else:
                full_items.append((idx, ni))
                self._row_node[ni.name] = ni.node
            self.row_gen[ni.name] = ni.generation
            dirty_writes = True
        # the per-row writers (the columnar batch writers are not ported)
        for idx, ni in full_items:
            self._write_row(idx, ni)
        for idx, ni in agg_items:
            self._write_row_aggregates(idx, ni)
        if dirty_writes or full:
            self._device_dirty = True
        self._applied_key = applied_key

    def _write_row_aggregates(self, idx: int, ni: NodeInfo) -> None:
        """Pod-aggregate-only row refresh (used/nonzero/npods/ports) —
        valid only when the Node object itself is unchanged."""
        a = self.arrays
        if self._dirty_rows is not None:
            self._dirty_rows.add(idx)
        used_row = self.rtable.vector(ni.requested)
        if len(used_row) > a.used.shape[1]:
            self._write_row(idx, ni)   # resource table grew: full path
            return
        a.used[idx, :len(used_row)] = used_row
        a.used[idx, len(used_row):] = 0
        a.nonzero_used[idx, 0] = ni.non_zero_cpu
        a.nonzero_used[idx, 1] = ni.non_zero_mem
        a.npods[idx] = len(ni.pods)
        if ni.used_ports.ports or a.ports[idx, 0]:
            port_ids = sorted({self.interner.port_id(p, pt)
                               for (p, pt, _ip) in ni.used_ports.ports})
            if len(port_ids) > self.dims.ports:
                raise CapacityError(
                    f"node {ni.name}: {len(port_ids)} ports > "
                    f"{self.dims.ports}")
            a.ports[idx] = 0
            a.ports[idx, :len(port_ids)] = port_ids

    def _write_row(self, idx: int, ni: NodeInfo) -> None:
        a = self.arrays
        d = self.dims
        node = ni.node
        # full row write touches the static columns: hoisted per-signature
        # surfaces over this node axis must recompute
        self.statics_gen += 1
        if self._dirty_rows is not None:
            self._dirty_rows.add(idx)
        # resources
        cap_row = self.rtable.vector(ni.allocatable)
        used_row = self.rtable.vector(ni.requested)
        if len(cap_row) > d.resources or len(used_row) > d.resources:
            self._grow_resources()
            a = self.arrays  # _grow_resources rebinds the arrays
            cap_row = self.rtable.vector(ni.allocatable)
            used_row = self.rtable.vector(ni.requested)
        a.cap[idx, :len(cap_row)] = cap_row
        a.cap[idx, len(cap_row):] = 0
        a.used[idx, :len(used_row)] = used_row
        a.used[idx, len(used_row):] = 0
        a.nonzero_used[idx, 0] = ni.non_zero_cpu
        a.nonzero_used[idx, 1] = ni.non_zero_mem
        a.npods[idx] = len(ni.pods)
        a.allowed_pods[idx] = ni.allocatable.get(res.PODS, 0)
        a.valid[idx] = True
        a.unschedulable[idx] = node.spec.unschedulable
        a.name_id[idx] = self.node_id(node.metadata.name)
        # taints
        taints = node.spec.taints
        if len(taints) > d.taints:
            raise CapacityError(f"node {ni.name}: {len(taints)} taints > {d.taints}")
        a.taint_key[idx] = 0
        a.taint_val[idx] = 0
        a.taint_eff[idx] = 0
        for t, taint in enumerate(taints):
            a.taint_key[idx, t] = self.interner.key.intern(taint.key)
            a.taint_val[idx, t] = self.interner.kv.intern(f"tv:{taint.value}")
            a.taint_eff[idx, t] = _EFFECTS.get(taint.effect, 0)
        # labels (+ synthetic metadata.name)
        labels = dict(node.metadata.labels)
        labels[METADATA_NAME_KEY] = node.metadata.name
        if len(labels) > d.labels:
            raise CapacityError(f"node {ni.name}: {len(labels)} labels > {d.labels}")
        a.label_key[idx] = 0
        a.label_kv[idx] = 0
        a.label_num[idx] = NON_NUMERIC
        for l, (k, v) in enumerate(sorted(labels.items())):
            a.label_key[idx, l] = self.interner.key.intern(k)
            a.label_kv[idx, l] = self.interner.label_kv(k, v)
            try:
                a.label_num[idx, l] = int(v)
            except ValueError:
                a.label_num[idx, l] = NON_NUMERIC
        # ports
        port_ids = sorted({self.interner.port_id(p, pt)
                           for (p, pt, _ip) in ni.used_ports.ports})
        if len(port_ids) > d.ports:
            raise CapacityError(f"node {ni.name}: {len(port_ids)} ports > {d.ports}")
        a.ports[idx] = 0
        a.ports[idx, :len(port_ids)] = port_ids
        # images
        if len(ni.image_sizes) > d.images:
            # grow rather than truncate: the ImageLocality device kernel is
            # authoritative now (no host fallback), so a dropped image row
            # would silently corrupt scores
            self._grow_images(len(ni.image_sizes))
            a = self.arrays
        a.image_id[idx] = 0
        a.image_size[idx] = 0
        for i, (img, size) in enumerate(sorted(ni.image_sizes.items())):
            a.image_id[idx, i] = self.interner.image.intern(img)
            a.image_size[idx, i] = size

    def _grow_images(self, needed: int) -> None:
        self.dims.images = pow2_at_least(needed)
        if self.arrays is not None:
            a = self.arrays

            def pad(x):
                extra = self.dims.images - x.shape[1]
                if extra <= 0:
                    return x
                return np.concatenate(
                    [x, np.zeros((x.shape[0], extra), x.dtype)], axis=1)

            self.arrays = a._replace(image_id=pad(a.image_id),
                                     image_size=pad(a.image_size))
        self._device_dirty = True
        self.statics_gen += 1
        self._dirty_rows = None

    def _grow_resources(self) -> None:
        self.dims.resources = self.rtable.width
        if self.arrays is not None:
            self.arrays = _pad_cols(self.arrays, self.dims)
            self.statics_gen += 1
            self._dirty_rows = None

    def request_vector(self, requests: dict[str, int]):
        """Dense np.int64 request row at the CURRENT staging width, without
        interning: None when a resource name is not in the table (or sits
        past the staged width). The preemption dry run reads victim and
        nominated-pod vectors through it; a None sends the dry run to the
        host loop instead of growing the resource axis mid-flight."""
        a = self.ensure_arrays()
        width = a.used.shape[1]
        row = np.zeros((width,), np.int64)
        index = self.rtable.index
        for name, v in requests.items():
            i = index.get(name)
            if i is None or i >= width:
                return None
            row[i] = v
        return row

    # -- device transfer ------------------------------------------------------

    def device_arrays(self) -> NodeArrays:
        """torch copies on `self.device` (cached until the staging arrays
        change).

        Generation-diff upload: when only a small set of rows moved since
        the last refresh (tracked in `_dirty_rows` by the row writers),
        ship just those rows through `scatter_rows` (ops/program.py) —
        the host-to-device copy is O(dirty × row width), not O(N × row
        width). The scatter does NOT write into the previous device copy:
        in-flight drains and resident carries may still reference it, so
        it materializes fresh tensors and only the transfer is diffed."""
        if self._device is None or self._device_dirty:
            a = self.ensure_arrays()
            dirty = self._dirty_rows
            N = a.used.shape[0]
            if (self._device is not None and dirty
                    and tuple(self._device.used.shape) == a.used.shape
                    and tuple(self._device.label_key.shape)
                    == a.label_key.shape
                    and tuple(self._device.image_id.shape)
                    == a.image_id.shape
                    and len(dirty) <= max(N >> self.scatter_shift, 32)):
                idx = np.fromiter(dirty, np.int64, len(dirty))
                idx.sort()
                rows = NodeArrays(*(x[idx] for x in a))
                from ..ops.program import scatter_rows
                from .convert import node_arrays_from_numpy
                self._device = scatter_rows(
                    self._device, idx,
                    node_arrays_from_numpy(rows, self.device))
                self.rows_scattered_total += len(idx)
            else:
                from .convert import node_arrays_from_numpy
                self._device = node_arrays_from_numpy(a, self.device)
                self.full_uploads_total += 1
            self._device_dirty = False
            self._dirty_rows = set()
        return self._device

    def sharded_upload_due(self) -> bool:
        """True when `device_arrays_sharded` would upload (rows or the
        whole matrices) instead of returning its resident shards."""
        return self._device_sharded is None or self._device_dirty

    def device_arrays_sharded(self, mesh):
        """The staging arrays on the node-sharded mesh (parallel/
        sharding.py Shards), with the generation-diff policy of
        `device_arrays` (the JAX package's device_arrays_sharded): a small
        dirty set, padded to a power of two by repeating its first row,
        rides `scatter_rows_sharded`, each shard taking only its own rows;
        anything else re-shards the full matrices."""
        if self._device_sharded is None or self._device_dirty:
            a = self.ensure_arrays()
            from ..parallel.sharding import (scatter_rows_sharded,
                                             shard_node_arrays)
            dirty = self._dirty_rows
            N = a.used.shape[0]
            dev = self._device_sharded
            if (dev is not None and dirty and len(dev) == mesh.size
                    and dev.rows == N
                    and tuple(dev[0].used.shape[1:]) == a.used.shape[1:]
                    and tuple(dev[0].label_key.shape[1:])
                    == a.label_key.shape[1:]
                    and tuple(dev[0].image_id.shape[1:])
                    == a.image_id.shape[1:]
                    and len(dirty) <= max(N >> self.scatter_shift, 32)):
                idx = np.fromiter(dirty, np.int64, len(dirty))
                idx.sort()
                pidx = np.full((pow2_at_least(len(idx)),), idx[0], np.int64)
                pidx[:len(idx)] = idx
                rows = NodeArrays(*(x[pidx] for x in a))
                self._device_sharded = scatter_rows_sharded(mesh, dev, pidx,
                                                            rows)
                self.rows_scattered_total += len(idx)
            else:
                self._device_sharded = shard_node_arrays(mesh, a)
                self.full_uploads_total += 1
            self._device_dirty = False
            self._dirty_rows = set()
        return self._device_sharded

    def adopt_carry(self, used, nonzero_used, npods, ports,
                    touched: Optional[dict[str, int]] = None) -> None:
        """After a batch, the scan's carry IS the new truth for the mutable
        arrays — pull it back into staging without a full rebuild. (The host
        cache is updated in parallel via assume; `reconcile` cross-checks.)

        `touched` maps node name → the cache generation reached by the
        parallel assume bookkeeping; recording it marks those rows current,
        which is what lets `reconcile` compare scan-carry content against
        cache content instead of writing the rows off as lagging.

        On the mesh each argument is a tuple of the shards' tensors: the
        staging arrays take them in shard order and the resident shards
        adopt them in place, with no re-upload."""
        a = self.ensure_arrays()
        cols = (used, nonzero_used, npods, ports)
        sharded = isinstance(used, (tuple, list))

        def host(x):
            parts = x if sharded else (x,)
            return np.concatenate([t.cpu().numpy() for t in parts])

        for dst, x in zip((a.used, a.nonzero_used, a.npods, a.ports), cols):
            np.copyto(dst, host(x))
        if touched:
            self.row_gen.update(touched)
        if sharded:
            if self._device_sharded is not None:
                self._device_sharded = type(self._device_sharded)(
                    s._replace(used=u, nonzero_used=z, npods=n, ports=p)
                    for s, u, z, n, p in zip(self._device_sharded, *cols))
        elif self._device is not None:
            self._device = self._device._replace(
                used=used, nonzero_used=nonzero_used, npods=npods, ports=ports)

    # -- divergence check (cache debugger analog) ----------------------------

    def reconcile(self, snapshot: Snapshot) -> list[str]:
        """Compare staging arrays vs snapshot; returns divergent node names
        (backend/cache/debugger comparer analog). Rows whose generation is
        behind the snapshot are LAG, not divergence — the next apply_snapshot
        refreshes them; only rows claiming to be current are compared."""
        out = []
        a = self.ensure_arrays()
        for name, idx in self.node_index.items():
            ni = snapshot.node_infos.get(name)
            if ni is None:
                out.append(name)
                continue
            if self.row_gen.get(name) != ni.generation:
                continue
            used_row = self.rtable.vector(ni.requested)
            port_ids = sorted({self.interner.port_id(p, pt)
                               for (p, pt, _ip) in ni.used_ports.ports})
            row_ports = sorted(int(x) for x in a.ports[idx] if x != 0)
            if (list(a.used[idx, :len(used_row)]) != used_row
                    or a.npods[idx] != len(ni.pods)
                    or row_ports != port_ids):
                out.append(name)
        return out


def _zero_arrays(d: Dims) -> NodeArrays:
    n = d.nodes
    return NodeArrays(
        cap=np.zeros((n, d.resources), np.int64),
        used=np.zeros((n, d.resources), np.int64),
        nonzero_used=np.zeros((n, 2), np.int64),
        npods=np.zeros((n,), np.int32),
        allowed_pods=np.zeros((n,), np.int32),
        valid=np.zeros((n,), bool),
        unschedulable=np.zeros((n,), bool),
        name_id=np.zeros((n,), np.int32),
        taint_key=np.zeros((n, d.taints), np.int32),
        taint_val=np.zeros((n, d.taints), np.int32),
        taint_eff=np.zeros((n, d.taints), np.int32),
        label_key=np.zeros((n, d.labels), np.int32),
        label_kv=np.zeros((n, d.labels), np.int32),
        label_num=np.full((n, d.labels), NON_NUMERIC, np.int64),
        ports=np.zeros((n, d.ports), np.int32),
        image_id=np.zeros((n, d.images), np.int32),
        image_size=np.zeros((n, d.images), np.int64),
    )


def _pad_rows(a: NodeArrays, n: int) -> NodeArrays:
    def pad(x):
        extra = n - x.shape[0]
        if extra <= 0:
            return x
        fill = NON_NUMERIC if x is a.label_num else 0
        pad_block = np.full((extra,) + x.shape[1:], fill, x.dtype)
        return np.concatenate([x, pad_block], axis=0)
    return NodeArrays(*(pad(x) for x in a))


def _pad_cols(a: NodeArrays, d: Dims) -> NodeArrays:
    def pad(x, want):
        extra = want - x.shape[1]
        if extra <= 0:
            return x
        return np.concatenate(
            [x, np.zeros((x.shape[0], extra), x.dtype)], axis=1)
    return a._replace(cap=pad(a.cap, d.resources), used=pad(a.used, d.resources))
