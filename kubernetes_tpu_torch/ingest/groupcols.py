"""Columnar node label store for group-tensor seeding.

`GroupManager.build_dev` (ops/groups.py) seeds spread / inter-pod
affinity tensors by walking O(nodes) Python per signature row — the
topology-value interning walk, the domain-id walk, and a per-node dict
lookup for every count surface. Those walks ran per build_dev call
(scheduler reseed, diagnosis), every time.

`NodeLabelColumns` hoists the label views into per-statics-generation
columns: one interned topology-value vector and one dense domain-id
vector per topology key, computed once per node-state statics change
(ClusterState.statics_gen — the same key the compiler's SurfaceCache
trusts) and shared by every row, constraint and term that names the
key. `gather_ids` then turns the per-node count-dict lookups into one
sorted-search gather over the interned ids.
"""

from __future__ import annotations

import numpy as np


def gather_ids(tv: np.ndarray, id_values: dict, dtype=np.int64) -> np.ndarray:
    """Vectorized `{interned id: value}` lookup over an id vector:
    out[i] = id_values.get(tv[i], 0). One argsort of the (small) dict +
    one searchsorted over the node axis replaces the per-node Python
    dict probes."""
    out = np.zeros(tv.shape, dtype)
    if not id_values:
        return out
    ids = np.fromiter(id_values.keys(), np.int64, len(id_values))
    vals = np.fromiter(id_values.values(), dtype, len(id_values))
    order = np.argsort(ids)
    ids = ids[order]
    vals = vals[order]
    pos = np.searchsorted(ids, tv)
    pos_c = np.minimum(pos, len(ids) - 1)
    hit = ids[pos_c] == tv
    out[hit] = vals[pos_c[hit]]
    return out


class NodeLabelColumns:
    """Per-statics-generation interned label columns (see module doc).

    Validity contract: a column set is keyed on (statics_gen, node
    bucket). Every node add/remove/label change writes or invalidates a
    row, which bumps statics_gen (state/tensorize.py), so cached vectors
    can never describe a stale node set; snapshot-list ORDER is likewise
    a function of the node tree, which only changes with membership."""

    def __init__(self, state):
        self.state = state
        self._key = (-1, -1)
        self._nis: list = []
        self._tv: dict = {}        # topology key → i32 [N] label_kv ids
        self._dom: dict = {}       # topology key → i32 [N] dense dom ids
        self._keys_ok: dict = {}   # keys tuple → bool [N]
        self._order_idx = np.zeros((0,), np.int64)

    def sync(self, nis: list) -> "NodeLabelColumns":
        """Bind to the current node rows ([(row idx, NodeInfo)] in
        snapshot order); drops the columns when the statics generation
        or node bucket moved."""
        key = (self.state.statics_gen, self.state.dims.nodes)
        if key != self._key:
            self._key = key
            self._tv.clear()
            self._dom.clear()
            self._keys_ok.clear()
            self._order_idx = np.array([idx for idx, _ in nis], np.int64)
        self._nis = nis
        return self

    @property
    def order_idx(self) -> np.ndarray:
        return self._order_idx

    def tv(self, key: str) -> np.ndarray:
        """Interned label_kv id of label `key` per node row (0 = label
        absent) — the O(N) walk runs once per (key, statics_gen)."""
        v = self._tv.get(key)
        if v is None:
            N = self.state.dims.nodes
            v = np.zeros((N,), np.int32)
            kid: dict = {}
            intern = self.state.interner.label_kv
            for idx, ni in self._nis:
                val = ni.node.metadata.labels.get(key)
                if val is not None:
                    t = kid.get(val)
                    if t is None:
                        t = kid[val] = intern(key, val)
                    v[idx] = t
            self._tv[key] = v
        return v

    def dom(self, key: str) -> np.ndarray:
        """Dense domain id per node: the row index of the FIRST node (in
        snapshot order) sharing the key's topology value."""
        d = self._dom.get(key)
        if d is None:
            tvv = self.tv(key)
            N = self.state.dims.nodes
            d = np.zeros((N,), np.int32)
            order_idx = self._order_idx
            if len(order_idx):
                sub = tvv[order_idx]
                uniq, first_pos = np.unique(sub, return_index=True)
                first_row = order_idx[first_pos]
                d[order_idx] = first_row[np.searchsorted(uniq, sub)]
            self._dom[key] = d
        return d

    def keys_ok(self, keys: tuple) -> np.ndarray:
        """bool [N]: node is in the snapshot AND carries every key."""
        ok = self._keys_ok.get(keys)
        if ok is None:
            N = self.state.dims.nodes
            ok = np.zeros((N,), bool)
            ok[self._order_idx] = True
            for k in keys:
                ok = ok & (self.tv(k) != 0)
            self._keys_ok[keys] = ok
        return ok

    def value_ids(self, key: str, values: dict, dtype=np.int64) -> dict:
        """{interned label_kv(key, value): v} for a value-string-keyed
        count/score dict (the seeding surfaces are keyed by raw label
        values; the vectorized gather wants interned ids)."""
        intern = self.state.interner.label_kv
        return {intern(key, val): v for val, v in values.items()}
