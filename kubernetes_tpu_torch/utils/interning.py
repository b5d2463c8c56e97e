"""String interning — the bridge from Kubernetes' stringly-typed label world
to fixed-width integer tensors.

Every label key, key=value pair, taint, topology value and port tuple is
interned to a dense positive int32 id. Selector evaluation on device then
reduces to integer equality against padded id arrays. Id 0 is reserved as
"empty/padding" everywhere, so masks can test `ids != 0`.

This replaces the reference's ubiquitous `labels.Selector.Matches` string
matching (apimachinery labels/selector.go) on the hot path; the host keeps
the strings for the slow/generic fallback paths (Gt/Lt node selectors etc.).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class InternTable:
    """Dense interner. Ids start at 1; 0 means empty."""

    index: dict[str, int] = field(default_factory=dict)
    strings: list[str] = field(default_factory=lambda: [""])

    def intern(self, s: str) -> int:
        i = self.index.get(s)
        if i is None:
            i = len(self.strings)
            self.index[s] = i
            self.strings.append(s)
        return i

    def lookup(self, s: str) -> int:
        """0 if never interned (never matches anything on device)."""
        return self.index.get(s, 0)

    def string(self, i: int) -> str:
        return self.strings[i]

    def __len__(self) -> int:
        return len(self.strings)


@dataclass
class ClusterInterner:
    """All intern tables used to tensorize cluster state."""

    # "key=value" pairs for labels (nodes and pods share one table)
    kv: InternTable = field(default_factory=InternTable)
    # bare label keys (Exists / DoesNotExist / topology keys)
    key: InternTable = field(default_factory=InternTable)
    # taint/toleration "key=value" and keys reuse kv/key tables
    # topology VALUES per topology key: interned as "key\x00value" in kv —
    # cheap and collision-free.
    # namespaces
    namespace: InternTable = field(default_factory=InternTable)
    # image names
    image: InternTable = field(default_factory=InternTable)

    def label_kv(self, k: str, v: str) -> int:
        return self.kv.intern(f"{k}={v}")

    def label_kv_lookup(self, k: str, v: str) -> int:
        return self.kv.lookup(f"{k}={v}")

    def label_key(self, k: str) -> int:
        return self.key.intern(k)

    def label_key_lookup(self, k: str) -> int:
        return self.key.lookup(k)

    def topo_value(self, key: str, value: str) -> int:
        return self.kv.intern(f"{key}\x00{value}")

    def port_id(self, protocol: str, port: int) -> int:
        return self.kv.intern(f"port:{protocol}:{port}")

    def ip_id(self, ip: str) -> int:
        # 0.0.0.0 and "" are the wildcard; give them id 0 so device code can
        # treat wildcard as "matches everything".
        if ip in ("", "0.0.0.0"):
            return 0
        return self.kv.intern(f"ip:{ip}")
