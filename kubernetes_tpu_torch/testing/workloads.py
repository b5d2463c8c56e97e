"""Trace-driven gang workload generator: the LLM-traffic suite.

Counterpart of kubernetes_tpu/testing/workloads.py (the gang specs and the
trace; the open-loop arrival processes belong with the streaming
pipeline). Gang traffic is LLM training jobs that need
topology-contiguous slices, co-located inference pods sharing the
cluster, and priority preemption of gangs by gangs (Topology-aware
Preemptive Scheduling for Co-located LLM Workloads, arXiv:2411.11560).
The generator stamps that traffic DETERMINISTICALLY (seeded numpy RNG):
the same seed gives the same names, specs and arrival order as the JAX
package's generator, so the smoke run and the parity tests draw the same
scenarios from both.

Gang members share their prototype's spec OBJECT (api/types.py aliasing
contract), which is what makes the builder's identity signature cache hit
— a 512-member training gang is one signature row, one device surface.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from ..api.types import ObjectMeta, Pod, PodGroup, PodStatus, Workload, _shallow
from .wrappers import _counter, make_pod


@dataclass(frozen=True)
class GangSpec:
    """One gang's shape: `ref` is the workload ref its members carry."""

    name: str
    size: int
    min_count: int
    cpu: str
    memory: str
    priority: int

    @property
    def ref(self) -> str:
        return self.name


class GangWorkloadGenerator:
    """Seeded generator of gang-shaped traffic (see module docstring)."""

    def __init__(self, seed: int = 0):
        self.rng = np.random.RandomState(seed)
        self._pod_seq = 0

    # -- specs -----------------------------------------------------------------

    def training_gangs(self, count: int, size=(8, 512),
                       min_count_frac: float = 1.0, cpu: str = "900m",
                       memory: str = "1Gi", priority: int = 0,
                       prefix: str = "train") -> list[GangSpec]:
        """Training gangs with min-count semantics. `size` is either a
        fixed member count or a (lo, hi) range sampled log-uniformly —
        real training fleets mix 8-chip probes with 512-chip jobs, and
        log-uniform is the only draw that exercises both decades."""
        specs = []
        for i in range(count):
            if isinstance(size, tuple):
                lo, hi = size
                g = int(round(2 ** self.rng.uniform(math.log2(lo),
                                                    math.log2(hi))))
                g = max(min(g, hi), lo)
            else:
                g = int(size)
            mc = max(1, min(g, int(round(g * min_count_frac))))
            specs.append(GangSpec(name=f"{prefix}-{i}", size=g, min_count=mc,
                                  cpu=cpu, memory=memory, priority=priority))
        return specs

    # -- object stamping -------------------------------------------------------

    @staticmethod
    def workload(spec: GangSpec) -> Workload:
        return Workload(metadata=ObjectMeta(name=spec.name),
                        pod_groups=[PodGroup(name="workers",
                                             min_count=spec.min_count)])

    def _stamp(self, proto: Pod, name: str) -> Pod:
        """Shallow-clone `proto` with fresh metadata/status — the spec
        object (and with it the signature) is SHARED across the gang."""
        p = _shallow(proto)
        m = _shallow(proto.metadata)
        m.name = name
        m.uid = f"{m.namespace}/{name}"
        m.creation_index = next(_counter)
        p.metadata = m
        p.status = PodStatus()
        return p

    def gang_pods(self, spec: GangSpec) -> list[Pod]:
        proto = (make_pod(f"{spec.name}-proto")
                 .req({"cpu": spec.cpu, "memory": spec.memory})
                 .workload(spec.ref)
                 .priority(spec.priority)
                 .obj())
        out = []
        for _ in range(spec.size):
            self._pod_seq += 1
            out.append(self._stamp(proto, f"{spec.name}-m{self._pod_seq}"))
        return out

    def inference_pods(self, count: int, cpu: str = "250m",
                       memory: str = "256Mi", priority: int = 100,
                       prefix: str = "inf") -> list[Pod]:
        """Co-located inference traffic: small, latency-class pods that
        outrank training gangs (the co-location contract of
        arXiv:2411.11560 — inference preempts training, not vice versa)."""
        proto = (make_pod(f"{prefix}-proto")
                 .req({"cpu": cpu, "memory": memory})
                 .priority(priority)
                 .obj())
        out = []
        for _ in range(count):
            self._pod_seq += 1
            out.append(self._stamp(proto, f"{prefix}-{self._pod_seq}"))
        return out

    # -- traces ----------------------------------------------------------------

    def trace(self, gangs: list[GangSpec],
              inference_count: int = 0,
              inference_cpu: str = "250m",
              inference_priority: int = 100,
              preemptor_gangs: Optional[list[GangSpec]] = None,
              chunk: int = 512) -> Iterator[tuple[str, object]]:
        """Deterministic arrival trace: ("workload", Workload) events for
        every gang up front (the Workload object must exist before its
        members can pass PreEnqueue), then ("pods", [Pod...]) chunks —
        gang arrivals shuffled with inference arrivals interleaved
        between them, preemptor gangs (gangs preempting gangs) last."""
        preemptor_gangs = preemptor_gangs or []
        for spec in (*gangs, *preemptor_gangs):
            yield ("workload", self.workload(spec))
        segments: list[list[Pod]] = [self.gang_pods(s) for s in gangs]
        if inference_count:
            inf = self.inference_pods(inference_count, cpu=inference_cpu,
                                      priority=inference_priority)
            # split the inference stream into as many slices as there are
            # gangs so it arrives co-located, not as one lump
            n_slices = max(len(segments), 1)
            per = max(len(inf) // n_slices, 1)
            slices = [inf[i:i + per] for i in range(0, len(inf), per)]
            merged: list[list[Pod]] = []
            for i, seg in enumerate(segments):
                merged.append(seg)
                if i < len(slices):
                    merged.append(slices[i])
            merged.extend(slices[len(segments):])
            segments = merged
        order = self.rng.permutation(len(segments))
        flat: list[Pod] = []
        for idx in order:
            flat.extend(segments[int(idx)])
        for spec in preemptor_gangs:
            flat.extend(self.gang_pods(spec))
        for i in range(0, len(flat), chunk):
            yield ("pods", flat[i:i + chunk])
