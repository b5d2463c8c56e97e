"""Fluent test builders (reference: pkg/scheduler/testing/wrappers.go
`st.MakePod()` / `st.MakeNode()`)."""

from __future__ import annotations

import itertools
from typing import Optional

from ..api import resources as res
from ..api.types import (Affinity, Container, ContainerPort, LabelSelector,
                         LabelSelectorRequirement, Node, NodeAffinity,
                         NodeSelector, NodeSelectorTerm, NodeSpec, NodeStatus,
                         ObjectMeta, Pod, PodAffinity, PodAffinityTerm,
                         PodAntiAffinity, PodSchedulingGate, PodSpec,
                         PodStatus, PreferredSchedulingTerm, Taint,
                         Toleration, TopologySpreadConstraint,
                         WeightedPodAffinityTerm)

_counter = itertools.count()


class PodWrapper:
    def __init__(self, name: str = "", namespace: str = "default"):
        idx = next(_counter)
        self.pod = Pod(
            metadata=ObjectMeta(name=name or f"pod-{idx}", namespace=namespace,
                                creation_index=idx),
            spec=PodSpec(containers=[Container(name="c0")]),
            status=PodStatus(),
        )

    def obj(self) -> Pod:
        return self.pod

    def name(self, n: str) -> "PodWrapper":
        self.pod.metadata.name = n
        self.pod.metadata.uid = f"{self.pod.metadata.namespace}/{n}"
        return self

    def namespace(self, ns: str) -> "PodWrapper":
        self.pod.metadata.namespace = ns
        self.pod.metadata.uid = f"{ns}/{self.pod.metadata.name}"
        return self

    def uid(self, uid: str) -> "PodWrapper":
        self.pod.metadata.uid = uid
        return self

    def label(self, k: str, v: str) -> "PodWrapper":
        self.pod.metadata.labels[k] = v
        return self

    def labels(self, d: dict[str, str]) -> "PodWrapper":
        self.pod.metadata.labels.update(d)
        return self

    def req(self, requests: dict[str, str | int]) -> "PodWrapper":
        """st.MakePod().Req(...): sets container 0 requests."""
        self.pod.spec.containers[0].requests = res.parse_resource_dict(requests)
        return self

    def container(self, requests: dict[str, str | int], image: str = "") -> "PodWrapper":
        self.pod.spec.containers.append(
            Container(name=f"c{len(self.pod.spec.containers)}",
                      requests=res.parse_resource_dict(requests), image=image))
        return self

    def init_req(self, requests: dict[str, str | int]) -> "PodWrapper":
        self.pod.spec.init_containers.append(
            Container(name=f"init{len(self.pod.spec.init_containers)}",
                      requests=res.parse_resource_dict(requests)))
        return self

    def overhead(self, requests: dict[str, str | int]) -> "PodWrapper":
        self.pod.spec.overhead = res.parse_resource_dict(requests)
        return self

    def node(self, node_name: str) -> "PodWrapper":
        self.pod.spec.node_name = node_name
        return self

    def priority(self, p: int) -> "PodWrapper":
        self.pod.spec.priority = p
        return self

    def scheduler_name(self, n: str) -> "PodWrapper":
        self.pod.spec.scheduler_name = n
        return self

    def node_selector(self, sel: dict[str, str]) -> "PodWrapper":
        self.pod.spec.node_selector = dict(sel)
        return self

    def toleration(self, key: str = "", operator: str = "Equal", value: str = "",
                   effect: str = "") -> "PodWrapper":
        self.pod.spec.tolerations.append(
            Toleration(key=key, operator=operator, value=value, effect=effect))
        return self

    def host_port(self, port: int, protocol: str = "TCP", ip: str = "") -> "PodWrapper":
        c = self.pod.spec.containers[0]
        self.pod.spec.containers[0] = Container(
            name=c.name, requests=c.requests, limits=c.limits, image=c.image,
            ports=c.ports + (ContainerPort(host_port=port, protocol=protocol, host_ip=ip),))
        return self

    def scheduling_gate(self, name: str) -> "PodWrapper":
        self.pod.spec.scheduling_gates.append(PodSchedulingGate(name))
        return self

    def pvc(self, claim_name: str, volume_name: str = "") -> "PodWrapper":
        from ..api.types import Volume
        self.pod.spec.volumes.append(Volume(
            name=volume_name or f"vol-{len(self.pod.spec.volumes)}",
            claim_name=claim_name))
        return self

    def csi_volume(self, driver: str) -> "PodWrapper":
        from ..api.types import Volume
        self.pod.spec.volumes.append(Volume(
            name=f"vol-{len(self.pod.spec.volumes)}", csi_driver=driver))
        return self

    def require_features(self, *features: str) -> "PodWrapper":
        self.pod.spec.required_node_features = tuple(features)
        return self

    def claim(self, *names: str) -> "PodWrapper":
        """DRA: reference ResourceClaims by name (same namespace)."""
        self.pod.spec.resource_claims = self.pod.spec.resource_claims + names
        return self

    def workload(self, ref: str) -> "PodWrapper":
        self.pod.spec.workload_ref = ref
        return self

    def _ensure_affinity(self) -> Affinity:
        if self.pod.spec.affinity is None:
            self.pod.spec.affinity = Affinity()
        return self.pod.spec.affinity

    def node_affinity_in(self, key: str, values: list[str]) -> "PodWrapper":
        aff = self._ensure_affinity()
        term = NodeSelectorTerm(match_expressions=(
            LabelSelectorRequirement(key, "In", tuple(values)),))
        na = aff.node_affinity or NodeAffinity()
        existing = na.required.terms if na.required else ()
        self.pod.spec.affinity = Affinity(
            node_affinity=NodeAffinity(required=NodeSelector(existing + (term,)),
                                       preferred=na.preferred),
            pod_affinity=aff.pod_affinity, pod_anti_affinity=aff.pod_anti_affinity)
        return self

    def preferred_node_affinity_in(self, key: str, values: list[str], weight: int) -> "PodWrapper":
        aff = self._ensure_affinity()
        term = PreferredSchedulingTerm(weight, NodeSelectorTerm(match_expressions=(
            LabelSelectorRequirement(key, "In", tuple(values)),)))
        na = aff.node_affinity or NodeAffinity()
        self.pod.spec.affinity = Affinity(
            node_affinity=NodeAffinity(required=na.required,
                                       preferred=na.preferred + (term,)),
            pod_affinity=aff.pod_affinity, pod_anti_affinity=aff.pod_anti_affinity)
        return self

    def pod_affinity(self, topology_key: str, labels: dict[str, str],
                     anti: bool = False, namespaces: tuple[str, ...] = ()) -> "PodWrapper":
        aff = self._ensure_affinity()
        term = PodAffinityTerm(topology_key=topology_key,
                               label_selector=LabelSelector.of(labels),
                               namespaces=namespaces)
        if anti:
            pa = aff.pod_anti_affinity or PodAntiAffinity()
            new = PodAntiAffinity(required=pa.required + (term,), preferred=pa.preferred)
            self.pod.spec.affinity = Affinity(aff.node_affinity, aff.pod_affinity, new)
        else:
            pa = aff.pod_affinity or PodAffinity()
            new = PodAffinity(required=pa.required + (term,), preferred=pa.preferred)
            self.pod.spec.affinity = Affinity(aff.node_affinity, new, aff.pod_anti_affinity)
        return self

    def preferred_pod_affinity(self, topology_key: str, labels: dict[str, str],
                               weight: int, anti: bool = False) -> "PodWrapper":
        aff = self._ensure_affinity()
        wterm = WeightedPodAffinityTerm(weight, PodAffinityTerm(
            topology_key=topology_key, label_selector=LabelSelector.of(labels)))
        if anti:
            pa = aff.pod_anti_affinity or PodAntiAffinity()
            new = PodAntiAffinity(required=pa.required, preferred=pa.preferred + (wterm,))
            self.pod.spec.affinity = Affinity(aff.node_affinity, aff.pod_affinity, new)
        else:
            pa = aff.pod_affinity or PodAffinity()
            new = PodAffinity(required=pa.required, preferred=pa.preferred + (wterm,))
            self.pod.spec.affinity = Affinity(aff.node_affinity, new, aff.pod_anti_affinity)
        return self

    def spread_constraint(self, max_skew: int, topology_key: str,
                          when_unsatisfiable: str, labels: dict[str, str],
                          min_domains: Optional[int] = None) -> "PodWrapper":
        self.pod.spec.topology_spread_constraints.append(TopologySpreadConstraint(
            max_skew=max_skew, topology_key=topology_key,
            when_unsatisfiable=when_unsatisfiable,
            label_selector=LabelSelector.of(labels), min_domains=min_domains))
        return self


class NodeWrapper:
    def __init__(self, name: str = ""):
        idx = next(_counter)
        self.node_obj = Node(metadata=ObjectMeta(name=name or f"node-{idx}",
                                                 creation_index=idx))
        self.capacity({"cpu": "32", "memory": "64Gi", "pods": 110,
                       "ephemeral-storage": "100Gi"})

    def obj(self) -> Node:
        return self.node_obj

    def name(self, n: str) -> "NodeWrapper":
        self.node_obj.metadata.name = n
        self.node_obj.metadata.uid = f"/{n}"
        return self

    def label(self, k: str, v: str) -> "NodeWrapper":
        self.node_obj.metadata.labels[k] = v
        return self

    def capacity(self, caps: dict[str, str | int]) -> "NodeWrapper":
        parsed = res.parse_resource_dict(caps)
        self.node_obj.status.capacity.update(parsed)
        self.node_obj.status.allocatable.update(parsed)
        return self

    def allocatable(self, caps: dict[str, str | int]) -> "NodeWrapper":
        self.node_obj.status.allocatable.update(res.parse_resource_dict(caps))
        return self

    def taint(self, key: str, value: str = "", effect: str = "NoSchedule") -> "NodeWrapper":
        self.node_obj.spec.taints.append(Taint(key=key, value=value, effect=effect))
        return self

    def declare_features(self, *features: str) -> "NodeWrapper":
        self.node_obj.status.declared_features = tuple(features)
        return self

    def unschedulable(self, v: bool = True) -> "NodeWrapper":
        self.node_obj.spec.unschedulable = v
        return self

    def image(self, name: str, size_bytes: int) -> "NodeWrapper":
        from ..api.types import ContainerImage
        self.node_obj.status.images.append(
            ContainerImage(names=(name,), size_bytes=size_bytes))
        return self

    def zone(self, zone: str) -> "NodeWrapper":
        return self.label("topology.kubernetes.io/zone", zone)


def make_pod(name: str = "", namespace: str = "default") -> PodWrapper:
    return PodWrapper(name, namespace)


def make_node(name: str = "") -> NodeWrapper:
    return NodeWrapper(name)
