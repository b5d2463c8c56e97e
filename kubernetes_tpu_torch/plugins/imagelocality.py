"""ImageLocality score plugin (host/oracle path).

Parity with reference pkg/scheduler/framework/plugins/imagelocality/
image_locality.go: score = MaxNodeScore·(clamp(Σ scaled image sizes) −
minThreshold)/(maxThreshold − minThreshold), where each present image
contributes size·(numNodesWithImage/totalNodes) (image_locality.go:95-131),
and image names are normalized with an implicit ":latest" tag
(image_locality.go:138-143).

Tensor form: a (nodes × images) size matrix dotted with the pod's image
indicator vector — see ops/program.py.
"""

from __future__ import annotations

from ..api.types import Pod
from ..framework.interface import MAX_NODE_SCORE, CycleState, Status
from ..framework.types import NodeInfo

NAME = "ImageLocality"

MB = 1024 * 1024
MIN_THRESHOLD = 23 * MB
MAX_CONTAINER_THRESHOLD = 1000 * MB

_PRE_SCORE_KEY = "PreScore" + NAME


def normalized_image_name(name: str) -> str:
    if name.rfind(":") <= name.rfind("/"):
        name = name + ":latest"
    return name


def calculate_priority(sum_scores: int, num_containers: int) -> int:
    max_threshold = MAX_CONTAINER_THRESHOLD * num_containers
    if sum_scores < MIN_THRESHOLD:
        sum_scores = MIN_THRESHOLD
    elif sum_scores > max_threshold:
        sum_scores = max_threshold
    return MAX_NODE_SCORE * (sum_scores - MIN_THRESHOLD) // (max_threshold - MIN_THRESHOLD)


class ImageLocality:
    """S, Sg — reference image_locality.go. NumNodes per image comes from a
    PreScore pass over the node list (the reference maintains the same
    aggregate in the cache's imageStates, cache.go)."""

    def name(self) -> str:
        return NAME

    def pre_score(self, state: CycleState, pod: Pod, nodes: list[NodeInfo],
                  all_nodes=None) -> Status:
        pool = all_nodes if all_nodes is not None else nodes
        num_nodes_with: dict[str, int] = {}
        for ni in pool:
            for img in ni.image_sizes:
                num_nodes_with[img] = num_nodes_with.get(img, 0) + 1
        state.write(_PRE_SCORE_KEY, (num_nodes_with, len(pool)))
        return Status.success()

    def score(self, state: CycleState, pod: Pod, node_info: NodeInfo
              ) -> tuple[int, Status]:
        pre = state.read_or_none(_PRE_SCORE_KEY)
        if pre is None:
            num_nodes_with, total = {}, 1
        else:
            num_nodes_with, total = pre
        total = max(total, 1)
        containers = list(pod.spec.init_containers) + list(pod.spec.containers)
        total_sum = 0
        for c in containers:
            img = normalized_image_name(c.image)
            size = node_info.image_sizes.get(img)
            if size is not None:
                spread = num_nodes_with.get(img, 1) / total
                total_sum += int(size * spread)
        if not containers:
            return 0, Status.success()
        return calculate_priority(total_sum, len(containers)), Status.success()

    def normalize_scores(self, state, pod, scores, node_names=None) -> Status:
        return Status.success()

