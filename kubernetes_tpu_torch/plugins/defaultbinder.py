"""DefaultBinder bind plugin.

Parity with reference pkg/scheduler/framework/plugins/defaultbinder/
default_binder.go:51: POST the Binding subresource — here a call into the
API client's `bind` (routed through the async dispatcher when enabled,
mirroring the APICacher path).
"""

from __future__ import annotations

from ..api.types import Pod
from ..framework.interface import CycleState, Status

NAME = "DefaultBinder"


class DefaultBinder:
    """B — reference default_binder.go."""

    def __init__(self, client):
        self.client = client

    def name(self) -> str:
        return NAME

    def bind(self, state: CycleState, pod: Pod, node_name: str) -> Status:
        try:
            self.client.bind(pod, node_name)
        except Exception as e:  # API failure surfaces as Error status
            return Status.error(str(e), plugin=NAME)
        return Status.success()
