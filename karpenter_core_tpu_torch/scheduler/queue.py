"""Progress-detecting scheduling queue (ref
pkg/controllers/provisioning/scheduling/queue.go): the port's copy of
``karpenter_core_tpu/scheduler/queue.py``."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..kube.objects import Pod
from ..scheduling import resources


def _sort_key(pod: Pod) -> tuple:
    """CPU then memory descending; creation time + UID for stable ordering
    (queue.go:76 byCPUAndMemoryDescending)."""
    requests = resources.requests_for_pods(pod)
    return (
        -requests.get("cpu", 0),
        -requests.get("memory", 0),
        pod.metadata.creation_timestamp,
        pod.metadata.uid,
    )


class Queue:
    """Pops pods while progress is being made; a pod re-pushed un-relaxed at
    an unchanged queue length means we've cycled without progress
    (queue.go:46-70)."""

    def __init__(self, *pods: Pod):
        self.pods: List[Pod] = sorted(pods, key=_sort_key)
        self.last_len: Dict[str, int] = {}

    def pop(self) -> Tuple[Optional[Pod], bool]:
        if not self.pods:
            return None, False
        pod = self.pods[0]
        if self.last_len.get(pod.uid) == len(self.pods):
            return None, False
        self.pods.pop(0)
        return pod, True

    def push(self, pod: Pod, relaxed: bool) -> None:
        self.pods.append(pod)
        if relaxed:
            self.last_len = {}
        else:
            self.last_len[pod.uid] = len(self.pods)

    def list(self) -> List[Pod]:
        return list(self.pods)
