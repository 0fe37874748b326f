"""Host-port conflict tracking (ref pkg/scheduling/hostportusage.go), the
port's copy of ``karpenter_core_tpu/scheduling/hostports.py``: the usage a
``StateNode`` holds, which the solve's port columns read."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..kube.objects import Pod

UNSPECIFIED = ("0.0.0.0", "::")


@dataclass(frozen=True)
class HostPort:
    ip: str
    port: int
    protocol: str

    def matches(self, rhs: "HostPort") -> bool:
        """Same proto+port; IPs conflict if equal or either is unspecified
        (hostportusage.go:49)."""
        if self.protocol != rhs.protocol or self.port != rhs.port:
            return False
        return self.ip == rhs.ip or self.ip in UNSPECIFIED or rhs.ip in UNSPECIFIED

    def __str__(self) -> str:
        return f"IP={self.ip} Port={self.port} Proto={self.protocol}"


def get_host_ports(pod: Pod) -> List[HostPort]:
    """Extract HostPorts from containers; empty hostIP defaults to 0.0.0.0
    (hostportusage.go:93 GetHostPorts)."""
    usage = []
    for c in pod.spec.containers:
        for p in c.ports:
            if p.host_port == 0:
                continue
            usage.append(HostPort(ip=p.host_ip or "0.0.0.0", port=p.host_port, protocol=p.protocol))
    return usage


class HostPortUsage:
    """Per-node reservation map keyed by pod (hostportusage.go:34)."""

    def __init__(self) -> None:
        self.reserved: Dict[Tuple[str, str], List[HostPort]] = {}

    def add(self, pod: Pod, ports: List[HostPort]) -> None:
        self.reserved[(pod.namespace, pod.name)] = ports

    def conflicts(self, pod: Pod, ports: List[HostPort]) -> Optional[str]:
        key = (pod.namespace, pod.name)
        for new_entry in ports:
            for pod_key, entries in self.reserved.items():
                if pod_key == key:
                    continue
                for existing in entries:
                    if new_entry.matches(existing):
                        return f"{new_entry} conflicts with existing HostPort configuration {existing}"
        return None

    def delete_pod(self, namespace: str, name: str) -> None:
        self.reserved.pop((namespace, name), None)

    def copy(self) -> "HostPortUsage":
        out = HostPortUsage()
        # flat copy sharing the port lists: add() assigns a key's list
        # whole and nothing appends in place, so per-entry list copies
        # would be pure cost
        out.reserved = dict(self.reserved)
        return out
