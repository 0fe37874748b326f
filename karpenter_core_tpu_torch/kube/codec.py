"""Kubernetes JSON ↔ dataclass codec for the object kinds the
controllers watch: the wire half of the real-apiserver adapter
(restclient.py). The reference gets this from client-go's generated
deepcopy/scheme machinery (operator.go:105-171); here it is explicit,
stdlib-only translation.

The port's copy of ``karpenter_core_tpu/kube/codec.py``, over the port's
``apis/`` and ``kube/objects.py``.

Quantities: the apiserver speaks strings ("100m", "2Gi"); internally
everything is integer nanos (kube.quantity). Timestamps: RFC3339 ↔
epoch floats. Unknown fields are ignored on decode; encode emits only
what the controllers set.
"""

from __future__ import annotations

import calendar
import time
from typing import Dict, Optional

from ..apis.nodeclaim import (
    Condition,
    KubeletConfiguration,
    NodeClaim,
    NodeClaimResources,
    NodeClaimSpec,
    NodeClassReference,
)
from ..apis.nodepool import (
    Budget,
    Disruption,
    NodeClaimTemplateObjectMeta,
    NodeClaimTemplateSpec,
    NodePool,
)
from .objects import (
    Affinity,
    ConfigMap,
    Container,
    ContainerPort,
    CSINode,
    CSINodeDriver,
    DaemonSet,
    KubeObject,
    LabelSelector,
    LabelSelectorRequirement,
    Lease,
    Namespace,
    Node,
    NodeAffinity,
    NodeSelector,
    NodeSelectorRequirement,
    NodeSelectorTerm,
    PersistentVolume,
    PersistentVolumeClaim,
    Pod,
    PodAffinity,
    PodAffinityTerm,
    PodAntiAffinity,
    PodCondition,
    PodDisruptionBudget,
    PreferredSchedulingTerm,
    ResourceRequirements,
    StorageClass,
    Taint,
    Toleration,
    TopologySpreadConstraint,
    Volume,
    WeightedPodAffinityTerm,
)
from .quantity import format_quantity, parse_quantity

# kind → (api path prefix, plural, namespaced)
API_PATHS: Dict[str, tuple] = {
    "Pod": ("/api/v1", "pods", True),
    "Node": ("/api/v1", "nodes", False),
    "Namespace": ("/api/v1", "namespaces", False),
    "ConfigMap": ("/api/v1", "configmaps", True),
    "PersistentVolumeClaim": ("/api/v1", "persistentvolumeclaims", True),
    "PersistentVolume": ("/api/v1", "persistentvolumes", False),
    "DaemonSet": ("/apis/apps/v1", "daemonsets", True),
    "PodDisruptionBudget": ("/apis/policy/v1", "poddisruptionbudgets", True),
    "StorageClass": ("/apis/storage.k8s.io/v1", "storageclasses", False),
    "CSINode": ("/apis/storage.k8s.io/v1", "csinodes", False),
    "Lease": ("/apis/coordination.k8s.io/v1", "leases", True),
    "NodePool": ("/apis/karpenter.sh/v1beta1", "nodepools", False),
    "NodeClaim": ("/apis/karpenter.sh/v1beta1", "nodeclaims", False),
}


# kind → dataclass (ghost objects for relist-diff DELETED events, etc.)
OBJECT_TYPES: Dict[str, type] = {
    "Pod": Pod,
    "Node": Node,
    "Namespace": Namespace,
    "ConfigMap": ConfigMap,
    "PersistentVolumeClaim": PersistentVolumeClaim,
    "PersistentVolume": PersistentVolume,
    "DaemonSet": DaemonSet,
    "PodDisruptionBudget": PodDisruptionBudget,
    "StorageClass": StorageClass,
    "CSINode": CSINode,
    "Lease": Lease,
    "NodePool": NodePool,
    "NodeClaim": NodeClaim,
}


def _ts(value) -> Optional[float]:
    if not value:
        return None
    return float(calendar.timegm(time.strptime(value[:19], "%Y-%m-%dT%H:%M:%S")))


def _rfc3339(ts: Optional[float]) -> Optional[str]:
    if ts is None:
        return None
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(ts))


def _rfc3339_micro(ts: Optional[float]) -> Optional[str]:
    """metav1.MicroTime: the apiserver REQUIRES a six-digit fraction.
    Rounded in integer microseconds so a fraction near 1.0 carries into
    the seconds instead of emitting an invalid 7-digit fraction."""
    if ts is None:
        return None
    secs, micros = divmod(int(round(ts * 1e6)), 10**6)
    return time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(secs)) + f".{micros:06d}Z"


def _resources(d: Optional[dict]) -> dict:
    return {k: parse_quantity(v) for k, v in (d or {}).items()}


def _resources_out(r: dict) -> dict:
    return {k: format_quantity(v) for k, v in (r or {}).items()}


def _selector(d: Optional[dict]) -> Optional[LabelSelector]:
    if d is None:
        return None
    return LabelSelector(
        match_labels=dict(d.get("matchLabels") or {}),
        match_expressions=[
            LabelSelectorRequirement(
                key=e.get("key", ""),
                operator=e.get("operator", "In"),
                values=list(e.get("values") or []),
            )
            for e in d.get("matchExpressions") or []
        ],
    )


def _selector_out(sel: Optional[LabelSelector]) -> Optional[dict]:
    if sel is None:
        return None
    out: dict = {}
    if sel.match_labels:
        out["matchLabels"] = dict(sel.match_labels)
    if sel.match_expressions:
        out["matchExpressions"] = [
            {"key": e.key, "operator": e.operator, "values": list(e.values)}
            for e in sel.match_expressions
        ]
    return out


def _nsr(e: dict) -> NodeSelectorRequirement:
    return NodeSelectorRequirement(
        key=e.get("key", ""),
        operator=e.get("operator", "In"),
        values=list(e.get("values") or []),
    )


def _nsr_out(r: NodeSelectorRequirement) -> dict:
    out = {"key": r.key, "operator": r.operator}
    if r.values:
        out["values"] = list(r.values)
    return out


def _term(d: dict) -> PodAffinityTerm:
    return PodAffinityTerm(
        topology_key=d.get("topologyKey", ""),
        label_selector=_selector(d.get("labelSelector")),
        namespaces=list(d.get("namespaces") or []),
        namespace_selector=_selector(d.get("namespaceSelector")),
    )


def _affinity(d: Optional[dict]) -> Optional[Affinity]:
    if not d:
        return None
    aff = Affinity()
    na = d.get("nodeAffinity")
    if na:
        req = na.get("requiredDuringSchedulingIgnoredDuringExecution")
        aff.node_affinity = NodeAffinity(
            required=(
                NodeSelector(
                    node_selector_terms=[
                        NodeSelectorTerm(
                            match_expressions=[
                                _nsr(e) for e in t.get("matchExpressions") or []
                            ]
                        )
                        for t in req.get("nodeSelectorTerms") or []
                    ]
                )
                if req
                else None
            ),
            preferred=[
                PreferredSchedulingTerm(
                    weight=p.get("weight", 1),
                    preference=NodeSelectorTerm(
                        match_expressions=[
                            _nsr(e)
                            for e in (p.get("preference") or {}).get("matchExpressions")
                            or []
                        ]
                    ),
                )
                for p in na.get("preferredDuringSchedulingIgnoredDuringExecution") or []
            ],
        )
    for key, cls, attr in (
        ("podAffinity", PodAffinity, "pod_affinity"),
        ("podAntiAffinity", PodAntiAffinity, "pod_anti_affinity"),
    ):
        pa = d.get(key)
        if pa:
            setattr(
                aff,
                attr,
                cls(
                    required=[
                        _term(t)
                        for t in pa.get("requiredDuringSchedulingIgnoredDuringExecution")
                        or []
                    ],
                    preferred=[
                        WeightedPodAffinityTerm(
                            weight=w.get("weight", 1),
                            pod_affinity_term=_term(w.get("podAffinityTerm") or {}),
                        )
                        for w in pa.get(
                            "preferredDuringSchedulingIgnoredDuringExecution"
                        )
                        or []
                    ],
                ),
            )
    if aff.node_affinity is None and aff.pod_affinity is None and aff.pod_anti_affinity is None:
        return None
    return aff


def _taints(items) -> list:
    return [
        Taint(key=t.get("key", ""), value=t.get("value", ""), effect=t.get("effect", ""))
        for t in items or []
    ]


def _taints_out(taints) -> list:
    return [{"key": t.key, "value": t.value, "effect": t.effect} for t in taints or []]


def _meta_in(obj: KubeObject, meta: dict) -> None:
    m = obj.metadata
    m.name = meta.get("name", "")
    m.namespace = meta.get("namespace", obj.metadata.namespace)
    m.uid = meta.get("uid", m.uid)
    m.labels = dict(meta.get("labels") or {})
    m.annotations = dict(meta.get("annotations") or {})
    m.finalizers = list(meta.get("finalizers") or [])
    rv = meta.get("resourceVersion")
    if rv is not None:
        try:
            m.resource_version = int(rv)
        except ValueError:
            m.resource_version = 0
    m.generation = meta.get("generation", 1)
    ct = _ts(meta.get("creationTimestamp"))
    if ct is not None:
        m.creation_timestamp = ct
    m.deletion_timestamp = _ts(meta.get("deletionTimestamp"))
    from .objects import OwnerReference

    m.owner_references = [
        OwnerReference(
            api_version=o.get("apiVersion", ""),
            kind=o.get("kind", ""),
            name=o.get("name", ""),
            uid=o.get("uid", ""),
            controller=o.get("controller", False),
            block_owner_deletion=o.get("blockOwnerDeletion", False),
        )
        for o in meta.get("ownerReferences") or []
    ]


def _meta_out(obj: KubeObject) -> dict:
    m = obj.metadata
    out: dict = {"name": m.name}
    if m.namespace:
        out["namespace"] = m.namespace
    if m.labels:
        out["labels"] = dict(m.labels)
    if m.annotations:
        out["annotations"] = dict(m.annotations)
    # ALWAYS present: merge-patch replaces lists wholesale, so clearing
    # the last finalizer must send [] (omission would leave it in place)
    out["finalizers"] = list(m.finalizers)
    if m.resource_version:
        out["resourceVersion"] = str(m.resource_version)
    if m.owner_references:
        out["ownerReferences"] = [
            {
                "apiVersion": o.api_version,
                "kind": o.kind,
                "name": o.name,
                "uid": o.uid,
                "controller": o.controller,
                "blockOwnerDeletion": o.block_owner_deletion,
            }
            for o in m.owner_references
        ]
    return out


# -- decoders ---------------------------------------------------------------


def _decode_pod(d: dict) -> Pod:
    pod = Pod()
    spec = d.get("spec") or {}
    pod.spec.node_name = spec.get("nodeName", "")
    pod.spec.node_selector = dict(spec.get("nodeSelector") or {})
    pod.spec.affinity = _affinity(spec.get("affinity"))
    pod.spec.tolerations = [
        Toleration(
            key=t.get("key", ""),
            operator=t.get("operator", "Equal"),
            value=t.get("value", ""),
            effect=t.get("effect", ""),
            toleration_seconds=t.get("tolerationSeconds"),
        )
        for t in spec.get("tolerations") or []
    ]
    pod.spec.topology_spread_constraints = [
        TopologySpreadConstraint(
            max_skew=c.get("maxSkew", 1),
            topology_key=c.get("topologyKey", ""),
            when_unsatisfiable=c.get("whenUnsatisfiable", "DoNotSchedule"),
            label_selector=_selector(c.get("labelSelector")),
            min_domains=c.get("minDomains"),
        )
        for c in spec.get("topologySpreadConstraints") or []
    ]
    for field_name, attr in (("containers", "containers"), ("initContainers", "init_containers")):
        setattr(
            pod.spec,
            attr,
            [
                Container(
                    name=c.get("name", ""),
                    resources=ResourceRequirements(
                        requests=_resources((c.get("resources") or {}).get("requests")),
                        limits=_resources((c.get("resources") or {}).get("limits")),
                    ),
                    ports=[
                        ContainerPort(
                            host_port=p.get("hostPort", 0),
                            container_port=p.get("containerPort", 0),
                            protocol=p.get("protocol", "TCP"),
                            host_ip=p.get("hostIP", ""),
                        )
                        for p in c.get("ports") or []
                    ],
                )
                for c in spec.get(field_name) or []
            ],
        )
    pod.spec.overhead = _resources(spec.get("overhead"))
    pod.spec.volumes = [
        Volume(
            name=v.get("name", ""),
            persistent_volume_claim=(v.get("persistentVolumeClaim") or {}).get("claimName"),
            ephemeral=bool(v.get("ephemeral")),
        )
        for v in spec.get("volumes") or []
    ]
    pod.spec.priority = spec.get("priority")
    pod.spec.priority_class_name = spec.get("priorityClassName", "")
    pod.spec.scheduler_name = spec.get("schedulerName", "default-scheduler")
    status = d.get("status") or {}
    pod.status.phase = status.get("phase", "Pending")
    pod.status.conditions = [
        PodCondition(
            type=c.get("type", ""),
            status=c.get("status", ""),
            reason=c.get("reason", ""),
        )
        for c in status.get("conditions") or []
    ]
    start = _ts(status.get("startTime"))
    if start is not None:
        pod.status.start_time = start
    return pod


def _decode_node(d: dict) -> Node:
    node = Node()
    spec = d.get("spec") or {}
    node.spec.provider_id = spec.get("providerID", "")
    node.spec.taints = _taints(spec.get("taints"))
    node.spec.unschedulable = bool(spec.get("unschedulable", False))
    status = d.get("status") or {}
    node.status.capacity = _resources(status.get("capacity"))
    node.status.allocatable = _resources(status.get("allocatable"))
    node.status.phase = status.get("phase", "")
    node.status.conditions = [
        Condition(
            type=c.get("type", ""),
            status=c.get("status", ""),
            reason=c.get("reason", ""),
            message=c.get("message", ""),
            last_transition_time=_ts(c.get("lastTransitionTime")) or 0.0,
        )
        for c in status.get("conditions") or []
    ]
    return node


def _zones_from_node_affinity(d: Optional[dict]) -> list:
    """Zone values from a PV's spec.nodeAffinity required terms."""
    zones = []
    req = (d or {}).get("required") or {}
    for term in req.get("nodeSelectorTerms") or []:
        for e in term.get("matchExpressions") or []:
            if e.get("key") in (
                "topology.kubernetes.io/zone",
                "failure-domain.beta.kubernetes.io/zone",
            ):
                zones.extend(e.get("values") or [])
    return zones


def _decode_nodepool(d: dict) -> NodePool:
    np_ = NodePool()
    spec = d.get("spec") or {}
    tmpl = spec.get("template") or {}
    tmeta = tmpl.get("metadata") or {}
    tspec = tmpl.get("spec") or {}
    np_.spec.template = NodeClaimTemplateSpec(
        metadata=NodeClaimTemplateObjectMeta(
            labels=dict(tmeta.get("labels") or {}),
            annotations=dict(tmeta.get("annotations") or {}),
        ),
        taints=_taints(tspec.get("taints")),
        startup_taints=_taints(tspec.get("startupTaints")),
        requirements=[_nsr(e) for e in tspec.get("requirements") or []],
        kubelet=_decode_kubelet(tspec.get("kubelet")),
        node_class_ref=_decode_class_ref(tspec.get("nodeClassRef")),
    )
    dis = spec.get("disruption") or {}
    np_.spec.disruption = Disruption(
        consolidate_after=_duration(dis.get("consolidateAfter")),
        consolidation_policy=dis.get("consolidationPolicy", "WhenUnderutilized"),
        expire_after=_duration(dis.get("expireAfter")),
        budgets=[
            Budget(
                nodes=str(b.get("nodes", b.get("maxUnavailable", "10%"))),
                schedule=b.get("schedule", b.get("crontab")),
                duration=_duration(b.get("duration")),
            )
            for b in dis.get("budgets") or []
        ],
    )
    np_.spec.limits = _resources(spec.get("limits"))
    np_.spec.weight = spec.get("weight")
    np_.status.resources = _resources((d.get("status") or {}).get("resources"))
    return np_


def _decode_kubelet(d: Optional[dict]) -> Optional[KubeletConfiguration]:
    if not d:
        return None
    return KubeletConfiguration(
        max_pods=d.get("maxPods"),
        pods_per_core=d.get("podsPerCore"),
        system_reserved=_resources(d.get("systemReserved")),
        kube_reserved=_resources(d.get("kubeReserved")),
        eviction_hard=dict(d.get("evictionHard") or {}),
        eviction_soft=dict(d.get("evictionSoft") or {}),
    )


def _decode_class_ref(d: Optional[dict]) -> Optional[NodeClassReference]:
    if not d:
        return None
    return NodeClassReference(
        name=d.get("name", ""), kind=d.get("kind", ""), api_version=d.get("apiVersion", "")
    )


def _duration(v) -> Optional[float]:
    """metav1.Duration string / 'Never' → seconds."""
    if v is None or v == "Never":
        return None
    if isinstance(v, (int, float)):
        return float(v)
    total, num = 0.0, ""
    for ch in str(v):
        if ch.isdigit() or ch == ".":
            num += ch
        else:
            mult = {"h": 3600.0, "m": 60.0, "s": 1.0}.get(ch)
            if mult is None or not num:
                return None
            total += float(num) * mult
            num = ""
    return total


def _duration_out(seconds: Optional[float]) -> Optional[str]:
    if seconds is None:
        return "Never"
    out = ""
    rest = int(seconds)
    for unit, mult in (("h", 3600), ("m", 60), ("s", 1)):
        n, rest = divmod(rest, mult)
        if n:
            out += f"{n}{unit}"
    return out or "0s"


def _decode_nodeclaim(d: dict) -> NodeClaim:
    nc = NodeClaim()
    spec = d.get("spec") or {}
    nc.spec = NodeClaimSpec(
        taints=_taints(spec.get("taints")),
        startup_taints=_taints(spec.get("startupTaints")),
        requirements=[_nsr(e) for e in spec.get("requirements") or []],
        resources=NodeClaimResources(
            requests=_resources((spec.get("resources") or {}).get("requests"))
        ),
        kubelet=_decode_kubelet(spec.get("kubelet")),
        node_class_ref=_decode_class_ref(spec.get("nodeClassRef")),
    )
    status = d.get("status") or {}
    nc.status.node_name = status.get("nodeName", "")
    nc.status.provider_id = status.get("providerID", "")
    nc.status.image_id = status.get("imageID", "")
    nc.status.capacity = _resources(status.get("capacity"))
    nc.status.allocatable = _resources(status.get("allocatable"))
    nc.status.conditions = [
        Condition(
            type=c.get("type", ""),
            status=c.get("status", ""),
            reason=c.get("reason", ""),
            message=c.get("message", ""),
            last_transition_time=_ts(c.get("lastTransitionTime")) or 0.0,
        )
        for c in status.get("conditions") or []
    ]
    return nc


def _term_out(t: PodAffinityTerm) -> dict:
    out: dict = {"topologyKey": t.topology_key}
    if t.label_selector is not None:
        out["labelSelector"] = _selector_out(t.label_selector)
    if t.namespaces:
        out["namespaces"] = list(t.namespaces)
    if t.namespace_selector is not None:
        out["namespaceSelector"] = _selector_out(t.namespace_selector)
    return out


def _affinity_out(aff: Optional[Affinity]) -> Optional[dict]:
    if aff is None:
        return None
    out: dict = {}
    na = aff.node_affinity
    if na is not None:
        node: dict = {}
        if na.required is not None:
            node["requiredDuringSchedulingIgnoredDuringExecution"] = {
                "nodeSelectorTerms": [
                    {"matchExpressions": [_nsr_out(e) for e in t.match_expressions]}
                    for t in na.required.node_selector_terms
                ]
            }
        if na.preferred:
            node["preferredDuringSchedulingIgnoredDuringExecution"] = [
                {
                    "weight": p.weight,
                    "preference": {
                        "matchExpressions": [
                            _nsr_out(e) for e in p.preference.match_expressions
                        ]
                    },
                }
                for p in na.preferred
            ]
        out["nodeAffinity"] = node
    for attr, key in (
        ("pod_affinity", "podAffinity"),
        ("pod_anti_affinity", "podAntiAffinity"),
    ):
        pa = getattr(aff, attr)
        if pa is not None:
            out[key] = {
                "requiredDuringSchedulingIgnoredDuringExecution": [
                    _term_out(t) for t in pa.required
                ],
                "preferredDuringSchedulingIgnoredDuringExecution": [
                    {"weight": w.weight, "podAffinityTerm": _term_out(w.pod_affinity_term)}
                    for w in pa.preferred
                ],
            }
    return out or None


def _encode_pod_spec(spec) -> dict:
    out: dict = {
        "containers": [
            {
                "name": c.name,
                "resources": {
                    "requests": _resources_out(c.resources.requests),
                    "limits": _resources_out(c.resources.limits),
                },
                "ports": [
                    {
                        "hostPort": p.host_port,
                        "containerPort": p.container_port,
                        "protocol": p.protocol,
                    }
                    for p in c.ports
                ],
            }
            for c in spec.containers
        ],
    }
    if spec.node_name:
        out["nodeName"] = spec.node_name
    if spec.node_selector:
        out["nodeSelector"] = dict(spec.node_selector)
    aff = _affinity_out(spec.affinity)
    if aff:
        out["affinity"] = aff
    if spec.tolerations:
        out["tolerations"] = [
            {
                "key": t.key,
                "operator": t.operator,
                "value": t.value,
                "effect": t.effect,
            }
            for t in spec.tolerations
        ]
    if spec.topology_spread_constraints:
        out["topologySpreadConstraints"] = [
            {
                "maxSkew": c.max_skew,
                "topologyKey": c.topology_key,
                "whenUnsatisfiable": c.when_unsatisfiable,
                **(
                    {"labelSelector": _selector_out(c.label_selector)}
                    if c.label_selector is not None
                    else {}
                ),
                **({"minDomains": c.min_domains} if c.min_domains is not None else {}),
            }
            for c in spec.topology_spread_constraints
        ]
    if spec.volumes:
        vols = []
        for v in spec.volumes:
            if v.persistent_volume_claim:
                vols.append(
                    {
                        "name": v.name,
                        "persistentVolumeClaim": {"claimName": v.persistent_volume_claim},
                    }
                )
            elif v.ephemeral:
                # minimal generic-ephemeral marker so the flag round-trips
                vols.append(
                    {"name": v.name, "ephemeral": {"volumeClaimTemplate": {"spec": {}}}}
                )
            else:
                # a source-less volume is invalid on the wire
                vols.append({"name": v.name, "emptyDir": {}})
        out["volumes"] = vols
    if spec.overhead:
        out["overhead"] = _resources_out(spec.overhead)
    if spec.priority is not None:
        out["priority"] = spec.priority
    return out


def from_k8s(kind: str, d: dict) -> KubeObject:
    """Decode one apiserver JSON object into the internal dataclass."""
    decoders = {
        "Pod": _decode_pod,
        "Node": _decode_node,
        "NodePool": _decode_nodepool,
        "NodeClaim": _decode_nodeclaim,
    }
    dec = decoders.get(kind)
    if dec is not None:
        obj = dec(d)
    elif kind == "DaemonSet":
        obj = DaemonSet()
        tmpl = ((d.get("spec") or {}).get("template") or {}).get("spec") or {}
        obj.pod_template_spec = _decode_pod({"spec": tmpl}).spec
    elif kind == "PodDisruptionBudget":
        spec = d.get("spec") or {}
        status = d.get("status") or {}
        obj = PodDisruptionBudget(
            selector=_selector(spec.get("selector")) or LabelSelector(),
            min_available=_intstr(spec.get("minAvailable")),
            max_unavailable=_intstr(spec.get("maxUnavailable")),
            disruptions_allowed=status.get("disruptionsAllowed", 0),
        )
    elif kind == "PersistentVolumeClaim":
        spec = d.get("spec") or {}
        obj = PersistentVolumeClaim()
        obj.storage_class_name = spec.get("storageClassName") or ""
        obj.volume_name = spec.get("volumeName", "")
    elif kind == "PersistentVolume":
        spec = d.get("spec") or {}
        obj = PersistentVolume()
        obj.driver = ((spec.get("csi") or {}).get("driver")) or ""
        obj.zones = _zones_from_node_affinity(spec.get("nodeAffinity"))
    elif kind == "StorageClass":
        obj = StorageClass()
        obj.provisioner = d.get("provisioner", "")
        for topo in d.get("allowedTopologies") or []:
            for e in topo.get("matchLabelExpressions") or []:
                if e.get("key") in (
                    "topology.kubernetes.io/zone",
                    "failure-domain.beta.kubernetes.io/zone",
                ):
                    obj.zones.extend(e.get("values") or [])
    elif kind == "CSINode":
        obj = CSINode(
            drivers=[
                CSINodeDriver(
                    name=dr.get("name", ""),
                    allocatable_count=(dr.get("allocatable") or {}).get("count"),
                )
                for dr in (d.get("spec") or {}).get("drivers") or []
            ]
        )
    elif kind == "Lease":
        spec = d.get("spec") or {}
        obj = Lease(
            holder=spec.get("holderIdentity", "") or "",
            lease_duration_seconds=spec.get("leaseDurationSeconds"),
            acquire_time=_ts(spec.get("acquireTime")),
            renew_time=_ts(spec.get("renewTime")),
            lease_transitions=spec.get("leaseTransitions", 0) or 0,
        )
    elif kind == "ConfigMap":
        obj = ConfigMap(data=dict(d.get("data") or {}))
    elif kind == "Namespace":
        obj = Namespace()
    else:
        raise ValueError(f"no decoder for kind {kind!r}")
    _meta_in(obj, d.get("metadata") or {})
    return obj


def _intstr(v):
    """Absolute int-or-string → int; PERCENT values return None so the
    consumer falls back to status.disruptionsAllowed (the PDB controller
    resolves percentages against live matching pods — this codec can't,
    and a bare number would be read as an absolute count)."""
    if v is None:
        return None
    if isinstance(v, int):
        return v
    s = str(v)
    if s.endswith("%"):
        return None
    return int(s)


# -- encoders (the kinds the controllers WRITE) -----------------------------


def to_k8s(obj: KubeObject) -> dict:
    """Encode an internal object for the apiserver. Only kinds the
    controllers create/update need full fidelity; others round-trip
    their metadata (status patches go through dedicated helpers)."""
    kind = obj.kind
    prefix, _, _ = API_PATHS[kind]
    api_version = "v1" if prefix == "/api/v1" else prefix[len("/apis/") :]
    out: dict = {
        "apiVersion": api_version,
        "kind": kind,
        "metadata": _meta_out(obj),
    }
    if kind == "NodeClaim":
        out["spec"] = {
            "taints": _taints_out(obj.spec.taints),
            "startupTaints": _taints_out(obj.spec.startup_taints),
            "requirements": [_nsr_out(r) for r in obj.spec.requirements],
            "resources": {"requests": _resources_out(obj.spec.resources.requests)},
        }
        if obj.spec.node_class_ref is not None:
            out["spec"]["nodeClassRef"] = {
                "name": obj.spec.node_class_ref.name,
                "kind": obj.spec.node_class_ref.kind,
                "apiVersion": obj.spec.node_class_ref.api_version,
            }
        if obj.spec.kubelet is not None:
            k = obj.spec.kubelet
            out["spec"]["kubelet"] = {
                key: value
                for key, value in (
                    ("maxPods", k.max_pods),
                    ("podsPerCore", k.pods_per_core),
                    ("systemReserved", _resources_out(k.system_reserved) or None),
                    ("kubeReserved", _resources_out(k.kube_reserved) or None),
                    ("evictionHard", dict(k.eviction_hard) or None),
                    ("evictionSoft", dict(k.eviction_soft) or None),
                )
                if value is not None
            }
        out["status"] = {
            "nodeName": obj.status.node_name,
            "providerID": obj.status.provider_id,
            "capacity": _resources_out(obj.status.capacity),
            "allocatable": _resources_out(obj.status.allocatable),
            "conditions": [
                {
                    "type": c.type,
                    "status": c.status,
                    "reason": c.reason,
                    "message": c.message,
                    "lastTransitionTime": _rfc3339(c.last_transition_time),
                }
                for c in obj.status.conditions
            ],
        }
    elif kind == "Node":
        out["spec"] = {
            "providerID": obj.spec.provider_id,
            "taints": _taints_out(obj.spec.taints),
            "unschedulable": obj.spec.unschedulable,
        }
    elif kind == "Lease":
        out["spec"] = {
            "holderIdentity": obj.holder,
            "leaseDurationSeconds": obj.lease_duration_seconds,
            "acquireTime": _rfc3339_micro(obj.acquire_time),
            "renewTime": _rfc3339_micro(obj.renew_time),
            "leaseTransitions": obj.lease_transitions,
        }
    elif kind == "ConfigMap":
        out["data"] = dict(obj.data)
    elif kind == "Pod":
        out["spec"] = _encode_pod_spec(obj.spec)
        out["status"] = {
            "phase": obj.status.phase,
            "conditions": [
                {"type": c.type, "status": c.status, "reason": c.reason}
                for c in obj.status.conditions
            ],
            **(
                {"startTime": _rfc3339(obj.status.start_time)}
                if obj.status.start_time is not None
                else {}
            ),
        }
    elif kind == "NodePool":
        out["spec"] = {
            "template": {
                "metadata": {
                    "labels": dict(obj.spec.template.metadata.labels),
                    "annotations": dict(obj.spec.template.metadata.annotations),
                },
                "spec": {
                    "taints": _taints_out(obj.spec.template.taints),
                    "startupTaints": _taints_out(obj.spec.template.startup_taints),
                    "requirements": [
                        _nsr_out(r) for r in obj.spec.template.requirements
                    ],
                },
            },
            "disruption": {
                "consolidationPolicy": obj.spec.disruption.consolidation_policy,
                "consolidateAfter": _duration_out(obj.spec.disruption.consolidate_after),
                "expireAfter": _duration_out(obj.spec.disruption.expire_after),
                "budgets": [
                    {
                        "nodes": b.nodes,
                        **({"schedule": b.schedule} if b.schedule else {}),
                        **(
                            {"duration": _duration_out(b.duration)}
                            if b.duration is not None
                            else {}
                        ),
                    }
                    for b in obj.spec.disruption.budgets
                ],
            },
            "limits": _resources_out(obj.spec.limits),
            **({"weight": obj.spec.weight} if obj.spec.weight is not None else {}),
        }
        out["status"] = {"resources": _resources_out(obj.status.resources)}
    return out
