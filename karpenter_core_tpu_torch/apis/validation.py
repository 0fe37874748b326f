"""Admission validation for NodePool / NodeClaim specs: the port's copy of
``karpenter_core_tpu/apis/validation.py``.

Re-expresses the reference's two validation layers in one place:
the CEL rules stamped on the CRDs (ref pkg/apis/v1beta1/nodepool.go:42-43,
53-54, 63-114 kubebuilder markers) and the webhook/runtime validation
(ref nodepool_validation.go:35-111, nodeclaim_validation.go:71-276).
Errors are collected as strings (field-path prefixed) rather than raised
one at a time, mirroring knative's accumulated FieldError.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

from ..kube.objects import (
    EFFECT_NO_EXECUTE,
    EFFECT_NO_SCHEDULE,
    EFFECT_PREFER_NO_SCHEDULE,
    NodeSelectorRequirement,
    Taint,
)
from ..kube.quantity import parse_quantity
from . import labels as lbl
from .nodeclaim import KubeletConfiguration, NodeClaim, NodeClaimSpec
from .nodepool import (
    CONSOLIDATION_POLICY_WHEN_EMPTY,
    CONSOLIDATION_POLICY_WHEN_UNDERUTILIZED,
    Budget,
    Disruption,
    NodePool,
)

# ref nodeclaim_validation.go:37-44
SUPPORTED_NODE_SELECTOR_OPS = frozenset(
    {"In", "NotIn", "Gt", "Lt", "Exists", "DoesNotExist"}
)
# ref nodeclaim_validation.go:46-51
SUPPORTED_RESERVED_RESOURCES = frozenset({"cpu", "memory", "ephemeral-storage", "pid"})
# ref nodeclaim_validation.go:53-60
SUPPORTED_EVICTION_SIGNALS = frozenset(
    {
        "memory.available",
        "nodefs.available",
        "nodefs.inodesFree",
        "imagefs.available",
        "imagefs.inodesFree",
        "pid.available",
    }
)

_DNS1123_LABEL = re.compile(r"^[a-z0-9]([-a-z0-9]*[a-z0-9])?$")
_DNS1123_SUBDOMAIN = re.compile(
    r"^[a-z0-9]([-a-z0-9]*[a-z0-9])?(\.[a-z0-9]([-a-z0-9]*[a-z0-9])?)*$"
)
_QUALIFIED_NAME_PART = re.compile(r"^[A-Za-z0-9]([-A-Za-z0-9_.]*[A-Za-z0-9])?$")
_LABEL_VALUE = re.compile(r"^([A-Za-z0-9]([-A-Za-z0-9_.]*[A-Za-z0-9])?)?$")
# ref nodepool.go:108 crontab CEL pattern (anchored as one alternation; the
# reference's raw pattern is effectively unanchored on the macro side)
_CRONTAB = re.compile(
    r"^(@(annually|yearly|monthly|weekly|daily|midnight|hourly)"
    r"|(\S+)\s+(\S+)\s+(\S+)\s+(\S+)\s+(\S+))$"
)


class ValidationError(Exception):
    """Raised by validate-or-die entry points; carries all field errors."""

    def __init__(self, errors: List[str]):
        self.errors = errors
        super().__init__("; ".join(errors))


# ---------------------------------------------------------------------------
# k8s.io/apimachinery/pkg/util/validation semantics


def is_qualified_name(key: str) -> List[str]:
    """IsQualifiedName: optional DNS-1123 subdomain prefix '/', then a
    63-char qualified name part."""
    errs: List[str] = []
    parts = key.split("/")
    if len(parts) == 1:
        name = parts[0]
    elif len(parts) == 2:
        prefix, name = parts
        if not prefix:
            errs.append("prefix part must be non-empty")
        elif len(prefix) > 253 or not _DNS1123_SUBDOMAIN.match(prefix):
            errs.append("prefix part must be a valid DNS-1123 subdomain")
    else:
        errs.append("a qualified name must have at most one '/'")
        return errs
    if not name:
        errs.append("name part must be non-empty")
    elif len(name) > 63 or not _QUALIFIED_NAME_PART.match(name):
        errs.append(
            "name part must consist of alphanumeric characters, '-', '_' or '.', "
            "and must start and end with an alphanumeric character"
        )
    return errs


def is_valid_label_value(value: str) -> List[str]:
    if len(value) > 63 or not _LABEL_VALUE.match(value):
        return [
            "a valid label value must be an empty string or consist of alphanumeric "
            "characters, '-', '_' or '.', and must start and end with an "
            "alphanumeric character"
        ]
    return []


def is_dns1123_subdomain(value: str) -> List[str]:
    if len(value) > 253 or not _DNS1123_SUBDOMAIN.match(value):
        return ["must be a valid DNS-1123 subdomain"]
    return []


# ---------------------------------------------------------------------------
# requirement validation (ref nodeclaim_validation.go:144-177)


def validate_requirement(req: NodeSelectorRequirement) -> List[str]:
    errs: List[str] = []
    key = lbl.NORMALIZED_LABELS.get(req.key, req.key)
    if req.operator not in SUPPORTED_NODE_SELECTOR_OPS:
        errs.append(
            f"key {key} has an unsupported operator {req.operator} "
            f"not in {sorted(SUPPORTED_NODE_SELECTOR_OPS)}"
        )
    msg = lbl.is_restricted_label(key)
    if msg is not None:
        errs.append(msg)
    for e in is_qualified_name(key):
        errs.append(f"key {key} is not a qualified name, {e}")
    for value in req.values:
        for e in is_valid_label_value(value):
            errs.append(f"invalid value {value} for key {key}, {e}")
    if req.operator == "In" and not req.values:
        errs.append(f"key {key} with operator In must have a value defined")
    if req.operator in ("Gt", "Lt"):
        ok = len(req.values) == 1
        if ok:
            try:
                ok = int(req.values[0]) >= 0
            except ValueError:
                ok = False
        if not ok:
            errs.append(
                f"key {key} with operator {req.operator} must have a single "
                f"positive integer value"
            )
    return errs


# ---------------------------------------------------------------------------
# taint validation (ref nodeclaim_validation.go:91-130)

_VALID_EFFECTS = (EFFECT_NO_SCHEDULE, EFFECT_PREFER_NO_SCHEDULE, EFFECT_NO_EXECUTE, "")


def _validate_taints_field(
    taints: List[Taint],
    existing: Dict[Tuple[str, str], bool],
    field_name: str,
) -> List[str]:
    errs: List[str] = []
    for i, taint in enumerate(taints):
        if not taint.key:
            errs.append(f"{field_name}[{i}]: taint key must be non-empty")
        else:
            for e in is_qualified_name(taint.key):
                errs.append(f"{field_name}[{i}]: invalid key {taint.key}, {e}")
        if taint.value:
            # the reference webhook checks IsQualifiedName here
            # (nodeclaim_validation.go:110), but the apiserver's own taint
            # validation uses label-value semantics — enforce the stricter
            # form so stamped taints survive a real apiserver
            for e in is_valid_label_value(taint.value):
                errs.append(f"{field_name}[{i}]: invalid value {taint.value}, {e}")
        if taint.effect not in _VALID_EFFECTS:
            errs.append(f"{field_name}[{i}]: invalid effect {taint.effect}")
        pair = (taint.key, taint.effect)
        if pair in existing:
            errs.append(
                f"{field_name}[{i}]: duplicate taint Key/Effect pair "
                f"{taint.key}={taint.effect}"
            )
        existing[pair] = True
    return errs


def validate_taints(spec: NodeClaimSpec | "object") -> List[str]:
    """Duplicate detection spans taints AND startupTaints
    (nodeclaim_validation.go:91-96)."""
    existing: Dict[Tuple[str, str], bool] = {}
    errs = _validate_taints_field(spec.taints, existing, "taints")
    errs += _validate_taints_field(spec.startup_taints, existing, "startupTaints")
    return errs


# ---------------------------------------------------------------------------
# kubelet configuration (ref nodeclaim_validation.go:179-276)


def validate_kubelet(k: Optional[KubeletConfiguration]) -> List[str]:
    if k is None:
        return []
    errs: List[str] = []
    for field_name, m in (
        ("evictionHard", k.eviction_hard),
        ("evictionSoft", k.eviction_soft),
    ):
        for sig, v in m.items():
            if sig not in SUPPORTED_EVICTION_SIGNALS:
                errs.append(f"{field_name}[{sig}]: unsupported eviction signal")
            if v.endswith("%"):
                try:
                    p = float(v.rstrip("%"))
                except ValueError:
                    errs.append(f"{field_name}[{sig}]: {v} is not a valid percentage")
                    continue
                if p < 0:
                    errs.append(f"{field_name}[{sig}]: percentage cannot be negative")
                if p > 100:
                    errs.append(
                        f"{field_name}[{sig}]: percentage cannot be greater than 100"
                    )
            else:
                try:
                    parse_quantity(v)
                except Exception:
                    errs.append(
                        f"{field_name}[{sig}]: {v} could not be parsed as a quantity"
                    )
    for field_name, m in (
        ("kubeReserved", k.kube_reserved),
        ("systemReserved", k.system_reserved),
    ):
        for res, qty in m.items():
            if res not in SUPPORTED_RESERVED_RESOURCES:
                errs.append(f"{field_name}[{res}]: unsupported reserved resource")
            if qty < 0:
                errs.append(f"{field_name}[{res}]: cannot be a negative quantity")
    soft = set(k.eviction_soft)
    grace = set(k.eviction_soft_grace_period)
    for sig in k.eviction_soft_grace_period:
        if sig not in SUPPORTED_EVICTION_SIGNALS:
            errs.append(f"evictionSoftGracePeriod[{sig}]: unsupported eviction signal")
    for sig in soft - grace:
        errs.append(
            f"evictionSoft[{sig}]: key does not have a matching evictionSoftGracePeriod"
        )
    for sig in grace - soft:
        errs.append(
            f"evictionSoftGracePeriod[{sig}]: key does not have a matching "
            f"evictionSoft threshold value"
        )
    if (
        k.image_gc_high_threshold_percent is not None
        and k.image_gc_low_threshold_percent is not None
        and k.image_gc_high_threshold_percent < k.image_gc_low_threshold_percent
    ):
        errs.append(
            "imageGCHighThresholdPercent: must be greater than "
            "imageGCLowThresholdPercent"
        )
    return errs


# ---------------------------------------------------------------------------
# disruption + budgets (ref nodepool_validation.go:97-111 + CEL
# nodepool.go:42-43,88,108,114)


def validate_disruption(d: Disruption) -> List[str]:
    errs: List[str] = []
    if d.expire_after is not None and d.expire_after < 0:
        errs.append("disruption.expireAfter: cannot be negative")
    if d.consolidate_after is not None and d.consolidate_after < 0:
        errs.append("disruption.consolidateAfter: cannot be negative")
    if d.consolidation_policy not in (
        CONSOLIDATION_POLICY_WHEN_EMPTY,
        CONSOLIDATION_POLICY_WHEN_UNDERUTILIZED,
    ):
        errs.append(
            f"disruption.consolidationPolicy: unsupported value "
            f"{d.consolidation_policy}"
        )
    if (
        d.consolidate_after is not None
        and d.consolidation_policy == CONSOLIDATION_POLICY_WHEN_UNDERUTILIZED
    ):
        errs.append(
            "disruption: consolidateAfter cannot be combined with "
            "consolidationPolicy=WhenUnderutilized"
        )
    if (
        d.consolidate_after is None
        and d.consolidation_policy == CONSOLIDATION_POLICY_WHEN_EMPTY
    ):
        errs.append(
            "disruption: consolidateAfter must be specified with "
            "consolidationPolicy=WhenEmpty"
        )
    if len(d.budgets) > 50:
        errs.append("disruption.budgets: must have at most 50 items")
    for i, b in enumerate(d.budgets):
        errs += [f"disruption.budgets[{i}]: {e}" for e in validate_budget(b)]
    return errs


def validate_budget(b: Budget) -> List[str]:
    errs: List[str] = []
    nodes = b.nodes
    if nodes.endswith("%"):
        try:
            p = int(nodes[:-1])
        except ValueError:
            p = -1
        if not (0 <= p <= 100):
            errs.append(f"nodes: {nodes} must be a percentage in [0%, 100%]")
    else:
        try:
            if int(nodes) < 0:
                errs.append(f"nodes: {nodes} cannot be negative")
        except ValueError:
            errs.append(f"nodes: {nodes} must be an integer or percentage")
    # 'crontab' must be set with 'duration' and vice versa (nodepool.go:88)
    if (b.schedule is None) != (b.duration is None):
        errs.append("crontab must be set with duration")
    if b.schedule is not None and not _CRONTAB.match(b.schedule):
        errs.append(f"crontab: {b.schedule} is not a valid cron schedule")
    if b.duration is not None and b.duration < 0:
        errs.append("duration: cannot be negative")
    return errs


# ---------------------------------------------------------------------------
# object-level entry points


def validate_nodeclaim_spec(spec: NodeClaimSpec) -> List[str]:
    errs = validate_taints(spec)
    for i, req in enumerate(spec.requirements):
        errs += [f"requirements[{i}]: {e}" for e in validate_requirement(req)]
    errs += [f"kubeletConfiguration: {e}" for e in validate_kubelet(spec.kubelet)]
    return errs


def validate_nodeclaim(nc: NodeClaim) -> List[str]:
    errs = [f"metadata.name: {e}" for e in is_dns1123_subdomain(nc.name)]
    errs += [f"spec: {e}" for e in validate_nodeclaim_spec(nc.spec)]
    return errs


def validate_template_labels(template_labels: Dict[str, str]) -> List[str]:
    """ref nodepool_validation.go:70-86."""
    errs: List[str] = []
    for key, value in template_labels.items():
        if key == lbl.NODEPOOL_LABEL_KEY:
            errs.append(f"labels[{key}]: restricted")
            continue
        for e in is_qualified_name(key):
            errs.append(f"labels[{key}]: invalid key, {e}")
        for e in is_valid_label_value(value):
            errs.append(f"labels[{key}]: invalid value {value}, {e}")
        msg = lbl.is_restricted_label(key)
        if msg is not None:
            errs.append(f"labels[{key}]: {msg}")
    return errs


def validate_nodepool(np: NodePool) -> List[str]:
    """Full admission validation = CRD-level + RuntimeValidate
    (nodepool_validation.go:35-50)."""
    errs = [f"metadata.name: {e}" for e in is_dns1123_subdomain(np.name)]
    t = np.spec.template
    errs += [f"spec.template.metadata: {e}" for e in validate_template_labels(t.metadata.labels)]
    errs += [f"spec.template.spec: {e}" for e in validate_taints(t)]
    for i, req in enumerate(t.requirements):
        errs += [
            f"spec.template.spec.requirements[{i}]: {e}"
            for e in validate_requirement(req)
        ]
        # the nodepool label is stamped by the controller, never user-set
        # (nodepool_validation.go:88-95)
        if req.key == lbl.NODEPOOL_LABEL_KEY:
            errs.append(
                f"spec.template.spec.requirements[{i}]: "
                f"{lbl.NODEPOOL_LABEL_KEY} is restricted"
            )
    errs += [f"spec.template.spec.kubeletConfiguration: {e}" for e in validate_kubelet(t.kubelet)]
    errs += [f"spec: {e}" for e in validate_disruption(np.spec.disruption)]
    if np.spec.weight is not None and not (1 <= np.spec.weight <= 100):
        errs.append("spec.weight: must be in [1, 100]")  # nodepool.go:53-54
    for res, qty in np.spec.limits.items():
        if qty < 0:
            errs.append(f"spec.limits[{res}]: cannot be negative")
    return errs


def validate_or_die(obj) -> None:
    """Admission seam: raise ValidationError with all accumulated errors."""
    if isinstance(obj, NodePool):
        errs = validate_nodepool(obj)
    elif isinstance(obj, NodeClaim):
        errs = validate_nodeclaim(obj)
    else:
        return
    if errs:
        raise ValidationError(errs)


def install_admission(client) -> None:
    """Register defaulting + validating admission on a KubeClient — the
    stand-in for the reference's webhook registration
    (webhooks.go:57-87, disabled-by-default there; on by default here
    since CEL enforcement is otherwise absent in-process)."""
    client.admission.append(set_defaults)
    client.admission.append(validate_or_die)


def set_defaults(obj) -> None:
    """ref nodepool_defaults.go / nodeclaim_defaults.go: SetDefaults are
    no-ops in v1beta1 (defaulting happens via CRD markers); the one
    live default is the 10% disruption budget (nodepool.go:89)."""
    if isinstance(obj, NodePool) and not obj.spec.disruption.budgets:
        obj.spec.disruption.budgets = [Budget(nodes="10%")]
