"""Scheduler construction: templates, per-pool instance types, topology
domain universe (ref pkg/controllers/provisioning/provisioner.go:204-296
NewScheduler): the port's copy of ``karpenter_core_tpu/scheduler/builder.py``.
Shared by ``TorchScheduler``'s oracle fallback and tests."""

from __future__ import annotations

import logging
from typing import Callable, Dict, List, Optional, Set

from ..apis.nodepool import NodePool, order_by_weight
from ..cloudprovider.types import CloudProvider, InstanceType
from ..kube.objects import OP_IN, Pod
from ..scheduling import Requirements
from ..scheduling.requirements import label_requirements, node_selector_requirements
from ..state.statenode import StateNode
from .nodeclaim import NodeClaimTemplate
from .scheduler import Scheduler, SchedulerOptions
from .topology import Topology
from .volumetopology import VolumeTopology


class NodePoolsNotFoundError(Exception):
    pass


def build_domains(nodepools_and_types) -> Dict[str, Set[str]]:
    """Topology domain universe: nodepool requirements ∩ instance-type
    requirements, so instance types can't expand beyond what the pool
    allows (provisioner.go:248-281)."""
    domains: Dict[str, Set[str]] = {}
    for nodepool, instance_types in nodepools_and_types:
        base = node_selector_requirements(nodepool.spec.template.requirements)
        base.add(*label_requirements(nodepool.spec.template.metadata.labels).values_list())
        for it in instance_types:
            requirements = Requirements(*base.copy().values_list())
            requirements.add(*it.requirements.values_list())
            for key, req in requirements.items():
                # the reference inserts raw values regardless of operator
                # (provisioner.go:257-267)
                domains.setdefault(key, set()).update(req.values)
        for key, req in base.items():
            if req.operator() == OP_IN:
                domains.setdefault(key, set()).update(req.values)
    return domains


def build_scheduler(
    kube_client,
    cluster,
    nodepools: List[NodePool],
    cloud_provider: CloudProvider,
    pods: List[Pod],
    state_nodes: Optional[List[StateNode]] = None,
    daemonset_pods: Optional[List[Pod]] = None,
    recorder=None,
    opts: Optional[SchedulerOptions] = None,
    catalog_entry: Optional[Callable] = None,
) -> Scheduler:
    """The greedy scheduler over the pools' catalogs. ``catalog_entry``
    maps a catalog to its cached encoding (a ``TorchScheduler``'s own
    inside a solve, so the vectorised filter reads the entries the tensor
    path uses); None uses the filter bridge's own bounded registry."""
    nodepools = [np for np in nodepools if np.metadata.deletion_timestamp is None]
    if not nodepools:
        raise NodePoolsNotFoundError("no nodepools found")
    nodepools = order_by_weight(nodepools)

    templates: List[NodeClaimTemplate] = []
    instance_types: Dict[str, List[InstanceType]] = {}
    pool_types = []
    for np in nodepools:
        try:
            options = cloud_provider.get_instance_types(np)
        except Exception as e:  # noqa: BLE001 — one bad pool must not stop scheduling
            # (provisioner.go:236-240)
            logging.getLogger("karpenter").debug(
                "skipping nodepool %s: instance-type fetch failed: %s", np.name, e
            )
            continue
        if not options:
            continue
        templates.append(NodeClaimTemplate(np))
        instance_types.setdefault(np.name, []).extend(options)
        pool_types.append((np, options))

    domains = build_domains(pool_types)

    # register each pool's catalog with the vectorized-filter bridge once
    # per build: the catalog fingerprint check (in-place offering
    # mutation) happens here, not per filter call
    from ..solver.oracle_bridge import refresh as _bridge_refresh

    for _, options in pool_types:
        _bridge_refresh(options, catalog_entry)

    if kube_client is not None:
        vt = VolumeTopology(kube_client)
        for p in pods:
            vt.inject(p)

    topology = Topology(kube_client, cluster, domains, pods)
    return Scheduler(
        kube_client,
        templates,
        nodepools,
        cluster,
        state_nodes or [],
        topology,
        instance_types,
        daemonset_pods or [],
        recorder,
        opts,
    )
