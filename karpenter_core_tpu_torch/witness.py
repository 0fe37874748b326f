"""The witnessed run: the port's lock and knob witnesses over a fixed
threaded workload, in an interpreter of its own.

    python -m karpenter_core_tpu_torch.witness [--device cuda|cpu] [--json]

(or ``python -m karpenter_core_tpu_torch.analysis --witness``, which
starts this in a fresh interpreter). Both witnesses
(``analysis/lockwitness.py``, ``analysis/knobwitness.py``) patch
process-wide constructors, so they install here before any other module
of the package is imported, each behind its switch
(``KARPENTER_TORCH_LOCK_WITNESS``, ``KARPENTER_TORCH_KNOB_WITNESS``, on
unless set to another value than ``1``; a witness switched off fails the
gate). The workload then drives, on ``--device`` (default ``cuda``,
which fails without a card; the CPU only when asked for):

1. the serving pipeline on bench config 8's rollout at its 400 pods,
   its prewarm thread and a disruption stage every second tick, joined
   nodes labeled as their claims pin them (so pods land on existing
   nodes);
2. the fleet engine batched: four tenants, each on its own worker thread,
   their packs coalesced by the ``_MegaDispatcher``;
3. one ``Operator.start()`` on the in-memory client, with its controller
   threads, leader election and serving pipeline, until it has created
   NodeClaims;
4. a warm-store snapshot of a solver's planes and its restore into a
   fresh solver.

The gate: every lock-order edge observed ⊆ ``static_order_graph()``,
every ``KARPENTER_TORCH_*`` read observed ⊆ ``static_knob_names()``, and
every lock of ``REQUIRED_LOCKS`` acquired (an empty observation fails).
It prints the locks and edges observed and each kernel's launches (all
zero on the CPU, where the wrappers take their plain versions); exit 0
when the gate holds.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

from .analysis import knobwitness, lockwitness
from .analysis.engine import PACKAGE

# bench config 8: bench.py's BENCH_STREAM_SCALE default
CONFIG8_SCALE = 400
FLEET_TENANTS = 4
FLEET_SCALE = 60
OPERATOR_SCALE = 60
CLOCK = 50_000.0  # the serving world's clock at start; it moves STEP_S a step,
STEP_S = 60.0  # past the 20 s nomination window
QUIESCE_S = 300.0

# the coordination locks the workload must reach, on any device: the
# store and the cluster state, the solver's catalog, warm state and pack
# backend, the serving stages, the batcher, the fleet's registry,
# scheduler, engine, canonical catalogs and dispatcher, the provider's
# catalog, and the library manifest the warm store writes and restores
REQUIRED_LOCKS = tuple(
    f"{PACKAGE}/{lock}"
    for lock in (
        "kube/client.py::KubeClient._lock",
        "state/cluster.py::Cluster._mu",
        "solver/solver.py::_CATALOG_LOCK",
        "solver/incremental.py::WarmState.lock",
        "solver/incremental.py::_STATES_LOCK",
        "solver/backends/__init__.py::PackBackend.lock",
        "serving/pipeline.py::ServingPipeline._mu",
        "serving/pipeline.py::ServingPipeline._gate_cv",
        "serving/queues.py::StageQueue._cv",
        "provisioning/batcher.py::Batcher._cv",
        "fleet/registry.py::FleetRegistry._mu",
        "fleet/scheduler.py::FleetScheduler._cv",
        "fleet/megasolve.py::FleetEngine._mu",
        "fleet/megasolve.py::CatalogPlane._mu",
        "fleet/megasolve.py::_MegaDispatcher._cv",
        "cloudprovider/fake.py::FakeCloudProvider._lock",
        "solver/backend.py::_MANIFEST_LOCK",
        "buildlib.py::_LIBS_LOCK",
    )
)
# and on the card: each kernel's first load
REQUIRED_CUDA_LOCKS = (f"{PACKAGE}/buildlib.py::CudaKernel._lock",)


# each witness's switch: on unless set to another value than 1, and a
# witness switched off fails the gate, so a switch never yields a passing
# run with a witness skipped
SWITCHES = {"lock": "KARPENTER_TORCH_LOCK_WITNESS", "knob": "KARPENTER_TORCH_KNOB_WITNESS"}


def install() -> dict:
    """Install each witness whose switch is on → {witness: installed}."""
    on = {
        "lock": os.environ.get("KARPENTER_TORCH_LOCK_WITNESS", "1") == "1",
        "knob": os.environ.get("KARPENTER_TORCH_KNOB_WITNESS", "1") == "1",
    }
    if on["lock"]:
        lockwitness.install()
    if on["knob"]:
        knobwitness.install()
    return on


def _serving(device: str, scale: int, tmp: str) -> dict:
    """Config 8's rollout through the pipeline with its prewarm and a
    disruption stage every second tick."""
    from .apis import labels as wk
    from .apis.nodepool import Budget
    from .disruption import DisruptionController
    from .serving import PipelineConfig, ServingPipeline
    from .serving import trafficgen as tg

    sc = tg.build_scenario("rollout", scale=scale)
    h = tg.TrafficHarness(teams=sc.teams, device=device)
    now = [CLOCK]

    def clock() -> float:
        return now[0]

    for part in (h.kube, h.cluster, h.recorder):
        part.clock = clock
    h.provisioner.PARITY_SAMPLE_EVERY = 0
    pool = h.kube.get("NodePool", "default")
    pool.spec.disruption.budgets = [Budget(nodes="100%")]
    pool.spec.disruption.consolidate_after = 0.0
    h.kube.apply(pool)
    ctrl = DisruptionController(h.kube, h.cluster, h.provisioner, h.provider, recorder=h.recorder, clock=clock,
                                validation_sleep=lambda t: None, metrics=h.metrics)
    disrupt_pass = ctrl.reconcile

    def reconcile():
        executed = disrupt_pass()
        # a consolidation's replacements launch as the fake provider creates them
        for nc in sorted(h.kube.list("NodeClaim"), key=lambda c: c.metadata.name):
            if nc.status.provider_id or nc.metadata.deletion_timestamp is not None:
                continue
            labels = h.provider.create(nc).metadata.labels
            it = next(t for t in h.provider.instance_types if t.name == labels[wk.LABEL_INSTANCE_TYPE])
            h._launch_and_bind(nc.metadata.name, it, labels[wk.LABEL_TOPOLOGY_ZONE],
                               labels[wk.CAPACITY_TYPE_LABEL_KEY], [])
        return executed

    ctrl.reconcile = reconcile
    # a joined node carries the labels its NodeClaim pins (the pods' team
    # among them), as a node launched from the claim does: pods can then
    # land on existing nodes, and the existing-node scan runs
    launch_and_bind = h._launch_and_bind

    def launch_labeled(claim_name, it, zone, ct, pods):
        launch_and_bind(claim_name, it, zone, ct, pods)
        nc, node = h.kube.get("NodeClaim", claim_name), h.kube.get("Node", f"node-{claim_name}")
        if nc is None or node is None:
            return
        extra = {r.key: r.values[0] for r in nc.spec.requirements
                 if r.operator == "In" and len(r.values) == 1 and r.key not in node.metadata.labels}
        if extra:
            node.metadata.labels.update(extra)
            h.kube.apply(node)

    h._launch_and_bind = launch_labeled
    config = PipelineConfig(idle_seconds=0.02, max_seconds=1.0, disrupt_every=2, warmstore_dir=tmp)
    h.warmup()
    # the decision stream's recorder: the pipeline quiesces once each tick's decisions are taken
    pipe = ServingPipeline(h.provisioner, metrics=h.metrics, config=config, disruption=ctrl,
                           on_decision=tg._StreamRecorder(h))
    h.on_catalog_event = pipe.observe_catalog_event
    pipe.attach_watch()
    pipe.hold()
    pipe.start()
    try:
        for i, step in enumerate(sc.steps):
            now[0] += STEP_S
            h.inject_step(step, i)
            pipe.release()
            if not pipe.quiesce(timeout=QUIESCE_S):
                raise RuntimeError(f"witness: the serving pipeline did not quiesce at step {i}")
            pipe.hold()
        out = {"ticks": pipe.ticks(), "disruption_passes": len(pipe._disrupt_log),
               "prewarm": pipe.debug_state()["prewarm"]}
    finally:
        pipe.stop()
        h.close()
    return out


def _fleet(device: str) -> dict:
    from .serving import trafficgen as tg

    run = tg.run_fleet_measurement(n_tenants=FLEET_TENANTS, scale=FLEET_SCALE, engine="batched", device=device)
    if run["decision_errors"] or not run["pods_decided"]:
        raise RuntimeError(f"witness: the fleet decided {run['pods_decided']} pods, {run['decision_errors']} errors")
    return {"rounds": run["rounds"], "pods_decided": run["pods_decided"], "dispatch": run["dispatch"]}


def _operator(device: str) -> dict:
    from .operator import Operator, Options
    from .serving import trafficgen as tg

    sc = tg.build_scenario("rollout", scale=OPERATOR_SCALE)
    h = tg.TrafficHarness(teams=sc.teams, device=device)
    opts = Options(enable_leader_election=True, metrics_port=0, health_probe_port=0, use_serving_pipeline=True,
                   batch_idle_duration=0.05, batch_max_duration=1.0)
    op = Operator(h.provider, kube_client=h.kube, options=opts, device=device)
    try:
        op.start()
        h.inject_step(sc.steps[0], 0)
        deadline = time.monotonic() + 120.0
        while time.monotonic() < deadline and not sum(op.metrics.nodeclaims_created.values.values()):
            time.sleep(0.05)
        created = sum(op.metrics.nodeclaims_created.values.values())
        if not created:
            raise RuntimeError("witness: the operator created no NodeClaim")
        return {"leading": bool(op._leading()), "nodeclaims_created": created}
    finally:
        op.stop()
        h.close()


def _warmstore(device: str, tmp: str) -> dict:
    from .apis.nodepool import NodePool
    from .cloudprovider.fake import FakeCloudProvider, instance_types
    from .serving import trafficgen as tg
    from .solver import TorchScheduler

    provider = FakeCloudProvider()
    provider.instance_types = instance_types(40)
    pool = NodePool()
    pool.metadata.name = "default"
    sc = tg.build_scenario("rollout", scale=200)
    pods = [tg.materialize_spec(s) for s in sc.steps[0].creates]
    solver = TorchScheduler([pool], provider, device=device)
    first = solver.solve(pods)
    path = solver.snapshot(directory=tmp)
    if path is None:
        raise RuntimeError("witness: the warm store wrote no snapshot")
    fresh = TorchScheduler([pool], provider, device=device)
    outcome = fresh.restore(path)
    again = fresh.solve(pods)
    if (again.node_count, again.pods_scheduled) != (first.node_count, first.pods_scheduled):
        raise RuntimeError("witness: the restored solver planned another plan")
    return {"restored": outcome.get("restored", {}), "dropped": outcome.get("dropped", {})}


def run(device: str) -> dict:
    """The workload on ``device`` (the witnesses installed already)."""
    from . import buildlib

    out = {}
    with tempfile.TemporaryDirectory(prefix="witness-") as tmp:
        for name, part in (
            ("serving", lambda: _serving(device, CONFIG8_SCALE, tmp)),
            ("fleet", lambda: _fleet(device)),
            ("operator", lambda: _operator(device)),
            ("warmstore", lambda: _warmstore(device, tmp)),
        ):
            t0 = time.perf_counter()
            out[name] = part()
            out[name]["s"] = round(time.perf_counter() - t0, 3)
    if device == "cuda":
        import torch

        torch.cuda.synchronize()
    out["launches"] = {name: k.total_launches for name, k in sorted(buildlib.KERNELS.items())}
    return out


def gate(device: str, installed: dict) -> dict:
    """observed ⊆ static for both witnesses, and the required locks reached."""
    from .analysis.concurrency import static_order_graph

    out: dict = {"installed": installed}
    problems = []
    if installed["lock"]:
        edges = lockwitness.observed_edges()
        locks = lockwitness.observed_locks()
        unexplained = edges - static_order_graph()
        required = REQUIRED_LOCKS + (REQUIRED_CUDA_LOCKS if device == "cuda" else ())
        missing = sorted(set(required) - locks)
        out.update(lock_edges=sorted(map(list, edges)), locks=sorted(locks),
                   instrumented=lockwitness.instrumented_count(), unexplained_edges=sorted(map(list, unexplained)),
                   missing_locks=missing)
        if not edges or not locks:
            problems.append("the lock witness observed nothing")
        if unexplained:
            problems.append(f"lock-order edges missing from the static graph: {sorted(unexplained)}")
        if missing:
            problems.append(f"required locks never acquired: {missing}")
    if installed["knob"]:
        names, unexplained_knobs = knobwitness.verify_against_static()
        out.update(knobs=sorted(names), unexplained_knobs=unexplained_knobs)
        if not names:
            problems.append("the knob witness observed nothing")
        if unexplained_knobs:
            problems.append(f"knob reads missing from the static inventory: {unexplained_knobs}")
    for witness, switch in SWITCHES.items():
        if not installed[witness]:
            problems.append(f"the {witness} witness is switched off ({switch})")
    out["problems"] = problems
    out["ok"] = not problems
    return out


def main(argv=None) -> int:
    installed = install()
    ap = argparse.ArgumentParser(prog=f"python -m {PACKAGE}.witness", description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--json", action="store_true", help="print one JSON object")
    args = ap.parse_args(argv)
    from .solver.backend import resolve_device

    resolve_device(args.device)  # no card: fail now, not part way into the workload
    t0 = time.perf_counter()
    # with a witness switched off the gate fails: the workload is not run
    workload = run(args.device) if all(installed.values()) else {"launches": {}}
    result = {"device": args.device, "scale": CONFIG8_SCALE, "workload": workload, **gate(args.device, installed),
              "seconds": round(time.perf_counter() - t0, 3)}
    if args.json:
        print(json.dumps(result))
    else:
        for edge in result.get("lock_edges", ()):
            print("edge", " -> ".join(edge))
        for lock in result.get("locks", ()):
            print("lock", lock)
        print("knobs", ", ".join(result.get("knobs", ())))
        print("launches", json.dumps(workload["launches"]))
        for p in result["problems"]:
            print("WITNESS FAIL:", p)
        print(f"witness {'ok' if result['ok'] else 'FAILED'}: {len(result.get('lock_edges', ()))} edges, "
              f"{len(result.get('locks', ()))} locks, {len(result.get('knobs', ()))} knobs; {result['seconds']} s")
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
