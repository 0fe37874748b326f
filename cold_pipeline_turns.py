#!/usr/bin/env python3
"""Time the port's cold pipeline on two trees in turns, on one NVIDIA card.

    python3 cold_pipeline_turns.py TREE_A TREE_B [--rounds N] [--out FILE]

Each tree is a checkout of this repository (for example the parent
commit unpacked with ``git archive`` into an ignored directory). The
trees run one after the other in fresh processes, in the order A B B A
(repeated ``--rounds`` times), so a drift of the card or the host during
the call weighs on both alike. Each process runs, from its own tree's
``chip_smoke.py`` and with ``KARPENTER_TORCH_INCREMENTAL=0``, phases 4
(the slice), 5 (the cluster) and 6 (bench config 3), then phase 13b
(``Provisioner.reconcile`` over phase 5's world as store objects, the
C++ packer and the device scans). It prints one JSON line per run: the
warm solve times of phases 4-6, the reconcile times of 13b, the objects
the collector tracks at the end (and the eight commonest of the port's
types among them), and the collector's pauses by
generation, summed over the whole run (``gc.callbacks``). The lines are
appended to ``--out`` too. ``--device cpu`` with ``--pods``, ``--types``
and ``--nodes`` runs the same phases on the CPU at a cut size, to try
the script itself.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time


def child(tree: str, device: str, size: tuple) -> dict:
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    os.environ["KARPENTER_TORCH_INCREMENTAL"] = "0"
    pauses = {0: 0.0, 1: 0.0, 2: 0.0}
    collections = {0: 0, 1: 0, 2: 0}
    started = {}

    def on_gc(phase, info):
        gen = info["generation"]
        if phase == "start":
            started[gen] = time.perf_counter()
        elif gen in started:
            pauses[gen] += (time.perf_counter() - started.pop(gen)) * 1000.0
            collections[gen] += 1

    spec = importlib.util.spec_from_file_location("chip_smoke_turn", os.path.join(tree, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from karpenter_core_tpu_torch.solver.solver import TorchScheduler

    gc.callbacks.append(on_gc)
    t0 = time.perf_counter()
    pods_types = size[:2]
    pools, provider, pods = smoke.slice_world(*pods_types)
    _, _, warm_runs, _ = smoke.solve_runs(TorchScheduler(pools, provider, device=device), pods)
    del pools, provider, pods
    slice_ms = sorted(ms for ms, _ in warm_runs)[1]
    cluster = smoke.run_cluster_phase(device, *size)
    config3 = smoke.run_config3_phase(device, *pods_types)
    prov = smoke.run_provisioner_cluster(device, *size)["rows"]
    gc.callbacks.remove(on_gc)
    kinds: dict = {}
    for o in gc.get_objects():
        kind = type(o)
        module = getattr(kind, "__module__", None)  # a descriptor on some C types
        if isinstance(module, str) and module.startswith("karpenter_core_tpu_torch"):
            kinds[kind.__qualname__] = kinds.get(kind.__qualname__, 0) + 1
    return {
        "tree": tree,
        "slice_warm_ms": slice_ms,
        "cluster_warm_ms": cluster["warm_ms"],
        "cluster_existing_ms": cluster["warm_phases_ms"]["existing_ms"],
        "config3_warm_ms": config3["warm_ms"],
        "provisioner_cluster_reconcile_ms": prov["cluster"]["reconcile_ms"],
        "provisioner_cluster_device_reconcile_ms": prov["cluster-device"]["reconcile_ms"],
        "gc_objects": len(gc.get_objects()),
        "gc_port_types": dict(sorted(kinds.items(), key=lambda kv: -kv[1])[:8]),
        "gc_pause_ms": pauses,
        "gc_collections": collections,
        "s": time.perf_counter() - t0,
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--pods", type=int, default=None)
    ap.add_argument("--types", type=int, default=None)
    ap.add_argument("--nodes", type=int, default=None)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        # the phases' own lines go to stderr; the result is the last stdout line
        real_stdout, sys.stdout = sys.stdout, sys.stderr
        size = tuple(v for v in (args.pods, args.types, args.nodes) if v is not None)
        row = child(args.child, args.device, size)
        print(json.dumps(row), file=real_stdout, flush=True)
        return
    if len(args.trees) != 2:
        ap.error("give two trees")
    trees = [os.path.abspath(t) for t in args.trees]
    order = [trees[i] for _ in range(args.rounds) for i in (0, 1, 1, 0)]
    passed = ["--device", args.device] + [
        f"--{name}={v}" for name, v in (("pods", args.pods), ("types", args.types), ("nodes", args.nodes))
        if v is not None
    ]
    for tree in order:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", tree, *passed],
            cwd=tree, capture_output=True, text=True, timeout=900,
        )
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr[-4000:])
            sys.exit(f"the run on {tree} failed ({proc.returncode})")
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        if args.out:
            with open(args.out, "a", encoding="utf-8") as f:
                f.write(line + "\n")


if __name__ == "__main__":
    main()
