"""CLI: ``python -m karpenter_core_tpu_torch.analysis``.

Exit 0 when the repo is clean (every finding fixed, suppressed with a
marker, or baselined — and no stale baseline entries); 1 otherwise.
``--format json`` emits machine-readable findings for CI tooling, like
``profile_solve.py`` does for perf. ``--witness`` runs the lock and knob
witnesses over the package's fixed threaded workload instead, in a fresh
interpreter, so that both install before any module of the package is
imported (``python -m karpenter_core_tpu_torch.witness``); its exit code
is this one's. ``--contracts`` runs the shape-contract pass instead
(``shape_contracts.py``): every ``@contract`` at prime sizes, exit 1 on
any failure. Both run on ``--device`` (default ``cuda``, which fails
without a card; ``cpu`` only when asked for).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from .engine import (
    PACKAGE,
    analyze_paths,
    default_baseline_path,
    registered_rules,
    repo_root,
)
from .findings import Baseline


def _changed_python_files(root):
    """Absolute paths of .py files changed vs the merge base with the
    main branch (committed + staged + working tree + untracked), or None
    when git is unavailable. The merge base degrades to HEAD on main
    itself, which scopes the run to uncommitted work — the pre-push
    shape ``hack/analyze.sh`` wants."""
    import subprocess

    def git(*argv):
        try:
            p = subprocess.run(
                ["git", *argv], cwd=root, capture_output=True, text=True, timeout=15
            )
        except (OSError, subprocess.TimeoutExpired):
            return None
        return p.stdout if p.returncode == 0 else None

    if git("rev-parse", "--git-dir") is None:
        return None
    base = None
    for ref in ("origin/main", "main", "origin/master", "master"):
        out = git("merge-base", "HEAD", ref)
        if out:
            base = out.strip()
            break
    diff = git("diff", "--name-only", base or "HEAD")
    untracked = git("ls-files", "--others", "--exclude-standard")
    names = set()
    for blob in (diff, untracked):
        if blob:
            names.update(line.strip() for line in blob.splitlines() if line.strip())
    return sorted(
        os.path.join(root, n.replace("/", os.sep))
        for n in names
        if n.endswith(".py") and os.path.exists(os.path.join(root, n))
    )


def _contracts(device: str, fmt: str) -> int:
    """``--contracts``: the pass over the port's registry on ``device`` →
    0 when every contract holds."""
    from .shape_contracts import covered, verify_contracts

    t0 = time.perf_counter()
    results = verify_contracts(device=device)
    cover = covered(results)
    ok = all(r.ok for r in results) and all(cover.values())
    if fmt == "json":
        json.dump({"ok": ok, "device": device, "contracts": [r.to_dict() for r in results],
                   "reference_covered": cover, "seconds": round(time.perf_counter() - t0, 3)}, sys.stdout, indent=2)
        print()
    else:
        for r in results:
            status = "ok" if r.ok else "FAIL"
            mode = "checked" if r.checked else "runtime-only"
            card = f" {r.kernel} launches {r.launches}, bit-equal {r.bit_equal}" if r.kernel else ""
            print(f"contract {r.name}: {status} [{mode}] {r.detail}{card}")
        missing = sorted(ref for ref, hit in cover.items() if not hit)
        if missing:
            print(f"reference contracts not checked: {missing}")
        print(f"{len(results)} contracts, {sum(r.checked for r in results)} checked on {device}; "
              f"{sum(not r.ok for r in results)} failed; {time.perf_counter() - t0:.3f} s")
    return 0 if ok else 1


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog=f"python -m {PACKAGE}.analysis",
        description="Repo-native static analysis of the port's host Python: "
        "lock discipline and order, cache soundness, knob provenance, clocks, "
        "determinism, pipeline safety, hygiene, host syncs, kernel registry, "
        "tensor branches; and the shape-contract pass.",
    )
    parser.add_argument(
        "paths",
        nargs="*",
        help=f"files/dirs to scan (default: the {PACKAGE} package)",
    )
    parser.add_argument("--format", choices=("text", "json"), default="text")
    parser.add_argument(
        "--baseline",
        default=None,
        help="baseline file (default: the checked-in analysis/baseline.json)",
    )
    parser.add_argument(
        "--no-baseline", action="store_true", help="report grandfathered findings too"
    )
    parser.add_argument(
        "--write-baseline",
        action="store_true",
        help="rewrite the baseline from the current findings and exit",
    )
    parser.add_argument(
        "--rules", default=None, help="comma-separated rule subset (see --list-rules)"
    )
    parser.add_argument(
        "--changed-only",
        action="store_true",
        help="scope the scan to .py files changed vs the git merge base "
        "(falls back to uncommitted changes; project rules like cachesound "
        "still load their configured cross-file module set)",
    )
    parser.add_argument("--list-rules", action="store_true")
    parser.add_argument(
        "--knobs",
        action="store_true",
        help="print the KARPENTER_TORCH_* knob registry (the README "
        "Configuration table; --format json for per-site detail) and exit",
    )
    parser.add_argument(
        "--contracts",
        action="store_true",
        help="run every @contract at prime sizes on --device instead (on cuda the "
        "kernel wrappers against their plain versions on the CPU, bit for bit)",
    )
    parser.add_argument(
        "--witness",
        action="store_true",
        help="run the lock and knob witnesses over the fixed threaded "
        "workload and check observed ⊆ static (a fresh interpreter: both "
        "witnesses install before any package import)",
    )
    parser.add_argument("--device", choices=("cpu", "cuda"), default="cuda",
                        help="the device of --witness and --contracts (cuda fails without a card)")
    args = parser.parse_args(argv)

    if args.contracts:
        return _contracts(args.device, args.format)

    if args.witness:
        import subprocess

        from ..solver.backend import resolve_device

        resolve_device(args.device)  # no card: fail here, not in the child
        cmd = [sys.executable, "-m", f"{PACKAGE}.witness", "--device", args.device]
        if args.format == "json":
            cmd.append("--json")
        return subprocess.run(cmd, cwd=repo_root()).returncode

    if args.list_rules:
        for name, desc in registered_rules().items():
            print(f"{name}: {desc}")
        return 0

    if args.knobs:
        from .configprov import knob_rows, knob_table_lines, repo_registry

        registry = repo_registry()
        if args.format == "json":
            json.dump(knob_rows(registry), sys.stdout, indent=2)
            print()
        else:
            for line in knob_table_lines(registry):
                print(line)
        return 0

    t0 = time.perf_counter()
    root = repo_root()
    paths = args.paths or [os.path.join(root, PACKAGE)]
    if args.changed_only:
        changed = _changed_python_files(root)
        if changed is None:
            print("--changed-only: not a git checkout, scanning everything")
        else:
            paths = [p for p in changed if p.startswith(os.path.join(root, PACKAGE))]
            if not paths:
                print("--changed-only: no changed python files; clean")
                return 0
    rules = args.rules.split(",") if args.rules else None
    baseline_path = args.baseline or default_baseline_path()
    baseline = None if args.no_baseline else Baseline.load(baseline_path)

    report = analyze_paths(paths, root=root, baseline=baseline, rules=rules)
    if args.changed_only:
        # a scoped scan cannot see the files grandfathered findings live
        # in — only the full run may police baseline staleness
        report.stale_baseline = []

    if args.write_baseline:
        merged = report.findings + report.baselined
        Baseline.from_findings(merged).save(baseline_path)
        print(f"baseline: {len(merged)} findings -> {baseline_path}")
        return 0

    if args.format == "json":
        payload = report.to_dict()
        payload["seconds"] = round(time.perf_counter() - t0, 3)
        json.dump(payload, sys.stdout, indent=2)
        print()
    else:
        for f in report.findings:
            print(f.format())
        for e in report.stale_baseline:
            print(
                f"STALE baseline entry (fixed? run --write-baseline): "
                f"{e['path']}: {e['rule']}: {e['message']}"
            )
        for e in report.parse_errors:
            print(f"PARSE ERROR: {e}")
        print(
            f"{report.files_scanned} files; {len(report.findings)} findings, "
            f"{len(report.suppressed)} suppressed, {len(report.baselined)} baselined; "
            f"{time.perf_counter() - t0:.3f} s"
        )
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
