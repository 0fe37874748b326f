"""The port's chaos plane ≡ the JAX package's, on the CPU.

``karpenter_core_tpu_torch/kube/faults.py`` (seeded fault schedules, the
skew clock, the REST fault injector), the REST adapter's watch backoff
and the serving pipeline's degradation guards are held to the reference
two ways:

- every test of ``tests/test_chaos.py`` (nine classes, 26 tests) runs
  from its own source on the port (``mirror``): the stub apiserver is
  the port's copy (``test_torch_restclient.restclient_mirror``), the
  harness runs on ``device="cpu"``, and the reference's
  ``KARPENTER_TPU_WATCH_BACKOFF_{BASE,MAX}_MS`` settings become the
  port's constants ``restclient.WATCH_BACKOFF_BASE_MS`` /
  ``WATCH_BACKOFF_MAX_MS`` (the port reads no environment, so the
  knob test's garbage-string half becomes the constants' defaults);
- the same inputs through both packages give equal results, exactly:
  ``FaultSchedule.build(...).to_dict()`` for every fault kind, seeds
  0–19 and 4, 9 and 200 steps, with the chaos run's magnitudes and
  without; the injector's log and raised errors over seeded request
  sequences; the chaos run's fault set, magnitudes, holding faults
  and pipeline configuration.
"""

from __future__ import annotations

import dataclasses
import importlib
import random

import pytest

from test_torch_kube_client import PORT, REF, case_id, mirror, mirror_cases, run_mirrored
from test_torch_restclient import restclient_mirror

FILE = "test_chaos.py"
CASES = mirror_cases(FILE)
CLASSES = (
    "TestFaultSchedule", "TestSkewClock", "TestRestFaultInjector", "TestWatchLoopUnderFaults",
    "TestOrphanFaultKindSmoke", "TestWatchBackoff", "TestStaleWorldGuard", "TestLeaderGate",
    "TestFaultWindowAnnotation",
)

# the reference's environment settings of its watch backoff → the port's constants
_BACKOFF_SETTINGS = tuple(
    (f'monkeypatch.setenv("KARPENTER_TPU_WATCH_BACKOFF_{which}_MS", "{value}")',
     f'monkeypatch.setattr(_restclient, "WATCH_BACKOFF_{which}_MS", {float(value)})')
    for which, value in (("BASE", "5"), ("MAX", "20"), ("BASE", "50"), ("MAX", "900"))
)


def chaos_mirror():
    from karpenter_core_tpu_torch.kube import restclient

    replace = (
        ("from test_restclient import _StubApiServer\n", ""),
        ('tg.TrafficHarness(', 'tg.TrafficHarness(device="cpu", '),
        # the garbage-string half has no counterpart: the constants' defaults instead
        ('        monkeypatch.setenv("KARPENTER_TPU_WATCH_BACKOFF_BASE_MS", "junk")\n',
         "        monkeypatch.undo()\n"),
        *_BACKOFF_SETTINGS,
    )
    return mirror(FILE, PORT, replace=replace,
                  inject={"_restclient": restclient, "_StubApiServer": restclient_mirror()._StubApiServer})


def test_mirror_covers_the_file():
    assert len(CASES) == 26
    assert {cls for cls, _, _ in CASES} == set(CLASSES)


def test_mirror_reads_no_environment():
    src = (importlib.import_module("test_torch_kube_client").TESTS / FILE).read_text()
    for old, _ in _BACKOFF_SETTINGS:
        assert old in src
    mod = chaos_mirror()
    assert mod.WatchBackoff.__module__ == f"{PORT}.kube.restclient"
    assert mod._StubApiServer is restclient_mirror()._StubApiServer


@pytest.mark.parametrize("case", CASES, ids=[case_id(c) for c in CASES])
def test_chaos_case_holds_the_port(monkeypatch, case):
    run_mirrored(chaos_mirror(), *case, extra={"monkeypatch": monkeypatch})


def test_backoff_constants_are_the_reference_defaults():
    from karpenter_core_tpu_torch.kube import restclient

    assert (restclient.WATCH_BACKOFF_BASE_MS, restclient.WATCH_BACKOFF_MAX_MS) == (200.0, 5000.0)
    b = restclient.WatchBackoff()
    assert (b.base_s, b.max_s) == (0.2, 5.0)


# -- the same inputs through both packages ------------------------------------


def faults(pkg: str):
    return importlib.import_module(f"{pkg}.kube.faults")


def trafficgen(pkg: str):
    return importlib.import_module(f"{pkg}.serving.trafficgen")


def test_fault_kinds_and_chaos_tables_equal_reference():
    assert faults(PORT).FAULT_KINDS == faults(REF).FAULT_KINDS
    port, ref = trafficgen(PORT), trafficgen(REF)
    assert port.CHAOS_FAULTS == ref.CHAOS_FAULTS
    assert port._CHAOS_MAGNITUDES == ref._CHAOS_MAGNITUDES
    assert port._HOLDING_FAULTS == ref._HOLDING_FAULTS
    fields = ("idle_seconds", "max_seconds", "solve_queue_cap", "telemetry_queue_cap", "max_staleness_s")
    for fault in ("none",) + ref.CHAOS_FAULTS:
        got, want = port._chaos_config(fault), ref._chaos_config(fault)
        assert [getattr(got, f) for f in fields] == [getattr(want, f) for f in fields], fault


@pytest.mark.parametrize("n_steps", [4, 9, 200])
@pytest.mark.parametrize("kind", list(faults(REF).FAULT_KINDS))
def test_schedule_equals_reference(kind, n_steps):
    magnitudes = trafficgen(REF)._CHAOS_MAGNITUDES
    for seed in range(20):
        for mags in (magnitudes, None):
            got = faults(PORT).FaultSchedule.build(f"chaos-{kind}", seed, (kind,), n_steps, magnitudes=mags)
            want = faults(REF).FaultSchedule.build(f"chaos-{kind}", seed, (kind,), n_steps, magnitudes=mags)
            assert got.to_dict() == want.to_dict(), (seed, mags)
            assert [got.kinds_at(i) for i in range(n_steps + 2)] == [want.kinds_at(i) for i in range(n_steps + 2)]


@pytest.mark.parametrize("seed", range(8))
def test_every_kind_schedule_equals_reference(seed):
    kinds = faults(REF).FAULT_KINDS
    got = faults(PORT).FaultSchedule.build("all", seed, kinds, 64)
    want = faults(REF).FaultSchedule.build("all", seed, kinds, 64)
    assert got.to_dict() == want.to_dict()
    assert [dataclasses.astuple(e) for e in got.events] == [dataclasses.astuple(e) for e in want.events]


def _inject_log(pkg: str, seed: int) -> list:
    """A seeded schedule and request sequence through ``pkg``'s injector →
    per request (ordinal, slept seconds, raised error class and code), then
    the injector's own log."""
    f = faults(pkg)
    rng = random.Random(seed)
    events = [
        f.FaultEvent(rng.choice(f.FAULT_KINDS), rng.randrange(1, 30), rng.randrange(1, 4), float(rng.randrange(0, 50)))
        for _ in range(6)
    ]
    slept = []
    inj = f.RestFaultInjector(f.FaultSchedule(f"inj-{seed}", seed, events), sleep=slept.append)
    out = []
    for ordinal in range(1, 36):
        stream = rng.random() < 0.5
        before = len(slept)
        try:
            inj(rng.choice(("GET", "POST", "PATCH")), "/api/v1/pods" + ("?watch=1" if stream else ""), stream)
            err = None
        except Exception as e:  # noqa: BLE001 — the error is the result compared
            err = (type(e).__name__, getattr(e, "code", None))
        out.append((ordinal, slept[before:], err))
    return out + [("log", inj.injected)]


@pytest.mark.parametrize("seed", range(10))
def test_injector_equals_reference(seed):
    assert _inject_log(PORT, seed) == _inject_log(REF, seed)


def test_injector_raises_the_adapters_api_error():
    from karpenter_core_tpu_torch.kube import faults as port_faults
    from karpenter_core_tpu_torch.kube.restclient import ApiError

    inj = port_faults.RestFaultInjector(port_faults.FaultSchedule(
        "api", 0, [port_faults.FaultEvent("relist_storm", 1)]))
    with pytest.raises(ApiError) as err:
        inj("GET", "/api/v1/nodes?watch=1", True)
    assert err.value.code == 410


def test_skew_clock_equals_reference():
    now = [100.0]
    clocks = {pkg: faults(pkg).SkewClock(base=lambda: now[0]) for pkg in (REF, PORT)}
    rng = random.Random(3)
    for _ in range(50):
        if rng.random() < 0.3:
            delta = rng.choice((3600.0, -3600.0, 0.5))
            for clock in clocks.values():
                clock.skew(delta)
        now[0] += rng.random()
        assert clocks[PORT]() == clocks[REF]()
