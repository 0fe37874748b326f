"""The port's shape contracts ≡ the JAX package's, on the CPU.

``karpenter_core_tpu_torch/solver/contracts.py`` is the port's copy of
the JAX package's contract engine, off by default and turned on here by
fixture (the port's module flag; the reference's is set the same way,
never through its environment knob). Held:

- the engine: seeded specs (letters, pinned sizes, scalars, skipped
  arguments, free output letters) against seeded shapes are accepted or
  rejected alike by both engines, with the same message, the port's
  given torch tensors and the reference's numpy arrays;
- the contract sites: every function the reference contracts has its
  port counterpart contracted with the same specs;
- a seeded solve on the CPU passes with contracts on, through the
  device scans' plain versions, the existing-node first-fit and the LP
  backend, with plans equal to the solve with them off; a wrong shape
  at a kernel wrapper raises ``ContractError``;
- the shape-contract pass (``analysis/shape_contracts.py``, the
  counterpart of the reference's ``eval_shape`` pass): every contract at
  prime sizes on the CPU, the reference's six checked ones covered under
  ``REFERENCE_NAMES``, each site declaring what the reference's does, and
  a contract whose output letters are swapped failing.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from karpenter_core_tpu.solver import contracts as ref_contracts
from karpenter_core_tpu_torch.solver import contracts


@pytest.fixture
def contracts_on(monkeypatch):
    monkeypatch.setattr(contracts, "_ENABLED", True)
    monkeypatch.setattr(ref_contracts, "_ENABLED", True)
    # both decorators register every function they wrap for their shape
    # passes: the test's throwaway functions go to copies that are
    # dropped after the test, or those passes would check them
    monkeypatch.setattr(ref_contracts, "REGISTRY", list(ref_contracts.REGISTRY))
    monkeypatch.setattr(contracts, "REGISTRY", list(contracts.REGISTRY))


def test_off_by_default(monkeypatch):
    """Off unless turned on, as the reference's without its knob (the
    test suite's conftest turns the reference's on for every test)."""
    assert contracts.enabled() is False
    monkeypatch.setattr(contracts, "_ENABLED", False)
    contracts.enable()
    assert contracts.enabled() is True


LETTERS = ("A", "B", "C", "2", "3", "_")


def _spec(rng) -> str:
    rank = int(rng.randint(0, 4))
    return "()" if rank == 0 else " ".join(LETTERS[int(rng.randint(len(LETTERS)))] for _ in range(rank))


def _case(seed: int):
    """(in specs, out spec, argument shapes, output shapes) from ``seed``:
    shapes drawn near the specs so some agree and some do not."""
    rng = np.random.RandomState(seed)
    n_in = int(rng.randint(1, 4))
    specs = [_spec(rng) if rng.rand() > 0.15 else None for _ in range(n_in)]
    n_out = int(rng.randint(1, 3))
    outs = [_spec(rng) for _ in range(n_out)]
    sizes = {"A": int(rng.randint(1, 4)), "B": int(rng.randint(1, 4)), "C": int(rng.randint(1, 4))}

    def shape_for(spec):
        if spec is None:
            return tuple(int(d) for d in rng.randint(1, 4, size=int(rng.randint(0, 3))))
        dims = () if spec == "()" else spec.split()
        shape = [sizes.get(d, int(d) if d.isdigit() else int(rng.randint(1, 4))) for d in dims]
        if rng.rand() < 0.3 and shape:
            shape[int(rng.randint(len(shape)))] += 1  # a mismatch
        if rng.rand() < 0.1:
            shape.append(1)  # a wrong rank
        return tuple(shape)

    out_spec = outs[0] if n_out == 1 else tuple(outs)
    return specs, out_spec, [shape_for(s) for s in specs], [shape_for(s) for s in outs]


def _outcome(engine, specs, out_spec, arg_shapes, out_shapes, make):
    @engine.contract(*specs, out=out_spec)
    def fn(*args):
        outs = tuple(make(s) for s in out_shapes)
        return outs[0] if len(outs) == 1 else outs

    try:
        fn(*(make(s) for s in arg_shapes))
        return "ok"
    except engine.ContractError as e:
        return str(e)


@pytest.mark.parametrize("seed", range(40))
def test_engine_accepts_and_rejects_as_the_reference(contracts_on, seed):
    specs, out_spec, arg_shapes, out_shapes = _case(seed)
    port = _outcome(contracts, specs, out_spec, arg_shapes, out_shapes, lambda s: torch.zeros(s))
    ref = _outcome(ref_contracts, specs, out_spec, arg_shapes, out_shapes, lambda s: np.zeros(s))
    assert port == ref


def test_scalars_and_python_numbers(contracts_on):
    for engine in (contracts, ref_contracts):
        @engine.contract("()", "A", out="()")
        def f(x, v):
            return 3

        assert f(2.0, np.zeros(3)) == 3
        with pytest.raises(engine.ContractError, match="rank"):
            f(np.zeros(2), np.zeros(3))
        with pytest.raises(engine.ContractError, match="expected an array"):
            f("nope", np.zeros(3))


# the reference's contract sites (module, function) and the port's
# counterpart (module, function) of each
SITES = (
    (("kernels", "compat_kernel"), ("kernels", "compat_reference")),
    (("kernels", "offering_kernel"), ("kernels", "offering_reference")),
    (("kernels", "allowed_kernel"), ("kernels", "allowed_reference")),
    (("kernels", "allowed_host"), ("kernels", "allowed")),
    (("pack", "pareto_frontier"), ("pack", "pareto_frontier")),
    (("pack", "ffd_pack"), ("pack", "ffd_pack")),
    (("pack", "pack_existing"), ("pack", "pack_existing")),
    (("pack", "assign_cheapest_types"), ("pack", "assign_cheapest_types")),
    (("pack", "ffd_pack_batched"), ("pack", "ffd_pack_batched")),
    (("pack", "node_usage_from_assignment"), ("pack", "node_usage_from_assignment")),
    (("merge", "screen_candidates"), ("merge", "screen_candidates")),
    (("encode", "build_requests_matrix"), ("encode", "build_requests_matrix")),
    (("encode", "build_requests_matrix_ids"), ("encode", "build_requests_matrix_ids")),
    (("encode", "quantize_requests"), ("encode", "quantize_requests")),
    (("encode", "quantize_capacity"), ("encode", "quantize_capacity")),
)


def _contract_of(pkg: str, module: str, name: str) -> dict:
    import importlib

    fn = getattr(importlib.import_module(f"{pkg}.solver.{module}"), name)
    seen = fn
    while seen is not None:
        if hasattr(seen, "__shape_contract__"):
            return seen.__shape_contract__
        seen = getattr(seen, "__wrapped__", None)
    raise AssertionError(f"{pkg}.solver.{module}.{name} has no contract")


@pytest.mark.parametrize("ref_site,port_site", SITES, ids=[f"{r[0]}.{r[1]}" for r, _ in SITES])
def test_contract_sites_carry_the_reference_specs(ref_site, port_site):
    ref = _contract_of("karpenter_core_tpu", *ref_site)
    port = _contract_of("karpenter_core_tpu_torch", *port_site)
    assert (port["in_specs"], port["out"]) == (ref["in_specs"], ref["out"])


def test_compat_wrappers_are_contracted():
    """The counterparts of the reference's Pallas entry points (its
    ``compat_pallas`` and ``allowed_pallas``) carry contracts too."""
    allowed = _contract_of("karpenter_core_tpu_torch", "compat_kernels", "allowed_via_kernel")
    compat = _contract_of("karpenter_core_tpu_torch", "compat_kernels", "compat_via_kernel")
    assert allowed["in_specs"][0] == "W S" and allowed["out"] == compat["out"] == "S T"


def test_wrong_shape_at_a_kernel_wrapper_raises(contracts_on):
    from karpenter_core_tpu_torch.solver import pack

    requests = torch.zeros((2, 8, 3), dtype=torch.int32)
    frontiers = torch.ones((2, 4, 3), dtype=torch.int32)
    with pytest.raises(contracts.ContractError, match="'G'"):
        pack.ffd_pack_batched(requests, frontiers, torch.ones(3, dtype=torch.int32))
    with pytest.raises(contracts.ContractError, match="'R'"):
        pack.ffd_pack_batched(requests, torch.ones((2, 4, 5), dtype=torch.int32), torch.ones(2, dtype=torch.int32))
    ids, counts = pack.ffd_pack_batched(requests + 1, frontiers * 4, torch.full((2,), 100, dtype=torch.int32))
    assert tuple(ids.shape) == (2, 8) and tuple(counts.shape) == (2,)


def _seeded_world(seed: int):
    from test_torch_oracle import _port_helpers

    from karpenter_core_tpu_torch.cloudprovider.fake import FakeCloudProvider, instance_types

    h = _port_helpers()
    rng = np.random.RandomState(seed)
    provider = FakeCloudProvider()
    provider.instance_types = instance_types(12)
    pods = [
        h.make_pod(requests={"cpu": ["100m", "500m", "1"][rng.randint(3)], "memory": ["256Mi", "1Gi"][rng.randint(2)]})
        for _ in range(80)
    ]
    return provider, h.make_nodepool(), pods


@pytest.mark.parametrize("backend", ["ffd", "lp"])
def test_seeded_solve_passes_with_contracts_on(monkeypatch, backend):
    """A seeded solve through the device scans' plain versions (native
    off), under ffd and under the LP backend, passes with contracts on
    and plans as with them off."""
    from test_torch_disruption import cpu_scheduler

    from karpenter_core_tpu_torch.solver import backends, incremental

    monkeypatch.setenv("KARPENTER_TORCH_NATIVE", "0")
    monkeypatch.setenv("KARPENTER_TORCH_PACK_BACKEND", backend)
    monkeypatch.setenv("KARPENTER_TORCH_INCREMENTAL", "0")
    monkeypatch.setenv("KARPENTER_TORCH_LP_MIN_WORK", "0")
    plans = {}
    for on in (False, True):
        monkeypatch.setattr(contracts, "_ENABLED", on)
        backends.reset_for_tests()
        incremental.reset()
        provider, pool, pods = _seeded_world(7)
        solver = cpu_scheduler([pool], provider)
        res = solver.solve(pods)
        assert solver.last_pack_stats.get("backend", "ffd") == backend
        plans[on] = sorted((p.instance_type.name, tuple(p.pod_indices)) for p in res.node_plans)
    assert plans[True] == plans[False] and plans[True]


# -- the shape-contract pass ----------------------------------------------------


@pytest.fixture(scope="module")
def cpu_pass():
    from karpenter_core_tpu_torch.analysis import shape_contracts

    return shape_contracts.verify_contracts(device="cpu")


def test_the_pass_is_green_on_the_cpu_and_covers_the_reference(cpu_pass):
    from karpenter_core_tpu.analysis.shape_contracts import verify_contracts as ref_verify
    from karpenter_core_tpu_torch.analysis.shape_contracts import REFERENCE_NAMES, covered

    assert [f"{r.name}: {r.detail}" for r in cpu_pass if not r.ok] == []
    assert all(covered(cpu_pass).values())
    ref_checked = sorted(r.name for r in ref_verify() if r.checked)
    assert ref_checked == sorted(REFERENCE_NAMES)
    port = {r.name: r for r in cpu_pass}
    assert all(port[REFERENCE_NAMES[name]].checked for name in ref_checked)


def test_every_letter_binds_a_distinct_prime(cpu_pass):
    primes = {3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41}
    for r in (r for r in cpu_pass if r.checked):
        bound = {k: v for k, v in r.sizes.items() if k != "W"}  # W: the packed layout's own width
        assert bound and set(bound.values()) <= primes and len(set(bound.values())) == len(bound), (r.name, r.sizes)


@pytest.mark.parametrize("ref_site,port_site", SITES, ids=[f"{r[0]}.{r[1]}" for r, _ in SITES])
def test_sites_skip_the_pass_as_the_reference(ref_site, port_site):
    """A contract the reference's pass skips (``eval_shape=False``, a host
    function) is skipped by the port's; the others are checked, but
    ``allowed``, whose reference counterpart is the numpy ``allowed_host``:
    the port's is the card's dispatcher, run like the other wrappers."""
    ref = _contract_of("karpenter_core_tpu", *ref_site)
    port = _contract_of("karpenter_core_tpu_torch", *port_site)
    want = True if port_site == ("kernels", "allowed") else ref["eval_shape"]
    assert port["eval_shape"] is want


@pytest.mark.parametrize("out", ["T S", "S S", "S"])
def test_a_wrong_output_spec_fails_at_prime_sizes(out):
    """``offering_reference`` declared with its output letters swapped (or
    one repeated, or a rank short) fails the pass: at distinct primes no
    (S, T) output reads as (T, S)."""
    from karpenter_core_tpu_torch.analysis.shape_contracts import verify_contracts
    from karpenter_core_tpu_torch.solver import kernels

    entry = dict(_contract_of("karpenter_core_tpu_torch", "kernels", "offering_reference"), out=out)
    (res,) = verify_contracts(device="cpu", entries=[entry])
    assert res.checked and not res.ok and "ContractError" in res.detail, res.detail
    (good,) = verify_contracts(device="cpu", entries=[_contract_of("karpenter_core_tpu_torch", "kernels",
                                                                    "offering_reference")])
    assert good.ok and kernels.offering_reference.__shape_contract__["out"] == "S T"


def test_the_pass_raises_for_a_card_that_is_not_there(monkeypatch):
    from karpenter_core_tpu_torch.analysis.shape_contracts import verify_contracts

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        verify_contracts(device="cuda")
