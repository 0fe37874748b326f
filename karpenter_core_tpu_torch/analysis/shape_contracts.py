"""The shape-contract pass: every ``@contract`` checked at prime sizes.

The port's counterpart of ``karpenter_core_tpu/analysis/shape_contracts.py``.
For every contracted tensor function, bind each dimension letter to a
distinct prime (3, 5, 7, 11, … in order of first use), build inputs of
those sizes from a seeded numpy generator, run the function, and check
its outputs against the declared specs. Distinct primes make a
transposed dimension impossible to miss ((3, 5) != (5, 3)).

The reference runs ``jax.eval_shape`` on abstract inputs. The port's
plain versions are Python loops over tensors, which no abstract tensor
can run, so the pass runs concrete inputs, small enough (every letter at
most 41) that a loop takes milliseconds:

- on the CPU it runs each function as it is, which takes the plain
  versions;
- on ``cuda`` it runs each function on the card's tensors, and again on
  CPU copies of the same inputs. The dispatching wrappers
  (``ROUTES``: B1's ``allowed``, ``allowed_via_kernel`` and
  ``compat_via_kernel``, B5's ``ffd_pack`` and ``ffd_pack_batched``, B6's
  ``pack_existing``) then launch their hand kernels on the card and the
  plain versions on the CPU: each output must be bit-equal to the plain
  one, and each kernel's launch counter must move.

``REFERENCE_NAMES`` maps the reference's checked contracts to the
port's. This is the only module of the analysis package that imports
torch (and the solver modules whose contracts it reads), and only when
``verify_contracts`` runs (``--contracts``).
"""

from __future__ import annotations

import time
import zlib
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional

_PRIMES = [3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41]

_DTYPES = {None: "int32", "i4": "int32", "i8": "int64", "f4": "float32", "f8": "float64", "b1": "bool",
           "u1": "uint8"}

#: the reference's checked contracts → the port's counterparts
REFERENCE_NAMES = {
    "compat_kernel": "compat_reference",
    "offering_kernel": "offering_reference",
    "allowed_kernel": "allowed_reference",
    "ffd_pack": "ffd_pack",
    "pack_existing": "pack_existing",
    "ffd_pack_batched": "ffd_pack_batched",
}

#: the dispatching wrappers → the device plane's name of the hand kernel
#: each launches on the card (``buildlib.KERNELS``)
ROUTES = {
    "allowed": "kernels.allowed_kernel",
    "allowed_via_kernel": "kernels.allowed_kernel",
    "compat_via_kernel": "kernels.allowed_kernel",
    "ffd_pack": "pack.ffd_pack_batched",
    "ffd_pack_batched": "pack.ffd_pack_batched",
    "pack_existing": "pack.pack_existing",
}

_PACKAGE = "karpenter_core_tpu_torch."


@dataclass
class ContractResult:
    name: str
    ok: bool
    checked: bool  # False: a host function the pass skips (``eval_shape=False``)
    detail: str = ""
    sizes: Dict[str, int] = field(default_factory=dict)
    device: str = "cpu"
    kernel: Optional[str] = None  # the hand kernel the wrapper launches on the card
    launches: int = 0  # its launches in this check
    bit_equal: Optional[bool] = None  # the card's outputs against the CPU's (cuda only)
    ms: float = 0.0

    def to_dict(self) -> dict:
        return asdict(self)


class _DimEnv:
    """letter → concrete prime size, bound on first use."""

    def __init__(self) -> None:
        self.env: Dict[str, int] = {}
        self._next = 0

    def __call__(self, letter: str) -> int:
        if letter.isdigit():
            return int(letter)
        if letter in ("*", "_"):
            v = _PRIMES[self._next % len(_PRIMES)]
            self._next += 1
            return v
        if letter not in self.env:
            self.env[letter] = _PRIMES[self._next % len(_PRIMES)]
            self._next += 1
        return self.env[letter]


def _build_input(spec: Optional[str], dtype_code: Optional[str], dims: _DimEnv, rng, device):
    import numpy as np
    import torch

    from ..solver.contracts import _parse

    tokens = _parse(spec)
    if tokens is None:
        return None
    shape = tuple(dims(t) for t in tokens)
    dtype = np.dtype(_DTYPES.get(dtype_code, dtype_code))
    if dtype == np.bool_:
        values = rng.rand(*shape) < 0.5
    elif dtype.kind == "f":
        values = rng.rand(*shape).astype(dtype)
    else:
        values = rng.randint(0, 16, size=shape).astype(dtype)
    if not shape:
        return values.item()  # a "()" spec: a Python scalar
    return torch.from_numpy(np.ascontiguousarray(values)).to(device)


def _inputs(entry: dict, seed: int, device):
    """(args, kwargs, the letters' sizes) for ``entry`` on ``device``: the
    same values for every device at one seed. None when the specs cannot
    describe the inputs and no example builder is declared."""
    import numpy as np

    dims = _DimEnv()
    rng = np.random.RandomState(seed)
    if entry["example"] is not None:
        args, kwargs = entry["example"](dims, rng, device)
    else:
        dtypes = entry["dtypes"] or (None,) * len(entry["in_specs"])
        args = tuple(_build_input(s, d, dims, rng, device) for s, d in zip(entry["in_specs"], dtypes))
        if any(a is None for a in args):
            return None
        kwargs = {}
    return tuple(args), dict(entry["static"], **kwargs), dims.env


def _outputs(result) -> tuple:
    return tuple(result) if isinstance(result, (tuple, list)) else (result,)


def _same(a, b) -> bool:
    import torch

    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        return a.dtype == b.dtype and tuple(a.shape) == tuple(b.shape) and torch.equal(a.cpu(), b.cpu())
    return type(a) is type(b) and a == b


def registry() -> List[dict]:
    """The port's contracts: importing the solver modules registers them."""
    from ..solver import compat_kernels, contracts, encode, kernels, merge, pack  # noqa: F401

    return [e for e in contracts.REGISTRY if e["module"].startswith(_PACKAGE)]


def verify_contracts(names: Optional[List[str]] = None, device="cuda",
                     entries: Optional[List[dict]] = None) -> List[ContractResult]:
    """Run every contract (of ``names``, where given; of ``entries``
    instead of the port's registry, where given) at prime sizes on
    ``device`` → one result each. ``device`` resolves as every entry
    point's does: ``cuda`` without a card raises."""
    import torch

    from .. import buildlib
    from ..solver import contracts as C
    from ..solver.backend import resolve_device

    dev = resolve_device(device)
    results: List[ContractResult] = []
    for entry in registry() if entries is None else entries:
        name = entry["name"]
        if names is not None and name not in names:
            continue
        if not entry.get("eval_shape", True):
            results.append(ContractResult(name, True, checked=False, detail="runtime-only (host fn)",
                                          device=dev.type))
            continue
        res = ContractResult(name, False, checked=True, device=dev.type)
        results.append(res)
        t0 = time.perf_counter()
        try:
            seed = zlib.crc32(name.encode())
            built = _inputs(entry, seed, dev)
            if built is None:
                res.ok, res.checked, res.detail = True, False, "unspecced args and no example builder"
                continue
            args, kwargs, sizes = built
            res.sizes = dict(sizes)
            env = dict(sizes)
            for i, spec in enumerate(entry["in_specs"]):
                dims = C._parse(spec)
                if dims is not None and i < len(args):
                    C._check_one(name, f"arg[{i}]", dims, args[i], env)
            kernel = buildlib.KERNELS[ROUTES[name]] if dev.type == "cuda" and name in ROUTES else None
            before = kernel.launches if kernel is not None else 0
            out = entry["fn"](*args, **kwargs)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            C._check_out(name, entry["out"], out, env)
            res.sizes = dict(env)
            if dev.type == "cuda":
                res.kernel = kernel.name if kernel is not None else None
                res.launches = kernel.launches - before if kernel is not None else 0
                cpu_args, cpu_kwargs, _ = _inputs(entry, seed, torch.device("cpu"))
                plain = entry["fn"](*cpu_args, **cpu_kwargs)
                got, want = _outputs(out), _outputs(plain)
                res.bit_equal = len(got) == len(want) and all(_same(a, b) for a, b in zip(got, want))
                if not res.bit_equal:
                    raise AssertionError(f"{name}: the card's outputs differ from the plain version's on the CPU")
                if kernel is not None and res.launches < 1:
                    raise AssertionError(f"{name}: {kernel.name} was not launched on the card")
            res.ok = True
            res.detail = ", ".join(f"{k}={v}" for k, v in sorted(res.sizes.items()))
        except Exception as e:  # noqa: BLE001 — every failure becomes a report entry
            res.ok = False
            res.detail = f"{type(e).__name__}: {e}"[:500]
        finally:
            res.ms = round((time.perf_counter() - t0) * 1000.0, 3)
    return results


def covered(results: List[ContractResult]) -> Dict[str, bool]:
    """The reference's checked contracts → whether the port's counterpart
    was checked and passed in ``results``."""
    by_name = {r.name: r for r in results}
    return {ref: bool(by_name.get(port)) and by_name[port].checked and by_name[port].ok
            for ref, port in REFERENCE_NAMES.items()}
