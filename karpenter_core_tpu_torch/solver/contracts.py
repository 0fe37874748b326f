"""Shape contracts for the solver's tensor functions.

The port's copy of ``karpenter_core_tpu/solver/contracts.py``. A
contract declares the dimensional type of a tensor function once, at the
def site, in einops-style letters::

    @contract("G P R", "G F R", "G", out=("G P", "G"))
    def ffd_pack_batched(requests, frontiers, caps, k_open=16, n_pods=None): ...

Same letter = same size, bound left to right across arguments and then
checked on the outputs; integer tokens pin an exact size; ``"()"``
accepts a 0-d tensor or a Python scalar; ``None`` skips an argument
(dicts, static config). Letters that first appear in ``out`` bind free
(e.g. the frontier count of ``pareto_frontier``): only their arity and
already-bound letters are checked. Shapes are read from ``.shape``, so
torch tensors and numpy arrays both check, on the host, with no device
work.

Runtime checking is off by default, as in the reference, and costs one
truthiness check per call while off. The reference turns it on with its
``KARPENTER_TPU_SHAPE_CONTRACTS`` knob; the port has the module flag
``_ENABLED``, set by :func:`enable` (the port's tests turn it on in their
fixtures, ``chip_smoke.py`` for its whole card run).

Every contract also lands in ``REGISTRY`` for the shape-contract pass
(``python -m karpenter_core_tpu_torch.analysis --contracts``), which
binds each letter to a distinct prime, runs the function on seeded
inputs of those sizes and checks its outputs against the specs. The
decorator takes the reference's keywords for it: ``dtypes`` (aligned
with the specs, default int32), ``example`` (a builder for inputs a spec
cannot describe: ``example(dims, rng, device)`` → ``(args, kwargs)``),
``static`` (keyword arguments the pass passes as they are) and
``eval_shape=False`` (a host function the pass skips; the reference's
name for it).

Keep this module dependency-free: every solver module imports it.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Sequence, Tuple

_ENABLED = False

#: every contracted function, for the shape-contract pass: dicts with fn
#: (undecorated), name, in_specs, out, dtypes, example, static, eval_shape
REGISTRY: List[dict] = []


class ContractError(TypeError):
    """A tensor function was called with (or returned) shapes violating
    its declared contract."""


def enable(on: bool = True) -> None:
    """Turn runtime checking on (or off)."""
    global _ENABLED
    _ENABLED = on


def enabled() -> bool:
    return _ENABLED


def _parse(spec: Optional[str]) -> Optional[Tuple[str, ...]]:
    if spec is None:
        return None
    spec = spec.strip()
    if spec in ("()", ""):
        return ()
    return tuple(spec.split())


def _shape_of(value: Any) -> Optional[Tuple[int, ...]]:
    shape = getattr(value, "shape", None)
    if shape is not None:
        try:
            return tuple(int(d) for d in shape)
        except TypeError:
            return None
    if isinstance(value, (int, float, bool)):
        return ()  # Python scalar ⇒ 0-d
    return None


def _check_one(
    name: str, what: str, dims: Tuple[str, ...], value: Any, env: Dict[str, int]
) -> None:
    shape = _shape_of(value)
    if shape is None:
        raise ContractError(
            f"{name}: {what} expected an array of rank {len(dims)} "
            f"({' '.join(dims) or 'scalar'}), got {type(value).__name__}"
        )
    if len(shape) != len(dims):
        raise ContractError(
            f"{name}: {what} expected rank {len(dims)} ({' '.join(dims) or 'scalar'}), "
            f"got shape {shape}"
        )
    for letter, actual in zip(dims, shape):
        if letter in ("*", "_"):
            continue
        if letter.isdigit():
            if actual != int(letter):
                raise ContractError(
                    f"{name}: {what} dim '{letter}' expected {letter}, got {actual} "
                    f"(shape {shape})"
                )
            continue
        bound = env.get(letter)
        if bound is None:
            env[letter] = actual
        elif bound != actual:
            raise ContractError(
                f"{name}: {what} dim '{letter}'={actual} contradicts "
                f"'{letter}'={bound} bound earlier (shape {shape})"
            )


def _check_out(name: str, out_specs, result: Any, env: Dict[str, int]) -> None:
    if out_specs is None:
        return
    if isinstance(out_specs, str):
        parts: List[Optional[str]] = [out_specs]
        values: tuple = (result,)
    else:
        parts = list(out_specs)
        values = tuple(result) if isinstance(result, (tuple, list)) else (result,)
        if len(parts) != len(values):
            raise ContractError(
                f"{name}: output expected {len(parts)} values, got {len(values)}"
            )
    for i, (spec, value) in enumerate(zip(parts, values)):
        dims = _parse(spec)
        if dims is None:
            continue
        _check_one(name, f"output[{i}]", dims, value, env)


def contract(
    *in_specs: Optional[str],
    out=None,
    dtypes: Optional[Sequence[str]] = None,
    example=None,
    static: Optional[dict] = None,
    eval_shape: bool = True,
):
    """Declare a shape contract. ``in_specs`` align with positional
    parameters; ``out`` is a spec or tuple of specs; ``dtypes``,
    ``example``, ``static`` and ``eval_shape`` feed the shape-contract
    pass (module docstring)."""
    parsed_in = [_parse(s) for s in in_specs]

    def deco(fn):
        name = getattr(fn, "__name__", str(fn))

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _ENABLED:
                return fn(*args, **kwargs)
            env: Dict[str, int] = {}
            for i, dims in enumerate(parsed_in):
                if dims is None or i >= len(args):
                    continue
                _check_one(name, f"arg[{i}]", dims, args[i], env)
            result = fn(*args, **kwargs)
            _check_out(name, out, result, env)
            return result

        wrapper.__shape_contract__ = {
            "name": name,
            "fn": fn,
            "module": getattr(fn, "__module__", ""),
            "in_specs": tuple(in_specs),
            "out": out,
            "dtypes": tuple(dtypes) if dtypes is not None else None,
            "example": example,
            "static": dict(static or {}),
            "eval_shape": eval_shape,
        }
        REGISTRY.append(wrapper.__shape_contract__)
        return wrapper

    return deco
