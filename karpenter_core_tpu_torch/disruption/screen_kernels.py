"""The consolidation capacity screens (B8): ``csrc/disrupt_screen.cu``.

Counterpart of the three float32 screens of
``karpenter_core_tpu/disruption/tpu_repack.py`` (``prefix_screen_kernel``,
``subset_screen_kernel``, ``single_screen_kernel``). Each row of a screen
is True when removing its candidates is capacity-feasible on every
resource column::

    load <= (fleet_free + surviving candidate free) + new_node_cap

Every sum runs over the candidates in candidate order, one float32 add at
a time, so the card's kernel, its g++ host build (``*_host``) and the
plain versions here give the same bits; the reference's XLA order agrees
with them wherever the partial sums stay below 2^24 (every integer there
is exact in float32).

Each wrapper launches the kernel on CUDA tensors (or raises) and runs the
plain version on CPU tensors. Inputs: ``loads`` and ``free`` (N, R)
int32, ``fleet`` and ``cap`` (R,) int32, ``masks`` (S, N) uint8. Output:
(N,) or (S,) bool.
"""

from __future__ import annotations

import ctypes

import torch

from .. import buildlib
from ..tracing import deviceplane

_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 2 + [ctypes.c_void_p] * 2
SCREEN_PREFIX = buildlib.CudaKernel("disrupt_screen.cu", "disrupt_prefix_launch", _ARGS, name="disrupt.prefix_screen")
SCREEN_SUBSETS = buildlib.CudaKernel(
    "disrupt_screen.cu", "disrupt_subsets_launch",
    [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 3 + [ctypes.c_void_p] * 2, name="disrupt.subset_screen",
)
SCREEN_SINGLES = buildlib.CudaKernel("disrupt_screen.cu", "disrupt_singles_launch", _ARGS, name="disrupt.single_screen")
KERNELS = {"prefix": SCREEN_PREFIX, "subsets": SCREEN_SUBSETS, "singles": SCREEN_SINGLES}


def launches() -> int:
    """Launches of the three entry points together."""
    return sum(k.launches for k in KERNELS.values())


# -- plain versions ---------------------------------------------------------------


def _fits(load: torch.Tensor, surviving: torch.Tensor, fleet: torch.Tensor, cap: torch.Tensor) -> torch.Tensor:
    headroom = (fleet.to(torch.float32)[None, :] + surviving) + cap.to(torch.float32)[None, :]
    return (load <= headroom).all(dim=1)


def _running_sums(x: torch.Tensor) -> torch.Tensor:
    """(N, R) → (N, R) float32: row k the sum of rows 0..k, added one row
    at a time."""
    x = x.to(torch.float32)
    out = torch.empty_like(x)
    acc = torch.zeros(x.shape[1], dtype=torch.float32, device=x.device)
    for n in range(x.shape[0]):
        acc = acc + x[n]
        out[n] = acc
    return out


def _total(x: torch.Tensor) -> torch.Tensor:
    """(N, R) → (R,) float32: the sum of the rows, added one at a time."""
    x = x.to(torch.float32)
    acc = torch.zeros(x.shape[1], dtype=torch.float32, device=x.device)
    for n in range(x.shape[0]):
        acc = acc + x[n]
    return acc


def prefix_screen_reference(loads, free, fleet, cap) -> torch.Tensor:
    """Plain version of the prefix screen: row k removes candidates 0..k."""
    cum_free = _running_sums(free)
    total = cum_free[-1] if len(cum_free) else torch.zeros(free.shape[1], dtype=torch.float32, device=free.device)
    return _fits(_running_sums(loads), total[None, :] - cum_free, fleet, cap)


def subset_screen_reference(masks, loads, free, fleet, cap) -> torch.Tensor:
    """Plain version of the subset screen: row s removes the candidates
    masked in ``masks[s]``."""
    S, N = masks.shape
    R = loads.shape[1]
    m = masks.to(torch.bool)
    loads_f, free_f = loads.to(torch.float32), free.to(torch.float32)
    load = torch.zeros((S, R), dtype=torch.float32, device=loads.device)
    surviving = torch.zeros((S, R), dtype=torch.float32, device=loads.device)
    zero = torch.zeros((), dtype=torch.float32, device=loads.device)
    for n in range(N):
        mn = m[:, n, None]
        load = load + torch.where(mn, loads_f[n][None, :], zero)
        surviving = surviving + torch.where(mn, zero, free_f[n][None, :])
    return _fits(load, surviving, fleet, cap)


def single_screen_reference(loads, free, fleet, cap) -> torch.Tensor:
    """Plain version of the single screen: row i removes candidate i alone."""
    surviving = _total(free)[None, :] - free.to(torch.float32)
    return _fits(loads.to(torch.float32), surviving, fleet, cap)


# -- wrappers ------------------------------------------------------------------


def _check(dev, N: int, R: int, loads, free, fleet, cap) -> None:
    buildlib.check_tensor("loads", loads, torch.int32, (N, R), dev)
    buildlib.check_tensor("free", free, torch.int32, (N, R), dev)
    buildlib.check_tensor("fleet", fleet, torch.int32, (R,), dev)
    buildlib.check_tensor("cap", cap, torch.int32, (R,), dev)


def _on_card(dev: torch.device) -> bool:
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return True


@deviceplane.observe("disrupt.prefix_screen")
def screen_prefix(loads, free, fleet, cap) -> torch.Tensor:
    """(N,) bool: the prefix of size k + 1 is capacity-feasible."""
    dev = loads.device
    if not _on_card(dev):
        return prefix_screen_reference(loads, free, fleet, cap)
    N, R = loads.shape
    _check(dev, N, R, loads, free, fleet, cap)
    out = torch.empty(N, dtype=torch.bool, device=dev)
    if N:
        SCREEN_PREFIX.launch(
            loads.data_ptr(), free.data_ptr(), fleet.data_ptr(), cap.data_ptr(), N, R,
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream, device=dev,
        )
    return out


@deviceplane.observe("disrupt.subset_screen")
def screen_subsets(masks, loads, free, fleet, cap) -> torch.Tensor:
    """(S,) bool: removing exactly the candidates of ``masks[s]`` is
    capacity-feasible."""
    dev = loads.device
    if not _on_card(dev):
        return subset_screen_reference(masks, loads, free, fleet, cap)
    S, N = masks.shape
    R = loads.shape[1]
    buildlib.check_tensor("masks", masks, torch.uint8, (S, N), dev)
    _check(dev, N, R, loads, free, fleet, cap)
    out = torch.empty(S, dtype=torch.bool, device=dev)
    if S:
        SCREEN_SUBSETS.launch(
            masks.data_ptr(), loads.data_ptr(), free.data_ptr(), fleet.data_ptr(), cap.data_ptr(),
            S, N, R, out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream, device=dev,
        )
    return out


@deviceplane.observe("disrupt.single_screen")
def screen_singles(loads, free, fleet, cap) -> torch.Tensor:
    """(N,) bool: removing candidate i alone is capacity-feasible."""
    dev = loads.device
    if not _on_card(dev):
        return single_screen_reference(loads, free, fleet, cap)
    N, R = loads.shape
    _check(dev, N, R, loads, free, fleet, cap)
    out = torch.empty(N, dtype=torch.bool, device=dev)
    if N:
        SCREEN_SINGLES.launch(
            loads.data_ptr(), free.data_ptr(), fleet.data_ptr(), cap.data_ptr(), N, R,
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream, device=dev,
        )
    return out
