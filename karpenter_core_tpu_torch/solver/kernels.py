"""Signature × type compatibility and offering masks.

Counterpart of ``karpenter_core_tpu/solver/kernels.py``. The compat
check is the tensorized ``Intersects`` (requirements.go:241): per key,
set-intersection nonemptiness is mask overlap (the OTHER slot makes
complement sets exact), with the both-negative carve-out and
missing-key passes.

- ``build_compat_inputs`` / ``zone_ct_masks``: host numpy, copied.
- ``compat_reference`` / ``offering_reference`` / ``allowed_reference``:
  the plain PyTorch versions of the JAX package's ``compat_kernel`` /
  ``offering_kernel`` / ``allowed_kernel`` (one f32 matmul per key).
- ``allowed``: the dispatcher. On the CPU it runs the plain version; on
  a CUDA device it launches the Hopper kernel (solver/compat_kernels.py)
  or raises.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..apis import labels as wk
from .backend import resolve_device
from .contracts import contract
from .encode import EncodedInstanceTypes, SignaturePoolCompat


def build_compat_inputs(
    compats: List[SignaturePoolCompat], enc: EncodedInstanceTypes, vocab
) -> Dict[str, np.ndarray]:
    """Stack per-signature masks into arrays aligned with the catalog's
    key set. Keys only the pod side has are irrelevant to Intersects
    (missing on the type side ⇒ pass) **except** via the offering check,
    handled separately."""
    S = len(compats)
    arrays: Dict[str, np.ndarray] = {}
    for key, type_mask in enc.key_masks.items():
        Vk = type_mask.shape[1]
        sig_mask = np.zeros((S, Vk), dtype=bool)
        sig_has = np.zeros(S, dtype=bool)
        sig_neg = np.zeros(S, dtype=bool)
        for s, c in enumerate(compats):
            if not c.compatible:
                continue
            if key in c.key_has:
                m = c.key_mask[key]
                sig_mask[s, : m.shape[0]] = m[:Vk] if m.shape[0] >= Vk else np.pad(m, (0, Vk - m.shape[0]))
                sig_has[s] = True
                sig_neg[s] = c.key_neg[key]
        arrays[f"mask:{key}"] = sig_mask
        arrays[f"has:{key}"] = sig_has
        arrays[f"neg:{key}"] = sig_neg
    arrays["valid"] = np.array([c.compatible for c in compats], dtype=bool)
    return arrays


def zone_ct_masks(compats, enc: EncodedInstanceTypes) -> Tuple[np.ndarray, np.ndarray]:
    """Signature-level zone / capacity-type admissibility from merged
    requirements (missing key ⇒ all allowed)."""
    S = len(compats)
    zone_ok = np.ones((S, len(enc.zones)), dtype=bool)
    ct_ok = np.ones((S, len(enc.capacity_types)), dtype=bool)
    for s, c in enumerate(compats):
        if not c.compatible or c.merged is None:
            continue
        if c.merged.has(wk.LABEL_TOPOLOGY_ZONE):
            req = c.merged.get_req(wk.LABEL_TOPOLOGY_ZONE)
            zone_ok[s] = [req.has(z) for z in enc.zones]
        if c.merged.has(wk.CAPACITY_TYPE_LABEL_KEY):
            req = c.merged.get_req(wk.CAPACITY_TYPE_LABEL_KEY)
            ct_ok[s] = [req.has(ct) for ct in enc.capacity_types]
    return zone_ok, ct_ok


def compat_arrays(dims, rng) -> tuple:
    """Seeded host inputs of the compat functions for the shape-contract
    pass: two keys of V values over S signatures and T types, masks, has
    and neg bits drawn at random → (sig_arrays, type_masks, type_has,
    type_neg, keys)."""
    S, T, V = dims("S"), dims("T"), dims("V")
    keys = ("key-a", "key-b")
    sig = {"valid": rng.rand(S) < 0.8}
    tm, th, tn = {}, {}, {}
    for k in keys:
        sig[f"mask:{k}"] = rng.rand(S, V) < 0.3
        sig[f"has:{k}"] = rng.rand(S) < 0.7
        sig[f"neg:{k}"] = rng.rand(S) < 0.2
        tm[k] = rng.rand(T, V) < 0.3
        th[k] = rng.rand(T) < 0.7
        tn[k] = rng.rand(T) < 0.2
    return sig, tm, th, tn, keys


def offering_arrays(dims, rng) -> tuple:
    """Seeded (zone_ok (S, Z), ct_ok (S, C), avail (T, Z, C)) bool."""
    S, T, Z, C = dims("S"), dims("T"), dims("Z"), dims("C")
    return rng.rand(S, Z) < 0.6, rng.rand(S, C) < 0.6, rng.rand(T, Z, C) < 0.3


def _compat_example(dims, rng, device):
    sig, tm, th, tn, keys = compat_arrays(dims, rng)
    return tuple(to_tensors(d, device) for d in (sig, tm, th, tn)), {"keys": keys}


def _allowed_example(dims, rng, device):
    (sig, tm, th, tn), kw = _compat_example(dims, rng, device)
    masks = tuple(torch.from_numpy(a).to(device) for a in offering_arrays(dims, rng))
    return (sig, tm, th, tn) + masks, kw


def _allowed_host_example(dims, rng, device):
    sig, tm, th, tn, keys = compat_arrays(dims, rng)
    return (sig, tm, th, tn) + offering_arrays(dims, rng) + (keys,), {"device": device}


@contract(None, None, None, None, out="S T", example=_compat_example)
def compat_reference(
    sig_arrays: Dict[str, torch.Tensor],
    type_masks: Dict[str, torch.Tensor],
    type_has: Dict[str, torch.Tensor],
    type_neg: Dict[str, torch.Tensor],
    keys: Tuple[str, ...],
) -> torch.Tensor:
    """→ (S, T) bool: signature s compatible with instance type t."""
    valid = sig_arrays["valid"]
    S = valid.shape[0]
    T = next(iter(type_masks.values())).shape[0] if type_masks else 0
    ok = valid[:, None].expand(S, T).clone()
    for key in keys:
        q_mask = sig_arrays[f"mask:{key}"].float()  # (S, Vk)
        t_mask = type_masks[key].float()  # (T, Vk)
        overlap = (q_mask @ t_mask.T) > 0  # exact: sums of 0/1 products
        both_has = sig_arrays[f"has:{key}"][:, None] & type_has[key][None, :]
        both_neg = sig_arrays[f"neg:{key}"][:, None] & type_neg[key][None, :]
        ok &= ~both_has | overlap | both_neg
    return ok


@contract("S Z", "S C", "T Z C", dtypes=("b1", "b1", "b1"), out="S T")
def offering_reference(
    zone_ok: torch.Tensor,  # (S, Z) bool
    ct_ok: torch.Tensor,  # (S, C) bool
    avail: torch.Tensor,  # (T, Z, C) bool
) -> torch.Tensor:
    """→ (S, T) bool: some available offering satisfies the signature's
    zone/capacity-type requirements jointly (nodeclaim.go:270
    hasOffering)."""
    pair_ok = (zone_ok[:, :, None] & ct_ok[:, None, :]).reshape(zone_ok.shape[0], -1)
    return (pair_ok.float() @ avail.reshape(avail.shape[0], -1).float().T) > 0


@contract(None, None, None, None, "S Z", "S C", "T Z C", out="S T", example=_allowed_example)
def allowed_reference(
    sig_arrays: Dict[str, torch.Tensor],
    type_masks: Dict[str, torch.Tensor],
    type_has: Dict[str, torch.Tensor],
    type_neg: Dict[str, torch.Tensor],
    zone_ok: torch.Tensor,
    ct_ok: torch.Tensor,
    avail: torch.Tensor,
    keys: Tuple[str, ...],
) -> torch.Tensor:
    """compat ∧ offering → (S, T) bool."""
    compat = compat_reference(sig_arrays, type_masks, type_has, type_neg, keys)
    return compat & offering_reference(zone_ok, ct_ok, avail)


def to_tensors(arrays: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in arrays.items()}


@contract(None, None, None, None, "S Z", "S C", "T Z C", out="S T", example=_allowed_host_example)
def allowed(
    sig_arrays: Dict[str, np.ndarray],
    type_masks: Dict[str, np.ndarray],
    type_has: Dict[str, np.ndarray],
    type_neg: Dict[str, np.ndarray],
    zone_ok: np.ndarray,
    ct_ok: np.ndarray,
    avail: np.ndarray,
    keys: Tuple[str, ...],
    device=None,
) -> torch.Tensor:
    """Host-array drop-in for the JAX package's ``allowed_kernel`` →
    (S, T) bool tensor on ``device`` (``None`` = the card). CPU tensors
    take the plain version; CUDA tensors the Hopper kernel."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        masks = to_tensors({"zone_ok": zone_ok, "ct_ok": ct_ok, "avail": avail}, dev)
        return allowed_reference(
            to_tensors(sig_arrays, dev), to_tensors(type_masks, dev),
            to_tensors(type_has, dev), to_tensors(type_neg, dev),
            masks["zone_ok"], masks["ct_ok"], masks["avail"], keys,
        )
    from .compat_kernels import allowed_via_kernel, catalog_to_device, signature_side

    catalog = catalog_to_device(type_masks, type_has, type_neg, keys, avail, dev)
    return allowed_via_kernel(signature_side(sig_arrays, zone_ok, ct_ok, catalog), catalog)
