"""Host contract and wrapper of the Hopper compat∧offering kernel.

Counterpart of ``karpenter_core_tpu/solver/pallas_kernels.py``. The TPU
kernel multiplies 128-lane f32 chunks per key on the MXU; the operands
are 0/1, so here each key's mask is bit-packed into 32-bit words and
the overlap test is ``any(sig_word & typ_word)`` (``csrc/
compat_allowed.cu``).

Layout (``PackedLayout``): per requirement key a run of
``ceil((Vk + 3) / 32)`` words holding its Vk value bits and then three
flag bits, U_s (¬has on the signature side, 1 on the type side), U_t (1
on the signature side, ¬has on the type side) and N (neg on both), so
the OR over the key's words of ``sig & typ`` is exactly ¬(has_s ∧
has_t) ∨ overlap ∨ (neg_s ∧ neg_t). The offering is one more key over
the flattened zone × capacity-type axis, without flag bits: signature
bits are zone_ok × ct_ok ∧ valid, type bits are avail. So one launch
yields the solver's whole (S, T) ``allowed`` matrix from words alone:
no flag arrays, no ``valid``. Pad bits are zero on both sides. On the
device each side is a word-major plane, (W, N) int32, and the kernel
takes the planes and the K + 1 key word offsets.

Dispatch: a CPU tensor goes to the plain PyTorch version
(``allowed_packed_reference``); a CUDA tensor launches the kernel or
raises. The wrapper picks the kernel's tile shape on S
(``tile_for``). The kernel is compiled with ``nvcc`` at first use into
the port's build directory and called through ``ctypes``.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import buildlib
from ..tracing import deviceplane
from .contracts import contract

WORD_BITS = 32
# flag bits after each requirement key's value bits: U_s, U_t, N
FLAG_BITS = 3
SIG, TYP = "sig", "typ"
# row blocks are multiples of 32 signatures (128-byte aligned plane columns)
TILE_S = 32
# per-dispatch budget for the (rows, T) uint8 output — the JAX package's
# KARPENTER_TPU_COMPAT_TILE_MB default of 64 MB (pallas_kernels.py:36-48)
COMPAT_TILE_BYTES = 64_000_000
# name of the offering chunk in a layout's key list
OFFERING_KEY = "\0offering"
# the kernel's tile shapes (csrc/compat_allowed.cu Small / Large) and
# their (signature rows, type columns) per block
TILE_SMALL, TILE_LARGE = 0, 1
TILES = {TILE_SMALL: (4, 64), TILE_LARGE: (64, 64)}
# signatures at or below this take the small tile (4 rows, threads along
# T): on an H100 it beat the large tile up to S = 65 and was within 3 % of
# it at S = 128, T = 2048 (PERF.md)
SMALL_S_MAX = 128
# key offsets the kernel holds in shared memory (csrc MAX_KEYS)
MAX_KEYS = 1023



def tile_for(S: int) -> int:
    """The kernel's tile shape for S signature rows."""
    return TILE_SMALL if S <= SMALL_S_MAX else TILE_LARGE


@dataclass(frozen=True)
class PackedLayout:
    """Word layout shared by the signature and type sides."""

    keys: Tuple[str, ...]  # requirement keys, then OFFERING_KEY if present
    values: Tuple[int, ...]  # value bits per key (Vk; Z·C for the offering)

    def flag_bits(self, k: int) -> int:
        return 0 if self.keys[k] == OFFERING_KEY else FLAG_BITS

    @property
    def words(self) -> Tuple[int, ...]:
        """Words per key: ceil((Vk + flag bits) / 32), at least one."""
        return tuple(_n_words(v + self.flag_bits(k)) for k, v in enumerate(self.values))

    @property
    def offsets(self) -> Tuple[int, ...]:
        out = [0]
        for w in self.words:
            out.append(out[-1] + w)
        return tuple(out)

    @property
    def width(self) -> int:
        return sum(self.words)

    def key_offsets(self) -> np.ndarray:
        """(K + 1,) int32: each key's first word, then W."""
        return np.asarray(self.offsets, dtype=np.int32)

    def with_offering(self, bits: int) -> "PackedLayout":
        return PackedLayout(self.keys + (OFFERING_KEY,), self.values + (int(bits),))


def _n_words(bits: int) -> int:
    return max(1, -(-int(bits) // WORD_BITS))


def layout_for(key_masks: Dict[str, np.ndarray], keys: Sequence[str]) -> PackedLayout:
    """Tight layout: Vk value bits and the flag bits per key."""
    return PackedLayout(tuple(keys), tuple(int(key_masks[k].shape[1]) for k in keys))


def pack_side(
    key_masks: Dict[str, np.ndarray],  # key → (N, Vk) bool
    key_has: Dict[str, np.ndarray],  # key → (N,) bool
    key_neg: Dict[str, np.ndarray],  # key → (N,) bool
    layout: PackedLayout,
    n: int,
    side: str,  # SIG or TYP: which flag bit carries ¬has
    offering: Optional[np.ndarray] = None,  # (N, Z·C) bool when the layout has it
    valid: Optional[np.ndarray] = None,  # (N,) bool, signature side: ANDed into the offering
) -> np.ndarray:
    """One side in ``layout`` → words (N, W) int32; bit j of word w is
    bit 32·w + j of the side's bit row."""
    if side not in (SIG, TYP):
        raise ValueError(f"side must be {SIG!r} or {TYP!r}, got {side!r}")
    bits = np.zeros((n, layout.width * WORD_BITS), dtype=bool)
    for k, (key, off, vk) in enumerate(zip(layout.keys, layout.offsets, layout.values)):
        lo = off * WORD_BITS
        if key == OFFERING_KEY:
            if offering is None:
                raise ValueError("layout has an offering chunk but no offering bits were given")
            value_bits = np.asarray(offering, dtype=bool)
            if valid is not None:
                value_bits = value_bits & np.asarray(valid, dtype=bool)[:, None]
        else:
            value_bits = np.asarray(key_masks[key], dtype=bool)
        if value_bits.shape != (n, vk):
            raise ValueError(f"{key!r}: expected {(n, vk)} value bits, got {value_bits.shape}")
        bits[:, lo : lo + vk] = value_bits
        if key == OFFERING_KEY:
            continue
        not_has = ~np.asarray(key_has[key], dtype=bool)
        bits[:, lo + vk] = not_has if side == SIG else True  # U_s
        bits[:, lo + vk + 1] = True if side == SIG else not_has  # U_t
        bits[:, lo + vk + 2] = np.asarray(key_neg[key], dtype=bool)  # N
    packed = np.packbits(bits, axis=1, bitorder="little")  # (N, 4·W) u8
    return np.ascontiguousarray(packed).view("<u4").astype(np.uint32).view(np.int32)


def pack_masks(
    key_masks: Dict[str, np.ndarray],
    key_has: Dict[str, np.ndarray],
    key_neg: Dict[str, np.ndarray],
    keys: Sequence[str],
    side: str,
) -> Tuple[np.ndarray, PackedLayout]:
    """Counterpart of ``pallas_kernels.pack_masks``: per-key masks →
    (words (N, W) int32, layout), tight layout, no offering chunk."""
    n = next(iter(key_masks.values())).shape[0] if key_masks else 0
    layout = layout_for(key_masks, keys)
    return pack_side(key_masks, key_has, key_neg, layout, n, side), layout


def compat_row_block(T: int, budget_bytes: int = COMPAT_TILE_BYTES) -> int:
    """Signature rows per launch so one launch's (rows, T) uint8 output
    stays under the budget; a multiple of ``TILE_S``."""
    rows = int(budget_bytes // max(T, 1))
    return max(TILE_S, (rows // TILE_S) * TILE_S)


# -- device catalog (the counterpart of solver._entry_device_packed) ----------


@dataclass
class DeviceCatalog:
    """Type side of the kernel, resident on ``device`` for one catalog
    encoding at one vocab width."""

    layout: PackedLayout
    planes: torch.Tensor  # (W, T) int32, word-major (``to_planes``)
    key_off: torch.Tensor  # (K + 1,) int32
    device: torch.device

    @property
    def n_types(self) -> int:
        return int(self.planes.shape[1])

    def __deviceplane__(self):
        """What the device plane's signature registry records of it."""
        return (self.planes, self.key_off)


def to_planes(words: np.ndarray, device) -> torch.Tensor:
    """(N, W) words → the word-major (W, N) int32 plane on ``device``: a
    view with unit stride along N into zero-padded storage of (W,
    round_up(N, 4)), so the kernel stages every row of words in 16-byte
    copies, whatever N."""
    W, n = words.shape[1], words.shape[0]
    storage = np.zeros((W, -(-n // 4) * 4), dtype=np.int32)
    storage[:, :n] = words.T
    return torch.from_numpy(storage).to(torch.device(device))[:, :n]


def _check_plane(name: str, plane: torch.Tensor) -> None:
    """The kernel's contract for a plane: unit stride along its rows, a
    pitch of 4k words and a 16-byte-aligned start (``to_planes`` storage,
    or a slice of it starting at a multiple of 4 rows)."""
    if plane.stride(1) != 1 or plane.stride(0) % 4 or plane.data_ptr() % 16:
        raise ValueError(
            f"{name}: needs unit stride along rows, a pitch of 4k words and a 16-byte "
            f"aligned start (strides {plane.stride()}, address {plane.data_ptr():#x})"
        )


def _catalog(words: np.ndarray, layout: PackedLayout, device) -> DeviceCatalog:
    dev = torch.device(device)
    return DeviceCatalog(
        layout=layout,
        planes=to_planes(words, dev),
        key_off=torch.from_numpy(layout.key_offsets()).to(dev),
        device=dev,
    )


def catalog_to_device(
    type_masks: Dict[str, np.ndarray],
    type_has: Dict[str, np.ndarray],
    type_neg: Dict[str, np.ndarray],
    keys: Sequence[str],
    avail: np.ndarray,  # (T, Z, C) bool
    device,
) -> DeviceCatalog:
    """Pack a catalog encoding (plus its offering chunk) and upload it."""
    T = avail.shape[0]
    layout = layout_for(type_masks, keys).with_offering(avail[0].size if T else 1)
    offering = avail.reshape(T, -1) if T else np.zeros((0, 1), dtype=bool)
    words = pack_side(type_masks, type_has, type_neg, layout, T, TYP, offering=offering)
    return _catalog(words, layout, device)


def catalog_from_reference(
    tp: np.ndarray,  # (T, W) f32 0/1 in 128-lane chunks (pallas_kernels.pack_masks)
    th: np.ndarray,  # (T, K) f32 has
    tn: np.ndarray,  # (T, K) f32 neg
    offsets: Sequence[int],
    widths: Sequence[int],
    avail: np.ndarray,  # (T, Z, C) bool
    device,
) -> DeviceCatalog:
    """The port's device catalog from the JAX package's packed type side
    (as ``pallas_kernels.pack_masks`` and ``solver._entry_device_packed``
    produce it): each key's 128-lane chunks become its value bits (pad
    lanes are zero bits), followed by the flag bits. Keys are named by
    position (``k0``, ``k1``, …); pack the signature side with
    ``signature_side(..., keys=<the key names>)``, which pads each
    signature mask to the chunk width."""
    T = tp.shape[0]
    keys = tuple(f"k{i}" for i in range(len(offsets)))
    masks = {k: tp[:, o : o + w] > 0 for k, o, w in zip(keys, offsets, widths)}
    has = {k: th[:, i] > 0 for i, k in enumerate(keys)}
    neg = {k: tn[:, i] > 0 for i, k in enumerate(keys)}
    layout = PackedLayout(keys, tuple(int(w) for w in widths)).with_offering(
        avail[0].size if T else 1
    )
    words = pack_side(masks, has, neg, layout, T, TYP, offering=avail.reshape(T, -1))
    return _catalog(words, layout, device)


def signature_side(
    sig_arrays: Dict[str, np.ndarray],  # kernels.build_compat_inputs layout
    zone_ok: np.ndarray,  # (S, Z)
    ct_ok: np.ndarray,  # (S, C)
    catalog: DeviceCatalog,
    keys: Optional[Sequence[str]] = None,
) -> torch.Tensor:
    """Pack the signature side in the catalog's layout and move it to the
    catalog's device → the word-major (W, S) int32 plane. ``keys`` maps
    the layout's requirement keys to ``sig_arrays`` names when they differ
    (the positional keys of ``catalog_from_reference``); a mask narrower
    than the layout's key is zero-padded."""
    layout = catalog.layout
    req_keys = [k for k in layout.keys if k != OFFERING_KEY]
    src = list(keys) if keys is not None else req_keys
    S = sig_arrays["valid"].shape[0]
    values = dict(zip(layout.keys, layout.values))
    masks = {}
    for k, name in zip(req_keys, src):
        m = np.asarray(sig_arrays[f"mask:{name}"], dtype=bool)
        masks[k] = np.pad(m, ((0, 0), (0, values[k] - m.shape[1]))) if m.shape[1] < values[k] else m
    has = {k: sig_arrays[f"has:{s}"] for k, s in zip(req_keys, src)}
    neg = {k: sig_arrays[f"neg:{s}"] for k, s in zip(req_keys, src)}
    offering = (zone_ok[:, :, None] & ct_ok[:, None, :]).reshape(S, -1)
    words = pack_side(
        masks, has, neg, layout, S, SIG, offering=offering, valid=sig_arrays["valid"]
    )
    return to_planes(words, catalog.device)


# -- plain PyTorch version -----------------------------------------------------


def unpack_bits(words: torch.Tensor) -> torch.Tensor:
    """(N, W) int32 → (N, 32·W) bool, inverse of the packing."""
    shifts = torch.arange(WORD_BITS, dtype=torch.int32, device=words.device)
    return ((words.unsqueeze(-1) >> shifts) & 1).bool().reshape(words.shape[0], -1)


def allowed_packed_reference(
    sig_planes: torch.Tensor,  # (W, S) int32
    typ_planes: torch.Tensor,  # (W, T) int32
    layout: PackedLayout,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on the same packed inputs:
    unpack the bits, one f32 matmul per key (exact: sums of 0/1
    products), AND over keys of "some bit in common" → (S, T) bool."""
    S, T = sig_planes.shape[1], typ_planes.shape[1]
    sig_bits = unpack_bits(sig_planes.T).float()
    typ_bits = unpack_bits(typ_planes.T).float()
    ok = torch.ones((S, T), dtype=torch.bool, device=sig_planes.device)
    offsets = layout.offsets
    for k in range(len(layout.keys)):
        lo, hi = offsets[k] * WORD_BITS, offsets[k + 1] * WORD_BITS
        ok &= (sig_bits[:, lo:hi] @ typ_bits[:, lo:hi].T) > 0
    return ok


# -- the kernel ----------------------------------------------------------------


class _CompatAllowedKernel(buildlib.CudaKernel):
    """ctypes binding of ``compat_allowed_launch``; ``launches`` counts
    every launch it makes."""

    def __init__(self) -> None:
        super().__init__(
            "compat_allowed.cu", "compat_allowed_launch",
            [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 6 + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p],
            name="kernels.allowed_kernel",
        )

    def launch(
        self,
        sig_planes: torch.Tensor,  # (W, S) int32, unit stride along S
        catalog: DeviceCatalog,
        out: torch.Tensor,  # (S, T) uint8, contiguous
        tile: Optional[int] = None,
    ) -> None:
        W, S = sig_planes.shape
        T = catalog.n_types
        K = len(catalog.layout.keys)
        dev = catalog.planes.device
        for name, t, dtype, shape in (
            ("sig_planes", sig_planes, torch.int32, (catalog.layout.width, S)),
            ("typ_planes", catalog.planes, torch.int32, (W, T)),
            ("key_off", catalog.key_off, torch.int32, (K + 1,)),
            ("out", out, torch.uint8, (S, T)),
        ):
            if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
                raise ValueError(
                    f"{name}: expected {dtype} {shape} on {dev}, "
                    f"got {t.dtype} {tuple(t.shape)} on {t.device}"
                )
        _check_plane("sig_planes", sig_planes)
        _check_plane("typ_planes", catalog.planes)
        if not out.is_contiguous():
            raise ValueError("out: expected a contiguous tensor")
        if not 1 <= K <= MAX_KEYS:
            raise ValueError(f"the kernel takes 1..{MAX_KEYS} keys, got {K}")
        if S == 0 or T == 0:
            return
        tile = tile_for(S) if tile is None else tile
        if tile not in TILES:
            raise ValueError(f"unknown tile shape {tile}")
        super().launch(
            sig_planes.data_ptr(), catalog.planes.data_ptr(), catalog.key_off.data_ptr(),
            S, T, W, K, sig_planes.stride(0), catalog.planes.stride(0), out.data_ptr(), tile,
            torch.cuda.current_stream(dev).cuda_stream, device=dev,
        )


COMPAT_ALLOWED = _CompatAllowedKernel()
SRC = COMPAT_ALLOWED.src


def _planes_example(dims, rng, device):
    """The shape-contract pass's inputs for ``allowed_via_kernel``: the
    seeded compat and offering inputs packed, the catalog on ``device``."""
    from .kernels import compat_arrays, offering_arrays

    sig, tm, th, tn, keys = compat_arrays(dims, rng)
    zone_ok, ct_ok, avail = offering_arrays(dims, rng)
    catalog = catalog_to_device(tm, th, tn, keys, avail, device)
    return (signature_side(sig, zone_ok, ct_ok, catalog), catalog), {}


def _compat_via_example(dims, rng, device):
    from .kernels import compat_arrays

    sig, tm, th, tn, keys = compat_arrays(dims, rng)
    return (sig, tm, th, tn, keys, device), {}


@deviceplane.observe("kernels.allowed_kernel", static_names=("budget_bytes",))
@contract("W S", None, out="S T", example=_planes_example, static={"budget_bytes": COMPAT_TILE_BYTES})
def allowed_via_kernel(
    sig_planes: torch.Tensor,
    catalog: DeviceCatalog,
    budget_bytes: int = COMPAT_TILE_BYTES,
) -> torch.Tensor:
    """Counterpart of ``allowed_pallas``: compat ∧ valid ∧ offering against
    the device-resident catalog → (S, T) bool on the catalog's device,
    row-blocked by ``compat_row_block``. A CPU catalog takes the plain
    version; a CUDA catalog launches the kernel (or raises)."""
    S, T = sig_planes.shape[1], catalog.n_types
    block = compat_row_block(T, budget_bytes)
    if catalog.device.type == "cpu":
        rows = [
            allowed_packed_reference(sig_planes[:, s0 : s0 + block], catalog.planes, catalog.layout)
            for s0 in range(0, S, block)
        ]
        return torch.cat(rows) if rows else torch.zeros((0, T), dtype=torch.bool)
    if catalog.device.type != "cuda":
        raise ValueError(f"unsupported device {catalog.device}")
    out = torch.empty((S, T), dtype=torch.uint8, device=catalog.device)
    for s0 in range(0, S, block):
        s1 = min(s0 + block, S)
        COMPAT_ALLOWED.launch(sig_planes[:, s0:s1], catalog, out[s0:s1])
    return out.view(torch.bool)


@deviceplane.observe("kernels.compat_kernel", static_names=("keys", "budget_bytes"))
@contract(None, None, None, None, None, None, out="S T", example=_compat_via_example,
          static={"budget_bytes": COMPAT_TILE_BYTES})
def compat_via_kernel(
    sig_arrays: Dict[str, np.ndarray],
    type_masks: Dict[str, np.ndarray],
    type_has: Dict[str, np.ndarray],
    type_neg: Dict[str, np.ndarray],
    keys: Tuple[str, ...],
    device,
    budget_bytes: int = COMPAT_TILE_BYTES,
) -> torch.Tensor:
    """Counterpart of ``compat_via_pallas``: host dicts in the layout of
    ``kernels.compat_reference`` → (S, T) bool compat ∧ valid on
    ``device`` (the offering chunk is all-ones, so only valid rides it)."""
    T = next(iter(type_masks.values())).shape[0] if type_masks else 0
    S = sig_arrays["valid"].shape[0]
    ones_t = np.ones((T, 1, 1), dtype=bool)
    catalog = catalog_to_device(type_masks, type_has, type_neg, keys, ones_t, device)
    planes = signature_side(
        sig_arrays, np.ones((S, 1), dtype=bool), np.ones((S, 1), dtype=bool), catalog
    )
    return allowed_via_kernel(planes, catalog, budget_bytes)
