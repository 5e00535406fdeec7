"""Random draws that do not depend on the layout.

A tensor split over ranks (columns or heads over the model axis) must hold,
on every rank, the values one process draws at the same global
coordinates. A stream cannot be sliced, so such a tensor is drawn in fixed
units (a layer and a head, 128 columns or 128 vocabulary rows of a DALLE
weight), each from a generator of its own, seeded from a base seed and the
unit's global coordinates (``key_seed``). A rank draws the units that
overlap its block and nothing else. (The VAE's Gumbel noise hashes each
value's coordinates instead: ops/gumbel.py.)
"""

from __future__ import annotations

import hashlib

import torch


def key_seed(*keys) -> int:
    """A 63-bit seed from integer and string ``keys`` (blake2b of their
    reprs): the same keys give the same seed in every process."""
    h = hashlib.blake2b(digest_size=8)
    for k in keys:
        h.update(repr(k).encode())
        h.update(b"\0")
    return int.from_bytes(h.digest(), "little") >> 1


def base_seed(generator: torch.Generator) -> int:
    """One 62-bit draw from ``generator``: the base seed of a keyed draw
    (every rank holding the same generator draws the same one)."""
    return int(torch.randint(0, 2**62, (), generator=generator, device=generator.device))


def units(lo: int, hi: int, size: int, unit: int) -> list[tuple[int, int, int]]:
    """The units of ``unit`` along a dim of ``size`` that overlap [lo, hi):
    (unit index, its start, its stop); the last unit ends at ``size``."""
    return [(j, j * unit, min((j + 1) * unit, size)) for j in range(lo // unit, -(-hi // unit))]
