"""drand48-compatible 48-bit LCG, host half (a copy of scenelib2_tpu/rng.py:37-66).

The reference seeds ``srand48(0)`` once at init (reference
scenelib2/monoslam.cpp:1968) and consumes two ``drand48()`` values per random
feature-init region try (monoslam.cpp:988-989):

    x_{n+1} = (0x5DEECE66D * x_n + 0xB) mod 2^48,   drand48 -> x_{n+1} / 2^48

``srand48(s)`` sets x = (s << 16) | 0x330E. The state lives in
``SlamState.rng`` as three 16-bit limbs. The on-device stepping
(``drand48_step`` / ``drand48_many``) belongs to auto-initialisation, which
this package does not run yet.
"""

from __future__ import annotations

import numpy as np

__all__ = ["srand48", "Drand48", "pack_state", "unpack_state"]

_A = 0x5DEECE66D
_C = 0xB
_MASK = (1 << 48) - 1


def srand48(seed: int) -> int:
    """Return the LCG state set by srand48(seed)."""
    return ((seed << 16) | 0x330E) & _MASK


class Drand48:
    """Host-side exact drand48 stream."""

    def __init__(self, seed: int = 0):
        self.x = srand48(seed)

    def next(self) -> float:
        self.x = (_A * self.x + _C) & _MASK
        return self.x / float(1 << 48)

    def state(self) -> int:
        return self.x


def pack_state(x: int) -> np.ndarray:
    """48-bit LCG state as three 16-bit limbs in a uint32[3] array."""
    return np.array([x & 0xFFFF, (x >> 16) & 0xFFFF, (x >> 32) & 0xFFFF], np.uint32)


def unpack_state(limbs) -> int:
    l = [int(v) for v in np.asarray(limbs)]
    return l[0] | (l[1] << 16) | (l[2] << 32)
