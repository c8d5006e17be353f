"""drand48: the 48-bit LCG that the reference draws its init regions from.

The reference seeds ``srand48(0)`` once at init (monoslam.cpp:1968) and
takes two ``drand48()`` values for each try of a feature-init region
(monoslam.cpp:988-989):

    x_{n+1} = (0x5DEECE66D * x_n + 0xB) mod 2^48,   drand48 -> x_{n+1} / 2^48

``srand48(s)`` sets x = (s << 16) | 0x330E.
"""

from __future__ import annotations

_A = 0x5DEECE66D
_C = 0xB
_MASK = (1 << 48) - 1


def srand48(seed: int) -> int:
    """The LCG state that srand48(seed) sets."""
    return ((seed << 16) | 0x330E) & _MASK


class Drand48:
    """One drand48 stream."""

    def __init__(self, seed: int = 0):
        self.x = srand48(seed)

    def next(self) -> float:
        self.x = (_A * self.x + _C) & _MASK
        return self.x / float(1 << 48)
