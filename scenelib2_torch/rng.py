"""drand48-compatible 48-bit LCG (a port of scenelib2_tpu/rng.py).

The reference seeds ``srand48(0)`` once at init (reference
scenelib2/monoslam.cpp:1968) and consumes two ``drand48()`` values per random
feature-init region try (monoslam.cpp:988-989):

    x_{n+1} = (0x5DEECE66D * x_n + 0xB) mod 2^48,   drand48 -> x_{n+1} / 2^48

``srand48(s)`` sets x = (s << 16) | 0x330E. The state lives in
``SlamState.rng`` as three 16-bit limbs (int32). The host half (``Drand48``,
``pack_state``) seeds it; the tensor half (``drand48_step``,
``drand48_many``) steps it on the state's device without leaving it, and is
the plain reference of the draws inside the K5 kernel
(kernels/csrc/propose.cu).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["srand48", "Drand48", "pack_state", "unpack_state", "drand48_step",
           "drand48_many", "jump_constants", "jump_limbs", "host_drand48_sequence"]

_A = 0x5DEECE66D
_C = 0xB
_MASK = (1 << 48) - 1
_M16 = 0xFFFF


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


def host_drand48_sequence(seed: int, n: int) -> np.ndarray:
    r = Drand48(seed)
    return np.array([r.next() for _ in range(n)], np.float64)


def _limbs_value(r0, r1, r2, dtype):
    """x / 2^48 from the limbs (exact in float64)."""
    return (r2.to(dtype) * (65536.0 * 65536.0) + r1.to(dtype) * 65536.0
            + r0.to(dtype)) * (1.0 / float(1 << 48))


def _affine(a, c, s0, s1, s2):
    """Limbs of (a * x + c) mod 2^48 for limb triples a, c (int64 tensors)
    and the state limbs s. Column sums are taken in int64, so they are exact;
    each output limb is the low 16 bits of its column plus the carry, the
    same limbs as the JAX package's uint32 arithmetic (which wraps only above
    the bits an output limb reads)."""
    a0, a1, a2 = a
    c0, c1, c2 = c
    p0 = a0 * s0 + c0
    r0 = p0 & _M16
    p1 = a0 * s1 + a1 * s0 + c1 + (p0 >> 16)
    r1 = p1 & _M16
    p2 = a0 * s2 + a1 * s1 + a2 * s0 + c2 + (p1 >> 16)
    r2 = p2 & _M16
    return r0, r1, r2


def _split(v: int, device) -> list:
    return [torch.tensor((v >> sh) & _M16, dtype=torch.int64, device=device) for sh in (0, 16, 32)]


def drand48_step(state: torch.Tensor, dtype=torch.float64):
    """One draw on the [3] limb state: (new_state [3] in state's dtype,
    value = new_state / 2^48 in `dtype`)."""
    s = state.to(torch.int64)
    r0, r1, r2 = _affine(_split(_A, s.device), _split(_C, s.device), s[0], s[1], s[2])
    return torch.stack([r0, r1, r2]).to(state.dtype), _limbs_value(r0, r1, r2, dtype)


def jump_constants(n: int):
    """(A^{i+1} mod 2^48, C*(A^i+...+A+1) mod 2^48) for i = 0..n-1, as
    Python ints: n sequential LCG steps are one affine map x_i = Ai*x0 + Ci."""
    ai, ci = [], []
    a, c = _A, _C
    for _ in range(n):
        ai.append(a)
        ci.append(c)
        c = (_A * c + _C) & _MASK
        a = (a * _A) & _MASK
    return ai, ci


@functools.lru_cache(maxsize=None)
def jump_limbs(n: int, device: str):
    """The limbs of the n jump constants as int64 [n] tensors on `device`,
    (a0, a1, a2), (c0, c1, c2). Cached: the host-to-device copy happens once
    per (n, device), so a step that calls drand48_many every frame makes no
    host synchronisation after its first frame."""
    ai, ci = jump_constants(n)

    def limbs(xs, sh):
        return torch.tensor([(x >> sh) & _M16 for x in xs], dtype=torch.int64, device=device)

    return (tuple(limbs(ai, sh) for sh in (0, 16, 32)),
            tuple(limbs(ci, sh) for sh in (0, 16, 32)))


def drand48_many(state: torch.Tensor, n: int, dtype=torch.float64):
    """n draws from the [..., 3] limb state; returns (states [..., n, 3],
    values [..., n]); leading (lane) dimensions hold independent streams.

    states[i] is the state after i + 1 draws, so a caller that consumes a
    data-dependent number k of draws selects states[k - 1] (or keeps the
    state for k = 0) and stays in lockstep with the reference. All n states
    come from the closed form x_i = A^{i+1} x_0 + C_i mod 2^48 at once."""
    a, c = jump_limbs(n, str(state.device))
    s = state.to(torch.int64)
    r0, r1, r2 = _affine(a, c, s[..., 0:1], s[..., 1:2], s[..., 2:3])
    return torch.stack([r0, r1, r2], dim=-1).to(state.dtype), _limbs_value(r0, r1, r2, dtype)
