"""The premises of K10b's design (csrc/particle_kform.cu), held on the CPU
through Python mirrors of the kernel's index map and its tail, kept here
(k10b_grid, k10b_lanes, k10b_rows; a change to the kernel's step changes its
mirror here):

(a) the grid of (slot, block of K10B_THREADS lanes), one particle a thread:
    thread t of CTA (f, b) takes lane b K10B_THREADS + t of slot f, which
    covers every element of every slot's 8 rows exactly once at every row
    width from 128 to 16,384 lanes (the wrapper pads NP to a multiple of
    K10B_THREADS, so every thread has a lane), and the launch takes a row up
    to 65,535 blocks wide and refuses a wider one;
(b) the tail as the kernel runs it (particle_chain.cuh particle_tail, the
    depths at or past NP taken at lambda = 1), mirrored in float32 torch over
    the threads of the grid, equals particle.kform_rows_plain bit for bit
    (NaN equal to NaN) on seeded slots and degenerate depths.
"""

from __future__ import annotations

import os
import re

import numpy as np
import pytest
import torch

from scenelib2_torch.config import Params
from scenelib2_torch.kernels import particle
from scenelib2_torch.kernels.bayes import padded_lanes

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "scenelib2_torch", "kernels", "csrc")


def _define(name: str) -> int:
    with open(os.path.join(CSRC, "particle_kform.cu")) as f:
        return int(re.search(rf"#define {name} (\d+)", f.read()).group(1))


THREADS = _define("K10B_THREADS")
MAX_BLOCKS = 65535   # a grid's y extent


def k10b_grid(F: int, lanes: int):
    """k10b_particle_kform's grid (F, blocks) for rows of `lanes` lanes, None
    where it refuses the launch."""
    if lanes % THREADS != 0 or lanes // THREADS > MAX_BLOCKS:
        return None
    return F, lanes // THREADS


def k10b_lanes(F: int, lanes: int) -> np.ndarray:
    """The flat index into out [F, 8, lanes] of every store of the kernel:
    [F, blocks, THREADS, 8] (CTA (f, b), thread t, row r)."""
    _F, blocks = k10b_grid(F, lanes)
    f = np.arange(F)[:, None, None, None]
    b = np.arange(blocks)[None, :, None, None]
    t = np.arange(THREADS)[None, None, :, None]
    r = np.arange(8)[None, None, None, :]
    return f * 8 * lanes + r * lanes + b * THREADS + t


def test_threads_match_the_wrapper():
    assert THREADS == 128
    # the wrapper's rows are whole blocks at every NP
    assert all(padded_lanes(NP) % THREADS == 0 for NP in range(1, 20000, 7))


@pytest.mark.parametrize("F", [1, 5])
def test_index_map_covers_every_lane_once(F):
    for lanes in range(128, 16384 + 1, 128):
        got = k10b_lanes(F, lanes).reshape(-1)
        assert np.array_equal(np.sort(got), np.arange(F * 8 * lanes)), lanes


@pytest.mark.parametrize("F, NP, blocks", [
    (64, 100, 1), (16, 200, 2), (8, 1100, 9), (4, 5120, 40), (2, 16384, 128), (32, 16384, 128),
    (1, 1, 1), (3, 129, 2), (1, MAX_BLOCKS * 128, MAX_BLOCKS), (1, MAX_BLOCKS * 128 + 1, None),
])
def test_grid(F, NP, blocks):
    got = k10b_grid(F, padded_lanes(NP))
    assert got == (None if blocks is None else (F, blocks))


def particle_tail(lam, g, c: particle.ParticleConsts):
    """particle_chain.cuh particle_tail over every thread at once: lam [...]
    (each thread's depth), g [..., 33] the slot's geometry (broadcast);
    [..., 8] rows."""
    f32 = torch.float32

    def k(v):
        return torch.tensor(v, dtype=f32)

    def G(i):
        return g[..., i]

    two_kd1, neg_two_kd1 = k(2.0 * c.kd1), k(-2.0 * c.kd1)
    x = G(0) + lam * G(3)
    y = G(1) + lam * G(4)
    z = G(2) + lam * G(5)
    invz = 1.0 / z
    ucx = -k(c.fku) * x * invz
    ucy = -k(c.fkv) * y * invz
    r2 = ucx * ucx + ucy * ucy
    d = 1.0 + two_kd1 * r2
    d12 = torch.sqrt(d)
    hu = ucx / d12 + k(c.u0c)
    hv = ucy / d12 + k(c.v0c)
    c1 = 1.0 / d12
    c3 = neg_two_kd1 / (d12 * d)
    m00 = ucx * ucx * c3 + c1
    m01 = ucx * ucy * c3
    m11 = ucy * ucy * c3 + c1
    j00 = -k(c.fku) * invz
    j11 = -k(c.fkv) * invz
    j02 = k(c.fku) * x * invz * invz
    j12 = k(c.fkv) * y * invz * invz
    a00, a01, a02 = m00 * j00, m01 * j11, m00 * j02 + m01 * j12
    a10, a11, a12 = m01 * j00, m11 * j11, m01 * j02 + m11 * j12
    lam2 = lam * lam

    def kl(r, s):
        return G(6 + 3 * r + s) + lam * G(15 + 3 * r + s) + lam2 * G(24 + 3 * r + s)

    k00, k01, k02, k11, k12, k22 = kl(0, 0), kl(0, 1), kl(0, 2), kl(1, 1), kl(1, 2), kl(2, 2)
    t00 = a00 * k00 + a01 * k01 + a02 * k02
    t01 = a00 * k01 + a01 * k11 + a02 * k12
    t02 = a00 * k02 + a01 * k12 + a02 * k22
    t10 = a10 * k00 + a11 * k01 + a12 * k02
    t11 = a10 * k01 + a11 * k11 + a12 * k12
    t12 = a10 * k02 + a11 * k12 + a12 * k22
    s00 = t00 * a00 + t01 * a01 + t02 * a02
    s01 = t00 * a10 + t01 * a11 + t02 * a12
    s11 = t10 * a10 + t11 * a11 + t12 * a12
    du, dv = hu - k(c.u0c), hv - k(c.v0c)
    dist = torch.sqrt(du * du + dv * dv)
    sd = k(c.sd0) * (1.0 + dist / k(c.maxdist))
    rr = sd * sd
    s00 = s00 + rr
    s11 = s11 + rr
    l11 = torch.sqrt(s00)
    l21 = s01 / l11
    l22 = torch.sqrt(s11 - l21 * l21)
    i11 = 1.0 / l11
    i22 = 1.0 / l22
    i21 = -l21 * i11 * i22
    q00 = i11 * i11 + i21 * i21
    q01 = i21 * i22
    q11 = i22 * i22
    det = s00 * s11 - s01 * s01
    ns = k(c.no_sigma)
    hw = torch.floor(ns / torch.sqrt(q00 - q01 * q01 / q11))
    hh = torch.floor(ns / torch.sqrt(q11 - q01 * q01 / q00))
    return torch.stack([hu, hv, q00, q01, q11, det, hw, hh], dim=-1)


def k10b_rows(zeroed, K0, Ks, K2, lam, c) -> torch.Tensor:
    """K10b's [F, 8, lanes] output as its grid writes it: every thread's
    depth (1.0 at or past NP), particle_tail over it, and the rows stored at
    the thread's indices."""
    Fn, NP = lam.shape
    lanes = padded_lanes(NP)
    g = torch.cat([zeroed.reshape(Fn, 6), K0.reshape(Fn, 9), Ks.reshape(Fn, 9), K2.reshape(Fn, 9)], -1)
    _F, blocks = k10b_grid(Fn, lanes)
    lane = torch.arange(blocks * THREADS)                               # thread b THREADS + t
    lam_t = torch.where(lane < NP, lam[:, lane.clamp(max=NP - 1)], torch.ones((), dtype=lam.dtype))
    rows = particle_tail(lam_t, g[:, None, :], c)                       # [F, threads, 8]
    out = torch.full((Fn * 8 * lanes,), float("nan"))
    idx = torch.as_tensor(k10b_lanes(Fn, lanes)).reshape(Fn, -1, 8)     # [F, threads, 8]
    out[idx.reshape(-1)] = rows.reshape(-1)
    return out.reshape(Fn, 8, lanes)


def _seeded_slots(rng, n):
    """n slots' kform inputs: the geometry K10's prologue computes from a
    seeded camera row and slot rows (as chip_smoke.py's k10b_seeded does)."""
    q = np.array([1.0, *rng.normal(0, 0.02, 3)])
    d = 7 + 6 * n
    M = rng.normal(size=(d, d))
    s = np.sqrt(np.r_[np.full(7, 1e-5), np.full(6 * n, 1e-4)])
    C = s[:, None] * (np.eye(d) + 0.5 * M @ M.T / d) * s[None, :]
    shared = np.concatenate([rng.normal(0, 0.01, 3), q / np.linalg.norm(q), C[:7, :7].ravel()])
    rows = []
    for k in range(n):
        h = np.array([*rng.normal(0, 0.06, 2), 1.0])
        o = 7 + 6 * k
        rows.append(np.concatenate([rng.normal(0, 0.1, 3), h / np.linalg.norm(h), C[:7, o : o + 6].ravel(),
                                    C[o : o + 6, o : o + 6].ravel()]))
    f32 = torch.float32
    zr, zh, K0, Ks, K2 = particle.geometry_prologue(torch.tensor(shared, dtype=f32)[None, None],
                                                    torch.tensor(np.stack(rows), dtype=f32)[None])
    return torch.cat([zr, zh], -1).reshape(n, 6), K0.reshape(n, 3, 3), Ks.reshape(n, 3, 3), K2.reshape(n, 3, 3)


def _same(a, b) -> bool:
    return bool(((a.view(torch.int32) == b.view(torch.int32)) | (torch.isnan(a) & torch.isnan(b))).all())


@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("NP", [1, 100, 128, 129, 200, 1100, 5120, 16384])
def test_tail_mirror_equals_plain(NP, n):
    rng = np.random.default_rng(NP + n)
    c = particle.ParticleConsts.from_params(Params())
    args = _seeded_slots(rng, n)
    lam = torch.tensor(np.tile(np.linspace(0.5, 5.0, NP), (n, 1)), dtype=torch.float32)
    want = particle.kform_rows_plain(*args, lam, c)
    got = k10b_rows(*args, lam, c)
    assert got.shape == want.shape == (n, 8, padded_lanes(NP))
    assert _same(got, want)
    assert torch.isfinite(want).all()


@pytest.mark.parametrize("at", [0, 128])
def test_tail_mirror_degenerate_depths(at):
    """A ray through the camera centre side: lambda negative, 0, tiny, huge
    (z <= 0, infinities and NaN in the rows), in the first block of lanes or
    the second."""
    rng = np.random.default_rng(7)
    c = particle.ParticleConsts.from_params(Params())
    args = _seeded_slots(rng, 2)
    row = [1.0] * 200
    row[at : at + 5] = [-1.0, 0.0, 1e-30, 0.5, 1e30]
    lam = torch.tensor([row] * 2, dtype=torch.float32)
    want = particle.kform_rows_plain(*args, lam, c)
    assert not torch.isfinite(want).all()
    assert _same(k10b_rows(*args, lam, c), want)
