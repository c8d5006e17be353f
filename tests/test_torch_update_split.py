"""K3's decomposition over a thread-block cluster (csrc/ekf_update.cu),
mirrored in plain tensor code and held to K3's plain twin bit for bit.

The kernel no longer forms P' = P - (W S) W' whole and then transforms it:
CTA 0 computes the prefix (H, nu, R; P H' at the rows H reads, then S; L^-1
on one warp while the others form P H' at every row; S^-1, W, x', W S), the
strips of P' in rows and columns 3..6 and from them the quaternion-norm
transform's columns (cols) and rows (rowsb); CTA 1 the bookkeeping; then
the CTAs take the upper-triangle tiles of P, forming both P'[i][j] and
P'[j][i] with the same left-to-right sum over m, overwriting rows and
columns 3..6 from rowsb and cols, applying the keep mask and writing both
halves of P/2 + P'/2. split_update below is that order of operations,
written on the plain twin's own helpers (seqsum, chol_linv, dqnorm_by_dq,
bookkeeping); it must equal joint_update_plain exactly (every float
operation the same, only regrouped into strips and tiles) at D = 19, 109
and 373 (NSEL 10): with no match at all, one match, killed slots and a
mixed frame, on the kernel's 64 x 64 tiles (ragged at both D) and on 5 x 5
tiles, whose edge cuts the quaternion block.

The port at the two new sizes is also held to the JAX kernel it replaces
(pallas_ekf.py::pallas_joint_update_norm_compact, interpret mode), with
tests/test_torch_kernels.py's tolerance: x', P' within 1e-4 of the largest
|entry|, decisions exactly.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scenelib2_tpu.kernels import pallas_measure as jpm
from scenelib2_tpu.kernels.pallas_ekf import pallas_joint_update_norm_compact
from scenelib2_torch.config import Params
from scenelib2_torch.core.quaternion import dqnorm_by_dq, seqsum
from scenelib2_torch.kernels import measure
from scenelib2_torch.kernels.chol_inv import chol_linv
from scenelib2_torch.kernels.ekf_update import (
    CAM_DIM, SLOT_DIM, UpdateConsts, bookkeeping, joint_update, joint_update_plain,
)

P_STD = Params()
NSEL = 10
UC = UpdateConsts.from_params(P_STD)
K3_TOL = 1e-4
MODES = ("none", "one", "kill", "mixed")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(D: int, mode: str, seed: int):
    """K3's inputs at D = 13 + 6 MF, NSEL 10, as numpy arrays (the layout of
    tests/test_torch_kernels.py::_k3_scene). mode: "none" (no match),
    "one" (exactly one), "kill" (three list-consecutive scheduled slots:
    two die), "mixed"."""
    rng = np.random.default_rng(seed)
    MF = (D - CAM_DIM) // SLOT_DIM
    A = rng.normal(size=(D, D))
    P = A @ A.T / D * 1e-3 + np.eye(D) * 1e-4
    x = rng.normal(size=D) * 0.1
    x[3:7] = rng.normal(size=4)
    x[3:7] /= np.linalg.norm(x[3:7]) * (1.0 + 1e-3)
    sel = np.zeros((measure.NOUT, NSEL), np.float32)
    sel[measure.O_HX : measure.O_HX + 14] = rng.normal(size=(14, NSEL))
    sel[measure.O_HY : measure.O_HY + 6] = rng.normal(size=(6, NSEL))
    sel[measure.O_RD] = rng.uniform(1.0, 2.0, NSEL)
    h = rng.uniform(20, 200, (NSEL, 2))
    sel[measure.O_H : measure.O_H + 2] = h.T
    z = (h + rng.normal(0, 1.0, (NSEL, 2))).astype(np.float32)
    active = rng.uniform(size=MF) > 0.2
    sel_mask = rng.uniform(size=NSEL) > 0.2
    n_sel = min(MF, NSEL)
    sel_mask[n_sel:] = False            # K1 selects at most MF slots; the rest repeat, unselected
    succ = sel_mask & (rng.uniform(size=NSEL) > 0.4)
    if mode == "none":
        succ[:] = False
    elif mode == "one":
        succ[:] = False
        succ[int(rng.integers(n_sel))] = True
        sel_mask |= succ
    top_idx = np.resize(rng.permutation(MF)[:n_sel], NSEL).astype(np.int32)
    active[top_idx[sel_mask]] = True
    attempts = (rng.integers(0, 14, MF) * active).astype(np.int32)
    successes = (attempts * rng.uniform(0.0, 1.0, MF)).astype(np.int32)
    sched = (rng.uniform(size=MF) > 0.6) & active
    label = np.where(active, rng.permutation(MF), -1).astype(np.int32)
    if mode == "kill":
        order = np.argsort(np.where(active, label, 1 << 30), kind="stable")
        run = order[: min(3, MF)]
        active[run] = True
        sched[run] = True
    return (x.astype(np.float32), P.astype(np.float32), sel, z, succ, (13 + 6 * top_idx).astype(np.int32),
            attempts, successes, sched, active, label, sel_mask, top_idx)


def _torch(a):
    return tuple(torch.tensor(v) for v in a)


def split_update(x, P, sel, z, succ, offs, attempts, successes, sched, active, label, sel_mask, top_idx,
                 c: UpdateConsts, tile: int = 64):
    """K3 in the kernel's order of work: CTA 0's prefix and strips, CTA 1's
    bookkeeping, then the upper-triangle tiles of side `tile`."""
    D = x.shape[0]
    M = 2 * NSEL
    dt = x.dtype
    # ---- CTA 0: H, nu, R; P H'; S; L^-1; S^-1; W; x'; W S (the twin's formulas)
    sf = succ.to(dt)
    hx = (sel[measure.O_HX : measure.O_HX + 14].T.reshape(NSEL, 2, 7) * sf[:, None, None]).reshape(M, 7)
    hy = (sel[measure.O_HY : measure.O_HY + 6].T.reshape(NSEL, 2, 3) * sf[:, None, None]).reshape(M, 3)
    nu = (sf[:, None] * (z - sel[measure.O_H : measure.O_H + 2].T)).reshape(M)
    rd = torch.repeat_interleave(torch.where(succ, sel[measure.O_RD], torch.ones((), dtype=dt)), 2)
    offm = torch.repeat_interleave(offs.long(), 2)
    def pht(rows):
        """P H' at these rows (the twin's formula)."""
        Pr = P[rows]
        return seqsum([Pr[:, a : a + 1] * hx[None, :, a] for a in range(7)]
                      + [Pr[:, offm + j] * hy[None, :, j] for j in range(3)])

    # S from P H' at the 7 + 3 NSEL rows H reads only (0..6, each slot's 3)
    hrows = torch.cat([torch.arange(7), (offs.long()[:, None] + torch.arange(3)).reshape(-1)])
    PHs = pht(hrows)
    ks = 7 + 3 * (torch.arange(M) // 2)
    S = seqsum([hx[:, a : a + 1] * PHs[a, None, :] for a in range(7)]
               + [hy[:, j : j + 1] * PHs[ks + j, :] for j in range(3)]) + torch.diag(rd)
    Linv = chol_linv(S)
    # meanwhile (the other warps): P H' at every row
    PHt = pht(torch.arange(D))
    Sinv = seqsum([Linv[k, :, None] * Linv[k, None, :] for k in range(M)])
    W = seqsum([PHt[:, m : m + 1] * Sinv[m, None, :] for m in range(M)])
    x_upd = x + seqsum([nu[m] * W[:, m] for m in range(M)])
    WS = seqsum([W[:, m : m + 1] * S[m, None, :] for m in range(M)])
    # ---- CTA 0: the strips of P' (columns 3..6 of every row, rows 3..6 of
    # every column), the transform's cols [D, 4] and rowsb [4, D]
    colstrip = P[:, 3:7] - seqsum([WS[:, m : m + 1] * W[None, 3:7, m] for m in range(M)])
    rowstrip = P[3:7, :] - seqsum([WS[3:7, m : m + 1] * W[None, :, m] for m in range(M)])
    J = dqnorm_by_dq(x_upd[3:7])
    cols = seqsum([colstrip[:, k : k + 1] * J[None, :, k] for k in range(4)])
    pt = rowstrip.clone()
    pt[:, 3:7] = cols[3:7, :]
    rowsb = seqsum([J[:, k : k + 1] * pt[k, None, :] for k in range(4)])
    any_succ = bool(succ.any())
    # ---- CTA 1: bookkeeping and the keep factors
    att, suc, sched_after, kill = bookkeeping(attempts, successes, sched, active, label, sel_mask, succ,
                                              top_idx, c)
    keep = torch.cat([torch.ones(CAM_DIM, dtype=dt), torch.repeat_interleave((~kill).to(dt), SLOT_DIM)])
    x_out = (x_upd if any_succ else x) * keep

    def transformed(r, cc, pvals, acc):
        """P' at rows r x columns cc after the transform (P where no match)."""
        if not any_succ:
            return pvals
        v = pvals - acc
        in_c = (cc >= 3) & (cc < 7)
        v = torch.where(in_c[None, :], cols[r][:, (cc - 3).clamp(0, 3)], v)
        in_r = (r >= 3) & (r < 7)
        return torch.where(in_r[:, None], rowsb[(r - 3).clamp(0, 3)][:, cc], v)

    # ---- every CTA: the tiles (I <= J) of P/2 + P'/2
    out = torch.full_like(P, float("nan"))
    nT = math.ceil(D / tile)
    for I in range(nT):
        i = torch.arange(I * tile, min(D, I * tile + tile))
        for Jt in range(I, nT):
            j = torch.arange(Jt * tile, min(D, Jt * tile + tile))
            acc_ij = seqsum([WS[i, m, None] * W[None, j, m] for m in range(M)])
            acc_ji = seqsum([WS[j, m, None] * W[None, i, m] for m in range(M)])
            pij = transformed(i, j, P[i][:, j], acc_ij)
            pji = transformed(j, i, P[j][:, i], acc_ji)
            k2 = keep[i][:, None] * keep[j][None, :]
            a = pij * k2
            b = pji.T * k2
            out[i[:, None], j[None, :]] = a * 0.5 + b * 0.5
            out[j[:, None], i[None, :]] = (b * 0.5 + a * 0.5).T
    return x_out, out, att, suc, sched_after, kill


CASES = ([(D, mode, 64) for D in (19, 109, 373) for mode in MODES]
         + [(D, mode, 5) for D in (19, 109) for mode in MODES])


@pytest.mark.parametrize("D,mode,tile", CASES)
def test_split_order_equals_the_plain_twin_bit_for_bit(D, mode, tile):
    a = _torch(_scene(D, mode, seed=D + MODES.index(mode)))
    got = split_update(*a, UC, tile=tile)
    want = joint_update_plain(*a, UC)
    names = ("x'", "P'", "attempts", "successes", "sched", "kill")
    for n, g, w in zip(names, got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), f"{n} differs at D={D} {mode} tile={tile}"
    if mode == "kill":
        assert bool(want[5].any())
    if mode == "none":
        keep = torch.cat([torch.ones(CAM_DIM, dtype=torch.bool), torch.repeat_interleave(~want[5], SLOT_DIM)])
        assert torch.equal(want[1], torch.where(keep[:, None] & keep[None, :], a[1], torch.zeros(())))


@pytest.mark.parametrize("D,mode", [(19, "mixed"), (19, "none"), (373, "mixed"), (373, "kill")])
def test_k3_matches_pallas_at_new_sizes(D, mode):
    x, P, sel, z, succ, offs, att, suc, sched, active, label, sel_mask, top_idx = _scene(D, mode, seed=7 * D)
    want = pallas_joint_update_norm_compact(
        jnp.asarray(x), jnp.asarray(P), jnp.asarray(sel), jnp.asarray(z), jnp.asarray(succ),
        jnp.asarray(offs), None, meas_rows=(jpm.O_HX, jpm.O_HY, jpm.O_RD, jpm.O_H), interpret=True,
        bookkeeping=(jnp.asarray(att), jnp.asarray(suc), jnp.asarray(sched), jnp.asarray(active),
                     jnp.asarray(label)),
        sel_mask=jnp.asarray(sel_mask), top_idx=jnp.asarray(top_idx),
        mina=float(P_STD.min_attempted_measurements), frac=float(P_STD.successful_match_fraction))
    got = joint_update(*_torch((x, P, sel, z, succ, offs, att, suc, sched, active, label, sel_mask, top_idx)),
                       UC)
    xo, Po, att2, suc2, sched2, kill = (t.numpy() for t in got)
    wx, wP, watt, wsuc, wsched, wkill = (np.asarray(t) for t in want)
    np.testing.assert_array_equal(att2, watt)
    np.testing.assert_array_equal(suc2, wsuc)
    np.testing.assert_array_equal(sched2, wsched)
    np.testing.assert_array_equal(kill, wkill)
    np.testing.assert_array_equal(Po, Po.T)
    for name, g, w in (("x'", xo, wx), ("P'", Po, wP)):
        scale = float(np.abs(w).max())
        assert np.abs(g - w).max() <= K3_TOL * scale, f"{name} at D={D} {mode}"
