"""K3: fused joint EKF update + quaternion-norm transform + feature bookkeeping.

Replaces the TPU kernel scenelib2_tpu/kernels/pallas_ekf.py
(``pallas_joint_update_norm_compact`` / ``_update_kernel_compact``, with
``pallas_linalg.py::chol_linv_body`` inside). Stages 4-6 of the step
(reference kalman.cpp:72-119, monoslam.cpp:616-637, :644-703, :145-150):

  H, R, nu built from K1's selected columns: row 2k+i of H holds hx (state
    dims 0..6) and hy (the slot's dims off_k..off_k+2), scaled by the match
    flag; a failed match gives H = 0, nu = 0, R = 1;
  S = H P H' + R; its Cholesky factor and L^-1 by the right-looking
    recurrences of chol_linv_body; S^-1 = L^-T L^-1; W = P H' S^-1;
    x' = x + W nu; P' = P - (W S) W';
  the quaternion-'normalisation' transform of P' by the reference's qq=|q|^2
    Jacobian (the state's quaternion is NOT renormalised, PARITY rows 3-4);
  the any-success gate (no match: x and P pass through unchanged);
  bookkeeping: attempt/success counters, the failure-ratio test, the
    exterminate run-parity kill in label order (labels ranked as int32) with
    the persistent scheduled flag;
  zero the killed slots' rows/cols and entries, then P = P/2 + P'/2.

Bound on an H100: P in and out (0.1 MB at D = 109, 1.1 MB at D = 373) and
D^2 M multiply-adds, under a microsecond; the launch and the 2M dependent
factorisation / substitution steps cost more. Design (csrc/ekf_update.cu):
one launch of a thread-block cluster of 8 CTAs. CTA 0 runs the O(D M^2 + M^3)
prefix (H is never formed: 10 non-zeros a row, read from the selected
columns; the factorisation in one warp's registers at M <= 32, from a
build whose M is fixed when compiled, chol_inv.reg_defines) up to W, W S, x' and the transform's
rows and columns 3..6; CTA 1 the bookkeeping; both publish to a global
workspace that the wrapper allocates; after the cluster barrier every CTA
forms its share of the 64 x 64 tiles of the upper triangle, both halves of
P/2 + P'/2 at once. The phases from L^-1 on are csrc/update_cluster.cuh,
which K15 shares.

K15 (joint_update_dense) replaces the TPU kernel's non-compact sibling,
pallas_ekf.py::pallas_joint_update_norm (pallas_call at pallas_ekf.py:150,
kernel :39-114), which no step route reaches (the JAX step calls it only
when fused_update holds without fast_kpath, and fused_update implies
fast_kpath): H [M, D], nu [M] and R [M, M] come in dense, S = H P H' + R
sums over every state dimension, the update from S on is the one K3's twin
runs (update_tail), then the any-success select, the keep mask as a
multiply (a NaN in a deleted row stays NaN) and P/2 + P'/2, with P' formed
as the TPU kernel forms it, a product by the identity (a non-finite entry
spreads NaN along its row of P'). Bound on an H100 at D = 109, M = 20:
~0.1 MB in and out and ~2 MFLOP, a microsecond at most. Design
(csrc/ekf_update_dense.cu): K3's cluster of 8 CTAs and its phases from L^-1
on (update_cluster.cuh); each CTA stages its rows of P and H' in shared
memory and forms the dense P H' at those rows into CTA 0's shared memory;
CTA 0 forms S and factorises in one warp's registers at M <= 32 (a build
for each M, reg_defines); the CTAs form 32 x 32 tiles and count each
column's non-finite entries, and only where a count is not zero form them
again with the TPU kernel's transposition rule, after another cluster
barrier. At large M (D = M = 128) the M x M arrays move from shared memory
to the workspace (the form is picked at launch).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from scenelib2_torch.core.ekf import symmetrize
from scenelib2_torch.core.quaternion import dqnorm_by_dq, seqsum
from scenelib2_torch.kernels import _build
from scenelib2_torch.kernels.chol_inv import chol_linv, reg_defines
from scenelib2_torch.kernels.measure import NOUT, O_H, O_HX, O_HY, O_RD

CAM_DIM = 13
SLOT_DIM = 6
NAME = "ekf_update"
NAME_DENSE = "ekf_update_dense"   # K15: its own library (csrc/ekf_update_dense.cu) and launch count
DENSE_MAX = 128                   # K15's D and M (pallas_ekf.py:136, one 128-lane row)


@dataclass(frozen=True)
class UpdateConsts:
    min_attempts: float       # min_attempted_measurements
    success_fraction: float   # successful_match_fraction

    @staticmethod
    def from_params(p) -> "UpdateConsts":
        return UpdateConsts(float(p.min_attempted_measurements), float(p.successful_match_fraction))


def bookkeeping(attempts, successes, sched, active, label, sel_mask, succ, top_idx,
                c: UpdateConsts):
    """Counter updates, failure-ratio test and the exterminate iterator-skip
    closed form (monoslam.cpp:644-703, docs/PARITY.md): in list order
    (ascending label among active slots), within each maximal run of
    consecutively scheduled positions only even run offsets die this frame.
    Returns (attempts', successes', sched', kill)."""
    MF = attempts.shape[0]
    dev = attempts.device
    idx = top_idx.long()
    # scatter-add, as the TPU kernel and K3 do: a slot selected twice counts twice
    att = attempts.index_add(0, idx, sel_mask.to(torch.int32))
    suc = successes.index_add(0, idx, succ.to(torch.int32))
    f32 = torch.float32
    ratio = torch.where(att > 0, suc.to(f32) / torch.clamp(att, min=1).to(f32),
                        torch.ones((), dtype=f32, device=dev))
    bad = active & (att.to(f32) >= c.min_attempts) & (ratio < c.success_fraction)
    sched1 = (sched | bad) & active
    key = torch.where(active, label, torch.full_like(label, 1 << 30))
    lanes = torch.arange(MF, device=dev)
    before = (key[None, :] < key[:, None]) | (
        (key[None, :] == key[:, None]) & (lanes[None, :] < lanes[:, None]))
    rank = before.sum(dim=1)                              # list position of slot i
    order = torch.empty_like(rank)
    order[rank] = lanes                                   # slot at list position p
    s_sorted = sched1[order]
    pos = lanes
    run_start = torch.cummax(torch.where(s_sorted, torch.zeros_like(pos), pos + 1), dim=0).values
    kill_pos = s_sorted & ((pos - run_start) % 2 == 0)
    kill = kill_pos[rank]
    return att, suc, sched1 & ~kill, kill


def update_tail(x, P, PHt, S, nu):
    """The update from S on, shared by the twins of K3 and K15 (the kernels
    run it as their cluster's phases, csrc/update_cluster.cuh):
    L^-1 of S (chol_linv), S^-1 = L^-T L^-1, W = P H' S^-1, x' = x + W nu,
    P' = P - (W S) W', then P' transformed by the quaternion-norm Jacobian
    with the qq=|q|^2 quirk (pallas_ekf.py:68-90). PHt [D, M] = P H', S
    [M, M] = H P H' + R, nu [M]. Returns (x' [D], the transformed P' [D, D])."""
    M = S.shape[0]
    Linv = chol_linv(S)
    Sinv = seqsum([Linv[k, :, None] * Linv[k, None, :] for k in range(M)])
    W = seqsum([PHt[:, m : m + 1] * Sinv[m, None, :] for m in range(M)])
    x_upd = x + seqsum([nu[m] * W[:, m] for m in range(M)])
    WS = seqsum([W[:, m : m + 1] * S[m, None, :] for m in range(M)])
    P_upd = P - seqsum([WS[:, m : m + 1] * W[None, :, m] for m in range(M)])

    # quaternion-norm Jacobian with the qq=|q|^2 quirk (pallas_ekf.py:246-268)
    J = dqnorm_by_dq(x_upd[3:7])
    cols = seqsum([P_upd[:, 3 + k : 4 + k] * J[None, :, k] for k in range(4)])   # [D,4]
    PT = P_upd.clone()
    PT[:, 3:7] = cols
    P_norm = PT.clone()
    P_norm[3:7, :] = seqsum([J[:, k : k + 1] * PT[3 + k, None, :] for k in range(4)])
    return x_upd, P_norm


def joint_update_plain(x, P, sel, z, succ, offs, attempts, successes, sched, active, label,
                       sel_mask, top_idx, c: UpdateConsts):
    """Plain PyTorch K3. sel [NOUT, NSEL] (K1's selected columns), z [NSEL,2]
    matched pixels, succ [NSEL] bool, offs [NSEL] i32 slot offsets,
    bookkeeping fields [MF], sel_mask [NSEL] bool, top_idx [NSEL] i32.
    Returns (x' [D], P' [D,D], attempts', successes', sched', kill)."""
    D = x.shape[0]
    NSEL = sel.shape[1]
    M = 2 * NSEL
    dev, dt = x.device, x.dtype
    sf = succ.to(dt)
    hx = (sel[O_HX : O_HX + 14].T.reshape(NSEL, 2, 7) * sf[:, None, None]).reshape(M, 7)
    hy = (sel[O_HY : O_HY + 6].T.reshape(NSEL, 2, 3) * sf[:, None, None]).reshape(M, 3)
    nu = (sf[:, None] * (z - sel[O_H : O_H + 2].T)).reshape(M)
    rd = torch.where(succ, sel[O_RD], torch.ones((), dtype=dt, device=dev))
    rd = torch.repeat_interleave(rd, 2)
    offm = torch.repeat_interleave(offs.long(), 2)        # [M] slot offset per row

    # PHt[d, m] = sum of H's 10 non-zeros of row m, state dims ascending
    PHt = seqsum([P[:, a : a + 1] * hx[None, :, a] for a in range(7)]
                  + [P[:, offm + j] * hy[None, :, j] for j in range(3)])
    S = seqsum([hx[:, a : a + 1] * PHt[a, None, :] for a in range(7)]
                + [hy[:, j : j + 1] * PHt[offm + j, :] for j in range(3)])
    S = S + torch.diag(rd)
    x_upd, P_norm = update_tail(x, P, PHt, S, nu)

    any_succ = succ.any()
    P_sel = torch.where(any_succ, P_norm, P)
    x_sel = torch.where(any_succ, x_upd, x)

    att, suc, sched_after, kill = bookkeeping(
        attempts, successes, sched, active, label, sel_mask, succ, top_idx, c)
    keep = torch.cat([torch.ones(CAM_DIM, dtype=dt, device=dev),
                      torch.repeat_interleave((~kill).to(dt), SLOT_DIM)])
    P_del = P_sel * (keep[:, None] * keep[None, :])
    x_del = x_sel * keep
    return x_del, symmetrize(P_del), att, suc, sched_after, kill


class _K3Params(ctypes.Structure):
    _fields_ = [("min_attempts", ctypes.c_float), ("success_fraction", ctypes.c_float)]


# tensor pointers (13 inputs, 6 outputs, the workspace), ints, the params struct, the stream
_ARGTYPES = [ctypes.c_void_p] * 20 + [ctypes.c_int] * 3 + [ctypes.POINTER(_K3Params), ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def workspace_floats(D: int, NSEL: int) -> int:
    """Floats of K3's workspace (csrc/ekf_update.cu::k3_layout): W' and
    (W S)' [M][Dp], the transform's columns and rows [Dp][4], [4][Dp], the
    keep factors [Dp] and the any-match flag, Dp = D rounded up to 32."""
    fn = _build.function(NAME, "k3_workspace_floats", [ctypes.c_int, ctypes.c_int], reg_defines(2 * NSEL))
    return int(fn(D, NSEL))


def joint_update(x, P, sel, z, succ, offs, attempts, successes, sched, active, label,
                 sel_mask, top_idx, c: UpdateConsts):
    """K3. A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (or raises). Same outputs as joint_update_plain."""
    args = (x, P, sel, z, succ, offs, attempts, successes, sched, active, label, sel_mask, top_idx)
    if x.device.type == "cpu":
        return joint_update_plain(*args, c)
    D = x.shape[0]
    NSEL = sel.shape[1]
    MF = attempts.shape[0]
    if not (D == CAM_DIM + SLOT_DIM * MF and 2 * NSEL <= 64 and MF <= 256):
        raise ValueError(f"K3: unsupported shapes D={D} NSEL={NSEL} MF={MF}")
    f32, i32, b = torch.float32, torch.int32, torch.bool
    for t, name, dty, shp in (
        (x, "x", f32, (D,)), (P, "P", f32, (D, D)), (sel, "sel", f32, (NOUT, NSEL)),
        (z, "z", f32, (NSEL, 2)), (succ, "succ", b, (NSEL,)), (offs, "offs", i32, (NSEL,)),
        (attempts, "attempts", i32, (MF,)), (successes, "successes", i32, (MF,)),
        (sched, "sched", b, (MF,)), (active, "active", b, (MF,)), (label, "label", i32, (MF,)),
        (sel_mask, "sel_mask", b, (NSEL,)), (top_idx, "top_idx", i32, (NSEL,)),
    ):
        _build.check_tensor(t, name, dty, shp)
    xo = torch.empty_like(x)
    Po = torch.empty_like(P)
    att = torch.empty_like(attempts)
    suc = torch.empty_like(successes)
    sch = torch.empty_like(sched)
    kill = torch.empty_like(sched)
    ws = torch.empty(workspace_floats(D, NSEL), dtype=f32, device=x.device)
    prm = _K3Params(min_attempts=c.min_attempts, success_fraction=c.success_fraction)
    fn = _build.function(NAME, "k3_joint_update", _ARGTYPES, reg_defines(2 * NSEL))
    err = fn(
        *(t.data_ptr() for t in args), xo.data_ptr(), Po.data_ptr(), att.data_ptr(),
        suc.data_ptr(), sch.data_ptr(), kill.data_ptr(), ws.data_ptr(), D, NSEL, MF, ctypes.byref(prm),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "K3 joint_update")
    _build.launches[NAME] += 1
    return xo, Po, att, suc, sch, kill


def joint_update_dense_plain(x, P, H, nu, R, any_succ, keep_dims):
    """Plain PyTorch K15. x [D], P [D, D], H [M, D], nu [M], R [M, M] f32;
    any_succ [] bool; keep_dims [D] bool. Returns (x' [D], P' [D, D]): the
    update from S = H P H' + R (sums over the state dimensions in ascending
    order), the quaternion-norm transform, the prior where any_succ is
    false, the deleted dimensions zeroed by a multiply (a NaN there stays
    NaN), and P/2 + P'/2 with P' the TPU kernel's product by the identity
    (transpose_by_identity: on a finite P, P' exactly)."""
    f32 = torch.float32
    x, P, H, nu, R = (t.to(f32) for t in (x, P, H, nu, R))
    D = x.shape[0]
    PHt = seqsum([P[:, k : k + 1] * H[None, :, k] for k in range(D)])        # [D, M]
    S = seqsum([H[:, k : k + 1] * PHt[k, None, :] for k in range(D)]) + R
    x_upd, P_norm = update_tail(x, P, PHt, S, nu)
    P_sel = torch.where(any_succ, P_norm, P)
    x_sel = torch.where(any_succ, x_upd, x)
    keep = keep_dims.to(f32)
    P_del = P_sel * (keep[:, None] * keep[None, :])
    return x_sel * keep, P_del * 0.5 + transpose_by_identity(P_del) * 0.5


def transpose_by_identity(A: torch.Tensor) -> torch.Tensor:
    """A' as the TPU kernel forms it, the product A' I (pallas_ekf.py:104-
    107): exact where A is finite, but a non-finite entry of column k of A
    (times a 0 of I) makes row k of the result NaN, except where it meets
    the 1 of I itself: [k, j] is NaN if A[i, k] is NaN or infinite for some
    i != j, else A[j, k]."""
    bad = (~torch.isfinite(A)).to(torch.int64)
    spread = (bad.sum(0)[:, None] - bad.mT) > 0
    return torch.where(spread, torch.full((), float("nan"), dtype=A.dtype, device=A.device), A.mT)


# tensor pointers (7 inputs, 2 outputs, the workspace), D, M, the stream
_ARGTYPES_DENSE = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 2 + [ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def dense_workspace_floats(D: int, M: int) -> int:
    """Floats of K15's workspace (csrc/ekf_update_dense.cu::k15_layout):
    the published W', (W S)' [M][Dp], the transform's columns and rows
    [Dp][4], [4][Dp], each column's non-finite count [Dp] and, for the form
    with the M x M arrays out of shared memory, S, S^-1, A, U, L^-1; Dp = D
    rounded up to 32."""
    fn = _build.function(NAME_DENSE, "k15_workspace_floats", [ctypes.c_int, ctypes.c_int], reg_defines(M))
    return int(fn(D, M))


def joint_update_dense(x, P, H, nu, R, any_succ, keep_dims):
    """K15, with pallas_joint_update_norm's arguments in its order. A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel (or
    raises). Same outputs as joint_update_dense_plain."""
    if x.device.type == "cpu":
        return joint_update_dense_plain(x, P, H, nu, R, any_succ, keep_dims)
    D, M = x.shape[0], nu.shape[0]
    if not (7 <= D <= DENSE_MAX and 1 <= M <= DENSE_MAX):
        raise ValueError(f"K15: D and M must lie in [7, {DENSE_MAX}] and [1, {DENSE_MAX}], got D={D} M={M}")
    f32, b = torch.float32, torch.bool
    ins = [t.to(f32).contiguous() for t in (x, P, H, nu, R)] + [
        any_succ.reshape(1).contiguous(), keep_dims.contiguous()]
    for t, name, dty, shp in zip(ins, ("x", "P", "H", "nu", "R", "any_succ", "keep_dims"),
                                 (f32,) * 5 + (b, b), ((D,), (D, D), (M, D), (M,), (M, M), (1,), (D,))):
        _build.check_tensor(t, name, dty, shp)
    xo = torch.empty_like(ins[0])
    Po = torch.empty_like(ins[1])
    ws = torch.empty(dense_workspace_floats(D, M), dtype=f32, device=x.device)
    fn = _build.function(NAME_DENSE, "k15_joint_update_dense", _ARGTYPES_DENSE, reg_defines(M))
    err = fn(*(t.data_ptr() for t in ins), xo.data_ptr(), Po.data_ptr(), ws.data_ptr(), D, M,
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "K15 joint_update_dense")
    _build.launches[NAME_DENSE] += 1
    return xo, Po


def dense_inputs(D: int, sel, z, succ, offs):
    """(H [M, D], nu [M], R [M, M]) of K3's selected columns, assembled as
    the JAX step's XLA branch assembles them for K15 (scenelib2_tpu/runtime/
    step.py:493-515): rows 2k, 2k+1 hold the slot's hx (dims 0..6) and hy
    (dims offs_k..offs_k+2) where the match succeeded and zeros elsewhere;
    R is block-diagonal with the noise variance (1 on a missed row); nu =
    z - h on a match, 0 elsewhere."""
    NSEL = sel.shape[1]
    M = 2 * NSEL
    dev, dt = sel.device, sel.dtype
    zero = torch.zeros((), dtype=dt, device=dev)
    s3 = succ[:, None, None]
    hx = torch.where(s3, sel[O_HX : O_HX + 14].T.reshape(NSEL, 2, 7), zero)
    hy = torch.where(s3, sel[O_HY : O_HY + 6].T.reshape(NSEL, 2, 3), zero)
    onehot = (offs.long()[:, None, None] + torch.arange(3, device=dev)[None, :, None]
              == torch.arange(D, device=dev)).to(dt)                            # [NSEL, 3, D]
    H = (hy[:, :, :, None] * onehot[:, None, :, :]).sum(2)                       # [NSEL, 2, D]
    H[:, :, :7] = hx
    rd = torch.where(succ, sel[O_RD], torch.ones((), dtype=dt, device=dev))
    R = torch.diag(torch.repeat_interleave(rd, 2))
    nu = torch.where(succ[:, None], z - sel[O_H : O_H + 2].T, zero).reshape(M)
    return H.reshape(M, D), nu, R


def keep_of_kill(kill) -> torch.Tensor:
    """keep_dims [D] of a kill mask [MF] (the JAX step's, step.py:507-509)."""
    return torch.cat([torch.ones(CAM_DIM, dtype=torch.bool, device=kill.device),
                      torch.repeat_interleave(~kill, SLOT_DIM)])


def bytes_and_flops_dense(D: int, M: int) -> tuple[int, int]:
    """Least bytes (x, P, H, nu, R, the flags in; x', P' out) and float
    operations of one K15 call: the dense P H' and H (P H') over every state
    dimension, then K3's update from S on."""
    f = 4
    nbytes = 2 * (D * f + D * D * f) + M * D * f + M * f + M * M * f + 1 + D
    flops = (2 * D * D * M + 2 * D * M * M + 2 * M ** 3 // 3 + 2 * M ** 3 + 2 * D * M * M + 2 * D * M
             + 2 * D * M * M + 2 * D * D * M + 2 * 2 * 4 * 4 * D + 4 * D * D)
    return nbytes, flops


def bytes_and_flops(D: int, NSEL: int, MF: int) -> tuple[int, int]:
    """Least bytes (inputs read once, outputs written once) and float
    operations of one K3 call with every measurement row live."""
    M = 2 * NSEL
    f = 4
    nbytes = (2 * (D * f + D * D * f)                  # x, P in; x', P' out
              + NOUT * NSEL * f + NSEL * (2 * f + 1 + f + 1 + f)  # sel, z, succ, offs, mask, idx
              + MF * (4 * f + 3) + MF * (2 * f + 2))   # bookkeeping in / out
    flops = (2 * 10 * D * M          # P H' (10 non-zeros a row of H)
             + 2 * 10 * M * M        # S = H (P H') + R
             + 2 * M ** 3 // 3       # Cholesky and L^-1
             + 2 * M ** 3            # S^-1 = L^-T L^-1
             + 2 * D * M * M         # W = P H' S^-1
             + 2 * D * M             # x + W nu
             + 2 * D * M * M         # W S
             + 2 * D * D * M         # P - (W S) W'
             + 2 * 2 * 4 * 4 * D     # quaternion-norm transform of 4 rows and columns
             + 4 * D * D)            # keep mask and symmetrize
    return nbytes, flops
