"""The particle Bayes tail, as plain tensor code, and K12, the kernel that
runs it alone. The tail's CUDA form is csrc/bayes_tail.cuh, which K4 and
K11 (csrc/search_bayes.cu) run last and K12 (csrc/bayes.cu) runs whole.

Port of scenelib2_tpu/kernels/pallas_bayes.py::_bayes_tail
(pallas_bayes.py:43-118; reference monoslam.cpp:1446-1517,
feature_init_info.cpp:99-174): the Gaussian innovation likelihood of each
particle's match (an overflowed particle with no match keeps its prior),
Bayes, renormalisation, the prune below thresh / N, renormalisation again,
the weighted moments of lambda, and the convert / kill decisions.

Every sum over particles is a pairwise tree over the padded row of
max(128, NP rounded up to 128) lanes, the TPU kernel's row width (halves
added lane by lane: 64, 32, ..., 1 for 128 lanes), the order of the CUDA
block reduction; padding lanes hold exact zeros. The TPU kernel sums its
row in the order its compiler picks, so sums agree with it to rounding,
and decisions exactly.

K12 (bayes_update) replaces that standalone TPU kernel,
scenelib2_tpu/kernels/pallas_bayes.py::pallas_bayes_update (pallas_call at
pallas_bayes.py:246), which the batch step runs after the particle search on
its two alternative routes: one row of particles per (lane, partial slot),
the geometry either as separate hpi / sinv / dets arrays (13 rows, the
route with batch_pallas=False) or as K10's prediction rows (7 + 8 rows, the
route with SCENELIB2_BATCH_SB=0). Bound on an H100 at 64 rows x 100
particles: ~0.2 MB in and out, ~10 k operations a row; the launch dominates.
Design (csrc/bayes.cu): one block of padded_lanes(NP) threads per row, one
particle a thread, calling bayes_tail.cuh exactly as K11 does.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import torch

from scenelib2_torch.kernels import _build

LANE_BLOCK = 128
NAME = "bayes"
# K10's prediction rows: HU, HV, S00, S01, S11, DET first (kernels/particle.py ROW_*)
PRED_HU, PRED_HV, PRED_S00, PRED_S01, PRED_S11, PRED_DET = range(6)


def padded_lanes(n: int) -> int:
    """Lanes of the padded particle row: max(128, n rounded up to 128)."""
    return max(LANE_BLOCK, -(-n // LANE_BLOCK) * LANE_BLOCK)


@dataclass(frozen=True)
class BayesConsts:
    prune_prob_thresh: float
    sd_depth_ratio: float
    min_particles: float
    erase_partial_after_attempts: float

    @staticmethod
    def from_params(p) -> "BayesConsts":
        return BayesConsts(
            prune_prob_thresh=p.prune_prob_thresh, sd_depth_ratio=p.sd_depth_ratio,
            min_particles=float(p.min_particles),
            erase_partial_after_attempts=float(p.erase_partial_after_attempts),
        )


def tree_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum of v [NP] as the pairwise tree over padded_lanes(NP)
    zero-padded lanes."""
    n = padded_lanes(v.shape[0])
    t = torch.zeros(n, dtype=v.dtype, device=v.device)
    t[: v.shape[0]] = v
    while n > 1:
        n //= 2
        t = t[:n] + t[n : 2 * n]
    return t[0]


def bayes_tail(prob, lam, palive, found, p_over, zu, zv, hu, hv, a, b, c, det,
               making, pmask, match_attempts, bc: BayesConsts):
    """Per-particle rows [NP] (palive, found, p_over bool); making, pmask
    [] bool; match_attempts [] (this frame's incremented count).
    Returns (prob_f [NP], palive_f [NP] bool, mean [], cov [], convert []
    bool, kill [] bool, n_over [] i32)."""
    dev, dt = prob.device, prob.dtype

    def k(v):
        return torch.full((), v, dtype=dt, device=dev)

    zero = torch.zeros((), dtype=dt, device=dev)
    one = torch.ones((), dtype=dt, device=dev)
    nu_u = zu - hu
    nu_v = zv - hv
    quad = a * nu_u * nu_u + 2.0 * b * nu_u * nu_v + c * nu_v * nu_v
    gauss = (1.0 / torch.sqrt(2.0 * math.pi * det)) * torch.exp(-0.5 * quad)
    likelihood = torch.where(found, gauss, torch.where(p_over, one, zero))

    upd = making & palive
    prob1 = torch.where(upd, prob * likelihood, prob)
    total = tree_sum(torch.where(palive, prob1, zero))
    all_zero = making & (total == 0.0)
    safe_total = torch.where(total > 0.0, total, one)
    prob_n = torch.where(making, prob1 / safe_total, prob1)

    n_alive = tree_sum(palive.to(dt))
    thresh = k(bc.prune_prob_thresh) / torch.maximum(n_alive, one)
    keep = palive & ~(making & (prob_n < thresh))
    prob_k = torch.where(keep, prob_n, zero)
    total2 = tree_sum(prob_k)
    prob_f = torch.where(making & (total2 > 0.0),
                         prob_k / torch.where(total2 > 0.0, total2, one), prob_k)
    palive_f = (making & keep) | (~making & palive)
    n_alive_f = tree_sum(palive_f.to(dt))

    mean = tree_sum(lam * prob_f)
    exp2 = tree_sum(lam * lam * prob_f)
    cov = exp2 - mean * mean
    ratio = torch.sqrt(cov) / mean
    convert = making & ~all_zero & (ratio < bc.sd_depth_ratio) & (n_alive_f > bc.min_particles)
    sell_by = pmask & ~convert & ((match_attempts.to(dt) > bc.erase_partial_after_attempts)
                                  | (n_alive_f <= bc.min_particles))
    kill = all_zero | sell_by
    n_over = p_over.sum().to(torch.int32)
    return prob_f, palive_f, mean, cov, convert, kill, n_over


def _row_geometry(hpi, sinv, dets, pred_rows, NP: int):
    """(hu, hv, a, b, c, det) [F, NP] of either geometry form."""
    if pred_rows is not None:
        return tuple(pred_rows[:, r, :NP] for r in (PRED_HU, PRED_HV, PRED_S00, PRED_S01, PRED_S11,
                                                     PRED_DET))
    return hpi[..., 0], hpi[..., 1], sinv[..., 0, 0], sinv[..., 0, 1], sinv[..., 1, 1], dets


def bayes_update_plain(prob, lam, palive, found, p_over, z, hpi, sinv, dets, making, pmask,
                       match_attempts, bc: BayesConsts, pred_rows=None):
    """Plain PyTorch K12 over F rows: prob, lam [F, NP] f32; palive, found,
    p_over [F, NP] bool; z [F, NP, 2] f32; the geometry as hpi [F, NP, 2],
    sinv [F, NP, 2, 2], dets [F, NP] or (pred_rows given, hpi / sinv / dets
    unused) K10's rows [F, 8, >= NP]; making, pmask [F] bool; match_attempts
    [F] i32 (incremented this frame). Returns (prob_f [F, NP], palive_f
    [F, NP] bool, mean [F], cov [F], convert [F] bool, kill [F] bool,
    n_over [F] i32): bayes_tail row by row."""
    Fn, NP = prob.shape
    geo = _row_geometry(hpi, sinv, dets, pred_rows, NP)
    rows = [bayes_tail(prob[f], lam[f], palive[f], found[f], p_over[f], z[f, :, 0], z[f, :, 1],
                       *(g[f] for g in geo), making[f], pmask[f], match_attempts[f], bc)
            for f in range(Fn)]
    return tuple(torch.stack([r[i] for r in rows]).reshape(Fn, *rows[0][i].shape) for i in range(7))


class _K12Params(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_int) for n in ("NP", "lanes", "pred_w")]
                + [(n, ctypes.c_float) for n in ("prune_prob_thresh", "sd_depth_ratio", "min_particles",
                                                 "erase_partial_after_attempts")])


# tensor pointers (13 inputs, 7 outputs), F, the params struct, the stream
_ARGTYPES = [ctypes.c_void_p] * 20 + [ctypes.c_int, ctypes.POINTER(_K12Params), ctypes.c_void_p]


def bayes_update(prob, lam, palive, found, p_over, z, hpi, sinv, dets, making, pmask,
                 match_attempts, bc: BayesConsts, pred_rows=None):
    """K12. CPU tensors take the plain version; CUDA tensors launch the
    kernel (or raise). Same arguments and outputs as bayes_update_plain,
    except that every argument may carry further leading dimensions (lanes,
    slots: [B, F, ...]); the outputs keep them. One launch for all rows."""
    lead = prob.shape[:-1]
    n = prob[..., 0].numel()

    def rows(t):
        return None if t is None else t.reshape(n, *t.shape[len(lead):])

    args = [rows(t) for t in (prob, lam, palive, found, p_over, z)]
    geo = [rows(t) for t in (hpi, sinv, dets)] if pred_rows is None else [None, None, None]
    pred = rows(pred_rows)
    flags = [rows(t) for t in (making, pmask, match_attempts)]
    if prob.device.type == "cpu":
        out = bayes_update_plain(*args, *geo, *flags, bc, pred_rows=pred)
    else:
        out = _launch(*args, *geo, *flags, bc, pred)
    return tuple(o.reshape(*lead, *o.shape[1:]) for o in out)


def _launch(prob, lam, palive, found, p_over, z, hpi, sinv, dets, making, pmask, match_attempts,
            bc: BayesConsts, pred):
    Fn, NP = prob.shape
    lanes = padded_lanes(NP)
    if lanes > 2 * LANE_BLOCK:
        raise ValueError(f"K12: at most {2 * LANE_BLOCK} particles, got {NP}")
    f32, b, i32 = torch.float32, torch.bool, torch.int32
    ins = [t.contiguous() for t in (prob, lam, palive, found, p_over, z)]
    checks = list(zip(ins, ("prob", "lam", "palive", "found", "p_over", "z"), (f32, f32, b, b, b, f32),
                      ((Fn, NP),) * 5 + ((Fn, NP, 2),)))
    if pred is None:
        geo = [t.contiguous() for t in (hpi, sinv, dets)]
        checks += zip(geo, ("hpi", "sinv", "dets"), (f32,) * 3, ((Fn, NP, 2), (Fn, NP, 2, 2), (Fn, NP)))
        geo_ptrs = [t.data_ptr() for t in geo] + [None]
        pred_w = 0
    else:
        pred = pred.contiguous()
        pred_w = pred.shape[-1]
        checks.append((pred, "pred_rows", f32, (Fn, 8, pred_w)))
        geo_ptrs = [None, None, None, pred.data_ptr()]
    flags = [t.contiguous() for t in (making, pmask, match_attempts)]
    checks += zip(flags, ("making", "pmask", "match_attempts"), (b, b, i32), ((Fn,),) * 3)
    for t, name, dty, shp in checks:
        _build.check_tensor(t, name, dty, shp)
    dev = prob.device
    outs = (torch.empty((Fn, NP), dtype=f32, device=dev), torch.empty((Fn, NP), dtype=b, device=dev),
            torch.empty(Fn, dtype=f32, device=dev), torch.empty(Fn, dtype=f32, device=dev),
            torch.empty(Fn, dtype=b, device=dev), torch.empty(Fn, dtype=b, device=dev),
            torch.empty(Fn, dtype=i32, device=dev))
    prm = _K12Params(NP=NP, lanes=lanes, pred_w=pred_w, prune_prob_thresh=bc.prune_prob_thresh,
                     sd_depth_ratio=bc.sd_depth_ratio, min_particles=bc.min_particles,
                     erase_partial_after_attempts=bc.erase_partial_after_attempts)
    fn = _build.function(NAME, "k12_bayes", _ARGTYPES)
    err = fn(*(t.data_ptr() for t in ins), *geo_ptrs, *(t.data_ptr() for t in flags),
             *(t.data_ptr() for t in outs), Fn, ctypes.byref(prm), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "K12 bayes")
    _build.launches[NAME] += 1
    return outs


def bytes_and_flops(Fn: int, NP: int) -> tuple[int, int]:
    """Least bytes and operations of one K12 call, in either row form: the
    NP particles' rows in (prob, lam, z, six geometry values as f32, three
    flags) and the row scalars, prob_f / palive_f and the decisions out;
    ~60 operations per particle of the likelihood, the sums and the
    decisions."""
    nbytes = Fn * (NP * (4 + 4 + 8 + 3) + 6 * NP * 4 + 3 + 4) + Fn * (NP * 5 + 4 + 4 + 1 + 1 + 4)
    return nbytes, Fn * NP * 60
