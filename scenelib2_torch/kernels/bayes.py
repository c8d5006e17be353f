"""The particle Bayes tail, as plain tensor code; its CUDA form is
csrc/bayes_tail.cuh, which K4 (csrc/search_bayes.cu) runs last.

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
and decisions exactly. The standalone TPU kernel of this tail
(pallas_bayes.py:246) belongs to batch mode and is not ported yet.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

LANE_BLOCK = 128


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
