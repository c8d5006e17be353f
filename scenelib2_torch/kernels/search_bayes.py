"""K4 and K11: partial-feature particle search and Bayes update.

K4 (single stream): particle predict, the scores where the searches read,
per-particle search and Bayes update of one partial slot, in one kernel.

Replaces the TPU kernel scenelib2_tpu/kernels/pallas_search_bayes.py
(``pallas_search_bayes`` / ``_kernel``) in the one mode the single-stream
step uses: merged predict (the particle chain runs in the kernel from the
packed camera and slot rows), frame mode (the penalized NSSD score map is
built in the kernel, only where it is read), full width (the whole [MF, NP]
prob / palive arrays in and out, the slot's row picked by pidx and every
other row passed through bit for bit). Stage 8 of the step (reference
SearchMultipleOverlappingEllipses, search_multiple_overlapping_ellipses.cpp:
106-196, and monoslam.cpp:1299-1517):

  1. predict (kernels/particle.py): for each particle, hpi, S^-1, det and
     the 3-sigma half extents;
  2. search geometry (correlate.multi_ellipse_search_unionbox of the JAX
     package, in integer-valued f32): the window of side 2R+1 around
     trunc(hpi), each searchable particle's box in it, and the union box of
     the non-empty boxes; the scanned cells are the union box's rows times
     the 128-column chunks that meet its columns (the TPU kernel's scan);
  3. the penalized score of every scanned centre: the NSSD of
     kernels/search.py::nssd_corr_f32 on exact integer box sums, +5 where
     the image deviation is below the threshold, 1e6 at an invalid centre;
  4. per particle: the minimum over the scanned cells inside its box and
     ellipse ((a urel) urel + ((2b) urel) vrel + (c vrel) vrel < 9, the TPU
     kernel's operation order) with a score below 1e6, and among its ties
     the LARGEST key u*H + v; found = searchable & best <= corr_thresh2;
     z = (trunc((k + 0.5) / H), k - H zu);
  5. the Bayes tail (kernels/bayes.py).

Bound on an H100 (bytes_and_flops): ~60 KB of frame and state in and out,
the score work of the read box's cells (read_box: every particle's box
within the scanned region; search.nssd_cell_ops each) and ~12 operations a
cell that a particle's search visits: a few microseconds at the f32 rate in
the worst case, typically well under one. Design (csrc/search_bayes.cu): a
thread-block cluster of cluster_size(1, SMs) = 8 CTAs of block_threads(NP)
threads, thread t holding the particles t, t + threads, ... (one or up to
four a thread, picked at launch, up to bayes.CHUNK_NP = 4,096; longer rows,
any NP, run one CTA of 1,024 threads that loops over its particles with the
per-particle rows and the sums' tree in a global workspace that the
wrapper allocates, wide_workspace). Every CTA runs the prologue over its
threads and the particle chain of every particle into prediction rows in
dynamic shared memory, and finds the union box, the region and the read
box; each scores a band of the read box's rows (band) with int32 __dp4a
sums into a global workspace [H, W] that the wrapper allocates; after a
cluster barrier each stages the read box's scores in shared memory and
searches its share of the particles (rank, rank + cluster, ...: a warp a
particle, the cells row by row, one 64-bit key a cell, one unsigned
minimum) into CTA 0's shared memory; after a second barrier CTA 0 runs the
Bayes tail (its sums as fixed trees over bayes.tree_width(NP) lanes, three
passes of sums side by side) while the others copy the other rows of prob
and palive.

K11 (batch step, and any step with more than one partial slot) is the same
TPU kernel in its other mode: the prediction rows come in from K10
(``pred_rows``), the scores are read from K9's precomputed map [F, H, W]
instead of being built from the frame, prob / lam / palive are the compact
[F, NP] rows of the partial slots, and the grid has one cluster per (lane,
slot) (cluster_size: 2 CTAs for 64 slots, 8 for 16). Steps 2, 4 and 5 are
K4's, in the same device code (a template parameter of the one kernel body
selects the mode), so on the same slot K11 given K9's map returns K4's
found, z, best and overflow. Cells outside [0, H) x [0, W) are never read.
Bound on an H100 at 64 lanes x 1 slot: the read box's cells of each lane's
map read once (at most 64 x 307 KB = 19.7 MB, ~6 us at the memory rate;
typically a small part of it) against ~12 operations per cell that a
particle's search visits; every particle visits its own box of the shared
region, so on the replay's data the operations bound it (under half a
microsecond either way).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from scenelib2_torch.kernels import _build
from scenelib2_torch.kernels.bayes import CHUNK_NP, BayesConsts, bayes_tail, padded_lanes, tree_width
from scenelib2_torch.kernels.particle import (
    NSHARED,
    NSLOT,
    ROW_DET,
    ROW_HH,
    ROW_HU,
    ROW_HV,
    ROW_HW,
    ROW_S00,
    ROW_S01,
    ROW_S11,
    ParticleConsts,
    geometry_prologue,
    particle_tail,
)
from scenelib2_torch.kernels.search import nssd_cell_ops, nssd_corr_f32

NAME = "search_bayes"            # the library (csrc/search_bayes.cu) and K4's launch count
NAME_K11 = "search_bayes_maps"   # K11's launch count (the library's second entry point)
MISS = 1e6                 # score of a masked or invalid cell
BIG = float(1 << 24)       # empty union-box sentinel
CHUNK = 128                # column chunk of the TPU kernel's scan
THREADS = 256              # a CTA's threads, at least (block_threads)
MAX_CLUSTER = 8            # CTAs a slot, at most (cluster_size)


@dataclass(frozen=True)
class SearchBayesConsts:
    H: int
    W: int
    boxsize: int
    win_radius: int
    no_sigma: float
    corr_thresh2: float
    corr_sigma_thresh: float
    low_sigma_penalty: float
    particle: ParticleConsts
    bayes: BayesConsts

    @staticmethod
    def from_params(p) -> "SearchBayesConsts":
        return SearchBayesConsts(
            H=p.cam_height, W=p.cam_width, boxsize=p.boxsize, win_radius=p.particle_win_radius,
            no_sigma=p.no_sigma, corr_thresh2=p.corr_thresh2,
            corr_sigma_thresh=p.corr_sigma_thresh, low_sigma_penalty=p.low_sigma_penalty,
            particle=ParticleConsts.from_params(p), bayes=BayesConsts.from_params(p),
        )

    @property
    def side_u(self) -> int:
        return min(2 * self.win_radius + 1, self.W)

    @property
    def side_v(self) -> int:
        return min(2 * self.win_radius + 1, self.H)


def search_geometry(pred: torch.Tensor, searchable: torch.Tensor, c: SearchBayesConsts):
    """Per-particle window and box bounds and the scanned region, from the
    prediction rows [8, NP]. Returns (geom dict of [NP] f32 rows, over_l,
    v_lo_i [] i32, n_rows [] i32, need [n_chunks] bool)."""
    dev = pred.device

    def k(v):
        return torch.full((), v, dtype=torch.float32, device=dev)

    R = float(c.win_radius)
    hw, hh = pred[ROW_HW], pred[ROW_HH]
    uc = torch.trunc(pred[ROW_HU])
    vc = torch.trunc(pred[ROW_HV])
    u0 = torch.minimum(torch.maximum(uc - R, k(0.0)), k(float(c.W - c.side_u)))
    v0 = torch.minimum(torch.maximum(vc - R, k(0.0)), k(float(c.H - c.side_v)))
    over_l = (hw > R) | (hh > R)
    g = dict(
        uc=uc, vc=vc,
        vlo=torch.maximum(v0, vc - hh), vhi=torch.minimum(v0 + float(c.side_v), vc + hh + 1.0),
        ulo=torch.maximum(u0, uc - hw), uhi=torch.minimum(u0 + float(c.side_u), uc + hw + 1.0),
        u0=u0, v0=v0,
    )
    nonempty = searchable & (g["vlo"] < g["vhi"]) & (g["ulo"] < g["uhi"])
    v_lo_s = torch.where(nonempty, g["vlo"], k(BIG)).min()
    v_hi_s = torch.where(nonempty, g["vhi"], k(-BIG)).max()
    u_lo_s = torch.where(nonempty, g["ulo"], k(BIG)).min()
    u_hi_s = torch.where(nonempty, g["uhi"], k(-BIG)).max()
    n_rows = torch.clamp(torch.clamp(v_hi_s, 0.0, float(c.H)) - torch.clamp(v_lo_s, 0.0, float(c.H)),
                         min=0.0).to(torch.int32)
    v_lo_i = torch.clamp(v_lo_s, 0.0, float(c.H)).to(torch.int32)
    n_chunks = -(-c.W // CHUNK)
    kk = torch.arange(n_chunks, device=dev, dtype=torch.float32) * CHUNK
    need = (kk <= u_hi_s - 1.0) & (kk + float(CHUNK - 1) >= u_lo_s)
    return g, over_l, v_lo_i, n_rows, need


def score_block(frame, patch_row, v_lo: int, v_hi: int, u_lo: int, u_hi: int, c: SearchBayesConsts):
    """Penalized NSSD scores [v_hi - v_lo, u_hi - u_lo] at the centres of
    rows [v_lo, v_hi) x columns [u_lo, u_hi); MISS at an invalid centre.
    The integer box sums come from float64 convolutions (exact)."""
    B = c.boxsize
    half = (B - 1) // 2
    dev = frame.device
    img = F.pad(frame.to(torch.float64), (half, half, half, half))
    crop = img[v_lo : v_hi + 2 * half, u_lo : u_hi + 2 * half][None, None]
    ones = torch.ones((1, 1, B, B), dtype=torch.float64, device=dev)
    patch = patch_row[: B * B].to(torch.float64).reshape(1, 1, B, B)
    sg1 = F.conv2d(crop, ones)[0, 0].to(torch.float32)
    sg1sq = F.conv2d(crop * crop, ones)[0, 0].to(torch.float32)
    cross = F.conv2d(crop, patch)[0, 0].to(torch.float32)
    n = torch.full((), float(B * B), dtype=torch.float32, device=dev)
    corr, _sd0, sd1 = nssd_corr_f32(patch_row[B * B], patch_row[B * B + 1], sg1, sg1sq, cross, n)
    corr = torch.where(sd1 < c.corr_sigma_thresh, corr + c.low_sigma_penalty, corr)
    vv = torch.arange(v_lo, v_hi, device=dev)[:, None]
    uu = torch.arange(u_lo, u_hi, device=dev)[None, :]
    valid = (uu >= half) & (uu <= c.W - 1 - half) & (vv >= half) & (vv <= c.H - 1 - half)
    return torch.where(valid, corr, torch.full_like(corr, MISS))


def particle_search(g: dict, v_lo: int, v_hi: int, u_lo: int, u_hi: int, scores, c: SearchBayesConsts):
    """Per particle: (best [NP] f32, kbest [NP] f32) over the scanned cells
    [v_lo, v_hi) x [u_lo, u_hi) (scores holds their values) inside its box
    and ellipse; best = MISS and kbest = -1 where there is none."""
    dev = g["uc"].device
    NP = g["uc"].shape[0]
    sv, su = c.side_v, c.side_u
    # every cell a particle's box admits lies in its window [u0, u0 + su) x [v0, v0 + sv)
    u0 = torch.nan_to_num(g["u0"], nan=0.0).to(torch.int64)
    v0 = torch.nan_to_num(g["v0"], nan=0.0).to(torch.int64)
    uu = u0[:, None, None] + torch.arange(su, device=dev)[None, None, :]        # [NP, 1, su]
    vv = v0[:, None, None] + torch.arange(sv, device=dev)[None, :, None]        # [NP, sv, 1]
    uf, vf = uu.to(torch.float32), vv.to(torch.float32)

    def col(name):
        return g[name][:, None, None]

    urel = uf - col("uc")
    vrel = vf - col("vc")
    t1 = (col("a") * urel) * urel
    t2 = (col("b2") * urel) * vrel
    vterm = (col("c") * vrel) * vrel
    ell = ((t1 + t2) + vterm) < c.no_sigma * c.no_sigma
    mask = ((vf >= col("vlo")) & (vf < col("vhi")) & (uf >= col("ulo")) & (uf < col("uhi")) & ell
            & (vv >= v_lo) & (vv < v_hi) & (uu >= u_lo) & (uu < u_hi))
    if v_hi > v_lo and u_hi > u_lo:
        ri = torch.clamp(vv - v_lo, 0, v_hi - v_lo - 1)
        ci = torch.clamp(uu - u_lo, 0, u_hi - u_lo - 1)
        vals = scores[ri, ci]
    else:
        vals = torch.full((NP, sv, su), MISS, dtype=torch.float32, device=dev)
    mask = mask & (vals < MISS)
    cand = torch.where(mask, vals, torch.full_like(vals, MISS)).reshape(NP, -1)
    best = cand.min(dim=1).values
    key = (uf * float(c.H) + vf).expand(NP, sv, su).reshape(NP, -1)
    tie = mask.reshape(NP, -1) & (cand == best[:, None])
    kbest = torch.where(tie, key, torch.full_like(key, -1.0)).max(dim=1).values
    return best, kbest


def _scan_region(pred, searchable, c):
    """Step 2 from the prediction rows [8, NP]: (geometry, over_l, the
    scanned region (v_lo, v_hi, u_lo, u_hi) as host ints, all 0 when it is
    empty)."""
    g, over_l, v_lo_i, n_rows, need = search_geometry(pred, searchable, c)
    g.update(a=pred[ROW_S00], b2=2.0 * pred[ROW_S01], c=pred[ROW_S11])
    v_lo = int(v_lo_i)
    v_hi = v_lo + int(n_rows)
    ks = torch.nonzero(need).flatten().tolist()
    if v_hi > v_lo and ks:
        region = (v_lo, v_hi, CHUNK * ks[0], min(c.W, CHUNK * (ks[-1] + 1)))
    else:
        region = (0, 0, 0, 0)
    return g, over_l, region


def _predict_and_scan(frame, prob, lam, palive, making, pidx, shared, slot_row, c):
    """Steps 1-2 for the slot's row: (rows of the slot (prob, lam, alive),
    pred [8, NP], searchable, geometry, over_l, the scanned region)."""
    p_ = pidx.to(torch.int64).reshape(1)
    rows = [t.index_select(0, p_)[0] for t in (prob, lam, palive)]
    pred = particle_tail(rows[1], *geometry_prologue(shared, slot_row), c.particle)
    searchable = rows[2] & making[0]
    g, over_l, region = _scan_region(pred, searchable, c)
    return rows, pred, searchable, g, over_l, region


def _search_and_bayes(pred, rows, searchable, g, over_l, region, scores, making, pmask,
                      match_attempts, c):
    """Steps 4-5 on one slot: the per-particle search over `scores` (the
    scanned region's values) and the Bayes tail. making, pmask,
    match_attempts are [] tensors. Returns (prob_f [NP], palive_f [NP],
    mean, cov, convert, kill, n_over [], found [NP], z [NP, 2], best [NP])."""
    prob_in, lam_in, alive_in = rows
    best, kbest = particle_search(g, *region, scores, c)
    found = searchable & (best <= c.corr_thresh2)
    p_over = over_l & searchable
    Hf = torch.full((), float(c.H), dtype=torch.float32, device=pred.device)
    zu = torch.trunc((kbest + 0.5) / Hf)
    zv = kbest - float(c.H) * zu
    tail = bayes_tail(
        prob_in, lam_in, alive_in, found, p_over, zu, zv, pred[ROW_HU], pred[ROW_HV],
        pred[ROW_S00], pred[ROW_S01], pred[ROW_S11], pred[ROW_DET], making, pmask,
        match_attempts, c.bayes,
    )
    return (*tail, found, torch.stack([zu, zv], dim=-1), best)


def search_bayes_plain(frame, prob, lam, palive, making, pmask, match_attempts, pidx,
                       patch_row, shared, slot_row, c: SearchBayesConsts):
    """Plain PyTorch K4 (one partial slot). frame [H, W] u8; prob, lam [MF,
    NP] f32 and palive [MF, NP] bool (whole state arrays); making, pmask
    [1] bool; match_attempts [1] i32 (the slot's, incremented this frame);
    pidx [1] i32; patch_row [128] f32; shared [56], slot_row [84] f32.

    Returns (prob [MF, NP], palive [MF, NP] bool, mean [1], cov [1],
    convert [1] bool, kill [1] bool, n_over [1] i32, found [1, NP] bool,
    z [1, NP, 2], best [1, NP], pred [1, 8, NP]).

    The scanned region's bounds are read on the host here (this version
    runs for CPU tensors, and as the kernel's reference on the card)."""
    MF, _NP = prob.shape
    dev = frame.device
    rows, pred, searchable, g, over_l, region = _predict_and_scan(
        frame, prob, lam, palive, making, pidx, shared, slot_row, c)
    scores = score_block(frame, patch_row, *region, c) if region[1] > region[0] else None
    prob_f, palive_f, mean, cov, convert, kill, n_over, found, z, best = _search_and_bayes(
        pred, rows, searchable, g, over_l, region, scores, making[0], pmask[0], match_attempts[0], c)
    row = (torch.arange(MF, device=dev) == pidx.to(torch.int64))[:, None]
    return (torch.where(row, prob_f[None, :], prob), torch.where(row, palive_f[None, :], palive),
            mean[None], cov[None], convert[None], kill[None], n_over[None], found[None],
            z[None], best[None], pred[None])


def search_bayes_maps_plain(corr_maps, pred_rows, prob, lam, palive, making, pmask,
                            match_attempts, c: SearchBayesConsts):
    """Plain PyTorch K11. corr_maps [B, F, H, W] f32 (K9's maps); pred_rows
    [B, F, 8, padded_lanes(NP)] f32 (K10's rows); prob, lam [B, F, NP] f32 and palive
    [B, F, NP] bool (the partial slots' rows); making, pmask [B, F] bool;
    match_attempts [B, F] i32 (incremented this frame).

    Returns (prob_f [B, F, NP], palive_f [B, F, NP] bool, mean, cov [B, F],
    convert, kill [B, F] bool, n_over [B, F] i32, found [B, F, NP] bool,
    z [B, F, NP, 2], best [B, F, NP]). Loops over lanes and slots; each
    slot's scanned region is read on the host."""
    Bn, Fn, NP = prob.shape
    outs = []
    for b in range(Bn):
        for f in range(Fn):
            pred = pred_rows[b, f, :, :NP]
            rows = (prob[b, f], lam[b, f], palive[b, f])
            searchable = rows[2] & making[b, f]
            g, over_l, region = _scan_region(pred, searchable, c)
            v_lo, v_hi, u_lo, u_hi = region
            scores = corr_maps[b, f, v_lo:v_hi, u_lo:u_hi] if v_hi > v_lo else None
            outs.append(_search_and_bayes(pred, rows, searchable, g, over_l, region, scores,
                                          making[b, f], pmask[b, f], match_attempts[b, f], c))
    return tuple(torch.stack([o[i] for o in outs]).reshape(Bn, Fn, *outs[0][i].shape)
                 for i in range(len(outs[0])))


def work_counts(frame, prob, lam, palive, making, pmask, match_attempts, pidx, patch_row,
                shared, slot_row, c: SearchBayesConsts) -> tuple[int, int, int]:
    """The data-dependent work of one K4 call on these inputs: (rows and
    columns of the read box, the cells that must be scored; cells visited
    by the per-particle searches: each particle's box within the scanned
    region)."""
    _rows, _pred, _s, g, _o, region = _predict_and_scan(
        frame, prob, lam, palive, making, pidx, shared, slot_row, c)
    v0, v1, u0, u1 = read_box(g, *region)
    return v1 - v0, u1 - u0, int(_visited(g, *region).sum())


def cell_boxes(g: dict, v_lo: int, v_hi: int, u_lo: int, u_hi: int):
    """Each particle's box within the scanned region as cells [r0, r1) x
    [c0, c1) ([NP] int64 each; empty where r1 <= r0 or c1 <= c0): every cell
    that particle_search's mask can admit (csrc/search_bayes.cu cell_box;
    the bounds are integer-valued or infinite, a NaN one gives no cell)."""
    def span(lo, hi, a, b):
        lo = torch.nan_to_num(torch.floor(lo), nan=float(b)).clamp(a, b)
        hi = torch.nan_to_num(torch.ceil(hi), nan=float(a)).clamp(a, b)
        return lo.long(), hi.long()

    return (*span(g["vlo"], g["vhi"], v_lo, v_hi), *span(g["ulo"], g["uhi"], u_lo, u_hi))


def read_box(g: dict, v_lo: int, v_hi: int, u_lo: int, u_hi: int) -> tuple[int, int, int, int]:
    """The cells that any particle's search can read, (v0, v1, u0, u1): the
    bounding box of every particle's box within the scanned region (the
    union box's cells for the searchable particles, and the region's cells
    that the others' boxes meet); all 0 when there is none. K4 scores these
    cells and K11 stages them."""
    r0, r1, c0, c1 = cell_boxes(g, v_lo, v_hi, u_lo, u_hi)
    some = (r1 > r0) & (c1 > c0)
    if not bool(some.any()):
        return 0, 0, 0, 0
    return int(r0[some].min()), int(r1[some].max()), int(c0[some].min()), int(c1[some].max())


def band(n_rows: int, cluster: int, rank: int) -> tuple[int, int]:
    """The rows [a, b) of the read box's n_rows that CTA `rank` of K4's
    cluster scores."""
    return n_rows * rank // cluster, n_rows * (rank + 1) // cluster


def _visited(g: dict, v_lo: int, v_hi: int, u_lo: int, u_hi: int) -> torch.Tensor:
    """[NP] cells of each particle's box within the scanned region."""
    r0, r1, c0, c1 = cell_boxes(g, v_lo, v_hi, u_lo, u_hi)
    return (r1 - r0).clamp(min=0) * (c1 - c0).clamp(min=0)


def block_threads(NP: int) -> int:
    """A CTA's threads: THREADS, or a quarter of the sums' tree width
    where that is more (the kernel holds at most 4 particles a thread), and
    1,024 past CHUNK_NP particles (the wide rows' loop)."""
    if NP > CHUNK_NP:
        return 1024
    return min(1024, max(THREADS, tree_width(NP) // 4))


def cluster_size(n_slots: int, n_sms: int) -> int:
    """CTAs that share one slot (a thread-block cluster, each a share of the
    particles' searches and, in K4, a band of the scored rows): the largest
    power of two up to MAX_CLUSTER with n_slots x it at most the SMs, 1 past
    CHUNK_NP particles (the caller's check): the single stream takes 8,
    batch-hires' 16 slots 8, batch64's 64 slots 2."""
    cs = 1
    while cs < MAX_CLUSTER and 2 * cs * n_slots <= n_sms:
        cs *= 2
    return cs


class _K4Params(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_int) for n in ("H", "W", "B", "MF", "NP", "win_radius", "pred_w", "width",
                                             "threads", "cluster", "stage")]
                + [(n, ctypes.c_float) for n in (
                    "no_sigma", "corr_thresh2", "corr_sigma_thresh", "low_sigma_penalty",
                    "fku", "fkv", "u0c", "v0c", "two_kd1", "neg_two_kd1", "sd0", "maxdist",
                    "prune_prob_thresh", "sd_depth_ratio", "min_particles",
                    "erase_partial_after_attempts")])


def _k4_params(c: SearchBayesConsts, MF: int, NP: int, n_slots: int, dev) -> _K4Params:
    pc, bc = c.particle, c.bayes
    return _K4Params(
        H=c.H, W=c.W, B=c.boxsize, MF=MF, NP=NP, win_radius=c.win_radius, pred_w=padded_lanes(NP),
        width=tree_width(NP), threads=block_threads(NP),
        cluster=1 if NP > CHUNK_NP else cluster_size(n_slots, _build.n_sms(dev)), stage=0,
        no_sigma=c.no_sigma,
        corr_thresh2=c.corr_thresh2, corr_sigma_thresh=c.corr_sigma_thresh,
        low_sigma_penalty=c.low_sigma_penalty, fku=pc.fku, fkv=pc.fkv, u0c=pc.u0c, v0c=pc.v0c,
        two_kd1=2.0 * pc.kd1, neg_two_kd1=-2.0 * pc.kd1, sd0=pc.sd0, maxdist=pc.maxdist,
        prune_prob_thresh=bc.prune_prob_thresh, sd_depth_ratio=bc.sd_depth_ratio,
        min_particles=bc.min_particles, erase_partial_after_attempts=bc.erase_partial_after_attempts,
    )


# tensor pointers (11 inputs, 11 outputs, the workspace, the wide rows' workspace), the params
# struct, the stream
_ARGTYPES = [ctypes.c_void_p] * 24 + [ctypes.POINTER(_K4Params), ctypes.c_void_p]


def wide_workspace(n_blocks: int, NP: int, dev):
    """K4's / K11's per-particle rows for rows past bayes.CHUNK_NP particles
    (None below): per block, the prediction rows [8, NP], best and key [NP]
    and the sums' tree [tree_width(NP)] (csrc/search_bayes.cu sb_body)."""
    if NP <= CHUNK_NP:
        return None
    return torch.empty((n_blocks, 10 * NP + tree_width(NP)), dtype=torch.float32, device=dev)


def _ptr(t):
    return None if t is None else t.data_ptr()


def search_bayes(frame, prob, lam, palive, making, pmask, match_attempts, pidx, patch_row,
                 shared, slot_row, c: SearchBayesConsts):
    """K4. A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (or raises). Same outputs as search_bayes_plain."""
    args = (frame, prob, lam, palive, making, pmask, match_attempts, pidx, patch_row, shared,
            slot_row)
    if frame.device.type == "cpu":
        return search_bayes_plain(*args, c)
    MF, NP = prob.shape
    H, W = c.H, c.W
    if c.boxsize * c.boxsize + 2 > 128:
        raise ValueError(f"K4: unsupported boxsize {c.boxsize}")
    f32, b, i32 = torch.float32, torch.bool, torch.int32
    for t, name, dty, shp in (
        (frame, "frame", torch.uint8, (H, W)), (prob, "prob", f32, (MF, NP)),
        (lam, "lam", f32, (MF, NP)), (palive, "palive", b, (MF, NP)), (making, "making", b, (1,)),
        (pmask, "pmask", b, (1,)), (match_attempts, "match_attempts", i32, (1,)),
        (pidx, "pidx", i32, (1,)), (patch_row, "patch_row", f32, (128,)),
        (shared, "shared", f32, (NSHARED,)), (slot_row, "slot_row", f32, (NSLOT,)),
    ):
        _build.check_tensor(t, name, dty, shp)
    dev = frame.device
    outs = (
        torch.empty_like(prob), torch.empty_like(palive),
        torch.empty(1, dtype=f32, device=dev), torch.empty(1, dtype=f32, device=dev),
        torch.empty(1, dtype=b, device=dev), torch.empty(1, dtype=b, device=dev),
        torch.empty(1, dtype=i32, device=dev), torch.empty((1, NP), dtype=b, device=dev),
        torch.empty((1, NP, 2), dtype=f32, device=dev), torch.empty((1, NP), dtype=f32, device=dev),
        torch.empty((1, 8, NP), dtype=f32, device=dev),
    )
    workspace = torch.empty((H, W), dtype=f32, device=dev)
    wide = wide_workspace(1, NP, dev)
    fn = _build.function(NAME, "k4_search_bayes", _ARGTYPES)
    prm = _k4_params(c, MF=MF, NP=NP, n_slots=1, dev=dev)
    err = fn(*(t.data_ptr() for t in args), *(t.data_ptr() for t in outs), workspace.data_ptr(), _ptr(wide),
             ctypes.byref(prm), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "K4 search_bayes")
    _build.launches[NAME] += 1
    return outs


# tensor pointers (8 inputs, 10 outputs, the wide rows' workspace), the number of (lane, slot)
# blocks, the params struct, the stream
_ARGTYPES_K11 = [ctypes.c_void_p] * 19 + [ctypes.c_int, ctypes.POINTER(_K4Params), ctypes.c_void_p]


def search_bayes_maps(corr_maps, pred_rows, prob, lam, palive, making, pmask, match_attempts,
                      c: SearchBayesConsts):
    """K11. CPU tensors take the plain version; CUDA tensors launch the
    kernel (or raise). Same outputs as search_bayes_maps_plain."""
    args = (corr_maps, pred_rows, prob, lam, palive, making, pmask, match_attempts)
    if corr_maps.device.type == "cpu":
        return search_bayes_maps_plain(*args, c)
    Bn, Fn, NP = prob.shape
    H, W = c.H, c.W
    f32, b, i32 = torch.float32, torch.bool, torch.int32
    args = tuple(t.contiguous() for t in args)
    for t, name, dty, shp in zip(
        args, ("corr_maps", "pred_rows", "prob", "lam", "palive", "making", "pmask", "match_attempts"),
        (f32, f32, f32, f32, b, b, b, i32),
        ((Bn, Fn, H, W), (Bn, Fn, 8, padded_lanes(NP)), (Bn, Fn, NP), (Bn, Fn, NP), (Bn, Fn, NP), (Bn, Fn),
         (Bn, Fn), (Bn, Fn)),
    ):
        _build.check_tensor(t, name, dty, shp)
    dev = corr_maps.device
    outs = (
        torch.empty((Bn, Fn, NP), dtype=f32, device=dev), torch.empty((Bn, Fn, NP), dtype=b, device=dev),
        torch.empty((Bn, Fn), dtype=f32, device=dev), torch.empty((Bn, Fn), dtype=f32, device=dev),
        torch.empty((Bn, Fn), dtype=b, device=dev), torch.empty((Bn, Fn), dtype=b, device=dev),
        torch.empty((Bn, Fn), dtype=i32, device=dev), torch.empty((Bn, Fn, NP), dtype=b, device=dev),
        torch.empty((Bn, Fn, NP, 2), dtype=f32, device=dev), torch.empty((Bn, Fn, NP), dtype=f32, device=dev),
    )
    wide = wide_workspace(Bn * Fn, NP, dev)
    fn = _build.function(NAME, "k11_search_bayes_maps", _ARGTYPES_K11)
    prm = _k4_params(c, MF=Fn, NP=NP, n_slots=Bn * Fn, dev=dev)
    err = fn(*(t.data_ptr() for t in args), *(t.data_ptr() for t in outs), _ptr(wide), Bn * Fn,
             ctypes.byref(prm), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "K11 search_bayes_maps")
    _build.launches[NAME_K11] += 1
    return outs


def bytes_and_flops_maps(Bn: int, Fn: int, NP: int, n_scanned: int, n_searched: int) -> tuple[int, int]:
    """Least bytes and operations of one K11 call with this run's data: the
    n_scanned map cells of the read boxes read once, the prediction
    and particle rows in, the results out; ~40 operations per particle of
    the geometry and the Bayes tail and ~12 per cell that a particle's
    search visits (n_searched, summed over lanes and slots)."""
    per_slot = 8 * NP * 4 + NP * (4 + 4 + 1) + 6 + NP * (4 + 1) + 4 * 4 + NP * (1 + 8 + 4)
    return 4 * n_scanned + Bn * Fn * per_slot, Bn * Fn * NP * 40 + 12 * n_searched


def work_counts_maps(pred_rows, palive, making, c: SearchBayesConsts) -> tuple[int, int]:
    """The data-dependent work of one K11 call: (cells of the read boxes,
    cells visited by the per-particle searches), summed over lanes and
    slots."""
    Bn, Fn, NP = palive.shape
    n_scanned = n_searched = 0
    for bi in range(Bn):
        for f in range(Fn):
            g, _o, region = _scan_region(pred_rows[bi, f, :, :NP], palive[bi, f] & making[bi, f], c)
            v0, v1, u0, u1 = read_box(g, *region)
            n_scanned += (v1 - v0) * (u1 - u0)
            n_searched += int(_visited(g, *region).sum())
    return n_scanned, n_searched


def bytes_and_flops(MF: int, NP: int, H: int, W: int, boxsize: int, n_rows: int, n_cols: int,
                    n_searched: int) -> tuple[int, int]:
    """Least bytes and operations of one K4 call with this run's data
    (work_counts): the frame pixels under the read box's n_rows x n_cols
    centres and their halo, each read once, and the state rows in; prob /
    palive and the small outputs out. ~1.5 k operations of the prologue,
    ~90 per particle of the chain and ~40 of the Bayes tail,
    search.nssd_cell_ops per scored cell and ~12 per cell that a particle's
    search visits."""
    n_scored = n_rows * n_cols
    pixels = min(H * W, (n_rows + boxsize - 1) * (n_cols + boxsize - 1)) if n_scored else 0
    nbytes = (pixels + 2 * MF * NP * 4 + MF * NP + 128 * 4 + (56 + 84) * 4 + 3 * 4
              + MF * NP * 4 + MF * NP + 4 * 4 + NP * (1 + 8 + 4) + 8 * NP * 4)
    flops = 1500 + NP * (90 + 40) + n_scored * nssd_cell_ops(boxsize) + 12 * n_searched
    return nbytes, flops
