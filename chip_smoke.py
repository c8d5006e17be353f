"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed):

 1. device and build: the card's name and power limit; every kernel of
    scenelib2_torch/kernels/csrc built with nvcc (one process per source,
    all at once; timed).
 2. kernel vs plain: each kernel (K1 predict+measure+select, K2 search,
    K3 update+bookkeeping, K4 particle search+Bayes, K5 init region
    proposal, K6 Shi-Tomasi pick; K14 L^-1 on seeded SPD matrices) and its
    plain PyTorch version on the same
    CUDA tensors: on seeded random scenes and variations (no attempt, no
    room, every try clashing, a flat region, built ties, making false, an
    empty union box, overflowing particles, a sell-by kill) and on the
    inputs of real frames of the synthetic sequence with mapping on (output
    index 9: the first init; 20: the first conversion; 120): decisions and
    integers exactly equal, floats within the stated tolerances; then each
    kernel's and plain version's time.
 3. main paths: the 240-frame seed-7 synthetic sequence through
    MonoSLAM(device="cuda").run_sequence, with mapping off and then on,
    each reproducing its committed decisions fingerprint, with every kernel
    of the path launched once per frame (K5 and K6 run only with mapping
    on; the counts are zeroed just before each run and read just after
    it); the first mapping-on frames agree with the CPU
    plain replay; 30 steps run with PyTorch's sync debug mode raising on any
    host synchronisation; ms/frame, device busy ms/frame and idle share of
    each path.
 3b. batch mode: 64 independent lanes (32 scene textures x 2 phase offsets)
    x 63 frames through parallel.mesh.make_batched_step / run_batch. Phase 2
    of the batch kernels runs here, on inputs captured from this replay (K7
    measurement rows, K9 score maps, K10 particle rows, K11 search + Bayes on
    the maps, and K2 / K6 launched over lanes, each against its plain
    version; K10 and K11 also against K4 on the same slot), after seeded
    scenes. Then the replay itself: all 64 per-lane fingerprints equal the
    committed file, each batch kernel launched once a frame for all lanes,
    four lanes agree with their CPU plain replay, 30 batch steps without a
    host synchronisation, aggregate frames/s, device busy and idle share,
    peak device memory.
 3c. hires (BASELINE config 3): the 640x480 seed-7 sequence of 120 frames,
    max_features 60 (D = 373, the fused route), search radius 48, particle
    radius 52, 200 particles; 3d. mf100: the std sequence with
    max_features 100 (D = 613, the split route: K7, K2, K14 and the dense
    update). Each: its committed fingerprint with every kernel of its path
    launched once a frame and none other, the path's kernels against their
    plain versions on inputs captured at a few frames of that replay (K14
    also on seeded SPD matrices in phase 2; K2 with 107 x 107 windows and
    K4 with 200 particles at hires), the CPU plain replay of its first 20
    frames, 30 steps under sync debug mode "error", ms/frame, a traced
    window's device busy and idle share, peak device memory.
 4. a `kernels` JSON line, then the last line
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.

Imports nothing of JAX; needs the repository beside it (the kernels are
built from its sources).
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

# published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s and
# float32 operations/s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12

K1_TOL = 1e-5     # |a - b| <= K1_TOL * (largest |entry| of that row / matrix)
K2_BEST_ULP = 2   # NSSD best: within 2 ulp
K3_TOL = 1e-5     # x', P': |a - b| <= K3_TOL * max |entry|
K4_TOL = 1e-5     # K4 floats (prob, moments, prediction rows, best): within K4_TOL * max |entry|
K6_TOL = 1e-6     # K6 eigenvalue: relative
K9_TOL = 2e-5     # K9 score map: absolute, on cells that are neither 1e6 on both
K14_TOL = 1e-5    # K14 L^-1: within K14_TOL * max |entry| (the recurrence is K3's, bit-exact by design)
N_LANES, N_TEXTURES, N_BATCH_FRAMES = 64, 32, 64    # the batch replay: 63 frames a lane
BATCH_AT = (9, 20, 40)     # output indices whose kernel inputs are captured
N_REF_BATCH, REF_LANES = 20, (0, 1, 32, 33)
STEP_TOL = 1e-4   # CUDA vs CPU plain replay: r, xv
N_REF = 30        # CPU plain replay frames (4 inits, 2 conversions)


T_START = time.time()


def log(*a):
    """A progress line, stamped with the seconds since the script started."""
    print(f"[{time.time() - T_START:7.1f} s]", *a, flush=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------ comparisons


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b| over the finite entries (non-finite ones must match)."""
    if not nonfinite_equal(a, b):
        return float("inf")
    a = a.double().cpu()
    b = b.double().cpu()
    fin = torch.isfinite(a)
    return float((a[fin] - b[fin]).abs().max()) if fin.any() else 0.0


def nonfinite_equal(a, b) -> bool:
    """Same NaN positions, same infinities, finite elsewhere on both."""
    a = a.double().cpu()
    b = b.double().cpu()
    if not (torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(torch.isinf(a), torch.isinf(b))):
        return False
    inf = torch.isinf(a)
    return torch.equal(a[inf], b[inf])


def rowwise_close(a, b, tol) -> bool:
    """Per row of a [R, C] matrix: |a - b| <= tol * max |b| of the row's
    finite entries; non-finite entries must match exactly."""
    if not nonfinite_equal(a, b):
        return False
    a = a.double().cpu()
    b = b.double().cpu()
    fin = torch.isfinite(b)
    scale = torch.where(fin, b.abs(), torch.zeros_like(b)).amax(dim=-1, keepdim=True).clamp_min(1e-30)
    d = torch.where(fin, (a - b).abs(), torch.zeros_like(b))
    return bool((d <= tol * scale).all())


def matrix_close(a, b, tol) -> bool:
    """Non-finite entries equal; the rest within tol x max |finite entry|."""
    if not nonfinite_equal(a, b):
        return False
    a = a.double().cpu()
    b = b.double().cpu()
    fin = torch.isfinite(b)
    a, b = a[fin], b[fin]
    scale = max(float(b.abs().max()), 1e-30) if b.numel() else 1.0
    return bool(((a - b).abs() <= tol * scale).all())


def ulp_close(a, b, n_ulp) -> bool:
    a = a.float().cpu()
    b = b.float().cpu()
    ai = a.view(torch.int32).long()
    bi = b.view(torch.int32).long()
    ai = torch.where(ai < 0, -(ai & 0x7FFFFFFF), ai)
    bi = torch.where(bi < 0, -(bi & 0x7FFFFFFF), bi)
    return bool(((ai - bi).abs() <= n_ulp).all())


def same(a, b) -> bool:
    return torch.equal(a.cpu(), b.cpu())


# ------------------------------------------------------------ timing


def time_ms(fn, n: int = 100, batches: int = 5) -> float:
    """Median over `batches` of (CUDA-event time of n back-to-back calls)/n."""
    fn()
    torch.cuda.synchronize()
    res = []
    for _ in range(batches):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(n):
            fn()
        e1.record()
        torch.cuda.synchronize()
        res.append(e0.elapsed_time(e1) / n)
    return statistics.median(res)


# ------------------------------------------------------------ scenes


def k1_random_scene(rng, params, dev, nan_lane=False):
    MF = params.max_features
    D = 13 + 6 * MF
    x = np.zeros(D)
    x[3] = 1.0
    x[4:7] = rng.normal(0, 0.02, 3)
    x[2] = -0.8
    x[7:10] = rng.normal(0, 0.1, 3)
    x[10:13] = rng.normal(0, 0.2, 3)
    for k in range(MF):
        x[13 + 6 * k : 13 + 6 * k + 3] = [rng.uniform(-0.3, 0.3), rng.uniform(-0.2, 0.2), 0.0]
    xpo = np.tile(x[:7], (MF, 1))
    xpo[:, :3] += rng.normal(0, 0.005, (MF, 3))
    A = rng.normal(size=(D, D))
    P = (A @ A.T / (4 * D) + np.eye(D)) * 1e-4
    act = rng.uniform(size=MF) > 0.15
    full = rng.uniform(size=MF) > 0.1
    if nan_lane:
        # a visible lane whose point covariance overflows S to inf - inf:
        # a NaN score, clamped and ranked last
        o = 13 + 6 * 3
        P[o, o], P[o + 1, o + 1] = 1e36, -1e36
        act[3] = full[3] = True
    f = dict(dtype=torch.float32, device=dev)
    return (torch.tensor(x, **f), torch.tensor(P, **f), torch.tensor(xpo, **f),
            torch.tensor(act & full, device=dev), torch.tensor(act & ~full, device=dev))


def k2_random_scene(rng, params, dev, tie=False):
    from scenelib2_torch.kernels.search import search_window_origin
    from scenelib2_torch.runtime.state import patch_row

    H, W, B = params.cam_height, params.cam_width, params.boxsize
    K = params.n_features_to_select
    if tie:
        # a periodic image: every period-shifted cell scores the same, so
        # the minimum is tied and the (u, v) tie-break decides
        tile = rng.integers(0, 256, size=(B, B), dtype=np.uint8)
        img = np.tile(tile, (H // B + 1, W // B + 1))[:H, :W].copy()
    else:
        img = rng.integers(0, 256, size=(H, W), dtype=np.uint8)
    centres = np.stack([rng.uniform(30, W - 30, K), rng.uniform(30, H - 30, K)], 1)
    patches = []
    for k in range(K):
        u = int(np.clip(round(centres[k, 0] + rng.integers(-4, 5)), 5, W - 6))
        v = int(np.clip(round(centres[k, 1] + rng.integers(-4, 5)), 5, H - 6))
        patches.append(img[v - 5 : v + 6, u - 5 : u + 6])
    sinv = []
    for k in range(K):
        s = rng.uniform(1.0, 40.0, 2)
        rho = rng.uniform(-0.6, 0.6)
        S = np.array([[s[0], rho * np.sqrt(s[0] * s[1])], [rho * np.sqrt(s[0] * s[1]), s[1]]])
        Si = np.linalg.inv(S)
        sinv.append([Si[0, 0], Si[0, 1], Si[1, 1]])
    active = rng.uniform(size=K) > 0.2
    frame = torch.tensor(img, device=dev)
    rows = torch.stack([patch_row(torch.tensor(p, device=dev)) for p in patches])
    h = torch.tensor(centres, dtype=torch.float32, device=dev)
    u0, v0, uc, vc = search_window_origin(h, params.search_win_radius, W, H, B)
    return (frame, rows, u0, v0, uc, vc, torch.tensor(sinv, dtype=torch.float32, device=dev),
            torch.tensor(active, device=dev))


def k3_random_scene(rng, params, dev, mode="mixed"):
    from scenelib2_torch.kernels.measure import NOUT, O_H, O_HX, O_HY, O_RD

    MF, NSEL = params.max_features, params.n_features_to_select
    D = 13 + 6 * MF
    A = rng.normal(size=(D, D))
    P = A @ A.T / D * 1e-3 + np.eye(D) * 1e-4
    x = rng.normal(size=D) * 0.1
    x[3:7] = rng.normal(size=4)
    x[3:7] /= np.linalg.norm(x[3:7]) * (1.0 + 1e-3)
    sel = np.zeros((NOUT, NSEL), np.float32)
    sel[O_HX : O_HX + 14] = rng.normal(size=(14, NSEL))
    sel[O_HY : O_HY + 6] = rng.normal(size=(6, NSEL))
    sel[O_RD] = rng.uniform(1.0, 2.0, NSEL)
    h = rng.uniform(20, 200, (NSEL, 2))
    sel[O_H : O_H + 2] = h.T
    z = h + rng.normal(0, 1.0, (NSEL, 2))
    active = rng.uniform(size=MF) > 0.2
    sel_mask = rng.uniform(size=NSEL) > 0.2
    succ = sel_mask & (rng.uniform(size=NSEL) > 0.4)
    if mode == "none":
        succ[:] = False
    top_idx = rng.choice(MF, NSEL, replace=False).astype(np.int32)
    active[top_idx[sel_mask]] = True
    attempts = rng.integers(0, 14, MF).astype(np.int32) * active
    successes = (attempts * rng.uniform(0.0, 1.0, MF)).astype(np.int32)
    sched = (rng.uniform(size=MF) > 0.6) & active
    label = np.where(active, rng.permutation(MF), -1).astype(np.int32)
    if mode == "run":
        # three list-consecutive scheduled slots: positions 0 and 2 die now
        order = np.argsort(np.where(active, label, 1 << 30), kind="stable")
        sched[order[:3]] = True
        active[order[:3]] = True
    offs = (13 + 6 * top_idx).astype(np.int32)
    f = dict(dtype=torch.float32, device=dev)
    i = dict(dtype=torch.int32, device=dev)
    return (torch.tensor(x, **f), torch.tensor(P, **f), torch.tensor(sel, **f),
            torch.tensor(z, **f), torch.tensor(succ, device=dev), torch.tensor(offs, **i),
            torch.tensor(attempts, **i), torch.tensor(successes, **i),
            torch.tensor(sched, device=dev), torch.tensor(active, device=dev),
            torch.tensor(label, **i), torch.tensor(sel_mask, device=dev),
            torch.tensor(top_idx, **i))


# ------------------------------------------------------------ checks


def check_k1(args, kw) -> float:
    from scenelib2_torch.kernels.predict_measure import predict_measure, predict_measure_plain

    got = predict_measure(*args, **kw)
    want = predict_measure_plain(*args, **kw)
    torch.cuda.synchronize()
    meas, sel, xo, Po, top_idx, top_score, n_vis, pidx, pmask = got
    wm, ws, wx, wP, wi, wsc, wn, wp, wpm = want
    for name, a, b in (("top_idx", top_idx, wi), ("n_visible", n_vis, wn), ("pidx", pidx, wp),
                       ("pmask", pmask, wpm)):
        if not same(a, b):
            fail(f"K1 {name} differs: kernel {a.tolist()} plain {b.tolist()}")
    # the selected set (as the step uses it: rank < n_visible & real score)
    if not same(top_score > -3e38, wsc > -3e38):
        fail("K1 selection mask differs")
    if not (rowwise_close(meas, wm, K1_TOL) and rowwise_close(sel, ws, K1_TOL)
            and matrix_close(xo, wx, K1_TOL) and matrix_close(Po, wP, K1_TOL)
            and rowwise_close(top_score[None], wsc[None], K1_TOL)):
        fail("K1 floats outside tolerance")
    return max(max_err(meas, wm), max_err(sel, ws), max_err(xo, wx), max_err(Po, wP))


def check_k2(args, c) -> float:
    from scenelib2_torch.kernels.search import search, search_plain

    got = search(*args, c)
    want = search_plain(*args, c)
    torch.cuda.synchronize()
    for name, a, b in zip(("found", "u", "v"), got[:3], want[:3]):
        if not same(a, b):
            fail(f"K2 {name} differs: kernel {a.tolist()} plain {b.tolist()}")
    if not same(got[4], want[4]):
        fail("K2 overflow differs")
    if not ulp_close(got[3], want[3], K2_BEST_ULP):
        fail(f"K2 best beyond {K2_BEST_ULP} ulp: {got[3].tolist()} vs {want[3].tolist()}")
    return max_err(got[3], want[3])


def check_k3(args, c) -> float:
    from scenelib2_torch.kernels.ekf_update import joint_update, joint_update_plain

    got = joint_update(*args, c)
    want = joint_update_plain(*args, c)
    torch.cuda.synchronize()
    for name, a, b in zip(("attempts", "successes", "sched", "kill"), got[2:], want[2:]):
        if not same(a, b):
            fail(f"K3 {name} differs: kernel {a.tolist()} plain {b.tolist()}")
    if not (matrix_close(got[0], want[0], K3_TOL) and matrix_close(got[1], want[1], K3_TOL)):
        fail("K3 x'/P' outside tolerance")
    if not same(got[1], got[1].T):
        fail("K3 P' not symmetric")
    return max(max_err(got[0], want[0]), max_err(got[1], want[1]))


def same_floats(a, b) -> bool:
    """Equal values, NaN where the other has NaN."""
    return nonfinite_equal(a, b) and max_err(a, b) == 0.0


def k5_variations(args, rng):
    """(label, args) cases of K5 from a real frame's inputs."""
    x, rng_l, occ, want, c = args
    out = [("real", args), ("want_false", (x, rng_l, occ, torch.zeros_like(want), c))]
    fall = x.clone()
    fall[7:10] = torch.tensor([0.0, -20.0, 0.0], device=x.device)   # no room
    out.append(("no_room", (fall, rng_l, occ, want, c)))
    grid = x.clone()
    MF = occ.shape[0]
    pts = [(u, v) for u in np.linspace(-0.9, 0.9, 4) for v in np.linspace(-0.6, 0.6, 4)]
    for k in range(MF):
        u, v = pts[k % len(pts)]
        grid[13 + 6 * k : 16 + 6 * k] = x[0:3] + torch.tensor(
            [u, v, 2.0 + rng.uniform(-0.1, 0.1)], dtype=torch.float32, device=x.device)
    out.append(("all_clash", (grid, rng_l, torch.ones_like(occ), want, c)))
    for t in range(3):
        y = x.clone()
        y[7:13] += torch.tensor(rng.normal(0, 0.1, 6), dtype=torch.float32, device=x.device)
        limbs = torch.tensor(rng.integers(0, 1 << 16, 3), dtype=torch.int32, device=x.device)
        out.append((f"seeded{t}", (y, limbs, torch.rand(MF, device=x.device) > 0.3, want, c)))
    return out


def k6_variations(args, rng, H, W):
    frame, ru, rv, ruf, rvf = args[:5]
    kw = args[5]
    dev = frame.device
    out = [("real", args)]
    out.append(("flat", (torch.full_like(frame, 117), ru, rv, ruf, rvf, kw)))
    tile = rng.integers(0, 256, (7, 9), dtype=np.uint8)
    tie = torch.tensor(np.tile(tile, (H // 7 + 1, W // 9 + 1))[:H, :W].copy(), device=dev)
    out.append(("tie", (tie, ru, rv, ruf, rvf, kw)))
    noise = torch.tensor(rng.integers(0, 256, (H, W), dtype=np.uint8), device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    for label, (u, v) in (("border", (250, 3)), ("random", (100, 90))):
        out.append((label, (noise, torch.tensor(max(u, 6), **i32), torch.tensor(max(v, 6), **i32),
                            torch.tensor(min(u + 80, W - 6), **i32),
                            torch.tensor(min(v + 60, H - 6), **i32), kw)))
    return out


def k4_variations(args, rng, H, W, B, erase_after):
    a = list(args)
    dev = a[0].device
    p = int(a[7][0])
    out = [("real", tuple(a))]

    def case(label, **repl):
        b = list(a)
        for i, v in repl.items():
            b[int(i[1:])] = v
        out.append((label, tuple(b)))

    case("making_false", i4=torch.zeros_like(a[4]))
    case("empty_union", i3=torch.zeros_like(a[3]))
    wide = a[10].clone()
    wide[48:] *= 400.0
    case("overflow", i10=wide)
    case("sell_by", i6=torch.full_like(a[6], erase_after + 1))
    alive = a[3].clone()
    alive[p] = torch.tensor(rng.uniform(size=a[3].shape[1]) > 0.3, device=dev)
    prob = a[1].clone()
    prob[p] = torch.tensor(rng.uniform(0.0, 0.02, a[1].shape[1]), dtype=torch.float32, device=dev)
    case("random_alive", i1=prob, i3=alive)
    tile = rng.integers(0, 256, (B, B), dtype=np.uint8)
    row = a[8].clone()
    row[: B * B] = torch.tensor(tile.reshape(-1), dtype=torch.float32, device=dev)
    row[B * B] = row[: B * B].sum()
    row[B * B + 1] = (row[: B * B] ** 2).sum()
    frame = torch.tensor(np.tile(tile, (H // B + 1, W // B + 1))[:H, :W].copy(), device=dev)
    case("tie", i0=frame, i8=row)
    return out


def check_k4(args) -> float:
    from scenelib2_torch.kernels.search_bayes import search_bayes, search_bayes_plain

    got = search_bayes(*args)
    want = search_bayes_plain(*args)
    torch.cuda.synchronize()
    names = ("prob", "palive", "mean", "cov", "convert", "kill", "n_over", "found", "z", "best", "pred")
    for name, a, b in zip(names, got, want):
        if a.dtype == torch.bool or not a.is_floating_point() or name == "z":
            if not same(a, b):
                fail(f"K4 {name} differs: kernel {a.flatten()[:8].tolist()} plain {b.flatten()[:8].tolist()}")
        elif not matrix_close(a, b, K4_TOL):
            fail(f"K4 {name} outside tolerance (max abs err {max_err(a, b)})")
    return max(max_err(a, b) for a, b in zip(got, want) if a.is_floating_point())


def check_k5(args) -> float:
    from scenelib2_torch.kernels.propose import propose, propose_plain

    got = propose(*args)
    want = propose_plain(*args)
    torch.cuda.synchronize()
    for name, a, b in zip(("region_us", "region_vs", "any_ok", "rng_new"), got, want):
        if not same(a, b):
            fail(f"K5 {name} differs: kernel {a.tolist()} plain {b.tolist()}")
    return 0.0


def check_k6(args) -> float:
    from scenelib2_torch.kernels.shi_tomasi import shi_tomasi, shi_tomasi_plain

    got = shi_tomasi(*args[:5], **args[5])
    want = shi_tomasi_plain(*args[:5], **args[5])
    torch.cuda.synchronize()
    for name, a, b in zip(("ubest", "vbest"), got[:2], want[:2]):
        if not same(a, b):
            fail(f"K6 {name} differs: kernel {a.tolist()} plain {b.tolist()}")
    if not (nonfinite_equal(got[2], want[2])
            and max_err(got[2], want[2]) <= K6_TOL * max(abs(float(want[2])), 1.0)):
        fail(f"K6 evbest outside tolerance: {got[2].tolist()} vs {want[2].tolist()}")
    return max_err(got[2], want[2])


# ------------------------------------------------------------ batch kernels


def lanes_of(fn, n):
    """fn(lane) for each of n lanes, results stacked field by field."""
    return tuple(torch.stack(o) for o in zip(*(fn(b) for b in range(n))))


def k7_random_scene(rng, params, dev, n_lanes=6):
    """K7 inputs of n_lanes seeded lanes: lane 0 holds a NaN score, lane 1
    has no visible feature (nothing active), lane 2 equal scores (every slot
    the same point and covariance)."""
    from scenelib2_torch.runtime import state as st

    MF = params.max_features
    xs, Ps, xpos, acts = [], [], [], []
    for b in range(n_lanes):
        x, P, xpo, act_full, _part = k1_random_scene(rng, params, dev, nan_lane=b == 0)
        if b == 1:
            act_full = torch.zeros_like(act_full)
        if b == 2:
            x = x.clone()
            P = torch.eye(x.shape[0], device=dev) * 1e-4
            for k in range(1, MF):
                x[13 + 6 * k : 19 + 6 * k] = x[13:19]
            xpo = xpo[:1].expand(MF, 7).contiguous()
            act_full = torch.ones_like(act_full)
        xs.append(x); Ps.append(P); xpos.append(xpo); acts.append(act_full)
    x, P = torch.stack(xs), torch.stack(Ps)
    return (x[:, :7].contiguous(), P[:, :7, :7].contiguous(), st.slot_states(x, MF)[..., :3].contiguous(),
            torch.stack(xpos), st.slot_pxy(P, MF)[..., :7, :3].contiguous(),
            st.slot_pyy(P, MF)[..., :3, :3].contiguous(), torch.stack(acts))


def check_k7(args, c, nsel) -> float:
    from scenelib2_torch.kernels.measure import (
        O_SCORE, O_VIS, measure_predict, measure_predict_plain, stable_top_k)

    got = measure_predict(*args, c)
    want = measure_predict_plain(*args, c)
    torch.cuda.synchronize()
    if not same(got[:, O_VIS], want[:, O_VIS]):
        fail("K7 visibility flags differ")
    (gs, gi), (ws, wi) = stable_top_k(got[:, O_SCORE], nsel), stable_top_k(want[:, O_SCORE], nsel)
    if not (same(gi, wi) and same(gs > -torch.inf, ws > -torch.inf)):
        fail(f"K7 selection differs: kernel {gi.tolist()} plain {wi.tolist()}")
    for b in range(got.shape[0]):
        if not rowwise_close(got[b], want[b], K1_TOL):
            fail(f"K7 rows outside tolerance in lane {b}")
    return max_err(got, want)


def k9_random_scene(rng, params, dev):
    """Four lanes: noise, a flat image, a periodic image (tied scores), noise
    with a flat patch."""
    from scenelib2_torch.runtime.state import patch_row

    H, W, B = params.cam_height, params.cam_width, params.boxsize
    noise = rng.integers(0, 256, (H, W), dtype=np.uint8)
    tile = rng.integers(0, 256, (B, B), dtype=np.uint8)
    periodic = np.tile(tile, (H // B + 1, W // B + 1))[:H, :W]
    imgs = [noise, np.full((H, W), 117, np.uint8), periodic, rng.integers(100, 104, (H, W), dtype=np.uint8)]
    patches = [noise[50:50 + B, 60:60 + B], noise[80:80 + B, 90:90 + B], tile, np.full((B, B), 90, np.uint8)]
    frames = torch.tensor(np.stack(imgs), device=dev)
    rows = torch.stack([patch_row(torch.tensor(np.ascontiguousarray(q), device=dev)) for q in patches])[:, None]
    return frames, rows


def check_k9(frames, rows, c) -> float:
    from scenelib2_torch.kernels.score_map import MISS, score_map, score_map_plain

    got = score_map(frames, rows, c)
    want = score_map_plain(frames, rows, c)
    torch.cuda.synchronize()
    if not same(got == MISS, want == MISS):
        fail("K9 invalid-centre cells differ")
    if not (nonfinite_equal(got, want) and max_err(got, want) <= K9_TOL):
        fail(f"K9 scores outside tolerance: max abs err {max_err(got, want)}")
    return max_err(got, want)


def check_k10(shared, slot_rows, lam, c) -> float:
    from scenelib2_torch.kernels.particle import particle_predict, particle_predict_plain

    got = particle_predict(shared, slot_rows, lam, c)
    want = particle_predict_plain(shared, slot_rows, lam, c)
    torch.cuda.synchronize()
    for b in range(got.shape[0]):
        for f in range(got.shape[1]):
            if not rowwise_close(got[b, f], want[b, f], K4_TOL):
                fail(f"K10 rows outside tolerance in lane {b} slot {f} "
                     f"(max abs err {max_err(got[b, f], want[b, f])})")
    return max_err(got, want)


K11_NAMES = ("prob", "palive", "mean", "cov", "convert", "kill", "n_over", "found", "z", "best")


def compare_sb(got, want, what) -> float:
    """The outputs of K11 (or K4) against a reference: booleans, integers and
    z exactly, floats within K4_TOL of the largest entry."""
    for name, a, b in zip(K11_NAMES, got, want):
        if a.dtype == torch.bool or not a.is_floating_point() or name == "z":
            if not same(a, b):
                bad = torch.nonzero((a != b).reshape(a.shape[0], -1).any(-1)).flatten().tolist()
                fail(f"{what} {name} differs in lanes {bad[:8]}")
        elif not matrix_close(a, b, K4_TOL):
            fail(f"{what} {name} outside tolerance (max abs err {max_err(a, b)})")
    return max(max_err(a, b) for a, b in zip(got, want) if a.is_floating_point())


def check_k11(args) -> float:
    from scenelib2_torch.kernels.search_bayes import search_bayes_maps, search_bayes_maps_plain

    got = search_bayes_maps(*args)
    want = search_bayes_maps_plain(*args)
    torch.cuda.synchronize()
    return compare_sb(got, want, "K11")


def k11_variations(args, rng, erase_after):
    """(label, args) cases of K11 from a captured call (all lanes at once)."""
    a = list(args)
    dev = a[0].device
    out = [("real", tuple(a))]

    def case(label, **repl):
        b = list(a)
        for i, v in repl.items():
            b[int(i[1:])] = v
        out.append((label, tuple(b)))

    case("making_false", i5=torch.zeros_like(a[5]))
    case("empty_union", i4=torch.zeros_like(a[4]))
    wide = a[1].clone()
    wide[:, :, 6:8] *= 40.0          # ROW_HW, ROW_HH: boxes beyond the window
    case("overflow", i1=wide)
    case("sell_by", i7=torch.full_like(a[7], erase_after + 1))
    alive = torch.tensor(rng.uniform(size=tuple(a[4].shape)) > 0.3, device=dev)
    prob = torch.tensor(rng.uniform(0.0, 0.02, tuple(a[2].shape)), dtype=torch.float32, device=dev)
    case("random_alive", i2=prob, i4=alive, i5=torch.ones_like(a[5]))
    return out


def search_lanes_plain(args, c):
    """K2's plain version lane by lane on K2-over-lanes arguments."""
    from scenelib2_torch.kernels.search import search_plain

    frames, rest = args[0], args[1:8]
    return lanes_of(lambda b: search_plain(frames[b], *(t[b] for t in rest), c), frames.shape[0])


def check_k2_lanes(args, c) -> float:
    """K2 launched once over all lanes against its plain version lane by lane."""
    from scenelib2_torch.kernels.search import search

    got = search(*args[:8], c)
    want = search_lanes_plain(args, c)
    torch.cuda.synchronize()
    for name, a, b in zip(("found", "u", "v"), got[:3], want[:3]):
        if not same(a, b):
            fail(f"K2 over lanes: {name} differs")
    if not same(got[4], want[4]):
        fail("K2 over lanes: overflow differs")
    if not ulp_close(got[3], want[3], K2_BEST_ULP):
        fail(f"K2 over lanes: best beyond {K2_BEST_ULP} ulp")
    return max_err(got[3], want[3])


def check_k6_lanes(args, kw) -> float:
    """K6 launched once over all lanes against its plain version lane by lane."""
    from scenelib2_torch.kernels.shi_tomasi import shi_tomasi, shi_tomasi_plain

    frames = args[0]
    got = shi_tomasi(*args, **kw)
    want = lanes_of(lambda b: shi_tomasi_plain(frames[b], *(t[b] for t in args[1:]), **kw),
                    frames.shape[0])
    torch.cuda.synchronize()
    for name, a, b in zip(("ubest", "vbest"), got[:2], want[:2]):
        if not same(a, b):
            fail(f"K6 over lanes: {name} differs")
    err = max_err(got[2], want[2])
    if not (nonfinite_equal(got[2], want[2]) and err <= K6_TOL * max(float(want[2].abs().max()), 1.0)):
        fail(f"K6 over lanes: evbest outside tolerance ({err})")
    return err


def check_k10_k11_against_k4(a4, smc, sbc) -> float:
    """On one single-stream K4 call: K10 writes exactly K4's prediction rows,
    and K11 given K9's map of the same frame and patch returns exactly K4's
    results for the slot."""
    from scenelib2_torch.kernels.particle import particle_predict
    from scenelib2_torch.kernels.score_map import score_map
    from scenelib2_torch.kernels.search_bayes import search_bayes, search_bayes_maps

    frame, prob, lam, palive, making, pmask, ma, pidx, patch_row, shared, slot_row, _c = a4
    k4 = search_bayes(*a4)
    NP = prob.shape[1]
    row = pidx.long()
    pred = particle_predict(shared[None], slot_row[None, None], lam[row][None], sbc.particle)
    if not same_floats(pred[0, :, :, :NP], k4[10]):
        fail("K10 rows differ from the rows K4 computes for the same slot")
    maps = score_map(frame[None], patch_row[None, None], smc)
    k11 = search_bayes_maps(maps, pred, prob[row][None], lam[row][None], palive[row][None],
                            making[None], pmask[None], ma[None], sbc)
    torch.cuda.synchronize()
    want = (k4[0][row][None], k4[1][row][None]) + tuple(t[None] for t in k4[2:10])
    for name, a, b in zip(K11_NAMES, k11, want):
        ok = same_floats(a, b) if a.is_floating_point() else same(a, b)
        if not ok:
            fail(f"K11 given K9's map differs from K4 on the same slot: {name}")
    return 0.0


# ------------------------------------------------------------ large maps: K14


def k14_random_cases(rng, dev):
    """(label, S) SPD cases for K14: seeded matrices of every size class the
    kernel takes, a stack of three, and an EKF-shaped S = H P H' + R at
    M = 20 whose missed rows are identity blocks (H = 0, R = 1)."""
    f = dict(dtype=torch.float32, device=dev)
    out = []
    for M in (1, 2, 7, 20, 64, 128):
        A = rng.normal(size=(M, M))
        out.append((f"spd{M}", torch.tensor(A @ A.T / M + np.eye(M) * 0.5, **f)))
    A = rng.normal(size=(3, 20, 20))
    out.append(("stack3x20", torch.tensor(A @ A.transpose(0, 2, 1) / 20 + np.eye(20), **f)))
    D = 109
    B = rng.normal(size=(D, D))
    P = B @ B.T / D * 1e-3 + np.eye(D) * 1e-4
    H = rng.normal(size=(20, D)) * 30.0
    miss = rng.uniform(size=10) < 0.4
    H[np.repeat(miss, 2)] = 0.0
    R = np.diag(np.where(np.repeat(miss, 2), 1.0, rng.uniform(1.0, 2.0, 20)))
    out.append(("ekf", torch.tensor(H @ P @ H.T + R, **f)))
    return out


def check_k14(S) -> float:
    from scenelib2_torch.kernels.chol_inv import chol_inv, chol_linv

    got = chol_inv(S)
    want = chol_linv(S)
    torch.cuda.synchronize()
    if not matrix_close(got, want, K14_TOL):
        fail(f"K14 L^-1 outside tolerance at M={S.shape[-1]} (max abs err {max_err(got, want)})")
    return max_err(got, want)


# ------------------------------------------------------------ large maps: the replays

# hires: BASELINE config 3 (eval/synthetic.py HIRES_PARAMS, HIRES_OVERRIDES);
# mf100: the std sequence at max_features 100. "at": the output indices whose
# kernel inputs are checked
LARGE_MAPS = {
    "hires": dict(n_frames=120, at=(9, 10, 37, 60)),   # making, a conversion, a light frame, later
    "mf100": dict(n_frames=240, at=(9, 20, 120)),      # the first init, the first conversion, later
}
N_REF_LARGE = 20   # CPU plain replay frames of each large-map path
N_TIMED_LARGE = 2  # timed replays of each large-map path
N_TRACE_LARGE = 40  # frames of the traced window (the profiler's own bookkeeping grows with events)


def large_map_phase(tag: str, name: str, tmp: str, dev, rng) -> dict:
    """Phases 3c (hires) and 3d (mf100): the replay through
    MonoSLAM(device="cuda").run_sequence against its committed fingerprint
    with its launch counts, the kernels of its path against their plain
    versions on inputs captured from that replay, the CPU plain replay of
    its first frames, steps under sync debug mode "error", and its times."""
    from scenelib2_torch import MonoSLAM
    from scenelib2_torch.config import Params
    from scenelib2_torch.eval.fingerprint import decisions_fingerprint, load_expected
    from scenelib2_torch.eval.synthetic import HIRES_OVERRIDES, HIRES_PARAMS, generate_dataset
    from scenelib2_torch.kernels import (
        _build, chol_inv, ekf_update, predict_measure, search, search_bayes)

    spec = LARGE_MAPS[name]
    if name == "hires":
        dataset, overrides = Params(**HIRES_PARAMS), HIRES_OVERRIDES
    else:
        dataset, overrides = None, dict(max_features=100)
    t0 = time.time()
    frames, _gt_r, _gt_q, cfg = generate_dataset(
        os.path.join(tmp, name), n_frames=spec["n_frames"], seed=7, params=dataset)
    slam = MonoSLAM(cfg, device="cuda", **overrides)
    p = slam.params
    D = 13 + 6 * p.max_features
    path = SINGLE_PATH if D <= 384 else SPLIT_PATH
    H, W, B = p.cam_height, p.cam_width, p.boxsize
    seq = torch.as_tensor(frames[1:]).to(dev)
    n_run = seq.shape[0]
    log(f"[{tag}] {name}: {W}x{H}, max_features {p.max_features} (D = {D}), {p.n_particles} particles, "
        f"search radius {p.search_win_radius}, particle radius {p.particle_win_radius}; {n_run} frames "
        f"rendered in {time.time() - t0:.1f} s; route {'fused' if D <= 384 else 'split'}")
    slam.run_sequence(seq[:8], enable_mapping=True)          # warm-up
    torch.cuda.synchronize()

    # the main path: counts zeroed just before, read just after; the kernel
    # inputs of the frames in spec["at"] kept, and every launch's inputs for
    # its cost (the first wrapper of a frame is K1 on the fused route, K7 on
    # the split one)
    first = "predict_measure" if D <= 384 else "measure_predict"
    seen, calls, frame = {}, {}, [-1]

    def keep(n, a, k):
        if n == first:
            frame[0] += 1
        if frame[0] in spec["at"]:
            seen.setdefault(frame[0], {})[n] = (a, k)
        calls.setdefault(n, []).append((a, k))

    outs, launches = run_main_path(slam, seq, mapping=True, on_call=keep)
    fp = decisions_fingerprint(outs, n_run)
    want = load_expected(f"expected_fingerprint_{name}")
    log(f"[{tag}] fingerprint ({name}): {json.dumps(fp)}")
    for k in ("n_frames", "matched_sum", "inits", "convs", "active_end", "decisions_sha256"):
        if fp[k] != want[k]:
            fail(f"{name} field {k}: got {fp[k]}, expected {want[k]}")
    for n in _build.KERNELS:
        if launches.get(n, 0) != (n_run if n in path else 0):
            fail(f"kernel {n} launched {launches.get(n, 0)} times on the {name} path, expected "
                 f"{n_run if n in path else 0}")
    log(f"[{tag}] launches on the {name} path: {json.dumps(launches)}")
    r = outs.r.numpy()
    if r.shape != (n_run, 3) or not np.isfinite(r).all():
        fail(f"{name} trajectory not finite/shaped: {r.shape}")

    # the path's kernels against their plain versions on the captured inputs
    errs, n_cases = {}, {}

    def worse(k, v):
        errs[k] = max(errs.get(k, 0.0), v)
        n_cases[k] = n_cases.get(k, 0) + 1

    sc = search.SearchConsts.from_params(p)
    uc = ekf_update.UpdateConsts.from_params(p)
    for at in spec["at"]:
        c = seen[at]
        a2, _ = c["search"]
        if D <= 384:
            worse("K1", check_k1(*c["predict_measure"]))
            worse("K2", check_k2(a2[:-1], sc))
            worse("K3", check_k3(c["joint_update"][0][:-1], uc))
        else:
            worse("K7", check_k7(c["measure_predict"][0][:7], c["measure_predict"][0][7],
                                 p.n_features_to_select))
            worse("K2", check_k2_lanes(a2, sc))
            worse("K14", check_k14(c["chol_inv"][0][0]))
        for _label, args in k4_variations(c["search_bayes"][0], rng, H, W, B,
                                          p.erase_partial_after_attempts):
            worse("K4", check_k4(args))
    log(f"[{tag}] the {name} kernels equal their plain versions on the inputs of output indices "
        f"{spec['at']} (cases {json.dumps(n_cases)}; max abs err {json.dumps(errs)})")

    # reference on a small input: the CPU plain replay of the first frames
    cpu = MonoSLAM(cfg, device="cpu", **overrides)
    ref = cpu.run_sequence(frames[1 : N_REF_LARGE + 1], enable_mapping=True)
    for k in ("n_visible", "n_selected", "n_matched", "n_active", "n_partial", "did_init",
              "did_convert", "n_overflow", "sel_slot", "sel_matched", "init_box", "par_alive"):
        if not torch.equal(getattr(ref, k), getattr(outs, k)[:N_REF_LARGE]):
            fail(f"{name}: CUDA vs CPU plain replay: {k} differs in the first {N_REF_LARGE} frames")
    dxv = float((ref.xv.double() - outs.xv[:N_REF_LARGE].double()).abs().max())
    if dxv > STEP_TOL:
        fail(f"{name}: CUDA vs CPU plain replay: xv differs by {dxv}")
    log(f"[{tag}] {name}: the CUDA run equals the CPU plain replay on frames 1..{N_REF_LARGE} "
        f"(inits at {torch.nonzero(ref.did_init).flatten().tolist()}, conversions at "
        f"{torch.nonzero(ref.did_convert).flatten().tolist()}; max |dxv| {dxv:.3g})")

    # no host synchronisation in the step
    slam.reset()
    state = slam.state
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for t in range(N_REF):
            state, _out = slam._step(state, seq[t], True)
    except RuntimeError as e:
        fail(f"the {name} step synchronised with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log(f"[{tag}] {N_REF} {name} steps ran with torch.cuda.set_sync_debug_mode('error'): "
        f"no host synchronisation in the step")

    # times: untimed replays for ms/frame and peak memory, one traced replay.
    # The path's peak memory: its frames and state, plus the most the
    # replays allocated above what was allocated before them (the process
    # still holds the earlier phases' tensors)
    per_frame = []
    slam.reset()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(N_TIMED_LARGE):
        slam.reset()
        torch.cuda.synchronize()
        t = time.perf_counter()
        slam.run_sequence(seq, enable_mapping=True)
        per_frame.append((time.perf_counter() - t) / n_run * 1e3)
    held = seq.numel() + sum(t_.numel() * t_.element_size() for t_ in slam.state)
    peak_mb = (torch.cuda.max_memory_allocated() - base + held) / 2**20
    ms_frame = statistics.median(per_frame)
    # the traced window: its first N_TRACE_LARGE frames, beside an untraced
    # replay of the same frames
    nt = min(N_TRACE_LARGE, n_run)
    slam.reset()
    torch.cuda.synchronize()
    t = time.perf_counter()
    slam.run_sequence(seq[:nt], enable_mapping=True)
    ms_window = (time.perf_counter() - t) / nt * 1e3
    prof = profile_main_path(slam, seq, nt, True)
    busy = prof["device_ms"] / nt
    res = dict(ms_frame=ms_frame, runs=per_frame, ms_frame_window=ms_window, traced_frames=nt,
               busy=busy if busy > 0 else None,
               idle_share=(1.0 - busy / ms_window) if busy > 0 else None, peak_mb=peak_mb,
               kernels_per_frame=sum(c_ for _m, c_ in prof["by_name"].values()) / nt)
    log(f"[{tag}] {name}: {ms_frame:.4f} ms/frame (median of {N_TIMED_LARGE} runs of {n_run} frames: "
        f"{', '.join(f'{v:.4f}' for v in per_frame)}); peak device memory of the replay {peak_mb:.1f} MiB "
        f"(frames and state included)")
    if busy > 0:
        log(f"[{tag}] {name} traced replay of frames 1..{nt}: device busy {busy:.4f} ms/frame of "
            f"{ms_window:.4f} ms/frame untraced over the same frames -> idle share "
            f"{res['idle_share']:.4f}; {res['kernels_per_frame']:.2f} device kernels/frame; traced "
            f"wall {prof['wall_ms'] / nt:.4f} ms/frame")
        for kname, (ms, cnt) in sorted(prof["by_name"].items(), key=lambda kv: -kv[1][0])[:12]:
            log(f"[{tag}]   {ms / nt * 1e3:9.3f} us/frame  x{cnt / nt:6.2f}/frame  {kname[:90]}")
    else:
        log(f"[{tag}] {name} traced replay: the profiler recorded no device time (not measured)")

    def dev_ms(sym):
        hits = [v for k, v in prof["by_name"].items() if sym in k]
        return sum(h[0] for h in hits) / max(1, sum(h[1] for h in hits)) if hits else None

    # each kernel of the path that this slice added or widened: its time, its
    # plain version's, its bound from each launch's own inputs
    c = seen[spec["at"][1]]
    a2, _ = c["search"]
    a4, _ = c["search_bayes"]
    kern = {
        # the split route launches K2 over its one lane
        "K2": (lambda: search.search(*a2),
               (lambda: search.search_plain(*a2)) if D <= 384 else (lambda: search_lanes_plain(a2, sc)),
               "k2_kernel"),
        "K4": (lambda: search_bayes.search_bayes(*a4), lambda: search_bayes.search_bayes_plain(*a4),
               "k4_kernel"),
    }
    costs = {"K2": [], "K4": []}
    for a, _k in calls["search"]:
        admit = search.candidate_geometry(*(t.reshape(-1) for t in a[2:6]), a[6].reshape(-1, 3), sc)[0]
        costs["K2"].append(search.bytes_and_flops(a[2].numel(), sc, int(admit.sum())))
    for a, _k in calls["search_bayes"]:
        MF, NP = a[1].shape
        costs["K4"].append(search_bayes.bytes_and_flops(MF, NP, H, W, B, *search_bayes.work_counts(*a)))
    library = {}
    if D <= 384:
        a1, kw1 = c["predict_measure"]
        a3, _ = c["joint_update"]
        kern["K1"] = (lambda: predict_measure.predict_measure(*a1, **kw1),
                      lambda: predict_measure.predict_measure_plain(*a1, **kw1), "k1_kernel")
        kern["K3"] = (lambda: ekf_update.joint_update(*a3), lambda: ekf_update.joint_update_plain(*a3),
                      "k3_kernel")
        costs["K1"] = [predict_measure.bytes_and_flops(a[0].shape[0], a[2].shape[0], k["nsel"])
                       for a, k in calls["predict_measure"]]
        costs["K3"] = [ekf_update.bytes_and_flops(a[0].shape[0], a[2].shape[1], a[6].shape[0])
                       for a, _k in calls["joint_update"]]
    else:
        S = c["chol_inv"][0][0]
        eye = torch.eye(S.shape[-1], device=dev)
        kern["K14"] = (lambda: chol_inv.chol_inv(S), lambda: chol_inv.chol_linv(S), "k14_kernel")
        costs["K14"] = [chol_inv.bytes_and_flops(a[0][..., 0, 0].numel(), a[0].shape[-1])
                        for a, _k in calls["chol_inv"]]
        # the nearest library form: two calls (factor, then a triangular solve)
        library["K14"] = time_ms(lambda: torch.linalg.solve_triangular(
            torch.linalg.cholesky_ex(S)[0], eye, upper=False))
    timings = {}
    for short, (fk, fp_, sym) in kern.items():
        b_ms, b_by = bound(costs[short])
        timings[short] = dict(ms=time_ms(fk), plain_ms=time_ms(fp_, n=5, batches=3), device_ms=dev_ms(sym),
                              bound_ms=b_ms, bound_by=b_by, library_ms=library.get(short),
                              max_abs_err=errs[short], launches=launches[KERNEL_OF[short]])
        log(f"[{tag}] {short} at the {name} shapes: {json.dumps(timings[short])}")
    res.update(timings=timings, fingerprint=fp, launches=launches, errs=errs)
    return res


def bound(costs_list):
    """(mean over launches of max(bytes / peak rate, operations / peak rate)
    in ms, which of the two bounds the sum)."""
    bms = [max(b / PEAK_BYTES, f / PEAK_F32) * 1e3 for b, f in costs_list]
    nb = sum(b for b, _ in costs_list) / PEAK_BYTES
    nf = sum(f for _, f in costs_list) / PEAK_F32
    return statistics.mean(bms), ("bytes" if nb >= nf else "operations")


# ------------------------------------------------------------ main


def profile_main_path(slam, seq, n: int, mapping: bool) -> dict:
    """torch.profiler over an n-frame replay: device time by kernel name,
    total device time, and wall time of the traced window."""
    from torch.profiler import ProfilerActivity, profile

    slam.reset()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        slam.run_sequence(seq[:n], enable_mapping=mapping)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    by_name = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        by_name[e.key] = (us / 1e3, e.count)
    return dict(wall_ms=wall_ms, device_ms=sum(v[0] for v in by_name.values()), by_name=by_name)


SINGLE_WRAPPERS = ("predict_measure", "search", "joint_update", "propose", "shi_tomasi", "search_bayes")
WRAPPERS = ("predict_measure", "search", "joint_update", "propose", "shi_tomasi", "search_bayes",
            "measure_predict", "score_map", "particle_predict", "search_bayes_maps", "chol_inv")
# the kernels of each main path (launch-count names of kernels/_build.py)
SINGLE_PATH = ("predict_measure", "search", "ekf_update", "propose", "shi_tomasi", "search_bayes")
SPLIT_PATH = ("measure", "search", "chol_inv", "propose", "shi_tomasi", "search_bayes")
BATCH_PATH = ("measure", "search", "shi_tomasi", "score_map", "particle_predict", "search_bayes_maps")
KERNEL_OF = {"K1": "predict_measure", "K2": "search", "K3": "ekf_update", "K4": "search_bayes",
             "K7": "measure", "K14": "chol_inv"}


@contextlib.contextmanager
def observe_wrappers(on_call):
    """Within the block, the steps call on_call(name, args, kwargs) before
    each kernel wrapper (K1 predict_measure, K2 search, K3 joint_update,
    K5 propose, K6 shi_tomasi, K4 search_bayes; K7 measure_predict, K9
    score_map, K10 particle_predict, K11 search_bayes_maps; K14 chol_inv,
    which core/ekf.py calls)."""
    import scenelib2_torch.core.ekf as ekf_mod
    import scenelib2_torch.runtime.step as step_mod

    names = WRAPPERS
    mod = {n: ekf_mod if n == "chol_inv" else step_mod for n in names}
    orig = {n: getattr(mod[n], n) for n in names}

    def wrap(n):
        def call(*a, **k):
            on_call(n, a, k)
            return orig[n](*a, **k)
        return call

    for n in names:
        setattr(mod[n], n, wrap(n))
    try:
        yield
    finally:
        for n in names:
            setattr(mod[n], n, orig[n])


def capture_inputs(slam, frames, at: tuple) -> dict:
    """Drive the step on the GPU with mapping on through output index
    max(at) and return {index: {wrapper: (args, kwargs)}} for the indices in
    `at`."""
    seen, cur = {}, {}
    with observe_wrappers(lambda n, a, k: cur.__setitem__(n, (a, k))):
        slam.reset()
        for t in range(max(at) + 1):
            cur.clear()
            slam.go_one_step(frames[t + 1])
            if t in at:
                seen[t] = dict(cur)
    torch.cuda.synchronize()
    return seen


def run_main_path(slam, seq, mapping: bool, on_call=None):
    """One replay with every launch count zeroed just before it; returns
    (outputs, launches read just after it)."""
    from scenelib2_torch.kernels import _build

    slam.reset()
    torch.cuda.synchronize()
    _build.reset_launches()
    with observe_wrappers(on_call) if on_call else contextlib.nullcontext():
        outs = slam.run_sequence(seq, enable_mapping=mapping)
    return outs, dict(_build.launches)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    from scenelib2_torch import MonoSLAM
    from scenelib2_torch.eval.fingerprint import decisions_fingerprint, load_expected
    from scenelib2_torch.eval.synthetic import generate_dataset
    from scenelib2_torch.kernels import (
        _build, ekf_update, measure, particle, predict_measure, propose, score_map, search,
        search_bayes, shi_tomasi,
    )
    from scenelib2_torch.kernels.measure import MeasureConsts

    t_start = time.time()
    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    print(smi, flush=True)
    log(f"[1] device: {kind} (count {torch.cuda.device_count()}), torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    t0 = time.time()
    _build.build_all(verbose=True)
    for n in _build.SOURCES:
        _build.load(n)
    log(f"[1] built {len(_build.SOURCES)} kernel libraries in {time.time() - t0:.1f} s")

    with tempfile.TemporaryDirectory() as tmp:
        frames, gt_r, _gt_q, cfg = generate_dataset(tmp, n_frames=240, seed=7)
        slam = MonoSLAM(cfg, max_features=16, device="cuda")
        p = slam.params
        H, W, B = p.cam_height, p.cam_width, p.boxsize
        mc = MeasureConsts.from_params(p)
        sc = search.SearchConsts.from_params(p)
        uc = ekf_update.UpdateConsts.from_params(p)
        k1kw = dict(nsel=p.n_features_to_select, maxp=max(1, p.max_features_to_init_at_once),
                    dt=p.delta_t, sd_a=p.sd_a, sd_alpha=p.sd_alpha, consts=mc)

        # ---- 2. kernel vs plain ------------------------------------------
        rng = np.random.default_rng(2026)
        errs = {k: 0.0 for k in ("K1", "K2", "K3", "K4", "K5", "K6")}
        for trial in range(6):
            errs["K1"] = max(errs["K1"], check_k1(k1_random_scene(rng, p, dev, nan_lane=trial == 0), k1kw))
            errs["K2"] = max(errs["K2"], check_k2(k2_random_scene(rng, p, dev, tie=trial < 2), sc))
            mode = ("none", "run", "mixed")[trial % 3]
            errs["K3"] = max(errs["K3"], check_k3(k3_random_scene(rng, p, dev, mode), uc))
        seen = capture_inputs(slam, frames, at=(9, 20, 120))
        a1, kw1 = seen[120]["predict_measure"]
        a2, _ = seen[120]["search"]
        a3, _ = seen[120]["joint_update"]
        errs["K1"] = max(errs["K1"], check_k1(a1, kw1))
        errs["K2"] = max(errs["K2"], check_k2(a2[:-1], sc))
        errs["K3"] = max(errs["K3"], check_k3(a3[:-1], uc))
        n_cases = {"K4": 0, "K5": 0, "K6": 0}
        for at in (9, 20, 120):
            a5, _ = seen[at]["propose"]
            for _label, args in k5_variations(a5, rng):
                errs["K5"] = max(errs["K5"], check_k5(args))
                n_cases["K5"] += 1
            a6, kw6 = seen[at]["shi_tomasi"]
            for _label, args in k6_variations(tuple(a6) + (kw6,), rng, H, W):
                errs["K6"] = max(errs["K6"], check_k6(args))
                n_cases["K6"] += 1
            a4, _ = seen[at]["search_bayes"]
            for _label, args in k4_variations(a4, rng, H, W, B, p.erase_partial_after_attempts):
                errs["K4"] = max(errs["K4"], check_k4(args))
                n_cases["K4"] += 1
        log(f"[2] kernels equal their plain versions: K1-K3 on 6 random scenes + frame 120, "
            f"K4/K5/K6 on {n_cases} cases from frames 9, 20, 120 and their variations "
            f"(max abs err {json.dumps(errs)})")
        k14_err = 0.0
        for label, S in k14_random_cases(rng, dev):
            k14_err = max(k14_err, check_k14(S))
        log(f"[2] K14 equals its plain version on seeded SPD matrices (M = 1, 2, 7, 20, 64, 128, a "
            f"stack of three 20 x 20, an EKF-shaped S with missed rows) (max abs err {k14_err})")

        a4, _ = seen[20]["search_bayes"]
        a5, _ = seen[9]["propose"]
        a6, kw6 = seen[9]["shi_tomasi"]
        timings = {}
        for name, kern, plain in (
            ("K1", lambda: predict_measure.predict_measure(*a1, **kw1),
             lambda: predict_measure.predict_measure_plain(*a1, **kw1)),
            ("K2", lambda: search.search(*a2), lambda: search.search_plain(*a2)),
            ("K3", lambda: ekf_update.joint_update(*a3), lambda: ekf_update.joint_update_plain(*a3)),
            ("K4", lambda: search_bayes.search_bayes(*a4), lambda: search_bayes.search_bayes_plain(*a4)),
            ("K5", lambda: propose.propose(*a5), lambda: propose.propose_plain(*a5)),
            ("K6", lambda: shi_tomasi.shi_tomasi(*a6, **kw6), lambda: shi_tomasi.shi_tomasi_plain(*a6, **kw6)),
        ):
            timings[name] = (time_ms(kern), time_ms(plain, n=10, batches=3))
        empty = _build.function("predict_measure", "k0_empty_launch", [ctypes.c_void_p])
        empty_ms = time_ms(lambda: empty(torch.cuda.current_stream().cuda_stream))
        for name, (k_ms, p_ms) in timings.items():
            log(f"[2] {name}: kernel {k_ms:.4f} ms/launch, plain {p_ms:.4f} ms/call "
                f"(frame-{dict(K4=20, K5=9, K6=9).get(name, 120)} inputs)")
        log(f"[2] empty kernel launch: {empty_ms:.4f} ms")

        # ---- 3. main paths ------------------------------------------------
        seq = torch.as_tensor(frames[1:]).to(dev)
        n_run = seq.shape[0]
        slam.reset()
        slam.run_sequence(seq[:8], enable_mapping=True)           # warm-up
        torch.cuda.synchronize()

        def check_fingerprint(outs, name):
            fp = decisions_fingerprint(outs, n_run)
            want = load_expected(name)
            log(f"[3] fingerprint ({name}): {json.dumps(fp)}")
            for k in ("n_frames", "matched_sum", "inits", "convs", "active_end", "decisions_sha256"):
                if fp[k] != want[k]:
                    fail(f"{name} field {k}: got {fp[k]}, expected {want[k]}")

        def check_launches(launches, what, stage7):
            for n in _build.KERNELS:
                want = n_run if n in SINGLE_PATH else 0
                if n in ("propose", "shi_tomasi") and not stage7:
                    want = 0
                if launches.get(n, 0) != want:
                    fail(f"kernel {n} launched {launches.get(n, 0)} times on the {what} path, "
                         f"expected {want}")
            log(f"[3] launches on the {what} path: {json.dumps(launches)}")

        outs_nomap, launches_nomap = run_main_path(slam, seq, mapping=False)
        check_fingerprint(outs_nomap, "expected_fingerprint_nomap")
        check_launches(launches_nomap, "mapping-off", stage7=False)

        # cost model of each launch on the mapping-on path, from its own inputs
        costs = {k: [] for k in ("K1", "K2", "K3", "K4", "K5", "K6")}
        k4_args = []

        def record_cost(n, a, k):
            if n not in SINGLE_WRAPPERS:
                raise AssertionError(f"the single-stream step called the batch wrapper {n}")
            if n == "predict_measure":
                costs["K1"].append(
                    predict_measure.bytes_and_flops(a[0].shape[0], a[2].shape[0], k["nsel"]))
            elif n == "search":
                admit = search.candidate_geometry(a[2], a[3], a[4], a[5], a[6], a[8])[0]
                costs["K2"].append((admit, a[2].shape[0]))
            elif n == "joint_update":
                costs["K3"].append(
                    ekf_update.bytes_and_flops(a[0].shape[0], a[2].shape[1], a[6].shape[0]))
            elif n == "propose":
                costs["K5"].append(propose.bytes_and_flops(a[2].shape[0], a[4].tries))
            elif n == "shi_tomasi":
                costs["K6"].append(shi_tomasi.bytes_and_flops(k["boxsize"], k["region_w"], k["region_h"]))
            else:
                k4_args.append(a)

        outs, launches = run_main_path(slam, seq, mapping=True, on_call=record_cost)
        check_fingerprint(outs, "expected_fingerprint")
        check_launches(launches, "mapping-on", stage7=True)
        for a in k4_args:
            MF, NP = a[1].shape
            costs["K4"].append(search_bayes.bytes_and_flops(
                MF, NP, H, W, B, *search_bayes.work_counts(*a)))
        r = outs.r.numpy()
        if r.shape != (n_run, 3) or not np.isfinite(r).all():
            fail(f"trajectory not finite/shaped: {r.shape}")
        rmse = float(np.sqrt(np.mean(np.sum((r - gt_r[1:]) ** 2, axis=1))))

        # reference on a small input: the CPU plain replay of the first frames
        cpu = MonoSLAM(cfg, max_features=16, device="cpu")
        ref = cpu.run_sequence(frames[1 : N_REF + 1], enable_mapping=True)
        for k in ("n_visible", "n_selected", "n_matched", "n_active", "n_partial", "did_init",
                  "did_convert", "sel_slot", "sel_matched", "init_box", "par_alive"):
            if not torch.equal(getattr(ref, k), getattr(outs, k)[:N_REF]):
                fail(f"CUDA vs CPU plain replay: {k} differs in the first {N_REF} frames")
        dr = float((ref.xv.double() - outs.xv[:N_REF].double()).abs().max())
        if dr > STEP_TOL:
            fail(f"CUDA vs CPU plain replay: xv differs by {dr}")
        log(f"[3] CUDA run equals the CPU plain replay on frames 1..{N_REF} with mapping on "
            f"(inits at {torch.nonzero(ref.did_init).flatten().tolist()}, conversions at "
            f"{torch.nonzero(ref.did_convert).flatten().tolist()}; max |dxv| {dr:.3g})")

        # the step makes no host synchronisation: 30 mapping-on steps (four
        # inits, two conversions) with PyTorch's sync debug mode raising on
        # any synchronising call
        slam.reset()
        state = slam.state
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for t in range(N_REF):
                state, _out = slam._step(state, seq[t], True)
        except RuntimeError as e:
            fail(f"the step synchronised with the host: {e}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        log(f"[3] {N_REF} mapping-on steps ran with torch.cuda.set_sync_debug_mode('error'): "
            f"no host synchronisation in the step")

        # timed replays (state reset each time; the host waits once per run),
        # then where the device time goes: a traced replay of the same frames
        paths = {}
        for label, mapping in (("mapping-off", False), ("mapping-on", True)):
            per_frame = []
            for _ in range(3):
                slam.reset()
                torch.cuda.synchronize()
                t = time.perf_counter()
                slam.run_sequence(seq, enable_mapping=mapping)
                per_frame.append((time.perf_counter() - t) / n_run * 1e3)
            ms_frame = statistics.median(per_frame)
            prof = profile_main_path(slam, seq, n_run, mapping)
            busy = prof["device_ms"] / n_run
            paths[label] = dict(ms_frame=ms_frame, runs=per_frame, prof=prof, busy=busy)
            log(f"[3] {label}: {ms_frame:.4f} ms/frame (median of 3 runs of {n_run} frames: "
                f"{', '.join(f'{v:.4f}' for v in per_frame)})")
            if prof["device_ms"] > 0:
                n_kern = sum(cnt for _ms, cnt in prof["by_name"].values()) / n_run
                log(f"[3] {label} traced replay: device busy {busy:.4f} ms/frame of "
                    f"{ms_frame:.4f} ms/frame untraced wall -> idle share {1.0 - busy / ms_frame:.4f}; "
                    f"{n_kern:.2f} device kernels/frame; traced wall {prof['wall_ms'] / n_run:.4f} ms/frame")
                top = sorted(prof["by_name"].items(), key=lambda kv: -kv[1][0])[:14]
                for name, (ms, cnt) in top:
                    log(f"[3]   {ms / n_run * 1e3:9.3f} us/frame  x{cnt / n_run:5.2f}/frame  {name[:90]}")
            else:
                log(f"[3] {label} traced replay: the profiler recorded no device time (not measured)")
        kernel_dev = {}
        by_name = paths["mapping-on"]["prof"]["by_name"]
        for short, sym in (("K1", "k1_kernel"), ("K2", "k2_kernel"), ("K3", "k3_kernel"),
                           ("K4", "k4_kernel"), ("K5", "k5_kernel"), ("K6", "k6_kernel")):
            hits = [v for k, v in by_name.items() if sym in k]
            kernel_dev[short] = (sum(h[0] for h in hits) / max(1, sum(h[1] for h in hits))
                                 if hits else None)
        log("[3] device time per launch (mapping on): " + ", ".join(
            f"{k} {v:.5f} ms" if v is not None else f"{k} not measured" for k, v in kernel_dev.items()))
        log(f"[3] mapping-on last position {r[-1].tolist()}; RMSE vs ground truth {rmse:.6f} m")


        # ---- 3b. batch mode: 64 lanes in one step -------------------------
        from scenelib2_torch.eval.batch import check_lanes, lane_fingerprints, make_lanes
        from scenelib2_torch.parallel.mesh import make_batched_step, run_batch
        from scenelib2_torch.runtime.state import SlamState

        smc = score_map.ScoreMapConsts.from_params(p)
        sbc = search_bayes.SearchBayesConsts.from_params(p)
        nsel = p.n_features_to_select
        berrs = {k: 0.0 for k in ("K7", "K9", "K10", "K11", "K2 lanes", "K6 lanes")}

        def worse(k, v):
            berrs[k] = max(berrs[k], v)

        for _trial in range(3):
            worse("K7", check_k7(k7_random_scene(rng, p, dev), mc, nsel))
            worse("K9", check_k9(*k9_random_scene(rng, p, dev), smc))
        for at in (9, 20, 120):
            check_k10_k11_against_k4(seen[at]["search_bayes"][0], smc, sbc)
        log("[3b] K7 and K9 equal their plain versions on 3 seeded scenes each (a NaN score, an "
            "all-invisible lane, equal scores; a flat image, a flat patch, tied scores); K10's rows "
            "and K11's results given K9's map equal K4's exactly on the single-stream frames 9, 20, 120")

        t0 = time.time()
        bparams, states0, bframes = make_lanes(
            tmp, N_LANES, N_TEXTURES, N_BATCH_FRAMES, max_features=16, device=dev, dtype=torch.float32)
        bseq = torch.as_tensor(bframes).to(dev)
        T = bseq.shape[0]
        log(f"[3b] {N_LANES} lanes ({N_TEXTURES} textures x {N_LANES // N_TEXTURES} offsets) x {T} "
            f"frames rendered in {time.time() - t0:.1f} s")
        bstep = make_batched_step(bparams, device="cuda")

        # kernel inputs of whole batch steps (all lanes at once)
        bseen, cur = {}, {}

        def keep(n, a, k):
            if n == "search_bayes_maps":       # the maps live in the step's workspace
                a = (a[0].clone(),) + tuple(a[1:])
            cur[n] = (a, k)

        with observe_wrappers(keep):
            st_b = states0
            for t in range(max(BATCH_AT) + 1):
                cur.clear()
                st_b, _o = bstep(st_b, bseq[t], True)
                if t in BATCH_AT:
                    bseen[t] = dict(cur)
        torch.cuda.synchronize()
        cover = dict(making=0, converting=0, no_partial=0, fresh_ray=0)
        n_k11 = 0
        for at in BATCH_AT:
            c = bseen[at]
            worse("K7", check_k7(c["measure_predict"][0][:7], mc, nsel))
            worse("K9", check_k9(c["score_map"][0][0], c["score_map"][0][1], smc))
            worse("K10", check_k10(*c["particle_predict"][0]))
            a11 = c["search_bayes_maps"][0]
            for _label, args in k11_variations(a11, rng, p.erase_partial_after_attempts):
                worse("K11", check_k11(args))
                n_k11 += 1
            worse("K2 lanes", check_k2_lanes(c["search"][0], sc))
            worse("K6 lanes", check_k6_lanes(*c["shi_tomasi"]))
            res = search_bayes.search_bayes_maps(*a11)
            cover["making"] += int(a11[5].sum())
            cover["converting"] += int(res[4].sum())
            cover["no_partial"] += int((~a11[6]).sum())
            cover["fresh_ray"] += int((a11[5][:, 0] & (a11[7][:, 0] == 2)).sum())
        if min(cover.values()) == 0:
            fail(f"the captured batch frames do not cover every case: {cover}")
        log(f"[3b] batch kernels equal their plain versions on whole {N_LANES}-lane steps at output "
            f"indices {BATCH_AT} (lane-frames: {json.dumps(cover)}; {n_k11} K11 cases with variations; "
            f"K2 and K6 over lanes against their plain versions lane by lane) "
            f"(max abs err {json.dumps(berrs)})")

        c20 = bseen[20]
        a7, a9, a10 = c20["measure_predict"][0], c20["score_map"][0], c20["particle_predict"][0]
        a11, a2b = c20["search_bayes_maps"][0], c20["search"][0]
        a6b, kw6b = c20["shi_tomasi"]
        ws9 = torch.empty((N_LANES, 1, H, W), dtype=torch.float32, device=dev)

        btimings = {}
        for name, kern, plain in (
            ("K7", lambda: measure.measure_predict(*a7), lambda: measure.measure_predict_plain(*a7)),
            ("K9", lambda: score_map.score_map(a9[0], a9[1], smc, out=ws9),
             lambda: score_map.score_map_plain(a9[0], a9[1], smc)),
            ("K10", lambda: particle.particle_predict(*a10), lambda: particle.particle_predict_plain(*a10)),
            ("K11", lambda: search_bayes.search_bayes_maps(*a11),
             lambda: search_bayes.search_bayes_maps_plain(*a11)),
            ("K2 lanes", lambda: search.search(*a2b), lambda: search_lanes_plain(a2b, sc)),
            ("K6 lanes", lambda: shi_tomasi.shi_tomasi(*a6b, **kw6b),
             lambda: lanes_of(lambda b: shi_tomasi.shi_tomasi_plain(*(t[b] for t in a6b), **kw6b),
                              N_LANES)),
        ):
            btimings[name] = (time_ms(kern, n=50, batches=3), time_ms(plain, n=2, batches=3))
            log(f"[3b] {name}: kernel {btimings[name][0]:.4f} ms/launch for {N_LANES} lanes, plain "
                f"{btimings[name][1]:.4f} ms/call (output-index-20 inputs)")
        # the nearest library form of K9: several calls, and without the score formula
        import torch.nn.functional as F
        img9 = F.pad(a9[0].float(), (5, 5, 5, 5))
        w9 = a9[1][:, 0, : B * B].reshape(N_LANES, 1, B, B).contiguous()

        def k9_library_composition():
            cross = F.conv2d(img9[None], w9, groups=N_LANES)
            s1 = F.avg_pool2d(img9[:, None], B, stride=1)
            s2 = F.avg_pool2d((img9 * img9)[:, None], B, stride=1)
            return cross, s1, s2

        k9_comp_ms = time_ms(k9_library_composition, n=20, batches=3)
        log(f"[3b] K9's nearest library form (conv2d for the cross sum + 2 avg_pool2d box sums: "
            f"three calls, the score formula not included): {k9_comp_ms:.4f} ms")

        bcosts = {k: [] for k in ("K7", "K9", "K10", "K11", "K2", "K6")}
        k11_args, k2_args = [], []

        def record_batch_cost(n, a, k):
            if n in SINGLE_WRAPPERS and n not in ("search", "shi_tomasi"):
                raise AssertionError(f"the batch step called the single-stream wrapper {n}")
            if n == "measure_predict":
                bcosts["K7"].append(measure.bytes_and_flops(*a[6].shape))
            elif n == "score_map":
                bcosts["K9"].append(score_map.bytes_and_flops(a[1].shape[0], a[1].shape[1], a[2]))
            elif n == "particle_predict":
                bcosts["K10"].append(particle.bytes_and_flops(*a[2].shape))
            elif n == "search_bayes_maps":
                k11_args.append((a[1], a[4], a[5]))
            elif n == "search":
                k2_args.append(a[2:7])
            elif n == "shi_tomasi":
                b_, f_ = shi_tomasi.bytes_and_flops(k["boxsize"], k["region_w"], k["region_h"])
                bcosts["K6"].append((b_ * N_LANES, f_ * N_LANES))

        def run_batch_path(on_call=None):
            torch.cuda.synchronize()
            _build.reset_launches()
            with observe_wrappers(on_call) if on_call else contextlib.nullcontext():
                _st, o = run_batch(bstep, states0, bseq, True, bparams)
            return o, dict(_build.launches)

        bouts, blaunches = run_batch_path(record_batch_cost)
        fps = lane_fingerprints(bouts)
        bad = check_lanes(fps)
        if bad:
            fail(f"{len(bad)} of {N_LANES} lane fingerprints differ from the committed file:\n"
                 + "\n".join(bad[:6]))
        distinct = len({f_["decisions_sha256"] for f_ in fps})
        ends = sorted({f_["active_end"] for f_ in fps})
        log(f"[3b] all {N_LANES} per-lane fingerprints equal expected_fingerprint_batch64.json "
            f"({distinct} distinct decision histories, active_end in {ends}, "
            f"{sum(f_['inits'] for f_ in fps)} inits, {sum(f_['convs'] for f_ in fps)} conversions, "
            f"{sum(f_['matched_sum'] for f_ in fps)} matches)")
        for n in _build.KERNELS:
            want = T if n in BATCH_PATH else 0
            if blaunches.get(n, 0) != want:
                fail(f"kernel {n} launched {blaunches.get(n, 0)} times on the batch path, expected {want}")
        log(f"[3b] launches on the batch path ({T} steps of {N_LANES} lanes): {json.dumps(blaunches)}")
        rb = bouts.r.numpy()
        if rb.shape != (T, N_LANES, 3) or not np.isfinite(rb).all():
            fail(f"batch trajectories not finite/shaped: {rb.shape}")
        for pr_, al_, mk_ in k11_args:
            bcosts["K11"].append(search_bayes.bytes_and_flops_maps(
                N_LANES, 1, p.n_particles, *search_bayes.work_counts_maps(pr_, al_, mk_, sbc)))
        for u0_, v0_, uc_, vc_, sinv_ in k2_args:
            admit = search.candidate_geometry(u0_.reshape(-1), v0_.reshape(-1), uc_.reshape(-1),
                                              vc_.reshape(-1), sinv_.reshape(-1, 3), sc)[0]
            bcosts["K2"].append(search.bytes_and_flops(N_LANES * nsel, sc, int(admit.sum())))

        # reference on a small input: four lanes replayed by the CPU plain versions
        idx = list(REF_LANES)
        cpu_states = SlamState(*(t[idx].cpu() for t in states0))
        cpu_step = make_batched_step(bparams, device="cpu")
        _s, bref = run_batch(cpu_step, cpu_states, bframes[:N_REF_BATCH, idx], True, bparams)
        for k in ("n_visible", "n_selected", "n_matched", "n_active", "n_partial", "did_init",
                  "did_convert", "n_overflow", "sel_matched", "init_box", "par_alive"):
            if not torch.equal(getattr(bref, k), getattr(bouts, k)[:N_REF_BATCH, idx]):
                fail(f"batch CUDA vs CPU plain replay: {k} differs in lanes {idx}")
        dxb = float((bref.xv.double() - bouts.xv[:N_REF_BATCH, idx].double()).abs().max())
        if dxb > STEP_TOL:
            fail(f"batch CUDA vs CPU plain replay: xv differs by {dxb}")
        log(f"[3b] lanes {idx} of the CUDA batch run equal their CPU plain replay on frames "
            f"1..{N_REF_BATCH} (max |dxv| {dxb:.3g})")

        st_b = states0
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for t in range(N_REF):
                st_b, _o = bstep(st_b, bseq[t], True)
        except RuntimeError as e:
            fail(f"the batch step synchronised with the host: {e}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        log(f"[3b] {N_REF} batch steps ran with torch.cuda.set_sync_debug_mode('error'): "
            f"no host synchronisation in the batch step")

        walls = []
        torch.cuda.reset_peak_memory_stats()
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            run_batch(bstep, states0, bseq, True, bparams)
            walls.append(time.perf_counter() - t)
        peak_mb = torch.cuda.max_memory_allocated() / 2**20
        wall = statistics.median(walls)
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run_batch(bstep, states0, bseq, True, bparams)
            torch.cuda.synchronize()
        bby = {}
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            bby[e.key] = (us / 1e3, e.count)
        bbusy = sum(v[0] for v in bby.values()) / T
        bn_kern = sum(v[1] for v in bby.values()) / T
        batch = dict(
            lanes=N_LANES, frames_per_lane=T, wall_s=wall, runs_s=walls,
            frames_per_s=N_LANES * T / wall, ms_per_step=wall / T * 1e3,
            device_ms_per_step=bbusy if bbusy > 0 else None,
            idle_share=(1.0 - bbusy / (wall / T * 1e3)) if bbusy > 0 else None,
            device_kernels_per_step=bn_kern, peak_device_mb=peak_mb,
            single_stream_frames_per_s=1e3 / paths["mapping-on"]["ms_frame"],
        )
        batch["vs_64x_single_stream"] = batch["frames_per_s"] / (N_LANES * batch["single_stream_frames_per_s"])
        log(f"[3b] batch replay: {batch['frames_per_s']:.1f} aggregate frames/s "
            f"({N_LANES} lanes x {T} frames in {wall:.4f} s, median of 3 runs: "
            f"{', '.join(f'{v:.4f}' for v in walls)}); {batch['ms_per_step']:.4f} ms a batch step; "
            f"single stream with mapping on {batch['single_stream_frames_per_s']:.1f} frames/s, so the "
            f"batch runs at {batch['vs_64x_single_stream']:.4f} of {N_LANES} x that; "
            f"peak device memory {peak_mb:.1f} MiB")
        if bbusy > 0:
            log(f"[3b] batch traced replay: device busy {bbusy:.4f} ms a step -> idle share "
                f"{batch['idle_share']:.4f}; {bn_kern:.2f} device kernels a step")
            for name, (ms, cnt) in sorted(bby.items(), key=lambda kv: -kv[1][0])[:16]:
                log(f"[3b]   {ms / T * 1e3:9.3f} us/step  x{cnt / T:6.2f}/step  {name[:90]}")
        else:
            log("[3b] batch traced replay: the profiler recorded no device time (not measured)")
        bkernel_dev = {}
        for short, sym in (("K7", "k7_kernel"), ("K9", "k9_kernel"), ("K10", "k10_kernel"),
                           ("K11", "k11_kernel"), ("K2", "k2_kernel"), ("K6", "k6_kernel")):
            hits = [v for k, v in bby.items() if sym in k]
            bkernel_dev[short] = (sum(h[0] for h in hits) / max(1, sum(h[1] for h in hits))
                                  if hits else None)
        log("[3b] device time per launch (batch): " + ", ".join(
            f"{k} {v:.5f} ms" if v is not None else f"{k} not measured" for k, v in bkernel_dev.items()))

        # ---- 3c / 3d. large maps: hires (fused, D = 373), mf100 (split, D = 613)
        large = {name: large_map_phase(tag, name, tmp, dev, rng)
                 for tag, name in (("3c", "hires"), ("3d", "mf100"))}
        large["mf100"]["errs"]["K14"] = max(large["mf100"]["errs"]["K14"], k14_err)

    # ---- 4. kernel records ------------------------------------------------
    costs["K2"] = [search.bytes_and_flops(K, sc, int(admit.sum())) for admit, K in costs["K2"]]
    recs = []
    for short, name, src, rep, key in (
        ("K1", "K1 predict_measure", "predict_measure.cu", "pallas_predict_measure.py:375", "predict_measure"),
        ("K2", "K2 search", "search.cu", "pallas_search.py:476", "search"),
        ("K3", "K3 ekf_update", "ekf_update.cu", "pallas_ekf.py:446", "ekf_update"),
        ("K4", "K4 search_bayes", "search_bayes.cu", "pallas_search_bayes.py:638", "search_bayes"),
        ("K5", "K5 propose", "propose.cu", "pallas_propose.py:306", "propose"),
        ("K6", "K6 shi_tomasi", "shi_tomasi.cu", "pallas_shi_tomasi.py:211", "shi_tomasi"),
    ):
        b_ms, b_by = bound(costs[short])
        recs.append(dict(
            name=name, route="cuda", source=f"scenelib2_torch/kernels/csrc/{src}",
            replaces=f"scenelib2_tpu/kernels/{rep}", launches=launches[key],
            max_abs_err=errs[short], ms=timings[short][0], plain_ms=timings[short][1],
            bound_ms=b_ms, bound_by=b_by, library_ms=None, device_ms=kernel_dev[short],
        ))
    # K2 and K6 also run on the batch path, one launch for all lanes
    for rec, short in ((recs[1], "K2"), (recs[5], "K6")):
        b_ms, b_by = bound(bcosts[short])
        rec.update(launches_batch=blaunches[rec["source"].rsplit("/", 1)[1][:-3]],
                   ms_batch=btimings[f"{short} lanes"][0], plain_ms_batch=btimings[f"{short} lanes"][1],
                   bound_ms_batch=b_ms, bound_by_batch=b_by, device_ms_batch=bkernel_dev[short],
                   max_abs_err_batch=berrs[f"{short} lanes"])
    for short, name, src, rep_, key in (
        ("K7", "K7 measure", "measure.cu", "pallas_measure.py:310", "measure"),
        ("K9", "K9 score_map", "score_map.cu", "pallas_score_map.py:258 and :300", "score_map"),
        ("K10", "K10 particle_predict", "particle_predict.cu", "pallas_particle.py:434", "particle_predict"),
        ("K11", "K11 search_bayes_maps", "search_bayes.cu", "pallas_search_bayes.py:638", "search_bayes_maps"),
    ):
        b_ms, b_by = bound(bcosts[short])
        recs.append(dict(
            name=name, route="cuda", source=f"scenelib2_torch/kernels/csrc/{src}",
            replaces=f"scenelib2_tpu/kernels/{rep_}", launches=blaunches[key],
            max_abs_err=berrs[short], ms=btimings[short][0], plain_ms=btimings[short][1],
            bound_ms=b_ms, bound_by=b_by, library_ms=None, device_ms=bkernel_dev[short],
        ))
    recs[-3]["library_composition_ms"] = k9_comp_ms
    # the large-map paths: K14 (split route) and the kernels at the hires shapes
    for short, name, label, src, rep_ in (
        ("K14", "mf100", "K14 chol_inv", "chol_inv.cu (+ chol_linv.cuh)", "pallas_linalg.py:83"),
        ("K1", "hires", "K1 predict_measure (hires, D=373)", "predict_measure.cu",
         "pallas_predict_measure.py:375"),
        ("K2", "hires", "K2 search (hires, 107 x 107 windows)", "search.cu", "pallas_search.py:476"),
        ("K3", "hires", "K3 ekf_update (hires, D=373)", "ekf_update.cu", "pallas_ekf.py:446"),
        ("K4", "hires", "K4 search_bayes (hires, 200 particles)", "search_bayes.cu",
         "pallas_search_bayes.py:638"),
    ):
        t_ = large[name]["timings"][short]
        recs.append(dict(
            name=label, route="cuda", source=f"scenelib2_torch/kernels/csrc/{src}",
            replaces=f"scenelib2_tpu/kernels/{rep_}", launches=t_["launches"],
            max_abs_err=t_["max_abs_err"], ms=t_["ms"], plain_ms=t_["plain_ms"], bound_ms=t_["bound_ms"],
            bound_by=t_["bound_by"], library_ms=t_["library_ms"], device_ms=t_["device_ms"], path=name,
        ))
    recs[6]["launches_mf100"] = large["mf100"]["launches"]["measure"]
    log(f"[4] empty-launch floor {empty_ms:.4f} ms; total {time.time() - t_start:.1f} s")
    print(smi, flush=True)
    on, off = paths["mapping-on"], paths["mapping-off"]
    print(json.dumps({"ms_per_frame": on["ms_frame"], "device_ms_per_frame": on["busy"],
                      "ms_per_frame_nomap": off["ms_frame"], "device_ms_per_frame_nomap": off["busy"],
                      "empty_launch_ms": empty_ms, "card": smi}))
    print(json.dumps({"batch64": batch, "card": smi}))
    print(json.dumps({"large_maps": {
        name: {k: v for k, v in r_.items() if k in ("ms_frame", "runs", "ms_frame_window", "traced_frames",
                                                   "busy", "idle_share", "peak_mb", "kernels_per_frame",
                                                   "fingerprint", "launches")}
        for name, r_ in large.items()}, "card": smi}))
    print(json.dumps({"kernels": recs}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
