"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed):

 1. device and build: the card's name and power limit; every kernel of
    scenelib2_torch/kernels/csrc built with nvcc (one process per source,
    all at once; timed).
 2. kernel vs plain: each kernel (K1 predict+measure+select, K2 search,
    K3 update+bookkeeping, K4 particle search+Bayes, K5 init region
    proposal with the step's speed gate and the region's clamp, K6
    Shi-Tomasi pick; K14 L^-1 on seeded matrices, bit for
    bit: SPD at M = 1..128, stacks of 3 and 64, a negative pivot, an
    infinite entry) and its
    plain PyTorch version on the same
    CUDA tensors: on seeded random scenes and variations (no attempt, no
    room, every try clashing, a flat region, built ties, making false, an
    empty union box, overflowing particles, a sell-by kill) and on the
    inputs of real frames of the synthetic sequence with mapping on (output
    index 9: the first init; 20: the first conversion; 120; K5 there also
    at 17 and 40 tries, past the 16 it once held): decisions and integers
    exactly equal, floats bit for bit or at max abs error 0 (K2 and K8:
    best identical bit for bit); K2 and K8 also on seeded edge cases at 320x240
    and 640x480 (search_edge_scene: an ellipse beyond the window, a 3 x 3
    box, NaN, infinite and huge half-widths, centres on and past each
    border and at +-3e9, a tie of perfect matches, perfect matches, an
    unselected NaN centre; K = 1, 10 and 64 x 10 / 16 x 10 lanes); then
    each kernel's and plain version's time.
 2c. past the caps the kernels once had: K2 (one frame and over lanes) and
    K8 at search radii 104, 110 and 160 at 320x240 (160: the whole frame)
    and 320 at 640x480 (a CTA's rows past the device's shared memory:
    staged in passes), and K6 (one frame and over lanes) on regions 100 x
    60, 200 x 150 and the whole frame (308 x 228, 628 x 468), each with the
    stage the launcher sizes and with one row a pass: bit for bit; the widest
    cases timed.
 2b. the particle kernels past 128 particles and the three kernels that no
    route runs: K10, K11 (making and not), K12 in both row forms and K4 with
    its variations at NP = 200, 300, 1,100, 5,120 and 16,384 (rows of 256,
    512 and 1,152 lanes held in shared memory, and two rows past its 4,096
    particles, on the kernels' workspace path) on seeded slots; K10b (NP 100, 200, 1,100, 5,120 and
    16,384 on 1 to 128 CTAs a slot, degenerate depths), K15
    (D = 109 and 128, M up to 128, any_succ false, a NaN in a deleted slot,
    D = 7, 13, 109 and 128 at M = 1, 2, 20, 32, 33, 64 and 128: both forms,
    the register and the block factorisation; NaN, inf and -inf in a kept
    and in a deleted row, in the same tile as their mirror and in another,
    on the diagonal, any_succ true and false: the transposition rule's
    pass; and frame 120's inputs) and K16 (degenerate particles, dead ones,
    a tie, a NaN score; search radii 16, 32, 110 and 115, the widest window
    it takes at 320x240, with ellipses wider than the window; 16 maps of
    640x480 x 200 particles; a cloud spread over the whole map, whose read
    box exceeds the stage: the in-place path) on seeded cases: each at max
    abs error 0 against its plain version; K15 on the JAX XLA branch's H,
    nu, R of frame 120 against K3 (bit for bit); K10b in 3b on K10's prologue geometry of captured batch steps
    (K10's rows bit for bit), K16 in 3e on the maps and clouds of K13's
    captured calls (K13's decisions for every live particle); each one's
    kernel, device and plain times; K12 re-timed at 200 particles.
 3. main paths: the 240-frame seed-7 synthetic sequence through
    MonoSLAM(device="cuda"), with mapping off and then on: the eager loop
    (MonoSLAM._run_sequence_eager) reproducing its committed decisions
    fingerprint, with every kernel of the path launched once per frame (K5
    and K6 run only with mapping on; the counts are zeroed just before each
    run and read just after it); then run_sequence, which replays CUDA
    graphs on the card (runtime/replay.py: a graph of 8 steps replayed once
    for each full block of 8 frames, a one-step graph for the rest), as
    every replay phase below does (3b-3f: run_batch) through graph_cell:
    the first graph run reproduces the fingerprint, its packed outputs and
    final state equal the eager loop's bit for bit, its captures launched
    each kernel of the path once a captured step (the counters count
    captures and each graph's warm-up step, not replays: 8 + 1 + 2 each in
    that run), chunk=10 (full chunks and a remainder of one-step replays)
    equals chunk=0 bit for bit, a traced graph run launched each kernel of
    the path exactly once a step and no other kernel (these are the
    launches of the kernel records), and the eager loop (once), the first
    graph call (captures included) and the graph (median of 3) are timed
    beside the graphs' capture + instantiate seconds, the device span of a
    replay (CUDA events), the traced run's device busy and the idle share of
    each, and peak device memory with the graphs' shared pool. The first
    mapping-on frames agree
    with the CPU plain replay; 30 frames at search radius 110 and init
    region 100, through a graph, equal the port's CPU run of the same
    frames decision by decision; 30 eager steps run with PyTorch's sync
    debug mode raising on any host synchronisation (graph captures and
    replays always run so); a step that synchronises cannot be captured
    (the capture raises).
 3b. batch mode: 64 independent lanes (32 scene textures x 2 phase offsets)
    x 63 frames through parallel.mesh.make_batched_step / run_batch. Phase 2
    of the batch kernels runs here, on inputs captured from this replay (K7's
    selection, selected rows and every slot's chain rows bit for bit, also
    on seeded lanes at 16 x 60, 1 x 100 and 3 x 100 slots; K9 score maps,
    K10 particle rows, K11 search + Bayes on
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
    update). Each: its committed fingerprint through the graph replay, with
    every kernel of its path launched once a frame and none other, the
    eager loop up to the last captured frame (held to the replay's rows),
    the path's kernels against their plain versions on inputs captured at a
    few frames of that eager loop (K14
    also on seeded SPD matrices in phase 2; K2 with 107 x 107 windows and
    K4 with 200 particles at hires), the CPU plain replay of its first 20
    frames, 30 steps under sync debug mode "error", ms/frame, a traced
    window's device busy and idle share, peak device memory.
 3e. the two alternative batch routes of the JAX step, on the 64 lanes of
    3b: batch_pallas=False (K8 on gathered windows and K12 on 13 rows, the
    rest as tensor ops) and SCENELIB2_BATCH_SB=0 (K7, K2, K6, K9, K10, then
    K13 and K12 on K10's rows in place of K11). K8, K12 in both forms and
    K13 against their plain versions on seeded cases (ties, an overflowing
    ellipse, an all-zero likelihood, a sell-by, degenerate S, empty regions;
    K13 also the in-kernel geometry's edges and windows that are the whole
    map) and on captured steps (K13 on every step of the sb0 replay); each
    route's replay reproduces all 64 per-lane
    fingerprints of its committed file with its kernels launched once a
    step and no other; two lanes agree with their CPU plain replay; 30
    steps without a host synchronisation; aggregate frames/s, an 8-step
    traced window, the replay's peak device memory, each kernel's times.
 3f. batch-hires: the default batch route at BASELINE config 3 (640x480,
    max_features 60, 200 particles: K10's and K11's rows 256 lanes wide),
    16 lanes (8 hires textures x 2 offsets) x 39 frames: the route's kernels
    against their plain versions on two captured steps, all 16 per-lane
    fingerprints of expected_fingerprint_batch_hires.json with each kernel
    of the route launched once a step and no other, two lanes against
    their CPU plain replay, 30 steps under sync debug mode "error", ms a
    step, aggregate frames/s, an 8-step traced window, peak device memory,
    K10's and K11's times at 200 particles and K2's over the 16 lanes.
    Every replay phase (3, 3b-3f) requires zero launches of K10b, K15 and
    K16: no route reaches them.
 3g. the entry points users start the system through: (a) go_one_step
    through its one-step CUDA graph over the 239 frames with mapping on,
    one call a frame: expected_fingerprint.json, every packed row and the
    final state bit for bit with _go_one_step_eager and with phase 3's
    eager replay, one graph captured (each kernel of the path counted twice:
    the capture and its warm-up step); 10 calls alternating mapping off and
    on (one graph a mapping value, bit for bit with the eager step), then
    run_sequence beside them within MAX_GRAPHS; median ms a call through
    the graph and eagerly (host wall with the frame upload and the
    trajectory fetch) on std-mapping and 40 frames of mf100; (b) a facade
    script (steps, initialise_feature, initialise_auto_feature,
    delete_feature of a marked label, add_new_known_feature,
    save_checkpoint, load_checkpoint, reset) through the graph bit for bit
    with the eager step and against the CPU port (decisions and bookkeeping
    identical, x and P within STEP_TOL); initialise_auto_feature launches K5
    and K6 once each, and both equal their plain versions on its inputs;
    (c) `python -m scenelib2_torch.cli selftest` exits 0, and 1 on a copy
    of the expected file with matched_sum + 1; (d) `cli run --mapping
    --checkpoint` on a PGM directory of the frames, read by the native
    grabber built by make: its decisions equal (a)'s and its checkpoint
    (a)'s final state, and `cli print-state` reads it (c and d run side by
    side); (e) `cli bench testseq autoinit hires hires_r48 batch64`: each
    JSON line printed, each cell's timed replay reproducing its committed
    fingerprint (hires: JAX's bench_hires configuration, radii 32 / 32,
    against expected_fingerprint_hires_bench.json; hires_r48: radii 48 / 52
    against expected_fingerprint_hires.json; batch64 reads the lanes phase
    3b rendered).
 3h. JAX's pure-XLA route in f32 (use_pallas=False; xla_route_phase): the
    std-mapping sequence through MonoSLAM(cfg, max_features=16,
    use_pallas=False) by run_sequence's graph replay, reproducing
    expected_fingerprint_xla.json, and over its first EAGER_PREFIX frames by
    the eager loop and by go_one_step one call a frame, rows and state bit
    for bit across the three, K14 launched exactly once a frame (counted in
    the eager loop and from traces of the graph replay and of go_one_step)
    and no other kernel, K14 bit for bit with its plain version on every S
    of the eager loop, the CPU plain replay of the first frames, sync debug mode
    "error"; then the batch route "xla" on the 64 lanes of 3b, every lane's
    fingerprint equal to its committed file with no kernel launched, through
    the eager loop and graph_cell; ms a frame eager and graph, busy, kernels
    a step, idle shares and peak memory beside the card's line (an
    `xla_route` JSON line).
 3i. JAX's f64 parity mode (precision="f64"; f64_phase): (a) the parity
    route, MonoSLAM(cfg, max_features=16, precision="f64",
    use_pallas=False), and (b) JAX's hybrid route, use_pallas=True (K2 in
    an f64 step), each by run_sequence's graph replay
    (expected_fingerprint_f64.json / _f64_k2.json) and over its first
    frames by the eager loop (EAGER_PREFIX; the hybrid route's up to the
    last frame of F64_AT) and go_one_step (EAGER_PREFIX), rows and state
    bit for bit across the three, no kernel at all on the
    parity route and K2 alone once a frame on the hybrid one (eager counts
    and traces), K2 bit for bit with its plain version on three captured
    frames, the CPU f64 replay of the first frames (decisions equal, r and
    xv within F64_TOL), sync debug mode "error"; (c) the batch parity route
    "xla-f64" on 3b's lanes made in f64, every lane equal to
    expected_fingerprint_batch64_f64.json through the eager loop and
    graph_cell with no kernel, then the hybrid batch routes "k2-f64" and
    "k8-f64" (batch_pallas=False) over the 64 lanes: their kernel once a
    step and no other, K2 / K8 bit for bit with their plain versions on a
    captured step, two lanes against their CPU f64 replay; (d)
    eval.metrics.run_parity_eval on the card (decision agreement 1.0,
    drand48 in lockstep, RMSE against the oracle <= 1e-3); an `f64` JSON
    line.
 3j. two partial features at a time (max_features_to_init_at_once = 2;
    maxp_phase): (a) std-maxp2, autoinit-maxp2 (max_features 24) and
    mf100-maxp2 (the split route) by run_sequence's graph replay, which
    reproduces expected_fingerprint_maxp2{,_autoinit,_mf100}.json, and over
    its first EAGER_PREFIX frames by the eager loop and go_one_step one call
    a frame, rows and state bit for bit across the three, the path's kernels (K9, K10 and K11
    on both partial slots, never K4) once a frame in the eager loop and in
    the traces; K9, K10 and K11 bit for bit with their plain versions on two
    frames that search both slots and one that searches none; the CPU
    plain replay of the first frames; sync debug mode "error"; (b) the
    single stream's "xla", "xla-f64" and "k2-f64" routes at MAXP 2 against
    their files through the graph replay, its first 12 frames bit for bit
    with the eager loop and the CPU replay (f64: r and xv within F64_TOL);
    (c)
    the 64 lanes at MAXP 2 on "default", "sb0", "bp0", "xla" and
    "xla-f64" through the eager loop (16 steps) and graph_cell: lanes 0-15 equal
    expected_fingerprint_batch16_maxp2.json, every route's 64 lanes equal
    the default route's, each route's kernels once a step, K9-K11 and K12,
    K13 bit for bit with their plain versions on a captured step; a
    `maxp2` JSON line.
 3k. the large-map EKF frame (ekf_frames_phase): each of the five EKF
    benches' frames (stress500 f64 / packed / f32 at 500 features, ekf100
    f64 / f32) from _make_map_state: 3 eager frames on the card under sync
    debug mode "error" against the CPU frame (top_idx equal, x and P within
    the JAX package's f64 bars, f32 within 1e-5 / 1e-4 of the largest
    entry), the one-frame graph's replays bit for bit with them, the bench's
    ms/step through the graph, busy and device kernels a frame from a trace,
    peak memory, no counted kernel launched (K1-K16: none on this path); on
    a one-rank NCCL process group, the sharded stress frame on a (1, 1)
    mesh at D = 3013 against the unsharded frame (3 frames, top_idx equal,
    P rtol 1e-7) and through its graph, sharded_predict, _joint_update and
    _slam_frame at D = 3013 against core.ekf's compositions, and run_batch
    over a (1,) lane mesh equal to run_batch bit for bit; an `ekf_frames`
    JSON line.
 4. a `graph_replay` JSON line (every cell: eager and graph ms a frame or
    step, span, busy, idle shares, peak memory, capture seconds), an
    `entry_points` JSON line (phase 3g's ms a call and frames/s), a
    `kernels` JSON line (launches: the mapping-on graph run's counts, a
    warm-up step and the capture), a `summary` JSON line under 4 KB (every
    phase's fingerprint verdict and headline times, so that the 24 KB tail
    a chip call returns always holds the result), then the last line
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.

Imports nothing of JAX; needs the repository beside it (the kernels are
built from its sources).
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import json
import os
import re
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

N_LANES, N_TEXTURES, N_BATCH_FRAMES = 64, 32, 64    # the batch replay: 63 frames a lane
BATCH_AT = (9, 20, 40)     # output indices whose kernel inputs are captured
BATCH_TRACED_STEPS = 8     # batch64's traced graph window (~2,800 device kernels a step)
STD_TRACED_STEPS = 16      # std-nomap's and std-mapping's traced graph windows
N_REF_BATCH, REF_LANES = 10, (0, 1, 32, 33)
STEP_TOL = 1e-4   # CUDA vs CPU plain replay: r, xv
N_REF = 30        # CPU plain replay frames (4 inits, 2 conversions)
K5_TIMED_TRIES = 40
# K5 past the 16 tries it once held (the default is 5); at 100 tries every
# try clashing consumes 200 draws, past the 128 the kernel stages
K5_MORE_TRIES = (17, K5_TIMED_TRIES, 100)


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


def on_cpu(args) -> tuple:
    """args with every tensor copied to the CPU: the bound's data-dependent
    work counts (search_bayes.work_counts, work_counts_maps) take thousands
    of tiny ops a step, each a launch and a wait on the card."""
    return tuple(t.cpu() if isinstance(t, torch.Tensor) else t for t in args)


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


def k1_random_scene(rng, params, dev, nan_lane=False, partial=0.1):
    """K1's arguments for a seeded map of params.max_features slots: about
    `partial` of the active slots partial (0: none, 1: all)."""
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
    full = rng.uniform(size=MF) >= partial
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


# K2 / K8 edge cases (search_edge_scene): feature j of a lane is of kind
# SEARCH_KINDS[j % 10]
SEARCH_KINDS = ("random", "overflow", "box3", "nan_half", "inf_half", "huge_half", "border", "far", "tie",
                "perfect")


def search_edge_scene(rng, c, dev, n_lanes: int, K: int, kinds=SEARCH_KINDS):
    """K2 and K8 arguments over n_lanes random u8 frames of the shapes of c
    (search.SearchConsts), K features a lane,
    feature j of kind kinds[j % len(kinds)]:
      random: S^-1 of deviations 1-10.7 px (half-heights 3-32), any tilt;
      overflow: deviations 40 and 35 px, an ellipse beyond the window;
      box3: deviations 0.5 px, a 3 x 3 box;
      nan_half: a - b^2 / c < 0, a NaN half-width (nothing admitted);
      inf_half: a - b^2 / c = 0 = c - b^2 / a exactly, infinite half-widths
        (the whole window; a strip of it inside the degenerate ellipse);
      huge_half: half-widths near 9.5e6, above 2^22 (the whole window);
      border: a centre on or past a border of the frame (cycling);
      far: a centre at +-3e9 (K8 saturates it) with infinite half-widths;
      tie: a random patch planted at two cells of the window (a tie of
        perfect matches: the larger u*H + v wins);
      perfect: the patch cut at the centre (best a rounding residue near 0);
        in every third lane unselected, with a NaN centre.
    Returns (K2 arguments over lanes: frame [n_lanes, H, W], the rest
    [n_lanes, K, ...]; K8 arguments [n_lanes, K, ...])."""
    from scenelib2_torch.kernels.correlate import gather_windows_u8
    from scenelib2_torch.kernels.search import search_window_origin
    from scenelib2_torch.runtime.state import patch_row

    H, W, B, R = c.H, c.W, c.boxsize, c.win_radius
    half = (B - 1) // 2
    frames = rng.integers(0, 256, (n_lanes, H, W), dtype=np.uint8)
    patches = np.zeros((n_lanes, K, B, B), np.uint8)
    h = np.zeros((n_lanes, K, 2))
    abc = np.zeros((n_lanes, K, 3))
    active = np.ones((n_lanes, K), bool)
    borders = ((2.3, None), (W - 1.7, None), (None, 1.2), (None, H - 1.4), (-40.0, None), (None, H + 60.0))

    def sinv(su, sv, rho):
        return np.linalg.inv(np.array([[su * su, rho * su * sv], [rho * su * sv, sv * sv]]))[[0, 0, 1], [0, 1, 1]]

    for b in range(n_lanes):
        for j in range(K):
            kind = kinds[j % len(kinds)]
            u, v = rng.uniform(60, W - 60), rng.uniform(60, H - 60)
            s = sinv(*rng.uniform(1.0, 32 / 3, 2), rng.uniform(-0.6, 0.6))
            cu = int(np.clip(round(u) + rng.integers(-4, 5), half, W - 1 - half))
            cv = int(np.clip(round(v) + rng.integers(-4, 5), half, H - 1 - half))
            patch = frames[b, cv - half : cv + half + 1, cu - half : cu + half + 1].copy()
            if kind == "overflow":
                s = sinv(40.0, 35.0, 0.3)
            elif kind == "box3":
                s = sinv(0.5, 0.5, 0.0)
            elif kind == "nan_half":
                s = [0.01, 0.1, 0.01]
            elif kind in ("inf_half", "far"):
                s = [1.0, 0.5, 0.25]
            elif kind == "huge_half":
                s = [1e-13, 0.0, 1e-13]
            elif kind == "border":
                bu, bv = borders[(b * K + j) % len(borders)]
                u, v = (bu if bu is not None else u), (bv if bv is not None else v)
            elif kind == "tie":
                s = sinv(5.0, 5.0, 0.0)
                patch = rng.integers(0, 256, (B, B), dtype=np.uint8)
                iu, iv = int(np.floor(u + 0.5)), int(np.floor(v + 0.5))
                for du, dv in ((-6, -2), (5, 4)):
                    frames[b, iv + dv - half : iv + dv + half + 1, iu + du - half : iu + du + half + 1] = patch
            elif kind == "perfect":
                iu, iv = int(np.floor(u + 0.5)), int(np.floor(v + 0.5))
                patch = frames[b, iv - half : iv + half + 1, iu - half : iu + half + 1].copy()
                if b % 3 == 2:
                    u = v = float("nan")
                    active[b, j] = False
            if kind == "far":
                u, v = (3e9, -3e9) if b % 2 == 0 else (-3e9, 3e9)
            patches[b, j] = patch
            h[b, j] = (u, v)
            abc[b, j] = s
    f32 = dict(dtype=torch.float32, device=dev)
    frames_t = torch.tensor(frames, device=dev)
    patches_t = torch.tensor(patches, device=dev)
    h_t = torch.tensor(h, **f32)
    abc_t = torch.tensor(abc, **f32)
    active_t = torch.tensor(active, device=dev)
    u0, v0, uc, vc = search_window_origin(h_t, R, W, H, B)
    k2 = (frames_t, patch_row(patches_t), u0, v0, uc, vc, abc_t, active_t)
    k8 = (gather_windows_u8(frames_t, u0, v0, R, B), patches_t, u0, v0, h_t, abc_t, active_t)
    return k2, k8


def check_search_edges(rng, p, dev, n_lanes: int) -> tuple[int, float]:
    """K2 (one frame and over lanes) and K8 on search_edge_scene: each kind
    alone at K = 1, the ten kinds at K = 10 on one frame, and over n_lanes
    lanes x 10; every output bit for bit. Returns (cases, max abs error)."""
    from scenelib2_torch.kernels.search import SearchConsts

    sc = SearchConsts.from_params(p)
    err, n = 0.0, 0
    K = p.n_features_to_select
    cases = [search_edge_scene(rng, sc, dev, 1, 1, (kind,)) for kind in SEARCH_KINDS]
    cases.append(search_edge_scene(rng, sc, dev, 1, K))
    for k2, k8 in cases:
        err = max(err, check_k2(tuple(t[0] for t in k2), sc), check_k8(k8, sc))
        n += 2
    k2, k8 = search_edge_scene(rng, sc, dev, n_lanes, K)
    err = max(err, check_k2_lanes(k2, sc), check_k8(k8, sc))
    return n + 2, err


# K2 / K8 past the old 103 px radius cap, and K6 past the old 88 x 68 region
# cap (phase 2c): (frame height, width, search radius) and (region width,
# height); 10**4 is the whole frame after the clamp
WIDE_RADII = ((240, 320, 104), (240, 320, 110), (240, 320, 160), (480, 640, 320))
WIDE_REGIONS = ((100, 60), (200, 150), (10**4, 10**4))


def check_wide_windows(rng, p, dev) -> tuple[dict, dict]:
    """Phase 2c: K2 (one frame, K = 1 of each edge kind and K = 10; over
    lanes) and K8 (over lanes) at the radii of WIDE_RADII on
    search_edge_scene, and K6 (one frame and over lanes) on regions of
    WIDE_REGIONS at 320x240 and 640x480: each bit for bit with its plain
    version, with the stage the launcher sizes (one pass, above 48 KB opted
    in; passes where a CTA's rows exceed the device: R = 320 at 640x480 on
    one CTA a feature) and with the stage forced to one centre row (K2, K8)
    or one row of cells (K6) a pass. Returns (max abs errors, {label:
    timing record}) with the times of the widest cases."""
    from scenelib2_torch.kernels import search, shi_tomasi

    errs = {"K2": 0.0, "K8": 0.0, "K6": 0.0}
    n = {"K2": 0, "K8": 0, "K6": 0}
    timed = {}
    for H, W, R in WIDE_RADII:
        q = dataclasses.replace(p, cam_height=H, cam_width=W, search_win_radius=R)
        sc = search.SearchConsts.from_params(q)
        n_lanes = N_LANES if W == 320 else N_HIRES_LANES
        K = p.n_features_to_select
        cases = [search_edge_scene(rng, sc, dev, 1, 1, (kind,)) for kind in SEARCH_KINDS]
        cases.append(search_edge_scene(rng, sc, dev, 1, K))
        cases.append(search_edge_scene(rng, sc, dev, n_lanes, K))
        for k2, k8 in cases:
            lanes = k2[0].shape[0]
            flat2 = tuple(t.reshape(-1, *t.shape[2:]) for t in k2[1:])
            frame = k2[0] if lanes > 1 else k2[0][0]
            flat8 = tuple(t.reshape(-1, *t.shape[2:]) for t in k8)
            want2 = tuple(o.reshape(-1) for o in search_lanes_plain(k2, sc))
            want8 = search.search_windows_plain(*flat8, sc)
            for rows in (0, 1):   # the launcher's own stage; passes of one centre row
                got2 = search._launch(frame, *flat2, sc, lanes, rows)
                got8 = search._launch_k8(*flat8, sc, rows)
                torch.cuda.synchronize()
                errs["K2"] = max(errs["K2"], check_search(got2, want2, f"K2 at R = {R} ({W}x{H}, pass rows {rows})"))
                errs["K8"] = max(errs["K8"], check_search(got8, want8, f"K8 at R = {R} ({W}x{H}, pass rows {rows})"))
                n["K2"] += 1
                n["K8"] += 1
        # the widest case of each kernel timed: K2 on one frame (a cluster of 8 a
        # feature: one pass) and over lanes, K8 over lanes (one CTA a feature)
        if R in (110, 320):
            k2, k8 = cases[-1]
            k2_1 = tuple(t[0] for t in k2)
            admit1 = search.candidate_geometry(*k2_1[2:7], sc)[0]
            flat2 = tuple(t.reshape(-1, *t.shape[2:]) for t in k2[1:])
            admit = search.candidate_geometry(*flat2[1:6], sc)[0]
            flat8 = tuple(t.reshape(-1, *t.shape[2:]) for t in k8)
            for label, fk, fp_, sym, cost in (
                (f"K2 R={R} one frame", lambda: search.search(*k2_1, sc), lambda: search.search_plain(*k2_1, sc),
                 "k2_kernel", search.bytes_and_flops(K, sc, admit1)),
                (f"K2 R={R} {n_lanes} lanes", lambda: search.search(*k2, sc), lambda: search_lanes_plain(k2, sc),
                 "k2_kernel", search.bytes_and_flops(K * n_lanes, sc, admit)),
                (f"K8 R={R} {n_lanes} lanes", lambda: search.search_windows(*k8, sc),
                 lambda: search.search_windows_plain(*flat8, sc), "k8_kernel",
                 search.bytes_and_flops_windows(K * n_lanes, sc, admit)),
            ):
                b_ms, b_by = bound([cost])
                timed[label] = dict(ms=time_ms(fk, n=20, batches=3), plain_ms=time_ms(fp_, n=2, batches=3),
                                    device_ms=kernel_device_ms(fk, sym), bound_ms=b_ms, bound_by=b_by,
                                    inputs=f"search_edge_scene at {W}x{H}, R = {R}, side {sc.side_u} x {sc.side_v}")
    i32 = dict(dtype=torch.int32, device=dev)
    B = p.boxsize
    for H, W in ((240, 320), (480, 640)):
        n_lanes = N_LANES if W == 320 else N_HIRES_LANES
        frame = torch.tensor(rng.integers(0, 256, (H, W), dtype=np.uint8), device=dev)
        frames = torch.tensor(rng.integers(0, 256, (n_lanes, H, W), dtype=np.uint8), device=dev)
        for rw_, rh_ in WIDE_REGIONS:
            kw = dict(boxsize=B, region_w=rw_, region_h=rh_)
            singles = []
            for u, v in ((6, 6), (W // 3, H // 4), (W - 30, H - 30)):
                singles.append(tuple(torch.tensor(x, **i32) for x in (u, v, min(u + rw_, W - 6), min(v + rh_, H - 6))))
            us = torch.tensor(rng.integers(6, W // 2, n_lanes), **i32)
            vs = torch.tensor(rng.integers(6, H // 2, n_lanes), **i32)
            lanes = (us, vs, torch.clamp(us + rw_, max=W - 6).to(torch.int32),
                     torch.clamp(vs + rh_, max=H - 6).to(torch.int32))
            for rows in (0, 1):   # the launcher's own stage; stages of one row of cells
                for b in singles:
                    got = shi_tomasi._launch(frame, *b, **kw, rows=rows)
                    want = shi_tomasi.shi_tomasi_plain(frame, *b, **kw)
                    torch.cuda.synchronize()
                    if not all(same_bits_or_nan(x, y) for x, y in zip(got, want)):
                        fail(f"K6 at region {rw_} x {rh_} ({W}x{H}, stage rows {rows}) differs from its plain version")
                    errs["K6"] = max(errs["K6"], max_err(got[2], want[2]))
                    n["K6"] += 1
                got = shi_tomasi._launch(frames, *lanes, **kw, rows=rows)
                want = shi_tomasi.shi_tomasi_plain(frames, *lanes, **kw)
                torch.cuda.synchronize()
                if not all(same_bits_or_nan(x, y) for x, y in zip(got, want)):
                    fail(f"K6 over {n_lanes} lanes at region {rw_} x {rh_} ({W}x{H}, stage rows {rows}) differs")
                errs["K6"] = max(errs["K6"], max_err(got[2], want[2]))
                n["K6"] += 1
            if rw_ == 10**4:
                _off, rw, rh = shi_tomasi.region_geometry(H, W, B, rw_, rh_)
                b = singles[0]
                for label, fk, fp_, cost in (
                    (f"K6 {rw}x{rh} one frame", lambda: shi_tomasi.shi_tomasi(frame, *b, **kw),
                     lambda: shi_tomasi.shi_tomasi_plain(frame, *b, **kw), shi_tomasi.bytes_and_flops(B, rw, rh)),
                    (f"K6 {rw}x{rh} {n_lanes} lanes", lambda: shi_tomasi.shi_tomasi(frames, *lanes, **kw),
                     lambda: shi_tomasi.shi_tomasi_plain(frames, *lanes, **kw),
                     tuple(n_lanes * x for x in shi_tomasi.bytes_and_flops(B, rw, rh))),
                ):
                    b_ms, b_by = bound([cost])
                    timed[label] = dict(ms=time_ms(fk, n=20, batches=3), plain_ms=time_ms(fp_, n=2, batches=3),
                                        device_ms=kernel_device_ms(fk, "k6_kernel"), bound_ms=b_ms, bound_by=b_by,
                                        inputs=f"seeded noise frames at {W}x{H}, the whole-frame region {rw} x {rh}")
    log(f"[2c] K2 ({n['K2']} calls) and K8 ({n['K8']}) at search radii "
        f"{', '.join(f'{R} ({W}x{H})' for H, W, R in WIDE_RADII)} and K6 ({n['K6']}) on regions "
        f"{', '.join(f'{w} x {h}' for w, h in WIDE_REGIONS[:2])} and the whole frame at 320x240 and 640x480, "
        f"each with its own stage and with one row a pass, one frame and over lanes: bit for bit "
        f"(max abs err {json.dumps(errs)})")
    for label, t_ in timed.items():
        log(f"[2c] {label}: {json.dumps(t_)}")
    return errs, timed


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
    for name, a, b in (("meas", meas, wm), ("sel", sel, ws), ("x'", xo, wx), ("P'", Po, wP),
                       ("top_score", top_score, wsc)):
        if not same_bits_or_nan(a, b):
            fail(f"K1 {name} differs from the plain version bit for bit (max abs err {max_err(a, b)})")
    return max(max_err(meas, wm), max_err(sel, ws), max_err(xo, wx), max_err(Po, wP))


def same_bits(a, b) -> bool:
    """Equal bit for bit (floats compared as their 32-bit patterns)."""
    return torch.equal(a.float().cpu().view(torch.int32), b.float().cpu().view(torch.int32))


def same_bits_or_nan(a, b) -> bool:
    """Equal bit for bit, any NaN equal to any NaN."""
    a, b = a.float().cpu(), b.float().cpu()
    if a.shape != b.shape:
        return False
    return bool(((a.view(torch.int32) == b.view(torch.int32)) | (torch.isnan(a) & torch.isnan(b))).all())


def check_search(got, want, what: str) -> float:
    """K2's and K8's outputs: found, u, v, over equal, best identical bit for bit."""
    for name, a, b in zip(("found", "u", "v"), got[:3], want[:3]):
        if not same(a, b):
            fail(f"{what} {name} differs: kernel {a.tolist()} plain {b.tolist()}")
    if not same(got[4], want[4]):
        fail(f"{what} overflow differs")
    if not same_bits(got[3], want[3]):
        fail(f"{what} best differs bit for bit: {got[3].tolist()} vs {want[3].tolist()}")
    return max_err(got[3], want[3])


def check_k2(args, c) -> float:
    from scenelib2_torch.kernels.search import search, search_plain

    got = search(*args, c)
    want = search_plain(*args, c)
    torch.cuda.synchronize()
    return check_search(got, want, "K2")


def check_k3(args, c) -> float:
    from scenelib2_torch.kernels.ekf_update import joint_update, joint_update_plain

    got = joint_update(*args, c)
    want = joint_update_plain(*args, c)
    torch.cuda.synchronize()
    for name, a, b in zip(("attempts", "successes", "sched", "kill"), got[2:], want[2:]):
        if not same(a, b):
            fail(f"K3 {name} differs: kernel {a.tolist()} plain {b.tolist()}")
    err = max(max_err(got[0], want[0]), max_err(got[1], want[1]))
    if not (same_floats(got[0], want[0]) and same_floats(got[1], want[1])):
        fail(f"K3 x'/P' differ from the plain version (max abs err {err})")
    if not same(got[1], got[1].T):
        fail("K3 P' not symmetric")
    return err


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
    for label, (u, v, w, h) in (("border", (250, 3, 80, 60)), ("random", (100, 90, 80, 60)),
                                ("left", (0, H // 3, 80, 60)), ("right", (W - 30, H // 3, 80, 60)),
                                ("top", (W // 3, 0, 80, 60)), ("bottom", (W // 3, H - 20, 80, 60)),
                                ("corner", (W - 3, H - 3, 80, 60)), ("excluded", (W // 3, H // 3, 23, 17))):
        out.append((label, (noise, torch.tensor(max(u, 6), **i32), torch.tensor(max(v, 6), **i32),
                            torch.tensor(min(u + w, W - 6), **i32),
                            torch.tensor(min(v + h, H - 6), **i32), kw)))
    return out


def k6_lane_variations(args, kw, rng):
    """K6 over lanes on each lane's captured frame and bounds, then on
    lanes that are flat, periodic (tied maxima) or noise with regions at
    each border and corner, a lane to each kind."""
    frames, us, vs, uf, vf = args
    n, H, W = frames.shape
    dev = frames.device
    tile = rng.integers(0, 256, (7, 9), dtype=np.uint8)
    kinds = [np.full((H, W), 117, np.uint8), np.tile(tile, (H // 7 + 1, W // 9 + 1))[:H, :W].copy()]
    fr, b4 = [], []
    at = ((0, H // 3), (W - 30, H // 3), (W // 3, 0), (W // 3, H - 20), (W - 3, H - 3), (0, 0), (W // 3, H // 3))
    for b in range(n):
        k = b % 3
        fr.append(kinds[k] if k < 2 else rng.integers(0, 256, (H, W), dtype=np.uint8))
        u, v = at[b % len(at)]
        b4.append((max(u, 6), max(v, 6), min(u + 80, W - 6), min(v + 60, H - 6)))
    i32 = dict(dtype=torch.int32, device=dev)
    bt = torch.tensor(b4, **i32)
    return [("captured", (args, kw)),
            ("flat/tie/borders", ((torch.tensor(np.stack(fr), device=dev),) + tuple(bt[:, j].contiguous()
                                                                                   for j in range(4)), kw))]


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
    return compare_sb(got, want, "K4", K11_NAMES + ("pred",))


def k5_jax_args(args):
    """propose_plain's arguments (the JAX kernel's: x, rng, occ, want, c)
    from the step's propose_region arguments: the active full slots and the
    step's gate."""
    from scenelib2_torch.kernels.propose import init_gate

    x, rng_l, active, full, speed, n_visible, c = args
    return x, rng_l, active & full, init_gate(active, full, speed, n_visible, c), c


def k5_region_variations(args, rng):
    """(label, args) cases of K5 from a real frame's propose_region inputs:
    the gate shut by speed, by the visible count, by a partial slot; and,
    with the gate open, k5_variations' no room, every try clashing and
    seeded streams."""
    x, rng_l, active, full, speed, n_visible, c = args
    out = [("real", args)]

    def case(label, **repl):
        b = list(args)
        for i, v in repl.items():
            b[int(i[1:])] = v
        out.append((label, tuple(b)))

    case("slow", i4=torch.full_like(speed, c.min_speed))
    case("enough_visible", i5=torch.full_like(n_visible, c.keep_visible))
    part = full.clone()
    part[-1] = False
    case("partial_slot", i2=torch.ones_like(active), i3=part)
    fast = speed + 1.0
    for label, jax_args in k5_variations(k5_jax_args(args), rng)[2:]:
        case(label, i0=jax_args[0], i1=jax_args[1], i2=jax_args[2], i3=torch.ones_like(full), i4=fast,
             i5=torch.zeros_like(n_visible))
    return out


def check_k5(args) -> float:
    from scenelib2_torch.kernels.propose import propose_region, propose_region_plain

    got = propose_region(*args)
    want = propose_region_plain(*args)
    torch.cuda.synchronize()
    for name, a, b in zip(got._fields, got, want):
        if not same(a, b):
            fail(f"K5 {name} differs: kernel {a.tolist()} plain {b.tolist()}")
    return 0.0


def draws_consumed(args) -> int | None:
    """The drand48 draws K5's plain version consumed on args (None past 4,096)."""
    from scenelib2_torch.kernels.propose import propose_plain
    from scenelib2_torch.rng import drand48_many

    rng_new = propose_plain(*args)[3]
    states, _ = drand48_many(args[1], 4096)
    if torch.equal(rng_new, args[1]):
        return 0
    hit = torch.nonzero((states == rng_new).all(dim=-1)).flatten()
    return int(hit[0]) + 1 if hit.numel() else None


def check_k6(args) -> float:
    from scenelib2_torch.kernels.shi_tomasi import shi_tomasi, shi_tomasi_plain

    got = shi_tomasi(*args[:5], **args[5])
    want = shi_tomasi_plain(*args[:5], **args[5])
    torch.cuda.synchronize()
    for name, a, b in zip(("ubest", "vbest"), got[:2], want[:2]):
        if not same(a, b):
            fail(f"K6 {name} differs: kernel {a.tolist()} plain {b.tolist()}")
    if not same_bits_or_nan(got[2], want[2]):
        fail(f"K6 evbest differs bit for bit: {got[2].tolist()} vs {want[2].tolist()}")
    return max_err(got[2], want[2])


# ------------------------------------------------------------ batch kernels


def lanes_of(fn, n):
    """fn(lane) for each of n lanes, results stacked field by field."""
    return tuple(torch.stack(o) for o in zip(*(fn(b) for b in range(n))))


def k7_random_scene(rng, params, dev, n_lanes=6):
    """K7's arguments (x, P, xp_org, active, full) for n_lanes seeded lanes
    of params.max_features slots: lane 0 holds a NaN score, lane 1 has no
    visible feature (nothing active), lane 2 equal scores (every slot the
    same point and covariance)."""
    MF = params.max_features
    xs, Ps, xpos, acts, fulls = [], [], [], [], []
    for b in range(n_lanes):
        x, P, xpo, act_full, part = k1_random_scene(rng, params, dev, nan_lane=b == 0)
        active, full = act_full | part, ~part
        if b == 1:
            active = torch.zeros_like(active)
        if b == 2:
            x = x.clone()
            P = torch.eye(x.shape[0], device=dev) * 1e-4
            for k in range(1, MF):
                x[13 + 6 * k : 19 + 6 * k] = x[13:19]
            xpo = xpo[:1].expand(MF, 7).contiguous()
            active, full = torch.ones_like(active), torch.ones_like(full)
        xs.append(x); Ps.append(P); xpos.append(xpo); acts.append(active); fulls.append(full)
    return tuple(torch.stack(t) for t in (xs, Ps, xpos, acts, fulls))


def check_k7(args, c, nsel) -> float:
    """K7 against its plain version on (x, P, xp_org, active, full): the
    selection, the count, the selected rows and every slot's chain rows bit
    for bit (NaN equal to NaN)."""
    from scenelib2_torch.kernels.measure import measure_select, measure_select_plain

    got = measure_select(*args, nsel, c, rows=True)
    want = measure_select_plain(*args, nsel, c, rows=True)
    torch.cuda.synchronize()
    err = 0.0
    for name, g, w in zip(got._fields, got, want):
        g, w = g.contiguous(), w.contiguous()
        if g.is_floating_point():
            if not same_bits_or_nan(g, w):
                fail(f"K7 {name} differs from the plain version bit for bit (max abs err {max_err(g, w)})")
            err = max(err, max_err(g, w))
        elif not same(g, w):
            fail(f"K7 {name} differs: kernel {g.tolist()} plain {w.tolist()}")
    return err


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
    if not same_floats(got, want):
        fail(f"K9 scores differ from the plain version: max abs err {max_err(got, want)}")
    return max_err(got, want)


def check_k10(shared, slot_rows, lam, c) -> float:
    from scenelib2_torch.kernels.particle import particle_predict, particle_predict_plain

    got = particle_predict(shared, slot_rows, lam, c)
    want = particle_predict_plain(shared, slot_rows, lam, c)
    torch.cuda.synchronize()
    if not same_floats(got, want):
        fail(f"K10 rows differ from the plain version (max abs err {max_err(got, want)})")
    return max_err(got, want)


K11_NAMES = ("prob", "palive", "mean", "cov", "convert", "kill", "n_over", "found", "z", "best")


def compare_sb(got, want, what, names=K11_NAMES) -> float:
    """The outputs of K11 (or K4) against a reference: booleans and
    integers equal, floats bit for bit (any NaN equal to any NaN); returns
    the largest float difference (0)."""
    for name, a, b in zip(names, got, want):
        ok = same_bits_or_nan(a, b) if a.is_floating_point() else same(a, b)
        if not ok:
            bad = torch.nonzero((a != b).reshape(a.shape[0], -1).any(-1)).flatten().tolist()
            fail(f"{what} {name} differs from the plain version bit for bit in rows {bad[:8]} "
                 f"(max abs err {max_err(a.float(), b.float())})")
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
    return check_search(got, want, "K2 over lanes:")


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
    if not same_bits_or_nan(got[2], want[2]):
        fail(f"K6 over lanes: evbest differs bit for bit (max abs err {max_err(got[2], want[2])})")
    return max_err(got[2], want[2])


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


# ------------------------------------------------------------ 3e: the alternative batch routes

# route -> (label, the kernels each step launches once for all lanes); the
# JAX batch routes batch_pallas=False ("bp0") and SCENELIB2_BATCH_SB=0 ("sb0")
ROUTE_PATH = {
    "bp0": ("batch_pallas=False", ("search_windows", "bayes")),
    "sb0": ("SCENELIB2_BATCH_SB=0", ("measure", "search", "shi_tomasi", "score_map", "particle_predict",
                                     "particle_search", "bayes")),
}
ROUTE_TRACED_STEPS = 4       # the profiler costs ~0.7 ms per traced device kernel
ROUTE_REF_LANES, N_ROUTE_REF = (0, 32), 10
K12_NAMES = ("prob", "palive", "mean", "cov", "convert", "kill", "n_over")


def compare_exact(got, want, names, what) -> float:
    """Every output equal (floats bit for bit, NaN where the other has NaN);
    returns the largest float difference (0)."""
    for name, a, b in zip(names, got, want):
        ok = same_floats(a, b) if a.is_floating_point() else same(a, b)
        if not ok:
            fail(f"{what}: {name} differs from the plain version (max abs err {max_err(a.float(), b.float())})")
    return max((max_err(a, b) for a, b in zip(got, want) if a.is_floating_point()), default=0.0)


def check_k8(args, sc) -> float:
    from scenelib2_torch.kernels.search import search_windows, search_windows_plain

    got = search_windows(*args, sc)
    flat = [t.reshape(-1, *t.shape[2:]) for t in args]
    want = tuple(o.reshape(got[0].shape) for o in search_windows_plain(*flat, sc))
    torch.cuda.synchronize()
    return check_search(got, want, "K8")


def check_k12(args, kw) -> float:
    from scenelib2_torch.kernels.bayes import bayes_update, bayes_update_plain

    got = bayes_update(*args, **kw)
    lead = args[0].shape[:-1]

    def rows(t):
        return None if t is None else t.reshape(-1, *t.shape[len(lead):])

    want = bayes_update_plain(*(rows(t) for t in args[:12]), args[12],
                              pred_rows=rows(kw.get("pred_rows")))
    want = tuple(w.reshape(g.shape) for g, w in zip(got, want))
    torch.cuda.synchronize()
    return compare_exact(got, want, K12_NAMES, "K12 (pred rows)" if kw.get("pred_rows") is not None else "K12")


def check_k13(args) -> float:
    from scenelib2_torch.kernels.particle_search import particle_search, particle_search_plain

    got = particle_search(*args)
    want = particle_search_plain(*args)
    torch.cuda.synchronize()
    return compare_exact(got, want, ("found", "u", "v", "over"), "K13")


def k8_seeded(rng, p, dev, n_lanes=4):
    """K8 arguments over lanes of random frames: lane 0's first feature with
    its patch planted at two centres of its window (a tie of perfect
    matches), lane 1's first feature with a near-singular S^-1 (an ellipse
    beyond the window), a NaN centre in lane 2 (an unselected slot)."""
    from scenelib2_torch.kernels.correlate import gather_windows_u8
    from scenelib2_torch.kernels.search import search_window_origin

    H, W, B, K = p.cam_height, p.cam_width, p.boxsize, p.n_features_to_select
    frames = torch.tensor(rng.integers(0, 256, (n_lanes, H, W), dtype=np.uint8), device=dev)
    patches = torch.tensor(rng.integers(0, 256, (n_lanes, K, B, B), dtype=np.uint8), device=dev)
    h = torch.tensor(rng.uniform(40, 200, (n_lanes, K, 2)), dtype=torch.float32, device=dev)
    h[0, 0] = torch.tensor([100.0, 90.0])
    for uu, vv in ((92, 80), (110, 98)):
        frames[0, vv - 5 : vv + 6, uu - 5 : uu + 6] = patches[0, 0]
    h[2, 3] = float("nan")
    abc = torch.tensor(np.tile([0.02, 0.002, 0.03], (n_lanes, K, 1)), dtype=torch.float32, device=dev)
    abc[1, 0] = torch.tensor([1e-4, 0.0, 1e-4])
    active = torch.ones((n_lanes, K), dtype=torch.bool, device=dev)
    active[2, 3] = False
    u0, v0, _, _ = search_window_origin(h, p.search_win_radius, W, H, B)
    wins = gather_windows_u8(frames, u0, v0, p.search_win_radius, B)
    return wins, patches, u0, v0, h, abc, active


def k12_seeded(rng, p, dev, pred_form: bool, n_rows=6, NP=None):
    """K12 arguments [n_rows, 1, ...] at NP particles (the configuration's by
    default): random rows, row 1 with nothing found or overflowed (an
    all-zero likelihood: killed), row 2 past its sell-by, row 3 not making."""
    from scenelib2_torch.kernels.bayes import BayesConsts, padded_lanes

    NP = NP or p.n_particles
    lanes = padded_lanes(NP)
    f = dict(dtype=torch.float32, device=dev)

    def t(a, **k):
        return torch.tensor(a, **(k or f))

    prob = t(rng.uniform(0.005, 0.02, (n_rows, 1, NP)))
    lam = t(np.tile(np.linspace(0.5, 5.0, NP), (n_rows, 1, 1)))
    palive = t(rng.uniform(size=(n_rows, 1, NP)) > 0.1, device=dev)
    found = t(rng.uniform(size=(n_rows, 1, NP)) > 0.6, device=dev)
    over = t(rng.uniform(size=(n_rows, 1, NP)) > 0.95, device=dev)
    found[1], over[1] = False, False
    z = t(rng.uniform(100, 115, (n_rows, 1, NP, 2)))
    making = torch.ones((n_rows, 1), dtype=torch.bool, device=dev)
    making[3] = False
    pmask = torch.ones((n_rows, 1), dtype=torch.bool, device=dev)
    ma = torch.full((n_rows, 1), 3, dtype=torch.int32, device=dev)
    ma[2] = p.erase_partial_after_attempts + 1
    geo = [t(rng.uniform(100, 115, (n_rows, 1, NP, 2))),
           t(np.tile([[0.05, 0.01], [0.01, 0.04]], (n_rows, 1, NP, 1, 1))), t(rng.uniform(300, 600, (n_rows, 1, NP)))]
    kw = {}
    if pred_form:
        pred = t(rng.uniform(0.01, 0.06, (n_rows, 1, 8, lanes)))
        pred[:, :, 0:2] = t(rng.uniform(100, 115, (n_rows, 1, 2, lanes)))
        pred[:, :, 5] = t(rng.uniform(300, 600, (n_rows, 1, lanes)))
        geo, kw = [None, None, None], dict(pred_rows=pred)
    return (prob, lam, palive, found, over, z, *geo, making, pmask, ma, BayesConsts.from_params(p)), kw


def k13_seeded(rng, p, dev, n_lanes=4):
    """K13 arguments: random maps and particle clouds along rays; lane 0 with
    degenerate particles (NaN, huge and indefinite S^-1, an overflowing
    ellipse, centres far off the frame: regions whose bounds lie 2^31
    apart), lane 1 with empty regions and dead particles, lane 2 with a
    planted three-way tie, lane 3 with the in-kernel geometry's edges (S^-1
    with c = 0, +-inf and NaN entries, centres at +-2^31 and NaN, half-
    extents above R), NaN cells and cells at and above 1e6."""
    from scenelib2_torch.kernels.particle_search import ParticleSearchConsts

    H, W, NP = p.cam_height, p.cam_width, p.n_particles
    f = dict(dtype=torch.float32, device=dev)
    maps = torch.tensor(rng.uniform(0.3, 2.0, (n_lanes, 1, H, W)), **f)
    u = np.linspace(80, 160, NP)
    h = torch.tensor(np.tile(np.stack([u, 100 + 0.3 * (u - 80)], -1), (n_lanes, 1, 1, 1)), **f)
    sinv = torch.tensor(np.tile([[0.05, 0.01], [0.01, 0.04]], (n_lanes, 1, NP, 1, 1)), **f)
    alive = torch.ones((n_lanes, 1, NP), dtype=torch.bool, device=dev)
    sinv[0, 0, 0] = float("nan")
    sinv[0, 0, 1] = torch.tensor([[1e-30, 0.0], [0.0, 1e-30]])
    sinv[0, 0, 2] = torch.tensor([[1.0, 2.0], [2.0, 1.0]])
    sinv[0, 0, 3] = torch.tensor([[1e-6, 0.0], [0.0, 1e-6]])
    h[0, 0, 4] = torch.tensor([-1e12, 5.0])
    h[0, 0, 5] = torch.tensor([float("nan"), 50.0])
    h[0, 0, 6] = torch.tensor([3e9, 3e9])
    maps[0, 0, 95:105, 95:105] = 0.1
    sinv[1, 0, :] = torch.tensor([[4.0, 0.0], [0.0, 4.0]])
    h[1, 0, :10, 0] = -40.0
    alive[1, 0, 10:20] = False
    maps[2, 0, 102, 104] = maps[2, 0, 100, 104] = maps[2, 0, 101, 103] = 0.05
    h[2, 0, :] = torch.tensor([104.3, 101.2])
    inf, nan = float("inf"), float("nan")
    for q, si in enumerate(([[0.05, 0.01], [0.01, 0.0]], [[inf, 0.0], [0.0, 0.04]], [[0.05, inf], [inf, 0.04]],
                            [[0.05, 0.0], [0.0, -inf]], [[0.05, nan], [nan, 0.04]], [[1e-5, 0.0], [0.0, 1e-5]])):
        sinv[3, 0, q] = torch.tensor(si)
    for q, hc in enumerate(((2.0**31, 2.0**31), (-(2.0**31), -(2.0**31)), (nan, nan), (2147483520.0, 30.0)), 6):
        h[3, 0, q] = torch.tensor(hc)
    maps[3, 0, 100:110, 85:95] = float("nan")
    maps[3, 0, 110:120, 120:130] = 1e6
    maps[3, 0, 120:125, 140:150] = 3e6
    return maps, h, sinv, alive, ParticleSearchConsts.from_params(p)


def k13_whole(rng, p, dev, n_slots=3):
    """K13 arguments whose windows are the whole map (particle radius 200 on
    320x240 maps, correlate.window_search's rule): slot 0 admits every cell
    of maps above 1e6 (best above 1e6, its key kept), slot 1 admits a few
    (the 1e6 of the others joins the minimum), slot 2 a cell at exactly 1e6
    among cells above it."""
    from scenelib2_torch.kernels.particle_search import ParticleSearchConsts

    H, W, NP = p.cam_height, p.cam_width, 40
    f = dict(dtype=torch.float32, device=dev)
    maps = torch.tensor(rng.uniform(1.5e6, 3e6, (n_slots, 1, H, W)), **f)
    maps[2, 0, 120, 160] = 1e6
    h = torch.tensor(np.stack([rng.uniform(100, 220, (n_slots, 1, NP)), rng.uniform(80, 160, (n_slots, 1, NP))], -1),
                     **f)
    sinv = torch.tensor(np.tile([[1e-6, 0.0], [0.0, 1e-6]], (n_slots, 1, NP, 1, 1)), **f)
    sinv[1] = torch.tensor([[0.5, 0.0], [0.0, 0.5]])
    alive = torch.ones((n_slots, 1, NP), dtype=torch.bool, device=dev)
    c = dataclasses.replace(ParticleSearchConsts.from_params(p), win_radius=200)
    return maps, h, sinv, alive, c


def batch_routes_phase(p, dev, rng, bparams, states0, bseq, bframes, single_ms_frame) -> dict:
    """Phase 3e: K8, K12 (both forms) and K13 against their plain versions on
    seeded cases and on inputs captured from each route's replay; each
    route's 64-lane replay against its committed fingerprints with its
    launch counts; a CPU plain replay of two lanes; 30 steps under sync
    debug mode "error"; timings, a traced window and peak device memory."""
    import dataclasses
    import traceback

    from scenelib2_torch.eval.batch import check_lanes, lane_fingerprints
    from scenelib2_torch.kernels import _build, bayes, multi_ellipse, particle_search, search
    from scenelib2_torch.parallel.mesh import _run_batch_eager, make_batched_step, run_batch
    from scenelib2_torch.runtime.state import SlamState

    sc = search.SearchConsts.from_params(p)
    T = bseq.shape[0]
    errs = {"K8": 0.0, "K12": 0.0, "K12 pred rows": 0.0, "K13": 0.0}
    k16_dead = {}
    for _trial in range(2):
        errs["K8"] = max(errs["K8"], check_k8(k8_seeded(rng, p, dev), sc))
        for form, key in ((False, "K12"), (True, "K12 pred rows")):
            a, kw = k12_seeded(rng, p, dev, form)
            errs[key] = max(errs[key], check_k12(a, kw))
        errs["K13"] = max(errs["K13"], check_k13(k13_seeded(rng, p, dev)), check_k13(k13_whole(rng, p, dev)))
    log("[3e] K8 (a tie, an overflowing ellipse, a NaN centre), K12 in both forms (an all-zero "
        "likelihood, a sell-by, a row not making) and K13 (degenerate S^-1, far and NaN centres, c = 0, "
        "infinite and NaN S^-1, empty regions, dead particles, a tie, NaN cells, cells at and above 1e6, "
        "windows that are the whole map) equal their plain versions on seeded cases")

    res = {}
    for route, (label, path) in ROUTE_PATH.items():
        rparams = dataclasses.replace(bparams, batch_pallas=route != "bp0")
        sb = False if route == "sb0" else None
        step = make_batched_step(rparams, device="cuda", batch_sb=sb)
        # kernel inputs of whole batch steps (all lanes at once); on sb0 every
        # step's K13 call is held to its plain version as it is made
        seen, cur = {}, {}
        n13 = 0

        def keep(n, a, k):
            nonlocal n13
            cur[n] = (tuple(t.clone() if isinstance(t, torch.Tensor) else t for t in a), dict(k))
            if n == "particle_search":
                errs["K13"] = max(errs["K13"], check_k13(a))
                n13 += 1

        with observe_wrappers(keep):
            st_b = states0
            for t in range(T if route == "sb0" else max(BATCH_AT) + 1):
                cur.clear()
                st_b, _o = step(st_b, bseq[t], True)
                if t in BATCH_AT:
                    seen[t] = dict(cur)
        torch.cuda.synchronize()
        k12_key = "K12" if route == "bp0" else "K12 pred rows"
        for at in BATCH_AT:
            c = seen[at]
            a12, kw12 = c["bayes_update"]
            errs[k12_key] = max(errs[k12_key], check_k12(a12, kw12))
            if route == "bp0":
                errs["K8"] = max(errs["K8"], check_k8(c["search_windows"][0][:7], sc))
            else:
                errs["K13"] = max(errs["K13"], check_k13(c["particle_search"][0]))
                # K16 (no route runs it) on the same maps and clouds, and against K13
                errs["K16"] = max(errs.get("K16", 0.0), check_k16(*k16_of_k13(c["particle_search"][0])))
                k16_dead[at] = k16_against_k13(c["particle_search"][0])
        log(f"[3e] {label}: the route's kernels equal their plain versions on whole {N_LANES}-lane "
            f"steps at output indices {BATCH_AT} (max abs err {json.dumps(errs)})")
        if route == "sb0":
            log(f"[3e] K13 equals its plain version bit for bit on all {n13} calls of the {T}-step replay")
            log(f"[3e] K16 on the maps and clouds of K13's calls at {BATCH_AT}: found and overflow equal K13's "
                f"everywhere, (u, v) for every live particle; dead particles whose (u, v) differ (K13 gives a "
                f"dead particle no key by design, K16 searches it): {json.dumps(k16_dead)}")

        costs = []

        def record(n, a, k):
            if n == "search_windows":
                from scenelib2_torch.kernels.search import candidate_geometry, window_centre

                uc, vc = window_centre(a[4])
                admit = candidate_geometry(a[2].reshape(-1), a[3].reshape(-1), uc.reshape(-1),
                                           vc.reshape(-1), a[5].reshape(-1, 3), sc)[0]
                costs.append(("K8", search.bytes_and_flops_windows(a[2].numel(), sc, admit)))
            elif n == "bayes_update":
                costs.append((k12_key, bayes.bytes_and_flops(a[0][..., 0].numel(), a[0].shape[-1])))
            elif n == "particle_search":
                Bn, Fn, P = a[3].shape
                costs.append(("K13", particle_search.bytes_and_flops(
                    Bn, Fn, P, *particle_search.region_cells(a[1], a[2], a[3], a[4]))))

        torch.cuda.synchronize()
        _build.reset_launches()
        with observe_wrappers(record):
            st_eager, outs = _run_batch_eager(step, states0, bseq, True, rparams)
        launches = dict(_build.launches)

        def check_fp(o, route=route, label=label):
            bad = check_lanes(lane_fingerprints(o), route=route)
            if bad:
                fail(f"{label}: {len(bad)} of {N_LANES} lane fingerprints differ from the committed file:\n"
                     + "\n".join(bad[:6]))

        check_fp(outs)
        for n in _build.KERNELS:
            want = T if n in path else 0
            if launches.get(n, 0) != want:
                fail(f"kernel {n} launched {launches.get(n, 0)} times on the {label} route, expected {want}")
        log(f"[3e] {label}: all {N_LANES} per-lane fingerprints equal the committed file; launches "
            f"({T} steps of {N_LANES} lanes, eager loop): {json.dumps(launches)}")
        rb = outs.r.numpy()
        if rb.shape != (T, N_LANES, 3) or not np.isfinite(rb).all():
            fail(f"{label}: trajectories not finite/shaped: {rb.shape}")

        # reference on a small input: two lanes replayed by the CPU plain versions
        idx = list(ROUTE_REF_LANES)
        cpu_states = SlamState(*(t[idx].cpu() for t in states0))
        cpu_step = make_batched_step(rparams, device="cpu", batch_sb=sb)
        _s, ref = run_batch(cpu_step, cpu_states, bframes[:N_ROUTE_REF, idx], True, rparams)
        for k in ("n_visible", "n_selected", "n_matched", "n_active", "n_partial", "did_init",
                  "did_convert", "n_overflow", "sel_matched", "init_box", "par_alive"):
            if not torch.equal(getattr(ref, k), getattr(outs, k)[:N_ROUTE_REF, idx]):
                fail(f"{label}: CUDA vs CPU plain replay: {k} differs in lanes {idx}")
        dx = float((ref.xv.double() - outs.xv[:N_ROUTE_REF, idx].double()).abs().max())
        if dx > STEP_TOL:
            fail(f"{label}: CUDA vs CPU plain replay: xv differs by {dx}")
        log(f"[3e] {label}: lanes {idx} equal their CPU plain replay on frames 1..{N_ROUTE_REF} "
            f"(max |dxv| {dx:.3g})")

        st_b = states0
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for t in range(N_REF):
                st_b, _o = step(st_b, bseq[t], True)
        except RuntimeError:
            fail(f"the {label} batch step synchronised with the host:\n{traceback.format_exc()}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        log(f"[3e] {label}: {N_REF} batch steps ran with torch.cuda.set_sync_debug_mode('error'): "
            "no host synchronisation")

        run, run_eager = batch_runs(step, states0, bseq, rparams)
        g = graph_cell("3e", label, run, run_eager, step.graphs, T, path, (outs, st_eager), check_fp,
                       trace_n=ROUTE_TRACED_STEPS)
        launches = g["launches"]
        r_ = {k: v for k, v in g.items() if k != "prof"}
        r_.update(route=label, lanes=N_LANES, frames_per_lane=T, frames_per_s=N_LANES / g["graph_ms"] * 1e3,
                  frames_per_s_eager=N_LANES / g["eager_ms"] * 1e3,
                  single_stream_frames_per_s=1e3 / single_ms_frame)
        r_["vs_64x_single_stream"] = r_["frames_per_s"] / (N_LANES * r_["single_stream_frames_per_s"])
        log(f"[3e] {label}: {r_['frames_per_s']:.1f} aggregate frames/s through the graph "
            f"({r_['frames_per_s_eager']:.1f} eager); {r_['vs_64x_single_stream']:.4f} of {N_LANES} x the "
            f"single stream's graph replay ({r_['single_stream_frames_per_s']:.1f} frames/s)")
        dev_ms = {short: kernel_dev_ms(g["prof"], sym)
                  for short, sym in (("K8", "k8_kernel"), ("K12", "k12_kernel"), ("K13", "k13_kernel"))}

        # each kernel's and its plain version's time on the output-index-20 inputs
        c20 = seen[20]
        a12, kw12 = c20["bayes_update"]
        kern = {k12_key: (lambda: bayes.bayes_update(*a12, **kw12),
                          lambda: bayes.bayes_update_plain(
                              *(None if t is None else t.reshape(-1, *t.shape[2:]) for t in a12[:12]),
                              a12[12], pred_rows=(None if "pred_rows" not in kw12
                                                  else kw12["pred_rows"].flatten(0, 1))),
                          "K12")}
        if route == "bp0":
            a8 = c20["search_windows"][0][:7]
            flat8 = [t.reshape(-1, *t.shape[2:]) for t in a8]
            kern["K8"] = (lambda: search.search_windows(*a8, sc), lambda: search.search_windows_plain(*flat8, sc),
                          "K8")
        else:
            a13 = c20["particle_search"][0]
            kern["K13"] = (lambda: particle_search.particle_search(*a13),
                           lambda: particle_search.particle_search_plain(*a13), "K13")
            a16, kw16 = k16_of_k13(a13)
            res["K16"] = dict(
                ms=time_ms(lambda: multi_ellipse.multi_ellipse_search(*a16, **kw16), n=50, batches=3),
                plain_ms=time_ms(lambda: multi_ellipse.multi_ellipse_search_plain(*a16, **kw16), n=2, batches=3),
                device_ms=kernel_device_ms(lambda: multi_ellipse.multi_ellipse_search(*a16, **kw16), "k16_kernel"),
                costs=[multi_ellipse.bytes_and_flops(*a16[3].shape, *multi_ellipse.work_counts(*a16, **{
                    k_: kw16[k_] for k_ in ("win_radius", "no_sigma")}))],
                inputs=f"the SCENELIB2_BATCH_SB=0 route's output index 20, {a16[3].shape[0]} slots")
            log(f"[3e] K16: kernel {res['K16']['ms']:.4f} ms/launch (device {res['K16']['device_ms']}), plain "
                f"{res['K16']['plain_ms']:.4f} ms ({res['K16']['inputs']})")
        timings = {}
        for short, (fk, fp_, sym) in kern.items():
            lname = "search_windows" if short == "K8" else "bayes" if short.startswith("K12") else "particle_search"
            b_ms, b_by = bound([c for k_, c in costs if k_ == short])
            timings[short] = dict(ms=time_ms(fk, n=50, batches=3), plain_ms=time_ms(fp_, n=2, batches=3),
                                  device_ms=dev_ms[sym], bound_ms=b_ms, bound_by=b_by, library_ms=None,
                                  launches=launches[lname], launches_steps=g["launches_steps"],
                                  launches_captured=g["captured"].get(lname, 0))
            log(f"[3e] {short} on the {label} route: {json.dumps(timings[short])}")
        r_["timings"] = timings
        res[route] = r_
    res["errs"] = errs
    return res


# ------------------------------------------------------------ large maps: K14


K14_SPD_MS = (1, 2, 7, 20, 31, 32, 33, 64, 128)   # k14_random_cases' SPD sizes
K3_MORE_NSEL = (8, 16)   # K3 also at M = 16 and 32: the register form at an M of no configuration
# K15's seeded sizes (D, M) beyond the first six cases: M = 1, 32 (register
# factorisations), 33, 64 (the block form), 128 (its M x M arrays in the
# workspace); D = 7 and 13 (no slot), 128
K15_SIZES = ((109, 1), (109, 32), (109, 33), (109, 64), (109, 128), (7, 20), (13, 32), (128, 20), (7, 1),
             (128, 33))


def build_variants() -> list:
    """The (source, defines) builds this script's K14, K3 and K15 calls take
    beside every source's own: the register form at each M <= 32 they
    see (chol_inv.reg_defines)."""
    from scenelib2_torch.config import Params
    from scenelib2_torch.kernels import chol_inv

    k14 = [M for M in K14_SPD_MS if M <= chol_inv.REG_MAX_M]
    k3 = [2 * n for n in (Params().n_features_to_select, *K3_MORE_NSEL)]
    k15 = sorted({M for _D, M in K15_SIZES + ((19, 2),) if M <= chol_inv.REG_MAX_M} | {k3[0]})
    return ([("chol_inv", chol_inv.reg_defines(M)) for M in k14]
            + [("ekf_update", chol_inv.reg_defines(M)) for M in k3]
            + [("ekf_update_dense", chol_inv.reg_defines(M)) for M in k15])


def k14_random_cases(rng, dev):
    """(label, S) cases for K14: seeded SPD matrices of every size class the
    kernel takes (the warp form up to M = 32, the block form above), a stack
    of three and one of 64 at M = 20 (the warp form, four matrices a CTA),
    an EKF-shaped S = H P H' + R at M = 20 whose missed rows are identity
    blocks (H = 0, R = 1), and S that are not SPD (a negative pivot: NaN
    from there on; an infinite entry) at M = 20 and 40."""
    f = dict(dtype=torch.float32, device=dev)
    out = []
    for M in K14_SPD_MS:
        A = rng.normal(size=(M, M))
        out.append((f"spd{M}", torch.tensor(A @ A.T / M + np.eye(M) * 0.5, **f)))
    for n in (3, 64):
        A = rng.normal(size=(n, 20, 20))
        out.append((f"stack{n}x20", torch.tensor(A @ A.transpose(0, 2, 1) / 20 + np.eye(20), **f)))
    D = 109
    B = rng.normal(size=(D, D))
    P = B @ B.T / D * 1e-3 + np.eye(D) * 1e-4
    H = rng.normal(size=(20, D)) * 30.0
    miss = rng.uniform(size=10) < 0.4
    H[np.repeat(miss, 2)] = 0.0
    R = np.diag(np.where(np.repeat(miss, 2), 1.0, rng.uniform(1.0, 2.0, 20)))
    out.append(("ekf", torch.tensor(H @ P @ H.T + R, **f)))
    for M in (20, 40):
        A = rng.normal(size=(M, M))
        S = A @ A.T / M + np.eye(M) * 0.5
        S[M // 2, M // 2] = -5.0
        out.append((f"negative_pivot{M}", torch.tensor(S, **f)))
        S = A @ A.T / M + np.eye(M) * 0.5
        S[3, 3] = np.inf
        out.append((f"inf{M}", torch.tensor(S, **f)))
    return out


def check_k14(S) -> float:
    """K14 against its plain version bit for bit (NaN equal to NaN)."""
    from scenelib2_torch.kernels.chol_inv import chol_inv, chol_linv

    got = chol_inv(S)
    want = chol_linv(S)
    torch.cuda.synchronize()
    if not same_bits_or_nan(got, want):
        fail(f"K14 L^-1 differs from its plain version bit for bit at M={S.shape[-1]} "
             f"(max abs err {max_err(got, want)})")
    return max_err(got, want)


# ------------------------------------------------------------ 2b: K10b, K15, K16; the widened particle kernels

# the widened particle kernels' seeded NP: hires', 3 lane chunks, above 1,024
# threads, and two rows past the 4,096 held in shared memory (the workspace path)
WIDE_NP = (200, 300, 1100, 5120, 16384)


def wide_slot(rng, dev, n_slots: int):
    """Seeded partial slots: (shared [56], slot rows [n_slots, 84]) of a
    camera near the origin and rays close to the optical axis (lambda in
    [0.5, 5] projects inside a 320x240 frame), with one joint SPD
    covariance over the camera's first 7 dimensions and the slots."""
    q = np.array([1.0, *rng.normal(0, 0.02, 3)])
    d = 7 + 6 * n_slots
    M = rng.normal(size=(d, d))
    s = np.sqrt(np.r_[np.full(7, 1e-5), np.full(6 * n_slots, 1e-4)])
    C = s[:, None] * (np.eye(d) + 0.5 * M @ M.T / d) * s[None, :]
    shared = np.concatenate([rng.normal(0, 0.01, 3), q / np.linalg.norm(q), C[:7, :7].ravel()])
    slots = []
    for k in range(n_slots):
        h = np.array([*rng.normal(0, 0.06, 2), 1.0])
        o = 7 + 6 * k
        slots.append(np.concatenate([rng.normal(0, 0.1, 3), h / np.linalg.norm(h), C[:7, o : o + 6].ravel(),
                                     C[o : o + 6, o : o + 6].ravel()]))
    f = dict(dtype=torch.float32, device=dev)
    return torch.tensor(shared, **f), torch.tensor(np.stack(slots), **f)


def wide_lam(NP: int, n: int, dev):
    return torch.tensor(np.tile(np.linspace(0.5, 5.0, NP), (n, 1)), dtype=torch.float32, device=dev)


def check_wide(rng, p, dev) -> dict:
    """K10, K11, K12 (both forms) and K4 at WIDE_NP particles on seeded
    slots, each against its plain version at error 0."""
    from scenelib2_torch.kernels import bayes, particle, search_bayes
    from scenelib2_torch.kernels.particle import ParticleConsts, particle_predict, particle_predict_plain
    from scenelib2_torch.runtime.state import patch_row

    pc = ParticleConsts.from_params(p)
    sbc = search_bayes.SearchBayesConsts.from_params(p)
    H, W, B = p.cam_height, p.cam_width, p.boxsize
    errs = {"K10": 0.0, "K11": 0.0, "K12": 0.0, "K12 pred rows": 0.0, "K4": 0.0}
    f = dict(dtype=torch.float32, device=dev)
    for NP in WIDE_NP:
        n = 3
        shared, slots = wide_slot(rng, dev, n)
        lam = wide_lam(NP, n, dev)
        sh = shared[None].expand(n, 56).contiguous()
        args10 = (sh, slots[:, None], lam[:, None], pc)
        got = particle_predict(*args10)
        want = particle_predict_plain(*args10)
        torch.cuda.synchronize()
        if got.shape[-1] != bayes.padded_lanes(NP) or not same_floats(got, want):
            fail(f"K10 at NP={NP} differs from its plain version (max abs err {max_err(got, want)})")
        errs["K10"] = max(errs["K10"], max_err(got, want))
        # K11 on random maps with a planted minimum under each ray
        maps = torch.tensor(rng.uniform(0.3, 2.0, (n, 1, H, W)), **f)
        hu = want[:, 0, 0, NP // 2].nan_to_num(0.0).long().tolist()
        hv = want[:, 0, 1, NP // 2].nan_to_num(0.0).long().tolist()
        for b in range(n):
            u, v = min(max(hu[b], 3), W - 4), min(max(hv[b], 3), H - 4)
            maps[b, 0, v - 2 : v + 2, u - 2 : u + 2] = 0.1
        alive = torch.tensor(rng.uniform(size=(n, 1, NP)) > 0.1, device=dev)
        prob = torch.tensor(rng.uniform(0.5, 1.5, (n, 1, NP)) / NP, **f)
        ones = torch.ones((n, 1), dtype=torch.bool, device=dev)
        ma = torch.full((n, 1), 3, dtype=torch.int32, device=dev)
        for label, mk in (("making", ones), ("not making", torch.zeros_like(ones))):
            errs["K11"] = max(errs["K11"], compare_sb(
                search_bayes.search_bayes_maps(maps, want, prob, lam[:, None], alive, mk, ones, ma, sbc),
                search_bayes.search_bayes_maps_plain(maps, want, prob, lam[:, None], alive, mk, ones, ma, sbc),
                f"K11 at NP={NP} ({label})"))
        for form, key in ((False, "K12"), (True, "K12 pred rows")):
            a, kw = k12_seeded(rng, p, dev, form, NP=NP)
            errs[key] = max(errs[key], check_k12(a, kw))
        # K4 on a random frame whose patch is planted along the ray
        frame = torch.tensor(rng.integers(0, 256, (H, W), dtype=np.uint8), device=dev)
        u, v = min(max(hu[0], 20), W - 21), min(max(hv[0], 20), H - 21)
        patch = frame[v - B // 2 : v + B // 2 + 1, u - B // 2 : u + B // 2 + 1]
        MF = 4
        a4 = (frame, torch.full((MF, NP), 1.0 / NP, **f), wide_lam(NP, MF, dev),
              torch.tensor(rng.uniform(size=(MF, NP)) > 0.1, device=dev),
              torch.tensor([True], device=dev), torch.tensor([True], device=dev),
              torch.tensor([3], dtype=torch.int32, device=dev), torch.tensor([1], dtype=torch.int32, device=dev),
              patch_row(patch), shared, slots[0], sbc)
        for _label, args in k4_variations(a4, rng, H, W, B, p.erase_partial_after_attempts):
            got4 = search_bayes.search_bayes(*args)
            want4 = search_bayes.search_bayes_plain(*args)
            torch.cuda.synchronize()
            errs["K4"] = max(errs["K4"], compare_sb(got4, want4, f"K4 at NP={NP}", K11_NAMES + ("pred",)))
    return errs


def kform_inputs(shared, slot_rows):
    """K10b's inputs (zeroed [F, 6], K0, Ksym, K2 [F, 3, 3]) of slots: the
    geometry K10's prologue computes (particle.geometry_prologue), shared
    [B, 56], slot_rows [B, F, 84] flattened to B x F slots."""
    from scenelib2_torch.kernels.particle import geometry_prologue

    zr, zh, K0, Ks, K2 = geometry_prologue(shared[:, None, :], slot_rows)
    n = slot_rows.shape[0] * slot_rows.shape[1]
    return torch.cat([zr, zh], -1).reshape(n, 6), K0.reshape(n, 3, 3), Ks.reshape(n, 3, 3), K2.reshape(n, 3, 3)


def check_k10b(zeroed, K0, Ks, K2, lam, c) -> float:
    from scenelib2_torch.kernels.particle import (
        kform_outputs, kform_rows, kform_rows_plain, particle_predict_kform, particle_predict_kform_plain)

    got = kform_rows(zeroed, K0, Ks, K2, lam, c)
    want = kform_rows_plain(zeroed, K0, Ks, K2, lam, c)
    torch.cuda.synchronize()
    if not same_floats(got, want):
        fail(f"K10b rows differ from the plain version (max abs err {max_err(got, want)})")
    kw = dict(fku=c.fku, fkv=c.fkv, u0c=c.u0c, v0c=c.v0c, kd1=c.kd1, sd0=c.sd0, no_sigma=c.no_sigma)
    outs = particle_predict_kform(zeroed, K0, Ks, K2, lam, **kw)
    for name, a, b in zip(("hpi", "sinv", "dets", "hw", "hh"), outs,
                          particle_predict_kform_plain(zeroed, K0, Ks, K2, lam, **kw)):
        if not same_floats(a, b):
            fail(f"K10b {name} differs from the plain version")
    for a, b in zip(outs, kform_outputs(want, lam.shape[-1])):
        if not same_floats(a, b):
            fail("K10b's entry point does not unpack its rows as the TPU wrapper does")
    return max_err(got, want)


# K10b's seeded rows: (particles, slots), the widest on 1 to 128 CTAs a slot
K10B_SEEDED = ((100, 4), (200, 4), (1100, 8), (5120, 4), (16384, 2))


def k10b_seeded(rng, p, dev):
    """(label, args) K10b cases: seeded slots at K10B_SEEDED, and degenerate
    depths (a ray through the camera centre, lambda 0 and negative:
    z <= 0)."""
    from scenelib2_torch.kernels.particle import ParticleConsts

    c = ParticleConsts.from_params(p)
    out = []
    for NP, n in K10B_SEEDED:
        shared, slots = wide_slot(rng, dev, n)
        out.append((f"NP{NP}", (*kform_inputs(shared[None], slots[None]), wide_lam(NP, n, dev), c)))
    shared, slots = wide_slot(rng, dev, 2)
    lam = torch.tensor([[-1.0, 0.0, 1e-30, 0.5, 1e30] + [1.0] * 95] * 2, dtype=torch.float32, device=dev)
    out.append(("degenerate", (*kform_inputs(shared[None], slots[None]), lam, c)))
    return out


def k15_seeded(rng, dev, D=109, M=20, n_bad=2, any_succ=True, nan_deleted=False):
    """K15 arguments of pallas_ekf's test problem (tests/test_pallas_ekf.py:
    an SPD P, H with each row pair on the camera and one slot, R = I, the
    last n_bad slots deleted), optionally with a NaN in a deleted slot. A
    map with no slot (D < 19) gives H's rows on the camera alone, an odd M
    a last row of its own."""
    MF = (D - 13) // 6
    A = rng.normal(size=(D, D))
    P = A @ A.T / D * 1e-3 + np.eye(D) * 1e-4
    x = rng.normal(size=D) * 0.1
    x[3:7] = rng.normal(size=4)
    x[3:7] /= np.linalg.norm(x[3:7]) * (1.0 + 1e-3)
    H = np.zeros((M, D))
    for k in range((M + 1) // 2):
        rows = slice(2 * k, min(2 * k + 2, M))
        n = rows.stop - rows.start
        H[rows, :7] = rng.normal(size=(n, 7))
        if MF > 0:
            off = 13 + 6 * (k % MF)
            H[rows, off : off + 3] = rng.normal(size=(n, 3))
    nu = rng.normal(size=M) * 0.5
    keep = np.ones(D, bool)
    for k in range(n_bad):
        off = 13 + 6 * (MF - 1 - k)
        keep[off : off + 6] = False
    if nan_deleted:
        off = 13 + 6 * (MF - 1)
        P[off, off + 1] = P[off + 1, off] = np.nan
        x[off] = np.nan
    f = dict(dtype=torch.float32, device=dev)
    return (torch.tensor(x, **f), torch.tensor(P, **f), torch.tensor(H, **f), torch.tensor(nu, **f),
            torch.tensor(np.eye(M), **f), torch.tensor(any_succ, device=dev), torch.tensor(keep, device=dev))


def k15_nonfinite(rng, dev):
    """(label, args) K15 cases at D = 109, M = 20 with one non-finite entry
    of P (NaN, inf or -inf) placed in a kept row (on the diagonal, in the
    same 32 x 32 tile as its mirror, in another tile, the mirror's side),
    in a deleted row (the last slot: in its own tile, in another, on the
    diagonal) and twice in one column, with any_succ false (P passes
    through: the placement decides which rows the transposition rule makes
    NaN) and true (the update spreads it first)."""
    kept, dead = 20, 13 + 6 * 15    # slot 15 is deleted (n_bad = 2: slots 14 and 15)
    places = (((kept, kept),), ((kept, 25),), ((kept, 90),), ((90, kept),), ((dead, dead + 1),), ((dead, 5),),
              ((5, dead),), ((dead, dead),), ((kept, 60), (90, 60)))
    out = []
    for val in (float("nan"), float("inf"), -float("inf")):
        for place in places:
            for any_succ in (False, True):
                a = list(k15_seeded(rng, dev, any_succ=any_succ))
                P = a[1].clone()
                for i, j in place:
                    P[i, j] = val
                a[1] = P
                out.append((f"{val} at {place}, any_succ {any_succ}", tuple(a)))
    return out


def check_k15(args) -> float:
    from scenelib2_torch.kernels.ekf_update import joint_update_dense, joint_update_dense_plain

    got = joint_update_dense(*args)
    want = joint_update_dense_plain(*args)
    torch.cuda.synchronize()
    return compare_exact(got, want, ("x'", "P'"), f"K15 at D={args[0].shape[0]} M={args[3].shape[0]}")


def k15_from_k3(a3, c):
    """K15's arguments on K3's inputs of a real frame: H, nu, R assembled as
    the JAX step's XLA branch does and keep from K3's own kill; and K3's
    results on the same frame."""
    from scenelib2_torch.kernels.ekf_update import dense_inputs, joint_update, keep_of_kill

    x, P, sel, z, succ, offs = a3[:6]
    k3 = joint_update(*a3[:13], c)
    Hd, nu, R = dense_inputs(x.shape[0], sel, z, succ, offs)
    return (x, P, Hd, nu, R, succ.any(), keep_of_kill(k3[5])), k3


def k16_seeded(rng, p, dev, F=3, P=64, H=None, W=None):
    """K16 arguments on random maps with planted minima and particle clouds,
    and the degenerate particles: centres outside the image and far off it,
    a NaN centre, a NaN S^-1, an S^-1 with a - b^2 / c < 0, a particle with
    no admitted cell (a tiny ellipse between cells), dead particles, a
    planted three-way tie. H x W: the configuration's frame unless given."""
    H, W = H or p.cam_height, W or p.cam_width
    f = dict(dtype=torch.float32, device=dev)
    maps = torch.tensor(rng.uniform(0.0, 2.0, (F, H, W)), **f)
    for fi in range(F):
        for _ in range(60):
            maps[fi, rng.integers(0, H), rng.integers(0, W)] = float(rng.uniform(0, 0.3))
    h = torch.tensor(np.stack([rng.uniform(-5, W + 5, (F, P)), rng.uniform(-5, H + 5, (F, P))], -1), **f)
    a = rng.uniform(0.02, 0.4, (F, P))
    cc = rng.uniform(0.02, 0.4, (F, P))
    b = rng.uniform(-0.5, 0.5, (F, P)) * np.sqrt(a * cc)
    sinv = torch.tensor(np.stack([np.stack([a, b], -1), np.stack([b, cc], -1)], -2), **f)
    alive = torch.tensor(rng.uniform(size=(F, P)) > 0.2, device=dev)
    h[0, 0] = torch.tensor([-1e12, 5.0])
    h[0, 1] = torch.tensor([float("nan"), 50.0])
    h[0, 2] = torch.tensor([3e9, 3e9])
    h[0, 3] = torch.tensor([W + 40.0, -30.0])
    sinv[0, 4] = float("nan")
    sinv[0, 5] = torch.tensor([[1.0, 2.0], [2.0, 1.0]])
    sinv[0, 6] = torch.tensor([[400.0, 0.0], [0.0, 400.0]])
    h[0, 6] = torch.tensor([100.5, 100.5])
    alive[0, 7:10] = False
    sinv[1, :] = torch.tensor([[0.05, 0.0], [0.0, 0.05]])
    h[1, :] = torch.tensor([150.2, 120.7])
    maps[1, 118, 151] = maps[1, 121, 149] = maps[1, 120, 152] = -0.5
    maps[2, 60, 60] = float("nan")
    h[2, 0] = torch.tensor([60.0, 61.0])
    return maps, h, sinv, alive


def k16_more(rng, p, dev):
    """(label, args, kwargs) K16 cases past the configurations' windows:
    search radius 110 and 115 (231 x 231: the widest window K16 takes at
    320x240, whose band holds every row of the map; a window of all 240
    rows would need a band past the padded map, which the TPU kernel's
    slice and band_shape refuse) with half the ellipses wider than the
    window; 16 maps of 640x480 x 200 particles at hires' radius 52; and a
    cloud of wide ellipses spread over the whole 320x240 map, whose read
    box (about the map) exceeds the 16,384-cell stage: the in-place path."""
    from scenelib2_torch.eval.synthetic import HIRES_PARAMS

    kw = dict(no_sigma=p.no_sigma, corr_thresh2=p.corr_thresh2)
    out = [("R110", k16_seeded(rng, p, dev), dict(kw, win_radius=110))]
    a = k16_seeded(rng, p, dev)
    a[2][:, ::2] = torch.tensor([[1e-6, 0.0], [0.0, 1e-6]])
    out.append(("R115, every window cell in half the ellipses", a, dict(kw, win_radius=115)))
    out.append(("16 x 640x480 x 200", k16_seeded(rng, p, dev, F=16, P=200, H=480, W=640),
                dict(kw, win_radius=HIRES_PARAMS["particle_win_radius"])))
    F, P, H, W = 4, 100, p.cam_height, p.cam_width
    f = dict(dtype=torch.float32, device=dev)
    maps = torch.tensor(rng.uniform(0.0, 2.0, (F, H, W)), **f)
    h = torch.tensor(np.stack([rng.uniform(0, W, (F, P)), rng.uniform(0, H, (F, P))], -1), **f)
    sinv = torch.tensor(np.tile([[1e-4, 0.0], [0.0, 1e-4]], (F, P, 1, 1)), **f)   # half-extents 300: no cut
    alive = torch.tensor(rng.uniform(size=(F, P)) > 0.2, device=dev)
    R = p.particle_win_radius
    lo, hi = torch.clamp(torch.trunc(h) - R, min=0), torch.trunc(h) + R + 1
    box = (hi[..., 1].amax(1) - lo[..., 1].amin(1)) * (hi[..., 0].clamp(max=W).amax(1) - lo[..., 0].amin(1))
    if not bool((box > 16384).all()):
        fail(f"K16's spread cloud: a read box of {box.tolist()} cells fits the stage")
    out.append(("spread cloud (in place)", (maps, h, sinv, alive), dict(kw, win_radius=R)))
    return out


def check_k16(args, kw) -> float:
    from scenelib2_torch.kernels.multi_ellipse import multi_ellipse_search, multi_ellipse_search_plain

    got = multi_ellipse_search(*args, **kw)
    want = multi_ellipse_search_plain(*args, **kw)
    torch.cuda.synchronize()
    return compare_exact(got, want, ("found", "u", "v", "over"), "K16")


def k16_of_k13(a13):
    """K16's arguments (args, kwargs) on the maps and clouds of a K13 call,
    its lanes and slots flattened to slots."""
    maps, h, sinv, alive, c = a13
    Bn, Fn, H, W = maps.shape
    n = Bn * Fn
    return ((maps.reshape(n, H, W), h.reshape(n, -1, 2), sinv.reshape(n, -1, 2, 2), alive.reshape(n, -1)),
            dict(win_radius=c.win_radius, no_sigma=c.no_sigma, corr_thresh2=c.corr_thresh2))


def k16_against_k13(a13):
    """K16 on the maps and clouds of a K13 call (a captured step of the
    SCENELIB2_BATCH_SB=0 route): found and overflow equal everywhere, (u, v)
    equal for every live particle. Returns the dead particles whose (u, v)
    differ: K13 gives a dead particle no key by design, K16 searches it."""
    from scenelib2_torch.kernels.multi_ellipse import multi_ellipse_search
    from scenelib2_torch.kernels.particle_search import particle_search

    alive = a13[3]
    k13 = particle_search(*a13)
    a16, kw16 = k16_of_k13(a13)
    k16 = multi_ellipse_search(*a16, **kw16)
    torch.cuda.synchronize()
    k16 = [t.reshape(alive.shape) for t in k16]
    for name, i in (("found", 0), ("overflow", 3)):
        if not same(k16[i], k13[i]):
            fail(f"K16 and K13 decide {name} differently on a captured step")
    for name, i in (("u", 1), ("v", 2)):
        if not same(k16[i][alive], k13[i][alive]):
            fail(f"K16 and K13 give live particles a different {name} on a captured step")
    return int(((k16[1] != k13[1]) | (k16[2] != k13[2]))[~alive].sum())


def kernel_device_ms(fn, sym: str, n: int = 20):
    """Device time of one launch of the kernel named sym, from a traced loop
    of n calls of fn (torch.profiler); None if the profiler saw none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    hits = []
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and sym in e.key:
            us = getattr(e, "self_device_time_total", None)
            hits.append(((us if us is not None else e.self_cuda_time_total) / 1e3, e.count))
    return sum(h[0] for h in hits) / max(1, sum(h[1] for h in hits)) if hits else None


# ------------------------------------------------------------ large maps: the replays

# hires: BASELINE config 3 (eval/synthetic.py HIRES_PARAMS, HIRES_OVERRIDES);
# mf100: the std sequence at max_features 100. "at": the output indices whose
# kernel inputs are checked
LARGE_MAPS = {
    "hires": dict(n_frames=120, at=(9, 10, 37, 60)),   # making, a conversion, a light frame, later
    "mf100": dict(n_frames=240, at=(9, 20, 120)),      # the first init, the first conversion, later
}
N_REF_LARGE = 20   # CPU plain replay frames of each large-map path
N_TRACE_LARGE = 8  # frames of the traced window (the profiler's own bookkeeping grows with events)


def large_map_phase(tag: str, name: str, tmp: str, dev, rng) -> dict:
    """Phases 3c (hires) and 3d (mf100): the replay through
    MonoSLAM(device="cuda").run_sequence against its committed fingerprint
    with its launch counts, the eager loop up to the last frame of
    spec["at"], the kernels of its path against their plain versions on
    inputs captured from that loop, the CPU plain replay of
    its first frames, steps under sync debug mode "error", and its times."""
    from scenelib2_torch import MonoSLAM
    from scenelib2_torch.config import Params
    from scenelib2_torch.eval.fingerprint import decisions_fingerprint, load_expected
    from scenelib2_torch.eval.synthetic import HIRES_OVERRIDES, HIRES_PARAMS, generate_dataset
    from scenelib2_torch.kernels import (
        _build, chol_inv, ekf_update, measure, predict_measure, search, search_bayes)

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
    slam._run_sequence_eager(seq[:8], enable_mapping=True)   # warm-up
    torch.cuda.synchronize()

    # the main path: counts zeroed just before, read just after; the kernel
    # inputs of the frames in spec["at"] kept, and every launch's inputs for
    # its cost (the first wrapper of a frame is K1 on the fused route, K7 on
    # the split one)
    first = "predict_measure" if D <= 384 else "measure_select"
    seen, calls, frame = {}, {}, [-1]

    def keep(n, a, k):
        if n == first:
            frame[0] += 1
        if frame[0] in spec["at"]:
            seen.setdefault(frame[0], {})[n] = (a, k)
        calls.setdefault(n, []).append((a, k))

    # the eager loop runs the frames up to the last captured one; the graph
    # replay (graph_cell) runs them all and holds the fingerprint
    n_eager = min(n_run, max(spec["at"]) + 1)
    t0 = time.perf_counter()
    outs, launches, state_eager = run_main_path(slam, seq[:n_eager], mapping=True, on_call=keep)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    want = load_expected(f"expected_fingerprint_{name}")
    fps = []

    def check_fp(o):
        fp_ = decisions_fingerprint(o, n_run)
        log(f"[{tag}] fingerprint ({name}, graph replay): {json.dumps(fp_)}")
        for k in ("n_frames", "matched_sum", "inits", "convs", "active_end", "decisions_sha256"):
            if fp_[k] != want[k]:
                fail(f"{name} field {k}: got {fp_[k]}, expected {want[k]}")
        fps.append(fp_)

    for n in _build.KERNELS:
        if launches.get(n, 0) != (n_eager if n in path else 0):
            fail(f"kernel {n} launched {launches.get(n, 0)} times on the {name} path, expected "
                 f"{n_eager if n in path else 0}")
    log(f"[{tag}] launches on the {name} path (eager loop, frames 1..{n_eager}, {eager_s:.2f} s): "
        f"{json.dumps(launches)}")
    r = outs.r.numpy()
    if r.shape != (n_eager, 3) or not np.isfinite(r).all():
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
            a7, _ = c["measure_select"]
            worse("K7", check_k7(a7[:5], a7[6], a7[5]))
            worse("K2", check_k2_lanes(a2, sc))
            worse("K14", check_k14(c["chol_inv"][0][0]))
        for _label, args in k4_variations(c["search_bayes"][0], rng, H, W, B,
                                          p.erase_partial_after_attempts):
            worse("K4", check_k4(args))
        a6, kw6 = c["shi_tomasi"]
        for _label, args in k6_variations(tuple(a6) + (kw6,), rng, H, W):
            worse("K6", check_k6(args))
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

    # the graph replay against the eager loop; times, busy, idle, peak memory
    run, run_eager = single_runs(slam, seq, True)
    g = graph_cell(tag, name, run, run_eager, slam._graphs, n_run, path, (outs, state_eager), check_fp,
                   trace_n=min(N_TRACE_LARGE, n_run), eager_s=eager_s, eager_n=n_eager)
    fp = fps[0]
    launches = g["launches"]
    prof = g["prof"]
    res = dict(g, ms_frame=g["graph_ms"])
    del res["prof"]

    def dev_ms(sym):
        return kernel_dev_ms(prof, sym)

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
        costs["K2"].append(search.bytes_and_flops(a[2].numel(), sc, admit))
    for a, _k in calls["search_bayes"]:
        MF, NP = a[1].shape
        costs["K4"].append(search_bayes.bytes_and_flops(MF, NP, H, W, B, *search_bayes.work_counts(*on_cpu(a))))
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
        a7, _ = c["measure_select"]
        kern["K7"] = (lambda: measure.measure_select(*a7), lambda: measure.measure_select_plain(*a7),
                      "k7_kernel")
        costs["K7"] = [measure.bytes_and_flops(*a[0].shape, a[3].shape[1], a[5])
                       for a, _k in calls["measure_select"]]
        S = c["chol_inv"][0][0]
        eye = torch.eye(S.shape[-1], device=dev)
        kern["K14"] = (lambda: chol_inv.chol_inv(S), lambda: chol_inv.chol_linv(S), "k14_")
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
                              max_abs_err=errs[short], launches=launches[KERNEL_OF[short]],
                              launches_steps=g["launches_steps"],
                              launches_captured=g["captured"].get(KERNEL_OF[short], 0))
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


# ------------------------------------------------------------ 3f: batch lanes at the hires configuration

# the committed batch-hires replay (scenelib2_torch/data/expected_fingerprint_batch_hires.json):
# 16 lanes = 8 hires textures x 2 phase offsets, 39 frames a lane
N_HIRES_LANES, N_HIRES_TEXTURES, N_HIRES_FRAMES = 16, 8, 40
HIRES_AT = (9, 20)                     # output indices whose kernel inputs are checked and timed
HIRES_REF_LANES, N_HIRES_REF = (0, 4), 10
HIRES_TRACED_STEPS = 4


def batch_hires_phase(tmp: str, dev, rng) -> dict:
    """Phase 3f: the default batch route at BASELINE config 3 (200
    particles: K10's rows and K11's rows 256 lanes wide): the route's kernels
    against their plain versions on captured steps, the replay against the
    committed per-lane fingerprints with its launch counts, a CPU plain
    replay of two lanes, 30 steps under sync debug mode "error", ms a step,
    aggregate frames/s, a traced window and peak device memory."""
    import traceback

    from scenelib2_torch.eval.batch import check_lanes, lane_fingerprints, make_lanes
    from scenelib2_torch.kernels import _build, measure, particle, score_map, search, search_bayes, shi_tomasi
    from scenelib2_torch.kernels.measure import MeasureConsts
    from scenelib2_torch.parallel.mesh import _run_batch_eager, make_batched_step, run_batch
    from scenelib2_torch.runtime.state import SlamState

    t0 = time.time()
    params, states0, frames = make_lanes(tmp, N_HIRES_LANES, N_HIRES_TEXTURES, N_HIRES_FRAMES, device=dev,
                                         dtype=torch.float32, config="hires")
    seq = torch.as_tensor(frames).to(dev)
    T, Bn = seq.shape[:2]
    p = params
    log(f"[3f] batch-hires: {Bn} lanes ({N_HIRES_TEXTURES} hires textures x {Bn // N_HIRES_TEXTURES} offsets) x "
        f"{T} frames at {p.cam_width}x{p.cam_height}, max_features {p.max_features}, {p.n_particles} particles, "
        f"particle radius {p.particle_win_radius}; rendered in {time.time() - t0:.1f} s")
    step = make_batched_step(params, device="cuda")
    mc, sc = MeasureConsts.from_params(p), search.SearchConsts.from_params(p)
    smc, sbc = score_map.ScoreMapConsts.from_params(p), search_bayes.SearchBayesConsts.from_params(p)

    seen, cur = {}, {}

    def keep(n, a, k):
        if n == "search_bayes_maps":       # the maps live in the step's workspace
            a = (a[0].clone(),) + tuple(a[1:])
        cur[n] = (a, k)

    with observe_wrappers(keep):
        st_b = states0
        for t in range(max(HIRES_AT) + 1):
            cur.clear()
            st_b, _o = step(st_b, seq[t], True)
            if t in HIRES_AT:
                seen[t] = dict(cur)
    torch.cuda.synchronize()
    errs = {k: 0.0 for k in ("K7", "K9", "K10", "K11", "K2 lanes", "K6 lanes")}
    making = 0
    for at in HIRES_AT:
        c = seen[at]
        a7 = c["measure_select"][0]
        errs["K7"] = max(errs["K7"], check_k7(a7[:5], mc, a7[5]))
        errs["K9"] = max(errs["K9"], check_k9(c["score_map"][0][0], c["score_map"][0][1], smc))
        a10 = c["particle_predict"][0]
        got10, want10 = particle.particle_predict(*a10), particle.particle_predict_plain(*a10)
        torch.cuda.synchronize()
        if got10.shape[-1] != 256 or not same_floats(got10, want10):
            fail(f"[3f] K10's 256-lane rows differ from the plain version (max abs err {max_err(got10, want10)})")
        a11 = c["search_bayes_maps"][0]
        errs["K11"] = max(errs["K11"], compare_sb(search_bayes.search_bayes_maps(*a11),
                                                  search_bayes.search_bayes_maps_plain(*a11),
                                                  "K11 at 200 particles"))
        errs["K2 lanes"] = max(errs["K2 lanes"], check_k2_lanes(c["search"][0], sc))
        for _label, (a6l, kw6l) in k6_lane_variations(*c["shi_tomasi"], rng):
            errs["K6 lanes"] = max(errs["K6 lanes"], check_k6_lanes(a6l, kw6l))
        making += int(a11[5].sum())
    if making == 0:
        fail("[3f] no lane searches a partial feature at the captured steps")
    log(f"[3f] the route's kernels equal their plain versions on whole {Bn}-lane steps at output indices "
        f"{HIRES_AT} ({making} lane-slots making; K10's rows 256 lanes wide) (max abs err {json.dumps(errs)})")

    costs = {k: [] for k in ("K7", "K10", "K11", "K2 lanes", "K6 lanes")}
    k11_args = []

    def record(n, a, k):
        if n == "measure_select":
            costs["K7"].append(measure.bytes_and_flops(*a[0].shape, a[3].shape[1], a[5]))
        elif n == "particle_predict":
            costs["K10"].append(particle.bytes_and_flops(*a[2].shape))
        elif n == "search_bayes_maps":
            k11_args.append((a[1], a[4], a[5]))
        elif n == "search":
            admit = search.candidate_geometry(a[2].reshape(-1), a[3].reshape(-1), a[4].reshape(-1),
                                              a[5].reshape(-1), a[6].reshape(-1, 3), sc)[0]
            costs["K2 lanes"].append(search.bytes_and_flops(a[2].numel(), sc, admit))
        elif n == "shi_tomasi":
            b_, f_ = shi_tomasi.bytes_and_flops(k["boxsize"], k["region_w"], k["region_h"])
            costs["K6 lanes"].append((b_ * a[0].shape[0], f_ * a[0].shape[0]))

    torch.cuda.synchronize()
    _build.reset_launches()
    with observe_wrappers(record):
        st_eager, outs = _run_batch_eager(step, states0, seq, True, params)
    launches = dict(_build.launches)

    def check_fp(o):
        bad = check_lanes(lane_fingerprints(o), config="hires")
        if bad:
            fail(f"[3f] {len(bad)} of {Bn} lane fingerprints differ from the committed file:\n" + "\n".join(bad[:6]))

    check_fp(outs)
    fps = lane_fingerprints(outs)
    for n in _build.KERNELS:
        want = T if n in BATCH_PATH else 0
        if launches.get(n, 0) != want:
            fail(f"kernel {n} launched {launches.get(n, 0)} times on the batch-hires path, expected {want}")
    log(f"[3f] all {Bn} per-lane fingerprints equal expected_fingerprint_batch_hires.json "
        f"({sum(f_['inits'] for f_ in fps)} inits, {sum(f_['convs'] for f_ in fps)} conversions, "
        f"{sum(f_['matched_sum'] for f_ in fps)} matches); launches ({T} steps of {Bn} lanes, eager loop): "
        f"{json.dumps(launches)}")
    rb = outs.r.numpy()
    if rb.shape != (T, Bn, 3) or not np.isfinite(rb).all():
        fail(f"[3f] trajectories not finite/shaped: {rb.shape}")
    for pr_, al_, mk_ in k11_args:
        costs["K11"].append(search_bayes.bytes_and_flops_maps(
            Bn, 1, p.n_particles, *search_bayes.work_counts_maps(*on_cpu((pr_, al_, mk_)), sbc)))

    # reference on a small input: two lanes replayed by the CPU plain versions
    idx = list(HIRES_REF_LANES)
    cpu_states = SlamState(*(t[idx].cpu() for t in states0))
    _s, ref = run_batch(make_batched_step(params, device="cpu"), cpu_states, frames[:N_HIRES_REF, idx], True,
                        params)
    for k in ("n_visible", "n_selected", "n_matched", "n_active", "n_partial", "did_init", "did_convert",
              "n_overflow", "sel_matched", "init_box", "par_alive"):
        if not torch.equal(getattr(ref, k), getattr(outs, k)[:N_HIRES_REF, idx]):
            fail(f"[3f] CUDA vs CPU plain replay: {k} differs in lanes {idx}")
    dx = float((ref.xv.double() - outs.xv[:N_HIRES_REF, idx].double()).abs().max())
    if dx > STEP_TOL:
        fail(f"[3f] CUDA vs CPU plain replay: xv differs by {dx}")
    log(f"[3f] lanes {idx} equal their CPU plain replay on frames 1..{N_HIRES_REF} (max |dxv| {dx:.3g})")

    st_b = states0
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for t in range(N_REF):
            st_b, _o = step(st_b, seq[t], True)
    except RuntimeError:
        fail(f"the batch-hires step synchronised with the host:\n{traceback.format_exc()}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log(f"[3f] {N_REF} batch-hires steps ran with torch.cuda.set_sync_debug_mode('error'): no host synchronisation")

    run, run_eager = batch_runs(step, states0, seq, params)
    g = graph_cell("3f", "batch-hires", run, run_eager, step.graphs, T, BATCH_PATH, (outs, st_eager), check_fp,
                   trace_n=HIRES_TRACED_STEPS)
    launches = g["launches"]
    res = {k: v for k, v in g.items() if k != "prof"}
    res.update(lanes=Bn, frames_per_lane=T, frames_per_s=Bn / g["graph_ms"] * 1e3,
               frames_per_s_eager=Bn / g["eager_ms"] * 1e3, errs=errs)
    log(f"[3f] batch-hires: {res['frames_per_s']:.1f} aggregate frames/s through the graph "
        f"({res['frames_per_s_eager']:.1f} eager)")

    def dev_ms(sym):
        return kernel_dev_ms(g["prof"], sym)

    # K10's and K11's times at 200 particles and K2's and K6's over the 16
    # lanes of 640x480 frames, on the output-index-20 inputs
    a10, a11 = seen[20]["particle_predict"][0], seen[20]["search_bayes_maps"][0]
    a2, a7 = seen[20]["search"][0], seen[20]["measure_select"][0]
    a6, kw6 = seen[20]["shi_tomasi"]
    timings = {}
    for short, fk, fp_, sym, lname, what in (
        ("K7", lambda: measure.measure_select(*a7), lambda: measure.measure_select_plain(*a7), "k7_kernel",
         "measure", f"over {Bn} lanes x {p.max_features} slots"),
        ("K10", lambda: particle.particle_predict(*a10), lambda: particle.particle_predict_plain(*a10), "k10_kernel",
         "particle_predict", "at 200 particles"),
        ("K11", lambda: search_bayes.search_bayes_maps(*a11), lambda: search_bayes.search_bayes_maps_plain(*a11),
         "k11_kernel", "search_bayes_maps", "at 200 particles"),
        ("K2 lanes", lambda: search.search(*a2[:8], sc), lambda: search_lanes_plain(a2, sc), "k2_kernel", "search",
         f"over {Bn} lanes of 640x480"),
        ("K6 lanes", lambda: shi_tomasi.shi_tomasi(*a6, **kw6),
         lambda: lanes_of(lambda b: shi_tomasi.shi_tomasi_plain(*(t[b] for t in a6), **kw6), Bn), "k6_kernel",
         "shi_tomasi", f"over {Bn} lanes of 640x480"),
    ):
        b_ms, b_by = bound(costs[short])
        timings[short] = dict(ms=time_ms(fk, n=50, batches=3), plain_ms=time_ms(fp_, n=2, batches=3),
                              device_ms=dev_ms(sym), bound_ms=b_ms, bound_by=b_by, library_ms=None,
                              launches=launches[lname], launches_steps=g["launches_steps"],
                              launches_captured=g["captured"].get(lname, 0), max_abs_err=errs[short])
        log(f"[3f] {short} {what}: {json.dumps(timings[short])}")
    res["timings"] = timings
    return res


# ------------------------------------------------------------ 3g: the entry points

N_MF100_CALLS = 40    # go_one_step calls on mf100 (the split route, K14), timed graph and eager
N_ALTERNATE = 10      # go_one_step calls alternating mapping off and on
EP_DECISIONS = ("n_visible", "n_selected", "n_matched", "n_active", "n_partial", "did_init", "did_convert")
BENCH_CELLS = ("testseq", "autoinit", "hires", "hires_r48", "batch64")
# the two hires cells and their files: JAX's bench_hires (radii 32 / 32) and the radii 48 / 52
HIRES_BENCH_FILES = {"fps_640x480_60feat": "expected_fingerprint_hires_bench",
                     "fps_640x480_60feat_r48": "expected_fingerprint_hires"}


def cache_root(tmp: str) -> str:
    """The temporary directory of phase 3g's subprocesses: the rendered
    sequences and lanes they read (3b renders its lanes there)."""
    return os.path.join(tmp, "cache")


def go_calls(slam, frames, n: int, mapping, graph: bool):
    """go_one_step on frames[1 .. n] (the graph path, or its eager reference
    _go_one_step_eager): (packed rows [n, K] on the device, host ms of each
    call, the trajectory fetch included). mapping is a bool or a function of
    the frame index."""
    call = slam.go_one_step if graph else slam._go_one_step_eager
    rows, ms = [], []
    for t in range(1, n + 1):
        em = mapping(t) if callable(mapping) else mapping
        t0 = time.perf_counter()
        call(frames[t], True, em)
        ms.append((time.perf_counter() - t0) * 1e3)
        rows.append(step_pack(slam.last_output))
    return torch.stack(rows), ms


def step_pack(out):
    from scenelib2_torch.runtime.step import pack_outputs

    return pack_outputs(out)


def unpack_rows(rows, p):
    from scenelib2_torch.runtime.step import unpack_outputs

    return unpack_outputs(rows.cpu(), p.n_features_to_select, max(1, p.max_features_to_init_at_once),
                          p.n_particles)


def facade_script(slam, call, frames, xp, work: str, probe: dict | None = None):
    """Phase 3g(b)'s facade calls between steps; call(slam, frame) steps.
    Returns (tag, return value, packed row or None, state) after every call.
    probe, where given, receives the kernel wrappers' arguments and the
    launch counts of the initialise_auto_feature call."""
    from scenelib2_torch.kernels import _build

    recs, f = [], [1]

    def rec(tag, ret=None, row=None):
        recs.append((tag, ret, row, tuple(t.clone() for t in slam.state)))

    def steps(n, tag):
        for _ in range(n):
            call(slam, frames[f[0]])
            rec(f"{tag} frame {f[0]}", None, step_pack(slam.last_output))
            f[0] += 1

    steps(10, "steps 1")
    rec("initialise_feature", slam.initialise_feature(frames[10], 160, 120))
    if probe is not None:
        torch.cuda.synchronize()
        _build.reset_launches()
        with observe_wrappers(lambda n, a, k: probe.setdefault("calls", {}).__setitem__(n, (a, k))):
            did = slam.initialise_auto_feature(frames[10])
        probe["launches"] = dict(_build.launches)
    else:
        did = slam.initialise_auto_feature(frames[10])
    rec("initialise_auto_feature", did)
    slam.mark_feature_by_lab(1)
    rec("delete_feature", slam.delete_feature())
    slam.add_new_known_feature(np.array([0.05, -0.02, 0.0]), xp, frames[10][100:111, 150:161])
    rec("add_new_known_feature")
    steps(10, "steps 2")
    slam.save_checkpoint(os.path.join(work, "facade.npz"))
    steps(5, "steps 3")
    slam.load_checkpoint(os.path.join(work, "facade.npz"))
    rec("load_checkpoint")
    f[0] -= 5
    steps(5, "steps 3 again")
    slam.mark_feature_by_lab(2)
    slam.reset()
    rec("reset", slam.marked_feature_label)
    f[0] = 1
    steps(5, "after reset")
    return recs


def entry_points_phase(tmp: str, dev, frames, gt_r, gt_q, cfg: str, outs_eager, state_eager, smi: str) -> dict:
    """Phase 3g: the entry points users start the system through.
    (a) go_one_step through the one-step graph over the 239-frame std
        sequence, mapping on: its fingerprint, every packed row and the final
        state bit for bit with the eager step and with phase 3's eager
        replay, one graph captured (each kernel of the path counted twice:
        the capture and its warm-up step); mapping off and on alternately
        (two graphs, bit for bit with the eager step) and beside
        run_sequence's block graph within replay.MAX_GRAPHS; ms a call
        through the graph and eagerly, std-mapping and 40 frames of mf100;
    (b) facade calls between steps on the card through the graph, bit for bit
        with the same script through the eager step, and against the CPU
        port (decisions and bookkeeping identical, x and P within STEP_TOL);
        initialise_auto_feature launches K5 and K6 once each and nothing
        else, and both equal their plain versions on its inputs;
    (c) `cli selftest` returns 0, and 1 on a copy of the expected file with
        matched_sum changed by one;
    (d) `cli run --mapping --checkpoint` on a PGM directory of the frames,
        read by the native grabber (built by make): its decisions are (a)'s
        and its checkpoint is (a)'s final state; `cli print-state` reads it;
    (e) `cli bench testseq autoinit hires hires_r48 batch64`: each cell's timed replay
        reproduces its committed fingerprint."""
    from scenelib2_torch import MonoSLAM
    from scenelib2_torch.convert import state_to_numpy
    from scenelib2_torch.eval.fingerprint import decisions_fingerprint, load_expected, selection_set
    from scenelib2_torch.eval.selftest import EXPECTED_PATH, std_dataset
    from scenelib2_torch.kernels import _build
    from scenelib2_torch.runtime import replay
    from scenelib2_torch.runtime.step import pack_outputs

    t_phase = time.time()
    res = {}
    n_run = len(frames) - 1

    # ---- (a) go_one_step through the one-step graph
    slam = MonoSLAM(cfg, max_features=16, device="cuda")
    p = slam.params
    torch.cuda.synchronize()
    _build.reset_launches()
    rows_g, ms_g = go_calls(slam, frames, n_run, True, graph=True)
    launches_g = dict(_build.launches)
    keys = list(slam._graphs)
    if len(keys) != 1 or keys[0][1:3] != (True, 1):
        fail(f"go_one_step with mapping on captured the graphs {[k[:3] for k in keys]}, expected one one-step graph")
    for n in _build.KERNELS:
        if launches_g.get(n, 0) != (2 if n in SINGLE_PATH else 0):
            fail(f"go_one_step x {n_run}: kernel {n} counted {launches_g.get(n, 0)} launches, expected "
                 f"{2 if n in SINGLE_PATH else 0} (one capture and its warm-up step)")
    outs_g = unpack_rows(rows_g, p)
    fp = decisions_fingerprint(outs_g, n_run)
    want = load_expected("expected_fingerprint")
    if any(fp[k] != want[k] for k in fp):
        fail(f"go_one_step through the graph: fingerprint {fp} differs from expected_fingerprint.json {want}")
    eager = MonoSLAM(cfg, max_features=16, device="cuda")
    rows_e, ms_e = go_calls(eager, frames, n_run, True, graph=False)
    if not same_bits_or_nan(rows_g, rows_e):
        fail("go_one_step through the graph: packed rows differ from the eager step's")
    if not outputs_identical(slam.state, eager.state):
        fail("go_one_step through the graph: final state differs from the eager step's")
    if not same_bits_or_nan(rows_g.cpu(), pack_outputs(outs_eager)):
        fail("go_one_step through the graph: packed rows differ from phase 3's eager replay")
    if not outputs_identical(slam.state, state_eager):
        fail("go_one_step through the graph: final state differs from phase 3's eager replay")
    if not np.array_equal(slam.trajectory(), outs_g.r.numpy()):
        fail("go_one_step through the graph: the trajectory store differs from the steps' positions")
    state_a = slam.state
    log(f"[3g] go_one_step x {n_run} through the one-step graph (mapping on): fingerprint {json.dumps(fp)} "
        f"equals expected_fingerprint.json; packed rows and final state bit for bit with the eager step "
        f"and with phase 3's eager replay; one graph captured; launches {json.dumps(launches_g)}")

    # mapping off and on alternately: one more graph, beside run_sequence's block graph
    alt = lambda t: t % 2 == 0  # noqa: E731
    slam.reset()
    eager.reset()
    rows_ga, _ = go_calls(slam, frames, N_ALTERNATE, alt, graph=True)
    rows_ea, _ = go_calls(eager, frames, N_ALTERNATE, alt, graph=False)
    if not (same_bits_or_nan(rows_ga, rows_ea) and outputs_identical(slam.state, eager.state)):
        fail("go_one_step alternating mapping off and on: the graph path differs from the eager step")
    one_step = {k for k in slam._graphs if k[2] == 1}
    if sorted(k[1] for k in one_step) != [False, True] or len(slam._graphs) != 2:
        fail(f"go_one_step alternating mapping: graphs {[k[:3] for k in slam._graphs]}, expected one a mapping value")
    slam.reset()
    slam.run_sequence(frames[1:12], enable_mapping=True)           # a block of 8 and 3 one-step replays
    if not (one_step <= set(slam._graphs) and len(slam._graphs) == 3 <= replay.MAX_GRAPHS):
        fail(f"run_sequence beside go_one_step's graphs: {[k[:3] for k in slam._graphs]}")
    log(f"[3g] {N_ALTERNATE} calls alternating mapping off and on: bit for bit with the eager step, one "
        f"graph a mapping value; run_sequence then reuses the one-step graph and adds its block graph "
        f"({len(slam._graphs)} of MAX_GRAPHS = {replay.MAX_GRAPHS})")

    big = MonoSLAM(cfg, max_features=100, device="cuda")
    rows_bg, ms_bg = go_calls(big, frames, N_MF100_CALLS, True, graph=True)
    big.reset()
    rows_be, ms_be = go_calls(big, frames, N_MF100_CALLS, True, graph=False)
    if not same_bits_or_nan(rows_bg, rows_be):
        fail("mf100 go_one_step through the graph: packed rows differ from the eager step's")
    per_call = {}
    for cell, g_ms, e_ms in (("std-mapping", ms_g, ms_e), ("mf100", ms_bg, ms_be)):
        per_call[cell] = dict(graph_ms=statistics.median(g_ms[1:]), eager_ms=statistics.median(e_ms[1:]),
                              first_call_ms=g_ms[0], calls=len(g_ms), card=smi)
        log(f"[3g] {cell}: go_one_step {per_call[cell]['graph_ms']:.4f} ms a call through the graph, "
            f"{per_call[cell]['eager_ms']:.4f} ms eagerly (median of calls 2..{len(g_ms)}, host wall with "
            f"the frame upload and the trajectory fetch; the first graph call {g_ms[0]:.1f} ms, its "
            f"capture included) on {smi}")
    res["per_call"] = per_call

    # ---- (b) facade calls between steps
    xp = np.concatenate([gt_r[10], gt_q[10]])
    works = {k: os.path.join(tmp, f"facade_{k}") for k in ("graph", "eager", "cpu")}
    for w_ in works.values():
        os.makedirs(w_, exist_ok=True)
    probe = {}
    fg = facade_script(MonoSLAM(cfg, max_features=16, device="cuda"), lambda s_, f_: s_.go_one_step(f_),
                       frames, xp, works["graph"], probe)
    fe = facade_script(MonoSLAM(cfg, max_features=16, device="cuda"), lambda s_, f_: s_._go_one_step_eager(f_),
                       frames, xp, works["eager"])
    fc = facade_script(MonoSLAM(cfg, max_features=16, device="cpu"), lambda s_, f_: s_.go_one_step(f_),
                       frames, xp, works["cpu"])
    fields = list(state_a._fields)
    exact = [fields.index(k) for k in ("active", "full", "label", "patches", "attempts", "successes", "rng")]
    dmax = 0.0
    for (tag, rg, wg, sg), (_t, re_, we, se), (_t2, rc, wc, sc_) in zip(fg, fe, fc):
        if rg != re_ or rg != rc:
            fail(f"facade script, {tag}: returned {rg} through the graph, {re_} eagerly, {rc} on the CPU")
        if (wg is None) != (we is None) or (wg is not None and not same_bits_or_nan(wg, we)):
            fail(f"facade script, {tag}: the graph's packed row differs from the eager step's")
        if not outputs_identical(sg, se):
            fail(f"facade script, {tag}: the state through the graph differs from the eager step's")
        for i in exact:
            if not same(sg[i], sc_[i]):
                fail(f"facade script, {tag}: {fields[i]} differs from the CPU port's")
        for k in ("x", "P"):
            d = max_err(sg[fields.index(k)], sc_[fields.index(k)])
            dmax = max(dmax, d)
            if d > STEP_TOL:
                fail(f"facade script, {tag}: {k} differs from the CPU port's by {d}")
        if wg is not None:
            og, oc = unpack_rows(wg[None], p), unpack_rows(wc[None], p)
            for k in EP_DECISIONS + ("n_overflow",):
                if not same(getattr(og, k), getattr(oc, k)):
                    fail(f"facade script, {tag}: {k} differs from the CPU port's")
            if not np.array_equal(selection_set(og), selection_set(oc)):
                fail(f"facade script, {tag}: the selection differs from the CPU port's")
    rets = {t_: r_ for t_, r_, _w, _s in fg if r_ is not None}
    if not (rets["initialise_feature"] and rets["delete_feature"] and rets["reset"] == -1):
        fail(f"facade script: the calls did not do what the script asks: {rets}")
    want5 = {n: (1 if n in ("propose", "shi_tomasi") else 0) for n in _build.KERNELS}
    if probe["launches"] != want5:
        fail(f"initialise_auto_feature launched {probe['launches']}, expected K5 and K6 once each")
    a5, _ = probe["calls"]["propose_region"]
    a6, kw6 = probe["calls"]["shi_tomasi"]
    check_k5(a5)
    e6 = check_k6(tuple(a6) + (kw6,))
    res["facade"] = dict(calls=len(fg), returns=rets, max_dx_cpu=dmax, manual_init_launches=probe["launches"])
    log(f"[3g] facade script ({len(fg)} calls: steps, initialise_feature, initialise_auto_feature, "
        f"delete_feature, add_new_known_feature, save/load_checkpoint, reset): through the graph bit for "
        f"bit with the eager step, against the CPU port decisions identical (max |dx|, |dP| {dmax:.3g}); "
        f"returns {json.dumps(rets)}; initialise_auto_feature launched K5 and K6 once each, both equal "
        f"their plain versions on its inputs (K6 evbest max abs err {e6})")

    # ---- (c) + (d): selftest and cli run, side by side in subprocesses
    root = cache_root(tmp)
    os.makedirs(root, exist_ok=True)
    std_dataset(len(frames), root=root)          # rendered once for every subprocess
    # the subprocesses launch kernels from one host thread each: no intra-op thread pools beside them
    env = dict(os.environ, TMPDIR=root, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    with open(EXPECTED_PATH) as f_:
        bad = json.load(f_)
    bad["matched_sum"] += 1
    bad_path = os.path.join(tmp, "expected_matched_sum_plus_one.json")
    with open(bad_path, "w") as f_:
        json.dump(bad, f_)
    mk = subprocess.run(["make", "-C", os.path.join(REPO, "native"), "-s", "-B", "libframegrabber.so"],
                        capture_output=True, text=True, timeout=300)
    if mk.returncode != 0:
        fail(f"make -C native failed: {mk.stderr[-2000:]}")
    print(f"# native grabber: native/libframegrabber.so built by make in this run ({os.path.join(REPO, 'native')})",
          flush=True)
    from scenelib2_torch.io import native
    from scenelib2_torch.io.pgm import write_pgm
    from scenelib2_torch.io.sequence import ImageSequence

    seq_dir = os.path.join(tmp, "pgm_seq")
    os.makedirs(seq_dir, exist_ok=True)
    for i, fr in enumerate(frames):
        write_pgm(os.path.join(seq_dir, f"frame_{i:04d}.pgm"), fr)
    if not native.available() or ImageSequence(seq_dir)._native is None:
        fail("ImageSequence does not read the PGM directory through the native grabber")
    run_dir = os.path.join(tmp, "cli_run")
    cli = [sys.executable, "-m", "scenelib2_torch.cli"]
    procs = {
        "selftest": subprocess.Popen(cli + ["selftest"], cwd=REPO, env=env, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True),
        "selftest (matched_sum + 1)": subprocess.Popen(cli + ["selftest", "--expected", bad_path], cwd=REPO, env=env,
                                                       stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
        "run": subprocess.Popen(cli + ["run", "--config", cfg, "--seq", seq_dir, "--out", run_dir, "--mapping",
                                       "--checkpoint"], cwd=REPO, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True),
    }
    hires_t0 = time.time()
    from scenelib2_torch.config import Params
    from scenelib2_torch.eval.synthetic import HIRES_PARAMS

    std_dataset(120, params=Params(**HIRES_PARAMS), tag="hires", root=root)   # for (e), meanwhile
    hires_s = time.time() - hires_t0
    done = {}
    for name, pr in procs.items():
        try:
            out_, err_ = pr.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs.values():
                q.kill()
            fail(f"cli {name} did not finish in 600 s")
        done[name] = (pr.returncode, out_, err_)
        for line in err_.splitlines():
            if line.startswith("#"):
                print(f"# cli {name}: {line[1:].strip()}", flush=True)
    want_rc = {"selftest": 0, "selftest (matched_sum + 1)": 1, "run": 0}
    for name, (rc, out_, err_) in done.items():
        if rc != want_rc[name]:
            fail(f"cli {name} exited {rc}, expected {want_rc[name]}:\n{out_[-1500:]}\n{err_[-3000:]}")
    if "native grabber" not in done["run"][2]:
        fail("cli run did not read its frames through the native grabber")
    with open(os.path.join(run_dir, "metrics.jsonl")) as f_:
        metrics = [json.loads(line) for line in f_]
    if len(metrics) != n_run:
        fail(f"cli run wrote {len(metrics)} metrics lines, expected {n_run}")
    for k in EP_DECISIONS:
        got_k = np.array([m[k] for m in metrics], dtype=np.int64)
        if not np.array_equal(got_k, getattr(outs_g, k).numpy().astype(np.int64)):
            fail(f"cli run: {k} differs from go_one_step's in phase 3g(a)")
    with np.load(os.path.join(run_dir, "final_state.npz")) as z:
        ck = {k[len("state_"):]: z[k] for k in z.files}
    for k, v in state_to_numpy(state_a).items():
        if not np.array_equal(ck[k], v, equal_nan=v.dtype.kind == "f"):
            fail(f"cli run's checkpoint field {k} differs from phase 3g(a)'s final state")
    ps = subprocess.run(cli + ["print-state", "--config", cfg, "--checkpoint",
                               os.path.join(run_dir, "final_state.npz")],
                        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    if ps.returncode != 0 or not ps.stdout.startswith("[Robot state]"):
        fail(f"cli print-state failed ({ps.returncode}): {ps.stdout[-500:]} {ps.stderr[-2000:]}")
    n_rows = sum(1 for line in ps.stdout.splitlines() if line.startswith("{'slot'"))
    if n_rows != int(state_a.active.sum()):
        fail(f"cli print-state listed {n_rows} features, the checkpoint holds {int(state_a.active.sum())}")
    res["cli"] = dict(selftest_rc=done["selftest"][0], selftest_altered_rc=done["selftest (matched_sum + 1)"][0],
                      run_frames=len(metrics), run_summary=json.loads(done["run"][1].strip().splitlines()[-1]))
    log(f"[3g] cli selftest exited 0 ({done['selftest'][1].strip()}), and 1 on a copy of the expected file "
        f"with matched_sum + 1; cli run --mapping --checkpoint read {len(metrics)} + 1 PGM frames through the "
        f"native grabber: decisions equal go_one_step's, checkpoint equal to its final state; cli print-state "
        f"read the checkpoint ({n_rows} features); hires sequence rendered meanwhile in {hires_s:.1f} s")

    # ---- (e) the bench suite
    b = subprocess.run(cli + ["bench", *BENCH_CELLS], cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=900)
    if b.returncode != 0:
        fail(f"cli bench exited {b.returncode}: {b.stdout[-1500:]} {b.stderr[-3000:]}")
    bench = {}
    for line in b.stdout.strip().splitlines():
        r_ = json.loads(line)
        print(line, flush=True)
        bench[r_["metric"]] = r_
    if len(bench) != len(BENCH_CELLS):
        fail(f"cli bench printed {len(bench)} results, expected {len(BENCH_CELLS)}")
    for r_ in bench.values():
        if "lanes_differing" in r_:
            if r_["lanes_differing"]:
                fail(f"bench {r_['metric']}: lanes differ from {r_['fingerprint_file']}: {r_['lanes_differing'][:4]}")
        else:
            want_fp = {k: v for k, v in load_expected(r_["fingerprint_file"]).items() if k != "dataset_version"}
            if r_["fingerprint"] != want_fp:
                fail(f"bench {r_['metric']}: fingerprint {r_['fingerprint']} differs from {r_['fingerprint_file']}")
    for metric, fp_file in HIRES_BENCH_FILES.items():
        if bench.get(metric, {}).get("fingerprint_file") != fp_file:
            fail(f"bench {metric}: held to {bench.get(metric, {}).get('fingerprint_file')}, expected {fp_file}")
    res["bench"] = {k: dict(value=v["value"], unit=v["unit"], card=v["card"]) for k, v in bench.items()}
    log("[3g] cli bench: " + ", ".join(f"{k} {v['value']} {v['unit']}" for k, v in bench.items())
        + f" on {smi}; each cell's timed replay reproduces its committed fingerprint "
        f"(batch64: all 64 lanes)")
    res["seconds"] = time.time() - t_phase
    log(f"[3g] phase 3g took {res['seconds']:.1f} s")
    return res


# ------------------------------------------------------------ 3h: the pure-XLA route (use_pallas=False)

XLA_PATH = ("chol_inv",)   # the single stream's pure-XLA route launches K14 alone; its batch form none
XLA_TRACED_STEPS = 4       # ~4,000 device kernels a step: the profiler's bookkeeping grows with events
XLA_GO_TRACED = 3          # go_one_step calls in the traced window of (c)
XLA_AT = 20                # the output index whose S times K14 and its plain version
# frames of the single stream's second and third passes (the counted eager loop, go_one_step) where a
# full pass takes tens of seconds: held to the graph replay's rows on the same frames, which hold the
# fingerprint over every frame
EAGER_PREFIX = 40


def xla_route_phase(tmp: str, dev, frames, cfg: str, seq, bparams, states0, bseq, bframes, smi: str) -> dict:
    """Phase 3h: JAX's pure-XLA route in f32 (use_pallas=False) on the card.

    (a) std-mapping through MonoSLAM(cfg, max_features=16, use_pallas=False):
        the counted eager loop reproduces expected_fingerprint_xla.json with
        K14 launched once a frame and no other kernel (the wrappers see only
        K14's), K14 against its plain version bit for bit on every S of the
        replay, the CPU plain replay of the first frames, steps under sync
        debug mode "error"; (b) run_sequence's graph replay through
        graph_cell (fingerprint, outputs and final state bit for bit with
        the eager loop, K14 exactly once a step in a traced window and no
        other counted kernel, times, busy, idle, peak memory); (c)
        go_one_step one call a frame through the one-step graph: the
        fingerprint, every packed row and the final state bit for bit with
        the eager loop, K14 once a call in a traced window, ms a call; (d)
        the batch route "xla" on batch64's 64 lanes x 63 frames: every lane's
        fingerprint equal to its committed file with no kernel launched, two
        lanes against their CPU plain replay, steps under sync debug mode
        "error", graph_cell; (e) K14's times on the route's S."""
    from scenelib2_torch import MonoSLAM
    from scenelib2_torch.eval.batch import check_lanes, lane_fingerprints
    from scenelib2_torch.eval.fingerprint import decisions_fingerprint, load_expected
    from scenelib2_torch.kernels import _build, chol_inv
    from scenelib2_torch.parallel.mesh import _run_batch_eager, make_batched_step, run_batch
    from scenelib2_torch.runtime.state import SlamState
    from scenelib2_torch.runtime.step import pack_outputs

    t_phase = time.time()
    res = {}
    slam = MonoSLAM(cfg, max_features=16, device="cuda", use_pallas=False)
    if slam._step.route != "xla":
        fail(f"MonoSLAM(use_pallas=False) took the route {slam._step.route!r}, not the pure-XLA route")
    n_run = seq.shape[0]
    slam._run_sequence_eager(seq[:4], enable_mapping=True)    # warm-up
    torch.cuda.synchronize()
    want = load_expected("expected_fingerprint_xla")

    def check_fp(o, what="std-mapping xla"):
        fp_ = decisions_fingerprint(o, o.n_matched.shape[0])
        for k in ("n_frames", "matched_sum", "inits", "convs", "active_end", "decisions_sha256"):
            if fp_[k] != want[k]:
                fail(f"[3h] {what}: fingerprint field {k}: got {fp_[k]}, expected {want[k]}")
        return fp_

    # ---- (a) the counted eager loop
    S_all = []

    def keep(n, a, k):
        if n != "chol_inv":
            fail(f"[3h] the pure-XLA step called the kernel wrapper {n}")
        S_all.append(a[0].clone())

    n_eager = EAGER_PREFIX
    t0 = time.perf_counter()
    outs, launches, state_eager = run_main_path(slam, seq[:n_eager], mapping=True, on_call=keep)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    for n in _build.KERNELS:
        if launches.get(n, 0) != (n_eager if n in XLA_PATH else 0):
            fail(f"[3h] kernel {n} launched {launches.get(n, 0)} times on the pure-XLA route, expected "
                 f"{n_eager if n in XLA_PATH else 0}")
    r = outs.r.numpy()
    if r.shape != (n_eager, 3) or not np.isfinite(r).all():
        fail(f"[3h] trajectory not finite/shaped: {r.shape}")
    log(f"[3h] std-mapping, use_pallas=False (route xla): launches (eager loop, frames 1..{n_eager}, "
        f"{eager_s:.2f} s): {json.dumps({k: v for k, v in launches.items() if v})}")
    S = torch.cat(S_all)
    k14_err = max(check_k14(S), check_k14(S_all[XLA_AT]))
    log(f"[3h] K14 equals its plain version bit for bit on all {S.shape[0]} S of the replay "
        f"({tuple(S.shape[1:])}; max abs err {k14_err})")

    cpu = MonoSLAM(cfg, max_features=16, device="cpu", use_pallas=False)
    ref = cpu.run_sequence(frames[1 : N_REF + 1], enable_mapping=True)
    for k in ("n_visible", "n_selected", "n_matched", "n_active", "n_partial", "did_init",
              "did_convert", "n_overflow", "sel_slot", "sel_matched", "init_box", "par_alive"):
        if not torch.equal(getattr(ref, k), getattr(outs, k)[:N_REF]):
            fail(f"[3h] CUDA vs CPU plain replay: {k} differs in the first {N_REF} frames")
    dxv = float((ref.xv.double() - outs.xv[:N_REF].double()).abs().max())
    if dxv > STEP_TOL:
        fail(f"[3h] CUDA vs CPU plain replay: xv differs by {dxv}")
    log(f"[3h] the CUDA run equals the CPU plain replay on frames 1..{N_REF} (inits at "
        f"{torch.nonzero(ref.did_init).flatten().tolist()}, conversions at "
        f"{torch.nonzero(ref.did_convert).flatten().tolist()}; max |dxv| {dxv:.3g})")

    slam.reset()
    state = slam.state
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for t in range(N_REF):
            state, _out = slam._step(state, seq[t], True)
    except RuntimeError as e:
        fail(f"[3h] the pure-XLA step synchronised with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log(f"[3h] {N_REF} pure-XLA steps ran with torch.cuda.set_sync_debug_mode('error')")

    # ---- (b) run_sequence's graph replay
    run, run_eager = single_runs(slam, seq, True)
    fps = []
    g = graph_cell("3h", "std-mapping xla", run, run_eager, slam._graphs, n_run, XLA_PATH,
                   (outs, state_eager), lambda o: fps.append(check_fp(o)), trace_n=XLA_TRACED_STEPS,
                   eager_s=eager_s, eager_n=n_eager)
    fp = fps[0]
    log(f"[3h] std-mapping xla: the graph replay's fingerprint {json.dumps(fp)} equals expected_fingerprint_xla.json")
    res["std"] = {k: v for k, v in g.items() if k != "prof"}

    # ---- (c) go_one_step, one call a frame through the one-step graph, on the eager loop's frames
    slam.reset()
    rows, ms = go_calls(slam, frames, n_eager, True, graph=True)
    torch.cuda.synchronize()
    if not same_bits_or_nan(rows.cpu(), pack_outputs(outs)):
        fail("[3h] go_one_step through the graph: packed rows differ from the eager loop's")
    if not outputs_identical(slam.state, state_eager):
        fail("[3h] go_one_step through the graph: final state differs from the eager loop's")
    _prof, go_launches = traced_exactly(lambda: traced_go_calls(slam, frames),
                                        XLA_GO_TRACED, XLA_PATH, f"[3h] {XLA_GO_TRACED} go_one_step calls")
    res["go_one_step"] = dict(graph_ms_call=statistics.median(ms[1:]), first_call_ms=ms[0], calls=n_eager,
                              traced_calls=XLA_GO_TRACED, launches=go_launches)
    log(f"[3h] go_one_step through the one-step graph, {n_eager} calls: every packed row and the state "
        f"bit for bit with the eager loop (held to the graph replay above); {statistics.median(ms[1:]):.4f} ms "
        f"a call (median of calls 2..{n_eager}; first {ms[0]:.1f} ms); a trace of {XLA_GO_TRACED} calls launched "
        f"{json.dumps({k: v for k, v in go_launches.items() if v})}")

    # ---- (d) the batch route "xla" on batch64's lanes
    xparams = dataclasses.replace(bparams, use_pallas=False)
    bstep = make_batched_step(xparams, device="cuda")
    if bstep.route != "xla":
        fail(f"[3h] make_batched_step(use_pallas=False) took the route {bstep.route!r}")
    T = bseq.shape[0]
    _run_batch_eager(bstep, states0, bseq[:2], True, xparams)     # warm-up
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    bst_eager, bouts = _run_batch_eager(bstep, states0, bseq, True, xparams)
    torch.cuda.synchronize()
    beager_s = time.perf_counter() - t0
    blaunches = dict(_build.launches)

    def check_batch_fp(o):
        bad = check_lanes(lane_fingerprints(o), route="xla")
        if bad:
            fail(f"[3h] batch xla: {len(bad)} of {N_LANES} lane fingerprints differ from the committed file:\n"
                 + "\n".join(bad[:6]))

    check_batch_fp(bouts)
    if any(blaunches.get(n, 0) for n in _build.KERNELS):
        fail(f"[3h] the batch pure-XLA route launched kernels: {json.dumps(blaunches)}")
    log(f"[3h] batch64 on the route xla ({T} steps of {N_LANES} lanes, eager loop {beager_s:.2f} s): every "
        f"lane's fingerprint equals the committed file; no kernel launched")
    idx = list(ROUTE_REF_LANES)
    cpu_states = SlamState(*(t[idx].cpu() for t in states0))
    _s, bref = run_batch(make_batched_step(xparams, device="cpu"), cpu_states, bframes[:N_ROUTE_REF, idx], True,
                         xparams)
    for k in ("n_visible", "n_selected", "n_matched", "n_active", "n_partial", "did_init",
              "did_convert", "n_overflow", "sel_matched", "init_box", "par_alive"):
        if not torch.equal(getattr(bref, k), getattr(bouts, k)[:N_ROUTE_REF, idx]):
            fail(f"[3h] batch xla: CUDA vs CPU plain replay: {k} differs in lanes {idx}")
    dxb = float((bref.xv.double() - bouts.xv[:N_ROUTE_REF, idx].double()).abs().max())
    if dxb > STEP_TOL:
        fail(f"[3h] batch xla: CUDA vs CPU plain replay: xv differs by {dxb}")
    st_b = states0
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for t in range(N_ROUTE_REF):
            st_b, _o = bstep(st_b, bseq[t], True)
    except RuntimeError as e:
        fail(f"[3h] the batch pure-XLA step synchronised with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log(f"[3h] batch xla: lanes {idx} equal their CPU plain replay on frames 1..{N_ROUTE_REF} (max |dxv| "
        f"{dxb:.3g}); {N_ROUTE_REF} steps ran with sync debug mode 'error'")
    brun, brun_eager = batch_runs(bstep, states0, bseq, xparams)
    gb = graph_cell("3h", "batch64 xla", brun, brun_eager, bstep.graphs, T, (), (bouts, bst_eager),
                    check_batch_fp, trace_n=ROUTE_TRACED_STEPS, eager_s=beager_s)
    res["batch64"] = {k: v for k, v in gb.items() if k != "prof"}
    res["batch64"].update(frames_per_s=N_LANES / gb["graph_ms"] * 1e3,
                          frames_per_s_eager=N_LANES / gb["eager_ms"] * 1e3)

    # ---- (e) K14 on the route's S: kernel, plain version, library form, bound
    S20 = S_all[XLA_AT]
    eye = torch.eye(S20.shape[-1], device=dev)
    b_ms, b_by = bound([chol_inv.bytes_and_flops(s_[..., 0, 0].numel(), s_.shape[-1]) for s_ in S_all])
    res["K14"] = dict(
        ms=time_ms(lambda: chol_inv.chol_inv(S20)),
        plain_ms=time_ms(lambda: chol_inv.chol_linv(S20), n=5, batches=3),
        library_ms=time_ms(lambda: torch.linalg.solve_triangular(torch.linalg.cholesky_ex(S20)[0], eye,
                                                                 upper=False)),
        device_ms=kernel_dev_ms(g["prof"], "k14_"), bound_ms=b_ms, bound_by=b_by, max_abs_err=k14_err,
        launches=g["launches"]["chol_inv"], launches_steps=g["launches_steps"],
        launches_captured=g["captured"].get("chol_inv", 0))
    log(f"[3h] K14 on the pure-XLA route's S (output index {XLA_AT}): {json.dumps(res['K14'])}")
    res["fingerprint"] = fp
    res["seconds"] = time.time() - t_phase
    log(f"[3h] phase 3h took {res['seconds']:.1f} s on {smi}")
    return res


F64_TOL = 1e-8            # CUDA vs CPU f64 replay: r, xv (exp and reduction orders may differ by ulps)
F64_AT = (9, 20, 120)     # output indices whose K2 inputs the hybrid route's replay captures
N_HYB, HYB_AT = 16, 9     # hybrid batch routes: eager steps over the 64 lanes, the captured step
N_SYNC_HYB = 4            # hybrid batch steps under sync debug mode "error"
PARITY_FRAMES = 24        # run_parity_eval's frames at tests/test_parity.py's 160x120 configuration
F64_TRACED_STEPS = 2      # ~5,000 device kernels a step: the profiler's post-processing grows with events
PARITY_PARAMS = dict(cam_width=160, cam_height=120, cam_fku=98.0, cam_fkv=98.0, cam_u0=80.0, cam_v0=60.0,
                     max_features=10, n_particles=24, n_features_to_select=6, n_features_to_keep_visible=6,
                     min_particles=4, erase_partial_after_attempts=8)
F64_DECISIONS = ("n_visible", "n_selected", "n_matched", "n_active", "n_partial", "did_init", "did_convert",
                 "n_overflow", "sel_slot", "sel_matched", "init_box", "par_alive")


def f64_phase(tmp: str, dev, frames, cfg: str, seq, smi: str) -> dict:
    """Phase 3i: JAX's f64 parity mode (precision="f64") on the card.

    (a) the parity route: std-mapping through MonoSLAM(cfg, max_features=16,
        precision="f64", use_pallas=False) by the counted eager loop, the
        graph replay (graph_cell) and go_one_step one call a frame, each
        reproducing expected_fingerprint_f64.json, rows and final state bit
        for bit across the three, no kernel wrapper called and no counted
        kernel in the traces; the first N_REF frames against the port's CPU
        f64 replay (decisions equal, r and xv within F64_TOL); N_REF steps
        under sync debug mode "error" (graph captures and replays always
        run so). (b) JAX's hybrid route: the same with use_pallas=True
        (route "k2-f64"), expected_fingerprint_f64_k2.json, K2 launched once
        a frame and no other kernel, K2 bit for bit with its plain version on
        the inputs of three frames of the replay. (c) the batch parity route
        "xla-f64" on batch64's lanes made in f64: every lane equal to
        expected_fingerprint_batch64_f64.json through the eager loop and
        graph_cell with no kernel launched, two lanes against their CPU f64
        replay, steps under sync debug mode "error"; then the two hybrid
        batch routes (K2 lanes, and K8 with batch_pallas=False) over the 64
        lanes: one launch a step and no other kernel, K2 / K8 bit for bit
        with their plain versions on a captured step, two lanes against
        their CPU f64 replay, steps under sync debug mode "error". (d)
        run_parity_eval on the card: decision agreement 1.0, drand48 in
        lockstep, RMSE against the oracle <= 1e-3."""
    from scenelib2_torch import MonoSLAM
    from scenelib2_torch.config import Params
    from scenelib2_torch.eval.batch import EXPECTED_F64, check_lanes, lane_fingerprints, lanes_cache_dir, make_lanes
    from scenelib2_torch.eval.fingerprint import decisions_fingerprint, load_expected
    from scenelib2_torch.eval.metrics import run_parity_eval
    from scenelib2_torch.kernels import _build
    from scenelib2_torch.kernels.search import SearchConsts
    from scenelib2_torch.parallel.mesh import _run_batch_eager, make_batched_step, run_batch
    from scenelib2_torch.runtime.state import SlamState
    from scenelib2_torch.runtime.step import pack_outputs

    t_phase = time.time()
    res = {}
    n_run = seq.shape[0]

    def check_fp(o, name, what):
        fp_ = decisions_fingerprint(o, o.n_matched.shape[0])
        want = load_expected(name)
        for k in ("n_frames", "matched_sum", "inits", "convs", "active_end", "decisions_sha256"):
            if fp_[k] != want[k]:
                fail(f"[3i] {what}: fingerprint field {k}: got {fp_[k]}, expected {want[k]} ({name}.json)")
        return fp_

    def against_cpu(got, ref, what, idx=None):
        for k in F64_DECISIONS:
            g = getattr(got, k)[: ref.n_matched.shape[0]]
            if idx is not None:
                g = g[:, idx]
            if not torch.equal(getattr(ref, k), g):
                fail(f"[3i] {what}: CUDA vs CPU f64 replay: {k} differs")
        d = 0.0
        for k in ("r", "xv"):
            g = getattr(got, k)[: ref.n_matched.shape[0]]
            g = g if idx is None else g[:, idx]
            if getattr(ref, k).dtype != torch.float64 or g.dtype != torch.float64:
                fail(f"[3i] {what}: {k} is not f64")
            d = max(d, float((getattr(ref, k) - g).abs().max()))
        if d > F64_TOL:
            fail(f"[3i] {what}: CUDA vs CPU f64 replay: r / xv differ by {d}")
        return d

    def no_sync(step, state, frames_, n, what):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for t in range(n):
                state, _o = step(state, frames_[t], True)
        except RuntimeError as e:
            fail(f"[3i] {what}: the f64 step synchronised with the host: {e}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()

    # ---- (a) / (b) the single stream on the parity and the hybrid route
    sc = None
    k2_err, k2_checked = 0.0, 0
    for route, use_pallas, fp_name, path in (("xla-f64", False, "expected_fingerprint_f64", ()),
                                              ("k2-f64", True, "expected_fingerprint_f64_k2", ("search",))):
        tag = f"std-mapping {route}"
        slam = MonoSLAM(cfg, max_features=16, device="cuda", precision="f64", use_pallas=use_pallas)
        if slam._step.route != route or slam.state.x.dtype != torch.float64:
            fail(f"[3i] MonoSLAM(precision='f64', use_pallas={use_pallas}) took the route {slam._step.route!r}")
        sc = SearchConsts.from_params(slam.params)
        slam._run_sequence_eager(seq[:4], enable_mapping=True)    # warm-up
        torch.cuda.synchronize()
        seen, n_call = {}, [0]

        def on_call(n, a, k, route=route, seen=seen, n_call=n_call):
            if n != "search" or route != "k2-f64":
                fail(f"[3i] {route}: the f64 step called the kernel wrapper {n}")
            if n_call[0] in F64_AT:
                seen[n_call[0]] = tuple(t_.clone() if isinstance(t_, torch.Tensor) else t_ for t_ in a)
            n_call[0] += 1

        # the eager loop up to the last frame whose K2 inputs are captured (xla-f64: EAGER_PREFIX)
        n_eager = max(EAGER_PREFIX, max(F64_AT) + 1) if route == "k2-f64" else EAGER_PREFIX
        t0 = time.perf_counter()
        outs, launches, state_eager = run_main_path(slam, seq[:n_eager], mapping=True, on_call=on_call)
        torch.cuda.synchronize()
        eager_s = time.perf_counter() - t0
        for n in _build.KERNELS:
            if launches.get(n, 0) != (n_eager if n in path else 0):
                fail(f"[3i] {tag}: kernel {n} launched {launches.get(n, 0)} times in the eager loop, expected "
                     f"{n_eager if n in path else 0}")
        if outs.r.dtype != torch.float64 or not torch.isfinite(outs.r).all():
            fail(f"[3i] {tag}: the trajectory is not finite f64")
        log(f"[3i] {tag}: launches (eager loop, frames 1..{n_eager}, {eager_s:.2f} s): "
            f"{json.dumps({k: v for k, v in launches.items() if v})}")
        if route == "k2-f64":
            if sorted(seen) != list(F64_AT):
                fail(f"[3i] {tag}: K2 was called {n_call[0]} times; inputs captured at {sorted(seen)}")
            for at in F64_AT:
                k2_err = max(k2_err, check_k2_lanes(seen[at], sc))
                k2_checked += 1
            log(f"[3i] {tag}: K2 equals its plain version bit for bit on the inputs of output indices {F64_AT} "
                f"(f32 casts of the f64 S^-1; max abs err {k2_err})")
        cpu = MonoSLAM(cfg, max_features=16, device="cpu", precision="f64", use_pallas=use_pallas)
        d = against_cpu(outs, cpu.run_sequence(frames[1 : N_REF + 1], enable_mapping=True), tag)
        log(f"[3i] {tag}: the CUDA run equals the CPU f64 replay on frames 1..{N_REF} decision by decision "
            f"(max |dr|, |dxv| {d:.3g})")
        slam.reset()
        no_sync(slam._step, slam.state, seq, N_REF, tag)
        log(f"[3i] {tag}: {N_REF} steps ran with torch.cuda.set_sync_debug_mode('error')")

        run, run_eager = single_runs(slam, seq, True)
        fps = []
        g = graph_cell("3i", tag, run, run_eager, slam._graphs, n_run, path, (outs, state_eager),
                       lambda o, fp_name=fp_name, tag=tag: fps.append(check_fp(o, fp_name, tag)),
                       trace_n=F64_TRACED_STEPS, eager_s=eager_s, eager_n=n_eager)
        fp = fps[0]
        log(f"[3i] {tag}: the graph replay's fingerprint {json.dumps(fp)} equals {fp_name}.json")
        cell = {k: v for k, v in g.items() if k != "prof"}
        if route == "k2-f64":
            cell["k2_device_ms"] = kernel_dev_ms(g["prof"], "k2_")
        slam.reset()
        n_go = EAGER_PREFIX
        rows, ms = go_calls(slam, frames, n_go, True, graph=True)
        torch.cuda.synchronize()
        if not same_bits_or_nan(rows.cpu(), pack_outputs(outs)[:n_go]):
            fail(f"[3i] {tag}: go_one_step through the graph: packed rows differ from the eager loop's")
        if not outputs_identical(slam.state, state_eager if n_go == n_eager else run(0, n_go)[1]):
            fail(f"[3i] {tag}: go_one_step through the graph: the state differs from the graph replay's")
        _prof, go_launches = traced_exactly(
            lambda: traced_go_calls(slam, frames), XLA_GO_TRACED, path,
            f"[3i] {tag}: {XLA_GO_TRACED} go_one_step calls")
        cell["go_one_step"] = dict(graph_ms_call=statistics.median(ms[1:]), first_call_ms=ms[0], calls=n_go,
                                   traced_calls=XLA_GO_TRACED,
                                   launches={k: v for k, v in go_launches.items() if v})
        cell["fingerprint"] = fp
        cell["cpu_max_diff"] = d
        log(f"[3i] {tag}: go_one_step through the one-step graph, {n_go} calls: every packed row and the "
            f"state bit for bit with the eager loop and the graph replay; {statistics.median(ms[1:]):.4f} ms a "
            f"call (median of calls 2..{n_go}; first {ms[0]:.1f} ms); a trace of {XLA_GO_TRACED} calls launched "
            f"{json.dumps(cell['go_one_step']['launches'])}")
        res[tag] = cell
    res["K2"] = dict(max_abs_err=k2_err, checked=k2_checked)

    # ---- (c) the batch routes on batch64's lanes, made in f64
    bparams, states64, bframes = make_lanes(lanes_cache_dir(cache_root(tmp)), N_LANES, N_TEXTURES,
                                            N_BATCH_FRAMES, device=dev, dtype=torch.float64)
    bseq = torch.as_tensor(bframes).to(dev)
    T = bseq.shape[0]
    n_file = len(load_expected(EXPECTED_F64["std"])["lanes"])
    xparams = dataclasses.replace(bparams, use_pallas=False)
    bstep = make_batched_step(xparams, device="cuda", precision="f64")
    if bstep.route != "xla-f64":
        fail(f"[3i] make_batched_step(use_pallas=False, precision='f64') took the route {bstep.route!r}")
    _run_batch_eager(bstep, states64, bseq[:2], True, xparams)     # warm-up
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    bst_eager, bouts = _run_batch_eager(bstep, states64, bseq, True, xparams)
    torch.cuda.synchronize()
    beager_s = time.perf_counter() - t0
    blaunches = dict(_build.launches)

    def check_batch_fp(o):
        bad = check_lanes(lane_fingerprints(o)[:n_file], route="xla-f64", precision="f64")
        if bad:
            fail(f"[3i] batch xla-f64: {len(bad)} of {n_file} lane fingerprints differ from the committed file:\n"
                 + "\n".join(bad[:6]))

    check_batch_fp(bouts)
    if any(blaunches.get(n, 0) for n in _build.KERNELS):
        fail(f"[3i] the batch f64 parity route launched kernels: {json.dumps(blaunches)}")
    log(f"[3i] batch64 on the route xla-f64 ({T} steps of {N_LANES} lanes, eager loop {beager_s:.2f} s): "
        f"the fingerprints of lanes 0..{n_file - 1} equal {EXPECTED_F64['std']}.json; no kernel launched")
    idx = list(ROUTE_REF_LANES)
    cpu_states = SlamState(*(t[idx].cpu() for t in states64))
    _s, bref = run_batch(make_batched_step(xparams, device="cpu", precision="f64"), cpu_states,
                         bframes[:N_ROUTE_REF, idx], True, xparams)
    dxb = against_cpu(bouts, bref, "batch xla-f64", idx)
    no_sync(bstep, states64, bseq, N_ROUTE_REF, "batch xla-f64")
    log(f"[3i] batch xla-f64: lanes {idx} equal their CPU f64 replay on frames 1..{N_ROUTE_REF} (max |dr|, "
        f"|dxv| {dxb:.3g}); {N_ROUTE_REF} steps ran with sync debug mode 'error'")
    brun, brun_eager = batch_runs(bstep, states64, bseq, xparams)
    gb = graph_cell("3i", "batch64 xla-f64", brun, brun_eager, bstep.graphs, T, (), (bouts, bst_eager),
                    check_batch_fp, trace_n=F64_TRACED_STEPS, eager_s=beager_s)
    res["batch64 xla-f64"] = {k: v for k, v in gb.items() if k != "prof"}
    res["batch64 xla-f64"].update(frames_per_s=N_LANES / gb["graph_ms"] * 1e3,
                                  frames_per_s_eager=N_LANES / gb["eager_ms"] * 1e3, lanes_checked=n_file)
    del bstep, gb

    hyb_errs = {}
    for route, hparams, wrapper, count in (
            ("k2-f64", dataclasses.replace(bparams, use_pallas=True, batch_pallas=True), "search", "search"),
            ("k8-f64", dataclasses.replace(bparams, use_pallas=True, batch_pallas=False), "search_windows",
             "search_windows")):
        hstep = make_batched_step(hparams, device="cuda", precision="f64")
        if hstep.route != route:
            fail(f"[3i] the batch step took the route {hstep.route!r}, expected {route}")
        _run_batch_eager(hstep, states64, bseq[:2], True, hparams)     # warm-up
        torch.cuda.synchronize()
        cap = {}

        def on_call(n, a, k, wrapper=wrapper, route=route, cap=cap):
            if n != wrapper:
                fail(f"[3i] batch {route}: the f64 step called the kernel wrapper {n}")
            cap.setdefault("n", 0)
            if cap["n"] == HYB_AT:
                cap["args"] = tuple(t_.clone() if isinstance(t_, torch.Tensor) else t_ for t_ in a)
            cap["n"] += 1

        _build.reset_launches()
        t0 = time.perf_counter()
        with observe_wrappers(on_call):
            hst, houts = _run_batch_eager(hstep, states64, bseq[:N_HYB], True, hparams)
        torch.cuda.synchronize()
        h_s = time.perf_counter() - t0
        hl = dict(_build.launches)
        for n in _build.KERNELS:
            if hl.get(n, 0) != (N_HYB if n == count else 0):
                fail(f"[3i] batch {route}: kernel {n} launched {hl.get(n, 0)} times in {N_HYB} steps")
        a = cap["args"]
        err = check_k2_lanes(a, sc) if wrapper == "search" else check_k8(a[:7], sc)
        hyb_errs[route] = err
        _s, href = run_batch(make_batched_step(hparams, device="cpu", precision="f64"), cpu_states,
                             bframes[:N_ROUTE_REF, idx], True, hparams)
        dh = against_cpu(houts, href, f"batch {route}", idx)
        no_sync(hstep, states64, bseq, N_SYNC_HYB, f"batch {route}")
        res[f"batch64 {route}"] = dict(eager_ms=h_s / N_HYB * 1e3, steps=N_HYB, launches={count: hl[count]},
                                       max_abs_err=err, cpu_max_diff=dh, lanes=N_LANES)
        log(f"[3i] batch {route} over {N_LANES} lanes x {N_HYB} steps: {count} launched once a step and no "
            f"other kernel; {'K2' if count == 'search' else 'K8'} bit for bit with its plain version on step "
            f"{HYB_AT} (max abs err {err}); lanes {idx} equal their CPU f64 replay on frames 1..{N_ROUTE_REF} "
            f"(max |dr|, |dxv| {dh:.3g}); {N_SYNC_HYB} steps under sync debug mode 'error'; eager "
            f"{h_s / N_HYB * 1e3:.3f} ms a step")
        del hstep

    # ---- (d) run_parity_eval on the card
    t0 = time.time()
    pe = run_parity_eval(n_frames=PARITY_FRAMES, params=Params(**PARITY_PARAMS), device="cuda")
    pe_s = time.time() - t0
    if pe["decision_agreement"] != 1.0 or pe["drand48_in_lockstep"] is not True or not pe["rmse_vs_oracle"] <= 1e-3:
        fail(f"[3i] run_parity_eval on the card misses a bar: {json.dumps(pe)}")
    log(f"[3i] run_parity_eval (160x120, {PARITY_FRAMES} frames, {pe_s:.1f} s): rmse_vs_oracle "
        f"{pe['rmse_vs_oracle']!r}, decision_agreement {pe['decision_agreement']}, drand48_in_lockstep "
        f"{pe['drand48_in_lockstep']}, ATE rmse vs the renderer {pe['ate_vs_ground_truth']['rmse']!r}")
    res["parity_eval"] = dict(pe, seconds=pe_s, frames=PARITY_FRAMES)
    res["hybrid_errs"] = hyb_errs
    res["seconds"] = time.time() - t_phase
    log(f"[3i] phase 3i took {res['seconds']:.1f} s on {smi}")
    return res


# ------------------------------------------------------------ main


SINGLE_WRAPPERS = ("predict_measure", "search", "joint_update", "propose_region", "shi_tomasi", "search_bayes")
WRAPPERS = ("predict_measure", "search", "joint_update", "propose_region", "shi_tomasi", "search_bayes",
            "measure_select", "score_map", "particle_predict", "search_bayes_maps", "chol_inv",
            "search_windows", "bayes_update", "particle_search")
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
    K5 propose_region, K6 shi_tomasi, K4 search_bayes; K7 measure_select, K9
    score_map, K10 particle_predict, K11 search_bayes_maps; K14 chol_inv,
    which core/ekf.py calls; K8 search_windows, K12 bayes_update, K13
    particle_search)."""
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
    """Drive the eager step (go_one_step's reference form: the wrappers see
    every call) on the GPU with mapping on through output index max(at) and
    return {index: {wrapper: (args, kwargs)}} for the indices in `at`."""
    seen, cur = {}, {}
    with observe_wrappers(lambda n, a, k: cur.__setitem__(n, (a, k))):
        slam.reset()
        for t in range(max(at) + 1):
            cur.clear()
            slam._go_one_step_eager(frames[t + 1])
            if t in at:
                seen[t] = dict(cur)
    torch.cuda.synchronize()
    return seen


def run_main_path(slam, seq, mapping: bool, on_call=None):
    """The eager reference replay (MonoSLAM._run_sequence_eager: the step
    called on every frame, so on_call sees every kernel's real inputs) with
    every launch count zeroed just before it; returns (outputs, launches
    read just after it, final state)."""
    from scenelib2_torch.kernels import _build

    slam.reset()
    torch.cuda.synchronize()
    _build.reset_launches()
    with observe_wrappers(on_call) if on_call else contextlib.nullcontext():
        outs = slam._run_sequence_eager(seq, enable_mapping=mapping)
    return outs, dict(_build.launches), slam.state


# ------------------------------------------------------------ graph replay (runtime/replay.py)

N_GRAPH_TIMED = 3   # timed graph replays of each cell (median); the eager loop is timed once
GRAPH_CHUNK = 10    # the chunk= each cell's graph replay is held to chunk = 0 at: full chunks and a
                    # remainder of one-step replays (239 -> 23 x 10 + 9, 119 -> 11 x 10 + 9, 63 -> 6 x 10 + 3)
TRACE_TRIES = 3     # traced graph runs in which the profiler's counts may come out short, at most
# the device kernels of each launch count (kernels/_build.py KERNELS): each wrapper launches one of
# its kernels where it counts a launch
TRACE_SYMBOLS = {
    "predict_measure": ("k1_kernel",), "search": ("k2_kernel",), "ekf_update": ("k3_kernel",),
    "propose": ("k5_kernel",), "shi_tomasi": ("k6_kernel", "k6_kernel_one"), "search_bayes": ("k4_kernel",),
    "measure": ("k7_kernel",), "score_map": ("k9_kernel",), "particle_predict": ("k10_kernel",),
    "chol_inv": ("k14_kernel", "k14_warp_kernel"), "bayes": ("k12_kernel",),
    "particle_search": ("k13_kernel",), "particle_kform": ("k10b_kernel",),
    "ekf_update_dense": ("k15_kernel",), "multi_ellipse": ("k16_kernel",),
    "search_bayes_maps": ("k11_kernel",), "search_windows": ("k8_kernel",),
}


def outputs_identical(a, b) -> bool:
    """Two StepOutputs or states equal field by field, floats bit for bit
    (any NaN equal to any NaN)."""
    return all(same_bits_or_nan(x, y) if x.is_floating_point() else same(x, y) for x, y in zip(a, b))


def device_profile(fn) -> dict:
    """torch.profiler over fn(): device time by kernel name, total device
    time and the wall time of the traced call. Every trace of this script
    records the device's activity only: the host's operator events would add
    most of the profiler's post-processing time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
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


def traced_launches(prof: dict) -> dict:
    """The launches of each counted kernel (TRACE_SYMBOLS) in a trace."""
    from scenelib2_torch.kernels import _build

    pats = {n: re.compile(r"(?<![\w])(" + "|".join(TRACE_SYMBOLS[n]) + r")[<(]") for n in _build.KERNELS}
    got = {n: 0 for n in _build.KERNELS}
    for key, (_ms, cnt) in prof["by_name"].items():
        for n, pat in pats.items():
            if pat.search(key):
                got[n] += cnt
    return got


def profiler_warmup(n: int = 512) -> None:
    """Device activity at the start of a traced go_one_step run: a trace whose
    first device work is a step's first kernel (K1 there) came back without
    that step's first records (K1, K2, K3 counted 2 of 3 calls, in every try,
    late in a full run), so n tiny kernels and a pause go first."""
    x = torch.zeros(1, device="cuda")
    for _ in range(n):
        x.add_(1.0)
    torch.cuda.synchronize()
    time.sleep(0.01)


def traced_go_calls(slam, frames):
    """go_calls of XLA_GO_TRACED frames through the graph, after profiler_warmup."""
    profiler_warmup()
    return go_calls(slam, frames, XLA_GO_TRACED, True, graph=True)


def traced_exactly(fn, n: int, path, what: str):
    """(profile, launches) of a trace of fn() in which each kernel of path
    ran n times and no other counted kernel ran: traced up to TRACE_TRIES
    times, since the profiler's counts may come out short; fails otherwise."""
    from scenelib2_torch.kernels import _build

    for _try in range(TRACE_TRIES):
        prof = device_profile(fn)
        got = traced_launches(prof)
        if all(got[k] == (n if k in path else 0) for k in _build.KERNELS):
            return prof, got
        log(f"{what}: a trace counted {json.dumps({k: v for k, v in got.items() if v})}; tracing again")
    fail(f"{what}: in {TRACE_TRIES} traces the kernels ran {json.dumps({k: v for k, v in got.items() if v})} "
         f"times, expected {n} each of {list(path)}")


def timed_s(fn) -> float:
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t


def graph_cell(tag: str, label: str, run, run_eager, graphs: dict, T: int, path, eager, check,
               trace_n: int | None = None, eager_s: float | None = None, eager_n: int | None = None) -> dict:
    """A cell's replay through CUDA graphs (run_sequence / run_batch on the
    card) against its eager reference. run(chunk, n=None) replays the first
    n (all) of the cell's T frames from its initial state through the graph
    path and returns (outputs, final state); run_eager() the same through
    the eager loop; graphs is the cache the graph path fills; path the
    launch-count names of the cell's kernels; eager the (outputs, final
    state) of the counted eager reference; check(outputs) its fingerprint
    check.

    1. The first graph run (its wall time, captures included, beside the
       eager loop's), every count zeroed just before it and read just after:
       it captures a graph of replay.REPLAY_BLOCK steps and, where T leaves
       a remainder, a one-step graph, each after one warm-up step, so each
       kernel of the path is counted once per captured step and warm-up
       step and no other kernel is: the counters count captures, not
       replays (StepGraph.launches: the capture alone). Its fingerprint; its
       packed outputs and final state equal the eager reference's bit for
       bit (an eager reference of the first eager_n steps only: those rows,
       and the state of a graph run of as many steps); capture + instantiate
       seconds; peak device memory above what was
       allocated before it (the graphs' pools included) and the size of the
       pool the cache's graphs share.
    2. chunk = GRAPH_CHUNK (full chunks and a one-step remainder) equals
       chunk = 0 bit for bit.
    3. Times: the eager loop once (or eager_s, the seconds of the counted
       eager reference over its eager_n steps, where given), the graph replay N_GRAPH_TIMED times
       (median), the device's span of one replay of the block graph (CUDA
       events, from the same state each time), and a traced graph run of
       trace_n (all) frames: each kernel of the path ran exactly once a step
       in it and no other kernel ran (the launches of the kernel records),
       device busy, kernels a step and the idle shares of the eager loop, of
       the graph run (host wall of the traced frames) and of the replay's
       span."""
    from scenelib2_torch.kernels import _build
    from scenelib2_torch.runtime import replay

    before = set(graphs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    alloc0 = torch.cuda.memory_allocated()
    _build.reset_launches()
    t0 = time.perf_counter()
    outs, state = run(0)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(_build.launches)
    peak_mb = (torch.cuda.max_memory_allocated() - alloc0) / 2**20
    new = [graphs[k] for k in graphs if k not in before]
    sizes = sorted(g_.n for g_ in new)
    if sizes != sorted(set(replay.chunk_plan(T, 0))):
        fail(f"[{tag}] {label}: the graph run captured graphs of {sizes} steps, expected "
             f"{sorted(set(replay.chunk_plan(T, 0)))}")
    g = next(g_ for g_ in new if g_.n == replay.REPLAY_BLOCK)
    # the graphs of a cache share one pool (runtime/replay.py), which may
    # hold graphs captured before this cell's
    pools = [graph_pool_mb(pid) for pid in sorted({tuple(g_.graph.pool()) for g_ in new})]
    pool_mb = None if None in pools else sum(pools)
    for n in _build.KERNELS:
        want = sum(sizes) if n in path else 0
        got_captured = sum(g_.launches.get(n, 0) for g_ in new)
        if got_captured != want or launches.get(n, 0) != (want + len(new) if want else 0):
            fail(f"[{tag}] {label}: kernel {n} launched {launches.get(n, 0)} times in the graph run, "
                 f"{got_captured} of them captured; expected {want} captured and {len(new)} warm-up launches")
    check(outs)
    eager_n = eager_n or T
    head = type(outs)(*(t_[:eager_n] for t_ in outs))
    if not outputs_identical(head, eager[0]):
        bad = [f for f, a, b in zip(outs._fields, head, eager[0]) if not outputs_identical((a,), (b,))]
        fail(f"[{tag}] {label}: the graph replay's outputs differ from the eager loop's: {bad}")
    state_n = state if eager_n == T else run(0, eager_n)[1]
    if not outputs_identical(state_n, eager[1]):
        fail(f"[{tag}] {label}: the graph replay's state after {eager_n} steps differs from the eager loop's")
    warmup_s = sum(g_.warmup_s for g_ in new)
    capture_s = sum(g_.capture_s for g_ in new)
    log(f"[{tag}] {label}: graph replay of {T} steps ({len(replay.chunk_plan(T, 0))} replays of graphs of "
        f"{sizes} steps) equals the eager loop bit for bit (outputs and state{'' if eager_n == T else f' over its first {eager_n} steps'}); first call {first_s:.3f} s "
        f"wall, of it warm-up steps {warmup_s:.3f} s and capture + instantiate {capture_s:.3f} s (host); "
        f"launches counted in the graph run (warm-up steps and the captures, not the replays) "
        f"{json.dumps({k: v for k, v in launches.items() if v})}")
    k = GRAPH_CHUNK
    before = set(graphs)
    outs_c, state_c = run(k)
    chunk_sizes = sorted(graphs[key].n for key in graphs if key not in before)
    if not (outputs_identical(outs_c, outs) and outputs_identical(state_c, state)):
        fail(f"[{tag}] {label}: run with chunk={k} differs from chunk=0")
    log(f"[{tag}] {label}: chunk={k} ({T // k} x {k} + {T % k} x 1; graphs captured {chunk_sizes}) equals "
        f"chunk=0 bit for bit")
    if eager_s is None:
        eager_s, eager_n = timed_s(run_eager), T
    eager_ms = eager_s / eager_n * 1e3
    runs = [timed_s(lambda: run(0)) / T * 1e3 for _ in range(N_GRAPH_TIMED)]
    graph_ms = statistics.median(runs)
    # the device's span of one replay of the block graph (CUDA events around
    # the replay alone, from the same static state each time): busy plus the
    # gaps between its nodes
    start = [t_.clone() for t_ in g.state_in]
    span = []
    for _ in range(N_GRAPH_TIMED):
        for dst, src in zip(g.state_in, start):
            dst.copy_(src)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        g.graph.replay()
        e1.record()
        torch.cuda.synchronize()
        span.append(e0.elapsed_time(e1) / g.n)
    span_ms = statistics.median(span)
    n = trace_n or T
    window_ms = graph_ms if n == T else timed_s(lambda: run(0, n)) / n * 1e3
    prof, replayed = traced_exactly(lambda: run(0, n), n, path, f"[{tag}] {label}: traced graph run of {n} steps")
    log(f"[{tag}] {label}: traced graph run of {n} steps: each kernel of the path ran {n} times, no other "
        f"counted kernel ran")
    busy = prof["device_ms"] / n
    res = dict(eager_ms=eager_ms, eager_s=eager_s, first_s=first_s, graph_ms=graph_ms, graph_runs=runs,
               span_ms=span_ms, warmup_s=warmup_s, capture_s=capture_s, steps=T, graphs=sizes,
               chunk=k, traced_steps=n, graph_ms_window=window_ms,
               busy=busy if busy > 0 else None,
               idle_eager=(1.0 - busy / eager_ms) if busy > 0 else None,
               idle_graph=(1.0 - busy / window_ms) if busy > 0 else None,
               idle_span=(1.0 - busy / span_ms) if busy > 0 else None,
               kernels=sum(c for _m, c in prof["by_name"].values()) / n,
               peak_mb=peak_mb, pool_mb=pool_mb, pools_mb=pools, launches=replayed, launches_steps=n,
               captured={k_: v for k_, v in launches.items() if v}, prof=prof)
    log(f"[{tag}] {label}: eager {eager_ms:.4f} ms a step (one run of {eager_n}: {eager_s:.3f} s; the graph "
        f"path's first call {first_s:.3f} s), graph {graph_ms:.4f} ms a step "
        f"(median of {N_GRAPH_TIMED}: {', '.join(f'{v:.4f}' for v in runs)}), of it the device's span of a "
        f"replay {span_ms:.4f} ms a step (CUDA events); peak device memory of the first "
        f"graph run {peak_mb:.1f} MiB above what was allocated before it, the graphs' private pools "
        f"{pool_mb if pool_mb is None else round(pool_mb, 1)} MiB ({len(pools)} pool(s) for its graphs of "
        f"{sizes} steps and any graph captured before them in the same cache)")
    if busy > 0:
        log(f"[{tag}] {label}: traced graph replay of {n} steps: device busy {busy:.4f} ms a step, "
            f"{res['kernels']:.2f} device kernels a step -> idle share {res['idle_graph']:.4f} of the graph "
            f"({window_ms:.4f} ms a step over those steps), {res['idle_eager']:.4f} of the eager loop, "
            f"{res['idle_span']:.4f} of the replay's span")
        for name, (ms, cnt) in sorted(prof["by_name"].items(), key=lambda kv: -kv[1][0])[:10]:
            log(f"[{tag}]   {ms / n * 1e3:9.3f} us/step  x{cnt / n:6.2f}/step  {name[:90]}")
    else:
        log(f"[{tag}] {label}: the profiler recorded no device time in the graph replay (not measured)")
    return res


def graph_pool_mb(pool: tuple):
    """MiB of the device memory segments of a graph pool (a CUDAGraph's
    pool() id; the caching allocator's snapshot), None where the snapshot
    names no pool."""
    segs = torch.cuda.memory_snapshot()
    if not any("segment_pool_id" in seg for seg in segs):
        return None
    return sum(seg["total_size"] for seg in segs if tuple(seg.get("segment_pool_id", ())) == pool) / 2**20


def kernel_dev_ms(prof: dict, sym: str):
    """Device ms a launch of the kernels whose name holds sym in a trace."""
    hits = [v for k, v in prof["by_name"].items() if sym in k]
    return sum(h[0] for h in hits) / max(1, sum(h[1] for h in hits)) if hits else None


def single_runs(slam, seq, mapping: bool):
    """graph_cell's run and run_eager for a MonoSLAM over seq."""
    def run(chunk, n=None):
        slam.reset()
        outs = slam.run_sequence(seq[:n], enable_mapping=mapping, chunk=chunk)
        return outs, slam.state

    def run_eager():
        slam.reset()
        return slam._run_sequence_eager(seq, enable_mapping=mapping), slam.state

    return run, run_eager


def batch_runs(step, states0, seq, params):
    """graph_cell's run and run_eager for a batched step over seq [T, B, H, W]."""
    from scenelib2_torch.parallel.mesh import _run_batch_eager, run_batch

    def run(chunk, n=None):
        st_, outs = run_batch(step, states0, seq[:n], True, params, chunk=chunk)
        return outs, st_

    def run_eager():
        st_, outs = _run_batch_eager(step, states0, seq, True, params)
        return outs, st_

    return run, run_eager


def run_summary(cells, entry, xla, f64, maxp, ekfs, smi: str, total_s: float) -> dict:
    """The run's result in under 4 KB, for the line just before the last:
    every phase's fingerprint verdict (a failed check exits before it is
    printed) and headline times, ms a frame or a batch step through the
    graph and eagerly."""
    def ms(r_):
        return [round(r_["graph_ms"], 4), round(r_["eager_ms"], 3)]

    # a phase that failed a check exited before this line: every verdict reads "equal"
    verdicts = {ph: "equal" for ph in ("3 std-nomap, std-mapping", "3b batch64", "3c hires", "3d mf100",
                                       "3e bp0, sb0", "3f batch-hires", "3g go_one_step, cli, bench",
                                       "3h std-xla, batch64-xla", "3i std-f64, std-f64-k2, batch64-f64",
                                       "3j maxp2: std, autoinit, mf100, xla, f64, batch64 x 5 routes",
                                       "3k EKF benches, sharded (1, 1) and lanes (1,)")}
    out = {"card": smi, "seconds": round(total_s, 1), "fingerprints": verdicts,
           "graph_eager_ms": {c: ms(r_) for c, r_ in cells.items()}}
    out["graph_eager_ms"].update({f"{c} (3h)": ms(xla[k]) for c, k in (("std-xla", "std"),
                                                                        ("batch64-xla", "batch64"))})
    out["graph_eager_ms"].update({f"{c} (3i)": ms(f64[c]) for c in ("std-mapping xla-f64", "std-mapping k2-f64",
                                                                      "batch64 xla-f64")})
    out["graph_eager_ms"].update({f"{c} (3j)": ms(r_) for c, r_ in maxp["cells"].items()})
    out["graph_eager_ms"].update({f"{c} (3j)": ms(r_) for c, r_ in maxp["routes"].items()})
    out["graph_eager_ms"].update({f"batch64-maxp2 {c} (3j)": ms(r_) for c, r_ in maxp["batch"].items()})
    out["busy_ms"] = {c: round(r_["busy"], 4) for c, r_ in cells.items() if r_.get("busy")}
    out["busy_ms"].update({c: round(r_["busy"], 4) for c, r_ in maxp["cells"].items() if r_.get("busy")})
    out["busy_ms"].update({c: round(f64[c]["busy"], 4) for c in ("std-mapping xla-f64", "std-mapping k2-f64",
                                                                 "batch64 xla-f64") if f64[c].get("busy")})
    out["go_one_step_ms"] = {c: round(entry["per_call"][c]["graph_ms"], 4) for c in entry["per_call"]}
    out["go_one_step_ms"].update({"xla": round(xla["go_one_step"]["graph_ms_call"], 4),
                             "xla-f64": round(f64["std-mapping xla-f64"]["go_one_step"]["graph_ms_call"], 4),
                             "k2-f64": round(f64["std-mapping k2-f64"]["go_one_step"]["graph_ms_call"], 4)})
    out["bench_fps"] = {k: v["value"] for k, v in entry.get("bench", {}).items() if isinstance(v, dict)}
    out["batch_f64_eager_ms"] = {r_: round(f64[f"batch64 {r_}"]["eager_ms"], 3) for r_ in ("k2-f64", "k8-f64")}
    pe = f64["parity_eval"]
    out["parity_eval"] = {k: pe[k] for k in ("rmse_vs_oracle", "decision_agreement", "drand48_in_lockstep")}
    out["go_one_step_ms"].update({c: round(r_["go_one_step"]["graph_ms_call"], 4) for c, r_ in maxp["cells"].items()})
    out["ekf_ms_busy"] = {c: [round(r_["ms"], 4), round(r_["busy"], 4)] for c, r_ in ekfs["frames"].items()}
    out["ekf_ms_busy"]["sharded (1, 1)"] = [round(ekfs["sharded"]["stress_frame"]["ms"], 4),
                                            round(ekfs["sharded"]["stress_frame"]["busy"], 4)]
    out["phase_s"] = {"3h": round(xla["seconds"], 1), "3i": round(f64["seconds"], 1), "3j": round(maxp["seconds"], 1),
                      "3g": round(entry.get("seconds", 0.0), 1), "3k": round(ekfs["seconds"], 1)}
    if len(json.dumps(out)) > 4000:
        fail(f"the summary line outgrew 4 KB ({len(json.dumps(out))} bytes)")
    return out


# ------------------------------------------------------------ phase 3j: two partial features at a time

MAXP2 = dict(max_features_to_init_at_once=2)
# the single stream at MAXP 2: stage 8 is K9, K10 and K11 on both partial slots, never K4
MAXP_FUSED_PATH = ("predict_measure", "search", "ekf_update", "propose", "shi_tomasi", "score_map",
                   "particle_predict", "search_bayes_maps")
MAXP_SPLIT_PATH = ("measure", "search", "chol_inv", "propose", "shi_tomasi", "score_map", "particle_predict",
                   "search_bayes_maps")
# cell -> (MonoSLAM overrides, fingerprint file, the step's route, the kernels of its path)
MAXP_CELLS = {
    "std-maxp2": (dict(max_features=16), "expected_fingerprint_maxp2", "fused", MAXP_FUSED_PATH),
    "autoinit-maxp2": (dict(max_features=24), "expected_fingerprint_maxp2_autoinit", "fused", MAXP_FUSED_PATH),
    "mf100-maxp2": (dict(max_features=100), "expected_fingerprint_maxp2_mf100", "split", MAXP_SPLIT_PATH),
}
MAXP_AT = (5, 11, 18)      # output indices whose stage-8 inputs are held: no partial slot, then both searched
MAXP_BOTH = (11, 18)
MAXP_N_REF = 20            # CPU plain replay frames (inits at 9, 10, 16, 17; both slots searched at 11-14, 18)
MAXP_N_REF_ROUTES = 12     # the same for (b)'s routes, and their eager loop (both slots searched at 11)
MAXP_ROUTE_TRACED = 2      # (b)'s traced graph window (~4,000-5,200 device kernels a step)
MAXP_N_SYNC = 10           # steps under sync debug mode "error"
MAXP_TRACED_STEPS = 4
# the single stream's other routes at MAXP 2 (std, max_features 16): route -> (MonoSLAM overrides,
# precision, fingerprint file, the kernels of its path)
MAXP_ROUTES = {
    "xla": (dict(use_pallas=False), "f32", "expected_fingerprint_maxp2_xla", ("chol_inv",)),
    "xla-f64": (dict(use_pallas=False), "f64", "expected_fingerprint_maxp2_f64", ()),
    "k2-f64": (dict(use_pallas=True), "f64", "expected_fingerprint_maxp2_f64_k2", ("search",)),
}
# the batch routes at MAXP 2 over the 64 lanes: route -> (Params changes, batch_sb, precision, path)
MAXP_BATCH_ROUTES = {
    "default": (dict(), None, "f32", BATCH_PATH),
    "sb0": (dict(), False, "f32", ROUTE_PATH["sb0"][1]),
    "bp0": (dict(batch_pallas=False), None, "f32", ROUTE_PATH["bp0"][1]),
    "xla": (dict(use_pallas=False), None, "f32", ()),
    "xla-f64": (dict(use_pallas=False), None, "f64", ()),
}
MAXP_BATCH_AT = 12         # the batch step whose kernel inputs are held (lanes search both slots)
MAXP_BATCH_EAGER = 16      # steps of (c)'s counted eager loops (the graph replay runs all 63 and holds the lanes)
MAXP_CPU_ROUTES = ("default", "xla-f64")   # the batch routes also held to their CPU replay on two lanes
N_MAXP_FILE_LANES = 16     # lanes 0-15: expected_fingerprint_batch16_maxp2.json


def clone_args(a):
    return tuple(t.clone() if isinstance(t, torch.Tensor) else t for t in a)


def maxp_phase(tmp: str, dev, frames, cfg: str, seq, smi: str) -> dict:
    """Phase 3j: two partial features at a time (max_features_to_init_at_once
    = 2) on the card.

    (a) std-maxp2, autoinit-maxp2 (max_features 24) and mf100-maxp2 (100, the
        split route) through MonoSLAM(cfg, max_features_to_init_at_once=2):
        the counted eager loop over the first EAGER_PREFIX frames, each
        kernel of the path launched once a frame (K9, K10 and K11 on both
        slots in place of K4, which never launches); K9, K10 and K11
        bit for bit with their plain versions on the inputs of output
        indices 11 and 18 (both partial slots searched) and 5 (none); the
        CPU plain replay of the first frames; steps under sync debug mode
        "error"; graph_cell (the committed fingerprint, rows and state bit for
        bit with the eager loop's frames, each kernel once a step in a traced
        window); go_one_step one call a frame through the one-step graph over
        the eager loop's frames (rows and state bit for bit, each kernel once
        a call in a trace of three calls). (b) the single stream's routes "xla", "xla-f64" and
        "k2-f64" at MAXP 2 against their files through the graph replay, its
        first MAXP_N_REF_ROUTES frames bit for bit with the eager loop and
        against the CPU replay (f64: r and xv within F64_TOL), its kernel
        once a step in a short trace. (c) 64 lanes at MAXP 2 on "default",
        "sb0", "bp0", "xla" and "xla-f64", each through the eager loop
        (MAXP_BATCH_EAGER steps) and graph_cell (all 63): the graph replay's
        lanes 0-15 equal expected_fingerprint_batch16_maxp2.json, its 64
        lanes on every route the default route's, each route's
        kernels once a step, K9, K10 and K11 (default) and K12 and K13 (sb0)
        bit for bit with their plain versions on a captured step, two lanes
        against their CPU replay (MAXP_CPU_ROUTES), steps under sync debug
        mode "error". Returns each cell's times and the kernels' records at
        the F = 2 shapes."""
    from scenelib2_torch import MonoSLAM
    from scenelib2_torch.eval.batch import check_lanes, lane_fingerprints, lanes_cache_dir, make_lanes
    from scenelib2_torch.eval.fingerprint import decisions_fingerprint, load_expected
    from scenelib2_torch.kernels import _build, bayes, particle, particle_search, score_map, search_bayes
    from scenelib2_torch.parallel.mesh import _run_batch_eager, make_batched_step, run_batch
    from scenelib2_torch.runtime.state import SlamState
    from scenelib2_torch.runtime.step import pack_outputs

    t_phase = time.time()
    res = {"cells": {}, "routes": {}, "batch": {}}
    n_run = seq.shape[0]
    errs = {k: 0.0 for k in ("K9", "K10", "K11", "K12", "K13")}

    def check_fp(o, name, what):
        fp_ = decisions_fingerprint(o, o.n_matched.shape[0])
        want = load_expected(name)
        for k in ("n_frames", "matched_sum", "inits", "convs", "active_end", "decisions_sha256"):
            if fp_[k] != want[k]:
                fail(f"[3j] {what}: fingerprint field {k}: got {fp_[k]}, expected {want[k]} ({name}.json)")
        return fp_

    def check_launches(launches, path, n, what):
        for k in _build.KERNELS:
            if launches.get(k, 0) != (n if k in path else 0):
                fail(f"[3j] {what}: kernel {k} launched {launches.get(k, 0)} times, expected "
                     f"{n if k in path else 0}")

    def against_cpu(got, ref, what, tol, idx=None):
        for k in F64_DECISIONS:
            g = getattr(got, k)[: ref.n_matched.shape[0]]
            if idx is not None:
                g = g[:, idx]
            if not torch.equal(getattr(ref, k), g):
                fail(f"[3j] {what}: CUDA vs CPU plain replay: {k} differs")
        d = 0.0
        for k in ("r", "xv"):
            g = getattr(got, k)[: ref.n_matched.shape[0]]
            g = g if idx is None else g[:, idx]
            d = max(d, float((getattr(ref, k).double() - g.double()).abs().max()))
        if d > tol:
            fail(f"[3j] {what}: CUDA vs CPU plain replay: r / xv differ by {d}")
        return d

    def no_sync(step, state, frames_, n, what):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for t in range(n):
                state, _o = step(state, frames_[t], True)
        except RuntimeError as e:
            fail(f"[3j] {what}: the step synchronised with the host: {e}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()

    # ---- (a) the single stream's kernel routes at MAXP 2
    k9k11 = {}
    for cell, (ov, fp_name, route, path) in MAXP_CELLS.items():
        slam = MonoSLAM(cfg, device="cuda", **ov, **MAXP2)
        if slam._step.route != route:
            fail(f"[3j] {cell}: MonoSLAM took the route {slam._step.route!r}, expected {route}")
        p = slam.params
        slam._run_sequence_eager(seq[:4], enable_mapping=True)    # warm-up
        torch.cuda.synchronize()
        seen, cur, frame = {}, {}, [0]

        def on_call(n, a, k, seen=seen, cur=cur, frame=frame):
            if n in ("score_map", "particle_predict", "search_bayes_maps") and frame[0] in MAXP_AT:
                cur[n] = clone_args(a)
            if n == "search_bayes_maps":
                if frame[0] in MAXP_AT:
                    seen[frame[0]] = dict(cur)
                frame[0] += 1

        n_eager = EAGER_PREFIX
        t0 = time.perf_counter()
        outs, launches, state_eager = run_main_path(slam, seq[:n_eager], mapping=True, on_call=on_call)
        torch.cuda.synchronize()
        eager_s = time.perf_counter() - t0
        check_launches(launches, path, n_eager, f"{cell} eager loop")
        if outs.par_slot.shape != (n_eager, 2) or not torch.isfinite(outs.r).all():
            fail(f"[3j] {cell}: outputs not shaped for two partial slots or not finite")
        log(f"[3j] {cell}: launches (eager loop, frames 1..{n_eager}, {eager_s:.2f} s): "
            f"{json.dumps({k: v for k, v in launches.items() if v})}")
        smc = score_map.ScoreMapConsts.from_params(p)
        for at in MAXP_AT:
            c = seen[at]
            a9, a10, a11 = c["score_map"], c["particle_predict"], c["search_bayes_maps"]
            making, pmask = a11[5], a11[6]
            if making.shape != (1, 2) or bool(making.all()) != (at in MAXP_BOTH) or (
                    at not in MAXP_BOTH and bool(pmask.any())):
                fail(f"[3j] {cell}: output index {at}: making {making.tolist()}, pmask {pmask.tolist()}")
            errs["K9"] = max(errs["K9"], check_k9(a9[0], a9[1], smc))
            errs["K10"] = max(errs["K10"], check_k10(*a10))
            errs["K11"] = max(errs["K11"], check_k11(a11))
        if cell == "std-maxp2":
            k9k11 = seen[MAXP_BOTH[0]]
        log(f"[3j] {cell}: K9, K10 and K11 equal their plain versions bit for bit at output indices "
            f"{MAXP_BOTH} (both partial slots searched) and {MAXP_AT[0]} (none) (max abs err "
            f"{json.dumps({k: errs[k] for k in ('K9', 'K10', 'K11')})})")
        cpu = MonoSLAM(cfg, device="cpu", **ov, **MAXP2)
        d = against_cpu(outs, cpu.run_sequence(frames[1 : MAXP_N_REF + 1], enable_mapping=True), cell, STEP_TOL)
        slam.reset()
        no_sync(slam._step, slam.state, seq, MAXP_N_SYNC, cell)
        log(f"[3j] {cell}: the CUDA run equals the CPU plain replay on frames 1..{MAXP_N_REF} (max |dr|, |dxv| "
            f"{d:.3g}); {MAXP_N_SYNC} steps ran with sync debug mode 'error'")

        run, run_eager = single_runs(slam, seq, True)
        fps = []
        g = graph_cell("3j", cell, run, run_eager, slam._graphs, n_run, path, (outs, state_eager),
                       lambda o, fp_name=fp_name, cell=cell: fps.append(check_fp(o, fp_name, cell)),
                       trace_n=MAXP_TRACED_STEPS, eager_s=eager_s, eager_n=n_eager)
        fp = fps[0]
        log(f"[3j] {cell}: the graph replay's fingerprint {json.dumps(fp)} equals {fp_name}.json")
        r_ = {k: v for k, v in g.items() if k != "prof"}
        r_["device_ms"] = {s: kernel_dev_ms(g["prof"], s) for s in ("k9_kernel", "k10_kernel", "k11_kernel")}
        slam.reset()
        rows, ms = go_calls(slam, frames, n_eager, True, graph=True)
        torch.cuda.synchronize()
        if not same_bits_or_nan(rows.cpu(), pack_outputs(outs)):
            fail(f"[3j] {cell}: go_one_step through the graph: packed rows differ from the eager loop's")
        if not outputs_identical(slam.state, state_eager):
            fail(f"[3j] {cell}: go_one_step through the graph: the state differs from the eager loop's")
        _prof, go_launches = traced_exactly(
            lambda: traced_go_calls(slam, frames), XLA_GO_TRACED, path,
            f"[3j] {cell}: {XLA_GO_TRACED} go_one_step calls")
        r_.update(fingerprint=fp, cpu_max_diff=d, go_one_step=dict(
            graph_ms_call=statistics.median(ms[1:]), first_call_ms=ms[0], calls=n_eager,
            traced_calls=XLA_GO_TRACED, launches={k: v for k, v in go_launches.items() if v}))
        log(f"[3j] {cell}: go_one_step through the one-step graph, {n_eager} calls: every packed row and the "
            f"state bit for bit with the eager loop (held to the graph replay); {statistics.median(ms[1:]):.4f} ms "
            f"a call (median of calls 2..{n_eager}; first {ms[0]:.1f} ms); a trace of {XLA_GO_TRACED} calls "
            f"launched {json.dumps(r_['go_one_step']['launches'])}")
        res["cells"][cell] = r_
        del slam, cpu

    # K9, K10 and K11 at the single stream's F = 2 shapes (std-maxp2, output index 11): times and bounds
    a9, a10, a11 = k9k11["score_map"], k9k11["particle_predict"], k9k11["search_bayes_maps"]
    sbc = a11[8]
    ws = torch.empty_like(a11[0])
    std_cell = res["cells"]["std-maxp2"]
    timed = {}
    for short, key, sym, fk, fp_, cost in (
        ("K9", "score_map", "k9_kernel", lambda: score_map.score_map(a9[0], a9[1], a9[2], out=ws),
         lambda: score_map.score_map_plain(*a9), score_map.bytes_and_flops(1, 2, a9[2])),
        ("K10", "particle_predict", "k10_kernel", lambda: particle.particle_predict(*a10),
         lambda: particle.particle_predict_plain(*a10), particle.bytes_and_flops(*a10[2].shape)),
        ("K11", "search_bayes_maps", "k11_kernel", lambda: search_bayes.search_bayes_maps(*a11),
         lambda: search_bayes.search_bayes_maps_plain(*a11), search_bayes.bytes_and_flops_maps(
             1, 2, a11[2].shape[-1], *search_bayes.work_counts_maps(a11[1], a11[4], a11[5], sbc))),
    ):
        b_ms, b_by = bound([cost])
        timed[short] = dict(ms=time_ms(fk, n=50, batches=3), plain_ms=time_ms(fp_, n=5, batches=3),
                            device_ms=std_cell["device_ms"][sym], bound_ms=b_ms, bound_by=b_by, library_ms=None,
                            launches=std_cell["launches"][key], launches_steps=std_cell["launches_steps"],
                            launches_captured=std_cell["captured"].get(key, 0), max_abs_err=errs[short])
        log(f"[3j] {short} at the single stream's F = 2 shapes (std-maxp2, output index {MAXP_BOTH[0]}): "
            f"{json.dumps(timed[short])}")

    # ---- (b) the single stream's other routes at MAXP 2: the graph replay over every frame (their
    # eager loops, 20-30 s each, run the first MAXP_N_REF frames only)
    from scenelib2_torch.runtime import replay

    for route, (ov, prec, fp_name, path) in MAXP_ROUTES.items():
        tag = f"std-maxp2 {route}"
        slam = MonoSLAM(cfg, max_features=16, device="cuda", precision=prec, **ov, **MAXP2)
        if slam._step.route != route:
            fail(f"[3j] {tag}: MonoSLAM took the route {slam._step.route!r}")
        slam._run_sequence_eager(seq[:4], enable_mapping=True)    # warm-up
        torch.cuda.synchronize()
        run, _run_eager = single_runs(slam, seq, True)
        torch.cuda.reset_peak_memory_stats()
        alloc0 = torch.cuda.memory_allocated()
        _build.reset_launches()
        first_s = timed_s(lambda: run(0))
        t0 = time.perf_counter()
        outs, state_g = run(0)
        torch.cuda.synchronize()
        graph_ms = (time.perf_counter() - t0) / n_run * 1e3
        launches = dict(_build.launches)
        peak_mb = (torch.cuda.max_memory_allocated() - alloc0) / 2**20
        fp = check_fp(outs, fp_name, tag)
        # the first run captured a graph of REPLAY_BLOCK steps and a one-step graph, each after a warm-up
        # step; the second replayed them: each kernel of the path counted once a captured or warm-up step
        sizes = sorted(set(replay.chunk_plan(n_run, 0)))
        check_launches(launches, path, sum(sizes) + len(sizes), f"{tag} graph runs")

        def on_call(n, a, k, path=path, tag=tag):
            # the wrappers of these routes (chol_inv: K14, search: K2) share their launch counts' names
            if n not in path:
                fail(f"[3j] {tag}: the step called the kernel wrapper {n}")

        n_ref, n_tr = MAXP_N_REF_ROUTES, MAXP_ROUTE_TRACED
        t0 = time.perf_counter()
        head, eager_launches, _st = run_main_path(slam, seq[:n_ref], mapping=True, on_call=on_call)
        torch.cuda.synchronize()
        eager_s = time.perf_counter() - t0
        check_launches(eager_launches, path, n_ref, f"{tag} eager loop")
        if not outputs_identical(head, type(outs)(*(t_[:n_ref] for t_ in outs))):
            fail(f"[3j] {tag}: the graph replay's first {n_ref} frames differ from the eager loop's")
        cpu = MonoSLAM(cfg, max_features=16, device="cpu", precision=prec, **ov, **MAXP2)
        tol = F64_TOL if prec == "f64" else STEP_TOL
        d = against_cpu(outs, cpu.run_sequence(frames[1 : n_ref + 1], enable_mapping=True), tag, tol)
        window_ms = timed_s(lambda: run(0, n_tr)) / n_tr * 1e3
        prof, traced = traced_exactly(lambda: run(0, n_tr), n_tr, path,
                                      f"[3j] {tag}: a traced graph run of {n_tr} steps")
        busy = prof["device_ms"] / n_tr
        r_ = dict(eager_ms=eager_s / n_ref * 1e3, eager_steps=n_ref, graph_ms=graph_ms, first_s=first_s, busy=busy,
                  kernels=sum(c for _m, c in prof["by_name"].values()) / n_tr, graph_ms_window=window_ms,
                  idle_graph=1.0 - busy / window_ms, traced_steps=n_tr, launches=traced, launches_steps=n_tr,
                  peak_mb=peak_mb, fingerprint=fp, cpu_max_diff=d)
        r_["idle_eager"] = 1.0 - busy / r_["eager_ms"]
        res["routes"][tag] = r_
        log(f"[3j] {tag}: fingerprint {json.dumps(fp)} equals {fp_name}.json through the graph replay (first call "
            f"{first_s:.3f} s, captures included), launches counted there {json.dumps({k: v for k, v in launches.items() if v})}; "
            f"its first {n_ref} frames equal the eager loop's bit for bit (launches "
            f"{json.dumps({k: v for k, v in eager_launches.items() if v})}) and the CPU {prec} replay (max |dr|, |dxv| "
            f"{d:.3g}, within {tol}); eager {r_['eager_ms']:.4f} ms a frame, graph {graph_ms:.4f} (the second "
            f"run); a traced graph run of {n_tr} steps: busy {busy:.4f} ms a step, "
            f"{r_['kernels']:.2f} device kernels a step, idle share {r_['idle_graph']:.4f} of the graph over those "
            f"steps ({window_ms:.4f} ms a step untraced); peak "
            f"{peak_mb:.1f} MiB")
        del slam, cpu

    # ---- (c) 64 lanes at MAXP 2 on every batch route
    lanes_dir = lanes_cache_dir(cache_root(tmp))
    lanes_by_prec = {}
    default_fps = None
    timed_b = {}
    for route, (change, sb, prec, path) in MAXP_BATCH_ROUTES.items():
        tag = f"batch64-maxp2 {route}"
        if prec not in lanes_by_prec:
            lanes_by_prec[prec] = make_lanes(lanes_dir, N_LANES, N_TEXTURES, N_BATCH_FRAMES, device=dev,
                                             dtype=torch.float64 if prec == "f64" else torch.float32,
                                             config="maxp2")
        bparams, states0, bframes = lanes_by_prec[prec]
        bseq = torch.as_tensor(bframes).to(dev)
        T = bseq.shape[0]
        rparams = dataclasses.replace(bparams, **change)
        step = make_batched_step(rparams, device="cuda", batch_sb=sb, precision=prec)
        if step.route != route or rparams.max_features_to_init_at_once != 2:
            fail(f"[3j] {tag}: the batch step took the route {step.route!r}")
        _run_batch_eager(step, states0, bseq[:2], True, rparams)     # warm-up
        torch.cuda.synchronize()
        cap, n_step = {}, [0]
        # the wrapper each step of the route calls last (the XLA routes call none)
        last = "search_bayes_maps" if "search_bayes_maps" in path else "bayes_update" if "bayes" in path else None

        def keep(n, a, k, cap=cap, n_step=n_step, last=last):
            if n_step[0] == MAXP_BATCH_AT and n in ("score_map", "particle_predict", "search_bayes_maps",
                                                    "particle_search", "bayes_update"):
                cap[n] = (clone_args(a), {x: v.clone() if isinstance(v, torch.Tensor) else v for x, v in k.items()})
            if n == last:
                n_step[0] += 1

        n_eager = MAXP_BATCH_EAGER
        _build.reset_launches()
        t0 = time.perf_counter()
        with observe_wrappers(keep):
            bst_eager, bouts = _run_batch_eager(step, states0, bseq[:n_eager], True, rparams)
        torch.cuda.synchronize()
        beager_s = time.perf_counter() - t0
        blaunches = dict(_build.launches)
        check_launches(blaunches, path, n_eager, f"{tag} eager loop")
        both = []

        def check_batch(o, tag=tag, both=both):
            """The graph replay's lanes: 0-15 against the file, all 64 against the default route's."""
            nonlocal default_fps
            got = lane_fingerprints(o)
            bad = check_lanes(got[:N_MAXP_FILE_LANES], list(range(N_MAXP_FILE_LANES)), route=route, config="maxp2")
            if bad:
                fail(f"[3j] {tag}: {len(bad)} of lanes 0-{N_MAXP_FILE_LANES - 1} differ from "
                     "expected_fingerprint_batch16_maxp2.json:\n" + "\n".join(bad[:6]))
            if default_fps is not None:
                diff = [b for b in range(N_LANES) if got[b] != default_fps[b]]
                if diff:
                    fail(f"[3j] {tag}: lanes {diff} differ from the default route's on the card")
            elif route == "default":
                default_fps = got
            both.append(int(o.par_mask.all(-1).sum()))

        log(f"[3j] {tag}: launches (eager loop, steps 1..{n_eager}, {beager_s:.2f} s) "
            f"{json.dumps({k: v for k, v in blaunches.items() if v})}")
        if route == "default":
            c = cap
            if not bool(c["search_bayes_maps"][0][5].all(-1).any()):
                fail(f"[3j] {tag}: no lane searches both slots at step {MAXP_BATCH_AT}")
            smc_b = score_map.ScoreMapConsts.from_params(rparams)
            errs["K9"] = max(errs["K9"], check_k9(c["score_map"][0][0], c["score_map"][0][1], smc_b))
            errs["K10"] = max(errs["K10"], check_k10(*c["particle_predict"][0]))
            errs["K11"] = max(errs["K11"], check_k11(c["search_bayes_maps"][0]))
            log(f"[3j] {tag}: K9, K10 and K11 equal their plain versions bit for bit at step {MAXP_BATCH_AT} "
                f"({N_LANES} lanes x 2 slots)")
            a9b = c["score_map"][0]
            ws9b = torch.empty((N_LANES, 2, smc_b.H, smc_b.W), dtype=torch.float32, device=dev)
            b_ms, b_by = bound([score_map.bytes_and_flops(N_LANES, 2, smc_b)])
            timed_b["K9 64x2"] = dict(
                ms=time_ms(lambda: score_map.score_map(a9b[0], a9b[1], smc_b, out=ws9b), n=50, batches=3),
                plain_ms=time_ms(lambda: score_map.score_map_plain(a9b[0], a9b[1], smc_b), n=2, batches=3),
                bound_ms=b_ms, bound_by=b_by, library_ms=None, key="score_map", sym="k9_kernel", route=route,
                max_abs_err=errs["K9"])
        if route == "sb0":
            a13 = cap["particle_search"][0]
            a12, kw12 = cap["bayes_update"]
            errs["K13"] = max(errs["K13"], check_k13(a13))
            errs["K12"] = max(errs["K12"], check_k12(a12, kw12))
            Bn, Fn, P = a13[3].shape
            for short, key, sym, fk, fp_, cost in (
                ("K13", "particle_search", "k13_kernel", lambda: particle_search.particle_search(*a13),
                 lambda: particle_search.particle_search_plain(*a13), particle_search.bytes_and_flops(
                     Bn, Fn, P, *particle_search.region_cells(a13[1], a13[2], a13[3], a13[4]))),
                ("K12", "bayes", "k12_kernel", lambda: bayes.bayes_update(*a12, **kw12),
                 lambda: bayes.bayes_update_plain(*(None if t is None else t.reshape(-1, *t.shape[2:])
                                                    for t in a12[:12]), a12[12],
                                                  pred_rows=kw12["pred_rows"].flatten(0, 1)),
                 bayes.bytes_and_flops(Bn * Fn, P)),
            ):
                b_ms, b_by = bound([cost])
                timed_b[short] = dict(ms=time_ms(fk, n=50, batches=3), plain_ms=time_ms(fp_, n=2, batches=3),
                                      bound_ms=b_ms, bound_by=b_by, library_ms=None, key=key, sym=sym,
                                      route=route, max_abs_err=errs[short])
            log(f"[3j] {tag}: K13 and K12 equal their plain versions bit for bit at step {MAXP_BATCH_AT} "
                f"({Bn} lanes x {Fn} slots)")
        d = None
        if route in MAXP_CPU_ROUTES:
            idx = list(ROUTE_REF_LANES)
            cpu_states = SlamState(*(t[idx].cpu() for t in states0))
            _s, bref = run_batch(make_batched_step(rparams, device="cpu", batch_sb=sb, precision=prec), cpu_states,
                                 bframes[:N_ROUTE_REF, idx], True, rparams)
            d = against_cpu(bouts, bref, tag, F64_TOL if prec == "f64" else STEP_TOL, idx)
            log(f"[3j] {tag}: lanes {idx} equal their CPU replay on frames 1..{N_ROUTE_REF} (max |dr|, |dxv| {d:.3g})")
        no_sync(step, states0, bseq, N_SYNC_HYB, tag)
        log(f"[3j] {tag}: {N_SYNC_HYB} steps ran with sync debug mode 'error'")
        brun, brun_eager = batch_runs(step, states0, bseq, rparams)
        gb = graph_cell("3j", tag, brun, brun_eager, step.graphs, T, path, (bouts, bst_eager), check_batch,
                        trace_n=F64_TRACED_STEPS, eager_s=beager_s, eager_n=n_eager)
        log(f"[3j] {tag}: the graph replay's lanes 0-{N_MAXP_FILE_LANES - 1} equal "
            f"expected_fingerprint_batch16_maxp2.json{'' if route == 'default' else ', all 64 lanes the default route'}"
            f" ({both[0]} lane-steps search both slots)")
        r_ = {k: v for k, v in gb.items() if k != "prof"}
        r_.update(frames_per_s=N_LANES / gb["graph_ms"] * 1e3, frames_per_s_eager=N_LANES / gb["eager_ms"] * 1e3,
                  cpu_max_diff=d, both_slot_lane_steps=both[0])
        for short, t_ in timed_b.items():
            if t_.get("route") == route:
                key, sym, _r = t_.pop("key"), t_.pop("sym"), t_.pop("route")
                t_.update(device_ms=kernel_dev_ms(gb["prof"], sym), launches=gb["launches"][key],
                          launches_steps=gb["launches_steps"], launches_captured=gb["captured"].get(key, 0))
                log(f"[3j] {short} at F = 2 over {N_LANES} lanes ({route} maxp2, step {MAXP_BATCH_AT}): "
                    f"{json.dumps(t_)}")
        res["batch"][route] = r_
        del step, gb
    timed.update(timed_b)
    res["timed"] = timed
    res["errs"] = errs
    res["seconds"] = time.time() - t_phase
    log(f"[3j] phase 3j took {res['seconds']:.1f} s on {smi}")
    return res


# ------------------------------------------------------------ phase 3k: the large-map EKF frames

# bench: (n_feat, slot_dim, predict, dtype) of eval/benchmark.py's five EKF benches
EKF_BENCHES = {"stress500": (500, 6, True, torch.float64), "stress500packed": (500, 3, True, torch.float64),
               "stress500f32": (500, 6, True, torch.float32), "ekf100": (100, 6, False, torch.float64),
               "ekf100f32": (100, 6, False, torch.float32)}
EKF_FRAMES = 3            # frames held against the CPU frame, and the graph against the eager frames
EKF_TRACED = 3            # frames of a traced graph window
EKF_SHARD_STEPS = 50      # the sharded frame's timed replays (best of 3 runs)
EKF_LANE_FRAMES = 16      # frames of the lane-sharded batch step (REF_LANES)


def ekf_close(got, want, what: str, p_rtol: float = 1e-8) -> tuple[float, float]:
    """(max |dx|, max |dP|) of got (x, P) against want (x, P): f64 within x
    rtol 1e-10 / atol 1e-12, P rtol p_rtol / atol 1e-10 (the JAX package's
    bars, tests/test_parallel.py); f32 within 1e-5 of max |x| and 1e-4 of
    max |P| (tests/test_torch_ekf_frame_jax.py)."""
    (x, P), (xr, Pr) = (t.cpu() for t in got), (t.cpu() for t in want)
    if x.dtype == torch.float64:
        ok = torch.allclose(x, xr, rtol=1e-10, atol=1e-12) and torch.allclose(P, Pr, rtol=p_rtol, atol=1e-10)
    else:
        ok = (bool((x - xr).abs().max() <= 1e-5 * xr.abs().max())
              and bool((P - Pr).abs().max() <= 1e-4 * Pr.abs().max()))
    dx, dP = float((x - xr).abs().max()), float((P - Pr).abs().max())
    if not ok:
        fail(f"[3k] {what}: x differs by {dx}, P by {dP}")
    return dx, dP


def frame_cell(fn, state, eager_end, what: str, n_timed: int = 0) -> dict:
    """A large-map frame fn(*state) -> (*state', top_idx) through a one-frame
    CUDA graph (runtime/replay.py::FrameGraph): the capture (no counted
    kernel launched, the capture under sync debug mode "error"), EKF_FRAMES
    replays bit for bit with eager_end (the state and top_idx after as many
    eager frames), with n_timed ms a frame (best of 3 runs of n_timed
    replays from state, one sync at the end of each), a traced window of
    EKF_TRACED replays (busy ms and device kernels a frame, no counted
    kernel), peak MiB over the capture and the replays."""
    from scenelib2_torch.kernels import _build
    from scenelib2_torch.runtime.replay import FrameGraph

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    alloc0 = torch.cuda.memory_allocated()
    _build.reset_launches()
    t0 = time.perf_counter()
    g = FrameGraph(fn, state)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    launched = {k: v for k, v in _build.launches.items() if v}
    if launched or any(g.launches.values()):
        fail(f"[3k] {what}: the frame launched counted kernels: {json.dumps(launched)}")
    end = g.replay(EKF_FRAMES)
    if not (all(same(a, b) for a, b in zip(end, eager_end[:len(end)])) and same(g.extra[0], eager_end[-1])):
        fail(f"[3k] {what}: {EKF_FRAMES} graph replays differ from as many eager frames")
    out = {}
    if n_timed:
        best = float("inf")
        for _ in range(3):
            for dst, src in zip(g.state, state):
                dst.copy_(src)
            best = min(best, timed_s(lambda: g.replay(n_timed)))
        out = dict(ms=best / n_timed * 1e3, steps=n_timed)
    for dst, src in zip(g.state, state):
        dst.copy_(src)
    profiler_warmup()
    prof = device_profile(lambda: g.replay(EKF_TRACED))
    counted = {k: v for k, v in traced_launches(prof).items() if v}
    if counted:
        fail(f"[3k] {what}: the traced frames ran counted kernels {json.dumps(counted)}")
    return dict(out, capture_s=capture_s, busy=prof["device_ms"] / EKF_TRACED,
                kernels=sum(c for _m, c in prof["by_name"].values()) / EKF_TRACED,
                peak_mb=(torch.cuda.max_memory_allocated() - alloc0) / 2**20, launches=launched,
                top=sorted(((round(ms_ / EKF_TRACED, 4), k[:90]) for k, (ms_, _c) in prof["by_name"].items()),
                           reverse=True)[:3])


def ekf_frame_bound(D: int, itemsize: int, M: int = 20) -> tuple[float, str]:
    """(ms, "bytes" or "operations") of the least time of one large-map EKF
    frame: P read twice (P H' before S is known, then the update) and
    written once, against the update's three D-sized products (H P, P H',
    W S W': 2 M D^2 operations each) at the float32 rate of PEAK_F32 (the
    published FP64 tensor-core rate is the same 67 TFLOP/s); the slot
    chain, the factorisation and the 13 camera rows are O(n_feat + M^3 +
    13 D) and left out."""
    b, f = 3 * D * D * itemsize / PEAK_BYTES, 3 * 2 * M * D * D / PEAK_F32
    return max(b, f) * 1e3, "bytes" if b >= f else "operations"


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def ekf_frames_phase(tmp: str, dev, smi: str) -> dict:
    """Phase 3k: the large-map EKF frame (eval/benchmark.py, runtime/
    assembly.py) and the sharded-covariance EKF (parallel/mesh.py). (a) Each
    of the five EKF benches' frames: EKF_FRAMES eager frames on the card
    (sync debug mode "error", no counted kernel launched) against the CPU
    frame from the same _make_map_state (top_idx equal, x / P within
    ekf_close), frame_cell, and the bench itself (its ms/step: best of 3
    runs of its steps through the graph). (b) On a one-rank NCCL process
    group: the sharded stress frame on a (1, 1) mesh at D = 3013, EKF_FRAMES
    frames against the unsharded frame on the card (top_idx equal, P rtol
    1e-7 as tests/test_parallel.py), frame_cell and its ms a frame through
    the graph; sharded_joint_update, sharded_predict and sharded_slam_frame
    at D = 3013 against core.ekf's compositions; the batch step over a (1,)
    lane mesh equal to run_batch lane for lane; then the process group is
    destroyed."""
    import torch.distributed as dist

    from scenelib2_torch.config import Params
    from scenelib2_torch.core import ekf
    from scenelib2_torch.eval import benchmark
    from scenelib2_torch.eval.batch import lanes_cache_dir, make_lanes
    from scenelib2_torch.kernels import _build
    from scenelib2_torch.parallel import mesh as pm
    from scenelib2_torch.runtime.replay import sync_error

    t_phase = time.time()
    if torch.backends.cuda.matmul.allow_tf32:
        fail("[3k] TF32 is on (torch.backends.cuda.matmul.allow_tf32)")
    res = {"frames": {}, "sharded": {}, "tf32": torch.backends.cuda.matmul.allow_tf32}
    params = Params()
    for name, (n_feat, slot_dim, predict, dtype) in EKF_BENCHES.items():
        x0, P0, _ = benchmark._make_map_state(n_feat, slot_dim)
        frame = benchmark._make_ekf_frame(params, n_feat, slot_dim, predict=predict)
        xc, Pc = torch.tensor(x0, dtype=dtype), torch.tensor(P0, dtype=dtype)
        start = (xc.to(dev), Pc.to(dev))
        frame(*start)         # a first call: cuBLAS's handle and workspace
        xg, Pg = start
        cpu, gpu = [], []
        torch.cuda.synchronize()
        _build.reset_launches()
        with sync_error():
            for _f in range(EKF_FRAMES):
                xg, Pg, tg = frame(xg, Pg)
                gpu.append((xg, Pg, tg))
        torch.cuda.synchronize()
        launched = {k: v for k, v in _build.launches.items() if v}
        if launched:
            fail(f"[3k] {name}: the eager frames launched counted kernels {json.dumps(launched)}")
        for _f in range(EKF_FRAMES):
            xc, Pc, tc = frame(xc, Pc)
            cpu.append((xc, Pc, tc))
        diffs = []
        for f, ((xg_, Pg_, tg_), (xc_, Pc_, tc_)) in enumerate(zip(gpu, cpu)):
            if not same(tg_, tc_):
                fail(f"[3k] {name} frame {f}: top_idx {tg_.tolist()} on the card, {tc_.tolist()} on the CPU")
            diffs.append(ekf_close((xg_, Pg_), (xc_, Pc_), f"{name} frame {f}: card against CPU"))
        cell = frame_cell(frame, start, gpu[-1], name)
        bench = benchmark.ALL_BENCHES[name](device=dev)
        b_ms, b_by = ekf_frame_bound(bench["state_dim"], start[1].element_size())
        cell.update(metric=bench["metric"], ms=bench["value"], steps=bench["steps"], state_dim=bench["state_dim"],
                    dtype=bench["dtype"], cpu_max_diff=[max(d[0] for d in diffs), max(d[1] for d in diffs)],
                    bound_ms=b_ms, bound_by=b_by)
        res["frames"][name] = cell
        log(f"[3k] {name} (D = {bench['state_dim']}, {bench['dtype']}): {EKF_FRAMES} eager frames on the card "
            f"(sync debug mode 'error', no counted kernel) equal the CPU frame's top_idx and hold x, P "
            f"(max |dx|, |dP| {cell['cpu_max_diff']}); the graph's {EKF_FRAMES} replays equal them bit for bit; "
            f"{bench['metric']} {bench['value']} ms/step (best of 3 x {bench['steps']} graph replays; bound "
            f"{b_ms:.5f} ms, {b_by}); busy "
            f"{cell['busy']:.4f} ms, {cell['kernels']:.1f} device kernels a frame; peak {cell['peak_mb']:.1f} MiB; "
            f"capture {cell['capture_s']:.2f} s; top kernels {cell['top']}")

    # ---- (b) the sharded EKF on a one-rank NCCL mesh
    torch.cuda.set_device(dev.index or 0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0, world_size=1)
    try:
        mesh = pm.make_mesh((1, 1), ("row", "col"))
        n_feat, slot_dim = 500, 6
        x0, P0, _ = benchmark._make_map_state(n_feat, slot_dim)
        D = pm.pad_for_mesh(x0.shape[0], 1, 1)
        u = torch.zeros(3, dtype=torch.float64, device=dev)
        sframe = pm.sharded_stress_frame(mesh, params, n_feat, slot_dim, 10)
        dense = benchmark._make_ekf_frame(params, n_feat, slot_dim)
        start = pm.shard_state(mesh, x0, P0)
        if tuple(start[1].shape) != (D, D):
            fail(f"[3k] the (1, 1) mesh's block is {tuple(start[1].shape)}")
        xd, Pd = (torch.as_tensor(a).to(dev) for a in (x0, P0))
        sframe(*start, u)     # the first collectives set up NCCL's communicators
        xs, Ps = start
        sh, dn = [], []
        torch.cuda.synchronize()
        _build.reset_launches()
        with sync_error():
            for _f in range(EKF_FRAMES):
                xs, Ps, ts = sframe(xs, Ps, u)
                xd, Pd, td = dense(xd, Pd)
                sh.append((xs, Ps, ts))
                dn.append((xd, Pd, td))
        torch.cuda.synchronize()
        if any(_build.launches.values()):
            fail(f"[3k] the sharded frame launched counted kernels {json.dumps(_build.launches)}")
        diffs = []
        for f, (a, b) in enumerate(zip(sh, dn)):
            if not same(a[2], b[2]):
                fail(f"[3k] sharded stress frame {f}: top_idx {a[2].tolist()}, unsharded {b[2].tolist()}")
            gx, gP = pm.gather_state(mesh, a[0], a[1])
            diffs.append(ekf_close((gx, gP), b[:2], f"sharded stress frame {f} against the unsharded frame",
                                   p_rtol=1e-7))
        cell = frame_cell(lambda x, P: sframe(x, P, u), start, sh[-1], "sharded stress frame",
                          n_timed=EKF_SHARD_STEPS)
        cell["cpu_max_diff"] = [max(d[0] for d in diffs), max(d[1] for d in diffs)]
        cell["bound_ms"], cell["bound_by"] = ekf_frame_bound(D, 8)
        res["sharded"]["stress_frame"] = cell
        log(f"[3k] sharded_stress_frame on a (1, 1) NCCL mesh (D = {D}, block {tuple(start[1].shape)}): "
            f"{EKF_FRAMES} frames (sync debug mode 'error', no counted kernel) equal the unsharded frame's top_idx "
            f"and hold x, P (max |dx|, |dP| {cell['cpu_max_diff']}); the graph's replays equal them bit for bit; "
            f"{cell['ms']:.4f} ms a frame (best of 3 x {EKF_SHARD_STEPS} replays); busy {cell['busy']:.4f} ms, "
            f"{cell['kernels']:.1f} device kernels a frame; peak {cell['peak_mb']:.1f} MiB; top kernels {cell['top']}")

        # the other sharded functions at D = 3013, M = 20, against core.ekf's compositions
        gen = torch.Generator(device=dev).manual_seed(2026)
        M = 20
        A = torch.randn((D, D), generator=gen, dtype=torch.float64, device=dev) * 0.05
        P = A @ A.mT + torch.eye(D, dtype=torch.float64, device=dev)
        x = torch.zeros(D, dtype=torch.float64, device=dev)
        x[3] = 1.0
        x[7:13] = torch.randn(6, generator=gen, dtype=torch.float64, device=dev) * 0.1
        H = torch.zeros((M, D), dtype=torch.float64, device=dev)
        H[:, 13:13 + M] = torch.eye(M, dtype=torch.float64, device=dev)
        H[:, :13] = torch.randn((M, 13), generator=gen, dtype=torch.float64, device=dev) * 0.1
        nu = torch.randn(M, generator=gen, dtype=torch.float64, device=dev) * 0.01
        R = torch.eye(M, dtype=torch.float64, device=dev) * 1.2
        up = torch.randn(3, generator=gen, dtype=torch.float64, device=dev) * 0.01
        xp_, Pp_ = ekf.predict(x, P, up, params.delta_t, params.sd_a, params.sd_alpha)
        xu_, Pu_, _ = ekf.joint_update(x, P, H, nu, R, blas=True)
        xf_, Pf_ = ekf.predict(x, P, u, params.delta_t, params.sd_a, params.sd_alpha)
        xf_, Pf_, _ = ekf.joint_update(xf_, Pf_, H, nu, R, blas=True)
        xf_, Pf_ = ekf.normalise(xf_, Pf_)
        Pf_ = ekf.symmetrize(Pf_)
        fns = {"sharded_predict": (pm.sharded_predict(mesh, D), (up,)),
               "sharded_joint_update": (pm.sharded_joint_update(mesh, D, M), (H, nu, R)),
               "sharded_slam_frame": (pm.sharded_slam_frame(mesh, D, M), (u, H, nu, R))}
        blocks = pm.shard_state(mesh, x, P)
        for fn_, rest in fns.values():    # a first call: cuSOLVER's and cuBLAS's handles
            fn_(*blocks, *rest)
        torch.cuda.synchronize()
        _build.reset_launches()
        with sync_error():
            got = {k: fn_(*blocks, *rest) for k, (fn_, rest) in fns.items()}
        torch.cuda.synchronize()
        if any(_build.launches.values()):
            fail(f"[3k] the sharded functions launched counted kernels {json.dumps(_build.launches)}")
        for fname, want, tols in (("sharded_predict", (xp_, Pp_), ((1e-12, 1e-15), (1e-12, 1e-15))),
                                  ("sharded_joint_update", (xu_, Pu_), ((1e-10, 0.0), (1e-8, 1e-10))),
                                  ("sharded_slam_frame", (xf_, Pf_), ((1e-11, 1e-13), (1e-8, 1e-11)))):
            gx, gP = pm.gather_state(mesh, *got[fname])
            (xr, xa), (pr, pa) = tols
            if not (torch.allclose(gx, want[0], rtol=xr, atol=xa) and torch.allclose(gP, want[1], rtol=pr, atol=pa)):
                fail(f"[3k] {fname} at D = {D} differs from its unsharded composition (max |dx| "
                     f"{max_err(gx, want[0])}, |dP| {max_err(gP, want[1])})")
            res["sharded"][fname] = [max_err(gx, want[0]), max_err(gP, want[1])]
        log(f"[3k] sharded_predict, sharded_joint_update and sharded_slam_frame at D = {D}, M = {M} on the (1, 1) "
            f"mesh equal core.ekf's compositions on the card within the JAX package's bars (max |dx|, |dP| "
            f"{json.dumps({k: v for k, v in res['sharded'].items() if k != 'stress_frame'})}); sync debug mode "
            f"'error', no counted kernel")

        # lanes over a (1,) mesh: the batch step's run_batch(mesh=) against run_batch
        lanes = pm.make_mesh((1,), ("data",))
        bparams, st0, bfr = make_lanes(lanes_cache_dir(cache_root(tmp)), N_LANES, N_TEXTURES, N_BATCH_FRAMES,
                                       device=dev, dtype=torch.float32, lanes=list(REF_LANES))
        bseq = torch.as_tensor(bfr[:EKF_LANE_FRAMES]).to(dev)
        bstep = pm.make_batched_step(bparams, device="cuda")
        one = pm.run_batch(bstep, st0, bseq, True, bparams)
        shd = pm.run_batch(bstep, st0, bseq, True, bparams, mesh=lanes)
        if not (outputs_identical(one[1], shd[1]) and outputs_identical(one[0], shd[0])):
            fail("[3k] the batch step over the (1,) lane mesh differs from run_batch")
        res["lanes"] = dict(lanes=len(REF_LANES), frames=EKF_LANE_FRAMES)
        log(f"[3k] run_batch over a (1,) NCCL lane mesh equals run_batch lane for lane, bit for bit ("
            f"{len(REF_LANES)} lanes x {EKF_LANE_FRAMES} frames: outputs and final states)")
    finally:
        dist.destroy_process_group()
    res["seconds"] = time.time() - t_phase
    log(f"[3k] phase 3k took {res['seconds']:.1f} s on {smi}")
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    from scenelib2_torch import MonoSLAM
    from scenelib2_torch.eval.fingerprint import decisions_fingerprint, load_expected
    from scenelib2_torch.eval.synthetic import HIRES_PARAMS, generate_dataset
    from scenelib2_torch.kernels import (
        _build, bayes, ekf_update, measure, particle, predict_measure, propose, score_map, search,
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
    variants = build_variants()
    _build.build_all(verbose=True, variants=variants)
    for n in _build.SOURCES:
        _build.load(n)
    for n, defines in variants:
        _build.load(n, defines)
    sizes = ", ".join(f"{n} M = {dict(d)['CHOL_REG_M']}" for n, d in variants)
    log(f"[1] built {len(_build.SOURCES)} kernel libraries and {len(variants)} register-form builds ({sizes}) "
        f"in {time.time() - t0:.1f} s")

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
        # K1 at the hires shapes (D = 373, 640x480 constants) and at MAXP 2, with
        # a NaN lane, no partial slot and every slot partial
        ph = dataclasses.replace(p, **HIRES_PARAMS)
        k1kw_h = dict(k1kw, nsel=ph.n_features_to_select, consts=MeasureConsts.from_params(ph))
        for trial, (pp, kw_, maxp, part) in enumerate((
                (ph, k1kw_h, 1, 0.1), (ph, k1kw_h, 2, 0.1), (ph, k1kw_h, 2, 0.0), (ph, k1kw_h, 2, 1.0),
                (p, k1kw, 2, 0.3), (p, k1kw, 2, 1.0))):
            errs["K1"] = max(errs["K1"], check_k1(
                k1_random_scene(rng, pp, dev, nan_lane=trial < 2, partial=part), dict(kw_, maxp=maxp)))
        # M = 34 > 32: K3 factorises with the whole block instead of one warp;
        # M = 16 and 32: the register form at an M of no configuration
        p34 = dataclasses.replace(p, max_features=20, n_features_to_select=17)
        errs["K3"] = max(errs["K3"], check_k3(k3_random_scene(rng, p34, dev, "mixed"), uc))
        for nsel in K3_MORE_NSEL:
            pm = dataclasses.replace(p, n_features_to_select=nsel)
            errs["K3"] = max(errs["K3"], check_k3(k3_random_scene(rng, pm, dev, "mixed"), uc))
        seen = capture_inputs(slam, frames, at=(9, 20, 120))
        a1, kw1 = seen[120]["predict_measure"]
        a2, _ = seen[120]["search"]
        a3, _ = seen[120]["joint_update"]
        errs["K1"] = max(errs["K1"], check_k1(a1, kw1))
        errs["K2"] = max(errs["K2"], check_k2(a2[:-1], sc))
        errs["K3"] = max(errs["K3"], check_k3(a3[:-1], uc))
        n_edge = 0
        for ep, n_lanes in ((p, N_LANES), (dataclasses.replace(p, **HIRES_PARAMS), N_HIRES_LANES)):
            n, e = check_search_edges(rng, ep, dev, n_lanes)
            n_edge += n
            errs["K2"] = max(errs["K2"], e)
        log(f"[2] K2 and K8 bit for bit on {n_edge} seeded edge cases (320x240 and 640x480; K = 1, 10, "
            f"{N_LANES} x 10 and {N_HIRES_LANES} x 10 lanes; kinds {', '.join(SEARCH_KINDS)})")
        wide_errs, wide_timed = check_wide_windows(rng, p, dev)
        n_cases = {"K4": 0, "K5": 0, "K6": 0}
        k5_consumed = {}
        for at in (9, 20, 120):
            a5, _ = seen[at]["propose_region"]
            for tries in (a5[6].tries,) + K5_MORE_TRIES:
                c5 = dataclasses.replace(a5[6], tries=tries)
                for label, args in k5_region_variations(tuple(a5[:6]) + (c5,), rng):
                    errs["K5"] = max(errs["K5"], check_k5(args))
                    n_cases["K5"] += 1
                    if label in ("real", "all_clash"):
                        k5_consumed[f"{at}/{tries}/{label}"] = draws_consumed(k5_jax_args(args))
            a6, kw6 = seen[at]["shi_tomasi"]
            for _label, args in k6_variations(tuple(a6) + (kw6,), rng, H, W):
                errs["K6"] = max(errs["K6"], check_k6(args))
                n_cases["K6"] += 1
            a4, _ = seen[at]["search_bayes"]
            for _label, args in k4_variations(a4, rng, H, W, B, p.erase_partial_after_attempts):
                errs["K4"] = max(errs["K4"], check_k4(args))
                n_cases["K4"] += 1
        most = K5_MORE_TRIES[-1]
        if 2 * most not in (k5_consumed[f"{at}/{most}/all_clash"] for at in (9, 20, 120)):
            fail(f"K5 at {most} tries: no case consumed all {2 * most} draws, so the draws past the staged "
                 f"ones and the limbs after them went unchecked ({json.dumps(k5_consumed)})")
        log(f"[2] kernels equal their plain versions: K1-K3 on 6 random scenes + frame 120 (K3 also at M = 16, 32 and 34; "
            f"K1 also at D = 373 and MAXP 2 with a NaN lane, no and every slot partial), "
            f"K4/K5/K6 on {n_cases} cases from frames 9, 20, 120 and their variations, K5 at tries "
            f"{p.init_region_tries} and {K5_MORE_TRIES} (draws consumed, frame/tries/case: "
            f"{json.dumps(k5_consumed)}) (max abs err {json.dumps(errs)})")
        k14_err = 0.0
        for label, S in k14_random_cases(rng, dev):
            k14_err = max(k14_err, check_k14(S))
        log(f"[2] K14 equals its plain version bit for bit on seeded matrices (SPD at M = 1, 2, 7, 20, 31, "
            f"32, 33, 64, 128, stacks of 3 and 64 at M = 20, an EKF-shaped S with missed rows, a negative "
            f"pivot and an infinite entry at M = 20 and 40) (max abs err {k14_err})")

        # ---- 2b. the widened particle kernels; K10b, K15, K16 (entry points of their own)
        werrs = check_wide(rng, p, dev)
        log(f"[2b] K10, K11 (making and not), K12 (both forms) and K4 (with its variations) equal their "
            f"plain versions at NP = {WIDE_NP} on seeded slots (rows of 256, 512, 1,152, 5,120 and "
            f"16,384 lanes) "
            f"(max abs err {json.dumps(werrs)})")
        lerrs = {"K10b": 0.0, "K15": 0.0, "K16": 0.0}
        for _label, args in k10b_seeded(rng, p, dev):
            lerrs["K10b"] = max(lerrs["K10b"], check_k10b(*args))
        for kw in (dict(), dict(any_succ=False), dict(nan_deleted=True), dict(nan_deleted=True, any_succ=False),
                   dict(D=128, M=128, n_bad=3), dict(D=19, M=2, n_bad=0)):
            lerrs["K15"] = max(lerrs["K15"], check_k15(k15_seeded(rng, dev, **kw)))
        for D, M in K15_SIZES:
            lerrs["K15"] = max(lerrs["K15"], check_k15(k15_seeded(rng, dev, D=D, M=M, n_bad=min(2, max(0, (D - 13) // 6)))))
        n15 = 0
        for _label, args in k15_nonfinite(rng, dev):
            lerrs["K15"] = max(lerrs["K15"], check_k15(args))
            n15 += 1
        a15, k3_res = k15_from_k3(a3[:-1], uc)
        lerrs["K15"] = max(lerrs["K15"], check_k15(a15))
        k15_res = ekf_update.joint_update_dense(*a15)
        torch.cuda.synchronize()
        if not (same_floats(k15_res[0], k3_res[0]) and same_floats(k15_res[1], k3_res[1])):
            fail("K15 on the JAX XLA branch's H, nu, R differs from K3 on frame 120")
        k15_vs_k3 = max(max_err(k15_res[0], k3_res[0]), max_err(k15_res[1], k3_res[1]))
        for wr in (16, p.particle_win_radius):
            lerrs["K16"] = max(lerrs["K16"], check_k16(k16_seeded(rng, p, dev), dict(
                win_radius=wr, no_sigma=p.no_sigma, corr_thresh2=p.corr_thresh2)))
        more16 = k16_more(rng, p, dev)
        for _label, args, kw in more16:
            lerrs["K16"] = max(lerrs["K16"], check_k16(args, kw))
        log(f"[2b] K10b (NP x slots {K10B_SEEDED}, degenerate depths), K15 (D = 109 and 128 x M = 128, any_succ false, "
            f"a NaN in a deleted slot; (D, M) = {list(K15_SIZES)}; {n15} placements of NaN, inf and -inf) and "
            f"K16 (centres off the frame, NaN centre and S^-1, an indefinite S^-1, dead particles, a tie, a "
            f"NaN score; {[lb for lb, _a, _k in more16]}) equal their plain versions on seeded cases, K15 also "
            f"on frame 120 (max abs err {json.dumps(lerrs)}); K15 on the XLA branch's H, nu, R of frame 120 "
            f"equals K3 bit for bit (max abs err {k15_vs_k3})")
        last = {"K15": dict(
            ms=time_ms(lambda: ekf_update.joint_update_dense(*a15)),
            plain_ms=time_ms(lambda: ekf_update.joint_update_dense_plain(*a15), n=5, batches=3),
            device_ms=kernel_device_ms(lambda: ekf_update.joint_update_dense(*a15), "k15_kernel"),
            costs=[ekf_update.bytes_and_flops_dense(a15[0].shape[0], a15[3].shape[0])], inputs="frame 120")}
        for form, key in ((False, "K12"), (True, "K12 pred rows")):
            a12w, kw12w = k12_seeded(rng, p, dev, form, n_rows=16, NP=200)
            last[f"{key} NP200"] = dict(
                ms=time_ms(lambda: bayes.bayes_update(*a12w, **kw12w)),
                plain_ms=time_ms(lambda: bayes.bayes_update_plain(
                    *(None if t is None else t.reshape(-1, *t.shape[2:]) for t in a12w[:12]), a12w[12],
                    pred_rows=(None if not form else kw12w["pred_rows"].reshape(16, 8, -1))), n=5, batches=3),
                device_ms=kernel_device_ms(lambda: bayes.bayes_update(*a12w, **kw12w), "k12_kernel"),
                costs=[bayes.bytes_and_flops(16, 200)], inputs="16 seeded rows x 200 particles")
        for k, v in last.items():
            log(f"[2b] {k}: kernel {v['ms']:.4f} ms/launch (device {v['device_ms']}), plain {v['plain_ms']:.4f} ms "
                f"({v['inputs']})")

        a4, _ = seen[20]["search_bayes"]
        a5, _ = seen[9]["propose_region"]
        a6, kw6 = seen[9]["shi_tomasi"]
        timings = {}
        for name, kern, plain in (
            ("K1", lambda: predict_measure.predict_measure(*a1, **kw1),
             lambda: predict_measure.predict_measure_plain(*a1, **kw1)),
            ("K2", lambda: search.search(*a2), lambda: search.search_plain(*a2)),
            ("K3", lambda: ekf_update.joint_update(*a3), lambda: ekf_update.joint_update_plain(*a3)),
            ("K4", lambda: search_bayes.search_bayes(*a4), lambda: search_bayes.search_bayes_plain(*a4)),
            ("K5", lambda: propose.propose_region(*a5), lambda: propose.propose_region_plain(*a5)),
            ("K6", lambda: shi_tomasi.shi_tomasi(*a6, **kw6), lambda: shi_tomasi.shi_tomasi_plain(*a6, **kw6)),
        ):
            timings[name] = (time_ms(kern), time_ms(plain, n=10, batches=3))
        empty = _build.function("predict_measure", "k0_empty_launch", [ctypes.c_int] * 3 + [ctypes.c_void_p])
        empty_ms = time_ms(lambda: empty(1, 1, 32, torch.cuda.current_stream().cuda_stream))
        for name, (k_ms, p_ms) in timings.items():
            log(f"[2] {name}: kernel {k_ms:.4f} ms/launch, plain {p_ms:.4f} ms/call "
                f"(frame-{dict(K4=20, K5=9, K6=9).get(name, 120)} inputs)")
        # K5 at the most tries of phase 2, on frame 9's inputs
        a5_40 = tuple(a5[:6]) + (dataclasses.replace(a5[6], tries=K5_TIMED_TRIES),)
        last["K5 tries"] = dict(
            ms=time_ms(lambda: propose.propose_region(*a5_40)),
            plain_ms=time_ms(lambda: propose.propose_region_plain(*a5_40), n=10, batches=3),
            device_ms=kernel_device_ms(lambda: propose.propose_region(*a5_40), "k5_kernel"),
            costs=[propose.bytes_and_flops(a5[2].shape[0], K5_TIMED_TRIES)],
            inputs=f"frame 9 at tries {K5_TIMED_TRIES}")
        log(f"[2] K5 at tries {K5_TIMED_TRIES}: kernel {last['K5 tries']['ms']:.4f} ms/launch (device "
            f"{last['K5 tries']['device_ms']}), plain {last['K5 tries']['plain_ms']:.4f} ms")
        log(f"[2] empty kernel launch: {empty_ms:.4f} ms")

        # ---- 3. main paths ------------------------------------------------
        seq = torch.as_tensor(frames[1:]).to(dev)
        n_run = seq.shape[0]
        slam.reset()
        slam._run_sequence_eager(seq[:8], enable_mapping=True)    # warm-up
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

        outs_nomap, launches_nomap, state_nomap = run_main_path(slam, seq, mapping=False)
        check_fingerprint(outs_nomap, "expected_fingerprint_nomap")
        check_launches(launches_nomap, "mapping-off (eager loop)", stage7=False)

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
            elif n == "propose_region":
                costs["K5"].append(propose.bytes_and_flops(a[2].shape[0], a[6].tries))
            elif n == "shi_tomasi":
                costs["K6"].append(shi_tomasi.bytes_and_flops(k["boxsize"], k["region_w"], k["region_h"]))
            else:
                k4_args.append(a)

        outs, launches, state_on = run_main_path(slam, seq, mapping=True, on_call=record_cost)
        check_fingerprint(outs, "expected_fingerprint")
        check_launches(launches, "mapping-on (eager loop)", stage7=True)
        for a in k4_args:
            MF, NP = a[1].shape
            costs["K4"].append(search_bayes.bytes_and_flops(
                MF, NP, H, W, B, *search_bayes.work_counts(*on_cpu(a))))
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

        # a search radius and an init region past the old caps (K2's windows
        # of 221 x 221 centres, K6's window of 112 x 72 pixels): the first
        # frames on the card against the port's CPU run, decision by decision
        # (through graphs: their warm-up steps and their captures launch each
        # kernel of the path once a step)
        wide = dict(search_win_radius=110, init_search_width=100)
        wslam = MonoSLAM(cfg, max_features=16, device="cuda", **wide)
        torch.cuda.synchronize()
        _build.reset_launches()
        wouts = wslam.run_sequence(seq[:N_REF], enable_mapping=True)
        wide_launches = dict(_build.launches)
        # each captured step and each graph's warm-up step
        wide_want = sum(g_.n for g_ in wslam._graphs.values()) + len(wslam._graphs)
        wref = MonoSLAM(cfg, max_features=16, device="cpu", **wide).run_sequence(
            frames[1 : N_REF + 1], enable_mapping=True)
        for k in ("n_visible", "n_selected", "n_matched", "n_active", "n_partial", "did_init",
                  "did_convert", "n_overflow", "sel_slot", "sel_matched", "init_box", "par_alive"):
            if not torch.equal(getattr(wref, k), getattr(wouts, k)):
                fail(f"search radius 110, init region 100: CUDA vs CPU run: {k} differs in the first {N_REF} frames")
        dw = float((wref.xv.double() - wouts.xv.double()).abs().max())
        if dw > STEP_TOL:
            fail(f"search radius 110, init region 100: CUDA vs CPU run: xv differs by {dw}")
        for n in _build.KERNELS:
            if wide_launches.get(n, 0) != (wide_want if n in SINGLE_PATH else 0):
                fail(f"search radius 110, init region 100: kernel {n} launched {wide_launches.get(n, 0)} times")
        log(f"[3] search radius 110 and init region 100: the CUDA run equals the port's CPU run on frames "
            f"1..{N_REF} decision by decision (inits at {torch.nonzero(wref.did_init).flatten().tolist()}, "
            f"{int(wref.n_matched.sum())} matches; max |dxv| {dw:.3g}); launches {json.dumps(wide_launches)}")

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

        # a step that synchronises with the host cannot be captured: the
        # capture raises, and nothing steps on eagerly in its place
        from scenelib2_torch.runtime import replay

        def syncing_step(state_, frame_, em_):
            st_, out_ = slam._step(state_, frame_, em_)
            int(out_.n_matched)
            return st_, out_

        syncing_step.route = "syncing"
        slam.reset()
        try:
            replay.StepGraph(syncing_step, slam.state, seq[:2], True)
        except RuntimeError as e:
            log(f"[3] a step with a host synchronisation: its capture raises ({str(e).splitlines()[0][:120]})")
        else:
            fail("a step that synchronises with the host was captured without an error")
        torch.cuda.synchronize()

        # the graph replay of each path against its eager loop; times, busy, idle
        paths = {}
        path_off = tuple(n for n in SINGLE_PATH if n not in ("propose", "shi_tomasi"))
        for label, mapping, eager, fp_name, path in (
                ("mapping-off", False, (outs_nomap, state_nomap), "expected_fingerprint_nomap", path_off),
                ("mapping-on", True, (outs, state_on), "expected_fingerprint", SINGLE_PATH)):
            run, run_eager = single_runs(slam, seq, mapping)
            res = graph_cell("3", label, run, run_eager, slam._graphs, n_run, path, eager,
                             lambda o, fp_name=fp_name: check_fingerprint(o, fp_name), trace_n=STD_TRACED_STEPS)
            res["ms_frame"] = res["graph_ms"]
            paths[label] = res
        launches = paths["mapping-on"]["launches"]
        kernel_dev = {}
        for short, sym in (("K1", "k1_kernel"), ("K2", "k2_kernel"), ("K3", "k3_kernel"),
                           ("K4", "k4_kernel"), ("K5", "k5_kernel"), ("K6", "k6_kernel")):
            kernel_dev[short] = kernel_dev_ms(paths["mapping-on"]["prof"], sym)
        log("[3] device time per launch (mapping on, graph replay): " + ", ".join(
            f"{k} {v:.5f} ms" if v is not None else f"{k} not measured" for k, v in kernel_dev.items()))
        log(f"[3] mapping-on last position {r[-1].tolist()}; RMSE vs ground truth {rmse:.6f} m")


        # ---- 3b. batch mode: 64 lanes in one step -------------------------
        from scenelib2_torch.eval.batch import check_lanes, lane_fingerprints, lanes_cache_dir, make_lanes
        from scenelib2_torch.parallel.mesh import _run_batch_eager, make_batched_step, run_batch
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
        # K7 at the batch-hires and mf100 shapes: 16 lanes x 60 slots (640x480), 1 x 100 and 3 x 100
        for pk, n_lanes in ((dataclasses.replace(p, **HIRES_PARAMS), N_HIRES_LANES),
                            (dataclasses.replace(p, max_features=100), 1),
                            (dataclasses.replace(p, max_features=100), 3)):
            worse("K7", check_k7(k7_random_scene(rng, pk, dev, n_lanes=n_lanes), MeasureConsts.from_params(pk),
                                 pk.n_features_to_select))
        # a frame width that is no multiple of 4: K9 stages bytes and stores scalars
        f9, r9 = k9_random_scene(rng, p, dev)
        worse("K9", check_k9(f9[:, 3:, 2:].contiguous(), r9, dataclasses.replace(smc, H=H - 3, W=W - 2)))
        for at in (9, 20, 120):
            check_k10_k11_against_k4(seen[at]["search_bayes"][0], smc, sbc)
        log("[3b] K7 and K9 equal their plain versions on 3 seeded scenes each (a NaN score, an "
            "all-invisible lane, equal scores; a flat image, a flat patch, tied scores; K7 also at "
            f"{N_HIRES_LANES} x 60 slots, 1 x 100 and 3 x 100, K9 at "
            f"{W - 2}x{H - 3}); K10's rows "
            "and K11's results given K9's map equal K4's exactly on the single-stream frames 9, 20, 120")

        t0 = time.time()
        bparams, states0, bframes = make_lanes(
            lanes_cache_dir(cache_root(tmp)), N_LANES, N_TEXTURES, N_BATCH_FRAMES, device=dev,
            dtype=torch.float32)
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
            worse("K7", check_k7(c["measure_select"][0][:5], mc, nsel))
            worse("K9", check_k9(c["score_map"][0][0], c["score_map"][0][1], smc))
            worse("K10", check_k10(*c["particle_predict"][0]))
            a11 = c["search_bayes_maps"][0]
            for _label, args in k11_variations(a11, rng, p.erase_partial_after_attempts):
                worse("K11", check_k11(args))
                n_k11 += 1
            worse("K2 lanes", check_k2_lanes(c["search"][0], sc))
            for _label, (a6l, kw6l) in k6_lane_variations(*c["shi_tomasi"], rng):
                worse("K6 lanes", check_k6_lanes(a6l, kw6l))
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

        # K10b on the geometry K10's prologue computes for each captured step's slots: K10's rows
        for at in BATCH_AT:
            sh_, sl_, lam_, pc_ = bseen[at]["particle_predict"][0]
            kin = (*kform_inputs(sh_, sl_), lam_.reshape(-1, lam_.shape[-1]), pc_)
            lerrs["K10b"] = max(lerrs["K10b"], check_k10b(*kin))
            k10_rows = particle.particle_predict(sh_, sl_, lam_, pc_)
            k10b_rows = particle.kform_rows(*kin)
            torch.cuda.synchronize()
            if not same_floats(k10b_rows, k10_rows.reshape(k10b_rows.shape)):
                fail(f"K10b on K10's prologue geometry differs from K10's rows at output index {at}")
        log(f"[3b] K10b equals its plain version on the slots of the captured steps {BATCH_AT}, and on the "
            f"geometry of K10's prologue writes K10's rows bit for bit")
        sh20, sl20, lam20, pc20 = bseen[20]["particle_predict"][0]
        kin20 = (*kform_inputs(sh20, sl20), lam20.reshape(-1, lam20.shape[-1]), pc20)
        last["K10b"] = dict(
            ms=time_ms(lambda: particle.kform_rows(*kin20), n=50, batches=3),
            plain_ms=time_ms(lambda: particle.kform_rows_plain(*kin20), n=10, batches=3),
            device_ms=kernel_device_ms(lambda: particle.kform_rows(*kin20), "k10b_kernel"),
            costs=[particle.bytes_and_flops_kform(*kin20[4].shape)],
            inputs=f"the batch replay's output index 20, {kin20[4].shape[0]} slots")
        log(f"[3b] K10b: kernel {last['K10b']['ms']:.4f} ms/launch (device {last['K10b']['device_ms']}), plain "
            f"{last['K10b']['plain_ms']:.4f} ms ({last['K10b']['inputs']})")

        c20 = bseen[20]
        a7, a9, a10 = c20["measure_select"][0], c20["score_map"][0], c20["particle_predict"][0]
        a11, a2b = c20["search_bayes_maps"][0], c20["search"][0]
        a6b, kw6b = c20["shi_tomasi"]
        ws9 = torch.empty((N_LANES, 1, H, W), dtype=torch.float32, device=dev)

        btimings = {}
        for name, kern, plain in (
            ("K7", lambda: measure.measure_select(*a7), lambda: measure.measure_select_plain(*a7)),
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
            if n == "measure_select":
                bcosts["K7"].append(measure.bytes_and_flops(*a[0].shape, a[3].shape[1], a[5]))
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

        torch.cuda.synchronize()
        _build.reset_launches()
        with observe_wrappers(record_batch_cost):
            bst_eager, bouts = _run_batch_eager(bstep, states0, bseq, True, bparams)
        blaunches = dict(_build.launches)

        def check_batch_fp(o):
            bad = check_lanes(lane_fingerprints(o))
            if bad:
                fail(f"{len(bad)} of {N_LANES} lane fingerprints differ from the committed file:\n"
                     + "\n".join(bad[:6]))

        check_batch_fp(bouts)
        fps = lane_fingerprints(bouts)
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
        log(f"[3b] launches on the batch path ({T} steps of {N_LANES} lanes, eager loop): {json.dumps(blaunches)}")
        rb = bouts.r.numpy()
        if rb.shape != (T, N_LANES, 3) or not np.isfinite(rb).all():
            fail(f"batch trajectories not finite/shaped: {rb.shape}")
        t_costs = time.perf_counter()
        for pr_, al_, mk_ in k11_args:
            bcosts["K11"].append(search_bayes.bytes_and_flops_maps(
                N_LANES, 1, p.n_particles, *search_bayes.work_counts_maps(*on_cpu((pr_, al_, mk_)), sbc)))
        for u0_, v0_, uc_, vc_, sinv_ in k2_args:
            admit = search.candidate_geometry(u0_.reshape(-1), v0_.reshape(-1), uc_.reshape(-1),
                                              vc_.reshape(-1), sinv_.reshape(-1, 3), sc)[0]
            bcosts["K2"].append(search.bytes_and_flops(N_LANES * nsel, sc, admit))
        t_costs = time.perf_counter() - t_costs

        # reference on a small input: four lanes replayed by the CPU plain versions
        t_cpu = time.perf_counter()
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
            f"1..{N_REF_BATCH} (max |dxv| {dxb:.3g}; the replay {time.perf_counter() - t_cpu:.1f} s on "
            f"{torch.get_num_threads()} threads, the batch launches' cost counts before it {t_costs:.1f} s)")

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

        run, run_eager = batch_runs(bstep, states0, bseq, bparams)
        g = graph_cell("3b", "batch64", run, run_eager, bstep.graphs, T, BATCH_PATH, (bouts, bst_eager),
                       check_batch_fp, trace_n=BATCH_TRACED_STEPS)
        blaunches = g["launches"]
        batch = {k: v for k, v in g.items() if k != "prof"}
        batch.update(lanes=N_LANES, frames_per_lane=T, frames_per_s=N_LANES / g["graph_ms"] * 1e3,
                     frames_per_s_eager=N_LANES / g["eager_ms"] * 1e3,
                     single_stream_frames_per_s=1e3 / paths["mapping-on"]["ms_frame"])
        batch["vs_64x_single_stream"] = batch["frames_per_s"] / (N_LANES * batch["single_stream_frames_per_s"])
        log(f"[3b] batch replay: {batch['frames_per_s']:.1f} aggregate frames/s through the graph "
            f"({batch['frames_per_s_eager']:.1f} eager); the single stream's graph replay with mapping on "
            f"{batch['single_stream_frames_per_s']:.1f} frames/s, so the batch runs at "
            f"{batch['vs_64x_single_stream']:.4f} of {N_LANES} x that")
        bkernel_dev = {}
        for short, sym in (("K7", "k7_kernel"), ("K9", "k9_kernel"), ("K10", "k10_kernel"),
                           ("K11", "k11_kernel"), ("K2", "k2_kernel"), ("K6", "k6_kernel")):
            bkernel_dev[short] = kernel_dev_ms(g["prof"], sym)
        log("[3b] device time per launch (batch, graph replay): " + ", ".join(
            f"{k} {v:.5f} ms" if v is not None else f"{k} not measured" for k, v in bkernel_dev.items()))

        # ---- 3e. the alternative batch routes (batch_pallas=False; SCENELIB2_BATCH_SB=0)
        routes = batch_routes_phase(p, dev, rng, bparams, states0, bseq, bframes,
                                    paths["mapping-on"]["ms_frame"])

        # ---- 3c / 3d. large maps: hires (fused, D = 373), mf100 (split, D = 613)
        large = {name: large_map_phase(tag, name, tmp, dev, rng)
                 for tag, name in (("3c", "hires"), ("3d", "mf100"))}
        large["mf100"]["errs"]["K14"] = max(large["mf100"]["errs"]["K14"], k14_err)

        # ---- 3f. batch lanes at the hires configuration (200 particles)
        hires_b = batch_hires_phase(os.path.join(tmp, "bhires"), dev, rng)

        # ---- 3g. the entry points: go_one_step, the facade, the CLI, the bench suite
        entry = entry_points_phase(tmp, dev, frames, gt_r, _gt_q, cfg, outs, state_on, smi)

        # ---- 3h. JAX's pure-XLA route in f32 (use_pallas=False): single stream and batch
        xla = xla_route_phase(tmp, dev, frames, cfg, seq, bparams, states0, bseq, bframes, smi)

        # ---- 3i. JAX's f64 parity mode (precision="f64"): parity and hybrid routes, batch, parity eval
        f64 = f64_phase(tmp, dev, frames, cfg, seq, smi)

        # ---- 3j. two partial features at a time (max_features_to_init_at_once = 2): every route
        maxp = maxp_phase(tmp, dev, frames, cfg, seq, smi)

        # ---- 3k. the large-map EKF frames (the five EKF benches) and the sharded-covariance EKF
        ekfs = ekf_frames_phase(tmp, dev, smi)

    # ---- 4. kernel records ------------------------------------------------
    costs["K2"] = [search.bytes_and_flops(K, sc, admit) for admit, K in costs["K2"]]
    recs = []
    for short, name, src, rep, key in (
        ("K1", "K1 predict_measure", "predict_measure.cu", "pallas_predict_measure.py:375", "predict_measure"),
        ("K2", "K2 search", "search.cu", "pallas_search.py:476", "search"),
        ("K3", "K3 ekf_update", "ekf_update.cu (+ update_cluster.cuh)", "pallas_ekf.py:446", "ekf_update"),
        ("K4", "K4 search_bayes", "search_bayes.cu", "pallas_search_bayes.py:638", "search_bayes"),
        ("K5", "K5 propose", "propose.cu", "pallas_propose.py:306", "propose"),
        ("K6", "K6 shi_tomasi", "shi_tomasi.cu", "pallas_shi_tomasi.py:211", "shi_tomasi"),
    ):
        b_ms, b_by = bound(costs[short])
        recs.append(dict(
            name=name, route="cuda", source=f"scenelib2_torch/kernels/csrc/{src}",
            replaces=f"scenelib2_tpu/kernels/{rep}", launches=launches[key],
            launches_steps=paths["mapping-on"]["launches_steps"],
            launches_captured=paths["mapping-on"]["captured"].get(key, 0),
            max_abs_err=errs[short], ms=timings[short][0], plain_ms=timings[short][1],
            bound_ms=b_ms, bound_by=b_by, library_ms=None, device_ms=kernel_dev[short],
        ))
    # K2 and K6 also run on the batch path, one launch for all lanes
    for rec, short in ((recs[1], "K2"), (recs[5], "K6")):
        b_ms, b_by = bound(bcosts[short])
        rec.update(launches_batch=blaunches[rec["source"].rsplit("/", 1)[1][:-3]],
                   launches_batch_steps=batch["launches_steps"],
                   launches_batch_captured=batch["captured"].get(rec["source"].rsplit("/", 1)[1][:-3], 0),
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
            launches_steps=batch["launches_steps"], launches_captured=batch["captured"].get(key, 0),
            max_abs_err=berrs[short], ms=btimings[short][0], plain_ms=btimings[short][1],
            bound_ms=b_ms, bound_by=b_by, library_ms=None, device_ms=bkernel_dev[short],
        ))
    recs[-3]["library_composition_ms"] = k9_comp_ms
    # the large-map paths: K14 (split route) and the kernels at the hires shapes
    for short, name, label, src, rep_ in (
        ("K14", "mf100", "K14 chol_inv", "chol_inv.cu (+ chol_linv.cuh)", "pallas_linalg.py:83"),
        ("K7", "mf100", "K7 measure (mf100, 1 lane x 100 slots)", "measure.cu (+ measure_chain.cuh)",
         "pallas_measure.py:310"),
        ("K1", "hires", "K1 predict_measure (hires, D=373)", "predict_measure.cu",
         "pallas_predict_measure.py:375"),
        ("K2", "hires", "K2 search (hires, 107 x 107 windows)", "search.cu", "pallas_search.py:476"),
        ("K3", "hires", "K3 ekf_update (hires, D=373)", "ekf_update.cu (+ update_cluster.cuh)", "pallas_ekf.py:446"),
        ("K4", "hires", "K4 search_bayes (hires, 200 particles)", "search_bayes.cu",
         "pallas_search_bayes.py:638"),
    ):
        t_ = large[name]["timings"][short]
        recs.append(dict(
            name=label, route="cuda", source=f"scenelib2_torch/kernels/csrc/{src}",
            replaces=f"scenelib2_tpu/kernels/{rep_}", launches=t_["launches"],
            launches_steps=t_["launches_steps"], launches_captured=t_["launches_captured"],
            max_abs_err=t_["max_abs_err"], ms=t_["ms"], plain_ms=t_["plain_ms"], bound_ms=t_["bound_ms"],
            bound_by=t_["bound_by"], library_ms=t_["library_ms"], device_ms=t_["device_ms"], path=name,
        ))
    # the alternative batch routes: K8 (bp0), K12 on 13 rows (bp0) and on K10's rows (sb0), K13 (sb0)
    for short, route, name, src, rep_ in (
        ("K8", "bp0", "K8 search_windows", "search.cu", "pallas_search.py:312"),
        ("K12", "bp0", "K12 bayes (13 rows)", "bayes.cu", "pallas_bayes.py:246"),
        ("K12 pred rows", "sb0", "K12 bayes (7 + 8 rows)", "bayes.cu", "pallas_bayes.py:246"),
        ("K13", "sb0", "K13 particle_search", "particle_search.cu", "pallas_particle_search.py:206"),
    ):
        t_ = routes[route]["timings"][short]
        recs.append(dict(
            name=name, route="cuda", source=f"scenelib2_torch/kernels/csrc/{src}",
            replaces=f"scenelib2_tpu/kernels/{rep_}", launches=t_["launches"],
            launches_steps=t_["launches_steps"], launches_captured=t_["launches_captured"],
            max_abs_err=routes["errs"][short], ms=t_["ms"], plain_ms=t_["plain_ms"], bound_ms=t_["bound_ms"],
            bound_by=t_["bound_by"], library_ms=t_["library_ms"], device_ms=t_["device_ms"],
            path=ROUTE_PATH[route][0],
        ))
    # the kernels that no route runs (their own entry points; 0 launches on every main path), and the
    # widened particle kernels at 200 particles
    lerrs["K16"] = max(lerrs["K16"], routes["errs"]["K16"])
    last["K16"] = routes["K16"]
    for short, name, src, rep_, key in (
        ("K10b", "K10b particle_kform", "particle_kform.cu (+ particle_chain.cuh)", "pallas_particle.py:197",
         "particle_kform"),
        ("K15", "K15 ekf_update_dense", "ekf_update_dense.cu (+ update_cluster.cuh)", "pallas_ekf.py:150",
         "ekf_update_dense"),
        ("K16", "K16 multi_ellipse", "multi_ellipse.cu", "pallas_search.py:618", "multi_ellipse"),
    ):
        t_ = last[short]
        b_ms, b_by = bound(t_["costs"])
        recs.append(dict(
            name=name, route="cuda", source=f"scenelib2_torch/kernels/csrc/{src}",
            replaces=f"scenelib2_tpu/kernels/{rep_}", launches=launches[key],
            launches_steps=paths["mapping-on"]["launches_steps"], max_abs_err=lerrs[short],
            ms=t_["ms"], plain_ms=t_["plain_ms"], bound_ms=b_ms, bound_by=b_by, library_ms=None,
            device_ms=t_["device_ms"], path="entry point only (no route runs it)", timed_on=t_["inputs"],
        ))
    for short, name, src, rep_, t_, err in (
        ("K7", "K7 measure (16 lanes x 60 slots, batch-hires)", "measure.cu", "pallas_measure.py:310",
         hires_b["timings"]["K7"], hires_b["errs"]["K7"]),
        ("K10", "K10 particle_predict (200 particles, batch-hires)", "particle_predict.cu",
         "pallas_particle.py:434", hires_b["timings"]["K10"], max(werrs["K10"], hires_b["errs"]["K10"])),
        ("K11", "K11 search_bayes_maps (200 particles, batch-hires)", "search_bayes.cu",
         "pallas_search_bayes.py:638", hires_b["timings"]["K11"], max(werrs["K11"], hires_b["errs"]["K11"])),
        ("K2 lanes", "K2 search (16 lanes of 107 x 107 windows, batch-hires)", "search.cu",
         "pallas_search.py:476", hires_b["timings"]["K2 lanes"], hires_b["errs"]["K2 lanes"]),
        ("K6 lanes", "K6 shi_tomasi (16 lanes of 640x480, batch-hires)", "shi_tomasi.cu",
         "pallas_shi_tomasi.py:211", hires_b["timings"]["K6 lanes"], hires_b["errs"]["K6 lanes"]),
    ):
        recs.append(dict(
            name=name, route="cuda", source=f"scenelib2_torch/kernels/csrc/{src}",
            replaces=f"scenelib2_tpu/kernels/{rep_}", launches=t_["launches"], launches_steps=t_["launches_steps"],
            launches_captured=t_["launches_captured"], max_abs_err=err, ms=t_["ms"],
            plain_ms=t_["plain_ms"], bound_ms=t_["bound_ms"], bound_by=t_["bound_by"], library_ms=None,
            device_ms=t_["device_ms"], path="batch-hires",
        ))
    # K14 on the single stream's pure-XLA route (phase 3h): one launch a frame, M = 20
    t_ = xla["K14"]
    recs.append(dict(
        name="K14 chol_inv (pure-XLA route, std, M = 20)", route="cuda",
        source="scenelib2_torch/kernels/csrc/chol_inv.cu (+ chol_linv.cuh)",
        replaces="scenelib2_tpu/kernels/pallas_linalg.py:83", launches=t_["launches"],
        launches_steps=t_["launches_steps"], launches_captured=t_["launches_captured"],
        max_abs_err=t_["max_abs_err"], ms=t_["ms"], plain_ms=t_["plain_ms"], bound_ms=t_["bound_ms"],
        bound_by=t_["bound_by"], library_ms=t_["library_ms"], device_ms=t_["device_ms"], path="std-mapping xla",
    ))
    for key, name in (("K12 NP200", "K12 bayes (13 rows, 200 particles)"),
                      ("K12 pred rows NP200", "K12 bayes (7 + 8 rows, 200 particles)")):
        t_ = last[key]
        b_ms, b_by = bound(t_["costs"])
        recs.append(dict(
            name=name, route="cuda", source="scenelib2_torch/kernels/csrc/bayes.cu",
            replaces="scenelib2_tpu/kernels/pallas_bayes.py:246", launches=0,
            max_abs_err=werrs["K12" if key == "K12 NP200" else "K12 pred rows"], ms=t_["ms"],
            plain_ms=t_["plain_ms"], bound_ms=b_ms, bound_by=b_by, library_ms=None, device_ms=t_["device_ms"],
            path="seeded rows (bp0 and sb0 at 200 particles run it; no replay here drives them)",
            timed_on=t_["inputs"],
        ))
    recs[3]["max_abs_err_wide"] = werrs["K4"]
    # K2 inside the f64 step (phase 3i): JAX's hybrid route, single stream and over lanes; K8 on its batch route
    k2h = f64["std-mapping k2-f64"]
    recs[1].update(launches_f64=k2h["launches"]["search"], launches_f64_steps=k2h["launches_steps"],
                   device_ms_f64=k2h["k2_device_ms"], max_abs_err_f64=max(f64["K2"]["max_abs_err"],
                                                                           f64["hybrid_errs"]["k2-f64"]),
                   launches_f64_batch=f64["batch64 k2-f64"]["launches"]["search"],
                   launches_f64_batch_steps=f64["batch64 k2-f64"]["steps"])
    k8_rec = next(r_ for r_ in recs if r_["name"] == "K8 search_windows")
    k8_rec.update(launches_f64_batch=f64["batch64 k8-f64"]["launches"]["search_windows"],
                  launches_f64_batch_steps=f64["batch64 k8-f64"]["steps"],
                  max_abs_err_f64=f64["hybrid_errs"]["k8-f64"])
    # K5 past the 16 tries it once held: frame 9's inputs (0 launches on a main path)
    t_ = last["K5 tries"]
    b_ms, b_by = bound(t_["costs"])
    recs.append(dict(
        name=f"K5 propose (tries {K5_TIMED_TRIES})", route="cuda",
        source="scenelib2_torch/kernels/csrc/propose.cu", replaces="scenelib2_tpu/kernels/pallas_propose.py:306",
        launches=0, max_abs_err=errs["K5"], ms=t_["ms"], plain_ms=t_["plain_ms"], bound_ms=b_ms, bound_by=b_by,
        library_ms=None, device_ms=t_["device_ms"], path="captured inputs at more tries", timed_on=t_["inputs"],
    ))
    # K2, K8 and K6 past the radius and region caps they once had (phase 2c)
    for label, t_ in wide_timed.items():
        short = label.split()[0]
        src, rep_ = {"K2": ("search.cu", "pallas_search.py:476"), "K8": ("search.cu", "pallas_search.py:312"),
                     "K6": ("shi_tomasi.cu", "pallas_shi_tomasi.py:211")}[short]
        # timed on seeded inputs, not on a replay: no launches of a main path
        recs.append(dict(
            name=f"{label} (past the old cap)", route="cuda", source=f"scenelib2_torch/kernels/csrc/{src}",
            replaces=f"scenelib2_tpu/kernels/{rep_}", launches=0,
            max_abs_err=wide_errs[short], ms=t_["ms"], plain_ms=t_["plain_ms"], bound_ms=t_["bound_ms"],
            bound_by=t_["bound_by"], library_ms=None, device_ms=t_["device_ms"],
            path="seeded (phase 2c)", timed_on=t_["inputs"],
        ))
    # phase 3j: the launches at MAXP 2 of every kernel of its paths (K4: none), and K9-K13 at F = 2
    maxp_keys = {"K1 predict_measure": "predict_measure", "K2 search": "search", "K3 ekf_update": "ekf_update",
                 "K4 search_bayes": "search_bayes", "K5 propose": "propose", "K6 shi_tomasi": "shi_tomasi",
                 "K7 measure": "measure", "K9 score_map": "score_map", "K10 particle_predict": "particle_predict",
                 "K11 search_bayes_maps": "search_bayes_maps", "K8 search_windows": "search_windows",
                 "K12 bayes (7 + 8 rows)": "bayes", "K13 particle_search": "particle_search"}
    maxp_runs = dict(maxp["cells"], **{f"batch64-maxp2 {r_}": v for r_, v in maxp["batch"].items()})
    for rec in recs:
        if rec["name"] in maxp_keys:
            rec["launches_maxp2"] = {c: r_["launches"][maxp_keys[rec["name"]]] for c, r_ in maxp_runs.items()}
            rec["launches_maxp2_steps"] = {c: r_["launches_steps"] for c, r_ in maxp_runs.items()}
    for short, name, src, rep_, path in (
        ("K9", "K9 score_map (std-maxp2, 1 lane x 2 slots)", "score_map.cu", "pallas_score_map.py:258 and :300",
         "std-maxp2"),
        ("K10", "K10 particle_predict (std-maxp2, 2 slots)", "particle_predict.cu", "pallas_particle.py:434",
         "std-maxp2"),
        ("K11", "K11 search_bayes_maps (std-maxp2, 2 slots)", "search_bayes.cu", "pallas_search_bayes.py:638",
         "std-maxp2"),
        ("K12", "K12 bayes (7 + 8 rows, sb0 maxp2, 64 x 2 rows)", "bayes.cu", "pallas_bayes.py:246",
         "batch64-maxp2 sb0"),
        ("K13", "K13 particle_search (sb0 maxp2, 64 x 2 slots)", "particle_search.cu",
         "pallas_particle_search.py:206", "batch64-maxp2 sb0"),
        ("K9 64x2", "K9 score_map (batch64-maxp2 default, 64 lanes x 2 maps)", "score_map.cu",
         "pallas_score_map.py:258 and :300", "batch64-maxp2 default"),
    ):
        t_ = maxp["timed"][short]
        recs.append(dict(
            name=name, route="cuda", source=f"scenelib2_torch/kernels/csrc/{src}",
            replaces=f"scenelib2_tpu/kernels/{rep_}", launches=t_["launches"], launches_steps=t_["launches_steps"],
            launches_captured=t_["launches_captured"], max_abs_err=t_["max_abs_err"], ms=t_["ms"],
            plain_ms=t_["plain_ms"], bound_ms=t_["bound_ms"], bound_by=t_["bound_by"], library_ms=None,
            device_ms=t_["device_ms"], path=path,
        ))
    log(f"[4] empty-launch floor {empty_ms:.4f} ms; total {time.time() - t_start:.1f} s")
    print(smi, flush=True)
    # every cell's graph replay beside its eager loop (ms a frame or a batch step)
    cells = {"std-nomap": paths["mapping-off"], "std-mapping": paths["mapping-on"], "hires": large["hires"],
             "mf100": large["mf100"], "batch64": batch, "bp0": routes["bp0"], "sb0": routes["sb0"],
             "batch-hires": hires_b}
    keys = ("eager_ms", "graph_ms", "graph_runs", "span_ms", "graph_ms_window", "traced_steps", "busy",
            "idle_eager", "idle_graph", "idle_span", "kernels", "peak_mb", "pool_mb", "warmup_s", "capture_s",
            "eager_s", "first_s", "steps", "graphs", "pools_mb", "chunk", "captured")
    print(json.dumps({"graph_replay": {c: {k: r_[k] for k in keys} for c, r_ in cells.items()},
                      "empty_launch_ms": empty_ms, "card": smi}))
    print(json.dumps({"batch_routes": {ROUTE_PATH[r][0]: {k: v for k, v in routes[r].items() if k != "timings"}
                                       for r in ROUTE_PATH}, "card": smi}))
    print(json.dumps({"entry_points": entry, "card": smi}))
    xkeys = keys + ("launches", "launches_steps")
    print(json.dumps({"xla_route": {
        "std-mapping": {k: xla["std"][k] for k in xkeys}, "batch64": {
            k: xla["batch64"][k] for k in xkeys + ("frames_per_s", "frames_per_s_eager")},
        "go_one_step": xla["go_one_step"], "fingerprint": xla["fingerprint"], "seconds": xla["seconds"]},
        "card": smi}))
    fkeys = xkeys + ("go_one_step", "fingerprint", "cpu_max_diff")
    print(json.dumps({"f64": {
        "std-mapping xla-f64": {k: f64["std-mapping xla-f64"][k] for k in fkeys},
        "std-mapping k2-f64": {k: f64["std-mapping k2-f64"][k] for k in fkeys + ("k2_device_ms",)},
        "batch64 xla-f64": {k: f64["batch64 xla-f64"][k] for k in xkeys + (
            "frames_per_s", "frames_per_s_eager", "lanes_checked")},
        "batch64 k2-f64": f64["batch64 k2-f64"], "batch64 k8-f64": f64["batch64 k8-f64"],
        "parity_eval": f64["parity_eval"], "seconds": f64["seconds"]}, "card": smi}))
    mkeys = xkeys + ("fingerprint", "cpu_max_diff")
    print(json.dumps({"maxp2": {
        **{c: {k: r_[k] for k in mkeys + ("go_one_step",)} for c, r_ in maxp["cells"].items()},
        **maxp["routes"],
        **{f"batch64-maxp2 {c}": {k: r_[k] for k in xkeys + ("frames_per_s", "frames_per_s_eager", "cpu_max_diff",
                                                             "both_slot_lane_steps")}
           for c, r_ in maxp["batch"].items()},
        "errs": maxp["errs"], "seconds": maxp["seconds"]}, "card": smi}))
    print(json.dumps({"ekf_frames": ekfs, "card": smi}))
    print(json.dumps({"kernels": recs}))
    summary = run_summary(cells, entry, xla, f64, maxp, ekfs, smi, time.time() - t_start)
    print(json.dumps({"summary": summary}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
