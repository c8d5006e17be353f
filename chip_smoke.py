"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed):

 1. device and build: the card's name and power limit; every kernel of
    scenelib2_torch/kernels/csrc built with nvcc (timed).
 2. kernel vs plain: each kernel (K1 predict+measure+select, K2 search,
    K3 update+bookkeeping) and its plain PyTorch version on the same CUDA
    tensors, on seeded random scenes and on the inputs of a real frame of
    the synthetic sequence: decisions exactly equal, floats within the
    stated tolerances; then each kernel's and plain version's time.
 3. main path: the 240-frame seed-7 synthetic sequence through
    MonoSLAM(device="cuda").run_sequence with mapping off, reproducing the
    committed decisions fingerprint, with every kernel launched once per
    frame; the first frames agree with the CPU plain replay; ms/frame.
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
STEP_TOL = 1e-4   # CUDA vs CPU plain replay: r, xv


def log(*a):
    print(*a, flush=True)


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


# ------------------------------------------------------------ main


def profile_main_path(slam, seq, n: int) -> dict:
    """torch.profiler over an n-frame replay: device time by kernel name,
    total device time, and wall time of the traced window."""
    from torch.profiler import ProfilerActivity, profile

    slam.reset()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        slam.run_sequence(seq[:n], enable_mapping=False)
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


@contextlib.contextmanager
def observe_wrappers(on_call):
    """Within the block, the step calls on_call(name, args, kwargs) before
    each kernel wrapper (K1 predict_measure, K2 search, K3 joint_update)."""
    import scenelib2_torch.runtime.step as step_mod

    names = ("predict_measure", "search", "joint_update")
    orig = {n: getattr(step_mod, n) for n in names}

    def wrap(n):
        def call(*a, **k):
            on_call(n, a, k)
            return orig[n](*a, **k)
        return call

    for n in names:
        setattr(step_mod, n, wrap(n))
    try:
        yield
    finally:
        for n in names:
            setattr(step_mod, n, orig[n])


def capture_inputs(slam, frames, at: int):
    """Drive the step on the GPU through frame `at` and return the inputs
    that each kernel wrapper was called with on that frame."""
    seen = {}
    with observe_wrappers(lambda n, a, k: seen.__setitem__(n, (a, k))):
        slam.reset()
        for t in range(1, at + 1):
            slam.go_one_step(frames[t], enable_mapping=False)
    torch.cuda.synchronize()
    return seen


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    from scenelib2_torch import MonoSLAM
    from scenelib2_torch.eval.fingerprint import decisions_fingerprint, load_expected
    from scenelib2_torch.eval.synthetic import generate_dataset
    from scenelib2_torch.kernels import _build, ekf_update, predict_measure, search
    from scenelib2_torch.kernels.measure import MeasureConsts

    t_start = time.time()
    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log(smi)
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
        mc = MeasureConsts.from_params(p)
        sc = search.SearchConsts.from_params(p)
        uc = ekf_update.UpdateConsts.from_params(p)
        k1kw = dict(nsel=p.n_features_to_select, maxp=max(1, p.max_features_to_init_at_once),
                    dt=p.delta_t, sd_a=p.sd_a, sd_alpha=p.sd_alpha, consts=mc)

        # ---- 2. kernel vs plain ------------------------------------------
        rng = np.random.default_rng(2026)
        errs = {"K1": 0.0, "K2": 0.0, "K3": 0.0}
        for trial in range(6):
            errs["K1"] = max(errs["K1"], check_k1(k1_random_scene(rng, p, dev, nan_lane=trial == 0), k1kw))
            errs["K2"] = max(errs["K2"], check_k2(k2_random_scene(rng, p, dev, tie=trial < 2), sc))
            mode = ("none", "run", "mixed")[trial % 3]
            errs["K3"] = max(errs["K3"], check_k3(k3_random_scene(rng, p, dev, mode), uc))
        seen = capture_inputs(slam, frames, at=120)
        a1, kw1 = seen["predict_measure"]
        a2, _ = seen["search"]
        a3, _ = seen["joint_update"]
        errs["K1"] = max(errs["K1"], check_k1(a1, kw1))
        errs["K2"] = max(errs["K2"], check_k2(a2[:-1], sc))
        errs["K3"] = max(errs["K3"], check_k3(a3[:-1], uc))
        log(f"[2] kernels equal their plain versions on 6 random scenes + frame 120 "
            f"(max abs err {json.dumps(errs)})")

        timings = {}
        for name, kern, plain, args in (
            ("K1", lambda: predict_measure.predict_measure(*a1, **kw1),
             lambda: predict_measure.predict_measure_plain(*a1, **kw1), a1),
            ("K2", lambda: search.search(*a2), lambda: search.search_plain(*a2), a2),
            ("K3", lambda: ekf_update.joint_update(*a3), lambda: ekf_update.joint_update_plain(*a3), a3),
        ):
            timings[name] = (time_ms(kern), time_ms(plain, n=10, batches=3))
        empty = _build.function("predict_measure", "k0_empty_launch", [ctypes.c_void_p])
        empty_ms = time_ms(lambda: empty(torch.cuda.current_stream().cuda_stream))
        for name, (k_ms, p_ms) in timings.items():
            log(f"[2] {name}: kernel {k_ms:.4f} ms/launch, plain {p_ms:.4f} ms/call (frame-120 inputs)")
        log(f"[2] empty kernel launch: {empty_ms:.4f} ms")

        # ---- 3. main path --------------------------------------------------
        seq = torch.as_tensor(frames[1:]).to(dev)
        slam.reset()
        slam.run_sequence(seq[:8], enable_mapping=False)           # warm-up
        torch.cuda.synchronize()

        # cost model of each launch on the main path, from its own inputs
        costs = {"K1": [], "K2": [], "K3": []}

        def record_cost(n, a, k):
            if n == "predict_measure":
                costs["K1"].append(
                    predict_measure.bytes_and_flops(a[0].shape[0], a[2].shape[0], k["nsel"]))
            elif n == "search":
                admit = search.candidate_geometry(a[2], a[3], a[4], a[5], a[6], a[8])[0]
                costs["K2"].append((admit, a[2].shape[0]))
            else:
                costs["K3"].append(
                    ekf_update.bytes_and_flops(a[0].shape[0], a[2].shape[1], a[6].shape[0]))

        slam.reset()
        _build.reset_launches()
        with observe_wrappers(record_cost):
            outs = slam.run_sequence(seq, enable_mapping=False)
        launches = dict(_build.launches)
        n_run = seq.shape[0]
        fp = decisions_fingerprint(outs, n_run)
        want = load_expected()
        log(f"[3] fingerprint: {json.dumps(fp)}")
        for k in ("n_frames", "matched_sum", "inits", "convs", "active_end", "decisions_sha256"):
            if fp[k] != want[k]:
                fail(f"fingerprint field {k}: got {fp[k]}, expected {want[k]}")
        for n, cnt in launches.items():
            if cnt != n_run:
                fail(f"kernel {n} launched {cnt} times on the main path, expected {n_run}")
        log(f"[3] launches on the main path: {json.dumps(launches)}")
        r = outs.r.numpy()
        if r.shape != (n_run, 3) or not np.isfinite(r).all():
            fail(f"trajectory not finite/shaped: {r.shape}")
        rmse = float(np.sqrt(np.mean(np.sum((r - gt_r[1:]) ** 2, axis=1))))

        # reference on a small input: the CPU plain replay of the first frames
        n_ref = 24
        cpu = MonoSLAM(cfg, max_features=16, device="cpu")
        ref = cpu.run_sequence(frames[1 : n_ref + 1], enable_mapping=False)
        for k in ("n_visible", "n_selected", "n_matched", "n_active", "sel_slot", "sel_matched"):
            if not torch.equal(getattr(ref, k), getattr(outs, k)[:n_ref]):
                fail(f"CUDA vs CPU plain replay: {k} differs in the first {n_ref} frames")
        dr = float((ref.xv.double() - outs.xv[:n_ref].double()).abs().max())
        if dr > STEP_TOL:
            fail(f"CUDA vs CPU plain replay: xv differs by {dr}")
        log(f"[3] CUDA run equals the CPU plain replay on frames 1..{n_ref} (max |dxv| {dr:.3g})")

        # timed replays (state reset each time; the host waits once per run)
        per_frame = []
        for _ in range(3):
            slam.reset()
            torch.cuda.synchronize()
            t = time.perf_counter()
            slam.run_sequence(seq, enable_mapping=False)
            per_frame.append((time.perf_counter() - t) / n_run * 1e3)
        ms_frame = statistics.median(per_frame)

        # where the device time goes: a traced replay of the same frames
        prof = profile_main_path(slam, seq, n_run)
        device_per_frame = prof["device_ms"] / n_run
        top = sorted(prof["by_name"].items(), key=lambda kv: -kv[1][0])[:12]
        kernel_dev = {}
        for short, sym in (("K1", "k1_kernel"), ("K2", "k2_kernel"), ("K3", "k3_kernel")):
            hits = [v for k, v in prof["by_name"].items() if sym in k]
            kernel_dev[short] = (sum(h[0] for h in hits) / max(1, sum(h[1] for h in hits))
                                 if hits else None)
        if prof["device_ms"] > 0:
            log(f"[3] traced replay: device busy {device_per_frame:.4f} ms/frame of "
                f"{ms_frame:.4f} ms/frame untraced wall -> idle share "
                f"{1.0 - device_per_frame / ms_frame:.4f}; "
                f"traced wall {prof['wall_ms'] / n_run:.4f} ms/frame")
            log(f"[3] device time per launch: " + ", ".join(
                f"{k} {v:.5f} ms" if v is not None else f"{k} not measured" for k, v in kernel_dev.items()))
            for name, (ms, cnt) in top:
                log(f"[3]   {ms / n_run * 1e3:9.3f} us/frame  x{cnt / n_run:5.2f}/frame  {name[:90]}")
        else:
            log("[3] traced replay: the profiler recorded no device time (not measured)")
        log(f"[3] main path: {ms_frame:.4f} ms/frame (median of 3 runs of {n_run} frames: "
            f"{', '.join(f'{v:.4f}' for v in per_frame)}); last position {r[-1].tolist()}; "
            f"RMSE vs ground truth {rmse:.6f} m")

    # ---- 4. kernel records ------------------------------------------------
    def bound(costs_list):
        bms = [max(b / PEAK_BYTES, f / PEAK_F32) * 1e3 for b, f in costs_list]
        return statistics.mean(bms), ("bytes" if costs_list[0][0] / PEAK_BYTES >= costs_list[0][1] / PEAK_F32
                                      else "operations")

    k2_costs = [search.bytes_and_flops(K, sc, int(admit.sum())) for admit, K in costs["K2"]]
    recs = []
    for name, src, rep, key, cl in (
        ("K1 predict_measure", "scenelib2_torch/kernels/csrc/predict_measure.cu",
         "scenelib2_tpu/kernels/pallas_predict_measure.py:375", "predict_measure", costs["K1"]),
        ("K2 search", "scenelib2_torch/kernels/csrc/search.cu",
         "scenelib2_tpu/kernels/pallas_search.py:476", "search", k2_costs),
        ("K3 ekf_update", "scenelib2_torch/kernels/csrc/ekf_update.cu",
         "scenelib2_tpu/kernels/pallas_ekf.py:446", "ekf_update", costs["K3"]),
    ):
        short = name.split()[0]
        b_ms, b_by = bound(cl)
        recs.append(dict(
            name=name, route="cuda", source=src, replaces=rep, launches=launches[key],
            max_abs_err=errs[short], ms=timings[short][0], plain_ms=timings[short][1],
            bound_ms=b_ms, bound_by=b_by, library_ms=None, device_ms=kernel_dev[short],
        ))
    log(f"[4] empty-launch floor {empty_ms:.4f} ms; total {time.time() - t_start:.1f} s")
    log(smi)
    print(json.dumps({"ms_per_frame": ms_frame, "device_ms_per_frame": device_per_frame,
                      "empty_launch_ms": empty_ms, "card": smi}))
    print(json.dumps({"kernels": recs}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
