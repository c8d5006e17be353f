"""Benchmark suite over the BASELINE.json configurations (a port of
scenelib2_tpu/eval/benchmark.py).

  1. testseq   — the std 320x240 sequence with known features, mapping on:
                 frames/s of run_sequence
  2. autoinit  — the same sequence at max_features 24 (D = 157): auto-init
                 and particle depth filtering from a 4-feature start
  3. hires     — BASELINE config 3 as JAX's bench_hires runs it: the
                 640x480 dataset rendered with search radius 48 and particle
                 radius 52, but MonoSLAM(cfg, max_features=60) only; the cfg
                 file carries no radii, so the step searches at the
                 defaults 32 and 32 (200 particles from the cfg;
                 expected_fingerprint_hires_bench.json)
     hires_r48 — the same dataset with the radii 48 / 52 given to the step
                 as well (HIRES_OVERRIDES: the configuration of
                 expected_fingerprint_hires.json and of the batch-hires
                 lanes), under a metric name of its own; no JAX bench runs it
  4. batch64   — 64 independent lanes (32 textures x 2 phase offsets) in one
                 batched step: aggregate frames/s
  5. stress500, stress500packed, stress500f32, ekf100, ekf100f32 — one
                 EKF frame of a 100- or 500-feature map with the real
                 measurement assembly (runtime/assembly.py): predict (not at
                 100 features), per-slot prediction, top-10 selection, H / R /
                 nu packing, joint update, normalise, symmetrize; ms/step.

Each bench returns the JAX bench's dict ({"metric", "value", "unit", plus
details}, the same names) plus `card` (the nvidia-smi name and power limit,
or "cpu") and the decisions fingerprint of its timed replay: `fingerprint`
beside the committed file it should equal (`fingerprint_file`), or for
batch64 the lanes whose fingerprints differ from the committed file.

Timing follows the JAX package's _timed_replay: best of N replays of the
whole sequence from one pristine state already on the device, one
synchronisation at the end of each. On a CUDA device a replay is
run_sequence's (run_batch's) CUDA-graph replay, captured by an untimed
first run; on the CPU it is the eager loop. The EKF frames take the best of
3 runs of n_steps frames (not JAX's two-point n_steps + 2 minus 2), each
frame one replay of a one-frame graph (runtime/replay.py::FrameGraph) on
CUDA, an eager call on the CPU.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from scenelib2_torch.eval.selftest import std_dataset

def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def timed_replay(slam, seq: torch.Tensor, repeats: int = 12):
    """(best seconds of `repeats` replays of seq from one pristine state,
    StepOutputs of the last replay on the CPU). The first, untimed run
    captures the graphs (and builds the kernels)."""
    from scenelib2_torch.runtime import replay
    from scenelib2_torch.runtime import step as step_mod

    p = slam.params
    nsel, maxp, npart = p.n_features_to_select, max(1, p.max_features_to_init_at_once), p.n_particles
    slam.run_sequence(seq)
    slam.reset()
    s0 = slam.state
    flat = torch.empty((seq.shape[0], step_mod.packed_size(nsel, maxp, npart)), dtype=slam.dtype,
                       device=slam.device)
    graphs = slam.device.type == "cuda"
    dt = float("inf")
    for _ in range(repeats):
        _sync(slam.device)
        t0 = time.perf_counter()
        if graphs:
            replay.replay_steps(slam._step, slam._graphs, s0, seq, True, 0, flat)
        else:
            replay.eager_steps(slam._step, s0, seq, True, flat)
        _sync(slam.device)
        dt = min(dt, time.perf_counter() - t0)
    return dt, step_mod.unpack_outputs(flat.cpu(), nsel, maxp, npart)


def _single(slam, frames, repeats: int, fp_file: str) -> tuple[float, object, dict]:
    from scenelib2_torch.device import card_line
    from scenelib2_torch.eval.fingerprint import decisions_fingerprint

    rest = slam._to_device(frames[1:])
    _sync(slam.device)
    dt, outs = timed_replay(slam, rest, repeats)
    extra = dict(frames=len(rest), card=card_line(slam.device),
                 fingerprint=decisions_fingerprint(outs, len(rest)), fingerprint_file=fp_file)
    return dt, outs, extra


def bench_testseq(n_frames: int = 240, device=None, repeats: int = 12):
    from scenelib2_torch import MonoSLAM

    frames, cfg = std_dataset(n_frames)
    slam = MonoSLAM(cfg, max_features=16, device=device)
    dt, outs, extra = _single(slam, frames, repeats, "expected_fingerprint")
    return dict(
        metric="fps_testseq_320x240",
        value=round(extra["frames"] / dt, 2),
        unit="frames/sec",
        mean_matched=round(float(outs.n_matched.float().mean()), 2),
        **extra,
    )


def bench_autoinit(n_frames: int = 240, device=None, repeats: int = 12):
    """Same sequence at max_features 24, reported with init/convert counts."""
    from scenelib2_torch import MonoSLAM

    frames, cfg = std_dataset(n_frames)
    slam = MonoSLAM(cfg, max_features=24, device=device)
    dt, outs, extra = _single(slam, frames, repeats, "expected_fingerprint_autoinit")
    return dict(
        metric="fps_autoinit_320x240",
        value=round(extra["frames"] / dt, 2),
        unit="frames/sec",
        inits=int(outs.did_init.sum()),
        conversions=int(outs.did_convert.sum()),
        final_map=int(outs.n_active[-1]),
        **extra,
    )


def _hires(metric: str, overrides: dict, fp_file: str, n_frames: int, device, repeats: int):
    from scenelib2_torch import MonoSLAM
    from scenelib2_torch.config import Params
    from scenelib2_torch.eval.synthetic import HIRES_PARAMS

    frames, cfg = std_dataset(n_frames, params=Params(**HIRES_PARAMS), tag="hires")
    slam = MonoSLAM(cfg, device=device, **overrides)
    dt, outs, extra = _single(slam, frames, repeats, fp_file)
    return dict(
        metric=metric,
        value=round(extra["frames"] / dt, 2),
        unit="frames/sec",
        final_map=int(outs.n_active[-1]),
        **extra,
    )


def bench_hires(n_frames: int = 120, device=None, repeats: int = 8):
    """JAX's bench_hires: the hires dataset, MonoSLAM(cfg, max_features=60)."""
    return _hires("fps_640x480_60feat", dict(max_features=60), "expected_fingerprint_hires_bench",
                  n_frames, device, repeats)


def bench_hires_r48(n_frames: int = 120, device=None, repeats: int = 8):
    """The hires dataset with the step at the dataset's radii (HIRES_OVERRIDES)."""
    from scenelib2_torch.eval.synthetic import HIRES_OVERRIDES

    return _hires("fps_640x480_60feat_r48", HIRES_OVERRIDES, "expected_fingerprint_hires", n_frames,
                  device, repeats)


def bench_batch64(n_frames: int = 64, batch: int = 64, n_textures: int = 32, device=None,
                  repeats: int = 2):
    """64 independent lanes (eval/batch.py: 32 scene textures x 2 phase
    offsets, each lane its own patches and random stream) in one batched
    step: aggregate frames/s of run_batch."""
    import tempfile

    from scenelib2_torch.device import card_line, resolve_device
    from scenelib2_torch.eval.batch import check_lanes, lane_fingerprints, lanes_cache_dir, make_lanes
    from scenelib2_torch.parallel.mesh import make_batched_step, run_batch
    from scenelib2_torch.runtime import replay
    from scenelib2_torch.runtime import step as step_mod

    dev = resolve_device(device)
    params, states0, fb = make_lanes(lanes_cache_dir(tempfile.gettempdir()), batch, n_textures, n_frames,
                                     device=dev, dtype=torch.float32)
    step = make_batched_step(params, device=dev)
    seq = torch.as_tensor(fb).to(dev)
    T = seq.shape[0]
    run_batch(step, states0, seq, True, params)          # captures the graphs
    nsel, maxp, npart = params.n_features_to_select, max(1, params.max_features_to_init_at_once), params.n_particles
    flat = torch.empty((T, batch, step_mod.packed_size(nsel, maxp, npart)), dtype=torch.float32, device=dev)
    dt = float("inf")
    for _ in range(repeats):
        _sync(dev)
        t0 = time.perf_counter()
        if dev.type == "cuda":
            replay.replay_steps(step, step.graphs, states0, seq, True, 0, flat)
        else:
            replay.eager_steps(step, states0, seq, True, flat)
        _sync(dev)
        dt = min(dt, time.perf_counter() - t0)
    outs = step_mod.unpack_outputs(flat.cpu(), nsel, maxp, npart)
    final_active = outs.n_active[-1].numpy()
    return dict(
        metric="fps_batch64_aggregate",
        value=round(T * batch / dt, 2),
        unit="frames/sec",
        batch=batch,
        distinct_scenes=n_textures,
        mean_matched=round(float(outs.n_matched.float().mean()), 2),
        final_active_min=int(final_active.min()),
        final_active_max=int(final_active.max()),
        card=card_line(dev),
        lanes_differing=check_lanes(lane_fingerprints(outs)),
        fingerprint_file="expected_fingerprint_batch64",
    )


def _make_map_state(n_feat: int, slot_dim: int, seed: int = 0):
    """A realistic large-map filter state (numpy, float64): camera at the
    origin (identity quaternion, stock velocity noise) and n_feat full
    features spread over a frustum in front of it, with an SPD covariance
    whose blocks live at the given slot stride (6 = the framework's
    ray-capable layout, 3 = the reference's packed full-feature layout,
    feature.h:79-142). The JAX package's arrays, bit for bit."""
    rng = np.random.default_rng(seed)
    D = 13 + slot_dim * n_feat
    x = np.zeros(D)
    x[3] = 1.0  # identity quaternion
    x[7:10] = [0.05, 0.02, 0.1]
    x[10:13] = [0.01, 0.02, 0.005]
    ys = np.stack(
        [
            rng.uniform(-1.5, 1.5, n_feat),
            rng.uniform(-1.1, 1.1, n_feat),
            rng.uniform(1.0, 4.0, n_feat),
        ],
        axis=1,
    )
    live = np.zeros(D, bool)
    live[:13] = True
    for k in range(n_feat):
        off = 13 + slot_dim * k
        x[off : off + 3] = ys[k]
        live[off : off + 3] = True
    # SPD covariance on the live dims only (dead ray dims stay exact zeros,
    # like the runtime's 6-wide slots after conversion)
    nlive = int(live.sum())
    A = rng.normal(size=(nlive, nlive)) * 2e-4
    P_live = A @ A.T + np.eye(nlive) * 1e-4
    P = np.zeros((D, D))
    P[np.ix_(live, live)] = P_live
    return x, P, ys


def _make_ekf_frame(params, n_feat: int, slot_dim: int, n_sel: int = 10, predict: bool = True):
    """frame(x, P) -> (x', P', top_idx): one frame of the large-map EKF path
    with the real glue (runtime/assembly.py) on x [D], P [D, D] of one
    device and dtype: predict (u = 0), per-slot measurement prediction,
    top-k selection, H / R / nu packing, joint update, quaternion normalise,
    symmetrize. Measurements are synthetic (nu = 0.5 px, every selected
    feature measured); the D-sized products of the update go through
    torch.matmul (joint_update's blas), the rest as in the live step."""
    from scenelib2_torch.core import ekf
    from scenelib2_torch.core.camera import CameraParams
    from scenelib2_torch.runtime.assembly import measurement_assembly

    cam = CameraParams.from_params(params)

    def frame(x, P):
        if predict:
            u = torch.zeros(3, dtype=x.dtype, device=x.device)
            x, P = ekf.predict(x, P, u, params.delta_t, params.sd_a, params.sd_alpha)
        H, R, top_idx, _h_sel = measurement_assembly(cam, x, P, n_feat, slot_dim, n_sel)
        nu = torch.full((2 * n_sel,), 0.5, dtype=x.dtype, device=x.device)
        x, P, _ = ekf.joint_update(x, P, H, nu, R, blas=True)
        x, P = ekf.normalise(x, P)
        return x, ekf.symmetrize(P), top_idx

    return frame


def _make_realistic_ekf_step(params, n_feat: int, slot_dim: int, n_sel: int = 10, predict: bool = True):
    """The JAX package's step(x, P) -> (x', P'): _make_ekf_frame without
    top_idx."""
    frame = _make_ekf_frame(params, n_feat, slot_dim, n_sel, predict)

    def step(x, P):
        x, P, _ = frame(x, P)
        return x, P

    return step


ASSEMBLY = "real (predict+Si+topk+H/R/nu pack+update+normalise+symmetrize)"


def _bench_ekf_frame(n_feat: int, slot_dim: int, n_steps: int, metric: str, predict: bool = True,
                     dtype: str = "float64", device=None, repeats: int = 3):
    """Best of `repeats` runs of n_steps chained frames from _make_map_state,
    the host waiting once at the end of each (the module docstring). The
    frames launch none of the hand-written kernels (K1-K16): JAX's frame
    reaches no Pallas kernel (its pallas_chol=False)."""
    from scenelib2_torch.config import Params
    from scenelib2_torch.device import card_line, resolve_device
    from scenelib2_torch.kernels import _build
    from scenelib2_torch.runtime.replay import FrameGraph

    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the EKF frames run without TF32: torch.backends.cuda.matmul.allow_tf32 is set")
    dev = resolve_device(device)
    dt = {"float64": torch.float64, "float32": torch.float32}[dtype]
    x0, P0, _ = _make_map_state(n_feat, slot_dim)
    x0 = torch.as_tensor(x0, dtype=dt).to(dev)
    P0 = torch.as_tensor(P0, dtype=dt).to(dev)
    frame = _make_ekf_frame(Params(), n_feat, slot_dim, predict=predict)
    before = dict(_build.launches)
    if dev.type == "cuda":
        graph = FrameGraph(frame, (x0, P0))

        def run():
            for dst, src in zip(graph.state, (x0, P0)):
                dst.copy_(src)
            return graph.replay(n_steps)
    else:
        def run():
            x, P = x0, P0
            for _ in range(n_steps):
                x, P, _ = frame(x, P)
            return x, P
    best = float("inf")
    for _ in range(repeats):
        _sync(dev)
        t0 = time.perf_counter()
        x, P = run()
        _sync(dev)
        best = min(best, time.perf_counter() - t0)
    launched = {k: v - before[k] for k, v in _build.launches.items() if v != before[k]}
    if launched:
        raise RuntimeError(f"the EKF frame launched hand-written kernels: {launched}")
    if not (bool(torch.isfinite(x).all()) and bool(torch.isfinite(P).all())):
        raise RuntimeError("EKF bench state went non-finite")
    return dict(
        metric=metric,
        value=round(best / n_steps * 1000, 4),
        unit="ms/step",
        state_dim=13 + slot_dim * n_feat,
        slot_dim=slot_dim,
        dtype=dtype,
        assembly=ASSEMBLY,
        steps=n_steps,
        tf32=torch.backends.cuda.matmul.allow_tf32,
        card=card_line(dev),
    )


def bench_stress500(n_steps: int = 50, n_feat: int = 500, device=None):
    """Full EKF frame at a 500-feature map in the runtime's 6-wide slot
    layout (D = 13 + 6*500 = 3013), f64."""
    return _bench_ekf_frame(n_feat, 6, n_steps, "ekf_predict_update_ms_500feat", device=device)


def bench_stress500_packed(n_steps: int = 50, n_feat: int = 500, device=None):
    """The same frame in the reference's packed 3-dims-per-feature layout
    (D = 1513)."""
    return _bench_ekf_frame(n_feat, 3, n_steps, "ekf_predict_update_ms_500feat_packed3", device=device)


def bench_stress500_f32(n_steps: int = 100, n_feat: int = 500, device=None):
    """The 6-wide 500-feature frame in f32 (the fast-mode dtype)."""
    return _bench_ekf_frame(n_feat, 6, n_steps, "ekf_predict_update_ms_500feat_f32", dtype="float32",
                            device=device)


def bench_ekf100(n_steps: int = 200, device=None):
    """EKF update frame at a 100-feature map (D = 613), f64, no predict."""
    return _bench_ekf_frame(100, 6, n_steps, "ekf_update_ms_100feat", predict=False, device=device)


def bench_ekf100_f32(n_steps: int = 400, device=None):
    """The 100-feature update frame in f32."""
    return _bench_ekf_frame(100, 6, n_steps, "ekf_update_ms_100feat_f32", predict=False, dtype="float32",
                            device=device)


ALL_BENCHES = {
    "testseq": bench_testseq,
    "autoinit": bench_autoinit,
    "hires": bench_hires,
    "hires_r48": bench_hires_r48,
    "batch64": bench_batch64,
    "ekf100": bench_ekf100,
    "ekf100f32": bench_ekf100_f32,
    "stress500": bench_stress500,
    "stress500packed": bench_stress500_packed,
    "stress500f32": bench_stress500_f32,
}


def run_all(names=None, device=None):
    """Run the named benches (all where names is empty), printing one JSON
    line each; an unknown name raises ValueError."""
    unknown = sorted(set(names or ()) - set(ALL_BENCHES))
    if unknown:
        raise ValueError(f"unknown benches {unknown}; known: {sorted(ALL_BENCHES)}")
    results = []
    for name, fn in ALL_BENCHES.items():
        if names and name not in names:
            continue
        r = fn(device=device)
        results.append(r)
        print(json.dumps(r), flush=True)
    return results


__all__ = ["ALL_BENCHES", "run_all", "timed_replay", "bench_testseq", "bench_autoinit", "bench_hires",
           "bench_hires_r48", "bench_batch64", "bench_ekf100", "bench_ekf100_f32", "bench_stress500",
           "bench_stress500_packed", "bench_stress500_f32"]
