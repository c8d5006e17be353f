"""Benchmark suite over the BASELINE.json configurations (a port of
scenelib2_tpu/eval/benchmark.py).

  1. testseq   — the std 320x240 sequence with known features, mapping on:
                 frames/s of run_sequence
  2. autoinit  — the same sequence at max_features 24 (D = 157): auto-init
                 and particle depth filtering from a 4-feature start
  3. hires     — BASELINE config 3: 640x480, max_features 60, 200 particles,
                 search radius 48, particle radius 52 (the configuration of
                 expected_fingerprint_hires.json; JAX's bench_hires renders
                 its dataset with those radii but gives MonoSLAM only
                 max_features, so its step searches at the default 32)
  4. batch64   — 64 independent lanes (32 textures x 2 phase offsets) in one
                 batched step: aggregate frames/s
  5. stress500*, ekf100* — the 100- and 500-feature EKF frames with the real
                 measurement assembly: not ported (they need
                 runtime/assembly.py), so run_all prints a line saying so and
                 naming one of them raises.

Each bench returns the JAX bench's dict ({"metric", "value", "unit", plus
details}, the same names) plus `card` (the nvidia-smi name and power limit,
or "cpu") and the decisions fingerprint of its timed replay: `fingerprint`
beside the committed file it should equal (`fingerprint_file`), or for
batch64 the lanes whose fingerprints differ from the committed file.

Timing follows the JAX package's _timed_replay: best of N replays of the
whole sequence from one pristine state already on the device, one
synchronisation at the end of each. On a CUDA device a replay is
run_sequence's (run_batch's) CUDA-graph replay, captured by an untimed
first run; on the CPU it is the eager loop.
"""

from __future__ import annotations

import json
import time

import torch

from scenelib2_torch.eval.selftest import std_dataset

NOT_PORTED = {
    "ekf100": "ekf_update_ms_100feat",
    "ekf100f32": "ekf_update_ms_100feat_f32",
    "stress500": "ekf_predict_update_ms_500feat",
    "stress500packed": "ekf_predict_update_ms_500feat_packed3",
    "stress500f32": "ekf_predict_update_ms_500feat_f32",
}
NOT_PORTED_WHY = ("the EKF frame with the real measurement assembly (scenelib2_tpu/runtime/assembly.py) "
                  "is not ported (ROADMAP.md Queue 1, \"BASELINE config 5: the 500-feature EKF frame\")")


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


def bench_hires(n_frames: int = 120, device=None, repeats: int = 8):
    from scenelib2_torch import MonoSLAM
    from scenelib2_torch.config import Params
    from scenelib2_torch.eval.synthetic import HIRES_OVERRIDES, HIRES_PARAMS

    frames, cfg = std_dataset(n_frames, params=Params(**HIRES_PARAMS), tag="hires")
    slam = MonoSLAM(cfg, device=device, **HIRES_OVERRIDES)
    dt, outs, extra = _single(slam, frames, repeats, "expected_fingerprint_hires")
    return dict(
        metric="fps_640x480_60feat",
        value=round(extra["frames"] / dt, 2),
        unit="frames/sec",
        final_map=int(outs.n_active[-1]),
        **extra,
    )


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


def _not_ported(name):
    def bench(**_kw):
        raise NotImplementedError(f"bench {name} ({NOT_PORTED[name]}): {NOT_PORTED_WHY}")
    return bench


ALL_BENCHES = {
    "testseq": bench_testseq,
    "autoinit": bench_autoinit,
    "hires": bench_hires,
    "batch64": bench_batch64,
    **{name: _not_ported(name) for name in NOT_PORTED},
}


def run_all(names=None, device=None):
    """Run the named benches (all where names is empty), printing one JSON
    line each. With no names, each bench that is not ported prints a line
    saying so; naming one raises NotImplementedError."""
    unknown = sorted(set(names or ()) - set(ALL_BENCHES))
    if unknown:
        raise ValueError(f"unknown benches {unknown}; known: {sorted(ALL_BENCHES)}")
    results = []
    for name, fn in ALL_BENCHES.items():
        if names and name not in names:
            continue
        if name in NOT_PORTED and not names:
            r = dict(bench=name, metric=NOT_PORTED[name], ported=False, why=NOT_PORTED_WHY)
        else:
            r = fn(device=device)
        results.append(r)
        print(json.dumps(r), flush=True)
    return results


__all__ = ["ALL_BENCHES", "NOT_PORTED", "run_all", "timed_replay", "bench_testseq", "bench_autoinit",
           "bench_hires", "bench_batch64"]
