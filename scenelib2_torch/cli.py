"""Headless command line (a port of scenelib2_tpu/cli.py).

The reference ships a Pangolin GUI binary (examples/MonoSlamSceneLib1.cpp:
Continuous/Next/Stop buttons, Toggle Tracking, Enable Mapping, manual init,
state printing, frame dumps). This command line runs the same workflows headless:

  run          replay a sequence directory or a live camera frame by frame
               (go_one_step: one CUDA-graph replay a frame on the card),
               dump the trajectory, per-frame metrics JSONL, optionally a
               checkpoint and a torch.profiler trace
  bench        the benchmark suite (scenelib2_torch.eval.benchmark)
  visualize    plot a finished run (matplotlib)
  ar           AR overlays and a 3-D map of a replayed sequence
  selftest     replay the standard workload and compare its decisions
               fingerprint with the committed one (exit 1 on drift)
  print-state  load a checkpoint and print xv / Pxx (print_robot_state)

Every subcommand that runs the pipeline runs it on CUDA; --cpu runs the
plain PyTorch twins of the kernels on the CPU instead. run and print-state
take --precision f64: the JAX package's default process, its f64 parity
mode with use_pallas=False (MonoSLAM(..., precision="f64",
use_pallas=False): no kernel); the default is f32.

Usage:
  python -m scenelib2_torch.cli run --config data/SceneLib2.cfg --seq <dir> \
      --frames 200 --out run_out --mapping
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def _device(args):
    return "cpu" if args.cpu else None


def _precision(args) -> dict:
    """MonoSLAM's arguments for --precision: f64 is the JAX package's parity
    process, which runs its f64 step with use_pallas=False."""
    return dict(precision="f64", use_pallas=False) if args.precision == "f64" else {}


def cmd_run(args):
    from scenelib2_torch import MonoSLAM
    from scenelib2_torch.io.sequence import ImageSequence

    slam = MonoSLAM(args.config, max_features=args.max_features, device=_device(args), **_precision(args))
    if args.camera is not None:
        # live input (reference input.mode=1, UsbCamGrabber)
        from scenelib2_torch.io.camera import CameraGrabber

        seq = CameraGrabber(
            width=slam.params.cam_width, height=slam.params.cam_height,
            device=args.camera,
        )
    else:
        if args.seq is None:
            raise SystemExit("run: provide --seq <dir> or --camera <index>")
        seq = ImageSequence(args.seq)
        print(f"# frames read by {'the native grabber' if seq._native is not None else 'Python'} "
              f"({len(seq)} files)", file=sys.stderr)
    os.makedirs(args.out, exist_ok=True)
    prof = None
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if slam.device.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.__enter__()
    metrics_path = os.path.join(args.out, "metrics.jsonl")
    t_start = time.perf_counter()
    n = 0
    with open(metrics_path, "w") as mf:
        for i, frame in enumerate(seq):
            if args.frames and i >= args.frames:
                break
            if i == 0 and args.skip_first:
                continue
            t0 = time.perf_counter()
            slam.go_one_step(frame, save_trajectory=True, enable_mapping=args.mapping)
            o = slam.last_output
            rec = dict(
                frame=i,
                ms=round((time.perf_counter() - t0) * 1e3, 3),
                n_visible=int(o.n_visible),
                n_selected=int(o.n_selected),
                n_matched=int(o.n_matched),
                n_active=int(o.n_active),
                n_partial=int(o.n_partial),
                did_init=bool(o.did_init),
                did_convert=bool(o.did_convert),
                speed=round(float(o.speed), 4),
                r=[round(float(v), 6) for v in o.r.cpu().numpy()],
            )
            mf.write(json.dumps(rec) + "\n")
            n += 1
            if args.verbose and i % 10 == 0:
                print(json.dumps(rec), file=sys.stderr)
    if prof is not None:
        prof.__exit__(None, None, None)
        profile_dir = os.path.join(args.out, "profile")
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
        print(f"# profile trace: {profile_dir}", file=sys.stderr)
    traj = slam.trajectory()
    np.savez(os.path.join(args.out, "trajectory.npz"), r=traj)
    if args.checkpoint:
        slam.save_checkpoint(os.path.join(args.out, "final_state.npz"))
    dt = time.perf_counter() - t_start
    print(
        json.dumps(
            dict(frames=n, seconds=round(dt, 2), fps=round(n / dt, 2), out=args.out)
        )
    )


def cmd_bench(args):
    from scenelib2_torch.eval.benchmark import ALL_BENCHES, run_all

    unknown = sorted(set(args.names) - set(ALL_BENCHES))
    if unknown:
        raise SystemExit(f"bench: unknown benches {unknown}; known: {sorted(ALL_BENCHES)}")
    run_all(args.names or None, device=_device(args))


def cmd_visualize(args):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    data = np.load(os.path.join(args.run, "trajectory.npz"))
    traj = data["r"]
    fig = plt.figure(figsize=(10, 4))
    ax = fig.add_subplot(121, projection="3d")
    ax.plot(traj[:, 0], traj[:, 1], traj[:, 2], "b-")
    ax.scatter(traj[0, 0], traj[0, 1], traj[0, 2], c="g", label="start")
    ax.scatter(traj[-1, 0], traj[-1, 1], traj[-1, 2], c="r", label="end")
    ax.set_title("camera trajectory")
    ax.legend()
    ax2 = fig.add_subplot(122)
    with open(os.path.join(args.run, "metrics.jsonl")) as f:
        metrics = [json.loads(line) for line in f]
    ax2.plot([m["frame"] for m in metrics], [m["n_matched"] for m in metrics], label="matched")
    ax2.plot([m["frame"] for m in metrics], [m["n_active"] for m in metrics], label="map size")
    ax2.set_xlabel("frame")
    ax2.legend()
    out = args.out or os.path.join(args.run, "run.png")
    fig.savefig(out, dpi=120, bbox_inches="tight")
    plt.close(fig)
    print(out)


def cmd_ar(args):
    """AR replay (reference GraphicTool::DrawAR / Draw3dScene analog):
    re-run a sequence and dump per-frame overlays — search ellipses, match
    boxes, partial-feature particle-ellipse clouds, auto-init region boxes —
    plus a final 3-D map with true 3-sigma covariance ellipsoids."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from scenelib2_torch import MonoSLAM
    from scenelib2_torch.eval import viz
    from scenelib2_torch.io.sequence import ImageSequence

    slam = MonoSLAM(args.config, max_features=args.max_features, device=_device(args))
    seq = ImageSequence(args.seq)
    frames = []
    for i, f in enumerate(seq):
        if args.frames and i >= args.frames:
            break
        frames.append(f)
    frames = np.stack(frames)
    outs = slam.run_sequence(frames[1:], enable_mapping=args.mapping)
    os.makedirs(args.out, exist_ok=True)
    region = (slam.params.init_search_width, slam.params.init_search_height)
    paths = []
    for t in range(0, len(frames) - 1, args.every):
        fig, ax = plt.subplots(figsize=(6, 4.5))
        viz.render_ar_frame(ax, frames[t + 1], viz.frame_outputs(outs, t), slam.params.boxsize, region)
        p = os.path.join(args.out, f"ar_{t:04d}.png")
        fig.savefig(p, dpi=110, bbox_inches="tight")
        plt.close(fig)
        paths.append(p)
    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(111, projection="3d")
    viz.render_map_3d(ax, slam.state, outs.r.numpy())
    map_path = os.path.join(args.out, "map3d.png")
    fig.savefig(map_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    print(json.dumps(dict(ar_frames=len(paths), map=map_path, out=args.out)))


def cmd_selftest(args):
    """Replay the standard workload on the device and compare its decisions
    fingerprint with the expected file (eval/selftest.py); exits with its
    code. The port has no import-time precision switch, so this runs in
    this process."""
    from scenelib2_torch.eval.selftest import run_selftest

    raise SystemExit(run_selftest(args.expected or None, args.frames, args.update, args.cpu))


def cmd_print_state(args):
    from scenelib2_torch import MonoSLAM

    slam = MonoSLAM(args.config, device=_device(args), **_precision(args))
    slam.load_checkpoint(args.checkpoint)
    slam.print_robot_state()
    for row in slam.feature_table():
        print(row)


def _cpu_flag(parser):
    parser.add_argument("--cpu", action="store_true",
                        help="run the plain PyTorch twins of the kernels on the CPU")


def _precision_flag(parser):
    parser.add_argument("--precision", choices=("f32", "f64"), default="f32",
                        help="f64: the f64 parity mode with use_pallas=False (no kernel)")


def main(argv=None):
    p = argparse.ArgumentParser(prog="scenelib2_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("run", help="replay a sequence")
    pr.add_argument("--config", required=True)
    pr.add_argument("--seq", default=None)
    pr.add_argument("--camera", type=int, default=None,
                    help="live cv2 camera device index (instead of --seq)")
    pr.add_argument("--frames", type=int, default=0)
    pr.add_argument("--out", default="run_out")
    pr.add_argument("--max-features", type=int, default=16)
    pr.add_argument("--mapping", action="store_true")
    pr.add_argument("--no-skip-first", dest="skip_first", action="store_false")
    pr.add_argument("--checkpoint", action="store_true")
    pr.add_argument("--verbose", action="store_true")
    pr.add_argument("--profile", action="store_true", help="write a torch.profiler trace")
    _cpu_flag(pr)
    _precision_flag(pr)
    pr.set_defaults(func=cmd_run, skip_first=True)

    pb = sub.add_parser("bench", help="run benchmark suite")
    pb.add_argument("names", nargs="*")
    _cpu_flag(pb)
    pb.set_defaults(func=cmd_bench)

    pv = sub.add_parser("visualize", help="plot a finished run")
    pv.add_argument("--run", required=True)
    pv.add_argument("--out", default="")
    _cpu_flag(pv)
    pv.set_defaults(func=cmd_visualize)

    pa = sub.add_parser("ar", help="AR overlay + 3-D map replay (DrawAR analog)")
    pa.add_argument("--config", required=True)
    pa.add_argument("--seq", required=True)
    pa.add_argument("--frames", type=int, default=0)
    pa.add_argument("--out", default="ar_out")
    pa.add_argument("--max-features", type=int, default=16)
    pa.add_argument("--mapping", action="store_true")
    pa.add_argument("--every", type=int, default=1)
    _cpu_flag(pa)
    pa.set_defaults(func=cmd_ar)

    pt = sub.add_parser(
        "selftest", help="device decisions-fingerprint selftest (exit 1 on drift)"
    )
    pt.add_argument("--frames", type=int, default=240)
    pt.add_argument("--expected", default="")
    pt.add_argument("--update", action="store_true",
                    help="write the fingerprint to --expected (deliberate; never the committed file)")
    _cpu_flag(pt)
    pt.set_defaults(func=cmd_selftest)

    ps = sub.add_parser("print-state", help="print xv/Pxx from a checkpoint")
    ps.add_argument("--config", required=True)
    ps.add_argument("--checkpoint", required=True)
    _cpu_flag(ps)
    _precision_flag(ps)
    ps.set_defaults(func=cmd_print_state)

    args = p.parse_args(argv)
    args.func(args)


if __name__ == "__main__":
    main()
