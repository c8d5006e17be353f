"""Survey a traffic file's camera path on the reference: does the map grow
while tracking holds?

    python perfbench/survey_path.py --traffic room900-replay \
        --seeds 3200000001 3200000002 3200000003 3200000004 3200000005

For each seed it renders the stream as a run of the benchmark would (the
traffic's path and frame count, the std configuration's settings at
MAX_FEATURES), runs the reference (NumPy, f64) over it with mapping on,
and prints the live map (n_active), the visible features (n_visible) and
the matched ones (n_matched) every 100 frames, then a
summary line: the peak map, the share of frames after frame 30 with at
least 2 matched features, the fewest visible features after frame 30, the
largest position error against the rendered path (recorded, not judged:
the scale of a monocular map drifts) and the reference's seconds on one
core. The last line says whether every seed met the marks below. Streams
render on --device (cpu, or cuda as the benchmark's runs render them: the
two draw different textures from one seed); the references run in
--workers processes of one thread each.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_FEATURES = 100          # the split route's capacity the map should fill past the fused route's 61
PEAK_MIN, MATCHED_SHARE_MIN, VISIBLE_MIN, SKIP = 62, 0.95, 3, 30
COLUMNS = ("n_active", "n_visible", "n_matched")


def survey(job: dict) -> dict:
    """The reference over one stream; its per-frame counts, position
    errors and seconds."""
    import numpy as np

    from perfbench.reference.replay import DECISIONS, replay

    t0 = time.perf_counter()
    ref = replay(job["settings"], job["frames"], job["xv0"], job["pxx0"], job["known"], mapping=True)
    seconds = time.perf_counter() - t0
    counts = {k: ref["decisions"][:, DECISIONS.index(k)] for k in COLUMNS}
    err = np.linalg.norm(ref["pose"][:, :3] - job["r_true"], axis=1)
    return dict(seed=job["seed"], seconds=seconds, err=np.where(np.isnan(err), np.inf, err), **counts)


def summary(res: dict) -> dict:
    """The numbers the marks judge, of one seed's survey."""
    after = slice(SKIP, None)            # the frames after frame 30: row i is frame i + 1
    return dict(peak=int(res["n_active"].max()), matched_share=float((res["n_matched"][after] >= 2).mean()),
                visible_min=int(res["n_visible"][after].min()), err_max=float(res["err"].max()),
                seconds=res["seconds"])


def meets(s: dict) -> bool:
    return s["peak"] >= PEAK_MIN and s["matched_share"] >= MATCHED_SHARE_MIN and s["visible_min"] >= VISIBLE_MIN


def _init_worker():
    os.environ["OMP_NUM_THREADS"] = "1"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--traffic", required=True, help="a file of perfbench/traffic/, without .json")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--workers", type=int, default=1)
    args = ap.parse_args(argv)

    os.environ["OMP_NUM_THREADS"] = "1"
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    from perfbench import scene

    torch.set_num_threads(1)
    with open(os.path.join(ROOT, "perfbench", "configs", "std.json")) as f:
        settings = dict(json.load(f)["settings"], max_features=MAX_FEATURES)
    with open(os.path.join(ROOT, "perfbench", "traffic", f"{args.traffic}.json")) as f:
        traffic = json.load(f)
    path = traffic.get("path", "orbit")
    jobs = []
    for seed in args.seeds:
        frames, rs, qs, patches, points = scene.stream(seed, settings, traffic["frames"], settings["boxsize"],
                                                       args.device, path=path)
        xv0, pxx0 = scene.initial_filter(rs[0], qs[0], settings)
        xp = np.concatenate([rs[0], qs[0]])
        jobs.append(dict(seed=seed, settings=settings, frames=frames[1:].cpu().numpy(), xv0=xv0, pxx0=pxx0,
                         known=[(y, xp, p) for y, p in zip(points, patches)], r_true=rs[1:]))
    print(f"path {path!r}, {traffic['frames']} frames, std at max_features {MAX_FEATURES}, "
          f"rendered on {args.device}; marks: peak >= {PEAK_MIN}, n_matched >= 2 on >= {MATCHED_SHARE_MIN:.0%} "
          f"and n_visible >= {VISIBLE_MIN} on every frame after frame {SKIP}", flush=True)
    if args.workers <= 1:
        results = [survey(j) for j in jobs]
    else:
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(min(args.workers, len(jobs)), initializer=_init_worker) as pool:
            results = pool.map(survey, jobs)
            pool.close()
            pool.join()
    ok = True
    for res in results:
        print(f"seed {res['seed']}: frame n_active/n_visible/n_matched, every 100 frames")
        shown = range(0, len(res["n_active"]), 100)
        print("  " + " ".join(f"{t + 1}:{res['n_active'][t]}/{res['n_visible'][t]}/{res['n_matched'][t]}"
                              for t in shown))
        s = summary(res)
        ok &= meets(s)
        print(f"seed {res['seed']} peak {s['peak']} matched_share {s['matched_share']!r} visible_min "
              f"{s['visible_min']} err_max_m {s['err_max']!r} reference_s {s['seconds']!r} "
              f"{'meets' if meets(s) else 'FAILS'}", flush=True)
    print(f"every seed meets the marks: {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
