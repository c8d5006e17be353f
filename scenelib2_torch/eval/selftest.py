"""Device selftest: replay the standard workload on the device and compare
its decisions fingerprint with the committed one (a port of
scenelib2_tpu/eval/selftest.py).

    python -m scenelib2_torch.cli selftest          # compare, exit 1 on drift
    python -m scenelib2_torch.cli selftest --cpu    # the plain twins on the CPU

The workload is the 240-frame seed-7 synthetic sequence (239 frames replayed)
at max_features 16 with mapping on, replayed by MonoSLAM.run_sequence (on
the card: CUDA-graph replay of the hand-written kernels); the fingerprint is
eval/fingerprint.py's, and the expected file is
scenelib2_torch/data/expected_fingerprint.json. A kernel or a build whose
decisions drift from the JAX package's fails the command with exit 1. The
exit codes are the JAX selftest's: 0 match, 1 drift, 2 no expected file.
`update` writes the fingerprint to the path it is given, and only there: it
never rewrites the committed file by default.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np

from scenelib2_torch.eval.fingerprint import DATA_DIR, decisions_fingerprint

EXPECTED_PATH = os.path.join(DATA_DIR, "expected_fingerprint.json")


def std_dataset(n_frames: int, seed: int = 7, params=None, tag: str = "std", root: str | None = None):
    """(frames [n_frames, H, W] u8, cfg path) of the seed's synthetic
    sequence, rendered once into a cache under root (the temporary
    directory where root is None)."""
    from scenelib2_torch.eval.synthetic import DATASET_VERSION, generate_dataset

    cache = os.path.join(root or tempfile.gettempdir(),
                         f"scenelib2_torch_ds_v{DATASET_VERSION}_{tag}_{n_frames}_{seed}")
    fr = os.path.join(cache, "frames.npy")
    if not os.path.exists(fr):
        os.makedirs(cache, exist_ok=True)
        frames, _rs, _qs, _cfg = generate_dataset(cache, n_frames=n_frames, seed=seed, params=params)
        np.save(fr + ".tmp.npy", frames)
        os.replace(fr + ".tmp.npy", fr)
    return np.load(fr), os.path.join(cache, "synthetic.cfg")


def run_selftest(expected_path: str | None = None, n_frames: int = 240,
                 update: bool = False, cpu: bool = False) -> int:
    """Returns a process exit code (0 = fingerprint matches)."""
    from scenelib2_torch import MonoSLAM
    from scenelib2_torch.device import card_line
    from scenelib2_torch.eval.synthetic import DATASET_VERSION

    if update and not expected_path:
        print("selftest: --update needs --expected PATH (the committed file is not rewritten)",
              file=sys.stderr)
        return 2
    expected_path = expected_path or EXPECTED_PATH
    frames, cfg = std_dataset(n_frames)
    slam = MonoSLAM(cfg, max_features=16, device="cpu" if cpu else None)
    print(f"# selftest device: {slam.device}; card: {card_line(slam.device)}", file=sys.stderr)
    seq = slam._to_device(frames[1:])
    t0 = time.perf_counter()
    slam.run_sequence(seq, enable_mapping=True)
    print(f"# first run (kernel builds and graph captures included): {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    slam.reset()
    outs = slam.run_sequence(seq, enable_mapping=True)
    got = decisions_fingerprint(outs, len(seq))
    got["dataset_version"] = DATASET_VERSION
    print(f"# fingerprint: {json.dumps(got)}", file=sys.stderr)

    if update:
        with open(expected_path, "w") as f:
            json.dump(got, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"selftest: wrote {expected_path}")
        return 0
    if not os.path.exists(expected_path):
        print(f"selftest: no expected file at {expected_path}", file=sys.stderr)
        return 2
    with open(expected_path) as f:
        want = json.load(f)
    diffs = {k: (want[k], got.get(k)) for k in want if got.get(k) != want[k]}
    if diffs:
        print(f"selftest: FINGERPRINT MISMATCH — the pipeline on {slam.device} makes different "
              "decisions than the expected file:", file=sys.stderr)
        for k, (w, g) in sorted(diffs.items()):
            print(f"  {k}: expected {w}, got {g}", file=sys.stderr)
        print("selftest: FAIL")
        return 1
    print(f"selftest: OK ({got['matched_sum']} matches, {got['inits']} inits, "
          f"{got['convs']} conversions over {got['n_frames']} frames on {slam.device})")
    return 0
