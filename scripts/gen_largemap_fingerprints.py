"""Generate the reference fingerprints of the larger-map replays from the
JAX package, in fast (f32) mode on the CPU with interpret-mode kernels:

  hires   BASELINE config 3 (scenelib2_tpu/eval/benchmark.py::bench_hires):
          the 120-frame 640x480 sequence of seed 7 with the hires Params,
          max_features 60 (D = 373, the fused route), search_win_radius 48,
          particle_win_radius 52, 200 particles; 119 frames replayed.
  mf100   the 240-frame std sequence of seed 7 with max_features 100
          (D = 613, the split route that inverts S with
          pallas_linalg.py::pallas_chol_inv_lower); 239 frames replayed.
  autoinit bench_autoinit's configuration (scenelib2_tpu/eval/benchmark.py::
          bench_autoinit): the same sequence with max_features 24 (D = 157,
          the fused route, stage 8 under the light/heavy choice); 239
          frames replayed.

Both run MonoSLAM(cfg, ..., use_pallas=True).run_sequence(frames[1:],
enable_mapping=True) and hash the outputs with
scenelib2_tpu.eval.selftest.decisions_fingerprint:

    SCENELIB2_X64=0 JAX_PLATFORMS=cpu python scripts/gen_largemap_fingerprints.py \
        --out-dir scenelib2_torch/data

writes expected_fingerprint_<name>.json for each name (about 75 s of
compile each; --configs NAME ... for some of them). --dump DIR also saves each replay's
per-frame outputs as DIR/<name>.npz, for comparing a port frame by frame.

XLA's CPU compiler contracts a*b + c into fused multiply-adds where the
instruction set has them, which the TPU and the port's kernels do not. The
cross-check runs the generator again without them and compares:

    XLA_FLAGS=--xla_cpu_max_isa=AVX SCENELIB2_X64=0 JAX_PLATFORMS=cpu \
        python scripts/gen_largemap_fingerprints.py --out-dir nofma/
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# name -> (frames rendered, Params overrides of the dataset or None for the
# std config file, MonoSLAM overrides)
HIRES_PARAMS = dict(cam_width=640, cam_height=480, cam_fku=390.0, cam_fkv=390.0,
                    cam_u0=324.0, cam_v0=250.0, max_features=60,
                    search_win_radius=48, particle_win_radius=52, n_particles=200)
CONFIGS = {
    "hires": (120, HIRES_PARAMS,
              dict(max_features=60, search_win_radius=48, particle_win_radius=52)),
    "mf100": (240, None, dict(max_features=100)),
    "autoinit": (240, None, dict(max_features=24)),
}


def run(name: str, dump_dir: str | None) -> dict:
    import jax

    from scenelib2_tpu.config import Params
    from scenelib2_tpu.eval.benchmark import _dataset
    from scenelib2_tpu.eval.selftest import decisions_fingerprint
    from scenelib2_tpu.eval.synthetic import DATASET_VERSION
    from scenelib2_tpu.runtime.slam import MonoSLAM

    n_frames, dataset_params, overrides = CONFIGS[name]
    if dataset_params is None:
        frames, cfg, _ = _dataset(n_frames)
    else:
        frames, cfg, _ = _dataset(n_frames, params=Params(**dataset_params), tag="hires")
    slam = MonoSLAM(cfg, use_pallas=True, **overrides)
    t0 = time.time()
    outs = slam.run_sequence(frames[1:], enable_mapping=True)
    outs = jax.tree_util.tree_map(np.asarray, outs)
    T = n_frames - 1
    fp = decisions_fingerprint(outs, T)
    fp["dataset_version"] = DATASET_VERSION
    print(f"{name}: {T} frames in {time.time() - t0:.1f} s (compile included): {fp}")
    if dump_dir:
        os.makedirs(dump_dir, exist_ok=True)
        np.savez_compressed(os.path.join(dump_dir, f"{name}.npz"), **outs._asdict())
    return fp


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--configs", nargs="*", default=list(CONFIGS), choices=list(CONFIGS))
    ap.add_argument("--dump", default=None, metavar="DIR")
    a = ap.parse_args()

    import jax.numpy as jnp

    if jnp.zeros(()).dtype != jnp.float32:
        raise SystemExit("needs fast (f32) mode: run with SCENELIB2_X64=0")
    os.makedirs(a.out_dir, exist_ok=True)
    for name in a.configs:
        fp = run(name, a.dump)
        path = os.path.join(a.out_dir, f"expected_fingerprint_{name}.json")
        with open(path, "w") as f:
            json.dump(fp, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"wrote {path}")


if __name__ == "__main__":
    main()
