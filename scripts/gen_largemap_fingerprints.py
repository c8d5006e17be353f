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
  hires_bench bench_hires's own configuration (scenelib2_tpu/eval/benchmark.py::
          bench_hires): hires' dataset, but MonoSLAM(cfg, max_features=60)
          only; the cfg file carries no window radii, so the step searches
          at the defaults 32 and 32 (200 particles from the cfg); 119
          frames replayed.
  xla     the std sequence with max_features 16 on the pure-XLA route,
          MonoSLAM(cfg, max_features=16, use_pallas=False); 239 frames
          replayed.
  f64     the same in the JAX package's f64 parity mode (x64 on, the
          package's default process): MonoSLAM(cfg, max_features=16,
          use_pallas=False), no kernel at all; 239 frames replayed.
  f64_k2  the same with use_pallas=True: the f64 step with the NSSD search
          kernel (pallas_elliptical_search_fused) in stage 3 and everything
          else in f64 XLA; 239 frames replayed.
  std     the selftest's configuration, MonoSLAM(cfg, max_features=16)
          (its file at MAXP 1 is data/expected_fingerprint.json, which
          the JAX package's selftest keeps); 239 frames replayed.

--maxp N runs each configuration with max_features_to_init_at_once = N
(MonoSLAM's override) and writes expected_fingerprint_maxpN_<name>.json,
or expected_fingerprint_maxpN.json for std. At N > 1 the JAX step takes
stage 8's non-fused arm: whole-frame score maps, the particle predict
kernel and the search + Bayes kernel in compact mode. The MAXP-2 files:

    SCENELIB2_X64=0 JAX_PLATFORMS=cpu python scripts/gen_largemap_fingerprints.py \
        --maxp 2 --configs std autoinit mf100 xla --out-dir scenelib2_torch/data
    JAX_PLATFORMS=cpu python scripts/gen_largemap_fingerprints.py \
        --maxp 2 --configs f64 f64_k2 --out-dir scenelib2_torch/data

Each runs MonoSLAM(cfg, ..., use_pallas=True unless the configuration says
otherwise).run_sequence(frames[1:], enable_mapping=True) and hashes the
outputs with scenelib2_tpu.eval.selftest.decisions_fingerprint:

    SCENELIB2_X64=0 JAX_PLATFORMS=cpu python scripts/gen_largemap_fingerprints.py \
        --out-dir scenelib2_torch/data

writes expected_fingerprint_<name>.json for each f32 name (about 75 s of
compile each, ~30 s for xla; --configs NAME ... for some of them). The f64
configurations need x64, which the JAX package turns on unless
SCENELIB2_X64=0, so they run in a process of their own:

    JAX_PLATFORMS=cpu python scripts/gen_largemap_fingerprints.py \
        --configs f64 f64_k2 --out-dir scenelib2_torch/data

(~50 s each; with and without FMA the two agree, and both equal the std
file.)
 --dump DIR also saves each replay's
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
    "hires_bench": (120, HIRES_PARAMS, dict(max_features=60)),
    "xla": (240, None, dict(max_features=16, use_pallas=False)),
    "f64": (240, None, dict(max_features=16, use_pallas=False)),
    "f64_k2": (240, None, dict(max_features=16, use_pallas=True)),
    "std": (240, None, dict(max_features=16)),
}
# the configurations that run in the f64 parity mode (x64 on)
F64_CONFIGS = ("f64", "f64_k2")


def file_name(name: str, maxp: int) -> str:
    """The reference file's name (without .json) of a configuration at MAXP maxp."""
    if maxp == 1:
        return "expected_fingerprint" if name == "std" else f"expected_fingerprint_{name}"
    return f"expected_fingerprint_maxp{maxp}" + ("" if name == "std" else f"_{name}")


def run(name: str, dump_dir: str | None, maxp: int = 1) -> dict:
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
    slam = MonoSLAM(cfg, **{"use_pallas": True, **overrides, "max_features_to_init_at_once": maxp})
    t0 = time.time()
    outs = slam.run_sequence(frames[1:], enable_mapping=True)
    outs = jax.tree_util.tree_map(np.asarray, outs)
    T = n_frames - 1
    fp = decisions_fingerprint(outs, T)
    fp["dataset_version"] = DATASET_VERSION
    print(f"{name}: {T} frames in {time.time() - t0:.1f} s (compile included): {fp}")
    if dump_dir:
        os.makedirs(dump_dir, exist_ok=True)
        np.savez_compressed(os.path.join(dump_dir, f"{file_name(name, maxp)}.npz"), **outs._asdict())
    return fp


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--configs", nargs="*", default=None, choices=list(CONFIGS),
                    help="default: every configuration of this process's precision")
    ap.add_argument("--dump", default=None, metavar="DIR")
    ap.add_argument("--maxp", type=int, default=1, help="max_features_to_init_at_once")
    a = ap.parse_args()

    import jax.numpy as jnp

    import scenelib2_tpu  # noqa: F401  (turns x64 on unless SCENELIB2_X64=0)

    x64 = jnp.zeros(()).dtype == jnp.float64
    if a.configs is None:
        a.configs = [n for n in CONFIGS if (n in F64_CONFIGS) == x64 and (n != "std" or a.maxp > 1)]
    for name in a.configs:
        if (name in F64_CONFIGS) != x64:
            need = "x64 on: leave SCENELIB2_X64 unset" if name in F64_CONFIGS else \
                "fast (f32) mode: run with SCENELIB2_X64=0"
            raise SystemExit(f"{name} needs {need}")
    os.makedirs(a.out_dir, exist_ok=True)
    for name in a.configs:
        fp = run(name, a.dump, a.maxp)
        path = os.path.join(a.out_dir, f"{file_name(name, a.maxp)}.json")
        with open(path, "w") as f:
            json.dump(fp, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"wrote {path}")


if __name__ == "__main__":
    main()
