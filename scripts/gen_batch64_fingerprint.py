"""Generate the per-lane reference fingerprints of the 64-lane batch replay
from the JAX package (the bench_batch64 lanes of scenelib2_tpu/eval/benchmark.py:
32 scene textures x 2 one-frame phase offsets, known-feature patches from each
lane's own config, rng srand48(lane), batch_mode + use_pallas, max_features 16,
mapping on, 63 frames a lane).

Run on the CPU in fast (f32) mode; the Pallas kernels run in interpret mode:

    SCENELIB2_X64=0 JAX_PLATFORMS=cpu python scripts/gen_batch64_fingerprint.py \
        --out scenelib2_torch/data/expected_fingerprint_batch64.json

--route picks the JAX batch route: "default" (batch_pallas=True, the fused
search + Bayes kernel), "bp0" (batch_pallas=False: the XLA measurement chain,
the gathered-window search kernel, the XLA Shi-Tomasi, XLA score maps, the
dense particle search and the Bayes kernel) or "sb0" (batch_pallas=True with
SCENELIB2_BATCH_SB=0 set before the step is traced: the multi-ellipse search
kernel and the Bayes kernel in place of the fused one). --lanes-per-run N
steps the lanes N at a time (each lane is independent under the vmap) to
bound the memory of bp0's dense particle search ([N, 100, 240, 320] f32
temporaries). --dump FILE.npz also saves every lane's per-frame decision
fields, for comparing a port frame by frame.

XLA's CPU compiler contracts a*b + c into a fused multiply-add where the
instruction set has one; the TPU's vector unit and the port's kernels do
not. Two decisions of the 64 x 63 lane-frames sit inside that rounding
difference (scripts/batch64_near_ties.py shows both): the Shi-Tomasi
discriminant of one cell of lane 59 at output index 39 (0 unfused, -55
fused: a NaN eigenvalue that voids the region's pick; +1 exactly), and an
NSSD of 0.4000029 against the match threshold 0.40 in lanes 9 and 41
(indices 49 and 48, the same scene one frame apart). The run without FMA
(XLA_FLAGS=--xla_cpu_max_isa=AVX) decides the first as exact arithmetic
does, the default run the second. The committed file is the default run
with lane 59 taken from the run without FMA:

    SCENELIB2_X64=0 JAX_PLATFORMS=cpu python scripts/gen_batch64_fingerprint.py --out default.json
    XLA_FLAGS=--xla_cpu_max_isa=AVX SCENELIB2_X64=0 JAX_PLATFORMS=cpu \
        python scripts/gen_batch64_fingerprint.py --out nofma.json
    python scripts/gen_batch64_fingerprint.py --merge default.json nofma.json --take 59 \
        --out scenelib2_torch/data/expected_fingerprint_batch64.json
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


ROUTES = ("default", "bp0", "sb0")


def lanes(batch: int, n_textures: int, n_frames: int, route: str = "default"):
    """(params, stacked JAX states, frames [T, B, H, W] u8) of bench_batch64
    on the JAX batch route `route` (ROUTES). "sb0" sets SCENELIB2_BATCH_SB=0
    in this process; the JAX step reads it when it is traced."""
    if route not in ROUTES:
        raise ValueError(f"route {route!r} is not one of {ROUTES}")
    if route == "sb0":
        os.environ["SCENELIB2_BATCH_SB"] = "0"
    import jax
    import jax.numpy as jnp

    from scenelib2_tpu.config import load_config
    from scenelib2_tpu.eval.benchmark import _dataset
    from scenelib2_tpu.io.pgm import read_pgm
    from scenelib2_tpu.rng import pack_state, srand48
    from scenelib2_tpu.runtime import state as st

    offsets = max(1, batch // n_textures)
    lane_frames, lane_cfgs = [], []
    for tex in range(n_textures):
        fr, cfg_path, _ = _dataset(n_frames + offsets, seed=7 + tex, tag=f"b64t{tex}")
        lane_cfgs.append(load_config(cfg_path))
        lane_frames.append(fr)
    params = dataclasses.replace(
        lane_cfgs[0].params, max_features=16, use_pallas=True, batch_mode=True,
        batch_pallas=route != "bp0",
    )
    states = []
    fb = np.empty((batch, n_frames - 1) + lane_frames[0].shape[1:], np.uint8)
    for lane in range(batch):
        tex, off = lane % n_textures, lane // n_textures
        lcfg = lane_cfgs[tex]
        s = st.init_state(params, lcfg.xv0, lcfg.pxx0)
        for kf in lcfg.known_features:
            s = st.add_known_feature(s, kf.y, kf.xp_org, read_pgm(kf.patch_path))
        states.append(s)
        fb[lane] = lane_frames[tex][1 + off : n_frames + off]
    states = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *states)
    states = states._replace(
        rng=jnp.asarray(np.stack([pack_state(srand48(i)) for i in range(batch)]))
    )
    return params, states, jnp.swapaxes(jnp.asarray(fb, jnp.uint8), 0, 1)


def merge(base_path: str, other_path: str, take: list[int], out: str) -> None:
    """The base file with the lanes in `take` replaced by the other file's."""
    with open(base_path) as f:
        doc = json.load(f)
    with open(other_path) as f:
        other = json.load(f)
    for k in ("dataset_version", "batch", "n_textures", "n_frames", "max_features", "route"):
        if doc.get(k, "default") != other.get(k, "default"):
            raise SystemExit(f"the two files differ in {k}")
    differing = [i for i, (a, b) in enumerate(zip(doc["lanes"], other["lanes"])) if a != b]
    for lane in take:
        doc["lanes"][lane] = other["lanes"][lane]
    doc["lanes_from_run_without_fma"] = sorted(take)
    with open(out, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {out}: lanes {sorted(take)} from {other_path}; the two runs differ in lanes {differing}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--merge", nargs=2, metavar=("BASE", "OTHER"), default=None,
                    help="merge two generated files instead of running JAX")
    ap.add_argument("--take", type=int, nargs="*", default=[], help="lanes taken from OTHER")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--textures", type=int, default=32)
    ap.add_argument("--frames", type=int, default=64, help="frames rendered; one less is replayed")
    ap.add_argument("--route", choices=ROUTES, default="default")
    ap.add_argument("--lanes-per-run", type=int, default=0,
                    help="step the lanes this many at a time (0: all at once)")
    ap.add_argument("--dump", default=None)
    a = ap.parse_args()
    if a.merge:
        merge(a.merge[0], a.merge[1], a.take, a.out)
        return

    import jax
    import jax.numpy as jnp

    from scenelib2_tpu.eval.selftest import DECISION_FIELDS, decisions_fingerprint
    from scenelib2_tpu.eval.synthetic import DATASET_VERSION
    from scenelib2_tpu.runtime import step as step_mod

    if jnp.zeros(()).dtype != jnp.float32:
        raise SystemExit("needs fast (f32) mode: run with SCENELIB2_X64=0")
    params, states, fb = lanes(a.batch, a.textures, a.frames, a.route)
    vstep = jax.jit(jax.vmap(step_mod.make_step(params), in_axes=(0, 0, None)))
    n = a.lanes_per_run or a.batch
    chunks = []
    for lo in range(0, a.batch, n):
        st_c = jax.tree_util.tree_map(lambda x: x[lo : lo + n], states)
        per_frame = []
        for t in range(fb.shape[0]):
            st_c, o = vstep(st_c, fb[t, lo : lo + n], True)
            per_frame.append(jax.tree_util.tree_map(np.asarray, o))
        chunks.append(jax.tree_util.tree_map(lambda *xs: np.stack(xs), *per_frame))
    outs = jax.tree_util.tree_map(lambda *xs: np.concatenate(xs, axis=1), *chunks)   # [T, B, ...]
    T = fb.shape[0]
    fps = []
    for lane in range(a.batch):
        lane_outs = jax.tree_util.tree_map(lambda x: x[:, lane], outs)
        fps.append(decisions_fingerprint(lane_outs, T))
    doc = dict(
        dataset_version=DATASET_VERSION, batch=a.batch, n_textures=a.textures,
        n_frames=T, max_features=params.max_features, lanes=fps,
    )
    if a.route != "default":
        doc["route"] = a.route
    with open(a.out, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    distinct = len({fp["decisions_sha256"] for fp in fps})
    ends = sorted({fp["active_end"] for fp in fps})
    print(f"wrote {a.out}: {a.batch} lanes x {T} frames, {distinct} distinct histories, "
          f"active_end in {ends}")
    if a.dump:
        fields = DECISION_FIELDS + ("sel_slot", "sel_mask", "sel_matched", "init_box",
                                    "par_slot", "par_mask", "r", "q")
        np.savez_compressed(a.dump, **{k: np.asarray(getattr(outs, k)) for k in fields})


if __name__ == "__main__":
    main()
