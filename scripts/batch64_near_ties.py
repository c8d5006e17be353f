"""The two rounding-level ties of the 64-lane batch replay, evaluated exactly.

The JAX batch step on the CPU decides 3 of the 64 x 63 lane-frames
differently with and without fused multiply-add contraction (see
scripts/gen_batch64_fingerprint.py). This script replays the lanes in
question with the port on the CPU (torch and numpy only), takes the inputs of
the kernel call where each tie sits, and evaluates the tied quantity in f32
as the kernels do, with the contraction emulated, and in f64:

  lane 59, output index 39: K6's discriminant (A + C)^2 - 4 (A C - B^2) over
    the region's cells; the smallest one decides whether an eigenvalue is NaN;
  lane 41, output index 48 (and lane 9, index 49: the same scene one frame
    earlier in phase): the NSSD of a selected feature's best cell against
    the match threshold corr_thresh2.

The 16-lane batch-hires replay (BASELINE config 3, the lanes of
scenelib2_torch/data/expected_fingerprint_batch_hires.json) has one such
lane-frame, evaluated the same way:

  lane 4, output index 26: K6's discriminant, as for lane 59 above.

The 16 lanes at max_features_to_init_at_once = 2 (config "maxp2", lanes 0-15
of the 64-lane recipe, scenelib2_torch/data/
expected_fingerprint_batch16_maxp2.json) have one:

  lane 9, output index 49: the NSSD tie of the std lanes above, reached at
    MAXP 2 too.

    python scripts/batch64_near_ties.py
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import scenelib2_torch.runtime.step as step_mod  # noqa: E402
from scenelib2_torch.eval.batch import make_lanes  # noqa: E402
from scenelib2_torch.parallel.mesh import make_batched_step  # noqa: E402


# configuration -> the make_lanes arguments of its committed replay
REPLAYS = {"std": dict(batch=64, n_textures=32, n_frames=64), "hires": dict(batch=16, n_textures=8, n_frames=40),
           "maxp2": dict(batch=64, n_textures=32, n_frames=64)}


def replay_to(lane: int, index: int, wrapper: str, tmp: str, config: str = "std"):
    """The arguments and result of `wrapper` at output index `index` of one
    lane of the committed replay at `config`."""
    params, states, frames = make_lanes(tmp, device="cpu", dtype=torch.float32, lanes=[lane], config=config,
                                        **REPLAYS[config])
    step = make_batched_step(params, device="cpu")
    seen = {}
    orig = getattr(step_mod, wrapper)

    def spy(*a, **k):
        seen["args"], seen["kwargs"], seen["out"] = a, k, orig(*a, **k)
        return seen["out"]

    setattr(step_mod, wrapper, spy)
    try:
        for t in range(index + 1):
            states, out = step(states, torch.as_tensor(frames[t]), True)
    finally:
        setattr(step_mod, wrapper, orig)
    return params, seen, out


def k6_tie(tmp: str, lane: int = 59, index: int = 39, config: str = "std") -> None:
    params, seen, out = replay_to(lane, index, "shi_tomasi", tmp, config)
    frame = seen["args"][0][0].numpy().astype(np.int64)
    us, vs, uf, vf = (int(t[0]) for t in seen["args"][1:5])
    half = (params.boxsize - 1) // 2
    gx = np.zeros_like(frame)
    gy = np.zeros_like(frame)
    gx[:, 1:-1] = frame[:, 2:] - frame[:, :-2]
    gy[1:-1, :] = frame[2:, :] - frame[:-2, :]
    f32 = np.float32
    worst = None
    for v in range(vs, vf):
        for u in range(us, uf):
            wx = gx[v - half : v + half + 1, u - half : u + half + 1]
            wy = gy[v - half : v + half + 1, u - half : u + half + 1]
            A, C, B = (f32(s) * f32(0.25) for s in ((wx * wx).sum(), (wy * wy).sum(), (wx * wy).sum()))
            s = f32(A + C)
            unfused = f32(f32(s * s) - f32(f32(4.0) * f32(f32(A * C) - f32(B * B))))
            inner = f32(float(A) * float(C) - float(f32(B * B)))           # fma(A, C, -(B*B))
            fused = f32(float(s) * float(s) - float(f32(f32(4.0) * inner)))  # fma(s, s, -(4*inner))
            exact = (float(A) - float(C)) ** 2 + 4.0 * float(B) ** 2
            if worst is None or fused < worst[0]:
                worst = (fused, unfused, exact, u, v, float(A), float(C), float(B))
    fused, unfused, exact, u, v, A, C, B = worst
    print(f"{config} lane {lane}, output index {index}: region [{us}, {uf}) x [{vs}, {vf}); "
          f"did_init {bool(out.did_init[0])}")
    print(f"  cell (u, v) = ({u}, {v}): A = {A}, C = {C}, B = {B}")
    print(f"  discriminant: f32 unfused {unfused}, f32 with fused multiply-add {fused}, exact {exact}")
    print(f"  -> sqrt is {'NaN' if fused < 0 else 'real'} with contraction, "
          f"{'NaN' if unfused < 0 else 'real'} without")


def k2_tie(lane: int, index: int, pick: int | None, tmp: str, config: str = "std") -> None:
    """pick None: the selected feature whose NSSD lies nearest the threshold."""
    params, seen, out = replay_to(lane, index, "search", tmp, config)
    frames, rows = seen["args"][0], seen["args"][1]
    found, u, v, best, _over = seen["out"]
    if pick is None:
        gap = (best[0] - params.corr_thresh2).abs().masked_fill(~out.sel_mask[0], float("inf"))
        pick = int(torch.argmin(gap))
    uu, vv = int(u[0, pick]), int(v[0, pick])
    half = (params.boxsize - 1) // 2
    win = frames[0].numpy().astype(np.float64)[vv - half : vv + half + 1, uu - half : uu + half + 1]
    patch = rows[0, pick, : params.boxsize ** 2].numpy().astype(np.float64).reshape(win.shape)
    p0 = (patch - patch.mean()) / patch.std()
    p1 = (win - win.mean()) / win.std()
    exact = float(((p0 - p1) ** 2).mean())
    print(f"{config} lane {lane}, output index {index}, pick {pick} (slot {int(out.sel_slot[0, pick])}) at "
          f"(u, v) = ({uu}, {vv}): NSSD f32 {float(best[0, pick])!r}, exact {exact!r}, "
          f"threshold {params.corr_thresh2}; found {bool(found[0, pick])}")


def main() -> None:
    torch.set_num_threads(max(1, min(4, os.cpu_count() or 1)))
    with tempfile.TemporaryDirectory() as tmp:
        k6_tie(tmp)
        k2_tie(41, 48, 4, tmp)
        k2_tie(9, 49, 1, tmp)
        k6_tie(tmp, 4, 26, "hires")
        k2_tie(9, 49, None, tmp, "maxp2")


if __name__ == "__main__":
    main()
