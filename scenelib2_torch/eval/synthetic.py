"""Synthetic TestSeqMonoSLAM-style dataset generator with exact ground truth.

The reference is evaluated by replaying the TestSeqMonoSLAM image directory
(README:107-129), which is not distributed with the repo. For repeatable
benchmarks and parity tests we render our own sequences with the SAME camera
model (negated focal + radial distortion, stock SceneLib2.cfg calibration):

  - the scene is a large textured plane at z=0 (where the reference's printed
    target lives; cfg known features are its 4 corners at +-0.105/+-0.07425)
  - each frame renders by unprojecting every pixel through the calibrated
    camera model, intersecting the plane, and sampling the texture bilinearly
  - the 4 known patches are CROPPED from frame 0 at the projections of the
    known world points, exactly as patches were captured in the original
    dataset, and written as P5 PGMs + a generated .cfg

Because rendering uses the identical camera model the SLAM filter assumes,
the generated ground-truth trajectory is exact and RMSE targets are
meaningful.

A copy of scenelib2_tpu/eval/synthetic.py (numpy only): for a given seed it
renders byte-identical frames. HIRES_PARAMS / HIRES_OVERRIDES copy the
640x480 configuration of scenelib2_tpu/eval/benchmark.py::bench_hires.
"""

from __future__ import annotations

import os

import numpy as np

from scenelib2_torch.config import Params, load_config
from scenelib2_torch.io.pgm import write_pgm

# BASELINE config 3 (scenelib2_tpu/eval/benchmark.py:153-157): the Params of
# the 640x480 dataset (window caps scale with resolution), and the MonoSLAM
# overrides of its parity run (tests/test_fast_parity.py:199-200; the cfg
# file carries neither window radius)
HIRES_PARAMS = dict(cam_width=640, cam_height=480, cam_fku=390.0, cam_fkv=390.0, cam_u0=324.0,
                    cam_v0=250.0, max_features=60, search_win_radius=48, particle_win_radius=52,
                    n_particles=200)
HIRES_OVERRIDES = dict(max_features=60, search_win_radius=48, particle_win_radius=52)


def make_texture(rng: np.random.Generator, size: int = 2048, smooth: int = 2) -> np.ndarray:
    """High-contrast smooth-ish random texture (f64 in [0,255])."""
    tex = rng.uniform(0.0, 255.0, size=(size, size))
    for _ in range(smooth):
        tex = (
            tex
            + np.roll(tex, 1, 0)
            + np.roll(tex, -1, 0)
            + np.roll(tex, 1, 1)
            + np.roll(tex, -1, 1)
        ) / 5.0
    tex -= tex.min()
    tex *= 255.0 / max(tex.max(), 1e-9)
    return tex


def quat_to_R(q):
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def quat_mul(a, b):
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ]
    )


def quat_from_axis_angle(axis, angle):
    axis = np.asarray(axis, float)
    axis = axis / np.linalg.norm(axis)
    return np.concatenate([[np.cos(angle / 2)], np.sin(angle / 2) * axis])


# bump when the generator's output changes: embedded in every dataset cache
# key so stale /tmp caches can't poison benchmark or driver runs
DATASET_VERSION = 4


def default_trajectory(n_frames: int, delta_t: float):
    """Smooth handheld-style exploratory trajectory starting at the cfg pose
    (0,0,-0.6).

    True speed stays in ~[0.216, 0.235] m/s — strictly above the reference's
    0.2 m/s mapping gate (SceneLib2.cfg min_speed; monoslam.cpp:157-163) so
    auto-initialisation keeps firing and the map grows toward the
    keep-visible threshold, like the real TestSeqMonoSLAM workload. (The v1
    trajectory peaked at 0.17 m/s: mapping stalled after the filter's early
    noisy speed estimates settled, leaving 4-6 feature maps.)

    Rotation is a partial look-at toward the scene centre: enough to keep
    the textured plane in view, but under-corrected so new texture keeps
    flowing through the image and there are fresh regions to initialise.
    """
    rs = np.zeros((n_frames, 3))
    qs = np.zeros((n_frames, 4))
    t = np.arange(n_frames) * delta_t
    om = 1.8
    rs[:, 0] = 0.13 * np.sin(om * t)                   # orbit x
    rs[:, 1] = 0.12 * (1.0 - np.cos(om * t))           # orbit y
    rs[:, 2] = -0.60 + 0.03 * (1 - np.cos(0.8 * t))    # gentle approach
    for i in range(n_frames):
        # half look-at correction toward the world origin on the plane:
        # keeps patch view angles small (features survive the 45-degree
        # visibility test) while still sweeping fresh texture through view
        yaw = 0.5 * np.arctan2(rs[i, 0], -rs[i, 2])
        pitch = 0.5 * np.arctan2(rs[i, 1], -rs[i, 2])
        q = quat_mul(quat_from_axis_angle([0, 1, 0], -yaw), quat_from_axis_angle([1, 0, 0], pitch))
        qs[i] = q / np.linalg.norm(q)
    return rs, qs


def texture_coords(params: Params, tex_shape, r: np.ndarray, q: np.ndarray,
                   tex_scale: float):
    """Per-pixel texel coordinates of the z=0 plane hit from pose (r, q).

    The exact pixel->texel mapping the renderer samples through (unproject
    via the calibrated camera, intersect the plane, scale into the texture).
    Returns (tx, ty, hit); tx/ty are zeroed (NaN-free) where the ray misses.
    Exposed separately so stamp_patch_on_plane can invert the mapping."""
    W, Hh = params.cam_width, params.cam_height
    u = np.arange(W)[None, :].repeat(Hh, 0).astype(np.float64)
    v = np.arange(Hh)[:, None].repeat(W, 1).astype(np.float64)
    cu = u - params.cam_u0
    cv = v - params.cam_v0
    r2 = cu * cu + cv * cv
    # beyond the distortion model's valid radius (1 - 2*kd1*r2 <= 0, reachable
    # at hires calibrations) the pixel unprojects nowhere: mask it instead of
    # letting NaNs flow into the int cast below (they were rejected by `inb`
    # only via NumPy's NaN->INT_MIN cast behaviour, with RuntimeWarnings)
    arg = 1.0 - 2.0 * params.cam_kd1 * r2
    dist_ok = arg > 0
    factor = np.sqrt(np.where(dist_ok, arg, 1.0))
    und_u = np.where(dist_ok, cu / factor, 0.0)
    und_v = np.where(dist_ok, cv / factor, 0.0)
    d_cam = np.stack([und_u / -params.cam_fku, und_v / -params.cam_fkv, np.ones_like(und_u)], -1)
    R = quat_to_R(q)
    d_world = d_cam @ R.T
    dz = d_world[..., 2]
    ray_ok = dist_ok & (dz != 0)
    tz = np.where(ray_ok, -r[2] / np.where(dz != 0, dz, 1.0), -1.0)
    hit = ray_ok & (tz > 0)
    px = r[0] + tz * d_world[..., 0]
    py = r[1] + tz * d_world[..., 1]
    # texture centred on world origin; masked where the ray misses so the
    # floor/int cast below stays warning-clean (pixel values are unchanged:
    # hit gates inb either way)
    tx = np.where(hit, px / tex_scale + tex_shape[1] / 2.0, 0.0)
    ty = np.where(hit, py / tex_scale + tex_shape[0] / 2.0, 0.0)
    return tx, ty, hit


def render_frame(params: Params, tex: np.ndarray, r: np.ndarray, q: np.ndarray,
                 tex_scale: float, background: float = 128.0) -> np.ndarray:
    """Render one frame through the calibrated camera (vectorised numpy)."""
    tx, ty, hit = texture_coords(params, tex.shape, r, q, tex_scale)
    x0 = np.floor(tx).astype(int)
    y0 = np.floor(ty).astype(int)
    inb = hit & (x0 >= 0) & (x0 < tex.shape[1] - 1) & (y0 >= 0) & (y0 < tex.shape[0] - 1)
    x0c = np.clip(x0, 0, tex.shape[1] - 2)
    y0c = np.clip(y0, 0, tex.shape[0] - 2)
    fx = tx - x0
    fy = ty - y0
    t00 = tex[y0c, x0c]
    t01 = tex[y0c, x0c + 1]
    t10 = tex[y0c + 1, x0c]
    t11 = tex[y0c + 1, x0c + 1]
    val = (1 - fy) * ((1 - fx) * t00 + fx * t01) + fy * ((1 - fx) * t10 + fx * t11)
    img = np.where(inb, val, background)
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def project_point(params: Params, y: np.ndarray, r: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Reference projection of world point y from pose (r, q)."""
    Rw = quat_to_R(q)
    camp = Rw.T @ (y - r)
    uc = np.array([-params.cam_fku * camp[0] / camp[2], -params.cam_fkv * camp[1] / camp[2]])
    f = np.sqrt(1 + 2 * params.cam_kd1 * (uc @ uc))
    return uc / f + np.array([params.cam_u0, params.cam_v0])


KNOWN_POINTS = np.array(
    [
        [0.105, 0.07425, 0.0],
        [-0.105, 0.07425, 0.0],
        [0.105, -0.07425, 0.0],
        [-0.105, -0.07425, 0.0],
    ]
)


def generate_dataset(
    out_dir: str,
    n_frames: int = 150,
    seed: int = 7,
    params: Params | None = None,
    base_cfg: str | None = None,
):
    """Render a sequence + patches + cfg into out_dir.

    Returns (frames [T,H,W] u8, gt_r [T,3], gt_q [T,4], cfg_path).
    """
    if params is None:
        here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        base_cfg = base_cfg or os.path.join(here, "data", "SceneLib2.cfg")
        params = load_config(base_cfg).params

    rng = np.random.default_rng(seed)
    tex = make_texture(rng)
    tex_scale = 0.6 / params.cam_fku  # ~1 px per texel at the start pose

    rs, qs = default_trajectory(n_frames, params.delta_t)
    frames = np.stack([render_frame(params, tex, rs[i], qs[i], tex_scale) for i in range(n_frames)])

    os.makedirs(os.path.join(out_dir, "seq"), exist_ok=True)
    for i, f in enumerate(frames):
        write_pgm(os.path.join(out_dir, "seq", f"rawoutput{i:04d}.pgm"), f)

    # crop the 4 known patches from frame 0 (integer-rounded projections)
    half = (params.boxsize - 1) // 2
    patch_paths = []
    for k, y in enumerate(KNOWN_POINTS):
        h = project_point(params, y, rs[0], qs[0])
        uu, vv = int(round(h[0])), int(round(h[1]))
        patch = frames[0][vv - half : vv + half + 1, uu - half : uu + half + 1]
        p = os.path.join(out_dir, f"known_patch{k}.pgm")
        write_pgm(p, patch)
        patch_paths.append(p)

    cfg_path = os.path.join(out_dir, "synthetic.cfg")
    _write_cfg(cfg_path, params, rs[0], qs[0], patch_paths)
    np.savez(os.path.join(out_dir, "ground_truth.npz"), r=rs, q=qs)
    return frames, rs, qs, cfg_path


def _write_cfg(path: str, p: Params, r0, q0, patch_paths):
    lines = [
        "# generated synthetic dataset (scenelib2_torch.eval.synthetic)",
        "input.mode = 0;",
        f"input.name = {os.path.join(os.path.dirname(path), 'seq')};",
        f"cam.width = {p.cam_width};",
        f"cam.height = {p.cam_height};",
        f"cam.fku = {int(p.cam_fku)};",
        f"cam.fkv = {int(p.cam_fkv)};",
        f"cam.u0 = {int(p.cam_u0)};",
        f"cam.v0 = {int(p.cam_v0)};",
        f"cam.kd1 = {p.cam_kd1};",
        f"cam.sd = {int(p.cam_sd)};",
        f"params.delta_t = {p.delta_t};",
        f"params.number_of_features_to_select = {p.n_features_to_select};",
        f"params.number_of_features_to_keep_visible = {p.n_features_to_keep_visible};",
        f"params.max_features_to_init_at_once = {p.max_features_to_init_at_once};",
        f"params.min_lambda = {p.min_lambda};",
        f"params.max_lambda = {p.max_lambda};",
        f"params.number_of_particles = {p.n_particles};",
        f"params.standard_deviation_depth_ratio = {p.sd_depth_ratio};",
        f"params.min_number_of_particles = {p.min_particles};",
        f"params.prune_probability_threshold = {p.prune_prob_thresh};",
        f"params.erase_partially_init_feature_after_this_many_attempts = {p.erase_partial_after_attempts};",
        f"state.rw_x = {r0[0]};",
        f"state.rw_y = {r0[1]};",
        f"state.rw_z = {r0[2]};",
        f"state.qwr_w = {q0[0]};",
        f"state.qwr_x = {q0[1]};",
        f"state.qwr_y = {q0[2]};",
        f"state.qwr_z = {q0[3]};",
        "state.vw_x = 0.0;",
        "state.vw_y = 0.0;",
        "state.vw_z = 0.0;",
        "state.ww_x = 0.0;",
        "state.ww_y = 0.0;",
        # like the stock cfg (state.ww_z = 0.01): the reference divides by
        # |omega| in dqomegadt_by_domega, so a run must never start at
        # exactly zero angular velocity
        "state.ww_z = 0.01;",
    ]
    # initial Pxx: same structure as the stock file (small position/velocity
    # uncertainty, zero quaternion uncertainty), scaled so the projected
    # pixel-space uncertainty matches the stock 195-px-focal calibration —
    # a sharper camera warrants a proportionally tighter metric prior
    # (otherwise initial 3-sigma search ellipses double at 640x480 and early
    # mismatches kill the known features)
    scale = min((195.0 / p.cam_fku) ** 2, 1.0)
    pxx = np.zeros((13, 13))
    for i in (0, 1, 2):
        pxx[i, i] = 0.0004 * scale
    for i in (7, 8, 9):
        pxx[i, i] = 0.0004 * scale
    for i in (10, 11, 12):
        pxx[i, i] = 0.0004 * scale
    for i in range(13):
        for j in range(13):
            lines.append(f"state.pxx{i}_{j} = {pxx[i, j]};")
    for k in range(4):
        y = KNOWN_POINTS[k]
        lines += [
            f"f{k+1}.yi_x = {y[0]};",
            f"f{k+1}.yi_y = {y[1]};",
            f"f{k+1}.yi_z = {y[2]};",
            f"f{k+1}.xp_org_0 = {r0[0]};",
            f"f{k+1}.xp_org_1 = {r0[1]};",
            f"f{k+1}.xp_org_2 = {r0[2]};",
            f"f{k+1}.xp_org_3 = {q0[0]};",
            f"f{k+1}.xp_org_4 = {q0[1]};",
            f"f{k+1}.xp_org_5 = {q0[2]};",
            f"f{k+1}.xp_org_6 = {q0[3]};",
            f"f{k+1}.identifier = {patch_paths[k]};",
        ]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def stamp_patch_on_plane(params: Params, tex: np.ndarray, tex_scale: float,
                         patch: np.ndarray, y: np.ndarray,
                         r0: np.ndarray, q0: np.ndarray) -> None:
    """Composite `patch` onto the world plane (in-place on `tex`) so that
    rendering from pose (r0, q0) reproduces it centred at the projection of
    world point y.

    Inverts the renderer's exact pixel->texel mapping at the capture pose,
    so the patch lands with correct perspective in EVERY frame — the
    synthetic analog of the printed target the stock known_patch PGMs were
    photographed from (the reference loads those patches by path at Init:
    feature.cpp:108-149, SceneLib2.cfg:267-313)."""
    h = project_point(params, y, r0, q0)
    uu, vv = int(round(h[0])), int(round(h[1]))
    b = patch.shape[0]
    half = (b - 1) // 2
    tx, ty, hit = texture_coords(params, tex.shape, r0, q0, tex_scale)
    # a negative slice start would silently wrap via Python indexing and
    # stamp a misplaced patch — require the full patch inside the frame
    assert half <= uu < params.cam_width - half, (uu, params.cam_width)
    assert half <= vv < params.cam_height - half, (vv, params.cam_height)
    sl = np.s_[vv - half : vv + half + 1, uu - half : uu + half + 1]
    assert hit[sl].all(), "patch region must see the plane at the capture pose"
    # at ~1 texel/pixel the rounded inverse mapping is collision-free inside
    # the patch, and bilinear resampling at render time costs <1 grey level
    ix = np.round(tx[sl]).astype(int)
    iy = np.round(ty[sl]).astype(int)
    tex[iy, ix] = np.asarray(patch, np.float64)


def generate_stock_dataset(out_dir: str, n_frames: int = 120, seed: int = 7):
    """Stock-data bootstrap scene: the four STOCK data/known_patch{0..3}.pgm
    patches composited onto the world plane at the stock cfg's target-corner
    points, rendered with the stock calibration along the standard
    trajectory from the stock initial pose (0, 0, -0.60, identity).

    Returns (frames, gt_r, gt_q, cfg_path) where cfg_path IS the literal
    repo data/SceneLib2.cfg — nothing rewritten. Our loader resolves the
    patch identifiers against the cfg's own directory; the C++ reference
    resolves the stock `../../data/known_patch*.pgm` strings against the
    process CWD, so run it from a directory two levels below the repo root
    (e.g. native/refbuild). This closes the north-star clause on stock data:
    cold start is AddNewKnownFeature x4 from the stock PGMs against footage
    containing that printed target (monoslam.cpp:1940-1957)."""
    from scenelib2_torch.io.pgm import read_pgm

    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    stock_cfg = os.path.join(here, "data", "SceneLib2.cfg")
    cfg = load_config(stock_cfg)
    params = cfg.params

    rng = np.random.default_rng(seed)
    tex = make_texture(rng)
    tex_scale = 0.6 / params.cam_fku
    rs, qs = default_trajectory(n_frames, params.delta_t)
    for kf in cfg.known_features:
        stamp_patch_on_plane(params, tex, tex_scale, read_pgm(kf.patch_path),
                             np.asarray(kf.y), rs[0], qs[0])
    frames = np.stack([
        render_frame(params, tex, rs[i], qs[i], tex_scale) for i in range(n_frames)
    ])
    os.makedirs(os.path.join(out_dir, "seq"), exist_ok=True)
    for i, f in enumerate(frames):
        write_pgm(os.path.join(out_dir, "seq", f"rawoutput{i:04d}.pgm"), f)
    np.savez(os.path.join(out_dir, "ground_truth.npz"), r=rs, q=qs)
    return frames, rs, qs, stock_cfg
