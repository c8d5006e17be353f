"""Camera streams for the benchmark, rendered from a seed in PyTorch.

A frozen copy of the port's synthetic generator (scenelib2_torch/eval/
synthetic.py: a textured plane at z = 0 seen through the calibrated camera
model along a fixed handheld trajectory), rewritten in tensor operations so
that it renders on the card in a few large calls. The seed picks the
texture only: every seed gives the same trajectory, frame count and image
size, so two seeds ask the same work of the system in another scene. The
frames are made once and the same bytes go to the system under test and to
the reference.

A stream follows one of the named camera paths of PATHS, each with the
texture it is rendered on:

- "orbit": the generator's trajectory over its smoothed noise: the map
  stays at the few features around the printed target;
- "room": a walk round the floor from the orbit's first pose, over coarser
  noise, on which the map grows past 61 features while tracking holds
  (PERF.md, section 4).

The lane layout of a batch (textures x phase offsets, each lane its own
random stream srand48(lane)) copies scenelib2_torch/eval/batch.py::make_lanes.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# the corners of the printed target (data/SceneLib2.cfg f1-f4)
KNOWN_POINTS = np.array([[0.105, 0.07425, 0.0], [-0.105, 0.07425, 0.0],
                         [0.105, -0.07425, 0.0], [-0.105, -0.07425, 0.0]])
TEXTURE_SIDE = 2048


def _quat_to_R(q):
    w, x, y, z = q
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                     [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                     [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def _quat_mul(a, b):
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2, w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                     w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2, w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2])


def _quat_axis_angle(axis, angle):
    axis = np.asarray(axis, float)
    return np.concatenate([[math.cos(angle / 2)], math.sin(angle / 2) * axis / np.linalg.norm(axis)])


def trajectory(n_frames: int, delta_t: float):
    """The generator's handheld trajectory from (0, 0, -0.6): an orbit at
    0.216-0.235 m/s (above the 0.2 m/s mapping gate) with half a look-at
    toward the origin. Returns (r [T, 3], q [T, 4])."""
    t = np.arange(n_frames) * delta_t
    om = 1.8
    rs = np.stack([0.13 * np.sin(om * t), 0.12 * (1.0 - np.cos(om * t)),
                   -0.60 + 0.03 * (1 - np.cos(0.8 * t))], axis=1)
    qs = np.zeros((n_frames, 4))
    for i in range(n_frames):
        yaw = 0.5 * math.atan2(rs[i, 0], -rs[i, 2])
        pitch = 0.5 * math.atan2(rs[i, 1], -rs[i, 2])
        q = _quat_mul(_quat_axis_angle([0, 1, 0], -yaw), _quat_axis_angle([1, 0, 0], pitch))
        qs[i] = q / np.linalg.norm(q)
    return rs, qs


def texture(seed: int, device, side: int = TEXTURE_SIDE) -> torch.Tensor:
    """A smooth high-contrast random texture [side, side] f64 in [0, 255],
    drawn from a generator on `device` seeded with `seed`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    tex = torch.rand((side, side), generator=gen, dtype=torch.float64, device=device) * 255.0
    for _ in range(2):
        tex = (tex + tex.roll(1, 0) + tex.roll(-1, 0) + tex.roll(1, 1) + tex.roll(-1, 1)) / 5.0
    tex = tex - tex.min()
    return tex * (255.0 / torch.clamp(tex.max(), min=1e-9))


# The room walk: the centre of a hand-held shake goes round a circle of ROOM_RADIUS through the
# origin at ROOM_SPEED, onto fresh ground, while the camera circles that centre at SHAKE_RADIUS
# and SHAKE_RATE (0.40 m/s, so the speed stays 0.28-0.52 m/s, well above the 0.2 m/s mapping
# gate) and bobs as the orbit does. The camera looks straight down: with the orbit's half
# look-at the reference lost track on 3 of 12 seeds (PERF.md, section 6).
ROOM_RADIUS, ROOM_SPEED = 0.75, 0.12        # m, m/s
SHAKE_RADIUS, SHAKE_RATE = 0.08, 5.0        # m, rad/s
ROOM_CELL = 5                               # texels a noise cell of the room's texture


def room(n_frames: int, delta_t: float):
    """The room walk from the orbit's first pose, (0, 0, -0.6) looking
    down the z axis. Returns (r [T, 3], q [T, 4])."""
    t = np.arange(n_frames) * delta_t
    ang = ROOM_SPEED * t / ROOM_RADIUS
    w = SHAKE_RATE * t
    rs = np.stack([ROOM_RADIUS * np.sin(ang) + SHAKE_RADIUS * np.sin(w),
                   ROOM_RADIUS * (1.0 - np.cos(ang)) + SHAKE_RADIUS * (1.0 - np.cos(w)),
                   -0.60 + 0.03 * (1 - np.cos(0.8 * t))], axis=1)
    qs = np.zeros((n_frames, 4))
    qs[:, 0] = 1.0
    return rs, qs


def room_texture(seed: int, device, side: int = TEXTURE_SIDE) -> torch.Tensor:
    """Uniform noise on a grid of ROOM_CELL-texel cells, interpolated
    bilinearly to [side, side] f64 in [0, 255], drawn from a generator on
    `device` seeded with `seed`. Its corners survive the lens's changes of
    scale across the image, where the orbit's one-texel noise does not."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    cells = torch.rand((1, 1, side // ROOM_CELL, side // ROOM_CELL), generator=gen, dtype=torch.float64,
                       device=device)
    tex = torch.nn.functional.interpolate(cells, size=(side, side), mode="bilinear", align_corners=False)[0, 0]
    tex = tex - tex.min()
    return tex * (255.0 / torch.clamp(tex.max(), min=1e-9))


def render(cam: dict, tex: torch.Tensor, rs: np.ndarray, qs: np.ndarray, background: float = 128.0,
           block: int = 32) -> torch.Tensor:
    """Frames [T, H, W] u8 on the texture's device: each pixel unprojected
    through the camera (negated focal lengths, radial distortion kd1),
    intersected with the plane z = 0 and sampled bilinearly from the
    texture at ~1 texel a pixel at the start pose. `block` frames a call."""
    dev = tex.device
    f64 = torch.float64
    W, H = cam["cam_width"], cam["cam_height"]
    scale = 0.6 / cam["cam_fku"]
    v, u = torch.meshgrid(torch.arange(H, dtype=f64, device=dev), torch.arange(W, dtype=f64, device=dev),
                          indexing="ij")
    cu, cv = u - cam["cam_u0"], v - cam["cam_v0"]
    arg = 1.0 - 2.0 * cam["cam_kd1"] * (cu * cu + cv * cv)
    dist_ok = arg > 0
    factor = torch.sqrt(torch.where(dist_ok, arg, torch.ones_like(arg)))
    d_cam = torch.stack([torch.where(dist_ok, cu / factor, 0.0) / -cam["cam_fku"],
                         torch.where(dist_ok, cv / factor, 0.0) / -cam["cam_fkv"],
                         torch.ones_like(cu)], -1)                       # [H, W, 3]
    th, tw = tex.shape
    out = []
    for s in range(0, len(rs), block):
        Rs = torch.as_tensor(np.stack([_quat_to_R(q) for q in qs[s : s + block]]), dtype=f64, device=dev)
        r = torch.as_tensor(rs[s : s + block], dtype=f64, device=dev)[:, None, None, :]
        d = torch.einsum("hwj,bij->bhwi", d_cam, Rs)
        dz = d[..., 2]
        ray_ok = dist_ok & (dz != 0)
        tz = torch.where(ray_ok, -r[..., 2] / torch.where(dz != 0, dz, torch.ones_like(dz)), -1.0)
        hit = ray_ok & (tz > 0)
        tx = torch.where(hit, (r[..., 0] + tz * d[..., 0]) / scale + tw / 2.0, 0.0)
        ty = torch.where(hit, (r[..., 1] + tz * d[..., 1]) / scale + th / 2.0, 0.0)
        x0, y0 = torch.floor(tx), torch.floor(ty)
        inb = hit & (x0 >= 0) & (x0 < tw - 1) & (y0 >= 0) & (y0 < th - 1)
        xi = x0.clamp(0, tw - 2).long()
        yi = y0.clamp(0, th - 2).long()
        fx, fy = tx - x0, ty - y0
        t00, t01 = tex[yi, xi], tex[yi, xi + 1]
        t10, t11 = tex[yi + 1, xi], tex[yi + 1, xi + 1]
        val = (1 - fy) * ((1 - fx) * t00 + fx * t01) + fy * ((1 - fx) * t10 + fx * t11)
        img = torch.where(inb, val, background)
        out.append(torch.clamp(torch.round(img), 0, 255).to(torch.uint8))
    return torch.cat(out)


def project(cam: dict, y: np.ndarray, r: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Image position of world point y from pose (r, q)."""
    camp = _quat_to_R(q).T @ (y - r)
    uc = np.array([-cam["cam_fku"] * camp[0] / camp[2], -cam["cam_fkv"] * camp[1] / camp[2]])
    return uc / math.sqrt(1 + 2 * cam["cam_kd1"] * (uc @ uc)) + np.array([cam["cam_u0"], cam["cam_v0"]])


def known_patches(cam: dict, frame0: np.ndarray, r0: np.ndarray, q0: np.ndarray, boxsize: int) -> list:
    """The four known patches [B, B] u8, cropped from frame 0 at the
    rounded projections of the target's corners."""
    half = (boxsize - 1) // 2
    out = []
    for y in KNOWN_POINTS:
        h = project(cam, y, r0, q0)
        uu, vv = int(round(h[0])), int(round(h[1]))
        out.append(np.ascontiguousarray(frame0[vv - half : vv + half + 1, uu - half : uu + half + 1]))
    return out


def target_corners(cam: dict, r0: np.ndarray, q0: np.ndarray) -> np.ndarray:
    """The printed target's corners, KNOWN_POINTS [4, 3], as the generator
    places them."""
    return KNOWN_POINTS


def patch_centres(cam: dict, r0: np.ndarray, q0: np.ndarray) -> np.ndarray:
    """The points of the plane z = 0 [4, 3] under the centres of the known
    patches: the rounded projections of the target's corners from (r0, q0),
    unprojected as render unprojects a pixel. A corner lies up to half a
    pixel from its patch's centre (0.40 and 0.24 px at the first pose); a
    known feature placed at its patch's centre makes no such error."""
    out = []
    R = _quat_to_R(q0)
    for y in KNOWN_POINTS:
        h = project(cam, y, r0, q0)
        cu, cv = round(h[0]) - cam["cam_u0"], round(h[1]) - cam["cam_v0"]
        factor = math.sqrt(1.0 - 2.0 * cam["cam_kd1"] * (cu * cu + cv * cv))
        d = R @ np.array([cu / factor / -cam["cam_fku"], cv / factor / -cam["cam_fkv"], 1.0])
        p = r0 - (r0[2] / d[2]) * d
        out.append([p[0], p[1], 0.0])
    return np.array(out)


# name -> (trajectory (n_frames, delta_t) -> (r, q), texture (seed, device) -> [side, side],
#          the known features' points (cam, r0, q0) -> [4, 3])
PATHS = {"orbit": (trajectory, texture, target_corners), "room": (room, room_texture, patch_centres)}


def initial_filter(r0: np.ndarray, q0: np.ndarray, cam: dict):
    """(xv0 [13], pxx0 [13, 13]) of the generator's cfg: the first pose,
    zero velocity, the stock cfg's omega_z = 0.01 (the reference divides by
    |omega|), and a prior of 0.0004 on position and velocities, scaled to
    the calibration's focal length."""
    xv0 = np.zeros(13)
    xv0[:3], xv0[3:7], xv0[12] = r0, q0, 0.01
    scale = min((195.0 / cam["cam_fku"]) ** 2, 1.0)
    pxx0 = np.zeros((13, 13))
    for i in (0, 1, 2, 7, 8, 9, 10, 11, 12):
        pxx0[i, i] = 0.0004 * scale
    return xv0, pxx0


def stream(seed: int, cam: dict, n_frames: int, boxsize: int, device, path: str = "orbit"):
    """One sequence along the named path: (frames [n_frames + 1, H, W] u8
    on `device`, r [T, 3], q [T, 4], known patches, their points [4, 3]).
    Frame 0 gives the patches; frames 1.. are replayed."""
    if path not in PATHS:
        raise ValueError(f"unknown camera path {path!r}: the paths are {', '.join(sorted(PATHS))}")
    traj, tex, points = PATHS[path]
    rs, qs = traj(n_frames + 1, cam["delta_t"])
    frames = render(cam, tex(seed, device), rs, qs)
    return (frames, rs, qs, known_patches(cam, frames[0].cpu().numpy(), rs[0], qs[0], boxsize),
            points(cam, rs[0], qs[0]))


def lane_streams(seed: int, cam: dict, n_frames: int, n_textures: int, n_offsets: int, boxsize: int,
                 device):
    """A batch of n_textures x n_offsets lanes of n_frames frames each:
    lane i replays texture i % n_textures from frame 1 + i // n_textures,
    with that texture's patches (cropped from its frame 0) and its own
    random stream srand48(i). Texture t is drawn from seed * 4096 + t.
    Returns (frames [n_frames, B, H, W] u8 on `device`, r0, q0, patches of
    each lane)."""
    rs, qs = trajectory(n_frames + n_offsets, cam["delta_t"])
    per_tex, patches = [], []
    for t in range(n_textures):
        fr = render(cam, texture(seed * 4096 + t, device), rs, qs)
        per_tex.append(fr)
        patches.append(known_patches(cam, fr[0].cpu().numpy(), rs[0], qs[0], boxsize))
    lanes = [per_tex[i % n_textures][1 + i // n_textures : 1 + i // n_textures + n_frames]
             for i in range(n_textures * n_offsets)]
    return torch.stack(lanes, dim=1), rs[0], qs[0], [patches[i % n_textures] for i in range(len(lanes))]
