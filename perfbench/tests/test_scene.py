"""The camera paths of perfbench/scene.py and the traffic's `path` key.

The orbit renders what it rendered before paths had names (digests of its
frames, patches and first filter, taken from the stream of the commit that
named them, on the CPU); a traffic without the key follows it; the room walk
keeps its geometry at every frame; and a short run on the room walk is
correct."""

import hashlib
import json
import os
import time

import numpy as np
import pytest
import torch

from perfbench import harness, scene, systems
from perfbench.tests.cells import ALL as BENCH

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2 ** 31 + 77
with open(os.path.join(HERE, "configs", "std.json")) as f:
    STD = json.load(f)


def _traffic(name: str) -> dict:
    with open(os.path.join(HERE, "traffic", f"{name}.json")) as f:
        return json.load(f)


ROOM = _traffic("room900-replay")


def digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def test_orbit_stream_renders_as_before():
    s = STD["settings"]
    torch.set_num_threads(2)
    frames, rs, qs, patches, points = scene.stream(SEED, s, 23, s["boxsize"], "cpu")
    assert tuple(frames.shape) == (24, 240, 320)
    assert points is scene.KNOWN_POINTS
    assert digest(frames) == "53b76bc73bbc5d6bd8cf94006ae9b889afe7c967fb5cd34f6e89821893f03f34"
    assert digest(rs, qs) == "93849a6f9e7afa5cd63473d4a9de00a63265b622268722925453cfb1f983e8fd"
    assert digest(*patches) == "30af69698534cbdeac1ea555e0d9882db0822faf72dd4aa06a35d517a6dd4db0"
    assert digest(*scene.initial_filter(rs[0], qs[0], s)) == \
        "5300750c733b654a4a3e89d58b0bacc3ab2757a393899a95d06fc9eb63d43985"
    named = scene.stream(SEED, s, 23, s["boxsize"], "cpu", path="orbit")
    assert torch.equal(named[0], frames)


def test_orbit_lanes_render_as_before():
    s = STD["settings"]
    torch.set_num_threads(2)
    frames, r0, q0, patches = scene.lane_streams(SEED, s, 6, 2, 2, s["boxsize"], "cpu")
    assert tuple(frames.shape) == (6, 4, 240, 320)
    assert digest(frames) == "3a3eafbff1c2aa6fb25f1e9cd9ffbb66de04ae7e6426db543a49782070ccd14b"
    assert digest(*[p for lane in patches for p in lane]) == \
        "51e9fe2ef6cf3af69c16ff938629e82f23d02547b0a07a0ac035a425cfb5f216"
    assert digest(*scene.initial_filter(r0, q0, s)) == \
        "5300750c733b654a4a3e89d58b0bacc3ab2757a393899a95d06fc9eb63d43985"


class _Rendered(Exception):
    """Raised in place of rendering: the system asked for a stream."""


@pytest.mark.parametrize("traffic", ["seq239-replay", "seq239-live"])
def test_traffic_without_a_path_follows_the_orbit(traffic, monkeypatch, tmp_path):
    t = _traffic(traffic)
    assert "path" not in t
    asked = []

    def stream(*args, **kw):
        asked.append(kw.get("path", "orbit"))
        raise _Rendered

    monkeypatch.setattr(scene, "stream", stream)
    with pytest.raises(_Rendered):
        systems.SYSTEMS[t["entry"]](STD, t, SEED, "cpu", str(tmp_path))
    assert asked == ["orbit"]


def test_unknown_path_is_refused_before_rendering(monkeypatch, tmp_path):
    monkeypatch.setattr(scene, "render", lambda *a, **k: pytest.fail("rendered an unknown path"))
    with pytest.raises(ValueError, match="unknown camera path 'nowhere'"):
        systems.SingleStream(STD, dict(ROOM, path="nowhere"), SEED, "cpu", str(tmp_path))


def test_batch_refuses_the_room(tmp_path):
    with pytest.raises(ValueError, match="follow the orbit only"):
        systems.Batch(STD, dict(_traffic("lanes64-replay"), path="room"), SEED, "cpu", str(tmp_path))


def _footprint(cam: dict, rs: np.ndarray, qs: np.ndarray, side: int) -> np.ndarray:
    """Texel coordinates [T, border pixels, 2] where render samples the
    plane for every pixel of the image's border."""
    W, H = cam["cam_width"], cam["cam_height"]
    u = np.concatenate([np.arange(W), np.arange(W), np.zeros(H), np.full(H, W - 1)])
    v = np.concatenate([np.zeros(W), np.full(W, H - 1), np.arange(H), np.arange(H)])
    cu, cv = u - cam["cam_u0"], v - cam["cam_v0"]
    factor = np.sqrt(1.0 - 2.0 * cam["cam_kd1"] * (cu * cu + cv * cv))
    d_cam = np.stack([cu / factor / -cam["cam_fku"], cv / factor / -cam["cam_fkv"], np.ones_like(cu)], -1)
    scale = 0.6 / cam["cam_fku"]
    out = []
    for r, q in zip(rs, qs):
        d = d_cam @ scene._quat_to_R(q).T
        tz = -r[2] / d[:, 2]
        assert (tz > 0).all()
        out.append(np.stack([(r[0] + tz * d[:, 0]) / scale + side / 2.0,
                             (r[1] + tz * d[:, 1]) / scale + side / 2.0], -1))
    return np.stack(out)


def test_room_walk_geometry():
    """At every frame of the room traffic: the speed well above the 0.2 m/s
    mapping gate and under a hand's, a bounded acceleration, the height of
    the orbit, the whole view on the texture; frame 0 at the orbit's first
    pose."""
    cam = STD["settings"]
    dt = cam["delta_t"]
    rs, qs = scene.room(ROOM["frames"] + 1, dt)
    speed = np.linalg.norm(np.diff(rs, axis=0), axis=1) / dt
    assert speed.min() >= 0.25 and speed.max() <= 0.6
    accel = np.linalg.norm(np.diff(rs, 2, axis=0), axis=1) / (dt * dt)
    assert accel.max() <= 2.5
    assert (-rs[:, 2] >= 0.54 - 1e-12).all() and (-rs[:, 2] <= 0.6 + 1e-12).all()
    assert np.allclose(np.linalg.norm(qs, axis=1), 1.0)
    tex = _footprint(cam, rs, qs, scene.TEXTURE_SIDE)
    assert tex.min() >= 64 and tex.max() <= scene.TEXTURE_SIDE - 64
    r0, q0 = scene.trajectory(1, dt)
    assert (rs[0] == r0[0]).all() and (qs[0] == q0[0]).all()
    # onto fresh ground: at its farthest it is 1.4 m and more from the start, past the first view
    assert np.hypot(*(rs[:, :2] - rs[0, :2]).T).max() > 1.4


def test_room_known_points_under_the_patch_centres():
    """The room's known features lie where their patches are centred: each
    projects from the first pose onto the pixel its patch was cropped
    around, within 1e-9 px, and within 2 mm of the target's corner."""
    cam = STD["settings"]
    frames, rs, qs, patches, points = scene.stream(SEED, cam, 1, cam["boxsize"], "cpu", path="room")
    half = (cam["boxsize"] - 1) // 2
    frame0 = frames[0].numpy()
    for y, corner, patch in zip(points, scene.KNOWN_POINTS, patches):
        h = scene.project(cam, y, rs[0], qs[0])
        u, v = round(h[0]), round(h[1])
        assert abs(h[0] - u) < 1e-9 and abs(h[1] - v) < 1e-9
        assert (patch == frame0[v - half : v + half + 1, u - half : u + half + 1]).all()
        assert y[2] == 0.0 and np.abs(y - corner).max() < 2e-3


def test_room_texture_from_the_seed():
    a = scene.room_texture(SEED, "cpu")
    assert tuple(a.shape) == (scene.TEXTURE_SIDE,) * 2 and a.dtype == torch.float64
    assert float(a.min()) == 0.0 and float(a.max()) == pytest.approx(255.0)
    assert torch.equal(a, scene.room_texture(SEED, "cpu"))
    assert not torch.equal(a, scene.room_texture(SEED + 1, "cpu"))


def test_room_run_is_correct():
    """The std replay cell on the room traffic, cut to 10 frames as
    test_cells.tiny cuts a cell: the whole run but the look for a card."""
    cell = harness.Cell("std-replay", BENCH)
    cell.traffic = dict(ROOM, frames=10)
    torch.set_num_threads(2)
    res, lines = harness.run(cell, SEED, 0.2, False, "cpu", time.perf_counter(), ref_workers=1, settle_s=0.0)
    assert res["correct"], lines
    assert res["attempted"] > 0 and res["failed"] == 0
