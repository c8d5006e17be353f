"""The premise of K9's design (csrc/score_map.cu): integer sums, taken in
the kernel's order, equal the plain twin's f32 sums bit for bit.

The kernel sums the window (and its squares) separably in int32, column
sums over B rows and then a sliding sum along u, and the cross sum with the
patch as __dp4a products of u8 quads, 4 taps at a time with the patch row
zero-padded to a multiple of 4; each sum is converted to f32 once. The twin
(kernels/score_map.py::window_sums_plain) takes them as shifted f32 adds.
Every sum is an integer below 2^24 (at most 121 x 255^2 = 7,868,025), so
the two agree exactly, and so do the maps that the score formula
(score_of_sums) makes of them. Cases: an all-255 frame with an all-255
patch (the largest sums), noise, a periodic image whose scores tie, a flat
patch on a near-flat image, and one 640x480 lane.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from scenelib2_torch.config import Params
from scenelib2_torch.kernels.score_map import (
    MISS, ScoreMapConsts, score_map, score_map_plain, score_of_sums, window_sums_plain,
)
from scenelib2_torch.runtime.state import patch_row

B = Params().boxsize


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _consts(H, W):
    p = Params()
    return ScoreMapConsts(H=H, W=W, boxsize=B, corr_sigma_thresh=p.corr_sigma_thresh,
                          low_sigma_penalty=p.low_sigma_penalty)


def int_sums(frames, patch_rows, b):
    """The kernel's sums in int32: (window sum, sum of squares [B, 1, H, W],
    cross sum [B, F, H, W]) of frames [B, H, W] u8 and patch rows whose first
    b * b entries are u8 pixels."""
    Bn, H, W = frames.shape
    half = (b - 1) // 2
    img = torch.nn.functional.pad(frames.to(torch.int32), (half, half, half, half))
    # separable box sums: columns over b rows, then a sliding sum along u
    def box(a):
        cols = a[:, 0:H].clone()
        for dy in range(1, b):
            cols += a[:, dy : dy + H]
        out = torch.empty((Bn, H, W), dtype=torch.int32)
        run = cols[:, :, 0:b].sum(-1)
        out[:, :, 0] = run
        for u in range(1, W):
            run = run + cols[:, :, u + b - 1] - cols[:, :, u - 1]
            out[:, :, u] = run
        return out[:, None]

    # cross sums: per patch row, ceil(b / 4) products of 4-byte quads (dp4a)
    nq = (b + 3) // 4
    pix = patch_rows[..., : b * b].to(torch.int32).reshape(*patch_rows.shape[:2], b, b)
    pix = torch.nn.functional.pad(pix, (0, 4 * nq - b))                    # zero taps past b
    imgq = torch.nn.functional.pad(img, (0, 4 * nq - b))
    cross = torch.zeros((Bn, patch_rows.shape[1], H, W), dtype=torch.int32)
    for dy in range(b):
        for t in range(nq):
            quad = torch.zeros_like(cross)
            for k in range(4):
                dx = 4 * t + k
                quad += pix[:, :, dy, dx, None, None] * imgq[:, None, dy : dy + H, dx : dx + W]
            cross += quad
    return box(img), box(img * img), cross


def _case(name, rng):
    H, W = (480, 640) if name == "640x480" else (48, 60)
    if name == "all255":
        frame = np.full((H, W), 255, np.uint8)
        patch = np.full((B, B), 255, np.uint8)
    elif name == "noise" or name == "640x480":
        frame = rng.integers(0, 256, (H, W), dtype=np.uint8)
        patch = frame[17 : 17 + B, 23 : 23 + B]
    elif name == "periodic":
        tile = rng.integers(0, 256, (B, B), dtype=np.uint8)
        frame = np.tile(tile, (H // B + 1, W // B + 1))[:H, :W]
        patch = tile
    else:  # flat patch on a near-flat image
        frame = rng.integers(100, 104, (H, W), dtype=np.uint8)
        patch = np.full((B, B), 90, np.uint8)
    frames = torch.tensor(frame)[None]
    rows = patch_row(torch.tensor(np.ascontiguousarray(patch)))[None, None]
    return frames, rows, _consts(H, W)


CASES = ("all255", "noise", "periodic", "flat_patch", "640x480")


@pytest.mark.parametrize("name", CASES)
def test_int_sums_equal_the_twins_f32_sums(name):
    frames, rows, c = _case(name, np.random.default_rng(CASES.index(name)))
    want = window_sums_plain(frames, rows, c)
    got = int_sums(frames, rows, B)
    assert max(int(g.max()) for g in got) < 2 ** 24
    for label, g, w in zip(("sum", "sum of squares", "cross"), got, want):
        assert torch.equal(g.to(torch.float32), w), f"{name}: {label}"
    if name == "all255":
        assert int(got[1].max()) == B * B * 255 ** 2 and int(got[2].max()) == B * B * 255 ** 2


@pytest.mark.parametrize("name", CASES)
def test_maps_from_int_sums_equal_the_plain_map(name):
    frames, rows, c = _case(name, np.random.default_rng(CASES.index(name)))
    want = score_map_plain(frames, rows, c)
    got = score_of_sums(*(s.to(torch.float32) for s in int_sums(frames, rows, B)), rows, c)
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
    half = (B - 1) // 2
    assert bool((want[..., :half, :] == MISS).all()) and bool((want[..., half:-half, half:-half] < MISS).all())
    if name == "periodic":
        # tied scores: every centre on the tile's period scores the same
        v = want[0, 0, half + B : -half : B, half + B : -half : B]
        assert v.numel() > 4 and bool((v == v.flatten()[0]).all())


def test_wrapper_takes_the_plain_path_on_the_cpu():
    frames, rows, c = _case("noise", np.random.default_rng(9))
    assert torch.equal(score_map(frames, rows, c), score_map_plain(frames, rows, c))
