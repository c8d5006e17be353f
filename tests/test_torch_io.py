"""The port's I/O and evaluation helpers against the JAX package's.

  - ImageSequence: on the same temporary directories (nested, mixed PGM,
    PPM, .npy and PNG files; an all-PGM directory) the port and the JAX
    package list the same files in the same order and yield the same bytes,
    with the native grabber and without it; load_all stacks them;
  - NativeGrabber: random access, iteration, a missing directory;
  - CameraGrabber with an injected capture: colour, grey and resized frames
    and the end of the stream, frame for frame against the JAX grabber;
  - trajectory_rmse and ate_stats against the JAX package's on seeded
    arrays (equal to the last bit: the same numpy arithmetic).

The JAX modules here are numpy only, so they run in this process.
"""

from __future__ import annotations

import os

import numpy as np
import pytest

from scenelib2_torch.eval import metrics as tmetrics
from scenelib2_torch.io import camera as tcamera
from scenelib2_torch.io import native as tnative
from scenelib2_torch.io import sequence as tsequence
from scenelib2_torch.io.pgm import write_pgm
from scenelib2_tpu.eval import metrics as jmetrics
from scenelib2_tpu.io import camera as jcamera
from scenelib2_tpu.io import sequence as jsequence


def _write_ppm(path, img):
    h, w = img.shape
    with open(path, "wb") as f:
        f.write(f"P5\n{w} {h}\n255\n".encode())
        f.write(img.tobytes())


@pytest.fixture
def mixed_dir(tmp_path, rng):
    """Nested directories, files of four kinds, names whose path order is not
    their creation order."""
    from PIL import Image

    os.makedirs(tmp_path / "b" / "inner")
    os.makedirs(tmp_path / "a")
    frames = {}
    for i, rel in enumerate(["b/inner/003.pgm", "a/010.pgm", "b/001.ppm", "a/002.npy", "c.png", "b/000.pgm"]):
        img = rng.integers(0, 256, (24, 32), dtype=np.uint8)
        path = str(tmp_path / rel)
        if rel.endswith(".pgm"):
            write_pgm(path, img)
        elif rel.endswith(".ppm"):
            _write_ppm(path, img)
        elif rel.endswith(".npy"):
            np.save(path, img)
        else:
            Image.fromarray(img).save(path)
        frames[path] = img
    return str(tmp_path), frames


@pytest.fixture
def pgm_dir(tmp_path, rng):
    for i in (5, 1, 12, 3):
        write_pgm(str(tmp_path / f"frame_{i:03d}.pgm"), rng.integers(0, 256, (30, 40), dtype=np.uint8))
    os.makedirs(tmp_path / "sub")
    write_pgm(str(tmp_path / "sub" / "frame_000.pgm"), rng.integers(0, 256, (30, 40), dtype=np.uint8))
    return str(tmp_path)


def _frames(seq):
    return [np.asarray(f) for f in seq]


def test_listing_order_matches_jax(mixed_dir):
    root, frames = mixed_dir
    got = tsequence._list_images(root)
    assert got == jsequence._list_images(root)
    assert got == sorted(frames)


def test_mixed_sequence_matches_jax(mixed_dir):
    root, frames = mixed_dir
    t, j = tsequence.ImageSequence(root), jsequence.ImageSequence(root)
    assert t._native is None and j._native is None      # not every file is a PGM
    got, want = _frames(t), _frames(j)
    assert len(got) == len(want) == len(frames)
    for g, w, path in zip(got, want, sorted(frames)):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, frames[path])
        assert g.dtype == np.uint8


@pytest.mark.parametrize("use_native", [True, False])
def test_pgm_sequence_matches_jax_with_and_without_native(pgm_dir, use_native):
    t = tsequence.ImageSequence(pgm_dir, prefetch=2, use_native=use_native)
    j = jsequence.ImageSequence(pgm_dir, prefetch=2, use_native=use_native)
    assert (t._native is not None) == use_native
    assert (j._native is not None) == use_native
    got, want = _frames(t), _frames(j)
    assert len(got) == len(t) == 5
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(t.load_all(), np.stack(want))


def test_native_library_is_the_repository_one():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert tnative._SO_PATH == os.path.join(here, "native", "libframegrabber.so")
    assert tnative.available()


def test_native_random_access_and_iteration(pgm_dir):
    g = tnative.NativeGrabber(pgm_dir, prefetch=3)
    try:
        assert len(g) == 5
        seq = list(g)
        files = tsequence._list_images(pgm_dir)
        for i in (3, 0, 4):
            np.testing.assert_array_equal(g.get(i), seq[i])
            np.testing.assert_array_equal(g.get(i), tsequence._read_image(files[i]))
        with pytest.raises(IndexError):
            g.get(99)
    finally:
        g.close()


def test_missing_directory_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        tnative.NativeGrabber(str(tmp_path / "nope"))
    with pytest.raises(FileNotFoundError):
        tsequence.ImageSequence(str(tmp_path / "nope"))


class FakeCapture:
    """Stands in for cv2.VideoCapture: its frames, then the end of the stream."""

    def __init__(self, frames):
        self.frames = list(frames)
        self.released = False

    def read(self):
        if self.frames:
            return True, self.frames.pop(0)
        return False, None

    def release(self):
        self.released = True


@pytest.mark.parametrize("kind", ["colour", "grey", "resize", "colour resize"])
def test_camera_grabber_matches_jax(rng, kind):
    shape = {"colour": (240, 320, 3), "grey": (240, 320), "resize": (480, 640),
             "colour resize": (300, 500, 3)}[kind]
    frames = [rng.integers(0, 256, size=shape, dtype=np.uint8) for _ in range(4)]
    t = tcamera.CameraGrabber(width=320, height=240, capture=FakeCapture([f.copy() for f in frames]))
    j = jcamera.CameraGrabber(width=320, height=240, capture=FakeCapture([f.copy() for f in frames]))
    got, want = list(t), list(j)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.shape == (240, 320) and g.dtype == np.uint8
        np.testing.assert_array_equal(g, w)
    t.close()
    j.close()
    assert t._cap.released


def test_camera_grabber_end_of_stream():
    t = tcamera.CameraGrabber(width=32, height=24, capture=FakeCapture([np.zeros((24, 32), np.uint8)]))
    f = t.get_frame(timeout=5.0)
    assert f is not None and f.shape == (24, 32)
    assert t.get_frame(timeout=5.0) is None
    assert not t.is_frame_buffer_full()
    t.close()


@pytest.mark.parametrize("n_est, n_gt", [(50, 50), (40, 55), (1, 3)])
def test_trajectory_metrics_match_jax(rng, n_est, n_gt):
    est = rng.normal(size=(n_est, 3))
    gt = est[:1].repeat(n_gt, 0) + rng.normal(scale=0.01, size=(n_gt, 3))
    assert tmetrics.trajectory_rmse(est, gt) == jmetrics.trajectory_rmse(est, gt)
    assert tmetrics.ate_stats(est, gt) == jmetrics.ate_stats(est, gt)
    assert tmetrics.ate_stats(est.astype(np.float32), gt)["n"] == min(n_est, n_gt)
