"""Image-sequence input pipeline (the reference FrameGrabber's analog).

The reference runs a producer thread filling a bounded queue from a sorted
recursive directory listing (framegrabber/filegrabber.cpp:63-109). Here the
sequence is loaded and decoded on the host (by the native C++ grabber where
every file is a PGM, see scenelib2_torch.io.native) and handed to the step
either one frame at a time with prefetch (go_one_step) or as a whole
[T,H,W] uint8 stack for run_sequence's graph replay (the high-throughput
path). A port of scenelib2_tpu/io/sequence.py.
"""

from __future__ import annotations

import os
import threading
import queue as _queue
from typing import Iterator

import numpy as np

from scenelib2_torch.io.pgm import read_pgm


def _list_images(root: str) -> list[str]:
    """Recursive listing, sorted by full path (matches filegrabber.cpp:63-83)."""
    out: list[str] = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames.sort()
        for fn in filenames:
            out.append(os.path.join(dirpath, fn))
    out.sort()
    return out


def _read_image(path: str) -> np.ndarray:
    lower = path.lower()
    if lower.endswith((".pgm", ".ppm")):
        return read_pgm(path)
    if lower.endswith(".npy"):
        return np.load(path).astype(np.uint8)
    # Fall back to PIL if available (the reference accepts any cv::imread type)
    try:
        from PIL import Image

        return np.asarray(Image.open(path).convert("L"), np.uint8)
    except ImportError as e:  # pragma: no cover
        raise ValueError(f"unsupported image format: {path}") from e


class ImageSequence:
    """Ordered grayscale frame source with background prefetch.

    Mirrors FrameGrabber::GetFrame/IsFrameBufferFull semantics (bounded
    lookahead, producer thread) without the shared-state quirks. When the
    whole sequence is PGM and the native C++ grabber is built
    (native/framegrabber.cpp), decoding + prefetch run off the GIL there.
    """

    def __init__(self, path: str, prefetch: int = 50, use_native: bool = True):
        if os.path.isdir(path):
            self.files = _list_images(path)
        else:
            raise FileNotFoundError(f"provided directory doesn't exist: {path}")
        self.prefetch = prefetch
        self.path = path
        self._native = None
        if use_native and self.files and all(
            f.lower().endswith(".pgm") for f in self.files
        ):
            try:
                from scenelib2_torch.io import native as native_mod

                if native_mod.available():
                    self._native = native_mod
            except Exception:
                self._native = None

    def __len__(self) -> int:
        return len(self.files)

    def __iter__(self) -> Iterator[np.ndarray]:
        if self._native is not None:
            grabber = self._native.NativeGrabber(self.path, self.prefetch)
            try:
                yield from grabber
            finally:
                grabber.close()
            return

        q: _queue.Queue = _queue.Queue(maxsize=self.prefetch)
        stop = object()

        def producer():
            for f in self.files:
                q.put(_read_image(f))
            q.put(stop)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is stop:
                return
            yield item

    def load_all(self) -> np.ndarray:
        """Load the full sequence as one [T,H,W] uint8 array (offline path)."""
        return np.stack(list(self))
