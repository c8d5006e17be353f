"""Live USB camera input (the reference UsbCamGrabber's analog).

The reference wraps pangolin::VideoInput on a producer thread, converts
YUV/RGB frames to grayscale, resizes to the configured camera geometry, and
fills the same bounded frame queue the file grabber uses
(framegrabber/usbcamgrabber.cpp:61-113, framegrabber.cpp:95-104). This module
does the same with cv2.VideoCapture: a daemon producer thread, grayscale
conversion, resize to (width, height) from the SLAM config, and a bounded
queue (default cap 50, like the reference's kMaxFrameBufferSize).

cv2 is an optional dependency: importing this module without it raises only
when a grabber is actually constructed, and a `capture` object can be
injected for tests or alternative backends (anything with read() ->
(ok, frame) and release()). A port of
scenelib2_tpu/io/camera.py.
"""

from __future__ import annotations

import queue as _queue
import threading
from typing import Iterator, Optional

import numpy as np


class CameraGrabber:
    """Bounded-queue live frame source.

    Usage:
        grab = CameraGrabber(width=320, height=240, device=0)
        for frame in grab:        # [H,W] uint8, resized + grayscale
            slam.go_one_step(frame)
    """

    def __init__(
        self,
        width: int,
        height: int,
        device: int = 0,
        prefetch: int = 50,
        capture=None,
    ):
        self.width = int(width)
        self.height = int(height)
        self.prefetch = int(prefetch)
        if capture is None:
            try:
                import cv2
            except ImportError as e:  # pragma: no cover
                raise RuntimeError(
                    "cv2 is required for live camera input; pass a custom "
                    "`capture` object or install opencv-python"
                ) from e
            capture = cv2.VideoCapture(device)
            if not capture.isOpened():
                raise RuntimeError(f"cannot open camera device {device}")
        self._cap = capture
        self._queue: _queue.Queue = _queue.Queue(maxsize=self.prefetch)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- internals

    def _to_gray(self, frame: np.ndarray) -> np.ndarray:
        """Grayscale + resize, mirroring usbcamgrabber.cpp:82-108."""
        frame = np.asarray(frame)
        if frame.ndim == 3:
            # reference converts RGB/YUV to gray via cv; BGR is cv2's order
            b = frame.astype(np.float32)
            gray = 0.114 * b[..., 0] + 0.587 * b[..., 1] + 0.299 * b[..., 2]
            frame = np.clip(np.round(gray), 0, 255).astype(np.uint8)
        frame = frame.astype(np.uint8)
        if frame.shape != (self.height, self.width):
            try:
                import cv2

                frame = cv2.resize(
                    frame, (self.width, self.height), interpolation=cv2.INTER_AREA
                )
            except ImportError:  # nearest-neighbour fallback
                vi = np.linspace(0, frame.shape[0] - 1, self.height).round().astype(int)
                ui = np.linspace(0, frame.shape[1] - 1, self.width).round().astype(int)
                frame = frame[vi][:, ui]
        return frame

    def _producer(self) -> None:
        while not self._stop.is_set():
            ok, frame = self._cap.read()
            if not ok:
                break
            # drop-oldest when full: live input must not stall the producer
            item = self._to_gray(frame)
            try:
                self._queue.put(item, timeout=0.5)
            except _queue.Full:
                try:
                    self._queue.get_nowait()
                except _queue.Empty:
                    pass
                try:
                    self._queue.put_nowait(item)
                except _queue.Full:
                    pass
        self._queue.put(None)

    # ------------------------------------------------------------------- API

    def start(self) -> "CameraGrabber":
        if self._thread is None:
            self._thread = threading.Thread(target=self._producer, daemon=True)
            self._thread.start()
        return self

    def get_frame(self, timeout: float | None = None) -> Optional[np.ndarray]:
        """Next frame or None at end-of-stream (FrameGrabber::GetFrame)."""
        if self._thread is None:
            self.start()
        return self._queue.get(timeout=timeout)

    def is_frame_buffer_full(self) -> bool:
        """FrameGrabber::IsFrameBufferFull analog."""
        return self._queue.full()

    def __iter__(self) -> Iterator[np.ndarray]:
        self.start()
        while True:
            frame = self._queue.get()
            if frame is None:
                return
            yield frame

    def close(self) -> None:
        self._stop.set()
        try:
            self._cap.release()
        except Exception:
            pass
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
