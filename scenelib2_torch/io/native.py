"""ctypes bindings for the native C++ frame grabber (native/framegrabber.cpp).

Builds on demand via make; falls back cleanly when unavailable. The native
grabber handles the PGM decode + prefetch-thread pipeline off the Python GIL
(the reference's boost-thread FrameGrabber equivalent); Python only moves
ready frames to the device.

A port of scenelib2_tpu/io/native.py: the library is the repository's
native/libframegrabber.so, found from this file's own path.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "libframegrabber.so")
_lock = threading.Lock()
_lib = None
_build_failed = False


def _load() -> ctypes.CDLL | None:
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        if not os.path.exists(_SO_PATH):
            try:
                subprocess.run(
                    ["make", "-C", _NATIVE_DIR, "-s"], check=True, capture_output=True, timeout=120
                )
            except Exception:
                _build_failed = True
                return None
        try:
            lib = ctypes.CDLL(_SO_PATH)
        except OSError:
            _build_failed = True
            return None
        lib.fg_open.restype = ctypes.c_void_p
        lib.fg_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.fg_count.restype = ctypes.c_long
        lib.fg_count.argtypes = [ctypes.c_void_p]
        lib.fg_next.restype = ctypes.c_long
        lib.fg_next.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.fg_get.restype = ctypes.c_long
        lib.fg_get.argtypes = [
            ctypes.c_void_p,
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.fg_close.restype = None
        lib.fg_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


class NativeGrabber:
    """Streaming access to a directory of PGM frames via the C++ grabber."""

    MAX_BYTES = 4096 * 4096

    def __init__(self, path: str, prefetch: int = 50):
        lib = _load()
        if lib is None:
            raise RuntimeError("native framegrabber unavailable")
        self._lib = lib
        self._h = lib.fg_open(path.encode(), prefetch)
        if not self._h:
            raise FileNotFoundError(f"provided directory doesn't exist: {path}")
        self._buf = np.empty(self.MAX_BYTES, np.uint8)

    def __len__(self) -> int:
        return int(self._lib.fg_count(self._h))

    def __iter__(self):
        w = ctypes.c_int()
        h = ctypes.c_int()
        ptr = self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        while True:
            rid = self._lib.fg_next(self._h, ptr, self.MAX_BYTES, ctypes.byref(w), ctypes.byref(h))
            if rid == -1:
                return
            if rid == -2:
                raise ValueError("native grabber: undecodable frame in sequence")
            yield self._buf[: w.value * h.value].reshape(h.value, w.value).copy()

    def get(self, idx: int) -> np.ndarray:
        w = ctypes.c_int()
        h = ctypes.c_int()
        ptr = self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        rid = self._lib.fg_get(self._h, idx, ptr, self.MAX_BYTES, ctypes.byref(w), ctypes.byref(h))
        if rid < 0:
            raise IndexError(f"frame {idx} unavailable ({rid})")
        return self._buf[: w.value * h.value].reshape(h.value, w.value).copy()

    def close(self):
        if self._h:
            self._lib.fg_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
