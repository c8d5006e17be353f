"""Minimal PGM (P5/P2) reader/writer.

The reference stores feature patches as 11x11 8-bit P5 PGM files
(data/known_patch{0..3}.pgm, loaded with cv::imread at feature.cpp:121) and
the TestSeqMonoSLAM evaluation sequence is a directory of grayscale images.
This loader needs no OpenCV. A copy of scenelib2_tpu/io/pgm.py.
"""

from __future__ import annotations

import numpy as np


def _read_tokens(data: bytes, n: int, pos: int):
    """Read n whitespace-separated header tokens, skipping # comments."""
    tokens = []
    while len(tokens) < n:
        while pos < len(data) and data[pos : pos + 1].isspace():
            pos += 1
        if data[pos : pos + 1] == b"#":
            while pos < len(data) and data[pos : pos + 1] != b"\n":
                pos += 1
            continue
        start = pos
        while pos < len(data) and not data[pos : pos + 1].isspace():
            pos += 1
        tokens.append(data[start:pos])
    return tokens, pos


def read_pgm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    magic = data[:2]
    if magic not in (b"P5", b"P2"):
        raise ValueError(f"{path}: not a PGM file (magic {magic!r})")
    tokens, pos = _read_tokens(data, 3, 2)
    width, height, maxval = (int(t) for t in tokens)
    if maxval > 255:
        raise ValueError(f"{path}: 16-bit PGM not supported")
    if magic == b"P5":
        pos += 1  # single whitespace after maxval
        img = np.frombuffer(data, np.uint8, count=width * height, offset=pos)
    else:
        img = np.array(data[pos:].split()[: width * height], np.uint8)
    return img.reshape(height, width)


def write_pgm(path: str, img: np.ndarray) -> None:
    img = np.asarray(img, np.uint8)
    h, w = img.shape
    with open(path, "wb") as f:
        f.write(f"P5\n{w} {h}\n255\n".encode())
        f.write(img.tobytes())
