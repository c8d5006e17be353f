"""Decisions fingerprint of a replay (a copy of scenelib2_tpu/eval/selftest.py:37-84).

The fingerprint covers every discrete per-frame decision of a replay: the
eight decision counters plus the per-frame selection as a canonical
(slot, matched) SET, hashed. Floats are excluded (they legitimately differ by
backend and summation order), and so is the lane ORDER of the selection
within a frame (the joint update is invariant to a permutation of its
measurement rows). The recipe is byte-for-byte the JAX package's, so a
fingerprint from either package can be compared with the other's.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

# per-frame discrete fields hashed into the fingerprint (all integer/bool)
DECISION_FIELDS = (
    "n_visible", "n_selected", "n_matched", "n_active", "n_partial",
    "did_init", "did_convert", "n_overflow",
)

DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")


def _np(a) -> np.ndarray:
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


def selection_set(outs) -> np.ndarray:
    """Per-frame selection as a canonical sorted (slot, matched) set."""
    sel = _np(outs.sel_slot).astype(np.int64)        # [T, NSEL]
    mat = _np(outs.sel_matched).astype(np.int64)     # [T, NSEL]
    nsel = _np(outs.n_selected).astype(np.int64)     # [T]
    lane = np.arange(sel.shape[1], dtype=np.int64)[None, :]
    pad = np.int64(1) << 40
    key = np.where(lane < nsel[:, None], sel * 2 + mat, pad)
    key = np.sort(key, axis=1)
    return np.where(key == pad, np.int64(-1), key)


def decisions_fingerprint(outs, n_frames: int) -> dict:
    """Summary scalars + a sha256 over every discrete per-frame decision."""
    h = hashlib.sha256()
    for name in DECISION_FIELDS:
        arr = _np(getattr(outs, name)).astype(np.int64)
        h.update(name.encode())
        h.update(arr.tobytes())
    h.update(b"sel_set")
    h.update(selection_set(outs).tobytes())
    return dict(
        n_frames=int(n_frames),
        matched_sum=int(_np(outs.n_matched).sum()),
        inits=int(_np(outs.did_init).sum()),
        convs=int(_np(outs.did_convert).sum()),
        active_end=int(_np(outs.n_active)[-1]),
        decisions_sha256=h.hexdigest(),
    )


def load_expected(name: str) -> dict:
    """The committed fingerprint scenelib2_torch/data/<name>.json:
    "expected_fingerprint" (mapping on) or "expected_fingerprint_nomap"."""
    with open(os.path.join(DATA_DIR, f"{name}.json")) as f:
        return json.load(f)
