"""The stage-level work count: a function of the configuration's shapes and
of the frame's decisions only."""

import json
import os

import numpy as np
import pytest

from perfbench import work

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
with open(os.path.join(ROOT, "perfbench", "configs", "std.json")) as f:
    CFG = json.load(f)["settings"]
NSEL, NP = 10, 100


def frame(n_matched=6, n_selected=8, did_init=False, did_convert=False, partial=True, seed=0):
    rng = np.random.default_rng(seed)
    sel_mask = np.arange(NSEL) < n_selected
    sel_h = np.stack([rng.uniform(40, 280, NSEL), rng.uniform(40, 200, NSEL)], 1)
    sel_S = np.tile(np.array([[9.0, 1.0], [1.0, 6.0]]), (NSEL, 1, 1))
    par_h = np.stack([np.linspace(100, 140, NP), np.linspace(90, 110, NP)], 1)[None]
    par_sinv = np.tile(np.linalg.inv(np.array([[4.0, 0.5], [0.5, 3.0]])), (1, NP, 1, 1))
    return dict(n_selected=n_selected, n_matched=n_matched, n_active=9, n_partial=int(partial),
                did_init=did_init, did_convert=did_convert, sel_mask=sel_mask, sel_h=sel_h, sel_S=sel_S,
                par_mask=np.array([partial]), par_h=par_h, par_sinv=par_sinv,
                par_alive=np.ones((1, NP), bool))


def test_unmatched_frame_has_no_update():
    w = work.frame_work(CFG, (9, 1), frame(n_matched=0))
    assert "update" not in w and {"predict", "measure", "search", "particles"} <= set(w)


def test_decisions_add_their_stages():
    w = work.frame_work(CFG, (9, 1), frame(did_init=True, did_convert=True))
    assert {"init", "convert"} <= set(w)


def test_count_reads_only_shapes_and_decisions():
    """Fields the count does not read, and the order of the selected
    features, leave it unchanged."""
    a = frame()
    b = dict(frame(), r=np.ones(3), speed=3.0, n_overflow=2)
    perm = np.random.default_rng(1).permutation(8)
    for k in ("sel_h", "sel_S"):
        b[k] = b[k].copy()
        b[k][:8] = b[k][perm]
    assert work.frame_work(CFG, (9, 1), a) == work.frame_work(CFG, (9, 1), b)


def test_count_grows_with_the_map_and_the_matches():
    small = work.frame_work(CFG, (5, 0), frame())
    large = work.frame_work(CFG, (15, 1), frame())
    assert all(large[k][0] >= small[k][0] and large[k][1] >= small[k][1] for k in ("predict", "update"))
    few = work.frame_work(CFG, (9, 1), frame(n_matched=2))["update"]
    many = work.frame_work(CFG, (9, 1), frame(n_matched=8))["update"]
    assert many[0] > few[0] and many[1] > few[1]


def test_update_count_by_hand():
    """M = 2 rows, D = 13 + 3 (one point): P H', S, S^-1, W, the upper
    triangle of W S W'; x and P's upper triangle read and written."""
    w = work.frame_work(CFG, (1, 0), dict(frame(n_matched=1, n_selected=1, partial=False)))
    D, M = 16, 2
    assert w["update"] == ((2 * D + D * (D + 1)) * 4 + M * 12 * 4,
                           2 * D * M * 10 + 2 * M * M * 10 + M ** 3 + 2 * D * M * M + D * (D + 1) * M)


def test_least_time_is_the_larger_bound():
    outs = [frame(seed=s) for s in range(3)]
    least, stages = work.stretch_least_s(CFG, (9, 1), outs)
    nb = sum(v[0] for v in stages.values())
    nf = sum(v[1] for v in stages.values())
    assert least == pytest.approx(max(nb / work.PEAK_BYTES_S, nf / work.PEAK_F32_S))
    assert 0 < least < 1e-5


def test_ellipse_cells_count_the_candidates():
    n, box = work.ellipse_cells(np.array([100.0, 100.0]), np.eye(2) / 4.0, 3.0, 32, 320, 240, 5)
    u, v = np.meshgrid(np.arange(-6, 7), np.arange(-6, 7))
    assert n == int((u * u / 4.0 + v * v / 4.0 < 9).sum())
    assert box == (95, 106, 95, 106)
    assert work.ellipse_cells(np.array([np.nan, 1.0]), np.eye(2), 3.0, 32, 320, 240, 5) == (0, None)
