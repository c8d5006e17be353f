"""The plain versions of K2, K8 and K6 past the search-radius and region
caps the kernels once had (K2 / K8 at radii above 103 px, K6 at regions
wider than 88 px or taller than 68 px), held to the JAX package's TPU
kernels in interpret mode on the CPU:

  K2 (search_plain) against pallas_elliptical_search_fused and K8
  (search_windows_plain) against pallas_elliptical_search, at radius 110
  and at the whole-frame radius 160 of a 320x240 frame (windows of side
  W - B + 1 by H - B + 1), on random frames with planted matches, an
  ellipse beyond the window, infinite half-widths and a border feature;
  K6 (shi_tomasi_plain) against pallas_shi_tomasi_region at
  init_search_width 100 and at the whole frame after the clamp (308 x 228).

Decisions and integers are equal; best within K2_BEST_ATOL (XLA's CPU f32
sqrt may be an ulp off) and the eigenvalue within EV_RTOL. The kernels
themselves are held to these plain versions bit for bit on the card
(chip_smoke.py phase 2).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scenelib2_tpu.kernels import correlate as jcorr
from scenelib2_tpu.kernels.pallas_search import (
    gather_windows_u8,
    pallas_elliptical_search,
    pallas_elliptical_search_fused,
)
from scenelib2_tpu.kernels.pallas_shi_tomasi import pallas_shi_tomasi_region
from scenelib2_torch.config import Params
from scenelib2_torch.kernels import correlate
from scenelib2_torch.kernels.search import SearchConsts, search_plain, search_window_origin, search_windows_plain
from scenelib2_torch.kernels.shi_tomasi import clamp_region, region_geometry, shi_tomasi_plain
from scenelib2_torch.runtime.state import patch_row

P = Params()
H, W, B = P.cam_height, P.cam_width, P.boxsize
K = 6
K2_BEST_ATOL = 2e-5
EV_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(R: int, seed: int):
    """A random frame, K features: planted perfect matches (0, 1), an
    ellipse beyond the window (2), infinite half-widths (3: the whole
    window), a feature at the border (4), a random one (5)."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (H, W), dtype=np.uint8)
    centres = np.stack([rng.uniform(60, W - 60, K), rng.uniform(50, H - 50, K)], 1)
    centres[4] = (W - 2.0, 3.0)
    patches = []
    for k in range(K):
        u = int(np.clip(round(centres[k, 0]) + rng.integers(-40, 41), 5, W - 6))
        v = int(np.clip(round(centres[k, 1]) + rng.integers(-30, 31), 5, H - 6))
        patches.append(img[v - 5 : v + 6, u - 5 : u + 6].copy())
    sinv = []
    for k in range(K):
        s = rng.uniform(20.0, 60.0, 2)
        rho = rng.uniform(-0.6, 0.6)
        c = rho * np.sqrt(s[0] * s[1])
        sinv.append(np.linalg.inv(np.array([[s[0] ** 2, c * s[0] * s[1] / np.sqrt(s[0] * s[1])],
                                            [c * s[0] * s[1] / np.sqrt(s[0] * s[1]), s[1] ** 2]])))
    sinv[2] = np.linalg.inv(np.diag([400.0**2, 300.0**2]))
    sinv[3] = np.array([[1.0, 0.5], [0.5, 0.25]])
    active = np.ones(K, bool)
    return img, centres.astype(np.float32), np.stack(patches), np.stack(sinv).astype(np.float32), active


def _consts(R: int) -> SearchConsts:
    return SearchConsts(H=H, W=W, boxsize=B, win_radius=R, no_sigma=P.no_sigma, corr_thresh2=P.corr_thresh2,
                        corr_sigma_thresh=P.corr_sigma_thresh)


def _assert_search(got, want, what):
    found, u, v, best, over = (t.numpy() for t in got)
    wfound, wu, wv, wbest, wover = (np.asarray(t) for t in want)
    np.testing.assert_array_equal(found, wfound, err_msg=what)
    np.testing.assert_array_equal(over, wover, err_msg=what)
    np.testing.assert_array_equal(u, wu, err_msg=what)
    np.testing.assert_array_equal(v, wv, err_msg=what)
    np.testing.assert_allclose(best, wbest, rtol=0, atol=K2_BEST_ATOL, err_msg=what)


@pytest.mark.parametrize("R", [110, 160])
def test_k2_plain_matches_pallas_past_the_old_cap(R):
    img, centres, patches, sinv, active = _scene(R, R)
    c = _consts(R)
    if R == 160:
        assert (c.side_u, c.side_v) == (W - B + 1, H - B + 1)
    rows = np.stack([patch_row(torch.tensor(p)).numpy() for p in patches])
    ju0, jv0, _, _ = jcorr.search_window_origin(jnp.asarray(centres), R, W, H, B, round_half=True)
    want = pallas_elliptical_search_fused(
        jnp.asarray(img), None, ju0, jv0, jnp.asarray(centres), jnp.asarray(sinv), jnp.asarray(active),
        image_shape=(H, W), boxsize=B, win_radius=R, no_sigma=P.no_sigma, corr_thresh2=P.corr_thresh2,
        corr_sigma_thresh=P.corr_sigma_thresh, interpret=True, patch_rows=jnp.asarray(rows))
    u0, v0, uc, vc = search_window_origin(torch.tensor(centres), R, W, H, B)
    np.testing.assert_array_equal(u0.numpy(), np.asarray(ju0))
    np.testing.assert_array_equal(v0.numpy(), np.asarray(jv0))
    abc = torch.tensor(np.stack([sinv[:, 0, 0], sinv[:, 0, 1], sinv[:, 1, 1]], 1))
    got = search_plain(torch.tensor(img), torch.tensor(rows), u0, v0, uc, vc, abc, torch.tensor(active), c)
    _assert_search(got, want, f"K2 R={R}")
    assert bool(got[0][:2].all()) and bool(got[4][2])


@pytest.mark.parametrize("R", [110, 160])
def test_k8_plain_matches_pallas_past_the_old_cap(R):
    img, centres, patches, sinv, active = _scene(R, 7 + R)
    c = _consts(R)
    u0, v0, _uc, _vc = search_window_origin(torch.tensor(centres), R, W, H, B)
    windows = correlate.gather_windows_u8(torch.tensor(img)[None], u0[None], v0[None], R, B)[0]
    jwin = gather_windows_u8(jnp.asarray(img), jnp.asarray(u0.numpy()), jnp.asarray(v0.numpy()), R, B)
    np.testing.assert_array_equal(windows.numpy(), np.asarray(jwin))
    want = pallas_elliptical_search(
        jnp.asarray(windows.numpy()), jnp.asarray(patches), jnp.asarray(u0.numpy()), jnp.asarray(v0.numpy()),
        jnp.asarray(centres), jnp.asarray(sinv), jnp.asarray(active), image_shape=(H, W), boxsize=B,
        win_radius=R, no_sigma=P.no_sigma, corr_thresh2=P.corr_thresh2, corr_sigma_thresh=P.corr_sigma_thresh,
        interpret=True)
    abc = torch.tensor(np.stack([sinv[:, 0, 0], sinv[:, 0, 1], sinv[:, 1, 1]], 1))
    got = search_windows_plain(windows, torch.tensor(patches), u0, v0, torch.tensor(centres), abc,
                               torch.tensor(active), c)
    _assert_search(got, want, f"K8 R={R}")
    assert bool(got[0][:2].all())


@pytest.mark.parametrize("region", [(100, 60), (10**4, 10**4)])
@pytest.mark.parametrize("kind", ["noise", "corner"])
def test_k6_plain_matches_pallas_past_the_old_cap(region, kind):
    rw_, rh_ = region
    rng = np.random.default_rng(rw_ % 97)
    frame = rng.integers(0, 256, (H, W), dtype=np.uint8)
    u, v = (W - 40, H - 25) if kind == "corner" else (40, 30)
    bounds = tuple(int(t) for t in clamp_region(*(torch.tensor(x, dtype=torch.int32) for x in (
        u, v, u + rw_, v + rh_)), W, H, B))
    off, rw, rh = region_geometry(H, W, B, rw_, rh_)
    assert rw + 2 * off > 100 or rh + 2 * off > 80   # past the old 100 x 80 window
    ub, vb, ev = pallas_shi_tomasi_region(jnp.asarray(frame), *(jnp.int32(b) for b in bounds), boxsize=B,
                                          image_shape=(H, W), region_w=rw_, region_h=rh_, interpret=True)
    gu, gv, gev = shi_tomasi_plain(torch.tensor(frame), *(torch.tensor(b, dtype=torch.int32) for b in bounds),
                                   boxsize=B, region_w=rw_, region_h=rh_)
    assert (int(gu), int(gv)) == (int(ub), int(vb))
    assert abs(float(gev) - float(ev)) <= EV_RTOL * max(abs(float(ev)), 1.0)
    assert float(ev) > 0
