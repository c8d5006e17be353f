"""The reference's whole-window image processing against the loop form it
was rewritten from (the port's copy of the oracle, scenelib2_torch/eval/
oracle_improc.py), and the reference's filter against the port's oracle:
equal results, number for number."""

import numpy as np
import pytest

from perfbench.reference import improc, monoslam
from perfbench.reference.replay import bfloat16, replay


def smooth_image(rng, H=240, W=320):
    img = rng.uniform(0, 255, (H, W))
    for _ in range(2):
        img = (img + np.roll(img, 1, 0) + np.roll(img, -1, 0) + np.roll(img, 1, 1) + np.roll(img, -1, 1)) / 5
    return np.clip(img, 0, 255).astype(np.uint8)


def random_sinv(rng, scale):
    a = rng.normal(size=(2, 2))
    S = a @ a.T + np.eye(2) * scale
    return np.linalg.inv(S)


@pytest.mark.parametrize("seed", range(6))
def test_elliptical_search_equals_loop(seed):
    from scenelib2_torch.eval import oracle_improc as loop

    rng = np.random.default_rng(seed)
    img = smooth_image(rng)
    patch = img[100:111, 150:161].copy() if seed % 2 else rng.integers(0, 255, (11, 11)).astype(np.uint8)
    for _ in range(8):
        centre = np.array([rng.uniform(-5, 325), rng.uniform(-5, 245)])
        sinv = random_sinv(rng, rng.uniform(1, 40))
        assert improc.elliptical_search(img, patch, centre, sinv) == loop.elliptical_search(img, patch, centre, sinv)


@pytest.mark.parametrize("seed", range(4))
def test_multi_ellipse_search_equals_loop(seed):
    from scenelib2_torch.eval import oracle_improc as loop

    rng = np.random.default_rng(100 + seed)
    img = smooth_image(rng)
    img[50:80, 50:80] = 77                                # a flat patch: the low-deviation penalty
    patch = img[120:131, 200:211].copy()
    base = np.array([rng.uniform(20, 300), rng.uniform(20, 220)])
    centres = [base + rng.normal(scale=6, size=2) for _ in range(30)]
    sinvs = [random_sinv(rng, rng.uniform(2, 20)) for _ in range(30)]
    got = improc.multi_ellipse_search(img, patch, centres, sinvs)
    want = loop.multi_ellipse_search(img, patch, centres, sinvs)
    assert [(bool(f), u, v) for f, u, v in got] == [(bool(f), u, v) for f, u, v in want]


@pytest.mark.parametrize("seed", range(4))
def test_find_best_patch_equals_loop(seed):
    from scenelib2_torch.eval import oracle_improc as loop

    rng = np.random.default_rng(200 + seed)
    img = smooth_image(rng)
    us, vs = int(rng.integers(-5, 200)), int(rng.integers(-5, 150))
    args = (img, 11, us, vs, us + 80, vs + 60)
    assert improc.find_best_patch(*args) == loop.find_best_patch(*args)


def test_search_window_cap_drops_far_candidates():
    rng = np.random.default_rng(7)
    img = smooth_image(rng)
    patch = img[100:111, 200:211].copy()                  # its best match is at (205, 105)
    sinv = np.eye(2) / 40.0 ** 2                          # a 3-sigma ellipse of 120 px
    found, u, v, _ = improc.elliptical_search(img, patch, np.array([160.0, 105.0]), sinv)
    assert (found, u, v) == (True, 205, 105)
    found, u, v, _ = improc.elliptical_search(img, patch, np.array([160.0, 105.0]), sinv, win_radius=32)
    assert abs(u - 160) <= 32 and (u, v) != (205, 105)


def test_bfloat16_keeps_eight_significant_bits():
    x = np.array([1.0, 1.0 + 2 ** -8, 1.0 + 3 * 2 ** -9, 0.1, -3.3])
    got = bfloat16(x)
    # 7 stored bits: 1 + 2^-8 lies halfway and goes to the even 1.0
    assert got[0] == 1.0 and got[1] == 1.0 and got[2] == 1.0 + 2 ** -7
    assert np.all(np.abs(got - x) <= np.abs(x) * 2 ** -8)


def test_filter_equals_the_port_oracle():
    """12 frames of a synthetic sequence: the reference and the port's
    oracle (the loop form) keep the same pose, bit for bit, and decide the
    same."""
    from scenelib2_torch.config import Params
    from scenelib2_torch.eval import oracle_monoslam as loop
    from scenelib2_torch.eval import synthetic

    p = Params(max_features=16)
    rng = np.random.default_rng(3)
    tex = synthetic.make_texture(rng)
    rs, qs = synthetic.default_trajectory(13, p.delta_t)
    frames = np.stack([synthetic.render_frame(p, tex, rs[i], qs[i], 0.6 / p.cam_fku) for i in range(13)])
    xv0 = np.zeros(13)
    xv0[:3], xv0[3:7], xv0[12] = rs[0], qs[0], 0.01
    pxx0 = np.diag([4e-4] * 3 + [0.0] * 4 + [4e-4] * 6)
    known = []
    for y in synthetic.KNOWN_POINTS:
        h = synthetic.project_point(p, y, rs[0], qs[0])
        uu, vv = int(round(h[0])), int(round(h[1]))
        known.append((y, np.concatenate([rs[0], qs[0]]), frames[0][vv - 5 : vv + 6, uu - 5 : uu + 6]))
    settings = dict(p.__dict__)
    got = replay(settings, frames[1:], xv0, pxx0, known)
    cam = loop.Cam(p.cam_width, p.cam_height, p.cam_fku, p.cam_fkv, p.cam_u0, p.cam_v0, p.cam_kd1, p.cam_sd)
    o = loop.OracleMonoSLAM(cam, p, xv0, pxx0, seed=0)
    for y, xp, patch in known:
        o.feats.append(loop.Feat(y=np.asarray(y, float), pxy=np.zeros((13, 3)), pyy=np.zeros((3, 3)),
                                 cross=[np.zeros((3, 3)) for _ in o.feats], patch=patch.copy(),
                                 xp_org=xp.copy(), label=o.next_label, fully=True))
        o.next_label += 1
    for t in range(12):
        rec = o.go_one_step(frames[t + 1], True)
        assert np.array_equal(got["pose"][t], np.concatenate([o.xv[:3], o.xv[3:7]]))
        assert got["decisions"][t][[0, 1, 2]].tolist() == [rec["n_visible"], rec["n_selected"], rec["n_matched"]]
        assert got["decisions"][t][[3, 4]].tolist() == [len(o.feats), len(o.partials)]


def test_params_of_ignores_unknown_keys():
    p = monoslam.Params.of({"max_features": 100, "use_pallas": True})
    assert p.max_features == 100 and p.n_particles == 100
