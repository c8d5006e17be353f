"""runtime/assembly.py::measurement_assembly against the JAX package's, in
process with x64 on (the JAX package's default), on _make_map_state's maps
after one predict: n_feat 20 and 500, slot_dim 6 and 3, f64 and f32 (JAX's
f32 frames run in its x64 process, so its camera constants promote h, the
Jacobians, R and S to f64 before the cast back; the port mirrors that).

  top_idx                         exact
  H's zero pattern                exact (every entry off the camera columns
                                  and the selected slots' columns is 0)
  H's Jacobian entries            1e-13 (f64) / 1e-6 (f32) of max |H|
  R                               1e-13 (f64) / 1e-6 (f32) relative
  h_sel                           1e-12 px (f64) / 1e-4 px (f32)

Largest differences seen: H 2.9e-16 / 2.4e-7 of max |H|, R 6.7e-16 /
2.4e-7 relative, h_sel 2.8e-14 / 1.5e-5 px (the f32 ones are an ulp: XLA
sums its small dots with fused multiply-adds). Near-ties of the score: two
slots with the same world point and covariance blocks score the same bits,
and the lower index goes first, as lax.top_k decides; a copy whose pyy
diagonal is larger by 1e-9 of itself beats its original whichever index it
has, in both packages.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scenelib2_tpu.config import Params as JParams
from scenelib2_tpu.core import ekf as jekf
from scenelib2_tpu.core.camera import CameraParams as JCam
from scenelib2_tpu.runtime.assembly import measurement_assembly as jax_assembly
from scenelib2_torch.config import Params
from scenelib2_torch.core.camera import CameraParams
from scenelib2_torch.eval.benchmark import _make_map_state
from scenelib2_torch.runtime.assembly import measurement_assembly, slot_blocks

N_SEL = 10
TOL = {"float64": dict(H=1e-13, R=1e-13, h=1e-12), "float32": dict(H=1e-6, R=1e-6, h=1e-4)}


@pytest.fixture(autouse=True)
def _x64():
    with jax.enable_x64(True):
        yield


def predicted(n_feat, slot_dim, dtype, edit=None):
    """(x, P) of _make_map_state (edited by edit(x, P) in f64) after JAX's
    predict in dtype, as numpy."""
    x, P, _ = _make_map_state(n_feat, slot_dim)
    if edit is not None:
        edit(x, P)
    p = JParams()
    xj, Pj = jekf.predict(jnp.asarray(x.astype(dtype)), jnp.asarray(P.astype(dtype)), jnp.zeros(3),
                          p.delta_t, p.sd_a, p.sd_alpha)
    return np.array(xj), np.array(Pj)


def both(x, P, n_feat, slot_dim):
    want = [np.asarray(a) for a in jax_assembly(JCam.from_params(JParams()), jnp.asarray(x), jnp.asarray(P),
                                                  n_feat, slot_dim, N_SEL)]
    got = [a.numpy() for a in measurement_assembly(CameraParams.from_params(Params()), torch.from_numpy(x.copy()),
                                                   torch.from_numpy(P.copy()), n_feat, slot_dim, N_SEL)]
    return got, want


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("slot_dim", [6, 3])
@pytest.mark.parametrize("n_feat", [20, 500])
def test_assembly_matches_jax(n_feat, slot_dim, dtype):
    x, P = predicted(n_feat, slot_dim, dtype)
    (H, R, top, h), (Hj, Rj, topj, hj) = both(x, P, n_feat, slot_dim)
    tol = TOL[dtype]
    D = 13 + slot_dim * n_feat
    assert H.shape == (2 * N_SEL, D) and R.shape == (2 * N_SEL,) * 2 and h.shape == (N_SEL, 2)
    assert H.dtype == R.dtype == h.dtype == np.dtype(dtype) and top.dtype == np.int32
    np.testing.assert_array_equal(top, topj)
    np.testing.assert_array_equal(H == 0, Hj == 0)
    live = np.zeros(D, bool)
    live[:7] = True
    for k in top:
        live[13 + slot_dim * k:16 + slot_dim * k] = True
    assert not H[:, ~live].any()
    np.testing.assert_allclose(H, Hj, rtol=0, atol=tol["H"] * np.abs(Hj).max())
    np.testing.assert_array_equal(R == 0, Rj == 0)
    np.testing.assert_allclose(R, Rj, rtol=tol["R"], atol=0)
    np.testing.assert_allclose(h, hj, rtol=0, atol=tol["h"])


def test_slot_blocks_read_the_live_range_of_a_padded_state():
    """A mesh-padded state (zeros past the live range) gives the blocks and
    the assembly of the unpadded one, with H zero in the pad columns."""
    n_feat, slot_dim = 20, 6
    x, P = predicted(n_feat, slot_dim, "float64")
    D = x.shape[0]
    xp, Pp = np.zeros(D + 5), np.zeros((D + 5, D + 5))
    xp[:D], Pp[:D, :D] = x, P
    cam = CameraParams.from_params(Params())
    a = slot_blocks(torch.from_numpy(x), torch.from_numpy(P), n_feat, slot_dim)
    b = slot_blocks(torch.from_numpy(xp), torch.from_numpy(Pp), n_feat, slot_dim)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    idx = 13 + slot_dim * np.arange(n_feat)[:, None] + np.arange(3)
    np.testing.assert_array_equal(a[4].numpy(), P[idx[:, :, None], idx[:, None, :]])
    H, R, top, h = measurement_assembly(cam, torch.from_numpy(x), torch.from_numpy(P), n_feat, slot_dim, N_SEL)
    Hp, Rp, topp, hp = measurement_assembly(cam, torch.from_numpy(xp), torch.from_numpy(Pp), n_feat, slot_dim, N_SEL)
    assert torch.equal(top, topp) and torch.equal(R, Rp) and torch.equal(h, hp)
    assert torch.equal(Hp[:, :D], H) and not Hp[:, D:].any()


def _copy_slot(src, dst, slot_dim, scale=1.0):
    """An edit: slot dst takes slot src's world point and covariance blocks
    (its diagonal block times scale)."""
    def edit(x, P):
        a, b = 13 + slot_dim * src, 13 + slot_dim * dst
        x[b:b + 3] = x[a:a + 3]
        P[b:b + 3, :] = P[a:a + 3, :]
        P[:, b:b + 3] = P[:, a:a + 3]
        P[b:b + 3, b:b + 3] = P[a:a + 3, a:a + 3] * scale
    return edit


@pytest.mark.parametrize("near", [False, True])
@pytest.mark.parametrize("where", ["later", "earlier"])
def test_score_ties_are_decided_as_lax_top_k_decides(where, near):
    """The last (or first) slot of a 20-slot map copies a selected slot
    between them: the same bits of score, so the lower index goes first,
    right beside the other; with its pyy diagonal larger by 1e-9 (near) the
    copy scores higher and goes first wherever it stands."""
    n_feat, slot_dim = 20, 6
    x, P = predicted(n_feat, slot_dim, "float64")
    (_, _, top, _), _ = both(x, P, n_feat, slot_dim)
    src = next(int(k) for k in top if 0 < k < n_feat - 1)
    dst = n_feat - 1 if where == "later" else 0
    x, P = predicted(n_feat, slot_dim, "float64", _copy_slot(src, dst, slot_dim, 1.0 + 1e-9 if near else 1.0))
    (_, _, top, _), (_, _, topj, _) = both(x, P, n_feat, slot_dim)
    np.testing.assert_array_equal(top, topj)
    i = min(list(top).index(src), list(top).index(dst))
    assert list(top[i:i + 2]) == ([dst, src] if near else sorted([src, dst]))
