"""scenelib2_torch.core against scenelib2_tpu.core, function by function.

The same inputs, made from a seeded numpy generator, go through the JAX
function (in f64; the test process runs JAX with x64 enabled) and its
PyTorch port in f64 and in f32. Tolerances: f64 to 1e-12 and f32 to 1e-5,
both relative to the largest entry of each output (the f32 port rounds
every operation to f32, the reference does not).
"""

from __future__ import annotations

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scenelib2_tpu.config import Params as JParams
from scenelib2_tpu.core import camera as jcam
from scenelib2_tpu.core import ekf as jekf
from scenelib2_tpu.core import models as jmodels
from scenelib2_tpu.core import motion as jmotion
from scenelib2_tpu.core import quaternion as jq
from scenelib2_torch.config import Params as TParams
from scenelib2_torch.core import camera as tcam
from scenelib2_torch.core import ekf as tekf
from scenelib2_torch.core import models as tmodels
from scenelib2_torch.core import motion as tmotion
from scenelib2_torch.core import quaternion as tq

TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
JCAM = jcam.CameraParams.from_params(JParams())
TCAM = tcam.CameraParams.from_params(TParams())
DT = 1.0 / 30.0



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain path is hundreds of tiny tensor ops per frame: intra-op
    threads only contend with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _unit(rng, n=4, scale=1.0):
    v = rng.normal(size=n)
    return v / np.linalg.norm(v) * scale


def _near_unit(rng):
    return _unit(rng, scale=1.0 + rng.uniform(-1e-3, 1e-3))


def _spd(rng, n, s=1.0):
    A = rng.normal(size=(n, n))
    return (A @ A.T / n + np.eye(n)) * s


def _xv(rng):
    xv = rng.normal(size=13) * 0.1
    xv[3:7] = _near_unit(rng)
    xv[10:13] = rng.normal(size=3) * 0.5
    return xv


def _point_in_front(rng):
    return np.array([rng.uniform(-0.3, 0.3), rng.uniform(-0.2, 0.2), rng.uniform(0.5, 2.0)])


def _xp_and_world_point(rng):
    xp = np.concatenate([rng.normal(size=3) * 0.05, [1.0, 0.0, 0.0, 0.0] + rng.normal(size=4) * 0.02])
    y = np.array([rng.uniform(-0.3, 0.3), rng.uniform(-0.2, 0.2), rng.uniform(0.8, 2.0)])
    return xp, y


# name -> (input builder, JAX function, torch function)
CASES = {
    "quat_mul": (lambda r: (_near_unit(r), _near_unit(r)), jq.quat_mul, tq.quat_mul),
    "quat_inverse": (lambda r: (_near_unit(r),), jq.quat_inverse, tq.quat_inverse),
    "quat_to_rotation_matrix": (lambda r: (_near_unit(r),), jq.quat_to_rotation_matrix,
                                tq.quat_to_rotation_matrix),
    "quat_from_angular_velocity": (lambda r: (r.normal(size=3) * 0.05,),
                                   jq.quat_from_angular_velocity, tq.quat_from_angular_velocity),
    "quat_from_zero_angular_velocity": (lambda r: (np.zeros(3),), jq.quat_from_angular_velocity,
                                        tq.quat_from_angular_velocity),
    "dq3_by_dq1": (lambda r: (_near_unit(r),), jq.dq3_by_dq1, tq.dq3_by_dq1),
    "dq3_by_dq2": (lambda r: (_near_unit(r),), jq.dq3_by_dq2, tq.dq3_by_dq2),
    "dqomegadt_by_domega": (lambda r: (r.normal(size=3),), lambda w: jq.dqomegadt_by_domega(w, DT),
                            lambda w: tq.dqomegadt_by_domega(w, DT)),
    "dqomegadt_by_domega_zero": (lambda r: (np.zeros(3),), lambda w: jq.dqomegadt_by_domega(w, DT),
                                 lambda w: tq.dqomegadt_by_domega(w, DT)),
    "dqnorm_by_dq": (lambda r: (_near_unit(r),), jq.dqnorm_by_dq, tq.dqnorm_by_dq),
    "dRq_times_a_by_dq": (lambda r: (_near_unit(r), r.normal(size=3)), jq.dRq_times_a_by_dq,
                          tq.dRq_times_a_by_dq),
    "project": (lambda r: (_point_in_front(r),), lambda y: jcam.project(JCAM, y),
                lambda y: tcam.project(TCAM, y)),
    "project_jacobian": (lambda r: (_point_in_front(r),), lambda y: jcam.project_jacobian(JCAM, y),
                         lambda y: tcam.project_jacobian(TCAM, y)),
    "measurement_noise": (lambda r: (r.uniform(0, 300, 2),), lambda h: jcam.measurement_noise(JCAM, h),
                          lambda h: tcam.measurement_noise(TCAM, h)),
    "func_fv_and_dfv_by_dxv": (lambda r: (_xv(r), r.normal(size=3) * 0.1),
                               lambda xv, u: jmotion.func_fv_and_dfv_by_dxv(xv, u, DT),
                               lambda xv, u: tmotion.func_fv_and_dfv_by_dxv(xv, u, DT)),
    "func_Q": (lambda r: (_xv(r),), lambda xv: jmotion.func_Q(xv, DT, 4.0, 6.0),
               lambda xv: tmotion.func_Q(xv, DT, 4.0, 6.0)),
    "func_xvnorm_and_dxvnorm_by_dxv": (lambda r: (_xv(r),), jmotion.func_xvnorm_and_dxvnorm_by_dxv,
                                       tmotion.func_xvnorm_and_dxvnorm_by_dxv),
    "full_zeroedyi": (lambda r: _xp_and_world_point(r)[::-1], jmodels.full_zeroedyi,
                      tmodels.full_zeroedyi),
    "full_predict_measurement": (lambda r: _xp_and_world_point(r)[::-1],
                                 lambda y, xp: jmodels.full_predict_measurement(JCAM, y, xp),
                                 lambda y, xp: tmodels.full_predict_measurement(TCAM, y, xp)),
    "innovation_covariance": (
        lambda r: (_spd(r, 13, 1e-3), r.normal(size=(13, 3)) * 1e-4, _spd(r, 3, 1e-3),
                   r.normal(size=(2, 13)) * 50, r.normal(size=(2, 3)) * 50, np.eye(2) * 1.3),
        jmodels.innovation_covariance, tmodels.innovation_covariance),
    "ekf_predict": (
        lambda r: (np.concatenate([_xv(r), r.normal(size=12)]), _spd(r, 25, 1e-3), np.zeros(3)),
        lambda x, P, u: jekf.predict(x, P, u, DT, 4.0, 6.0),
        lambda x, P, u: tekf.predict(x, P, u, DT, 4.0, 6.0)),
    "ekf_normalise": (lambda r: (np.concatenate([_xv(r), r.normal(size=12)]), _spd(r, 25, 1e-3)),
                      jekf.normalise, tekf.normalise),
    "chol2x2": (lambda r: (_spd(r, 2),), jekf.chol2x2, tekf.chol2x2),
    "inv2x2_via_chol": (lambda r: (_spd(r, 2),), jekf.inv2x2_via_chol, tekf.inv2x2_via_chol),
    "joint_update": (
        lambda r: (r.normal(size=25), _spd(r, 25), r.normal(size=(6, 25)), r.normal(size=6),
                   np.eye(6) * 1.5),
        lambda x, P, H, nu, R: jekf.joint_update(x, P, H, nu, R, pallas_chol=False),
        tekf.joint_update),
    "symmetrize": (lambda r: (r.normal(size=(9, 9)),), jekf.symmetrize, tekf.symmetrize),
}


def _as_tuple(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v,)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_core_function_matches_jax(name, dtype):
    build, jfn, tfn = CASES[name]
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    for _trial in range(3):
        args = build(rng)
        want = _as_tuple(jfn(*(jnp.asarray(np.asarray(a, np.float64)) for a in args)))
        got = _as_tuple(tfn(*(torch.tensor(np.asarray(a, np.float64), dtype=dtype) for a in args)))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            g = g.double().numpy()
            w = np.asarray(w, np.float64)
            assert g.shape == w.shape, (name, g.shape, w.shape)
            scale = max(float(np.abs(w).max()), 1e-30)
            np.testing.assert_allclose(g, w, rtol=TOL[dtype], atol=TOL[dtype] * scale, err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_visibility_flags_match_jax(dtype):
    """full_visibility_test bit flags, exact, over poses that trip each bit."""
    rng = np.random.default_rng(5)
    jp, tp = JParams(), TParams()
    for _ in range(40):
        xp, y = _xp_and_world_point(rng)
        xp_orig = xp.copy()
        xp_orig[:3] += rng.normal(size=3) * rng.choice([0.01, 1.0, 3.0])
        xp_orig[3:7] = _near_unit(rng) if rng.uniform() < 0.3 else xp_orig[3:7]
        if rng.uniform() < 0.2:
            y[2] = -y[2]                               # behind the camera
        hj, _, _, _ = jmodels.full_predict_measurement(JCAM, jnp.asarray(y), jnp.asarray(xp))
        want = int(jmodels.full_visibility_test(
            JCAM, jnp.asarray(xp), jnp.asarray(y), jnp.asarray(xp_orig), hj,
            jp.image_search_boundary, jp.max_length_ratio, jp.max_angle_difference))
        ty, txp, txo = (torch.tensor(a, dtype=dtype) for a in (y, xp, xp_orig))
        ht, _, _, _ = tmodels.full_predict_measurement(TCAM, ty, txp)
        got = int(tmodels.full_visibility_test(
            TCAM, txp, ty, txo, ht, tp.image_search_boundary, tp.max_length_ratio,
            tp.max_angle_difference))
        assert got == want, (xp, y, xp_orig)
