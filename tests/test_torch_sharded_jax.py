"""The sharded-covariance EKF (parallel/mesh.py) on one rank: a gloo
process group of world size 1 in this process and a (1, 1) ("row", "col")
DeviceMesh, against the JAX package's same functions jitted on a (1, 1)
JAX mesh of one CPU device (x64 on), and against the port's unsharded
composition of core.ekf (joint_update with blas=True, the large-map frame
eval.benchmark._make_ekf_frame). Operands follow tests/test_parallel.py
(its _frame_operands recipe, its sizes and its bars):

  sharded_joint_update   D = 128, M = 8      x rtol 1e-10; P rtol 1e-8, atol 1e-10
  sharded_predict        D = 73              rtol 1e-12, atol 1e-15
  sharded_slam_frame     D = 133, M = 16     x rtol 1e-12, atol 1e-14; P rtol 1e-9, atol 1e-12
  sharded_stress_frame   50 and 500 features top_idx exact; x rtol 1e-10, atol 1e-12;
                         (D = 313, 3013),    P rtol 1e-8, atol 1e-10 (the
                         3 chained frames    bench frames' bars)

The multi-rank meshes run in tests/test_torch_sharded_ranks.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from scenelib2_tpu.config import Params as JParams
from scenelib2_tpu.parallel import mesh as jmesh
from scenelib2_torch.config import Params
from scenelib2_torch.core import ekf
from scenelib2_torch.eval.benchmark import _make_ekf_frame, _make_map_state
from scenelib2_torch.parallel import mesh as pm

F64 = torch.float64


@pytest.fixture(autouse=True)
def _x64():
    with jax.enable_x64(True):
        yield


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    """(the port's (1, 1) mesh on a world-size-1 gloo group, JAX's (1, 1)
    mesh)."""
    torch.set_num_threads(1)
    init = tmp_path_factory.mktemp("pg") / "init"
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=0, world_size=1)
    try:
        yield pm.make_mesh((1, 1), ("row", "col"), device="cpu"), jmesh.make_mesh((1, 1), ("row", "col"))
    finally:
        dist.destroy_process_group()


def frame_operands(rng, D, M):
    """tests/test_parallel.py::_frame_operands, in numpy."""
    A = rng.normal(size=(D, D)) * 0.05
    P = A @ A.T + np.eye(D)
    x = np.zeros(D)
    x[3] = 1.0
    x[7:13] = rng.normal(size=6) * 0.1
    H = np.zeros((M, D))
    H[:, 13:13 + M] = np.eye(M)
    H[:, :13] = rng.normal(size=(M, 13)) * 0.1
    nu = rng.normal(size=M) * 0.01
    return x, P, H, nu, np.eye(M) * 1.2


def run_jax(jfn, jm, *args):
    with jm:
        return [np.asarray(a) for a in jfn(*(jnp.asarray(a) for a in args))]


def run_port(mesh, fn, x, P, *rest):
    """fn on the rank's blocks (the whole state on one rank), gathered."""
    xs, Ps = pm.shard_state(mesh, x, P)
    assert xs.shape == x.shape and Ps.shape == P.shape
    out = fn(xs, Ps, *(torch.as_tensor(a) for a in rest))
    return [a.numpy() for a in pm.gather_state(mesh, *out[:2])] + [a.numpy() for a in out[2:]]


def test_sharded_joint_update(meshes):
    mesh, jm = meshes
    rng = np.random.default_rng(42)
    D, M = 128, 8
    A = rng.normal(size=(D, D))
    P = A @ A.T + np.eye(D)
    x, H, nu, R = rng.normal(size=D), rng.normal(size=(M, D)), rng.normal(size=M), np.eye(M) * 1.2
    got = run_port(mesh, pm.sharded_joint_update(mesh, D, M), x, P, H, nu, R)
    want = run_jax(jmesh.sharded_joint_update(jm, D, M), jm, x, P, H, nu, R)
    dense = ekf.joint_update(*(torch.tensor(a) for a in (x, P, H, nu, R)), blas=True)
    for ref in (want, [a.numpy() for a in dense[:2]]):
        np.testing.assert_allclose(got[0], ref[0], rtol=1e-10)
        np.testing.assert_allclose(got[1], ref[1], rtol=1e-8, atol=1e-10)


def test_sharded_predict(meshes):
    mesh, jm = meshes
    rng = np.random.default_rng(42)
    D = jmesh.pad_for_mesh(13 + 6 * 10, 1, 1)
    x, P, _, _, _ = frame_operands(rng, D, 4)
    u = rng.normal(size=3) * 0.01
    got = run_port(mesh, pm.sharded_predict(mesh, D), x, P, u)
    want = run_jax(jmesh.sharded_predict(jm, D), jm, x, P, u)
    dense = ekf.predict(torch.tensor(x), torch.tensor(P), torch.tensor(u), 1 / 30.0, 4.0, 6.0)
    for ref in (want, [a.numpy() for a in dense]):
        np.testing.assert_allclose(got[0], ref[0], rtol=1e-12, atol=1e-15)
        np.testing.assert_allclose(got[1], ref[1], rtol=1e-12, atol=1e-15)
    # the same arithmetic as the unsharded predict on one rank: bit for bit
    np.testing.assert_array_equal(got[1], dense[1].numpy())


def test_sharded_slam_frame(meshes):
    mesh, jm = meshes
    rng = np.random.default_rng(42)
    D, M = pm.pad_for_mesh(13 + 6 * 20, 1, 1), 16
    x, P, H, nu, R = frame_operands(rng, D, M)
    u = np.zeros(3)
    got = run_port(mesh, pm.sharded_slam_frame(mesh, D, M), x, P, u, H, nu, R)
    want = run_jax(jmesh.sharded_slam_frame(jm, D, M), jm, x, P, u, H, nu, R)
    t = [torch.tensor(a) for a in (x, P, u, H, nu, R)]
    xd, Pd = ekf.predict(*t[:3], 1 / 30.0, 4.0, 6.0)
    xd, Pd, _ = ekf.joint_update(xd, Pd, *t[3:], blas=True)
    xd, Pd = ekf.normalise(xd, Pd)
    for ref in (want, [xd.numpy(), ekf.symmetrize(Pd).numpy()]):
        np.testing.assert_allclose(got[0], ref[0], rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(got[1], ref[1], rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("n_feat", [50, 500])
def test_sharded_stress_frame(meshes, n_feat):
    mesh, jm = meshes
    slot_dim, params = 6, Params()
    x, P, _ = _make_map_state(n_feat, slot_dim)
    u = np.zeros(3)
    frame = pm.sharded_stress_frame(mesh, params, n_feat, slot_dim, 10)
    jframe = jmesh.sharded_stress_frame(jm, JParams(), n_feat, slot_dim, 10)
    dense = _make_ekf_frame(params, n_feat, slot_dim)
    xs, Ps = pm.shard_state(mesh, x, P)
    xj, Pj = jnp.asarray(x), jnp.asarray(P)
    xd, Pd = torch.tensor(x), torch.tensor(P)
    for f in range(3):
        xs, Ps, top = frame(xs, Ps, torch.zeros(3, dtype=F64))
        with jm:
            xj, Pj, topj = jframe(xj, Pj, jnp.asarray(u))
        xd, Pd, topd = dense(xd, Pd)
        gx, gP = (a.numpy() for a in pm.gather_state(mesh, xs, Ps))
        for name, (rx, rP, rt) in (("jax", (np.asarray(xj), np.asarray(Pj), np.asarray(topj))),
                                   ("unsharded", (xd.numpy(), Pd.numpy(), topd.numpy()))):
            np.testing.assert_array_equal(top.numpy(), rt, err_msg=f"{name} frame {f}")
            np.testing.assert_allclose(gx, rx, rtol=1e-10, atol=1e-12, err_msg=f"{name} frame {f}")
            np.testing.assert_allclose(gP, rP, rtol=1e-8, atol=1e-10, err_msg=f"{name} frame {f}")


def test_make_mesh_refuses_what_it_cannot_run(meshes):
    """No fallback: a CUDA mesh on a gloo group, a mesh of the wrong size,
    a non-dividing D, blocks of the wrong shape."""
    mesh, _ = meshes
    with pytest.raises(RuntimeError, match="nccl"):
        pm.make_mesh((1, 1), ("row", "col"), device="cuda")
    with pytest.raises(ValueError, match="needs 4 ranks"):
        pm.make_mesh((2, 2), ("row", "col"), device="cpu")
    with pytest.raises(ValueError, match="takes x"):
        pm.sharded_predict(mesh, 20)(torch.zeros(21, dtype=F64), torch.zeros((21, 21), dtype=F64),
                                     torch.zeros(3, dtype=F64))
    with pytest.raises(ValueError, match="row.*col"):
        pm.sharded_predict(pm.make_mesh((1,), ("data",), device="cpu"), 20)
