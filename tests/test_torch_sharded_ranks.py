"""The sharded-covariance EKF (parallel/mesh.py) over several ranks: gloo
process groups of 4 ranks on a (2, 2) mesh and of 8 ranks on JAX's test
mesh (4, 2), spawned with torch.multiprocessing (one torch thread each, a
file:// rendezvous, a time limit of TIME_LIMIT seconds a spawn). Each rank
runs the four sharded functions on its blocks at tests/test_parallel.py's
sizes (joint update D = 128, M = 8; predict D = pad(73); the frame D =
pad(133), M = 16, and at the stress500 shape D = pad(3013), M = 20; the
stress frame with the real assembly at D = pad(13 + 6 * 50), three chained
frames), and rank 0 holds the gathered result to the port's unsharded
composition (core.ekf; eval.benchmark._make_ekf_frame) at the JAX package's
bars: joint update x rtol 1e-10, P rtol 1e-8 / atol 1e-10; predict rtol
1e-12 / atol 1e-15; frame x rtol 1e-12 / atol 1e-14, P rtol 1e-9 / atol
1e-12 (stress500 shape x 1e-11 / 1e-13, P 1e-8 / 1e-11); stress frame
top_idx exact, x rtol 1e-10 / atol 1e-12, P rtol 1e-8 / atol 1e-10. Pad
rows and columns stay exact zeros. Every rank takes and returns its
[D/rows, D/cols] block of P, and no collective of a frame moves more than
max(13, M) D numbers (the camera rows, the strip of P H', W), nor a
point-to-point piece more than one block (symmetrize's transpose).
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tests.torch_spawn import spawn

TIME_LIMIT = 300
MESHES = [(2, 2), (4, 2)]
FUNCTIONS = ["joint_update", "predict", "slam_frame", "slam_frame_3013", "stress_frame"]
TOL = {"joint_update": ((1e-10, 0.0), (1e-8, 1e-10)), "predict": ((1e-12, 1e-15), (1e-12, 1e-15)),
       "slam_frame": ((1e-12, 1e-14), (1e-9, 1e-12)), "slam_frame_3013": ((1e-11, 1e-13), (1e-8, 1e-11)),
       "stress_frame": ((1e-10, 1e-12), (1e-8, 1e-10))}


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


class Traffic:
    """The largest operand of each kind of collective while on."""

    def __init__(self):
        self.on, self.reduce, self.p2p = False, 0, 0
        self._ar, self._ag, self._b = dist.all_reduce, dist.all_gather, dist.batch_isend_irecv

        def all_reduce(t, *a, **k):
            if self.on:
                self.reduce = max(self.reduce, t.numel())
            return self._ar(t, *a, **k)

        def all_gather(parts, t, *a, **k):
            if self.on:
                self.reduce = max(self.reduce, t.numel() * len(parts))
            return self._ag(parts, t, *a, **k)

        def batch(ops):
            if self.on:
                self.p2p = max([self.p2p] + [op.tensor.numel() for op in ops])
            return self._b(ops)

        dist.all_reduce, dist.all_gather, dist.batch_isend_irecv = all_reduce, all_gather, batch


def _rank(rank, world, shape, init, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    try:
        _run_rank(rank, shape, out_dir)
    finally:
        dist.destroy_process_group()


def _run_rank(rank, shape, out_dir):
    from scenelib2_torch.config import Params
    from scenelib2_torch.core import ekf
    from scenelib2_torch.eval.benchmark import _make_ekf_frame, _make_map_state
    from scenelib2_torch.parallel import mesh as pm

    traffic = Traffic()
    mesh = pm.make_mesh(shape, ("row", "col"), device="cpu")
    rows, cols = shape
    t = lambda a: torch.as_tensor(a)  # noqa: E731
    report, arrays = {}, {}

    def sharded(name, fn, x, P, *rest, frames=1):
        """fn over frames chained frames on this rank's blocks; (gathered x,
        P, the last extra outputs)."""
        D = x.shape[0]
        b = pm.block_of(mesh, D)
        xs, Ps = pm.shard_state(mesh, x, P)
        shapes = [list(Ps.shape)]
        tops = []
        traffic.on, traffic.reduce, traffic.p2p = True, 0, 0
        for _ in range(frames):
            out = fn(xs, Ps, *(t(a) for a in rest))
            xs, Ps = out[:2]
            shapes.append(list(Ps.shape))
            tops += [o.tolist() for o in out[2:]]
        traffic.on = False
        report[name] = dict(shapes=shapes, block=[b.Dr, b.Dc], x_len=int(xs.shape[0]), D=D,
                            reduce=traffic.reduce, p2p=traffic.p2p)
        gx, gP = pm.gather_state(mesh, xs, Ps)
        return gx.numpy(), gP.numpy(), tops

    def keep(name, got, want):
        if rank == 0:
            for k, (g, w) in enumerate(zip(got, want)):
                arrays[f"{name}/got{k}"], arrays[f"{name}/want{k}"] = np.asarray(g), np.asarray(w)

    rng = np.random.default_rng(42)
    D, M = 128, 8
    A = rng.normal(size=(D, D))
    ops = (rng.normal(size=D), A @ A.T + np.eye(D), rng.normal(size=(M, D)), rng.normal(size=M), np.eye(M) * 1.2)
    got = sharded("joint_update", pm.sharded_joint_update(mesh, D, M), *ops)
    keep("joint_update", got[:2], ekf.joint_update(*(t(a) for a in ops), blas=True)[:2] if rank == 0 else ())

    D = pm.pad_for_mesh(13 + 6 * 10, rows, cols)
    x, P, _, _, _ = frame_operands(np.random.default_rng(42), D, 4)
    u = np.random.default_rng(7).normal(size=3) * 0.01
    got = sharded("predict", pm.sharded_predict(mesh, D), x, P, u)
    keep("predict", got[:2], ekf.predict(t(x), t(P), t(u), 1 / 30.0, 4.0, 6.0) if rank == 0 else ())

    for name, live, M in (("slam_frame", 13 + 6 * 20, 16), ("slam_frame_3013", 13 + 6 * 500, 20)):
        D = pm.pad_for_mesh(live, rows, cols)
        x, P, H, nu, R = frame_operands(np.random.default_rng(42), D, M)
        u = np.zeros(3)
        got = sharded(name, pm.sharded_slam_frame(mesh, D, M), x, P, u, H, nu, R)
        want = ()
        if rank == 0:
            xd, Pd = ekf.predict(t(x), t(P), t(u), 1 / 30.0, 4.0, 6.0)
            xd, Pd, _ = ekf.joint_update(xd, Pd, t(H), t(nu), t(R), blas=True)
            xd, Pd = ekf.normalise(xd, Pd)
            want = (xd, ekf.symmetrize(Pd))
        keep(name, got[:2], want)

    n_feat, slot_dim = 50, 6
    live = 13 + slot_dim * n_feat
    D = pm.pad_for_mesh(live, rows, cols)
    x0, P0, _ = _make_map_state(n_feat, slot_dim)
    x, P = np.zeros(D), np.zeros((D, D))
    x[:live], P[:live, :live] = x0, P0
    got = sharded("stress_frame", pm.sharded_stress_frame(mesh, Params(), n_feat, slot_dim, 10), x, P, np.zeros(3),
                  frames=3)
    if rank == 0:
        dense = _make_ekf_frame(Params(), n_feat, slot_dim)
        xd, Pd, tops = t(x), t(P), []
        for _ in range(3):
            xd, Pd, top = dense(xd, Pd)
            tops.append(top.tolist())
        keep("stress_frame", got[:2] + (np.asarray(got[2]),), (xd, Pd, np.asarray(tops)))
        report["stress_frame"]["live"] = live
        np.savez(os.path.join(out_dir, "arrays.npz"), **arrays)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)


@pytest.fixture(scope="module", params=MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def ranks(request, tmp_path_factory):
    shape = request.param
    out = tmp_path_factory.mktemp(f"mesh{shape[0]}x{shape[1]}")
    world = shape[0] * shape[1]
    spawn(_rank, world, (shape, f"file://{out}/init", str(out)), TIME_LIMIT)
    reports = []
    for r in range(world):
        with open(out / f"rank{r}.json") as f:
            reports.append(json.load(f))
    with np.load(out / "arrays.npz") as z:
        arrays = {k: z[k] for k in z.files}
    return shape, reports, arrays


@pytest.mark.parametrize("name", FUNCTIONS)
def test_sharded_matches_the_unsharded_port(ranks, name):
    shape, reports, arrays = ranks
    (xr, xa), (pr, pa) = TOL[name]
    np.testing.assert_allclose(arrays[f"{name}/got0"], arrays[f"{name}/want0"], rtol=xr, atol=xa, err_msg=name)
    np.testing.assert_allclose(arrays[f"{name}/got1"], arrays[f"{name}/want1"], rtol=pr, atol=pa, err_msg=name)
    if name == "stress_frame":
        np.testing.assert_array_equal(arrays[f"{name}/got2"], arrays[f"{name}/want2"])
        live = reports[0][name]["live"]
        x, P = arrays[f"{name}/got0"], arrays[f"{name}/got1"]
        assert x.shape[0] > live and not x[live:].any() and not P[live:].any() and not P[:, live:].any()


@pytest.mark.parametrize("name", FUNCTIONS)
def test_every_rank_holds_its_block_and_moves_no_more(ranks, name):
    shape, reports, _ = ranks
    rows, cols = shape
    M = {"joint_update": 8, "predict": 0, "slam_frame": 16, "slam_frame_3013": 20, "stress_frame": 20}[name]
    for r, rep in enumerate(reports):
        rep = rep[name]
        D = rep["D"]
        assert rep["block"] == [D // rows, D // cols]
        assert all(s == rep["block"] for s in rep["shapes"]), (r, rep["shapes"])
        assert rep["x_len"] == D // rows
        assert 0 < rep["reduce"] <= max(13, M) * D, (r, rep)
        assert rep["p2p"] <= (D // rows) * (D // cols), (r, rep)
    if name not in ("predict", "joint_update"):
        assert any(rep[name]["p2p"] > 0 for rep in reports)    # the transpose crossed ranks
