"""The port stands alone: no JAX, CUDA by default, plain path only for CPU.

  - no module of scenelib2_torch/ and not chip_smoke.py imports jax,
    scenelib2_tpu or the tests (an AST scan, and a subprocess whose import
    system refuses those names imports the package and every entry-point
    module: the CLI, the I/O, the selftest, the bench suite, viz and the
    interactive session; steps 3 frames, calls the facade's manual inits,
    deletion and checkpoints, runs the batch step on each of its three
    routes and 2 frames of the split route);
  - MonoSLAM(cfg) and make_batched_step(params) without a device raise
    where CUDA is absent, on every batch route;
  - a kernel wrapper (K1-K14, K12 in both row forms, and K2 / K6 over
    lanes) given CPU tensors runs the plain version and launches nothing;
    given tensors on any other non-CUDA device it raises; when its kernel
    cannot be built it raises, never falling back to the plain version;
  - what is not ported is refused: the pure-XLA route (use_pallas=False),
    more than one partial slot, f64, a batch state without lanes.
"""

from __future__ import annotations

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from scenelib2_torch import MonoSLAM
from scenelib2_torch.config import Params
from scenelib2_torch.kernels import _build
from scenelib2_torch.kernels.bayes import BayesConsts, bayes_update, bayes_update_plain
from scenelib2_torch.kernels.chol_inv import chol_inv, chol_linv
from scenelib2_torch.kernels.ekf_update import (
    UpdateConsts,
    joint_update,
    joint_update_dense,
    joint_update_dense_plain,
    joint_update_plain,
)
from scenelib2_torch.kernels.multi_ellipse import multi_ellipse_search, multi_ellipse_search_plain
from scenelib2_torch.kernels.measure import (
    NOUT,
    MeasureConsts,
    measure_select,
    measure_select_plain,
)
from scenelib2_torch.kernels.correlate import gather_windows_u8
from scenelib2_torch.kernels.particle import (
    ParticleConsts,
    particle_predict,
    particle_predict_kform,
    particle_predict_kform_plain,
    particle_predict_plain,
)
from scenelib2_torch.kernels.particle_search import (
    ParticleSearchConsts,
    particle_search,
    particle_search_plain,
)
from scenelib2_torch.kernels.predict_measure import predict_measure, predict_measure_plain
from scenelib2_torch.kernels.propose import ProposeConsts, propose_region, propose_region_plain
from scenelib2_torch.kernels.score_map import ScoreMapConsts, score_map, score_map_plain
from scenelib2_torch.kernels.search import (
    SearchConsts,
    search,
    search_plain,
    search_window_origin,
    search_windows,
    search_windows_plain,
)
from scenelib2_torch.kernels.search_bayes import (
    SearchBayesConsts,
    search_bayes,
    search_bayes_maps,
    search_bayes_maps_plain,
    search_bayes_plain,
)
from scenelib2_torch.kernels.shi_tomasi import shi_tomasi, shi_tomasi_plain
from scenelib2_torch.parallel.mesh import make_batched_step
from scenelib2_torch.runtime.step import make_batch_step, make_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "scenelib2_tpu", "tests")
# the modules users start the system through
ENTRY_MODULES = ("scenelib2_torch.cli", "scenelib2_torch.io", "scenelib2_torch.io.sequence",
                 "scenelib2_torch.io.native", "scenelib2_torch.io.camera", "scenelib2_torch.eval.selftest",
                 "scenelib2_torch.eval.metrics", "scenelib2_torch.eval.benchmark", "scenelib2_torch.eval.viz",
                 "scenelib2_torch.eval.interactive")



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain path is hundreds of tiny tensor ops per frame: intra-op
    threads only contend with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_sources():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(os.path.join(REPO, "scenelib2_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(paths)


def test_no_source_imports_jax_or_the_jax_package():
    bad = []
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            bad += [(path, n) for n in names if n.split(".")[0] in FORBIDDEN]
    assert len(_port_sources()) > 15
    names = {os.path.relpath(p_, REPO) for p_ in _port_sources()}
    assert {m.replace(".", "/") + ".py" for m in ENTRY_MODULES if not m.endswith(".io")} <= names
    assert not bad, bad


_GUARDED_RUN = r"""
import importlib, importlib.abc, sys, tempfile
FORBIDDEN = ("jax", "jaxlib", "scenelib2_tpu", "tests")

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in FORBIDDEN:
            raise ImportError("refused: " + name)
        return None

sys.meta_path.insert(0, Refuse())
import chip_smoke  # noqa: F401
from scenelib2_torch import MonoSLAM
from scenelib2_torch.eval.synthetic import generate_dataset
for m in ENTRY_MODULES:
    importlib.import_module(m)
work = tempfile.mkdtemp()
frames, _, _, cfg = generate_dataset(work, n_frames=4)
slam = MonoSLAM(cfg, device="cpu")
for t in range(1, 4):
    slam.go_one_step(frames[t])                 # mapping on: stages 1-8
# the facade's calls between steps
slam.save_checkpoint(work + "/ck.npz")
slam.initialise_feature(frames[3], 160, 120)
slam.initialise_auto_feature(frames[3])
slam.mark_feature_by_lab(1)
assert slam.delete_feature()
slam.load_checkpoint(work + "/ck.npz")
# the batch step: two lanes of the same scene with their own random streams
import torch
from scenelib2_torch.eval import batch as _batch  # noqa: F401
from scenelib2_torch.parallel.mesh import make_batched_step, replicate_states, run_batch
traj_shape = slam.trajectory().shape
slam.reset()
import dataclasses
for p_, sb in ((slam.params, None), (slam.params, False), (dataclasses.replace(slam.params, batch_pallas=False), None)):
    step = make_batched_step(p_, device="cpu", batch_sb=sb)
    _states, outs = run_batch(step, replicate_states(slam.state, 2), frames[1:4, None].repeat(2, axis=1),
                              True, p_)
    assert outs.r.shape == (3, 2, 3) and bool(torch.isfinite(outs.r).all())
for m in ("correlate", "bayes", "particle_search", "search"):
    assert "scenelib2_torch.kernels." + m in sys.modules
# the split route (D > 384: K7, K2, K14 in kernels/chol_inv.py)
big = MonoSLAM(cfg, max_features=64, device="cpu")
for t in range(1, 3):
    big.go_one_step(frames[t])
assert "scenelib2_torch.kernels.chol_inv" in sys.modules
assert not any(m.split(".")[0] in FORBIDDEN for m in sys.modules)
print("OK", traj_shape)
"""


def test_package_runs_with_jax_refused():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    run = f"ENTRY_MODULES = {ENTRY_MODULES!r}\n" + _GUARDED_RUN
    res = subprocess.run([sys.executable, "-c", run], capture_output=True, text=True,
                         timeout=300, env=env, cwd=REPO)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "OK (3, 3)" in res.stdout


def test_default_device_is_cuda_and_raises_without_it(monkeypatch, data_dir):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MonoSLAM(os.path.join(data_dir, "SceneLib2.cfg"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_batched_step(Params())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_batched_step(Params(batch_pallas=False))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_batched_step(Params(), batch_sb=False)


def test_unported_batch_routes_are_refused():
    """batch_mode belongs to the batch step (reached through parallel.mesh);
    what is not ported is refused, not run some other way: the JAX step's
    pure-XLA route (use_pallas=False) by both step builders, a partial
    capacity above one, f64, and a single-stream state given to the batch
    step. Every batch route itself builds."""
    import dataclasses

    p = Params()
    with pytest.raises(NotImplementedError, match="make_batched_step"):
        make_step(dataclasses.replace(p, batch_mode=True), device="cpu")
    for builder in (make_step, make_batch_step, make_batched_step):
        with pytest.raises(NotImplementedError, match="use_pallas=False"):
            builder(dataclasses.replace(p, use_pallas=False), device="cpu")
    with pytest.raises(NotImplementedError, match="use_pallas=False"):
        make_batched_step(dataclasses.replace(p, use_pallas=False, batch_pallas=False), device="cpu")
    for kw in (dict(), dict(batch_pallas=False)):
        with pytest.raises(NotImplementedError):
            make_batch_step(dataclasses.replace(p, max_features_to_init_at_once=2, **kw), device="cpu")
        with pytest.raises(NotImplementedError):
            make_batch_step(dataclasses.replace(p, **kw), device="cpu", precision="f64")
    for kw, sb in ((dict(), None), (dict(), False), (dict(batch_pallas=False), None)):
        step = make_batched_step(dataclasses.replace(p, **kw), device="cpu", batch_sb=sb)
        with pytest.raises(ValueError, match="lane"):
            step(MonoSLAM(os.path.join(REPO, "data", "SceneLib2.cfg"), device="cpu").state,
                 torch.zeros((p.cam_height, p.cam_width), dtype=torch.uint8), True)


def _k1_args(rng, dev):
    MF, D = 16, 109
    x = np.zeros(D, np.float32)
    x[3], x[2] = 1.0, -0.8
    x[13:] = rng.uniform(-0.2, 0.2, D - 13)
    A = rng.normal(size=(D, D))
    P = ((A @ A.T / (4 * D) + np.eye(D)) * 1e-4).astype(np.float32)
    xpo = np.tile(x[:7], (MF, 1))
    act = rng.uniform(size=MF) > 0.2
    return tuple(torch.tensor(a, device=dev) for a in (x, P, xpo, act, ~act))


def _k2_args(rng, dev):
    p = Params()
    img = torch.tensor(rng.integers(0, 256, (p.cam_height, p.cam_width), dtype=np.uint8), device=dev)
    h = torch.tensor(rng.uniform(40, 200, (10, 2)), dtype=torch.float32, device=dev)
    u0, v0, uc, vc = search_window_origin(h, p.search_win_radius, p.cam_width, p.cam_height,
                                          p.boxsize)
    rows = torch.zeros((10, 128), device=dev)
    rows[:, :121] = torch.tensor(rng.integers(0, 256, (10, 121)), dtype=torch.float32)
    rows[:, 121] = rows[:, :121].sum(1)
    rows[:, 122] = (rows[:, :121] ** 2).sum(1)
    abc = torch.tensor([[0.05, 0.01, 0.04]] * 10, device=dev)
    return img, rows, u0, v0, uc, vc, abc, torch.ones(10, dtype=torch.bool, device=dev)


def _k3_args(rng, dev):
    MF, NSEL, D = 16, 10, 109
    A = rng.normal(size=(D, D))
    P = (A @ A.T / D * 1e-3 + np.eye(D) * 1e-4).astype(np.float32)
    x = (rng.normal(size=D) * 0.1).astype(np.float32)
    sel = rng.normal(size=(NOUT, NSEL)).astype(np.float32)
    sel[22] = 1.5
    top = rng.choice(MF, NSEL, replace=False).astype(np.int32)
    i32 = np.int32
    arrs = (x, P, sel, rng.normal(size=(NSEL, 2)).astype(np.float32), rng.uniform(size=NSEL) > 0.5,
            (13 + 6 * top).astype(i32), np.zeros(MF, i32), np.zeros(MF, i32), np.zeros(MF, bool),
            np.ones(MF, bool), np.arange(MF, dtype=i32), np.ones(NSEL, bool), top)
    return tuple(torch.tensor(a, device=dev) for a in arrs)


def _k5_args(rng, dev):
    MF, D = 16, 109
    x = np.zeros(D, np.float32)
    x[3], x[2] = 1.0, -0.8
    x[7:13] = rng.normal(0, 0.3, 6)
    x[13:] = rng.uniform(-0.2, 0.2, D - 13)
    act = rng.uniform(size=MF) > 0.3
    full = rng.uniform(size=MF) > 0.2
    return (torch.tensor(x, device=dev), torch.tensor([0x330E, 0, 0], dtype=torch.int32, device=dev),
            torch.tensor(act, device=dev), torch.tensor(full, device=dev), torch.tensor(0.3, device=dev),
            torch.tensor(4, dtype=torch.int32, device=dev))


def _k6_args(rng, dev):
    p = Params()
    img = torch.tensor(rng.integers(0, 256, (p.cam_height, p.cam_width), dtype=np.uint8), device=dev)
    b = [torch.tensor(v, dtype=torch.int32, device=dev) for v in (100, 80, 180, 140)]
    return (img, *b)


def _k4_args(rng, dev):
    p = Params()
    MF, NP = 16, p.n_particles
    img = torch.tensor(rng.integers(0, 256, (p.cam_height, p.cam_width), dtype=np.uint8), device=dev)
    shared = np.zeros(56, np.float32)
    shared[3] = 1.0
    shared[7:] = (np.eye(7) * 1e-4).reshape(-1)
    slot = np.zeros(84, np.float32)
    slot[5] = 1.0
    slot[48:] = (np.eye(6) * 1e-4).reshape(-1)
    row = np.zeros(128, np.float32)
    row[:121] = rng.integers(0, 256, 121)
    row[121], row[122] = row[:121].sum(), (row[:121] ** 2).sum()
    f = dict(dtype=torch.float32, device=dev)
    return (img, torch.full((MF, NP), 0.01, **f),
            torch.tensor(np.tile(np.linspace(0.5, 5.0, NP), (MF, 1)), **f),
            torch.ones((MF, NP), dtype=torch.bool, device=dev),
            torch.tensor([True], device=dev), torch.tensor([True], device=dev),
            torch.tensor([2], dtype=torch.int32, device=dev), torch.tensor([3], dtype=torch.int32, device=dev),
            torch.tensor(row, **f), torch.tensor(shared, **f), torch.tensor(slot, **f))


def _k14_args(rng, dev):
    A = rng.normal(size=(2, 20, 20))
    return torch.tensor(A @ A.transpose(0, 2, 1) / 20 + np.eye(20), dtype=torch.float32, device=dev)


N_L = 3     # lanes of the batch-wrapper cases


def _lanes(fn, rng, dev):
    """fn's single-lane arguments for N_L lanes, stacked."""
    return tuple(torch.stack(ts) for ts in zip(*(fn(rng, dev) for _ in range(N_L))))


def _k7_args(rng, dev):
    x, P, xpo, act, _ = _lanes(_k1_args, rng, dev)
    return x, P, xpo, act, torch.ones_like(act), 10


def _k9_args(rng, dev):
    p = Params()
    imgs = torch.tensor(rng.integers(0, 256, (N_L, p.cam_height, p.cam_width), dtype=np.uint8), device=dev)
    return imgs, torch.stack([_k4_args(rng, dev)[8] for _ in range(N_L)])[:, None]


def _k10_args(rng, dev):
    a = [_k4_args(rng, dev) for _ in range(N_L)]
    return (torch.stack([t[9] for t in a]), torch.stack([t[10] for t in a])[:, None],
            torch.stack([t[2][3] for t in a])[:, None])


def _k11_args(rng, dev):
    p = Params()
    NP = p.n_particles
    f = dict(dtype=torch.float32, device=dev)
    maps = torch.tensor(rng.uniform(0.0, 2.0, (N_L, 1, p.cam_height, p.cam_width)), **f)
    if dev.type == "cpu":
        pred = particle_predict_plain(*_k10_args(rng, dev), ParticleConsts.from_params(p))
    else:
        pred = torch.zeros((N_L, 1, 8, 128), **f)
    return (maps, pred, torch.full((N_L, 1, NP), 0.01, **f),
            torch.tensor(np.tile(np.linspace(0.5, 5.0, NP), (N_L, 1, 1)), **f),
            torch.ones((N_L, 1, NP), dtype=torch.bool, device=dev),
            torch.ones((N_L, 1), dtype=torch.bool, device=dev),
            torch.ones((N_L, 1), dtype=torch.bool, device=dev),
            torch.full((N_L, 1), 2, dtype=torch.int32, device=dev))


def _k8_args(rng, dev):
    img, rows, u0, v0, _uc, _vc, abc, act = _k2_args(rng, dev)
    h = torch.stack([u0, v0], -1).to(torch.float32) + 32.3
    patches = rows[:, :121].reshape(10, 11, 11).to(torch.uint8)
    wins = gather_windows_u8(img[None], u0[None], v0[None], Params().search_win_radius, 11)[0]
    return wins, patches, u0, v0, h, abc, act


def _k12_args(rng, dev, pred_form: bool):
    p = Params()
    NP = p.n_particles
    f = dict(dtype=torch.float32, device=dev)
    base = [torch.full((N_L, NP), 0.01, **f),
            torch.tensor(np.tile(np.linspace(0.5, 5.0, NP), (N_L, 1)), **f),
            torch.ones((N_L, NP), dtype=torch.bool, device=dev),
            torch.tensor(rng.uniform(size=(N_L, NP)) > 0.5, device=dev),
            torch.zeros((N_L, NP), dtype=torch.bool, device=dev),
            torch.tensor(rng.uniform(100, 110, (N_L, NP, 2)), **f)]
    if pred_form:
        geo = [None, None, None]
    else:
        geo = [torch.tensor(rng.uniform(100, 110, (N_L, NP, 2)), **f),
               torch.tensor(np.tile([[0.05, 0.01], [0.01, 0.04]], (N_L, NP, 1, 1)), **f),
               torch.full((N_L, NP), 500.0, **f)]
    flags = [torch.ones(N_L, dtype=torch.bool, device=dev), torch.ones(N_L, dtype=torch.bool, device=dev),
             torch.full((N_L,), 2, dtype=torch.int32, device=dev)]
    pred = dict(pred_rows=torch.tensor(rng.uniform(0.01, 1.0, (N_L, 8, 128)), **f)) if pred_form else {}
    return (*base, *geo, *flags, BayesConsts.from_params(p)), pred


def _k13_args(rng, dev):
    p = Params()
    NP = p.n_particles
    f = dict(dtype=torch.float32, device=dev)
    return (torch.tensor(rng.uniform(0.0, 2.0, (N_L, 1, p.cam_height, p.cam_width)), **f),
            torch.tensor(rng.uniform(90, 130, (N_L, 1, NP, 2)), **f),
            torch.tensor(np.tile([[0.05, 0.01], [0.01, 0.04]], (N_L, 1, NP, 1, 1)), **f),
            torch.ones((N_L, 1, NP), dtype=torch.bool, device=dev))


def _k10b_args(rng, dev):
    from scenelib2_torch.kernels.particle import geometry_prologue

    a = _k10_args(rng, torch.device("cpu"))
    zr, zh, K0, Ks, K2 = geometry_prologue(a[0][:, None], a[1])
    return tuple(t.reshape(N_L, *t.shape[2:]).to(dev) for t in (torch.cat([zr, zh], -1), K0, Ks, K2, a[2]))


def _k15_args(rng, dev):
    x, P = _k3_args(rng, dev)[:2]
    D, M = x.shape[0], 6
    H = torch.tensor(rng.normal(size=(M, D)) * 0.1, dtype=torch.float32, device=dev)
    keep = torch.ones(D, dtype=torch.bool, device=dev)
    keep[-6:] = False
    return (x, P, H, torch.tensor(rng.normal(size=M), dtype=torch.float32, device=dev),
            torch.eye(M, device=dev), torch.tensor(True, device=dev), keep)


def _k16_args(rng, dev):
    a = _k13_args(rng, dev)
    return a[0][:, 0], a[1][:, 0], a[2][:, 0], a[3][:, 0]


def _cases():
    p = Params()
    k1kw = dict(nsel=10, maxp=1, dt=p.delta_t, sd_a=p.sd_a, sd_alpha=p.sd_alpha,
                consts=MeasureConsts.from_params(p))
    st_kw = dict(boxsize=p.boxsize, region_w=p.init_search_width, region_h=p.init_search_height)
    return {
        "K1": (lambda d, r: predict_measure(*_k1_args(r, d), **k1kw),
               lambda d, r: predict_measure_plain(*_k1_args(r, d), **k1kw)),
        "K2": (lambda d, r: search(*_k2_args(r, d), SearchConsts.from_params(p)),
               lambda d, r: search_plain(*_k2_args(r, d), SearchConsts.from_params(p))),
        "K3": (lambda d, r: joint_update(*_k3_args(r, d), UpdateConsts.from_params(p)),
               lambda d, r: joint_update_plain(*_k3_args(r, d), UpdateConsts.from_params(p))),
        "K4": (lambda d, r: search_bayes(*_k4_args(r, d), SearchBayesConsts.from_params(p)),
               lambda d, r: search_bayes_plain(*_k4_args(r, d), SearchBayesConsts.from_params(p))),
        "K5": (lambda d, r: propose_region(*_k5_args(r, d), ProposeConsts.from_params(p)),
               lambda d, r: propose_region_plain(*_k5_args(r, d), ProposeConsts.from_params(p))),
        "K6": (lambda d, r: shi_tomasi(*_k6_args(r, d), **st_kw),
               lambda d, r: shi_tomasi_plain(*_k6_args(r, d), **st_kw)),
        "K7": (lambda d, r: measure_select(*_k7_args(r, d), MeasureConsts.from_params(p), rows=True),
               lambda d, r: measure_select_plain(*_k7_args(r, d), MeasureConsts.from_params(p), rows=True)),
        "K9": (lambda d, r: (score_map(*_k9_args(r, d), ScoreMapConsts.from_params(p)),),
               lambda d, r: (score_map_plain(*_k9_args(r, d), ScoreMapConsts.from_params(p)),)),
        "K10": (lambda d, r: (particle_predict(*_k10_args(r, d), ParticleConsts.from_params(p)),),
                lambda d, r: (particle_predict_plain(*_k10_args(r, d), ParticleConsts.from_params(p)),)),
        "K11": (lambda d, r: search_bayes_maps(*_k11_args(r, d), SearchBayesConsts.from_params(p)),
                lambda d, r: search_bayes_maps_plain(*_k11_args(r, d), SearchBayesConsts.from_params(p))),
        "K14": (lambda d, r: (chol_inv(_k14_args(r, d)),), lambda d, r: (chol_linv(_k14_args(r, d)),)),
        "K10b": (lambda d, r: particle_predict_kform(*_k10b_args(r, d)),
                 lambda d, r: particle_predict_kform_plain(*_k10b_args(r, d))),
        "K15": (lambda d, r: joint_update_dense(*_k15_args(r, d)),
                lambda d, r: joint_update_dense_plain(*_k15_args(r, d))),
        "K16": (lambda d, r: multi_ellipse_search(*_k16_args(r, d), win_radius=p.particle_win_radius),
                lambda d, r: multi_ellipse_search_plain(*_k16_args(r, d), win_radius=p.particle_win_radius)),
        "K8": (lambda d, r: search_windows(*_k8_args(r, d), SearchConsts.from_params(p)),
               lambda d, r: search_windows_plain(*_k8_args(r, d), SearchConsts.from_params(p))),
        "K12": (lambda d, r: bayes_update(*_k12_args(r, d, False)[0]),
                lambda d, r: bayes_update_plain(*_k12_args(r, d, False)[0])),
        "K12 pred rows": (lambda d, r: bayes_update(*_k12_args(r, d, True)[0], **_k12_args(r, d, True)[1]),
                          lambda d, r: bayes_update_plain(*_k12_args(r, d, True)[0], **_k12_args(r, d, True)[1])),
        "K13": (lambda d, r: particle_search(*_k13_args(r, d), ParticleSearchConsts.from_params(p)),
                lambda d, r: particle_search_plain(*_k13_args(r, d), ParticleSearchConsts.from_params(p))),
        # K2 and K6 over lanes: one launch for all lanes, the plain version lane by lane
        "K2 lanes": (lambda d, r: search(*_lanes(_k2_args, r, d), SearchConsts.from_params(p)),
                     lambda d, r: _per_lane(
                         lambda *a: search_plain(*a, SearchConsts.from_params(p)), _lanes(_k2_args, r, d))),
        "K6 lanes": (lambda d, r: shi_tomasi(*_lanes(_k6_args, r, d), **st_kw),
                     lambda d, r: _per_lane(
                         lambda *a: shi_tomasi_plain(*a, **st_kw), _lanes(_k6_args, r, d))),
    }


def _per_lane(fn, args):
    return tuple(torch.stack(o) for o in zip(*(fn(*(t[b] for t in args)) for b in range(N_L))))


KERNELS = ["K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8", "K9", "K10", "K11", "K12", "K12 pred rows",
           "K13", "K14", "K2 lanes", "K6 lanes", "K10b", "K15", "K16"]


@pytest.mark.parametrize("kernel", KERNELS)
def test_wrapper_takes_plain_path_only_for_cpu_tensors(kernel):
    wrapper, plain = _cases()[kernel]
    _build.reset_launches()
    got = wrapper(torch.device("cpu"), np.random.default_rng(1))
    want = plain(torch.device("cpu"), np.random.default_rng(1))
    for g, w in zip(got, want):
        assert torch.equal(g, w) or (g.is_floating_point() and torch.equal(g.isnan(), w.isnan()))
    assert all(v == 0 for v in _build.launches.values())
    # a tensor on another device is neither run plain nor launched: it raises
    with pytest.raises(ValueError, match="CUDA"):
        wrapper(torch.device("meta"), np.random.default_rng(1))
    assert all(v == 0 for v in _build.launches.values())


@pytest.mark.parametrize("kernel", ["K4", "K5", "K6", "K7", "K8", "K9", "K10", "K11", "K12",
                                    "K12 pred rows", "K13", "K14", "K2 lanes", "K6 lanes", "K10b", "K15",
                                    "K16"])
def test_wrapper_raises_when_its_kernel_cannot_be_built(kernel, monkeypatch, tmp_path):
    """A non-CPU request whose kernel cannot be built (no CUDA toolkit)
    raises; the wrapper never answers with its plain version instead."""
    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "find_nvcc", no_nvcc)
    monkeypatch.setattr(_build, "check_tensor", lambda *a, **k: None)
    monkeypatch.setattr(_build, "_libs", {})
    wrapper, _plain = _cases()[kernel]
    _build.reset_launches()
    with pytest.raises(RuntimeError, match="nvcc"):
        wrapper(torch.device("meta"), np.random.default_rng(1))
    assert all(v == 0 for v in _build.launches.values())
