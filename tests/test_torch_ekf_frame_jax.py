"""The five large-map EKF benches' frames (eval/benchmark.py) against the
JAX package's _make_realistic_ekf_step at full width, in process with x64
on: stress500 (D = 3013, f64), stress500packed (D = 1513), stress500f32,
ekf100 (D = 613, no predict) and ekf100f32, three chained frames from
_make_map_state's state (bit for bit the JAX package's arrays).

  top_idx        exact, every frame (JAX's from its measurement_assembly on
                 its own predicted state)
  f64            x rtol 1e-10 / atol 1e-12, P rtol 1e-8 / atol 1e-10 (the
                 JAX package's own bars, tests/test_parallel.py)
  f32            x within 1e-5 of max |x|, P within 1e-4 of max |P|; the
                 largest differences seen are 2.2e-7 and 1.3e-5 of them (the
                 D-sized products sum in other orders: XLA's dot against
                 torch.matmul)

The bench functions run at a few steps on the CPU and report JAX's metric
names, units and detail fields, and launch no kernel.
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
from scenelib2_tpu.eval import benchmark as jbench
from scenelib2_tpu.runtime.assembly import measurement_assembly as jax_assembly
from scenelib2_torch.config import Params
from scenelib2_torch.core import ekf
from scenelib2_torch.core.quaternion import mm_seq
from scenelib2_torch.eval import benchmark

FRAMES = 3
# bench: (n_feat, slot_dim, predict, dtype, metric)
BENCHES = {
    "stress500": (500, 6, True, "float64", "ekf_predict_update_ms_500feat"),
    "stress500packed": (500, 3, True, "float64", "ekf_predict_update_ms_500feat_packed3"),
    "stress500f32": (500, 6, True, "float32", "ekf_predict_update_ms_500feat_f32"),
    "ekf100": (100, 6, False, "float64", "ekf_update_ms_100feat"),
    "ekf100f32": (100, 6, False, "float32", "ekf_update_ms_100feat_f32"),
}


@pytest.fixture(autouse=True)
def _x64():
    with jax.enable_x64(True):
        yield


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_top(x, P, n_feat, slot_dim, predict):
    p = JParams()
    if predict:
        x, P = jekf.predict(x, P, jnp.zeros(3), p.delta_t, p.sd_a, p.sd_alpha)
    return np.asarray(jax_assembly(JCam.from_params(p), x, P, n_feat, slot_dim, 10)[2])


@pytest.mark.parametrize("bench", list(BENCHES))
def test_bench_frame_matches_jax_over_three_frames(bench):
    n_feat, slot_dim, predict, dtype, _ = BENCHES[bench]
    x0, P0, _ = benchmark._make_map_state(n_feat, slot_dim)
    jstep = jax.jit(jbench._make_realistic_ekf_step(JParams(), n_feat, slot_dim, predict=predict))
    frame = benchmark._make_ekf_frame(Params(), n_feat, slot_dim, predict=predict)
    xj, Pj = jnp.asarray(x0.astype(dtype)), jnp.asarray(P0.astype(dtype))
    x, P = torch.tensor(x0, dtype=getattr(torch, dtype)), torch.tensor(P0, dtype=getattr(torch, dtype))
    for f in range(FRAMES):
        topj = jax_top(xj, Pj, n_feat, slot_dim, predict)
        xj, Pj = jstep(xj, Pj)
        x, P, top = frame(x, P)
        assert x.dtype == P.dtype == getattr(torch, dtype)
        want_x, want_P = np.asarray(xj), np.asarray(Pj)
        np.testing.assert_array_equal(top.numpy(), topj, err_msg=f"{bench} frame {f}")
        if dtype == "float64":
            np.testing.assert_allclose(x.numpy(), want_x, rtol=1e-10, atol=1e-12, err_msg=f"{bench} frame {f}")
            np.testing.assert_allclose(P.numpy(), want_P, rtol=1e-8, atol=1e-10, err_msg=f"{bench} frame {f}")
        else:
            np.testing.assert_allclose(x.numpy(), want_x, rtol=0, atol=1e-5 * np.abs(want_x).max(),
                                       err_msg=f"{bench} frame {f}")
            np.testing.assert_allclose(P.numpy(), want_P, rtol=0, atol=1e-4 * np.abs(want_P).max(),
                                       err_msg=f"{bench} frame {f}")


@pytest.mark.parametrize("shape", [(500, 6), (500, 3), (100, 6), (50, 6)])
def test_map_state_is_the_jax_packages_bit_for_bit(shape):
    for a, b in zip(benchmark._make_map_state(*shape), jbench._make_map_state(*shape)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_realistic_step_is_the_frame_without_top_idx():
    x0, P0, _ = benchmark._make_map_state(20, 6)
    x, P = torch.tensor(x0), torch.tensor(P0)
    a = benchmark._make_realistic_ekf_step(Params(), 20, 6)(x, P)
    b = benchmark._make_ekf_frame(Params(), 20, 6)(x, P)
    assert len(a) == 2 and torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_joint_update_default_takes_mm_seq_and_blas_takes_matmul():
    """joint_update's default keeps its mm_seq products (every existing
    route's bits); blas=True is the same composition through torch.matmul."""
    rng = np.random.default_rng(3)
    D, M = 40, 6
    A = rng.normal(size=(D, D))
    P = torch.tensor(A @ A.T + np.eye(D))
    x, H = torch.tensor(rng.normal(size=D)), torch.tensor(rng.normal(size=(M, D)))
    nu, R = torch.tensor(rng.normal(size=M)), torch.eye(M, dtype=torch.float64) * 1.2
    for mm, kw in ((mm_seq, {}), (torch.matmul, dict(blas=True))):
        S = mm(mm(H, P), H.mT) + R
        Linv = ekf.tril_inv_unrolled(ekf.chol_unrolled(S))
        W = mm(mm(P, H.mT), mm(Linv.mT, Linv))
        got = ekf.joint_update(x, P, H, nu, R, **kw)
        for g, w in zip(got, (x + mm(W, nu[:, None])[:, 0], P - mm(mm(W, S), W.mT), S)):
            assert torch.equal(g, w), kw


@pytest.mark.parametrize("bench", list(BENCHES))
def test_bench_reports_jax_fields_on_the_cpu(bench):
    n_feat, slot_dim, predict, dtype, metric = BENCHES[bench]
    fn = benchmark.ALL_BENCHES[bench]
    r = fn(n_steps=1, device="cpu") if bench.startswith("ekf") else fn(n_steps=1, n_feat=40, device="cpu")
    n = n_feat if bench.startswith("ekf") else 40
    assert r["metric"] == metric and r["unit"] == "ms/step" and r["value"] > 0
    assert (r["state_dim"], r["slot_dim"], r["dtype"]) == (13 + slot_dim * n, slot_dim, dtype)
    assert r["assembly"] == "real (predict+Si+topk+H/R/nu pack+update+normalise+symmetrize)"
    assert r["card"] == "cpu" and r["tf32"] is False and r["steps"] == 1
