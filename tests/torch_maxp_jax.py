"""Shared by the tests that hold the port at max_features_to_init_at_once = 2
(two partial features at a time) against the JAX step
(tests/test_torch_maxp_*.py).

At MAXP 2 the JAX step takes stage 8's non-fused arm on every route
(scenelib2_tpu/runtime/step.py:591-623, 916-918, 1017-1026, 1120-1152):
whole-frame score maps of both partial slots, the particle predict kernel on
both slots' rows, the search + Bayes kernel in compact mode, then
convert_feature for slot 0 and slot 1 in that order and one delete_mask. The
port runs the batch default route's stage 8 (runtime/step.py::make_stage8),
on the single stream with the state as one lane.

What is compared, frame by frame: every decision field, the selection as a
(slot, matched) set, the init box, the partial slots and their masks
(par_slot, par_mask, par_alive) exactly; the particle rows par_h and
par_sinv only where par_alive (a padding slot's rows are predicted from a
slot that is no ray), within rows_rtol of each field's largest such entry;
r and xv within step_tol.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np

from scenelib2_torch.eval.fingerprint import DECISION_FIELDS, selection_set

STEP_TOL = 1e-4
ROWS_RTOL = 1e-3
F64_TOL = 1e-8
EXACT_FIELDS = ("init_box", "par_slot", "par_mask", "par_alive")
MAXP2 = dict(max_features_to_init_at_once=2)


def both_searched(outs) -> np.ndarray:
    """The output indices at which both partial slots were searched."""
    pm = outs["par_mask"] if isinstance(outs, dict) else np.asarray(outs.par_mask)
    return np.flatnonzero(pm.reshape(pm.shape[0], -1, pm.shape[-1]).all(-1).any(-1))


def assert_same_maxp_run(got, want: dict, what: str, step_tol: float = STEP_TOL,
                         rows_rtol: float = ROWS_RTOL, xv: str = "xv"):
    """got (the port's StepOutputs with a time axis) against the JAX step's
    outputs (a dict of arrays), as the module docstring says; xv="q" holds
    the quaternion where the outputs carry no xv comparison."""
    for name in DECISION_FIELDS:
        np.testing.assert_array_equal(getattr(got, name).numpy().astype(np.int64),
                                      want[name].astype(np.int64), err_msg=f"{what}: {name}")
    np.testing.assert_array_equal(selection_set(got), selection_set(SimpleNamespace(**want)), err_msg=what)
    for name in EXACT_FIELDS:
        np.testing.assert_array_equal(getattr(got, name).numpy(), want[name], err_msg=f"{what}: {name}")
    alive = want["par_alive"]
    for name in ("par_h", "par_sinv"):
        g, w = getattr(got, name).numpy()[alive], want[name][alive]
        if w.size:
            np.testing.assert_allclose(g, w, rtol=0, atol=rows_rtol * np.abs(w).max(),
                                       err_msg=f"{what}: {name} of the alive particles")
    for k in ("r", xv):
        np.testing.assert_allclose(getattr(got, k).numpy(), want[k], rtol=0, atol=step_tol,
                                   err_msg=f"{what}: {k}")
