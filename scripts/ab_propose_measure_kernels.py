"""A/B of K5 (the init-region proposal) and K7 (the measurement chain and selection) between source trees on one card.

    python3 scripts/ab_propose_measure_kernels.py TREE_A TREE_B TREE_B TREE_A

Each TREE is the root of a checkout of this repo (`.` for the working tree;
unpack another commit with `git archive` into a directory that .gitignore
lists). For each TREE, in the order given, a subprocess imports that tree's
scenelib2_torch, builds its kernels there and reports, on the same seeded
inputs, each case's device time and a sha256 of its outputs
(scripts/ab_kernels.py; the first line printed is the card's name and
power limit). The cases are the shapes the main paths give the kernels:

  K5 as stage 7 runs it (the gate, the proposal, the region's clamp and
    the init box: the tree's K5 with the step's glue, or its K5 that takes
    the glue in) on a std map (MF 16, 320x240) at the default 5 tries, and
    at 17 and 40 tries where the tree's K5 takes them (a tree with the
    16-try cap has no such case), there also on a map where every try
    clashes: "K5 ..." is the kernel's own device time, "stage 7 proposal"
    that of every kernel the proposal launches a call;
  K7 at 64 lanes x 16 slots (batch64, sb0), 16 x 60 (batch-hires, 640x480)
    and 1 x 100 (mf100), from chip_smoke.py's k7_random_scene (a NaN score,
    an all-invisible lane, equal scores, then random lanes): "K7 ..." is the
    kernel's own device time a launch, "stage 2 ..." the device time of
    every kernel that stage 2 of the split stages launches a call (the
    tree's K7 and, where its K7 writes every slot's rows, the slices'
    copies, the visible count, stable_top_k and the gathers of the step
    that goes with it), with their number;
  K1 at D = 109 and D = 373, which shares csrc/measure_chain.cuh.

Every tree must give equal outputs (K7's selection, count and selected
rows; K5's four results; K1's outputs); the script fails if they do not.
"""

from __future__ import annotations

import functools
import os
import sys

import ab_kernels

SEED = 12
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))    # the script's checkout
K7_SHAPES = (("64x16", 64, None), ("16x60", 16, "hires"), ("1x100", 1, 100))


@functools.lru_cache(maxsize=None)
def _smoke():
    """chip_smoke.py of the script's checkout, as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _stage2(measure, state, nsel, mc):
    """fn(x, P, xp_org, active, full) -> stage 2's selection with the tree's K7."""
    import torch

    if hasattr(measure, "measure_select"):
        return lambda *a: measure.measure_select(*a, nsel, mc)[:9]

    def composed(x, P, xpo, active, full):
        # the step's code around a K7 that writes every slot's rows
        Bn, MF = active.shape
        act_full = active & full
        meas = measure.measure_predict(x[:, :7], P[:, :7, :7], state.slot_states(x, MF)[..., :3], xpo,
                                       state.slot_pxy(P, MF)[..., :7, :3],
                                       state.slot_pyy(P, MF)[..., :3, :3], act_full, mc)
        n_visible = (act_full & (meas[:, measure.O_VIS] == 0.0)).sum(-1).to(torch.int32)
        top_score, top_idx = measure.stable_top_k(meas[:, measure.O_SCORE], nsel)
        sel = torch.gather(meas, 2, top_idx.long()[:, None, :].expand(Bn, meas.shape[1], nsel))
        O_H, O_HX, O_HY, O_S, O_SINV = measure.O_H, measure.O_HX, measure.O_HY, measure.O_S, measure.O_SINV
        return (top_idx, top_score, n_visible, sel[:, O_H : O_H + 2].mT,
                sel[:, O_HX : O_HX + 14].mT.reshape(Bn, nsel, 2, 7),
                sel[:, O_HY : O_HY + 6].mT.reshape(Bn, nsel, 2, 3), sel[:, measure.O_RD],
                torch.stack([sel[:, O_S], sel[:, O_S + 1], sel[:, O_S + 1], sel[:, O_S + 2]],
                            dim=-1).reshape(Bn, nsel, 2, 2),
                sel[:, O_SINV : O_SINV + 3].mT.contiguous())

    return composed


def _stage7(propose, shi_tomasi, p, dev):
    """fn(x, rng, active, full, speed, n_visible, c) -> stage 7's proposal
    (the clamped region, any_ok, the limbs, the init box) with the tree's K5."""
    import torch

    if hasattr(propose, "propose_region"):
        return propose.propose_region
    no_box = torch.zeros(2, dtype=torch.int32, device=dev)

    def composed(x, rng, active, full, speed, n_visible, c):
        # the step's glue around a K5 that takes the JAX kernel's arguments
        n_partial = (active & ~full).sum().to(torch.int32)
        want = ((speed > p.min_speed_for_init) & (n_visible < p.n_features_to_keep_visible)
                & (n_partial < p.max_features_to_init_at_once))
        us, vs, any_ok, rng_new = propose.propose(x, rng, active & full, want, c)
        ru, rv, ruf, rvf = shi_tomasi.clamp_region(us, vs, us + p.init_search_width, vs + p.init_search_height,
                                                   p.cam_width, p.cam_height, p.boxsize)
        return ru, rv, ruf, rvf, any_ok, rng_new, torch.where(want, torch.stack([us, vs]), no_box)

    return composed


def _cases(dev):
    """(name, kernel symbol or None, fn) of every timed case; fn() returns
    the outputs. Call it after the tree's scenelib2_torch is imported:
    chip_smoke.py puts its own root first on sys.path."""
    import dataclasses

    import numpy as np
    import torch

    from scenelib2_torch.config import Params
    from scenelib2_torch.eval.synthetic import HIRES_PARAMS
    from scenelib2_torch.kernels import measure, predict_measure, propose, shi_tomasi
    from scenelib2_torch.kernels.measure import MeasureConsts
    from scenelib2_torch.runtime import state

    rng = np.random.default_rng(SEED)
    std = Params()
    out = []
    # K5: a std map moving sideways, the stream at srand48(0), most slots occupied
    x, _P, _xpo, act, _part = _smoke().k1_random_scene(rng, std, dev)
    x = x.clone()
    x[7:13] = torch.tensor([0.1, 0.05, 0.0, 0.0, 0.3, 0.0], device=dev)
    # stage 7's proposal as the step runs it, the gate open (fast, few visible)
    stage7 = _stage7(propose, shi_tomasi, std, dev)
    a5 = (x, torch.tensor([0x330E, 0, 0], dtype=torch.int32, device=dev), act | _part, ~_part,
          torch.tensor(0.5, device=dev), torch.tensor(3, dtype=torch.int32, device=dev))
    any_tries = hasattr(propose, "jump_table")
    for tries in (std.init_region_tries, 17, 40):
        if tries > 16 and not any_tries:
            continue
        c5 = dataclasses.replace(propose.ProposeConsts.from_params(std), tries=tries)
        fn7 = functools.partial(stage7, *a5, c5)
        out.append((f"K5 std (tries {tries})", "k5_kernel", fn7))
        if tries == std.init_region_tries:
            out.append(("stage 7 proposal", None, fn7))
        else:   # every try clashing: all 2 tries draws consumed
            clash = dict(_smoke().k5_region_variations(a5 + (c5,), np.random.default_rng(SEED + tries)))
            out.append((f"K5 all clash (tries {tries})", "k5_kernel",
                        functools.partial(stage7, *clash["all_clash"])))
    for label, n_lanes, which in K7_SHAPES:
        p = (dataclasses.replace(std, **HIRES_PARAMS) if which == "hires"
             else dataclasses.replace(std, max_features=which or std.max_features))
        a7 = _smoke().k7_random_scene(rng, p, dev, n_lanes=n_lanes)
        fn = functools.partial(_stage2(measure, state, p.n_features_to_select, MeasureConsts.from_params(p)), *a7)
        out.append((f"K7 {label}", "k7_kernel", fn))
        out.append((f"stage 2 {label}", None, fn))
    for label, p in (("K1 std (D 109)", std), ("K1 hires (D 373)", dataclasses.replace(std, **HIRES_PARAMS))):
        a1 = _smoke().k1_random_scene(rng, p, dev)
        kw = dict(nsel=p.n_features_to_select, maxp=1, dt=p.delta_t, sd_a=p.sd_a, sd_alpha=p.sd_alpha,
                  consts=MeasureConsts.from_params(p))
        out.append((label, "k1_kernel", lambda a1=a1, kw=kw: predict_measure.predict_measure(*a1, **kw)))
    return out


if __name__ == "__main__":
    sys.exit(ab_kernels.run(sys.argv[1:], os.path.abspath(__file__), _cases))
