"""A/B of K3 and K15 (the fused joint updates), K9 (the batch score map) and K14 (L^-1) between source trees on one card.

    python3 scripts/ab_update_kernels.py TREE_A TREE_B TREE_B TREE_A

Each TREE is the root of a checkout of this repo (`.` for the working tree;
unpack another commit with `git archive` into a directory that .gitignore
lists). For each TREE, in the order given, a subprocess imports that tree's
scenelib2_torch, builds its kernels there and reports, on the same seeded
inputs, each kernel's device time and a sha256 of its outputs
(scripts/ab_kernels.py). The cases are the shapes the main paths
give the kernels: K3 at the std map (D = 109) and at hires (D = 373), both
with NSEL 10 (M = 20), mixed match flags and exactly one slot killed; K15
on each of them with H, nu and R assembled as the JAX step's XLA branch
assembles them (ekf_update.dense_inputs) and K3's keep (the D = 109 case is
the shape of the single stream's frames), and at the sizes of its forms:
D = 109 at M = 32 (the largest register factorisation) and 33 (the block
form), D = 128 at M = 128 (the M x M arrays in the workspace); K9
over 64 lanes of 320x240 (batch64) and 16 lanes of 640x480 (batch-hires),
one partial slot a lane; K14 on one S at M = 20 (the split route's
2 NSEL), on a stack of 64 at M = 20 and on one at M = 40 (the block form).
Every redesign keeps its plain twin bit for bit,
so all trees must give equal outputs; the script fails if they do not.
Prints the card's name and power limit, one JSON line per tree, and the
median device time of each case per distinct tree.
"""

from __future__ import annotations

import os
import sys

import ab_kernels

SEED = 70


def _cases(dev):
    """(name, kernel symbol, fn) of every timed case; fn() returns the
    kernel's outputs."""
    import numpy as np
    import torch

    from scenelib2_torch.config import Params
    from scenelib2_torch.kernels import chol_inv, ekf_update, score_map
    from scenelib2_torch.kernels.measure import NOUT, O_H, O_HX, O_HY, O_RD
    from scenelib2_torch.runtime.state import patch_row

    rng = np.random.default_rng(SEED)
    f = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    p = Params()
    uc = ekf_update.UpdateConsts.from_params(p)
    out = []
    for MF in (16, 60):
        D, NSEL = 13 + 6 * MF, p.n_features_to_select
        A = rng.normal(size=(D, D))
        P = A @ A.T / D * 1e-3 + np.eye(D) * 1e-4
        x = rng.normal(size=D) * 0.1
        x[3:7] = rng.normal(size=4)
        x[3:7] /= np.linalg.norm(x[3:7]) * (1.0 + 1e-3)
        sel = np.zeros((NOUT, NSEL), np.float32)
        sel[O_HX : O_HX + 14] = rng.normal(size=(14, NSEL))
        sel[O_HY : O_HY + 6] = rng.normal(size=(6, NSEL))
        sel[O_RD] = rng.uniform(1.0, 2.0, NSEL)
        h = rng.uniform(20, 200, (NSEL, 2))
        sel[O_H : O_H + 2] = h.T
        z = h + rng.normal(0, 1.0, (NSEL, 2))
        sel_mask = np.ones(NSEL, bool)
        succ = np.arange(NSEL) % 3 != 1                      # mixed: a third of the matches fail
        top_idx = rng.choice(MF, NSEL, replace=False).astype(np.int32)
        active = np.zeros(MF, bool)
        active[top_idx] = True
        active[rng.choice(MF, MF // 2, replace=False)] = True
        attempts = np.zeros(MF, np.int32)                    # no failure-ratio kill
        sched = np.zeros(MF, bool)
        sched[top_idx[0]] = True                             # a run of one scheduled slot: it dies
        label = np.where(active, rng.permutation(MF), -1).astype(np.int32)
        a3 = (torch.tensor(x, **f), torch.tensor(P, **f), torch.tensor(sel, **f), torch.tensor(z, **f),
              torch.tensor(succ, device=dev), torch.tensor(13 + 6 * top_idx, **i32), torch.tensor(attempts, **i32),
              torch.tensor(attempts, **i32), torch.tensor(sched, device=dev), torch.tensor(active, device=dev),
              torch.tensor(label, **i32), torch.tensor(sel_mask, device=dev), torch.tensor(top_idx, **i32))
        out.append((f"K3 D {D}", "k3_kernel", lambda a3=a3: ekf_update.joint_update(*a3, uc)))
        if D <= ekf_update.DENSE_MAX:
            kill = ekf_update.joint_update_plain(*a3, uc)[5]
            a15 = (a3[0], a3[1], *ekf_update.dense_inputs(D, *a3[2:6]), a3[4].any(), ekf_update.keep_of_kill(kill))
            out.append((f"K15 D {D} M {2 * NSEL}", "k15_kernel",
                        lambda a15=a15: ekf_update.joint_update_dense(*a15)))
    for n, H, W in ((64, 240, 320), (16, 480, 640)):
        c = score_map.ScoreMapConsts(H=H, W=W, boxsize=p.boxsize, corr_sigma_thresh=p.corr_sigma_thresh,
                                     low_sigma_penalty=p.low_sigma_penalty)
        frames = torch.tensor(rng.integers(0, 256, (n, H, W), dtype=np.uint8), device=dev)
        B = p.boxsize
        rows = torch.stack([patch_row(frames[k, 40 : 40 + B, 60 : 60 + B]) for k in range(n)])[:, None]
        ws = torch.empty((n, 1, H, W), **f)
        out.append((f"K9 {n} x {W}x{H}", "k9_kernel",
                    lambda frames=frames, rows=rows, c=c, ws=ws: (score_map.score_map(frames, rows, c, out=ws),)))
    for label, n, M in (("K14 M 20", 1, 20), ("K14 64 x M 20", 64, 20), ("K14 M 40", 1, 40)):
        A = rng.normal(size=(n, M, M))
        S = torch.tensor(A @ A.transpose(0, 2, 1) / M + np.eye(M), **f)
        S = S[0] if n == 1 else S
        out.append((label, "k14_", lambda S=S: (chol_inv.chol_inv(S),)))
    for D, M in ((109, 32), (109, 33), (128, 128)):
        A = rng.normal(size=(D, D))
        P = A @ A.T / D * 1e-3 + np.eye(D) * 1e-4
        x = rng.normal(size=D) * 0.1
        x[3:7] = rng.normal(size=4)
        x[3:7] /= np.linalg.norm(x[3:7]) * (1.0 + 1e-3)
        H = rng.normal(size=(M, D)) * (rng.uniform(size=(M, D)) < 0.1)
        keep = np.ones(D, bool)
        keep[D - 6 :] = False
        a15 = (torch.tensor(x, **f), torch.tensor(P, **f), torch.tensor(H, **f), torch.tensor(rng.normal(size=M), **f),
               torch.tensor(np.eye(M), **f), torch.tensor(True, device=dev), torch.tensor(keep, device=dev))
        out.append((f"K15 D {D} M {M}", "k15_kernel", lambda a15=a15: ekf_update.joint_update_dense(*a15)))
    return out


if __name__ == "__main__":
    sys.exit(ab_kernels.run(sys.argv[1:], os.path.abspath(__file__), _cases))
