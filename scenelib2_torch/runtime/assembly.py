"""Large-map joint measurement assembly: the construct_total_measurement_stuff
analog (reference monoslam.cpp:548-572) on the packed 13 + slot_dim*n_feat
state layout.

Port of scenelib2_tpu/runtime/assembly.py. Per-slot measurement prediction
(projection, Jacobians, S_i, noise: full_feature_model.cpp:67-195), top-k
selection by trace(S) (monoslam.cpp:187-254) and the H / R packing, with
every selected feature treated as measured. Shared by the large-map EKF
frame of the benches (eval/benchmark.py) and the sharded-covariance frame
(parallel/mesh.py::sharded_stress_frame), which gathers the same slot blocks
from its shards and calls `assemble`.

Works on mesh-padded states: only the live range [13, 13 + slot_dim*n_feat)
is read, and H is zero in every column beyond it.

The chain runs in float64 whatever the state's dtype and is cast back, as in
the JAX package, whose f32 frames run in an x64 process: its camera
constants are f64 and promote h, the Jacobians, R and S (camera.project's
`wide`). The camera pose and the world points stay in the state's dtype.
"""

from __future__ import annotations

import torch

from scenelib2_torch.core import models
from scenelib2_torch.core.camera import CameraParams, measurement_noise

CAM_DIM = 13
WIDE = torch.float64


def slot_rows(n_feat: int, slot_dim: int, device) -> torch.Tensor:
    """[n_feat, 3] state indices of each slot's world point."""
    return (CAM_DIM + slot_dim * torch.arange(n_feat, device=device)[:, None]
            + torch.arange(3, device=device)[None, :])


def slot_blocks(x, P, n_feat: int, slot_dim: int):
    """The blocks that the assembly reads: (xp [7], ys3 [n, 3], Pxx [13, 13],
    pxy3 [n, 13, 3], pyy3 [n, 3, 3]); pyy3 is the diagonal gather of the
    slots' 3 x 3 blocks (no [n, s, n, s] copy)."""
    lo, hi = CAM_DIM, CAM_DIM + slot_dim * n_feat
    ys3 = x[lo:hi].reshape(n_feat, slot_dim)[:, :3]
    pxy3 = P[:CAM_DIM, lo:hi].reshape(CAM_DIM, n_feat, slot_dim).permute(1, 0, 2)[:, :, :3]
    i = slot_rows(n_feat, slot_dim, x.device)
    pyy3 = P[i[:, :, None], i[:, None, :]]
    return x[:7], ys3, P[:CAM_DIM, :CAM_DIM], pxy3, pyy3


def assemble(cam: CameraParams, xp, ys3, Pxx, pxy3, pyy3, D: int, slot_dim: int, n_sel: int):
    """(H_tot [2 n_sel, D], R_tot [2 n_sel, 2 n_sel], top_idx [n_sel] int32,
    h_sel [n_sel, 2]) from slot_blocks' blocks, in xp's dtype."""
    from scenelib2_torch.kernels.measure import stable_top_k

    dt, dev = xp.dtype, xp.device
    n_feat = ys3.shape[0]
    h, hx7, hy, _ = models.full_predict_measurement(cam, ys3, xp.expand(n_feat, 7), wide=WIDE)
    R = measurement_noise(cam, h)
    hx = torch.nn.functional.pad(hx7, (0, CAM_DIM - 7))
    S = models.innovation_covariance(Pxx.to(WIDE), pxy3.to(WIDE), pyy3.to(WIDE), hx, hy, R).to(dt)
    score = S[:, 0, 0] + S[:, 1, 1]
    _, top_idx = stable_top_k(score, n_sel)
    sel = top_idx.long()
    H = torch.zeros((n_sel, 2, D), dtype=dt, device=dev)
    cols = slot_rows(n_feat, slot_dim, dev)[sel]                     # [n_sel, 3]
    H.scatter_(2, cols[:, None, :].expand(n_sel, 2, 3), hy[sel].to(dt))
    H[:, :, :7] = hx7[sel].to(dt)
    Rd = R[sel, 0, 0].to(dt)
    R_tot = torch.diag_embed(Rd.repeat_interleave(2))
    return H.reshape(2 * n_sel, D), R_tot, top_idx, h[sel].to(dt)


def measurement_assembly(cam: CameraParams, x, P, n_feat: int, slot_dim: int, n_sel: int):
    """(H_tot [2 n_sel, D], R_tot [2 n_sel, 2 n_sel], top_idx [n_sel] int32,
    h_sel [n_sel, 2]) for the joint EKF update, every matrix as in the live
    step; x [D] and P [D, D] on one device."""
    return assemble(cam, *slot_blocks(x, P, n_feat, slot_dim), x.shape[0], slot_dim, n_sel)


__all__ = ["measurement_assembly", "slot_blocks", "assemble", "slot_rows"]
