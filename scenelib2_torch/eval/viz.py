"""Replay visualisation — the reference GraphicTool's headless analog (a port
of scenelib2_tpu/eval/viz.py).

The reference renders with OpenGL/Pangolin (graphic/graphictool.cpp):
  Draw3dScene — camera body, trajectory, map points, 3-sigma covariance
                ellipsoids
  DrawAR      — camera image with feature patches, active-search ellipses,
                match points, init boxes

Here the same observability comes from recorded StepOutputs + SlamState,
moved to numpy (any field may be a numpy array or a tensor on any device)
and rendered with matplotlib (AR overlays per frame, 3-D map plots) —
strictly off the device path.
"""

from __future__ import annotations

import numpy as np


def _np(a) -> np.ndarray:
    """A field as numpy: tensors (on any device) are moved to the host."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


def _ellipse_points(S, n_sigma=3.0, n=48):
    """Boundary of the n-sigma ellipse of a 2x2 covariance."""
    w, V = np.linalg.eigh(S)
    w = np.maximum(w, 0.0)
    t = np.linspace(0, 2 * np.pi, n)
    circ = np.stack([np.cos(t), np.sin(t)])
    return (V @ (np.sqrt(w)[:, None] * circ)) * n_sigma


def feature_colour(selected: bool, successful: bool, marked: bool = False) -> str:
    """The reference's SetFeatureColour palette (graphictool.cpp:1344-1362):
    marked features green; selected features red when the last measurement
    succeeded, blue when it failed; unselected features yellow."""
    if marked:
        return "lime"
    if selected:
        return "red" if successful else "blue"
    return "yellow"


def render_ar_frame(ax, frame: np.ndarray, out, boxsize: int = 11,
                    init_region_size: tuple[int, int] | None = (80, 60),
                    marked_label: int = -1):
    """Draw one frame's AR overlay onto a matplotlib Axes.

    `out` is a single-frame StepOutputs slice (numpy-compatible fields).
    Colours follow the reference's SetFeatureColour split: red ellipse/patch
    box for a successfully matched selected feature, blue for a selected
    feature whose search failed, green for the marked feature; the patch box
    is drawn at the match position z when matched, else at the prediction h
    (DrawRawAR, graphictool.cpp:322-338).
    """
    ax.imshow(frame, cmap="gray", vmin=0, vmax=255)
    half = (boxsize - 1) // 2
    sel_mask = _np(out.sel_mask)
    sel_slot = _np(getattr(out, "sel_slot", np.full(len(sel_mask), -1)))
    for k in range(len(sel_mask)):
        if not sel_mask[k]:
            continue
        matched = bool(_np(out.sel_matched)[k])
        col = feature_colour(True, matched, marked_label >= 0 and sel_slot[k] == marked_label)
        h = _np(out.sel_h)[k]
        S = _np(out.sel_S)[k]
        pts = _ellipse_points(S) + h[:, None]
        ax.plot(pts[0], pts[1], color=col, lw=0.8)
        if matched:
            z = _np(out.sel_z)[k]
            ax.plot([z[0]], [z[1]], "g+", ms=10, mew=2)
            bx, by = z[0], z[1]
        else:
            bx, by = h[0], h[1]
        ax.add_patch(
            __import__("matplotlib.patches", fromlist=["Rectangle"]).Rectangle(
                (bx - half, by - half), boxsize, boxsize,
                fill=False, ec=col, lw=0.8,
            )
        )

    # partial features: per-particle search ellipses. The reference draws
    # every particles_step-th particle STARTING at particles_step-1, with
    # particles_step = max(n/10, 1) (kDrawNOverlappingEllipses_=10,
    # graphictool.cpp:714-762), in yellow (glColor4f(1,1,0) at :758).
    if hasattr(out, "par_mask"):
        par_mask = np.atleast_1d(_np(out.par_mask))
        for j in range(len(par_mask)):
            if not par_mask[j]:
                continue
            alive = _np(out.par_alive)[j]
            hs = _np(out.par_h)[j]
            sinvs = _np(out.par_sinv)[j]
            idx = np.nonzero(alive)[0]
            stride = max(1, len(idx) // 10)
            for k in idx[stride - 1 :: stride]:
                try:
                    S = np.linalg.inv(sinvs[k])
                except np.linalg.LinAlgError:
                    continue
                pts = _ellipse_points(S) + hs[k][:, None]
                ax.plot(pts[0], pts[1], color="yellow", lw=0.5, alpha=0.6)

    # auto-init region box (graphictool.cpp:774-797)
    if hasattr(out, "did_init") and bool(_np(out.did_init)) and hasattr(out, "init_box"):
        us, vs = (int(v) for v in _np(out.init_box))
        if init_region_size is not None:
            rw, rh = init_region_size
            ax.add_patch(
                __import__("matplotlib.patches", fromlist=["Rectangle"]).Rectangle(
                    (us, vs), rw, rh, fill=False, ec="cyan", lw=1.0, ls="--",
                )
            )
    ax.set_xlim(0, frame.shape[1])
    ax.set_ylim(frame.shape[0], 0)
    ax.set_xticks([])
    ax.set_yticks([])


def _plot_ellipsoid(ax, centre, cov, n_sigma=3.0, color="b", n=12):
    """True 3-sigma covariance ellipsoid wireframe via eigendecomposition —
    the reference's Draw3dScene ellipsoids (graphictool.cpp:113-364), not
    axis-aligned whiskers: off-diagonal Pyy terms tilt the principal axes."""
    w, V = np.linalg.eigh(_np(cov))
    radii = n_sigma * np.sqrt(np.maximum(w, 0.0))
    if not radii.any():
        return
    u = np.linspace(0, 2 * np.pi, 2 * n)
    v = np.linspace(0, np.pi, n)
    sphere = np.stack([
        np.outer(np.cos(u), np.sin(v)),
        np.outer(np.sin(u), np.sin(v)),
        np.outer(np.ones_like(u), np.cos(v)),
    ])                                             # [3, 2n, n]
    pts = np.einsum("ij,juv->iuv", V * radii[None, :], sphere)
    ax.plot_wireframe(
        centre[0] + pts[0], centre[1] + pts[1], centre[2] + pts[2],
        color=color, lw=0.3, alpha=0.35, rstride=2, cstride=2,
    )


def render_map_3d(ax, state, trajectory: np.ndarray | None = None,
                  out=None, marked_label: int = -1):
    """3-D map points + camera trajectory + per-feature 3-sigma extents.

    When a StepOutputs slice is given, points take the reference's
    SetFeatureColour palette (selected+matched red, selected+failed blue,
    marked green, else yellow — graphictool.cpp:1344-1362)."""
    from scenelib2_torch.runtime import state as st

    active = _np(state.active)
    full = _np(state.full)
    x = _np(state.x)
    P = _np(state.P)
    labels = _np(state.label)
    sel_of_slot = {}
    if out is not None:
        for k, s in enumerate(_np(out.sel_slot)):
            if _np(out.sel_mask)[k]:
                sel_of_slot[int(s)] = bool(_np(out.sel_matched)[k])
    for i in range(len(active)):
        if not active[i]:
            continue
        off = st.slot_offset(i)
        if full[i]:
            y = x[off : off + 3]
            pyy = P[off : off + 3, off : off + 3]
            col = (
                feature_colour(i in sel_of_slot, sel_of_slot.get(i, False),
                               marked_label == int(labels[i]))
                if out is not None
                else "b"
            )
            ax.scatter([y[0]], [y[1]], [y[2]], c=col, s=12)
            _plot_ellipsoid(ax, y, pyy)
        else:
            ri = x[off : off + 3]
            hhat = x[off + 3 : off + 6]
            lam = _np(state.lam[i])
            prob = _np(state.prob[i])
            alive = _np(state.palive[i])
            if alive.any():
                pts = ri[None, :] + lam[alive, None] * hhat[None, :]
                ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], c="m", s=4,
                           alpha=np.clip(prob[alive] / max(prob[alive].max(), 1e-12), 0.05, 1.0))
    if trajectory is not None and len(trajectory):
        ax.plot(trajectory[:, 0], trajectory[:, 1], trajectory[:, 2], "g-", lw=1)
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_zlabel("z")


def save_ar_video_frames(frames, outs, out_dir: str, boxsize: int = 11, every: int = 1):
    """Dump AR overlay PNGs for a recorded run (outs = stacked StepOutputs)."""
    import os

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    T = len(frames)
    paths = []
    for t in range(0, T, every):
        o_t = frame_outputs(outs, t)
        fig, ax = plt.subplots(figsize=(5, 4))
        render_ar_frame(ax, frames[t], o_t, boxsize)
        p = os.path.join(out_dir, f"ar_{t:04d}.png")
        fig.savefig(p, dpi=110, bbox_inches="tight")
        plt.close(fig)
        paths.append(p)
    return paths


def frame_outputs(outs, t: int):
    """Frame t of stacked StepOutputs (leading time axis), every field as
    numpy."""
    return type(outs)(*(_np(a)[t] for a in outs))
