"""Minimal interactive init/pick loop — the reference's GL_SELECT flow.

The reference wires mouse picks through GL_SELECT hit buffers
(graphic/graphictool.cpp:1475-1571) into MonoSLAM::toggle_feature_lab /
mark_feature_by_lab, and a left-click in the AR view sets (uu, vv) for a
manual InitialiseFeature (support/pangolin_util.cpp:40-81,
examples/MonoSlamSceneLib1.cpp:91-117). This module provides the same flow
on a matplotlib canvas over the facade's label-based APIs:

  left click  near a feature -> toggle selection (toggle_feature_lab)
              elsewhere      -> manual feature init at the click (uu, vv)
  right click near a feature -> mark it (mark_feature_by_lab)
  key n  -> process the next frame (GoOneStep)
  key d  -> delete the marked feature
  key s  -> save the marked feature's patch (SavePatch)

Handlers are plain methods taking (x, y) / key so they are unit-testable
without a display; `run()` wires them to a live matplotlib window. A port
of scenelib2_tpu/eval/interactive.py driving the port's facade.
"""

from __future__ import annotations

import numpy as np

from scenelib2_torch.core import models
from scenelib2_torch.runtime import state as st

PICK_RADIUS_PX = 8.0  # GL_SELECT pick window is 10x10 (graphictool.cpp:1496)


class InteractiveSession:
    def __init__(self, slam, frames):
        self.slam = slam
        self.frames = np.asarray(frames, np.uint8)
        self.frame_idx = 0
        self.mapping = True
        self.messages: list[str] = []

    # ----------------------------------------------------------- picking

    def _feature_projections(self):
        """Current image positions of active fully-initialised features,
        as (label, u, v) rows — the Picker's candidate set."""
        s = self.slam.state
        cam = self.slam.cam
        x = s.x.detach().cpu()
        active, full, label = (t.cpu().numpy() for t in (s.active, s.full, s.label))
        rows = []
        for k in range(self.slam.params.max_features):
            if not (active[k] and full[k]):
                continue
            off = st.slot_offset(k)
            h, _, _, zeroed = models.full_predict_measurement(cam, x[off : off + 3], x[:7])
            if float(zeroed[2]) <= 0:
                continue
            rows.append((int(label[k]), float(h[0]), float(h[1])))
        return rows

    def pick(self, u: float, v: float):
        """Nearest feature label within the pick radius, or None."""
        best, best_d = None, PICK_RADIUS_PX
        for lab, fu, fv in self._feature_projections():
            d = float(np.hypot(fu - u, fv - v))
            if d <= best_d:
                best, best_d = lab, d
        return best

    # ----------------------------------------------------------- handlers

    def on_click(self, u: float, v: float, button: int = 1) -> str:
        lab = self.pick(u, v)
        if button == 3:  # right: mark (pangolin_util.cpp:63-71)
            if lab is not None:
                self.slam.mark_feature_by_lab(lab)
                return self._log(f"marked feature {lab}")
            return self._log("nothing to mark here")
        if lab is not None:
            self.slam.toggle_feature_lab(lab)
            return self._log(f"toggled feature {lab}")
        ok = self.slam.initialise_feature(self.frames[self.frame_idx], int(u), int(v))
        return self._log(f"manual init at ({int(u)},{int(v)}): {'ok' if ok else 'rejected'}")

    def on_key(self, key: str) -> str:
        if key == "n":
            if self.frame_idx + 1 >= len(self.frames):
                return self._log("end of sequence")
            self.frame_idx += 1
            self.slam.go_one_step(
                self.frames[self.frame_idx], save_trajectory=True,
                enable_mapping=self.mapping,
            )
            o = self.slam.last_output
            return self._log(
                f"frame {self.frame_idx}: matched {int(o.n_matched)}/"
                f"{int(o.n_selected)}, map {int(o.n_active)}"
            )
        if key == "d":
            ok = self.slam.delete_feature()
            return self._log("deleted marked feature" if ok else "no marked feature")
        if key == "s":
            ok = self.slam.save_patch()
            return self._log("patch saved" if ok else "no marked feature")
        if key == "m":
            self.mapping = not self.mapping
            return self._log(f"mapping {'on' if self.mapping else 'off'}")
        return ""

    def _log(self, msg: str) -> str:
        self.messages.append(msg)
        return msg

    # ------------------------------------------------------------- window

    def run(self, show: bool = True):
        """Wire the handlers to a matplotlib window and (optionally) block in
        plt.show(). With show=False the fully-wired figure is returned
        instead, so the event loop body is drivable headless under Agg by
        synthesizing button_press_event / key_press_event through
        fig.canvas.callbacks (see tests/test_torch_viz.py)."""
        import matplotlib.pyplot as plt

        from scenelib2_torch.eval import viz

        fig, ax = plt.subplots(figsize=(7, 5.5))

        def redraw():
            ax.clear()
            o = self.slam.last_output
            if o is not None:
                viz.render_ar_frame(ax, self.frames[self.frame_idx], o,
                                    self.slam.params.boxsize)
            else:
                ax.imshow(self.frames[self.frame_idx], cmap="gray", vmin=0, vmax=255)
            ax.set_title(self.messages[-1] if self.messages else
                         "click: toggle/init | right: mark | n/d/s/m keys")
            fig.canvas.draw_idle()

        def click(ev):
            if ev.inaxes is ax and ev.xdata is not None:
                self.on_click(ev.xdata, ev.ydata, ev.button)
                redraw()

        def key(ev):
            self.on_key(ev.key)
            redraw()

        fig.canvas.mpl_connect("button_press_event", click)
        fig.canvas.mpl_connect("key_press_event", key)
        redraw()
        if show:  # pragma: no cover - blocks on a live display
            plt.show()
        return fig
