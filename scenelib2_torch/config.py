"""Config system: SceneLib2.cfg-compatible parser + typed parameter dataclasses.

The reference loads a flat ``section.key = value;`` file via Pangolin's
ParseVarsFile (reference scenelib2/monoslam.cpp:1574-1969, data/SceneLib2.cfg).
We parse the identical format so the stock calibration file works drop-in, and
expose the result as frozen dataclasses that parameterize the per-frame pipeline.

Static capacities (feature slots, particle count, etc.) fix the shapes of the
per-frame step; per-run numeric state (xv, Pxx, known features) becomes device
tensors. A copy of scenelib2_tpu/config.py: the port imports nothing of the
JAX package.
"""

from __future__ import annotations

import dataclasses
import os
import re
from dataclasses import dataclass
from typing import Any

import numpy as np

# ---------------------------------------------------------------------------
# Raw .cfg parsing (Pangolin ParseVarsFile-compatible subset)
# ---------------------------------------------------------------------------


def parse_cfg_file(path: str) -> dict[str, str]:
    """Parse a SceneLib2 ``key = value;`` config file into a flat dict.

    Format (see reference data/SceneLib2.cfg): one ``a.b = v;`` per line,
    ``#`` starts a comment, whitespace/tabs are insignificant, values run to
    the trailing ``;`` (which is optional for robustness).
    """
    out: dict[str, str] = {}
    with open(path, "r") as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            m = re.match(r"([A-Za-z0-9_.]+)\s*=\s*(.*?);?\s*$", line)
            if m:
                out[m.group(1)] = m.group(2).strip()
    return out


def _get(d: dict[str, str], key: str, default: Any, typ: type) -> Any:
    if key not in d:
        return default
    v = d[key]
    if typ is bool:
        return v.strip() in ("1", "true", "True")
    return typ(v)


# ---------------------------------------------------------------------------
# Typed parameters
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Params:
    """Algorithm + camera parameters (reference monoslam.cpp:1848-1938).

    These mirror the ``params.*`` and ``cam.*`` sections of SceneLib2.cfg plus
    the constants hard-coded in the reference (boxsize, sigma, thresholds at
    monoslam.cpp:47-49 and :1875-1876).
    """

    # cam.*
    cam_width: int = 320
    cam_height: int = 240
    cam_fku: float = 195.0
    cam_fkv: float = 195.0
    cam_u0: float = 162.0
    cam_v0: float = 125.0
    cam_kd1: float = 9e-6
    cam_sd: float = 1.0

    # params.*
    delta_t: float = 1.0 / 30.0
    n_features_to_select: int = 10
    n_features_to_keep_visible: int = 12
    max_features_to_init_at_once: int = 1
    min_lambda: float = 0.5
    max_lambda: float = 5.0
    n_particles: int = 100
    sd_depth_ratio: float = 0.3
    min_particles: int = 20
    prune_prob_thresh: float = 0.05
    erase_partial_after_attempts: int = 10

    # hard-coded constants in the reference
    boxsize: int = 11                     # monoslam.cpp:48 kBoxSize_
    no_sigma: float = 3.0                 # kNoSigma_
    corr_thresh2: float = 0.40            # kCorrThresh2_
    corr_sigma_thresh: float = 10.0       # kCorrelationSigmaThreshold_
    low_sigma_penalty: float = 5.0        # search_multiple_overlapping_ellipses.h:56
    min_attempted_measurements: int = 10  # monoslam.cpp:1875
    successful_match_fraction: float = 0.5  # monoslam.cpp:1876
    sd_a: float = 4.0                     # motion_model.cpp:45 kSdAComponentFilter_
    sd_alpha: float = 6.0                 # kSdAlphaComponentFilter_
    init_steps_to_predict: int = 10       # monoslam.cpp:832
    init_depth_hypothesis: float = 2.5    # monoslam.cpp:836
    init_patch_score_thresh: float = 20000.0  # monoslam.cpp:839
    init_search_width: int = 80           # monoslam.cpp:940
    init_search_height: int = 60
    init_region_tries: int = 5            # monoslam.cpp:949
    feature_separation_min: int = 10      # monoslam.cpp:950
    image_search_boundary: float = 20.0   # full_feature_model.cpp:51
    max_length_ratio: float = 2.0         # full_feature_model.cpp:49
    max_angle_difference: float = np.pi * 45.0 / 180.0  # full_feature_model.cpp:50
    min_speed_for_init: float = 0.2       # monoslam.cpp:163

    # --- build capacities (TPU static shapes; not in the reference) ---
    max_features: int = 16    # feature slots; each slot spans 6 state dims
    slot_dim: int = 6         # per-slot state stride (ray features need 6)
    cam_dim: int = 13         # camera state size (motion_model.cpp:44)
    # static window caps for the masked searches (the reference's dynamic
    # 3-sigma boxes are data-dependent; candidates beyond the cap are dropped
    # and counted — stock-workload extents stay well inside)
    search_win_radius: int = 32
    # particle windows gather from the shared per-patch score map, so a
    # generous radius is cheap; fresh rays routinely need >16 px (3-sigma)
    particle_win_radius: int = 32
    # window-gather strategy: dynamic_slice loops win single-stream on TPU;
    # index-grid gathers win under an outer vmap (batch datagen configs)
    index_gather: bool = False
    # True: the JAX step's kernel route; False: its pure-XLA route (the
    # single stream launches K14 alone, the batch step no kernel). The port
    # keeps True as its default where JAX's Params say False: JAX ties False
    # to its f64 parity mode (scenelib2_tpu/config.py:129-131), and every
    # JAX bench and the selftest pass use_pallas=True in f32
    # (scenelib2_tpu/eval/benchmark.py:112-197, eval/selftest.py:131). In
    # f64 the flag keeps JAX's meaning: False is the parity route, True the
    # hybrid route with the search kernel in stage 3
    use_pallas: bool = True
    # batch_mode: pick vmap-friendly implementations (dense particle search,
    # unrolled Cholesky, vmapped particle predict) — single-invocation Pallas
    # kernels serialize across a vmapped batch axis (one grid step per lane)
    batch_mode: bool = False
    # batch_pallas: in batch_mode, still run the image-plane Pallas kernels
    # (measurement predict, fused search, score maps, Shi-Tomasi, particle
    # predict) under the lane vmap — each lane is one grid step, which beats
    # the dense XLA forms because per-invocation work is image-sized. The
    # joint EKF update stays batched XLA (64 tiny serial kernel steps would
    # underuse the MXU vs one [B,D,D] matmul).
    batch_pallas: bool = True

    @property
    def state_dim(self) -> int:
        return self.cam_dim + self.slot_dim * self.max_features


@dataclass(frozen=True)
class KnownFeature:
    y: tuple[float, float, float]
    xp_org: tuple[float, ...]  # 7-dim
    patch_path: str


@dataclass(frozen=True)
class SlamConfig:
    params: Params
    xv0: np.ndarray            # [13]
    pxx0: np.ndarray           # [13,13]
    known_features: tuple[KnownFeature, ...] = ()
    input_name: str = ""
    input_mode: int = 0

    def __post_init__(self):
        object.__setattr__(self, "xv0", np.asarray(self.xv0, np.float64))
        object.__setattr__(self, "pxx0", np.asarray(self.pxx0, np.float64))


def load_config(path: str, data_dir: str | None = None, **param_overrides) -> SlamConfig:
    """Load a stock SceneLib2.cfg into a SlamConfig.

    ``data_dir``: directory used to resolve patch identifiers (the stock file
    uses relative paths like ``../../data/known_patch0.pgm``; we resolve by
    basename against data_dir, defaulting to the cfg file's directory).
    """
    raw = parse_cfg_file(path)
    if data_dir is None:
        data_dir = os.path.dirname(os.path.abspath(path))

    p = Params(
        cam_width=_get(raw, "cam.width", 320, int),
        cam_height=_get(raw, "cam.height", 240, int),
        cam_fku=float(int(_get(raw, "cam.fku", 195, float))),
        cam_fkv=float(int(_get(raw, "cam.fkv", 195, float))),
        cam_u0=float(int(_get(raw, "cam.u0", 162, float))),
        cam_v0=float(int(_get(raw, "cam.v0", 125, float))),
        cam_kd1=_get(raw, "cam.kd1", 9e-6, float),
        cam_sd=float(int(_get(raw, "cam.sd", 1, float))),
        delta_t=_get(raw, "params.delta_t", 1 / 30.0, float),
        n_features_to_select=_get(raw, "params.number_of_features_to_select", 10, int),
        n_features_to_keep_visible=_get(raw, "params.number_of_features_to_keep_visible", 12, int),
        max_features_to_init_at_once=_get(raw, "params.max_features_to_init_at_once", 1, int),
        min_lambda=_get(raw, "params.min_lambda", 0.5, float),
        max_lambda=_get(raw, "params.max_lambda", 5.0, float),
        n_particles=_get(raw, "params.number_of_particles", 100, int),
        sd_depth_ratio=_get(raw, "params.standard_deviation_depth_ratio", 0.3, float),
        min_particles=_get(raw, "params.min_number_of_particles", 20, int),
        prune_prob_thresh=_get(raw, "params.prune_probability_threshold", 0.05, float),
        erase_partial_after_attempts=_get(
            raw, "params.erase_partially_init_feature_after_this_many_attempts", 10, int
        ),
    )
    if param_overrides:
        p = dataclasses.replace(p, **param_overrides)

    xv0 = np.array(
        [
            _get(raw, "state.rw_x", 0.0, float),
            _get(raw, "state.rw_y", 0.0, float),
            _get(raw, "state.rw_z", 0.0, float),
            _get(raw, "state.qwr_w", 1.0, float),
            _get(raw, "state.qwr_x", 0.0, float),
            _get(raw, "state.qwr_y", 0.0, float),
            _get(raw, "state.qwr_z", 0.0, float),
            _get(raw, "state.vw_x", 0.0, float),
            _get(raw, "state.vw_y", 0.0, float),
            _get(raw, "state.vw_z", 0.0, float),
            _get(raw, "state.ww_x", 0.0, float),
            _get(raw, "state.ww_y", 0.0, float),
            _get(raw, "state.ww_z", 0.0, float),
        ],
        np.float64,
    )

    pxx0 = np.zeros((13, 13), np.float64)
    for i in range(13):
        for j in range(13):
            pxx0[i, j] = _get(raw, f"state.pxx{i}_{j}", 0.0, float)

    feats = []
    for k in (1, 2, 3, 4):
        ident = raw.get(f"f{k}.identifier")
        if ident is None or ident == "empty":
            continue
        patch_path = os.path.join(data_dir, os.path.basename(ident))
        feats.append(
            KnownFeature(
                y=(
                    _get(raw, f"f{k}.yi_x", 0.0, float),
                    _get(raw, f"f{k}.yi_y", 0.0, float),
                    _get(raw, f"f{k}.yi_z", 0.0, float),
                ),
                xp_org=tuple(_get(raw, f"f{k}.xp_org_{i}", 0.0, float) for i in range(7)),
                patch_path=patch_path,
            )
        )

    return SlamConfig(
        params=p,
        xv0=xv0,
        pxx0=pxx0,
        known_features=tuple(feats),
        input_name=raw.get("input.name", ""),
        input_mode=_get(raw, "input.mode", 0, int),
    )


def replace_params(cfg: SlamConfig, **kw) -> SlamConfig:
    return dataclasses.replace(cfg, params=dataclasses.replace(cfg.params, **kw))
