"""The plain reference of the benchmark: SceneLib2's per-frame MonoSLAM in NumPy.

A frozen copy of the NumPy oracle that the port's parity evaluation runs
(per-feature objects, doubles, the C++ reference's quirks: the
unnormalised 'normalise', qq = |q|^2 Jacobians, integer truncations, the
drand48 stream, exterminate_features' skipped neighbour), imports NumPy and
this folder's modules only, and adds what a configuration of the benchmark
states beside SceneLib2's own settings:

- the feature capacity max_features: an initialisation that finds every
  slot taken is proposed (did_init) but inserts no feature;
- the fixed-size search windows (search_win_radius, particle_win_radius):
  improc drops the candidates outside them;
- per-frame outputs: the pose and the frame's decisions (visible, selected
  and matched counts, the map's size and its partial features, whether a
  feature was proposed and whether a ray became a point);
- quantize: None, or a function applied to every stored number of the
  filter after the prediction, after the update and at the end of each
  frame: the state held in a lower precision (the control of the
  comparison that decides `correct`).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import numpy as np

from perfbench.reference import improc as imp
from perfbench.reference.drand48 import Drand48


@dataclass(frozen=True)
class Params:
    """SceneLib2's settings (the cfg file's params.* and cam.*, the
    constants of monoslam.cpp) and the benchmark configuration's capacities."""

    cam_width: int = 320
    cam_height: int = 240
    cam_fku: float = 195.0
    cam_fkv: float = 195.0
    cam_u0: float = 162.0
    cam_v0: float = 125.0
    cam_kd1: float = 9e-6
    cam_sd: float = 1.0
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
    boxsize: int = 11
    no_sigma: float = 3.0
    corr_thresh2: float = 0.40
    corr_sigma_thresh: float = 10.0
    low_sigma_penalty: float = 5.0
    min_attempted_measurements: int = 10
    successful_match_fraction: float = 0.5
    sd_a: float = 4.0
    sd_alpha: float = 6.0
    init_steps_to_predict: int = 10
    init_depth_hypothesis: float = 2.5
    init_patch_score_thresh: float = 20000.0
    init_search_width: int = 80
    init_search_height: int = 60
    init_region_tries: int = 5
    feature_separation_min: int = 10
    image_search_boundary: float = 20.0
    max_length_ratio: float = 2.0
    max_angle_difference: float = np.pi * 45.0 / 180.0
    min_speed_for_init: float = 0.2
    max_features: int = 16
    search_win_radius: int = 32
    particle_win_radius: int = 32

    @classmethod
    def of(cls, values: dict) -> "Params":
        """The Params of the keys in values that it knows."""
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in values.items() if k in names})


# ---------------------------------------------------------------- math utils


def quat_mul(a, b):
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ]
    )


def quat_conj(q):
    return q * np.array([1.0, -1, -1, -1])


def quat_inverse(q):
    return quat_conj(q) / (q @ q)


def quat_R(q):
    """Eigen toRotationMatrix (unit-assumption formula)."""
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def quat_from_av(av):
    angle = math.sqrt(av @ av)
    if angle > 0:
        s = math.sin(angle / 2) / angle
        return np.array([math.cos(angle / 2), s * av[0], s * av[1], s * av[2]])
    return np.array([1.0, 0, 0, 0])


def dq3_by_dq1(q):
    w, x, y, z = q
    return np.array([[w, -x, -y, -z], [x, w, -z, y], [y, z, w, -x], [z, -y, x, w]])


def dq3_by_dq2(q):
    w, x, y, z = q
    return np.array([[w, -x, -y, -z], [x, w, z, -y], [y, -z, w, x], [z, y, -x, w]])


def dqomegadt_by_domega(omega, dt):
    J = np.zeros((4, 3))
    wmod = math.sqrt(omega @ omega)
    for j in range(3):
        J[0, j] = (-dt / 2.0) * (omega[j] / wmod) * math.sin(wmod * dt / 2.0)
    for i in range(3):
        for j in range(3):
            if i == j:
                J[i + 1, j] = (dt / 2.0) * omega[i] ** 2 / wmod**2 * math.cos(
                    wmod * dt / 2.0
                ) + (1.0 / wmod) * (1.0 - omega[i] ** 2 / wmod**2) * math.sin(wmod * dt / 2.0)
            else:
                J[i + 1, j] = (omega[i] * omega[j] / wmod**2) * (
                    (dt / 2.0) * math.cos(wmod * dt / 2.0) - (1.0 / wmod) * math.sin(wmod * dt / 2.0)
                )
    return J


def norm_jac(v):
    """The reference's qq=|v|^2 'normalisation Jacobian' quirk."""
    qq = v @ v
    n = len(v)
    M = np.empty((n, n))
    for i in range(n):
        for j in range(n):
            if i == j:
                M[i, j] = (1 - v[i] * v[i] / (qq * qq)) / qq
            else:
                M[i, j] = -v[i] * v[j] / (qq * qq * qq)
    return M


def dRq_times_a_by_dq(q, a):
    w, x, y, z = q
    dR0 = 2 * np.array([[w, -z, y], [z, w, -x], [-y, x, w]])
    dRx = 2 * np.array([[x, y, z], [y, -x, -w], [z, w, -x]])
    dRy = 2 * np.array([[-y, x, w], [x, y, z], [-w, z, -y]])
    dRz = 2 * np.array([[-z, -w, x], [w, -z, y], [x, y, z]])
    return np.stack([dR0 @ a, dRx @ a, dRy @ a, dRz @ a], axis=1)


DQBAR = np.diag([1.0, -1, -1, -1])


def _cholesky(S):
    """Cholesky factor of S, or NaN where S is not positive definite (the
    reference's factorisation raises no error: what follows reads NaN)."""
    try:
        return np.linalg.cholesky(S)
    except np.linalg.LinAlgError:
        return np.full_like(S, np.nan)


def _sqrt(v: float) -> np.float64:
    """C's sqrt: NaN, not an error, below 0 (a NaN compares false); as a
    NumPy double, so that what divides by it follows IEEE rules too."""
    return np.float64(math.sqrt(v)) if v >= 0.0 else np.float64(np.nan)


# ---------------------------------------------------------------- camera


@dataclass
class Cam:
    width: int
    height: int
    fku: float
    fkv: float
    u0: float
    v0: float
    kd1: float
    sd: float

    @property
    def centre(self):
        return np.array([self.u0, self.v0])

    def project(self, y):
        uc = np.array([-self.fku * y[0] / y[2], -self.fkv * y[1] / y[2]])
        return uc / math.sqrt(1 + 2 * self.kd1 * (uc @ uc)) + self.centre

    def project_jac(self, y):
        fku_yz = self.fku / y[2]
        fkv_yz = self.fkv / y[2]
        du = np.array(
            [[-fku_yz, 0, fku_yz * y[0] / y[2]], [0, -fkv_yz, fkv_yz * y[1] / y[2]]]
        )
        uc = np.array([-self.fku * y[0] / y[2], -self.fkv * y[1] / y[2]])
        o = np.outer(uc, uc)
        r2 = o[0, 0] + o[1, 1]
        d = 1 + 2 * self.kd1 * r2
        dh = o * (-2 * self.kd1 / (d * math.sqrt(d))) + np.eye(2) / math.sqrt(d)
        return dh @ du

    def unproject(self, h):
        c = h - self.centre
        f = math.sqrt(1 - 2 * self.kd1 * (c @ c))
        u = c / f
        return np.array([u[0] / -self.fku, u[1] / -self.fkv, 1.0])

    def unproject_jac(self, h):
        dy = np.array([[-1 / self.fku, 0], [0, -1 / self.fkv], [0, 0]])
        c = h - self.centre
        o = np.outer(c, c)
        r2 = o[0, 0] + o[1, 1]
        d = 1 - 2 * self.kd1 * r2
        du = o * (2 * self.kd1 / (d * math.sqrt(d))) + np.eye(2) / math.sqrt(d)
        return dy @ du

    def noise(self, h):
        ratio = np.linalg.norm(h - self.centre) / np.linalg.norm(self.centre)
        sd = self.sd * (1 + ratio)
        return np.eye(2) * sd * sd


# ---------------------------------------------------------------- features


@dataclass(eq=False)
class Feat:
    y: np.ndarray
    pxy: np.ndarray                     # [13, k]
    pyy: np.ndarray                     # [k, k]
    cross: list                         # blocks P(y_j, y_this) for earlier j
    patch: np.ndarray
    xp_org: np.ndarray
    label: int
    fully: bool
    attempts: int = 0
    successes: int = 0
    sched: bool = False  # scheduled_for_termination_flag_ (persistent)
    # transient
    h: np.ndarray | None = None
    dh_dxv: np.ndarray | None = None
    dh_dy: np.ndarray | None = None
    R: np.ndarray | None = None
    S: np.ndarray | None = None
    selected: bool = False
    success_flag: bool = False
    z: np.ndarray | None = None
    nu: np.ndarray | None = None


@dataclass(eq=False)
class PartInfo:
    feat: Feat
    lam: np.ndarray
    prob: np.ndarray
    attempts: int = 0
    making: bool = False
    h: np.ndarray | None = None
    sinv: np.ndarray | None = None
    dets: np.ndarray | None = None
    z_ok: np.ndarray | None = None
    z: np.ndarray | None = None
    mean: float = 0.0
    cov: float = 0.0


class OracleMonoSLAM:
    """Reference-semantics MonoSLAM in NumPy (per-feature objects)."""

    def __init__(self, cam: Cam, params: Params, xv0, pxx0, seed=0, quantize=None):
        self.cam = cam
        self.p = params
        self.quantize = quantize
        self.xv = np.asarray(xv0, float).copy()
        self.pxx = np.asarray(pxx0, float).copy()
        self.feats: list[Feat] = []
        self.partials: list[PartInfo] = []
        self.rng = Drand48(seed)
        self.next_label = 0
        self.trajectory = []

    # ---------------- model functions

    def zeroedyi_full(self, y, xp):
        r, q = xp[:3], xp[3:7]
        ymr = y - r
        qRW = quat_inverse(q)
        RRW = quat_R(qRW)
        zeroed = RRW @ ymr
        d_dq = dRq_times_a_by_dq(qRW, ymr) @ DQBAR
        d_dxp = np.concatenate([-RRW, d_dq], axis=1)
        return zeroed, d_dxp, RRW

    def hi_full(self, y, xp):
        zeroed, dz_dxp, dz_dy = self.zeroedyi_full(y, xp)
        h = self.cam.project(zeroed)
        J = self.cam.project_jac(zeroed)
        return h, J @ dz_dxp, J @ dz_dy, zeroed

    def visible(self, y, xp, xp_org, h):
        p = self.p
        flag = 0
        if h[0] < p.image_search_boundary or h[0] > self.cam.width - 1 - p.image_search_boundary:
            flag |= 1
        if h[1] < p.image_search_boundary or h[1] > self.cam.height - 1 - p.image_search_boundary:
            flag |= 2
        zeroed, _, _ = self.zeroedyi_full(y, xp)
        if zeroed[2] <= 0:
            flag |= 16
        hLW = quat_R(xp[3:7]) @ zeroed
        zeroed_o, _, _ = self.zeroedyi_full(y, xp_org)
        hLW_o = quat_R(xp_org[3:7]) @ zeroed_o
        m, mo = np.linalg.norm(hLW), np.linalg.norm(hLW_o)
        ratio = m / mo
        if ratio > p.max_length_ratio or ratio < 1 / p.max_length_ratio:
            flag |= 4
        ang = abs(math.acos(min(1.0, max(-1.0, (hLW @ hLW_o) / (m * mo)))))
        if ang > p.max_angle_difference:
            flag |= 8
        return flag

    def Si(self, pxy, pyy, hx, hy, R):
        t = hx @ pxy @ hy.T
        return hx @ self.pxx @ hx.T + t + t.T + hy @ pyy @ hy.T + R

    def fv_F(self, xv, u, dt):
        r, q, v, w = xv[:3], xv[3:7], xv[7:10], xv[10:13]
        qwt = quat_from_av(w * dt)
        fv = np.concatenate([r + v * dt, quat_mul(q, qwt), v + u * dt, w])
        F = np.eye(13)
        F[0:3, 7:10] = np.eye(3) * dt
        F[3:7, 3:7] = dq3_by_dq2(qwt)
        F[3:7, 10:13] = dq3_by_dq1(q) @ dqomegadt_by_domega(w, dt)
        return fv, F

    def Qmat(self, xv, dt):
        lin = self.p.sd_a**2 * dt * dt
        ang = self.p.sd_alpha**2 * dt * dt
        q, w = xv[3:7], xv[10:13]
        G = np.zeros((13, 6))
        G[0:3, 0:3] = np.eye(3) * dt
        G[3:7, 3:6] = dq3_by_dq1(q) @ dqomegadt_by_domega(w, dt)
        G[7:10, 0:3] = np.eye(3)
        G[10:13, 3:6] = np.eye(3)
        Pnn = np.diag([lin] * 3 + [ang] * 3)
        return G @ Pnn @ G.T

    # ---------------- total gather/scatter

    def total_size(self):
        return 13 + sum(f.y.size for f in self.feats)

    def construct_P(self):
        n = self.total_size()
        M = np.zeros((n, n))
        M[:13, :13] = self.pxx
        xpos = 13
        for f in self.feats:
            ypos = 0
            M[ypos : ypos + 13, xpos : xpos + f.y.size] = f.pxy
            M[xpos : xpos + f.y.size, ypos : ypos + 13] = f.pxy.T
            ypos = 13
            for blk in f.cross:
                M[ypos : ypos + blk.shape[0], xpos : xpos + f.y.size] = blk
                M[xpos : xpos + f.y.size, ypos : ypos + blk.shape[0]] = blk.T
                ypos += blk.shape[0]
            M[ypos : ypos + f.y.size, xpos : xpos + f.y.size] = f.pyy
            xpos += f.y.size
        return M

    def fill_P(self, M):
        self.pxx = M[:13, :13].copy()
        xpos = 13
        for f in self.feats:
            f.pxy = M[:13, xpos : xpos + f.y.size].copy()
            ypos = 13
            for k in range(len(f.cross)):
                r = f.cross[k].shape[0]
                f.cross[k] = M[ypos : ypos + r, xpos : xpos + f.y.size].copy()
                ypos += r
            f.pyy = M[ypos : ypos + f.y.size, xpos : xpos + f.y.size].copy()
            xpos += f.y.size

    def construct_x(self):
        return np.concatenate([self.xv] + [f.y for f in self.feats])

    def fill_x(self, V):
        self.xv = V[:13].copy()
        pos = 13
        for f in self.feats:
            f.y = V[pos : pos + f.y.size].copy()
            pos += f.y.size

    # ---------------- the step

    def go_one_step(self, frame, enable_mapping=True):
        p = self.p
        prev_pos = self.xv[:3].copy()
        u = np.zeros(3)

        # predict
        fv, F = self.fv_F(self.xv, u, p.delta_t)
        Q = self.Qmat(self.xv, p.delta_t)
        self.xv = fv
        self.pxx = F @ self.pxx @ F.T + Q
        for f in self.feats:
            f.pxy = F @ f.pxy
        self._quantize()

        # select
        xp = self.xv[:7]
        fas = []
        for f in self.feats:
            f.selected = False
            if not f.fully:
                continue
            h, hx7, hy, zeroed = self.hi_full(f.y, xp)
            f.h = h
            f.dh_dy = hy
            f.dh_dxv = np.concatenate([hx7, np.zeros((2, 6))], axis=1)
            f.R = self.cam.noise(h)
            f.S = self.Si(f.pxy, f.pyy, f.dh_dxv, f.dh_dy, f.R)
            if self.visible(f.y, xp, f.xp_org, h) == 0:
                score = np.trace(f.S)
                inserted = False
                for i, (sc, _) in enumerate(fas):
                    if score > sc:
                        fas.insert(i, (score, f))
                        inserted = True
                        break
                if not inserted:
                    fas.append((score, f))
        n_visible = len(fas)
        selected = []
        for sc, f in fas[: p.n_features_to_select]:
            if sc == 0.0:
                break
            f.selected = True
            selected.append(f)

        # measure
        n_succ = 0
        for f in selected:
            L = _cholesky(f.S)
            Linv = np.linalg.inv(L)
            sinv = Linv.T @ Linv
            ok, uu, vv, _ = imp.elliptical_search(
                frame, f.patch, f.h, sinv, p.boxsize, p.no_sigma, p.corr_thresh2,
                p.corr_sigma_thresh, p.search_win_radius,
            )
            f.attempts += 1
            f.success_flag = ok
            if ok:
                f.successes += 1
                f.z = np.array([float(uu), float(vv)])
                f.nu = f.z - f.h
                n_succ += 1

        # update
        if selected and n_succ:
            n = self.total_size()
            x = self.construct_x()
            P = self.construct_P()
            m = 2 * n_succ
            nu_t = np.zeros(m)
            H = np.zeros((m, n))
            R_t = np.zeros((m, m))
            pos = 0
            xpos_of = {}
            xpos = 13
            for f in self.feats:
                xpos_of[id(f)] = xpos
                xpos += f.y.size
            for f in selected:
                if not f.success_flag:
                    continue
                nu_t[pos : pos + 2] = f.nu
                H[pos : pos + 2, :13] = f.dh_dxv
                H[pos : pos + 2, xpos_of[id(f)] : xpos_of[id(f)] + f.y.size] = f.dh_dy
                R_t[pos : pos + 2, pos : pos + 2] = f.R
                pos += 2
            S = H @ P @ H.T + R_t
            L = _cholesky(S)
            Linv = np.linalg.inv(L)
            Sinv = Linv.T @ Linv
            W = P @ H.T @ Sinv
            x = x + W @ nu_t
            P = P - W @ S @ W.T
            self.fill_x(x)
            self.fill_P(P)

            # normalise_state
            J = np.eye(13)
            J[3:7, 3:7] = norm_jac(self.xv[3:7])
            self.pxx = J @ self.pxx @ J.T
            for f in self.feats:
                f.pxy = J @ f.pxy
            self._quantize()

        # delete bad — replicating the reference's exterminate_features
        # iterator bug (monoslam.cpp:663-703): delete_feature's vector::erase
        # invalidates the already-incremented iterator, so the feature right
        # after a deleted one is SKIPPED this frame; its persistent
        # scheduled_for_termination_flag_ survives and it dies on a later
        # pass even if the ratio recovered.
        for f in self.feats:
            if (
                f.attempts >= p.min_attempted_measurements
                and f.successes / f.attempts < p.successful_match_fraction
            ):
                f.sched = True
        skip = False
        for f in list(self.feats):
            if skip:
                skip = False
                continue
            if f.sched:
                self.delete_feature(f)
                skip = True

        # symmetrize
        P = self.construct_P()
        self.fill_P(P * 0.5 + P.T * 0.5)

        # speed + auto init
        pos_now = self.xv[:3]
        speed = np.linalg.norm((pos_now - prev_pos) / p.delta_t)
        did_init = False
        if speed > p.min_speed_for_init and enable_mapping:
            if n_visible < p.n_features_to_keep_visible and len(self.partials) < p.max_features_to_init_at_once:
                did_init = self.auto_initialise(frame)

        did_convert = self.match_partials(frame)
        self._quantize()
        self.trajectory.append(self.xv[:3].copy())
        return dict(r=self.xv[:3].copy(), q=self.xv[3:7].copy(), speed=speed, n_visible=n_visible,
                    n_selected=len(selected), n_matched=n_succ, n_active=len(self.feats),
                    n_partial=len(self.partials), did_init=did_init, did_convert=did_convert)

    def _quantize(self):
        """Every stored number of the filter through self.quantize (none
        without one)."""
        qz = self.quantize
        if qz is None:
            return
        self.xv, self.pxx = qz(self.xv), qz(self.pxx)
        for f in self.feats:
            f.y, f.pxy, f.pyy = qz(f.y), qz(f.pxy), qz(f.pyy)
            f.cross = [qz(c) for c in f.cross]
        for pi in self.partials:
            pi.lam, pi.prob = qz(pi.lam), qz(pi.prob)

    # ---------------- deletion

    def delete_feature(self, f):
        idx = self.feats.index(f)
        for later in self.feats[idx + 1 :]:
            del later.cross[idx]
        self.feats.remove(f)
        self.partials = [pi for pi in self.partials if pi.feat is not f]

    # ---------------- auto init

    def auto_initialise(self, frame):
        p = self.p
        local_xv = self.xv.copy()
        for _ in range(p.init_steps_to_predict):
            local_xv, _ = self.fv_F(local_xv, np.zeros(3), p.delta_t)
        rW = local_xv[:3]
        qWR = local_xv[3:7]
        yW = rW + quat_R(qWR) @ np.array([0.0, 0.0, p.init_depth_hypothesis])
        xp = self.xv[:7]
        h, _, _, _ = self.hi_full(yW, xp)
        if not np.all(np.isfinite(h)):
            return False
        pm_u = self.cam.width / 2.0 - h[0]
        pm_v = self.cam.height / 2.0 - h[1]
        half = (p.boxsize - 1) // 2
        sus = int(-pm_u)
        svs = int(-pm_v)
        suf = int(self.cam.width - pm_u)
        svf = int(self.cam.height - pm_v)
        sus = max(sus, half + 1)
        suf = min(suf, self.cam.width - half - 1)
        svs = max(svs, half + 1)
        svf = min(svf, self.cam.height - half - 1)
        if not (suf - sus > p.init_search_width and svf - svs > p.init_search_height):
            return False
        u_arr, v_arr = [], []
        for f in self.feats:
            if f.fully:
                hh, _, _, zeroed = self.hi_full(f.y, xp)
                if zeroed[2] > 0:
                    u_arr.append(hh[0])
                    v_arr.append(hh[1])
        found = False
        for _try in range(p.init_region_tries):
            u_off = int((suf - sus - p.init_search_width) * self.rng.next())
            v_off = int((svf - svs - p.init_search_height) * self.rng.next())
            us = sus + u_off
            uf = us + p.init_search_width
            vs = svs + v_off
            vf = vs + p.init_search_height
            clash = any(
                uu >= us - p.feature_separation_min
                and uu < uf + p.feature_separation_min
                and vv >= vs - p.feature_separation_min
                and vv < vf + p.feature_separation_min
                for uu, vv in zip(u_arr, v_arr)
            )
            if not clash:
                found = True
                break
        if not found:
            return False
        ub, vb, ev = imp.find_best_patch(frame, p.boxsize, us, vs, uf, vf)
        if ev > p.init_patch_score_thresh:
            if len(self.feats) < p.max_features:
                self.initialise_feature(frame, ub, vb)
            return True
        return False

    def initialise_feature(self, frame, uu, vv):
        p = self.p
        half = (p.boxsize - 1) // 2
        patch = frame[vv - half : vv + half + 1, uu - half : uu + half + 1].copy()
        h = np.array([float(uu), float(vv)])
        xp = self.xv[:7]
        # func_ypi...
        hLR = self.cam.unproject(h)
        norm = np.linalg.norm(hLR)
        hLhat = hLR / norm
        dnorm = norm_jac(hLR)
        RWR = quat_R(xp[3:7])
        hLhatW = RWR @ hLhat
        ypi = np.concatenate([xp[:3], hLhatW])
        dypi_dxp = np.zeros((6, 7))
        dypi_dxp[0:3, 0:3] = np.eye(3)
        dypi_dxp[3:6, 3:7] = dRq_times_a_by_dq(xp[3:7], hLhat)
        dypi_dhi = np.zeros((6, 2))
        dypi_dhi[3:6] = RWR @ dnorm @ self.cam.unproject_jac(h)
        R = self.cam.noise(h)
        J = np.concatenate([dypi_dxp, np.zeros((6, 6))], axis=1)
        pxy = self.pxx @ J.T
        pyy = J @ self.pxx @ J.T + dypi_dhi @ R @ dypi_dhi.T
        cross = [(J @ f.pxy).T for f in self.feats]
        f = Feat(
            y=ypi, pxy=pxy, pyy=pyy, cross=cross, patch=patch,
            xp_org=xp.copy(), label=self.next_label, fully=False,
        )
        self.next_label += 1
        self.feats.append(f)
        lam = np.empty(p.n_particles)
        acc = p.min_lambda
        step = (1.0 / p.n_particles) * (p.max_lambda - p.min_lambda)
        for i in range(p.n_particles):
            lam[i] = acc
            acc += step
        self.partials.append(
            PartInfo(feat=f, lam=lam, prob=np.full(p.n_particles, 1.0 / p.n_particles))
        )

    # ---------------- partial matching

    def zeroedyi_part(self, y, xp):
        r, q = xp[:3], xp[3:7]
        ri, hhat = y[:3], y[3:6]
        ymr = ri - r
        qRW = quat_inverse(q)
        RRW = quat_R(qRW)
        zr = RRW @ ymr
        zh = RRW @ hhat
        d_dxp = np.zeros((6, 7))
        d_dxp[0:3, 0:3] = -RRW
        d_dxp[0:3, 3:7] = dRq_times_a_by_dq(qRW, ymr) @ DQBAR
        d_dxp[3:6, 3:7] = dRq_times_a_by_dq(qRW, hhat) @ DQBAR
        d_dy = np.zeros((6, 6))
        d_dy[0:3, 0:3] = RRW
        d_dy[3:6, 3:6] = RRW
        return np.concatenate([zr, zh]), d_dxp, d_dy

    def match_partials(self, frame):
        p = self.p
        xp = self.xv[:7]
        for pi in self.partials:
            if pi.attempts != 0:
                pi.making = True
                n = len(pi.lam)
                pi.h = np.zeros((n, 2))
                pi.sinv = np.zeros((n, 2, 2))
                pi.dets = np.zeros(n)
                zeroed, dz_dxp, dz_dy = self.zeroedyi_part(pi.feat.y, xp)
                for k in range(n):
                    lam = pi.lam[k]
                    hLR = zeroed[:3] + lam * zeroed[3:6]
                    h = self.cam.project(hLR)
                    J = self.cam.project_jac(hLR)
                    dproj = np.concatenate([np.eye(3), lam * np.eye(3)], axis=1)
                    hx7 = J @ dproj @ dz_dxp
                    hy = J @ dproj @ dz_dy
                    hx = np.concatenate([hx7, np.zeros((2, 6))], axis=1)
                    R = self.cam.noise(h)
                    S = self.Si(pi.feat.pxy, pi.feat.pyy, hx, hy, R)
                    L = _cholesky(S)
                    Linv = np.linalg.inv(L)
                    pi.h[k] = h
                    pi.sinv[k] = Linv.T @ Linv
                    pi.dets[k] = S[0, 0] * S[1, 1] - S[1, 0] * S[0, 1]
            else:
                pi.making = False
            pi.attempts += 1

        for pi in self.partials:
            if pi.making:
                res = imp.multi_ellipse_search(
                    frame, pi.feat.patch, list(pi.h), list(pi.sinv), p.boxsize,
                    p.no_sigma, p.corr_thresh2, p.corr_sigma_thresh, p.low_sigma_penalty,
                    p.particle_win_radius,
                )
                pi.z_ok = np.array([r[0] for r in res])
                pi.z = np.array([[float(r[1]), float(r[2])] for r in res])

        # probability updates
        to_delete = []
        for pi in self.partials:
            if not pi.making:
                continue
            for k in range(len(pi.lam)):
                if pi.z_ok[k]:
                    nu = pi.z[k] - pi.h[k]
                    lik = (1.0 / _sqrt(2 * math.pi * pi.dets[k])) * math.exp(
                        -0.5 * nu @ pi.sinv[k] @ nu
                    )
                else:
                    lik = 0.0
                pi.prob[k] *= lik
            total = pi.prob.sum()
            if total == 0.0:
                to_delete.append(pi)
                continue
            pi.prob /= total
            # prune
            thresh = p.prune_prob_thresh / len(pi.prob)
            keep = pi.prob >= thresh
            pi.lam = pi.lam[keep]
            pi.prob = pi.prob[keep]
            pi.h = pi.h[keep]
            pi.sinv = pi.sinv[keep]
            pi.dets = pi.dets[keep]
            if pi.prob.sum() > 0:
                pi.prob /= pi.prob.sum()
            pi.mean = float((pi.lam * pi.prob).sum())
            pi.cov = float((pi.lam * pi.lam * pi.prob).sum() - pi.mean * pi.mean)
        for pi in to_delete:
            self.delete_feature(pi.feat)

        # conversion
        did_convert = False
        for pi in list(self.partials):
            if pi.making and _sqrt(pi.cov) / pi.mean < p.sd_depth_ratio and len(
                pi.lam
            ) > p.min_particles:
                self.convert(pi)
                self.partials.remove(pi)
                did_convert = True

        # sell-by-date
        for pi in list(self.partials):
            if pi.attempts > p.erase_partial_after_attempts or len(pi.lam) <= p.min_particles:
                self.delete_feature(pi.feat)
        return did_convert

    def convert(self, pi):
        f = pi.feat
        lam = pi.mean
        T = np.concatenate([np.eye(3), lam * np.eye(3)], axis=1)
        b = f.y[3:6].reshape(3, 1)
        yfi = f.y[:3] + lam * f.y[3:6]
        f.pxy = f.pxy @ T.T
        f.pyy = T @ f.pyy @ T.T + b @ np.array([[pi.cov]]) @ b.T
        idx = self.feats.index(f)
        for k in range(len(f.cross)):
            f.cross[k] = f.cross[k] @ T.T
        for later in self.feats[idx + 1 :]:
            later.cross[idx] = T @ later.cross[idx]
        f.y = yfi
        f.fully = True
