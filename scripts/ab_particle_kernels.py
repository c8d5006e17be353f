"""A/B of the particle kernels (K4, K10, K10b, K11, K12, K13, K16) between source trees on one card.

    python3 scripts/ab_particle_kernels.py TREE_A TREE_B TREE_B TREE_A
    python3 scripts/ab_particle_kernels.py --grid TREE

Each TREE is the root of a checkout of this repo (`.` for the working tree;
unpack another commit with `git archive` into a directory that .gitignore
lists). For each TREE, in the order given, a subprocess imports that tree's
scenelib2_torch, builds its kernels there and reports, on the same seeded
inputs, each kernel's device time and a sha256 of its outputs
(scripts/ab_kernels.py). The cases are the shapes the main paths give the
kernels: K4 at the std configuration (100 particles, 320x240, 16 slots) and
at hires (200 particles, 640x480, 60 slots), K10 and K11 over 64 (lane,
slot) blocks of 100 particles (batch64) and over 16 of 200 at 640x480
(batch-hires), K12 over 64 rows of 100 and of 200 particles in both of its
forms, K13 (route sb0) on K11's maps with the positions and S^-1 of K10's
rows, as the step hands them over, and K16 on K13's inputs (its kernel, and
every kernel of one call with their number: the wrapper's tensor
operations). Every kernel keeps its plain twin bit for bit, so all trees must give
equal outputs; the script fails if they do not. Prints the card's name and
power limit, one JSON line per tree, and the median device time of each case
per distinct tree. With --grid, times K4's and K11's cases of TREE at 256,
512 and 1,024 threads a CTA (search_bayes.THREADS) times 1, 2, 4 and 8
CTAs a slot (search_bayes.cluster_size forced; a launch the card refuses is
reported), failing if any output differs from the wrappers' own choice.
With --grid16, times K16's cases of TREE at 256, 512 and 1,024 threads a
CTA (multi_ellipse.THREADS) times 1, 2, 4 and 8 CTAs a slot
(multi_ellipse.ctas_a_slot forced), failing likewise. K10b runs on
seeded slots at 64 x 100, 16 x 200, 8 x 1,100, 4 x 5,120, 2 x 16,384 and
32 x 16,384 particles, beside an empty kernel (predict_measure.cu k0_empty)
on its grid of (slot, block of 128 lanes) and on its first form's grid of
one CTA a slot (a tree whose empty kernel takes no grid lacks those cases).
"""

from __future__ import annotations

import os
import sys

import ab_kernels

SEED = 20
# K10b's cases: (slots, particles)
K10B_CASES = ((64, 100), (16, 200), (8, 1100), (4, 5120), (2, 16384), (32, 16384))


def _cases(dev):
    """(name, kernel symbol, fn) of every timed case; fn() returns the
    kernel's outputs."""
    import numpy as np
    import torch

    from scenelib2_torch.config import Params
    from scenelib2_torch.eval.synthetic import HIRES_PARAMS
    from scenelib2_torch.kernels import bayes, multi_ellipse, particle, particle_search, search_bayes
    from scenelib2_torch.runtime.state import patch_row

    rng = np.random.default_rng(SEED)
    f = dict(dtype=torch.float32, device=dev)
    out = []

    def slots(n):
        # a camera near the origin, rays close to the optical axis, one
        # joint SPD covariance over the camera's first 7 dimensions and the slots
        q = np.array([1.0, *rng.normal(0, 0.02, 3)])
        d = 7 + 6 * n
        M = rng.normal(size=(d, d))
        s = np.sqrt(np.r_[np.full(7, 1e-5), np.full(6 * n, 1e-4)])
        C = s[:, None] * (np.eye(d) + 0.5 * M @ M.T / d) * s[None, :]
        shared = np.concatenate([rng.normal(0, 0.01, 3), q / np.linalg.norm(q), C[:7, :7].ravel()])
        rows = []
        for k in range(n):
            h = np.array([*rng.normal(0, 0.06, 2), 1.0])
            o = 7 + 6 * k
            rows.append(np.concatenate([rng.normal(0, 0.1, 3), h / np.linalg.norm(h), C[:7, o : o + 6].ravel(),
                                        C[o : o + 6, o : o + 6].ravel()]))
        return torch.tensor(shared, **f), torch.tensor(np.stack(rows), **f)

    def lam(NP, n):
        return torch.tensor(np.tile(np.linspace(0.5, 5.0, NP), (n, 1)), **f)

    for tag, p, MF in (("std", Params(), 16), ("hires", Params(**HIRES_PARAMS), 60)):
        NP, H, W, B = p.n_particles, p.cam_height, p.cam_width, p.boxsize
        sbc = search_bayes.SearchBayesConsts.from_params(p)
        shared, rows = slots(1)
        frame = torch.tensor(rng.integers(0, 256, (H, W), dtype=np.uint8), device=dev)
        # the patch planted where the middle depth of the ray projects
        pred = particle.particle_predict_plain(shared[None], rows[None], lam(100, 1)[None],
                                               particle.ParticleConsts.from_params(p))
        u = min(max(int(pred[0, 0, 0, 50]), 20), W - 21)
        v = min(max(int(pred[0, 0, 1, 50]), 20), H - 21)
        patch = frame[v - B // 2 : v + B // 2 + 1, u - B // 2 : u + B // 2 + 1]
        a4 = (frame, torch.full((MF, NP), 1.0 / NP, **f), lam(NP, MF),
              torch.tensor(rng.uniform(size=(MF, NP)) > 0.1, device=dev), torch.tensor([True], device=dev),
              torch.tensor([True], device=dev), torch.tensor([3], dtype=torch.int32, device=dev),
              torch.tensor([1], dtype=torch.int32, device=dev), patch_row(patch), shared, rows[0], sbc)
        out.append((f"K4 {tag} NP {NP}", "k4_kernel", lambda a4=a4: search_bayes.search_bayes(*a4)))

    for tag, p, n in (("", Params(), 64), (" 640x480", Params(**HIRES_PARAMS), 16)):
        NP, H, W = p.n_particles, p.cam_height, p.cam_width
        sbc = search_bayes.SearchBayesConsts.from_params(p)
        shared, rows = slots(n)
        lam11 = lam(NP, n)[:, None]
        a10 = (shared[None].expand(n, 56).contiguous(), rows[:, None], lam11, particle.ParticleConsts.from_params(p))
        out.append((f"K10 {n} slots NP {NP}{tag}", "k10_kernel", lambda a10=a10: (particle.particle_predict(*a10),)))
        pred = particle.particle_predict(*a10)
        maps = torch.tensor(rng.uniform(0.3, 2.0, (n, 1, H, W)), **f)
        ones = torch.ones((n, 1), dtype=torch.bool, device=dev)
        a11 = (maps, pred, torch.tensor(rng.uniform(0.5, 1.5, (n, 1, NP)) / NP, **f), lam11,
               torch.tensor(rng.uniform(size=(n, 1, NP)) > 0.1, device=dev), ones, ones,
               torch.full((n, 1), 3, dtype=torch.int32, device=dev), sbc)
        out.append((f"K11 {n} blocks NP {NP}{tag}", "k11_kernel",
                    lambda a11=a11: search_bayes.search_bayes_maps(*a11)))
        # K13 on the same maps and rows (runtime/step.py, route sb0)
        pr = pred[..., :NP]
        hpi = torch.stack([pr[:, :, particle.ROW_HU], pr[:, :, particle.ROW_HV]], dim=-1)
        sinv = torch.stack([pr[:, :, particle.ROW_S00], pr[:, :, particle.ROW_S01], pr[:, :, particle.ROW_S01],
                            pr[:, :, particle.ROW_S11]], dim=-1).reshape(n, 1, NP, 2, 2)
        a13 = (maps, hpi, sinv, a11[4], particle_search.ParticleSearchConsts.from_params(p))
        out.append((f"K13 {n} blocks NP {NP}{tag}", "k13_kernel",
                    lambda a13=a13: particle_search.particle_search(*a13)))
        # K16 on the same maps and clouds, lanes and slots flattened to slots
        a16 = (maps.reshape(n, H, W), hpi.reshape(n, NP, 2), sinv.reshape(n, NP, 2, 2), a11[4].reshape(n, NP))
        kw16 = dict(win_radius=p.particle_win_radius, no_sigma=p.no_sigma, corr_thresh2=p.corr_thresh2)
        for sym, what in (("k16_kernel", ""), (None, " call")):
            out.append((f"K16 {n} slots NP {NP}{tag}{what}", sym,
                        lambda a16=a16, kw16=kw16: multi_ellipse.multi_ellipse_search(*a16, **kw16)))

    # K10b on seeded slots (the geometry K10's prologue gives them), and an
    # empty kernel on K10b's grid and on its first form's (one CTA a slot)
    pc = particle.ParticleConsts.from_params(Params())
    empty = _empty_on_grid()
    for n, NP in K10B_CASES:
        shared, rows = slots(n)
        zr, zh, K0, Ks, K2 = particle.geometry_prologue(shared[None, None], rows[None])
        a10b = (torch.cat([zr, zh], -1).reshape(n, 6), K0.reshape(n, 3, 3), Ks.reshape(n, 3, 3),
                K2.reshape(n, 3, 3), lam(NP, n), pc)
        out.append((f"K10b {n} slots NP {NP}", "k10b_kernel",
                    lambda a10b=a10b: (particle.kform_rows(*a10b),)))
        if empty is not None:
            blocks = bayes.padded_lanes(NP) // 128
            for tag_, nb in (("grid", blocks), ("first-form grid", 1)):
                out.append((f"empty {tag_} {n} x {nb}", "k0_empty",
                            lambda n=n, nb=nb: _launch_empty(empty, n, nb)))

    p = Params()
    n = 64
    for NP in (100, 200):
        bc = bayes.BayesConsts.from_params(p)
        lanes = bayes.padded_lanes(NP)

        def t(a):
            return torch.tensor(a, **f)

        common = (t(rng.uniform(0.005, 0.02, (n, NP))), t(np.tile(np.linspace(0.5, 5.0, NP), (n, 1))),
                  torch.tensor(rng.uniform(size=(n, NP)) > 0.1, device=dev),
                  torch.tensor(rng.uniform(size=(n, NP)) > 0.6, device=dev),
                  torch.tensor(rng.uniform(size=(n, NP)) > 0.95, device=dev), t(rng.uniform(100, 115, (n, NP, 2))))
        tail = (torch.ones(n, dtype=torch.bool, device=dev), torch.ones(n, dtype=torch.bool, device=dev),
                torch.full((n,), 3, dtype=torch.int32, device=dev), bc)
        geo = (t(rng.uniform(100, 115, (n, NP, 2))), t(np.tile([[0.05, 0.01], [0.01, 0.04]], (n, NP, 1, 1))),
               t(rng.uniform(300, 600, (n, NP))))
        pr = t(rng.uniform(0.01, 0.06, (n, 8, lanes)))
        pr[:, 0:2] = t(rng.uniform(100, 115, (n, 2, lanes)))
        pr[:, 5] = t(rng.uniform(300, 600, (n, lanes)))
        out.append((f"K12 64 rows NP {NP}", "k12_kernel",
                    lambda common=common, geo=geo, tail=tail: bayes.bayes_update(*common, *geo, *tail)))
        out.append((f"K12 pred 64 rows NP {NP}", "k12_kernel",
                    lambda common=common, pr=pr, tail=tail: bayes.bayes_update(*common, None, None, None, *tail,
                                                                                 pred_rows=pr)))
    return out


def _empty_on_grid():
    """The tree's empty kernel launched on a grid (csrc/predict_measure.cu
    k0_empty_launch), None where its launcher takes no grid."""
    import ctypes

    from scenelib2_torch.kernels import _build

    with open(os.path.join(_build.CSRC, "predict_measure.cu")) as f:
        if "k0_empty_launch(int gx" not in f.read():
            return None
    return _build.function("predict_measure", "k0_empty_launch", [ctypes.c_int] * 3 + [ctypes.c_void_p])


def _launch_empty(fn, F, blocks):
    import torch

    from scenelib2_torch.kernels import _build

    _build.check(fn(F, blocks, 128, torch.cuda.current_stream().cuda_stream), "empty launch")
    return (torch.zeros(1),)


def _grid(tree: str) -> int:
    """K4's and K11's cases of `tree` at each grid shape, in this process."""
    import subprocess

    import torch

    sys.path.insert(0, os.path.abspath(tree))
    from scenelib2_torch.kernels import _build, search_bayes

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()
    print(smi[0] if smi else "nvidia-smi: no card")
    dev = torch.device("cuda")
    cases = [c for c in _cases(dev) if c[0].startswith(("K4", "K11"))]
    threads, choice = search_bayes.THREADS, search_bayes.cluster_size
    digests = {}
    for forced in [None] + [(t, cs) for t in (256, 512, 1024) for cs in (1, 2, 4, 8)]:
        search_bayes.THREADS = threads if forced is None else forced[0]
        search_bayes.cluster_size = choice if forced is None else (lambda n, sms, f=forced[1]: f)
        for name, sym, fn in cases:
            try:
                d = ab_kernels._digest(fn())
            except RuntimeError as e:          # a cluster the card cannot place
                print(f"{name:<30} forced {forced}: refused ({e})", flush=True)
                continue
            if digests.setdefault(name, d) != d:
                print(f"{name}: outputs at grid {forced} differ", file=sys.stderr)
                return 1
            NP, n_slots = (fn.__defaults__[0][1].shape[-1], 1) if name.startswith("K4") else \
                (fn.__defaults__[0][2].shape[-1], fn.__defaults__[0][2].shape[0])
            shape = (f"{search_bayes.block_threads(NP)} threads, "
                     f"{search_bayes.cluster_size(n_slots, _build.n_sms(dev))} CTAs a slot")
            shape = ("choice: " if forced is None else "forced: ") + shape
            print(f"{name:<30} {shape:<40} {ab_kernels._device_ms(fn, sym) * 1e3:9.3f} us", flush=True)
    return 0


def _grid16(tree: str) -> int:
    """K16's cases of `tree` at each CTA size and CTAs a slot, in this process."""
    import subprocess

    import torch

    sys.path.insert(0, os.path.abspath(tree))
    from scenelib2_torch.kernels import _build, multi_ellipse

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()
    print(smi[0] if smi else "nvidia-smi: no card")
    dev = torch.device("cuda")
    cases = [c for c in _cases(dev) if c[0].startswith("K16") and c[1] is not None]
    threads, choice = multi_ellipse.THREADS, multi_ellipse.ctas_a_slot
    digests = {}
    for forced in [None] + [(t, cs) for t in (256, 512, 1024) for cs in (1, 2, 4, 8)]:
        multi_ellipse.THREADS = threads if forced is None else forced[0]
        multi_ellipse.ctas_a_slot = choice if forced is None else (lambda n, sms, f=forced[1]: f)
        for name, sym, fn in cases:
            d = ab_kernels._digest(fn())
            if digests.setdefault(name, d) != d:
                print(f"{name}: outputs at grid {forced} differ", file=sys.stderr)
                return 1
            n_slots = fn.__defaults__[0][3].shape[0]
            shape = (f"{multi_ellipse.THREADS} threads, "
                     f"{multi_ellipse.ctas_a_slot(n_slots, _build.n_sms(dev))} CTAs a slot")
            shape = ("choice: " if forced is None else "forced: ") + shape
            print(f"{name:<34} {shape:<40} {ab_kernels._device_ms(fn, sym) * 1e3:9.3f} us", flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--grid"]:
        sys.exit(_grid(sys.argv[2]))
    if sys.argv[1:2] == ["--grid16"]:
        sys.exit(_grid16(sys.argv[2]))
    sys.exit(ab_kernels.run(sys.argv[1:], os.path.abspath(__file__), _cases))
