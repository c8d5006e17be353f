"""K13: the particle-cloud search over precomputed score maps.

Replaces the TPU kernel scenelib2_tpu/kernels/pallas_particle_search.py
(``pallas_multi_ellipse_search`` / ``_kernel``, pallas_call at
pallas_particle_search.py:206), stage 8 of the batch step on the route with
SCENELIB2_BATCH_SB=0 (reference SearchMultipleOverlappingEllipses,
search_multiple_overlapping_ellipses.cpp:106-196). For every particle of
every (lane, partial slot), from its predicted position and S^-1:

  the geometry, which the TPU wrapper computes outside its kernel
  (pallas_particle_search.py:158-176) and this kernel inside, with XLA's int32 semantics
  (correlate.particle_geometry: trunc / floor converted with NaN -> 0 and
  saturation, sums wrapping): the clamped window of side 2R + 1 and the
  effective region [v_lo, v_hi) x [u_lo, u_hi), the window cut to the
  ellipse's 3-sigma box; overflow = a half-extent above R;
  over the region's cells inside the ellipse, the minimum of
  the slot's score map against the 1e6 of a masked cell (NaN if such a cell
  is NaN) and the largest key u*H + v among the cells at the minimum;
  found = alive & best <= corr_thresh2; (u, v) = (key // H, key % H).

Its results equal correlate.multi_ellipse_search_dense's wherever the
half-extents fit int32 (the TPU kernel's docstring; the CPU tests hold
both). The key stays int32 (JAX passes it through f32, exact below 2^24).

Bound on an H100 at 64 lanes x 100 particles (bytes_and_flops): the map
cells under each slot's live regions (their union) read once and ~10
operations per cell of each particle's region; a converged cloud's regions
are a few hundred cells each and overlap, so well under a microsecond. The
launch, one chain of loads a particle and the host glue set the time.
Design (csrc/particle_search.cu, K11's search with K13's semantics):
the wrapper checks, allocates the outputs and launches once with the inputs
as they are; the kernel computes the geometry (region_geometry's int32
semantics), cluster_size CTAs a (lane, slot) each stage the read box (the
bounding box of the live particles' regions) where it fits and take every
cluster-th particle, a warp a particle walking its region row by row, one
64-bit key a cell. region_geometry and _results stay as the plain
version's code; region_cells and bytes_and_flops count the bound.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from scenelib2_torch.kernels import _build
from scenelib2_torch.kernels.correlate import (
    MISS,
    ellipse_mask,
    particle_geometry,
    window_search,
    wrap_i32,
)
from scenelib2_torch.kernels.search_bayes import cluster_size

NAME = "particle_search"
GEOM_OPS = 24   # a particle's geometry: two conversions, two roots and divisions, the clamps and wrapped sums


@dataclass(frozen=True)
class ParticleSearchConsts:
    H: int
    W: int
    win_radius: int
    no_sigma: float
    corr_thresh2: float

    @staticmethod
    def from_params(p) -> "ParticleSearchConsts":
        return ParticleSearchConsts(H=p.cam_height, W=p.cam_width, win_radius=p.particle_win_radius,
                                    no_sigma=p.no_sigma, corr_thresh2=p.corr_thresh2)

    @property
    def side_u(self) -> int:
        return min(2 * self.win_radius + 1, self.W)

    @property
    def side_v(self) -> int:
        return min(2 * self.win_radius + 1, self.H)


def region_geometry(h_centres, sinv, alive, c: ParticleSearchConsts):
    """(geo [..., P, 7] int32: uc, vc, v_lo, v_hi, u_lo, u_hi, alive; abc
    [..., P, 3] f32; over [..., P] bool; u0, v0 [..., P] int64 window
    origins) of every particle, as pallas_particle_search.py:158-176."""
    uc, vc, hw, hh, u0, v0, a, b, cc = particle_geometry(h_centres, sinv, c.win_radius, c.no_sigma,
                                                         c.H, c.W)
    R = c.win_radius
    over = (hw > R) | (hh > R)
    v_lo = torch.maximum(v0, wrap_i32(vc - hh))
    v_hi = torch.minimum(v0 + c.side_v, wrap_i32(wrap_i32(vc + hh) + 1))
    u_lo = torch.maximum(u0, wrap_i32(uc - hw))
    u_hi = torch.minimum(u0 + c.side_u, wrap_i32(wrap_i32(uc + hw) + 1))
    geo = torch.stack([uc, vc, v_lo, v_hi, u_lo, u_hi, alive.to(torch.int64)], dim=-1).to(torch.int32)
    return geo, torch.stack([a, b, cc], dim=-1), over, u0, v0


def _results(best, key, alive, over, c: ParticleSearchConsts):
    key = key.to(torch.int64)
    found = alive & (best <= c.corr_thresh2)
    u = torch.div(key, c.H, rounding_mode="floor").to(torch.int32)
    v = torch.remainder(key, c.H).to(torch.int32)
    return found, u, v, over & alive


def particle_search_plain(corr_maps, h_centres, sinv, alive, c: ParticleSearchConsts):
    """Plain PyTorch K13. corr_maps [B, F, H, W] f32 (the slots' score
    maps); h_centres [B, F, P, 2]; sinv [B, F, P, 2, 2] f32; alive [B, F, P]
    bool. Returns (found, u, v, overflow), each [B, F, P] (u, v int32).
    Every cell of a particle's region lies in its window, so the search
    gathers the windows (correlate.window_search) and masks the region."""
    geo, abc, over, u0, v0 = region_geometry(h_centres, sinv, alive, c)
    g = geo.to(torch.int64)
    uc, vc, v_lo, v_hi, u_lo, u_hi = (g[..., i] for i in range(6))

    def mask_fn(uu, vv):
        def e(t):
            return t[..., None, None]

        region = (uu >= e(u_lo)) & (uu < e(u_hi)) & (vv >= e(v_lo)) & (vv < e(v_hi))
        return region & ellipse_mask(abc[..., 0], abc[..., 1], abc[..., 2], uc, vc, uu, vv, c.no_sigma)

    best, key = window_search(corr_maps, u0, v0, c.side_v, c.side_u, mask_fn)
    best = torch.where(alive, best, torch.full_like(best, MISS))
    key = torch.where(alive, key, torch.full_like(key, -1))
    return _results(best, key, alive, over, c)


class _K13Params(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_int) for n in ("H", "W", "P", "win_radius", "side_u", "side_v", "cluster",
                                             "stage")]
                + [(n, ctypes.c_float) for n in ("no_sigma", "no_sigma2", "corr_thresh2")])


# tensor pointers (maps, h_centres, sinv, alive; found, u, v, over), the
# (lane, slot) pairs, the params struct, the stream
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.POINTER(_K13Params), ctypes.c_void_p]


def particle_search(corr_maps, h_centres, sinv, alive, c: ParticleSearchConsts):
    """K13. CPU tensors take the plain version; CUDA tensors launch the
    kernel (or raise). Same outputs as particle_search_plain: one launch for
    all lanes and slots, and no other tensor operation."""
    if corr_maps.device.type == "cpu":
        return particle_search_plain(corr_maps, h_centres, sinv, alive, c)
    Bn, Fn = corr_maps.shape[:2]
    P = alive.shape[-1]
    for t, name, dty, shp in ((corr_maps, "corr_maps", torch.float32, (Bn, Fn, c.H, c.W)),
                              (h_centres, "h_centres", torch.float32, (Bn, Fn, P, 2)),
                              (sinv, "sinv", torch.float32, (Bn, Fn, P, 2, 2)),
                              (alive, "alive", torch.bool, (Bn, Fn, P))):
        _build.check_tensor(t, name, dty, shp)
    dev = corr_maps.device
    found = torch.empty((Bn, Fn, P), dtype=torch.bool, device=dev)
    u = torch.empty((Bn, Fn, P), dtype=torch.int32, device=dev)
    v = torch.empty((Bn, Fn, P), dtype=torch.int32, device=dev)
    over = torch.empty((Bn, Fn, P), dtype=torch.bool, device=dev)
    fn = _build.function(NAME, "k13_particle_search", _ARGTYPES)
    prm = _K13Params(H=c.H, W=c.W, P=P, win_radius=c.win_radius, side_u=c.side_u, side_v=c.side_v,
                     cluster=cluster_size(Bn * Fn, _build.n_sms(dev)), stage=0,
                     no_sigma=c.no_sigma, no_sigma2=c.no_sigma * c.no_sigma, corr_thresh2=c.corr_thresh2)
    err = fn(*(t.data_ptr() for t in (corr_maps, h_centres, sinv, alive, found, u, v, over)), Bn * Fn,
             ctypes.byref(prm), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "K13 particle_search")
    _build.launches[NAME] += 1
    return found, u, v, over


def region_cells(h_centres, sinv, alive, c: ParticleSearchConsts) -> tuple[int, int]:
    """The data-dependent work of one K13 call on these inputs: (map cells
    read, each slot's union of its live particles' regions counted once;
    cells searched, the live regions' cells summed over particles)."""
    geo = region_geometry(h_centres, sinv, alive, c)[0].to(torch.int64).cpu()
    geo = geo.reshape(-1, *geo.shape[-2:])                       # [slots, P, 7]
    v_lo, v_hi, u_lo, u_hi, live = (geo[..., i] for i in range(2, 7))
    some = (live != 0) & (v_hi > v_lo) & (u_hi > u_lo)
    n_searched = int(((v_hi - v_lo) * (u_hi - u_lo))[some].sum())
    # the union per slot: +1 / -1 at each live region's corners, then a 2-D prefix sum
    slot = torch.arange(geo.shape[0])[:, None].expand_as(some)[some]
    cover = torch.zeros((geo.shape[0], c.H + 1, c.W + 1), dtype=torch.int32)
    for vv, uu, sign in ((v_lo, u_lo, 1), (v_lo, u_hi, -1), (v_hi, u_lo, -1), (v_hi, u_hi, 1)):
        cover.index_put_((slot, vv[some], uu[some]), torch.full(slot.shape, sign, dtype=torch.int32),
                         accumulate=True)
    n_read = int((cover.cumsum(1).cumsum(2) > 0).sum())
    return n_read, n_searched


def bytes_and_flops(Bn: int, Fn: int, P: int, n_read: int, n_searched: int) -> tuple[int, int]:
    """Least bytes and operations of one K13 call with this run's data
    (region_cells): the n_read map cells under the slots' live regions read
    once, each particle's position, S^-1 and alive flag in and found, u, v,
    overflow out; its geometry (GEOM_OPS) and ~10 operations per cell of
    each particle's search (the ellipse test and the comparison)."""
    per = 2 * 4 + 4 * 4 + 1 + 1 + 4 + 4 + 1
    return 4 * n_read + Bn * Fn * P * per, Bn * Fn * P * GEOM_OPS + 10 * n_searched
