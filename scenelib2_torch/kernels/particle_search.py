"""K13: the particle-cloud search over precomputed score maps.

Replaces the TPU kernel scenelib2_tpu/kernels/pallas_particle_search.py
(``pallas_multi_ellipse_search`` / ``_kernel``, pallas_call at
pallas_particle_search.py:206), stage 8 of the batch step on the route with
SCENELIB2_BATCH_SB=0 (reference SearchMultipleOverlappingEllipses,
search_multiple_overlapping_ellipses.cpp:106-196). For every particle of
every (lane, partial slot), from its predicted position and S^-1:

  the geometry, in the wrapper as the TPU wrapper computes it outside its
  kernel (pallas_particle_search.py:158-176), with XLA's int32 semantics
  (correlate.particle_geometry: trunc / floor converted with NaN -> 0 and
  saturation, sums wrapping): the clamped window of side 2R + 1 and the
  effective region [v_lo, v_hi) x [u_lo, u_hi), the window cut to the
  ellipse's 3-sigma box; overflow = a half-extent above R;
  in the kernel: over the region's cells inside the ellipse, the minimum of
  the slot's score map against the 1e6 of a masked cell (NaN if such a cell
  is NaN) and the largest key u*H + v among the cells at the minimum;
  found = alive & best <= corr_thresh2; (u, v) = (key // H, key % H).

Its results equal correlate.multi_ellipse_search_dense's wherever the
half-extents fit int32 (the TPU kernel's docstring; the CPU tests hold
both). The key stays int32 (JAX passes it through f32, exact below 2^24).

Bound on an H100 at 64 lanes x 100 particles: the map cells under each
slot's live regions (their union) read once and ~10 operations per cell of
each particle's region; a converged cloud's regions are a few hundred cells
each and overlap, so a few microseconds at most. Design
(csrc/particle_search.cu): one block per (lane, slot), one warp per
particle, the lanes striding over the particle's region in the map in
global memory, one warp reduction (the minimum, then the largest key).
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

NAME = "particle_search"
N_GEO = 7   # uc, vc, v_lo, v_hi, u_lo, u_hi, alive


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
    _fields_ = [("H", ctypes.c_int), ("W", ctypes.c_int), ("P", ctypes.c_int),
                ("no_sigma2", ctypes.c_float)]


# tensor pointers (maps, geo, abc, best, key), the (lane, slot) blocks, the params struct, the stream
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.POINTER(_K13Params), ctypes.c_void_p]


def particle_search(corr_maps, h_centres, sinv, alive, c: ParticleSearchConsts):
    """K13. CPU tensors take the plain version; CUDA tensors launch the
    kernel (or raise). Same outputs as particle_search_plain; one launch for
    all lanes and slots."""
    if corr_maps.device.type == "cpu":
        return particle_search_plain(corr_maps, h_centres, sinv, alive, c)
    Bn, Fn, H, W = corr_maps.shape
    P = alive.shape[-1]
    geo, abc, over, _u0, _v0 = region_geometry(h_centres, sinv, alive, c)
    maps, geo, abc = corr_maps.contiguous(), geo.contiguous(), abc.contiguous()
    _build.check_tensor(maps, "corr_maps", torch.float32, (Bn, Fn, c.H, c.W))
    _build.check_tensor(geo, "geo", torch.int32, (Bn, Fn, P, N_GEO))
    _build.check_tensor(abc, "abc", torch.float32, (Bn, Fn, P, 3))
    dev = corr_maps.device
    best = torch.empty((Bn, Fn, P), dtype=torch.float32, device=dev)
    key = torch.empty((Bn, Fn, P), dtype=torch.int32, device=dev)
    prm = _K13Params(H=c.H, W=c.W, P=P, no_sigma2=c.no_sigma * c.no_sigma)
    fn = _build.function(NAME, "k13_particle_search", _ARGTYPES)
    err = fn(maps.data_ptr(), geo.data_ptr(), abc.data_ptr(), best.data_ptr(), key.data_ptr(), Bn * Fn,
             ctypes.byref(prm), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "K13 particle_search")
    _build.launches[NAME] += 1
    return _results(best, key, alive, over, c)


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
    once, the per-particle geometry in and best / key out; ~10 operations
    per cell of each particle's search (the ellipse test and the
    comparison)."""
    return 4 * n_read + Bn * Fn * P * (N_GEO * 4 + 3 * 4 + 4 + 4), 10 * n_searched
