"""The image operations of the batch route with batch_pallas=False and of
the pure-XLA route (use_pallas=False), as tensor operations (no kernel of
their own).

Port of the parts of scenelib2_tpu/kernels/correlate.py that those routes
run (frame_sums, cross_sum_maps, cross_sum_windows, patch_stats,
nssd_score, elliptical_search_batch, penalized_score_map,
multi_ellipse_search_dense, which the single stream's XLA route also runs
in place of multi_ellipse_search_unionbox) and of gather_windows_u8
(scenelib2_tpu/kernels/pallas_search.py:639-653). Each runs in the step's
dtype: f32 in the fast mode (the JAX package's astype(float64) is f32
there) and f64 in the parity mode (precision="f64"), where frame_sums and
patch_stats hand the exact integer sums on as f64 and the NSSD, the score
maps, the ellipse masks and the particle geometry follow in f64, as the
JAX functions do with x64 on. Every leading dimension is a lane (or a lane
and a slot).

Integer sums stay exact: the box sums and the patch cross sums are float64
convolutions of u8 data (every partial sum is an integer below 2^53, and
the results, below 2^24, convert to f32 and int32 exactly); nothing here
runs a TF32 convolution.

multi_ellipse_search_dense keeps the JAX form's semantics (per particle: the
window clamp, the 3-sigma box, the ellipse, the masked minimum against the
1e6 of a masked cell and the last tie in u-outer / v-inner order) but not
its [P, H, W] masks: every cell the dense mask admits lies in the
particle's clamped side_v x side_u window, so the search gathers that
window ([B, F, P, 65, 65]: ~108 MB of f32 at 64 lanes x 100 particles,
where [B, F, P, 240, 320] would be ~2 GB a temporary) and adds the 1e6 of
the cells outside it to the minimum. min and the last-tie max are
order-free, so the results are the dense form's.

xla_i32 and wrap_i32 give XLA's integer semantics: a float converts to
int32 with NaN -> 0 and saturation at the int32 range, and int32 sums wrap.
A degenerate S (NaN or huge half-extents) reaches these casts.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from scenelib2_torch.kernels.search import nssd_corr_f32

MISS = 1e6
I32_MIN, I32_MAX = -(2**31), 2**31 - 1


def xla_i32(v: torch.Tensor) -> torch.Tensor:
    """astype(int32) as XLA converts: NaN -> 0, out-of-range values
    saturate. Returns int64 holding the int32 values (so that later sums can
    wrap as int32 with wrap_i32)."""
    return torch.nan_to_num(v.double(), nan=0.0).clamp(I32_MIN, I32_MAX).to(torch.int64)


def wrap_i32(v: torch.Tensor) -> torch.Tensor:
    """An int64 tensor reduced to int32 with two's-complement wrap-around,
    still as int64."""
    return ((v - I32_MIN) & 0xFFFFFFFF) + I32_MIN


def _box_f64(x: torch.Tensor, w: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """VALID correlation of x [N, C, H, W] with w [O, 1, b, b], in float64."""
    return F.conv2d(x.double(), w.double(), groups=groups)


def _centre_pad(m: torch.Tensor, H: int, W: int, half: int) -> torch.Tensor:
    """A VALID map [..., H - 2 half, W - 2 half] padded with zeros to the
    centre-indexed [..., H, W]."""
    return F.pad(m, (half, W - m.shape[-1] - half, half, H - m.shape[-2] - half))


def centre_valid(H: int, W: int, boxsize: int, device) -> torch.Tensor:
    """[H, W] bool: the centres whose boxsize^2 patch lies inside the frame."""
    half = (boxsize - 1) // 2
    uu = torch.arange(W, device=device)[None, :]
    vv = torch.arange(H, device=device)[:, None]
    return (uu >= half) & (uu <= W - 1 - half) & (vv >= half) & (vv <= H - 1 - half)


def frame_sums(frames_u8: torch.Tensor, boxsize: int, dtype=torch.float32):
    """(sg1, sg1sq [B, H, W] box sums of the image and its square,
    centre-indexed, 0 at invalid centres; valid [H, W]) of frames [B, H, W].
    The sums are exact integers below 2^24, handed on as `dtype`."""
    Bn, H, W = frames_u8.shape
    half = (boxsize - 1) // 2
    img = frames_u8[:, None].double()
    ones = torch.ones((1, 1, boxsize, boxsize), dtype=torch.float64, device=frames_u8.device)
    sg1 = _centre_pad(_box_f64(img, ones)[:, 0], H, W, half).to(dtype)
    sg1sq = _centre_pad(_box_f64(img * img, ones)[:, 0], H, W, half).to(dtype)
    return sg1, sg1sq, centre_valid(H, W, boxsize, frames_u8.device)


def cross_sum_maps(frames_u8: torch.Tensor, patches_u8: torch.Tensor, boxsize: int) -> torch.Tensor:
    """Sg0g1 of every lane's patches at every centre: frames [B, H, W],
    patches [B, F, b, b] u8 -> [B, F, H, W] int32 (0 at invalid centres)."""
    Bn, H, W = frames_u8.shape
    Fn = patches_u8.shape[1]
    half = (boxsize - 1) // 2
    w = patches_u8.reshape(Bn * Fn, 1, boxsize, boxsize)
    x = frames_u8[None]
    if Fn > 1:
        x = x.repeat_interleave(Fn, dim=1)
    out = _box_f64(x, w, groups=Bn * Fn)[0].reshape(Bn, Fn, H - 2 * half, W - 2 * half)
    return _centre_pad(out, H, W, half).to(torch.int32)


def cross_sum_windows(frames_u8: torch.Tensor, patches_u8: torch.Tensor, u0: torch.Tensor,
                      v0: torch.Tensor, win_radius: int, boxsize: int) -> torch.Tensor:
    """Sg0g1 of each selected feature's patch on its own search window only
    (correlate.py:177-214): frames [B, H, W], patches [B, K, b, b] u8, the
    window origins u0, v0 [B, K] of search.search_window_origin -> [B, K,
    side_v, side_u] int32. The JAX function gathers the windows by
    dynamic_slice or, with Params.index_gather, by one index grid; both read
    the same pixels, since the origins keep every window inside its frame,
    so one gather stands for both."""
    Bn, K = patches_u8.shape[:2]
    wins = gather_windows_u8(frames_u8, u0, v0, win_radius, boxsize)
    sw_v, sw_u = wins.shape[-2:]
    out = _box_f64(wins.reshape(1, Bn * K, sw_v, sw_u),
                   patches_u8.reshape(Bn * K, 1, boxsize, boxsize), groups=Bn * K)
    return out[0].reshape(Bn, K, sw_v - boxsize + 1, sw_u - boxsize + 1).to(torch.int32)


def patch_stats(patches_u8: torch.Tensor, dtype=torch.float32):
    """Per patch (Sg0, Sg0sq), exact integer sums handed on as `dtype`:
    patches [..., b, b] u8 -> [...]."""
    p = patches_u8.to(torch.int32)
    return p.sum(dim=(-2, -1)).to(dtype), (p * p).sum(dim=(-2, -1)).to(dtype)


def nssd_score(sg0, sg0sq, sg1, sg1sq, sg0g1, n: float):
    """(corr, sd0, sd1) of correlate.nssd_score in the dtype of sg1, with
    the 0/1 zero-variance specials: search.nssd_corr_f32's operations in the
    same order, which are the JAX function's (f32 in the fast mode, f64 in
    the parity mode)."""
    nt = torch.full((), n, dtype=sg1.dtype, device=sg1.device)
    return nssd_corr_f32(sg0, sg0sq, sg1, sg1sq, sg0g1.to(sg1.dtype), nt)


def elliptical_search_batch(sg1, sg1sq, cross_win, sg0, sg0sq, u0, v0, h_centre, sinv_abc, active,
                            boxsize: int, *, win_radius: int = 32, no_sigma: float = 3.0,
                            corr_thresh2: float = 0.40, corr_sigma_thresh: float = 10.0):
    """The reference's elliptical search (monoslam.cpp:401-477) for every
    selected feature of every lane on its window of precomputed sums:
    correlate.py:266-319. sg1, sg1sq [B, H, W] (frame_sums); cross_win [B, K,
    side_v, side_u] int32 (cross_sum_windows); sg0, sg0sq [B, K]
    (patch_stats); u0, v0 [B, K] window origins; h_centre [B, K, 2];
    sinv_abc [B, K, 3] the entries (a, b, c) of S^-1; active [B, K] bool.

    A window cell is a candidate where it lies in the 3-sigma box and the
    ellipse about floor(h + 0.5), its patch lies inside the frame, and both
    the image and the patch deviation reach corr_sigma_thresh. The best is
    the masked minimum (1e6 where no cell is a candidate) with the
    reference's tie-break: the last candidate of the u-outer / v-inner scan,
    i.e. the largest u * H + v (_masked_min_last_tie_win). overflow marks a
    box wider than the window, found a best <= corr_thresh2; both only where
    active. Returns (found, u, v, best, overflow), each [B, K]; the floats
    take the dtype of sg1."""
    Bn, H, W = sg1.shape
    half = (boxsize - 1) // 2
    side_v, side_u = cross_win.shape[-2:]
    dev, dt = sg1.device, sg1.dtype
    a, b, c = sinv_abc[..., 0], sinv_abc[..., 1], sinv_abc[..., 2]
    ns = torch.full((), no_sigma, dtype=dt, device=dev)
    hw = xla_i32(torch.floor(ns / torch.sqrt(a - b * b / c)))
    hh = xla_i32(torch.floor(ns / torch.sqrt(c - b * b / a)))
    uc = xla_i32(torch.floor(h_centre[..., 0] + 0.5))
    vc = xla_i32(torch.floor(h_centre[..., 1] + 0.5))
    uu = u0.long()[..., None, None] + torch.arange(side_u, device=dev)            # [B, K, 1, su]
    vv = v0.long()[..., None, None] + torch.arange(side_v, device=dev)[:, None]   # [B, K, sv, 1]
    bi = torch.arange(Bn, device=dev).reshape(Bn, 1, 1, 1)
    n = torch.full((), float(boxsize * boxsize), dtype=dt, device=dev)
    corr, sd0, sd1 = nssd_corr_f32(sg0[..., None, None], sg0sq[..., None, None], sg1[bi, vv, uu],
                                   sg1sq[bi, vv, uu], cross_win.to(dt), n)
    urel = wrap_i32(uu - uc[..., None, None]).to(dt)
    vrel = wrap_i32(vv - vc[..., None, None]).to(dt)
    box = (torch.abs(urel) <= hw.to(dt)[..., None, None]) & (torch.abs(vrel) <= hh.to(dt)[..., None, None])
    centre_ok = (uu >= half) & (uu <= W - 1 - half) & (vv >= half) & (vv <= H - 1 - half)
    mask = (box & ellipse_mask(a, b, c, uc, vc, uu, vv, no_sigma) & centre_ok
            & (sd1 >= corr_sigma_thresh) & (sd0 >= corr_sigma_thresh))
    vals = torch.where(mask, corr, torch.full_like(corr, MISS)).flatten(-2)
    best = vals.amin(dim=-1)
    key = (uu * H + vv).expand(mask.shape).flatten(-2)
    tie = (vals == best[..., None]) & mask.flatten(-2)
    kbest = torch.where(tie, key, torch.full_like(key, -1)).amax(dim=-1)
    u = torch.div(kbest, H, rounding_mode="floor").to(torch.int32)
    v = torch.remainder(kbest, H).to(torch.int32)
    over = (hw > win_radius) | (hh > win_radius)
    found = active & (best <= corr_thresh2)
    return found, u, v, best, over & active


def penalized_score_map(sg1, sg1sq, valid, cross_map, sg0, sg0sq, boxsize: int,
                        corr_sigma_thresh: float, low_sigma_penalty: float) -> torch.Tensor:
    """The particle search's score map: the NSSD, + low_sigma_penalty where
    the image deviation is below the threshold, 1e6 at an invalid centre.
    sg1, sg1sq [B, 1, H, W]; cross_map [B, F, H, W]; sg0, sg0sq [B, F, 1, 1];
    valid [H, W]. Returns [B, F, H, W] in the dtype of sg1."""
    corr, _sd0, sd1 = nssd_score(sg0, sg0sq, sg1, sg1sq, cross_map, float(boxsize * boxsize))
    corr = torch.where(sd1 < corr_sigma_thresh, corr + low_sigma_penalty, corr)
    return torch.where(valid, corr, torch.full_like(corr, MISS))


def score_maps(frames_u8: torch.Tensor, patches_u8: torch.Tensor, boxsize: int,
               corr_sigma_thresh: float, low_sigma_penalty: float, dtype=torch.float32) -> torch.Tensor:
    """The JAX step's XLA score maps (step.py:609-620): frames [B, H, W],
    the partial slots' patches [B, F, b, b] -> [B, F, H, W] in `dtype`."""
    sg1, sg1sq, valid = frame_sums(frames_u8, boxsize, dtype)
    cross = cross_sum_maps(frames_u8, patches_u8, boxsize)
    sg0, sg0sq = patch_stats(patches_u8, dtype)
    return penalized_score_map(sg1[:, None], sg1sq[:, None], valid, cross, sg0[..., None, None],
                               sg0sq[..., None, None], boxsize, corr_sigma_thresh, low_sigma_penalty)


def particle_geometry(h_centres, sinv, win_radius: int, no_sigma: float, H: int, W: int):
    """The per-particle integers of the dense search and of the
    multi-ellipse kernel's wrapper (correlate.py:361-369,
    pallas_particle_search.py:159-176), with XLA's int32 semantics, as int64
    tensors [..., P]: (uc, vc, halfwidth, halfheight, u0, v0), and the S^-1
    entries (a, b, c); the floats in the dtype of sinv (f32 for the kernels'
    wrappers and the fast mode, f64 in the parity mode)."""
    side_u, side_v = min(2 * win_radius + 1, W), min(2 * win_radius + 1, H)
    uc = xla_i32(torch.trunc(h_centres[..., 0]))
    vc = xla_i32(torch.trunc(h_centres[..., 1]))
    a, b, c = sinv[..., 0, 0], sinv[..., 0, 1], sinv[..., 1, 1]
    ns = torch.full((), no_sigma, dtype=a.dtype, device=a.device)
    hw = xla_i32(torch.floor(ns / torch.sqrt(a - b * b / c)))
    hh = xla_i32(torch.floor(ns / torch.sqrt(c - b * b / a)))
    u0 = torch.clamp(wrap_i32(uc - win_radius), 0, W - side_u)
    v0 = torch.clamp(wrap_i32(vc - win_radius), 0, H - side_v)
    return uc, vc, hw, hh, u0, v0, a, b, c


def window_search(maps, u0, v0, side_v: int, side_u: int, mask_fn):
    """Masked minimum and last-tie key of every particle over its window.

    maps [B, F, H, W] (f32 or f64); u0, v0 [B, F, P] (int64) window origins;
    mask_fn(uu [B, F, P, 1, su], vv [B, F, P, sv, 1]) -> the admitted cells
    [B, F, P, sv, su]. Returns (best [B, F, P] f32, kbest [B, F, P] int64):
    the minimum over the admitted cells and the 1e6 of every other cell of
    the map (NaN if an admitted cell is NaN), and the largest u*H + v among
    the admitted cells at the minimum (-1 if none)."""
    Bn, Fn, H, W = maps.shape
    dev = maps.device
    uu = u0[..., None, None] + torch.arange(side_u, device=dev)           # [B, F, P, 1, su]
    vv = v0[..., None, None] + torch.arange(side_v, device=dev)[:, None]  # [B, F, P, sv, 1]
    mask = mask_fn(uu, vv)
    base = torch.arange(Bn * Fn, device=dev).reshape(Bn, Fn, 1, 1, 1) * (H * W)
    vals = maps.reshape(-1)[base + vv * W + uu]
    vals = torch.where(mask, vals, torch.full_like(vals, MISS)).flatten(-2)
    best = vals.amin(dim=-1)
    if side_v * side_u < H * W:
        best = torch.minimum(best, torch.full_like(best, MISS))
    key = (uu * H + vv).expand(mask.shape).flatten(-2)
    tie = (vals == best[..., None]) & mask.flatten(-2)
    kbest = torch.where(tie, key, torch.full_like(key, -1)).amax(dim=-1)
    return best, kbest


def ellipse_mask(a, b, c, uc, vc, uu, vv, no_sigma: float):
    """(a urel) urel + ((2b) urel) vrel + (c vrel) vrel < no_sigma^2 with
    urel, vrel the int32-wrapped offsets from (uc, vc) in the dtype of a;
    a, b, c, uc, vc [..., P] broadcast against the cells uu, vv."""
    urel = wrap_i32(uu - uc[..., None, None]).to(a.dtype)
    vrel = wrap_i32(vv - vc[..., None, None]).to(a.dtype)
    a, b2, c = a[..., None, None], (2.0 * b)[..., None, None], c[..., None, None]
    return (((a * urel) * urel + (b2 * urel) * vrel) + (c * vrel) * vrel) < no_sigma * no_sigma


def multi_ellipse_search_dense(corr_maps, h_centres, sinv, alive, *, win_radius: int = 32,
                               no_sigma: float = 3.0, corr_thresh2: float = 0.40):
    """correlate.multi_ellipse_search_dense over lanes and slots:
    corr_maps [B, F, H, W], h_centres [B, F, P, 2], sinv [B, F, P, 2, 2],
    alive [B, F, P]. Returns (found, u, v, overflow), each [B, F, P]. The
    offsets, the box and the ellipse are in the dtype of sinv, as the JAX
    function's are in that of its map (f32 in the fast mode, f64 in the
    parity mode, where the two agree).

    The single stream's pure-XLA route runs this in place of
    correlate.multi_ellipse_search_unionbox (correlate.py:464-591, called at
    scenelib2_tpu/runtime/step.py:1185-1201): that function picks, by
    lax.cond on the particles' union box, one rung of a ladder of band sizes
    or this dense form, and is bit-equal to the dense form on every rung for
    the alive particles (the union box holds every alive particle's cells);
    a CUDA graph cannot branch on data without a host synchronisation. The
    u and v of a particle that is not alive may differ from the rung's; the
    step reads them only where the particle is alive."""
    H, W = corr_maps.shape[-2:]
    side_u, side_v = min(2 * win_radius + 1, W), min(2 * win_radius + 1, H)
    uc, vc, hw, hh, u0, v0, a, b, c = particle_geometry(h_centres, sinv, win_radius, no_sigma, H, W)

    def mask_fn(uu, vv):
        urel = wrap_i32(uu - uc[..., None, None]).to(a.dtype)
        vrel = wrap_i32(vv - vc[..., None, None]).to(a.dtype)
        # int32 half-extents compare with the float offsets in their dtype
        box = ((torch.abs(urel) <= hw.to(a.dtype)[..., None, None])
               & (torch.abs(vrel) <= hh.to(a.dtype)[..., None, None]))
        return box & ellipse_mask(a, b, c, uc, vc, uu, vv, no_sigma)

    best, kbest = window_search(corr_maps, u0, v0, side_v, side_u, mask_fn)
    u = torch.div(kbest, H, rounding_mode="floor").to(torch.int32)
    v = torch.remainder(kbest, H).to(torch.int32)
    over = (hw > win_radius) | (hh > win_radius)
    found = alive & (best <= corr_thresh2)
    return found, u, v, over & alive


def gather_windows_u8(frames_u8: torch.Tensor, u0: torch.Tensor, v0: torch.Tensor,
                      win_radius: int, boxsize: int) -> torch.Tensor:
    """The [B, K, sw_v, sw_u] u8 search windows at (u0 - half, v0 - half) of
    frames [B, H, W] (u0, v0 [B, K] int32 from search.search_window_origin,
    which keeps every window inside its frame)."""
    Bn, H, W = frames_u8.shape
    half = (boxsize - 1) // 2
    sw_u = min(2 * win_radius + 1, W - boxsize + 1) + boxsize - 1
    sw_v = min(2 * win_radius + 1, H - boxsize + 1) + boxsize - 1
    dev = frames_u8.device
    rows = (v0.long() - half)[..., None, None] + torch.arange(sw_v, device=dev)[:, None]
    cols = (u0.long() - half)[..., None, None] + torch.arange(sw_u, device=dev)
    bi = torch.arange(Bn, device=dev).reshape(Bn, 1, 1, 1)
    return frames_u8[bi, rows, cols]
