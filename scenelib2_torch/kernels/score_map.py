"""K9: whole-frame penalized NSSD score map of one patch per partial slot.

Replaces the TPU kernels scenelib2_tpu/kernels/pallas_score_map.py
(``pallas_score_maps``: ``_score_map_kernel_whole`` for frames that fit the
TPU's vector memory and the 64-row banded ``_score_map_kernel`` for larger
ones; one function, so one CUDA kernel serves both). Stage 8 of the batch
step (the reference's correlation cache, monoslam.cpp:1299-1517): for every
lane and every partial slot's 11x11 patch, at every pixel taken as the
patch centre,

  exact integer box sums of the image and of its square and the 121-tap
  cross sum with the patch (all below 2^24: exact in f32 in any order);
  the f32 NSSD of kernels/search.py::nssd_corr_f32;
  + low_sigma_penalty where the image deviation is below corr_sigma_thresh;
  exactly 1e6 at a centre whose patch leaves the frame.

Output [B, F, H, W] f32, unpadded. Only nssd_corr_f32 rounds, and the kernel
(csrc/score_map.cu, csrc/nssd.cuh) runs its operations in the plain
version's order, so the two agree bit for bit.

Bound on an H100 at 64 lanes of 320x240: 4.9 MB of frames in and 19.7 MB of
maps out (~7 us at the memory rate) against 64 x 71300 valid centres x 313
operations (search.nssd_cell_ops) = 1.4 GOP (~21 us at the f32 rate): bound
by operations, most of them the score formula's. Design: one block per
(lane, 16 x 64 tile of centres), each thread a run of 8 adjacent centres
along u; the u8 frame tile staged in shared memory; the box sums separable
in int32 (column sums over B rows, then a sliding sum along u); the cross
sum with __dp4a on u8 quads (4 exact multiply-adds an instruction: the
integer sums equal the twin's f32 sums after one exact conversion, which
tests/test_torch_score_map_int.py holds); the map written 16 bytes a store.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from scenelib2_torch.kernels import _build
from scenelib2_torch.kernels.search import nssd_cell_ops, nssd_corr_f32

NAME = "score_map"
MISS = 1e6


@dataclass(frozen=True)
class ScoreMapConsts:
    H: int
    W: int
    boxsize: int
    corr_sigma_thresh: float
    low_sigma_penalty: float

    @staticmethod
    def from_params(p) -> "ScoreMapConsts":
        return ScoreMapConsts(H=p.cam_height, W=p.cam_width, boxsize=p.boxsize,
                              corr_sigma_thresh=p.corr_sigma_thresh,
                              low_sigma_penalty=p.low_sigma_penalty)


def window_sums_plain(frames, patch_rows, c: ScoreMapConsts):
    """The three sums of every centre as K9's twin takes them, shifted adds
    in f32 (exact in any order: integers below 2^24): (window sum, window
    sum of squares [B, 1, H, W], cross sum with each patch [B, F, H, W])."""
    Bn, H, W = frames.shape
    b = c.boxsize
    half = (b - 1) // 2
    f32 = torch.float32
    img = F.pad(frames.to(f32), (half, half, half, half))              # [B, H+2h, W+2h]
    img2 = img * img

    def box(a):
        rows = a[:, 0:H]
        for dy in range(1, b):
            rows = rows + a[:, dy : dy + H]
        out = rows[:, :, 0:W]
        for dx in range(1, b):
            out = out + rows[:, :, dx : dx + W]
        return out[:, None]                                            # [B, 1, H, W]

    cross = torch.zeros((Bn, patch_rows.shape[1], H, W), dtype=f32, device=frames.device)
    for dy in range(b):
        for dx in range(b):
            cross = cross + (patch_rows[:, :, dy * b + dx, None, None]
                             * img[:, None, dy : dy + H, dx : dx + W])
    return box(img), box(img2), cross


def score_of_sums(sg1, sg1sq, cross, patch_rows, c: ScoreMapConsts):
    """The penalized NSSD of every centre from its sums ([B, F, H, W] f32),
    exactly 1e6 where the patch leaves the frame."""
    H, W = cross.shape[-2:]
    b = c.boxsize
    half = (b - 1) // 2
    dev = cross.device
    n = torch.full((), float(b * b), dtype=torch.float32, device=dev)
    sg0 = patch_rows[:, :, b * b, None, None]
    sg0sq = patch_rows[:, :, b * b + 1, None, None]
    corr, _sd0, sd1 = nssd_corr_f32(sg0, sg0sq, sg1, sg1sq, cross, n)
    corr = torch.where(sd1 < c.corr_sigma_thresh, corr + c.low_sigma_penalty, corr)
    vv = torch.arange(H, device=dev)[:, None]
    uu = torch.arange(W, device=dev)[None, :]
    valid = (uu >= half) & (uu <= W - 1 - half) & (vv >= half) & (vv <= H - 1 - half)
    return torch.where(valid, corr, torch.full_like(corr, MISS))


def score_map_plain(frames, patch_rows, c: ScoreMapConsts):
    """Plain PyTorch K9. frames [B, H, W] u8; patch_rows [B, F, 128] f32
    (pixels | sum | sum of squares). Returns [B, F, H, W] f32."""
    return score_of_sums(*window_sums_plain(frames, patch_rows, c), patch_rows, c)


class _K9Params(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_int) for n in ("H", "W", "B", "n_lanes", "F")]
                + [(n, ctypes.c_float) for n in ("corr_sigma_thresh", "low_sigma_penalty")])


# tensor pointers (frames, patch rows, the output), the params struct, the stream
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.POINTER(_K9Params), ctypes.c_void_p]


def score_map(frames, patch_rows, c: ScoreMapConsts, out=None):
    """K9. CPU tensors take the plain version; CUDA tensors launch the
    kernel (or raise). `out` is an optional [B, F, H, W] f32 workspace to
    write into (the step allocates it once, not per frame). The patch
    pixels are u8 values (runtime/state.py::patch_row): the kernel sums
    them as bytes."""
    if frames.device.type == "cpu":
        return score_map_plain(frames, patch_rows, c)
    Bn, Fn = patch_rows.shape[:2]
    if c.boxsize > 11 or c.boxsize % 2 == 0:
        raise ValueError(f"K9: unsupported boxsize {c.boxsize} (odd, at most 11)")
    _build.check_tensor(frames, "frames", torch.uint8, (Bn, c.H, c.W))
    _build.check_tensor(patch_rows, "patch_rows", torch.float32, (Bn, Fn, 128))
    if out is None:
        out = torch.empty((Bn, Fn, c.H, c.W), dtype=torch.float32, device=frames.device)
    _build.check_tensor(out, "out", torch.float32, (Bn, Fn, c.H, c.W))
    prm = _K9Params(H=c.H, W=c.W, B=c.boxsize, n_lanes=Bn, F=Fn,
                    corr_sigma_thresh=c.corr_sigma_thresh, low_sigma_penalty=c.low_sigma_penalty)
    fn = _build.function(NAME, "k9_score_map", _ARGTYPES)
    err = fn(frames.data_ptr(), patch_rows.data_ptr(), out.data_ptr(), ctypes.byref(prm),
             torch.cuda.current_stream(frames.device).cuda_stream)
    _build.check(err, "K9 score_map")
    _build.launches[NAME] += 1
    return out


def bytes_and_flops(Bn: int, Fn: int, c: ScoreMapConsts) -> tuple[int, int]:
    """Least bytes (each frame and patch row read once, each map written
    once) and operations (search.nssd_cell_ops per valid centre) of one K9
    call."""
    half = (c.boxsize - 1) // 2
    valid = max(c.H - 2 * half, 0) * max(c.W - 2 * half, 0)
    nbytes = Bn * c.H * c.W + Bn * Fn * 128 * 4 + Bn * Fn * c.H * c.W * 4
    return nbytes, Bn * Fn * valid * nssd_cell_ops(c.boxsize)
