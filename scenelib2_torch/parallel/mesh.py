"""Multi-device scaling: batch lanes, and the 2-D sharded-covariance EKF.

Port of scenelib2_tpu/parallel/mesh.py. A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over an initialised process
group (``make_mesh``: NCCL on the card, gloo where the caller asks for the
CPU); every rank calls the same functions, as every device runs the same
program in JAX.

  1. Batch parallelism (the DP analog). The JAX package vmaps its step over
     the lanes; a ctypes kernel cannot be vmapped, so here the lanes are a
     real leading dimension of every state field and every kernel's grid
     carries the lane (``make_batched_step``, runtime/step.py
     ``make_batch_step``). Over a 1-D mesh, ``run_batch(..., mesh=)`` gives
     each rank a contiguous block of the lanes (``shard_batch``), steps it as
     on one card and gathers states and outputs back in lane order
     (``gather_batch``): no collective inside a step, as in JAX.

  2. Sharded-covariance EKF (the TP analog, for the 500-feature map). P [D, D]
     is split over a ("row", "col") mesh: each rank holds its
     [D/rows, D/cols] block and x's [D/rows] rows (copied over "col"); H, nu,
     R, S and top_idx are the same on every rank. Where JAX annotates the
     shardings and lets XLA insert the collectives, the functions here call
     explicit collectives on the mesh's process groups, and no rank gathers
     P: only the camera rows P[:13, :], the strip of P H' (reduced over
     "col"), W (gathered over "row"), the slots' 3 x 3 diagonal blocks and
     x move, O(13 D + M D) a frame; symmetrize's P' comes block by block from
     the ranks that hold it (point-to-point). Each function takes and returns
     the rank's blocks (``shard_state`` / ``gather_state`` move whole states
     in and out) and works on mesh-padded D (``pad_for_mesh``), whose pad
     rows and columns stay exact zeros.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.distributed as dist

from scenelib2_torch.config import Params
from scenelib2_torch.core import ekf, motion
from scenelib2_torch.core.quaternion import mm_seq
from scenelib2_torch.device import resolve_device
from scenelib2_torch.rng import pack_state, srand48
from scenelib2_torch.runtime import replay
from scenelib2_torch.runtime import step as step_mod
from scenelib2_torch.runtime.state import SlamState

CAM = 13


def make_mesh(shape, axis_names, device=None):
    """A DeviceMesh of `shape` (row-major over the process group's ranks)
    named `axis_names`, on an initialised process group of that many ranks.
    device None means CUDA, whose group must run NCCL; device="cpu" needs
    gloo. Nothing falls back to another backend or device."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group (torch.distributed.init_process_group)")
    want = "nccl" if dev.type == "cuda" else "gloo"
    if dist.get_backend() != want:
        raise RuntimeError(f"a mesh on {dev.type} needs the {want} backend; the process group runs "
                           f"{dist.get_backend()}")
    shape = tuple(int(n) for n in shape)
    if math.prod(shape) != dist.get_world_size():
        raise ValueError(f"a mesh of shape {shape} needs {math.prod(shape)} ranks; the group has "
                         f"{dist.get_world_size()}")
    return init_device_mesh(dev.type, shape, mesh_dim_names=tuple(axis_names))


def mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def pad_for_mesh(D: int, rows: int, cols: int) -> int:
    """Smallest Dp >= D divisible by both mesh axis sizes."""
    lcm = rows * cols // math.gcd(rows, cols)
    return ((D + lcm - 1) // lcm) * lcm


# ------------------------------------------------------------------ batch DP


def make_batched_step(params: Params, device=None, batch_sb: bool | None = None,
                      precision: str = "f32"):
    """step(states_b, frames_b, enable_mapping) -> (states_b', outs_b): the
    whole per-frame step for all lanes at once. Every field of states_b has
    a leading lane dimension, frames_b is [B, H, W] u8, and every field of
    outs_b (StepOutputs) has the lane dimension too. device None means CUDA
    (raises without a GPU). The JAX batch route follows params.batch_pallas
    and, with batch_pallas=True, batch_sb (None: the environment variable
    SCENELIB2_BATCH_SB, read now): runtime.step.batch_route. precision
    "f64" is the JAX package's x64 step on states made in f64
    (runtime.step.make_batch_step: routes "xla-f64", "k2-f64", "k8-f64")."""
    return step_mod.make_batch_step(dataclasses.replace(params, batch_mode=True), device,
                                    precision=precision, batch_sb=batch_sb)


def stack_states(states) -> SlamState:
    """Lane-stack single states (all of one configuration and device)."""
    return SlamState(*(torch.stack(ts) for ts in zip(*states)))


def lane_state(states_b: SlamState, lane: int) -> SlamState:
    """One lane of a stacked state, as a single-stream state."""
    return SlamState(*(t[lane] for t in states_b))


def lane_seeds(batch: int, device) -> torch.Tensor:
    """[B, 3] drand48 limb states, lane i seeded with srand48(i)."""
    return torch.as_tensor(
        np.stack([pack_state(srand48(i)) for i in range(batch)]).astype(np.int32), device=device)


def replicate_states(state: SlamState, batch: int) -> SlamState:
    """B copies of a state, each lane with its own random stream srand48(lane)."""
    stacked = SlamState(*(t.expand(batch, *t.shape).clone() for t in state))
    return stacked._replace(rng=lane_seeds(batch, state.x.device))


def _lane_group(mesh):
    if mesh.ndim != 1:
        raise ValueError(f"lanes shard over a 1-D mesh, got {mesh.ndim} dimensions")
    group = mesh.get_group()
    if dist.get_process_group_ranks(group) != mesh.mesh.tolist():
        raise RuntimeError("the mesh's group does not list its ranks in mesh order")
    return group


def shard_batch(mesh, tree, dim: int = 0):
    """This rank's contiguous block of the lanes (dimension dim) of a tensor,
    a numpy array or a SlamState, on the mesh's device: block k of the mesh's
    size is rank k's, as JAX's NamedSharding splits a sharded axis."""
    _lane_group(mesh)
    n, k, dev = mesh.size(), mesh.get_local_rank(), mesh_device(mesh)

    def one(t):
        t = torch.as_tensor(t)
        B = t.shape[dim]
        if B % n:
            raise ValueError(f"{B} lanes do not split over {n} ranks")
        return t.narrow(dim, k * (B // n), B // n).to(dev).contiguous()

    return type(tree)(*(one(t) for t in tree)) if isinstance(tree, SlamState) else one(tree)


def gather_batch(mesh, tree, dim: int = 0):
    """shard_batch's inverse: every rank's block of a tensor or SlamState,
    concatenated along dim in lane order, on every rank."""
    group = _lane_group(mesh)

    def one(t):
        src = (t.to(torch.uint8) if t.dtype == torch.bool else t).contiguous()
        parts = [torch.empty_like(src) for _ in range(mesh.size())]
        dist.all_gather(parts, src, group=group)
        out = torch.cat(parts, dim=dim)
        return out.bool() if t.dtype == torch.bool else out

    return type(tree)(*(one(t) for t in tree)) if isinstance(tree, SlamState) else one(tree)


def run_batch(step, states_b: SlamState, frames, enable_mapping: bool, params: Params, chunk: int = 0,
              mesh=None):
    """Replay frames [T, B, H, W] u8 through `step` (from make_batched_step).
    The packed outputs of every step go into one [T, B, K] tensor on the
    state's device and the host waits once, at the end. Returns (final
    states_b, StepOutputs with leading [T, B] dimensions on the CPU).

    On a CUDA device the steps replay CUDA graphs (runtime/replay.py), as
    the reference's batch bench scans its step: one graph of chunk steps
    (replay.REPLAY_BLOCK where chunk is 0) replayed once for each full block
    of frames, and a one-step graph for the frames past the last full block.
    Each graph is captured on its first use and kept on `step` (step.graphs,
    at most replay.MAX_GRAPHS of them). On the CPU the step is called on
    every frame, and chunk only groups the frames: the outputs are the
    same.

    With a 1-D mesh (make_mesh), states_b and frames hold every lane on
    every rank; each rank runs its block of them (shard_batch) and the final
    states and the outputs are gathered back in lane order (gather_batch)."""
    if mesh is not None:
        states_b = shard_batch(mesh, states_b)
        frames = shard_batch(mesh, frames, dim=1)
    states_b, flat = _run_batch(step, states_b, frames, enable_mapping, params, chunk,
                                graphs=states_b.x.device.type == "cuda")
    if mesh is not None:
        states_b = gather_batch(mesh, states_b)
        flat = gather_batch(mesh, flat, dim=1)
    return states_b, _unpack(flat, params)


def _run_batch_eager(step, states_b: SlamState, frames, enable_mapping: bool, params: Params):
    """run_batch with the step called from Python on every frame, on any
    device: the reference that the graph replay is held to."""
    states_b, flat = _run_batch(step, states_b, frames, enable_mapping, params, 0, graphs=False)
    return states_b, _unpack(flat, params)


def _unpack(flat, params: Params):
    return step_mod.unpack_outputs(flat.cpu(), params.n_features_to_select,
                                   max(1, params.max_features_to_init_at_once), params.n_particles)


def _run_batch(step, states_b, frames, enable_mapping, params, chunk, graphs):
    """(final states_b, the packed outputs [T, B, K] on the state's device)."""
    dev = states_b.x.device
    if isinstance(frames, torch.Tensor):
        seq = frames.to(device=dev, dtype=torch.uint8).contiguous()
    else:
        seq = torch.as_tensor(np.ascontiguousarray(frames, np.uint8)).to(dev)
    replay.chunk_plan(seq.shape[0], chunk)   # refuses a bad chunk on every device
    nsel = params.n_features_to_select
    maxp = max(1, params.max_features_to_init_at_once)
    npart = params.n_particles
    T, Bn = seq.shape[:2]
    flat = torch.empty((T, Bn, step_mod.packed_size(nsel, maxp, npart)),
                       dtype=states_b.x.dtype, device=dev)
    if graphs:
        states_b = replay.replay_steps(step, step.graphs, states_b, seq, enable_mapping, chunk, flat)
    else:
        states_b = replay.eager_steps(step, states_b, seq, enable_mapping, flat)
    return states_b, flat


# --------------------------------------------------------- 2-D sharded EKF


@dataclasses.dataclass(frozen=True)
class Block:
    """Rank (r, c)'s block of a ("row", "col") mesh at state size D: rows
    [r0, r0 + Dr) and columns [c0, c0 + Dc) of P, rows [r0, r0 + Dr) of x."""
    D: int
    rows: int
    cols: int
    r: int
    c: int

    @property
    def Dr(self) -> int:
        return self.D // self.rows

    @property
    def Dc(self) -> int:
        return self.D // self.cols

    @property
    def r0(self) -> int:
        return self.r * self.Dr

    @property
    def c0(self) -> int:
        return self.c * self.Dc


def block_of(mesh, D: int, coord=None) -> Block:
    """The Block of this rank (or of the mesh coordinate coord) at size D."""
    if tuple(mesh.mesh_dim_names or ()) != ("row", "col"):
        raise ValueError(f"the sharded EKF needs a ('row', 'col') mesh, got {mesh.mesh_dim_names}")
    rows, cols = mesh.shape
    if D % rows or D % cols:
        raise ValueError(f"D = {D} does not split over a {rows} x {cols} mesh: pad it (pad_for_mesh)")
    r, c = mesh.get_coordinate() if coord is None else coord
    return Block(D, rows, cols, int(r), int(c))


def shard_state(mesh, x, P):
    """(x [Dr], P [Dr, Dc]): this rank's blocks of a whole state x [D],
    P [D, D] (tensors or numpy arrays, any device), on the mesh's device.
    The counterpart of JAX's device_put with the ("row") and ("row", "col")
    NamedShardings."""
    x, P = torch.as_tensor(x), torch.as_tensor(P)
    b = block_of(mesh, x.shape[0])
    dev = mesh_device(mesh)
    return (x[b.r0:b.r0 + b.Dr].to(dev).contiguous(),
            P[b.r0:b.r0 + b.Dr, b.c0:b.c0 + b.Dc].to(dev).contiguous())


def gather_state(mesh, x, P):
    """shard_state's inverse: the whole (x [D], P [D, D]) on every rank (for
    checks and reports; no frame calls it)."""
    b = block_of(mesh, x.shape[0] * mesh.shape[0])
    xs = x.new_zeros(b.D)
    if b.c == 0:
        xs[b.r0:b.r0 + b.Dr] = x
    Ps = P.new_zeros((b.D, b.D))
    Ps[b.r0:b.r0 + b.Dr, b.c0:b.c0 + b.Dc] = P
    dist.all_reduce(xs)
    dist.all_reduce(Ps)
    return xs, Ps


def _sum(t, group=None):
    """t summed over the group's ranks (the world by default), in place. Each
    gather below writes every entry on exactly one rank of the group and
    zeros elsewhere, so its sum is exact."""
    dist.all_reduce(t, group=group)
    return t


class _Sharded:
    """The collectives of one rank of a ("row", "col") mesh at size D: the
    gathers of x and of P's camera rows and slot blocks, the update's
    products, and P's transpose for symmetrize."""

    def __init__(self, mesh, D: int):
        self.mesh = mesh
        self.b = block_of(mesh, D)
        self.dev = mesh_device(mesh)
        self.row_group = mesh.get_group("row")     # the ranks of this column
        self.col_group = mesh.get_group("col")     # the ranks of this row
        self._pieces = self._transpose_pieces()
        self._diag = {}

    def check(self, x, P):
        b = self.b
        if x.device.type != self.dev.type or P.device.type != self.dev.type:
            raise ValueError(f"the mesh runs on {self.dev.type}; got x on {x.device}, P on {P.device}")
        if tuple(x.shape) != (b.Dr,) or tuple(P.shape) != (b.Dr, b.Dc):
            raise ValueError(f"rank ({b.r}, {b.c}) takes x [{b.Dr}] and P [{b.Dr}, {b.Dc}]; got "
                             f"{tuple(x.shape)} and {tuple(P.shape)}")

    def x_head(self, x, n: int):
        """x[:n] on every rank."""
        b = self.b
        buf = x.new_zeros(n)
        hi = min(b.r0 + b.Dr, n)
        if b.r0 < hi:
            buf[b.r0:hi] = x[:hi - b.r0]
        return _sum(buf, self.row_group)

    def camera_rows(self, P):
        """P[:13, :] on every rank."""
        b = self.b
        buf = P.new_zeros((CAM, b.D))
        hi = min(b.r0 + b.Dr, CAM)
        if b.r0 < hi:
            buf[b.r0:hi, b.c0:b.c0 + b.Dc] = P[:hi - b.r0]
        return _sum(buf)

    def camera_transform(self, x, P, rows, xv):
        """ekf._camera_transform on the blocks: rows [13, D] are the new
        camera rows (the new camera block in their first 13 columns), their
        transpose the new camera columns; xv the new camera state."""
        b = self.b
        P = P.clone()
        hi = min(b.c0 + b.Dc, CAM)
        if b.c0 < hi:   # columns first: the rows hold the camera block
            P[:, :hi - b.c0] = rows[b.c0:hi, b.r0:b.r0 + b.Dr].mT
        x = x.clone()
        hi = min(b.r0 + b.Dr, CAM)
        if b.r0 < hi:
            P[:hi - b.r0] = rows[b.r0:hi, b.c0:b.c0 + b.Dc]
            x[:hi - b.r0] = xv[b.r0:hi]
        return x, P

    def predict(self, x, P, u, delta_t, sd_a, sd_alpha):
        """ekf.predict on the blocks; also returns the new camera rows."""
        xv = self.x_head(x, CAM)
        fv, F = motion.func_fv_and_dfv_by_dxv(xv, u, delta_t)
        rows = _transformed_rows(F, self.camera_rows(P), motion.func_Q(xv, delta_t, sd_a, sd_alpha))
        return (*self.camera_transform(x, P, rows, fv), rows)

    def normalise(self, x, P):
        xvn, J = motion.func_xvnorm_and_dxvnorm_by_dxv(self.x_head(x, CAM))
        return self.camera_transform(x, P, _transformed_rows(J, self.camera_rows(P)), xvn)

    def update(self, x, P, H, nu, R, sinv):
        """Joint update on the blocks; sinv(S) gives S^-1. P H' is reduced
        over "col" (this rank's rows of it), H P H' summed once over every
        rank (so S is the same everywhere), W's rows gathered over "row"."""
        b = self.b
        PHt = _sum(P @ H[:, b.c0:b.c0 + b.Dc].mT, self.col_group)          # [Dr, M]
        part = H[:, b.r0:b.r0 + b.Dr] @ PHt if b.c == 0 else PHt.new_zeros((H.shape[0],) * 2)
        S = _sum(part) + R
        W = PHt @ sinv(S)
        x = x + (W @ nu[:, None])[:, 0]
        Wall = W.new_zeros((b.D, W.shape[1]))
        Wall[b.r0:b.r0 + b.Dr] = W
        _sum(Wall, self.row_group)
        return x, P - (W @ S) @ Wall[b.c0:b.c0 + b.Dc].mT

    def slot_diagonal(self, P, n_feat: int, slot_dim: int):
        """[n_feat, 3, 3]: each slot's world-point block P[i, i] on every
        rank, each entry from the rank that holds it (a block may cross a
        block boundary). The indices are made on the device: no upload, so
        no host synchronisation on a first call."""
        key = (n_feat, slot_dim)
        if key not in self._diag:
            b, dev = self.b, self.dev
            k = torch.arange(n_feat, device=dev)[:, None, None]
            i = CAM + slot_dim * k + torch.arange(3, device=dev)[None, :, None]
            j = CAM + slot_dim * k + torch.arange(3, device=dev)[None, None, :]
            own = (i >= b.r0) & (i < b.r0 + b.Dr) & (j >= b.c0) & (j < b.c0 + b.Dc)
            src = (i - b.r0).clamp(0, b.Dr - 1) * b.Dc + (j - b.c0).clamp(0, b.Dc - 1)
            self._diag[key] = (own, src)
        own, src = self._diag[key]
        return _sum(torch.where(own, P.reshape(-1)[src], 0.0))

    def _transpose_pieces(self):
        """[(peer rank, my rows and columns to send, where in P[C, R] the
        peer's piece lands)]: P[C, R] (C this rank's columns, R its rows) is
        made of the pieces P[R' & C, C' & R] of the ranks (r', c')."""
        b, pieces = self.b, []
        for r in range(b.rows):
            for c in range(b.cols):
                p = block_of(self.mesh, b.D, (r, c))
                send = (_cut(b.r0, b.Dr, p.c0, p.Dc, b.r0), _cut(b.c0, b.Dc, p.r0, p.Dr, b.c0))
                recv = (_cut(p.r0, p.Dr, b.c0, b.Dc, b.c0), _cut(p.c0, p.Dc, b.r0, b.Dr, b.r0))
                pieces.append((int(self.mesh.mesh[r, c]), send, recv, (r, c) == (b.r, b.c)))
        return pieces

    def transpose(self, P):
        """P[C, R] of the whole P ([Dc, Dr], this rank's block of P')."""
        b = self.b
        T = P.new_empty((b.Dc, b.Dr))
        ops, landed = [], []
        for peer, send, recv, mine in self._pieces:
            if mine:
                T[recv] = P[send]
                continue
            if _size(send):
                ops.append(dist.P2POp(dist.isend, P[send].contiguous(), peer))
            if _size(recv):
                buf = P.new_empty((_len(recv[0]), _len(recv[1])))
                ops.append(dist.P2POp(dist.irecv, buf, peer))
                landed.append((recv, buf))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        for recv, buf in landed:
            T[recv] = buf
        return T

    def symmetrize(self, P):
        """ekf.symmetrize on the blocks: P / 2 + P' / 2."""
        return P * 0.5 + self.transpose(P).mT * 0.5


def _cut(a0: int, an: int, b0: int, bn: int, origin: int) -> slice:
    """The global indices in both [a0, a0 + an) and [b0, b0 + bn), as a
    slice relative to origin."""
    lo, hi = max(a0, b0), min(a0 + an, b0 + bn)
    return slice(lo - origin, max(lo, hi) - origin)


def _len(s: slice) -> int:
    return s.stop - s.start


def _size(piece) -> int:
    return _len(piece[0]) * _len(piece[1])


def _transformed_rows(F, Pc, Q=None):
    """The camera rows F P[:13, :] with their camera block F Pxx F' (+ Q),
    in ekf._camera_transform's arithmetic."""
    top = mm_seq(F, Pc)
    pxx = mm_seq(top[:, :CAM], F.mT)
    top[:, :CAM] = pxx if Q is None else pxx + Q
    return top


def _sinv_unrolled(S):
    Linv = ekf.tril_inv_unrolled(ekf.chol_unrolled(S))
    return Linv.mT @ Linv


def _sinv_linalg(S):
    # cholesky_ex: torch.linalg.cholesky without its error check, which
    # waits for the device; a failed factor gives NaNs, as jnp's does
    L, _ = torch.linalg.cholesky_ex(S)
    Linv = torch.linalg.solve_triangular(L, torch.eye(S.shape[0], dtype=S.dtype, device=S.device),
                                         upper=False)
    return Linv.mT @ Linv


def sharded_joint_update(mesh, D: int, M: int):
    """update(x, Pm, H, nu, R) -> (x', Pm'): the EKF joint update on this
    rank's blocks (x [D/rows], Pm [D/rows, D/cols]; H [M, D], nu [M], R [M, M]
    the same on every rank), S^-1 through torch.linalg's Cholesky factor and
    triangular solve, as JAX's sharded_joint_update does."""
    sh = _Sharded(mesh, D)

    def update(x, Pm, H, nu, R):
        sh.check(x, Pm)
        return sh.update(x, Pm, H, nu, R, _sinv_linalg)

    return update


def sharded_predict(mesh, D: int, delta_t: float = 1 / 30.0, sd_a: float = 4.0, sd_alpha: float = 6.0):
    """predict(x, Pm, u) -> (x', Pm'): EKF predict with the constant-velocity
    motion model (kalman.cpp:50-69) on this rank's blocks; only the 13
    camera rows and columns change, from the gathered camera rows."""
    sh = _Sharded(mesh, D)

    def predict(x, Pm, u):
        sh.check(x, Pm)
        x, Pm, _ = sh.predict(x, Pm, u, delta_t, sd_a, sd_alpha)
        return x, Pm

    return predict


def sharded_slam_frame(mesh, D: int, M: int, delta_t: float = 1 / 30.0, sd_a: float = 4.0,
                       sd_alpha: float = 6.0):
    """frame(x, Pm, u, H, nu, R) -> (x', Pm'): one EKF frame on this rank's
    blocks: predict, joint update (S factored by ekf.chol_unrolled /
    tril_inv_unrolled), quaternion normalise, symmetrize (monoslam.cpp:108-150
    filter stages); the composition of core.ekf's functions on the whole
    state, up to the order of the update's sums."""
    sh = _Sharded(mesh, D)

    def frame(x, Pm, u, H, nu, R):
        sh.check(x, Pm)
        x, Pm, _ = sh.predict(x, Pm, u, delta_t, sd_a, sd_alpha)
        x, Pm = sh.update(x, Pm, H, nu, R, _sinv_unrolled)
        x, Pm = sh.normalise(x, Pm)
        return x, sh.symmetrize(Pm)

    return frame


def sharded_stress_frame(mesh, params: Params, n_feat: int, slot_dim: int = 6, n_sel: int = 10):
    """frame(x, Pm, u) -> (x', Pm', top_idx): one stress500-scale mapping
    frame with the real measurement stage on this rank's blocks: predict,
    runtime.assembly's per-slot chain, top-k selection and H / R packing on
    the gathered slot blocks (Pxx and pxy from the camera rows, pyy from the
    ranks that hold each slot's diagonal block), nu = 0.5 px, the joint
    update, normalise, symmetrize. The sharded counterpart of
    eval.benchmark._make_ekf_frame (which makes the same selection); D is
    taken from the blocks at the first call and may be mesh-padded."""
    from scenelib2_torch.core.camera import CameraParams
    from scenelib2_torch.runtime.assembly import assemble

    cam = CameraParams.from_params(params)
    shs = {}
    lo, hi = CAM, CAM + slot_dim * n_feat

    def frame(x, Pm, u):
        D = x.shape[0] * mesh.shape[0]
        if D not in shs:
            shs[D] = _Sharded(mesh, D)
        sh = shs[D]
        sh.check(x, Pm)
        x, Pm, rows = sh.predict(x, Pm, u, params.delta_t, params.sd_a, params.sd_alpha)
        xs = sh.x_head(x, hi)
        ys3 = xs[lo:hi].reshape(n_feat, slot_dim)[:, :3]
        pxy3 = rows[:, lo:hi].reshape(CAM, n_feat, slot_dim).permute(1, 0, 2)[:, :, :3]
        H, R, top_idx, _ = assemble(cam, xs[:7], ys3, rows[:, :CAM], pxy3,
                                    sh.slot_diagonal(Pm, n_feat, slot_dim), D, slot_dim, n_sel)
        nu = torch.full((2 * n_sel,), 0.5, dtype=x.dtype, device=x.device)
        x, Pm = sh.update(x, Pm, H, nu, R, _sinv_unrolled)
        x, Pm = sh.normalise(x, Pm)
        return x, sh.symmetrize(Pm), top_idx

    return frame


__all__ = ["make_mesh", "mesh_device", "pad_for_mesh", "make_batched_step", "stack_states", "lane_state",
           "lane_seeds", "replicate_states", "shard_batch", "gather_batch", "run_batch", "Block", "block_of",
           "shard_state", "gather_state", "sharded_joint_update", "sharded_predict", "sharded_slam_frame",
           "sharded_stress_frame"]
