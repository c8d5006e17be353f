"""CUDA-graph replay of the step: the port's counterpart of JAX's compiled
run_sequence.

JAX's ``MonoSLAM.run_sequence`` (scenelib2_tpu/runtime/slam.py:79-133) is
one jitted ``lax.scan`` of the step over the frame stack, or, with
``chunk > 0``, one scan compiled for ``chunk`` frames over the full chunks
and the single-step jit over the remainder; its batch bench scans the
vmapped step the same way (scenelib2_tpu/eval/benchmark.py:228). A scan
compiles its body once, whatever the number of frames. Here a StepGraph
captures a block of N calls of a step (runtime/step.py ``make_step`` or
``make_batch_step``, any route) as one ``torch.cuda.CUDAGraph``, and a
sequence replays it once for each full block of its frames: N is ``chunk``,
or REPLAY_BLOCK where chunk is 0, and the frames past the last full block go
through a one-step graph (chunk_plan). So a capture costs the same for every
sequence length, and the graphs a cache keeps are bounded (MAX_GRAPHS).
``replay_one`` replays that same one-step graph for a single frame: the
port's counterpart of JAX's jitted ``go_one_step`` (one dispatch a frame,
scenelib2_tpu/runtime/slam.py:58-68).

- inputs are static buffers, the state's fields and an [N, *frame] frame
  buffer; the graph ends by copying its final state back into the static
  state, so that the next replay of the same graph goes on from it with no
  copy; before a replay the group's frames, and a state that is not already
  in the graph's inputs, are copied in;
- outputs are a static packed [N, *lanes, K] tensor (``pack_outputs`` of
  every step) in the graph's private memory pool, copied out after every
  replay; ``replay_steps`` returns a copy of the final state, not the
  graph's tensors, which the next replay overwrites;
- the graphs of one cache share one memory pool: their replays run one at
  a time on one stream and each one's outputs are copied out before the
  next replay starts, so a graph may take for its scratch memory another
  graph's scratch or stale outputs;
- before the capture one eager step of the same route runs on the static
  inputs (the step is functional: it leaves them unchanged) on the capture
  stream, so that whatever a first call does once happens outside the
  capture: the kernels' nvcc builds, their ``cudaFuncSetAttribute`` opt-ins
  and any cached device table;
- the capture and every replay run under ``torch.cuda.set_sync_debug_mode
  ("error")``: a host synchronisation raises, and so does a failed capture or
  a launch refused while capturing. Nothing falls back to stepping eagerly.

The kernel wrappers count their launches when called (kernels/_build.py
``launches``), so a graph's kernels are counted while it is captured (and
its warm-up step's once), not when it is replayed: ``StepGraph.launches``
keeps the counts its capture added.

The replays carry runtime/telemetry.py's spans and counters (the
SequenceRecord ``rec`` of the caller: copy_in, launch, copy_out; an eager
step's time goes under launch), and each StepGraph's GraphRecord takes its
nodes by stage from the step's stage marks while it is captured.
"""

from __future__ import annotations

import contextlib
import time

import torch

from scenelib2_torch.kernels import _build
from scenelib2_torch.runtime import telemetry
from scenelib2_torch.runtime.state import SlamState
from scenelib2_torch.runtime.step import pack_outputs


REPLAY_BLOCK = 8    # steps a graph holds where the caller gives no chunk
MAX_GRAPHS = 4      # graphs a cache keeps; the least recently used one goes first


def chunk_plan(n_frames: int, chunk: int = 0) -> list[int]:
    """The lengths of the groups that n_frames frames replay in: one group
    of the block (chunk, or REPLAY_BLOCK where chunk is 0) for each full
    block, then one group of 1 for each remaining frame."""
    if not isinstance(chunk, int) or isinstance(chunk, bool) or chunk < 0:
        raise ValueError(f"chunk must be an int >= 0, got {chunk!r}")
    block = chunk or REPLAY_BLOCK
    return [block] * (n_frames // block) + [1] * (n_frames % block)


@contextlib.contextmanager
def sync_error():
    """PyTorch's sync debug mode "error" inside the block (a host
    synchronisation raises), the previous mode after it."""
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def eager_steps(step, state: SlamState, seq: torch.Tensor, enable_mapping: bool,
                flat: torch.Tensor, rec: telemetry.SequenceRecord = telemetry.UNCOUNTED) -> SlamState:
    """The step called from Python on every frame of seq [T, *frame], its
    packed outputs written to flat[t]; returns the final state. The
    reference that a graph replay is held to, and the CPU path. Each step
    is a slam.step span and a launch of one step in rec."""
    for t in range(seq.shape[0]):
        t0 = rec.start("slam.step")
        state, out = step(state, seq[t], enable_mapping)
        flat[t] = pack_outputs(out)
        rec.stop_launch(1, t0)
    return state


class StepGraph:
    """N steps of `step` captured as one CUDA graph (the module docstring):
    state_in and frames are its static inputs, and it leaves its final state
    in state_in; flat [N, *lanes, K] is its packed output. launches holds the
    kernel launches its capture counted and capture_s the host seconds of
    the capture and the instantiation; record (telemetry.GraphRecord) its
    nodes by stage, capture seconds and replays. pool is another graph's
    pool() to allocate from (the module docstring), None for a pool of its
    own."""

    def __init__(self, step, state: SlamState, frames: torch.Tensor, enable_mapping: bool, pool=None):
        dev = state.x.device
        self.n = frames.shape[0]
        self.state_in = SlamState(*(t.clone() for t in state))
        self.frames = frames.clone()
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            step(self.state_in, self.frames[0], enable_mapping)
        t0 = time.perf_counter()
        before = dict(_build.launches)
        self.record = telemetry.GraphRecord(step.route, enable_mapping, self.n)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool, stream=stream):
            with sync_error(), telemetry.capture_stages(self.record):
                s, packed = self.state_in, []
                for i in range(self.n):
                    s, out = step(s, self.frames[i], enable_mapping)
                    packed.append(pack_outputs(out))
                self.flat = torch.stack(packed)
                self._keep(s)
        self.launches = {k: v - before[k] for k, v in _build.launches.items()}
        self.capture_s = time.perf_counter() - t0
        self.record.capture_s = self.capture_s
        telemetry.register(self.record)

    def _keep(self, final: SlamState):
        """Copy the final state into the static inputs (while capturing). A
        field that is a view of an input's memory is copied out first, so
        that no copy reads what another has overwritten."""
        inputs = {t.untyped_storage().data_ptr() for t in self.state_in}
        srcs = []
        for name, dst, src in zip(SlamState._fields, self.state_in, final):
            if src.shape != dst.shape or src.dtype != dst.dtype:
                raise RuntimeError(f"the step changed state field {name}: {tuple(dst.shape)} {dst.dtype} -> "
                                   f"{tuple(src.shape)} {src.dtype}")
            srcs.append(src.clone() if src is not dst and src.untyped_storage().data_ptr() in inputs else src)
        for dst, src in zip(self.state_in, srcs):
            if src is not dst:
                dst.copy_(src)

    def replay(self, state: SlamState, frames: torch.Tensor,
               rec: telemetry.SequenceRecord = telemetry.UNCOUNTED) -> SlamState:
        """Replay on frames [N, *frame] from state (copied in unless it is
        the graph's own state_in); returns state_in, which now holds the
        final state until the next replay. The copies in and the launch
        count in rec."""
        t0 = rec.start("slam.copy_in")
        if state is not self.state_in:
            for dst, src in zip(self.state_in, state):
                dst.copy_(src)
        self.frames.copy_(frames)
        t1 = rec.start("slam.launch", rec.stop("copies", t0))
        self.graph.replay()
        rec.stop_launch(self.n, t1)
        self.record.replays += 1
        return self.state_in


class FrameGraph:
    """One call of a frame fn(*state) -> (*state', *extra) captured as a
    CUDA graph whose end copies state' into its static state, so that each
    replay advances the state by one frame (the large-map EKF frames of
    eval/benchmark.py, sharded or not). fn must return new tensors for
    state'; extra are the graph's own outputs of its last replay. As for
    StepGraph: an eager warm-up call on a side stream first, the capture
    under sync debug mode "error", and launches holds the kernel launches
    its capture counted."""

    def __init__(self, fn, state, pool=None):
        dev = state[0].device
        self.state = tuple(t.clone() for t in state)
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            fn(*self.state)
        before = dict(_build.launches)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool, stream=stream):
            with sync_error():
                outs = fn(*self.state)
                n = len(self.state)
                inputs = {t.untyped_storage().data_ptr() for t in self.state}
                if any(t.untyped_storage().data_ptr() in inputs for t in outs[:n]):
                    raise RuntimeError("FrameGraph: fn returned a view of its input state")
                for dst, src in zip(self.state, outs[:n]):
                    dst.copy_(src)
                self.extra = tuple(outs[n:])
        self.launches = {k: v - before[k] for k, v in _build.launches.items()}

    def replay(self, n: int = 1):
        """n frames from the static state; returns it (overwritten by the
        next replay)."""
        for _ in range(n):
            self.graph.replay()
        return self.state


def cached_graph(step, graphs: dict, state: SlamState, frames: torch.Tensor,
                 enable_mapping: bool) -> StepGraph:
    """The StepGraph of `step` for frames [N, *frame] from graphs, keyed by
    (route, enable_mapping, N, state shapes and dtypes, frame shape), or one
    captured now from state and frames. graphs keeps at most MAX_GRAPHS, all
    in one memory pool; the least recently used one goes first."""
    key = (step.route, bool(enable_mapping), frames.shape[0],
           tuple((tuple(t.shape), t.dtype) for t in state), tuple(frames.shape[1:]))
    g = graphs.pop(key, None)
    if g is None:
        while len(graphs) >= MAX_GRAPHS:
            del graphs[next(iter(graphs))]
        pool = next(iter(graphs.values())).graph.pool() if graphs else None
        with telemetry.span("slam.capture"):
            g = StepGraph(step, state, frames, enable_mapping, pool)
    graphs[key] = g                         # the most recently used last
    return g


def replay_steps(step, graphs: dict, state: SlamState, seq: torch.Tensor, enable_mapping: bool,
                 chunk: int, flat: torch.Tensor,
                 rec: telemetry.SequenceRecord = telemetry.UNCOUNTED) -> SlamState:
    """seq [T, *frame] through CUDA graphs of `step` in the groups of
    chunk_plan(T, chunk), the packed outputs written to flat [T, ...].
    graphs caches the graphs (cached_graph); a missing one is captured from
    the state at hand. Returns the final state as tensors of its own (a
    copy, not the graph's). The copies and launches count in rec."""
    t = 0
    for n in chunk_plan(seq.shape[0], chunk):
        g = cached_graph(step, graphs, state, seq[t : t + n], enable_mapping)
        with sync_error():
            state = g.replay(state, seq[t : t + n], rec)
            t0 = rec.start("slam.copy_out")
            flat[t : t + n].copy_(g.flat)
            rec.stop("copies", t0)
        t += n
    t0 = rec.start("slam.copy_out")
    final = SlamState(*(x.clone() for x in state))
    rec.stop("copies", t0)
    return final


def replay_one(step, graphs: dict, state: SlamState, frame: torch.Tensor, enable_mapping: bool,
               rec: telemetry.SequenceRecord = telemetry.UNCOUNTED) -> tuple[SlamState, torch.Tensor]:
    """One step of `step` on frame [*frame] through the cache's one-step
    graph, the one replay_steps replays past the last full block (the same
    key, so the two share it): the state is copied into the graph's inputs
    (whatever changed it since the last call: reset, a loaded checkpoint,
    the facade's state surgery) and the frame into its frame buffer.
    Returns the state after the step and that step's packed row
    (pack_outputs), both as tensors of their own, which no later replay
    overwrites. The copies and the launch count in rec."""
    g = cached_graph(step, graphs, state, frame[None], enable_mapping)
    with sync_error():
        out = g.replay(state, frame[None], rec)
        t0 = rec.start("slam.copy_out")
        row = g.flat[0].clone()
        out = SlamState(*(x.clone() for x in out))
        rec.stop("copies", t0)
    return out, row
