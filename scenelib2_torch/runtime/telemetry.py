"""Spans and counters of the facade and the graph replay, and the step's
kernels by stage, counted when a graph is captured.

Spans. ``span(name)`` is a torch.profiler record function of FUNCTION
scope (``torch._C._profiler._RecordFunctionFast``) while a torch profiler
records, and a no-op context otherwise: off, a span costs the profiler
flag's check. A FUNCTION-scope range stays on the host's timeline; the
profiler mirrors USER-scope ranges (``torch.profiler.record_function``)
onto the device's, where they would read as device work. On, the spans sit
on the profiler's clock beside the device's activities, so an idle stretch
of the device names the program span that was open during it. The names:

  slam.go_one_step   a go_one_step call
  slam.run_sequence  a run_sequence call
  slam.upload        frames from the caller's memory to the device
  slam.copy_in       the state and frames into a graph's static inputs
  slam.launch        a graph's launch (cudaGraphLaunch on the host)
  slam.step          the step called eagerly (the CPU, the eager references)
  slam.copy_out      the outputs and the state out of a graph's tensors
  slam.unpack        the packed output row into StepOutputs
  slam.fetch         the host waiting on the device for what it fetches
  slam.reset         MonoSLAM.reset (rereads the known patches' files)
  slam.capture       a missing graph captured

Counters. Always on: host nanoseconds (``time.perf_counter_ns``) and counts
of each part, kept per sequence in a SequenceRecord. A MonoSLAM starts one
when built and another at each reset(); the module keeps the latest few so
that a reader without the facade object finds the newest that no profiler
slowed (``latest``). Parts
(PARTS): ``call`` (a go_one_step call), ``sequence`` (a run_sequence call),
``upload``, ``copies`` (copy_in and copy_out), ``launch`` (by graph steps
too; an eager step on the CPU counts here) and ``wait`` (the fetch).

Stages. The step marks the start of each stage with ``stage(name)``
(STAGES: s1_2 = K1 or predict + K7, s3 = the search, s4_6 = the update and
the bookkeeping, s7 = the speed gate and the auto-init, s8 = the particles
and their surgery, tail = the outputs, their packing and the graph's copy
of its final state into its inputs). A mark does nothing unless a
StepGraph is being captured: replays run no Python. While capturing, a
mark notes the node the capture added last (``cuStreamGetCaptureInfo`` of
the CUDA driver, through ctypes); when the capture ends, the graph's nodes
(``cuGraphGetNodes``, in the order they were added) are typed once
(``cuGraphNodeGetType``: kernel, copy = memcpy or memset, other) and split
at the marks, each stage taking the kernels up to the next mark.

Regions. Inside a stage, ``with region(name):`` marks a named part of the
step the same way, at its entry and at its exit; outside a StepGraph's
capture it is a no-op context (one flag check). A region counts the kernel
nodes between its entries and exits, those of regions nested in it
included; a region nested in one of its own name counts once. The names
(REGIONS): ``ekf.predict`` (core/ekf.py ``predict``), ``ekf.update`` (the
split route's ``joint_update`` with K14's S^-1, ``normalise`` and
``symmetrize``, runtime/step.py) and ``mm_seq`` (every call of
core/quaternion.py ``mm_seq``, whatever region it lies in).

Each StepGraph keeps a GraphRecord (its key, kernel nodes by stage and by
region a step, copy nodes, capture seconds, replays); ``graphs()`` lists
the records of the graphs alive in the process, MonoSLAM.graphs() those of
one facade.
"""

from __future__ import annotations

import collections
import ctypes
import itertools
import time
import weakref

import numpy as np
import torch

STAGES = ("s1_2", "s3", "s4_6", "s7", "s8", "tail")
REGIONS = ("ekf.predict", "ekf.update", "mm_seq")
UNMARKED = "unmarked"     # the stage of nodes captured before a graph's first mark
PARTS = ("call", "sequence", "upload", "copies", "launch", "wait")
KEEP_SEQUENCES = 8        # the sequence records `latest` can reach

now = time.perf_counter_ns
_profiling = torch._C._autograd._profiler_enabled
_RecordFunction = torch._C._profiler._RecordFunctionFast


class _Off:
    """The span when no profiler records: a reusable no-op context."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return None


_OFF = _Off()


def span(name: str):
    """A FUNCTION-scope record function `name` while a torch profiler
    records, else a no-op context."""
    return _RecordFunction(name) if _profiling() else _OFF


# ------------------------------------------------------------------ counters


class SequenceRecord:
    """Host nanoseconds (ns) and counts (n) of each part of PARTS over one
    sequence, the frames stepped, the launches by graph steps
    ({steps: [ns, count]}), and whether a profiler recorded during any of
    its spans (profiled: its times then hold the profiler's cost).

    The entry points open their spans with span(); the parts inside them,
    which hold no span of their own, with start() and stop(), which take
    the part's clock readings too: off, a part costs two clock readings and
    the profiler flag's check."""

    def __init__(self):
        self.ns = dict.fromkeys(PARTS, 0)
        self.n = dict.fromkeys(PARTS, 0)
        self.frames = 0
        self.launches: dict[int, list] = {}
        self.profiled = False
        self._part = None      # the open part's record function

    def span(self, name: str):
        """span(name), noting on the record whether a profiler recorded."""
        if _profiling():
            self.profiled = True
            return _RecordFunction(name)
        return _OFF

    def start(self, name: str, t0: int | None = None) -> int:
        """A part starts: its span `name` opened where a profiler records;
        returns its start, t0 or now()."""
        if _profiling():
            self.profiled = True
            self._part = _RecordFunction(name)
            self._part.__enter__()
        return now() if t0 is None else t0

    def stop(self, part: str | None, t0: int, t1: int | None = None) -> int:
        """The part that started at t0 ends at t1 (now() where not given):
        counted under `part` (not where None), its span closed. Returns t1."""
        t1 = now() if t1 is None else t1
        if part is not None:
            self.ns[part] += t1 - t0
            self.n[part] += 1
        if self._part is not None:
            self._part.__exit__(None, None, None)
            self._part = None
        return t1

    def stop_launch(self, steps: int, t0: int) -> None:
        """stop("launch", t0) of a launch of `steps` steps (a graph's, or one eager step)."""
        t1 = self.stop("launch", t0)
        c = self.launches.get(steps)
        if c is None:
            c = self.launches[steps] = [0, 0]
        c[0] += t1 - t0
        c[1] += 1

    def as_dict(self) -> dict:
        return dict(frames=self.frames, profiled=self.profiled, ns=dict(self.ns), n=dict(self.n),
                    launches={str(k): list(v) for k, v in sorted(self.launches.items())})


# the record of the replay functions' callers that keep none (run_batch,
# the benches): counted, never read
UNCOUNTED = SequenceRecord()
_sequences: collections.deque = collections.deque(maxlen=KEEP_SEQUENCES)


def new_sequence() -> SequenceRecord:
    """A new record, the latest from now on."""
    rec = SequenceRecord()
    _sequences.append(rec)
    return rec


def latest() -> SequenceRecord | None:
    """The newest record that a facade started and no profiler recorded
    during (its times hold no profiler's cost), None if there is none."""
    for rec in reversed(_sequences):
        if not rec.profiled:
            return rec
    return None


# ------------------------------------------------------------------ graphs


class GraphRecord:
    """A captured StepGraph: its key (route, mapping, steps), its kernel
    nodes by stage a step (stage_kernels, STAGES and UNMARKED where it
    captured any) and by region a step (region_kernels, the REGIONS its
    capture entered), its kernel, copy (memcpy and memset) and other nodes
    in all, the seconds of its capture (StepGraph.capture_s) and its
    replays."""

    def __init__(self, route: str, mapping: bool, steps: int):
        self.route, self.mapping, self.steps = route, bool(mapping), steps
        self.stage_kernels: dict[str, float] = {}
        self.region_kernels: dict[str, float] = {}
        self.kernel_nodes = self.copy_nodes = self.other_nodes = 0
        self.capture_s = 0.0
        self.replays = 0

    def as_dict(self) -> dict:
        return dict(route=self.route, mapping=self.mapping, steps=self.steps,
                    stage_kernels=dict(self.stage_kernels), region_kernels=dict(self.region_kernels),
                    kernel_nodes=self.kernel_nodes, copy_nodes=self.copy_nodes, other_nodes=self.other_nodes,
                    capture_s=self.capture_s, replays=self.replays)


_registry: weakref.WeakValueDictionary = weakref.WeakValueDictionary()
_ids = itertools.count()


def register(rec: GraphRecord) -> None:
    """List rec in graphs() for as long as something holds it (its graph)."""
    _registry[next(_ids)] = rec


def graphs() -> list[dict]:
    """The records of the captured graphs alive in the process, oldest first."""
    return [rec.as_dict() for rec in list(_registry.values())]


# ------------------------------------------------------------------ stages

_NODE_KERNEL, _NODE_MEMCPY, _NODE_MEMSET = 0, 1, 2     # CUgraphNodeType


class StageTally:
    """The stage and region marks of one capture: mark(name, last) opens
    stage `name` after the nodes `last` (those the capture added last: none
    before the first); region(name, entering, last) enters or leaves region
    `name` there. close() splits the graph's nodes at the marks."""

    def __init__(self):
        self.marks: list = []
        self.regions: list = []

    def mark(self, name: str, last: list) -> None:
        self.marks.append((name, last))

    def region(self, name: str, entering: bool, last: list) -> None:
        self.regions.append((name, entering, last))

    def close(self, rec: GraphRecord, nodes: list, kinds: list) -> None:
        """rec takes the kernel nodes by stage and by region a step, and the
        kernel, copy and other nodes in all, of the graph's nodes in the
        order they were added and their CUgraphNodeType. Where the stage
        marks do not follow that order, rec takes no stages; where the
        region marks do not, or a region is left unbalanced, no regions."""
        kinds = np.asarray(kinds, dtype=np.int64)
        kernel = np.concatenate([[0], np.cumsum(kinds == _NODE_KERNEL)])
        copies = int(np.isin(kinds, (_NODE_MEMCPY, _NODE_MEMSET)).sum())
        rec.kernel_nodes, rec.copy_nodes = int(kernel[-1]), copies
        rec.other_nodes = len(nodes) - rec.kernel_nodes - copies
        where = {node: i for i, node in enumerate(nodes)}
        rec.region_kernels = self._region_kernels(where, kernel, rec.steps)
        starts = [max((where[node] + 1 for node in last), default=0) for _name, last in self.marks]
        if starts != sorted(starts):
            rec.stage_kernels = {}
            return
        bounds = [0] + starts + [len(nodes)]
        names = [UNMARKED] + [name for name, _last in self.marks]
        by: dict[str, int] = {}
        for name, a, b in zip(names, bounds, bounds[1:]):
            by[name] = by.get(name, 0) + int(kernel[b] - kernel[a])
        rec.stage_kernels = {k: v / rec.steps for k, v in by.items() if k != UNMARKED or v}

    def _region_kernels(self, where: dict, kernel: np.ndarray, steps: int) -> dict:
        """Kernel nodes a step between each region's outermost entries and
        their exits (a region inside one of its own name adds nothing)."""
        at = [max((where[node] + 1 for node in last), default=0) for _name, _entering, last in self.regions]
        if at != sorted(at):
            return {}
        depth: dict[str, int] = {}
        entered: dict[str, int] = {}
        by: dict[str, int] = {}
        for (name, entering, _last), i in zip(self.regions, at):
            d = depth.get(name, 0) + (1 if entering else -1)
            if d < 0:
                return {}
            if entering and d == 1:
                entered[name] = i
            elif not entering and d == 0:
                by[name] = by.get(name, 0) + int(kernel[i] - kernel[entered[name]])
            depth[name] = d
        if any(depth.values()):
            return {}
        return {k: v / steps for k, v in by.items()}


class _Driver:
    """The CUDA driver's queries of a graph under capture (libcuda through
    ctypes)."""

    def __init__(self):
        cu = ctypes.CDLL("libcuda.so.1")
        vp, pint, psize = ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_size_t)
        # (stream, status, id, graph, dependencies, [edge data,] count); v3
        # adds the edge data: NULL for it and for the id
        if hasattr(cu, "cuStreamGetCaptureInfo_v2"):
            self._info, self._edges = cu.cuStreamGetCaptureInfo_v2, ()
        else:
            self._info, self._edges = cu.cuStreamGetCaptureInfo_v3, (None,)
        self._info.argtypes = ([vp, pint, vp, ctypes.POINTER(vp), ctypes.POINTER(ctypes.POINTER(vp))]
                               + [vp] * len(self._edges) + [psize])
        self._nodes = cu.cuGraphGetNodes
        self._nodes.argtypes = [vp, vp, psize]
        self._type = cu.cuGraphNodeGetType
        self._type.argtypes = [vp, pint]
        for fn in (self._info, self._nodes, self._type):
            fn.restype = ctypes.c_int
        self._kind = ctypes.c_int()
        self._kind_ref = ctypes.byref(self._kind)

    @staticmethod
    def _check(err: int, what: str) -> None:
        if err != 0:
            raise RuntimeError(f"{what}: CUDA driver error {err}")

    def capture(self, stream: int) -> tuple:
        """(the graph that `stream` is capturing, the nodes that the next
        node captured on it would depend on: the last it added, none at
        first)."""
        status, graph = ctypes.c_int(), ctypes.c_void_p()
        deps, n = ctypes.POINTER(ctypes.c_void_p)(), ctypes.c_size_t()
        self._check(self._info(stream, ctypes.byref(status), None, ctypes.byref(graph), ctypes.byref(deps),
                               *self._edges, ctypes.byref(n)), "cuStreamGetCaptureInfo")
        return graph.value, [deps[i] for i in range(n.value)]

    def nodes(self, graph: int) -> list:
        """The graph's nodes, in the order they were added (an array of
        none is refused: asked only where there are nodes)."""
        count = ctypes.c_size_t(0)
        self._check(self._nodes(graph, None, ctypes.byref(count)), "cuGraphGetNodes")
        if count.value == 0:
            return []
        nodes = (ctypes.c_void_p * count.value)()
        self._check(self._nodes(graph, nodes, ctypes.byref(count)), "cuGraphGetNodes")
        return nodes[: count.value]

    def node_type(self, node: int) -> int:
        """The node's CUgraphNodeType."""
        self._check(self._type(node, self._kind_ref), "cuGraphNodeGetType")
        return self._kind.value


_capture: StageTally | None = None     # the marks of the StepGraph being captured
_driver_api: _Driver | None = None


def _driver() -> _Driver:
    global _driver_api
    if _driver_api is None:
        _driver_api = _Driver()
    return _driver_api


def _capturing_stream() -> int | None:
    """The current stream's handle while it is being captured, else None."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        return torch.cuda.current_stream().cuda_stream
    return None


def stage(name: str) -> None:
    """Mark the start of step stage `name` (STAGES) in the graph being
    captured; nothing outside a StepGraph's capture."""
    if _capture is not None:
        stream = _capturing_stream()
        if stream is not None:
            _capture.mark(name, _driver().capture(stream)[1])


class _Region:
    """The marks of a region in the graph being captured, at its entry and
    at its exit."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def _mark(self, entering: bool) -> None:
        stream = _capturing_stream() if _capture is not None else None
        if stream is not None:
            _capture.region(self.name, entering, _driver().capture(stream)[1])

    def __enter__(self):
        self._mark(True)
        return None

    def __exit__(self, *exc):
        self._mark(False)
        return None


def region(name: str):
    """A context marking step region `name` (REGIONS) in the graph being
    captured; the no-op context outside a StepGraph's capture."""
    return _OFF if _capture is None else _Region(name)


class capture_stages:
    """Inside a StepGraph's capture: the stage and region marks count into
    rec, which takes the nodes by stage and by region when the block ends
    without an error (its nodes typed once, there)."""

    def __init__(self, rec: GraphRecord):
        self.rec = rec

    def __enter__(self):
        global _capture
        _capture = StageTally()
        return self

    def __exit__(self, exc_type, *exc):
        global _capture
        tally, _capture = _capture, None
        if exc_type is None:
            cuda = _driver()
            graph, _last = cuda.capture(_capturing_stream())
            nodes = cuda.nodes(graph)
            tally.close(self.rec, nodes, [cuda.node_type(node) for node in nodes])
        return None
