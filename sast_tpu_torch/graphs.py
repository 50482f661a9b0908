"""A step as captured CUDA graphs: the port's ``jax.jit`` with donated state.

JAX runs each serving step as one compiled program and donates the carried
state to it (sast_tpu/serving.py:156-169, export.py:72-76 and :125,
utils/benchmark.py:60-91). The port's counterpart, for a step written as a
body that reads and writes static buffers:

- ``Captured``: ``body()`` run once eagerly on a side stream (the warm-up:
  the real step, which fills every cache and builds every kernel library,
  every data-dependent choice taken both ways), then captured into a
  ``Schedule``; later calls replay it. The body writes the carried state
  back into its buffers (``copy_``), which is what donation gives JAX. With
  ``graph`` off, or on the CPU, the same body runs eagerly every time.
- ``Schedule``: the graphs of one capture, sharing one memory pool. A body
  without a data-dependent choice is one graph. At each choice (``choose``)
  the running graph ends, each branch is captured as a graph of its own
  writing into one output, and the next graph begins. At the end of the
  capture the schedule assembles its graphs into one parent graph, in
  capture order, where each choice is a kernel node that reads the 0-d
  predicate on the card and a conditional node over the two branches
  (``csrc/cond.cu``): a replay is one launch of that graph, and no
  predicate crosses to the host (JAX's ``lax.cond`` inside one compiled
  program). A node that the CUDA driver refuses makes the capture raise.
- ``choose``: JAX's ``lax.cond`` for eager code: one host read of the
  predicate, both branches during a warm-up, a choice of the schedule
  during a capture. The schedule being captured is visible to every
  thread, so that the backward of a captured train step, which autograd
  runs on its own thread for a card, chooses inside the capture as well.
- ``run_together``: the replicas of a mesh, called together: each replay is
  one launch on its own card, all enqueued before any output is returned.
- ``CapturedStep``: a step on its static inputs and carried state through
  ``Captured``: the serving step (``serving_step``; the live detector,
  ``serving.py``, and the loaded artifact, ``export.py``) and the train and
  eval steps (``training/steps.py``). ``Staging``: the page-locked host
  buffers of a serving batch's upload and of its slate's download; the
  upload is the events field by field with no padding, which the serving
  step unpacks on the card (``unpack_events``).
- ``BatchBuffers``: a training or evaluation batch's static buffers on the
  card, filled from page-locked staging (host arrays) or by a copy on the
  card, unless a producer wrote straight into them
  (``data/device_cache.py``); the captured train and eval steps of
  ``training/steps.py`` read them.
- Launch counts: the kernels' wrappers count what they enqueue, and a
  replay runs no Python. Each graph keeps the counts recorded while it was
  captured; ``Captured.recorded`` sums them over its captures.
  ``Captured.replayed`` sums each segment's counts times the replays, and
  each branch's counts times the times the card took it, which the
  choice's kernel node counts on the card (read when ``replayed`` is asked
  for, not at a replay); so the launches a card ran are the wrappers'
  counts less ``recorded`` plus ``replayed``.

Captured graphs read the tensors they were captured with: the weights in
place (``models/layers.cached_copy`` rewrites the compute-dtype copies in
place), and the tensors that cross from one graph of a schedule to the next,
which their Python holders keep while a later graph is captured that reads
them. A block of the pool freed after its last reader's capture goes to a
later graph, which replays after that reader: the graphs share one pool and
replay in capture order. ``Captured`` watches the
storage and version of the weights it was given, and the storage of the
other state it is told of (an optimizer's moments, an EMA copy): a version
change refreshes the copies before the next replay, a moved storage
captures again. A replay writes tensors without Python, so without moving
their version: a body that writes weights (the train step) has its caller
move them (``bump_versions``), so that the copies and the other captures
that read those weights see the change.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import gc
import weakref
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.utils._pytree as pytree

from sast_tpu_torch.packing import FIELDS, pack_event_fields
from sast_tpu_torch.utils import timers

class _Active:
    """The schedule that ``choose`` consults: one per process, not per
    thread (module docstring)."""

    schedule: Optional["Schedule"] = None


_active = _Active()


def launch_counts() -> Dict[str, int]:
    """The launch counter of every kernel wrapper, by wrapper name."""
    from sast_tpu_torch.ops import density, fused_block, nms_keep, sparse_block, stem_conv

    wrappers = (stem_conv.stem_conv7x4, density.density_ratio, nms_keep.greedy_keep,
                fused_block.fused_window_block, fused_block.rvt_window_block,
                sparse_block.sparse_window_block,
                sparse_block.sparse_window_block_looped, sparse_block.sparse_block_mlp_bwd,
                sparse_block.sparse_block_attn_bwd)
    return {w.__name__: w.launches for w in wrappers}


def _since(before: Dict[str, int]) -> collections.Counter:
    now = launch_counts()
    return collections.Counter({k: now[k] - before[k] for k in now if now[k] != before[k]})


def choose(pred: torch.Tensor, true_fn: Callable, false_fn: Callable, operands: Tuple,
           label: str = "a choice"):
    """``lax.cond(pred, true_fn, false_fn, *operands)`` outside a trace:
    eagerly one host read of the 0-d ``pred``; inside a ``Captured``
    warm-up both branches (the chosen result returned); inside its capture
    a choice of the schedule, taken on the card at replay. Each branch
    returns new tensors of one structure, shapes and dtypes, and writes none
    of its operands. ``label`` names the choice's configuration in the
    errors of a capture."""
    schedule = _active.schedule
    if schedule is None:
        return true_fn(*operands) if bool(pred) else false_fn(*operands)
    return schedule.choose(pred, true_fn, false_fn, operands, label)


# cudaGraphNodeType, by value (driver_types.h)
NODE_TYPES = ("kernel", "memcpy", "memset", "host", "child graph", "empty", "event wait",
              "event record", "external semaphore signal", "external semaphore wait",
              "memory allocation", "memory free", "batch memory operation", "conditional")
# The nodes of cond.cu's add_choice, by the stage it reports
_STAGES = {1: "conditional handle", 2: "condition-setting kernel node",
           3: "conditional (IF) node", 4: "child-graph node inside a conditional body"}


def _cond_library(device: torch.device):
    """``csrc/cond.cu``'s library for ``device``, its entries typed."""
    return _typed_cond_library(device.index or 0)


@functools.cache
def _typed_cond_library(card: int):
    import ctypes

    from sast_tpu_torch import build

    lib = build.load("cond", card)
    ptr, ptrs, i32p = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)
    for name, args in (("sast_cond_graph_create", [ptrs]),
                       ("sast_cond_node_types", [ptr, ctypes.POINTER(ctypes.c_longlong),
                                                 ctypes.c_int]),
                       ("sast_cond_add_segment", [ptr, ptrs, ptr]),
                       ("sast_cond_add_choice", [ptr, ptrs, ptr, ptr, ptr, ptr, i32p]),
                       ("sast_cond_instantiate", [ptr, ptrs, i32p]),
                       ("sast_cond_launch", [ptr, ptr]),
                       ("sast_cond_destroy", [ptr, ptr])):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, ctypes.c_int
    return lib


def _node_types(graph: torch.cuda.CUDAGraph, device) -> collections.Counter:
    """The nodes of a captured ``keep_graph`` graph (child graphs
    included), by type name."""
    import ctypes

    lib = _cond_library(torch.device(device))
    counts = (ctypes.c_longlong * len(NODE_TYPES))()
    with torch.cuda.device(device):
        rc = lib.sast_cond_node_types(ctypes.c_void_p(graph.raw_cuda_graph()), counts,
                                      len(NODE_TYPES))
    if rc:
        raise RuntimeError(f"counting a graph's nodes: CUDA error {rc}")
    return collections.Counter({NODE_TYPES[i]: n for i, n in enumerate(counts) if n})


class _NoGenerator(torch.utils._python_dispatch.TorchDispatchMode):
    """Refuses, by name, an operator that draws from torch's generator while
    a schedule captures: the assembled graph bypasses ``CUDAGraph.replay``,
    which advances the generator's offsets, so such a draw would repeat its
    numbers at every replay."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if torch.Tag.nondeterministic_seeded in func.tags:
            raise RuntimeError(f"{func} draws from torch's random generator inside a captured "
                               "step; a replay of the assembled graph would repeat its numbers")
        return func(*args, **(kwargs or {}))


class Schedule:
    """The graphs of one capture on ``device``, assembled at its end into one
    parent graph whose choices are conditional nodes (``assemble``); a
    replay is one launch of it on the current stream. The launches recorded
    at capture are added to the counter ``recorded``; ``replayed()`` counts
    those the replays ran."""

    def __init__(self, recorded: collections.Counter, device):
        self.device = torch.device(device)
        self.pool = torch.cuda.graph_pool_handle()
        # ("run", graph, counts) or ("choose", pred, (graph, counts), (graph, counts), label)
        self.items: List[tuple] = []
        self.held: List[torch.Tensor] = []  # the predicates, which the set kernels read
        self.recorded = recorded
        self.replays = 0
        self.taken: Optional[torch.Tensor] = None  # (choices, 2) int64: branch counts on the card
        self._exec = None
        self._graph = None
        self._counts = None
        self.warming = False

    def _begin(self) -> None:
        # keep_graph: the graph is assembled into the parent, never
        # instantiated alone. "relaxed": the backward of a train step runs
        # on autograd's thread, so a graph may begin on one thread and end
        # on another.
        self._graph = torch.cuda.CUDAGraph(keep_graph=True)
        self._counts = launch_counts()
        self._graph.capture_begin(pool=self.pool, capture_error_mode="relaxed")

    def _end(self) -> Tuple[torch.cuda.CUDAGraph, collections.Counter]:
        graph, self._graph = self._graph, None
        graph.capture_end()
        counts = _since(self._counts)
        self.recorded.update(counts)
        return graph, counts

    def _abort(self) -> None:
        """End a capture that raised, so that the stream is usable again;
        the body's own error is the one that propagates."""
        if self._graph is not None:
            graph, self._graph = self._graph, None
            try:
                graph.capture_end()
            except RuntimeError:
                pass

    def capture(self, body: Callable):
        """Capture ``body()`` (on the current stream, which must be a side
        stream), assemble the parent graph and return the body's outputs:
        tensors of the pool that every replay rewrites."""
        self._begin()
        try:
            with _NoGenerator():
                out = body()
            self.items.append(("run", *self._end()))
        except BaseException:
            self._abort()
            raise
        self.assemble()
        return out

    def choose(self, pred, true_fn, false_fn, operands, label):
        if self.warming:
            taken = [true_fn(*operands), false_fn(*operands)]
            return taken[0] if bool(pred) else taken[1]
        self.items.append(("run", *self._end()))
        ins = [t for t in pytree.tree_leaves(operands) if isinstance(t, torch.Tensor)]
        first, out = self._branch(true_fn, operands, None)
        for t in pytree.tree_leaves(out):
            if any(t.untyped_storage().data_ptr() == o.untyped_storage().data_ptr() for o in ins):
                raise ValueError("a branch of a captured choice returned a view of its operand")
        second, _ = self._branch(false_fn, operands, out)
        self.items.append(("choose", pred, first, second, label))
        self.held.append(pred)
        self._begin()
        return out

    def _branch(self, fn, operands, into):
        """One branch as a graph; its result written into ``into``'s
        tensors where given (the other branch's outputs)."""
        self._begin()
        try:
            out = fn(*operands)
            if into is not None:
                want, spec = pytree.tree_flatten(into)
                got, got_spec = pytree.tree_flatten(out)
                if got_spec != spec or any((a.shape, a.dtype) != (b.shape, b.dtype)
                                           for a, b in zip(want, got)):
                    raise ValueError("the branches of a captured choice return different "
                                     "structures, shapes or dtypes")
                for a, b in zip(want, got):
                    a.copy_(b)
            return self._end(), out
        except BaseException:
            self._abort()
            raise

    def assemble(self) -> None:
        """The parent graph of the captured graphs, instantiated: each
        segment a child-graph node, each choice a condition-setting kernel
        node and an IF node with an else body over its branches
        (``csrc/cond.cu``), one after another in capture order. Raises, naming the node
        and the configuration, where the CUDA driver refuses a node; nothing is
        then replayed."""
        import ctypes

        lib = _cond_library(self.device)
        choices = [item for item in self.items if item[0] == "choose"]
        what = ", ".join(dict.fromkeys(item[4] for item in choices)) or "no choice"
        with torch.cuda.device(self.device):
            self.taken = torch.zeros((max(len(choices), 1), 2), dtype=torch.int64,
                                     device=self.device)
            graph, tail = ctypes.c_void_p(), ctypes.c_void_p()
            self._check(lib.sast_cond_graph_create(ctypes.byref(graph)), "creating the graph",
                        what)
            handles = [graph.value, None]  # the parent graph and its instance
            # Not at exit: the CUDA driver frees a process's graphs with it.
            weakref.finalize(self, _destroy, lib, handles, self.device).atexit = False
            i = 0
            for item in self.items:
                if item[0] == "run":
                    if _node_types(item[1], self.device):
                        self._check(lib.sast_cond_add_segment(
                            graph, ctypes.byref(tail), ctypes.c_void_p(item[1].raw_cuda_graph())),
                            "adding a segment's child-graph node", what)
                    continue
                _, pred, (first, _), (second, _), label = item
                stage = ctypes.c_int(0)
                rc = lib.sast_cond_add_choice(
                    graph, ctypes.byref(tail), ctypes.c_void_p(pred.data_ptr()),
                    ctypes.c_void_p(self.taken[i].data_ptr()),
                    ctypes.c_void_p(first.raw_cuda_graph()),
                    ctypes.c_void_p(second.raw_cuda_graph()), ctypes.byref(stage))
                if rc:
                    bodies = sum((_node_types(g, self.device) for g in (first, second)),
                                 collections.Counter())
                    raise RuntimeError(
                        f"the CUDA driver refused the {_STAGES.get(stage.value, 'node')} of the "
                        f"choice {i} ({label}): CUDA error {rc}; the branches hold "
                        f"{dict(bodies)}")
                i += 1
            exec_, node = ctypes.c_void_p(), ctypes.c_int(-1)
            rc = lib.sast_cond_instantiate(graph, ctypes.byref(exec_), ctypes.byref(node))
            if rc:
                name = NODE_TYPES[node.value] if 0 <= node.value < len(NODE_TYPES) else "no"
                raise RuntimeError(
                    f"the CUDA driver refused to instantiate the step's graph ({what}): "
                    f"CUDA error {rc} at a {name} node")
            handles[1] = exec_.value
            self._exec = exec_

    @staticmethod
    def _check(rc: int, what: str, config: str) -> None:
        if rc:
            raise RuntimeError(f"{what} of the step's graph ({config}): CUDA error {rc}")

    def replay(self) -> None:
        """One launch of the assembled graph on the current stream."""
        import ctypes

        stream = torch.cuda.current_stream(self.device).cuda_stream
        rc = _cond_library(self.device).sast_cond_launch(self._exec, ctypes.c_void_p(stream))
        if rc:
            raise RuntimeError(f"launching the step's graph: CUDA error {rc}")
        self.replays += 1

    def replayed(self) -> collections.Counter:
        """The launches the replays ran: each segment's counts times the
        replays, each branch's times the times the card took it (one read
        of the counters on the card)."""
        out: collections.Counter = collections.Counter()
        taken = self.taken.tolist() if self.taken is not None else []
        i = 0
        for item in self.items:
            if item[0] == "run":
                for k, n in item[2].items():
                    out[k] += n * self.replays
                continue
            for (_, counts), times in zip(item[2:4], taken[i]):
                for k, n in counts.items():
                    out[k] += n * times
            i += 1
        return out

    @contextlib.contextmanager
    def active(self, warming: bool):
        """Make this schedule the one ``choose`` consults."""
        if _active.schedule is not None:
            raise RuntimeError("a capture is already running")
        _active.schedule, self.warming = self, warming
        try:
            yield
        finally:
            _active.schedule, self.warming = None, False


def _destroy(lib, handles, device) -> None:
    """Destroy a schedule's parent graph and its instance (``handles``)."""
    import ctypes

    with torch.cuda.device(device):
        lib.sast_cond_destroy(*(ctypes.c_void_p(h) for h in handles))


class Captured:
    """``body()`` on static buffers of ``device``, replayed as one captured
    CUDA graph (module docstring).

    ``body`` reads its inputs from buffers that the caller rewrites in place
    before each call and writes the carried state back into its own; it
    returns its outputs. ``weights``: the modules whose parameters and
    buffers the graphs read. ``graph`` False, or a CPU ``device``, runs the
    body eagerly at every call. A call returns the body's outputs: after a
    replay the schedule's own tensors, which the next call rewrites.

    The graphs are captured again when a weight moved, when a tensor of
    ``state()`` (the other state the body reads and writes in place) moved,
    or when a switch that picks a kernel as the body runs
    (``_kernel_switches``) changed since the capture: a replay runs the
    kernels of the capture."""

    def __init__(self, body: Callable, device, graph: bool = True,
                 weights: Sequence[nn.Module] = (),
                 state: Optional[Callable[[], List[torch.Tensor]]] = None):
        self.body = body
        self.device = torch.device(device)
        self.graph = bool(graph) and self.device.type == "cuda"
        self.weights = list(weights)
        self.state = state
        self.schedule: Optional[Schedule] = None
        self.outputs = None
        self.recorded: collections.Counter = collections.Counter()
        self._replayed: collections.Counter = collections.Counter()  # of earlier schedules
        self._replays = 0
        self._watched: List[torch.Tensor] = []
        self._stamps: list = []
        self._state_ptrs: list = []
        self._switches: tuple = ()

    @property
    def replays(self) -> int:
        return self._replays + (self.schedule.replays if self.schedule is not None else 0)

    @property
    def replayed(self) -> collections.Counter:
        """The launches the replays of every capture ran (``Schedule.replayed``)."""
        out = collections.Counter(self._replayed)
        if self.schedule is not None:
            out.update(self.schedule.replayed())
        return out

    def __call__(self):
        (out,) = run_together([self])
        return out

    def _drop(self) -> None:
        """Forget the capture, keeping what its replays ran."""
        self._replayed.update(self.schedule.replayed())
        self._replays += self.schedule.replays
        self.schedule = self.outputs = None

    def _call(self):
        if not self.graph:
            return self.body()
        if self.schedule is not None and (self._switches != _kernel_switches(self.weights)
                                          or not self._weights_current()):
            self._drop()
        if self.schedule is None:
            return self._warm_up_and_capture()
        self.schedule.replay()
        return self.outputs

    def _weights_current(self) -> bool:
        """True where the graphs may be replayed: the weights kept their
        storage (their compute-dtype copies are brought up to date here when
        a weight was written in place)."""
        if self.state is not None and [t.data_ptr() for t in self.state()] != self._state_ptrs:
            return False
        stamps = [(t.data_ptr(), t._version) for t in self._watched]
        if stamps == self._stamps:
            return True
        if [s[0] for s in stamps] != [s[0] for s in self._stamps]:
            return False
        _refresh_copies(self.weights)
        self._stamps = stamps
        return True

    def _warm_up_and_capture(self):
        self._switches = _kernel_switches(self.weights)
        schedule = Schedule(self.recorded, self.device)
        caller = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        with torch.cuda.device(self.device):
            side.wait_stream(caller)
            with torch.cuda.stream(side):
                with schedule.active(warming=True):
                    out = self.body()
                # A warm-up that wrote the weights (a train step) left their
                # compute-dtype copies stale: bring them up to date now, or
                # the capture records their refresh into whichever branch
                # first reads them, which a replay may not take.
                _refresh_copies(self.weights)
                torch.cuda.synchronize(self.device)
                # Destroying a graph while a capture runs is refused and
                # breaks the capture; the cycle collector would destroy the
                # graphs of dead objects at any allocation, so collect now
                # and not during the capture.
                gc.collect()
                collecting = gc.isenabled()
                gc.disable()
                try:
                    with schedule.active(warming=False):
                        self.outputs = schedule.capture(self.body)
                finally:
                    if collecting:
                        gc.enable()
            caller.wait_stream(side)
        self._watched = [t for m in self.weights for t in (*m.parameters(), *m.buffers())]
        self._stamps = [(t.data_ptr(), t._version) for t in self._watched]
        self._state_ptrs = [t.data_ptr() for t in self.state()] if self.state else []
        self.schedule = schedule
        return out


def _refresh_copies(weights: Sequence[nn.Module]) -> None:
    """Bring the compute-dtype copies of the weights in ``weights`` up to
    date with them, in place (``models/layers.refresh_compute_copies``)."""
    if any("_compute_copies" in m.__dict__ for w in weights for m in w.modules()):
        from sast_tpu_torch.models.layers import refresh_compute_copies

        for module in weights:
            refresh_compute_copies(module)


def _kernel_switches(weights: Sequence[nn.Module] = ()) -> tuple:
    """The switches that pick a kernel as a body runs: the module-level
    ``sparse_block.MODEL_USES_LOOPED`` (kernel F or E on the sparse path),
    then each attention layer's ``sparse_kernel`` in ``weights``
    (``models/detector.set_sparse_kernel``, which a trainer flips between
    its train and eval paths)."""
    from sast_tpu_torch.models.sast import MaskedSparseAttention
    from sast_tpu_torch.ops import sparse_block

    layers = tuple(m.sparse_kernel for w in weights for m in w.modules()
                   if isinstance(m, MaskedSparseAttention))
    return (sparse_block.MODEL_USES_LOOPED,) + layers


def bump_versions(tensors: Sequence[torch.Tensor]) -> None:
    """Move the version of each of ``tensors`` as an in-place write does:
    after a replay that wrote them, so that whatever is stamped with their
    version (``models/layers.cached_copy``, another ``Captured``) sees the
    write."""
    for t in tensors:
        torch.autograd.graph.increment_version(t)


def run_together(runs: Sequence[Captured]) -> list:
    """Call every ``Captured`` of ``runs`` (the replicas of a mesh), each on
    its own card, and return their outputs in order. A replay is one launch
    that reads nothing on the host, so every replica's step is enqueued
    before any output is returned; a warm-up, a capture or an eager call
    runs whole, in turn."""
    outs = []
    for run in runs:
        device = run.device
        with torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext():
            outs.append(run._call())
    return outs


class CapturedStep:
    """A step function on static buffers: ``fn(states, inputs) ->
    (new_states, out)`` on ``device``.

    ``inputs`` (a dict of tensors) are the static inputs, which the caller
    rewrites in place before each call; ``states`` holds the carried state
    (a list of tuples of tensors, cloned from ``init_states``), written back
    in place by every step (JAX donates it). A call runs one step and
    returns ``out``: on a card with ``graph`` on, the first call runs the
    step eagerly as the warm-up and captures it, and every later call
    replays the graphs and returns their own output tensors, which the next
    call rewrites (``Captured``; ``weights``: the modules whose parameters
    the graphs read; ``state``: the other state they read and write in
    place). Otherwise the step runs eagerly every call."""

    def __init__(self, fn: Callable, init_states, inputs: Dict[str, torch.Tensor], device,
                 graph: bool = True, weights: Sequence[nn.Module] = (),
                 state: Optional[Callable[[], List[torch.Tensor]]] = None):
        self.device = torch.device(device)
        self.states = [tuple(t.clone() for t in hc) for hc in init_states]
        self.inputs = inputs
        # The body holds the buffers, not this object: no reference cycle
        # keeps the graphs alive after their owner is gone.
        states = self.states

        def body():
            new_states, out = fn(states, inputs)
            for hc, new in zip(states, new_states):
                for t, v in zip(hc, new):
                    t.copy_(v)
            return out

        self.run = Captured(body, self.device, graph, weights, state=state)

    def zero_states(self) -> None:
        for hc in self.states:
            for t in hc:
                t.zero_()

    def __call__(self):
        return self.run()


def unpack_events(events: torch.Tensor, n_events: torch.Tensor, start: torch.Tensor,
                  max_events: int) -> torch.Tensor:
    """``packing.pack_event_batch``'s (S, E, 4) int32 events from a
    field-major layout on the device: ``events`` (4, S * E + 1) int32 whose
    last column is zero, ``n_events`` (S,) and ``start`` (S,), the column of
    each lane's first event. Row ``r`` of lane ``i`` is column ``start_i +
    r``, and a row at or past its lane's count reads the zero column. No
    host read, so it is captured with the step."""
    S = n_events.shape[0]
    rows = torch.arange(max_events, device=events.device)
    cols = torch.where(rows < n_events[:, None], start.long()[:, None] + rows,
                       events.shape[1] - 1)
    return (events.index_select(1, cols.view(-1)).view(len(FIELDS), S, max_events)
            .permute(1, 2, 0).contiguous())


def serving_step(fn, init_states, lanes: int, max_events: int, device, graph: bool = True,
                 weights=()) -> CapturedStep:
    """A serving step ``fn(states, packed, n_events, reset) -> (dets,
    new_states, p_tel)`` (a ``StreamingStep``, or an exported program's
    module) for ``lanes`` lanes of ``max_events`` events as a
    ``CapturedStep``, without grad: its static inputs are the events field
    by field (``events``: (4, lanes x max_events) and a zero column), the
    column of each lane's first event (``start``), the counts and the
    resets. ``Staging`` fills them compact, lanes back to back
    (``pack_event_fields``), and ``load_packed`` from (S, E, 4). The step
    unpacks the events into ``fn``'s (S, E, 4) first (``unpack_events``),
    and a call returns ``(dets, p_tel)``."""
    device = torch.device(device)
    inputs = {"events": torch.zeros((len(FIELDS), lanes * max_events + 1), dtype=torch.int32,
                                    device=device),
              "start": torch.zeros((lanes,), dtype=torch.int32, device=device),
              "n_events": torch.zeros((lanes,), dtype=torch.int32, device=device),
              "reset": torch.zeros((lanes,), dtype=torch.bool, device=device)}

    @torch.no_grad()
    def step(states, inputs):
        packed = unpack_events(inputs["events"], inputs["n_events"], inputs["start"],
                               max_events)
        dets, new_states, p_tel = fn(states, packed, inputs["n_events"], inputs["reset"])
        return new_states, (dets, p_tel)

    return CapturedStep(step, init_states, inputs, device, graph, weights)


def load_packed(step: CapturedStep, packed: torch.Tensor, n_events: torch.Tensor,
                reset: torch.Tensor) -> None:
    """Write a batch in ``pack_event_batch``'s (S, E, 4) layout into a
    serving step's static inputs: the events by one transposing copy, each
    lane's E rows in place (lane ``i`` starts at column ``i * E``), and the
    counts and resets, asynchronously where the sources allow it."""
    S, E, F = packed.shape
    step.inputs["events"][:, :-1].view(F, S, E).copy_(packed.permute(2, 0, 1),
                                                      non_blocking=True)
    step.inputs["start"].copy_(torch.arange(0, S * E, E, dtype=torch.int32,
                                            device=packed.device), non_blocking=True)
    step.inputs["n_events"].copy_(n_events, non_blocking=True)
    step.inputs["reset"].copy_(reset, non_blocking=True)


class Staging:
    """Host buffers of a detector's batches: the compact upload
    (``pack_event_fields``) and the slate's download, page-locked on a card
    so that both copies run asynchronously. A batch waits once, for the
    download of every replica's slate; each upload runs before it on the
    same stream, so the upload buffers are free to refill when ``batch``
    returns."""

    def __init__(self, lanes: int, max_events: int, pinned: bool):
        self.pinned = pinned
        self.events = torch.zeros((len(FIELDS), lanes * max_events), dtype=torch.int32,
                                  pin_memory=pinned)
        self.n = torch.zeros((lanes,), dtype=torch.int32, pin_memory=pinned)
        self.start = torch.zeros((lanes,), dtype=torch.int32, pin_memory=pinned)
        self.reset = torch.zeros((lanes,), dtype=torch.bool, pin_memory=pinned)
        self.down = None

    def batch(self, frames, reset, steps: Sequence[CapturedStep], run):
        """Pack ``frames`` and ``reset`` (None: no lane) into the upload
        buffers; copy each replica's share into its serving step's static
        inputs (``steps`` in lane order, each taking as many lanes): its
        lanes' events, one contiguous range of each field, the column of
        each of its lanes' first event in that range, and its counts and
        resets; then ``run()`` (each replica's ``(dets, p_tel)`` on its
        device), copy those down and wait once. Returns the download
        buffers, which the next batch rewrites.

        Spans (``utils/timers``): ``serve.pack``, ``serve.launch`` (the
        uploads, every replica's step and the downloads enqueued) and
        ``serve.wait``; counters ``serve.events`` (the events packed) and
        ``serve.upload_bytes`` (the bytes the uploads enqueued: 16 an
        event, and 9 a lane for the starts, counts and resets)."""
        n, per = self.n.numpy(), len(self.n) // len(steps)
        with timers.span("serve.pack"):
            total = pack_event_fields(frames, self.events.numpy(), n)
            self.reset.numpy()[:] = False if reset is None else np.asarray(reset, bool)
            for i in range(len(steps)):
                part = slice(i * per, (i + 1) * per)
                self.start.numpy()[part] = np.cumsum(n[part]) - n[part]
        with timers.span("serve.launch"):
            start, sent = 0, 0
            for i, step in enumerate(steps):
                part = slice(i * per, (i + 1) * per)
                m = int(n[part].sum())
                for row, host in zip(step.inputs["events"], self.events):
                    row[:m].copy_(host[start:start + m], non_blocking=True)
                for k, host in (("start", self.start), ("n_events", self.n),
                                ("reset", self.reset)):
                    step.inputs[k].copy_(host[part], non_blocking=True)
                    sent += host[part].nbytes
                sent += m * self.events.shape[0] * self.events.element_size()
                start += m
            with torch.no_grad():
                outs = run()
            if self.down is None:
                self.down = [pytree.tree_map(
                    lambda t: torch.empty(t.shape, dtype=t.dtype, pin_memory=self.pinned), o)
                    for o in outs]
            events = []
            for host, out in zip(self.down, outs):
                for h, d in zip(pytree.tree_leaves(host), pytree.tree_leaves(out)):
                    h.copy_(d, non_blocking=self.pinned)
                if self.pinned:
                    event = torch.cuda.Event()
                    event.record(torch.cuda.current_stream(pytree.tree_leaves(out)[0].device))
                    events.append(event)
        if timers.tracing():
            timers.count("serve.events", total)
            timers.count("serve.upload_bytes", sent)
        with timers.span("serve.wait"):
            for event in events:
                event.synchronize()
        return self.down


def _dtype_of(value) -> torch.dtype:
    """The torch dtype of a tensor or of a numpy array."""
    if torch.is_tensor(value):
        return value.dtype
    return torch.from_numpy(np.empty(0, dtype=np.asarray(value).dtype)).dtype


class BatchBuffers:
    """A step's batch as static buffers on ``device``: one tensor per key of
    ``like`` (a batch of numpy arrays or tensors), of its shape and dtype.

    ``load(batch)`` writes a batch of those shapes and dtypes into them and
    returns them: a host array through a page-locked staging buffer and a
    ``non_blocking`` copy (the staging is rewritten only once the previous
    batch's copies have run), a tensor on the card by a copy there, and
    nothing for a tensor that is the buffer itself (a producer gathered into
    it, ``data/device_cache.py``). The copies run on the current stream
    after the work queued before them, so a step still reading the previous
    batch finishes first. ``load`` is ``wait`` then ``fill``, which the
    captured train step calls one by one, each in a span of its own."""

    def __init__(self, like: Dict, device):
        self.device = torch.device(device)
        self.pinned = self.device.type == "cuda"
        self.tensors = {k: torch.empty(tuple(v.shape), dtype=_dtype_of(v), device=self.device)
                        for k, v in like.items()}
        self._staging: Dict[str, torch.Tensor] = {}
        self._copied: Optional[torch.cuda.Event] = None

    def matches(self, batch: Dict) -> bool:
        return set(batch) == set(self.tensors) and all(
            tuple(v.shape) == tuple(self.tensors[k].shape) and _dtype_of(v) == self.tensors[k].dtype
            for k, v in batch.items())

    def load(self, batch: Dict) -> Dict[str, torch.Tensor]:
        self.wait()
        self.fill(batch)
        return self.tensors

    def wait(self) -> None:
        """Block until the previous batch's copies from the staging ran."""
        if self._copied is not None:
            self._copied.synchronize()
            self._copied = None

    def fill(self, batch: Dict) -> None:
        """``load`` after ``wait``: each host array into its page-locked
        staging buffer and a copy from there enqueued (on the CPU, into the
        buffer itself), each tensor on the card into its buffer."""
        staged = False
        for k, value in batch.items():
            buf = self.tensors[k]
            if torch.is_tensor(value) and value.device == buf.device:
                if value.data_ptr() != buf.data_ptr() or value.stride() != buf.stride():
                    buf.copy_(value)
                continue
            if not self.pinned:
                buf.copy_(value if torch.is_tensor(value) else torch.from_numpy(np.asarray(value)))
                continue
            host = self._staging.get(k)
            if host is None:
                host = self._staging[k] = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
            if torch.is_tensor(value):
                host.copy_(value)
            else:
                host.numpy()[...] = value
            buf.copy_(host, non_blocking=True)
            staged = True
        if staged:
            self._copied = torch.cuda.Event()
            self._copied.record(torch.cuda.current_stream(self.device))
