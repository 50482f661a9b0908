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
- ``Schedule``: the graphs of one capture, sharing one memory pool, replayed
  in the order they were captured. A body without a data-dependent choice
  is one graph. At each choice (``choose``) the running graph ends, each
  branch is captured as a graph of its own writing into one output, and the
  next graph begins; a replay reads that choice's 0-d predicate on the host
  once and replays the branch it names: the eager step's host reads, one
  per choosing layer, with no dispatch between them. (CUDA's conditional
  graph nodes would take the branch on the card; the torch of this port
  has no API for them.)
- ``choose``: JAX's ``lax.cond`` for eager code: one host read of the
  predicate, both branches during a warm-up, the schedule's branch graphs
  during a capture.
- ``run_together``: the replicas of a mesh, called together; their replays
  are interleaved so that every card's graphs up to a choice are enqueued
  before any card's predicate is read.
- ``CapturedStep``: a step on its static inputs and carried state through
  ``Captured``: the serving step (``serving_step``; the live detector,
  ``serving.py``, and the loaded artifact, ``export.py``) and the train and
  eval steps (``training/steps.py``). ``Staging``: the page-locked host
  buffers of a serving batch's upload and of its slate's download.
- ``BatchBuffers``: a training or evaluation batch's static buffers on the
  card, filled from page-locked staging (host arrays) or by a copy on the
  card, unless a producer wrote straight into them
  (``data/device_cache.py``); the captured train and eval steps of
  ``training/steps.py`` read them.
- Launch counts: the kernels' wrappers count what they enqueue, and a
  replay runs no Python. Each graph keeps the counts recorded while it was
  captured; ``Captured.recorded`` sums them over its captures and
  ``Captured.replayed`` over the graphs it replayed, so the launches a card
  ran are the wrappers' counts less ``recorded`` plus ``replayed``.

Captured graphs read the tensors they were captured with: the weights in
place (``models/layers.cached_copy`` rewrites the compute-dtype copies in
place), and every tensor that crosses from one graph to the next is held by
the schedule for as long as its graphs live. ``Captured`` watches the
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
import gc
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.utils._pytree as pytree

from sast_tpu_torch.packing import pack_event_batch

_active = threading.local()


def launch_counts() -> Dict[str, int]:
    """The launch counter of every kernel wrapper, by wrapper name."""
    from sast_tpu_torch.ops import density, fused_block, nms_keep, sparse_block, stem_conv

    wrappers = (stem_conv.stem_conv7x4, density.density_ratio, nms_keep.greedy_keep,
                fused_block.fused_window_block, sparse_block.sparse_window_block,
                sparse_block.sparse_window_block_looped, sparse_block.sparse_block_mlp_bwd,
                sparse_block.sparse_block_attn_bwd)
    return {w.__name__: w.launches for w in wrappers}


def _since(before: Dict[str, int]) -> collections.Counter:
    now = launch_counts()
    return collections.Counter({k: now[k] - before[k] for k in now if now[k] != before[k]})


def choose(pred: torch.Tensor, true_fn: Callable, false_fn: Callable, operands: Tuple):
    """``lax.cond(pred, true_fn, false_fn, *operands)`` outside a trace:
    eagerly one host read of the 0-d ``pred``; inside a ``Captured``
    warm-up both branches (the chosen result returned); inside its capture
    a choice of the schedule. Each branch returns new tensors of one
    structure, shapes and dtypes, and writes none of its operands."""
    schedule = getattr(_active, "schedule", None)
    if schedule is None:
        return true_fn(*operands) if bool(pred) else false_fn(*operands)
    return schedule.choose(pred, true_fn, false_fn, operands)


class Schedule:
    """The graphs of one capture, replayed in capture order on the current
    stream; the launches recorded at capture and run by replays are added to
    the counters ``recorded`` and ``replayed``."""

    def __init__(self, recorded: collections.Counter, replayed: collections.Counter):
        self.pool = torch.cuda.graph_pool_handle()
        self.items: List[tuple] = []  # ("run", graph, counts) or ("choose", pred, true, false)
        self.held: List[torch.Tensor] = []  # tensors that cross from one graph to the next
        self.recorded, self.replayed = recorded, replayed
        self._graph = None
        self._counts = None
        self.warming = False

    def _begin(self) -> None:
        self._graph = torch.cuda.CUDAGraph()
        self._counts = launch_counts()
        self._graph.capture_begin(pool=self.pool)

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
        stream) and return its outputs: tensors of the pool that every
        replay rewrites."""
        self._begin()
        try:
            out = body()
            self.items.append(("run", *self._end()))
        except BaseException:
            self._abort()
            raise
        return out

    def choose(self, pred, true_fn, false_fn, operands):
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
        self.items.append(("choose", pred, first, second))
        self.held.extend([pred, *ins, *pytree.tree_leaves(out)])
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

    def replay(self):
        """Replay every graph in order; at each choice, the branch its
        predicate names. A generator: it yields before each predicate read,
        so that a caller can enqueue other cards' graphs before this host
        read waits for this card (``run_together``)."""
        for item in self.items:
            if item[0] == "run":
                graph, counts = item[1], item[2]
            else:
                _, pred, first, second = item
                yield
                graph, counts = first if bool(pred) else second
            graph.replay()
            self.replayed.update(counts)

    @contextlib.contextmanager
    def active(self, warming: bool):
        """Make this schedule the one ``choose`` consults."""
        if getattr(_active, "schedule", None) is not None:
            raise RuntimeError("a capture is already running on this thread")
        _active.schedule, self.warming = self, warming
        try:
            yield
        finally:
            _active.schedule, self.warming = None, False


class Captured:
    """``body()`` on static buffers of ``device``, replayed as captured CUDA
    graphs (module docstring).

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
        self.replayed: collections.Counter = collections.Counter()
        self.replays = 0
        self._watched: List[torch.Tensor] = []
        self._stamps: list = []
        self._state_ptrs: list = []
        self._switches: tuple = ()

    def __call__(self):
        (out,) = run_together([self])
        return out

    def _steps(self):
        """One call as a generator that yields before each of a replay's
        predicate reads, and returns the call's outputs."""
        if not self.graph:
            return self.body()
        if self.schedule is not None and (self._switches != _kernel_switches(self.weights)
                                          or not self._weights_current()):
            self.schedule = self.outputs = None
        if self.schedule is None:
            return self._warm_up_and_capture()
        yield from self.schedule.replay()
        self.replays += 1
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
        if any("_compute_copies" in m.__dict__
                               for w in self.weights for m in w.modules()):
            from sast_tpu_torch.models.layers import refresh_compute_copies

            for module in self.weights:
                refresh_compute_copies(module)
        self._stamps = stamps
        return True

    def _warm_up_and_capture(self):
        self._switches = _kernel_switches(self.weights)
        schedule = Schedule(self.recorded, self.replayed)
        caller = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        with torch.cuda.device(self.device):
            side.wait_stream(caller)
            with torch.cuda.stream(side):
                with schedule.active(warming=True):
                    out = self.body()
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
    """Call every ``Captured`` of ``runs`` (the replicas of a mesh) and
    return their outputs in order. The replays are interleaved: each run's
    graphs are enqueued up to its next choice before any run reads a
    predicate, so that the cards' work overlaps also where the step chooses
    on the host. A warm-up, a capture or an eager call runs whole, in turn."""
    steps = [run._steps() for run in runs]
    outs: list = [None] * len(runs)
    live = list(range(len(runs)))
    while live:
        for i in list(live):
            device = runs[i].device
            with torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext():
                try:
                    next(steps[i])
                except StopIteration as done:
                    outs[i] = done.value
                    live.remove(i)
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


SERVING_INPUTS = ("packed", "n_events", "reset")


def serving_step(fn, init_states, lanes: int, max_events: int, device, graph: bool = True,
                 weights=()) -> CapturedStep:
    """A serving step ``fn(states, packed, n_events, reset) -> (dets,
    new_states, p_tel)`` (a ``StreamingStep``, or an exported program's
    module) for ``lanes`` lanes of ``max_events`` events as a
    ``CapturedStep``, without grad: its static inputs are the packed
    events, counts and resets (``SERVING_INPUTS``), and a call returns
    ``(dets, p_tel)``."""
    device = torch.device(device)
    inputs = {"packed": torch.zeros((lanes, max_events, 4), dtype=torch.int32, device=device),
              "n_events": torch.zeros((lanes,), dtype=torch.int32, device=device),
              "reset": torch.zeros((lanes,), dtype=torch.bool, device=device)}

    @torch.no_grad()
    def step(states, inputs):
        dets, new_states, p_tel = fn(states, *(inputs[k] for k in SERVING_INPUTS))
        return new_states, (dets, p_tel)

    return CapturedStep(step, init_states, inputs, device, graph, weights)


class Staging:
    """Host buffers of a detector's batches: the packed upload and the
    slate's download, page-locked on a card so that both copies run
    asynchronously. A batch waits once, for the download of every replica's
    slate; each upload runs before it on the same stream, so the upload
    buffers are free to refill when ``batch`` returns."""

    def __init__(self, lanes: int, max_events: int, pinned: bool):
        self.pinned = pinned
        self.packed = torch.zeros((lanes, max_events, 4), dtype=torch.int32, pin_memory=pinned)
        self.n = torch.zeros((lanes,), dtype=torch.int32, pin_memory=pinned)
        self.reset = torch.zeros((lanes,), dtype=torch.bool, pin_memory=pinned)
        self.down = None

    def batch(self, frames, reset, launch):
        """Pack ``frames`` and ``reset`` (None: no lane) into the upload
        buffers, ``launch(packed, n_events, reset)`` (each replica's
        ``(dets, p_tel)`` on its device), copy those down and wait once.
        Returns the download buffers, which the next batch rewrites."""
        lanes, max_events = self.packed.shape[:2]
        pack_event_batch(frames, lanes, max_events, out=(self.packed.numpy(), self.n.numpy()))
        self.reset.numpy()[:] = False if reset is None else np.asarray(reset, bool)
        with torch.no_grad():
            outs = launch(self.packed, self.n, self.reset)
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
    batch finishes first."""

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
        if self._copied is not None:
            self._copied.synchronize()
            self._copied = None
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
        return self.tensors
