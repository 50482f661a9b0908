"""Deployment artifacts of the streaming detector (``torch.export``): port of
sast_tpu/export.py.

The deployable unit is the serving step (``serving.StreamingStep``:
tensorize, recurrent backbone, head, NMS) traced by ``torch.export`` into
one ``ExportedProgram`` and saved with ``torch.export.save``:

- the **weights are baked** into the artifact (they are the program's
  parameters and buffers, saved beside its graph), and the graph and the
  branches of its cond nodes hold no cast of a parameter, as JAX bakes its
  weights in as constants of the compute dtype (sast_tpu/export.py:72-76):
  a parameter that the step only ever reads cast to one dtype (conv and
  dense kernels, most biases) is stored cast; one read both at its own
  dtype (norm scales, the block kernels' fp32 vectors, BatchNorm
  statistics) and cast (the masked branch's biases beside the kernel's)
  gets a second parameter of the cast values (``bake_compute_weights``);
- the carried LSTM state, the packed events, the valid counts and the reset
  mask stay **runtime inputs**;
- the hand-written kernels stand in the graph as the operators
  ``torch.ops.sast_tpu_torch.*`` (``ops/stem_conv.py``, ``ops/density.py``,
  ``ops/nms_keep.py``, ``ops/sparse_block.py``, ``ops/fused_block.py``): a loaded program launches
  them on CUDA tensors and runs their plain versions on CPU tensors;
- the artifact is **self-describing**: its input signature gives the zero
  state, the lane count and the event budget, so loading it needs no model
  config and no model code, only torch, this module and the operators.

Portability: an artifact runs on the device it was exported on (the
device of the detector's first replica; its kernels where that is a card),
and on the torch version that wrote it, since ``torch.export``'s format
has no promise across versions. The JAX export's ``platforms`` and
``allow_tpu_kernels`` have no counterpart here.
"""

from __future__ import annotations

import io
import os
from typing import Dict, Union

import numpy as np
import torch
import torch.utils._pytree as pytree

# Deliberately no model imports at module level: a serving host loads an
# artifact with torch, numpy, the event packing and the operator
# registrations alone (the model stack is imported lazily by the export
# function).
import sast_tpu_torch.ops.density  # noqa: F401  (registers sast_tpu_torch::density_ratio)
import sast_tpu_torch.ops.fused_block  # noqa: F401  (fused_block_fwd)
import sast_tpu_torch.ops.nms_keep  # noqa: F401  (sast_tpu_torch::greedy_keep)
import sast_tpu_torch.ops.sparse_block  # noqa: F401  (sparse_block_fwd, sparse_block_looped)
import sast_tpu_torch.ops.stem_conv  # noqa: F401  (stem_conv7x4, stem_conv_density7x4)
from sast_tpu_torch import graphs
from sast_tpu_torch.graphs import Staging, load_packed, serving_step
from sast_tpu_torch.utils import timers

ARTIFACT_NAME = "streaming_step.pt2"


def export_streaming_detector(det, path=None) -> bytes:
    """Trace ``det``'s serving step (a ``serving.StreamingDetector``) into an
    artifact and return its bytes; when ``path`` is given also write them to
    ``<path>/streaming_step.pt2`` (creating the directory).

    The program takes ``(states, packed, n_events, reset)`` for all
    ``det.num_streams`` lanes on the device of ``det``'s first replica and
    returns ``(dets, new_states, selected_tokens)``. The attention layers'
    data-dependent choices (the gather path's ``n_win <= K`` below a budget
    of 1, the sparse kernel's density test below a threshold of 1) stand in
    the graph as ``torch.cond`` nodes, which the program decides on its
    device, as JAX's ``lax.cond``. Tracing leaves ``det`` as it was: its
    caches fill only outside a trace."""
    from sast_tpu_torch.models.backbone import zero_states

    step, device = det.replicas[0], det.devices[0]
    S = det.num_streams
    args = (
        zero_states(det.cfg.model.backbone, S, det.dtype, device),
        torch.zeros((S, det.max_events, 4), dtype=torch.int32, device=device),
        torch.zeros((S,), dtype=torch.int32, device=device),
        torch.zeros((S,), dtype=torch.bool, device=device),
    )
    with torch.no_grad():
        program = torch.export.export(step, args, strict=False)
    program.example_inputs = None  # zeros of the signature's shapes; not saved
    # The trace checks the input of every dtype cast (about 470 a step, the
    # weights' casts among them) with an assertion node of its own: a host
    # dispatch each time the program runs, on shapes and dtypes that are
    # static. The program runs without them, in the graph and in the
    # branches of its ``torch.cond`` nodes.
    for gm in program.graph_module.modules():
        if isinstance(gm, torch.fx.GraphModule):
            for node in list(gm.graph.nodes):
                if node.target is torch.ops.aten._assert_tensor_metadata.default:
                    gm.graph.erase_node(node)
            gm.recompile()
    bake_compute_weights(program)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    blob = buf.getvalue()
    if path is not None:
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, ARTIFACT_NAME), "wb") as f:
            f.write(blob)
    return blob


def _is_cast(node: torch.fx.Node) -> bool:
    return node.target is torch.ops.aten.to.dtype and len(node.args) == 2 and not node.kwargs


def _reach(gm: torch.fx.GraphModule, node: torch.fx.Node, via=None) -> list:
    """``(graph module, node, via)`` for ``node`` in ``gm`` and for each
    placeholder that stands for it in the branches of the cond nodes that
    take it as an operand, recursively; ``via`` is the ``(graph module,
    cond node)`` through which a branch receives it (None in ``gm``)."""
    out = [(gm, node, via)]
    for user in node.users:
        if user.target is not torch.ops.higher_order.cond:
            continue
        for i, operand in enumerate(user.args[3]):
            if operand is not node:
                continue
            for branch in user.args[1:3]:
                sub = getattr(gm, branch.target)
                holder = [n for n in sub.graph.nodes if n.op == "placeholder"][i]
                out += _reach(sub, holder, (gm, user))
    return out


def _uses(reach) -> list:
    """The ``(graph module, node)`` of every use of what ``reach`` lists,
    other than the cond nodes that pass it into their branches."""
    return [(gm, u) for gm, node, _ in reach for u in node.users
            if u.target is not torch.ops.higher_order.cond or node not in u.args[3]]


def _add_parameter(program, after: torch.fx.Node, fqn: str, value: torch.Tensor,
                   val) -> torch.fx.Node:
    """A new parameter ``fqn`` holding ``value`` (``val``: its fake tensor):
    its placeholder after the parameter placeholder ``after`` and its input
    spec after ``after``'s."""
    from torch.export.graph_signature import InputKind, InputSpec, TensorArgument

    with program.graph.inserting_after(after):
        node = program.graph.placeholder(fqn.replace(".", "_"))
    node.meta["val"] = val
    specs = program.graph_signature.input_specs
    at = next(i for i, spec in enumerate(specs) if spec.arg.name == after.name)
    specs.insert(at + 1, InputSpec(kind=InputKind.PARAMETER, arg=TensorArgument(name=node.name),
                                   target=fqn, persistent=None))
    program.state_dict[fqn] = torch.nn.Parameter(value, requires_grad=False)
    return node


def bake_compute_weights(program) -> int:
    """Bake the parameters of ``program`` into the dtypes its graph and the
    branches of its cond nodes read them in, and drop every cast of a
    parameter there (in place):

    - a cast to the parameter's own dtype, which returns its input, goes;
    - a parameter whose every other use is a cast to one dtype is stored in
      that dtype;
    - a parameter also read at its own dtype keeps it, and each dtype it is
      cast to gets a parameter of its own, ``<name>_<dtype>``, which enters
      the branches that read it as a new operand of their cond nodes.

    Returns how many parameters were baked (stored cast or given a cast
    twin). The values are those the casts computed, so the program's
    results keep their bits."""
    names = dict(program.graph_signature.inputs_to_parameters)
    params = [n for n in program.graph.nodes if n.op == "placeholder" and n.name in names]
    modules = [m for m in program.graph_module.modules() if isinstance(m, torch.fx.GraphModule)]
    baked, made = 0, {}
    for node in list(params):
        fqn = names[node.name]
        held = program.state_dict[fqn]
        reach = _reach(program.graph_module, node)
        for gm, use in _uses(reach):
            if _is_cast(use) and use.args[1] == held.dtype:
                use.replace_all_uses_with(use.args[0])
                gm.graph.erase_node(use)
        uses = _uses(reach)
        casts = {}
        for gm, use in uses:
            if _is_cast(use):
                casts.setdefault(use.args[1], []).append((gm, use))
        if not casts:
            continue
        baked += 1
        if len(casts) == 1 and sum(map(len, casts.values())) == len(uses):
            ((dtype, _),) = casts.items()
            program.state_dict[fqn] = torch.nn.Parameter(held.detach().to(dtype),
                                                         requires_grad=False)
            for _, holder, _ in reach:
                holder.meta["val"] = holder.meta["val"].to(dtype)
            for gm, use in casts[dtype]:
                use.replace_all_uses_with(use.args[0])
                gm.graph.erase_node(use)
            continue
        via = {gm: v for gm, _, v in reach}
        for dtype, cast_uses in casts.items():
            twin = _add_parameter(program, params[-1], f"{fqn}_{str(dtype).split('.')[-1]}",
                                  held.detach().to(dtype), node.meta["val"].to(dtype))
            params.append(twin)
            for gm, use in cast_uses:
                value = twin if via[gm] is None else _operand_in(program, twin, gm, via[gm], made)
                use.replace_all_uses_with(value)
                gm.graph.erase_node(use)
    for gm in modules:
        gm.recompile()
    return baked


def _operand_in(program, value: torch.fx.Node, sub: torch.fx.GraphModule, via,
                made: dict) -> torch.fx.Node:
    """``value``, a placeholder of the top graph, inside the branch graph
    ``sub`` of the cond node that ``via`` (``_reach``'s) names: a new last
    operand of that cond node and a new last placeholder of both its
    branches, made once (``made``). Cond nodes of the top graph only."""
    gm, cond = via
    if gm is not program.graph_module:
        raise NotImplementedError("a parameter cast inside a cond node nested in a branch")
    key = (cond, value)
    if key not in made:
        cond.args = (*cond.args[:3], type(cond.args[3])([*cond.args[3], value]))
        made[key] = {}
        for branch in cond.args[1:3]:
            graph = getattr(gm, branch.target).graph
            last = [n for n in graph.nodes if n.op == "placeholder"][-1]
            with graph.inserting_after(last):
                holder = graph.placeholder(value.name)
            holder.meta["val"] = value.meta["val"]
            made[key][branch.target] = holder
    return made[key][next(b.target for b in cond.args[1:3] if getattr(gm, b.target) is sub)]


def parameter_casts(program) -> int:
    """How many nodes of ``program``'s graph, and of the branches of its cond
    nodes, cast a parameter directly."""
    names = program.graph_signature.inputs_to_parameters
    return sum(1 for node in program.graph.nodes
               if node.op == "placeholder" and node.name in names
               for _, use in _uses(_reach(program.graph_module, node)) if _is_cast(use))


class _CondInterpreter(torch.fx.Interpreter):
    """Runs a loaded program's graph node by node, each cond node through
    ``graphs.choose``: eagerly one host read of its predicate, and in a
    captured step a conditional node over its two branches captured as
    graphs, which takes the branch on the card."""

    def call_function(self, target, args, kwargs):
        if target is torch.ops.higher_order.cond:
            pred, true_fn, false_fn, operands = args
            return graphs.choose(pred, true_fn, false_fn, tuple(operands))
        return super().call_function(target, args, kwargs)


class ExportedStreamingDetector:
    """Run an exported streaming-detector artifact.

    The API of ``StreamingDetector`` (``reset``, ``process_batch``,
    ``process_events``, ``step``, ``states``) without the model code or
    config: the zero state, ``num_streams`` and ``max_events`` come from the
    program's own input signature, and it runs on the device it was
    exported on. There, on a card and with ``graph`` on (the default), the
    program's step is captured as CUDA graphs at the first batch and
    replayed from then on, the carried state in place
    (``graphs.CapturedStep``; JAX jits the loaded artifact's call,
    sast_tpu/export.py:125). A program whose layers choose their branch on
    the card runs through an interpreter that hands each cond node to
    ``graphs.choose``, captured as one graph with conditional nodes as the
    live detector is.
    ``graph=False`` runs the program eagerly."""

    def __init__(self, blob_or_path: Union[bytes, str], graph: bool = True):
        if isinstance(blob_or_path, (bytes, bytearray)):
            source = io.BytesIO(bytes(blob_or_path))
        else:
            source = blob_or_path
            if os.path.isdir(source):
                source = os.path.join(source, ARTIFACT_NAME)
        self.program = torch.export.load(source)
        self._fn = self.program.module()
        # The user inputs' placeholders, in the order of the flattened
        # ((states, packed, n_events, reset), {}) tree.
        names = set(self.program.graph_signature.user_inputs)
        specs = [n.meta["val"] for n in self.program.graph.nodes
                 if n.op == "placeholder" and n.name in names]
        self.device = specs[0].device
        leaves = [torch.zeros(v.shape, dtype=v.dtype, device=self.device) for v in specs]
        (states, packed, _, _), _ = pytree.tree_unflatten(leaves, self.program.call_spec.in_spec)
        self.num_streams, self.max_events = int(packed.shape[0]), int(packed.shape[1])
        self.cond_nodes = [n.name for n in self._fn.graph.nodes
                           if n.target is torch.ops.higher_order.cond]
        fn = gm = self._fn
        if self.cond_nodes:
            def fn(*args):
                out = _CondInterpreter(gm).run(*pytree.arg_tree_leaves(*args))
                return pytree.tree_unflatten(pytree.tree_leaves(out), gm._out_spec)
        self._step = serving_step(fn, states, self.num_streams, self.max_events, self.device,
                                  graph, weights=(self._fn,))
        self._staging = Staging(self.num_streams, self.max_events,
                                 pinned=self.device.type == "cuda")

    @property
    def states(self):
        """The carried state of every lane: the step's own buffers,
        rewritten in place by every step."""
        return self._step.states

    def reset(self) -> None:
        """Zero the carried recurrent state of every lane, in place
        (per-lane resets go through ``process_batch``'s ``reset`` mask)."""
        self._step.zero_states()

    @torch.no_grad()
    def step(self, packed: torch.Tensor, n_events: torch.Tensor, reset: torch.Tensor):
        """``StreamingDetector.step`` through the program: (S, E, 4) int32
        events, (S,) counts and (S,) resets on the artifact's device ->
        (detections, selected-token telemetry), tensors of their own;
        carries the state."""
        load_packed(self._step, packed, n_events, reset)
        dets, p_tel = self._step()
        return {k: v.clone() for k, v in dets.items()}, p_tel.clone()

    def process_batch(self, frames, reset: "np.ndarray | None" = None) -> Dict[str, np.ndarray]:
        """One frame window per lane -> batched detections (the contract of
        ``StreamingDetector.process_batch``; both pack with
        ``packing.pack_event_fields`` and move the batch through page-locked
        buffers on a card; the same spans and counters)."""
        with timers.span("serve.batch"):
            ((dets, p_tel),) = self._staging.batch(frames, reset, [self._step],
                                                   lambda: [self._step()])
            return {k: v.numpy().copy() for k, v in dets.items()} | {
                "selected_tokens": p_tel.numpy().copy()}

    def process_events(self, x: np.ndarray, y: np.ndarray, p: np.ndarray,
                       t: np.ndarray) -> Dict[str, np.ndarray]:
        """One frame window of raw (time-sorted) events -> detections."""
        if self.num_streams != 1:
            raise ValueError("use process_batch with num_streams > 1")
        out = self.process_batch([dict(x=x, y=y, p=p, t=t)])
        tel = out.pop("selected_tokens")
        return {k: v[0] for k, v in out.items()} | {"selected_tokens": tel}
