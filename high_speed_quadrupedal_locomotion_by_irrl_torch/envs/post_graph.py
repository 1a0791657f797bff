"""The env step's post-physics work replayed as one CUDA graph.

:func:`.blackpanther.step_batch` calls a :class:`PostGraphs` in place of
``_post_substeps`` (observation, reward, reference update, termination, the
every-step ``reset`` of the branchless auto-reset and the per-env select):
about a thousand small PyTorch ops a control step that the host would
otherwise issue one by one while the card waits.

The graphs are kept by key: the config, the generator, the inputs' structure
and every input tensor's shape, strides and dtype. The first call with a key
runs the function eagerly (the warm-up, on the real inputs, which also fills
the constant caches the function reads); the second captures it on copies of
its inputs and replays it; every later call copies its inputs into the
graph's own (one ``torch._foreach_copy_`` a dtype and layout), replays, and
copies the outputs out, since callers keep a step's outputs past the next
replay. An
output that is one of the inputs (the robot parameters and the terrain pass
through the step) is handed back as the caller's own tensor, as the eager
call hands it back.

Random draws come from the step's generator, registered with each graph
(``CUDAGraph.register_generator_state``; a rank block's underlying
generator): a replay draws the numbers the eager call would have drawn, in
the same order, and advances the generator as far.

The graph engages on CUDA tensors none of which requires grad; on the CPU
and under autograd the function runs as it is. At most ``SIZE`` keys are
kept, the least recently used dropped first with its graph: a fleet that
makes a fresh generator each rollout captures once a rollout.
Counters ``post_graph_captures`` and ``post_graph_replays``
(:mod:`..utils.profiling`) count the captures and the replays of later calls.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable, NamedTuple

import torch

from high_speed_quadrupedal_locomotion_by_irrl_torch import device as dev_mod
from high_speed_quadrupedal_locomotion_by_irrl_torch.utils import profiling


class _Node(NamedTuple):
    """A container in an argument tree: its type, its keys and its children's specs."""
    kind: str          # "dataclass", "namedtuple", "tuple" or "dict"
    type: type
    keys: tuple
    children: tuple


# a tensor's spec; any other value that is no container is its own spec
_TENSOR = _Node("tensor", torch.Tensor, (), ())
_FIELDS: dict = {}     # dataclass type -> its field names


def _flatten(x, leaves: list):
    """Appends ``x``'s tensors to ``leaves`` in order; returns what rebuilds ``x``."""
    if isinstance(x, torch.Tensor):
        leaves.append(x)
        return _TENSOR
    if isinstance(x, tuple):
        kind = "namedtuple" if hasattr(x, "_fields") else "tuple"
        return _Node(kind, type(x), (), tuple(_flatten(v, leaves) for v in x))
    if isinstance(x, dict):
        return _Node("dict", dict, tuple(x), tuple(_flatten(v, leaves) for v in x.values()))
    if dataclasses.is_dataclass(x):
        names = _FIELDS.get(type(x))
        if names is None:
            names = _FIELDS[type(x)] = tuple(f.name for f in dataclasses.fields(x))
        return _Node("dataclass", type(x), names,
                     tuple(_flatten(getattr(x, n), leaves) for n in names))
    return x


def _build(spec, leaves):
    """The tree of ``spec`` around the tensors of the iterator ``leaves``."""
    if spec is _TENSOR:
        return next(leaves)
    if not isinstance(spec, _Node):
        return spec
    children = [_build(c, leaves) for c in spec.children]
    if spec.kind == "tuple":
        return tuple(children)
    if spec.kind == "namedtuple":
        return spec.type(*children)
    if spec.kind == "dict":
        return dict(zip(spec.keys, children))
    return spec.type(**dict(zip(spec.keys, children)))


def _groups(dst: list, src: list) -> list[list[int]]:
    """The positions of the pairs ``dst[i] <- src[i]``, one list a dtype and
    whether the pair's strides agree: ``torch._foreach_copy_`` copies a list
    of one dtype and agreeing strides in a few launches, any other one tensor
    by tensor."""
    groups: dict = {}
    for i, (d, s) in enumerate(zip(dst, src)):
        groups.setdefault((d.dtype, d.stride() == s.stride()), []).append(i)
    return list(groups.values())


class _Graph(NamedTuple):
    graph: torch.cuda.CUDAGraph
    in_groups: list    # (the graph's inputs of a group, their positions among the leaves)
    out_spec: object
    out_from: list     # each output leaf: k >= 0 the graph's own output k, else input -1 - k
    owned: list        # the graph's own output tensors
    out_groups: list   # positions among ``owned``, one list a dtype


class PostGraphs:
    """``fn(cfg, state, gen, *tensors and trees of tensors)`` on the card as
    CUDA-graph replays, one graph a key (module notes)."""

    SIZE = 2

    def __init__(self, fn: Callable):
        self.fn = fn
        self._graphs: collections.OrderedDict = collections.OrderedDict()  # key -> _Graph | None

    def __call__(self, cfg, state, gen, *args):
        leaves: list = []
        spec = _flatten((state,) + args, leaves)
        if not all(t.is_cuda and not t.requires_grad for t in leaves):
            return self.fn(cfg, state, gen, *args)
        key = (cfg, gen, spec, tuple((t.shape, t.stride(), t.dtype) for t in leaves))
        if key not in self._graphs:
            self._graphs[key] = None
            while len(self._graphs) > self.SIZE:
                self._graphs.popitem(last=False)
            return self.fn(cfg, state, gen, *args)        # the warm-up
        self._graphs.move_to_end(key)
        g = self._graphs[key]
        if g is None:
            g = self._graphs[key] = self._capture(cfg, gen, spec, leaves)
            profiling.count("post_graph_captures")
            g.graph.replay()
            return self._outputs(g, leaves)
        with profiling.span("env.post"):
            for dst, pos in g.in_groups:
                torch._foreach_copy_(dst, [leaves[i] for i in pos])
            g.graph.replay()
            profiling.count("post_graph_replays")
            return self._outputs(g, leaves)

    def _capture(self, cfg, gen, spec, leaves: list) -> _Graph:
        """The graph of ``fn`` on copies of ``leaves``, captured on a side stream."""
        inputs = [t.clone() for t in leaves]
        stream = torch.cuda.current_stream(leaves[0].device)
        side = torch.cuda.Stream(device=leaves[0].device)
        side.wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(gen.gen if isinstance(gen, dev_mod.RankBlock) else gen)
        state, *args = _build(spec, iter(inputs))
        with torch.cuda.stream(side):
            graph.capture_begin()
            try:
                out = self.fn(cfg, state, gen, *args)
                out_leaves: list = []
                out_spec = _flatten(out, out_leaves)
                where = {id(t): i for i, t in enumerate(inputs)}
                out_from, owned, seen = [], [], {}
                for t in out_leaves:
                    if id(t) in where:
                        out_from.append(-1 - where[id(t)])
                        continue
                    if id(t) not in seen:
                        seen[id(t)] = len(owned)
                        # an output laid out as no fresh tensor is (a view) gets a copy of its own
                        owned.append(t if torch.empty_like(t).stride() == t.stride()
                                     else t.clone(memory_format=torch.contiguous_format))
                    out_from.append(seen[id(t)])
            finally:
                graph.capture_end()
        stream.wait_stream(side)
        in_groups = [([inputs[i] for i in pos], pos) for pos in _groups(inputs, leaves)]
        return _Graph(graph, in_groups, out_spec, out_from, owned, _groups(owned, owned))

    @staticmethod
    def _outputs(g: _Graph, leaves: list):
        """Copies of the graph's outputs (the callers' own tensors where they pass through)."""
        fresh = [torch.empty_like(t) for t in g.owned]
        for pos in g.out_groups:
            torch._foreach_copy_([fresh[i] for i in pos], [g.owned[i] for i in pos])
        return _build(g.out_spec, iter([fresh[k] if k >= 0 else leaves[-1 - k]
                                        for k in g.out_from]))
