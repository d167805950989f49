"""CUDA graphs of the training steps and of the forwards.

The JAX trainer runs a default step — forward, backward, the Adam update
and the metric sums — in one dispatch (`fused_step`, a whole epoch in one
`lax.scan`), and the predictor one `jax.jit` of `model.apply`; the
multi-device programs (the halo forward and step, the dp / gp / dcn step)
are one `jax.jit` of a `shard_map` each.  Their counterpart on the card is
a CUDA graph: the step's kernels, about 1,600 of them on one patch, are
captured once and replayed with one launch, so the host's Python and the
launches leave the step's time.

`Graph` captures a function of tensors once, for one padded shape, and
replays it: the inputs are copied into static buffers (the graph reads
those addresses) and the outputs are static tensors that each replay
overwrites.  What a capture needs before it starts runs in the caller's
first, eager call of the same function (the warm-up): the kernels'
builds and their shared-memory opt-ins, the optimizer's state.  Nothing
inside may wait for the device; a capture that meets such a call raises,
and nothing falls back to the eager path.  `Program` keeps one graph per
signature of a function's inputs, warms each up and captures it on its
first call, and lets its graphs share one memory pool.

A multi-device program is one graph where all of its tensors live on one
card (`one_card`: the parts or grid entries name one CUDA device, one
process).  Parts on several cards, and dcn over several processes, run
eagerly: one graph per card joined by cross-device events, and NCCL's
all-reduce inside a capture, are not written.

The kernel wrappers count their launches in `banded_cuda.LAUNCHES` as they
run, into a capture too.  A replay calls no wrapper and counts nothing
there: `Graph.launches` is what its capture recorded and `Graph.replays`
how often it ran; what a replay launched on the device is read from a
profile of it (`profile_train_step.aggregate_launches`).

`EAGER` is the one switch to the eager path on the card, for comparisons
(`testing.eager_steps()`); the CPU always runs eagerly.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc

import torch
import torch.distributed as dist

from geobignn_tpu_torch.ops.banded_cuda import LAUNCHES

EAGER = False  # testing.eager_steps() sets it; nothing else does


def tensors(tree) -> list:
    """The tensors of a tree of dataclasses, tuples, lists, dicts (in key
    order) and tensors, in order (static ints, floats and None left out)."""
    if torch.is_tensor(tree):
        return [tree]
    if dataclasses.is_dataclass(tree):
        return [t for f in dataclasses.fields(tree) for t in tensors(getattr(tree, f.name))]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in tensors(v)]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tensors(tree[k])]
    return []


def signature(tree) -> tuple:
    """What a graph is keyed on: the tree's structure (a dict's keys), static
    values and every tensor's shape, dtype and device."""
    if torch.is_tensor(tree):
        return ("tensor", tuple(tree.shape), tree.dtype, tree.device)
    if dataclasses.is_dataclass(tree):
        return (type(tree).__name__,) + tuple(
            signature(getattr(tree, f.name)) for f in dataclasses.fields(tree))
    if isinstance(tree, (tuple, list)):
        return tuple(signature(v) for v in tree)
    if isinstance(tree, dict):
        return ("dict",) + tuple((k, signature(tree[k])) for k in sorted(tree))
    return ("static", tree)


def map_tensors(fn, tree):
    """The tree with fn applied to every tensor (other leaves kept)."""
    if torch.is_tensor(tree):
        return fn(tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: map_tensors(fn, getattr(tree, f.name)) for f in dataclasses.fields(tree)})
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_tensors(fn, v) for v in tree)
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v) for k, v in tree.items()}
    return tree


def one_card(devices) -> bool:
    """Whether a program over `devices` (a halo sample's parts, a grid's
    entries) runs as one CUDA graph: every entry names the same CUDA device,
    the process is alone (no process group of several), and
    testing.eager_steps() is not open.  Otherwise it runs eagerly."""
    devices = {torch.device(d) for d in devices}
    if EAGER or len(devices) != 1 or next(iter(devices)).type != "cuda":
        return False
    return not (dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1)


def capturable(optimizer) -> bool:
    """Whether an optimizer's step may be captured: Adam made `capturable`
    (train/optim.make_optimizer on the card); SGD and RMSprop are not."""
    return all(g.get("capturable", False) for g in optimizer.param_groups)


def static_copy(tree):
    """A copy of the tree with every tensor cloned (the static buffers)."""
    return map_tensors(torch.clone, tree)


@contextlib.contextmanager
def side_stream():
    """A context running on a fresh stream that starts after, and is waited
    for by, the current one: where a warm-up before a capture runs."""
    prev = torch.cuda.current_stream()
    stream = torch.cuda.Stream()
    stream.wait_stream(prev)
    with torch.cuda.stream(stream):
        yield
    prev.wait_stream(stream)


class Graph:
    """fn(*inputs) captured once as a CUDA graph, replayed by calling it
    with new inputs of the same signature (copied into the static inputs
    first); returns fn's static outputs, which the next replay
    overwrites.  `pool`, a memory pool handle that other graphs share
    (torch.cuda.graph_pool_handle()), or None for the graph's own."""

    def __init__(self, fn, *inputs, pool=None):
        self.inputs = static_copy(inputs)
        self.key = signature(inputs)
        before = dict(LAUNCHES)
        # a trainer and its graphs are a reference cycle: collected while this
        # capture runs, a dead graph's destruction invalidates it (torch's
        # capture no longer collects first), so collect before it begins
        gc.collect()
        self.graph = torch.cuda.CUDAGraph()
        # thread_local: a prefetch worker (data/prefetch.py) goes on copying
        # the next samples on its own stream while this thread captures
        with torch.cuda.graph(self.graph, pool=pool, capture_error_mode="thread_local"):
            self.outputs = fn(*self.inputs)
        # the launches the wrappers recorded into the graph, by kernel
        self.launches = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
        self.replays = 0

    def __call__(self, *inputs):
        if signature(inputs) != self.key:
            raise ValueError("inputs differ from the captured ones in structure or shape")
        dst, src = tensors(self.inputs), tensors(inputs)
        pairs = [(d, s) for d, s in zip(dst, src) if d is not s]
        if pairs:
            torch._foreach_copy_([d for d, _ in pairs], [s for _, s in pairs])
        self.graph.replay()
        self.replays += 1
        return self.outputs


class Program:
    """fn as CUDA graphs, one per signature of its inputs: the first call of
    a signature runs fn eagerly on a side stream (the warm-up; its result is
    returned), then captures it and calls `settle()` (a step sets the
    gradients the capture left back to None); later calls replay the graph
    and return its static outputs.  The graphs share one memory pool,
    `pool` (a Pool that other programs may share too): one stream replays
    them one at a time, so one graph's scratch memory may be another's, and
    a replay may overwrite the outputs of any graph of the pool — read them
    before the next call."""

    def __init__(self, fn, settle=None, pool: "Pool | None" = None):
        self.fn = fn
        self.settle = settle
        self.pool = pool or Pool()
        self.graphs: dict = {}  # signature of the inputs -> Graph

    def __call__(self, *inputs):
        graph = self.graphs.get(signature(inputs))
        if graph is not None:
            return graph(*inputs)
        with side_stream():
            out = self.fn(*inputs)
        graph = Graph(self.fn, *inputs, pool=self.pool.handle())
        self.graphs[graph.key] = graph
        if self.settle is not None:
            self.settle()
        return out


class Pool:
    """One memory pool for the CUDA graphs of several programs that one
    stream replays one at a time (a trainer's steps and evaluation); its
    handle is made at the first capture."""

    def __init__(self):
        self._handle = None

    def handle(self):
        if self._handle is None:
            self._handle = torch.cuda.graph_pool_handle()
        return self._handle
