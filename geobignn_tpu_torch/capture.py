"""CUDA graphs of the training step and of the patch forward.

The JAX trainer runs a default step — forward, backward, the Adam update
and the metric sums — in one dispatch (`fused_step`, a whole epoch in one
`lax.scan`), and the predictor one `jax.jit` of `model.apply`.  Their
counterpart on the card is a CUDA graph: the step's kernels, about 1,600 of
them, are captured once and replayed with one launch, so the host's Python
and the launches leave the step's time.

`Graph` captures a function of tensors once, for one padded shape, and
replays it: the inputs are copied into static buffers (the graph reads
those addresses) and the outputs are static tensors that each replay
overwrites.  What a capture needs before it starts runs in the caller's
first, eager call of the same function (the warm-up): the kernels'
builds and their shared-memory opt-ins, the optimizer's state.  Nothing
inside may wait for the device; a capture that meets such a call raises,
and nothing falls back to the eager path.

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

import torch

from geobignn_tpu_torch.ops.banded_cuda import LAUNCHES

EAGER = False  # testing.eager_steps() sets it; nothing else does


def tensors(tree) -> list:
    """The tensors of a tree of dataclasses, tuples, lists and tensors, in
    order (static ints, floats and None left out)."""
    if torch.is_tensor(tree):
        return [tree]
    if dataclasses.is_dataclass(tree):
        return [t for f in dataclasses.fields(tree) for t in tensors(getattr(tree, f.name))]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in tensors(v)]
    return []


def signature(tree) -> tuple:
    """What a graph is keyed on: the tree's structure, static values and
    every tensor's shape, dtype and device."""
    if torch.is_tensor(tree):
        return ("tensor", tuple(tree.shape), tree.dtype, tree.device)
    if dataclasses.is_dataclass(tree):
        return (type(tree).__name__,) + tuple(
            signature(getattr(tree, f.name)) for f in dataclasses.fields(tree))
    if isinstance(tree, (tuple, list)):
        return tuple(signature(v) for v in tree)
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
    return tree


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
    overwrites."""

    def __init__(self, fn, *inputs):
        self.inputs = static_copy(inputs)
        self.key = signature(inputs)
        before = dict(LAUNCHES)
        self.graph = torch.cuda.CUDAGraph()
        # thread_local: a prefetch worker (data/prefetch.py) goes on copying
        # the next samples on its own stream while this thread captures
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
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
