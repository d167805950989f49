"""Segment (scatter) reductions over static maps, in plain torch.

Counterpart of geobignn_tpu/ops/segment.py.  The padding convention is the
framework's: padded edges carry row == col == trash, a reserved final node
slot whose features are zero, so no masks are needed.  Autograd
differentiates all of them.

`sorted=True` asserts non-decreasing segment ids, as the JAX functions'
flag does (every host-built edge list, and the compacted coalesce outputs
of dynamic pooling): the sum is then `torch.segment_reduce` over offsets
found by a binary search, which adds each segment's rows in order, and a
parallel reduction for the last segment, with no atomics, so it gives the
same bits on every run, eager or in a CUDA graph.
Unsorted ids take `index_add_`, whose float atomics on the card do not.
Passing sorted=True on unsorted ids gives wrong sums, as in JAX.

`take_rows` is `x[idx]` with the same kind of backward: the cotangent's
rows summed per index in sorted order, instead of autograd's index
backward, which adds the rows of each repeated index one after another —
slow where one index repeats tens of thousands of times, as the trash slot
does in a padded edge list.
"""

from __future__ import annotations

import torch


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int, *,
                sorted: bool = False):
    if sorted:
        # every segment but the last by segment_reduce; the last (the trash
        # slot, where a padded list's padding piles up: tens of thousands of
        # rows that one thread of segment_reduce would add one by one) is
        # left empty there and summed by a parallel reduction
        bounds = torch.arange(num_segments + 1, device=segment_ids.device)
        offsets = torch.searchsorted(segment_ids, bounds.clamp(max=num_segments - 1))
        head = torch.segment_reduce(data, "sum", offsets=offsets, axis=0, unsafe=True)
        last = (segment_ids == num_segments - 1).reshape((-1,) + (1,) * (data.ndim - 1))
        tail = torch.where(last, data, 0).sum(0, keepdim=True)
        return torch.cat([head[:-1], tail])
    out = data.new_zeros((num_segments,) + data.shape[1:])
    return out.index_add_(0, segment_ids, data)


def segment_count(segment_ids: torch.Tensor, num_segments: int, dtype=torch.float32, *,
                  sorted: bool = False):
    ones = torch.ones(segment_ids.shape[:1], dtype=dtype, device=segment_ids.device)
    return segment_sum(ones, segment_ids, num_segments, sorted=sorted)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int, *,
                 sorted: bool = False):
    s = segment_sum(data, segment_ids, num_segments, sorted=sorted)
    cnt = segment_count(segment_ids, num_segments, data.dtype, sorted=sorted)
    cnt = torch.clamp(cnt, min=1.0)
    return s / cnt.reshape((num_segments,) + (1,) * (s.ndim - 1))


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                fill_value: float = 0.0):
    """Segment max; empty segments get `fill_value` (torch_scatter uses 0)."""
    idx = segment_ids.reshape((-1,) + (1,) * (data.ndim - 1)).expand_as(data)
    m = data.new_full((num_segments,) + data.shape[1:], -torch.inf)
    m = m.scatter_reduce(0, idx, data, reduce="amax", include_self=True)
    # a fill, not a tensor made from a host value: a CUDA graph can hold it
    return m.masked_fill(torch.isneginf(m), fill_value)


class _TakeRows(torch.autograd.Function):
    """x[idx]; backward: segment_sum of the cotangent over idx, in the
    order `order` sorts idx into (None: idx is sorted already)."""

    @staticmethod
    def forward(ctx, x, idx, order):
        ctx.save_for_backward(idx, order)
        ctx.n = x.shape[0]
        return x[idx]

    @staticmethod
    def backward(ctx, g):
        idx, order = ctx.saved_tensors
        if order is not None:
            g, idx = g[order], idx[order]
        return segment_sum(g, idx, ctx.n, sorted=True), None, None


def take_rows(x: torch.Tensor, idx: torch.Tensor, *, sorted: bool = False) -> torch.Tensor:
    """x[idx] (idx 1-D) whose gradient is a sorted segment sum (no atomics):
    `sorted=True` asserts non-decreasing idx; otherwise a stable argsort
    orders it first."""
    order = None if sorted else torch.argsort(idx, stable=True)
    return _TakeRows.apply(x, idx, order)
