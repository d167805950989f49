"""Segment (scatter) reductions over static maps, in plain torch.

Counterpart of geobignn_tpu/ops/segment.py.  The padding convention is the
framework's: padded edges carry row == col == trash, a reserved final node
slot whose features are zero, so no masks are needed.  Autograd
differentiates all of them (index_add_ and scatter_reduce have backwards).
"""

from __future__ import annotations

import torch


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int):
    out = data.new_zeros((num_segments,) + data.shape[1:])
    return out.index_add_(0, segment_ids, data)


def segment_count(segment_ids: torch.Tensor, num_segments: int, dtype=torch.float32):
    ones = torch.ones(segment_ids.shape[:1], dtype=dtype, device=segment_ids.device)
    return segment_sum(ones, segment_ids, num_segments)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int):
    s = segment_sum(data, segment_ids, num_segments)
    cnt = torch.clamp(segment_count(segment_ids, num_segments, data.dtype), min=1.0)
    return s / cnt.reshape((num_segments,) + (1,) * (s.ndim - 1))


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                fill_value: float = 0.0):
    """Segment max; empty segments get `fill_value` (torch_scatter uses 0)."""
    idx = segment_ids.reshape((-1,) + (1,) * (data.ndim - 1)).expand_as(data)
    m = data.new_full((num_segments,) + data.shape[1:], -torch.inf)
    m = m.scatter_reduce(0, idx, data, reduce="amax", include_self=True)
    return torch.where(torch.isneginf(m), m.new_tensor(fill_value), m)
