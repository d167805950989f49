"""A work module named by a configuration file (probe_patch.json): the
counts of yardstick/work.py, each call counted."""

from __future__ import annotations

import collections

from yardstick import work as base

CALLS: collections.Counter = collections.Counter()


def step_useful_flops(*args, **kwargs):
    CALLS["step_useful_flops"] += 1
    return base.step_useful_flops(*args, **kwargs)


def step_aggregate_bound_s(*args, **kwargs):
    CALLS["step_aggregate_bound_s"] += 1
    return base.step_aggregate_bound_s(*args, **kwargs)
