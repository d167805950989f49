"""Spans and counters inside the program, on the profiler's clock.

Tracing is on exactly while a torch profiler records
(`torch.autograd.profiler._is_profiler_enabled`): `train/profiling.trace`,
or any `torch.profiler.profile` around the program.  There is no other
switch.  Off, a span is one bool check and a shared null context, and a
count is one bool check.

  * `span(name)` is `torch.profiler.record_function(name)` while on: the
    span's start, end and nesting are the profiler's own, on the clock of
    its device intervals, kept in memory until the trace is exported;
    `spanned(name)` makes a whole function such a span.
  * `count(name, value)` adds to an in-process dict while on;
    `counters()` returns a copy and `reset()` clears it
    (`profiling.trace` resets it on entry and writes it beside the trace).

The names, by layer: `trainer.epoch` (`trainer.epoch_begin`,
`trainer.steps`, `trainer.epoch_sync`), `trainer.step` (`trainer.rotation`),
`trainer.evaluate` (`trainer.eval_begin`, `trainer.eval_steps`,
`trainer.eval_sync`); `graph.run` (`graph.copy_inputs`, `graph.replay`),
`graph.capture`; `model.forward` (`model.vertex`, `model.facet_features`,
`model.facet`), `model.loss`, `model.backward`, `optimizer.step`;
`data.get`, `prefetch.wait`; `build.mesh` (`build.split`, `build.raw`:
`build.rcm`, `build.graphs`, `build.hierarchy`), `build.plan`;
`predict.mesh`, `predict.host_build`, `predict.forward`, `predict.stitch`,
`predict.update`.  torch's profiler records the thread that started it: a
streamed run's prefetch worker pads its samples (`data.get`) unrecorded,
and the loop's wait for them is `prefetch.wait`.  Counters: `graph.runs`,
`graph.input_tensors`, `graph.input_bytes`, `graph.captures`;
`step.fwd_ms`, `step.bwd_ms`, `step.opt_ms` and `step.stage_readings`
(every replayed step of a traced epoch, from the device timestamps inside
its CUDA graph: train/trainer._StageClock).

Under the profiler the program runs slower than without it: CUPTI's cost
on each kernel launch lengthens the host's launches (a graph's launch by
its kernel nodes), so host spans and the device's idle time read from a
trace are upper readings of the program's own.
"""

from __future__ import annotations

import contextlib
import functools

import torch.autograd.profiler as _autograd_profiler
from torch import profiler as _profiler

_NULL = contextlib.nullcontext()
_COUNTERS: dict = {}


def on() -> bool:
    """Whether a torch profiler is recording."""
    return _autograd_profiler._is_profiler_enabled


def span(name: str):
    """A context that records a span named `name` while a profiler records."""
    if _autograd_profiler._is_profiler_enabled:
        return _profiler.record_function(name)
    return _NULL


def spanned(name: str):
    """A decorator: the function's every call is the span `name` while a
    profiler records."""
    def wrap(fn):
        @functools.wraps(fn)
        def spanned_fn(*args, **kwargs):
            if _autograd_profiler._is_profiler_enabled:
                with _profiler.record_function(name):
                    return fn(*args, **kwargs)
            return fn(*args, **kwargs)
        return spanned_fn
    return wrap


def count(name: str, value=1) -> None:
    """Add `value` to the counter `name` while a profiler records."""
    if _autograd_profiler._is_profiler_enabled:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + value


def counters() -> dict:
    """A copy of the counters."""
    return dict(_COUNTERS)


def reset() -> None:
    _COUNTERS.clear()
