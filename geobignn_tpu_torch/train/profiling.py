"""Tracing and timing of steps on the card.

Counterpart of geobignn_tpu/train/profiling.py in PyTorch idiom:

  * `trace(log_dir)` records a region with `torch.profiler` (host and
    device activities), which turns the program's spans and counters on
    (tracing.py), and writes a Chrome/Perfetto trace to
    `log_dir/trace.json` and the counters to `log_dir/counters.json`;
  * `device_sync(x)` is the fence: `torch.cuda.synchronize()` and one
    value read back to the host;
  * `time_steps(step)` takes the place of `measure_chained` (which chains
    k steps in one TPU dispatch and differences two chain lengths): each
    of `steps` calls of `step()` after `warmup` calls is timed between two
    CUDA events on the current stream, and the median, minimum, maximum
    and mean are returned together, so that the spread goes with the time.
"""

from __future__ import annotations

import contextlib
import json
import os

import numpy as np
import torch

from geobignn_tpu_torch import tracing


@contextlib.contextmanager
def trace(log_dir: str):
    """`with profiling.trace('/tmp/trace'): trainer.fit()` — a torch.profiler
    trace of the region with the program's spans, written to
    log_dir/trace.json, and the counters the region added (from zero) to
    log_dir/counters.json."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    tracing.reset()
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "counters.json"), "w") as f:
        json.dump(tracing.counters(), f, indent=1, sort_keys=True)


def device_sync(x) -> float:
    """Wait for every queued kernel, then read one value of x (a tensor or
    a tuple / list / dict of them) back to the host, and return it."""
    if isinstance(x, dict):
        x = next(iter(x.values()))
    while isinstance(x, (tuple, list)):
        x = x[0]
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    return float(x.detach().reshape(-1)[0].cpu())


def time_steps(step, steps: int = 20, warmup: int = 3) -> dict:
    """Milliseconds of each of `steps` calls of `step()` after `warmup`
    calls, between CUDA events around each call: {n, median_ms, min_ms,
    max_ms, mean_ms, ms (every step)}.  Needs a CUDA device."""
    if steps < 1:
        raise ValueError("steps must be at least 1")
    for _ in range(warmup):
        step()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(steps)]
    for start, end in events:
        start.record()
        step()
        end.record()
    torch.cuda.synchronize()
    ms = np.array([start.elapsed_time(end) for start, end in events])
    return dict(n=steps, median_ms=float(np.median(ms)), min_ms=float(ms.min()),
                max_ms=float(ms.max()), mean_ms=float(ms.mean()), ms=ms.tolist())
