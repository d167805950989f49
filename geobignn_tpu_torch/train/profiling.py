"""Tracing and timing of steps on the card.

Counterpart of geobignn_tpu/train/profiling.py in PyTorch idiom:

  * `trace(log_dir)` records a region with `torch.profiler` (host and
    device activities) and writes a Chrome/Perfetto trace to
    `log_dir/trace.json`;
  * `device_sync(x)` is the fence: `torch.cuda.synchronize()` and one
    value read back to the host;
  * `time_steps(step)` takes the place of `measure_chained` (which chains
    k steps in one TPU dispatch and differences two chain lengths): each
    of `steps` calls of `step()` after `warmup` calls is timed between two
    CUDA events on the current stream, and the median, minimum, maximum
    and mean are returned together, so that the spread goes with the time;
  * `StepTimer` collects host-clock latencies, as in the JAX module.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """`with profiling.trace('/tmp/trace'): step()` — a torch.profiler
    trace of the region, written to log_dir/trace.json."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


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


class StepTimer:
    def __init__(self):
        self.samples: list[float] = []
        self._t0: float | None = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.samples.append(time.perf_counter() - self._t0)

    def summary(self) -> dict:
        a = np.asarray(self.samples)
        if a.size == 0:
            return {}
        return dict(
            n=int(a.size),
            mean_ms=float(a.mean() * 1e3),
            p50_ms=float(np.percentile(a, 50) * 1e3),
            p95_ms=float(np.percentile(a, 95) * 1e3),
            max_ms=float(a.max() * 1e3),
        )
