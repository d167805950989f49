"""A traced window: torch.profiler on the host and the card, read back.

`traced(fn)` runs fn once under torch.profiler (CPU and CUDA activities)
inside a host span named `bench.window` that ends after a synchronize, and
returns a `Trace`: every device interval (kernels, copies, sets), the host
events, and the window.  The trace goes through the profiler's Chrome
export, a file under the temporary directory deleted once read.

The readings a metric takes from a Trace: the union of the device
intervals inside the window (intervals are unioned, never summed, so
overlapping kernels count once), the device time of kernels by name, the
longest idle gaps named by the innermost host event under each.
"""

from __future__ import annotations

import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench.window"


class Trace:
    def __init__(self, device, host, window):
        self.device = device  # [(name, start_us, end_us)] sorted by start
        self.host = host  # [(name, start_us, end_us)]
        self.window = window  # (start_us, end_us)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def clipped(self):
        lo, hi = self.window
        return [(n, max(s, lo), min(e, hi)) for n, s, e in self.device if e > lo and s < hi]

    def busy_s(self) -> float:
        return union_length([(s, e) for _, s, e in self.clipped()]) * 1e-6

    def kernel_s(self, match) -> float:
        """Device seconds of the kernels whose name `match(name)` accepts."""
        return sum(e - s for n, s, e in self.clipped() if match(n)) * 1e-6

    def top_ops(self, k: int = 10):
        tot: dict = {}
        for n, s, e in self.clipped():
            tot[n] = tot.get(n, 0.0) + (e - s) * 1e-6
        return sorted(([n[:160], v] for n, v in tot.items()), key=lambda t: -t[1])[:k]

    def idle_gaps(self, k: int = 10):
        """The k longest stretches of the window with no device interval,
        each named by the shortest host event that covers its middle."""
        gaps = complement([(s, e) for _, s, e in self.clipped()], *self.window)
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:k]:
            mid = (s + e) / 2
            cover = [(he - hs, n) for n, hs, he in self.host
                     if hs <= mid <= he and n != WINDOW]
            out.append([min(cover)[1][:160] if cover else "host idle", (e - s) * 1e-6])
        return out


def union_length(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def complement(intervals, lo, hi):
    """The stretches of [lo, hi] that no interval covers."""
    out, at = [], lo
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]


def parse_chrome(path: str) -> Trace:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device, host, window = [], [], None
    for ev in events:
        if ev.get("ph") != "X":
            continue
        s, e = float(ev["ts"]), float(ev["ts"]) + float(ev.get("dur", 0.0))
        cat = ev.get("cat", "")
        if cat in DEVICE_CATS:
            device.append((ev.get("name", ""), s, e))
        elif cat in ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
                     "python_function"):
            host.append((ev.get("name", ""), s, e))
            if ev.get("name") == WINDOW and cat == "user_annotation":
                window = (s, e)
    device.sort(key=lambda t: t[1])
    if window is None:
        raise RuntimeError("the trace holds no bench.window span")
    return Trace(device, host, window)


def traced(fn) -> Trace:
    """fn() under torch.profiler inside the `bench.window` span, read back."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            fn()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return parse_chrome(path)
    finally:
        os.remove(path)
