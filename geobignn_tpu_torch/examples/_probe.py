"""What the measuring scripts of examples/ share: the device flag, timing
with CUDA events on the card and the host clock on the CPU, the card's
line, and one printed row per measurement."""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import time

import numpy as np
import torch


def parser(doc: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; CUDA events) or cpu (the host clock)")
    return ap


def device_of(name: str) -> torch.device:
    """The device a probe runs on: the card unless the CPU is asked for."""
    from geobignn_tpu_torch.utils import resolve_device

    return resolve_device(name)


def card(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi prints them, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed(fn, device: torch.device, steps: int = 10, warmup: int = 2,
          graph: bool = False) -> dict:
    """Milliseconds of each of `steps` calls of fn() after `warmup` calls:
    between CUDA events on the card (train/profiling.time_steps), on the
    host clock after a sync on the CPU.  With `graph` on the card, fn is
    captured as one CUDA graph after its warm-up and its replays are timed:
    the device's time without the host's launches.  {n, median_ms,
    min_ms, max_ms, mean_ms, ms}."""
    if device.type == "cuda":
        from geobignn_tpu_torch.train.profiling import time_steps

        if not graph:
            return time_steps(fn, steps=steps, warmup=warmup)
        from geobignn_tpu_torch.capture import side_stream

        with side_stream():
            for _ in range(warmup):
                fn()
        gc.collect()  # a dead graph destroyed mid-capture invalidates it (capture.Graph)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, capture_error_mode="thread_local"):
            fn()
        return time_steps(g.replay, steps=steps, warmup=1)
    for _ in range(warmup):
        fn()
    ms = []
    for _ in range(steps):
        t0 = time.perf_counter()
        fn()
        ms.append((time.perf_counter() - t0) * 1e3)
    ms = np.array(ms)
    return dict(n=steps, median_ms=float(np.median(ms)), min_ms=float(ms.min()),
                max_ms=float(ms.max()), mean_ms=float(ms.mean()), ms=ms.tolist())


def spread(t: dict) -> dict:
    """A timing's median, min and max, for a row."""
    return {k: t[k] for k in ("median_ms", "min_ms", "max_ms")}


def row(tag: str, **fields) -> dict:
    """Print one measurement as `[tag] {json}` and return its fields."""
    print(f"[{tag}] " + json.dumps(fields), flush=True)
    return fields
