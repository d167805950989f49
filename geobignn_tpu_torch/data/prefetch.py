"""Background input pipeline: host padding and host-to-device copies ahead
of the device's steps.

Counterpart of geobignn_tpu/data/prefetch.py.  `prefetch_iter` is the JAX
function: one worker thread runs `fetch` up to `depth` items ahead of the
consumer, results arrive in input order, a fetch's exception surfaces at its
own yield, and an early exit cancels the queued fetches.

JAX gets its overlap from `device_put` only enqueueing the copy.  Here
`device_iter` provides it: on the worker, a padded sample goes to pinned
host memory and is copied with `non_blocking=True` on a copy stream, which
records an event; on the consumer, the current stream waits on that event
and `record_stream`s every device tensor on it, so the caching allocator
keeps each buffer until the work enqueued on the current stream before its
release has run.  The pinned buffers come from torch's caching host
allocator, which does not hand a block out again before the copies that
read it have finished.
"""

from __future__ import annotations

import collections
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, TypeVar

import torch

from geobignn_tpu_torch.capture import map_tensors, tensors

T = TypeVar("T")
R = TypeVar("R")


def prefetch_iter(items: Iterable[T], fetch: Callable[[T], R], depth: int = 2) -> Iterator[R]:
    """Yield fetch(item) for each item, keeping up to `depth` fetches in
    flight on a background thread.  Results arrive in input order; a fetch
    exception surfaces at the corresponding yield."""
    if depth <= 0:
        for x in items:
            yield fetch(x)
        return
    with ThreadPoolExecutor(max_workers=1) as ex:
        q: collections.deque = collections.deque()
        try:
            for x in items:
                q.append(ex.submit(fetch, x))
                if len(q) > depth:
                    yield q.popleft().result()
            while q:
                yield q.popleft().result()
        finally:  # consumer bailed early: drop queued work fast
            for f in q:
                f.cancel()


def device_iter(items: Iterable[T], fetch: Callable[[T], object], device,
                depth: int = 2) -> Iterator:
    """prefetch_iter over fetch(item) (a host sample, a structs tree) copied
    to `device`: each yielded sample may be read at once on the current
    stream.  A plain `.to` on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        yield from prefetch_iter(items, lambda x: fetch(x).to(device), depth)
        return
    stream = torch.cuda.Stream(device)

    def stage(x):  # worker side: start the copy, return at once
        host = map_tensors(torch.Tensor.pin_memory, fetch(x).to("cpu"))
        with torch.cuda.device(device), torch.cuda.stream(stream):
            sample = map_tensors(lambda t: t.to(device, non_blocking=True), host)
            event = torch.cuda.Event()
            event.record(stream)
        return sample, event

    for sample, event in prefetch_iter(items, stage, depth):
        cur = torch.cuda.current_stream(device)
        cur.wait_event(event)
        for t in tensors(sample):
            t.record_stream(cur)
        yield sample
