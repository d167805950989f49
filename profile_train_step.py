#!/usr/bin/env python3
"""Device-time breakdown of the port's training step on one NVIDIA GPU.

    python3 profile_train_step.py [--steps 5] [--seeds 0,6]

Trains the default DualGNN (Config(seed=0), seeded random weights) on the
first 20,000-face patch of the training set that chip_smoke.py builds from
add_noise(icosphere(5), 0.2, seed=s) for the noise seeds given: `0,6` (the
default; every level bands) or `1,2` (the finest facet level runs
block-sparse) — and profiles `--steps` steps (forward, backward, Adam;
rotation on) after three warm-up steps with torch.profiler.  Prints the
step's host-clock time without the profiler, the device busy share (the
kernel time per step over that step time), the device time of the port's
hand-written kernels by group (banded and block-sparse instantiations
apart), of autograd's index backward and of everything else, and the top
kernels by device time.  Exits non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

# the port's hand-written kernels (csrc/window_walk.cuh, window_bwd.cuh,
# node_product.cuh, banded_common.cuh, nearest.cu), by name
HAND_WRITTEN = ("row_walk_kernel", "col_walk_kernel", "node_product_kernel",
                "scaled_operand_kernel", "nearest_small_k", "nearest_wide_k")
# autograd's backward of the index ops (the gathers of the pooling, unpooling
# and boundary tables): index_put_ with accumulate sorts the indices (cub)
# and then runs indexing_backward_kernel
INDEX_BACKWARD = ("indexing_backward", "index_put", "RadixSort", "radix_sort",
                  "DeviceScan", "unique", "Unique")


def _template_flags(name):
    """The template arguments of a demangled kernel name as strings of
    digits or words: 'row_walk_kernel<(bool)0, (int)3, (bool)1>(...)' ->
    ['0', '3', '1']."""
    if "<" not in name:
        return []
    inner = name[name.index("<") + 1:name.index(">")]
    return [a.split(")")[-1].strip() for a in inner.split(",")]


def kernel_group(name):
    """The group a device kernel's time is summed under."""
    hit = next((k for k in HAND_WRITTEN if k in name), None)
    if hit is None:
        return ("index backward (autograd)" if any(k in name for k in INDEX_BACKWARD)
                else "everything else (PyTorch ops)")
    flags = _template_flags(name)
    true = ("1", "true")
    if hit == "row_walk_kernel":
        window = "block-sparse" if flags[0] in true else "banded"
        return (f"{window} backward row pass" if flags[-1] in true
                else f"{window} forward walk")
    if hit == "col_walk_kernel":
        return ("block-sparse" if flags[0] in true else "banded") + " backward column pass"
    if hit == "node_product_kernel":
        return "per-node products (Y, x̄, W̄, gy, out)"
    if hit == "scaled_operand_kernel":
        return "elementwise operands (V, G)"
    return "nearest distance"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--seeds", default="0,6",
                    help="noise seeds of the training set's meshes, e.g. 0,6 or 1,2")
    args = ap.parse_args()
    seeds = tuple(int(v) for v in args.seeds.split(","))

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_train_step: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())

    from geobignn_tpu_torch.config import Config
    from geobignn_tpu_torch.data import dataset, synth
    from geobignn_tpu_torch.train.trainer import Trainer

    cfg = Config(seed=0)
    clean = synth.icosphere(5)
    ds = dataset.InMemoryDataset(
        [(synth.add_noise(clean, 0.2, seed=sd), clean) for sd in seeds],
        cfg.build_config(), submesh_size=cfg.sub_size)
    tr = Trainer(cfg, ds, None, device="cuda")
    sample = tr._get(ds, "t", 0)

    def step(i):
        tr._step(sample, i)
        tr._apply(1)

    for i in range(3):
        step(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(args.steps):
        step(10 + i)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(args.steps):
            step(100 + i)
        torch.cuda.synchronize()

    kernels = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        annotation = ev.key.startswith(("Optimizer.", "ProfilerStep"))
        if dev_us > 0 and not annotation and str(ev.device_type).endswith("CUDA"):
            kernels[ev.key] = (dev_us / 1e3 / args.steps, ev.count // args.steps)
    total = sum(ms for ms, _ in kernels.values())
    print(f"[profile] noise seeds {seeds}: {args.steps} steps on one 20,000-face patch: {step_ms:.3f} ms "
          f"per step (host clock, without the profiler); device kernel time "
          f"{total:.3f} ms per step (profiled) "
          f"(busy share {total / step_ms:.3f})" if total else
          f"[profile] {step_ms:.3f} ms per step; device time not measured "
          f"(the profiler recorded no kernel)")
    groups: dict = {}
    for name, (ms, cnt) in kernels.items():
        g = groups.setdefault(kernel_group(name), [0.0, 0])
        g[0] += ms
        g[1] += cnt
    for label, (ms, cnt) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"[profile] {label}: {ms:.3f} ms per step, {cnt} launches")
    for name, (ms, cnt) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:25]:
        print(f"[profile]   {ms:8.3f} ms {cnt:5d}x  {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
