#!/usr/bin/env python3
"""Device-time breakdown of the port's training step on one NVIDIA GPU.

    python3 profile_train_step.py [--steps 5]

Trains the default DualGNN (Config(seed=0), seeded random weights) on the
first 20,000-face patch of add_noise(icosphere(5), 0.2, seed=0) — the
training phase of chip_smoke.py — and profiles `--steps` steps (forward,
backward, Adam; rotation on) after three warm-up steps with torch.profiler.
Prints the step's host-clock time without the profiler, the device busy
share (the kernel time per step over that step time), the device time of
the port's banded kernels by group and of everything else, and the top
kernels by device time.  Exits non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

GROUPS = (  # kernel-name substrings of the port's hand-written kernels
    ("banded forward window (kernels #1/#2)", ("banded_window_kernel",)),
    ("banded window operand (forward and backward)", ("window_operand_kernel",)),
    ("banded backward (kernels #3/#4)", ("bwd_row_kernel", "bwd_col_kernel",
                                         "row_operand_kernel", "xbar_tf_kernel",
                                         "wbar_partial_kernel")),
)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args()

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
    ds = dataset.InMemoryDataset([(synth.add_noise(clean, 0.2, seed=0), clean)],
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
    print(f"[profile] {args.steps} steps on one 20,000-face patch: {step_ms:.3f} ms "
          f"per step (host clock, without the profiler); device kernel time "
          f"{total:.3f} ms per step (profiled) "
          f"(busy share {total / step_ms:.3f})" if total else
          f"[profile] {step_ms:.3f} ms per step; device time not measured "
          f"(the profiler recorded no kernel)")
    rest = total
    for label, names in GROUPS:
        ms = sum(v[0] for k, v in kernels.items() if any(n in k for n in names))
        cnt = sum(v[1] for k, v in kernels.items() if any(n in k for n in names))
        rest -= ms
        print(f"[profile] {label}: {ms:.3f} ms per step, {cnt} launches")
    print(f"[profile] everything else (PyTorch ops): {rest:.3f} ms per step")
    for name, (ms, cnt) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:25]:
        print(f"[profile]   {ms:8.3f} ms {cnt:5d}x  {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
