#!/usr/bin/env python3
"""What a torch.profiler window loses of a run's kernel records, profile
after profile, in one process on one NVIDIA GPU.

    python3 profile_windows.py [--sessions 30]

Builds chip_smoke.py's [halo-train] step (HaloTrainer on two
add_noise(icosphere(5), 0.2, seed) meshes, seeds 0 and 6, 4 parts on
cuda:0, eager: about 6,200 launch calls, 48 of them aggregate kernels),
then profiles one step in each of 2 x `--sessions` profiles, alternating
two ways of opening the window:

  * bare — the step right behind the profile's opening, as chip_smoke.py's
    counted runs opened it before they had the settle and the primer;
  * primed — as chip_smoke.py's `_counted()` opens it: PROFILE_SETTLE_S,
    then PROFILE_PRIMER launches of a tiny kernel, then the step, then
    PROFILE_SETTLE_S.

Per profile it prints the aggregate kernels the window lost (the step's
launches less those counted by kernel name), the launch calls without a
kernel record (in the primer, and in the step by their innermost
operation), and the least time from a launch call to its kernel's start on
the profiler's clock.  Exits non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    import profile_train_step as pts

    ap = argparse.ArgumentParser()
    ap.add_argument("--sessions", type=int, default=30)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_windows: no CUDA device", file=sys.stderr)
        return 2

    from geobignn_tpu_torch.config import Config
    from geobignn_tpu_torch.data import synth
    from geobignn_tpu_torch.ops import banded_cuda
    from geobignn_tpu_torch.train.halo_trainer import HaloTrainer

    banded_cuda.build()
    clean = synth.icosphere(5)
    pairs = [(synth.add_noise(clean, 0.2, seed=s), clean) for s in (0, 6)]
    cfg = Config(halo_parts=cs.HALO_PARTS, halo_banded=True, seed=0, augment=False)
    tr = HaloTrainer(cfg, pairs, devices=[torch.device("cuda", 0)] * cs.HALO_PARTS)
    s0 = tr.samples[0]
    step = tr._step_for(s0)
    per_fwd = cs._aggregates(cs._halo_expected(s0, cs.HALO_PARTS))
    launched = 2 * sum(per_fwd.values())  # forward and backward
    for _ in range(3):
        step(s0.arrays, 0)
    torch.cuda.synchronize()
    print(f"{torch.cuda.get_device_name(0)}; the step launches {launched} aggregate kernels")

    for i in range(2 * args.sessions):
        primed = i % 2 == 1
        if primed:
            with cs._counted() as cnt:
                step(s0.arrays, 0)
            counted, rec = sum(cnt["device"].values()), cnt["records"]
        else:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                step(s0.arrays, 0)
                torch.cuda.synchronize()
            counted = sum(pts.aggregate_launches(pts.device_kernels(prof)).values())
            rec = cs._launch_records(prof)
        print(json.dumps({
            "profile": i + 1, "window": "primed" if primed else "bare",
            "aggregates_lost": launched - counted, "launch_calls": rec["launch_calls"],
            "unrecorded_in_primer": rec["unrecorded_in_primer"],
            "unrecorded_in_step": rec["unrecorded"] - rec["unrecorded_in_primer"],
            "min_launch_to_start_us": rec["min_launch_to_start_us"],
            "unrecorded_in": rec["unrecorded_in"]}), flush=True)
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(f"profile_windows: {time.perf_counter() - t0:.1f} s")
    sys.exit(rc)
