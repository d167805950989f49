#!/usr/bin/env python3
"""Device-time breakdown of the port's training step on one NVIDIA GPU.

    python3 profile_train_step.py [--steps 5] [--seeds 0,6]

Trains the default DualGNN (Config(seed=0), seeded random weights) on the
first 20,000-face patch of the training set that chip_smoke.py builds from
add_noise(icosphere(5), 0.2, seed=s) for the noise seeds given: `0,6` (the
default; every level bands) or `1,2` (the finest facet level runs
block-sparse).  Three ways of running a step (forward, backward, Adam;
rotation on), each profiled over `--steps` steps with torch.profiler after
three warm-up steps:

  * graphed — as the trainer runs it on the card: one replay of the step's
    CUDA graph (`Trainer.fused_step`);
  * eager — the same step kernel by kernel (`testing.eager_steps()`);
  * eager, autograd's index backward — the gathers as plain indexing
    (`plain_gathers()`), so that autograd differentiates them with its
    scatter-add, as the port did before the gathers' custom backwards.

For each it prints the step's host-clock time without the profiler, the
device busy share (kernel time per step over that step time), the kernels
launched per step, the device time of the port's hand-written kernels by
group (banded and block-sparse instantiations apart), of autograd's index
backward and of everything else, and the top kernels.  Then it attributes
the gathers' backward to their call sites: one eager step records every
call of a gather function (`GATHER_SITES`) with its inputs and the gradient
its output received; each call's backward is then run alone, under a
`record_function` range named after its site, once with autograd's
scatter-add and once with the custom backward, each profiled, and the
device time and kernels are summed by site.  Exits non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import subprocess
import sys
import time

# the port's hand-written kernels (csrc/window_walk.cuh, window_bwd.cuh,
# node_product.cuh, banded_common.cuh, nearest.cu, stamp.cu), by name
HAND_WRITTEN = ("row_walk_kernel", "col_walk_kernel", "node_product_kernel",
                "node_product_kernel_mma", "scaled_operand_kernel", "nearest_small_k",
                "nearest_wide_k", "stamp_kernel")
# autograd's backward of the index ops (the gathers of the pooling, unpooling
# and boundary tables): index_put_ with accumulate sorts the indices (cub)
# and then runs indexing_backward_kernel
INDEX_BACKWARD = ("indexing_backward", "index_put", "RadixSort", "radix_sort",
                  "DeviceScan", "unique", "Unique")
# the gather functions of a step by call site: (module, attribute, site)
GATHER_SITES = (
    ("table", "gather_pool_max", "pooling, member tables (gather_pool_max)"),
    ("table", "gather_pool_mean", "pooling, member tables (gather_pool_mean)"),
    ("table", "gather_unpool", "unpooling (gather_unpool)"),
    ("table", "table_gather", "face corners, table convs (table_gather)"),
    ("table", "table_gather_compact", "boundary tables (table_gather_compact)"),
    ("banded_cuda", "_gather_unique", "hybrid band, boundary gather (_gather_unique)"),
    ("banded_cuda", "_scatter_add_unique",
     "hybrid band, boundary scatter-add (_scatter_add_unique)"),
)


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
    if hit == "row_walk_kernel":  # <block-sparse, chunks, backward, transform-first>
        window = "block-sparse" if flags[0] in true else "banded"
        return (f"{window} backward row pass" if flags[2] in true
                else f"{window} forward walk")
    if hit == "col_walk_kernel":
        return ("block-sparse" if flags[0] in true else "banded") + " backward column pass"
    if hit == "node_product_kernel":
        return "per-node products (Y, x̄, W̄, gy, out)"
    if hit == "scaled_operand_kernel":
        return "elementwise operands (V, G)"
    if hit == "stamp_kernel":
        return "stage clock (timestamps)"
    return "nearest distance"


def aggregate_of(name):
    """The aggregate kernel ("aggregate_first", "bs_transform_first_bwd",
    ...; the keys of banded_cuda.LAUNCHES) that a device kernel's launch
    belongs to, or None: each launch of an aggregate runs one
    row_walk_kernel<block-sparse, chunks, backward, transform-first>."""
    if "row_walk_kernel" not in name:
        return None
    bs, _, bwd, tf = (f in ("1", "true") for f in _template_flags(name))
    return (("bs_" if bs else "") + ("transform_first" if tf else "aggregate_first")
            + ("_bwd" if bwd else ""))


def aggregate_launches(kernels):
    """{aggregate: launches} of device_kernels' result, by aggregate_of."""
    out: dict = {}
    for name, (_, cnt) in kernels.items():
        key = aggregate_of(name)
        if key is not None:
            out[key] = out.get(key, 0) + int(round(cnt))
    return out


def _modules():
    from geobignn_tpu_torch.ops import banded_cuda
    from geobignn_tpu_torch.ops import table

    return {"table": table, "banded_cuda": banded_cuda}


def _plain_versions():
    """Each gather function as plain indexing, whose backward is autograd's
    scatter-add."""
    import torch

    plain_take = lambda x, idx, *_: x[idx]  # noqa: E731
    return {
        "table_gather": plain_take,
        "table_gather_compact": plain_take,
        "_gather_unique": plain_take,
        "_scatter_add_unique": lambda num, corr, jnodes, jpos: num + torch.cat(
            [corr, corr.new_zeros((1, corr.shape[1]))])[jpos],
    }


@contextlib.contextmanager
def plain_gathers():
    """While open, the gathers are plain indexing (the pooling and
    unpooling reach table_gather through the table module)."""
    mods = _modules()
    saved = []
    for name, fn in _plain_versions().items():
        mod = mods["banded_cuda" if name.startswith("_") else "table"]
        saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def profile_steps(step, steps):
    """Run step(i) 3 times, then `steps` times on the host clock, then
    `steps` times under the profiler.  Returns (host ms per step, {kernel
    name: (device ms per step, launches per step)})."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for i in range(3):
        step(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        step(10 + i)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(steps):
            step(100 + i)
        torch.cuda.synchronize()
    return step_ms, device_kernels(prof, steps)


def device_kernels(prof, per=1):
    """{kernel name: (device ms, launches)} of a profile, divided by per
    (copies and sets included, annotations left out)."""
    kernels = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        annotation = ev.key.startswith(("Optimizer.", "ProfilerStep", "backward of "))
        if dev_us > 0 and not annotation and str(ev.device_type).endswith("CUDA"):
            kernels[ev.key] = (dev_us / 1e3 / per, ev.count / per)
    return kernels


def groups_of(kernels):
    """{group: [device ms, launches]} of device_kernels' result."""
    groups: dict = {}
    for name, (ms, cnt) in kernels.items():
        g = groups.setdefault(kernel_group(name), [0.0, 0.0])
        g[0] += ms
        g[1] += cnt
    return groups


def report(label, step_ms, kernels, top=15):
    total = sum(ms for ms, _ in kernels.values())
    launches = sum(cnt for _, cnt in kernels.values())
    print(f"[profile] {label}: {step_ms:.3f} ms per step (host clock, without the "
          f"profiler); device kernel time {total:.3f} ms per step, {launches:.0f} "
          f"kernels (busy share {total / step_ms:.3f})" if total else
          f"[profile] {label}: {step_ms:.3f} ms per step; device time not measured "
          f"(the profiler recorded no kernel)")
    for name, (ms, cnt) in sorted(groups_of(kernels).items(), key=lambda kv: -kv[1][0]):
        print(f"[profile]   {name}: {ms:.3f} ms per step, {cnt:.0f} launches")
    for name, (ms, cnt) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"[profile]     {ms:8.3f} ms {cnt:6.0f}x  {name[:110]}")
    return total, launches


def gather_calls(backward_step):
    """Every call of a gather function during backward_step(): (site, the
    function, its inputs, the gradient its output received)."""
    mods = _modules()
    calls, depth = [], [0]
    saved = []

    def wrap(fn, site):
        def recording(*args):
            if depth[0]:
                return fn(*args)
            depth[0] += 1
            try:
                out = fn(*args)
            finally:
                depth[0] -= 1
            if out.requires_grad:
                rec = {"site": site, "fn": fn, "args": [
                    a.detach().clone() if hasattr(a, "detach") else a for a in args]}
                out.register_hook(lambda g: rec.__setitem__("grad", g.detach().clone()))
                calls.append(rec)
            return out
        return recording

    for mod, name, site in GATHER_SITES:
        saved.append((mods[mod], name, getattr(mods[mod], name)))
        setattr(mods[mod], name, wrap(getattr(mods[mod], name), site))
    try:
        backward_step()
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return [c for c in calls if "grad" in c]


def site_backward(calls):
    """{site: {"calls", "autograd": (ms, launches, index-backward launches),
    "custom": (...)}}: each recorded call's backward run alone, profiled,
    with autograd's scatter-add (plain indexing) and with the custom
    backward."""
    import torch
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    out: dict = {}
    for rec in calls:
        row = out.setdefault(rec["site"], {"calls": 0, "autograd": [0.0, 0, 0],
                                           "custom": [0.0, 0, 0]})
        row["calls"] += 1
        for backend, fn in _backends(rec["fn"]):
            args = [a.clone().requires_grad_() if torch.is_tensor(a) and a.is_floating_point()
                    else a for a in rec["args"]]
            y = fn(*args)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                with record_function(f"backward of {rec['site']}"):
                    torch.autograd.backward(y, rec["grad"])
                torch.cuda.synchronize()
            kernels = device_kernels(prof)
            acc = row[backend]
            acc[0] += sum(ms for ms, _ in kernels.values())
            acc[1] += sum(cnt for _, cnt in kernels.values())
            acc[2] += sum(cnt for k, (_, cnt) in kernels.items() if "indexing_backward" in k)
    return out


def _backends(fn):
    """(("autograd", fn as plain indexing), ("custom", fn)); the pooling and
    unpooling functions take plain indexing through table_gather."""
    plain = _plain_versions().get(fn.__name__)
    if plain is None:
        def plain(*args):
            with plain_gathers():
                return fn(*args)
    return (("autograd", plain), ("custom", fn))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--seeds", default="0,6",
                    help="noise seeds of the training set's meshes, e.g. 0,6 or 1,2")
    args = ap.parse_args()
    seeds = tuple(int(v) for v in args.seeds.split(","))

    import torch

    if not torch.cuda.is_available():
        print("profile_train_step: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())

    from geobignn_tpu_torch.config import Config
    from geobignn_tpu_torch.data import dataset, synth
    from geobignn_tpu_torch.testing import eager_steps
    from geobignn_tpu_torch.train.trainer import Trainer

    cfg = Config(seed=0)
    clean = synth.icosphere(5)
    ds = dataset.InMemoryDataset(
        [(synth.add_noise(clean, 0.2, seed=sd), clean) for sd in seeds],
        cfg.build_config(), submesh_size=cfg.sub_size)
    tr = Trainer(cfg, ds, None, device="cuda")
    sample = tr._get(ds, "t", 0)

    def eager(i):
        tr._step(sample, i)
        tr._apply(1)

    print(f"[profile] noise seeds {seeds}: {args.steps} steps on one 20,000-face patch")
    report("graphed", *profile_steps(lambda i: tr.fused_step(sample, i), args.steps))
    tr.optimizer.zero_grad(set_to_none=True)
    with eager_steps():
        report("eager", *profile_steps(eager, args.steps))
        with plain_gathers():
            report("eager, autograd's index backward", *profile_steps(eager, args.steps))

    calls = gather_calls(lambda: tr._step(sample, 0))
    tr.optimizer.zero_grad(set_to_none=True)
    sites = site_backward(calls)
    tot = {"autograd": [0.0, 0, 0], "custom": [0.0, 0, 0]}
    for site, row in sorted(sites.items(), key=lambda kv: -kv[1]["autograd"][0]):
        print(f"[gathers] {site}: {row['calls']} calls; backward alone: autograd's "
              f"scatter-add {row['autograd'][0]:.3f} ms, {row['autograd'][1]:.0f} kernels "
              f"({row['autograd'][2]:.0f} indexing_backward); custom "
              f"{row['custom'][0]:.3f} ms, {row['custom'][1]:.0f} kernels")
        for k in tot:
            tot[k] = [a + b for a, b in zip(tot[k], row[k])]
    print(f"[gathers] all sites: autograd's scatter-add {tot['autograd'][0]:.3f} ms, "
          f"{tot['autograd'][1]:.0f} kernels ({tot['autograd'][2]:.0f} "
          f"indexing_backward); custom {tot['custom'][0]:.3f} ms, "
          f"{tot['custom'][1]:.0f} kernels")
    return 0


if __name__ == "__main__":
    sys.exit(main())
