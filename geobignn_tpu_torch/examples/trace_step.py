"""A device trace of whole training steps, every microsecond attributed.

Counterpart of the JAX repo's examples/trace_step.py: `--steps` (2) graphed
training steps (Trainer.fused_step: forward, backward, Adam; one CUDA graph
replay each) of the whole add_noise(icosphere(subdiv), 0.2, seed=0) mesh
(`--batch` copies in one union sample), or with `--halo-parts P` the
P-part halo step of that mesh as the JAX repo's run_1m.py builds and runs
it (parallel/halo_train: build_halo_train_sample under
BuildConfig(granularity=256, reorder=False), table convs,
make_halo_train_step with Adam and rotation; every part on the one device,
one graph replay a step), after two warm-up steps, under torch.profiler
(CUPTI).  The traced steps sit between two CUDA events; the device time of
every kernel the trace recorded is summed by kernel name, then by group
(the name without its template arguments and trailing digits), and the
sum of the rows is set against the events' time: the busy share, the rest
idle.  The window opens with a 50 ms settle and 256 spin kernels (left out
of the rows), which take the profiler's losses of a window's first
records.  On the CPU the rows are the operators' own CPU times and the
time the host clock's.  The Chrome trace goes to `--trace-dir`
(log/trace_step).

Run:  python -m geobignn_tpu_torch.examples.trace_step [--subdiv 7 --batch 1
      --fc-float32 --halo-parts P --trace-dir DIR]
      (on the CPU at a small size: --device cpu --subdiv 2)
"""

from __future__ import annotations

import collections
import itertools
import os
import re
import time

import torch

from geobignn_tpu_torch.examples import _probe, _sample

PRIMER = 256  # spin kernels that open the traced window
TOP_GROUPS, TOP_KERNELS = 25, 45


ANNOTATIONS = ("primer", "traced steps")  # the window's own ranges, not kernels


def group_of(name: str) -> str:
    """A kernel's group: its name without "void", anonymous namespaces,
    template arguments, argument lists and trailing digits."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return re.sub(r"[.\d_]+$", "", re.sub(r"[<(].*", "", name)).strip() or name


def step_of(args, dev):
    """(step(i), description) of the traced program."""
    from geobignn_tpu_torch.config import Config

    fc = "float32" if args.fc_float32 else "bfloat16"
    if args.halo_parts:  # the JAX repo's run_1m.py's halo step
        from geobignn_tpu_torch.data import synth
        from geobignn_tpu_torch.data.builder import BuildConfig
        from geobignn_tpu_torch.models.dual_gnn import DualGNN
        from geobignn_tpu_torch.parallel import halo_train as ht
        from geobignn_tpu_torch.train import optim

        cfg = Config(seed=0, fc_precision=fc)
        clean = synth.icosphere(args.subdiv)
        noisy = synth.add_noise(clean, 0.2, seed=0)
        t0 = time.perf_counter()
        s = ht.build_halo_train_sample(noisy, clean, BuildConfig(granularity=256, reorder=False),
                                       args.halo_parts, seed=0, devices=[dev] * args.halo_parts)
        host_s = time.perf_counter() - t0
        model = DualGNN(fc_dtype=torch.bfloat16 if fc == "bfloat16" else None, device=dev)
        opt = optim.make_optimizer(cfg, model.parameters())
        fn = ht.make_halo_train_step(model, opt, s.static, cfg.loss_cfg(), cfg.pool_type,
                                     augment=True)
        return (lambda i: fn(s.arrays, i)), (
            f"{args.halo_parts}-part halo step of {noisy.n_faces} faces (table convs), every "
            f"part on {dev}, {fc} heads, host build {host_s:.2f} s")
    from geobignn_tpu_torch.train.trainer import Trainer

    cfg = Config(seed=0, granularity=256, fc_precision=fc)
    host = _sample.whole_sample(args.subdiv, args.batch)
    tr = Trainer(cfg, _sample.stand_in(cfg), None, device=dev)
    sample = host["sample"].to(dev)
    kind = "graphed" if tr.one_dispatch() else "eager"
    return _sample.train_step(tr, sample), (
        f"{kind} step of {args.batch} x {host['noisy'].n_faces} faces (union sample), "
        f"{fc} heads, host build {host['host_s']:.2f} s")


def rows_of(prof, dev) -> list:
    """(name, microseconds) of every kernel the trace recorded on the card,
    the primer's spin kernels left out; on the CPU, every operator's own
    CPU time."""
    if dev.type == "cuda":
        return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
                if str(e.device_type).endswith("CUDA") and "spin" not in e.name
                and e.name not in ANNOTATIONS and not getattr(e, "is_user_annotation", False)]
    return [(e.key, e.self_cpu_time_total) for e in prof.key_averages()
            if e.key not in ANNOTATIONS and e.self_cpu_time_total > 0]


def attribute(rows: list, steps: int, step_ms: float) -> dict:
    """The rows by name and by group, their sum per step against step_ms."""
    by_name, by_group = collections.Counter(), collections.Counter()
    for name, us in rows:
        by_name[name] += us
        by_group[group_of(name)] += us
    busy_ms = sum(by_name.values()) / 1e3 / steps
    return dict(by_name=by_name, by_group=by_group, kernels=len(rows) / steps,
                busy_ms=busy_ms, step_ms=step_ms, busy_share=busy_ms / step_ms,
                idle_ms=step_ms - busy_ms)


def main(argv=None) -> dict:
    ap = _probe.parser(__doc__)
    ap.add_argument("--subdiv", type=int, default=7)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--fc-float32", action="store_true", help="float32 fc heads (not bf16)")
    ap.add_argument("--halo-parts", type=int, default=0)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--trace-dir", default=os.path.join("log", "trace_step"))
    args = ap.parse_args(argv)
    dev = _probe.device_of(args.device)
    from torch.profiler import ProfilerActivity, profile, record_function

    step, what = step_of(args, dev)
    it = itertools.count()
    for _ in range(2):  # the eager warm-up and the capture
        step(next(it))
    _probe.sync(dev)
    cuda = dev.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        if cuda:
            time.sleep(0.05)
            with record_function("primer"):
                for _ in range(PRIMER):
                    torch.cuda._sleep(10)
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
        t0 = time.perf_counter()
        with record_function("traced steps"):
            for _ in range(args.steps):
                step(next(it))
        if cuda:
            end.record()
        _probe.sync(dev)
        host_ms = (time.perf_counter() - t0) * 1e3
        if cuda:
            time.sleep(0.05)
    step_ms = (start.elapsed_time(end) if cuda else host_ms) / args.steps
    att = attribute(rows_of(prof, dev), args.steps, step_ms)
    os.makedirs(args.trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(args.trace_dir, "trace.json"))
    print(f"[trace-step] {_probe.card(dev)}; {what}; {args.steps} steps traced")
    _probe.row("trace-step", step_ms=step_ms, busy_ms=att["busy_ms"], idle_ms=att["idle_ms"],
               busy_share=att["busy_share"], kernels_per_step=att["kernels"],
               groups=len(att["by_group"]), trace=os.path.join(args.trace_dir, "trace.json"))
    for name, us in att["by_group"].most_common(TOP_GROUPS):
        _probe.row("trace-step-group", ms_per_step=us / 1e3 / args.steps, group=name[:120])
    for name, us in att["by_name"].most_common(TOP_KERNELS):
        _probe.row("trace-step-kernel", ms_per_step=us / 1e3 / args.steps, kernel=name[:160])
    return att


if __name__ == "__main__":
    main()
