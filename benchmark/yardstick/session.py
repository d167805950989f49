"""One run of one cell: set-up, the timed window, the traced window, the judgement.

The program is the port, `geobignn_tpu_torch`; this module runs it (the
faults, the program's counters and a configuration's watch reach into it
besides).  Set-up builds the corpus's samples with the program's
`process_one_mesh` (spread over worker processes), one
`Trainer` over them, loads the benchmark's weights into its model, pads and
uploads the feed and, for a training mix, runs whole `run_epoch` calls
until three steps have been taken (the first step runs eagerly and
captures the step's CUDA graph, the later ones replay it); for an eval
mix, one whole `evaluate` pass (which captures the eval graph).  The
window then runs whole `run_epoch` calls or whole `evaluate` passes until
`seconds` have passed; each ends in the program's one sync.  A Recorder
stands in for the per-sample call those make and records which sample
each call took: the work counted is what the calls were given.  With
trace, CUDA events time every step of the window, and a separate traced
window of `traced_passes` epochs or passes follows under torch.profiler.

Once the window has closed and the peak memory has been read, the
program's state is freed and the reference works the judged samples out
again from the raw meshes: host structures, the first three steps that
run_epoch took, or the eval means.

Which code judges a configuration, its configuration file says (paths from
the root of the checkout, each under benchmark/):

  reference  the plain model: param_shapes, precision_of, train_steps,
             eval_means (default benchmark/reference/model.py);
  work       step_useful_flops and step_aggregate_bound_s, as in
             yardstick/work.py (the default);
  watch      "<path>:<function>", optional: function(trainer) returns an
             object whose before(k) and after(k) run around each judged
             call and whose records() (one entry a judged call, in call
             order) reach the reference as `choices=`, one a judged sample.
"""

from __future__ import annotations

import gc
import multiprocessing
import os
import subprocess
import sys
import time

import numpy as np
import torch

from reference import host, judge
from yardstick import cells, imports, meshes, weights
from yardstick.trace import traced

DEFAULT_REFERENCE = "benchmark/reference/model.py"
DEFAULT_WORK = "benchmark/yardstick/work.py"


def _span(store: dict, name: str):
    class _S:
        def __enter__(self):
            self.t = time.perf_counter()

        def __exit__(self, *exc):
            store[name] = store.get(name, 0.0) + time.perf_counter() - self.t
    return _S()


# ---------------------------------------------------------------------------
# the program's host build, spread over worker processes
# ---------------------------------------------------------------------------

def _program_entry(job):
    """process_one_mesh of one (noisy, clean) pair, in a worker."""
    from geobignn_tpu_torch.data.builder import BuildConfig
    from geobignn_tpu_torch.data.dataset import process_one_mesh
    from geobignn_tpu_torch.meshio import TriMesh

    pn, fn, pc, fc, sub_size, bc = job
    return process_one_mesh(TriMesh(pn, fn), sub_size, TriMesh(pc, fc), BuildConfig(**bc))


def _reference_sample(job):
    pn, fn, pc, fc, bc = job
    return host.build(meshes.Mesh(pn, fn), meshes.Mesh(pc, fc), bc)


def _pool_map(fn, jobs, workers: int):
    if workers <= 1 or len(jobs) <= 1:
        return [fn(j) for j in jobs]
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(min(workers, len(jobs))) as pool:
        return pool.map(fn, jobs, chunksize=1)


def cells_traffic(name: str) -> dict:
    from yardstick.cells import BENCH_DIR, read_json
    return read_json(os.path.join(BENCH_DIR, "traffic", name + ".json"))


def default_workers() -> int:
    return max(1, min(6, (os.cpu_count() or 2) - 2))


def build_config_fields(cfg) -> dict:
    import dataclasses
    return dataclasses.asdict(cfg.build_config())


def reference_build_fields(conf: dict) -> dict:
    """The host build's settings, read from the configuration file."""
    c, w = conf["config"], conf["widths"]
    return dict(edge_weight_type=c["edge_weight_type"], wei_param=c["wei_param"],
                preprocess_seed=c["preprocess_seed"], reorder=c["reorder"],
                pool_step=w["pool_step"], n_levels=w["pool_levels"])


def program_config(conf: dict, overrides: dict | None = None):
    """The port's Config of a configuration file, with `overrides`."""
    from geobignn_tpu_torch.config import Config

    return Config(**{**conf["config"], **(overrides or {})})


def judged_by(conf: dict):
    """(reference module, work module, watch factory or None) that the
    configuration file names."""
    ref = cells.load_module(conf.get("reference", DEFAULT_REFERENCE))
    counts = cells.load_module(conf.get("work", DEFAULT_WORK))
    if "watch" not in conf:
        return ref, counts, None
    path, _, fn = conf["watch"].partition(":")
    if not fn:
        raise ValueError(f"watch {conf['watch']!r}: give it as <path>:<function>")
    return ref, counts, getattr(cells.load_module(path), fn)


# ---------------------------------------------------------------------------
# what the harness reads of the program's samples
# ---------------------------------------------------------------------------

def program_structures(entry) -> dict:
    """The host-built arrays of one of the program's raw entries, under the
    names of judge.reference_structures."""
    bv, bf, meta = entry[:3]
    out = {"fv": meta["fv_indices"]}
    if "perm_v" in meta:
        out["perm_v"], out["perm_f"] = meta["perm_v"], meta["perm_f"]
    for b, br in (("v", bv), ("f", bf)):
        out[f"{b}.x"], out[f"{b}.y"] = br.x, br.y
        out[f"{b}.edge_index"], out[f"{b}.edge_weight"] = br.edge_index, br.edge_weight
        for i, s in enumerate(br.specs):
            for k, c in enumerate(s.step_clusters):
                out[f"{b}.s{i}.cluster{k}"] = c
            out[f"{b}.s{i}.unpool"] = s.unpool
            out[f"{b}.s{i}.edge_index"] = s.edge_index
            out[f"{b}.s{i}.edge_weight"] = s.edge_weight
    return out


def level_sizes(br) -> tuple:
    """((real nodes, real edges) of levels 0, 1, 2) of a raw branch."""
    s1, s2 = br.specs
    return ((br.n_nodes, br.edge_index.shape[1]), (s1.n_out, s1.edge_index.shape[1]),
            (s2.n_out, s2.edge_index.shape[1]))


def route(level) -> str:
    """How the program runs a padded level's convs."""
    if level.band is None:
        return "table" if level.nbr is not None else "coo"
    if level.blk_idx is not None:
        return "block-sparse"
    if level.jnodes is not None or level.nbr_b is not None:
        return "hybrid"
    return "banded"


class Recorder:
    """Stands in for the trainer's per-sample call that `run_epoch` or
    `evaluate` makes (`fused_step` or the eager `_step`; the eval graph or
    the eager `_eval_into`) and records what each call was given: the
    sample's index in the feed and the step's rotation seed.  `before(k)`
    runs before the k-th call and `after(k)` after it; the losses of the
    first `judged` steps are kept (on the device); with `events`, CUDA
    events time every call."""

    def __init__(self, trainer, name: str, index: dict):
        self.trainer, self.name, self.index = trainer, name, index
        self.own = name in vars(trainer)  # an attribute, not a method
        self.inner = getattr(trainer, name)
        self.idx, self.seeds, self.bounds = [], [], [0]
        self.losses, self.judged = [], 0
        self.before = self.after = None
        self.events = None
        setattr(trainer, name, self)

    def __call__(self, sample, *rest):
        k = len(self.idx) + 1
        if self.before is not None:
            self.before(k)
        self.idx.append(self.index[id(sample)])
        self.seeds.append(rest[0] if rest else None)
        sums = self.trainer._sums["loss"]
        s0 = sums.clone() if k <= self.judged else None
        if self.events is not None:
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
        out = self.inner(sample, *rest)
        if self.events is not None:
            b.record()
            self.events.append((a, b))
        if s0 is not None:  # the eager step returns its metrics; a replay adds them
            self.losses.append(out["loss"].detach().clone() if isinstance(out, dict)
                               else sums - s0)
        if self.after is not None:
            self.after(k)
        return out

    def close_pass(self) -> None:
        self.bounds.append(len(self.idx))

    def passes_off(self, n: int, train: bool) -> int:
        """The epochs or passes that did not take every sample of the feed
        exactly once (a training epoch: each under a seed of its own)."""
        off = 0
        for lo, hi in zip(self.bounds, self.bounds[1:]):
            if sorted(self.idx[lo:hi]) != list(range(n)):
                off += 1
            elif train and len(set(self.seeds[lo:hi])) != hi - lo:
                off += 1
        return off

    def undo(self) -> None:
        if self.own:
            setattr(self.trainer, self.name, self.inner)
        else:
            delattr(self.trainer, self.name)


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

def run(cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
        t_start: float | None = None, variant: dict | None = None,
        workers: int | None = None, log=print, cache: dict | None = None) -> dict:
    """One run of `cell`; returns the result (without the import check).

    For the control script and the tests: `variant` {"config": Config
    overrides, "plant": fn(trainer) -> undo, called once the trainer is
    made}; `cache`, a dict kept across runs of one cell, reuses the host
    builds of a seed."""
    from geobignn_tpu_torch.data.dataset import BaseDualDataset
    from geobignn_tpu_torch.train.trainer import Trainer

    t_start = time.perf_counter() if t_start is None else t_start
    variant = variant or {}
    workers = default_workers() if workers is None else workers
    conf, traffic = cell.config, cell.traffic
    widths = conf["widths"]
    train = traffic["mode"] == "train"
    on_card = torch.device(device).type == "cuda"
    spans: dict = {"before_run_s": time.perf_counter() - t_start}
    if on_card:
        torch.cuda.reset_peak_memory_stats()

    # ---- set-up: the corpus and its host build ---------------------------
    ref_model, counts, watch_of = judged_by(conf)
    cfg = program_config(conf, variant.get("config"))
    bc = build_config_fields(cfg)
    cache = {} if cache is None else cache
    # an eval mix may name the training mix whose padded plan it shares
    # (`plan_with`): its samples are built too, and only pad the plan
    plan_traffic = cells_traffic(traffic["plan_with"]) if "plan_with" in traffic else None
    with _span(spans, "host_build_s"):
        if (seed, "program") not in cache:
            corpus = meshes.corpus(traffic, seed)
            extra = meshes.corpus(plan_traffic, seed) if plan_traffic else []
            jobs = [(n.points, n.fv_indices, c.points, c.fv_indices, cfg.sub_size, bc)
                    for n, c, _ in corpus + extra]
            cache[(seed, "program")] = corpus, _pool_map(_program_entry, jobs, workers)
        corpus, built = cache[(seed, "program")]
    if any(len(e) != 1 for e in built):
        raise ValueError("a mesh of the corpus was split into patches: "
                         "the configuration's sub_size must hold every mesh whole")
    entries = [e[0] for e in built[: len(corpus)]]
    plan_entries = [e[0] for e in built[len(corpus):]]

    class Corpus(BaseDualDataset):
        def __init__(self, samples):
            self.build_cfg = cfg.build_config()
            self.entries = samples
            self._compute_plan(self.build_cfg.granularity)

    t_trainer = time.perf_counter()
    ds = Corpus(entries)
    train_ds = Corpus(plan_entries) if plan_entries else ds
    trainer = Trainer(cfg, train_ds, None if train else ds, device=device)
    w0 = weights.make(ref_model.param_shapes(widths), seed, device)
    trainer.model.load_state_dict(w0, strict=True)
    undo = variant["plant"](trainer) if "plant" in variant else None
    watch = watch_of(trainer) if watch_of is not None else None
    tag = "t" if train else "e"
    names = dict((p, n) for n, p in trainer.model.named_parameters())
    spans["trainer_s"] = time.perf_counter() - t_trainer

    # ---- set-up: the feed, then the first epochs (train) or pass (eval) --
    t_first = time.perf_counter()
    feed = [trainer._get(ds, tag, idx) for idx in range(len(ds))]  # padded, on the device
    real_f = [e[1].n_nodes for e in entries]
    sizes = [(level_sizes(e[0]), level_sizes(e[1])) for e in entries]
    flops_of = [counts.step_useful_flops(sv, sf, widths, train) for sv, sf in sizes]
    opb = 2 if conf.get("aggregate_operands", "bfloat16") == "bfloat16" else 4
    bound_of = [counts.step_aggregate_bound_s(
        sv, sf, [lv.band is not None for lv in s.v.levels],
        [lv.band is not None for lv in s.f.levels], widths, train, opb)
        for (sv, sf), s in zip(sizes, feed)]
    if train:
        call = "fused_step" if trainer.one_dispatch() else "_step"
    else:
        call = "_eval_program" if on_card else "_eval_into"
    rec = Recorder(trainer, call, {id(s): i for i, s in enumerate(feed)})
    watched = 3 if train else len(feed)  # the judged steps, or the set-up pass

    def watching(k, when):
        if watch is not None and k <= watched:
            getattr(watch, when)(k)
    rec.before = lambda k: watching(k, "before")
    rec.after = lambda k: watching(k, "after")
    # the positions and normals of the first forward, which runs eagerly (the
    # capture's warm-up), read by a hook that records nothing into a graph
    seen = []

    def keep(module, inputs, out):
        if not seen and not (on_card and torch.cuda.is_current_stream_capturing()):
            seen.append(tuple(o.detach().float().clone() for o in out))
    hook = trainer.model.register_forward_hook(keep)
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 11]))
    first: dict = {}
    if train:
        # the first three steps that run_epoch dispatches are judged: the
        # gradient as Adam got it after the first, the change after the third
        beta1 = trainer.optimizer.param_groups[0]["betas"][0]

        def grads():
            out = {}
            for p, name in names.items():
                st = trainer.optimizer.state.get(p, {})
                g = st["exp_avg"] / (1 - beta1) if "exp_avg" in st else torch.zeros(())
                out[name] = float(torch.linalg.vector_norm(g.float()))
            return out

        def before(k):
            if k == 2 and "grad" not in first:
                first["grad"] = grads()
            if k == 4 and "change" not in first:
                first["change"] = changes()
            watching(k, "before")

        def changes():
            return {n: float(torch.linalg.vector_norm(p.detach().float() - w0[n]))
                    for p, n in names.items()}
        rec.before, rec.judged = before, 3
        while len(rec.idx) < 3:
            trainer.run_epoch(rng)
            rec.close_pass()
        first.setdefault("grad", grads())
        first.setdefault("change", changes())
        first["losses"] = [float(v) for v in rec.losses]
        first["rot_seeds"] = rec.seeds[:3]
        answers = []
    else:
        answers = [trainer.evaluate()]
        rec.close_pass()
    hook.remove()
    rec.before = rec.after = None
    if on_card:
        torch.cuda.synchronize()
    spans["first_pass_s"] = time.perf_counter() - t_first
    spans["setup_s"] = time.perf_counter() - t_start
    judged = rec.idx[:3] if train else []

    # ---- what the window's work is ---------------------------------------
    padded_f = trainer.plan.f.n1
    routes = {}
    for s in feed:
        r = (tuple(route(lv) for lv in s.v.levels), tuple(route(lv) for lv in s.f.levels))
        routes[r] = routes.get(r, 0) + 1
    kinds: dict = {}
    for (rv, rf), n in routes.items():
        for k in rv + rf:
            kinds[k] = kinds.get(k, 0) + n
    log(f"[levels] {len(ds)} samples, levels by route (samples x levels): "
        + ", ".join(f"{k} {v}" for k, v in sorted(kinds.items()))
        + f"; distinct route sets {len(routes)}; padded plan v {trainer.plan.v.n1} f {padded_f}",
        file=sys.stderr)
    del feed

    # ---- the window ----------------------------------------------------
    # what is counted is what the window's calls were given
    def one_pass():
        if train:
            trainer.run_epoch(rng)
        else:
            answers.append(trainer.evaluate())
        rec.close_pass()

    at = len(rec.idx)
    if trace and on_card and train:
        rec.events = []
    passes, pass_s = 0, []
    t0 = time.perf_counter()
    while True:
        one_pass()
        passes += 1
        pass_s.append(time.perf_counter() - t0)
        if pass_s[-1] >= seconds:
            break
    spans["window_s"] = pass_s[-1]
    spans["pass_ends_s"] = pass_s
    window = rec.idx[at:]
    events, rec.events = rec.events or [], None
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0

    counters = dict(passes=passes, samples=len(ds), steps=len(window),
                    faces=sum(real_f[i] for i in window),
                    padded_faces=padded_f * len(window),
                    useful_flops=sum(flops_of[i] for i in window))
    if events:
        counters["step_ms"] = [a.elapsed_time(b) for a, b in events]

    tr = None
    if trace:
        k = int(traffic.get("traced_passes", 1))
        at = len(rec.idx)
        tr = traced(lambda: [one_pass() for _ in range(k)])
        counters["traced_agg_bound_s"] = sum(bound_of[i] for i in rec.idx[at:])
    passes_off = rec.passes_off(len(ds), train)
    rec.undo()
    records = watch.records() if watch is not None else None
    del watch

    # ---- the judgement: free the program, then the reference -------------
    prog_struct = {i: program_structures(entries[i])
                   for i in (set(judged) if train else range(len(entries)))}
    if undo is not None:
        undo()
    del trainer, ds, train_ds, entries, plan_entries, built
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    rbc = reference_build_fields(conf)
    idx_ref = sorted(set(judged)) if train else list(range(len(corpus)))
    if (seed, "reference") not in cache:
        cache[(seed, "reference")] = dict(zip(idx_ref, _pool_map(_reference_sample, [
            (corpus[i][0].points, corpus[i][0].fv_indices, corpus[i][1].points,
             corpus[i][1].fv_indices, rbc) for i in idx_ref],
            workers if len(idx_ref) > 3 else 1)))
    ref_samples = [cache[(seed, "reference")][i] for i in (judged if train else idx_ref)]
    mine = {}
    if records is not None:  # one a judged call; the reference's come in sample order
        by_sample = dict(zip(rec.idx, records))
        mine["choices"] = records[:3] if train else [by_sample.get(i) for i in idx_ref]
    bad = []
    for i in idx_ref:
        bad += [f"{corpus[i][2]}:{k}" for k in judge.host_mismatch(
            prog_struct[i], judge.reference_structures(cache[(seed, "reference")][i]))[1]]
    numbers = {"host_mismatch": len(bad), "passes_off": passes_off}
    if bad:
        log("[host] differing arrays: " + ", ".join(bad[:20]), file=sys.stderr)
    prec = ref_model.precision_of(conf)
    if train:
        ref_losses, ref_g, ref_p, ref_out = ref_model.train_steps(
            w0, ref_samples, first["rot_seeds"], widths, conf["config"]["lr"], device, prec,
            **mine)
        numbers.update(judge.train_numbers(first["losses"], first["grad"], first["change"],
                                           ref_losses, ref_g, w0, ref_p))
        numbers.update(judge.forward_numbers(seen[0], ref_out))
        numbers["losses"] = first["losses"]
        numbers["ref_losses"] = ref_losses
    else:
        ref, ref_out = ref_model.eval_means(w0, ref_samples, widths, device, prec, **mine)
        numbers.update(judge.eval_numbers(answers, ref))
        numbers.update(judge.forward_numbers(seen[0], ref_out))
    correct, checks = judge.verdict(numbers, cell.limits)

    return dict(spans=spans, counters=counters, trace=tr, numbers=numbers, correct=correct,
                checks=checks, memory_peak=memory_peak, routes=kinds,
                mode=traffic["mode"], power=_power_limit() if on_card else "cpu")


def forbidden() -> list:
    return imports.forbidden_loaded()
