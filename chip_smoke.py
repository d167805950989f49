#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (geobignn_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its lines; any failure raises and the script exits
non-zero without the final result line:

  1. the card (nvidia-smi name and power limit); no CUDA device -> exit 2;
  2. build: the banded kernels (csrc/banded_fwd.cu and csrc/banded_bwd.cu,
     one nvcc each for sm_90a, started together) and the native mesh
     library, timed;
  3. the serving path: Predictor with Config() defaults and seeded random
     weights denoises add_noise(icosphere(5), 0.2, seed=0) — 20,480 faces
     in 2 patches — through predict_dir's body (60 update iterations,
     `{name}-60.obj` written to a temp dir).  Launch counts are zeroed just
     before and read just after; one mesh must launch the aggregate-first
     kernel 18 times and the transform-first kernel 20 times, and no
     backward kernel.  Wall time of the mesh after a warm-up mesh; the host
     build, one patch's forward and the update loop timed apart;
  4. the same predict_mesh with device="cpu" (plain PyTorch versions)
     against the GPU run;
  5. every forward kernel against its plain version on the card, on the
     inputs the serving path gave it (recorded during the warm-up), timed
     with CUDA events, with its bound;
  6. the training path at the default model's full width: an
     InMemoryDataset of two (noisy, clean) icosphere(5) pairs (noise seeds
     0 and 6) split into 4 patches of 20,000 faces.  One recorded step on
     one patch must launch 9 / 10 forward and 9 / 10 backward kernels
     (aggregate-first / transform-first); the gradient of every parameter
     on the card against the CPU's plain backward on the same weights; ms
     per training step; 20 steps on one patch must lower its loss; then
     the main path, Trainer(Config(seed=0, max_epoch=2)).fit() — counts
     zeroed just before, read just after — with per-epoch loss, s/step and
     edges/s; and each backward kernel against its plain backward on the
     inputs the path gave it (with a seeded gout), timed, with its bound;
  7. one JSON line of the kernels, then the result line.

Tolerances: kernel vs plain on identical inputs, bf16 compute: 2e-2 of
max|out| (both round the same operands to bf16, but a D summed in another
order can round an operand to the neighbouring bf16 value, 2^-8 relative);
float32 compute: 1e-4 of max|out| (summation order only); for the backward,
per cotangent.  GPU vs CPU prediction: positions within 2e-2 of the mean
edge length, unit normals within 5e-2 (bf16 differences carried through 16
convs and the bf16 heads; the JAX package's own banded-vs-table model test
uses 2e-2 / 5e-2).  GPU vs CPU parameter gradients, Config defaults (bf16
aggregate operands and heads): every tensor but the convs' `u` within 5e-2
of its max|g| and at a cosine of at least 0.99 — `u`'s gradient is a small
difference of large terms, so bf16 rounding, which differs between the two
runs, dominates it (tests/test_torch_grads.py finds the same against JAX);
so the same comparison in float32 compute holds every tensor, `u`
included, within 1e-3 of its max|g| (float32 sums in another order).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

H100_BF16_FLOPS = 989e12  # dense tensor-core peak, SXM at 700 W
H100_BYTES_PER_S = 3.35e12  # HBM3
BF16_TOL, F32_TOL = 2e-2, 1e-4
POS_TOL_MEL, NORMAL_TOL = 2e-2, 5e-2
EXPECTED_LAUNCHES = {"aggregate_first": 18, "transform_first": 20,
                     "aggregate_first_bwd": 0, "transform_first_bwd": 0}
# one training step on one patch: 8 convs of each schedule, plus the facet
# level-1 boundary sub-band (one aggregate-first conv, two transform-first)
STEP_LAUNCHES = {"aggregate_first": 9, "transform_first": 10,
                 "aggregate_first_bwd": 9, "transform_first_bwd": 10}
TPU_KERNEL = {  # file:line of the TPU kernel each CUDA kernel replaces
    "aggregate_first": "geobignn_tpu/ops/banded_pallas.py:220",
    "transform_first": "geobignn_tpu/ops/banded_pallas.py:104",
    "aggregate_first_bwd": "geobignn_tpu/ops/banded_pallas.py:241",
    "transform_first_bwd": "geobignn_tpu/ops/banded_pallas.py:141",
}
SOURCE = {"aggregate_first": "geobignn_tpu_torch/csrc/banded_fwd.cu",
          "transform_first": "geobignn_tpu_torch/csrc/banded_fwd.cu",
          "aggregate_first_bwd": "geobignn_tpu_torch/csrc/banded_bwd.cu",
          "transform_first_bwd": "geobignn_tpu_torch/csrc/banded_bwd.cu"}
# noise seeds of the training meshes: the first pair whose patches all keep
# the serving mesh's levels and tiles (with seeds 1 and 2 one patch bands
# facet level 1 at tile 384 while the other needs the hybrid, and
# TableWidths.merge sends that level to the block-sparse path, kernels
# #5/#6, for every sample)
TRAIN_SEEDS = (0, 6)


def _cuda_ms(fn, reps, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _work(r, p, x, w, m, tf):
    """(bytes, operations this run's data needs, operations counted densely
    over the window as the TPU wrapper's cost estimate does)."""
    n, c_in = x.shape
    heads, c_out = r.shape[1], w.shape[2]
    win = m.shape[2]
    k = heads * (c_out if tf else c_in)
    nnz = int(m.count_nonzero())
    byts = 4 * (r.numel() + p.numel() + x.numel() + w.numel() + n * c_out) + m.numel()
    ops = 2 * nnz * (heads + k) + n * k  # D and A·V over the set slots; r scale
    if tf:
        ops += 2 * n * heads * c_out * c_in + n * k  # W2 x; head sum
    else:
        ops += n * k + 2 * n * k * c_out  # p x; W contraction
    if tf:
        dense = 2 * n * win * (heads * (c_out + 1) + heads * c_in / 3)
    else:
        dense = 2 * n * win * (heads * (c_in + 1) + heads * c_out / 3)
    return byts, ops, int(dense)


def _work_bwd(r, p, x, w, m, tf):
    """(bytes, operations this run's data needs, dense operations) of the
    backward: inputs r, p, x, w, m, gout and outputs r̄, p̄, x̄ and the
    per-block W̄ partials, each moved once; per set mask slot D, the window
    products z, K and a, and the r̄ / p̄ denominator parts, plus the per-node
    products; densely, the five window products of _bwd_kernel over the
    whole 3T window and the two C_out (or C_in) products."""
    n, c_in = x.shape
    heads, c_out = r.shape[1], w.shape[2]
    n_blk, _, win = m.shape
    cv = c_out if tf else c_in
    kk = heads * cv
    cr = c_in if tf else c_out
    nnz = int(m.count_nonzero())
    byts = (4 * (r.numel() + p.numel() + x.numel() + w.numel() + n * c_out)
            + m.numel() + 4 * (2 * n * heads + n * c_in + n_blk * kk * cr))
    ops = nnz * (6 * kk + 6 * heads)
    if tf:  # Y, V, G, gz*z, y*a, yb, x̄ = yb W2, W̄ = yb^T x
        ops += n * (2 * kk * c_in + 8 * kk + 2 * kk * c_in) + 2 * n * kk * c_in
        dense = 2 * n * win * (3 * kk + 3 * heads) + 3 * 2 * 3 * n * kk * c_in
    else:  # V, gy, G, zr, gy*z, x̄, p̄ direct, W̄ = zr^T gout
        ops += n * (9 * kk + 2 * kk * c_out) + 2 * n * kk * c_out
        dense = 2 * n * win * (3 * kk + 3 * heads) + 4 * n * kk * c_out
    return byts, ops, int(dense)


def _bound_ms(byts, ops):
    t_b, t_o = byts / H100_BYTES_PER_S, ops / H100_BF16_FLOPS
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def _kernel_entry(name, rows, calls_key, launches):
    """One entry of the kernels JSON line: times and bound summed over the
    launches of one mesh (forward) or one training step (backward)."""
    per = lambda f: sum(r[calls_key] * r[f] for r in rows)
    t_bytes = per("bytes") / H100_BYTES_PER_S
    t_ops = per("ops") / H100_BF16_FLOPS
    return {
        "name": f"banded_aggregate_{name}",
        "route": "cuda",
        "source": SOURCE[name],
        "replaces": TPU_KERNEL[name],
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": per("ms"),
        "plain_ms": per("plain_ms"),
        "bound_ms": per("bound_ms"),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
    }


def _grad_agreement(model_a, model_b):
    """{parameter: (max|ga - gb| / max|gb|, cosine of ga and gb)} over two
    models' .grad."""
    grads_b = dict(model_b.named_parameters())
    out = {}
    for k, pa in model_a.named_parameters():
        a = pa.grad.detach().double().cpu()
        b = grads_b[k].grad.detach().double().cpu()
        cos = float((a * b).sum()) / max(float(a.norm() * b.norm()), 1e-300)
        out[k] = (float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30), cos)
    return out


def train_phase(torch, np, kind):
    """Phase 6: the training path on the card.  Returns the backward kernels'
    rows and the launch counts of the main path (Trainer.fit)."""
    from geobignn_tpu_torch.config import Config
    from geobignn_tpu_torch.data import dataset, synth
    from geobignn_tpu_torch.models.dual_gnn import DualGNN
    from geobignn_tpu_torch.ops import banded_cuda
    from geobignn_tpu_torch.train.trainer import Trainer, _metrics_of

    cfg = Config(seed=0, max_epoch=2)
    clean = synth.icosphere(5)
    t0 = time.perf_counter()
    train_ds = dataset.InMemoryDataset(
        [(synth.add_noise(clean, 0.2, seed=s), clean) for s in TRAIN_SEEDS],
        cfg.build_config(), submesh_size=cfg.sub_size)
    host_s = time.perf_counter() - t0
    n_faces = [int(e[1].n_nodes) for e in train_ds.entries]
    print(f"[train] {len(train_ds)} patches of {n_faces} faces from noise seeds "
          f"{TRAIN_SEEDS}; host build {host_s:.3f} s; real edge messages per "
          f"step {train_ds.messages_per_sample().tolist()}")
    assert len(train_ds) == 4 and max(n_faces) <= cfg.sub_size

    # one recorded step on one patch: launches per step, inputs of the
    # backward kernels at the path's shapes
    probe = Trainer(cfg.with_updates(augment=False), train_ds, None, device="cuda")
    s0 = probe._get(train_ds, "t", 0)
    captured: dict = {}
    wrapper = banded_cuda.banded_aggregate_bwd

    def recording(r, p, x, w, m, gout, compute_dtype=torch.bfloat16):
        tf = banded_cuda.use_transform_first(x.shape[1], w.shape[2])
        key = ("transform_first_bwd" if tf else "aggregate_first_bwd",
               x.shape[0], m.shape[1], x.shape[1], w.shape[2])
        ent = captured.setdefault(key, {
            "args": [t.detach().clone() for t in (r, p, x, w, m)],
            "gout_shape": tuple(gout.shape), "cd": compute_dtype, "calls": 0})
        ent["calls"] += 1
        return wrapper(r, p, x, w, m, gout, compute_dtype)

    banded_cuda.reset_launches()
    banded_cuda.banded_aggregate_bwd = recording
    try:
        probe._step(s0, 0)
        probe._apply(1)
    finally:
        banded_cuda.banded_aggregate_bwd = wrapper
    torch.cuda.synchronize()
    step_launches = dict(banded_cuda.LAUNCHES)
    print(f"[train] one step on one patch: launches {step_launches}")
    assert step_launches == STEP_LAUNCHES, step_launches

    # the gradient of every parameter on the card against the CPU's plain
    # backward, on the same weights and sample: with the Config defaults
    # (bf16 aggregate operands and heads), and with both in float32
    s0_cpu = train_ds.get(0, probe.plan).to("cpu")
    agg = banded_cuda.banded_aggregate
    for label in ("bfloat16", "float32"):
        f32 = label == "float32"
        if f32:
            banded_cuda.banded_aggregate = (
                lambda r, p, x, w, m, compute_dtype=None:
                agg(r, p, x, w, m, torch.float32))
        try:
            models, losses_, secs = [], [], []
            for dev, smp in (("cuda", s0), ("cpu", s0_cpu)):
                mdl = DualGNN(fc_dtype=None if f32 else torch.bfloat16, device=dev)
                mdl.load_state_dict(probe.model.state_dict())
                t0 = time.perf_counter()
                loss = _metrics_of(*mdl(smp), smp, cfg)[0]
                loss.backward()
                losses_.append(float(loss.detach()))
                secs.append(time.perf_counter() - t0)
                models.append(mdl)
        finally:
            banded_cuda.banded_aggregate = agg
        stats = _grad_agreement(*models)
        not_u = {k: v for k, v in stats.items() if not k.endswith(".u")}
        worst = max(not_u, key=lambda k: not_u[k][0])
        worst_all = max(stats, key=lambda k: stats[k][0])
        min_cos = min(not_u, key=lambda k: not_u[k][1])
        min_cos_u = min(v[1] for k, v in stats.items() if k.endswith(".u"))
        print(f"[train] gradients GPU vs CPU plain backward, {label} compute, one "
              f"patch: loss {losses_[0]:.6f} vs {losses_[1]:.6f}; worst tensor "
              f"{worst_all} {stats[worst_all][0]:.3e} of its max|g|, u aside "
              f"{worst} {not_u[worst][0]:.3e}; smallest cosine u aside {min_cos} "
              f"{not_u[min_cos][1]:.6f}, of the u {min_cos_u:.6f}; CPU forward+"
              f"backward {secs[1]:.2f} s")
        if f32:  # every tensor, u included: float32 sums in another order
            assert abs(losses_[0] - losses_[1]) <= 1e-5 * abs(losses_[1])
            assert stats[worst_all][0] <= 1e-3
        else:  # u's gradient is noise-dominated in bf16 (see the docstring)
            assert abs(losses_[0] - losses_[1]) <= 1e-2 * abs(losses_[1])
            assert not_u[worst][0] <= 5e-2 and not_u[min_cos][1] >= 0.99

    def one_step():
        probe._step(s0, 0)
        probe._apply(1)

    step_ms = _cuda_ms(one_step, reps=5)
    print(f"[train] one training step (forward, backward, Adam) on one "
          f"20,000-face patch: {step_ms:.3f} ms (CUDA events, after warm-up)")

    # 20 steps on one patch lower its loss
    over = Trainer(cfg.with_updates(augment=False), train_ds, None, device="cuda")
    o0 = over._get(train_ds, "t", 0)
    hist = []
    for _ in range(20):
        hist.append(float(over._step(o0, 0)["loss"].detach()))
        over._apply(1)
    print(f"[train] overfit one patch, 20 steps: loss {hist[0]:.5f} -> "
          f"{hist[-1]:.5f} (min {min(hist):.5f})")
    assert np.isfinite(hist).all() and hist[-1] < hist[0]

    # the main path: Trainer(Config(seed=0, max_epoch=2)).fit()
    tr = Trainer(cfg, train_ds, None, device="cuda")
    epochs = []

    def report(t, m, _):
        epochs.append(m)
        print(f"[train] epoch {t.epoch}: loss {m['loss']:.5f} (v {m['loss_v']:.5f}, "
              f"f {m['loss_f']:.5f}) error_f {m['error_f']:.4f} deg; "
              f"{1.0 / m['samples_per_s']:.4f} s/step; edges/s {m['edges_per_s']:.4e}")

    banded_cuda.reset_launches()
    t0 = time.perf_counter()
    best = tr.fit(on_epoch=report)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = dict(banded_cuda.LAUNCHES)
    n_steps = cfg.max_epoch * len(train_ds)
    print(f"[train] fit: {cfg.max_epoch} epochs x {len(train_ds)} steps in "
          f"{fit_s:.3f} s; best error_f {best:.4f}; launches {launches}")
    assert launches == {k: n_steps * v for k, v in STEP_LAUNCHES.items()}, launches
    assert len(epochs) == cfg.max_epoch
    assert all(np.isfinite([m[k] for k in ("loss", "loss_v", "loss_f", "error_v",
                                            "error_f")]).all() for m in epochs)

    # each backward kernel against its plain backward
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for key in sorted(captured):
        ent = captured[key]
        name = key[0]
        gout = torch.randn(ent["gout_shape"], device="cuda", generator=gen)
        args = [*ent["args"], gout]
        tf = name == "transform_first_bwd"
        res = {}
        for cd in (ent["cd"], torch.float32):
            got = banded_cuda.banded_aggregate_bwd(*args, compute_dtype=cd)
            torch.cuda.synchronize()
            ref = banded_cuda.banded_aggregate_bwd_plain(*args, compute_dtype=cd)
            abs_err = [float((g - r_).abs().max()) for g, r_ in zip(got, ref)]
            rel = [a / max(float(r_.abs().max()), 1e-30) for a, r_ in zip(abs_err, ref)]
            res[cd] = (max(abs_err), max(rel))
        cd = ent["cd"]
        ms = _cuda_ms(lambda: banded_cuda.banded_aggregate_bwd(*args, compute_dtype=cd), 10)
        plain_ms = _cuda_ms(
            lambda: banded_cuda.banded_aggregate_bwd_plain(*args, compute_dtype=cd), 3)
        byts, ops, dense = _work_bwd(*args[:5], tf)
        bound, by = _bound_ms(byts, ops)
        dense_bound, _ = _bound_ms(byts, dense)
        n, c_in = args[2].shape
        row = dict(kernel=name, n=n, tile=args[4].shape[1], c_in=c_in,
                   c_out=args[3].shape[2], calls_per_step=ent["calls"],
                   max_abs_err=res[cd][0], rel_err=res[cd][1],
                   rel_err_f32=res[torch.float32][1], ms=ms, plain_ms=plain_ms,
                   bound_ms=bound, bound_by=by, dense_bound_ms=dense_bound,
                   bytes=byts, ops=ops, dense_ops=dense)
        print("[kernel-bwd] " + json.dumps(row))
        assert res[cd][1] <= BF16_TOL and res[torch.float32][1] <= F32_TOL, row
        rows.append(row)
    for name in ("aggregate_first_bwd", "transform_first_bwd"):
        assert sum(r["calls_per_step"] for r in rows if r["kernel"] == name) \
            == STEP_LAUNCHES[name]
    per_step = {name: sum(r["calls_per_step"] * r["ms"] for r in rows
                          if r["kernel"] == name) for name in STEP_LAUNCHES
                if name.endswith("_bwd")}
    print(f"[train] backward kernels per step: "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in per_step.items())
          + f" of a {step_ms:.3f} ms step; card {kind}")
    return {"rows": rows, "launches": launches}


def main() -> int:
    import torch

    # 1. the card ---------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    kind = torch.cuda.get_device_name(0)
    print(f"[card] {kind}; torch {torch.__version__} cuda {torch.version.cuda}; "
          f"python {sys.version.split()[0]}")

    import numpy as np

    from geobignn_tpu_torch import geometry, meshio, native
    from geobignn_tpu_torch.config import Config
    from geobignn_tpu_torch.data import synth
    from geobignn_tpu_torch.infer import predict
    from geobignn_tpu_torch.models.dual_gnn import DualGNN
    from geobignn_tpu_torch.ops import banded_cuda

    # 2. build --------------------------------------------------------------
    secs = banded_cuda.build(force=True)
    ptxas = [ln.strip() for ln in banded_cuda.BUILD_LOG.splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"[build] nvcc {sorted(banded_cuda.SOURCES.values())} -> sm_90a "
          f"(in parallel) in {secs:.2f} s")
    for ln in ptxas:
        print(f"[build] {ln}")
    t0 = time.perf_counter()
    has_native = native.has_native()
    print(f"[build] native mesh library: {has_native} ({time.perf_counter() - t0:.2f} s)")

    # 3. the main path --------------------------------------------------------
    mesh = synth.add_noise(synth.icosphere(5), 0.2, seed=0)
    assert mesh.n_faces == 20480, mesh.n_faces
    cfg = Config()
    state = DualGNN(fc_dtype=torch.bfloat16, device="cpu", seed=0).state_dict()
    pred = predict.Predictor(cfg, state, device="cuda")

    captured: dict = {}
    wrapper = banded_cuda.banded_aggregate

    def recording(r, p, x, w, m, compute_dtype=torch.bfloat16):
        tf = banded_cuda.use_transform_first(x.shape[1], w.shape[2])
        key = ("transform_first" if tf else "aggregate_first",
               x.shape[0], m.shape[1], x.shape[1], w.shape[2])
        ent = captured.setdefault(key, {
            "args": [t.detach().clone() for t in (r, p, x, w, m)],
            "cd": compute_dtype, "calls": 0})
        ent["calls"] += 1
        return wrapper(r, p, x, w, m, compute_dtype)

    with tempfile.TemporaryDirectory() as root:
        data = os.path.join(root, cfg.data_type, "test")
        os.makedirs(os.path.join(data, "noisy"))
        os.makedirs(os.path.join(data, "original"))
        clean = synth.icosphere(5)
        meshio.write_obj(os.path.join(data, "noisy", "ball_n1.obj"),
                         mesh.points, mesh.fv_indices)
        meshio.write_obj(os.path.join(data, "original", "ball.obj"),
                         clean.points, clean.fv_indices)

        banded_cuda.banded_aggregate = recording  # warm-up mesh, recorded
        try:
            predict.predict_dir_body(pred, dataset_root=root)
        finally:
            banded_cuda.banded_aggregate = wrapper
        torch.cuda.synchronize()

        banded_cuda.reset_launches()
        t0 = time.perf_counter()
        res = predict.predict_dir_body(pred, dataset_root=root)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(banded_cuda.LAUNCHES)
        print(f"[main] one mesh ({mesh.n_faces} faces, 2 patches, 60 update iterations): "
              f"{wall:.3f} s wall; launches {launches}")
        assert launches == EXPECTED_LAUNCHES, launches
        out = meshio.read_obj(os.path.join(res["result_dir"], "ball_n1-60.obj"))
        assert out.n_faces == mesh.n_faces and out.n_vertices == mesh.n_vertices
        assert np.isfinite(out.points).all()
        assert np.isfinite([res["angle_mean1"], res["angle_mean2"]]).all()
        print(f"[main] wrote {out.n_vertices} vertices; angle1 "
              f"{res['angle_mean1']:.4f} angle2 {res['angle_mean2']:.4f} "
              f"(random weights)")

    # host build, forward of one patch and the update loop, timed apart
    t0 = time.perf_counter()
    mem = pred.patch_dataset(mesh)
    assert len(mem.entries) == 2, len(mem.entries)
    samples = [mem.get(i) for i in range(len(mem.entries))]
    host_s = time.perf_counter() - t0
    sample = samples[0].to("cuda")
    with torch.no_grad():
        fwd_ms = _cuda_ms(lambda: pred.model(sample), reps=5)
    vp0, np0 = pred.predict_mesh(mesh)
    upd = [torch.from_numpy(a).to("cuda") for a in (
        vp0, mesh.fv_indices.astype(np.int64), mesh.vf_indices.astype(np.int64), np0)]
    upd_ms = _cuda_ms(lambda: predict.update_positions(*upd, n_iter=60), reps=3)
    print(f"[main] host build of both patches (split, graphs, hierarchies, "
          f"tables, bands): {host_s:.3f} s; DualGNN forward of one patch: "
          f"{fwd_ms:.3f} ms; 60 update iterations: {upd_ms:.3f} ms")

    # 4. GPU vs CPU ------------------------------------------------------------
    vp_g, n_g = vp0, np0
    t0 = time.perf_counter()
    vp_c, n_c = predict.Predictor(cfg, state, device="cpu").predict_mesh(mesh)
    cpu_s = time.perf_counter() - t0
    mel = geometry.mean_edge_length_np(mesh.points, mesh.ev_indices)
    e_pos = float(np.abs(vp_g - vp_c).max()) / mel
    e_n = float(np.abs(n_g - n_c).max())
    print(f"[cpu] plain-version predict_mesh {cpu_s:.2f} s; GPU vs CPU: positions "
          f"{e_pos:.3e} mean edge lengths (tol {POS_TOL_MEL}), normals {e_n:.3e} "
          f"(tol {NORMAL_TOL})")
    assert np.isfinite(vp_g).all() and np.isfinite(n_g).all()
    assert e_pos <= POS_TOL_MEL and e_n <= NORMAL_TOL

    # 5. kernels against their plain versions --------------------------------
    def check(name, args, cd, calls):
        tf = name == "transform_first"
        got = banded_cuda.banded_aggregate(*args, compute_dtype=cd)
        torch.cuda.synchronize()
        ref = banded_cuda.banded_aggregate_plain(*args, compute_dtype=cd)
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        got32 = banded_cuda.banded_aggregate(*args, compute_dtype=torch.float32)
        ref32 = banded_cuda.banded_aggregate_plain(*args, compute_dtype=torch.float32)
        err32 = float((got32 - ref32).abs().max()) / float(ref32.abs().max())
        ms = _cuda_ms(lambda: banded_cuda.banded_aggregate(*args, compute_dtype=cd), 20)
        plain_ms = _cuda_ms(lambda: banded_cuda.banded_aggregate_plain(*args, compute_dtype=cd), 3)
        byts, ops, dense = _work(*args, tf)
        bound, by = _bound_ms(byts, ops)
        dense_bound, _ = _bound_ms(byts, dense)
        n, c_in = args[2].shape
        row = dict(kernel=name, n=n, tile=args[4].shape[1], c_in=c_in,
                   c_out=args[3].shape[2], calls_per_mesh=calls, max_abs_err=err,
                   rel_err=err / scale, rel_err_f32=err32, ms=ms, plain_ms=plain_ms,
                   bound_ms=bound, bound_by=by, dense_bound_ms=dense_bound,
                   bytes=byts, ops=ops, dense_ops=dense)
        print("[kernel] " + json.dumps(row))
        assert err <= BF16_TOL * scale, row
        assert err32 <= F32_TOL, row
        return row

    rows = []
    for key in sorted(captured):
        ent = captured[key]
        rows.append(check(key[0], ent["args"], ent["cd"], ent["calls"]))
    # 128 -> 128 at T=256 as well (the path runs that width only at T=128)
    r_, p_, x_, w_, m_ = next(e["args"] for k, e in sorted(captured.items())
                              if k[0] == "aggregate_first" and k[2] == 256)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x128 = torch.randn((x_.shape[0], 128), device="cuda", generator=gen)
    w128 = torch.randn((9, 128, 128), device="cuda", generator=gen) * 0.05
    check("aggregate_first", [r_, p_, x128, w128, m_], torch.bfloat16, 0)
    assert {r["kernel"] for r in rows} == {"aggregate_first", "transform_first"}
    assert sum(r["calls_per_mesh"] for r in rows if r["kernel"] == "aggregate_first") \
        == EXPECTED_LAUNCHES["aggregate_first"]

    # 6. training ---------------------------------------------------------------
    train = train_phase(torch, np, kind)

    kernels = []
    for name in ("aggregate_first", "transform_first"):
        mine = [r for r in rows if r["kernel"] == name]
        kernels.append(_kernel_entry(name, mine, "calls_per_mesh", launches[name]))
    for name in ("aggregate_first_bwd", "transform_first_bwd"):
        mine = [r for r in train["rows"] if r["kernel"] == name]
        kernels.append(_kernel_entry(name, mine, "calls_per_step", train["launches"][name]))

    # 7. result -----------------------------------------------------------------
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
