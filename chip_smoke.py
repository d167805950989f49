#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (geobignn_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its lines; any failure raises and the script exits
non-zero without the final result line:

  1. the card (nvidia-smi name and power limit); no CUDA device -> exit 2;
  2. build: the banded and the block-sparse kernels (csrc/banded_fwd.cu,
     banded_bwd.cu, blocksparse_fwd.cu, blocksparse_bwd.cu: one nvcc each
     for sm_90a, started together) and the native mesh library, timed;
  3. the serving path on a mesh whose levels all band: Predictor with
     Config() defaults and seeded random weights denoises
     add_noise(icosphere(5), 0.2, seed=0) — 20,480 faces in 2 patches —
     through predict_dir's body (60 update iterations, `{name}-60.obj`
     written to a temp dir).  Launch counts are zeroed just before and read
     just after; one mesh must launch the banded aggregate-first kernel 18
     times and the transform-first kernel 20 times, and nothing else.  Wall
     time of the mesh after a warm-up mesh; the host build, one patch's
     forward and the update loop timed apart;
  4. the same predict_mesh with device="cpu" (plain PyTorch versions)
     against the GPU run; then the dense-table convs on the card (plain
     torch, no kernel launched): predict_mesh under Config(reorder=False),
     and patch 0 with its band structures taken away against the same patch
     through the banded kernels in float32 compute;
  5. the serving path on a mesh whose patches disagree on a band (noise
     seed 1: TableWidths.merge drops the finest facet level's band and both
     patches run it block-sparse, 79 row blocks of 256 over K column
     blocks): the same body, counts zeroed and read the same way — the
     block-sparse forward 2 + 4 times (aggregate-first / transform-first),
     the banded forward 14 + 12 times, no backward; wall time after a
     warm-up; patch 0's forward on the card against device="cpu";
  6. every forward kernel, banded and block-sparse, against its plain
     version on the card, on the inputs the serving paths gave it (recorded
     during the warm-ups), timed with CUDA events, with its bound;
  7. the training path at the default model's full width, twice: an
     InMemoryDataset of two (noisy, clean) icosphere(5) pairs split into 4
     patches of 20,000 faces, first with noise seeds (0, 6), whose levels
     all band, then with seeds (1, 2), whose finest facet level is
     block-sparse (merged K = 9).  One recorded step on one patch must
     launch 9 / 10 banded kernels each way, or 7 / 6 banded and 1 / 2
     block-sparse each way; the gradient of every parameter on the card
     against the CPU's plain backward on the same weights; ms per training
     step; with seeds (0, 6), 20 steps on one patch must lower its loss;
     then the main path, Trainer(Config(seed=0, max_epoch=2)).fit() —
     counts zeroed just before, read just after — with per-epoch loss,
     s/step and edges/s; and each backward kernel against its plain backward on the
     inputs the path gave it (with a seeded gout), timed, with its bound
     (the banded ones from seeds (0, 6), the block-sparse ones from (1, 2));
  8. the run-directory path, through the entry points a user calls, at the
     default model's full width (Config() defaults, sub_size 20000), in a
     temp directory: a reference-layout corpus (Synthetic/{train,test}/
     {noisy,original} + train_list.txt / test_list.txt) of icosphere(5)
     meshes (train: noise seeds 1 and 2, test: seed 3);
     train(Config(max_epoch=2)) writes the run directory (params.json,
     ckpt_best.pkl, ckpt_last.pkl, metrics.jsonl, training_info.txt and the
     code snapshot with csrc/ and the native sources) and puts stdout back;
     Predictor.from_run loads it version-pinned — the snapshot builds its
     own kernels — with the checkpoint's weights bit for bit, and its
     prediction of the test mesh equals the live package's exactly;
     predict_dir writes `{name}-60.obj` (forward launches counted as in the
     serving phases; the launches of train() are 8 training steps plus two
     evaluation passes of the same mesh); eval_denoising_result scores it —
     the nearest-distance kernel once per result mesh — against the same
     call with device="cpu" (angle and normal_mse equal to 1e-6, the vertex
     distance within 1e-5 of the mean edge length), and writes
     ErrorInfo_h.txt; then resume: Trainer.restore(ckpt_last.pkl) and one
     more epoch against a fresh 3-epoch fit (same epoch loss to 1e-6
     relative: no kernel uses atomics, autograd's index backward may), whose
     best weights Predictor.from_run returns bit for bit;
  9. the nearest-distance kernel against its plain version (squared
     distances within 1e-5 * max(|a|^2 + |b|^2), also against a float64
     brute force where its matrix fits) at 10,242 x 10,242 x 3 (the path's
     own inputs), 40,000^2 x 3, 500,000^2 x 3 and 8,192^2 x 64, timed with
     CUDA events, with its bound (float32 operations at 67 TFLOP/s) and the
     time of torch.cdist(a, b).min(dim=1), which materialises the matrix;
 10. one JSON line of the nine kernels, then the result line.

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
included, within 1e-3 of its max|g| (float32 sums in another order) on
seeds (0, 6).  On seeds (1, 2) that bound is 5e-3: there the sample's vertex
head amplifies the order of float32 sums (the plain versions alone, on the
card against the CPU, differ by 2e-3 of max|g| in `fc_v1.kernel`), so the
block-sparse kernels are also held in place, float32 compute, against their
own plain versions on the card: every parameter gradient within 1e-4.
The nearest-distance kernel's error is that of the expansion
|a|^2 - 2 a.b + |b|^2, a few float32 ulps of the terms that cancel: squared
distances within 1e-5 * max(|a|^2 + |b|^2); the root magnifies it for the
closest pairs, so the error of the distances is printed beside it.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

H100_BF16_FLOPS = 989e12  # dense tensor-core peak, SXM at 700 W
H100_F32_FLOPS = 67e12  # float32 outside the tensor cores, SXM at 700 W
H100_BYTES_PER_S = 3.35e12  # HBM3
NEAREST_TOL = 1e-5  # of max(|a|^2 + |b|^2), on squared distances
BF16_TOL, F32_TOL = 2e-2, 1e-4
POS_TOL_MEL, NORMAL_TOL = 2e-2, 5e-2
FWD = ("aggregate_first", "transform_first")
AGGREGATES = tuple(pre + k + suf for suf in ("", "_bwd") for pre in ("", "bs_") for k in FWD)
KERNELS = AGGREGATES + ("nearest",)


def _counts(**launched):
    """Launch counts of every kernel, zero but for those named."""
    return {**dict.fromkeys(KERNELS, 0), **launched}


# launches of one served mesh (2 patches), by its noise seed: with seed 0
# every level bands (8 convs of each schedule per branch, plus the finest
# facet level's boundary sub-band: one aggregate-first conv, two
# transform-first); with seed 1 the finest facet level is block-sparse
# (l_conv1 aggregate-first, r_conv3 and r_conv4 transform-first) and has no
# boundary sub-band
SERVE_LAUNCHES = {
    0: _counts(aggregate_first=18, transform_first=20),
    1: _counts(aggregate_first=14, transform_first=12,
               bs_aggregate_first=2, bs_transform_first=4),
}
# noise seeds of the two training sets and the launches of one training
# step on one patch: (0, 6) is the first pair whose patches all keep the
# seed-0 serving mesh's levels and tiles; with (1, 2) one patch bands the
# finest facet level at tile 384 while another needs the hybrid, so
# TableWidths.merge sends that level to the block-sparse path for every
# sample
TRAIN_SETS = {
    (0, 6): _counts(aggregate_first=9, transform_first=10,
                    aggregate_first_bwd=9, transform_first_bwd=10),
    (1, 2): _counts(aggregate_first=7, transform_first=6,
                    aggregate_first_bwd=7, transform_first_bwd=6,
                    bs_aggregate_first=1, bs_transform_first=2,
                    bs_aggregate_first_bwd=1, bs_transform_first_bwd=2),
}
_PALLAS = "geobignn_tpu/ops/banded_pallas.py"
_BS = "geobignn_tpu/ops/blocksparse.py"
# float32 bound on GPU vs CPU parameter gradients, of max|g| (see the docstring)
F32_GRAD_TOL = {(0, 6): 1e-3, (1, 2): 5e-3}
TPU_KERNEL = {  # file:line of the TPU kernel each CUDA kernel replaces
    "aggregate_first": f"{_PALLAS}:220", "transform_first": f"{_PALLAS}:104",
    "aggregate_first_bwd": f"{_PALLAS}:241", "transform_first_bwd": f"{_PALLAS}:141",
    "bs_aggregate_first": f"{_BS}:164", "bs_transform_first": f"{_BS}:150",
    "bs_aggregate_first_bwd": f"{_BS}:182", "bs_transform_first_bwd": f"{_BS}:156",
}


def _source(name):
    return ("geobignn_tpu_torch/csrc/"
            + ("blocksparse" if name.startswith("bs_") else "banded")
            + ("_bwd.cu" if name.endswith("_bwd") else "_fwd.cu"))


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


def _work(r, p, x, w, m, tf, blk_idx=None):
    """(bytes, operations this run's data needs, operations counted densely
    over the window as the TPU wrapper's cost estimate does).  The bytes are
    r, p, x, w and out in f32, the int8 mask and, block-sparse, blk_idx."""
    n, c_in = x.shape
    heads, c_out = r.shape[1], w.shape[2]
    win = m.shape[2]
    k = heads * (c_out if tf else c_in)
    nnz = int(m.count_nonzero())
    byts = 4 * (r.numel() + p.numel() + x.numel() + w.numel() + n * c_out) + m.numel()
    if blk_idx is not None:
        byts += blk_idx.numel() * blk_idx.element_size()
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


def _work_bwd(r, p, x, w, m, tf, blk_idx=None):
    """(bytes, operations this run's data needs, dense operations) of the
    backward: inputs r, p, x, w, m, gout (and blk_idx) and outputs r̄, p̄, x̄
    and the per-block W̄ partials, each moved once; per set mask slot D, the
    window products z, K and a, and the r̄ / p̄ denominator parts, plus the
    per-node products; densely, the five window products of _bwd_kernel over
    the whole window and the two C_out (or C_in) products."""
    n, c_in = x.shape
    heads, c_out = r.shape[1], w.shape[2]
    n_blk, _, win = m.shape
    cv = c_out if tf else c_in
    kk = heads * cv
    cr = c_in if tf else c_out
    nnz = int(m.count_nonzero())
    byts = (4 * (r.numel() + p.numel() + x.numel() + w.numel() + n * c_out)
            + m.numel() + 4 * (2 * n * heads + n * c_in + n_blk * kk * cr))
    if blk_idx is not None:
        byts += blk_idx.numel() * blk_idx.element_size()
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


def _kernel_entry(name, rows, launches):
    """One entry of the kernels JSON line: times and bound summed over the
    launches of one mesh (forward) or one training step (backward)."""
    per = lambda f: sum(r["calls"] * r[f] for r in rows)
    t_bytes = per("bytes") / H100_BYTES_PER_S
    t_ops = per("ops") / H100_BF16_FLOPS
    return {
        "name": ("bs_aggregate_" + name[3:]) if name.startswith("bs_")
                else f"banded_aggregate_{name}",
        "route": "cuda",
        "source": _source(name),
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


@contextlib.contextmanager
def _recording(captured, backward=False):
    """While open, the banded and block-sparse aggregate wrappers (forward,
    or backward) record the inputs of their first call at each shape and
    count the calls, under (kernel name, N, T, C_in, C_out, window)."""
    import torch

    from geobignn_tpu_torch.ops import banded_cuda, blocksparse

    sites = ((banded_cuda, "banded_aggregate", ""), (blocksparse, "bs_aggregate", "bs_"))
    saved = []

    def wrap(fn, prefix):
        def recording(r, p, x, w, m, *rest, **kw):
            # rest: [blk_idx,] [gout,] [compute_dtype]
            tf = banded_cuda.use_transform_first(x.shape[1], w.shape[2])
            name = prefix + FWD[tf] + ("_bwd" if backward else "")
            ent = captured.setdefault(
                (name, x.shape[0], m.shape[1], x.shape[1], w.shape[2], m.shape[2]),
                {"args": [t.detach().clone() for t in (r, p, x, w, m)
                          + ((rest[0],) if prefix else ())],
                 "cd": kw.get("compute_dtype", rest[-1] if rest and not
                              torch.is_tensor(rest[-1]) else torch.bfloat16),
                 "calls": 0})
            if backward:
                ent["gout_shape"] = tuple(rest[1 if prefix else 0].shape)
            ent["calls"] += 1
            return fn(r, p, x, w, m, *rest, **kw)
        return recording

    for mod, attr, prefix in sites:
        attr += "_bwd" if backward else ""
        saved.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, wrap(getattr(mod, attr), prefix))
    try:
        yield captured
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


@contextlib.contextmanager
def _float32_aggregates():
    """While open, every aggregate computes in float32 (no bf16 operands)."""
    import torch

    from geobignn_tpu_torch.ops import banded_cuda, blocksparse

    agg, bs_agg = banded_cuda.banded_aggregate, blocksparse.bs_aggregate
    banded_cuda.banded_aggregate = (
        lambda r, p, x, w, m, compute_dtype=None: agg(r, p, x, w, m, torch.float32))
    blocksparse.bs_aggregate = (
        lambda r, p, x, w, m, i, compute_dtype=None:
        bs_agg(r, p, x, w, m, i, torch.float32))
    try:
        yield
    finally:
        banded_cuda.banded_aggregate, blocksparse.bs_aggregate = agg, bs_agg


def _functions(name):
    """(kernel wrapper, plain version) of a kernel name, forward or backward."""
    from geobignn_tpu_torch.ops import banded_cuda, blocksparse

    mod, stem = ((blocksparse, "bs_aggregate") if name.startswith("bs_")
                 else (banded_cuda, "banded_aggregate"))
    stem += "_bwd" if name.endswith("_bwd") else ""
    return getattr(mod, stem), getattr(mod, stem + "_plain")


def check_forward(key, ent, reps=20):
    """One forward kernel against its plain version on the recorded inputs:
    compute dtype of the path and float32; timed; with its bound."""
    import torch

    name, args, cd = key[0], ent["args"], ent["cd"]
    kernel, plain = _functions(name)
    tf = name.endswith("transform_first")
    got = kernel(*args, compute_dtype=cd)
    torch.cuda.synchronize()
    ref = plain(*args, compute_dtype=cd)
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    got32 = kernel(*args, compute_dtype=torch.float32)
    ref32 = plain(*args, compute_dtype=torch.float32)
    err32 = float((got32 - ref32).abs().max()) / float(ref32.abs().max())
    del got, ref, got32, ref32
    ms = _cuda_ms(lambda: kernel(*args, compute_dtype=cd), reps)
    plain_ms = _cuda_ms(lambda: plain(*args, compute_dtype=cd), 3)
    byts, ops, dense = _work(*args[:5], tf, *args[5:])
    bound, by = _bound_ms(byts, ops)
    dense_bound, _ = _bound_ms(byts, dense)
    n, c_in = args[2].shape
    row = dict(kernel=name, n=n, tile=args[4].shape[1], window=args[4].shape[2],
               c_in=c_in, c_out=args[3].shape[2], calls=ent["calls"], max_abs_err=err,
               rel_err=err / scale, rel_err_f32=err32, ms=ms, plain_ms=plain_ms,
               bound_ms=bound, bound_by=by, dense_bound_ms=dense_bound,
               bytes=byts, ops=ops, dense_ops=dense)
    print("[kernel] " + json.dumps(row))
    assert err <= BF16_TOL * scale, row
    assert err32 <= F32_TOL, row
    return row


def check_backward(key, ent, gen):
    """One backward kernel against its plain backward, per cotangent."""
    import torch

    name, cd = key[0], ent["cd"]
    kernel, plain = _functions(name)
    tf = name.endswith("transform_first_bwd")
    gout = torch.randn(ent["gout_shape"], device="cuda", generator=gen)
    args = [*ent["args"], gout]
    res = {}
    for dt in (cd, torch.float32):
        got = kernel(*args, compute_dtype=dt)
        torch.cuda.synchronize()
        ref = plain(*args, compute_dtype=dt)
        abs_err = [float((g - r_).abs().max()) for g, r_ in zip(got, ref)]
        rel = [a / max(float(r_.abs().max()), 1e-30) for a, r_ in zip(abs_err, ref)]
        res[dt] = (max(abs_err), max(rel))
        del got, ref
    ms = _cuda_ms(lambda: kernel(*args, compute_dtype=cd), 10)
    plain_ms = _cuda_ms(lambda: plain(*args, compute_dtype=cd), 3)
    byts, ops, dense = _work_bwd(*args[:5], tf, *args[5:-1])
    bound, by = _bound_ms(byts, ops)
    dense_bound, _ = _bound_ms(byts, dense)
    n, c_in = args[2].shape
    row = dict(kernel=name, n=n, tile=args[4].shape[1], window=args[4].shape[2],
               c_in=c_in, c_out=args[3].shape[2], calls=ent["calls"],
               max_abs_err=res[cd][0], rel_err=res[cd][1],
               rel_err_f32=res[torch.float32][1], ms=ms, plain_ms=plain_ms,
               bound_ms=bound, bound_by=by, dense_bound_ms=dense_bound,
               bytes=byts, ops=ops, dense_ops=dense)
    print("[kernel-bwd] " + json.dumps(row))
    assert res[cd][1] <= BF16_TOL and res[torch.float32][1] <= F32_TOL, row
    return row


def serve_phase(pred, seed, tag):
    """The serving path on add_noise(icosphere(5), 0.2, seed): a recorded
    warm-up mesh, then the timed mesh with its launch counts.  Returns the
    mesh, the recorded forward calls, the counts and the wall seconds."""
    import numpy as np
    import torch

    from geobignn_tpu_torch import meshio
    from geobignn_tpu_torch.data import synth
    from geobignn_tpu_torch.infer import predict
    from geobignn_tpu_torch.ops import banded_cuda

    mesh = synth.add_noise(synth.icosphere(5), 0.2, seed=seed)
    assert mesh.n_faces == 20480, mesh.n_faces
    captured: dict = {}
    with tempfile.TemporaryDirectory() as root:
        data = os.path.join(root, pred.cfg.data_type, "test")
        os.makedirs(os.path.join(data, "noisy"))
        os.makedirs(os.path.join(data, "original"))
        clean = synth.icosphere(5)
        meshio.write_obj(os.path.join(data, "noisy", "ball_n1.obj"),
                         mesh.points, mesh.fv_indices)
        meshio.write_obj(os.path.join(data, "original", "ball.obj"),
                         clean.points, clean.fv_indices)

        with _recording(captured):  # warm-up mesh, recorded
            predict.predict_dir_body(pred, dataset_root=root)
        torch.cuda.synchronize()

        banded_cuda.reset_launches()
        t0 = time.perf_counter()
        res = predict.predict_dir_body(pred, dataset_root=root)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(banded_cuda.LAUNCHES)
        print(f"[{tag}] one mesh (noise seed {seed}, {mesh.n_faces} faces, 2 patches, "
              f"60 update iterations): {wall:.3f} s wall; launches {launches}")
        assert launches == SERVE_LAUNCHES[seed], launches
        out = meshio.read_obj(os.path.join(res["result_dir"], "ball_n1-60.obj"))
        assert out.n_faces == mesh.n_faces and out.n_vertices == mesh.n_vertices
        assert np.isfinite(out.points).all()
        assert np.isfinite([res["angle_mean1"], res["angle_mean2"]]).all()
        print(f"[{tag}] wrote {out.n_vertices} vertices; angle1 "
              f"{res['angle_mean1']:.4f} angle2 {res['angle_mean2']:.4f} "
              f"(random weights)")
    assert {k: sum(e["calls"] for kk, e in captured.items() if kk[0] == k)
            for k in FWD + tuple("bs_" + k for k in FWD)} \
        == _fwd_only(SERVE_LAUNCHES[seed])
    return mesh, captured, launches, wall


def train_phase(torch, np, seeds, overfit):
    """Phase 7, for one training set: the training path on the card.
    Returns the recorded backward calls, the ms per step and the launch
    counts of the main path (Trainer.fit)."""
    from geobignn_tpu_torch.config import Config
    from geobignn_tpu_torch.data import dataset, synth
    from geobignn_tpu_torch.models.dual_gnn import DualGNN
    from geobignn_tpu_torch.ops import banded_cuda, blocksparse
    from geobignn_tpu_torch.train.trainer import Trainer, _metrics_of

    tag = f"train{seeds}"
    step_launches = TRAIN_SETS[seeds]
    cfg = Config(seed=0, max_epoch=2)
    clean = synth.icosphere(5)
    t0 = time.perf_counter()
    train_ds = dataset.InMemoryDataset(
        [(synth.add_noise(clean, 0.2, seed=s), clean) for s in seeds],
        cfg.build_config(), submesh_size=cfg.sub_size)
    host_s = time.perf_counter() - t0
    n_faces = [int(e[1].n_nodes) for e in train_ds.entries]
    print(f"[{tag}] {len(train_ds)} patches of {n_faces} faces from noise seeds "
          f"{seeds}; host build {host_s:.3f} s; real edge messages per "
          f"step {train_ds.messages_per_sample().tolist()}")
    assert len(train_ds) == 4 and max(n_faces) <= cfg.sub_size

    # one recorded step on one patch: launches per step, inputs of the
    # backward kernels at the path's shapes
    probe = Trainer(cfg.with_updates(augment=False), train_ds, None, device="cuda")
    s0 = probe._get(train_ds, "t", 0)
    f1 = s0.f.levels[0]
    print(f"[{tag}] finest facet level: mask {tuple(f1.band.shape)}, blk_idx "
          f"{None if f1.blk_idx is None else tuple(f1.blk_idx.shape)}, boundary "
          f"sub-band {None if f1.jband is None else tuple(f1.jband.shape)}")
    captured: dict = {}
    banded_cuda.reset_launches()
    with _recording(captured, backward=True):
        probe._step(s0, 0)
        probe._apply(1)
    torch.cuda.synchronize()
    got = dict(banded_cuda.LAUNCHES)
    print(f"[{tag}] one step on one patch: launches {got}")
    assert got == step_launches, got

    # the gradient of every parameter on the card against the CPU's plain
    # backward, on the same weights and sample: with the Config defaults
    # (bf16 aggregate operands and heads), and with both in float32
    s0_cpu = train_ds.get(0, probe.plan).to("cpu")
    launchers = blocksparse._launch, blocksparse._launch_bwd
    for label in ("bfloat16", "float32"):
        f32 = label == "float32"
        models, losses_, secs = [], [], []
        try:
            runs = [("cuda", s0), ("cpu", s0_cpu)]
            if f32 and step_launches["bs_aggregate_first"]:
                runs.append(("cuda", s0))  # third: block-sparse plain versions
            for i, (dev, smp) in enumerate(runs):
                if i == 2:
                    blocksparse._launch = blocksparse.bs_aggregate_plain
                    blocksparse._launch_bwd = blocksparse.bs_aggregate_bwd_plain
                mdl = DualGNN(fc_dtype=None if f32 else torch.bfloat16, device=dev)
                mdl.load_state_dict(probe.model.state_dict())
                t0 = time.perf_counter()
                with _float32_aggregates() if f32 else contextlib.nullcontext():
                    loss = _metrics_of(*mdl(smp), smp, cfg)[0]
                    loss.backward()
                losses_.append(float(loss.detach()))
                secs.append(time.perf_counter() - t0)
                models.append(mdl)
        finally:
            blocksparse._launch, blocksparse._launch_bwd = launchers
        if len(models) == 3:
            in_place = _grad_agreement(models[0], models.pop())
            k_w = max(in_place, key=lambda k: in_place[k][0])
            print(f"[{tag}] gradients on the card, float32 compute: block-sparse "
                  f"kernels vs their plain versions in place: worst tensor {k_w} "
                  f"{in_place[k_w][0]:.3e} of its max|g| (tol 1e-4)")
            assert in_place[k_w][0] <= 1e-4
        stats = _grad_agreement(*models)
        not_u = {k: v for k, v in stats.items() if not k.endswith(".u")}
        worst = max(not_u, key=lambda k: not_u[k][0])
        worst_all = max(stats, key=lambda k: stats[k][0])
        min_cos = min(not_u, key=lambda k: not_u[k][1])
        min_cos_u = min(v[1] for k, v in stats.items() if k.endswith(".u"))
        print(f"[{tag}] gradients GPU vs CPU plain backward, {label} compute, one "
              f"patch: loss {losses_[0]:.6f} vs {losses_[1]:.6f}; worst tensor "
              f"{worst_all} {stats[worst_all][0]:.3e} of its max|g|, u aside "
              f"{worst} {not_u[worst][0]:.3e}; smallest cosine u aside {min_cos} "
              f"{not_u[min_cos][1]:.6f}, of the u {min_cos_u:.6f}; CPU forward+"
              f"backward {secs[1]:.2f} s")
        if f32:  # every tensor, u included: float32 sums in another order
            assert abs(losses_[0] - losses_[1]) <= 1e-5 * abs(losses_[1])
            assert stats[worst_all][0] <= F32_GRAD_TOL[seeds]
        else:  # u's gradient is noise-dominated in bf16 (see the docstring)
            assert abs(losses_[0] - losses_[1]) <= 1e-2 * abs(losses_[1])
            assert not_u[worst][0] <= 5e-2 and not_u[min_cos][1] >= 0.99
        del models

    def one_step():
        probe._step(s0, 0)
        probe._apply(1)

    step_ms = _cuda_ms(one_step, reps=5)
    print(f"[{tag}] one training step (forward, backward, Adam) on one "
          f"20,000-face patch: {step_ms:.3f} ms (CUDA events, after warm-up)")

    if overfit:  # 20 steps on one patch lower its loss
        over = Trainer(cfg.with_updates(augment=False), train_ds, None, device="cuda")
        o0 = over._get(train_ds, "t", 0)
        hist = []
        for _ in range(20):
            hist.append(float(over._step(o0, 0)["loss"].detach()))
            over._apply(1)
        print(f"[{tag}] overfit one patch, 20 steps: loss {hist[0]:.5f} -> "
              f"{hist[-1]:.5f} (min {min(hist):.5f})")
        assert np.isfinite(hist).all() and hist[-1] < hist[0]
        del over, o0

    # the main path: Trainer(Config(seed=0, max_epoch=2)).fit()
    tr = Trainer(cfg, train_ds, None, device="cuda")
    epochs = []

    def report(t, m, _):
        epochs.append(m)
        print(f"[{tag}] epoch {t.epoch}: loss {m['loss']:.5f} (v {m['loss_v']:.5f}, "
              f"f {m['loss_f']:.5f}) error_f {m['error_f']:.4f} deg; "
              f"{1.0 / m['samples_per_s']:.4f} s/step; edges/s {m['edges_per_s']:.4e}")

    banded_cuda.reset_launches()
    t0 = time.perf_counter()
    best = tr.fit(on_epoch=report)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = dict(banded_cuda.LAUNCHES)
    n_steps = cfg.max_epoch * len(train_ds)
    print(f"[{tag}] fit: {cfg.max_epoch} epochs x {len(train_ds)} steps in "
          f"{fit_s:.3f} s; best error_f {best:.4f}; "
          f"launches {launches}")
    assert launches == {k: n_steps * v for k, v in step_launches.items()}, launches
    assert len(epochs) == cfg.max_epoch
    assert all(np.isfinite([m[k] for k in ("loss", "loss_v", "loss_f", "error_v",
                                            "error_f")]).all() for m in epochs)
    assert {k: sum(e["calls"] for kk, e in captured.items() if kk[0] == k)
            for k in KERNELS if k.endswith("_bwd")} \
        == {k: v for k, v in step_launches.items() if k.endswith("_bwd")}
    return {"captured": captured, "launches": launches, "step_ms": step_ms}


def _fwd_only(counts):
    return {k: v for k, v in counts.items() if k in FWD or k[3:] in FWD}


def rundir_phase(torch, np):
    """Phase 8: train(cfg) -> Predictor.from_run / predict_dir ->
    eval_denoising_result -> resume, in a temp directory.  Returns the
    launches of the `nearest` kernel on the path and the result mesh's and
    the original's points (the kernel's inputs on this path)."""
    from geobignn_tpu_torch import geometry, meshio
    from geobignn_tpu_torch.config import Config
    from geobignn_tpu_torch.data import synth
    from geobignn_tpu_torch.data.dataset import DualDataset
    from geobignn_tpu_torch.infer import predict
    from geobignn_tpu_torch.infer.evaluate import eval_denoising_result
    from geobignn_tpu_torch.ops import banded_cuda
    from geobignn_tpu_torch.train import checkpoint as ckpt
    from geobignn_tpu_torch.train.trainer import Trainer, train

    tag = "rundir"
    train_seeds, test_seed = (1, 2), 3
    step = TRAIN_SETS[train_seeds]
    tmp = tempfile.mkdtemp(prefix="gbn_smoke_")
    try:
        # a reference-layout corpus
        root = os.path.join(tmp, "dataset")
        clean = synth.icosphere(5)
        for split, seeds in (("train", train_seeds), ("test", (test_seed,))):
            for sub in ("noisy", "original"):
                os.makedirs(os.path.join(root, "Synthetic", split, sub))
            meshio.write_obj(os.path.join(root, "Synthetic", split, "original", "ball.obj"),
                             clean.points, clean.fv_indices)
            for sd in seeds:
                noisy = synth.add_noise(clean, 0.2, seed=sd)
                meshio.write_obj(
                    os.path.join(root, "Synthetic", split, "noisy", f"ball_n{sd}.obj"),
                    noisy.points, noisy.fv_indices)
            with open(os.path.join(root, "Synthetic", f"{split}_list.txt"), "w") as f:
                f.write("ball\n")
        test_dir = os.path.join(root, "Synthetic", "test")
        cfg = Config(seed=0, max_epoch=2, flag="smoke", dataset_dir=root,
                     log_dir=os.path.join(tmp, "log"))

        # 8.1 train(cfg): the run directory
        stdout = sys.stdout
        banded_cuda.reset_launches()
        t0 = time.perf_counter()
        run_dir = train(cfg)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        train_launches = dict(banded_cuda.LAUNCHES)
        assert sys.stdout is stdout, "train() left its tee on sys.stdout"
        for name in ("params.json", "ckpt_best.pkl", "ckpt_last.pkl", "metrics.jsonl",
                     "training_info.txt", "code_bak/geobignn_tpu_torch/csrc/nearest.cu",
                     "code_bak/geobignn_tpu_torch/csrc/window_fwd.cuh",
                     "code_bak/native/meshkernel.cpp"):
            assert os.path.exists(os.path.join(run_dir, name)), name
        recs = [json.loads(ln) for ln in open(os.path.join(run_dir, "metrics.jsonl"))]
        epochs = [r for r in recs if r["split"] == "train"]
        assert [r["epoch"] for r in epochs] == [0, 1]
        assert [r["epoch"] for r in recs if r["split"] == "test"] == [0, 1]
        for r in epochs:
            print(f"[{tag}] train() epoch {r['epoch']}: loss {r['loss']:.5f} error_f "
                  f"{r['error_f']:.4f} deg; {1.0 / r['samples_per_s']:.4f} s/step; "
                  f"edges/s {r['edges_per_s']:.4e}")
            assert np.isfinite([r["loss"], r["error_f"], r["edges_per_s"]]).all()
        print(f"[{tag}] train(Config(seed=0, max_epoch=2)) on 2 meshes (4 patches) + 1 "
              f"test mesh (2 patches): {train_s:.3f} s wall with the host builds and "
              f"the snapshot; launches {train_launches}")
        n_steps = 2 * 4
        assert {k: v for k, v in train_launches.items() if k.endswith("_bwd")} \
            == {k: n_steps * v for k, v in step.items() if k.endswith("_bwd")}, train_launches
        assert train_launches["nearest"] == 0

        # 8.2 Predictor.from_run: version-pinned, the checkpoint's weights
        best, _, scalars = ckpt.load_checkpoint(os.path.join(run_dir, "ckpt_best.pkl"))
        mesh_t = meshio.read_obj(os.path.join(test_dir, "noisy", f"ball_n{test_seed}.obj"))
        t0 = time.perf_counter()
        pinned = predict.Predictor.from_run(run_dir)
        try:
            snap_file = sys.modules[type(pinned).__module__].__file__
            assert snap_file.startswith(os.path.join(run_dir, "code_bak")), snap_file
            v_pin, n_pin = pinned.denoise(mesh_t)
            torch.cuda.synchronize()
            snap_cuda = sys.modules["geobignn_tpu_torch.ops.banded_cuda"]
            assert snap_cuda.BUILD_DIR.startswith(os.path.join(run_dir, "code_bak"))
            assert all(os.path.exists(lib) for lib in snap_cuda.LIBRARIES.values())
        finally:
            predict.unpin_live_package()
        pin_s = time.perf_counter() - t0
        live = predict.Predictor.from_run(run_dir, pinned=False)
        assert type(live) is predict.Predictor and type(pinned) is not predict.Predictor
        for name, t in best.items():
            for sd in (pinned.model.state_dict(), live.model.state_dict()):
                assert torch.equal(sd[name].cpu(), t), name
        v_live, n_live = live.denoise(mesh_t)
        same = np.array_equal(v_pin, v_live) and np.array_equal(n_pin, n_live)
        print(f"[{tag}] Predictor.from_run: pinned to the run's snapshot (its own nvcc "
              f"build and first mesh {pin_s:.2f} s), weights of epoch "
              f"{int(scalars['epoch'])} bit-equal to ckpt_best.pkl; pinned vs live "
              f"prediction of the test mesh identical: {same} (max |dv| "
              f"{float(np.abs(v_pin - v_live).max()):.3e})")
        assert same
        del pinned, live

        # 8.3 predict_dir
        banded_cuda.reset_launches()
        t0 = time.perf_counter()
        rep = predict.predict_dir(run_dir, dataset_root=root)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        serve_launches = dict(banded_cuda.LAUNCHES)
        out_path = os.path.join(rep["result_dir"], f"ball_n{test_seed}-60.obj")
        out = meshio.read_obj(out_path)
        print(f"[{tag}] predict_dir: {serve_s:.3f} s wall (pinned import, one mesh); "
              f"angle1 {rep['angle_mean1']:.4f} angle2 {rep['angle_mean2']:.4f}; "
              f"launches {serve_launches}")
        assert rep["result_dir"] == os.path.join(test_dir, "result_smoke")
        assert out.n_vertices == mesh_t.n_vertices and np.isfinite(out.points).all()
        assert np.isfinite([rep["angle_mean1"], rep["angle_mean2"]]).all()
        assert sum(_fwd_only(serve_launches).values()) >= 32, serve_launches  # 2 x 16 convs
        assert serve_launches == _counts(**_fwd_only(serve_launches))
        assert serve_launches["aggregate_first"] and serve_launches["transform_first"]
        # train() = 8 steps + 2 evaluation passes over the same two patches
        assert _fwd_only(train_launches) == {
            k: n_steps * step[k] + 2 * v for k, v in _fwd_only(serve_launches).items()}

        # 8.4 eval_denoising_result: the nearest-distance kernel, once per mesh
        orig_dir = os.path.join(test_dir, "original")
        banded_cuda.reset_launches()
        t0 = time.perf_counter()
        ev = eval_denoising_result(rep["result_dir"], orig_dir)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        eval_launches = dict(banded_cuda.LAUNCHES)
        info = os.path.join(rep["result_dir"], "ErrorInfo_h.txt")
        assert os.path.exists(info) and "ball_n3-60.obj" in open(info).read()
        os.remove(info)
        ev_cpu = eval_denoising_result(rep["result_dir"], orig_dir, device="cpu")
        assert os.path.exists(info)
        mel = geometry.mean_edge_length_np(clean.points, clean.ev_indices)
        c_g, c_c = ev["corpus"], ev_cpu["corpus"]
        launched = {k: v for k, v in eval_launches.items() if v}
        print(f"[{tag}] eval_denoising_result: {eval_s:.3f} s wall; launches "
              f"{launched}; angle {c_g['angle']:.6f}, "
              f"normal_mse {c_g['normal_mse']:.6f}, vertex_dist {c_g['vertex_dist']:.8f} "
              f"(device=\"cpu\": {c_c['vertex_dist']:.8f}; difference "
              f"{abs(c_g['vertex_dist'] - c_c['vertex_dist']) / mel:.3e} mean edge lengths, "
              f"tol 1e-5)")
        assert eval_launches == _counts(nearest=len(ev["rows"])) and len(ev["rows"]) == 1
        for k in ("angle", "normal_mse"):
            assert abs(c_g[k] - c_c[k]) <= 1e-6, (k, c_g[k], c_c[k])
        assert abs(c_g["vertex_dist"] - c_c["vertex_dist"]) <= 1e-5 * mel
        assert np.isfinite(list(c_g.values())).all()

        # 8.5 resume: restore ckpt_last.pkl (epoch 1), one more epoch, against
        # a fresh 3-epoch fit whose best weights from_run must return
        bc = cfg.build_config()
        t0 = time.perf_counter()
        sets = [DualDataset(root, "Synthetic", split, f"{split}_list.txt",
                            cfg.filter_patch_count if split == "train" else 0,
                            cfg.sub_size, bc) for split in ("train", "test")]
        cache_s = time.perf_counter() - t0
        cfg3 = cfg.with_updates(max_epoch=3)
        fresh_dir = os.path.join(tmp, "fresh")
        os.makedirs(fresh_dir)
        cfg3.to_json(os.path.join(fresh_dir, "params.json"))
        hist, kept = {}, {}

        def keep(name):
            def on_epoch(t, m, e):
                hist.setdefault(name, {})[t.epoch] = (m["loss"], e["error_f"])
                if e["error_f"] <= t.best_error:
                    kept[name] = {k: v.detach().clone()
                                  for k, v in t.model.state_dict().items()}
            return on_epoch

        fresh = Trainer(cfg3, *sets, run_dir=fresh_dir)
        fresh.fit(on_epoch=keep("fresh"))
        resumed = Trainer(cfg3, *sets)
        resumed.restore(os.path.join(run_dir, "ckpt_last.pkl"))
        assert resumed.epoch == 2
        resumed.fit(on_epoch=keep("resumed"))
        torch.cuda.synchronize()
        (l_f, e_f), (l_r, e_r) = hist["fresh"][2], hist["resumed"][2]
        rel = abs(l_f - l_r) / abs(l_f)
        p_diff = max(float((a - b).abs().max()) for a, b in zip(
            fresh.model.state_dict().values(), resumed.model.state_dict().values()))
        first = [abs(hist["fresh"][i][0] - epochs[i]["loss"]) / abs(epochs[i]["loss"])
                 for i in (0, 1)]
        print(f"[{tag}] resume: datasets from the cache in {cache_s:.3f} s; epoch 2 of a "
              f"fresh 3-epoch fit: loss {l_f:.7f} error_f {e_f:.5f}; after restore of "
              f"ckpt_last.pkl: loss {l_r:.7f} error_f {e_r:.5f}; relative difference "
              f"{rel:.3e} (tol 1e-6); max parameter difference {p_diff:.3e}; epochs 0-1 "
              f"against train()'s own: {first[0]:.3e}, {first[1]:.3e}")
        assert list(hist["resumed"]) == [2] and rel <= 1e-6
        served = predict.Predictor.from_run(fresh_dir)  # no snapshot there: live
        assert type(served) is predict.Predictor
        for name, t in kept["fresh"].items():
            assert torch.equal(served.model.state_dict()[name], t), name
        print(f"[{tag}] Predictor.from_run(fresh run): state dict bit-equal to the "
              f"trainer's best weights (best error_f {fresh.best_error:.5f})")

        pts = (np.ascontiguousarray(out.points, np.float32),
               np.ascontiguousarray(clean.points, np.float32))
        return {"launches": eval_launches["nearest"], "points": pts}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def check_nearest(torch, label, a, b, calls, reps, plain_reps, brute, library):
    """The nearest-distance kernel against its plain version (and a float64
    brute force where asked), timed, with its bound and the library call."""
    from geobignn_tpu_torch.ops import nn_cuda

    n, k = a.shape
    m = b.shape[0]
    d2 = nn_cuda.nearest_distance(a, b, squared=True)
    d = nn_cuda.nearest_distance(a, b)
    torch.cuda.synchronize()
    p2 = nn_cuda.nearest_distance_plain(a, b, squared=True)
    p = nn_cuda.nearest_distance_plain(a, b)
    scale = float((a * a).sum(1).max() + (b * b).sum(1).max())
    err2 = float((d2 - p2).abs().max())
    err_d = float((d - p).abs().max())
    assert torch.isfinite(d).all() and float(d.min()) >= 0.0
    err2_64 = err_d_64 = None
    if brute:
        ref = torch.cat([(torch.cdist(a[s:s + 4096].double(), b.double()) ** 2).amin(dim=1)
                         for s in range(0, n, 4096)])
        err2_64 = float((d2.double() - ref).abs().max())
        err_d_64 = float((d.double() - ref.sqrt()).abs().max())
        del ref
    ms = _cuda_ms(lambda: nn_cuda.nearest_distance(a, b), reps, warmup=1)
    plain_ms = _cuda_ms(lambda: nn_cuda.nearest_distance_plain(a, b), plain_reps, warmup=1)
    library_ms = None
    if library:  # one PyTorch call of the same function; it materialises (n, m)
        lib = torch.cdist(a, b).min(dim=1).values
        err_lib = float((d - lib).abs().max())
        del lib
        library_ms = _cuda_ms(lambda: torch.cdist(a, b).min(dim=1).values, 3, warmup=1)
    byts = 4 * ((n + m) * k + n)
    ops = n * m * (2 * k + 3)
    t_b, t_o = byts / H100_BYTES_PER_S, ops / H100_F32_FLOPS
    row = dict(kernel="nearest", shape=label, n=n, m=m, k=k, calls=calls,
               max_abs_err=err2, tol=NEAREST_TOL * scale, err_d=err_d,
               err_d2_vs_f64=err2_64, err_d_vs_f64=err_d_64,
               err_d_vs_library=err_lib if library else None, ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=max(t_b, t_o) * 1e3,
               bound_by="bytes" if t_b >= t_o else "operations", bytes=byts, ops=ops)
    print("[kernel] " + json.dumps(row))
    assert err2 <= NEAREST_TOL * scale, row
    assert err2_64 is None or err2_64 <= NEAREST_TOL * scale, row
    return row


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
    t_start = time.perf_counter()

    import numpy as np

    from geobignn_tpu_torch import geometry, native
    from geobignn_tpu_torch.config import Config
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

    # 3. the serving path, every level banded ---------------------------------
    cfg = Config()
    state = DualGNN(fc_dtype=torch.bfloat16, device="cpu", seed=0).state_dict()
    pred = predict.Predictor(cfg, state, device="cuda")
    pred_cpu = predict.Predictor(cfg, state, device="cpu")
    mesh, captured, launches, _ = serve_phase(pred, 0, "main")

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
    del samples, sample

    # 4. GPU vs CPU ------------------------------------------------------------
    vp_g, n_g = vp0, np0
    t0 = time.perf_counter()
    vp_c, n_c = pred_cpu.predict_mesh(mesh)
    cpu_s = time.perf_counter() - t0
    mel = geometry.mean_edge_length_np(mesh.points, mesh.ev_indices)
    e_pos = float(np.abs(vp_g - vp_c).max()) / mel
    e_n = float(np.abs(n_g - n_c).max())
    print(f"[cpu] plain-version predict_mesh {cpu_s:.2f} s; GPU vs CPU: positions "
          f"{e_pos:.3e} mean edge lengths (tol {POS_TOL_MEL}), normals {e_n:.3e} "
          f"(tol {NORMAL_TOL})")
    assert np.isfinite(vp_g).all() and np.isfinite(n_g).all()
    assert e_pos <= POS_TOL_MEL and e_n <= NORMAL_TOL

    # the table path.  As a user reaches it: Config(reorder=False), no RCM
    # order, no band, every conv a dense-table conv in float32 torch, no
    # kernel launched.  Its distance to the default run is printed, not
    # bounded: the default rounds the aggregates' operands to bf16.
    pred_tbl = predict.Predictor(Config(reorder=False), state, device="cuda")
    pred_tbl.predict_mesh(mesh)  # warm-up
    banded_cuda.reset_launches()
    t0 = time.perf_counter()
    vp_t, n_t = pred_tbl.predict_mesh(mesh)
    torch.cuda.synchronize()
    tbl_s = time.perf_counter() - t0
    print(f"[tables] predict_mesh under Config(reorder=False) {tbl_s:.3f} s wall, "
          f"launches {sum(banded_cuda.LAUNCHES.values())}; vs the default run "
          f"(bf16 aggregate operands): positions "
          f"{float(np.abs(vp_t - vp_g).max()) / mel:.3e} mean edge lengths, normals "
          f"{float(np.abs(n_t - n_g).max()):.3e}")
    assert sum(banded_cuda.LAUNCHES.values()) == 0
    assert np.isfinite(vp_t).all() and np.isfinite(n_t).all()
    del pred_tbl
    # Held to the model tolerances: patch 0 in the default order with its
    # band structures taken away, so that every level takes the table conv,
    # against the same patch through the banded kernels in float32 compute
    # (what the JAX package's banded-vs-table model test compares).
    no_band = dict.fromkeys(("band", "blk_idx", "jnodes", "jband", "jpos", "rows_b",
                             "nbr_b", "kmask_b", "src_b", "rev_b"))
    patch0 = mem.get(0)
    stripped = patch0.replace(**{
        side: getattr(patch0, side).replace(levels=tuple(
            lvl.replace(**no_band) for lvl in getattr(patch0, side).levels))
        for side in ("v", "f")})
    nv, nf = (int(b.n_nodes) for b in mem.entries[0][:2])
    banded_cuda.reset_launches()
    v_tb, n_tb = pred._apply(stripped)
    assert sum(banded_cuda.LAUNCHES.values()) == 0
    with _float32_aggregates():
        v_bd, n_bd = pred._apply(patch0)
    assert sum(banded_cuda.LAUNCHES.values()) == sum(SERVE_LAUNCHES[0].values()) // 2
    mel0 = mel * float(mem.entries[0][2]["scale"])  # patch coordinates are normalized
    e_pos_t = float(np.abs(v_tb[:nv] - v_bd[:nv]).max()) / mel0
    e_n_t = float(np.abs(n_tb[:nf] - n_bd[:nf]).max())
    print(f"[tables] patch 0, table convs vs banded kernels in float32 compute: "
          f"positions {e_pos_t:.3e} mean edge lengths (tol {POS_TOL_MEL}), normals "
          f"{e_n_t:.3e} (tol {NORMAL_TOL})")
    assert e_pos_t <= POS_TOL_MEL and e_n_t <= NORMAL_TOL
    del patch0, stripped

    # 5. the serving path through the block-sparse level -------------------------
    mesh1, captured1, launches1, _ = serve_phase(pred, 1, "main-bs")
    t0 = time.perf_counter()
    mem1 = pred.patch_dataset(mesh1)
    patch0 = mem1.get(0)
    host1_s = time.perf_counter() - t0
    f1 = patch0.f.levels[0]
    assert f1.blk_idx is not None and f1.band.shape[:2] == (79, 256), f1.band.shape
    sample1 = patch0.to("cuda")
    with torch.no_grad():
        fwd1_ms = _cuda_ms(lambda: pred.model(sample1), reps=5)
    print(f"[main-bs] finest facet level: mask {tuple(f1.band.shape)} "
          f"({int(f1.band.sum())} set slots), blk_idx {tuple(f1.blk_idx.shape)}; "
          f"host build of the patches' entries and of patch 0: {host1_s:.3f} s; "
          f"DualGNN forward of one patch: {fwd1_ms:.3f} ms")
    nv, nf = (int(b.n_nodes) for b in mem1.entries[0][:2])
    v_g, nrm_g = (a[:k] for a, k in zip(pred._apply(patch0), (nv, nf)))
    t0 = time.perf_counter()
    v_c, nrm_c = (a[:k] for a, k in zip(pred_cpu._apply(patch0), (nv, nf)))
    cpu1_s = time.perf_counter() - t0
    # patch coordinates are normalized: (point - centroid) * scale
    mel1 = (geometry.mean_edge_length_np(mesh1.points, mesh1.ev_indices)
            * float(mem1.entries[0][2]["scale"]))
    e_pos1 = float(np.abs(v_g - v_c).max()) / mel1
    e_n1 = float(np.abs(nrm_g - nrm_c).max())
    print(f"[cpu-bs] plain-version forward of patch 0 (of 2) {cpu1_s:.2f} s; GPU vs "
          f"CPU on that patch: positions {e_pos1:.3e} mean edge lengths (tol "
          f"{POS_TOL_MEL}), normals {e_n1:.3e} (tol {NORMAL_TOL})")
    assert np.isfinite(v_g).all() and np.isfinite(nrm_g).all()
    assert e_pos1 <= POS_TOL_MEL and e_n1 <= NORMAL_TOL
    del sample1, patch0, mem1

    # 6. forward kernels against their plain versions --------------------------
    rows = [check_forward(key, captured[key]) for key in sorted(captured)]
    # 128 -> 128 at T=256 as well (the path runs that width only at T=128)
    r_, p_, x_, w_, m_ = next(e["args"] for k, e in sorted(captured.items())
                              if k[0] == "aggregate_first" and k[2] == 256)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x128 = torch.randn((x_.shape[0], 128), device="cuda", generator=gen)
    w128 = torch.randn((9, 128, 128), device="cuda", generator=gen) * 0.05
    check_forward(("aggregate_first",), {"args": [r_, p_, x128, w128, m_],
                                         "cd": torch.bfloat16, "calls": 0})
    rows += [check_forward(key, captured1[key], reps=10) for key in sorted(captured1)
             if key[0].startswith("bs_")]
    for name in FWD:
        assert sum(r["calls"] for r in rows if r["kernel"] == name) == launches[name]
        assert sum(r["calls"] for r in rows if r["kernel"] == "bs_" + name) \
            == launches1["bs_" + name]
    del captured, captured1
    torch.cuda.empty_cache()

    # 7. training ---------------------------------------------------------------
    gen = torch.Generator(device="cuda").manual_seed(0)
    bwd_rows, fit_launches = [], {}
    for seeds, prefix in (((0, 6), ""), ((1, 2), "bs_")):
        train = train_phase(torch, np, seeds, overfit=not prefix)
        mine = [check_backward(key, ent, gen)
                for key, ent in sorted(train["captured"].items())
                if key[0].startswith("bs_") == bool(prefix)]
        per_step = {prefix + k + "_bwd": sum(
            r["calls"] * r["ms"] for r in mine if r["kernel"] == prefix + k + "_bwd")
            for k in FWD}
        print(f"[train{seeds}] backward kernels per step: "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in per_step.items())
              + f" of a {train['step_ms']:.3f} ms step; card {kind}")
        for name in per_step:
            assert sum(r["calls"] for r in mine if r["kernel"] == name) \
                == TRAIN_SETS[seeds][name]
            fit_launches[name] = train["launches"][name]
        bwd_rows += mine
        del train
        torch.cuda.empty_cache()

    # 8. the run-directory path ---------------------------------------------------
    run = rundir_phase(torch, np)
    torch.cuda.empty_cache()

    # 9. the nearest-distance kernel against its plain version -------------------
    gen = torch.Generator(device="cuda").manual_seed(7)

    def cloud(n, k):
        return torch.randn((n, k), device="cuda", generator=gen)

    nn_rows = [check_nearest(torch, "path", *(torch.from_numpy(x).to("cuda")
                                              for x in run["points"]),
                             calls=run["launches"], reps=20, plain_reps=3,
                             brute=True, library=True)]
    for label, n, k, reps, plain_reps, brute, library in (
            ("40k", 40_000, 3, 10, 2, True, True),
            ("500k", 500_000, 3, 2, 1, False, False),
            ("wide", 8_192, 64, 10, 3, True, True)):
        nn_rows.append(check_nearest(torch, label, cloud(n, k), cloud(n, k), 0, reps,
                                     plain_reps, brute, library))
        torch.cuda.empty_cache()
    assert nn_rows[0]["n"] == nn_rows[0]["m"] == 10242 and run["launches"] == 1

    kernels = []
    for name in AGGREGATES:
        if name.endswith("_bwd"):
            mine, n_l = [r for r in bwd_rows if r["kernel"] == name], fit_launches[name]
        else:
            mine = [r for r in rows if r["kernel"] == name]
            n_l = (launches1 if name.startswith("bs_") else launches)[name]
        assert mine and n_l > 0, name
        kernels.append(_kernel_entry(name, mine, n_l))
    path_row = nn_rows[0]
    kernels.append({
        "name": "nearest_distance", "route": "cuda",
        "source": "geobignn_tpu_torch/csrc/nearest.cu",
        "replaces": "geobignn_tpu/ops/pallas_nn.py:42", "launches": run["launches"],
        **{k: path_row[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms")}})
    assert len(kernels) == len(KERNELS) == 9
    print(f"[time] {time.perf_counter() - t_start:.1f} s after the card was found")

    # 10. result -----------------------------------------------------------------
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
