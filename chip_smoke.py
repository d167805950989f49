#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (geobignn_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its lines; any failure raises and the script exits
non-zero without the final result line:

  1. the card (nvidia-smi name and power limit); no CUDA device -> exit 2;
  2. build: the banded kernels (csrc/banded_fwd.cu, nvcc for sm_90a) and
     the native mesh library, timed;
  3. the main path: Predictor with Config() defaults and seeded random
     weights denoises add_noise(icosphere(5), 0.2, seed=0) — 20,480 faces
     in 2 patches — through predict_dir's body (60 update iterations,
     `{name}-60.obj` written to a temp dir).  Launch counts are zeroed just
     before and read just after; one mesh must launch the aggregate-first
     kernel 18 times and the transform-first kernel 20 times.  Wall time of
     the mesh after a warm-up mesh; the host build, one patch's forward
     and the update loop timed apart;
  4. the same predict_mesh with device="cpu" (plain PyTorch versions)
     against the GPU run;
  5. every kernel against its plain version on the card, on the inputs the
     main path gave it (recorded during the warm-up), timed with CUDA
     events, with its bound;
  6. one JSON line of the kernels, then the result line.

Tolerances: kernel vs plain on identical inputs, bf16 compute: 2e-2 of
max|out| (both round the same operands to bf16, but a D summed in another
order can round an operand to the neighbouring bf16 value, 2^-8 relative);
float32 compute: 1e-4 of max|out| (summation order only).  GPU vs CPU
prediction: positions within 2e-2 of the mean edge length, unit normals
within 5e-2 (bf16 differences carried through 16 convs and the bf16 heads;
the JAX package's own banded-vs-table model test uses 2e-2 / 5e-2).
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
EXPECTED_LAUNCHES = {"aggregate_first": 18, "transform_first": 20}
TPU_KERNEL = {  # file:line of the TPU kernel each CUDA kernel replaces
    "aggregate_first": "geobignn_tpu/ops/banded_pallas.py:220",
    "transform_first": "geobignn_tpu/ops/banded_pallas.py:104",
}


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


def _bound_ms(byts, ops):
    t_b, t_o = byts / H100_BYTES_PER_S, ops / H100_BF16_FLOPS
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


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
    print(f"[build] nvcc {banded_cuda.SOURCE} -> sm_90a in {secs:.2f} s")
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
    assert {r["kernel"] for r in rows} == set(EXPECTED_LAUNCHES)
    assert sum(r["calls_per_mesh"] for r in rows if r["kernel"] == "aggregate_first") \
        == EXPECTED_LAUNCHES["aggregate_first"]

    kernels = []
    for name in ("aggregate_first", "transform_first"):
        mine = [r for r in rows if r["kernel"] == name]
        per_mesh = lambda f: sum(r["calls_per_mesh"] * r[f] for r in mine)
        t_bytes = per_mesh("bytes") / H100_BYTES_PER_S
        t_ops = per_mesh("ops") / H100_BF16_FLOPS
        kernels.append({
            "name": f"banded_aggregate_{name}",
            "route": "cuda",
            "source": "geobignn_tpu_torch/csrc/banded_fwd.cu",
            "replaces": TPU_KERNEL[name],
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": per_mesh("ms"),
            "plain_ms": per_mesh("plain_ms"),
            "bound_ms": per_mesh("bound_ms"),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
        })

    # 6. result -----------------------------------------------------------------
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
