"""Inference pipeline: submesh stitching, normal-field integration, export.

Counterpart of geobignn_tpu/infer/predict.py.  Per mesh: split into BFS
patches of at most `sub_size` faces, build each patch's sample under one
merged plan and one merged set of table widths (so every patch has the same
shapes), run DualGNN on each patch (on the card, replays of one CUDA graph
of the merged plan: `Predictor.forward`), average the overlaps (int32 counters)
and un-permute the RCM order, denormalize, then run the 60-iteration vertex
re-projection onto the predicted normal field, write `{name}-60.obj` and
report the two angular errors.

`Predictor.from_run` loads a run directory.  When the run carries a
snapshot of this package (`code_bak/geobignn_tpu_torch`, written by
train/trainer.train), inference is version-pinned: the snapshot is imported
in place of the live package, builds its kernels from its own `csrc/` into
`code_bak/build/` and its native library from `code_bak/native/` into
`code_bak/build/native/`, and
`predict_dir` puts the live package back when the batch is done.  A run
directory written by the JAX package carries `code_bak/geobignn_tpu` only;
that is never imported: its `params.json` and checkpoint are read and the
live port serves the weights.

`Predictor.predict_mesh_halo` (and `halo_parts > 1` in `denoise`,
`predict_dir`, `infer --halo_parts`) denoises a whole mesh as one graph,
node-partitioned over several parts with a boundary exchange per conv
(parallel/halo_model.py): no patches, no overlap averaging.  The parts run
on `devices` (one per part, a device may repeat), on the CPU when the
predictor's device is the CPU, else on the first `n_parts` visible cards.
"""

from __future__ import annotations

import glob
import importlib
import os
import sys
import time

import numpy as np
import torch

from geobignn_tpu_torch import capture, geometry, meshio, tracing
from geobignn_tpu_torch.config import Config
from geobignn_tpu_torch.data import builder, dataset as ds_mod
from geobignn_tpu_torch.models.dual_gnn import DualGNN
from geobignn_tpu_torch.train import checkpoint as ckpt
from geobignn_tpu_torch.utils import resolve_device

_PKG = __name__.split(".")[0]


@tracing.spanned("predict.update")
def update_positions(
    points: torch.Tensor,  # (N, 3)
    fv_indices: torch.Tensor,  # (F, 3)
    vf_indices: torch.Tensor,  # (N, K), -1 padded
    face_normals: torch.Tensor,  # (F, 3)
    n_iter: int = 60,
    depth_direction: torch.Tensor | None = None,
    use_depth: bool = False,
) -> torch.Tensor:
    """Iteratively move each vertex by the mean over adjacent faces of
    ((c_f - v) . n_f) n_f — integrating the predicted normal field."""
    n_faces = fv_indices.shape[0]
    valid = vf_indices >= 0
    v_adj = torch.clamp(valid.sum(-1, keepdim=True), min=1).to(points.dtype)
    vf_safe = torch.where(valid, vf_indices, torch.full_like(vf_indices, n_faces))
    zero = face_normals.new_zeros((1, 3))
    adj_n = torch.cat([face_normals, zero])[vf_safe]  # (N, K, 3)
    pts = points
    for _ in range(n_iter):
        face_cent = pts[fv_indices].mean(dim=1)
        v_cx = torch.cat([face_cent, zero])[vf_safe] - pts[:, None, :]
        d = (adj_n * v_cx).sum(-1, keepdim=True)
        move = (adj_n * d).sum(dim=1) / v_adj
        if use_depth:
            move = (move * depth_direction).sum(1, keepdim=True) * depth_direction
        pts = pts + move
    return pts


_PINNED_STATE: dict | None = None  # live modules displaced by a snapshot


def _package_modules() -> list[str]:
    return [m for m in list(sys.modules) if m == _PKG or m.startswith(_PKG + ".")]


def _import_pinned(run_dir: str):
    """Import the snapshot of this package saved under `run_dir/code_bak`,
    REPLACING the live package in sys.modules, and return its infer.predict
    module — so inference runs the training-time code (reference:
    code/test_dual.py:127-128 `sys.path.insert(0, bak_dir)`).  Returns None
    when the run has no snapshot of this package.  Process-global while the
    snapshot is in use (function-level imports inside snapshot code must
    also resolve to the snapshot); batch entries (predict_dir) call
    `unpin_live_package` when done, so that a train -> predict chain, or a
    test suite, does not run the rest of the process on the snapshot.

    A second pin while one is held replaces the held snapshot and keeps the
    live package the first displaced, so one unpin restores it.

    The snapshot's modules count their kernel launches in the live
    package's counters (every `LAUNCHES` and `PRODUCTS` of the snapshot is
    rebound to the live dict), so a process has one place to read them."""
    global _PINNED_STATE
    bak = os.path.abspath(os.path.join(run_dir, "code_bak"))
    if not os.path.isdir(os.path.join(bak, _PKG)):
        return None
    held = _PINNED_STATE
    current = {m: sys.modules[m] for m in _package_modules()}
    # while a pin is held, the modules in sys.modules are its snapshot's: the
    # live package stays the one that pin displaced
    live = held["live"] if held else current
    for m in current:
        del sys.modules[m]
    if held and held["bak"] in sys.path:
        sys.path.remove(held["bak"])
    sys.path.insert(0, bak)
    try:
        mod = importlib.import_module(__name__)
    except Exception:
        # a failed snapshot import must not leave a half-purged process
        sys.path.remove(bak)
        for m in _package_modules():
            del sys.modules[m]
        sys.modules.update(current)
        if held:
            sys.path.insert(0, held["bak"])
        raise
    for name in ("LAUNCHES", "PRODUCTS"):
        counters = getattr(live.get(_PKG + ".ops.banded_cuda"), name, None)
        if counters is not None:
            for m in _package_modules():
                if isinstance(getattr(sys.modules[m], name, None), dict):
                    setattr(sys.modules[m], name, counters)
    _PINNED_STATE = dict(live=live, bak=bak)
    return mod


def unpin_live_package() -> None:
    """Undo `_import_pinned`'s sys.modules takeover: restore the live
    modules.  Safe no-op when nothing is pinned.  Snapshot objects already
    constructed keep working through their own module references; only NEW
    imports resolve live again."""
    global _PINNED_STATE
    if not _PINNED_STATE:
        return
    bak = _PINNED_STATE["bak"]
    if bak in sys.path:
        sys.path.remove(bak)
    for m in _package_modules():
        del sys.modules[m]
    sys.modules.update(_PINNED_STATE["live"])
    _PINNED_STATE = None


class Predictor:
    """Denoises meshes (whole or patch-stitched) with given weights.

    `params` is a DualGNN state dict (params.from_jax_params, params.load_npz,
    a module's state_dict() or a checkpoint's).  Runs on CUDA unless
    device="cpu"."""

    def __init__(self, cfg: Config, params: dict, sub_size: int | None = None,
                 device=None):
        if getattr(cfg, "dynamic_pool", False) or getattr(cfg, "edge_weight_type", 10) in (3, 4, 5):
            raise ValueError("the Predictor serves the static DualGNN, as the JAX one: "
                             "a model trained with dynamic pooling is not served")
        self.cfg = cfg
        self.sub_size = sub_size or cfg.sub_size
        self.device = resolve_device(device)
        self.model = DualGNN(
            force_depth=cfg.force_depth, pool_type=cfg.pool_type,
            heads=cfg.heads, fusion=getattr(cfg, "fusion_features", 0),
            fc_dtype=(torch.bfloat16
                      if getattr(cfg, "fc_precision", "float32") == "bfloat16"
                      else None),
            device=self.device,
        )
        self.model.load_state_dict(params)
        self.model.eval()
        self._program = None  # capture.Program of the forward of the last plan
        self._halo = None  # (key, halo forward) of the last halo sample's shapes

    @classmethod
    def from_run(cls, run_dir: str, sub_size: int | None = None,
                 pinned: bool = True, device=None) -> "Predictor":
        """The predictor of a run directory (`params.json` and `ckpt_best.pkl`,
        else `ckpt_last.pkl`), written by this package's `train` or by the JAX
        package's.  `pinned=True` (default, reference parity): when the run
        carries a snapshot of this package, the model and inference code are
        imported FROM the snapshot, so predictions are immune to later edits
        of the installed package."""
        if pinned:
            mod = _import_pinned(run_dir)
            if mod is not None and mod.Predictor is not cls:
                return mod.Predictor.from_run(run_dir, sub_size, pinned=False,
                                              device=device)
        cfg = Config.from_json(os.path.join(run_dir, "params.json"))
        path = os.path.join(run_dir, "ckpt_best.pkl")
        if not os.path.exists(path):
            path = os.path.join(run_dir, "ckpt_last.pkl")
        state, _, _ = ckpt.load_checkpoint(path)
        return cls(cfg, state, sub_size, device)

    @torch.no_grad()
    @tracing.spanned("predict.forward")
    def forward(self, sample):
        """(positions, normals) of one padded sample, on the device.  On the
        card, one replay of the CUDA graph of the sample's merged plan (the
        JAX predictor's `jax.jit(model.apply)`): the patches of a mesh share
        the plan, so the first runs eagerly, as the capture's warm-up, and
        the others replay.  One graph is kept; a new plan replaces it.
        A replay returns the graph's own output tensors, which the next call
        overwrites: clone what is kept (`_apply` copies to the host).
        Eager on the CPU and under testing.eager_steps()."""
        sample = sample.to(self.device)
        if self.device.type != "cuda" or capture.EAGER:
            return self.model(sample)
        if self._program is None or capture.signature((sample,)) not in self._program.graphs:
            self._program = None  # the old graph's memory goes before the new capture
            self._program = capture.Program(self.model)
        return self._program(sample)

    def _apply(self, sample):
        vert_p, norm_p = self.forward(sample)
        return vert_p.cpu().numpy(), norm_p.cpu().numpy()

    # ------------------------------------------------------------------
    def patch_dataset(self, mesh_n: meshio.TriMesh) -> ds_mod.InMemoryDataset:
        """The mesh's patches as a dataset with one merged plan and one set
        of merged table widths, so every patch has the same shapes."""
        bc = self.cfg.build_config()
        entries = ds_mod.process_one_mesh(mesh_n, self.sub_size, None, bc)

        plan = None
        for bv, bf, _, _, _ in entries:
            p = builder.plan_for(bv, bf, bc.granularity)
            plan = p if plan is None else plan.merge(p)

        mem = ds_mod.InMemoryDataset.__new__(ds_mod.InMemoryDataset)
        mem.entries = entries
        mem.plan = plan
        mem.build_cfg = bc
        widths = None
        for bv, bf, meta_, _, _ in entries:
            w = builder.widths_for(bv, bf, meta_["fv_indices"],
                                   with_bands=bc.reorder)
            widths = w if widths is None else widths.merge(w)
        mem.widths = widths
        return mem

    @tracing.spanned("predict.mesh")
    def predict_mesh(self, mesh_n: meshio.TriMesh):
        """Returns (denoised positions before integration, face normals).
        Spans (while a profiler records): `predict.mesh` over
        `predict.host_build`, each patch's `predict.forward` and the
        `predict.stitch` of the patches' predictions."""
        with tracing.span("predict.host_build"):
            mem = self.patch_dataset(mesh_n)
        entries = mem.entries

        def unpermute(arr, perm):
            """Predictions are in the build-time RCM order; map back."""
            if perm is None:
                return arr
            out = np.empty_like(arr)
            out[perm] = arr
            return out

        if len(entries) == 1:
            vert_p, norm_p = self._apply(mem.get(0))
            with tracing.span("predict.stitch"):
                nv, nf = mesh_n.n_vertices, mesh_n.n_faces
                meta_ = entries[0][2]
                vp = unpermute(vert_p[:nv], meta_.get("perm_v"))
                np_arr = unpermute(norm_p[:nf], meta_.get("perm_f"))
        else:
            # overlap-averaged stitching (int32 counters)
            count_v = np.zeros((mesh_n.n_vertices, 1), dtype=np.int32)
            vp = np.zeros((mesh_n.n_vertices, 3), dtype=np.float32)
            np_arr = np.zeros((mesh_n.n_faces, 3), dtype=np.float32)
            for i, (bv, bf, meta_, v_idx, f_idx) in enumerate(entries):
                vert_p, norm_p = self._apply(mem.get(i))
                with tracing.span("predict.stitch"):
                    count_v[v_idx] += 1
                    vp[v_idx] += unpermute(vert_p[: bv.n_nodes], meta_.get("perm_v"))
                    np_arr[f_idx] += unpermute(norm_p[: bf.n_nodes], meta_.get("perm_f"))
            with tracing.span("predict.stitch"):
                vp /= np.maximum(count_v, 1)
                norms = np.linalg.norm(np_arr, axis=1, keepdims=True)
                np_arr /= np.maximum(norms, 1e-12)

        meta = entries[0][2]
        vp = vp / meta["scale"] + meta["centroid"]  # denormalize
        return vp.astype(np.float32), np_arr.astype(np.float32)

    def predict_mesh_halo(self, mesh_n: meshio.TriMesh, n_parts: int | None = None,
                          banded: bool = False, devices=None):
        """Halo-sharded whole-mesh prediction: the mesh is node-partitioned
        over n_parts parts and denoised as ONE graph.  `banded=True` runs the
        level-1 convs of each part through the banded aggregate.  Returns
        (denoised positions before integration, face normals), in the
        mesh's own order and frame.  With every part on one card the
        forward is one CUDA graph (parallel/halo_train.make_halo_forward),
        kept for the next mesh of the same exchange schedule and shapes;
        another replaces it."""
        from geobignn_tpu_torch.parallel import halo_train as ht
        from geobignn_tpu_torch.train.halo_trainer import part_devices

        # the parts' devices: `devices` as given, n_parts times the CPU for
        # a CPU predictor, else the first n_parts visible cards (all of
        # them by default, as the JAX predictor takes all its chips)
        if devices is not None:
            devs = part_devices(n_parts or len(devices), devices=devices)
        elif self.device.type == "cpu":
            if n_parts is None:
                raise ValueError("halo inference on the CPU needs n_parts")
            devs = part_devices(n_parts, "cpu")
        else:
            devs = part_devices(n_parts or torch.cuda.device_count(), self.device)
        sample = ht.build_halo_train_sample(mesh_n, None, self.cfg.build_config(), len(devs),
                                            banded=banded, devices=devs)
        key = (repr(sample.static), capture.signature(sample.arrays))
        if self._halo is None or self._halo[0] != key:
            self._halo = None  # the old graph's memory goes before the new capture
            self._halo = (key, ht.make_halo_forward(self.model, sample.static,
                                                    self.cfg.pool_type))
        vp, np_arr = ht.unshard_predictions(sample, *self._halo[1](sample.arrays))
        meta = sample.meta
        if "perm_v" in meta:  # back to the original vertex / face order
            u = np.empty_like(vp)
            u[meta["perm_v"]] = vp
            vp = u
            u = np.empty_like(np_arr)
            u[meta["perm_f"]] = np_arr
            np_arr = u
        vp = vp / meta["scale"] + meta["centroid"]
        np_arr = np_arr / np.maximum(np.linalg.norm(np_arr, axis=1, keepdims=True), 1e-12)
        return vp.astype(np.float32), np_arr.astype(np.float32)

    def denoise(self, mesh_n: meshio.TriMesh, n_update_iters: int = 60,
                halo_parts: int | None = None, halo_banded: bool = False,
                ) -> tuple[np.ndarray, np.ndarray]:
        """Full pipeline: predict + integrate normals; returns (V, Np).
        halo_parts > 1 takes the halo-sharded path, halo_banded its banded
        level-1 convs."""
        if halo_parts and halo_parts > 1:
            vp, np_arr = self.predict_mesh_halo(mesh_n, halo_parts, banded=halo_banded)
        else:
            vp, np_arr = self.predict_mesh(mesh_n)
        dev = self.device
        depth = None
        use_depth = self.cfg.force_depth
        if use_depth:
            d = np.maximum(np.linalg.norm(mesh_n.points, axis=1, keepdims=True), 1e-12)
            depth = torch.from_numpy((mesh_n.points / d).astype(np.float32)).to(dev)
        v = update_positions(
            torch.from_numpy(vp).to(dev),
            torch.from_numpy(mesh_n.fv_indices.astype(np.int64)).to(dev),
            torch.from_numpy(mesh_n.vf_indices.astype(np.int64)).to(dev),
            torch.from_numpy(np_arr).to(dev),
            n_iter=n_update_iters,
            depth_direction=depth,
            use_depth=use_depth,
        )
        return v.cpu().numpy(), np_arr


def _angular_error(np_pred: np.ndarray, n_true: np.ndarray) -> float:
    err = ((np_pred - n_true) ** 2).sum(1)
    val = np.clip(1.0 - err / 2.0, -1.0, 1.0)
    return float(np.degrees(np.arccos(val)).mean())


def predict_dir(
    run_dir: str,
    data_dir: str | None = None,
    dataset_root: str | None = None,
    sub_size: int | None = None,
    n_update_iters: int = 60,
    halo_parts: int | None = None,
    halo_banded: bool = False,
    device=None,
) -> dict:
    """Denoise every test mesh of a run's data_type; writes `{name}-60.obj`
    into `result_{flag}` and reports face-weighted angle1/angle2 means."""
    resolve_device(device)
    try:
        pred = Predictor.from_run(run_dir, sub_size, device=device)
        return predict_dir_body(pred, data_dir, dataset_root, n_update_iters,
                                halo_parts, halo_banded)
    finally:
        # version-pinning replaced the live package in sys.modules for the
        # duration of this batch; restore it so the rest of the process — a
        # train -> predict chain, a campaign, the test suite — runs live
        unpin_live_package()


def predict_dir_body(pred: Predictor, data_dir: str | None = None,
                     dataset_root: str | None = None,
                     n_update_iters: int = 60, halo_parts: int | None = None,
                     halo_banded: bool = False) -> dict:
    """Denoise every test mesh of the config's data_type (or every .obj of
    `data_dir`); writes `{name}-{n_update_iters}.obj` into `result_{flag}`
    and reports face-weighted angle1/angle2 means."""
    cfg = pred.cfg
    if data_dir is None:
        root = dataset_root or cfg.dataset_dir
        data_dir = os.path.join(root, cfg.data_type, "test")
        list_txt = (
            "test_list.txt"
            if os.path.exists(os.path.join(root, cfg.data_type, "test_list.txt"))
            else None
        )
        pairs = list(ds_mod.discover_mesh_pairs(root, cfg.data_type, "test", list_txt))
    else:
        pairs = [(p, None) for p in sorted(glob.glob(os.path.join(data_dir, "*.obj")))]

    result_dir = os.path.join(data_dir, f"result_{cfg.flag}")
    os.makedirs(result_dir, exist_ok=True)

    rows = []
    for noisy_path, orig_path in pairs:
        t0 = time.time()
        mesh_n = meshio.read_obj(noisy_path)
        v, np_arr = pred.denoise(mesh_n, n_update_iters, halo_parts=halo_parts,
                                 halo_banded=halo_banded)
        base = os.path.splitext(os.path.basename(noisy_path))[0]
        out_path = os.path.join(result_dir, f"{base}-{n_update_iters}.obj")
        meshio.write_obj(out_path, v, mesh_n.fv_indices)

        angle1 = angle2 = 0.0
        if orig_path is not None:
            mesh_o = meshio.read_obj(orig_path)
            nt = geometry.face_normals_np(mesh_o.points, mesh_o.fv_indices)
            angle1 = _angular_error(np_arr, nt)
            np2 = geometry.face_normals_np(v, mesh_n.fv_indices)
            angle2 = _angular_error(np2, nt)
        dt = time.time() - t0
        rows.append(dict(name=base, faces=mesh_n.n_faces, angle1=angle1,
                         angle2=angle2, seconds=dt))
        print(
            f"angle1: {angle1:9.6f}  angle2: {angle2:9.6f}  "
            f"faces: {mesh_n.n_faces:>6}  time: {dt:7.3f}s  '{base}'"
        )

    total_f = sum(r["faces"] for r in rows) or 1
    mean1 = sum(r["faces"] * r["angle1"] for r in rows) / total_f
    mean2 = sum(r["faces"] * r["angle2"] for r in rows) / total_f
    print(f"Num_face: {total_f}, angle_mean1: {mean1:.6f}, angle_mean2: {mean2:.6f}")
    return dict(rows=rows, angle_mean1=mean1, angle_mean2=mean2, result_dir=result_dir)
