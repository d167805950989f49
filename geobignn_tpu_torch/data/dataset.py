"""Mesh datasets: BFS submesh splitting, per-patch preprocessing, padding.

Counterpart of part of geobignn_tpu/data/dataset.py: `split_mesh`,
`process_one_mesh`, `discover_mesh_pairs`, `branch_messages`,
`BaseDualDataset.get` / `messages_per_sample` and `InMemoryDataset`, copied
so that patches and padded samples are identical to the JAX package's.  The
disk-backed `DualDataset`, its cache and size bucketing are not ported yet
(ROADMAP: modules to port, the rest of the package).
"""

from __future__ import annotations

import glob
import os
import sys
from collections import Counter

import numpy as np

from geobignn_tpu_torch import geometry, graphs, structs
from geobignn_tpu_torch.data import builder
from geobignn_tpu_torch.meshio import TriMesh, read_obj
from geobignn_tpu_torch.models.dual_gnn import CONV_SCHEDULE


def split_mesh(
    mesh: TriMesh, submesh_size: int
) -> list[tuple[TriMesh, np.ndarray | None, np.ndarray | None]]:
    """Split a big mesh into BFS patches of <= submesh_size faces.

    Seeds at the face farthest from the centroid, then repeatedly at the
    farthest unvisited face (reference code/dataset.py:157-193).  Returns
    [(submesh, V_idx, F_idx)]; single-patch meshes return [(mesh, None,
    None)]."""
    if mesh.n_faces <= submesh_size:
        return [(mesh, None, None)]
    centroid = mesh.points.mean(0)
    face_cent = mesh.points[mesh.fv_indices].mean(1)
    covered = np.zeros(mesh.n_faces, dtype=bool)
    seed = int(np.argmax(((face_cent - centroid) ** 2).sum(1)))
    out = []
    while True:
        sel = graphs.grow_patch(
            mesh.fv_indices, mesh.vf_indices, seed, max_faces=submesh_size
        )
        covered[sel] = True
        v_idx, f_new = graphs.extract_submesh(mesh.fv_indices, sel)
        out.append((TriMesh(mesh.points[v_idx], f_new), v_idx, sel))
        left = np.where(~covered)[0]
        if left.size == 0:
            return out
        seed = int(left[np.argmax(((face_cent[left] - centroid) ** 2).sum(1))])


def process_one_mesh(
    noisy_path_or_mesh,
    submesh_size: int,
    original_path_or_mesh=None,
    build_cfg: builder.BuildConfig = builder.BuildConfig(),
    filter_patch_count: int = 0,
) -> list:
    """Preprocess one (noisy, original) pair into raw sub-samples.

    Returns [(bv, bf, meta, V_idx, F_idx)].  The full-mesh centroid/scale is
    recorded on every patch (normalization is global, reference
    code/dataset.py:140,151-152).  The JAX counterpart's on-disk cache is
    not ported (inference passes no cache directory)."""
    mesh_n = (
        read_obj(noisy_path_or_mesh)
        if isinstance(noisy_path_or_mesh, str)
        else noisy_path_or_mesh
    )
    mesh_o = (
        read_obj(original_path_or_mesh)
        if isinstance(original_path_or_mesh, str)
        else original_path_or_mesh
    )
    _, centroid, scale = geometry.center_and_scale_np(
        mesh_n.points, mesh_n.ev_indices, build_cfg.scale_type
    )

    results = []
    patches = split_mesh(mesh_n, submesh_size)
    for sub_n, v_idx, f_idx in patches:
        if len(patches) > 1 and sub_n.n_faces <= filter_patch_count:
            continue
        sub_o = None
        if mesh_o is not None:
            sub_o = mesh_o if v_idx is None else TriMesh(
                mesh_o.points[v_idx], sub_n.fv_indices.copy()
            )
        # patches normalize in the FULL mesh's frame
        bv, bf, meta = builder.build_raw(sub_n, sub_o, build_cfg, centroid, scale)
        results.append((bv, bf, meta, v_idx, f_idx))
    return results


def discover_mesh_pairs(
    root_dir: str, data_type: str, split: str,
    data_list_txt: str | None = None,
) -> list[tuple[str, str]]:
    """(noisy_path, original_path) pairs of a split: `{name}_n*.obj` glob
    under noisy/ against original/{name}.obj, filtered by the split list
    when given (reference discovery, code/dataset.py:83-103)."""
    data_dir = os.path.join(root_dir, data_type, split)
    noisy_dir = os.path.join(data_dir, "noisy")
    orig_dir = os.path.join(data_dir, "original")
    if data_list_txt is not None:
        # a requested split list MUST exist — silently globbing instead
        # would change the split composition (e.g. leak held-out shapes
        # into training) without any signal
        with open(os.path.join(root_dir, data_type, data_list_txt)) as f:
            names = [ln.strip() for ln in f if ln.strip()]
    else:
        names = sorted(
            os.path.splitext(os.path.basename(p))[0]
            for p in glob.glob(os.path.join(orig_dir, "*.obj"))
        )
    pairs: list[tuple[str, str]] = []
    for name in names:
        for np_file in sorted(
            glob.glob(os.path.join(noisy_dir, f"{name}_n*.obj"))
        ):
            pairs.append((np_file, os.path.join(orig_dir, f"{name}.obj")))
    return pairs


def branch_messages(b: builder.RawBranch) -> int:
    """Real (unpadded) FeaStConv edge messages per forward of one branch:
    per-level conv counts from the model's CONV_SCHEDULE times the REAL edge
    count at each U-Net level — the numerator of the edges/s metric,
    counted as the JAX package counts it."""
    per_lvl = Counter(lvl for _, lvl, _, _ in CONV_SCHEDULE)
    e = (b.edge_index.shape[1], b.specs[0].edge_index.shape[1],
         b.specs[1].edge_index.shape[1])
    return sum(per_lvl[lvl] * e[lvl] for lvl in range(3))


class BaseDualDataset:
    """Entries + shared SizePlan/TableWidths + padding-on-get.  `get`
    attaches the tables and band structures (ops/table.py, attach_band)
    with dataset-merged widths so every sample has one padded shape; set
    `tables = False` to serve COO-only samples."""

    entries: list
    plan: structs.SizePlan | None
    widths: "builder.TableWidths | None" = None
    tables: bool = True

    def _compute_plan(self, granularity: int):
        plan, widths = None, None
        for bv, bf, meta, _, _ in self.entries:
            p = builder.plan_for(bv, bf, granularity)
            plan = p if plan is None else plan.merge(p)
            w = builder.widths_for(
                bv, bf, meta["fv_indices"],
                with_bands=self.build_cfg.reorder,
            )
            widths = w if widths is None else widths.merge(w)
        self.plan = plan
        self.widths = widths

    def __len__(self) -> int:
        return len(self.entries)

    def messages_per_sample(self) -> np.ndarray:
        """(n_entries,) int64 real conv edge-messages per training forward
        (both branches) — lets the trainer log edges/s per epoch."""
        return np.asarray([branch_messages(bv) + branch_messages(bf)
                           for bv, bf, _, _, _ in self.entries], dtype=np.int64)

    def get(self, idx: int, plan: structs.SizePlan | None = None) -> structs.DualSample:
        bv, bf, meta, _, _ = self.entries[idx]
        widths = getattr(self, "widths", None)
        plan = plan or self.plan
        gv = builder._pad_branch(bv, plan.v)
        gf = builder._pad_branch(bf, plan.f)
        trash_v = plan.v.n1 - 1
        fv = np.full((plan.f.n1, 3), trash_v, dtype=np.int32)
        fv[: meta["fv_indices"].shape[0]] = meta["fv_indices"]
        pairs = graphs.build_edge_fv(meta["fv_indices"])
        n_pairs_pad = 3 * plan.f.n1
        sample = structs.DualSample(
            v=gv,
            f=gf,
            fv_indices=fv,
            edge_dual_v=structs.make_index_map(pairs[1], n_pairs_pad, plan.v.n1),
            edge_dual_f=structs.make_index_map(pairs[0], n_pairs_pad, plan.f.n1),
            centroid=meta["centroid"].astype(np.float32),
            scale=np.float32(meta["scale"]),
        )
        if getattr(self, "tables", True):
            sample = builder.attach_tables(sample, widths)
        return sample


class InMemoryDataset(BaseDualDataset):
    """Dataset over in-memory (noisy, original) TriMesh pairs (tests,
    synthetic corpora, benchmark inputs)."""

    def __init__(
        self,
        mesh_pairs: list[tuple[TriMesh, TriMesh | None]],
        build_cfg: builder.BuildConfig = builder.BuildConfig(),
        submesh_size: int = sys.maxsize,
    ):
        self.build_cfg = build_cfg
        self.entries = []
        for m_n, m_o in mesh_pairs:
            self.entries.extend(
                process_one_mesh(m_n, submesh_size, m_o, build_cfg)
            )
        self._compute_plan(build_cfg.granularity)
