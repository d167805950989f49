"""Mesh datasets: BFS submesh splitting, per-patch preprocessing, padding.

Counterpart of part of geobignn_tpu/data/dataset.py: `split_mesh`,
`process_one_mesh`, `discover_mesh_pairs`, `branch_messages`,
`BaseDualDataset.get` / `messages_per_sample`, `InMemoryDataset` and the
disk-backed `DualDataset` with its content-hashed preprocessing cache, copied
so that patches, padded samples and cache files are identical to the JAX
package's: the same file names (`_file_key` of the noisy .obj, `_config_key`
of the BuildConfig) and the same arrays, so either package reads a cache the
other wrote; and size bucketing (`bucketize`): one SizePlan and TableWidths
per geometric size bucket, computed as the JAX package computes them.
"""

from __future__ import annotations

import dataclasses
import glob
import hashlib
import json
import math
import os
import sys
from collections import Counter

import numpy as np

from geobignn_tpu_torch import geometry, graphs, structs
from geobignn_tpu_torch.data import builder
from geobignn_tpu_torch.meshio import TriMesh, read_obj
from geobignn_tpu_torch.models.dual_gnn import CONV_SCHEDULE
from geobignn_tpu_torch.pool.hierarchy import PoolLevelSpec

_BUILD_VERSION = 4  # the JAX package's: bumped on build-semantics changes, so
# content+config caches invalidate in both packages together


def _config_key(cfg: builder.BuildConfig) -> str:
    d = dataclasses.asdict(cfg)
    d["_build_version"] = _BUILD_VERSION
    return hashlib.sha256(
        json.dumps(d, sort_keys=True, default=str).encode()
    ).hexdigest()[:12]


def _file_key(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()[:16]


# --------------------------------------------------------------------------
# raw-sample (de)serialization
# --------------------------------------------------------------------------

def _branch_to_dict(prefix: str, b: builder.RawBranch) -> dict:
    d = {
        f"{prefix}_x": b.x,
        f"{prefix}_ei": b.edge_index,
        f"{prefix}_w": b.edge_weight,
        f"{prefix}_n": np.int64(b.n_nodes),
    }
    if b.y is not None:
        d[f"{prefix}_y"] = b.y
    if b.depth_direction is not None:
        d[f"{prefix}_depth"] = b.depth_direction
    for i, s in enumerate(b.specs):
        d[f"{prefix}_s{i}_c0"] = s.step_clusters[0]
        d[f"{prefix}_s{i}_c1"] = s.step_clusters[1]
        d[f"{prefix}_s{i}_sizes"] = np.asarray(s.step_sizes, dtype=np.int64)
        d[f"{prefix}_s{i}_ei"] = s.edge_index
        d[f"{prefix}_s{i}_w"] = s.edge_weight
        d[f"{prefix}_s{i}_unpool"] = s.unpool
    return d


def _branch_from_dict(prefix: str, d) -> builder.RawBranch:
    specs = []
    for i in range(2):
        sizes = [int(v) for v in d[f"{prefix}_s{i}_sizes"]]
        specs.append(
            PoolLevelSpec(
                step_clusters=[d[f"{prefix}_s{i}_c0"], d[f"{prefix}_s{i}_c1"]],
                step_sizes=sizes,
                unpool=d[f"{prefix}_s{i}_unpool"],
                edge_index=d[f"{prefix}_s{i}_ei"],
                edge_weight=d[f"{prefix}_s{i}_w"],
                n_out=sizes[-1],
            )
        )
    return builder.RawBranch(
        x=d[f"{prefix}_x"],
        y=d[f"{prefix}_y"] if f"{prefix}_y" in d else None,
        edge_index=d[f"{prefix}_ei"],
        edge_weight=d[f"{prefix}_w"],
        specs=specs,
        n_nodes=int(d[f"{prefix}_n"]),
        depth_direction=d[f"{prefix}_depth"] if f"{prefix}_depth" in d else None,
    )


def save_raw_sample(path, bv, bf, meta, v_idx=None, f_idx=None):
    d = _branch_to_dict("v", bv) | _branch_to_dict("f", bf)
    d["centroid"] = meta["centroid"]
    d["scale"] = np.float32(meta["scale"])
    d["fv_indices"] = meta["fv_indices"]
    if "perm_v" in meta:
        d["perm_v"] = meta["perm_v"]
        d["perm_f"] = meta["perm_f"]
    if v_idx is not None:
        d["V_idx"] = v_idx
    if f_idx is not None:
        d["F_idx"] = f_idx
    np.savez_compressed(path, **d)


def load_raw_sample(path):
    with np.load(path) as z:
        d = dict(z)
    bv = _branch_from_dict("v", d)
    bf = _branch_from_dict("f", d)
    meta = dict(
        centroid=d["centroid"], scale=float(d["scale"]), fv_indices=d["fv_indices"]
    )
    if "perm_v" in d:
        meta["perm_v"] = d["perm_v"]
        meta["perm_f"] = d["perm_f"]
    return bv, bf, meta, d.get("V_idx"), d.get("F_idx")


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
    cache_dir: str | None = None,
    filter_patch_count: int = 0,
) -> list:
    """Preprocess one (noisy, original) pair into raw sub-samples.

    Returns [(bv, bf, meta, V_idx, F_idx)].  The full-mesh centroid/scale is
    recorded on every patch (normalization is global, reference
    code/dataset.py:140,151-152).  Caches each patch when cache_dir given."""
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

    key = None
    if cache_dir is not None and isinstance(noisy_path_or_mesh, str):
        os.makedirs(cache_dir, exist_ok=True)
        key = _file_key(noisy_path_or_mesh) + "-" + _config_key(build_cfg)
        base = os.path.splitext(os.path.basename(noisy_path_or_mesh))[0]

    _, centroid, scale = geometry.center_and_scale_np(
        mesh_n.points, mesh_n.ev_indices, build_cfg.scale_type
    )

    results = []
    patches = split_mesh(mesh_n, submesh_size)
    for pi, (sub_n, v_idx, f_idx) in enumerate(patches):
        if len(patches) > 1 and sub_n.n_faces <= filter_patch_count:
            continue
        cache_path = None
        if key is not None:
            cache_path = os.path.join(cache_dir, f"{base}-{key}-p{pi}.npz")
            if os.path.exists(cache_path):
                results.append(load_raw_sample(cache_path))
                continue
        sub_o = None
        if mesh_o is not None:
            sub_o = mesh_o if v_idx is None else TriMesh(
                mesh_o.points[v_idx], sub_n.fv_indices.copy()
            )
        # patches normalize in the FULL mesh's frame
        bv, bf, meta = builder.build_raw(sub_n, sub_o, build_cfg, centroid, scale)
        entry = (bv, bf, meta, v_idx, f_idx)
        if cache_path is not None:
            save_raw_sample(cache_path, *entry)
        results.append(entry)
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
    bucket_of: list | None = None  # entry -> bucket id (bucketize())

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

    def bucketize(self, growth: float = 1.5) -> int:
        """Group entries into geometric size buckets, each with its own
        merged SizePlan and TableWidths; `get(idx)` then pads an entry to its
        bucket's plan instead of the dataset-wide one.  With `growth`-spaced
        bucket edges the padding is bounded by the growth factor, at the
        cost of one padded shape (one CUDA graph of the step) per bucket.
        Returns the number of buckets."""
        if growth <= 1.0:
            raise ValueError("growth must be > 1")
        sizes = [bv.n_nodes + bf.n_nodes for bv, bf, _, _, _ in self.entries]
        base = max(min(sizes), 1)
        raw = [int(math.floor(math.log(s / base) / math.log(growth) + 1e-9)) for s in sizes]
        buckets = sorted(set(raw))
        remap = {b: i for i, b in enumerate(buckets)}
        self.bucket_of = [remap[r] for r in raw]
        gran = self.build_cfg.granularity
        self._bucket_plans = [None] * len(buckets)
        self._bucket_widths = [None] * len(buckets)
        for i, (bv, bf, meta, _, _) in enumerate(self.entries):
            b = self.bucket_of[i]
            p = builder.plan_for(bv, bf, gran)
            w = builder.widths_for(bv, bf, meta["fv_indices"], with_bands=self.build_cfg.reorder)
            self._bucket_plans[b] = p if self._bucket_plans[b] is None else self._bucket_plans[b].merge(p)
            self._bucket_widths[b] = (w if self._bucket_widths[b] is None
                                      else self._bucket_widths[b].merge(w))
        return len(buckets)

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
        if plan is None and self.bucket_of is not None:
            plan = self._bucket_plans[self.bucket_of[idx]]
            widths = self._bucket_widths[self.bucket_of[idx]]
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


class DualDataset(BaseDualDataset):
    """Disk-backed dataset: discovery, preprocessing (cached under
    `{split}/processed_cache`), one shared SizePlan."""

    def __init__(
        self,
        root_dir: str,
        data_type: str,
        split: str = "train",
        data_list_txt: str | None = None,
        filter_patch_count: int = 0,
        submesh_size: int = sys.maxsize,
        build_cfg: builder.BuildConfig = builder.BuildConfig(),
        cache: bool = True,
    ):
        self.build_cfg = build_cfg
        self.data_dir = os.path.join(root_dir, data_type, split)
        self.pairs = discover_mesh_pairs(root_dir, data_type, split, data_list_txt)

        cache_dir = os.path.join(self.data_dir, "processed_cache") if cache else None
        self.entries = []
        for noisy, orig in self.pairs:
            self.entries.extend(
                process_one_mesh(
                    noisy, submesh_size, orig, build_cfg, cache_dir,
                    filter_patch_count if split == "train" else 0,
                )
            )

        self._compute_plan(build_cfg.granularity)
