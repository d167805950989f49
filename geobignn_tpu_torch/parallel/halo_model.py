"""Halo-sharded graph U-Net: the whole multi-level model over node parts.

Counterpart of geobignn_tpu/parallel/halo_model.py.  With owner-constrained
pooling hierarchies (pool/hierarchy.build_hierarchy(owner=)) every cluster
lives on one part, so pooling and unpooling are local gathers and scatters
in per-part slot spaces; only the convolutions exchange halos (one
exchange per conv), and the facet branch's corner positions cross parts
once (`send_fv`).

Host half (numpy, bit-equal to JAX): `build_halo_branch` / `build_halo_dual`
and the dicts of per-part arrays the device half consumes.  Device half
(torch, lists of P per-part tensors, parallel/partition.py): `halo_gnn_module`
and `halo_dual_gnn`, which take the port's DualGNN parameters in the JAX
tree layout (params.nest: {"gnn_v": {"l_conv1": {"u": ...}}, "fc_v1": ...}).
The parameters stay where they are; each part computes with a copy on its
device, so autograd sums every part's gradient into them (the psum of the
JAX transpose).  As the single-device model, the table and COO convs and the
fc heads run under `dual_gnn._remat` (only their inputs are kept for the
backward: at 1,310,720 faces over 8 parts the kept intermediates would
outgrow an 80 GB card); the banded aggregate is left out.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from geobignn_tpu_torch import geometry
from geobignn_tpu_torch.models import dual_gnn
from geobignn_tpu_torch.ops import banded as band_ops
from geobignn_tpu_torch.ops import segment
from geobignn_tpu_torch.ops import table as tbl
from geobignn_tpu_torch.parallel import partition as hp
from geobignn_tpu_torch.pool.hierarchy import PoolLevelSpec

@dataclasses.dataclass
class HaloBranch:
    """Per-part (leading axis P) multi-level halo structure."""

    levels: list[hp.HaloSharding]  # 3 levels
    clusters_loc: list[np.ndarray]  # 4 x (P, n_loc_in) -> local coarse slot
    unpool1_loc: np.ndarray  # (P, n_loc_l1) -> local level-2 slot
    unpool2_loc: np.ndarray  # (P, n_loc_l2) -> local level-3 slot
    tables: list[dict] | None = None  # 3 x halo_tables dict (scatter-free convs)
    band0: dict | None = None  # level-1 halo_band_arrays (banded conv)


def _localize_map(
    global_map: np.ndarray,  # fine global id -> coarse global id
    sh_in: hp.HaloSharding,
    sh_out: hp.HaloSharding,
) -> np.ndarray:
    """Per-part local index map: fine local slot -> coarse local slot.
    Requires owner(fine) == owner(coarse) (partition-constrained)."""
    out = np.full((sh_in.n_parts, sh_in.n_loc), sh_out.n_loc - 1, dtype=np.int32)
    assert (sh_out.owner[global_map] == sh_in.owner).all(), "cluster crosses partitions"
    out[sh_in.owner, sh_in.slot_of] = sh_out.slot_of[global_map]
    return out


def build_halo_branch(
    edge_index: np.ndarray,
    edge_weight: np.ndarray | None,
    n_nodes: int,
    specs: list[PoolLevelSpec],
    owner: np.ndarray,
    granularity: int = 8,
    with_tables: bool = True,
    banded: bool = False,
) -> HaloBranch:
    """specs must come from build_hierarchy(..., owner=owner).

    `banded=True` RCM-orders each part's local slot space and runs the
    level-1 convs through the banded aggregate (intra edges) plus a
    dense-table boundary correction (partition.halo_feast_conv_banded);
    its n_loc is rounded to the band's tile.  A band wider than
    ops/banded.MAX_BAND_TILE takes the table path, as the single-device
    builder does.  Levels 2-3 keep the table path."""
    band0 = None
    if banded:
        pri, bw = hp.partition_rcm_priority(edge_index, n_nodes, owner)
        tile = band_ops.pick_tile(bw)
        if tile > band_ops.MAX_BAND_TILE:
            banded = False
        else:
            sh1 = hp.build_halo_sharding(edge_index, edge_weight, n_nodes, owner,
                                         granularity, priority=pri, n_granularity=tile)
            band0 = hp.halo_band_arrays(sh1, tile, granularity)
    if not banded:
        sh1 = hp.build_halo_sharding(edge_index, edge_weight, n_nodes, owner, granularity)
    s1, s2 = specs
    assert s1.owner_out is not None and s2.owner_out is not None

    # intermediate shardings after each matching round (slot spaces only)
    def slots(n_out, clusters, own_in):
        own = np.zeros(n_out, dtype=owner.dtype)
        own[clusters] = own_in
        return hp.build_halo_sharding(np.zeros((2, 0), np.int64), None, n_out, own,
                                      granularity)

    sh_m1 = slots(s1.step_sizes[0], s1.step_clusters[0], owner)
    sh2 = hp.build_halo_sharding(s1.edge_index, s1.edge_weight, s1.n_out, s1.owner_out,
                                 granularity)
    sh_m2 = slots(s2.step_sizes[0], s2.step_clusters[0], s1.owner_out)
    sh3 = hp.build_halo_sharding(s2.edge_index, s2.edge_weight, s2.n_out, s2.owner_out,
                                 granularity)

    clusters_loc = [
        _localize_map(s1.step_clusters[0], sh1, sh_m1),
        _localize_map(s1.step_clusters[1], sh_m1, sh2),
        _localize_map(s2.step_clusters[0], sh2, sh_m2),
        _localize_map(s2.step_clusters[1], sh_m2, sh3),
    ]
    tables = (
        # level 0 is covered by band0 in banded mode
        [None if band0 is not None and i == 0 else hp.halo_tables(sh, granularity)
         for i, sh in enumerate((sh1, sh2, sh3))]
        if with_tables else None
    )
    return HaloBranch(
        levels=[sh1, sh2, sh3], clusters_loc=clusters_loc,
        unpool1_loc=_localize_map(s1.unpool, sh1, sh2),
        unpool2_loc=_localize_map(s2.unpool, sh2, sh3),
        tables=tables, band0=band0,
    )


def branch_static(hb: HaloBranch) -> dict:
    """The static exchange schedules per level (Python tuples, not arrays)."""
    return {f"rounds{i}": sh.rounds for i, sh in enumerate(hb.levels)}


def dual_static(hd: "HaloDual") -> dict:
    return dict(v=branch_static(hd.v), f=branch_static(hd.f), fv_rounds=hd.fv_rounds)


def branch_device_arrays(hb: HaloBranch) -> dict:
    """The (P, ...) arrays the device half consumes, as one dict."""
    d = {}
    for i, sh in enumerate(hb.levels):
        covered = (hb.band0 is not None and i == 0) or (
            hb.tables is not None and hb.tables[i] is not None)
        if not covered:  # the COO list only when it is the active path
            d[f"ei{i}"] = sh.edge_index
        d[f"deg{i}"] = sh.deg
        d[f"send{i}"] = sh.send_idx
        d[f"mask{i}"] = sh.node_mask
    if hb.tables is not None:
        for i, tab in enumerate(hb.tables):
            if tab is not None:
                d[f"tab{i}"] = tab
    if hb.band0 is not None:
        d["band0"] = hb.band0
    for i, cl in enumerate(hb.clusters_loc):
        d[f"cl{i}"] = cl
    d["unpool1"] = hb.unpool1_loc
    d["unpool2"] = hb.unpool2_loc
    return d


@dataclasses.dataclass
class HaloDual:
    """Both branches + the cross-domain face -> vertex halo relation."""

    v: HaloBranch
    f: HaloBranch
    fv_loc: np.ndarray  # (P, n_loc_f, 3) into [v local slots | fv halo bufs]
    send_fv: np.ndarray  # (P, h_total) vertex local slots sent, round-major
    fv_rounds: tuple = ()  # static exchange schedule of the fv gather
    fv_rev: np.ndarray | None = None  # (P, n_ext_v, R) reverse table of fv_loc
    send_fv_rev: np.ndarray | None = None  # (P, n_loc_v, R_s) reverse of send_fv


def build_gather_halo(
    indices: np.ndarray,  # (M, K) global src ids per row
    owner_rows: np.ndarray,  # (M,) part per row
    row_slot_of: np.ndarray,  # (M,) local slot per row
    n_loc_rows: int,
    sh_src: hp.HaloSharding,
    granularity: int = 8,
):
    """Halo structure of an arbitrary gather relation (face -> corner
    vertices): per destination part, the remote source rows it needs, as
    send_idx (source side, round-major), the localized index table
    (destination side) and the static `rounds` schedule."""
    p_cnt = sh_src.n_parts
    src_owner, src_slot = sh_src.owner, sh_src.slot_of
    m, k = indices.shape

    halo: list[list[np.ndarray]] = [[None] * p_cnt for _ in range(p_cnt)]
    cut = np.zeros((p_cnt, p_cnt), np.int64)
    for p in range(p_cnt):
        used = np.unique(indices[owner_rows == p].reshape(-1))
        for q in range(p_cnt):
            remote = np.empty(0, dtype=np.int64) if q == p else used[src_owner[used] == q]
            halo[p][q] = remote
            cut[p, q] = remote.size
    rounds, offset_of, h_total = hp.color_rounds(cut, granularity)

    trash_src = sh_src.n_loc - 1
    send_idx = np.full((p_cnt, h_total), trash_src, dtype=np.int32)
    pos: list[dict] = [dict() for _ in range(p_cnt)]
    for p in range(p_cnt):
        for q in range(p_cnt):
            nodes = halo[p][q]
            if nodes.size:
                off = int(offset_of[p, q])
                send_idx[q, off : off + nodes.size] = src_slot[nodes]
                base = sh_src.n_loc + off
                for j, g in enumerate(nodes):
                    pos[p][int(g)] = base + j

    table = np.full((p_cnt, n_loc_rows, k), trash_src, dtype=np.int32)
    for r in range(m):
        p = owner_rows[r]
        s = row_slot_of[r]
        for c in range(k):
            g = int(indices[r, c])
            table[p, s, c] = src_slot[g] if src_owner[g] == p else pos[p][g]
    return table, send_idx, rounds


def build_halo_dual(
    ei_v, w_v, n_v, specs_v, owner_v,
    ei_f, w_f, fv_indices, specs_f,
    granularity: int = 8,
    banded: bool = False,
) -> HaloDual:
    """Faces are owned by the part of their first corner; both hierarchies
    must be owner-constrained."""
    n_f = fv_indices.shape[0]
    owner_f = owner_v[fv_indices[:, 0]].astype(np.int32)
    hb_v = build_halo_branch(ei_v, w_v, n_v, specs_v, owner_v, granularity,
                             banded=banded)
    hb_f = build_halo_branch(ei_f, w_f, n_f, specs_f, owner_f, granularity,
                             banded=banded)
    fv_loc, send_fv, fv_rounds = build_gather_halo(
        fv_indices.astype(np.int64), owner_f,
        hb_f.levels[0].slot_of[:n_f].astype(np.int64),
        hb_f.levels[0].n_loc, hb_v.levels[0], granularity,
    )

    # reverse tables: the corner gather and its halo send scatter-free in
    # the backward
    p_cnt = fv_loc.shape[0]
    n_loc_v = hb_v.levels[0].n_loc
    h_total = send_fv.shape[-1]
    src_mask = hp._ext_src_mask(n_loc_v, n_loc_v + h_total)
    revs, rev_sends, r_max, rs_max = [], [], 1, 1
    for p in range(p_cnt):
        r_p, rr = tbl.reverse_table_np(fv_loc[p], n_loc_v + h_total, src_mask=src_mask,
                                       granularity=granularity)
        s_p, rs = tbl.reverse_table_np(send_fv[p].reshape(-1, 1), n_loc_v,
                                       src_mask=src_mask[:n_loc_v], granularity=granularity)
        revs.append(r_p)
        rev_sends.append(s_p)
        r_max, rs_max = max(r_max, rr), max(rs_max, rs)
    return HaloDual(
        v=hb_v, f=hb_f, fv_loc=fv_loc, send_fv=send_fv, fv_rounds=fv_rounds,
        fv_rev=np.stack([hp._repad(r, r_max, fv_loc[0].size) for r in revs]),
        send_fv_rev=np.stack([hp._repad(s, rs_max, h_total) for s in rev_sends]),
    )


def dual_device_arrays(hd: HaloDual) -> dict:
    d = dict(v=branch_device_arrays(hd.v), f=branch_device_arrays(hd.f),
             fv=hd.fv_loc, send_fv=hd.send_fv)
    if hd.fv_rev is not None:
        d["fv_rev"] = hd.fv_rev
        d["send_fv_rev"] = hd.send_fv_rev
    return d


def part_tensors(tree, p: int, device):
    """Part p's slice of a dict of stacked (P, ...) arrays, as tensors on
    `device`; indices int64 (the int8 band mask stays int8), as structs.py
    puts host arrays on a device."""
    if isinstance(tree, dict):
        return {k: part_tensors(v, p, device) for k, v in tree.items()}
    a = np.asarray(tree)[p]
    if a.dtype.kind in "iu" and a.dtype != np.int8:
        a = a.astype(np.int64)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


# --------------------------------------------------------------------------
# device half: lists of P per-part tensors
# --------------------------------------------------------------------------

def _f32(t):
    """A head's output in float32 (float64 stays float64, as DualGNN's)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _pool_local(x, cl, n_out: int, pool_type: str = "max"):
    if pool_type == "max":
        return segment.segment_max(x, cl, n_out)
    return segment.segment_mean(x, cl, n_out)


def per_device(tree: dict, devices: list, dt=None) -> list:
    """One copy of a parameter (sub)tree per part, on the part's device (in
    dt when given); parts on one device share one copy."""
    copies: dict = {}

    def moved(node, dev):
        if isinstance(node, dict):
            return {k: moved(v, dev) for k, v in node.items()}
        node = node.to(dev)
        return node if dt is None else node.to(dt)

    return [copies.setdefault(dev, moved(tree, dev)) for dev in devices]


def halo_gnn_module(params: dict, xs: list, ds: list, sd: dict, pool_type: str = "max",
                    compute_dtype=None) -> list:
    """The halo U-Net over P parts, consuming models.dual_gnn.GNNModule's
    parameters as a tree (keys l_conv1..4, r_conv1..4).  `ds` = each part's
    slice of branch_device_arrays, on its device; `sd` = branch_static.
    `compute_dtype` casts activations and conv parameters, as GNNModule.
    Returns each part's (n_loc_l1, 32) features."""
    dt = compute_dtype or torch.float32
    devices = [x.device for x in xs]
    xs = [x.to(dt) for x in xs]
    local = {name: per_device(params[name], devices, dt) for name in params}

    def conv(name, xs, lvl):
        rounds = sd[f"rounds{lvl}"]
        args = ([d[f"deg{lvl}"] for d in ds], [d[f"send{lvl}"] for d in ds], rounds,
                [d[f"mask{lvl}"] for d in ds])
        if f"band{lvl}" in ds[0]:  # banded aggregate + boundary-table correction
            return hp.halo_feast_conv_banded(local[name], xs, [d[f"band{lvl}"] for d in ds],
                                             *args)
        if f"tab{lvl}" in ds[0]:  # scatter-free dense tables (default)
            return dual_gnn._remat(hp.halo_feast_conv_table, local[name], xs,
                                   [d[f"tab{lvl}"] for d in ds], *args)
        return dual_gnn._remat(hp.halo_feast_conv, local[name], xs,
                               [d[f"ei{lvl}"] for d in ds], *args)

    def pool(xs, a, b, size_key):
        xs = [_pool_local(x, d[a], d[b].shape[0], pool_type) for x, d in zip(xs, ds)]
        return [_pool_local(x, d[b], d[size_key].shape[0], pool_type)
                for x, d in zip(xs, ds)]

    # the model's LeakyReLU, looked up at each call (testing.same_branches
    # holds its branches)
    act = lambda outs: [dual_gnn._act(o) for o in outs]
    x1 = act(conv("l_conv1", xs, 0))
    x2 = act(conv("l_conv2", pool(x1, "cl0", "cl1", "mask1"), 1))
    x3 = act(conv("l_conv3", pool(x2, "cl2", "cl3", "mask2"), 2))
    x3 = act(conv("l_conv4", x3, 2))

    u2 = conv("r_conv1", [x[d["unpool2"]] for x, d in zip(x3, ds)], 1)
    x2 = act(conv("r_conv2", [torch.cat(pair, dim=1) for pair in zip(x2, u2)], 1))
    u1 = conv("r_conv3", [x[d["unpool1"]] for x, d in zip(x2, ds)], 0)
    return act(conv("r_conv4", [torch.cat(pair, dim=1) for pair in zip(x1, u1)], 0))


def halo_dual_gnn(params: dict, xvs: list, xfs: list, ds: list, sd: dict,
                  pool_type: str = "max", depth_directions: list | None = None,
                  compute_dtype=None):
    """The DualGNN forward over halo parts; consumes models.DualGNN's
    parameters as a tree.  `sd` = dual_static.  `depth_directions` (each
    (n_loc_v, 3)): the force_depth head, engaged when fc_v2 regresses one
    channel.  `compute_dtype` (bf16) runs the U-Nets and fc heads in it; the
    residual add, the cross-domain geometry and the normalization stay
    float32.  Returns each part's (vert_p, norm_p)."""
    if "fusion" in params:
        raise ValueError("the halo model has no fusion layer, as the JAX one")
    dt = compute_dtype or torch.float32
    devices = [x.device for x in xvs]
    heads = {k: per_device(params[k], devices) for k in ("fc_v1", "fc_v2", "fc_f1", "fc_f2")}

    def dense(name, p, x):
        q = heads[name][p]
        return x @ q["kernel"].to(x.dtype) + q["bias"].to(x.dtype)

    def head(fc1, fc2, p, f):  # rematerialized: the (n_loc, 1024) hidden is not kept
        return _f32(dual_gnn._remat(
            lambda f: dense(fc2, p, dual_gnn._act(dense(fc1, p, f))), f))

    feat_v = halo_gnn_module(params["gnn_v"], xvs, [d["v"] for d in ds], sd["v"],
                             pool_type, dt)
    vert_ps = []
    for p, (x, f) in enumerate(zip(xvs, feat_v)):
        out_v = head("fc_v1", "fc_v2", p, f)
        if params["fc_v2"]["kernel"].shape[-1] == 1:  # force_depth head
            if depth_directions is None:
                raise ValueError(
                    "checkpoint has a force_depth (1-channel) vertex head but "
                    "no depth_direction was provided (build with with_depth)")
            out_v = out_v * depth_directions[p]
        vert_ps.append(out_v + x[:, :3])

    # cross-domain: exchange corner vertex positions, rebuild facet features
    ext_v = hp.halo_exchange(vert_ps, [d["send_fv"] for d in ds], sd["fv_rounds"],
                             [d["send_fv_rev"] for d in ds] if "send_fv_rev" in ds[0] else None)
    xf_full = []
    for ext, d, xf in zip(ext_v, ds, xfs):
        corners = tbl.table_gather(ext, d["fv"], d.get("fv_rev"))  # (n_loc_f, 3, 3)
        face_cent = corners.mean(dim=1)
        face_norm = geometry.safe_normalize(torch.linalg.cross(
            corners[:, 1] - corners[:, 0], corners[:, 2] - corners[:, 0], dim=-1))
        xf_full.append(torch.cat([xf, face_cent, face_norm], dim=1))

    feat_f = halo_gnn_module(params["gnn_f"], xf_full, [d["f"] for d in ds], sd["f"],
                             pool_type, dt)
    norm_ps = [geometry.safe_normalize(head("fc_f1", "fc_f2", p, f))
               for p, f in enumerate(feat_f)]
    return vert_ps, norm_ps
