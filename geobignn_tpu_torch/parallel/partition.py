"""Node-sharded graph partitioning with halo exchange.

Counterpart of geobignn_tpu/parallel/partition.py.  Nodes are partitioned
across parts, each part owns the edges whose DESTINATION is local, and
every conv exchanges only the BOUNDARY (halo) rows its neighbours need.

Host side (numpy, bit-equal to the JAX builders): the balanced partition
(`partition_nodes`), per-part slot spaces, the edge-coloured exchange
schedule (`color_rounds`: each round a set of disjoint part pairs, padded
to its own largest cut), per-part send tables and locally relabelled edge
lists whose remote columns point into the halo buffer region
(`build_halo_sharding`), the scatter-free tables (`halo_tables`) and the
per-part band of the banded conv (`partition_rcm_priority`,
`halo_band_arrays`).  Every per-part array shares one padded size and is
stacked on a leading part axis, as in JAX.

Device side (torch): the JAX functions run inside `shard_map`, one program
per device; here one process holds all P parts, each as a tensor on its
own device, and every function takes and returns a list of P per-part
tensors.  A `ppermute` of a round becomes one `.to(device)` copy for each
(src, dst) pair of the round; autograd differentiates the copy, so each
halo row's cotangent goes back to its sender's slot, as JAX's transpose
of the ppermute does.  Parts may share a device (the CPU tests, one card).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from geobignn_tpu_torch.ops import banded, feastconv
from geobignn_tpu_torch.ops import table as tbl
from geobignn_tpu_torch.structs import round_up


def partition_nodes(
    edge_index: np.ndarray, n: int, n_parts: int, seed: int = 0,
    method: str = "rcm",
) -> np.ndarray:
    """Balanced node partitioning.  Returns owner (n,) int32.

    method="rcm" (default): the whole-graph RCM order cut into P equal
    contiguous slabs, so every boundary is about one ring and each part
    talks to its neighbours in that order.  method="bfs": breadth-first
    growth from spread seeds, capped at ceil(n/n_parts)."""
    if method == "rcm":
        perm = banded.rcm_order(edge_index.astype(np.int64), n)
        cap = -(-n // n_parts)
        owner = np.empty(n, dtype=np.int32)
        for p in range(n_parts):
            owner[perm[p * cap : (p + 1) * cap]] = p
        return owner
    if method != "bfs":
        raise ValueError(f"unknown partition method '{method}'")
    rng = np.random.default_rng(seed)
    cap = -(-n // n_parts)
    order = np.argsort(edge_index[0], kind="stable")
    rows, cols = edge_index[0][order].astype(np.int64), edge_index[1][order].astype(np.int64)
    ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=ptr[1:])

    owner = np.full(n, -1, dtype=np.int32)
    counts = np.zeros(n_parts, dtype=np.int64)
    frontiers: list[np.ndarray] = [None] * n_parts
    for p in range(n_parts):
        free = np.where(owner < 0)[0]
        s = int(free[rng.integers(free.size)])
        owner[s] = p
        counts[p] = 1
        frontiers[p] = np.asarray([s], dtype=np.int64)

    def neighbors_of(front: np.ndarray) -> np.ndarray:
        """Concatenated CSR neighbour lists of a frontier, in CSR order."""
        degs = ptr[front + 1] - ptr[front]
        total = int(degs.sum())
        if total == 0:
            return np.empty(0, np.int64)
        starts_e = np.repeat(ptr[front], degs)
        offs = np.arange(total, dtype=np.int64) - np.repeat(np.cumsum(degs) - degs, degs)
        return cols[starts_e + offs]

    active = True
    while active:
        active = False
        for p in range(n_parts):
            front = frontiers[p]
            if counts[p] >= cap or front.size == 0:
                continue
            nbr = neighbors_of(front)
            cand = nbr[owner[nbr] < 0]
            # first occurrence in CSR order, capped at the remaining room
            uniq, first = np.unique(cand, return_index=True)
            taken = uniq[np.argsort(first, kind="stable")][: int(cap - counts[p])]
            owner[taken] = p
            counts[p] += taken.size
            frontiers[p] = taken
            active = active or taken.size > 0
    for v in np.where(owner < 0)[0]:  # orphans: to the emptiest parts
        p = int(np.argmin(counts))
        owner[v] = p
        counts[p] += 1
    return owner


@dataclasses.dataclass
class HaloSharding:
    """Per-part (leading axis P) halo-sharded graph structure.  The exchange
    runs in `rounds`, each over disjoint part pairs and padded to its own
    largest pair cut."""

    n_parts: int
    n_loc: int  # padded local node count (incl. trash at n_loc-1)
    h_total: int  # total halo buffer length = sum of per-round pads
    e_loc: int  # padded local edge count
    slot_of: np.ndarray  # (N,) global node -> local slot
    owner: np.ndarray  # (N,) global node -> part
    gather_x: np.ndarray  # (P, n_loc) global row to load per slot (trash -> N)
    edge_index: np.ndarray  # (P, 2, e_loc): row local, col in [0, n_loc + h_total)
    edge_weight: np.ndarray | None  # (P, e_loc)
    deg: np.ndarray  # (P, n_loc)
    node_mask: np.ndarray  # (P, n_loc)
    send_idx: np.ndarray  # (P, h_total) local slots to send, round-major
    rounds: tuple = ()  # ((perm pairs, h_c), ...) static exchange schedule


def color_rounds(
    cut: np.ndarray, granularity: int = 8, bin_ratio: float = 2.0
) -> tuple[tuple, np.ndarray, int]:
    """Size-binned greedy edge-colouring of the partition's communication
    graph.  cut (P, P): cut[p, q] = rows p must RECEIVE from q.  Pairs are
    bucketed into geometric weight classes (ratio `bin_ratio`) and each class
    is coloured heaviest first, so a light pair never shares a round with
    (and is padded to) a heavy one.  Returns (rounds, offset_of, h_total):
    rounds = ((perm, h_c), ...), perm the (src, dst) pairs of the round in
    both directions, h_c = round_up(its largest cut); offset_of[p, q] = the
    halo-buffer offset where p's rows from q land (-1 if none)."""
    p_cnt = cut.shape[0]
    wpair: dict[tuple[int, int], int] = {}
    for p in range(p_cnt):
        for q in range(p + 1, p_cnt):
            w = int(max(cut[p, q], cut[q, p]))
            if w > 0:
                wpair[(p, q)] = w

    def klass(w: int) -> int:  # descends with weight: heavy rounds first
        return -int(math.floor(math.log(max(w, 1)) / math.log(bin_ratio)))

    colors: list[dict] = []
    by_class: dict[int, list] = {}
    for pq, w in sorted(wpair.items(), key=lambda kv: (-kv[1], kv[0])):
        by_class.setdefault(klass(w), []).append((pq, w))
    for k in sorted(by_class):
        class_colors: list[dict] = []
        for (p, q), w in by_class[k]:
            for col in class_colors:
                if p not in col["used"] and q not in col["used"]:
                    break
            else:
                col = {"pairs": [], "h": 0, "used": set()}
                class_colors.append(col)
            col["pairs"].append((p, q))
            col["used"] |= {p, q}
            col["h"] = max(col["h"], w)
        colors.extend(class_colors)
    rounds = []
    offset_of = np.full((p_cnt, p_cnt), -1, np.int64)
    off = 0
    for col in colors:
        h_c = round_up(col["h"], granularity)
        perm = []
        for p, q in col["pairs"]:
            perm += [(p, q), (q, p)]
            offset_of[p, q] = off
            offset_of[q, p] = off
        rounds.append((tuple(sorted(perm)), h_c))
        off += h_c
    return tuple(rounds), offset_of, off


def build_halo_sharding(
    edge_index: np.ndarray,
    edge_weight: np.ndarray | None,
    n: int,
    owner: np.ndarray,
    granularity: int = 8,
    priority: np.ndarray | None = None,
    n_granularity: int | None = None,
) -> HaloSharding:
    """`priority` (n,) orders nodes within their part (lower first), e.g.
    `partition_rcm_priority`, which makes every part's local graph
    band-limited; default id order.  `n_granularity` rounds n_loc on its own
    (the banded aggregate needs n_loc % tile == 0) while the halo pads and
    e_loc keep the small `granularity`."""
    p_cnt = int(owner.max()) + 1
    counts = np.bincount(owner, minlength=p_cnt)
    n_loc = round_up(int(counts.max()) + 1, n_granularity or granularity)
    trash_loc = n_loc - 1

    slot_of = np.zeros(n, dtype=np.int64)
    gather_x = np.full((p_cnt, n_loc), n, dtype=np.int64)  # n == global trash row
    if priority is None:
        order_n = np.argsort(owner[:n], kind="stable")
    else:
        order_n = np.lexsort((priority[:n], owner[:n]))
    starts = np.zeros(p_cnt, dtype=np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    ranks = np.arange(n, dtype=np.int64) - starts[owner[order_n]]
    slot_of[order_n] = ranks
    gather_x[owner[order_n], ranks] = order_n

    row, col = edge_index[0].astype(np.int64), edge_index[1].astype(np.int64)
    orow = owner[row].astype(np.int64)
    ocol = owner[col].astype(np.int64)

    # halo sets: one sort of the cross edges by (dst part p, src part q,
    # global col), then a per-(p, q) dedup
    cross = orow != ocol
    ckey = (orow[cross] * p_cnt + ocol[cross]) * (n + 1) + col[cross]
    uniq = np.unique(ckey)
    u_pq = uniq // (n + 1)
    u_col = uniq % (n + 1)
    seg_counts = np.bincount(u_pq, minlength=p_cnt * p_cnt)
    seg_starts = np.zeros(p_cnt * p_cnt, np.int64)
    np.cumsum(seg_counts[:-1], out=seg_starts[1:])
    u_rank = np.arange(uniq.size, dtype=np.int64) - seg_starts[u_pq]
    u_p, u_q = u_pq // p_cnt, u_pq % p_cnt

    cut = seg_counts.reshape(p_cnt, p_cnt)  # [p, q] = p receives from q
    rounds, offset_of, h_total = color_rounds(cut, granularity)

    # send_idx[q]: q's round-major send buffer — at each round's offset the
    # local slots its partner p needs from q
    send_idx = np.full((p_cnt, h_total), trash_loc, dtype=np.int32)
    if uniq.size:
        send_idx[u_q, offset_of[u_p, u_q] + u_rank] = slot_of[u_col]

    # per destination part: global node -> halo buffer slot
    halo_slot = np.full((p_cnt, n), trash_loc, dtype=np.int32)
    if uniq.size:
        halo_slot[u_p, u_col] = n_loc + offset_of[u_p, u_q] + u_rank

    e_order = np.argsort(orow, kind="stable")
    e_counts = np.bincount(orow, minlength=p_cnt)
    e_loc = round_up(max(1, int(e_counts.max())), granularity)
    e_starts = np.zeros(p_cnt + 1, np.int64)
    np.cumsum(e_counts, out=e_starts[1:])
    ei = np.full((p_cnt, 2, e_loc), n_loc - 1, dtype=np.int32)
    ew = None if edge_weight is None else np.zeros((p_cnt, e_loc), np.float32)
    deg = np.zeros((p_cnt, n_loc), np.float32)
    mask = np.zeros((p_cnt, n_loc), np.float32)
    for p in range(p_cnt):
        sel = e_order[e_starts[p] : e_starts[p + 1]]
        r = slot_of[row[sel]]
        c_glob = col[sel]
        c = np.where(ocol[sel] == p, slot_of[c_glob], halo_slot[p, c_glob]).astype(np.int64)
        ei[p, 0, : r.size] = r
        ei[p, 1, : c.size] = c
        if edge_weight is not None:
            ew[p, : sel.size] = edge_weight[sel]
        np.add.at(deg[p], r, 1.0)
        mask[p, : counts[p]] = 1.0

    return HaloSharding(
        n_parts=p_cnt, n_loc=n_loc, h_total=h_total, e_loc=e_loc,
        slot_of=slot_of, owner=np.asarray(owner, np.int32),
        gather_x=gather_x, edge_index=ei, edge_weight=ew,
        deg=deg, node_mask=mask, send_idx=send_idx, rounds=rounds,
    )


def _repad(a: np.ndarray, r_out: int, pad_val: int) -> np.ndarray:
    """A reverse table widened to r_out columns of pad_val."""
    if a.shape[1] == r_out:
        return a
    pad = np.full((a.shape[0], r_out - a.shape[1]), pad_val, np.int32)
    return np.concatenate([a, pad], axis=1)


def _widen(nbr: np.ndarray, kmask: np.ndarray, k_out: int, trash: int):
    """A neighbour table and its mask widened to k_out columns."""
    if nbr.shape[1] == k_out:
        return nbr, kmask
    pad = np.full((nbr.shape[0], k_out - nbr.shape[1]), trash, np.int32)
    return (np.concatenate([nbr, pad], axis=1),
            np.concatenate([kmask, np.zeros(pad.shape, np.float32)], axis=1))


def _send_rev(sh: HaloSharding, p: int, src_mask: np.ndarray, granularity: int):
    """Reverse table of part p's send gather (local slot -> positions)."""
    return tbl.reverse_table_np(sh.send_idx[p].reshape(-1, 1), sh.n_loc,
                                src_mask=src_mask[: sh.n_loc], granularity=granularity)


def _ext_src_mask(n_loc: int, n_ext: int) -> np.ndarray:
    """Real source rows of an extended [local | halo] table: all but the
    local trash slot (huge fan-in, zero gradient)."""
    src_mask = np.ones(n_ext, bool)
    src_mask[n_loc - 1] = False
    return src_mask


def halo_tables(sh: HaloSharding, granularity: int = 8) -> dict:
    """Dense neighbour / reverse tables of the scatter-free halo conv, per
    part, stacked with shared K / R pads:

      nbr  (P, n_loc, K)   local row -> ext-space neighbour slots
      kmask(P, n_loc, K)
      rev  (P, n_ext, R)   ext slot -> flattened (n_loc*K) positions
      rev_send (P, n_loc, R_s)  local slot -> positions in send_idx
    """
    p_cnt, n_loc, h_total = sh.n_parts, sh.n_loc, sh.h_total
    n_ext = n_loc + h_total
    src_mask = _ext_src_mask(n_loc, n_ext)
    per = [tbl.neighbor_table_np(sh.edge_index[p], n_loc, granularity=granularity)
           for p in range(p_cnt)]
    k_pad = max([1] + [k for _, _, k in per])
    nbrs, kmasks, revs, rsends = [], [], [], []
    r_max = rs_max = 1
    for p, (nbr_p, kmask_p, _) in enumerate(per):
        nbr_p, kmask_p = _widen(nbr_p, kmask_p, k_pad, n_loc - 1)
        rev_p, r_p = tbl.reverse_table_np(nbr_p, n_ext, src_mask=src_mask,
                                          granularity=granularity)
        rs_p, rsp = _send_rev(sh, p, src_mask, granularity)
        nbrs.append(nbr_p)
        kmasks.append(kmask_p)
        revs.append(rev_p)
        rsends.append(rs_p)
        r_max, rs_max = max(r_max, r_p), max(rs_max, rsp)
    return dict(
        nbr=np.stack(nbrs), kmask=np.stack(kmasks),
        rev=np.stack([_repad(r, r_max, n_loc * k_pad) for r in revs]),
        rev_send=np.stack([_repad(s, rs_max, h_total) for s in rsends]),
    )


def partition_rcm_priority(
    edge_index: np.ndarray, n: int, owner: np.ndarray
) -> tuple[np.ndarray, int]:
    """Per-part RCM rank of every node over its intra-part subgraph.  Feed
    it as build_halo_sharding's `priority` so each part's local slot space
    is band-limited.  Returns (priority (n,), the largest slot bandwidth
    over the parts), which sizes the band's tile."""
    p_cnt = int(owner.max()) + 1
    row = edge_index[0].astype(np.int64)
    col = edge_index[1].astype(np.int64)
    pri = np.zeros(n, np.int64)
    bw_max = 0
    for p in range(p_cnt):
        nodes = np.where(owner[:n] == p)[0]
        idx_of = np.full(n, -1, np.int64)
        idx_of[nodes] = np.arange(nodes.size)
        sel = (owner[row] == p) & (owner[col] == p) & (row != col)
        sub = np.stack([idx_of[row[sel]], idx_of[col[sel]]])
        perm = banded.rcm_order(sub, nodes.size)  # old local index per new slot
        rank = np.empty(nodes.size, np.int64)
        rank[perm] = np.arange(nodes.size)
        pri[nodes] = rank
        if sub.shape[1]:
            bw_max = max(bw_max, int(np.abs(rank[sub[0]] - rank[sub[1]]).max()))
    return pri, bw_max


def halo_band_arrays(sh: HaloSharding, tile: int, granularity: int = 8) -> dict:
    """The per-part banded structure: the local edges split into INTRA
    edges (both ends local; band-limited when the sharding was built with
    partition_rcm_priority) and BOUNDARY edges (column in the halo region).
    The FeaSt softmax is per edge, so the two sets aggregate additively:

      m       (P, B, T, 3T) int8   band mask of the intra edges
      nbr_b   (P, n_loc, K_b)      boundary neighbour table (ext space)
      kmask_b (P, n_loc, K_b)
      rev_b   (P, n_ext, R)        reverse table of the boundary gather
      rev_send(P, n_loc, R_s)      as in halo_tables

    Requires sh.n_loc % tile == 0 (build with n_granularity=tile)."""
    p_cnt, n_loc, h_total = sh.n_parts, sh.n_loc, sh.h_total
    assert n_loc % tile == 0, (n_loc, tile)
    n_ext = n_loc + h_total
    src_mask = _ext_src_mask(n_loc, n_ext)
    masks, per, rsends = [], [], []
    rs_max = 1
    for p in range(p_cnt):
        ei_p = sh.edge_index[p].astype(np.int64)
        intra = ei_p[1] < n_loc  # trash padding (row == col) is dropped below
        masks.append(banded.band_mask_np(ei_p[:, intra], n_loc, tile))
        per.append(tbl.neighbor_table_np(ei_p[:, ~intra], n_loc, granularity=granularity))
        rs_p, rsp = _send_rev(sh, p, src_mask, granularity)
        rsends.append(rs_p)
        rs_max = max(rs_max, rsp)
    k_max = max([1] + [k for _, _, k in per])
    nbrs, kmasks, revs = [], [], []
    r_max = 1
    for nbr_p, km_p, _ in per:
        nbr_p, km_p = _widen(nbr_p, km_p, k_max, n_loc - 1)
        rev_p, r_p = tbl.reverse_table_np(nbr_p, n_ext, src_mask=src_mask,
                                          granularity=granularity)
        nbrs.append(nbr_p)
        kmasks.append(km_p)
        revs.append(rev_p)
        r_max = max(r_max, r_p)
    return dict(
        m=np.stack(masks), nbr_b=np.stack(nbrs), kmask_b=np.stack(kmasks),
        rev_b=np.stack([_repad(r, r_max, n_loc * k_max) for r in revs]),
        rev_send=np.stack([_repad(s, rs_max, h_total) for s in rsends]),
    )


def shard_features(x: np.ndarray, sh: HaloSharding) -> np.ndarray:
    """(N, C) global features -> (P, n_loc, C) per-part slot features."""
    ext = np.concatenate([x, np.zeros((1, x.shape[1]), x.dtype)], axis=0)
    return ext[sh.gather_x]


def unshard_features(x_loc: np.ndarray, sh: HaloSharding, n: int) -> np.ndarray:
    """(P, n_loc, C) -> (N, C) in global order."""
    return np.asarray(x_loc)[sh.owner[:n], sh.slot_of[:n]]


# --------------------------------------------------------------------------
# device side: lists of P per-part tensors, each on its part's device
# --------------------------------------------------------------------------

def halo_exchange(xs: list, sends: list, rounds=(), rev_sends: list | None = None) -> list:
    """xs: P tensors (n_loc, C); sends: P round-major send tables (h_total,);
    `rounds` the static schedule (HaloSharding.rounds).  Returns each part's
    extended table (n_loc + h_total, C): its local rows, then one halo buffer
    per round.

    Each round is one copy per (src, dst) pair of the round, of the src
    part's send rows at the round's offset, padded to the round's h_c, to
    the dst part's device; a part that is no destination in a round gets
    zeros there (as a `ppermute` gives it; those slots are never addressed).
    With `rev_sends` (halo_tables) the send gather backpropagates through a
    reverse-table gather instead of a scatter-add."""
    if not rounds:
        return list(xs)
    if rev_sends is None:
        send = [x[s] for x, s in zip(xs, sends)]
    else:
        send = [tbl.table_gather(x, s.reshape(-1, 1), rs).reshape(s.shape[0], x.shape[1])
                for x, s, rs in zip(xs, sends, rev_sends)]
    ext = [[x] for x in xs]
    off = 0
    for perm, h_c in rounds:
        recv = {dst: send[src][off : off + h_c].to(xs[dst].device) for src, dst in perm}
        for p, x in enumerate(xs):
            ext[p].append(recv[p] if p in recv else x.new_zeros((h_c, x.shape[1])))
        off += h_c
    return [torch.cat(e, dim=0) for e in ext]


def _masked(outs: list, masks: list | None) -> list:
    """Restore the zero-trash invariant: padded slots back to zero."""
    if masks is None:
        return outs
    return [o * m.to(o.dtype)[:, None] for o, m in zip(outs, masks)]


def halo_feast_conv(params: list, xs: list, edge_indices: list, degs: list, sends: list,
                    rounds=(), node_masks: list | None = None) -> list:
    """FeaStConv over a halo-sharded graph: one boundary exchange, then a
    purely local COO aggregation per part (ops/feastconv.feast_conv over the
    extended table).  `params` holds one parameter dict per part, on its
    device."""
    exts = halo_exchange(xs, sends, rounds)
    outs = [feastconv.feast_conv(prm, x, ei, deg=deg, x_src=ext)
            for prm, x, ei, deg, ext in zip(params, xs, edge_indices, degs, exts)]
    return _masked(outs, node_masks)


def halo_feast_conv_table(params: list, xs: list, tabs: list, degs: list, sends: list,
                          rounds=(), node_masks: list | None = None) -> list:
    """Scatter-free halo FeaStConv: one boundary exchange, then the dense
    neighbour-table conv (ops/feastconv.feast_conv_table) over each part's
    extended [local | halo] table.  `tabs` = each part's halo_tables slice."""
    exts = halo_exchange(xs, sends, rounds, [t["rev_send"] for t in tabs])
    outs = [feastconv.feast_conv_table(prm, x, t["nbr"], t["kmask"], t["rev"], deg=deg,
                                       x_src=ext)
            for prm, x, t, deg, ext in zip(params, xs, tabs, degs, exts)]
    return _masked(outs, node_masks)


def halo_feast_conv_banded(params: list, xs: list, bands: list, degs: list, sends: list,
                           rounds=(), node_masks: list | None = None,
                           compute_dtype=None) -> list:
    """The banded FeaStConv per halo part: the intra-part edges through the
    banded aggregate (ops/banded_cuda.banded_aggregate — TPU kernels #1/#2
    forward, #3/#4 backward — on each part's RCM-ordered band), the
    boundary edges through a small dense-table correction over the halo
    buffers; the two numerators add (the FeaSt softmax is per edge) and deg
    counts both.  Then the self loop in float32, the mean over deg + 1 and
    the bias.  `bands` = each part's halo_band_arrays slice.  The aggregate's
    compute dtype defaults to bf16, as the JAX function's."""
    from geobignn_tpu_torch.ops.banded_cuda import banded_aggregate

    compute_dtype = compute_dtype or torch.bfloat16
    exts = halo_exchange(xs, sends, rounds, [b["rev_send"] for b in bands])
    outs = []
    for prm, x, band, deg, ext in zip(params, xs, bands, degs, exts):
        p, r = banded.factorized_softmax(x, prm["u"], prm["c"])
        num = banded_aggregate(r, p, x, prm["w"], band["m"], compute_dtype)
        xnb = tbl.table_gather(ext, band["nbr_b"], band["rev_b"])  # (n_loc, K_b, C)
        s = torch.einsum("nkc,ch->nkh", xnb - x[:, None, :], prm["u"]) + prm["c"]
        q = torch.softmax(s, dim=-1) * band["kmask_b"][..., None]
        z = torch.einsum("nkh,nkc->nhc", q, xnb)
        num = num + torch.einsum("nhc,hco->no", z, prm["w"]).to(num.dtype)
        outs.append(banded.self_loop_epilogue(num, x, prm, deg.to(num.dtype)))
    return _masked(outs, node_masks)
