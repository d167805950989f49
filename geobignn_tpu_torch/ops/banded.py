"""Banded block-dense FeaStConv: host builders and the plain torch conv.

Counterpart of geobignn_tpu/ops/banded.py.  The host builders (`rcm_order`
through `hybrid_arrays_np`) are copied unchanged so the port's band masks
and hybrid-band arrays are bit-identical to the JAX package's; the
perf-sweep environment overrides of the JAX module are left out and their
defaults kept.  `MAX_BAND_TILE` is read at call time, so tests can
monkeypatch it.

The formulation: the FeaSt head softmax factorizes into per-node halves
p_h(j) and r_h(i), so the per-edge denominator of a whole (tile x window)
block is one (T,H)x(H,3T) product, and under RCM node order every neighbour
of tile b lies in the 3T window [(b-1)T, (b+2)T): the aggregate is a
block-dense masked product against a precomputed int8 band mask.
"""

from __future__ import annotations

import numpy as np
import torch

from geobignn_tpu_torch.structs import round_up


# --------------------------------------------------------------------------
# host-side builders
# --------------------------------------------------------------------------

def rcm_order(edge_index: np.ndarray, n: int) -> np.ndarray:
    """Reverse-Cuthill-McKee permutation (old index per new slot) of the
    real nodes [0, n).  Padding is the caller's business: apply to the
    unpadded graph, keep trash slots at the end."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    row, col = edge_index[0], edge_index[1]
    real = row != col
    g = coo_matrix(
        (np.ones(real.sum(), np.int8), (row[real], col[real])), shape=(n, n)
    ).tocsr()
    return np.asarray(reverse_cuthill_mckee(g, symmetric_mode=True), np.int64)


# Ordering note (measured, icosphere 327k faces): a hierarchical
# partition-then-per-part-RCM ordering was tried to shrink block-sparse
# windows and made them dramatically WORSE (max col-blocks per row block
# 195 vs 12 at T=256): each part's RCM ranks its seam nodes arbitrarily,
# so cross-part edges scatter across the neighbor part's whole slot range.
# Plain whole-graph RCM already clusters every row block's neighbors into
# a few contiguous runs (prev ring / own ring / next ring); the
# block-sparse builders exploit exactly that.
def bandwidth_of(edge_index: np.ndarray) -> int:
    row, col = edge_index[0].astype(np.int64), edge_index[1].astype(np.int64)
    real = row != col
    if not real.any():
        return 0
    return int(np.abs(row[real] - col[real]).max())


def band_mask_np(
    edge_index: np.ndarray,  # (2, E) trash-padded COO in RCM order
    n_pad: int,
    tile: int,
    check_bw: bool = True,
) -> np.ndarray:
    """0/1 band mask M (B, T, 3T) int8: M[b, t, w] = 1 iff the edge
    (b*T + t) <- ((b-1)*T + w) exists.  Requires graph bandwidth <= T
    (raises otherwise — re-tile or fall back to the table path);
    check_bw=False admits any edge already known to be in-window (the
    hybrid path pre-filters; in-window distance can legitimately reach
    2T-1)."""
    assert n_pad % tile == 0, (n_pad, tile)
    row = edge_index[0].astype(np.int64)
    col = edge_index[1].astype(np.int64)
    real = row != col
    row, col = row[real], col[real]
    bw = int(np.abs(row - col).max()) if row.size else 0
    if check_bw and bw > tile:
        raise ValueError(f"bandwidth {bw} exceeds tile {tile}; increase tile")
    b = row // tile
    t = row - b * tile
    w = col - (b - 1) * tile
    n_blk = n_pad // tile
    m = np.zeros((n_blk, tile, 3 * tile), np.int8)
    m[b, t, w] = 1
    return m


def pick_tile(bandwidth: int, granularity: int = 128, min_tile: int = 128) -> int:
    """Smallest lane-aligned tile covering the bandwidth (window = 3*tile)."""
    return max(min_tile, round_up(max(bandwidth, 1), granularity))


# Contiguous-band tile ceiling: levels needing a larger tile route through
# the slab-RCM hybrid (band at tile<=256 + banded sub-graph boundary
# correction) instead.  History: the hard VMEM limit is ~768 (the (T, 3T)
# f32 block intermediates outgrow scoped VMEM beyond it), and 768 was the
# r3 default; with the gather-only sub-band correction the hybrid now BEATS
# wide contiguous bands (327k faces: 118.6 -> 127.6e6 edges/s routing the
# tile-768 vertex L1 / tile-640 v-L2 / tile-512 f-L3 through hybrid-256),
# while at bench scale (bw 327 -> tile 384) the pure band is still 3.3%
# ahead of hybrid-256 — hence the 384 threshold.
MAX_BAND_TILE = 384


def order_for_band(
    edge_index: np.ndarray, n: int,
    max_tile: int | None = None, target_tile: int = 256,
) -> tuple[np.ndarray, int]:
    """Node permutation (new slot -> old id) for the banded conv family.

    Plain RCM when its bandwidth fits `max_tile`.  Otherwise SLAB + per-
    slab RCM: slice the global RCM order into Q contiguous slabs and
    re-RCM each slab's intra subgraph.  A slab of a 2-manifold mesh is a
    thin strip, so its own RCM bandwidth ~ strip thickness ~ N/(Q*ring) —
    it DROPS with Q, while cross-slab edges (a few rings' worth) leave
    the band entirely and become the hybrid conv's table-corrected
    boundary set (builder.attach_band; mirrors the halo banded mode,
    parallel/partition.py halo_band_arrays, applied single-chip).

    Returns (perm, intra_bandwidth): the bandwidth over IN-SLAB edges
    only — the graph's full bandwidth under perm includes the boundary
    edges and stays large by design."""
    if max_tile is None:  # resolved at call time so tests can monkeypatch
        max_tile = MAX_BAND_TILE
    target_tile = min(target_tile, max_tile)
    perm = rcm_order(edge_index.astype(np.int64), n)
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    row = inv[edge_index[0].astype(np.int64)]
    col = inv[edge_index[1].astype(np.int64)]
    real = row != col
    bw = int(np.abs(row[real] - col[real]).max()) if real.any() else 0
    if bw <= max_tile:
        return perm, bw

    for q in (2, 4, 8, 16, 32, 64):
        cap = -(-n // q)
        owner = np.minimum(inv // cap, q - 1)
        new_perm = np.empty(n, np.int64)
        bw_intra = 0
        base = 0
        o_row, o_col = owner[edge_index[0]], owner[edge_index[1]]
        for p in range(q):
            nodes = perm[p * cap : (p + 1) * cap]
            m = nodes.size
            idx_of = np.full(n, -1, np.int64)
            idx_of[nodes] = np.arange(m)
            sel = (
                (o_row == p) & (o_col == p)
                & (edge_index[0] != edge_index[1])
            )
            sub = np.stack([idx_of[edge_index[0][sel]],
                            idx_of[edge_index[1][sel]]])
            r = rcm_order(sub, m)
            # Chain the slabs head-to-tail: a slab's RCM sweeps the strip
            # end-to-end in an ARBITRARY direction, scattering junction
            # edges (slab p end <-> slab p+1 start) across ~cap slots.
            # Orienting every slab so nodes touching slab p-1 come FIRST
            # (and p+1 last) puts junction endpoints within ~2 ring-widths
            # of the slab boundary, so most cross-slab edges fall inside
            # the hybrid's 3T window and leave the boundary-table set —
            # measured 70% of the hybrid conv's cost at 327k faces
            # (examples/probe_f1_327k.py: 34.45 -> 10.65 ms/conv without
            # the correction).
            if sub.shape[1]:
                rank = np.empty(m, np.int64)
                rank[r] = np.arange(m)
                vote = 0.0
                prev_n = idx_of[np.concatenate([
                    edge_index[0][(o_row == p) & (o_col == p - 1)],
                    edge_index[1][(o_col == p) & (o_row == p - 1)],
                ])] if p > 0 else np.empty(0, np.int64)
                next_n = idx_of[np.concatenate([
                    edge_index[0][(o_row == p) & (o_col == p + 1)],
                    edge_index[1][(o_col == p) & (o_row == p + 1)],
                ])] if p < q - 1 else np.empty(0, np.int64)
                if prev_n.size:  # want prev-touching nodes EARLY
                    vote += rank[prev_n].mean() - (m - 1) / 2.0
                if next_n.size:  # want next-touching nodes LATE
                    vote += (m - 1) / 2.0 - rank[next_n].mean()
                if vote > 0:
                    r = r[::-1]
                    rank = (m - 1) - rank
                bw_intra = max(
                    bw_intra, int(np.abs(rank[sub[0]] - rank[sub[1]]).max())
                )
            new_perm[base : base + m] = nodes[r]
            base += m
        if bw_intra <= target_tile or q == 64:
            return new_perm, bw_intra
    return perm, bw  # unreachable


def hybrid_widths(
    edge_index: np.ndarray, n: int, granularity: int = 8,
    max_out_frac: float = 0.35, tile: int | None = None,
) -> tuple[int, int, int, int]:
    """Band+boundary-table hybrid sizing for a level whose full bandwidth
    exceeds MAX_BAND_TILE (order with `order_for_band` first).

    Picks the smallest tile whose 3T window covers >= (1 - max_out_frac)
    of the real edges; the rest become the compact boundary set.  Returns
    (tile, m_b, k_b, r_b, s_b) — all 0 when no tile qualifies (callers
    fall back to block-sparse): m_b = boundary ROWS (padded), k_b = max
    boundary edges per row, r_b = max occurrences of one source column in
    the boundary table (compact reverse width), s_b = distinct boundary
    SOURCE columns (padded; sizes the compact reverse table)."""
    row = edge_index[0].astype(np.int64)
    col = edge_index[1].astype(np.int64)
    real = row != col
    row, col = row[real], col[real]
    if row.size == 0:
        return 0, 0, 0, 0, 0
    forced = bool(tile)
    if tile:
        candidates = (tile,)
    else:  # MAX_BAND_TILE looked up at call time (tests monkeypatch it).
        # Floor at 256: measured on the 327k facet L1 (examples/
        # probe_f1_327k.py), tile 128 moves intra edges into the boundary
        # tables (77k rows, kb 10) and loses 2x end-to-end; 256 vs 384 are
        # within 8% with 256 ahead.
        candidates = sorted(
            {t for t in (256, 384, 512, 640) if t < MAX_BAND_TILE}
            | {MAX_BAND_TILE}
        )
    for t in candidates:
        w = col - (row // t - 1) * t
        out = (w < 0) | (w >= 3 * t)
        if out.mean() <= max_out_frac or forced:
            if not out.any():
                return t, 0, 0, 0, 0  # pure band after all
            rows_b = np.unique(row[out])
            m_b = round_up(int(rows_b.size), granularity)
            k_b = round_up(int(np.bincount(row[out]).max()), granularity)
            r_b = round_up(int(np.bincount(col[out], minlength=n).max()),
                           granularity)
            s_b = round_up(int(np.unique(col[out]).size), granularity)
            return t, m_b, k_b, r_b, s_b
    return 0, 0, 0, 0, 0


def out_of_window(edge_index: np.ndarray, tile: int) -> np.ndarray:
    """Boolean mask of REAL edges outside the 3T band window (trash
    padding rows==cols are never 'out'; band_mask_np strips them)."""
    row = edge_index[0].astype(np.int64)
    col = edge_index[1].astype(np.int64)
    w = col - (row // tile - 1) * tile
    return (row != col) & ((w < 0) | (w >= 3 * tile))


def boundary_band_np(
    edge_index: np.ndarray, n_band: int, tile: int,
    max_sub_tile: int = 256, granularity: int = 128,
    tile_out: int = 0, pad_out: int = 0,
) -> dict | None:
    """Banded SUB-GRAPH correction for the hybrid conv's out-of-window
    boundary — replaces the per-edge softmax table correction, which
    measured 70% of the hybrid conv's cost at 327k faces
    (examples/probe_f1_327k.py: 34.45 -> 10.65 ms/conv without it).

    The boundary edges of slab-RCM-ordered meshes are junction ring-pairs
    (adjacent rings of consecutive slabs): their sub-graph RCM bandwidth
    collapses to ~10 (measured 11 on the 327k facet L1), so the boundary
    aggregate can run through the SAME banded kernel at a tiny
    tile over gathered features, instead of gather-table einsums in a
    TPU-hostile (M, K, H) layout.  The per-edge head softmax is exact
    under any edge split, so band + sub-band is exactly additive.

    Returns dict(jnodes (S,) int32 — boundary nodes in sub-RCM order,
    trash-padded with n_band-1; jband (Bs, Ts, 3Ts) int8) or None when
    the sub-graph bandwidth exceeds `max_sub_tile` (callers fall back to
    the compact-table correction).

    tile_out / pad_out: dataset-merged shape targets (builder.widths_for
    threads them through TableWidths, like the table widths) so every
    batch compiles to the SAME jband shapes — the sub-tile is raised to
    tile_out and the node padding to pad_out unless this batch genuinely
    needs more (which changes this batch's compile only)."""
    row = edge_index[0].astype(np.int64)
    col = edge_index[1].astype(np.int64)
    real = row != col
    w = col - (row // tile - 1) * tile
    out = real & ((w < 0) | (w >= 3 * tile))
    if not out.any():
        return None
    rb, cb = row[out], col[out]
    nodes = np.unique(np.concatenate([rb, cb]))
    n_sub = int(nodes.size)
    pos = np.full(n_band, -1, np.int64)
    pos[nodes] = np.arange(n_sub)
    sub = np.stack([pos[rb], pos[cb]])
    r = rcm_order(sub, n_sub)
    rank = np.empty(n_sub, np.int64)
    rank[r] = np.arange(n_sub)
    bw_sub = int(np.abs(rank[sub[0]] - rank[sub[1]]).max())
    jtile = max(pick_tile(bw_sub, granularity=granularity), tile_out)
    if jtile > max_sub_tile:
        return None
    n_sub_pad = round_up(max(n_sub, pad_out), jtile)
    jnodes = np.full(n_sub_pad, n_band - 1, np.int32)
    jnodes[:n_sub] = nodes[r].astype(np.int32)
    sub_r = np.stack([rank[sub[0]], rank[sub[1]]])
    jband = band_mask_np(sub_r, n_sub_pad, jtile, check_bw=True)
    # inverse map (node -> slot in jnodes, sentinel n_sub_pad otherwise):
    # lets BOTH directions of the gather/scatter pair run as gathers
    # (XLA's scatter-add lowering measured 3.8 ms per (N, 9) scatter at
    # 327k — the trace's dominant fusion group)
    jpos = np.full(n_band, n_sub_pad, np.int32)
    jpos[jnodes[:n_sub]] = np.arange(n_sub, dtype=np.int32)
    # the gather/scatter pair in banded_pallas._gather_unique /
    # _scatter_add_unique is only a valid adjoint when every real jnodes
    # row is distinct and jpos is its exact inverse — cheap build-time
    # check so a future caller can't break that contract silently
    assert np.unique(jnodes[:n_sub]).size == n_sub, "jnodes rows not unique"
    assert np.array_equal(
        jpos[jnodes[:n_sub]], np.arange(n_sub, dtype=np.int32)
    ), "jpos is not the inverse of jnodes"
    return dict(jnodes=jnodes, jband=jband, jpos=jpos)


def boundary_band_widths(
    edge_index: np.ndarray, n: int, tile: int,
    max_sub_tile: int = 256, granularity: int = 128,
) -> tuple[int, int]:
    """Dataset-merge sizing for the jband correction: (jtile, n_sub_pad)
    of `boundary_band_np` on this graph, or (0, 0) when the sub-graph is
    band-infeasible (or there is no boundary).  widths_for records these
    per level and TableWidths merges them as maxima so all batches share
    one compiled jband shape."""
    arrs = boundary_band_np(
        edge_index, n, tile,
        max_sub_tile=max_sub_tile, granularity=granularity,
    )
    if arrs is None:
        return 0, 0
    return int(arrs["jband"].shape[1]), int(arrs["jnodes"].size)


def hybrid_arrays_np(
    edge_index: np.ndarray, n_band: int, tile: int,
    m_b: int, k_b: int, r_b: int, s_b: int,
) -> dict:
    """Build the hybrid structures: band mask over in-window edges plus a
    COMPACT boundary table for the rest — compact on BOTH sides (rows_b
    lists only rows with out-of-window edges; src_b/rev_b cover only the
    distinct boundary sources, so forward gathers O(m_b*k_b) rows and
    backward O(s_b*r_b), never O(N * anything); the full-width reverse
    measured ~60 ms/conv at 327k).

      m       (B, T, 3T) int8   in-window edges
      rows_b  (m_b,)     int32  boundary rows (trash-padded)
      nbr_b   (m_b, k_b) int32  their out-of-window neighbors
      kmask_b (m_b, k_b) f32
      src_b   (s_b,)     int32  distinct boundary sources (trash-padded)
      rev_b   (s_b, r_b) int32  positions of src_b[s] in flat nbr_b
                                 (pad = m_b * k_b) — table_gather_compact
    """
    row = edge_index[0].astype(np.int64)
    col = edge_index[1].astype(np.int64)
    real = row != col
    w = col - (row // tile - 1) * tile
    out = real & ((w < 0) | (w >= 3 * tile))

    ei_in = edge_index[:, ~out]
    m = band_mask_np(ei_in, n_band, tile, check_bw=False)

    trash = n_band - 1
    rows_u, inv_r = np.unique(row[out], return_inverse=True)
    assert rows_u.size <= m_b, (rows_u.size, m_b)
    rows_b = np.full(m_b, trash, np.int32)
    rows_b[: rows_u.size] = rows_u
    nbr_b = np.full((m_b, k_b), trash, np.int32)
    kmask_b = np.zeros((m_b, k_b), np.float32)
    slot = np.zeros(rows_u.size, np.int64)
    flat_pos = np.empty(out.sum(), np.int64)  # position of each boundary
    for e, (e_r, e_c) in enumerate(zip(inv_r, col[out])):
        nbr_b[e_r, slot[e_r]] = e_c
        kmask_b[e_r, slot[e_r]] = 1.0
        flat_pos[e] = e_r * k_b + slot[e_r]
        slot[e_r] += 1

    # compact reverse: per distinct source column, its positions in nbr_b
    srcs_u, src_inv = np.unique(col[out], return_inverse=True)
    assert srcs_u.size <= s_b, (srcs_u.size, s_b)
    r_used = int(np.bincount(src_inv).max()) if srcs_u.size else 0
    assert r_used <= r_b, (r_used, r_b)
    src_b = np.full(s_b, trash, np.int32)
    src_b[: srcs_u.size] = srcs_u
    rev_b = np.full((s_b, r_b), m_b * k_b, np.int32)
    rslot = np.zeros(srcs_u.size, np.int64)
    for s, fp in zip(src_inv, flat_pos):
        rev_b[s, rslot[s]] = fp
        rslot[s] += 1
    return dict(m=m, rows_b=rows_b, nbr_b=nbr_b, kmask_b=kmask_b,
                src_b=src_b, rev_b=rev_b)


# --------------------------------------------------------------------------
# device side (plain torch)
# --------------------------------------------------------------------------

def window(x_pad: torch.Tensor, tile: int) -> torch.Tensor:
    """(B*T, C) -> (B, 3T, C) overlapping windows, zero rows outside [0, N)."""
    c = x_pad.shape[-1]
    z = x_pad.new_zeros((tile, c))
    blocks = torch.cat([z, x_pad, z]).reshape(-1, tile, c)  # (B+2, T, C)
    return torch.cat([blocks[:-2], blocks[1:-1], blocks[2:]], dim=1)


# the span of u.x over the heads above which factorized_softmax shifts
# each node's halves by the middle of its span, not by their maxima
WIDE_SPAN = 20.0


def factorized_softmax(x: torch.Tensor, u: torch.Tensor, c: torch.Tensor):
    """p_h(j) = exp(u_h.x_j - s_j), r_h(i) = exp(c_h - u_h.x_i - t_i): the
    per-node halves of the FeaSt head softmax.  The aggregate is invariant
    to a per-node scaling of p and of r, so the shifts s and t are
    detached, as the JAX package's stop_gradient.

    The JAX function shifts by the maxima, s = max_h u.x and t = max_h
    (c - u.x); so is it here while every node's span of u.x over the heads
    (max_h - min_h) stays under WIDE_SPAN.  Then a node's product with its
    own or a near neighbour's halves, the D of the aggregates, is about
    exp(-span), and it falls under the aggregates' 1e-12 clamp once a span
    passes about 27.6: at level 0 of a whole mesh whose coordinates run to
    hundreds of mean edge lengths (a 327,680-face icosphere with seeded
    weights), where the JAX module's conv is wrong (it notes the deviation
    and presumes a saturated softmax; the scores (x_j - x_i).u are not).  Where any node's span passes WIDE_SPAN, every node
    is shifted by the middle of its span, s = -t = (max_h + min_h) / 2:
    each half stays within exp(+-span / 2) and D near sum_h exp(c_h), up to
    a span of about 170, float32's exponent range
    (tests/test_torch_banded.py::test_banded_conv_at_large_coordinates).
    The choice is one for the call, made on the device (a captured step
    replays it), so that no pair of neighbours mixes the two.

    `a = x @ u`, the shifts and the exponentials run in at least float32,
    and p and r are rounded to x's dtype once, as XLA runs the JAX
    function's elementwise chain in one fusion without rounding its
    intermediates.  In bf16 that keeps the cotangent of `a`, a small
    difference of the p and r terms, from being rounded before the
    subtraction.  `a` itself is formed in float32 from x's values and u as
    given (the model passes its float32 u), where the JAX function forms it
    in x's dtype from u cast to it: at whole-mesh coordinates a runs to
    hundreds of |u|, where one bf16 ulp of a is an O(1) change of a head
    logit (a deviation held by the witness of
    tests/test_torch_bf16_coords.py)."""
    af_dtype = torch.promote_types(torch.promote_types(x.dtype, u.dtype), torch.float32)
    af = x.to(af_dtype) @ u.to(af_dtype)  # (N, H)
    ca = c.to(af_dtype) - af
    hi, lo = af.amax(dim=1, keepdim=True), af.amin(dim=1, keepdim=True)
    wide = ((hi - lo) > WIDE_SPAN).any()
    mid = (hi + lo) / 2
    p = torch.exp(af - torch.where(wide, mid, hi).detach()).to(x.dtype)
    r = torch.exp(ca - torch.where(wide, -mid, ca.amax(dim=1, keepdim=True)).detach())
    return p, r.to(x.dtype)


def self_loop_epilogue(num, x, params, deg):
    """Add the implicit self-loop term, mean over N(i) + {i}, add the bias.
    The self-loop product comes out in num's dtype, as the JAX convs'
    `preferred_element_type`: float32 after the banded and block-sparse
    aggregates (bf16 operands, products exact in float32), x's dtype after
    the table and COO sums."""
    s_self = torch.softmax(params["c"], dim=0)
    w_self = torch.einsum("h,hio->io", s_self, params["w"])
    out = num + x.to(num.dtype) @ w_self.to(num.dtype)
    out = out / (deg + 1.0)[:, None]
    return out + params["b"]


def feast_conv_banded(
    params: dict,  # {"u": (C_in, H), "c": (H,), "w": (H, C_in, C_out), "b": (C_out,)}
    x: torch.Tensor,  # (N, C_in), N multiple of tile, trash rows zero
    m: torch.Tensor,  # (B, T, 3T) int8 band mask
    deg: torch.Tensor,  # (N,) real in-degree
) -> torch.Tensor:
    """FeaStConv via the rank-H factorized softmax over the band mask, all
    in float32: the algorithmic reference of the banded aggregate (JAX
    counterpart: ops/banded.feast_conv_banded with compute_dtype float32)."""
    n, _ = x.shape
    n_blk, tile, _ = m.shape
    assert n == n_blk * tile, (n, m.shape)
    heads = params["c"].shape[0]
    p, r = factorized_softmax(x, params["u"], params["c"])
    p_win = window(p, tile)  # (B, 3T, H)
    x_win = window(x, tile)  # (B, 3T, C)
    r_blk = r.reshape(n_blk, tile, heads)
    d = torch.einsum("bth,bwh->btw", r_blk, p_win)
    dinv = 1.0 / torch.clamp(d, min=1e-12)
    mf = m.to(torch.float32)
    out = 0.0
    for h in range(heads):
        g = mf * p_win[:, None, :, h] * dinv  # (B, T, 3T)
        z = torch.matmul(g, x_win) * r_blk[..., h, None]
        out = out + z @ params["w"][h]
    return self_loop_epilogue(out.reshape(n, -1), x, params, deg)
