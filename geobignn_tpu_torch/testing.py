"""What the CPU tests, the card-only tests and chip_smoke.py share: the
seeded edge cases of the window aggregates, and the means of holding a
float32 step against a float64 one (`float64_sample`, `aggregates_in`,
`grad_agreement`, `same_branches`), a step on one device held to another's
dynamic-pooling picks (`same_matchings`), the model's rematerialization switched off
(`without_remat`) or measured (`heads_peak_bytes`), the eager step and
forward in place of their CUDA graphs (`eager_steps`), the JAX
package's native path brought to the one this machine supports
(`match_reference_native`), and torch's CPU threads cut to one test
worker's share of the cores (`share_cores`).

`edge_case_inputs`, made with numpy, so that the port-against-JAX tests and
the kernels-against-plain checks hold the same cases:

  * rows without a set slot, and nodes that no row's window sets;
  * absent neighbours: set slots of the first row block's first third
    (nodes below 0) and of the last row block's last third (nodes from N
    on), which read as zero;
  * mask values 2 and 3 beside 1 (the mask is taken as a number);
  * a row with more than 32 set slots and a node set by every row of the
    row blocks that see it (the kernels walk set slots in batches of 32);
  * rows and nodes whose D = sum_h r[i,h] p[j,h] lies under the 1e-12
    clamp, where the forward divides by the clamp and the backward's
    denominator path is cut.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import os
import time

import numpy as np
import torch


def edge_case_inputs(c_in: int, c_out: int, tile: int = 32, n_blk: int = 3,
                     heads: int = 9, seed: int = 0, blocksparse: bool = False) -> dict:
    """Inputs of `banded_aggregate` (or, with blocksparse, `bs_aggregate`)
    and its backward: float32 r, p (N, H), x (N, C_in), w (H, C_in, C_out),
    gout (N, C_out), int8 m (B, T, 3T) — or (B, T, K T) beside an int64
    blk_idx (B, K), K = 4, whose last entry is a padded one (the row
    block's own index again under an all-zero mask) — and `clamped`, the
    rows whose D lies under the clamp (their r̄ is of the order of 1e12 and
    is compared apart from the other rows')."""
    rng = np.random.default_rng(seed)
    n = n_blk * tile
    x = rng.normal(size=(n, c_in)).astype(np.float32)
    a = x @ (rng.normal(size=(c_in, heads)) * 0.5).astype(np.float32)
    c = (rng.normal(size=heads) * 0.3).astype(np.float32)
    p = np.exp(a - a.max(1, keepdims=True)).astype(np.float32)
    ca = c - a
    r = np.exp(ca - ca.max(1, keepdims=True)).astype(np.float32)
    w = (rng.normal(size=(heads, c_in, c_out)) * 0.4).astype(np.float32)
    gout = rng.normal(size=(n, c_out)).astype(np.float32)

    k_blk = 4 if blocksparse else 3
    win = k_blk * tile
    m = np.zeros((n_blk, tile, win), np.int8)
    live = (k_blk - 1) * tile if blocksparse else win  # the padded entry stays empty
    for b in range(n_blk):
        for t in range(tile):
            slots = rng.choice(live, size=int(rng.integers(3, 9)), replace=False)
            m[b, t, slots] = rng.integers(1, 4, size=slots.size)
    out = {}
    if blocksparse:
        # each row block lists itself, two other column blocks (sorted, as
        # block_sparse_np lists them) and itself again as the padded entry
        blk_idx = np.empty((n_blk, k_blk), np.int64)
        for b in range(n_blk):
            others = rng.choice([q for q in range(n_blk) if q != b],
                                size=min(2, n_blk - 1), replace=False)
            lst = sorted({b, *others.tolist()})
            lst += [b] * (k_blk - len(lst))
            blk_idx[b] = lst
            m[b, :, (k_blk - 1) * tile:] = 0
            for pos in range(len(set(lst)), k_blk):  # every repeated entry is padding
                m[b, :, pos * tile:(pos + 1) * tile] = 0
        out["blk_idx"] = blk_idx
    else:
        # absent neighbours at both ends, set on purpose
        m[0, ::3, : tile : 5] = 2
        m[-1, 1::3, 2 * tile + 1 :: 7] = 3

    # a dense row and a dense column: more set slots than one batch holds
    dense = rng.choice(live, size=min(live - 8, 70), replace=False)
    m[0, 7, dense] = rng.integers(1, 4, size=dense.size)
    if blocksparse:
        m[:, :, 9] = 1  # node blk_idx[b, 0] * tile + 9, in every row of block b
    else:
        j = tile + 9
        for b in range(n_blk):
            w_slot = j - (b - 1) * tile
            if 0 <= w_slot < win:
                m[b, :, w_slot] = 1

    empty_rows = np.array([1, tile, n - 2])
    m.reshape(n, win)[empty_rows] = 0
    if not blocksparse:  # a node that no window sets: its column in the three blocks
        j = tile + 5
        for b in range(n_blk):
            w_slot = j - (b - 1) * tile
            if 0 <= w_slot < win:
                m[b, :, w_slot] = 0

    clamped = np.array([3, tile + 3, n - 5])
    r[clamped] *= np.float32(1e-16)
    p[tile // 2] *= np.float32(1e-16)  # a node under the clamp for every row
    assert (m.reshape(n, win)[clamped] != 0).any(axis=1).all()
    d = r[clamped] @ p.T
    assert (d < 1e-12).all()
    out.update(r=r, p=p, x=x, w=w, m=m, gout=gout, clamped=clamped)
    return out


def float64_sample(value):
    """A DualSample (or any of its parts) with every floating-point tensor in
    float64; indices, masks and static fields as they are."""
    if dataclasses.is_dataclass(value):
        return dataclasses.replace(value, **{
            f.name: float64_sample(getattr(value, f.name)) for f in dataclasses.fields(value)})
    if isinstance(value, tuple):
        return tuple(float64_sample(v) for v in value)
    if torch.is_tensor(value) and value.is_floating_point():
        return value.to(torch.float64)
    return value


@contextlib.contextmanager
def aggregates_in(compute_dtype):
    """While open, every banded and block-sparse aggregate computes in
    compute_dtype (the model's default rounds their operands to bf16):
    float32 on either device, float64 on the CPU's plain versions."""
    from geobignn_tpu_torch.ops import banded_cuda, blocksparse

    agg, bs_agg = banded_cuda.banded_aggregate, blocksparse.bs_aggregate
    banded_cuda.banded_aggregate = (
        lambda r, p, x, w, m, compute_dtype_=None: agg(r, p, x, w, m, compute_dtype))
    blocksparse.bs_aggregate = (
        lambda r, p, x, w, m, i, compute_dtype_=None: bs_agg(r, p, x, w, m, i, compute_dtype))
    try:
        yield
    finally:
        banded_cuda.banded_aggregate, blocksparse.bs_aggregate = agg, bs_agg


def grad_agreement(model, reference) -> dict:
    """{parameter: (max|g - g_ref| / max|g_ref|, cosine of g and g_ref)} over
    two models' .grad, in float64 on the CPU."""
    refs = dict(reference.named_parameters())
    out = {}
    for name, prm in model.named_parameters():
        a = prm.grad.detach().double().cpu()
        b = refs[name].grad.detach().double().cpu()
        cos = float((a * b).sum()) / max(float(a.norm() * b.norm()), 1e-300)
        out[name] = (float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30), cos)
    return out


TIE_TOL = 1e-5  # of a row's scale: how far apart rounding may put two branches


@contextlib.contextmanager
def same_branches(choices: list, replay: bool):
    """While open, the models' piecewise functions — the max-pooling
    (`table.gather_pool_max`) and the activations (DualGNN's LeakyReLU
    `dual_gnn._act`, the legacy models' `legacy._leaky` and `legacy._relu`,
    ReLU a LeakyReLU of slope 0) — either
    record, call by call, the branch they take (appended to `choices`: the
    member each row and channel picks, the sign of each input), or, with
    replay, take the recorded branch wherever their own differs.

    The gradient of a max jumps where two members tie, that of a LeakyReLU
    where its input crosses 0: two steps that round such a point apart (a
    float32 and a float64 step, or two devices) differentiate different
    branches, and their gradients differ by the jump, not by rounding.
    Replaying the reference step's branches in the others holds them to
    one; where nothing flips, values and gradients are those of the plain
    functions.  Rematerialization is off while open, so that each call
    runs once (its gradients are bit-equal either way).

    Only a near-tie may be held: at each value replay flips, its own
    branch's value and the recorded one's must lie within TIE_TOL of the
    row's scale (the largest magnitude among a pooled node's members, or
    among a node's activation inputs), else AssertionError — a branch taken
    by a wider margin is a different result, not rounding.  Yields a
    two-item list, filled once the run is done: the values that flipped,
    and the largest of those distances over its row's scale."""
    from geobignn_tpu_torch.models import dual_gnn, legacy
    from geobignn_tpu_torch.ops import table

    pool = table.gather_pool_max
    acts = [(dual_gnn, "_act", dual_gnn.LEAKY_SLOPE), (legacy, "_leaky", legacy.LEGACY_SLOPE),
            (legacy, "_relu", 0.0)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in acts]
    calls = iter(list(choices))
    flips = [0, 0.0]

    def held(own, plain, forced, scale):
        """plain where own matches the recorded branch, else forced."""
        if not replay:
            choices.append(own.detach().cpu())
            return plain
        want = next(calls).to(own.device)
        flip = own != want
        alt = forced(want)
        if bool(flip.any()):
            gap = ((plain - alt).detach().abs() / scale.detach().clamp(min=1e-30))[flip]
            worst = float(gap.max())
            flips[0] += int(flip.sum())
            flips[1] = max(flips[1], worst)
            if worst > TIE_TOL:
                raise AssertionError(
                    f"a held branch is {worst:.3e} of its row's scale from the "
                    f"step's own (TIE_TOL {TIE_TOL}): not a near-tie")
        return torch.where(flip, alt, plain)

    def max_pool(x, members, rev, mmask):
        out = pool(x, members, rev, mmask)
        g = table.table_gather(x, members, rev)
        masked = torch.where(mmask[..., None] > 0, g, g.new_full((), -torch.inf))
        has = (mmask.sum(dim=1) > 0)[:, None]
        pick = torch.where(has, masked.argmax(dim=1), -1)
        scale = torch.where(mmask[..., None] > 0, g.abs(), 0).amax(dim=(1, 2))[:, None]
        return held(pick, out, lambda want: masked.gather(
            1, want.clamp(min=0)[:, None]).squeeze(1), scale)

    def leaky(act, slope):
        return lambda v: held(v > 0, act(v), lambda want: torch.where(
            want, v, v * slope), v.abs().amax(dim=-1, keepdim=True))

    table.gather_pool_max = max_pool
    for (mod, name, slope), (_, _, act) in zip(acts, saved):
        setattr(mod, name, leaky(act, slope))
    try:
        with without_remat():
            yield flips
    finally:
        table.gather_pool_max = pool
        for mod, name, act in saved:
            setattr(mod, name, act)


def ranked_apart(edge_index: torch.Tensor, w_ref: torch.Tensor, w: torch.Tensor):
    """(pairs, widest) for the edges of one node that `w` ranks in the other
    order than `w_ref` does — the only way a matching sees its weights is
    each node's ranking of its edges by (weight, -col), self-loops and
    trash padding left out: the number of edges that `w` puts below one
    that `w_ref` ranks under them, and the widest such gap in `w`, over
    max|w_ref|."""
    row, col = (t.cpu().numpy() for t in edge_index)
    scale = max(float(w_ref.abs().max()), 1e-30)
    w_ref, w = (t.detach().double().cpu().numpy() / scale for t in (w_ref, w))
    real = row != col
    row, col, w_ref, w = row[real], col[real], w_ref[real], w[real]
    order = np.lexsort((-col, w_ref, row))
    # a running max of w along each node's run in w_ref's order: rows
    # shifted 4 apart (|w| <= about 1 after the scaling) keep runs apart
    key = row[order] * 4.0 + w[order]
    prev = np.concatenate([[-np.inf], np.maximum.accumulate(key)[:-1]])
    gap = prev - key
    return int((gap > 0).sum()), float(max(gap.max(initial=0.0), 0.0))


@contextlib.contextmanager
def same_matchings(records: list, replay: bool, weight_tol: float):
    """While open, dynamic pooling's matchings (`ops.matching.
    parallel_matching`, as pool/dynamic.py calls it) either record, call by
    call, their representatives and the edge weights they were given
    (appended to `records`), or, with replay, return the recorded
    representatives in place of their own.

    Two steps on two devices weigh the edges from activations that agree
    to rounding, and a near-tie between two candidate edges of a node can
    then pick another partner.  Replay holds the second step to the first
    one's picks, and shows each call whose picks differ to be such a case:
    the same matching on the recorded weights gives the recorded picks (so
    the picks differ through the weights alone); the weights lie within
    `weight_tol` of the recorded ones' scale; and every pair of candidate
    edges of a node that the two weight vectors rank in the other order
    (`ranked_apart`) lies within `weight_tol` of that scale, so each
    differing pick comes from near-ties.  Else AssertionError.  Yields a
    list, filled as the run goes: per call, (representatives that differ,
    the weights' largest distance over their scale, edges ranked apart,
    the widest of their gaps over the scale)."""
    from geobignn_tpu_torch.ops import matching

    fn = matching.parallel_matching
    calls = iter(list(records))
    seen: list = []

    def held(edge_index, w, n_pad, *args, **kw):
        rep = fn(edge_index, w, n_pad, *args, **kw)
        if not replay:
            records.append((rep.cpu(), None if w is None else w.detach().cpu()))
            return rep
        want, w_ref = next(calls)
        want = want.to(rep.device)
        n_diff, gap, pairs, widest = int((rep != want).sum()), 0.0, 0, 0.0
        if w is not None:
            w_ref = w_ref.to(w.device)
            gap = float((w.detach() - w_ref).abs().max()) / max(float(w_ref.abs().max()), 1e-30)
            pairs, widest = ranked_apart(edge_index, w_ref, w)
        if n_diff:
            again = fn(edge_index, w_ref, n_pad, *args, **kw)
            if not torch.equal(again, want) or gap > weight_tol or widest > weight_tol:
                raise AssertionError(
                    f"{n_diff} representatives differ, and not by a near-tie: the "
                    f"recorded weights give the recorded picks {torch.equal(again, want)}, "
                    f"the weights {gap:.3e} of their scale apart, {pairs} edges ranked "
                    f"apart by up to {widest:.3e} of it (tol {weight_tol})")
        seen.append((n_diff, gap, pairs, widest))
        return want

    matching.parallel_matching = held
    try:
        yield seen
    finally:
        matching.parallel_matching = fn


@contextlib.contextmanager
def without_remat():
    """While open, the model keeps every intermediate for the backward: its
    one rematerialization switch, `models.dual_gnn._remat`, is a plain call."""
    from geobignn_tpu_torch.models import dual_gnn

    remat = dual_gnn._remat
    dual_gnn._remat = lambda fn, *args: fn(*args)
    try:
        yield
    finally:
        dual_gnn._remat = remat


def heads_peak_bytes(model, feat: torch.Tensor, chunked: bool) -> int:
    """Peak device bytes, above what was allocated before, of the facet
    head's forward and backward over feat (N, 32) on the card: in the
    model's row chunks, rematerialized (chunked=True), or in one piece with
    every intermediate kept."""
    rows = model.fc_chunk_rows
    if not chunked:
        model.fc_chunk_rows = feat.shape[0]
    try:
        with contextlib.nullcontext() if chunked else without_remat():
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            x = feat.detach().requires_grad_()
            model._run_head(model.fc_f1, model.fc_f2, x).sum().backward()
            torch.cuda.synchronize()
            return torch.cuda.max_memory_allocated() - base
    finally:
        model.fc_chunk_rows = rows


@contextlib.contextmanager
def eager_steps():
    """While open, the trainer and the predictor run their step and their
    forward eagerly on the card, kernel by kernel, instead of capturing and
    replaying a CUDA graph: the one switch, `capture.EAGER`, that tests and
    chip_smoke.py compare the two with."""
    from geobignn_tpu_torch import capture

    eager = capture.EAGER
    capture.EAGER = True
    try:
        yield
    finally:
        capture.EAGER = eager


def match_reference_native(jax_native, timeout: float = 300.0) -> bool:
    """Bring the JAX package's native module (passed in: this package
    imports no JAX) to the path this machine supports, and return whether
    that is the native library.

    The JAX loader builds `native/libmeshkernel.so` in place at import and
    fixes `HAS_NATIVE` then, so a process that imports it while another is
    still writing the file reads False for its whole life and builds other
    hierarchies than the port.  This builds the port's own library; where
    that loads and the reference reads False, it reloads the reference
    module until it loads too (another process may still be writing the
    file).  The JAX package's graphs.py, pool/hierarchy.py and meshio.py
    read `native.HAS_NATIVE` at call time, so the reload reaches them.
    Neither side is put on a path the machine does not have: where the
    port's library does not build, nothing is changed."""
    from geobignn_tpu_torch import native

    if not native.has_native():
        return False
    deadline = time.monotonic() + timeout
    while not jax_native.HAS_NATIVE:
        if time.monotonic() > deadline:
            raise RuntimeError(
                f"the port's native library loads, the JAX package's "
                f"{jax_native.__file__} did not within {timeout} s")
        importlib.reload(jax_native)
        if not jax_native.HAS_NATIVE:
            time.sleep(0.5)
    return True


def share_cores() -> int:
    """Give torch's CPU kernels this process's share of the machine's cores
    and return it: the cores over pytest-xdist's worker count
    (PYTEST_XDIST_WORKER_COUNT), at least one; a process alone keeps them
    all.  torch's OpenMP threads spin while they wait, so several test
    workers each running one thread per core slow one another down by an
    order of magnitude on the tests' small tensors.  OMP_NUM_THREADS carries
    the share to the processes a test starts."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    n = max(1, (os.cpu_count() or 1) // max(workers, 1))
    torch.set_num_threads(n)
    os.environ["OMP_NUM_THREADS"] = str(n)
    return n
