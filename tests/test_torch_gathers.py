"""The gathers' custom backwards against jax.grad of the JAX functions.

`table_gather` and `table_gather_compact` (geobignn_tpu_torch/ops/table.py)
against geobignn_tpu/ops/table.py, and the hybrid conv's `_gather_unique` /
`_scatter_add_unique` (ops/banded_cuda.py) against
geobignn_tpu/ops/banded_pallas.py, on the same seeded numpy inputs and the
tables the host builders make from an icosphere's vertex graph: the
gradient of sum(out * cot) with respect to every differentiable input, at
1e-5 of its largest entry.  Rows that the reverse tables do not list (the
trash slots, which hold nonzero values here on purpose) get zero gradient
in both packages.  Last, `testing.same_branches`, which holds a step to
another step's max-pooling picks and LeakyReLU signs (chip_smoke.py's
float32-against-float64 gradients).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geobignn_tpu import graphs
from geobignn_tpu.data import synth
from geobignn_tpu.ops import banded as jbanded
from geobignn_tpu.ops import banded_pallas
from geobignn_tpu.ops import table as jtable
from geobignn_tpu_torch.ops import banded_cuda
from geobignn_tpu_torch.ops import table as ttable
from geobignn_tpu_torch.structs import round_up
from geobignn_tpu_torch.testing import share_cores

share_cores()  # torch's CPU threads: this test worker's share of the cores

TOL = 1e-5
C = 5


def _graph(subdiv: int, tile: int, rcm: bool):
    """An icosphere's vertex graph in RCM (or a seeded random) order, with
    its node count padded to a multiple of tile plus a trash slot."""
    m = synth.icosphere(subdiv)
    ei = graphs.build_vertex_graph_1ring(m.ev_indices, m.n_vertices).astype(np.int64)
    n = m.n_vertices
    perm = jbanded.rcm_order(ei, n) if rcm else np.random.default_rng(0).permutation(n)
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    return np.stack([inv[ei[0]], inv[ei[1]]]), n, round_up(n + 1, tile)


def _check(jax_fn, torch_fn, inputs, n_diff, seed=0):
    """jax.grad and torch's gradient of sum(fn(*inputs) * cot) with respect
    to the first n_diff inputs agree within TOL of their max."""
    out = jax_fn(*map(jnp.asarray, inputs))
    cot = np.random.default_rng(seed).normal(size=out.shape).astype(np.float32)
    want = jax.grad(lambda *d: jnp.sum(jax_fn(*d, *map(jnp.asarray, inputs[n_diff:]))
                                       * cot), argnums=tuple(range(n_diff)))(
        *map(jnp.asarray, inputs[:n_diff]))
    t_in = [torch.from_numpy(np.asarray(a)) for a in inputs]
    t_in = [t.long() if not t.is_floating_point() else t for t in t_in]
    diff = [t.requires_grad_() for t in t_in[:n_diff]]
    got_out = torch_fn(*t_in)
    np.testing.assert_array_equal(got_out.detach().numpy(), np.asarray(out))
    (got_out * torch.from_numpy(cot)).sum().backward()
    for d, w in zip(diff, want):
        w = np.asarray(w)
        np.testing.assert_allclose(d.grad.numpy(), w, rtol=0,
                                   atol=TOL * max(float(np.abs(w).max()), 1e-30))
    return [d.grad.numpy() for d in diff]


@pytest.mark.parametrize("case", ["neighbor table", "pool members", "unpool"])
def test_table_gather_gradient_matches_jax(case):
    ei, n, n_pad = _graph(2, 8, rcm=True)
    rng = np.random.default_rng(1)
    if case == "neighbor table":
        nbr, _, _ = jtable.neighbor_table_np(ei, n_pad)
        rev, _ = jtable.reverse_table_np(nbr, n_pad)
        n_src = n_pad
    elif case == "pool members":
        n_out = round_up(n // 3 + 1, 8)
        cluster = np.full(n_pad, n_out - 1, np.int32)
        cluster[:n] = rng.integers(0, n // 3, size=n)
        nbr, _, _ = jtable.members_table_np(cluster, None, n_out)
        rev, _ = jtable.reverse_table_np(nbr, n_pad)
        n_src = n_pad
    else:
        n_src = round_up(n // 3 + 1, 8)
        unpool = np.full(n_pad, n_src - 1, np.int32)
        unpool[:n] = rng.integers(0, n // 3, size=n)
        nbr = unpool[:, None]
        rev, _ = jtable.reverse_table_np(nbr, n_src)
    x = rng.normal(size=(n_src, C)).astype(np.float32)  # the trash row too
    assert (nbr == n_src - 1).any()  # padding entries point at the trash row
    (dx,) = _check(jtable.table_gather, ttable.table_gather, (x, nbr, rev), 1)
    assert (dx[n_src - 1] == 0).all()  # rev lists no position of the trash row


def test_table_gather_compact_gradient_matches_jax():
    """The boundary table of the hybrid conv: a random node order and a
    small tile leave most edges out of the band window."""
    ei, _, n_pad = _graph(2, 16, rcm=False)
    arrs = jbanded.hybrid_arrays_np(ei, n_pad, 16, m_b=n_pad, k_b=16, r_b=16, s_b=n_pad)
    nbr_b, src_b, rev_b = arrs["nbr_b"], arrs["src_b"], arrs["rev_b"]
    trash = n_pad - 1
    assert (src_b == trash).any() and (nbr_b == trash).any()
    x = np.random.default_rng(2).normal(size=(n_pad, C)).astype(np.float32)
    (dx,) = _check(jtable.table_gather_compact, ttable.table_gather_compact,
                   (x, nbr_b, src_b, rev_b), 1)
    listed = np.zeros(n_pad, bool)
    listed[src_b[src_b != trash]] = True
    assert (dx[~listed] == 0).all() and np.abs(dx[listed]).max() > 0


def _boundary():
    ei, _, n_pad = _graph(2, 16, rcm=True)
    arrs = jbanded.boundary_band_np(ei, n_pad, 16)
    assert arrs is not None and (arrs["jnodes"] == n_pad - 1).any()
    return arrs["jnodes"], arrs["jpos"], n_pad


@pytest.mark.parametrize("fn", ["_gather_unique", "_scatter_add_unique"])
def test_unique_gathers_gradient_match_jax(fn):
    jnodes, jpos, n_pad = _boundary()
    rng = np.random.default_rng(3)
    x = rng.normal(size=(n_pad, C)).astype(np.float32)
    if fn == "_gather_unique":
        (dx,) = _check(banded_pallas._gather_unique, banded_cuda._gather_unique,
                       (x, jnodes, jpos), 1)
        assert (dx[n_pad - 1] == 0).all()  # the trash slot jnodes repeats
    else:
        corr = rng.normal(size=(jnodes.shape[0], C)).astype(np.float32)
        _check(banded_pallas._scatter_add_unique, banded_cuda._scatter_add_unique,
               (x, corr, jnodes, jpos), 2)


def test_same_branches_records_and_replays_the_picks_and_signs(monkeypatch):
    """testing.same_branches: recording the max-pooling picks and LeakyReLU
    signs leaves a step's gradients bit-equal; a float64 step held to them
    differs from the float32 one by rounding alone (1e-4 of each tensor's
    max|g|), and every value it flips is a near-tie; replaying other picks
    is refused, being no tie, and without that bound moves the gradients
    (the recorded branch is taken)."""
    from geobignn_tpu_torch.config import Config
    from geobignn_tpu_torch.data import dataset, synth as tsynth
    from geobignn_tpu_torch.models.dual_gnn import DualGNN
    from geobignn_tpu_torch import testing
    from geobignn_tpu_torch.testing import (TIE_TOL, aggregates_in, float64_sample,
                                            same_branches)

    clean = tsynth.icosphere(2)
    ds = dataset.InMemoryDataset([(tsynth.add_noise(clean, 0.2, seed=0), clean)],
                                 Config().build_config(), submesh_size=100000)
    sample = ds.get(0, ds.plan).to("cpu")

    def grads(dtype, smp):
        model = DualGNN(compute_dtype=dtype, fc_dtype=dtype, device="cpu", seed=0).to(dtype)
        with aggregates_in(dtype):
            vert_p, norm_p = model(smp)
            (vert_p.square().sum() + norm_p.sum()).backward()
        return [p.grad.double() for p in model.parameters()]

    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # CPU gradients are bit-repeatable on one thread
    try:
        picks: list = []
        with same_branches(picks, replay=False):
            recorded = grads(torch.float32, sample)
        # 4 pooling steps and 6 activations a branch, one in each head
        assert len(picks) == 2 * (4 + 6 + 1)
        assert all(torch.equal(a, b) for a, b in zip(recorded, grads(torch.float32, sample)))
        with same_branches(picks, replay=True) as ties:
            held = grads(torch.float64, float64_sample(sample))
        for a, b in zip(recorded, held):  # float32 rounding alone
            assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
        assert ties[1] <= TIE_TOL
        others = [p.flip(0) for p in picks]
        with pytest.raises(AssertionError, match="not a near-tie"):
            with same_branches(others, replay=True):
                grads(torch.float32, sample)
        monkeypatch.setattr(testing, "TIE_TOL", float("inf"))
        with same_branches(others, replay=True) as flips:
            moved = grads(torch.float32, sample)
        assert flips[0] > 0 and flips[1] > TIE_TOL
        assert not all(torch.equal(a, b) for a, b in zip(recorded, moved))
    finally:
        torch.set_num_threads(threads)
