"""Dynamic pooling's graph operations against the JAX package on the CPU:
`coalesce_edges` (both modes), `parallel_matching` and its scatter oracle,
`pool_with_rep`, `pool_edges_with_rep` and the tensor branch of
`compute_edge_weight` for every strategy.

Inputs are made with numpy from seeds (a noisy icosphere's vertex graph,
trash-padded as the samples carry it) and handed to both packages.
Integer outputs (edge lists, representatives) must be bit-equal; float
outputs are held at the tolerance stated at each comparison.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geobignn_tpu import graphs as jgraphs
from geobignn_tpu.data import synth as jsynth
from geobignn_tpu.ops import coalesce as jcoalesce
from geobignn_tpu.ops import matching as jmatching
from geobignn_tpu.pool import edge_weight as jew
from geobignn_tpu_torch.ops import coalesce, matching
from geobignn_tpu_torch.pool import edge_weight as ew
from geobignn_tpu_torch.testing import share_cores

share_cores()  # torch's CPU threads: this test worker's share of the cores


def _graph(sub: int = 2, seed: int = 0, pad_nodes: int = 5, pad_edges: int = 9,
           ties: bool = False, shuffle: bool = False):
    """(edge_index (2, E) int32 trash-padded, weights (E,) f32, n_pad) of a
    noisy icosphere's 1-ring vertex graph; `ties` sets a third of the
    weights to one value, `shuffle` permutes the edges."""
    m = jsynth.add_noise(jsynth.icosphere(sub), 0.2, seed=seed)
    ei = jgraphs.build_vertex_graph_1ring(m.ev_indices, m.n_vertices)
    n_pad = m.n_vertices + pad_nodes
    trash = n_pad - 1
    ei_p = np.full((2, ei.shape[1] + pad_edges), trash, np.int32)
    ei_p[:, : ei.shape[1]] = ei
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.1, 1.0, ei_p.shape[1]).astype(np.float32)
    # symmetric weights, as the stored bilateral ones are
    key = {}
    for k, (r, c) in enumerate(ei_p.T):
        key.setdefault((min(r, c), max(r, c)), w[k])
        w[k] = key[(min(r, c), max(r, c))]
    if ties:
        w[: ei.shape[1] // 3] = 0.5
    w[ei.shape[1]:] = 0.0
    if shuffle:
        perm = rng.permutation(ei_p.shape[1])
        ei_p, w = ei_p[:, perm], w[perm]
    return ei_p, w, n_pad


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64 if np.asarray(a).dtype.kind in "iu"
                                                 else np.float32))


# --------------------------------------------------------------------------
# coalesce: edge lists bit-equal, weights within 1e-6 of their max
# --------------------------------------------------------------------------

def _duplicated(seed: int):
    """A graph relabelled through a random many-to-one map: duplicates,
    self-collapsed edges and trash padding, as pooling makes them."""
    ei, w, n_pad = _graph(2, seed)
    rng = np.random.default_rng(seed + 100)
    lab = np.minimum(np.arange(n_pad), rng.integers(0, n_pad - 1, n_pad))
    lab[n_pad - 1] = n_pad - 1
    return lab[ei].astype(np.int32), w, n_pad


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_coalesce_matches_jax(compact, seed):
    ei, w, n_pad = _duplicated(seed)
    j_ei, j_w = jcoalesce.coalesce_edges(jnp.asarray(ei), jnp.asarray(w), n_pad, compact)
    t_ei, t_w = coalesce.coalesce_edges(_t(ei), _t(w), n_pad, compact)
    np.testing.assert_array_equal(t_ei.numpy(), np.asarray(j_ei))
    j_w = np.asarray(j_w)
    assert np.abs(t_w.numpy() - j_w).max() <= 1e-6 * np.abs(j_w).max()
    if compact:
        assert (np.diff(t_ei[0].numpy()) >= 0).all()
    j_ei2, j_w2 = jcoalesce.coalesce_edges(jnp.asarray(ei), None, n_pad, compact)
    t_ei2, t_w2 = coalesce.coalesce_edges(_t(ei), None, n_pad, compact)
    assert t_w2 is None and j_w2 is None
    np.testing.assert_array_equal(t_ei2.numpy(), np.asarray(j_ei2))


def test_coalesce_static_shape_and_means():
    """The JAX package's own hand-made case: duplicates (0, 1) x 2, a self
    loop (2, 2) and trash padding (4, 4)."""
    ei = np.array([[0, 0, 1, 2, 4, 4], [1, 1, 0, 2, 4, 4]], np.int64)
    w = np.array([1.0, 3.0, 5.0, 7.0, 0.0, 0.0], np.float32)
    out_ei, out_w = coalesce.coalesce_edges(torch.from_numpy(ei), torch.from_numpy(w), 5)
    rows = out_ei.numpy().T.tolist()
    d = {tuple(r): float(v) for r, v in zip(rows, out_w.numpy())}
    assert d[(0, 1)] == pytest.approx(2.0) and d[(1, 0)] == pytest.approx(5.0)
    assert [2, 2] not in rows and rows.count([4, 4]) == 4


# --------------------------------------------------------------------------
# matching: rep bit-equal to JAX's and to the scatter oracle
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed,ties,shuffle", [
    (0, False, False), (1, True, False), (2, False, True), (3, True, True)])
def test_parallel_matching_matches_jax(seed, ties, shuffle):
    ei, w, n_pad = _graph(3, seed, ties=ties, shuffle=shuffle)
    for rounds in (1, 2, 8):
        got = matching.parallel_matching(_t(ei), _t(w), n_pad, rounds)
        assert got.dtype == torch.int64
        # the JAX flag only cheapens its sort: both ways give the port's picks
        for rows_sorted in (False, True):
            np.testing.assert_array_equal(got.numpy(), np.asarray(jmatching.parallel_matching(
                jnp.asarray(ei), jnp.asarray(w), n_pad, rounds, rows_sorted=rows_sorted)))
        oracle = matching._parallel_matching_scatter(_t(ei), _t(w), n_pad, rounds)
        np.testing.assert_array_equal(oracle.numpy(), got.numpy())
        np.testing.assert_array_equal(oracle.numpy(), np.asarray(
            jmatching._parallel_matching_scatter(jnp.asarray(ei), jnp.asarray(w), n_pad, rounds)))
    # uniform weights (edge_weight None), every tie broken toward the smaller id
    np.testing.assert_array_equal(
        matching.parallel_matching(_t(ei), None, n_pad).numpy(),
        np.asarray(jmatching.parallel_matching(jnp.asarray(ei), None, n_pad)))


def test_matching_is_a_heavy_matching():
    ei, w, n_pad = _graph(2, 0)
    rep = matching.parallel_matching(_t(ei), _t(w), n_pad).numpy()
    n = n_pad - 5
    _, counts = np.unique(rep[:n], return_counts=True)
    assert counts.max() <= 2 and (counts == 2).sum() * 2 >= 0.7 * n
    np.testing.assert_array_equal(rep[rep[:n]], rep[:n])
    # path 0-1-2, w(0,1) = 10, w(1,2) = 0.1: 1 pairs with 0, 2 stays alone
    pe = torch.tensor([[0, 1, 1, 2, 3], [1, 0, 2, 1, 3]])
    pw = torch.tensor([10.0, 10.0, 0.1, 0.1, 0.0])
    assert matching.parallel_matching(pe, pw, 4, rounds=4).tolist() == [0, 0, 2, 3]


# --------------------------------------------------------------------------
# pooling through rep: features 1e-6, edge lists bit-equal
# --------------------------------------------------------------------------

@pytest.mark.parametrize("pool_type", ["max", "mean"])
def test_pool_with_rep_matches_jax(pool_type):
    ei, w, n_pad = _graph(2, 4)
    rep = np.asarray(jmatching.parallel_matching(jnp.asarray(ei), jnp.asarray(w), n_pad))
    x = np.random.default_rng(4).normal(size=(n_pad, 7)).astype(np.float32)
    x[-1] = 0.0
    want = np.asarray(jmatching.pool_with_rep(jnp.asarray(x), jnp.asarray(rep), pool_type))
    got = matching.pool_with_rep(_t(x), _t(rep), pool_type).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_pool_edges_with_rep_matches_jax():
    ei, w, n_pad = _graph(3, 5)
    rep = np.asarray(jmatching.parallel_matching(jnp.asarray(ei), jnp.asarray(w), n_pad))
    j_ei, j_w = jmatching.pool_edges_with_rep(jnp.asarray(ei), jnp.asarray(w),
                                              jnp.asarray(rep), n_pad)
    t_ei, t_w = matching.pool_edges_with_rep(_t(ei), _t(w), _t(rep), n_pad)
    np.testing.assert_array_equal(t_ei.numpy(), np.asarray(j_ei))
    assert np.abs(t_w.numpy() - np.asarray(j_w)).max() <= 1e-6 * np.abs(np.asarray(j_w)).max()
    # and the next round's matching on them, as dynamic pooling runs it
    np.testing.assert_array_equal(
        matching.parallel_matching(t_ei, t_w, n_pad).numpy(),
        np.asarray(jmatching.parallel_matching(j_ei, j_w, n_pad, rows_sorted=True)))


# --------------------------------------------------------------------------
# edge weights on tensors, every strategy: 1e-6 of the max
# --------------------------------------------------------------------------

@pytest.mark.parametrize("wt", list(range(-1, 11)))
def test_edge_weight_on_tensors_matches_jax(wt):
    ei, w, n_pad = _graph(2, 6)
    real = ei[0] != ei[1]
    ei, w = ei[:, real], w[real]  # the strategies take no self-loops
    rng = np.random.default_rng(wt + 10)
    c = 5
    x = rng.normal(size=(n_pad, c)).astype(np.float32)
    att_l = rng.normal(size=(1, c)).astype(np.float32)
    att_r = rng.normal(size=(1, c)).astype(np.float32)
    kern = (rng.normal(size=(c, c)) * 0.5).astype(np.float32)
    bias = (rng.normal(size=c) * 0.1).astype(np.float32)
    learned = wt in (3, 4, 5)
    want = jew.compute_edge_weight(
        wt, jnp.asarray(ei), jnp.asarray(w), jnp.asarray(x), 1.5,
        jnp.asarray(att_l) if learned else None, jnp.asarray(att_r) if learned else None,
        (lambda v: v @ jnp.asarray(kern) + jnp.asarray(bias)) if learned else None)
    got = ew.compute_edge_weight(
        wt, _t(ei), _t(w), _t(x), 1.5,
        _t(att_l) if learned else None, _t(att_r) if learned else None,
        (lambda v: v @ _t(kern) + _t(bias)) if learned else None)
    if wt == -1:
        assert got is None and want is None
        return
    assert torch.is_tensor(got) and got.dtype == torch.float32
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= 1e-6 * max(np.abs(want).max(), 1.0)
    # the host branch still takes numpy and gives the JAX host values
    host = ew.compute_edge_weight(wt, ei, w, x, 1.5)
    np.testing.assert_allclose(host, jew.compute_edge_weight(wt, ei, w, x, 1.5), rtol=1e-6)


# --------------------------------------------------------------------------
# the COO conv's gathers: x[idx] with a sorted-sum backward
# --------------------------------------------------------------------------

@pytest.mark.parametrize("sorted_", [False, True], ids=["unsorted", "sorted"])
def test_take_rows_gradient_is_the_index_gradient(sorted_):
    """segment.take_rows: the rows of x[idx], and the gradient of x[idx]
    (float64: exact sums in either order), with one index repeated most
    often, as the trash slot is in a padded edge list."""
    from geobignn_tpu_torch.ops import segment

    ei, _, n_pad = _graph(2, 7, pad_edges=300)
    idx = torch.from_numpy(ei[0].astype(np.int64) if sorted_ else ei[1].astype(np.int64))
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(n_pad, 5))).requires_grad_()
    g = torch.from_numpy(rng.normal(size=(idx.shape[0], 5)))
    got = segment.take_rows(x, idx, sorted=sorted_)
    got.backward(g)
    dx = x.grad.clone()
    x.grad = None
    want = x[idx]
    want.backward(g)
    assert torch.equal(got, want)
    assert float((dx - x.grad).abs().max()) <= 1e-12 * float(x.grad.abs().max())
