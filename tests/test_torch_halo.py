"""The halo path's host structures and device convs against the JAX package.

Host half: every array of parallel/partition.py, halo_model.py and
halo_train.py's builders bit-equal (dtype, shape, value) to the JAX ones on
2 and 4 parts, and the owner-constrained pooling hierarchy they rest on.
Device half: the exchange and each halo conv against the JAX function run
as JAX's own tests run it, under `shard_map` over the virtual CPU devices
of tests/conftest.py, in float32 within 1e-5 of max|out|.  The port runs
its P parts as P tensors on the CPU.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from geobignn_tpu import graphs as jgraphs
from geobignn_tpu import native as jnative
from geobignn_tpu.data import synth as jsynth
from geobignn_tpu.data.builder import BuildConfig as JBuildConfig
from geobignn_tpu.ops.feastconv import FeastParams
from geobignn_tpu.parallel import accounting as jacc
from geobignn_tpu.parallel import halo_train as jht
from geobignn_tpu.parallel import partition as jhp
from geobignn_tpu.parallel.api import make_mesh as jmake_mesh
from geobignn_tpu.pool import hierarchy as jhier
from geobignn_tpu_torch import testing
from geobignn_tpu_torch.data.builder import BuildConfig
from geobignn_tpu_torch.parallel import accounting, api
from geobignn_tpu_torch.parallel import halo_model as hm
from geobignn_tpu_torch.parallel import halo_train as ht
from geobignn_tpu_torch.parallel import partition as hp
from geobignn_tpu_torch.pool import hierarchy

testing.share_cores()  # torch's CPU threads: this test worker's share of the cores

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _reference_native():
    """The JAX package's native path as this machine supports it."""
    testing.match_reference_native(jnative)


def assert_same(a, b, path="root"):
    """Recursive bit-equality of port vs JAX host structures (dataclasses,
    dicts, tuples, lists, arrays, scalars); tensors compare by value."""
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            assert_same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            assert_same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif a is None or isinstance(a, (int, float, str)):
        assert a == b, (path, a, b)
    elif isinstance(a, torch.Tensor):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape, (path, a.shape, b.shape)
        assert np.array_equal(a.numpy(), b), path
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype, a.shape, b.shape)
        assert np.array_equal(a, b), path


@pytest.fixture(scope="module")
def vgraph():
    """The vertex graph of a noisy icosphere(3): 642 vertices."""
    m = jsynth.add_noise(jsynth.icosphere(3), 0.2, seed=0)
    n = m.n_vertices
    ei = jgraphs.build_vertex_graph_1ring(m.ev_indices, n)
    _, w = jgraphs.weighted_graph(ei, n, m.points, np.ones_like(m.points))
    x = np.random.default_rng(0).normal(size=(n, 6)).astype(np.float32)
    return ei, w, n, x


@pytest.mark.parametrize("method", ["rcm", "bfs"])
@pytest.mark.parametrize("n_parts", [2, 4])
def test_partition_and_sharding_match_jax(vgraph, n_parts, method):
    """partition_nodes, build_halo_sharding (its color_rounds schedule),
    halo_tables, partition_rcm_priority, halo_band_arrays and
    shard/unshard_features: bit-equal."""
    ei, w, n, x = vgraph
    owner = hp.partition_nodes(ei, n, n_parts, seed=3, method=method)
    assert_same(owner, jhp.partition_nodes(ei, n, n_parts, seed=3, method=method))
    sh = hp.build_halo_sharding(ei, w, n, owner)
    jsh = jhp.build_halo_sharding(ei, w, n, owner)
    assert_same(sh, jsh)
    assert sh.rounds and sh.h_total == sum(h for _, h in sh.rounds)
    assert_same(hp.halo_tables(sh), jhp.halo_tables(jsh))
    pri, bw = hp.partition_rcm_priority(ei, n, owner)
    jpri, jbw = jhp.partition_rcm_priority(ei, n, owner)
    assert_same(pri, jpri)
    assert bw == jbw
    shb = hp.build_halo_sharding(ei, w, n, owner, priority=pri, n_granularity=128)
    jshb = jhp.build_halo_sharding(ei, w, n, owner, priority=pri, n_granularity=128)
    assert_same(shb, jshb)
    assert_same(hp.halo_band_arrays(shb, 128), jhp.halo_band_arrays(jshb, 128))
    x_loc = hp.shard_features(x, sh)
    assert_same(x_loc, jhp.shard_features(x, jsh))
    np.testing.assert_array_equal(hp.unshard_features(x_loc, sh, n), x)


@pytest.mark.parametrize("n_parts", [2, 4])
def test_owner_constrained_hierarchy_matches_jax(vgraph, n_parts):
    """pool/hierarchy.build_hierarchy(owner=): clusters, owner_out and edges
    bit-equal to JAX's; every cluster within one part."""
    ei, w, n, x = vgraph
    owner = hp.partition_nodes(ei, n, n_parts, seed=3)
    specs = hierarchy.build_hierarchy(ei, w, x, n, owner=owner)
    assert_same(specs, jhier.build_hierarchy(ei, w, x, n, owner=owner))
    own = owner
    for spec in specs:
        for cl in spec.step_clusters:
            first = np.full(int(cl.max()) + 1, -1)
            first[cl] = own
            assert (first[cl] == own).all()  # members of a cluster share an owner
            own = first
        np.testing.assert_array_equal(spec.owner_out, own)


def mixed_band_pair():
    """A mesh pair whose 8 parts band the vertex level at tile 128 and need
    tile 256 on the facet level (per-part bandwidths 79 and 154): with
    ops.banded.MAX_BAND_TILE at 128 the vertex level bands and the facet
    branch stays on tables, as examples/run_1m.py's 1,310,720-face mesh
    does at the gate's 384 (bandwidths 363 and 729)."""
    m_o = jsynth.cylinder(80, 24)
    return jsynth.add_noise(m_o, 0.2, seed=0), m_o


@pytest.fixture
def band_gate_128(monkeypatch):
    """Both packages' banded-tile gate (ops/banded.MAX_BAND_TILE) at 128."""
    from geobignn_tpu.ops import banded as jbanded
    from geobignn_tpu_torch.ops import banded as tbanded

    monkeypatch.setattr(jbanded, "MAX_BAND_TILE", 128)
    monkeypatch.setattr(tbanded, "MAX_BAND_TILE", 128)


@pytest.mark.parametrize("n_parts,banded", [
    (2, False), (2, True), (4, False), (4, True), (8, False), (8, True), (8, "mixed")],
    ids=["2-table", "2-banded", "4-table", "4-banded", "8-table", "8-banded", "8-mixed"])
def test_halo_train_sample_matches_jax(n_parts, banded, request):
    """build_halo_train_sample: the HaloDual (both HaloBranches, the corner
    gather's halo and reverse tables), the static schedule, the messages and
    every part's tensors equal to the JAX sample's slices.  8 parts take
    examples/run_1m.py's call (BuildConfig(granularity=256, reorder=False),
    seed 0) on icosphere(4); "mixed" on mixed_band_pair() with the tile
    gate at 128 in both packages: the vertex level banded, the facet branch
    on tables."""
    if n_parts == 8:
        m_n, m_o = (mixed_band_pair() if banded == "mixed" else
                    (jsynth.add_noise(jsynth.icosphere(4), 0.2, seed=0), jsynth.icosphere(4)))
        kw, seed = dict(granularity=256, reorder=False), 0
    else:
        m_o = jsynth.icosphere(2)
        m_n, kw, seed = jsynth.add_noise(m_o, 0.2, seed=1), dict(granularity=16), 1
    if banded == "mixed":
        request.getfixturevalue("band_gate_128")
    s = ht.build_halo_train_sample(m_n, m_o, BuildConfig(**kw), n_parts, seed=seed,
                                   banded=bool(banded))
    js = jht.build_halo_train_sample(m_n, m_o, JBuildConfig(**kw), n_parts, seed=seed,
                                     banded=bool(banded))
    assert_same(s.structure, js.structure)
    assert s.static == js.static
    assert (s.structure.v.band0 is not None) == bool(banded)
    assert (s.structure.f.band0 is not None) == (banded is True)
    assert s.meta["messages"] == js.meta["messages"]
    assert (s.n_v, s.n_f) == (js.n_v, js.n_f)
    for p, part in enumerate(s.arrays):
        assert_same(part, jax.tree.map(lambda a: np.asarray(a)[p], js.arrays), f"part{p}")
        assert part["d"]["v"]["send0"].dtype == torch.int64
    if banded:  # the kernel's operands: an int8 (B, T, 3T) band over n_loc rows
        m = s.arrays[0]["d"]["v"]["band0"]["m"]
        assert m.dtype == torch.int8 and m.shape[0] * m.shape[1] == s.structure.v.levels[0].n_loc


def test_comm_report_bytes_match_jax():
    """halo_comm_report's bytes and rounds equal JAX's (host facts); the
    time model is the port's own (no default step time)."""
    m_o = jsynth.icosphere(3)
    m_n = jsynth.add_noise(m_o, 0.2, seed=0)
    s = ht.build_halo_train_sample(m_n, m_o, BuildConfig(), 4)
    js = jht.build_halo_train_sample(m_n, m_o, JBuildConfig(), 4)
    rep = accounting.halo_comm_report(s.structure, step_ms_single_chip=5.0)
    jrep = jacc.halo_comm_report(js.structure, step_ms_single_chip=5.0)
    for k in ("n_parts", "per_conv", "step_payload_mb", "step_real_mb", "step_dense_mb",
              "padding_overhead", "n_rounds_step", "t_latency_ms"):
        assert rep[k] == jrep[k], k
    assert len(rep["per_conv"]) == 17 and rep["ici_gbps"] == accounting.DEFAULT_LINK_GBPS
    assert rep["step_real_mb"] <= rep["step_payload_mb"] <= rep["step_dense_mb"]
    with pytest.raises(TypeError):
        accounting.halo_comm_report(s.structure)  # the step time is required


def test_make_mesh_grid():
    """make_mesh: a (dp, gp) grid, row-major; a device may repeat; fewer
    devices than dcn * dp * gp raise; dcn > 1 adds a leading grid axis
    (tests/test_torch_dcn.py holds its layout against JAX's)."""
    grid = api.make_mesh(2, 2, ["cpu"] * 4)
    assert [[d.type for d in row] for row in grid] == [["cpu"] * 2] * 2
    with pytest.raises(ValueError, match="need 4 devices, have 3"):
        api.make_mesh(2, 2, ["cpu"] * 3)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="need 2 devices, have 0"):
            api.make_mesh(1, 2)
    assert api.make_mesh(1, 1, ["cpu"] * 2, dcn=2) == [[[torch.device("cpu")]]] * 2
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        api.make_mesh(1, 1, ["cpu"], dcn=2)


# --------------------------------------------------------------------------
# device half
# --------------------------------------------------------------------------

def _shard_run(fn, n_parts, *stacked):
    """fn over each device's slice of the stacked operands under shard_map
    on the virtual CPU devices; returns the stacked (P, ...) result."""
    mesh = jmake_mesh(1, n_parts)
    specs = tuple(jax.tree.map(lambda _: P("gp"), a) for a in stacked)

    def body(*a):
        return fn(*jax.tree.map(lambda t: t[0], a))[None]

    out = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=specs, out_specs=P("gp"),
                                check_vma=False))(*jax.tree.map(jnp.asarray, stacked))
    return np.asarray(out)


def _parts(tree, n_parts):
    return [hm.part_tensors(tree, p, CPU) for p in range(n_parts)]


def test_halo_exchange_matches_jax(vgraph):
    """The exchange (round-major sends, one copy per pair, zeros where a part
    is no destination) and its backward through the reverse send table."""
    ei, w, n, x = vgraph
    n_parts = 4
    sh = hp.build_halo_sharding(ei, w, n, hp.partition_nodes(ei, n, n_parts))
    tabs = hp.halo_tables(sh)
    x_loc = hp.shard_features(x, sh)
    want = _shard_run(lambda xl, s: jhp.halo_exchange(xl, s, "gp", sh.rounds), n_parts,
                      x_loc, sh.send_idx)
    xs = [torch.from_numpy(x_loc[p]).requires_grad_() for p in range(n_parts)]
    sends = [t["send"] for t in _parts({"send": sh.send_idx}, n_parts)]
    rs = [t["rs"] for t in _parts({"rs": tabs["rev_send"]}, n_parts)]
    got = hp.halo_exchange(xs, sends, sh.rounds, rs)
    np.testing.assert_array_equal(np.stack([g.detach().numpy() for g in got]), want)
    # the cotangent of each halo row of part 1 goes back to its sender's slot
    got[1].sum().backward()
    counts = np.zeros((n_parts, sh.n_loc))
    off = 0
    for perm, h_c in sh.rounds:
        for src, dst in perm:
            if dst == 1:
                np.add.at(counts[src], sh.send_idx[src, off : off + h_c], 1.0)
        off += h_c
    counts[:, sh.n_loc - 1] = 0.0  # the send gather gives the trash slot none
    counts[1] += 1.0  # part 1's own rows
    for p in range(n_parts):
        got_g = xs[p].grad.numpy() if xs[p].grad is not None else np.zeros(x_loc[p].shape)
        np.testing.assert_array_equal(got_g, np.repeat(counts[p][:, None], 6, axis=1))


def _conv_params(c_in, c_out, seed):
    rng = np.random.default_rng(seed)
    u = (rng.normal(size=(c_in, 9)) * 0.3).astype(np.float32)
    c = (rng.normal(size=9) * 0.3).astype(np.float32)
    w = (rng.normal(size=(9, c_in, c_out)) / np.sqrt(c_in)).astype(np.float32)
    b = (rng.normal(size=c_out) * 0.1).astype(np.float32)
    return dict(u=u, c=c, w=w, b=b)


@pytest.mark.parametrize("mode", ["coo", "table", "banded"])
def test_halo_convs_match_jax(vgraph, mode):
    """halo_feast_conv, halo_feast_conv_table and halo_feast_conv_banded
    (float32 aggregate) against the JAX functions: 1e-5 of max|out|."""
    ei, w, n, x = vgraph
    n_parts = 4
    owner = hp.partition_nodes(ei, n, n_parts)
    if mode == "banded":
        pri, bw = hp.partition_rcm_priority(ei, n, owner)
        tile = 128
        assert bw <= tile
        sh = hp.build_halo_sharding(ei, w, n, owner, priority=pri, n_granularity=tile)
        aux = hp.halo_band_arrays(sh, tile)
    else:
        sh = hp.build_halo_sharding(ei, w, n, owner)
        aux = hp.halo_tables(sh) if mode == "table" else {"ei": sh.edge_index}
    prm = _conv_params(6, 16, 1)
    jp = FeastParams(**{k: jnp.asarray(v) for k, v in prm.items()})
    rounds = sh.rounds

    def jfn(xl, a, deg, send, mask):
        if mode == "coo":
            return jhp.halo_feast_conv(jp, xl, a["ei"], deg, send, "gp", rounds, mask)
        if mode == "table":
            return jhp.halo_feast_conv_table(jp, xl, a, deg, send, "gp", rounds, mask)
        return jhp.halo_feast_conv_banded(jp, xl, a, deg, send, "gp", rounds, mask,
                                          compute_dtype=jnp.float32)

    x_loc = hp.shard_features(x, sh)
    want = _shard_run(jfn, n_parts, x_loc, aux, sh.deg, sh.send_idx, sh.node_mask)
    parts = _parts(dict(x=x_loc, a=aux, deg=sh.deg, send=sh.send_idx, mask=sh.node_mask),
                   n_parts)
    tp = [{k: torch.from_numpy(v) for k, v in prm.items()}] * n_parts
    args = ([q["x"] for q in parts], [q["a"] for q in parts], [q["deg"] for q in parts],
            [q["send"] for q in parts], rounds, [q["mask"] for q in parts])
    if mode == "coo":
        got = hp.halo_feast_conv(tp, args[0], [a["ei"] for a in args[1]], *args[2:])
    elif mode == "table":
        got = hp.halo_feast_conv_table(tp, *args)
    else:
        got = hp.halo_feast_conv_banded(tp, *args, compute_dtype=torch.float32)
    got = np.stack([g.numpy() for g in got])
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    # and the unsharded conv of the whole graph
    from geobignn_tpu_torch.ops.feastconv import feast_conv

    ref = feast_conv({k: torch.from_numpy(v) for k, v in prm.items()},
                     torch.from_numpy(np.concatenate([x, np.zeros((1, 6), np.float32)])),
                     torch.from_numpy(ei.astype(np.int64))).numpy()[:n]
    np.testing.assert_allclose(hp.unshard_features(got, sh, n), ref,
                               atol=1e-5 * np.abs(ref).max())
