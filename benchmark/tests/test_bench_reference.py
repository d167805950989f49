"""The plain reference agrees with the port on tiny meshes on the CPU."""

import copy

import numpy as np
import pytest
import torch

from reference import host, judge, model as ref_model
from yardstick import cells, meshes, session, weights

BC = dict(edge_weight_type=10, wei_param=2.0, preprocess_seed=0, pool_step=2, n_levels=2)
SHAPES = [("icosphere", {"subdivisions": 2}), ("torus", {"n_major": 16, "n_minor": 10}),
          ("cube", {"n": 5}), ("cylinder", {"n_seg": 12, "n_height": 6})]


def _pair(make, args, seed=3):
    clean = meshes.SHAPES[make](**args)
    return meshes.add_noise(clean, 0.2, seed), clean


@pytest.mark.parametrize("edge_weight_type", [10, 4])
@pytest.mark.parametrize("reorder", [False, True])
@pytest.mark.parametrize("make, args", SHAPES)
def test_host_build_equals_the_port(make, args, reorder, edge_weight_type):
    """Type 4 is learned: on the host, the port and the plain build both
    take the stored weight."""
    from geobignn_tpu_torch.config import Config

    noisy, clean = _pair(make, args)
    cfg = Config(reorder=reorder, sub_size=10 ** 6, edge_weight_type=edge_weight_type)
    entry = session._program_entry((noisy.points, noisy.fv_indices, clean.points,
                                    clean.fv_indices, cfg.sub_size,
                                    session.build_config_fields(cfg)))[0]
    hs = host.build(noisy, clean, dict(BC, reorder=reorder, edge_weight_type=edge_weight_type))
    assert judge.host_mismatch(session.program_structures(entry),
                               judge.reference_structures(hs)) == (0, [])


def test_splitmix_permutation_is_a_permutation():
    p = host.splitmix_permutation(1000, 12345)
    assert sorted(p.tolist()) == list(range(1000))
    assert p.tolist() != list(range(1000))


def test_forward_equals_the_port_in_float32():
    """The port's table convs and float32 heads (Config(reorder=False,
    fc_precision="float32")) against the reference, 1e-4 of the largest
    output: float32 sums in another order."""
    from geobignn_tpu_torch.config import Config
    from geobignn_tpu_torch.data.dataset import InMemoryDataset
    from geobignn_tpu_torch.meshio import TriMesh
    from geobignn_tpu_torch.models.dual_gnn import DualGNN

    torch.manual_seed(0)
    noisy, clean = _pair("icosphere", {"subdivisions": 2})
    cfg = Config(reorder=False, fc_precision="float32", granularity=8)
    ds = InMemoryDataset([(TriMesh(noisy.points, noisy.fv_indices),
                           TriMesh(clean.points, clean.fv_indices))], cfg.build_config())
    widths = cells.read_json(cells.BENCH_DIR + "/configs/geobi_patch.json")["widths"]
    w0 = weights.make(ref_model.param_shapes(widths), 77, "cpu")
    net = DualGNN(device="cpu", fc_dtype=None)
    net.load_state_dict(w0, strict=True)
    with torch.no_grad():
        vert, nrm = net(ds.get(0).to("cpu"))
        hs = host.build(noisy, clean, dict(BC, reorder=False))
        rv, rn = ref_model.forward(w0, ref_model.Sample(hs, "cpu"), widths)[:2]
    nv, nf = noisy.n_vertices, noisy.n_faces
    assert torch.allclose(vert[:nv], rv, atol=1e-4 * float(rv.abs().max()))
    assert torch.allclose(nrm[:nf], rn, atol=1e-4)


@pytest.mark.parametrize("make, args", SHAPES[:2])
def test_forward_equals_the_port_at_the_configured_precision(make, args):
    """The port as geobi_patch configures it (RCM bands, bf16 aggregate
    operands and heads) against the reference at the same precision: the
    same roundings at the same places, so the CPU's plain aggregates agree to
    float32 sums in another order, while the port's bf16-activation path
    (the control) lies far off."""
    from geobignn_tpu_torch.config import Config
    from geobignn_tpu_torch.data.dataset import InMemoryDataset
    from geobignn_tpu_torch.meshio import TriMesh
    from geobignn_tpu_torch.models.dual_gnn import DualGNN

    torch.manual_seed(0)
    noisy, clean = _pair(make, args)
    conf = cells.read_json(cells.BENCH_DIR + "/configs/geobi_patch.json")
    cfg = Config(**dict(conf["config"], granularity=8))
    ds = InMemoryDataset([(TriMesh(noisy.points, noisy.fv_indices),
                           TriMesh(clean.points, clean.fv_indices))], cfg.build_config())
    sample = ds.get(0).to("cpu")
    assert {session.route(lv) for lv in sample.v.levels + sample.f.levels} == {"banded"}
    w0 = weights.make(ref_model.param_shapes(conf["widths"]), 78, "cpu")
    hs = host.build(noisy, clean, dict(BC, reorder=True))
    with torch.no_grad():
        rv, rn = ref_model.forward(w0, ref_model.Sample(hs, "cpu"), conf["widths"],
                                   prec=ref_model.precision_of(conf))[:2]
        gaps = []
        for dt in (torch.float32, torch.bfloat16):
            net = DualGNN(device="cpu", fc_dtype=torch.bfloat16, compute_dtype=dt)
            net.load_state_dict(w0, strict=True)
            vert, nrm = net(sample)
            gaps.append(max(float((vert[: rv.shape[0]] - rv).abs().max() / rv.abs().max()),
                            float((nrm[: rn.shape[0]] - rn).abs().max())))
    assert gaps[0] <= 1e-5, gaps
    assert gaps[1] >= 100 * max(gaps[0], 1e-7), gaps


def _tiny_cell(mode, limits):
    conf = cells.read_json(cells.BENCH_DIR + "/configs/geobi_patch.json")
    conf = copy.deepcopy(conf)
    conf["config"]["granularity"] = 8
    traffic = cells.read_json(cells.BENCH_DIR + f"/tests/data/tiny_{mode}.json")
    return cells.Cell("tiny", 1, conf, traffic, limits, [], [])


@pytest.mark.parametrize("mode, limits", [
    # tiny meshes: the bf16 aggregate operands and heads move the worst
    # small-gradient leaf by a few percent (0.03-0.16 read on seeds 1-3)
    ("train", {"host_mismatch": 0, "loss_gap": 2e-2, "grad_gap": 0.3, "change_gap": 0.5,
               "pos_gap": 0.025, "normal_gap": 0.04}),
    ("eval", {"host_mismatch": 0, "eval_gap": 5e-3, "pos_gap": 0.025, "normal_gap": 0.04}),
])
def test_a_run_on_the_cpu_is_correct(mode, limits):
    torch.manual_seed(0)
    res = session.run(_tiny_cell(mode, limits), 2 ** 31 + 11, 0.0, True, "cpu", workers=1,
                      log=lambda *a, **k: None)
    assert res["correct"], res["checks"]
    assert res["numbers"]["host_mismatch"] == 0
    assert res["counters"]["passes"] >= 1 and res["trace"] is not None
    assert np.isfinite(res["counters"]["useful_flops"])
