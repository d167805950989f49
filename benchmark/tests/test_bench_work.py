"""The frozen work counts equal the port's train/roofline on small samples."""

import numpy as np
import pytest
import torch

from yardstick import meshes, session, work

WIDTHS = {"heads": 9, "in_v": 6, "in_f": 12, "fc_hidden": 1024,
          "convs": [["l_conv1", 0, None, 32], ["l_conv2", 1, 32, 64], ["l_conv3", 2, 64, 128],
                    ["l_conv4", 2, 128, 128], ["r_conv1", 1, 128, 64], ["r_conv2", 1, 128, 64],
                    ["r_conv3", 0, 64, 32], ["r_conv4", 0, 64, 32]]}


def _sample(reorder: bool):
    from geobignn_tpu_torch.data.builder import BuildConfig
    from geobignn_tpu_torch.data.dataset import InMemoryDataset
    from geobignn_tpu_torch.meshio import TriMesh

    clean = meshes.icosphere(3)
    noisy = meshes.add_noise(clean, 0.2, 5)
    ds = InMemoryDataset([(TriMesh(noisy.points, noisy.fv_indices),
                           TriMesh(clean.points, clean.fv_indices))],
                         BuildConfig(reorder=reorder, granularity=8))
    return ds.entries[0], ds.get(0).to("cpu")


@pytest.mark.parametrize("reorder", [False, True])
def test_useful_flops_equal_roofline(reorder):
    from geobignn_tpu_torch.train import roofline

    entry, sample = _sample(reorder)
    sv, sf = session.level_sizes(entry[0]), session.level_sizes(entry[1])
    fwd = roofline.dual_gnn_flops(sample)["fwd_useful"]
    assert work.step_useful_flops(sv, sf, WIDTHS, train=False) == fwd
    assert work.step_useful_flops(sv, sf, WIDTHS, train=True) == 3 * fwd


@pytest.mark.parametrize("c_in, c_out", [(6, 32), (64, 32), (128, 128), (32, 64)])
@pytest.mark.parametrize("blocks", [False, True])
def test_aggregate_work_equals_roofline(c_in, c_out, blocks):
    from geobignn_tpu_torch.train import roofline

    g = torch.Generator().manual_seed(c_in * 7 + c_out)
    n_blk, tile, heads = 6, 16, 9
    n = n_blk * tile
    r, p = torch.rand(n, heads, generator=g), torch.rand(n, heads, generator=g)
    x, w = torch.rand(n, c_in, generator=g), torch.rand(heads, c_in, c_out, generator=g)
    m = (torch.rand(n_blk, tile, 3 * tile, generator=g) < 0.1).to(torch.int8)
    blk = torch.zeros(n_blk, 3, dtype=torch.int32) if blocks else None
    tf = work.transform_first(c_in, c_out)
    idx = m.numel() + (blk.numel() * blk.element_size() if blocks else 0)
    nnz = int(m.count_nonzero())
    b, o, _ = roofline.aggregate_work(r, p, x, w, m, tf, blk)
    assert work.aggregate_work(n, c_in, c_out, heads, nnz, tf, idx) == (b, o)
    b, o, _ = roofline.aggregate_work_bwd(r, p, x, w, m, tf, blk)
    assert work.aggregate_work_bwd(n, c_in, c_out, heads, nnz, tf, idx, partials=n_blk) == (b, o)


def test_bound_takes_the_larger_time():
    assert work.bound_s(3.35e12, 1.0) == pytest.approx(1.0)
    assert work.bound_s(1.0, 989e12) == pytest.approx(1.0)
    assert np.isclose(work.bound_s(0, 0), 0.0)
