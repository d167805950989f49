"""The host side of the CUDA graphs of the step and the forward
(geobignn_tpu_torch/capture.py, train/optim.py, train/trainer.py).

On the CPU: the signature a graph is keyed on (equal for the patches of one
plan, different for another plan), the static copies, the one switch to
the eager path (`testing.eager_steps`), which the CPU never leaves; the
multi-device trees (a halo sample's per-part dicts) and the routing of a
multi-device program to one graph or to the eager path (`one_card`); and
the learning rate held as a tensor, as Adam holds it on the card, which
`set_lr` writes in place and a checkpoint round trip keeps.  The graphs
themselves run in tests/test_torch_cuda.py, on the card.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from geobignn_tpu import native as jnative
from geobignn_tpu_torch import capture, testing
from geobignn_tpu_torch.config import Config
from geobignn_tpu_torch.data import dataset, synth
from geobignn_tpu_torch.train import checkpoint as ckpt
from geobignn_tpu_torch.train import optim
from geobignn_tpu_torch.train.trainer import Trainer

testing.share_cores()  # torch's CPU threads: this test worker's share of the cores


@pytest.fixture(scope="module", autouse=True)
def _reference_native():
    """The JAX package's native path as this machine supports it: its
    loader may have read a library another process was still writing."""
    testing.match_reference_native(jnative)


def _dataset(sub_size):
    clean = synth.icosphere(2)
    return dataset.InMemoryDataset(
        [(synth.add_noise(clean, 0.2, seed=s), clean) for s in (0, 1)],
        Config().build_config(), submesh_size=sub_size)


def test_signature_and_static_copy():
    ds = _dataset(200)
    a, b = (ds.get(i, ds.plan).to("cpu") for i in (0, 1))
    assert len(ds) > 2
    assert capture.signature((a,)) == capture.signature((b,))
    other = _dataset(100000)
    c = other.get(0, other.plan).to("cpu")
    assert capture.signature((a,)) != capture.signature((c,))
    copy = capture.static_copy((a, None))
    pairs = list(zip(capture.tensors(copy), capture.tensors((a, None))))
    assert len(pairs) > 50 and copy[1] is None
    assert all(x.data_ptr() != y.data_ptr() and torch.equal(x, y) for x, y in pairs)


def test_per_part_dicts_are_trees():
    """A halo sample's arrays, a list of per-part dicts: tensors in key
    order, a signature keyed on the keys, shapes and devices, and a mapped
    copy of the same structure."""
    from geobignn_tpu_torch.parallel import halo_train as ht

    clean = synth.icosphere(2)
    sample = ht.build_halo_train_sample(synth.add_noise(clean, 0.2, seed=0), clean,
                                        Config().build_config(), 2, granularity=16)
    arrays = sample.arrays
    flat = capture.tensors(arrays)
    assert len(flat) > 40 and flat[0] is capture.tensors(arrays[0]["d"])[0]
    assert flat[len(capture.tensors(arrays[0])) - 1] is arrays[0]["yv"]  # "yv" sorts last
    shuffled = [dict(reversed(list(a.items()))) for a in arrays]  # key order, not insertion
    assert [t.data_ptr() for t in capture.tensors(shuffled)] == [t.data_ptr() for t in flat]
    assert capture.signature(shuffled) == capture.signature(arrays)
    assert capture.signature(arrays) != capture.signature(arrays[:1])
    fewer = [dict(a) for a in arrays]
    del fewer[0]["mv"]
    assert capture.signature(fewer) != capture.signature(arrays)
    moved = capture.signature([{k: v for k, v in a.items()} for a in sample.to(
        [torch.device("meta")] * 2).arrays])
    assert moved != capture.signature(arrays)  # a plan on other devices captures anew
    copy = capture.static_copy(arrays)
    assert isinstance(copy, list) and set(copy[1]) == set(arrays[1])
    assert all(x.data_ptr() != y.data_ptr() and torch.equal(x, y)
               for x, y in zip(capture.tensors(copy), flat))


def test_one_card_routes_multi_device_programs():
    """One graph only where every part or grid entry names the same CUDA
    device in a lone process and eager_steps() is not open; the CPU, two
    cards, or a mixed list run eagerly."""
    card = torch.device("cuda", 0)
    assert capture.one_card([card] * 4) and capture.one_card(["cuda:0", "cuda:0"])
    assert capture.one_card([card])
    assert not capture.one_card([card, torch.device("cuda", 1)])
    assert not capture.one_card(["cpu"] * 2) and not capture.one_card([card, "cpu"])
    with testing.eager_steps():
        assert not capture.one_card([card] * 2)
    model = torch.nn.Linear(2, 2)
    assert not capture.capturable(torch.optim.SGD(model.parameters(), lr=0.1))
    assert not capture.capturable(torch.optim.Adam(model.parameters()))
    assert capture.capturable(torch.optim.Adam(model.parameters(), capturable=True))


def test_eager_switch_and_the_cpu_stays_eager():
    ds = _dataset(200)
    tr = Trainer(Config(seed=0, max_epoch=1), ds, None, device="cpu")
    assert not capture.EAGER and not tr.one_dispatch()
    with testing.eager_steps():
        assert capture.EAGER
    assert not capture.EAGER


def test_lr_tensor_is_written_in_place_and_survives_a_checkpoint():
    prm = [torch.nn.Parameter(torch.ones(3))]
    lr = torch.tensor(1e-3, dtype=torch.float32)
    opt = torch.optim.Adam(prm, lr=lr, foreach=False)
    optim.set_lr(opt, 5e-3)
    assert opt.param_groups[0]["lr"] is lr and float(lr) == np.float32(5e-3)
    prm[0].grad = torch.ones(3)
    opt.step()
    saved = ckpt._opt_from_tree(ckpt.unpackb(ckpt.packb(ckpt._opt_to_tree(opt.state_dict()))))
    optim.set_lr(opt, 1.0)
    optim.load_state(opt, saved)
    assert opt.param_groups[0]["lr"] is lr and optim.get_lr(opt) == float(np.float32(5e-3))
    plain = torch.optim.Adam([torch.nn.Parameter(torch.ones(3))], lr=1e-3)
    optim.set_lr(plain, 2e-3)
    assert plain.param_groups[0]["lr"] == 2e-3
