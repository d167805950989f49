"""The port's checkpoint file against the JAX package's, both ways, and its
msgpack codec against the msgpack package.

Everything here is bit-exact: a checkpoint is a container, so the same
weights come back with the same bits from either package, and the codec's
bytes equal msgpack's own on the subset it covers.
"""

from __future__ import annotations

import pickle
import struct
import tempfile

import jax
import msgpack
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from hypothesis.configuration import set_hypothesis_home_dir

from geobignn_tpu.config import Config as JConfig
from geobignn_tpu.train import checkpoint as jckpt
from geobignn_tpu.train import optim as joptim
from geobignn_tpu_torch import params as tparams
from geobignn_tpu_torch.config import Config
from geobignn_tpu_torch.models.dual_gnn import DualGNN
from geobignn_tpu_torch.train import checkpoint as ckpt
from geobignn_tpu_torch.train import optim


# hypothesis keeps its example database and caches out of the checkout
set_hypothesis_home_dir(tempfile.mkdtemp(prefix="hypothesis_"))


@pytest.fixture(scope="module")
def state():
    return DualGNN(device="cpu", seed=3).state_dict()


def _assert_tree_bit_equal(got, want):
    got_l, got_s = jax.tree.flatten(got)
    want_l, want_s = jax.tree.flatten(want)
    assert got_s == want_s
    for a, b in zip(got_l, want_l):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def _assert_state_bit_equal(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert got[k].numpy().tobytes() == v.numpy().tobytes(), k


def test_jax_checkpoint_is_read_by_the_port(tmp_path, state):
    """geobignn_tpu save_checkpoint (with an optax state) -> the port's
    load_checkpoint: every parameter bit-equal, the scalars equal."""
    tree = tparams.to_jax_params(state)
    opt_state = joptim.make_optimizer(JConfig()).init(tree)
    path = str(tmp_path / "jax.pkl")
    jckpt.save_checkpoint(path, tree, opt_state, epoch=7, best_error=1.25,
                          plateau=dict(lr=1e-3, best=2.0, bad_epochs=1))
    got, opt, scalars = ckpt.load_checkpoint(path)
    _assert_state_bit_equal(got, state)
    assert opt is None
    assert scalars == dict(epoch=7, best_error=1.25,
                           plateau=dict(lr=1e-3, best=2.0, bad_epochs=1))


def test_port_checkpoint_is_read_by_jax(tmp_path, state):
    """The port's save_checkpoint -> geobignn_tpu load_checkpoint, with and
    without a template: the same tree, bit-equal; and the params blob is
    byte for byte the one flax writes for these weights."""
    tree = tparams.to_jax_params(state)
    opt = optim.make_optimizer(Config(), [torch.nn.Parameter(v.clone())
                                          for v in state.values()])
    path, jpath = str(tmp_path / "port.pkl"), str(tmp_path / "jax.pkl")
    ckpt.save_checkpoint(path, state, opt.state_dict(), epoch=3, best_error=float("inf"))
    for like in (None, tree):
        got, got_opt, scalars = jckpt.load_checkpoint(path, like)
        _assert_tree_bit_equal(got, tree)
        assert got_opt["writer"] == "geobignn_tpu_torch"
        assert scalars == dict(epoch=3, best_error=float("inf"))

    jckpt.save_checkpoint(jpath, tree)

    def params_blob(p):
        raw = open(p, "rb").read()
        (size,) = struct.unpack("<Q", raw[8:16])
        return raw[16:16 + size]

    assert params_blob(path) == params_blob(jpath)


@pytest.mark.parametrize("plateau", [None, dict(lr=5e-4, factor=0.5, patience=2,
                                                best=0.125, bad_epochs=1,
                                                threshold=1e-4)])
def test_scalars_round_trip(tmp_path, state, plateau):
    path = str(tmp_path / "c.pkl")
    ckpt.save_checkpoint(path, state, epoch=np.int64(4), best_error=np.float32(0.5),
                         plateau=plateau)
    _, _, scalars = ckpt.load_checkpoint(path, with_opt=True)
    assert scalars == dict(epoch=4.0, best_error=0.5, plateau=plateau)
    _, _, jscalars = jckpt.load_checkpoint(path)
    assert jscalars == scalars


def test_optax_state_with_opt_raises(tmp_path, state):
    """An optimizer blob written by optax is neither mapped by guesswork nor
    dropped: with_opt=True raises and names with_opt=False."""
    tree = tparams.to_jax_params(state)
    path = str(tmp_path / "jax.pkl")
    jckpt.save_checkpoint(path, tree, joptim.make_optimizer(JConfig()).init(tree), epoch=0)
    with pytest.raises(ValueError, match="with_opt=False"):
        ckpt.load_checkpoint(path, with_opt=True)
    assert ckpt.load_checkpoint(path, with_opt=False)[1] is None


@pytest.mark.parametrize("name", ["adam", "sgd", "rmsprop"])
def test_optimizer_state_round_trip(tmp_path, name):
    """Three steps, save, load into a fresh optimizer: every state tensor
    (Adam's step count and moments, the SGD trace, RMSprop's nu) bit-equal,
    and the next step gives bit-equal parameters."""
    rng = np.random.default_rng(0)
    init = [rng.normal(size=s).astype(np.float32) for s in ((5, 3), (4,))]
    grads = [[rng.normal(size=p.shape).astype(np.float32) for p in init] for _ in range(4)]
    cfg = Config(optimizer=name, lr=1e-2, weight_decay=1e-3)

    def run(prms, opt, steps):
        for g in steps:
            for p, gi in zip(prms, g):
                p.grad = torch.from_numpy(gi.copy())
            opt.step()

    prms = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in init]
    opt = optim.make_optimizer(cfg, prms)
    run(prms, opt, grads[:3])
    path = str(tmp_path / "o.pkl")
    ckpt.save_checkpoint(path, {f"p.{i}": p.detach() for i, p in enumerate(prms)},
                         opt.state_dict(), epoch=2)
    state, opt_sd, _ = ckpt.load_checkpoint(path, with_opt=True)
    prms2 = [torch.nn.Parameter(state[f"p.{i}"].clone()) for i in range(len(init))]
    opt2 = optim.make_optimizer(cfg, prms2)
    opt2.load_state_dict(opt_sd)
    want = opt.state_dict()["state"]
    got = opt2.state_dict()["state"]
    assert set(got) == set(want)
    for pid in want:
        for k, v in want[pid].items():
            if torch.is_tensor(v):
                assert got[pid][k].numpy().tobytes() == v.numpy().tobytes(), (pid, k)
            else:
                assert got[pid][k] == v
    run(prms, opt, grads[3:])
    run(prms2, opt2, grads[3:])
    for p, q in zip(prms, prms2):
        assert p.detach().numpy().tobytes() == q.detach().numpy().tobytes()
    jckpt.load_checkpoint(path)  # the JAX reader takes the file, blob and all


def test_round_one_pickle_file_is_refused(tmp_path):
    path = str(tmp_path / "old.pkl")
    with open(path, "wb") as f:
        pickle.dump(dict(params={}, opt_state=None, scalars={}), f)
    with pytest.raises(ValueError, match="pickle"):
        ckpt.load_checkpoint(path)


@pytest.mark.parametrize("keep", [10, 20, 0.5, -3])
def test_truncated_file_raises(tmp_path, state, keep):
    path = str(tmp_path / "c.pkl")
    ckpt.save_checkpoint(path, state, epoch=1)
    raw = open(path, "rb").read()
    cut = int(len(raw) * keep) if isinstance(keep, float) else keep
    with open(path, "wb") as f:
        f.write(raw[:cut])
    with pytest.raises(ValueError, match="truncated"):
        ckpt.load_checkpoint(path)


# --------------------------------------------------------------------------
# the codec against msgpack
# --------------------------------------------------------------------------

_leaves = (st.none() | st.booleans() | st.integers(-(2 ** 63), 2 ** 64 - 1)
           | st.floats(allow_nan=False) | st.text(max_size=40) | st.binary(max_size=40))
_trees = st.recursive(
    _leaves,
    lambda kids: st.lists(kids, max_size=5) | st.dictionaries(st.text(max_size=8), kids,
                                                              max_size=5),
    max_leaves=25)


@settings(max_examples=150, deadline=None)
@given(_trees)
def test_codec_matches_msgpack_on_random_trees(tree):
    theirs = msgpack.packb(tree, use_bin_type=True)
    assert ckpt.packb(tree) == theirs
    assert ckpt.unpackb(theirs) == tree


@pytest.mark.parametrize("value", [
    0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32, 2 ** 64 - 1,
    -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31, -2 ** 31 - 1, -2 ** 63,
    "x" * 31, "x" * 32, "x" * 255, "x" * 256, "é" * 40000, "x" * 70000,
    b"", b"y" * 255, b"y" * 256, b"y" * 70000,
    list(range(15)), list(range(16)), list(range(70000)),
    {str(i): i for i in range(15)}, {str(i): i for i in range(16)},
    {str(i): None for i in range(70000)}, 1.5, float("inf"), [True, False, None],
], ids=lambda v: f"{type(v).__name__}{len(v) if hasattr(v, '__len__') else v}")
def test_codec_matches_msgpack_at_format_boundaries(value):
    theirs = msgpack.packb(value, use_bin_type=True)
    assert ckpt.packb(value) == theirs
    assert ckpt.unpackb(theirs) == value


def test_codec_arrays_and_numpy_scalars_match_flax():
    from flax import serialization

    rng = np.random.default_rng(1)
    tree = {"a": {"w": rng.normal(size=(3, 4)).astype(np.float32),
                  "i": np.arange(5, dtype=np.int64), "e": np.zeros((0, 2), np.float32),
                  "s": np.float32(2.5), "k": np.int32(-7), "d": np.float64(1e-300)},
            "z": np.asarray(3, np.int8), "n": 4, "t": "label"}
    theirs = serialization.msgpack_serialize(tree)  # walks dicts in key order
    assert ckpt.packb(ckpt._sorted_tree(tree)) == theirs
    back = ckpt.unpackb(theirs)
    _assert_tree_bit_equal(back, serialization.msgpack_restore(theirs))
    assert isinstance(back["a"]["s"], np.float32) and back["z"].shape == ()
    assert ckpt.unpackb(struct.pack(">Bf", 0xCA, 0.5)) == 0.5  # float32 is read


def test_codec_refuses_what_it_does_not_cover():
    with pytest.raises(ValueError, match="complex"):
        ckpt.unpackb(msgpack.packb(msgpack.ExtType(2, msgpack.packb((1.0, 2.0)))))
    with pytest.raises(ValueError, match="ext type 9"):
        ckpt.unpackb(msgpack.packb(msgpack.ExtType(9, b"abcd")))
    with pytest.raises(ValueError, match="chunked"):
        ckpt.unpackb(msgpack.packb({"__msgpack_chunked_array__": True, "shape": {},
                                    "chunks": {}}))
    with pytest.raises(ValueError, match="str keys"):
        ckpt.unpackb(msgpack.packb({1: 2}, use_bin_type=True))
    with pytest.raises(ValueError, match="truncated"):
        ckpt.unpackb(msgpack.packb([1, 2, "abc"])[:-1])
    with pytest.raises(ValueError, match="left after"):
        ckpt.unpackb(msgpack.packb(1) + b"\x00")
    for bad in (1j, {1: 2}, object(), np.zeros(2, dtype=object)):
        with pytest.raises(TypeError):
            ckpt.packb(bad)
    with pytest.raises(OverflowError):
        ckpt.packb(2 ** 64)
