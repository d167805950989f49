"""Run directories of the port on the CPU: the preprocessing cache against
the JAX package's, a JAX run directory served by the port, version-pinned
inference, and resuming a run.

Inputs are tiny (icosphere(2), 320 faces, granularity 16) and seeded.  The
JAX Predictor runs its Pallas kernels in interpret mode, as its own tests
do; one compile is shared by the module fixture.  Tolerances are stated at
each comparison; containers (caches, checkpoints, a resumed trajectory on
one machine) are compared bit for bit.
"""

from __future__ import annotations

import inspect
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geobignn_tpu import meshio as jmeshio
from geobignn_tpu.config import Config as JConfig
from geobignn_tpu.data import builder as jbuilder
from geobignn_tpu.data import dataset as jdataset
from geobignn_tpu.infer import predict as jpredict
from geobignn_tpu.models import DualGNN as JDualGNN
from geobignn_tpu.train import checkpoint as jckpt
from geobignn_tpu_torch import geometry, meshio
from geobignn_tpu_torch.config import Config
from geobignn_tpu_torch.data import builder, dataset, synth
from geobignn_tpu_torch.infer import predict
from geobignn_tpu_torch.ops import banded_cuda
from geobignn_tpu_torch.train import checkpoint as ckpt
from geobignn_tpu_torch.train import trainer as ttrainer
from geobignn_tpu_torch.train.trainer import Trainer, train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(granularity=16, sub_size=10 ** 6, augment=False)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread for this module.  torch's CPU kernels split sums
    over threads by load, so two runs of the same training differ in the
    last bits unless one thread does them (the resume test compares bit for
    bit); and these tiny trainings run many times slower when several test
    processes' thread pools compete for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _corpus(root, train_names=("a",), test_names=("s",), draws=(1,)):
    """Reference-layout corpus of noisy icosphere(2) meshes."""
    for split, names in (("train", train_names), ("test", test_names)):
        nd = os.path.join(root, "Synthetic", split, "noisy")
        od = os.path.join(root, "Synthetic", split, "original")
        os.makedirs(nd), os.makedirs(od)
        for i, name in enumerate(names):
            m_o = synth.icosphere(2)
            meshio.write_obj(os.path.join(od, f"{name}.obj"), m_o.points, m_o.fv_indices)
            for k in draws:
                m_n = synth.add_noise(m_o, 0.15, seed=10 * i + k + (split == "test"))
                meshio.write_obj(os.path.join(nd, f"{name}_n{k}.obj"),
                                 m_n.points, m_n.fv_indices)
        with open(os.path.join(root, "Synthetic", f"{split}_list.txt"), "w") as f:
            f.write("\n".join(names) + "\n")
    return root


def _entries_bit_equal(got, want):
    """Two raw samples (bv, bf, meta, V_idx, F_idx): every array bit-equal."""
    def arrays(entry):
        bv, bf, meta, v_idx, f_idx = entry
        out = {}
        for tag, b in (("v", bv), ("f", bf)):
            out |= {f"{tag}.{k}": getattr(b, k) for k in
                    ("x", "y", "edge_index", "edge_weight", "depth_direction")}
            out[f"{tag}.n"] = np.int64(b.n_nodes)
            for i, s in enumerate(b.specs):
                out |= {f"{tag}.s{i}.{k}": getattr(s, k) for k in
                        ("unpool", "edge_index", "edge_weight")}
                out |= {f"{tag}.s{i}.c{j}": c for j, c in enumerate(s.step_clusters)}
                out[f"{tag}.s{i}.sizes"] = np.asarray(s.step_sizes)
                out[f"{tag}.s{i}.n_out"] = np.int64(s.n_out)
        out |= {f"meta.{k}": np.asarray(v) for k, v in meta.items()}
        out["meta.scale"] = np.float32(meta["scale"])  # the file keeps float32
        out |= {"V_idx": v_idx, "F_idx": f_idx}
        return out

    a, b = arrays(got), arrays(want)
    assert set(a) == set(b)
    for k in a:
        if a[k] is None or b[k] is None:
            assert a[k] is None and b[k] is None, k
            continue
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, (k, x.dtype, y.dtype)
        assert x.tobytes() == y.tobytes(), k


# --------------------------------------------------------------------------
# the preprocessing cache
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, dict(granularity=16, reorder=False, seed=3),
                                dict(weight_type=0, wei_param=1.5, pool_type="mean",
                                     with_depth=True)], ids=["default", "plain", "depth"])
def test_cache_keys_agree(tmp_path, kw):
    assert dataset._config_key(builder.BuildConfig(**kw)) \
        == jdataset._config_key(jbuilder.BuildConfig(**kw))
    path = str(tmp_path / "f.obj")
    with open(path, "wb") as f:
        f.write(os.urandom(3 << 20))
    assert dataset._file_key(path) == jdataset._file_key(path)
    assert dataset._BUILD_VERSION == jdataset._BUILD_VERSION


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_raw_sample_written_by_one_package_is_read_by_the_other(tmp_path, writer):
    """A multi-patch mesh (V_idx / F_idx present), RCM order (perm_v/perm_f):
    save_raw_sample of one package, load_raw_sample of the other, every
    array bit-equal to the writer's own."""
    mesh = synth.add_noise(synth.icosphere(2), 0.2, seed=4)
    mods = {"port": (dataset, builder), "jax": (jdataset, jbuilder)}
    (w_ds, w_b), (r_ds, _) = mods[writer], mods["jax" if writer == "port" else "port"]
    bc = w_b.BuildConfig(granularity=16, reorder=True)
    entries = w_ds.process_one_mesh(mesh, 200, synth.icosphere(2), bc)
    assert len(entries) >= 2
    for i, entry in enumerate(entries):
        path = str(tmp_path / f"p{i}.npz")
        w_ds.save_raw_sample(path, *entry)
        _entries_bit_equal(r_ds.load_raw_sample(path), entry)
        _entries_bit_equal(w_ds.load_raw_sample(path), entry)


def test_dual_dataset_second_construction_hits_the_cache(tmp_path, monkeypatch):
    """The second DualDataset builds nothing; the JAX DualDataset finds the
    same files (same names) and builds nothing either."""
    root = _corpus(str(tmp_path / "dataset"), train_names=("a", "b"), draws=(1, 2))
    bc = builder.BuildConfig(granularity=16, reorder=True)
    first = dataset.DualDataset(root, "Synthetic", "train", "train_list.txt", 0, 200, bc)
    cache = os.path.join(root, "Synthetic", "train", "processed_cache")
    names = sorted(os.listdir(cache))
    assert len(first) == len(names) >= 8 and first.pairs

    def refuse(*a, **k):
        raise AssertionError("build_raw called: the cache was missed")

    monkeypatch.setattr(builder, "build_raw", refuse)
    monkeypatch.setattr(jbuilder, "build_raw", refuse)
    second = dataset.DualDataset(root, "Synthetic", "train", "train_list.txt", 0, 200, bc)
    jds = jdataset.DualDataset(root, "Synthetic", "train", "train_list.txt", 0, 200,
                               jbuilder.BuildConfig(granularity=16, reorder=True))
    assert sorted(os.listdir(cache)) == names
    assert len(second) == len(jds) == len(first)
    for a, b, c in zip(first.entries, second.entries, jds.entries):
        _entries_bit_equal(b, a)
        _entries_bit_equal(c, a)
    assert second.plan == first.plan
    s1, s2 = first.get(0), second.get(0)
    np.testing.assert_array_equal(s1.v.x, s2.v.x)
    # another BuildConfig is another key: nothing stale is served
    with pytest.raises(AssertionError, match="cache was missed"):
        dataset.DualDataset(root, "Synthetic", "train", "train_list.txt", 0, 200,
                            builder.BuildConfig(granularity=16, reorder=True, seed=1))
    # cache=False builds, and writes nothing
    monkeypatch.undo()
    dataset.DualDataset(root, "Synthetic", "test", "test_list.txt", 0, 200, bc, cache=False)
    assert not os.path.exists(os.path.join(root, "Synthetic", "test", "processed_cache"))


# --------------------------------------------------------------------------
# a run directory of the JAX package, served by both packages
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A run directory made by hand with the JAX package: Config.to_json and
    save_checkpoint of model.init (no training), and a test split."""
    tmp = tmp_path_factory.mktemp("jaxrun")
    root = _corpus(str(tmp / "dataset"))
    cfg = JConfig(seed=0, flag="j", dataset_dir=root, log_dir=str(tmp / "log"), **SMALL)
    run_dir = str(tmp / "run")
    os.makedirs(run_dir)
    cfg.to_json(os.path.join(run_dir, "params.json"))
    mesh = jmeshio.read_obj(os.path.join(root, "Synthetic", "test", "noisy", "s_n1.obj"))
    ds = jdataset.InMemoryDataset([(mesh, None)], cfg.build_config())
    model = JDualGNN(fc_dtype=jnp.bfloat16)
    params = model.init(jax.random.PRNGKey(5), ds.get(0))
    jckpt.save_checkpoint(os.path.join(run_dir, "ckpt_best.pkl"), params,
                          epoch=0, best_error=1.0)
    return run_dir, root, mesh


def test_jax_run_dir_is_served_by_the_port(jax_run):
    """The same run directory through geobignn_tpu predict_dir and the
    port's predict_dir(device="cpu"): written positions within 1e-2 mean edge
    lengths, normals within 5e-2 (bf16 aggregate operands and heads in both
    packages, rounded at other places), angle1 / angle2 within 0.5 degrees.
    The port never imports the run's code_bak/geobignn_tpu."""
    run_dir, root, mesh = jax_run
    test_dir = os.path.join(root, "Synthetic", "test")
    jrep = jpredict.predict_dir(run_dir, dataset_root=root, n_update_iters=10)
    v_j = jmeshio.read_obj(os.path.join(jrep["result_dir"], "s_n1-10.obj")).points
    _, n_j = jpredict.Predictor.from_run(run_dir, pinned=False).denoise(mesh, 10)
    shutil.rmtree(jrep["result_dir"])

    # a snapshot of the JAX package that would fail to import
    bak = os.path.join(run_dir, "code_bak", "geobignn_tpu")
    os.makedirs(bak)
    with open(os.path.join(bak, "__init__.py"), "w") as f:
        f.write("raise ImportError('the port must not import the JAX snapshot')\n")
    before = set(sys.modules)
    rep = predict.predict_dir(run_dir, dataset_root=root, n_update_iters=10, device="cpu")
    assert predict._PINNED_STATE is None and sys.path.count(os.path.dirname(bak)) == 0
    assert not [m for m in set(sys.modules) - before if m.startswith("geobignn_tpu.")]
    v_t = meshio.read_obj(os.path.join(rep["result_dir"], "s_n1-10.obj")).points
    pred = predict.Predictor.from_run(run_dir, device="cpu")
    assert type(pred) is predict.Predictor  # no snapshot of the port: live
    _, n_t = pred.denoise(mesh, 10)
    shutil.rmtree(os.path.join(run_dir, "code_bak"))

    mel = geometry.mean_edge_length_np(mesh.points, mesh.ev_indices)
    assert rep["result_dir"] == jrep["result_dir"] == os.path.join(test_dir, "result_j")
    assert float(np.abs(v_t - v_j).max()) <= 1e-2 * mel
    assert float(np.abs(n_t - n_j).max()) <= 5e-2
    assert [r["name"] for r in rep["rows"]] == [r["name"] for r in jrep["rows"]] == ["s_n1"]
    for k in ("angle_mean1", "angle_mean2"):
        assert abs(rep[k] - jrep[k]) <= 0.5, (k, rep[k], jrep[k])
    # the weights arrived bit for bit
    jtree = jckpt.load_checkpoint(os.path.join(run_dir, "ckpt_best.pkl"))[0]["params"]
    for name, t in pred.model.state_dict().items():
        node = jtree
        for part in name.split("."):
            node = node[part]
        assert np.asarray(node).tobytes() == t.numpy().tobytes(), name


def test_halo_flags_are_accepted_and_refused(jax_run):
    run_dir, root, _ = jax_run
    for kw in (dict(halo_parts=2), dict(halo_banded=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            predict.predict_dir(run_dir, dataset_root=root, device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="halo"):
        train(Config(halo_parts=2, log_dir=os.path.join(root, "log")), device="cpu")


# --------------------------------------------------------------------------
# runs of the port: artefacts, pinning, resume
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("portrun")
    root = _corpus(str(tmp / "dataset"))
    cfg = Config(max_epoch=1, seed=0, flag="p", dataset_dir=root,
                 log_dir=str(tmp / "log"), **SMALL)
    stdout = sys.stdout
    run_dir = train(cfg, device="cpu")
    assert sys.stdout is stdout  # the tee is taken down again
    return run_dir, cfg


def test_train_writes_the_run_directory(port_run):
    run_dir, cfg = port_run
    for name in ("params.json", "ckpt_best.pkl", "ckpt_last.pkl", "metrics.jsonl",
                 "training_info.txt", "code_bak/geobignn_tpu_torch/csrc/nearest.cu",
                 "code_bak/geobignn_tpu_torch/infer/predict.py",
                 "code_bak/native/meshkernel.cpp", "code_bak/native/Makefile"):
        assert os.path.exists(os.path.join(run_dir, name)), name
    assert Config.from_json(os.path.join(run_dir, "params.json")) == cfg
    assert JConfig.from_json(os.path.join(run_dir, "params.json")).granularity == 16
    info = open(os.path.join(run_dir, "training_info.txt")).read()
    assert "Training set: 1 samples; eval: 1" in info and "best error:" in info
    recs = [json.loads(ln) for ln in open(os.path.join(run_dir, "metrics.jsonl"))]
    assert [(r["split"], r["epoch"]) for r in recs] == [("train", 0), ("test", 0)]
    _, opt, scalars = ckpt.load_checkpoint(os.path.join(run_dir, "ckpt_last.pkl"), True)
    assert scalars["epoch"] == 0 and scalars["plateau"] is None
    assert len(opt["state"]) == len(ckpt.load_checkpoint(
        os.path.join(run_dir, "ckpt_best.pkl"))[0])
    # the JAX package loads the port's weights from the same file
    jpred = jpredict.Predictor.from_run(run_dir, pinned=False)
    assert set(jpred.params["params"]) == {"gnn_v", "gnn_f", "fc_v1", "fc_v2",
                                           "fc_f1", "fc_f2"}


def test_pinned_inference_uses_snapshot(tmp_path, port_run):
    """from_run (pinned, the default) runs the run's code_bak snapshot, not
    the live package: a marker edit to the SNAPSHOT's model shows up in the
    predictions, while pinned=False (live code) is unaffected.  The
    snapshot counts its launches in the live package's counters."""
    src_run, _ = port_run
    run_dir = str(tmp_path / "run_pinned")
    shutil.copytree(src_run, run_dir)
    bak_pkg = os.path.join(run_dir, "code_bak", "geobignn_tpu_torch")
    snap_model = os.path.join(bak_pkg, "models", "dual_gnn.py")
    src = open(snap_model).read()
    marker = "return vert_p, geometry.safe_normalize(n)"
    assert marker in src
    with open(snap_model, "w") as f:
        f.write(src.replace(marker, marker.replace("vert_p,", "vert_p * 0.0 + 7.25,")))
    mesh = synth.add_noise(synth.icosphere(2), 0.25, seed=5)

    try:
        pred = predict.Predictor.from_run(run_dir, device="cpu")  # pinned by default
        assert bak_pkg in inspect.getfile(type(pred))
        snap_cuda = sys.modules["geobignn_tpu_torch.ops.banded_cuda"]
        assert snap_cuda is not banded_cuda and snap_cuda.LAUNCHES is banded_cuda.LAUNCHES
        assert sys.modules["geobignn_tpu_torch.ops.blocksparse"].LAUNCHES \
            is banded_cuda.LAUNCHES
        assert snap_cuda.BUILD_DIR == os.path.join(run_dir, "code_bak", "build",
                                                   "geobignn_tpu_torch")
        vp, _ = pred.predict_mesh(mesh)
        # imported when the host builders first ask for it: the snapshot's own
        snap_native = sys.modules["geobignn_tpu_torch.native"]
        assert snap_native.NATIVE_DIR == os.path.join(run_dir, "code_bak", "native")
        # positions before denormalization are the constant 7.25: all rows equal
        assert np.abs(vp - vp[:1]).max() < 1e-5
    finally:
        predict.unpin_live_package()
    assert sys.modules["geobignn_tpu_torch.ops.banded_cuda"] is banded_cuda
    assert predict._PINNED_STATE is None

    live = predict.Predictor.from_run(run_dir, pinned=False, device="cpu")
    assert type(live) is predict.Predictor
    vp_live, _ = live.predict_mesh(mesh)
    assert np.abs(vp_live - vp_live[:1]).max() > 1e-3  # real predictions vary


def test_predict_dir_restores_live_package(port_run):
    """Pinned batch inference must not leave the snapshot in sys.modules for
    the rest of the process, also when the batch fails."""
    run_dir, cfg = port_run
    live_before = sys.modules["geobignn_tpu_torch.data.builder"]
    path_before = list(sys.path)
    rep = predict.predict_dir(run_dir, dataset_root=cfg.dataset_dir, device="cpu")
    assert rep["rows"] and os.path.exists(
        os.path.join(rep["result_dir"], "s_n1-60.obj"))
    import geobignn_tpu_torch.data.builder as b_after

    assert sys.modules["geobignn_tpu_torch.data.builder"] is live_before
    assert b_after is live_before and sys.path == path_before
    with pytest.raises(NotImplementedError):  # raised inside the pinned batch
        predict.predict_dir(run_dir, dataset_root=cfg.dataset_dir, device="cpu",
                            halo_parts=2)
    assert sys.modules["geobignn_tpu_torch.data.builder"] is live_before
    assert sys.path == path_before


def test_a_failed_snapshot_import_leaves_the_live_package(tmp_path, port_run):
    run_dir = str(tmp_path / "run_broken")
    shutil.copytree(port_run[0], run_dir)
    with open(os.path.join(run_dir, "code_bak", "geobignn_tpu_torch", "infer",
                           "predict.py"), "w") as f:
        f.write("raise ImportError('broken snapshot')\n")
    live = sys.modules["geobignn_tpu_torch.infer.predict"]
    path_before = list(sys.path)
    with pytest.raises(ImportError, match="broken snapshot"):
        predict.Predictor.from_run(run_dir, device="cpu")
    assert sys.modules["geobignn_tpu_torch.infer.predict"] is live is predict
    assert sys.path == path_before and predict._PINNED_STATE is None


def test_a_copy_of_the_package_without_native_sources_raises(tmp_path):
    """A copy of the package alone (no native/ beside it) must not quietly
    take the numpy implementations, whose matching differs from the native
    one: it raises and says why."""
    shutil.copytree(os.path.join(REPO, "geobignn_tpu_torch"),
                    str(tmp_path / "geobignn_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import geobignn_tpu_torch.native as n, sys\n"
            "try:\n    n.has_native()\nexcept RuntimeError as e:\n"
            "    print('RAISED', e); sys.exit(0)\nsys.exit(1)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "RAISED" in res.stdout and "meshkernel.cpp" in res.stdout


def _fit(cfg, ds, run_dir=None, restore=None, with_opt=True):
    tr = Trainer(cfg, ds, ds, run_dir, device="cpu")
    if restore:
        tr.restore(restore, with_opt=with_opt)
    hist = []
    tr.fit(on_epoch=lambda t, m, e: hist.append((m["loss"], e["error_f"],
                                                  t.optimizer.param_groups[0]["lr"])))
    return tr, hist


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_resume_is_trajectory_exact(tmp_path, optimizer):
    """4 epochs at once against 2 epochs, restore of ckpt_last.pkl into a
    fresh Trainer, 2 more: bit-equal parameters and the same per-epoch loss,
    error and learning rate — with the plateau policy (patience 0, so its
    state matters), random rotations and gradient accumulation."""
    pairs = [(synth.add_noise(synth.icosphere(2), 0.3, seed=s), synth.icosphere(2))
             for s in (1, 2, 3)]
    ds = dataset.InMemoryDataset(pairs, builder.BuildConfig(granularity=16, reorder=True))
    kw = dict(seed=2, granularity=16, augment=True, batch_size=2, lr=3e-2, lr_sch="auto",
              lr_step=(0,), lr_decay=0.5, optimizer=optimizer)
    full, hist_full = _fit(Config(max_epoch=4, **kw), ds)
    run_dir = str(tmp_path)
    _, hist_a = _fit(Config(max_epoch=2, **kw), ds, run_dir)
    resumed, hist_b = _fit(Config(max_epoch=4, **kw), ds, None,
                           os.path.join(run_dir, "ckpt_last.pkl"))
    assert resumed.epoch == 3 and len(hist_b) == 2
    assert hist_a + hist_b == hist_full
    assert len({h[2] for h in hist_full}) > 1  # the plateau did reduce the lr
    for (k, a), b in zip(full.model.state_dict().items(),
                         resumed.model.state_dict().values()):
        assert a.numpy().tobytes() == b.numpy().tobytes(), k
    assert resumed.best_error == full.best_error
    # without the optimizer's state the run goes on, on another trajectory
    if optimizer == "adam":
        cold, hist_c = _fit(Config(max_epoch=4, **kw), ds, None,
                            os.path.join(run_dir, "ckpt_last.pkl"), with_opt=False)
        assert cold.epoch == 3 and hist_c != hist_b


def test_auto_resume_picks_the_latest_run(tmp_path, port_run):
    cfg = Config(flag="r", log_dir=str(tmp_path / "log"))
    assert ttrainer.find_resumable_run(cfg) is None
    base = tmp_path / "log" / "GeoBi-GNN_Synthetic_r"
    for stamp, has in (("20240101-000000", True), ("20240301-120000", True),
                       ("20240302-000000", False)):
        (base / stamp).mkdir(parents=True)
        if has:
            (base / stamp / "ckpt_last.pkl").write_bytes(b"")
    assert ttrainer.find_resumable_run(cfg) == str(base / "20240301-120000")
    assert ttrainer.find_resumable_run(cfg.with_updates(flag="other")) is None

    # through train(): the run of the fixture goes on in its own directory
    run_dir, cfg1 = port_run
    copy = tmp_path / "log2" / "GeoBi-GNN_Synthetic_p" / os.path.basename(run_dir)
    shutil.copytree(run_dir, str(copy))
    cfg2 = cfg1.with_updates(max_epoch=3, auto_resume=True, log_dir=str(tmp_path / "log2"))
    assert train(cfg2, device="cpu") == str(copy)
    recs = [json.loads(ln) for ln in open(copy / "metrics.jsonl")]
    assert [r["epoch"] for r in recs if r["split"] == "train"] == [0, 1, 2]
    assert "auto-resume: continuing" in open(copy / "training_info.txt").read()
    assert ckpt.load_checkpoint(str(copy / "ckpt_last.pkl"))[2]["epoch"] == 2


def test_restore_from_model_path(tmp_path, port_run):
    """cfg.restore + cfg.model_path: a new run directory that starts from
    the given checkpoint's weights and epoch."""
    run_dir, cfg1 = port_run
    cfg = cfg1.with_updates(max_epoch=2, restore=True, flag="again",
                            model_path=os.path.join(run_dir, "ckpt_last.pkl"),
                            log_dir=str(tmp_path / "log"))
    new_dir = train(cfg, device="cpu")
    assert new_dir != run_dir
    recs = [json.loads(ln) for ln in open(os.path.join(new_dir, "metrics.jsonl"))]
    assert [r["epoch"] for r in recs if r["split"] == "train"] == [1]
