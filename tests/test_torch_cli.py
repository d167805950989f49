"""`python -m geobignn_tpu_torch train|infer|eval|campaign` on a tiny
reference-layout corpus, with --device=cpu: the artefacts the JAX CLI
produces, its strict `--key=value` handling, and the refusal to run
without a GPU unless the CPU is asked for.
"""

from __future__ import annotations

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from geobignn_tpu import cli as jcli
from geobignn_tpu_torch import cli, meshio
from geobignn_tpu_torch.data import synth
from geobignn_tpu import native as jnative
from geobignn_tpu_torch import testing

testing.share_cores()  # torch's CPU threads: this test worker's share of the cores


@pytest.fixture(scope="module", autouse=True)
def _reference_native():
    """The JAX package's native path as this machine supports it: its
    loader may have read a library another process was still writing."""
    testing.match_reference_native(jnative)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# shape names from the reference Synthetic manifest vocabulary: the list
# files select by bare name, one per line
TRAIN_NAMES = ["Cylinder", "Icosahedron"]
TEST_NAMES = ["Octahedron"]
SMALL = ["--max_epoch=2", "--seed=1", "--augment=false", "--granularity=16",
         "--sub_size=100000", "--device=cpu"]
RUN_FILES = ("params.json", "ckpt_best.pkl", "ckpt_last.pkl", "metrics.jsonl",
             "training_info.txt", "code_bak/geobignn_tpu_torch/cli.py",
             "code_bak/geobignn_tpu_torch/csrc/nearest.cu")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread for this module: these tiny trainings run many times
    slower when several test processes' thread pools compete for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _make_corpus(root):
    """Reference-layout corpus with tiny icospheres standing in for the real
    meshes; two noise draws per shape like `{name}_n*.obj`."""
    for split, names in (("train", TRAIN_NAMES), ("test", TEST_NAMES)):
        nd = os.path.join(root, "Synthetic", split, "noisy")
        od = os.path.join(root, "Synthetic", split, "original")
        os.makedirs(nd), os.makedirs(od)
        for i, name in enumerate(names):
            m_o = synth.icosphere(2)
            meshio.write_obj(os.path.join(od, f"{name}.obj"), m_o.points, m_o.fv_indices)
            for k in (1, 2):
                m_n = synth.add_noise(m_o, 0.15, seed=10 * i + k)
                meshio.write_obj(os.path.join(nd, f"{name}_n{k}.obj"),
                                 m_n.points, m_n.fv_indices)
        with open(os.path.join(root, "Synthetic", f"{split}_list.txt"), "w") as f:
            f.write("\n".join(names) + "\n")
    return root


def _run_dir(tmp_path, flag):
    (run_dir,) = glob.glob(str(tmp_path / "log" / f"GeoBi-GNN_Synthetic_{flag}" / "*"))
    return run_dir


def test_train_infer_eval_chain(tmp_path, monkeypatch):
    """train (which chains inference as the JAX CLI does), then infer on a
    plain directory of meshes, then eval."""
    root = _make_corpus(str(tmp_path / "dataset"))
    monkeypatch.chdir(tmp_path)  # run dirs land under tmp log/
    stdout = sys.stdout
    assert cli.main(["train", "--data_type=Synthetic", "--flag=smoke",
                     f"--dataset_dir={root}", *SMALL]) is None
    assert sys.stdout is stdout
    run_dir = _run_dir(tmp_path, "smoke")
    for name in RUN_FILES:
        assert os.path.exists(os.path.join(run_dir, name)), name
    test_dir = os.path.join(root, "Synthetic", "test")
    res = sorted(os.listdir(os.path.join(test_dir, "result_smoke")))
    assert res == ["Octahedron_n1-60.obj", "Octahedron_n2-60.obj"]
    cfg = json.load(open(os.path.join(run_dir, "params.json")))
    assert cfg["max_epoch"] == 2 and cfg["augment"] is False and cfg["flag"] == "smoke"

    # infer: every .obj of a directory, no originals
    plain = tmp_path / "scans"
    plain.mkdir()
    m = synth.add_noise(synth.icosphere(2), 0.2, seed=9)
    meshio.write_obj(str(plain / "scan.obj"), m.points, m.fv_indices)
    cli.main(["infer", f"--run_dir={run_dir}", f"--data_dir={plain}", "--device=cpu"])
    out = meshio.read_obj(str(plain / "result_smoke" / "scan-60.obj"))
    assert out.n_vertices == m.n_vertices and np.isfinite(out.points).all()
    # infer on the run's own test split, by dataset root
    os.remove(os.path.join(test_dir, "result_smoke", res[0]))
    cli.main(["infer", f"--run_dir={run_dir}", f"--dataset_root={root}", "--device=cpu"])
    assert sorted(os.listdir(os.path.join(test_dir, "result_smoke"))) == res
    # halo inference: each mesh node-partitioned over 2 parts, both on the CPU
    os.remove(os.path.join(test_dir, "result_smoke", res[0]))
    cli.main(["infer", f"--run_dir={run_dir}", f"--dataset_root={root}",
              "--halo_parts=2", "--halo_banded", "--device=cpu"])
    assert sorted(os.listdir(os.path.join(test_dir, "result_smoke"))) == res
    out = meshio.read_obj(os.path.join(test_dir, "result_smoke", res[0]))
    assert np.isfinite(out.points).all()

    # eval, as a module run in a process of its own
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    done = subprocess.run(
        [sys.executable, "-m", "geobignn_tpu_torch", "eval",
         f"--result_dir={os.path.join(test_dir, 'result_smoke')}",
         f"--original_dir={os.path.join(test_dir, 'original')}", "--device=cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stdout + done.stderr
    assert "ErrorInfo_h.txt saved." in done.stdout
    info = open(os.path.join(test_dir, "result_smoke", "ErrorInfo_h.txt")).read()
    assert info.startswith("Error_rst:") and "Octahedron_n2-60.obj" in info


def test_campaign_entry_end_to_end(tmp_path, monkeypatch):
    root = _make_corpus(str(tmp_path / "dataset"))
    monkeypatch.chdir(tmp_path)
    summary = cli.main(["campaign", "--data_type=Synthetic", "--flag=smoke",
                        f"--dataset_dir={root}", *SMALL])
    assert summary and np.isfinite(summary["angle_mean1"])
    assert np.isfinite(summary["angle_mean2"])
    # result meshes for every manifest-selected test pair
    res = sorted(glob.glob(os.path.join(root, "Synthetic", "test", "result_smoke", "*.obj")))
    assert len(res) == 2  # Octahedron_n1 / _n2
    # corpus eval (ErrorInfo table) ran and the summary was persisted
    assert summary["corpus"] is not None and len(summary["eval_rows"]) == 2
    assert os.path.abspath(summary["run_dir"]) == _run_dir(tmp_path, "smoke")
    with open(os.path.join(summary["run_dir"], "campaign_summary.json")) as f:
        js = json.load(f)
    assert js["angle_mean1"] == summary["angle_mean1"]
    assert js["corpus"] == summary["corpus"]
    assert os.path.exists(os.path.join(
        root, "Synthetic", "test", "result_smoke", "ErrorInfo_h.txt"))
    for name in RUN_FILES:
        assert os.path.exists(os.path.join(summary["run_dir"], name)), name


@pytest.mark.parametrize("extra", [
    ["--edge_weight_type=4"], ["--precision=bfloat16"], ["--fusion_features=16"],
    ["--preload=False", "--buckets_growth=1.5", "--prefetch_depth=2"]],
    ids=["dynamic", "bf16", "fusion", "streamed-buckets"])
def test_train_takes_every_single_device_mode(tmp_path, monkeypatch, extra):
    """`train` with each mode of this slice: the run directory's params.json
    holds it, training ran, and inference is chained but for dynamic
    pooling, which the predictor does not serve (as the JAX one)."""
    root = _make_corpus(str(tmp_path / "dataset"))
    monkeypatch.chdir(tmp_path)
    args = [a for a in SMALL if not a.startswith("--max_epoch")] + ["--max_epoch=1"]
    cli.main(["train", "--data_type=Synthetic", "--flag=m", f"--dataset_dir={root}",
              *args, *extra])
    run_dir = _run_dir(tmp_path, "m")
    cfg = json.load(open(os.path.join(run_dir, "params.json")))
    for arg in extra:
        k, v = arg[2:].split("=")
        assert str(cfg[k]).lower() == v.lower(), (k, cfg[k])
    assert os.path.exists(os.path.join(run_dir, "ckpt_last.pkl"))
    results = os.path.join(root, "Synthetic", "test", "result_m")
    assert os.path.isdir(results) == ("--edge_weight_type=4" not in extra)


def test_config_file_and_extras(tmp_path, monkeypatch):
    """--config gives the base, --key=value pairs override it, typed by JSON."""
    monkeypatch.chdir(tmp_path)
    conf = tmp_path / "base.json"
    conf.write_text(json.dumps(dict(lr=0.5, heads=4, lr_step=[3, 5], flag="ignored")))
    seen = {}
    monkeypatch.setattr("geobignn_tpu_torch.train.trainer.train",
                        lambda cfg, device=None: seen.update(cfg=cfg, device=device) or "r")
    monkeypatch.setattr("geobignn_tpu_torch.infer.predict.predict_dir",
                        lambda run_dir, **kw: seen.update(run_dir=run_dir, kw=kw))
    cli.main(["train", "--data_type=Kinect_v1", f"--config={conf}", "--lr=0.25",
              "--lr_sch=auto", "--model_path=a=b.pkl", "--device=cpu"])
    cfg = seen["cfg"]
    assert (cfg.lr, cfg.heads, cfg.lr_step, cfg.lr_sch) == (0.25, 4, (3, 5), "auto")
    assert cfg.flag == "run" and cfg.model_path == "a=b.pkl" and cfg.force_depth
    assert seen["device"] == "cpu" and seen["run_dir"] == "r"
    assert seen["kw"] == dict(dataset_root="dataset", device="cpu")


@pytest.mark.parametrize("cmd", ["train", "campaign"])
@pytest.mark.parametrize("extra", ["--max_epohc=2", "stray", "--novalue"])
def test_unknown_key_exits_as_the_jax_cli_does(cmd, extra):
    argv = [cmd, "--data_type=Synthetic", extra, "--device=cpu"]
    with pytest.raises(SystemExit) as port:
        cli.main(argv)
    with pytest.raises(SystemExit) as ref:
        jcli.main(argv[:-1])
    assert port.value.code == ref.value.code and isinstance(port.value.code, str)
    if extra.startswith("--max"):
        assert "unknown config key '--max_epohc'" in port.value.code
        assert "max_epoch" in port.value.code


@pytest.mark.parametrize("argv", [["train"], ["infer"], ["eval", "--result_dir=x"], [],
                                  ["serve"]])
def test_missing_required_arguments_exit(argv, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(argv)
    assert e.value.code == 2


@pytest.mark.parametrize("argv", [
    ["train", "--data_type=Synthetic"], ["campaign", "--data_type=Synthetic"],
    ["infer", "--run_dir=nowhere"], ["eval", "--result_dir=a", "--original_dir=b"],
], ids=lambda a: a[0])
def test_every_subcommand_needs_a_gpu_unless_cpu(argv, tmp_path, monkeypatch):
    """Without --device=cpu and without a card every subcommand raises the
    device='cpu' error, before it writes anything."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(argv)
    assert os.listdir(tmp_path) == []
