"""The port's training-to-accuracy programs against the JAX package's on the
CPU: geobignn_tpu_torch/examples/train_synthetic_campaign.py against
examples/train_synthetic_campaign.py (its corpus, its final evaluation, its
protocol over three epochs) and examples/halo_convergence.py's corpus and
`compare`; and the trainer's eval pass, which runs as a CUDA graph on the
card, unchanged in value on the CPU.

The JAX scripts are imported by path.  Weights go from the JAX model to
the port through params.py.  Where the two packages' numbers are held
within 1e-4 or closer, both compute in float32: the table convs
(reorder=False), float32 fc heads, XLA's matmuls at float32 precision.
With the default bf16 aggregate operands each package rounds on its own,
and three epochs of Adam drift apart by about 3e-2 (test_torch_train.py
holds the bf16 trainers within 2e-2 over two); the table convs' JAX
programs also compile in a third of the banded ones' time in Pallas
interpret mode.  test_torch_train.py, test_torch_grads.py and
test_torch_predict.py hold the banded path against JAX.
"""

from __future__ import annotations

import importlib.util
import json
import os

import jax
import numpy as np
import pytest
import torch

from geobignn_tpu import native as jnative
from geobignn_tpu.config import Config as JConfig
from geobignn_tpu.data import dataset as jdataset
from geobignn_tpu.train import trainer as jtrainer
from geobignn_tpu_torch import params as tparams
from geobignn_tpu_torch import testing
from geobignn_tpu_torch.config import Config
from geobignn_tpu_torch.data import dataset, synth
from geobignn_tpu_torch.examples import halo_convergence as hc
from geobignn_tpu_torch.examples import train_synthetic_campaign as tsc
from geobignn_tpu_torch.models.dual_gnn import DualGNN
from geobignn_tpu_torch.train.trainer import Trainer, _metrics_of

testing.share_cores()  # torch's CPU threads: this test worker's share of the cores

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _reference_native():
    """The JAX package's native path as this machine supports it: its
    loader may have read a library another process was still writing."""
    testing.match_reference_native(jnative)


def _jax_script(name):
    """The JAX package's examples/<name>.py, imported by path."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _same_pairs(mine, theirs):
    assert len(mine) == len(theirs)
    for (n_t, o_t), (n_j, o_j) in zip(mine, theirs):
        for a, b in ((n_t, n_j), (o_t, o_j)):
            assert a.points.dtype == b.points.dtype
            np.testing.assert_array_equal(a.points, b.points)
            np.testing.assert_array_equal(a.fv_indices, b.fv_indices)


@pytest.mark.parametrize("split", ["train", "eval"])
def test_campaign_corpus_matches_the_jax_script(split):
    """Every (noisy, clean) pair of the campaign, points and faces bit-equal
    to the JAX script's, with the same names and classes; the short corpus
    is the samples of the first two train shapes of each class (24) and of
    the first two held-out shapes (6), each as in the whole one."""
    jc = _jax_script("train_synthetic_campaign")
    shapes, seed0 = {"train": ("train_shapes", 1000), "eval": ("eval_shapes", 9000)}[split]
    pairs_j, names_j = jc.make_pairs(getattr(jc, shapes)(), seed0)
    pairs_t, names_t = tsc.make_pairs(getattr(tsc, shapes)(), seed0)
    assert tsc.NOISE_LEVELS == jc.NOISE_LEVELS
    assert names_t == names_j and len(pairs_t) == {"train": 66, "eval": 24}[split]
    _same_pairs(pairs_t, pairs_j)
    whole, short = (tsc.corpus(short=s)[split == "eval"] for s in (False, True))
    assert whole[1] == names_j
    _same_pairs(whole[0], pairs_j)
    kept = {n: p for p, (n, _) in zip(pairs_j, names_j)}
    assert len(short[1]) == {"train": 24, "eval": 6}[split]
    _same_pairs(short[0], [kept[n] for n, _ in short[1]])
    if split == "train":
        per_class: dict = {}
        for n, k in short[1]:
            per_class.setdefault(k, set()).add(n.rsplit("_n", 1)[0])
        assert {k: len(v) for k, v in per_class.items()} == dict.fromkeys(
            ("smooth", "torus", "sharp", "mixed"), 2)
    else:
        assert {n.rsplit("_n", 1)[0] for n, _ in short[1]} == {"SphereT", "EllipT"}


def test_halo_corpus_matches_the_jax_script():
    jh = _jax_script("halo_convergence")
    for mine, theirs in zip(hc.corpus(), jh.corpus()):
        _same_pairs(mine, theirs)


@pytest.fixture
def float32_matmuls():
    """XLA's matmuls at float32 precision, as torch's on the CPU."""
    with jax.default_matmul_precision("float32"):
        yield


def test_final_eval_matches_the_jax_script(float32_matmuls):
    """final_eval on two small held-out pairs (icosphere(2), cube(6), noise
    0.2) with one set of weights in both packages, the table convs and
    float32 heads: each row's angles within 1e-3 degrees and its Hausdorff
    distance within 1e-4 (the rows are rounded to those digits); the
    per-class and corpus means are face-weighted."""
    jc = _jax_script("train_synthetic_campaign")
    shapes = [("Ico", "smooth", synth.icosphere(2)), ("Cube", "sharp", synth.cube(6))]
    pairs = [(synth.add_noise(m, 0.2, seed=5 + i), m) for i, (_, _, m) in enumerate(shapes)]
    names = [(n + "_n2", k) for n, k, _ in shapes]
    state = DualGNN(device="cpu", seed=1).state_dict()
    kw = dict(fc_precision="float32", reorder=False)
    rows_t = tsc.final_eval(tsc.campaign_config().with_updates(**kw), state, pairs, names,
                            device="cpu")
    rows_j = jc.final_eval(JConfig(data_type="SynthCampaign", seed=11, granularity=128, **kw),
                           tparams.to_jax_params(state), pairs, names)
    assert len(rows_t) == len(rows_j) == 2
    for rt, rj in zip(rows_t, rows_j):
        assert {k: rt[k] for k in ("name", "klass", "faces")} == \
            {k: rj[k] for k in ("name", "klass", "faces")}
        for k in ("angle_noisy", "angle1", "angle2"):
            assert abs(rt[k] - rj[k]) <= 1e-3 + 1e-9, (k, rt, rj)
        assert abs(rt["hausdorff"] - rj["hausdorff"]) <= 1e-4 + 1e-9, (rt, rj)
        assert np.isfinite([rt[k] for k in ("angle1", "angle2", "hausdorff")]).all()
    per_class, corpus = tsc.summarize(rows_t)
    assert sorted(per_class) == ["sharp", "smooth"]
    f = np.array([r["faces"] for r in rows_t], np.float64)
    for k in ("angle1", "angle2", "hausdorff"):
        want = float((f * [r[k] for r in rows_t]).sum() / f.sum())
        assert abs(corpus[k] - want) <= 1e-3, (k, corpus[k], want)
        assert per_class["smooth"][k] == rows_t[0][k] and per_class["sharp"][k] == rows_t[1][k]


def _protocol_pairs(synth_mod):
    """Four small training pairs and two held-out ones, named and seeded as
    the campaign names and seeds its own."""
    train = []
    for i, m in enumerate((synth_mod.icosphere(2), synth_mod.cube(4))):
        for j, sig in enumerate((0.1, 0.3)):
            train.append((synth_mod.add_noise(m, sig, seed=1000 + 17 * i + j), m))
    evals = [(synth_mod.add_noise(m, 0.2, seed=9000 + i), m)
             for i, m in enumerate((synth_mod.icosphere(2), synth_mod.cube(4)))]
    return train, evals


@pytest.fixture
def one_thread():
    """torch's CPU kernels on one thread: a step's float32 sums then come in
    one order (with several threads they round apart from run to run, and
    Adam's first steps, about lr * sign(g), carry a flipped sign of a
    near-zero gradient as 2 lr; 2.4e-4 relative after two epochs on 8
    threads against 1.5e-5 on one)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_campaign_protocol_matches_the_jax_trainer(tmp_path, one_thread, float32_matmuls):
    """Three epochs of the campaign's protocol (lmd, a full eval pass each
    epoch, the best checkpoint on the eval normal error), augmentation off,
    on 4 small pairs, from the JAX trainer's initial weights: eval error_f
    per epoch within 1e-4 relative of the JAX trainer's and the same best
    epoch, in float32 compute on the table convs (see the docstring), torch
    on one thread."""
    from geobignn_tpu.data import synth as jsynth

    kw = dict(data_type="SynthCampaign", seed=11, max_epoch=3, lr=1e-3, lr_sch="lmd",
              lr_decay=0.98, lr_step=(20,), augment=False, granularity=64, reorder=False,
              fc_precision="float32")
    (tp, ep), (jtp, jep) = _protocol_pairs(synth), _protocol_pairs(jsynth)
    jcfg = JConfig(preload=False, **kw)  # the per-step path: the same updates as the scan
    jbc = jcfg.build_config()
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jtr = jtrainer.Trainer(jcfg, jdataset.InMemoryDataset(jtp, jbc),
                           jdataset.InMemoryDataset(jep, jbc), str(tmp_path / "j"))
    cfg = tsc.campaign_config(3).with_updates(**kw)
    bc = cfg.build_config()
    tr = Trainer(cfg, dataset.InMemoryDataset(tp, bc), dataset.InMemoryDataset(ep, bc),
                 str(tmp_path / "t"), device="cpu")
    tr.model.load_state_dict(tparams.from_jax_params(jax.tree.map(np.asarray, jtr.params)))
    hist_j, hist_t = [], []
    best_j = jtr.fit(on_epoch=lambda t, m, e: hist_j.append(e))
    best_t = tr.fit(on_epoch=lambda t, m, e: hist_t.append(e))
    err_t = [e["error_f"] for e in hist_t]
    err_j = [e["error_f"] for e in hist_j]
    assert len(err_t) == len(err_j) == 3
    for a, b in zip(err_t, err_j):
        assert abs(a - b) <= 1e-4 * abs(b), (err_t, err_j)
    assert int(np.argmin(err_t)) == int(np.argmin(err_j))
    assert abs(best_t - best_j) <= 1e-4 * best_j and err_t[-1] < err_t[0]
    from geobignn_tpu_torch.train import checkpoint

    _, _, scalars = checkpoint.load_checkpoint(str(tmp_path / "t" / "ckpt_best.pkl"))
    assert scalars["epoch"] == int(np.argmin(err_j)) and scalars["best_error"] == best_t


def test_halo_compare_matches_the_jax_script(tmp_path, monkeypatch, capsys):
    """compare() on two given curves: the same table and summary.json as the
    JAX script's (whose OUT_DIR is pointed at the curves)."""
    jh = _jax_script("halo_convergence")
    rng = np.random.default_rng(3)
    for mode in ("single", "halo"):
        errs = 30.0 * np.exp(-np.arange(27) / 9.0) + 5.0 + rng.random(27)
        with open(tmp_path / f"{mode}_curve.jsonl", "w") as f:
            for e, v in enumerate(errs):
                f.write(json.dumps(dict(epoch=e, error_f=float(v), error_v=0.1)) + "\n")
    mine = hc.compare(str(tmp_path))
    out_t = capsys.readouterr().out
    with open(tmp_path / "summary.json") as f:
        written = json.load(f)
    monkeypatch.setattr(jh, "OUT_DIR", str(tmp_path))
    jh.compare()
    out_j = capsys.readouterr().out
    with open(tmp_path / "summary.json") as f:
        theirs = json.load(f)
    assert mine == written == theirs and out_t == out_j
    assert theirs["epochs"] == 27


def test_eval_pass_is_unchanged_on_the_cpu():
    """Trainer.evaluate on the CPU: the node-weighted sums of the eager
    forward and metrics, bit-equal to the same sums taken sample by sample
    here, the same twice, and no graph captured."""
    clean = synth.icosphere(2)
    pairs = [(synth.add_noise(clean, 0.2, seed=s), clean) for s in (1, 2, 3)]
    bc = Config(granularity=64).build_config()
    tr = Trainer(Config(granularity=64), dataset.InMemoryDataset(pairs[:1], bc),
                 dataset.InMemoryDataset(pairs[1:], bc), device="cpu")
    got = tr.evaluate()
    assert tr.evaluate() == got and not tr._eval_program.graphs
    keys = ("loss_v", "loss_f", "error_v", "error_f", "n_v", "n_f")
    sums = {k: torch.zeros(()) for k in keys}
    with torch.no_grad():
        for i in range(len(tr.eval_ds)):
            sample = tr._get(tr.eval_ds, "e", i)
            m = _metrics_of(*tr.model(sample), sample, tr.cfg)[1]
            for k, n in (("loss_v", "n_v"), ("error_v", "n_v"), ("loss_f", "n_f"),
                         ("error_f", "n_f")):
                sums[k] += m[k] * m[n]
            sums["n_v"] += m["n_v"]
            sums["n_f"] += m["n_f"]
    s = {k: float(v) for k, v in sums.items()}
    assert got == dict(loss_v=s["loss_v"] / s["n_v"], error_v=s["error_v"] / s["n_v"],
                       loss_f=s["loss_f"] / s["n_f"], error_f=s["error_f"] / s["n_f"])


def halo_against_jax(epochs: int = 3):
    """The port's 8-part HaloTrainer on halo_convergence's corpus from the
    JAX trainer's initial weights against the JAX HaloTrainer (8 virtual
    CPU devices, XLA's matmuls at float32 precision): each epoch's eval
    error_f and their relative distance."""
    from geobignn_tpu.train.halo_trainer import HaloTrainer as JHaloTrainer
    from geobignn_tpu_torch.train.halo_trainer import HaloTrainer

    jh = _jax_script("halo_convergence")
    (train, evals), (jtrain, jevals) = hc.corpus(), jh.corpus()
    cfg = hc.run_config("halo", epochs, 7)
    jcfg = JConfig(**{f: getattr(cfg, f) for f in (
        "data_type", "flag", "seed", "max_epoch", "lr", "lr_sch", "lr_decay", "lr_step",
        "augment", "preload", "granularity", "batch_size", "halo_parts")})
    hist_j, hist_t = [], []
    with jax.default_matmul_precision("float32"):
        jtr = JHaloTrainer(jcfg, jtrain, jevals)
        start = tparams.from_jax_params(jax.tree.map(np.asarray, jtr.params))
        jtr.fit(on_epoch=lambda t, m, e: hist_j.append(e["error_f"]))
    tr = HaloTrainer(cfg, train, evals, devices=["cpu"] * hc.HALO_PARTS)
    tr.model.load_state_dict(start)
    tr.fit(on_epoch=lambda t, m, e: hist_t.append(e["error_f"]))
    print(json.dumps(dict(jax=hist_j, port=hist_t,
                          rel=[abs(a - b) / b for a, b in zip(hist_t, hist_j)])))


def rel_gap_windows(out_dir: str, window: int = 10, first: int = 30):
    """compare()'s rel_gap of every `window`-epoch window ending at epoch
    `first` or later, over out_dir's two curves, and each curve's spread
    (std) over its last 20 epochs: how far the statistic moves by itself."""
    curves = {}
    for mode in ("single", "halo"):
        with open(os.path.join(out_dir, f"{mode}_curve.jsonl")) as f:
            curves[mode] = np.array([json.loads(ln)["error_f"] for ln in f])
    s, h = curves["single"], curves["halo"]
    gaps = [abs(s[e - window:e].mean() - h[e - window:e].mean()) / s[e - window:e].mean()
            for e in range(first, len(s) + 1)]
    print(json.dumps(dict(
        rel_gap=gaps[-1], windows_min=min(gaps), windows_max=max(gaps),
        std_last20=[float(c[-20:].std(ddof=1)) for c in (s, h)])))


if __name__ == "__main__":
    # PYTHONPATH=. python tests/test_torch_campaign.py halo-against-jax [epochs]
    # PYTHONPATH=. python tests/test_torch_campaign.py rel-gap [dir of the two curves]
    import sys

    os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
    jax.config.update("jax_platforms", "cpu")
    if sys.argv[1] == "halo-against-jax":
        halo_against_jax(*map(int, sys.argv[2:]))
    else:
        rel_gap_windows(sys.argv[2] if len(sys.argv) > 2 else os.path.join(ROOT, "docs", "halo_conv"))
