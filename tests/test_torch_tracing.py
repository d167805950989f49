"""The program's spans and counters (geobignn_tpu_torch/tracing.py).

On the CPU: under a torch profiler, an eager epoch, an eval pass, the host
build and a served mesh record the spans of tracing.py's docstring, nested
as stated, among the profiler's own events; with no profiler recording, no
span is entered (record_function made to raise) and nothing is counted;
`profiling.trace` writes the counters beside the trace and starts them
from zero.  The graph counters and the stage events inside the captured
step run on the card (tests/test_torch_cuda.py).
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from geobignn_tpu_torch import testing, tracing
from geobignn_tpu_torch.config import Config
from geobignn_tpu_torch.data import dataset, synth
from geobignn_tpu_torch.train import profiling
from geobignn_tpu_torch.train.trainer import Trainer

testing.share_cores()  # torch's CPU threads: this test worker's share of the cores

TRAIN_SPANS = ("trainer.epoch", "trainer.epoch_begin", "trainer.steps", "trainer.epoch_sync",
               "trainer.step", "trainer.rotation", "model.forward", "model.vertex",
               "model.facet_features", "model.facet", "model.loss", "model.backward",
               "optimizer.step")
EVAL_SPANS = ("trainer.evaluate", "trainer.eval_begin", "trainer.eval_steps",
              "trainer.eval_sync")


def _pairs(seeds=(0, 1)):
    clean = synth.icosphere(2)
    return [(synth.add_noise(clean, 0.2, seed=s), clean) for s in seeds]


def _trainer(**cfg):
    cfg = Config(seed=0, **cfg)
    ds = dataset.InMemoryDataset(_pairs(), cfg.build_config(), submesh_size=200)
    ev = dataset.InMemoryDataset(_pairs((5,)), cfg.build_config(), submesh_size=200)
    return Trainer(cfg, ds, ev, device="cpu")


def _spans(prof) -> dict:
    """{name: [(start_us, end_us)]} of the profiler's events, in order."""
    out: dict = {}
    for e in prof.events():
        out.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    return out


def _inside(spans: dict, child: str, parent: str) -> bool:
    """Whether every `child` span lies within some `parent` span."""
    return all(any(ps <= cs and ce <= pe for ps, pe in spans[parent])
               for cs, ce in spans[child])


@pytest.mark.parametrize("preload", [True, False], ids=["preloaded", "streamed"])
def test_an_epoch_and_an_eval_pass_record_their_spans(preload):
    tr = _trainer(preload=preload)
    rng = np.random.default_rng(0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert tracing.on()
        tr.run_epoch(rng)
        tr.evaluate()
    assert not tracing.on()
    spans = _spans(prof)
    # streamed, the samples are padded on the prefetch worker, a thread the
    # profiler does not record: the loop's wait for them is recorded instead
    names = TRAIN_SPANS + EVAL_SPANS + (("data.get",) if preload else ("prefetch.wait",))
    missing = [n for n in names if n not in spans]
    assert not missing, missing
    n_steps = len(tr.train_ds)
    assert len(spans["trainer.step"]) == n_steps and len(spans["trainer.epoch"]) == 1
    assert len(spans["model.forward"]) == n_steps + len(tr.eval_ds)
    for child, parent in [("trainer.epoch_begin", "trainer.epoch"),
                          ("trainer.steps", "trainer.epoch"),
                          ("trainer.epoch_sync", "trainer.epoch"),
                          ("trainer.step", "trainer.steps"),
                          ("trainer.rotation", "trainer.step"),
                          ("model.vertex", "model.forward"),
                          ("model.facet_features", "model.forward"),
                          ("model.facet", "model.forward"),
                          ("model.loss", "trainer.step"),
                          ("model.backward", "trainer.step"),
                          ("optimizer.step", "trainer.step"),
                          ("trainer.eval_begin", "trainer.evaluate"),
                          ("trainer.eval_steps", "trainer.evaluate"),
                          ("trainer.eval_sync", "trainer.evaluate")]:
        assert _inside(spans, child, parent), (child, parent)
    # the model's spans: the steps' inside trainer.step, the eval pass's inside its loop
    steps = {"trainer.step": spans["trainer.step"]}
    evals = {"trainer.eval_steps": spans["trainer.eval_steps"]}
    fwd = spans["model.forward"]
    assert all(_inside({**steps, "f": [f]}, "f", "trainer.step")
               or _inside({**evals, "f": [f]}, "f", "trainer.eval_steps") for f in fwd)
    assert sum(_inside({**steps, "f": [f]}, "f", "trainer.step") for f in fwd) == n_steps
    loops = {**spans, "loops": spans["trainer.steps"] + spans["trainer.eval_steps"]}
    assert _inside(loops, "data.get" if preload else "prefetch.wait", "loops")
    assert tracing.counters() == {}  # eager on the CPU: no graph, no stage events


def test_no_span_is_entered_and_nothing_counted_without_a_profiler(monkeypatch):
    def refuse(name, *args, **kwargs):
        raise AssertionError(f"record_function({name!r}) entered with no profiler recording")

    tr = _trainer()
    tracing.reset()
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not tracing.on()
    assert tracing.span("x") is tracing.span("y")  # one shared null context
    tr.run_epoch(np.random.default_rng(0))
    tr.evaluate()
    tracing.count("graph.runs")
    assert tracing.counters() == {}


def test_trace_writes_the_counters_beside_the_trace_from_zero(tmp_path):
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        tracing.count("graph.runs", 5)  # before: left out by the reset
    assert tracing.counters() == {"graph.runs": 5}
    with profiling.trace(str(tmp_path)):
        tracing.count("graph.runs")
        tracing.count("graph.input_bytes", 128)
        with tracing.span("trainer.step"):
            torch.ones(3).sum()
    tracing.count("graph.runs", 7)  # after: no profiler, not counted
    with open(os.path.join(tmp_path, "counters.json")) as f:
        assert json.load(f) == {"graph.input_bytes": 128, "graph.runs": 1}
    with open(os.path.join(tmp_path, "trace.json")) as f:
        names = {ev.get("name") for ev in json.load(f)["traceEvents"]}
    assert "trainer.step" in names
    tracing.reset()
    assert tracing.counters() == {}


def test_the_host_build_records_its_spans():
    cfg = Config()
    noisy, clean = _pairs((3,))[0]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        entries = dataset.process_one_mesh(noisy, 200, clean, cfg.build_config())
        dataset.InMemoryDataset(_pairs((3,)), cfg.build_config(), submesh_size=200)
    spans = _spans(prof)
    assert len(entries) > 1
    assert len(spans["build.mesh"]) == 2 and len(spans["build.plan"]) == 1
    assert len(spans["build.raw"]) == 2 * len(entries)
    for child, parent in [("build.split", "build.mesh"), ("build.raw", "build.mesh"),
                          ("build.rcm", "build.raw"), ("build.graphs", "build.raw"),
                          ("build.hierarchy", "build.raw")]:
        assert _inside(spans, child, parent), (child, parent)
    assert len(spans["build.graphs"]) == len(spans["build.hierarchy"]) == 4 * len(entries)


def test_a_served_mesh_records_its_spans():
    from geobignn_tpu_torch.infer.predict import Predictor

    tr = _trainer()
    pred = Predictor(tr.cfg, tr.model.state_dict(), sub_size=200, device="cpu")
    noisy = _pairs((4,))[0][0]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pred.denoise(noisy, n_update_iters=2)
    spans = _spans(prof)
    for child, parent in [("predict.host_build", "predict.mesh"),
                          ("predict.forward", "predict.mesh"),
                          ("predict.stitch", "predict.mesh"),
                          ("build.mesh", "predict.host_build"),
                          ("model.forward", "predict.forward")]:
        assert _inside(spans, child, parent), (child, parent)
    assert len(spans["predict.update"]) == 1 and len(spans["predict.mesh"]) == 1
    assert len(spans["predict.forward"]) > 1  # one a patch


def test_the_probe_splits_idle_time_by_the_innermost_span():
    """examples/trace_step.idle_by_span on a synthetic window: device busy
    10-30 and 50-60 of 0-100; a step 5-80 holding a copy 20-40 and a
    replay 40-55."""
    from geobignn_tpu_torch.examples.trace_step import idle_by_span

    spans = [("trainer.step", 5.0, 80.0), ("graph.copy_inputs", 20.0, 40.0),
             ("graph.replay", 40.0, 55.0)]
    idle = idle_by_span([(10.0, 30.0), (50.0, 60.0), (12.0, 14.0)], spans, (0.0, 100.0))
    assert idle == {"outside": 5.0 + 20.0, "trainer.step": 5.0 + 20.0,
                    "graph.copy_inputs": 10.0, "graph.replay": 10.0}
    assert sum(idle.values()) == 100.0 - 20.0 - 10.0
