"""A configuration file names the code that judges it.

probe_patch.json (tests/data) is geobi_patch with `reference`, `work` and
`watch` naming probe modules beside it that wrap the defaults and count
their calls: added as files alone, it is judged through them, and a run
reads the same numbers and work counts, digit for digit, as the cell's own
configuration at the same seed.  A probe reference that is wrong on purpose
makes the run not correct.  On the CPU, on the tiny traffic of tests/data,
with torch on one thread (its CPU sums are bit-repeatable only there)."""

import copy
import json
import os

import pytest
import torch

from yardstick import cells, session

ROOT = os.path.dirname(cells.BENCH_DIR)
DATA = os.path.join("benchmark", "tests", "data")
HOOKS = ("name", "reference", "work", "watch")


def _cell(workload, conf):
    cell = copy.deepcopy(cells.load(workload, ROOT))
    cell.config = copy.deepcopy(conf)
    cell.config["config"]["granularity"] = 8
    cell.traffic = cells.read_json(os.path.join(ROOT, DATA, f"tiny_{cell.traffic['mode']}.json"))
    return cell


def _run(cell):
    torch.manual_seed(0)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return session.run(cell, 2 ** 31 + 13, 0.0, True, "cpu", workers=1,
                           log=lambda *a, **k: None)
    finally:
        torch.set_num_threads(threads)


def _probes():
    return [cells.load_module(os.path.join(DATA, f"probe_{n}.py"))
            for n in ("reference", "work", "watch")]


def test_the_probe_configuration_is_geobi_patch_with_its_own_judges():
    probe = cells.read_json(os.path.join(ROOT, DATA, "probe_patch.json"))
    own = cells.load("patch.train", ROOT).config
    assert {k: v for k, v in probe.items() if k not in HOOKS} == \
        {k: v for k, v in own.items() if k not in HOOKS}
    assert own["reference"] == session.DEFAULT_REFERENCE and "work" not in own
    ref, counts, watch_of = session.judged_by(probe)
    assert ref is _probes()[0] and counts is _probes()[1] and watch_of is _probes()[2].watch


@pytest.mark.parametrize("workload", ["patch.train", "patch.eval"])
def test_the_named_modules_judge_and_the_numbers_match(workload):
    ref, counts, watch = _probes()
    for counter in (ref.CALLS, counts.CALLS):
        counter.clear()
    ref.CHOICES.clear()
    watch.EVENTS.clear()
    probe = cells.read_json(os.path.join(ROOT, DATA, "probe_patch.json"))
    own = _run(_cell(workload, cells.load(workload, ROOT).config))
    assert not ref.CALLS and not counts.CALLS and not watch.EVENTS
    res = _run(_cell(workload, probe))

    train = workload.endswith(".train")
    n = 3  # samples of the tiny traffic: judged steps, or calls of the set-up pass
    assert ref.CALLS == {"param_shapes": 1, "precision_of": 1,
                         ("train_steps" if train else "eval_means"): 1}
    assert counts.CALLS == {"step_useful_flops": n, "step_aggregate_bound_s": n}
    assert watch.EVENTS == [(when, k) for k in range(1, n + 1) for when in ("before", "after")]
    (choices,) = ref.CHOICES
    assert [c["k"] for c in choices] == [1, 2, 3]
    assert all(c["param_norm"] > 0 for c in choices)
    if train:  # each step moves the parameters
        assert len({c["param_norm"] for c in choices}) == 3

    assert json.dumps(res["numbers"], sort_keys=True) == \
        json.dumps(own["numbers"], sort_keys=True)
    for k in ("useful_flops", "traced_agg_bound_s", "faces", "steps"):
        assert res["counters"][k] == own["counters"][k], k
    assert res["correct"] == own["correct"]


def test_a_wrong_reference_makes_the_run_not_correct():
    probe = cells.read_json(os.path.join(ROOT, DATA, "probe_patch.json"))
    res = _run(_cell("patch.train", probe))
    assert res["correct"], res["checks"]
    wrong = dict(probe, reference=os.path.join(DATA, "probe_reference_fault.py"))
    res = _run(_cell("patch.train", wrong))
    assert not res["correct"], res["checks"]
    assert res["numbers"]["first_loss_gap"] > 5e-3, res["numbers"]


def test_a_module_outside_the_benchmark_is_refused():
    for path in ("geobignn_tpu_torch/config.py", "benchmark/../README.md",
                 "benchmark/tests/data/tiny_train.json"):
        with pytest.raises(ValueError, match="under benchmark/"):
            cells.load_module(path)
    with pytest.raises(ValueError, match="<path>:<function>"):
        session.judged_by(dict(cells.load("patch.train", ROOT).config,
                               watch=os.path.join(DATA, "probe_watch.py")))
