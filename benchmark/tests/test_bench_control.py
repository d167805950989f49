"""The control comes out not correct against each cell's committed limits;
the program beside it comes out correct.

The control is the program with the Config overrides of the
configuration file's "control" key; without one (as in every cell here),
its own path at the precision below the configuration's float32
activations, Config(precision="bfloat16"): on the card at the cells' own
sizes,

    python -m pytest benchmark/tests/test_bench_control.py -m cuda

and on the CPU on the tiny traffic of tests/data.  There the eval means
average a few hundred faces, and the angle error's arccos near 1 turns a
last-bit change of a normal into a larger one of the mean: the program's
eval_gap reads up to 1.1e-5 on those meshes (1.5e-6 at the cell's size),
so the tiny run holds it to TINY_EVAL_GAP, under the control's 8.8e-5 there."""

import copy
import os

import pytest
import torch

import control
from yardstick import cells, session

ROOT = os.path.dirname(cells.BENCH_DIR)
TINY_EVAL_GAP = 3e-5


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["patch.train", "whole.train", "patch.eval"])
def test_control_fails_and_program_passes(card, workload):
    cell = cells.load(workload, ROOT)
    rows = control.readings(cell, [2 ** 31 + 101], ["program", "control"], card,
                            log=lambda *a, **k: None)
    by = {r["variant"]: r for r in rows}
    assert by["program"]["correct"], by["program"]
    assert not by["control"]["correct"], by["control"]


@pytest.mark.parametrize("workload, mode", [("patch.train", "train"),
                                            ("whole.train", "train"),
                                            ("patch.eval", "eval")])
def test_control_fails_and_program_passes_on_tiny_meshes(workload, mode):
    torch.manual_seed(0)
    cell = copy.deepcopy(cells.load(workload, ROOT))
    cell.config["config"]["granularity"] = 8
    cell.traffic = cells.read_json(cells.BENCH_DIR + f"/tests/data/tiny_{mode}.json")
    if "eval_gap" in cell.limits:
        cell.limits["eval_gap"] = TINY_EVAL_GAP
    rows = control.readings(cell, [2 ** 31 + 7], ["program", "control"], "cpu",
                            log=lambda *a, **k: None, workers=1)
    by = {r["variant"]: r for r in rows}
    assert by["program"]["correct"], by["program"]
    assert not by["control"]["correct"], by["control"]


def test_the_control_comes_from_the_configuration_file():
    conf = cells.load("patch.train", ROOT).config
    assert "control" not in conf
    assert control.variants("control", conf) == {"config": {"precision": "bfloat16"}}
    own = dict(conf, control={"fc_precision": "float32"})
    assert control.variants("control", own) == {"config": {"fc_precision": "float32"}}


@pytest.mark.parametrize("overrides", [None, {"no_such_field": 1}])
def test_a_control_the_config_refuses_fails_at_once(overrides):
    """Dynamic pooling runs in float32 only, so the default control is
    refused there; so is a field the Config does not have.  Either fails
    before any run, naming the configuration."""
    conf = copy.deepcopy(cells.load("patch.train", ROOT).config)
    conf["name"] = "dynamic_probe"
    conf["config"]["edge_weight_type"] = 4
    if overrides is not None:
        conf["config"]["edge_weight_type"] = 10
        conf["control"] = overrides
    cell = cells.Cell("dynamic_probe.train", 1, conf, {}, {}, [], [])
    with pytest.raises(ValueError, match="dynamic_probe"):
        control.readings(cell, [1], ["program", "control"], "cpu", log=lambda *a, **k: None)
    session.program_config(conf).validate()  # the program itself is accepted
