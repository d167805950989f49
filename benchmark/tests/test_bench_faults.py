"""A run with the timed path broken underneath comes out not correct.

Each cell's committed configuration and limits, on the tiny traffic of
tests/data (the cells' own corpora are the card's work), with each fault
the cell can have planted in the program: a step that leaves its state
unchanged and half of the nodes left out of the losses' mean (training);
an answer altered where it is produced and half of the nodes left out
(eval); an epoch or pass that takes one sample twice and leaves one out
(both).  The look for a chip is skipped; the rest of a run is driven."""

import copy
import os

import pytest
import torch

from yardstick import cells, faults, session

ROOT = os.path.dirname(cells.BENCH_DIR)


def _cell(workload, mode):
    cell = copy.deepcopy(cells.load(workload, ROOT))
    cell.config["config"]["granularity"] = 8
    cell.traffic = cells.read_json(cells.BENCH_DIR + f"/tests/data/tiny_{mode}.json")
    return cell


@pytest.mark.parametrize("workload, mode, fault", [
    ("patch.train", "train", "state_unchanged"),
    ("patch.train", "train", "half_batch"),
    ("whole.train", "train", "state_unchanged"),
    ("whole.train", "train", "half_batch"),
    ("patch.eval", "eval", "answer_altered"),
    ("patch.eval", "eval", "half_batch"),
    ("patch.train", "train", "repeated_sample"),
    ("whole.train", "train", "repeated_sample"),
    ("patch.eval", "eval", "repeated_sample"),
])
def test_a_fault_makes_the_run_not_correct(workload, mode, fault):
    torch.manual_seed(0)
    res = session.run(_cell(workload, mode), 2 ** 31 + 5, 0.0, False, "cpu", workers=1,
                      variant={"plant": faults.FAULTS[fault]}, log=lambda *a, **k: None)
    assert not res["correct"], res["checks"]
