"""The harness finds every cell's files by name; the readers read nothing
where there is nothing."""

import json
import os

import pytest

from yardstick import cells, imports
from yardstick.trace import Trace

ROOT = os.path.dirname(cells.BENCH_DIR)
SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
# metrics that read only what a CUDA graph does: its calls, its input
# copies and the stage stamps inside a captured step
GRAPH_ONLY = ("graph_run_us", "input_copies", "fwd_ms", "bwd_ms", "opt_ms")


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_cell_files_found(workload):
    cell = cells.load(workload, ROOT)
    assert cell.config["name"] == next(w["config"] for w in SPEC["workloads"]
                                       if w["name"] == workload)
    assert cell.traffic["mode"] in ("train", "eval")
    assert cell.limits["host_mismatch"] == 0
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(cells.reader(m["name"]))


def test_every_metric_has_a_reader():
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert callable(cells.reader(m["name"])), m["name"]


def test_config_files_match_their_entries():
    for c in SPEC["configs"]:
        conf = cells.read_json(os.path.join(ROOT, c["file"]))
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"]
        assert conf["source"].startswith("https://github.com/zhangyk18/GeoBi-GNN")


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_readers_return_nothing_without_a_reading(mode):
    ctx = dict(mode=mode, spans={"setup_s": 1.0, "window_s": 2.0},
               counters={"faces": 10, "useful_flops": 0, "padded_faces": 20},
               trace=Trace([], [], (0.0, 1e6)))
    for m in SPEC["per_layer"]:
        if m["name"].startswith(("agg_roofline_pct.", "idle_pct.", "step_ms.")):
            assert cells.reader(m["name"])(ctx) is None


def test_shared_readers_are_found_by_the_name_before_the_dot():
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        own = os.path.join(cells.BENCH_DIR, "metrics", m["name"] + ".py")
        base = os.path.join(cells.BENCH_DIR, "metrics", m["name"].split(".")[0] + ".py")
        assert os.path.exists(own) or os.path.exists(base), m["name"]


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
@pytest.mark.parametrize("trace", [False, True])
def test_a_result_line_carries_the_cells_metrics(workload, trace):
    """A whole run on the CPU, on tiny traffic, turned into the result line
    run.py prints: every end-to-end metric of the cell, and every per-layer
    metric that needs neither a device trace nor a CUDA graph, is there."""
    import copy

    import torch

    import run
    from yardstick import session

    torch.manual_seed(0)
    cell = copy.deepcopy(cells.load(workload, ROOT))
    cell.config["config"]["granularity"] = 8
    mode = cell.traffic["mode"]
    cell.traffic = cells.read_json(cells.BENCH_DIR + f"/tests/data/tiny_{mode}.json")
    res = session.run(cell, 2 ** 31 + 3, 0.0, trace, "cpu", workers=1,
                      log=lambda *a, **k: None)
    line = run.result_line(cell, res, trace, "cpu", 1)
    assert json.loads(json.dumps(line)) == line
    assert list(line)[-1] == "checks" and line["correct"]
    want = [m["name"] for m in (cell.per_layer if trace else cell.end_to_end)
            if m["source"] != "device_trace" and m["name"].split(".")[0] not in GRAPH_ONLY]
    assert want and all(name in line["metrics"] for name in want), (want, line["metrics"])
    for m in line["metrics"].values():
        assert m["value"] > 0


@pytest.mark.parametrize("names, found", [
    (["geobignn_tpu_torch", "geobignn_tpu_torch.ops", "torch", "numpy"], []),
    (["geobignn_tpu", "geobignn_tpu.ops.banded"], ["geobignn_tpu"]),
    (["jax", "jax._src.core", "jaxlib.xla_client"], ["jax", "jaxlib"]),
    (["flax.linen", "optax", "jaxtyping"], ["flax", "optax"]),
])
def test_import_check_compares_whole_top_level_names(names, found):
    assert imports.forbidden_loaded(names) == found


def reference_files() -> list:
    """Every module under reference/, and every module that a configuration
    file names as its reference (the cells' and the tests' own)."""
    import glob

    out = set(glob.glob(os.path.join(cells.BENCH_DIR, "reference", "*.py")))
    for path in glob.glob(os.path.join(cells.BENCH_DIR, "**", "*.json"), recursive=True):
        conf = cells.read_json(path)
        if isinstance(conf, dict) and "reference" in conf:
            out.add(os.path.join(ROOT, conf["reference"]))
    return sorted(out)


def test_reference_imports_nothing_of_the_program():
    import ast

    files = reference_files()
    assert os.path.join(cells.BENCH_DIR, "reference", "model.py") in files
    assert os.path.join(cells.BENCH_DIR, "tests", "data", "probe_reference.py") in files
    for name in files:
        tree = ast.parse(open(name).read())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                    else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for mod in mods:
                assert mod.split(".")[0] not in ("geobignn_tpu_torch", "geobignn_tpu", "jax",
                                                 "flax", "yardstick.session"), (name, mod)
                assert mod not in ("yardstick.session",), (name, mod)
