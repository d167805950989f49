"""Find a cell's files by the names in BENCHMARK.json.

A cell names a configuration (`configs/<config>.json`) and a traffic mix
(`traffic/<traffic>.json`); its limits are `limits/<cell>.json`; each
metric is read by `metrics/<metric>.py`, a module with `read(ctx)` that
returns a number or None.  Adding a cell or a metric is adding files and
entries: no file here names one.  A metric measured alike in several
kinds of cell (`idle_pct.patch`, `idle_pct.eval`) may share one reader,
`metrics/<name before the first dot>.py`, where it has no file of its own.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration file
    traffic: dict  # the traffic file
    limits: dict  # {number: limit}
    end_to_end: list  # BENCHMARK.json entries this cell reports
    per_layer: list


def read_json(path: str):
    with open(path) as f:
        return json.load(f)


def load(workload: str, root: str) -> Cell:
    spec = read_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    conf = next(c for c in spec["configs"] if c["name"] == w["config"])
    e2e = [m for m in spec["end_to_end"] if workload in m.get("workloads", [workload])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if workload in m.get("workloads", [workload]) and m["moves"] in reported]
    return Cell(
        name=workload, chips=int(w["chips"]),
        config=read_json(os.path.join(root, conf["file"])),
        traffic=read_json(os.path.join(BENCH_DIR, "traffic", w["traffic"] + ".json")),
        limits=read_json(os.path.join(BENCH_DIR, "limits", workload + ".json")),
        end_to_end=e2e, per_layer=per_layer)


def reader(metric: str):
    """The `read` function of metrics/<metric>.py, or else of the shared
    metrics/<base>.py."""
    path = os.path.join(BENCH_DIR, "metrics", metric + ".py")
    if not os.path.exists(path):
        path = os.path.join(BENCH_DIR, "metrics", metric.split(".")[0] + ".py")
    mod_spec = importlib.util.spec_from_file_location("bench_metric_" + metric.replace(".", "_"),
                                                      path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read
