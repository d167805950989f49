"""Find a cell's files by the names in BENCHMARK.json.

A cell names a configuration (`configs/<config>.json`) and a traffic mix
(`traffic/<traffic>.json`); its limits are `limits/<cell>.json`; each
metric is read by `metrics/<metric>.py`, a module with `read(ctx)` that
returns a number or None.  Adding a cell or a metric is adding files and
entries: no file here names one.  A metric measured alike in several
kinds of cell (`idle_pct.patch`, `idle_pct.eval`) may share one reader,
`metrics/<name before the first dot>.py`, where it has no file of its own.
A configuration file may name the modules that judge it (`reference`,
`work`, `watch`: yardstick/session.py); they are loaded by path too.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import re
import sys

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


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


def load_module(path: str):
    """The module in the file `path` (from the root of the checkout, under
    benchmark/), loaded once a process."""
    full = os.path.realpath(os.path.join(ROOT, path))
    if not full.startswith(os.path.realpath(BENCH_DIR) + os.sep) or not full.endswith(".py"):
        raise ValueError(f"{path!r} is not a Python file under benchmark/")
    name = "bench_" + re.sub(r"\W", "_", os.path.relpath(full, os.path.realpath(ROOT)))
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, full)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[name]
            raise
    return sys.modules[name]


def reader(metric: str):
    """The `read` function of metrics/<metric>.py, or else of the shared
    metrics/<base>.py."""
    path = os.path.join(BENCH_DIR, "metrics", metric + ".py")
    if not os.path.exists(path):
        path = os.path.join(BENCH_DIR, "metrics", metric.split(".")[0] + ".py")
    return load_module(os.path.relpath(path, ROOT)).read
