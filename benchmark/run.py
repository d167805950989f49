"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell, its configuration, traffic,
limits and metrics are found by name (BENCHMARK.json, benchmark/configs,
traffic, limits, metrics).  With --trace 0 the result carries the cell's
end-to-end metrics, with --trace 1 its per-layer metrics.  The last line of
standard output is one JSON object; the compared numbers and their limits
are the last lines of standard error and the last key of that object.
The run exits with 2 and prints no result without enough CUDA devices, and
with 3 if a module of JAX or of the JAX package is loaded at the end.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


def _environment():
    """Caches inside the checkout; no library may load JAX on its own."""
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(ROOT, "build", "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "triton"))
    os.environ["USE_FLAX"] = "0"
    for p in (ROOT, BENCH_DIR):
        if p not in sys.path:
            sys.path.insert(0, p)


def _fmt(v):
    return v if isinstance(v, (int, float)) else str(v)


def result_line(cell, res: dict, trace: bool, device_name: str, count: int) -> dict:
    from yardstick.cells import reader

    ctx = dict(mode=res["mode"], spans=res["spans"], counters=res["counters"],
               trace=res["trace"])
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": device_name, "count": count,
              "memory_peak_bytes": int(res["memory_peak"])}
    out = {"correct": bool(res["correct"]), "attempted": int(res["counters"]["passes"]),
           "failed": 0, "metrics": metrics, "device": device}
    tr = res["trace"]
    if trace and tr is not None:
        device["busy_s"] = tr.busy_s()
        device["window_s"] = tr.window_s
        out["breakdown"] = {"device_ops": tr.top_ops(10), "idle_gaps": tr.idle_gaps(10)}
    out["card"] = res["power"]
    out["checks"] = {k: [_fmt(v), lim] for k, (v, lim) in res["checks"].items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()

    import torch

    from yardstick import cells, imports

    cell = cells.load(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2

    from yardstick import session

    res = session.run(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                      t_start=T_START, log=print)
    line = result_line(cell, res, bool(args.trace), torch.cuda.get_device_name(0), cell.chips)
    bad = imports.forbidden_loaded()
    if bad:
        print(f"loaded at the end of the run, and not allowed: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    print(f"[card] {res['power']}", file=sys.stderr)
    print(f"[spans] {json.dumps(res['spans'])}", file=sys.stderr)
    print(f"[numbers] {json.dumps({k: _fmt(v) for k, v in res['numbers'].items()})}",
          file=sys.stderr)
    print(f"[correct] {line['correct']}", file=sys.stderr)
    for k, (v, lim) in line["checks"].items():
        print(f"check {k} {v} limit {lim}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
