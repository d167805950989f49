"""The readings the limits of `correct` are set from, on the chip.

    python3 benchmark/control.py --workload patch.train --seeds 1-12 \
        --variants program,control,half_batch

For every seed and variant, one set-up and one pass of the cell (no timed
window) judged as a run judges it, with every compared number printed as a
JSON line.  Variants:

  program  the program as the configuration states it;
  control  the program with the Config overrides of the configuration
           file's "control" key, by default {"precision": "bfloat16"}:
           its own path at the precision below float32 activations;
  <fault>  the program with a fault of yardstick/faults.py planted.

The host builds of a seed are made once and reused by its variants.
"""

import argparse
import json
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


DEFAULT_CONTROL = {"precision": "bfloat16"}


def variants(name: str, conf: dict) -> dict:
    """The run's `variant` for the configuration file `conf`; a control
    that the port's Config refuses fails here, before any run."""
    from yardstick import faults, session

    if name == "program":
        return {}
    if name == "control":
        over = conf.get("control", DEFAULT_CONTROL)
        try:
            session.program_config(conf, over).validate()
        except (TypeError, ValueError) as e:
            raise ValueError(f"configuration {conf['name']}: its control {over} "
                             f"is refused: {e}") from e
        return {"config": over}
    return {"plant": faults.FAULTS[name]}


def seeds_of(text: str) -> list:
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi) + 1)) if hi else [int(lo)]
    return out


def readings(cell, seeds, names, device, log=print, workers=None):
    """[{seed, variant, numbers..., correct}] of every seed and variant."""
    from yardstick import session

    chosen = {name: variants(name, cell.config) for name in names}
    out = []
    for seed in seeds:
        cache: dict = {}
        for name in names:
            t = time.perf_counter()
            res = session.run(cell, seed, 0.0, False, device, variant=chosen[name],
                              cache=cache, workers=workers, log=lambda *a, **k: None)
            row = dict(seed=seed, variant=name, correct=res["correct"],
                       seconds=round(time.perf_counter() - t, 1), **res["numbers"])
            log(json.dumps(row), flush=True)
            out.append(row)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="e.g. 1-12 or 3,5,8")
    ap.add_argument("--variants", default="program")
    args = ap.parse_args(argv)
    for p in (ROOT, BENCH_DIR):
        sys.path.insert(0, p)
    import torch

    from yardstick import cells

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    cell = cells.load(args.workload, ROOT)
    readings(cell, seeds_of(args.seeds), args.variants.split(","), "cuda")
    return 0


if __name__ == "__main__":
    sys.exit(main())
