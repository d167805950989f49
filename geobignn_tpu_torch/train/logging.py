"""Observability: JSONL metric stream + TensorBoard events + stdout tee.

Copy of geobignn_tpu/train/logging.py (pure Python).  Replaces tensorboardX
scalars + Print_Logger (code/train_dual.py:21-32, 134-136, 222-226).
Metrics go to `{run_dir}/metrics.jsonl`, one record per event; the same
scalars stream to TensorBoard event files under `{run_dir}/tb/{split}`
(train/tb_writer.py, a copy of the JAX package's pure-Python writer);
stdout is teed to `training_info.txt`."""

from __future__ import annotations

import json
import os
import sys
import time


class Tee:
    def __init__(self, path: str):
        self.terminal = sys.stdout
        self.log = open(path, "a")

    def write(self, msg: str):
        self.terminal.write(msg)
        self.log.write(msg)

    def flush(self):
        self.terminal.flush()
        self.log.flush()


class MetricLogger:
    def __init__(self, path: str, tensorboard: bool = True):
        self.f = open(path, "a")
        self.t0 = time.time()
        # one event dir per split, like the reference's train/test writers
        self._tb_root = (
            os.path.join(os.path.dirname(path), "tb") if tensorboard else None
        )
        self._tb: dict = {}

    def _tb_writer(self, split: str):
        if self._tb_root is None:
            return None
        if split not in self._tb:
            from geobignn_tpu_torch.train.tb_writer import EventWriter

            self._tb[split] = EventWriter(os.path.join(self._tb_root, split))
        return self._tb[split]

    def log(self, split: str, epoch: int, step: int | None = None, **metrics):
        rec = {
            "t": round(time.time() - self.t0, 3),
            "split": split,
            "epoch": epoch,
        }
        if step is not None:
            rec["step"] = step
        rec.update({k: float(v) for k, v in metrics.items()})
        self.f.write(json.dumps(rec) + "\n")
        self.f.flush()
        w = self._tb_writer(split)
        if w is not None:
            w.add_scalars(
                {k: float(v) for k, v in metrics.items()},
                step if step is not None else epoch,
            )

    def close(self):
        self.f.close()
        for w in self._tb.values():
            w.close()
