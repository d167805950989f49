"""A watch named by a configuration file (probe_patch.json): it logs the
harness's before(k) and after(k) calls and records, after each judged call,
a reading of the program's state (the norm of its parameters), as a watch
of a model that makes discrete choices in its forward records them."""

from __future__ import annotations

import torch

EVENTS: list = []


class Watch:
    def __init__(self, trainer):
        self.trainer = trainer
        self.kept: list = []

    def before(self, k: int) -> None:
        EVENTS.append(("before", k))

    def after(self, k: int) -> None:
        EVENTS.append(("after", k))
        with torch.no_grad():
            norm = torch.sqrt(sum(p.detach().float().square().sum()
                                  for p in self.trainer.model.parameters()))
        self.kept.append({"k": k, "param_norm": float(norm)})

    def records(self) -> list:
        return self.kept


def watch(trainer) -> Watch:
    return Watch(trainer)
