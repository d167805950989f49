"""Faults planted in the program, for the check that `correct` catches them.

Each takes the trainer once it is made (before any step or pass, so that a
captured graph holds the fault) and returns a function that undoes it.

  state_unchanged  the optimizer's step does nothing;
  half_batch       the losses' mean is taken over the first half of the
                   real nodes, the rest left out;
  answer_altered   the eval pass's angle error is produced 1% high;
  repeated_sample  an epoch or pass takes its first sample again in place
                   of its last.
"""

from __future__ import annotations

import torch


def state_unchanged(trainer):
    trainer.optimizer.step = lambda *a, **k: None
    return lambda: trainer.optimizer.__dict__.pop("step", None)


def _patch(module, name, fn):
    old = getattr(module, name)
    setattr(module, name, fn(old))
    return lambda: setattr(module, name, old)


def half_batch(trainer):
    from geobignn_tpu_torch.models import losses

    def make(old):
        def masked_mean(per_node, mask):
            half = mask * (torch.cumsum(mask, 0) <= mask.sum() / 2).to(mask.dtype)
            return old(per_node, half)
        return masked_mean
    return _patch(losses, "masked_mean", make)


def answer_altered(trainer):
    from geobignn_tpu_torch.models import losses

    return _patch(losses, "error_n", lambda old: lambda *a: old(*a) * 1.01)


def repeated_sample(trainer):
    old = trainer._samples

    def samples(ds, tag, order):
        order = [int(i) for i in order]
        return old(ds, tag, order[:-1] + order[:1] if len(order) > 1 else order)
    trainer._samples = samples
    return lambda: vars(trainer).pop("_samples", None)


FAULTS = {f.__name__: f for f in (state_unchanged, half_batch, answer_altered,
                                  repeated_sample)}
