"""A reference that is wrong on purpose: reference/model.py with the
losses of its training steps 1% high.  A run judged by it is not correct."""

from __future__ import annotations

from reference import model as base

param_shapes = base.param_shapes
precision_of = base.precision_of
eval_means = base.eval_means


def train_steps(weights, samples, rot_seeds, widths, lr, device, prec, choices=None):
    losses, grads, params, out = base.train_steps(weights, samples, rot_seeds, widths, lr,
                                                  device, prec)
    return [v * 1.01 for v in losses], grads, params, out
