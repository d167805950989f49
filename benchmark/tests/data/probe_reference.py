"""A reference module named by a configuration file (probe_patch.json):
the plain model of reference/model.py, each call counted and the watch's
records kept, so that a test sees the harness reach the module that the
configuration names and hand it `choices`."""

from __future__ import annotations

import collections

from reference import model as base

CALLS: collections.Counter = collections.Counter()
CHOICES: list = []


def param_shapes(widths: dict) -> dict:
    CALLS["param_shapes"] += 1
    return base.param_shapes(widths)


def precision_of(conf: dict):
    CALLS["precision_of"] += 1
    return base.precision_of(conf)


def train_steps(weights, samples, rot_seeds, widths, lr, device, prec, choices=None):
    CALLS["train_steps"] += 1
    CHOICES.append(choices)
    return base.train_steps(weights, samples, rot_seeds, widths, lr, device, prec)


def eval_means(weights, samples, widths, device, prec, choices=None):
    CALLS["eval_means"] += 1
    CHOICES.append(choices)
    return base.eval_means(weights, samples, widths, device, prec)
