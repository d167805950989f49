"""Optimizers with optax's update rules, and epoch-keyed learning-rate policies.

Counterpart of geobignn_tpu/train/optim.py (reference code/train_dual.py:
162-180): adam / sgd / rmsprop, and five policies stepped per epoch:
  lmd        lr * decay^(epoch / step0)        (the shipped default)
  step       lr * decay^(epoch // step0)
  multi_step lr * decay^(#milestones <= epoch)
  exp        lr * decay^epoch
  auto       reduce-on-plateau (factor=decay, patience=step0) keyed on the
             eval normal error

The JAX package builds `optax.inject_hyperparams(optax.adam | sgd |
rmsprop)`, chained after `optax.add_decayed_weights(weight_decay)` (an L2
term added to the gradient before the optimizer, not AdamW).  The same
rules here:
  * `torch.optim.Adam` is optax.adam (bias-corrected moments, eps outside
    the square root), and its `weight_decay` adds wd * p to the gradient;
  * `torch.optim.SGD(momentum, dampening=0)` is optax.sgd (trace
    t = g + momentum t, update -lr t), with the same L2 term;
  * optax.rmsprop differs from `torch.optim.RMSprop` (eps inside the square
    root: g / sqrt(nu + eps), and decay 0.9 where torch defaults alpha to
    0.99), so `RMSprop` below writes optax's rule out.
The trainer computes the learning rate on the host each epoch and writes it
into every parameter group (`set_lr`), as the JAX trainer writes it into
the injected hyperparameters.  On the card Adam is `capturable` and its
learning rate a float32 tensor on the device, so that the trainer's CUDA
graph of the step (train/trainer.py) reads the rate `set_lr` wrote last:
a Python float would be baked into the graph at its capture.
"""

from __future__ import annotations

import dataclasses

import torch


class RMSprop(torch.optim.Optimizer):
    """optax.rmsprop(learning_rate, decay) with optax's defaults (eps 1e-8
    inside the square root, initial nu 0, no momentum, not centered):
        nu = decay nu + (1 - decay) g^2 ;  p -= lr g / sqrt(nu + eps)
    with g += weight_decay * p first (optax.add_decayed_weights)."""

    def __init__(self, params, lr: float, decay: float = 0.9, eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if group["weight_decay"]:
                    g = g.add(p, alpha=group["weight_decay"])
                state = self.state[p]
                if "nu" not in state:
                    state["nu"] = torch.zeros_like(p)
                nu = state["nu"]
                nu.mul_(group["decay"]).addcmul_(g, g, value=1.0 - group["decay"])
                p.addcdiv_(g, torch.sqrt(nu + group["eps"]), value=-group["lr"])


def make_optimizer(cfg, params) -> torch.optim.Optimizer:
    params = list(params)
    wd = cfg.weight_decay or 0.0
    if cfg.optimizer == "adam":
        on_card = params[0].is_cuda
        lr = (torch.tensor(cfg.lr, dtype=torch.float32, device=params[0].device)
              if on_card else cfg.lr)
        return torch.optim.Adam(params, lr=lr, betas=(cfg.beta1, cfg.beta2),
                                eps=1e-8, weight_decay=wd, capturable=on_card)
    if cfg.optimizer == "sgd":
        return torch.optim.SGD(params, lr=cfg.lr, momentum=cfg.momentum,
                               dampening=0.0, weight_decay=wd)
    if cfg.optimizer == "rmsprop":
        return RMSprop(params, lr=cfg.lr, decay=0.9, weight_decay=wd)
    raise ValueError(f"unknown optimizer {cfg.optimizer}")


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> torch.optim.Optimizer:
    """Write the learning rate into every parameter group: into its tensor
    in place where the group holds one (a captured step reads it there)."""
    for group in optimizer.param_groups:
        if torch.is_tensor(group["lr"]):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr
    return optimizer


def get_lr(optimizer: torch.optim.Optimizer) -> float:
    """The first parameter group's learning rate, as a float."""
    return float(optimizer.param_groups[0]["lr"])


def load_state(optimizer: torch.optim.Optimizer, state_dict: dict) -> None:
    """optimizer.load_state_dict, keeping what belongs to this device: the
    `capturable` flag, its step counts on the parameters' device, and the
    learning rate's tensor, into which the saved rate is written (a saved
    group holds it as a float or an array)."""
    kept = [(g.get("capturable"), g["lr"]) for g in optimizer.param_groups]
    optimizer.load_state_dict(state_dict)
    for group, (capturable, lr) in zip(optimizer.param_groups, kept):
        saved = float(group["lr"])
        group["lr"] = lr.fill_(saved) if torch.is_tensor(lr) else saved
        if capturable is not None:
            group["capturable"] = capturable
        for p in group["params"] if capturable else ():
            st = optimizer.state.get(p, {})
            if "step" in st:
                st["step"] = st["step"].to(dtype=torch.float32, device=p.device)


def lr_at_epoch(cfg, epoch: int) -> float:
    if cfg.lr_sch == "lmd":
        return cfg.lr * cfg.lr_decay ** (epoch / cfg.lr_step[0])
    if cfg.lr_sch == "step":
        return cfg.lr * cfg.lr_decay ** (epoch // cfg.lr_step[0])
    if cfg.lr_sch == "multi_step":
        return cfg.lr * cfg.lr_decay ** sum(1 for m in cfg.lr_step if m <= epoch)
    if cfg.lr_sch == "exp":
        return cfg.lr * cfg.lr_decay**epoch
    if cfg.lr_sch == "auto":
        raise ValueError("'auto' lr is driven by PlateauState, not epoch")
    raise ValueError(f"unknown lr_sch {cfg.lr_sch}")


@dataclasses.dataclass
class PlateauState:
    """Reduce-on-plateau: shrink lr by `factor` after `patience` epochs
    without improvement (torch ReduceLROnPlateau semantics, default
    rel-threshold 1e-4)."""

    lr: float
    factor: float
    patience: int
    best: float = float("inf")
    bad_epochs: int = 0
    threshold: float = 1e-4

    def step(self, metric: float) -> float:
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.lr *= self.factor
                self.bad_epochs = 0
        return self.lr
