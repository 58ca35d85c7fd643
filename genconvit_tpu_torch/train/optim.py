"""Optimizer (port of genconvit_tpu/train/optim.py): torch's Adam with the
reference's settings and the StepLR schedule.

The reference uses Adam(lr=1e-4, weight_decay=1e-4) (ref train.py:50-54):
L2 decay added to the gradient before the moments (not AdamW), b1 0.9, b2
0.999, eps 1e-8, and StepLR(step_size=15, gamma=0.1) stepped per epoch (ref
train.py:59). BatchNorm running statistics are buffers, outside the
optimizer: that is the JAX package's decay mask (optim.py:20-27), and they
are written from the batch statistics after each step instead.

optax updates every leaf, so a parameter whose gradient is zero still moves
by its decay; torch's Adam skips a parameter whose `.grad` is None. Without
the KL term the VAE's `var` head gets no gradient at all, so the train step
fills missing gradients with zeros (`fill_missing_grads`) before each step.
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch

BETAS = (0.9, 0.999)
EPS = 1e-8


def step_lr(base_lr: float, step_size: int = 15, gamma: float = 0.1) -> Callable[[int], float]:
    """torch StepLR as a function of the epoch."""

    def lr(epoch: int) -> float:
        return base_lr * (gamma ** (epoch // step_size))

    return lr


def make_optimizer(params: Iterable[torch.nn.Parameter], learning_rate: float,
                   weight_decay: float) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=learning_rate, betas=BETAS, eps=EPS,
                            weight_decay=weight_decay)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """The per-epoch StepLR value (set_lr of the JAX package)."""
    for group in optimizer.param_groups:
        group["lr"] = lr


def fill_missing_grads(optimizer: torch.optim.Optimizer) -> None:
    """A zero gradient for every parameter that has none, so that the step
    applies its decay and its moments as optax's does."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
