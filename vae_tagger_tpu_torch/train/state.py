"""Optimizer and train state (the port's counterpart of
``vae_tagger_tpu/train/state.py``).

The JAX package's optax chain ``clip_by_global_norm -> adamw(schedule)
[-> MultiSteps]`` becomes :class:`Optimizer`: ``clip_grad_norm_`` over all
trained parameters, then ``torch.optim.AdamW`` (betas 0.9/0.999, eps 1e-8,
decoupled weight decay) at the schedule's rate for the current optimizer
step.  With gradient accumulation over k micro-steps the gradients
(summed by ``backward``) are averaged and the update and the schedule
advance once per k, as ``optax.MultiSteps`` does.

Unlike optax, AdamW skips a parameter whose ``.grad`` is None, as the
reference's torch optimizer does: the port trains only the parameters it
holds (the encoder and the head), so the decay the JAX package applies to
the VAE decoder's untrained tensors does not happen here.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import torch

from .schedule import Schedule


class Optimizer:
    """clip -> AdamW(schedule), stepped once per ``accumulation_steps``
    micro-steps; call :meth:`step` after every ``backward``."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 schedule: Schedule, weight_decay: float = 1e-6,
                 max_grad_norm: float = 1.0, accumulation_steps: int = 1):
        self.params = [p for p in params if p.requires_grad]
        self.schedule = schedule
        self.max_grad_norm = max_grad_norm
        self.accumulation_steps = max(1, int(accumulation_steps))
        self.adamw = torch.optim.AdamW(self.params, lr=schedule(0),
                                       betas=(0.9, 0.999), eps=1e-8,
                                       weight_decay=weight_decay)
        self.count = 0   # applied updates: the schedule's step
        self.micro = 0   # micro-steps since the last update

    def step(self) -> bool:
        """Count one micro-step; on the k-th, apply the averaged update and
        clear the gradients.  Returns whether an update was applied."""
        self.micro += 1
        if self.micro < self.accumulation_steps:
            return False
        grads = [p.grad for p in self.params if p.grad is not None]
        if self.accumulation_steps > 1:
            torch._foreach_div_(grads, float(self.accumulation_steps))
        if self.max_grad_norm and self.max_grad_norm > 0:
            torch.nn.utils.clip_grad_norm_(self.params, self.max_grad_norm)
        for group in self.adamw.param_groups:
            group["lr"] = self.schedule(self.count)
        self.adamw.step()
        self.adamw.zero_grad(set_to_none=True)
        self.count += 1
        self.micro = 0
        return True

    def state_dict(self) -> dict:
        return {"adamw": self.adamw.state_dict(), "count": self.count,
                "micro": self.micro}

    def load_state_dict(self, state: dict) -> None:
        self.adamw.load_state_dict(state["adamw"])
        self.count = int(state["count"])
        self.micro = int(state["micro"])


def build_optimizer(params, schedule: Schedule, weight_decay: float = 1e-6,
                    max_grad_norm: float = 1.0,
                    gradient_accumulation_steps: int = 1) -> Optimizer:
    return Optimizer(params, schedule, weight_decay, max_grad_norm,
                     gradient_accumulation_steps)


@dataclasses.dataclass
class TrainState:
    """What a training run carries from step to step: the micro-step
    count, the two models (the head's BatchNorm running statistics are
    buffers of ``decoder``) and the optimizer with its schedule position."""

    vae: torch.nn.Module
    decoder: torch.nn.Module
    optimizer: Optimizer
    step: int = 0

    def state_dict(self) -> dict:
        return {"step": self.step, "vae": self.vae.state_dict(),
                "decoder": self.decoder.state_dict(),
                "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.step = int(state["step"])
        self.vae.load_state_dict(state["vae"])
        self.decoder.load_state_dict(state["decoder"])
        self.optimizer.load_state_dict(state["optimizer"])
