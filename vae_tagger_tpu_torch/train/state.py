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
reference's torch optimizer does: under the simplified loss the VAE
decoder gets no gradient (its ``.grad`` stays None; gradients are cleared
with ``set_to_none``), so the decay the JAX package applies to its
untrained tensors does not happen here.

Under data parallelism (parallel/mesh.py) the update first averages the
gradients over the processes: one all-reduce of a flat bucket of every
gradient that is not None, once per update (after k micro-steps of
accumulation), before the clip, so the clip and AdamW see the global
batch's gradient, as the JAX package's SPMD step does.  Wrapping the
modules in DDP is avoided on purpose: a tensor that gets no gradient
keeps ``.grad`` None (DDP's ``find_unused_parameters`` would fill it
with zeros, and AdamW would then decay it), the state-dict keys carry no
``module.`` prefix, and the autograd Functions of the kernels stay as
they are.  DDP's overlap of the all-reduce with the backward is left for
when a multi-GPU measurement asks for it.  While a profiler runs, that
average is the span ``steps.grad_allreduce`` (utils/profiling.py).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import torch

from ..parallel.mesh import all_reduce_mean_
from ..utils.profiling import span
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
        with span("steps.grad_allreduce"):
            all_reduce_mean_(grads)
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
    count, the models -- the VAE (None in train_decoder, whose frozen VAE
    lives in its steps), the tagger head ``decoder`` (None in train_vae;
    its BatchNorm running statistics are buffers) and the adaptive loss
    weights (None unless trained) -- and the optimizer with its schedule
    position."""

    vae: Optional[torch.nn.Module]
    decoder: Optional[torch.nn.Module]
    optimizer: Optimizer
    step: int = 0
    adaptive: Optional[torch.nn.Module] = None

    def _modules(self) -> dict:
        return {k: m for k, m in (("vae", self.vae),
                                  ("decoder", self.decoder),
                                  ("adaptive", self.adaptive))
                if m is not None}

    def state_dict(self) -> dict:
        return {"step": self.step,
                **{k: m.state_dict() for k, m in self._modules().items()},
                "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.step = int(state["step"])
        for k, m in self._modules().items():
            m.load_state_dict(state[k])
        self.optimizer.load_state_dict(state["optimizer"])
