"""Learning-rate schedules (the port's copy of
``vae_tagger_tpu/train/schedule.py``).

The diffusers ``get_scheduler`` names the reference passes
(``--lr_scheduler_type``, default "cosine" with ``--lr_warmup_steps`` 500)
map to the same shapes as the JAX package's optax schedules: linear warmup
0 -> lr over ``warmup_steps``, then the named decay to 0 over the remaining
steps.  A schedule is a plain function of the optimizer step (the count of
applied updates), evaluated in float64 on the host.
"""

from __future__ import annotations

import math
from typing import Callable

Schedule = Callable[[int], float]


def _linear(init: float, end: float, steps: int) -> Schedule:
    """optax.linear_schedule: init held fixed when ``steps`` <= 0."""
    if steps <= 0:
        return lambda count: init

    def f(count):
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end

    return f


def _cosine(init: float, decay_steps: int) -> Schedule:
    """optax.cosine_decay_schedule with alpha 0, exponent 1."""
    def f(count):
        count = min(count, decay_steps)
        return init * 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))

    return f


def _join(first: Schedule, then: Schedule, boundary: int) -> Schedule:
    """optax.join_schedules of two: ``then(count - boundary)`` from
    ``boundary`` on."""
    return lambda count: first(count) if count < boundary else then(
        count - boundary)


def build_lr_schedule(name: str, learning_rate: float, warmup_steps: int,
                      total_steps: int) -> Schedule:
    total_steps = max(total_steps, warmup_steps + 1)
    decay_steps = max(1, total_steps - warmup_steps)
    warmup = _linear(0.0, learning_rate, warmup_steps)

    if name == "constant":
        return lambda count: learning_rate
    if name == "constant_with_warmup":
        return _join(warmup, lambda count: learning_rate, warmup_steps)
    if name in ("linear", "polynomial"):
        # polynomial is power 1.0, the same line
        return _join(warmup, _linear(learning_rate, 0.0, decay_steps),
                     warmup_steps)
    if name in ("cosine", "cosine_with_restarts"):
        # one restart cycle, as the diffusers default num_cycles=1
        return _join(warmup, _cosine(learning_rate, decay_steps),
                     warmup_steps)
    raise ValueError(f"unknown lr scheduler: {name!r}")
