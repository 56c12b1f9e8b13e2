"""Seeded weights, made on the device in a few large draws.

The names and shapes come from the plain reference's modules (the
configuration's VAE family's reference VAE and the tagger head's
``state_dict`` layout), built on the meta device so that nothing is
allocated for them.  Every tensor of one kind is cut from one draw of a
``torch.Generator`` on the device:

- conv and linear weights: normal, std 1 / sqrt(fan_in) (lecun normal);
- norm scales (GroupNorm, LayerNorm, BatchNorm; a family's own, such as
  an RMS norm's ``gamma``): 1 + 0.1 * normal;
- biases and norm shifts: 0.05 * normal;
- BatchNorm running statistics: mean 0.1 * normal, variance 0.5 + uniform.

Scales and biases are not left at (1, 0), so a program that dropped one
would not agree with the reference by accident.  The same seed gives the
same weights; the program and the reference are given the same tensors.
A leaf's kind and a matrix's fan-in are ``leaf_kind`` and ``fan_in``
below, unless the family gives its own ``weight_kind`` or
``weight_fan_in``.
"""

from __future__ import annotations

import math

import torch

_KINDS = ("matrix", "scale", "shift", "running_mean", "running_var")


def leaf_kind(name: str, shape) -> str | None:
    """The kind of the leaf ``name`` (None: not drawn, set to 0): a
    ``weight`` of two or more dimensions is a matrix, one of one a scale."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "num_batches_tracked":
        return None
    if leaf in ("running_mean", "running_var"):
        return leaf
    if leaf == "weight":
        return "matrix" if len(shape) >= 2 else "scale"
    return "shift"


def fan_in(name: str, shape) -> int:
    """A matrix's fan-in: the product of every dimension but the first."""
    return math.prod(shape[1:])


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one stream of one seed (any whole
    number up to 2**64 - 1; larger ones are folded)."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 0x9E3779B97F4A7C15 + stream) % (2 ** 64 - 1))
    return g


def make(shapes: dict, seed: int, device, stream: int = 0,
         family=None) -> dict:
    """{name: fp32 tensor on ``device``} for ``shapes`` ({name: shape},
    sorted by name so that the draw does not depend on dict order), each
    leaf of the kind ``family`` (a VAE family's module) gives it."""
    kind_of = getattr(family, "weight_kind", leaf_kind)
    fan_in_of = getattr(family, "weight_fan_in", fan_in)
    names = sorted(shapes)
    kinds = {n: kind_of(n, shapes[n]) for n in names}
    g = generator(seed, stream, device)
    out = {}
    for kind in _KINDS:
        members = [n for n in names if kinds[n] == kind]
        if not members:
            continue
        sizes = [math.prod(shapes[n]) for n in members]
        draw = (torch.rand if kind == "running_var" else torch.randn)(
            sum(sizes), generator=g, device=device, dtype=torch.float32)
        for n, part in zip(members, draw.split(sizes)):
            t = part.view(shapes[n])
            if kind == "matrix":
                t = t / math.sqrt(fan_in_of(n, shapes[n]))
            elif kind == "scale":
                t = 1.0 + 0.1 * t
            elif kind == "shift":
                t = 0.05 * t
            elif kind == "running_mean":
                t = 0.1 * t
            else:
                t = 0.5 + t
            out[n] = t
    for n in names:
        if kinds[n] is None:
            out[n] = torch.zeros(shapes[n], dtype=torch.long, device=device)
    return out
