"""Inputs made from the seed with NumPy: image banks, labels and samples
of them.  The same seed gives the same inputs; every seed gives the same
sizes and counts, with other pixels."""

from __future__ import annotations

import numpy as np

# generator streams of one seed
BANK, LABELS, CHECK = 0, 1, 3


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & (2 ** 64 - 1), stream])


def image_bank(seed: int, count: int, height: int, width: int,
               stream: int = BANK) -> np.ndarray:
    """(count, height, width, 3) uint8, photo-like: a smooth field (a coarse
    random grid, upsampled by repetition and blended along rows) plus
    pixel noise."""
    g = rng(seed, stream)
    cell = 32
    coarse = g.integers(0, 256, (count, -(-height // cell) + 1,
                                 -(-width // cell) + 1, 3), dtype=np.int16)
    # bilinear-ish: average each coarse cell with its neighbour below/right
    smooth = (coarse[:, :-1, :-1] + coarse[:, 1:, :-1] + coarse[:, :-1, 1:]
              + coarse[:, 1:, 1:]) // 4
    field = np.repeat(np.repeat(smooth, cell, axis=1), cell, axis=2)
    field = field[:, :height, :width]
    noise = g.integers(-24, 25, field.shape, dtype=np.int16)
    return np.clip(field + noise, 0, 255).astype(np.uint8)


def label_bank(seed: int, count: int, num_tags: int, per_image: int = 12,
               stream: int = LABELS) -> np.ndarray:
    """(count, num_tags) float32 multi-hot labels, ``per_image`` tags each."""
    g = rng(seed, stream)
    out = np.zeros((count, num_tags), np.float32)
    for row in out:
        row[g.choice(num_tags, per_image, replace=False)] = 1.0
    return out


def sample(seed: int, population: int, k: int, stream: int = CHECK):
    """``k`` distinct indices of ``range(population)`` drawn from the seed,
    sorted."""
    return sorted(int(i) for i in rng(seed, stream).choice(
        population, min(k, population), replace=False))
