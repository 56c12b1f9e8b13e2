"""The seeded inputs: the same seed gives the same inputs, another seed
other inputs of the same sizes and counts."""

from __future__ import annotations

import numpy as np
import pytest

from bench_port import inputs

SEEDS = (3, 2 ** 31 + 12345, 987654321987)


@pytest.mark.parametrize("seed", SEEDS)
def test_banks_repeat_for_a_seed_and_differ_across(seed):
    a = inputs.image_bank(seed, 3, 40, 56)
    assert a.shape == (3, 40, 56, 3) and a.dtype == np.uint8
    assert np.array_equal(a, inputs.image_bank(seed, 3, 40, 56))
    assert not np.array_equal(a, inputs.image_bank(seed + 1, 3, 40, 56))
    labels = inputs.label_bank(seed, 5, 30)
    assert np.array_equal(labels, inputs.label_bank(seed, 5, 30))
    assert (labels.sum(1) == 12).all()


def test_samples_are_distinct_and_seeded():
    s = inputs.sample(5, 64, 16)
    assert s == inputs.sample(5, 64, 16) and len(set(s)) == 16
    assert s != inputs.sample(6, 64, 16)
