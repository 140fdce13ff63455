"""The seeded generator: the same seed gives the same stack, a rank's
block is the whole stack's rows, and the draws depend on the seed."""

from __future__ import annotations

import numpy as np
import torch

from conftest import BIG_SEED

import gen


def make(seed, start, stop):
    tmpl = torch.as_tensor(gen.templates(3, 32))
    return gen.stack(tmpl, seed, start, stop, "cpu")


def test_same_seed_same_stack():
    assert torch.equal(make(BIG_SEED, 0, 300), make(BIG_SEED, 0, 300))


def test_a_block_is_the_whole_stacks_rows():
    whole = make(BIG_SEED, 0, gen.BLOCK + 200)
    part = make(BIG_SEED, gen.BLOCK - 50, gen.BLOCK + 120)
    assert torch.equal(part, whole[gen.BLOCK - 50:gen.BLOCK + 120])


def test_seeds_differ():
    a, b = make(BIG_SEED, 0, 256), make(BIG_SEED + 1, 0, 256)
    assert not torch.equal(a, b)
    assert 1.0 < float(a.std()) < 1.6


def test_templates_are_normalised_and_distinct():
    t = gen.templates(8, 90)
    assert np.allclose(t.mean((1, 2)), 0, atol=1e-5)
    assert np.allclose(t.std((1, 2)), 1, atol=1e-4)
    assert len({round(float(x), 3) for x in t[:, 45, 60]}) == 8


def test_sample_is_seeded_sorted_and_distinct():
    s = gen.sample(BIG_SEED, 105247, 2048)
    assert len(np.unique(s)) == 2048 and np.all(np.diff(s) > 0)
    assert np.array_equal(s, gen.sample(BIG_SEED, 105247, 2048))
    assert not np.array_equal(s, gen.sample(BIG_SEED + 1, 105247, 2048))
