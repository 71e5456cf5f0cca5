"""The generator gives every seed the same work in its own order."""

import collections
import itertools

import numpy as np
import pytest

from portbench import generator

OPEN = {"op": "x", "loop": "open", "arrivals": "poisson", "rate_per_s": 400,
        "shapes": [[1, 1], [1, 2], [2, 1], [4, 4]]}
CLOSED = {"op": "x", "loop": "closed", "shapes": [[5, 7], [3, 9], [2, 2]], "sets": 2}


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 2**40 + 3])
def test_open_schedule_is_seed_invariant(seed):
    ref = generator.open_schedule(OPEN, 1, 2.5)
    got = generator.open_schedule(OPEN, seed, 2.5)
    assert len(got.due) == len(ref.due) == 1000
    assert np.all(np.diff(got.due) >= 0)
    assert got.due[-1] == pytest.approx(2.5)
    assert np.allclose(np.sort(np.diff(got.due, prepend=0.0)),
                       np.sort(np.diff(ref.due, prepend=0.0)))
    assert collections.Counter(got.shape.tolist()) == {0: 250, 1: 250, 2: 250, 3: 250}
    if seed != 1:
        assert not np.array_equal(got.shape, ref.shape)


def test_open_schedule_rate_and_gaps():
    s = generator.open_schedule(OPEN, 3, 10.0, rate=1000)
    gaps = np.diff(s.due, prepend=0.0)
    assert len(gaps) == 10000
    assert gaps.mean() == pytest.approx(1e-3)
    # exponential gaps: the coefficient of variation is about 1
    assert gaps.std() / gaps.mean() == pytest.approx(1.0, abs=0.05)


def test_bursts_keep_the_mean_and_the_count():
    mix = {**OPEN, "bursts": {"period_s": 1.0, "on_share": 0.25, "factor": 3.0}}
    s = generator.open_schedule(mix, 5, 8.0)
    steady = generator.open_schedule(OPEN, 5, 8.0)
    assert len(s.due) == len(steady.due)
    assert np.all(np.diff(s.due) >= 0) and s.due[-1] <= 8.0 + 1e-9
    phase = np.mod(s.due, 1.0)
    on = np.mean(phase < 0.25)
    assert on == pytest.approx(0.75, abs=0.05)  # a quarter of the time holds 3/4


def test_bursts_reject_a_profile_without_room():
    mix = {**OPEN, "bursts": {"period_s": 1.0, "on_share": 0.5, "factor": 3.0}}
    with pytest.raises(ValueError):
        generator.open_schedule(mix, 5, 2.0)


@pytest.mark.parametrize("seed", [0, 11, 2**33])
def test_closed_items_cycle_every_pair(seed):
    items = generator.closed_items(CLOSED, seed)
    cycle = list(itertools.product(range(3), range(2)))
    seen = [next(items) for _ in range(4 * len(cycle))]
    for c in range(4):
        assert sorted(seen[c * 6:(c + 1) * 6]) == cycle


def test_closed_order_depends_on_the_seed():
    a = list(itertools.islice(generator.closed_items(CLOSED, 1), 24))
    b = list(itertools.islice(generator.closed_items(CLOSED, 2), 24))
    assert sorted(a) == sorted(b) and a != b
