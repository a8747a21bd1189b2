"""The plain reference against a brute-force enumerator, on seeded random
databases, on the CPU."""
from collections import Counter
from itertools import combinations

import numpy as np
import pytest

from fimbench import reference


def brute_force(rows, min_count):
    """Count every subset of every row (rows are small here)."""
    counts = Counter()
    for row in rows:
        items = sorted({int(i) for i in row if i >= 0})
        for k in range(1, len(items) + 1):
            counts.update(combinations(items, k))
    return {s: c for s, c in counts.items() if c >= min_count}


def random_rows(seed, n_rows, n_items, width, pad_share=0.3):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n_items, size=(n_rows, width)).astype(np.int32)
    rows[rng.random((n_rows, width)) < pad_share] = -1  # padding anywhere, repeats kept
    return rows


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("min_count", [1, 3, 9])
def test_reference_equals_brute_force(seed, min_count):
    rows = random_rows(seed, n_rows=60, n_items=9, width=7)
    assert reference.mine(rows, 9, min_count) == brute_force(rows, min_count)


@pytest.mark.parametrize("seed", range(3))
def test_reference_on_dense_correlated_rows(seed):
    """Rows near copies of two templates, so that long itemsets are frequent."""
    rng = np.random.default_rng(100 + seed)
    templates = rng.choice(12, size=(2, 8), replace=True)
    rows = templates[rng.integers(0, 2, 80)]
    rows = np.where(rng.random(rows.shape) < 0.2, rng.integers(0, 12, rows.shape), rows)
    rows = rows.astype(np.int32)
    for min_count in (10, 25):
        assert reference.mine(rows, 12, min_count) == brute_force(rows, min_count)


def test_reference_edge_cases():
    empty = np.full((5, 3), -1, np.int32)
    assert reference.mine(empty, 4, 1) == {}
    one = np.array([[2, -1], [2, 2], [-1, -1]], np.int32)
    assert reference.mine(one, 3, 2) == {(2,): 2}
    assert reference.mine(one, 3, 3) == {}
    with pytest.raises(ValueError):
        reference.mine(np.array([[5]], np.int32), 5, 1)


def test_bitsets_cross_a_word_boundary():
    rows = random_rows(7, n_rows=200, n_items=6, width=4, pad_share=0.5)
    assert reference.mine(rows, 6, 15) == brute_force(rows, 15)


def test_min_count_reads_the_decimal():
    assert reference.min_count_of(0.01, 990002) == 9901
    assert reference.min_count_of(0.0125, 990002) == 12376
    assert reference.min_count_of(0.25, 10) == 3  # ceil, not floor
    assert reference.min_count_of(0.3, 10) == 3  # 0.3 * 10 is 3, not 3.0000000000000004
    assert reference.min_count_of(0.15, 8124) == 1219
    assert reference.min_count_of(1e-9, 10) == 1


def test_at_threshold_filters():
    found = {(1,): 5, (2,): 3, (1, 2): 2}
    assert reference.at_threshold(found, 3) == {(1,): 5, (2,): 3}
