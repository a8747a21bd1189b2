"""The benchmark's surrogate generator: deterministic by seed, and shaped as
the configuration states, on the CPU."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from fimbench import data

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def dataset(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())["dataset"]


@pytest.mark.parametrize("seed", [5, 2**31 + 17])
def test_same_seed_same_rows_other_seed_differs(seed):
    ds = dataset("kosarak")
    a = data.generate("kosarak", ds, seed, n_tx=5000)
    b = data.generate("kosarak", ds, seed, n_tx=5000)
    c = data.generate("kosarak", ds, seed + 1, n_tx=5000)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)


def test_shapes_and_item_ranges_match_the_spec():
    ds = dataset("kosarak")
    rows = data.generate("kosarak", ds, 5, n_tx=60000)
    assert rows.dtype == np.int32 and rows.shape == (60000, ds["max_len"])
    valid = rows >= 0
    assert rows[~valid].tolist() == [data.PAD] * int((~valid).sum())
    assert rows[valid].max() < ds["n_items"]
    # items ascending and distinct within a row, padding a suffix
    key = np.where(valid, rows, np.iinfo(np.int32).max).astype(np.int64)
    assert (np.diff(key, axis=1)[valid[:, 1:]] > 0).all()
    assert not (~valid[:, :-1] & valid[:, 1:]).any()
    lens = valid.sum(axis=1)
    assert lens.min() >= 1 and lens.max() == ds["max_len"]
    # the rows' mean length, as distinct items after the cap, is the source's
    assert abs(lens.mean() - ds["avg_len"]) < 0.05


@pytest.mark.parametrize("mean,cap", [(8.1, 48), (2.0, 4), (30.0, 256)])
def test_geometric_p_gives_the_capped_mean(mean, cap):
    p = data.geometric_p(mean, cap)
    assert (1 - (1 - p) ** cap) / p == pytest.approx(mean, rel=1e-12)


def test_distinct_prefix_takes_the_first_distinct_items_in_draw_order():
    draws = torch.tensor([[5, 5, 3, 5, 9, 3, 1], [2, 2, 2, 2, 2, 2, 2], [4, 1, 4, 7, 8, 9, 6]])
    keep = data.distinct_prefix(draws, torch.tensor([3, 2, 4]))
    assert draws[0][keep[0]].tolist() == [5, 3, 9]
    assert draws[1][keep[1]].tolist() == [2]  # the row holds one distinct item
    assert draws[2][keep[2]].tolist() == [4, 1, 7, 8]


def test_sparse_items_are_power_law_ordered():
    """Zipf's law puts the lowest ids first: item 0 in about 78% of rows,
    item 1 in about 58%."""
    ds = dataset("kosarak")
    rows = data.generate("kosarak", ds, 3, n_tx=50000)
    share = np.bincount(rows[rows >= 0], minlength=ds["n_items"]) / len(rows)
    assert 0.75 < share[0] < 0.81 and 0.55 < share[1] < 0.61
    assert (np.diff(share[:6]) < 0).all()
