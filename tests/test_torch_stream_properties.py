"""Property tests of the port's streaming layer against the reference's:
for random transaction databases split into 1-4 batches (empty ones
included), the port's ``StreamingMiner`` answers exactly like the
reference's (itemsets, every segment's payload, ``SegmentedDB`` counts and
``C``; tolerance: none) and like the whole-database oracle; and per-segment
supports are additive under the port's oracle as under the reference's.
Cases of ``test_stream_properties.py``."""
import itertools

import numpy as np
import pytest

pytest.importorskip("hypothesis", reason="property tests need hypothesis")
from hypothesis import given, settings, strategies as st

import repro.mining as jm
import repro_torch.mining as tm
from repro.core.encoding import pad_transactions
from repro.core.oracle import mine_bruteforce as ref_bruteforce
from repro_torch.core.oracle import mine_bruteforce
from test_torch_stream import Twin

N_ITEMS = 6
SPEC = dict(algorithm="hprepost", min_sup=None, min_count=2, max_k=3, candidate_unit=8, nlist_width=16)
_names = itertools.count()


@st.composite
def db_and_partition(draw):
    """A small transaction DB plus a partition of its rows into 1-4
    disjoint segments (possibly empty — empty map partitions are legal)."""
    n_rows = draw(st.integers(1, 16))
    tx = [
        draw(st.lists(st.integers(0, N_ITEMS - 1), min_size=0, max_size=4))
        for _ in range(n_rows)
    ]
    n_parts = draw(st.integers(1, 4))
    assign = [draw(st.integers(0, n_parts - 1)) for _ in range(n_rows)]
    return tx, assign, n_parts


def _pad(tx):
    return pad_transactions(tx, max_len=4) if tx else np.empty((0, 4), np.int32)


@pytest.fixture(scope="module")
def engines():
    return jm.MiningEngine(), tm.MiningEngine(device="cpu")


@settings(max_examples=25, deadline=None)
@given(db_and_partition())
def test_per_segment_supports_are_additive(case):
    tx, assign, n_parts = case
    full = mine_bruteforce(_pad(tx), N_ITEMS, 1, max_k=3)
    assert full == ref_bruteforce(_pad(tx), N_ITEMS, 1, max_k=3)
    parts = [mine_bruteforce(_pad([t for t, a in zip(tx, assign) if a == p]), N_ITEMS, 1,
                             max_k=3) for p in range(n_parts)]
    for itemset, support in full.items():
        assert support == sum(p.get(itemset, 0) for p in parts)
    for p in parts:
        assert set(p) <= set(full)


@settings(max_examples=15, deadline=None)
@given(case=db_and_partition())
def test_streaming_miner_matches_the_reference_and_the_whole_db(engines, case):
    tx, assign, n_parts = case
    rows = _pad(tx)
    tw = Twin(engines, f"prop-{next(_names)}", create=N_ITEMS, **SPEC)
    for p in range(n_parts):
        tw.append(_pad([t for t, a in zip(tx, assign) if a == p]), N_ITEMS)
    res = tw.query()
    tw.check()
    assert res.n_rows == len(rows)
    assert res.itemsets == mine_bruteforce(rows, N_ITEMS, 2, max_k=3)
