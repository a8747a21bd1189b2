"""Property tests of the port's continuous mining against the reference's:
random append / expire / compact interleavings over a sliding window keep,
at every step, the port equal to the reference (itemsets, ``SegmentedDB``
counts and ``C``, every segment's payload, the standing query's
``MineDiff`` sequence; tolerance: none), the windowed answer equal to the
oracle over exactly the retained rows, and the diff stream replaying to
the delivered answer. Cases of ``test_continuous_properties.py``."""
import itertools

import numpy as np
import pytest

pytest.importorskip("hypothesis", reason="property tests need hypothesis")
from hypothesis import given, settings, strategies as st

import repro.mining as jm
import repro_torch.mining as tm
from repro.core.encoding import PAD, pad_transactions
from repro_torch.core.oracle import mine_bruteforce
from repro_torch.mining.continuous import replay_diffs
from test_torch_continuous import _standing, assert_same_diffs
from test_torch_stream import Twin

N_ITEMS = 6
SPEC = dict(algorithm="hprepost", min_sup=None, min_count=2, max_k=3, candidate_unit=8, nlist_width=32)
_names = itertools.count()


@st.composite
def interleaving(draw):
    """2-6 ops: each an append of 1-8 random short transactions, possibly
    followed by a forced compaction pass."""
    n_ops = draw(st.integers(2, 6))
    ops = []
    for _ in range(n_ops):
        n_rows = draw(st.integers(1, 8))
        tx = [
            draw(st.lists(st.integers(0, N_ITEMS - 1), min_size=0, max_size=4))
            for _ in range(n_rows)
        ]
        ops.append((tx, draw(st.booleans())))
    window = draw(st.integers(4, 20))
    return ops, window


def _pad(tx):
    return pad_transactions(tx, max_len=4) if tx else np.empty((0, 4), np.int32)


@pytest.fixture(scope="module")
def engines():
    return jm.MiningEngine(), tm.MiningEngine(device="cpu")


@settings(max_examples=12, deadline=None)
@given(case=interleaving())
def test_windowed_interleavings_match_the_reference(engines, case):
    ops, window = case
    tw = Twin(engines, f"prop-{next(_names)}", create=N_ITEMS,
              stream_spec=dict(window_rows=window, max_segments=3, compact_fanin=2), **SPEC)
    jq, tq = _standing(tw)
    for tx, force_compact in ops:
        tw.append(_pad(tx), N_ITEMS)
        if force_compact and len(tw.stream()[1].db.segments) > 1:
            for s in tw.stream():
                s.compact()
        ts = tw.check()
        res = tw.query()
        rows = np.concatenate([s.rows for s in ts.db.segments] or [np.empty((0, 4), np.int32)])
        empty_rows = sum(n for _, n in ts._empty_trail)
        assert res.n_rows == sum(s.n_rows for s in ts.db.segments) + empty_rows
        assert res.itemsets == mine_bruteforce(rows[(rows != PAD).any(axis=1)], N_ITEMS, 2,
                                               max_k=3)
        assert_same_diffs(tq, jq)
        assert replay_diffs(tq.diffs) == tq.latest
    assert replay_diffs(tq.diffs) == tq.latest == tw.query().itemsets
