"""A stream with a floor (``StreamSpec.min_sup_floor``), on the CPU: after
every append the stream's answer at each threshold at or above the floor
equals a plain mine of exactly the window's rows — ``fimbench/reference.py``
(NumPy) and the JAX package's one-shot mine — while its item law drifts
from batch to batch, so that items cross the floor both ways and segments
are prepared again. Segments hold only admitted items, ``C`` covers the
ranked items alone, and the stream's aggregates always equal the sums over
its live segments: after expiry of a segment prepared again, after
compaction, and under a standing query. A query below the floor, a floor
with decay and a floor on a distributed database raise."""
import numpy as np
import pytest

import repro.mining as jm
import repro_torch.mining as tm
from fimbench import reference
from repro_torch.mining.stream import StreamSpec

N_ITEMS = 48
MAX_LEN = 8


def drifting_batches(seed, n_batches, rows=64):
    """Batches whose item law rotates by five items a batch: a few planted
    patterns over the favoured items, plus Zipf noise, so that items cross
    a floor of a few percent in both directions."""
    rng = np.random.default_rng(seed)
    base = 1.0 / np.arange(1, N_ITEMS + 1) ** 1.2
    out = []
    for b in range(n_batches):
        pop = np.roll(base, 5 * b)
        pop /= pop.sum()
        hot = np.argsort(-pop)[:6]
        batch = np.full((rows, MAX_LEN), -1, np.int32)
        for r in range(rows):
            items = set()
            if rng.random() < 0.6:
                items |= set(rng.choice(hot, size=rng.integers(2, 5), replace=False).tolist())
            k = int(rng.integers(1, MAX_LEN - len(items) + 1))
            items |= set(rng.choice(N_ITEMS, size=k, replace=False, p=pop).tolist())
            items = sorted(items)[:MAX_LEN]
            batch[r, :len(items)] = items
        out.append(batch)
    return out


def open_stream(name, engine=None, spec=None, **stream_spec):
    engine = engine or tm.MiningEngine(device="cpu")
    engine.stream(name, n_items=N_ITEMS, spec=spec or tm.MineSpec(algorithm="hprepost"),
                  stream_spec=StreamSpec(**stream_spec))
    return engine


def query(engine, name, min_sup):
    return engine.submit_stream(tm.MineSpec(algorithm="hprepost", min_sup=min_sup), stream=name)


def assert_consistent(db):
    """The stream's aggregates are the sums over its live segments, every
    held item is ranked in its segment's order, and only ranked items
    are held."""
    counts = np.zeros(N_ITEMS, np.int64)
    C = np.zeros((db.n_ranked, db.n_ranked), np.int64)
    held = np.zeros(N_ITEMS, np.int64)
    for s in db.segments:
        counts += s.hist(N_ITEMS)
        held[s.local_items] += 1
        if s.prepared is not None:
            gr = db.rank_of[s.local_items]
            assert (gr >= 0).all() and (np.diff(gr) > 0).all()
            C[np.ix_(gr, gr)] += s.prepared.C
    np.testing.assert_array_equal(db.counts, counts)
    np.testing.assert_array_equal(db.held, held)
    np.testing.assert_array_equal(db.C, C)
    assert db.C.shape == (db.n_ranked, db.n_ranked)
    ranked = set(db.order)
    assert ranked == set(np.flatnonzero(db.admitted()).tolist()) | set(np.flatnonzero(held).tolist())
    assert sorted(db.rank_of[db.order].tolist()) == list(range(db.n_ranked))


def window_answer(rows, min_count):
    return reference.mine(np.concatenate(rows), N_ITEMS, min_count)


@pytest.fixture(scope="module")
def jax_engine():
    return jm.MiningEngine()


def jax_oneshot(engine, rows, min_count, pad_to):
    """The JAX package's one-shot mine of ``rows``, padded with all-padding
    rows (support-neutral) to ``pad_to`` so that it compiles one shape."""
    rows = np.concatenate(rows)
    padded = np.full((pad_to, MAX_LEN), -1, np.int32)
    padded[:len(rows)] = rows
    spec = jm.MineSpec(algorithm="hprepost", min_count=min_count, backend="jnp",
                       nlist_width=256)
    return engine.submit(padded, N_ITEMS, spec).itemsets


@pytest.mark.parametrize("floor,window", [(0.05, 3), (0.1, 4)])
def test_floored_window_is_exact_after_every_append(jax_engine, floor, window):
    batches = drifting_batches(11, 12)
    eng = open_stream("w", window_batches=window, min_sup_floor=floor)
    s = eng.stream("w")
    kept, widest = [], 0
    for i, b in enumerate(batches):
        eng.append(b, stream="w")
        kept = (kept + [b])[-window:]
        db = s.db
        # the newest segment was built with the items the window admits
        adm = db.admitted()
        assert adm[db.segments[-1].local_items].all()
        for k, min_sup in enumerate((floor, 0.15, 0.3)):
            res = query(eng, "w", min_sup)
            assert res.itemsets == window_answer(kept, res.min_count), (i, min_sup)
            widest = max(widest, max(map(len, res.itemsets)))
            if k == 0 and i % 3 == 2:
                assert res.itemsets == jax_oneshot(jax_engine, kept, res.min_count, 64 * window)
        # after a query every segment holds every admitted item of its rows
        assert not any(db.stale(seg, db.admitted()) for seg in db.segments)
        assert_consistent(db)
        assert db.n_ranked < len(np.flatnonzero(db.counts))
    assert widest >= 3
    assert s.stats["readmits"] > 0 and s.stats["expired_segments"] > 0


def test_expiry_after_a_readmission_is_exact():
    """A segment prepared again at a query, then expired: its new
    histogram and F2 matrix come out of the aggregates, not the ones it was
    first built with."""
    batches = drifting_batches(5, 6)
    eng = open_stream("e", window_batches=2, min_sup_floor=0.08)
    s = eng.stream("e")
    kept, readmitted = [], set()
    for b in batches:
        before = {seg.seg_id for seg in s.db.segments}
        eng.append(b, stream="e")
        kept = (kept + [b])[-2:]
        res = query(eng, "e", 0.08)
        assert res.itemsets == window_answer(kept, res.min_count)
        after = {seg.seg_id for seg in s.db.segments}
        readmitted |= after - before - {s.db.segments[-1].seg_id}
        assert_consistent(s.db)
    assert readmitted - {seg.seg_id for seg in s.db.segments}  # one of them expired


@pytest.mark.parametrize("compact_async", [False, True])
def test_compaction_with_a_floor(compact_async):
    """Merges are prepared over the admitted items; the answers stay those
    of every row appended."""
    batches = drifting_batches(7, 7)
    eng = open_stream("c", max_segments=3, compact_fanin=2, min_sup_floor=0.06,
                      compact_async=compact_async)
    s = eng.stream("c")
    for i, b in enumerate(batches):
        eng.append(b, stream="c")
        s.flush()
        res = query(eng, "c", 0.06)
        assert res.itemsets == window_answer(batches[:i + 1], res.min_count)
        assert_consistent(s.db)
    assert any(seg.n_batches > 1 for seg in s.db.segments)
    assert s.stats["compactions"] > 0 and s.stats["compact_errors"] == 0
    eng.stream("c").close()


def test_a_hollow_segment_is_prepared_once_its_items_are_admitted():
    """A batch none of whose items the floor admits keeps its rows but no
    tree; when a later batch lifts its items over the floor, the query
    prepares it before its first wave."""
    a = np.full((100, 3), -1, np.int32)
    a[:, :2] = [0, 1]
    b = np.full((5, 3), -1, np.int32)
    b[:] = [5, 6, 7]
    c = np.full((50, 3), -1, np.int32)
    c[:, :2] = [5, 6]
    eng = open_stream("h", min_sup_floor=0.2)
    s = eng.stream("h")
    eng.append(a, stream="h")
    assert eng.append(b, stream="h")["prep_source"] == "hollow"
    assert s.db.segments[1].prepared is None and s.db.segments[1].k == 0
    assert query(eng, "h", 0.2).itemsets == {(0,): 100, (1,): 100, (0, 1): 100}
    eng.append(c, stream="h")
    res = query(eng, "h", 0.2)
    assert res.itemsets == reference.mine(np.concatenate([a, b, c]), N_ITEMS, res.min_count)
    assert res.itemsets[(5, 6)] == 55 and s.stats["readmits"] == 1
    assert s.db.segments[1].local_items.tolist() == [5, 6]
    assert_consistent(s.db)


def test_standing_query_on_a_floored_stream():
    batches = drifting_batches(3, 6)
    eng = open_stream("q", window_batches=3, min_sup_floor=0.05)
    eng.append(batches[0], stream="q")
    q = eng.register_standing(tm.MineSpec(algorithm="hprepost", min_sup=0.1), stream="q")
    for i, b in enumerate(batches[1:], 1):
        eng.append(b, stream="q")
        kept = batches[max(0, i - 2):i + 1]
        rows = sum(len(k) for k in kept)
        assert q.latest == window_answer(kept, reference.min_count_of(0.1, rows))
    assert eng.stream("q").stats["diffs_delivered"] >= len(batches) - 1


def test_segments_and_c_hold_the_admitted_items_not_the_universe():
    """Over 600 items, a floor of 0.1 admits a handful: every segment is
    prepared within ``max_f1`` 16 and ``C`` is the ranked items' square,
    where without the floor the first append refuses the batch."""
    rng = np.random.default_rng(9)
    n_items = 600
    hot = np.arange(8)
    rows = np.full((300, 10), -1, np.int32)
    for r in range(300):
        items = set(rng.choice(hot, size=3, replace=False).tolist())
        items |= set(rng.choice(n_items, size=5, replace=False).tolist())
        items = sorted(items)
        rows[r, :len(items)] = items
    spec = tm.MineSpec(algorithm="hprepost", max_f1=16)
    eng = tm.MiningEngine(device="cpu")
    for part in np.array_split(rows, 3):
        eng.append(part, n_items, stream="wide", spec=spec,
                   stream_spec=StreamSpec(min_sup_floor=0.1))
    db = eng.stream("wide").db
    assert len(np.flatnonzero(db.counts)) > 500
    assert db.n_ranked <= 16 and db.C.shape == (db.n_ranked, db.n_ranked)
    assert max(seg.k for seg in db.segments) <= db.n_ranked
    res = eng.submit_stream(tm.MineSpec(algorithm="hprepost", min_sup=0.1, max_f1=16),
                            stream="wide")
    assert res.itemsets == reference.mine(rows, n_items, res.min_count)
    with pytest.raises(ValueError, match="max_f1"):
        tm.MiningEngine(device="cpu").append(rows[:100], n_items, stream="all", spec=spec)


def test_a_query_below_the_floor_raises():
    eng = open_stream("low", min_sup_floor=0.1)
    eng.append(drifting_batches(1, 1)[0], stream="low")
    with pytest.raises(ValueError, match=r"min_sup=0\.05.*min_sup_floor=0\.1"):
        query(eng, "low", 0.05)
    with pytest.raises(ValueError, match=r"min_count=3 .*below the stream's floor"):
        eng.submit_stream(tm.MineSpec(algorithm="hprepost", min_count=3), stream="low")
    assert query(eng, "low", 0.1).min_count == 7  # ceil(0.1 * 64)


@pytest.mark.parametrize("kw,match", [
    (dict(min_sup_floor=0.1, decay=0.5), "decay"),
    (dict(min_sup_floor=-0.1), "min_sup_floor"),
    (dict(min_sup_floor=1.0), "min_sup_floor"),
])
def test_stream_spec_refuses_a_floor_it_cannot_keep(kw, match):
    with pytest.raises(ValueError, match=match):
        StreamSpec(**kw)


def test_a_distributed_database_refuses_a_floor():
    eng = tm.MiningEngine(device="cpu")
    with pytest.raises(ValueError, match="min_sup_floor"):
        eng.distribute("d", n_items=N_ITEMS, workers=1,
                       stream_spec=StreamSpec(min_sup_floor=0.1))
