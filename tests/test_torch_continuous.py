"""The port's continuous mining (``repro_torch.mining.continuous``:
sliding windows, decayed supports, standing queries) against the
reference's on the same seeded batches: itemsets, the ``SegmentedDB``
counts and ``C`` after expiry and compaction, every segment's payload, the
``MineDiff`` sequence and the float64 decayed supports — all exact
(tolerance: none; decayed float64 supports compared with ==). Cases of
``test_continuous.py`` (the single-process ones)."""
import numpy as np
import pytest

import repro.mining as jm
import repro_torch.mining as tm
from repro.core.encoding import PAD, pad_transactions
from repro.data.synth import random_db
from repro_torch.core.oracle import mine_bruteforce
from test_torch_stream import SPEC, Twin, _batches, _spec

DIFF_FIELDS = ("seq", "cause", "entered", "left", "changed", "n_rows", "min_count", "total")


@pytest.fixture(scope="module")
def engines():
    return jm.MiningEngine(), tm.MiningEngine(device="cpu")


def _retained(ts):
    """The retained transactions that hold an item (the segments' rows are
    padded to 32 with all-PAD rows, which no itemset counts)."""
    rows = np.concatenate([s.rows for s in ts.db.segments])
    return rows[(rows != PAD).any(axis=1)]


def _standing(tw, **kw):
    """Register the same standing query on both streams -> (ref, port)."""
    return (tw.j.register_standing(_spec(jm, **dict(tw.spec, **kw)), stream=tw.name),
            tw.t.register_standing(_spec(tm, **dict(tw.spec, **kw)), stream=tw.name))


def assert_same_diffs(tq, jq):
    assert len(tq.diffs) == len(jq.diffs)
    for a, b in zip(tq.diffs, jq.diffs):
        for f in DIFF_FIELDS:
            assert getattr(a, f) == getattr(b, f), f
    assert tq.latest == jq.latest and tq.seq == jq.seq


# -------------------------------------------------- StreamSpec validation
@pytest.mark.parametrize("kw", [
    dict(max_segments=4, compact_fanin=8), dict(window_rows=-1), dict(window_batches=-2),
    dict(window_rows=100, window_batches=4), dict(decay=0.0), dict(decay=1.5),
    dict(decay=0.5, small_rows=64), dict(row_pad=0), dict(small_byte_frac=0.0),
])
def test_stream_spec_rejects_what_the_reference_rejects(kw):
    from repro.mining.stream import StreamSpec as JS
    from repro_torch.mining.stream import StreamSpec as TS

    with pytest.raises(ValueError) as want:
        JS(**kw)
    with pytest.raises(ValueError) as got:
        TS(**kw)
    assert str(got.value) == str(want.value)
    assert TS(max_segments=8, compact_fanin=8).compact_fanin == 8
    assert TS(window_rows=100).windowed and TS(window_batches=3).windowed
    assert not TS().windowed


# ------------------------------------------------------ retraction primitive
def test_drop_segments_is_exact_retraction(engines):
    batches, n_items = _batches(3, sizes=(20, 15, 25))
    tw = Twin(engines, "drop", stream_spec=dict(max_segments=99), **SPEC)
    for b in batches:
        tw.append(b, n_items)
    js, ts = tw.stream()
    victim = ts.db.segments[0].seg_id
    dropped = [db.drop_segments({victim}) for db in (js.db, ts.db)]
    assert [s.seg_id for s in dropped[1]] == [s.seg_id for s in dropped[0]] == [victim]
    tw.check()
    res = tw.query()
    rest = np.concatenate(batches[1:])
    assert res.itemsets == mine_bruteforce(rest, n_items, res.min_count, max_k=4)
    assert ts.db.drop_segments({victim}) == []  # already gone: a no-op


def test_replace_segments_refuses_expired_victims(engines):
    batches, n_items = _batches(4, sizes=(18, 12, 16))
    tw = Twin(engines, "replace", stream_spec=dict(max_segments=99), **SPEC)
    for b in batches:
        tw.append(b, n_items)
    for s in tw.stream():
        a, b, c = s.db.segments
        s.db.drop_segments({a.seg_id})
        assert s.db.replace_segments({a.seg_id, b.seg_id}, c) is False
    tw.check()


# ---------------------------------------------------------- windowed parity
@pytest.mark.parametrize("min_sup", [0.5, 0.3, 0.15])
def test_window_rows_parity_across_thresholds(engines, min_sup):
    batches, n_items = _batches(5, sizes=(25, 18, 31, 12, 20))
    tw = Twin(engines, f"wrows-{min_sup}", stream_spec=dict(window_rows=40), **SPEC)
    reports = [tw.append(b, n_items) for b in batches]
    assert any(r["expired"] for r in reports)
    ts = tw.check()
    res = tw.query(min_sup=min_sup)
    retained = _retained(ts)
    assert res.n_rows == sum(s.n_rows for s in ts.db.segments)
    oneshot = tm.MiningEngine(device="cpu").submit(
        retained, n_items, _spec(tm, min_sup=None, min_count=res.min_count))
    assert res.itemsets == oneshot.itemsets == mine_bruteforce(retained, n_items, res.min_count,
                                                               max_k=4)
    assert ts.db.n_rows - ts.db.segments[0].n_rows < 40  # the minimal suffix


def test_window_batches_parity_and_telemetry(engines):
    batches, n_items = _batches(6, sizes=(25, 18, 31, 12))
    tw = Twin(engines, "wbatches", stream_spec=dict(window_batches=2), **SPEC)
    reports = [tw.append(b, n_items) for b in batches]
    assert [r["expired"] for r in reports] == [0, 0, 1, 1]
    res = tw.query()
    assert res.n_rows == len(batches[2]) + len(batches[3])
    st = tw.t.stream_stats()[tw.name]
    assert st["expires"] == 2 and st["expired_segments"] == 2
    assert st["expired_rows"] == len(batches[0]) + len(batches[1])
    tw.check()


def test_window_parity_pad_heavy_batches(engines):
    b1 = pad_transactions([[0], [1, 2], [], [0, 2]], max_len=8)
    b2 = pad_transactions([[2], [], [], [0, 1, 2]], max_len=8)
    b3 = np.full((3, 8), PAD, np.int32)  # all-PAD rows still count and expire
    b4 = pad_transactions([[0, 1], [1, 2], [0]], max_len=8)
    tw = Twin(engines, "wpad", stream_spec=dict(window_rows=7), **SPEC)
    reports = [tw.append(b, 3) for b in (b1, b2, b3, b4)]
    assert [r["expired_rows"] for r in reports] == [0, 0, 4, 0]
    assert tw.query(min_sup=0.2).n_rows == 10
    b5 = pad_transactions([[0, 2], [1]], max_len=8)
    tw.append(b5, 3)
    assert tw.append(b5, 3)["expired_rows"] > 0
    js, ts = tw.stream()
    assert ts._empty_trail == js._empty_trail == []
    tw.query(min_sup=0.2)
    tw.check()


def test_window_parity_paper_db_anchor(engines, paper_db):
    rows, n_items = paper_db
    tw = Twin(engines, "wpaper", stream_spec=dict(window_batches=1),
              **dict(SPEC, min_sup=None, min_count=2, max_k=3))
    tw.append(rows[:2], n_items)
    tw.append(rows[2:], n_items)
    res = tw.query()
    assert res.n_rows == len(rows) - 2
    assert res.itemsets == mine_bruteforce(rows[2:], n_items, 2, max_k=3)
    tw.check()


def test_windowed_compaction_respects_window_boundaries(engines):
    batches, n_items = _batches(7, sizes=(12, 10, 14, 11, 13, 12))
    tw = Twin(engines, "wcompact", stream_spec=dict(window_rows=45, max_segments=3,
                                                     compact_fanin=2), **SPEC)
    for b in batches:
        tw.append(b, n_items)
    ts = tw.check()
    assert ts.stats["compactions"] >= 1
    ids = [s.seg_id for s in ts.db.segments]
    assert ids == sorted(ids)
    res = tw.query()
    assert res.itemsets == mine_bruteforce(_retained(ts), n_items, res.min_count, max_k=4)


def test_deterministic_interleaving_parity_and_diff_reconstruction(engines):
    from repro_torch.mining.continuous import replay_diffs

    rng = np.random.default_rng(11)
    n_items = 8
    tw = Twin(engines, "interleave", create=n_items,
              stream_spec=dict(window_rows=60, max_segments=4, compact_fanin=2), **SPEC)
    jq, tq = _standing(tw)
    for _ in range(8):
        tw.append(random_db(rng, 12 + int(rng.integers(0, 18)), n_items, 5), n_items)
        ts = tw.check()
        res = tw.query()
        assert res.itemsets == mine_bruteforce(_retained(ts), n_items, res.min_count, max_k=4)
        assert_same_diffs(tq, jq)
        assert replay_diffs(tq.diffs) == tq.latest == res.itemsets


# ------------------------------------------------------------------- decay
@pytest.mark.parametrize("decay", [0.5, 0.9])
def test_decayed_supports_match_the_reference_bit_for_bit(engines, decay):
    """float64 weighted supports: the port's equal the reference's bit for
    bit at any decay; at a dyadic decay both equal the damped oracle's."""
    from repro_torch.mining.continuous import damped_oracle

    batches, n_items = _batches(8, sizes=(20, 15, 25, 18))
    tw = Twin(engines, f"decay-{decay}", stream_spec=dict(decay=decay),
              **dict(SPEC, min_sup=None, min_count=3))
    for b in batches:
        tw.append(b, n_items)
    res = tw.query()  # the reference's float64 supports, exactly
    assert all(isinstance(s, float) for s in res.itemsets.values())
    assert res.service_stats["decay"] == decay
    oracle = damped_oracle(batches, n_items, decay, 3.0, max_k=4)
    assert set(res.itemsets) == set(oracle)
    if decay == 0.5:  # dyadic weights: the float sums are exact
        assert res.itemsets == oracle
    tw.check()


def test_decay_helpers_match_the_reference(engines):
    import repro.mining.continuous as jc
    import repro_torch.mining.continuous as tc

    batches, n_items = _batches(9, sizes=(15, 15, 12))
    tw = Twin(engines, "decay-helpers", stream_spec=dict(decay=0.7), **SPEC)
    for b in batches:
        tw.append(b, n_items)
    js, ts = tw.stream()
    wj = jc.segment_weights(js.db.segments, js._tick, 0.7)
    wt = tc.segment_weights(ts.db.segments, ts._tick, 0.7)
    assert wt.tobytes() == wj.tobytes()
    for a, b in zip(tc.weighted_state(ts.db, wt), jc.weighted_state(js.db, wj)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    wrows = tc.weighted_state(ts.db, wt)[3]
    assert tc.resolve_weighted(_spec(tm), wrows) == jc.resolve_weighted(_spec(jm), wrows)
    with pytest.raises(ValueError, match="decay"):
        ts.compact()


# --------------------------------------------------------- standing queries
def test_standing_query_diffs_replay_to_the_live_answer(engines):
    from repro_torch.mining.continuous import replay_diffs

    batches, n_items = _batches(10, sizes=(25, 18, 31, 12))
    tw = Twin(engines, "standing", create=n_items, stream_spec=dict(window_rows=50), **SPEC)
    jq, tq = _standing(tw)
    assert tq.diffs[0].cause == "register" and tq.diffs[0].total == 0
    for b in batches:
        assert tw.append(b, n_items)["diffs"] == 1
    assert {"append", "expire"} <= {d.cause for d in tq.diffs}
    assert_same_diffs(tq, jq)
    final = tw.query()
    assert replay_diffs(tq.diffs) == tq.latest == final.itemsets
    tw.check()


def test_standing_query_seed_pruning_stays_exact(engines):
    n_items = 4
    tx = [[0, 1]] * 30 + [[0, 2]] * 30 + [[1, 2]] * 30 + [[0, 1, 2]] * 10
    b1 = pad_transactions(tx, max_len=3)
    b2 = pad_transactions([[0, 1, 2]] * 5, max_len=3)
    tw = Twin(engines, "seed", create=n_items, stream_spec=dict(row_pad=1),
              **dict(SPEC, min_sup=None, min_count=35))
    jq, tq = _standing(tw)
    tw.append(b1, n_items)
    tw.append(b2, n_items)
    st = tw.t.stream_stats()[tw.name]
    assert st["seed_pruned_candidates"] > 0
    assert st["seed_pruned_candidates"] == tw.j.stream_stats()[tw.name]["seed_pruned_candidates"]
    assert_same_diffs(tq, jq)
    assert tw.query().itemsets == tq.latest
    tw.check()


def test_standing_query_patterns_ride_the_delivered_view(engines):
    from repro_torch.core.patterns import closed_itemsets

    batches, n_items = _batches(12, sizes=(25, 20, 22))
    tw = Twin(engines, "patterns", create=n_items, **SPEC)
    jq, tq = _standing(tw, patterns="closed")
    for b in batches:
        tw.append(b, n_items)
    assert_same_diffs(tq, jq)
    assert tq.latest == closed_itemsets(tw.query().itemsets)


def test_standing_query_next_diff_future_and_cancel(engines):
    batches, n_items = _batches(13, sizes=(20, 15, 18))
    tw = Twin(engines, "cancel", create=n_items, **SPEC)
    jq, tq = _standing(tw)
    f = tq.next_diff()
    assert not f.done()
    tw.append(batches[0], n_items)
    assert f.result(timeout=5) is tq.diffs[-1]
    tw.t.cancel_standing(tq, stream=tw.name)
    tw.j.cancel_standing(jq, stream=tw.name)
    n = len(tq.diffs)
    tw.append(batches[1], n_items)
    assert len(tq.diffs) == n and not tq.active
    assert tw.t.stream_stats()[tw.name]["standing_queries"] == 0
    assert_same_diffs(tq, jq)


def test_standing_register_rejects_bad_spec_and_registers_nothing(engines):
    batches, n_items = _batches(14, sizes=(20,))
    tw = Twin(engines, "bad-spec", **SPEC)
    tw.append(batches[0], n_items)
    for pkg, eng in ((jm, tw.j), (tm, tw.t)):
        with pytest.raises(ValueError):
            eng.register_standing(_spec(pkg, algorithm="apriori"), stream=tw.name)
        assert eng.stream_stats()[tw.name]["standing_queries"] == 0
    with pytest.raises(KeyError, match="no stream"):
        tw.t.register_standing(_spec(tm), stream="nope")


# -------------------------------------------------------------------- chaos
def _with_chaos(tw, point, run, **arm):
    """``run(engine)`` for each package under its own injector armed alike."""
    import repro.fault.failures as jf
    import repro_torch.fault.failures as tf

    for f, eng in ((jf, tw.j), (tf, tw.t)):
        with f.installed(f.ChaosInjector(seed=0).arm(point, **arm)):
            run(eng)


def test_expiry_failure_skips_and_self_heals(engines):
    batches, n_items = _batches(15, sizes=(20, 15, 25, 18, 22))
    tw = Twin(engines, "chaos-expire", create=n_items, stream_spec=dict(window_rows=40), **SPEC)
    _with_chaos(tw, "stream.expire",
                lambda eng: [eng.append(b, stream=tw.name) for b in batches[:4]], times=2)
    assert tw.t.stream_stats()[tw.name]["expire_errors"] == 2
    tw.append(batches[4], n_items)
    ts = tw.check()
    assert ts.db.n_rows - ts.db.segments[0].n_rows < 40
    res = tw.query()
    assert res.itemsets == mine_bruteforce(_retained(ts), n_items, res.min_count, max_k=4)


def test_diff_failure_keeps_the_chain_consistent(engines):
    from repro_torch.mining.continuous import replay_diffs

    batches, n_items = _batches(16, sizes=(20, 15, 18, 22))
    tw = Twin(engines, "chaos-diff", create=n_items, **SPEC)
    jq, tq = _standing(tw)
    _with_chaos(tw, "stream.diff",
                lambda eng: [eng.append(b, stream=tw.name) for b in batches[:3]],
                after=1, times=1)
    tw.append(batches[3], n_items)
    assert tw.t.stream_stats()[tw.name]["diff_errors"] == 1
    assert len(tq.diffs) == 4
    assert_same_diffs(tq, jq)
    assert replay_diffs(tq.diffs) == tq.latest == tw.query().itemsets
    tw.check()


# ------------------------------------------------------------------ service
def test_service_standing_query_futures_arrive_in_order():
    from repro_torch.mining.continuous import replay_diffs

    batches, n_items = _batches(17, sizes=(22, 18, 20))
    out = []
    for pkg, kw in ((jm, {}), (tm, {"device": "cpu"})):
        with pkg.MiningService(batch_window_s=0.01, **kw) as svc:
            ss = (jm if pkg is jm else tm).StreamSpec(window_rows=40)
            svc.engine.stream("w", n_items=n_items, spec=_spec(pkg), stream_spec=ss)
            q = svc.register_standing(_spec(pkg), stream="w").result(timeout=60)
            afuts = [svc.append(b, n_items, stream="w") for b in batches]
            res = svc.submit_stream(_spec(pkg), stream="w").result(timeout=60)
            assert all(f.result(timeout=60)["diffs"] == 1 for f in afuts)
            assert replay_diffs(q.diffs) == q.latest == res.itemsets
            svc.cancel_standing(q, stream="w").result(timeout=60)
            assert svc.engine.stream_stats()["w"]["standing_queries"] == 0
            out.append((q, res))
    assert_same_diffs(out[1][0], out[0][0])
    assert out[1][1].itemsets == out[0][1].itemsets
