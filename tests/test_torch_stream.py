"""The port's streaming layer (``repro_torch.mining.stream``, ``device="cpu"``)
against the reference ``repro.mining.stream`` (``backend="jnp"``) on the same
seeded batches: the itemsets dicts, every segment's ``PreparedDB.to_host()``
payload, the ``segment_key`` inputs apart from the config dict, the
``SegmentedDB`` counts and ``C``, the append telemetry and the stream stats —
all exact (tolerance: none). Cases of ``test_stream.py`` (the single-process
ones). The reference engines are shared per module, each test on streams of
its own name, so its compiled programs are reused across tests."""
import numpy as np
import pytest

import repro.mining as jm
import repro_torch.mining as tm
from repro.core.encoding import pad_transactions
from repro.data.synth import random_db
from repro_torch.core.oracle import mine_bruteforce

# nlist_width: one static W for every segment (no segment here holds more
# than 128 rows, so no N-list is cut), which keeps the reference's compiled
# shapes few
SPEC = dict(algorithm="hprepost", max_k=4, candidate_unit=8, min_sup=0.3, nlist_width=128)
CLOCKS = ("append_s",)
RESULT_FIELDS = ("algorithm", "total_count", "n_explicit", "min_count", "n_rows",
                 "peak_bytes", "prep_shared")
PLANNING = ("planned_candidates", "host_pruned_parent", "host_pruned_subset",
            "host_pruned_seed")


def _batches(seed=0, sizes=(30, 14, 22), n_items=10, max_len=6):
    rng = np.random.default_rng(seed)
    return [random_db(rng, n, n_items, max_len) for n in sizes], n_items


def _spec(pkg, **kw):
    """The spec for one package: the reference on its jnp kernels, the port
    on the default registry entry (the plain versions on the CPU)."""
    over = dict(SPEC, **kw)
    if pkg is jm:
        over["backend"] = "jnp"
    return pkg.MineSpec(**over)


def assert_same_payload(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            assert np.ascontiguousarray(got[k]).tobytes() == want[k].tobytes(), k
        else:
            assert got[k] == want[k], k


def assert_same_result(got, want):
    assert got.itemsets == want.itemsets
    for f in RESULT_FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    np.testing.assert_array_equal(got.flist_items, want.flist_items)
    for k in PLANNING:
        assert got.stage_times_s.get(k) == want.stage_times_s.get(k), k
    for k in ("prep_source", "stream_segments", "stream_digest", "decay", "weighted_rows"):
        assert got.service_stats.get(k) == want.service_stats.get(k), k


def assert_same_db(t_db, j_db):
    """The SegmentedDB state and every segment, exactly."""
    from repro.mining.stream.stream import _digest as j_digest
    from repro_torch.mining.stream.stream import _digest as t_digest

    np.testing.assert_array_equal(t_db.rank_of, j_db.rank_of)
    assert t_db.order == j_db.order and t_db.n_rows == j_db.n_rows
    assert t_db.counts.dtype == j_db.counts.dtype and t_db.C.dtype == j_db.C.dtype
    np.testing.assert_array_equal(t_db.counts, j_db.counts)
    np.testing.assert_array_equal(t_db.C, j_db.C)
    assert t_db.digest() == j_db.digest() and t_db.stats() == j_db.stats()
    assert len(t_db.segments) == len(j_db.segments)
    for ts, js in zip(t_db.segments, j_db.segments):
        for f in ("seg_id", "n_rows", "digest", "n_batches", "tick"):
            assert getattr(ts, f) == getattr(js, f), f
        np.testing.assert_array_equal(ts.rows, js.rows)
        np.testing.assert_array_equal(ts.local_items, js.local_items)
        np.testing.assert_array_equal(ts.item_to_local, js.item_to_local)
        # segment_key's inputs apart from the config dict: the batch
        # digest, the imposed item order, n_items and the shard count
        assert t_digest(ts.rows) == j_digest(js.rows)
        assert_same_payload(ts.prepared.to_host(), js.prepared.to_host())
        # the planes the waves read: the payload's N-lists plus the sentinel
        planes = ts.planes.numpy()
        packed = js.packed_ext[0]
        for p in range(3):
            np.testing.assert_array_equal(planes[p], np.asarray(packed[..., p]))


class Twin:
    """A reference and a port engine driven by the same appends and queries
    on one named stream; every answer is compared as it comes back."""

    def __init__(self, engines, name, *, stream_spec=None, create=None, **spec):
        self.j, self.t = engines
        self.name = name
        self.spec = spec
        # batches padded to 32 rows: the reference compiles one prepare for
        # all of them (row padding is support-neutral)
        self.ss = dict(dict(row_pad=32), **(stream_spec or {}))
        if create is not None:
            self.stream(n_items=create)

    def stream(self, n_items=None):
        """Both packages' streams; ``n_items`` creates them on first touch."""
        from repro.mining.stream import StreamSpec as JS
        from repro_torch.mining.stream import StreamSpec as TS

        if n_items is None:
            return self.j.stream(self.name), self.t.stream(self.name)
        ss = JS(**self.ss), TS(**self.ss)
        return (self.j.stream(self.name, n_items=n_items, spec=_spec(jm, **self.spec),
                              stream_spec=ss[0]),
                self.t.stream(self.name, n_items=n_items, spec=_spec(tm, **self.spec),
                              stream_spec=ss[1]))

    def append(self, rows, n_items):
        js, ts = self.stream(n_items=n_items)
        a, b = js.append(rows), ts.append(rows)
        for k in CLOCKS:
            a.pop(k), b.pop(k)
        assert b == a
        return b

    def query(self, **kw):
        want = self.j.submit_stream(_spec(jm, **dict(self.spec, **kw)), stream=self.name)
        got = self.t.submit_stream(_spec(tm, **dict(self.spec, **kw)), stream=self.name)
        assert_same_result(got, want)
        return got

    def check(self):
        js, ts = self.stream()
        assert_same_db(ts.db, js.db)
        keep = {k: v for k, v in js.stats.items() if "latency" not in k}
        assert {k: v for k, v in ts.stats.items() if "latency" not in k} == keep
        return ts


@pytest.fixture(scope="module")
def engines():
    return jm.MiningEngine(), tm.MiningEngine(device="cpu")


# ---------------------------------------------------------------- parity
@pytest.mark.parametrize("min_sup", [0.5, 0.3, 0.2, 0.1])
def test_stream_matches_reference_oneshot_and_oracle(engines, min_sup):
    batches, n_items = _batches(1, sizes=(25, 18, 31, 12))
    tw = Twin(engines, f"parity-{min_sup}", **SPEC)
    for b in batches:
        tw.append(b, n_items)
    res = tw.query(min_sup=min_sup)
    tw.check()
    allrows = np.concatenate(batches)
    assert res.n_rows == len(allrows)
    oneshot = tm.MiningEngine(device="cpu").submit(allrows, n_items, _spec(tm, min_sup=min_sup))
    assert res.itemsets == oneshot.itemsets == mine_bruteforce(allrows, n_items, res.min_count,
                                                               max_k=4)


@pytest.mark.parametrize("n_filler", [0, 600])
def test_stream_planted_subset_prune(engines, n_filler):
    """``mine_prepared_segments`` on rows where the subset check removes
    doomed candidates at widths 5 and 8, the same count as the reference's:
    over 13 stream ranks every key is one word; over 613 the width-8 check
    takes two words, as ``plan.subset_multiword`` shows."""
    from test_torch_hprepost import planted_rows, under_profiler

    rows, n_items = planted_rows(n_filler)
    tw = Twin(engines, f"planted-{n_filler}", **dict(SPEC, max_k=None))
    for b in np.array_split(rows, 3):
        tw.append(b, n_items)
    res, tab = under_profiler(lambda: tw.query(min_sup=None, min_count=2))
    tw.check()
    assert max(len(s) for s in res.itemsets) == 7
    assert res.stage_times_s["host_pruned_subset"] > 0
    assert ("plan.subset_multiword" in tab) == (n_filler > 0)


def test_stream_min_count_spec_and_fractional_boundary(engines):
    batches, n_items = _batches(2, sizes=(7, 3))
    tw = Twin(engines, "boundary", **SPEC)
    for b in batches:
        tw.append(b, n_items)
    assert tw.query(min_sup=0.3).min_count == 3
    tw.query(min_sup=None, min_count=2)
    tw.check()


def test_stream_pad_heavy_batches(engines):
    b1 = pad_transactions([[0], [1, 2], [], [0, 2]], max_len=8)
    b2 = pad_transactions([[2], [], [], [0, 1, 2]], max_len=8)
    b3 = np.full((3, 8), -1, np.int32)  # an all-PAD batch (rows still count)
    tw = Twin(engines, "pad-heavy", **SPEC)
    reports = [tw.append(b, 3) for b in (b1, b2, b3)]
    assert reports[-1]["prep_source"] == "empty"
    res = tw.query(min_sup=0.2)
    assert res.n_rows == 11
    assert tw.check().stats["empty_batches"] == 1


def test_stream_flist_growth_on_unseen_items(engines):
    rng = np.random.default_rng(5)
    b1 = random_db(rng, 24, 5, 4)  # items 0..4 only
    b2 = random_db(rng, 24, 12, 6)  # introduces 5..11 mid-stream
    tw = Twin(engines, "growth", **SPEC)
    s1, s2 = tw.append(b1, 12), tw.append(b2, 12)
    assert s1["new_items"] == 5 and s2["new_items"] == 7
    tw.query(min_sup=0.15)
    tw.check()


def test_stream_row_padding_is_support_neutral(engines):
    batches, n_items = _batches(6, sizes=(13, 9, 17))
    padded = Twin(engines, "row-pad", stream_spec=dict(row_pad=16), **SPEC)
    for b in batches:
        padded.append(b, n_items)
    res = padded.query(min_sup=0.2)
    assert res.n_rows == 39
    assert [len(s.rows) for s in padded.check().db.segments] == [16, 16, 32]


# --------------------------------------------------------- incrementality
def test_append_preps_exactly_one_segment():
    """Fresh engines: the miners' stage counters (no Job 1 on an append, one
    Job 2 / pack / F2 each; queries run waves only) equal the reference's."""
    batches, n_items = _batches(7, sizes=(20, 25, 15, 30))
    tw = Twin((jm.MiningEngine(), tm.MiningEngine(device="cpu")), "default", **SPEC)
    for b in batches:
        tw.append(b, n_items)
    js, ts = tw.stream()
    assert ts.miner.stage_counters == js.miner.stage_counters
    assert ts.miner.stage_counters["job1"] == 0 and ts.miner.stage_counters["job2"] == 4
    tw.query(min_sup=0.1)
    assert ts.miner.stage_counters == js.miner.stage_counters
    assert ts.miner.stage_counters["seg_waves"] == 4 * ts.miner.stage_counters["waves"]
    assert tw.t.stats == tw.j.stats
    tw.check()


def test_stream_requires_matching_device_config_and_algorithm(engines):
    batches, n_items = _batches(8, sizes=(12,))
    tw = Twin(engines, "config", **SPEC)
    tw.append(batches[0], n_items)
    for pkg, eng in ((jm, tw.j), (tm, tw.t)):
        with pytest.raises(ValueError, match="device config"):
            eng.submit_stream(_spec(pkg, candidate_unit=64), stream="config")
        with pytest.raises(ValueError, match="hprepost"):
            eng.submit_stream(pkg.MineSpec(algorithm="apriori", min_sup=0.3), stream="config")
        with pytest.raises(KeyError, match="no stream"):
            eng.submit_stream(_spec(pkg), stream="nope")
        eng.append(batches[0], stream="config")  # existing stream: n_items may be omitted
        with pytest.raises(ValueError, match="n_items"):
            eng.append(batches[0], stream="never-made")  # creation needs n_items
        with pytest.raises(ValueError, match="n_items"):
            eng.stream("config", n_items=n_items + 1)  # must match at re-touch
    tw.check()


# ------------------------------------------------------------- compaction
@pytest.mark.parametrize("compact_async", [False, True])
def test_compaction_preserves_answers_bit_for_bit(engines, compact_async):
    batches, n_items = _batches(9, sizes=(14, 9, 21, 7, 26, 11))
    tw = Twin(engines, f"compact-{compact_async}",
              stream_spec=dict(max_segments=3, compact_fanin=3, compact_async=compact_async),
              **SPEC)
    for b in batches:
        tw.append(b, n_items)
        js, ts = tw.stream()
        js.flush(), ts.flush()  # async: both land their pass before the next append
    ts = tw.check()
    assert ts.stats["compactions"] >= 1 and len(ts.db.segments) < len(batches)
    res = tw.query(min_sup=0.15)
    assert res.itemsets == mine_bruteforce(np.concatenate(batches), n_items, res.min_count,
                                           max_k=4)


def test_forced_compaction_pass_reduces_segments(engines):
    batches, n_items = _batches(10, sizes=(10, 12, 9, 11))
    tw = Twin(engines, "forced", **SPEC)
    for b in batches:
        tw.append(b, n_items)
    before = tw.query(min_sup=0.2)
    js, ts = tw.stream()
    assert ts.compact() == js.compact() == {"segments": 1, "compactions": 1}
    assert tw.check().stats["segments_compacted"] == 4
    assert tw.query(min_sup=0.2).itemsets == before.itemsets


def test_auto_compaction_failure_never_fails_the_append(engines):
    batches, n_items = _batches(18, sizes=(10, 11, 12))
    tw = Twin(engines, "compact-fail", stream_spec=dict(max_segments=2, compact_fanin=2), **SPEC)
    tw.append(batches[0], n_items)
    tw.append(batches[1], n_items)

    def boom(*a, **k):
        raise RuntimeError("merge prepare blew up")

    for s in tw.stream():
        s._compact_job = boom
    st = tw.append(batches[2], n_items)
    assert st["segments"] == 3 and st["total_rows"] == 33
    tw.query(min_sup=0.2)
    for s in tw.stream():  # an EXPLICIT pass propagates the failure to its caller
        with pytest.raises(RuntimeError, match="blew up"):
            s.compact()
    tw.check()


def test_small_byte_fraction_trigger(engines):
    batches, n_items = _batches(11, sizes=(6, 7, 5, 8))
    tw = Twin(engines, "small-bytes",
              stream_spec=dict(small_rows=50, small_byte_frac=0.5, compact_fanin=4), **SPEC)
    for b in batches:
        tw.append(b, n_items)
    ts = tw.check()
    assert ts.stats["compactions"] >= 1 and len(ts.db.segments) < 4
    tw.query(min_sup=0.3)


# ---------------------------------------------------- snapshot warm-start
def test_segment_snapshots_warm_start_replayed_stream(tmp_path):
    """Each package's snapshots warm-start its own replay with zero prepares,
    and the restored segments and answers still equal the reference's."""
    batches, n_items = _batches(12, sizes=(18, 23, 14))

    def engines_on():  # a fresh process on each package's own store
        return (jm.MiningEngine(snapshot_dir=str(tmp_path / "j")),
                tm.MiningEngine(device="cpu", snapshot_dir=str(tmp_path / "t")))

    cold = Twin(engines_on(), "default", **SPEC)
    for b in batches:
        cold.append(b, n_items)
    ref = cold.query()
    assert cold.check().stats["seg_prepares"] == 3
    warm = Twin(engines_on(), "default", **SPEC)
    reports = [warm.append(b, n_items) for b in batches]
    assert [r["prep_source"] for r in reports] == ["snapshot"] * 3
    ts = warm.check()
    assert ts.stats["seg_prepares"] == 0 and ts.stats["seg_snapshot_hits"] == 3
    assert warm.query().itemsets == ref.itemsets
    # another history packs differently: the key carries the item order
    other = Twin(engines_on(), "default", **SPEC)
    for b in batches[::-1]:
        other.append(b, n_items)
    assert other.query().itemsets == ref.itemsets
    assert other.check().stats["seg_prepares"] >= 1


def test_segment_set_digest_tracks_layout(engines):
    batches, n_items = _batches(13, sizes=(10, 12))
    tw = Twin(engines, "digest", **SPEC)
    tw.append(batches[0], n_items)
    d1 = tw.stream()[1].db.digest()
    tw.append(batches[1], n_items)
    d2 = tw.stream()[1].db.digest()
    assert d1 != d2
    r = tw.query()
    assert r.service_stats["stream_digest"] == d2 and r.service_stats["stream_segments"] == 2
    assert r.service_stats["prep_source"] == "stream" and r.prep_shared


# ------------------------------------------------------- service wiring
def _served(pkg, batches, n_items, window=0.25, **kw):
    with pkg.MiningService(batch_window_s=window, **kw) as svc:
        futs = [svc.append(b, n_items, spec=_spec(pkg)) for b in batches]
        fq = svc.submit_stream(_spec(pkg))
        fm = svc.submit(np.concatenate(batches), n_items, _spec(pkg))
        out = ([f.result(timeout=120) for f in futs], fq.result(timeout=120),
               fm.result(timeout=120))
        snap = svc.stats()
    return out, snap


def test_service_append_then_query_sees_the_segment():
    batches, n_items = _batches(14, sizes=(20, 16))
    (ja, jq, jmine), jsnap = _served(jm, batches, n_items)
    (ta, tq, tmine), tsnap = _served(tm, batches, n_items, device="cpu")
    for a, b in zip(ta, ja):
        a.pop("append_s"), b.pop("append_s")
    assert ta == ja and [a["segments"] for a in ta] == [1, 2]
    assert tq.n_rows == 36 and tq.itemsets == jq.itemsets == tmine.itemsets == jmine.itemsets
    assert tq.service_stats["batch_size"] == jq.service_stats["batch_size"] == 4
    assert sorted(tsnap["streams"]) == sorted(jsnap["streams"]) == ["default"]
    assert tsnap["counters"]["retries"] == tsnap["counters"]["respawns"] == 0
    assert tsnap["streams"]["default"]["appends"] == 2


def test_service_append_copies_at_submit_time():
    batches, n_items = _batches(19, sizes=(14, 14))
    answers = []
    for pkg, kw in ((jm, {}), (tm, {"device": "cpu"})):
        buf = batches[0].copy()
        with pkg.MiningService(batch_window_s=0.3, **kw) as svc:
            svc.append(buf, n_items, spec=_spec(pkg))
            buf[:] = batches[1]  # caller reuses its buffer inside the window
            svc.append(buf, n_items)
            answers.append(svc.submit_stream(_spec(pkg, min_sup=0.2)).result(timeout=120))
    allrows = np.concatenate(batches)
    assert answers[1].itemsets == answers[0].itemsets == mine_bruteforce(
        allrows, n_items, answers[1].min_count, max_k=4)


def test_service_stream_failure_is_isolated():
    from repro_torch.mining.service import DeadlineExceeded

    batches, n_items = _batches(15, sizes=(15,))
    with tm.MiningService(device="cpu", batch_window_s=0.2) as svc:
        bad = svc.submit_stream(_spec(tm))  # no such stream yet
        good = svc.append(batches[0], n_items, spec=_spec(tm))
        with pytest.raises(KeyError):
            bad.result(timeout=120)
        assert good.result(timeout=120)["segments"] == 1
        late = svc.submit_stream(_spec(tm, deadline_s=1e-9))
        with pytest.raises(DeadlineExceeded):
            late.result(timeout=120)
        assert svc.stats["stream_deadline_dropped"] == 1


# ------------------------------------------------------------- edge cases
def test_stream_query_paths_max_k1_and_empty(engines):
    batches, n_items = _batches(16, sizes=(12,))
    tw = Twin(engines, "max-k1", **SPEC)
    tw.append(batches[0], n_items)
    r1, full = tw.query(max_k=1), tw.query()
    assert r1.itemsets == {k: v for k, v in full.itemsets.items() if len(k) == 1}
    empty = Twin(engines, "empty", create=5, **SPEC)  # a stream with no rows answers empty
    r = empty.query()
    assert r.itemsets == {} and r.n_rows == 0


def test_append_copies_the_batch(engines):
    batches, n_items = _batches(17, sizes=(15, 10))
    tw = Twin(engines, "copies", **SPEC)
    b0 = batches[0].copy()
    tw.append(b0, n_items)
    b0[:] = -1  # caller scribbles over its batch after the append
    tw.append(batches[1], n_items)
    for s in tw.stream():
        s.compact()  # compaction re-prepares from the stream's copy
    res = tw.query()
    allrows = np.concatenate(batches)
    assert res.itemsets == mine_bruteforce(allrows, n_items, res.min_count, max_k=4)
    tw.check()


# ------------------------------------------------- the segment half of hprepost
def _miners(**cfg):
    from repro.core.hprepost import HPrepostConfig as JC, HPrepostMiner as JM
    from repro.mining.miners import default_mesh
    from repro_torch.core.hprepost import HPrepostConfig as TC, HPrepostMiner as TM

    return JM(default_mesh(), config=JC(backend="jnp", **cfg)), TM("cpu", TC(**cfg))


def test_prepare_with_an_imposed_flist_matches_the_reference():
    """``prepare(flist=...)``: no Job 1 (no histogram launch), the result not
    support-ordered, the payload the reference's; a mismatched universe and
    ``mine_prepared`` on such a prep raise."""
    from repro.core import encoding as jenc
    from repro_torch.core import encoding as tenc

    rows, n_items = _batches(20, sizes=(40,))[0][0], 10
    hist = tenc.item_support(rows, n_items)
    items = np.flatnonzero(hist > 0)[::-1].astype(np.int32)  # an order not by support
    jmnr, tmnr = _miners(nlist_width=64)
    fl = dict(items=items, supports=hist[items].astype(np.int64), n_items=n_items, min_count=1)
    want = jmnr.prepare(rows, n_items, 1, flist=jenc.FList(**fl))
    got = tmnr.prepare(rows, n_items, 1, flist=tenc.FList(**fl))
    assert not got.support_ordered and tmnr.stage_counters == jmnr.stage_counters
    assert tmnr.stage_counters["job1"] == 0
    assert_same_payload(got.to_host(), want.to_host())
    planes, singleton = tmnr.extend_with_sentinel(got)
    ext, _ = jmnr.extend_with_sentinel(want)
    for p in range(3):
        np.testing.assert_array_equal(planes[p].numpy(), np.asarray(ext[0][..., p]))
    assert singleton.data_ptr() == planes[2].data_ptr() and singleton.is_contiguous()
    with pytest.raises(ValueError, match="mine_prepared_segments"):
        tmnr.mine_prepared(got, 3)
    with pytest.raises(ValueError, match="imposed flist covers"):
        tmnr.prepare(rows, n_items + 1, 1, flist=tenc.FList(**fl))
    with pytest.raises(ValueError, match="F1-only"):
        tmnr.extend_with_sentinel(tmnr.prepare(rows, n_items, 1, need_waves=False))


@pytest.mark.parametrize("make", ["c-contiguous", "strided-slice", "empty", "bool"])
def test_digest_matches_the_reference_without_a_copy(make):
    """The engine's fingerprint hashes the rows in place; its value is the
    reference's (it is part of every snapshot key)."""
    from repro.mining.engine import MiningEngine as JE
    from repro_torch.mining.engine import MiningEngine as TE

    rows = random_db(np.random.default_rng(21), 300, 40, 12)
    arr = {"c-contiguous": rows, "strided-slice": rows[::3, 1::2],
           "empty": rows[:0], "bool": rows > 5}[make]
    assert TE._digest(arr) == JE._digest(arr)


def test_max_f1_guards_the_segment_prepare_and_the_query(engines):
    """A segment's F-list holds every item of its batch, so |F1| is guarded
    at the append (``max_f1``, as in the reference) and again at the query
    over the stream's whole item order."""
    rng = np.random.default_rng(22)
    wide, narrow = random_db(rng, 20, 10, 8), random_db(rng, 20, 4, 3)
    for pkg, eng in ((jm, engines[0]), (tm, engines[1])):
        spec = _spec(pkg, max_f1=5)
        with pytest.raises(ValueError, match="exceeds max_f1=5"):
            eng.append(wide, 10, spec=spec, stream="f1-guard")
        eng.append(narrow, 10, stream="f1-guard-q", spec=spec)
        eng.append(np.where(narrow >= 0, narrow + 4, narrow), 10, stream="f1-guard-q")
        with pytest.raises(ValueError, match="exceeds max_f1=5"):
            eng.submit_stream(spec, stream="f1-guard-q")


def test_cli_append_window_watch_matches_reference_then_warm_start(capsys, tmp_path):
    """``--append 4 --window 2 --watch``: the same report line for line as
    the reference's but the clocks (the run self-checks window parity and
    diff replay), then a replay with ``--expect-warm`` restores every
    segment from the snapshots of a first run."""
    import re

    from repro.launch.mine import main as jmain
    from repro_torch.launch.mine import main as tmain

    args = ["--dataset", "mushroom", "--scale", "0.05", "--append", "4", "--window", "2",
            "--watch", "--min-sup", "0.3"]
    got = tmain(args + ["--device", "cpu"])
    tout = capsys.readouterr().out
    want = jmain(args + ["--backend", "jnp"])
    jout = capsys.readouterr().out
    assert [r.itemsets for r in got] == [r.itemsets for r in want]
    clocks = r"( in [0-9.]+s |[0-9.]+ms)"
    assert re.sub(clocks, "", tout) == re.sub(clocks, "", jout)
    assert "window parity verified" in tout and "watch verified" in tout
    warm = ["--dataset", "mushroom", "--scale", "0.05", "--append", "3", "--min-sup", "0.3",
            "--device", "cpu", "--snapshot-dir", str(tmp_path)]
    cold = tmain(warm)
    assert [r.itemsets for r in tmain(warm + ["--expect-warm"])] == [r.itemsets for r in cold]
    assert "warm start verified" in capsys.readouterr().out
