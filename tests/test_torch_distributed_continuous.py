"""The port's distributed continuous mining (workers on ``device="cpu"``):
the distributed cases of ``test_continuous.py`` (sliding windows, standing
queries, checkpoint replay of expired segments, empty batches, decay
refused), the distributed early-stop parity of ``test_early_stop.py`` and
the per-worker wave histograms of ``test_telemetry.py``.

The module shares one windowed 2-worker port cluster and one reference
``DistributedMiner`` (two JAX worker processes) driven by the same appends:
the append reports, the expired sets, the coordinator's counters and the
standing query's diffs are compared between them. Answers are held, exactly
(tolerance: none), to the reference's single-process windowed
``StreamingMiner`` (``backend="jnp"``) and to ``mine_bruteforce``."""
import numpy as np
import pytest

from repro.core.encoding import pad_transactions
from repro_torch.core.oracle import mine_bruteforce
from repro_torch.mining.continuous import replay_diffs
from torch_distributed_twin import (
    assert_same_result,
    batches,
    jm,
    random_db,
    single_process,
    spec,
    stream_spec,
    tm,
    wire,  # noqa: F401  (module fixture)
)

pytestmark = pytest.mark.usefixtures("wire")
PAD = -1
LATENCY = ("diff_latency_s_total", "last_diff_latency_s")


@pytest.fixture(scope="module")
def windowed_cluster(tmp_path_factory, wire):
    bs, n_items = batches(18, sizes=(25, 18, 31, 12))
    ck = str(tmp_path_factory.mktemp("cont-ck"))
    t_eng = tm.MiningEngine(device="cpu")
    j_eng = jm.MiningEngine()
    dm = t_eng.distribute(name="w", n_items=n_items, workers=2, spec=spec(tm),
                          stream_spec=stream_spec(tm, window_batches=2), checkpoint_dir=ck)
    try:
        j_dm = j_eng.distribute(
            name="w", n_items=n_items, workers=2, spec=spec(jm),
            stream_spec=stream_spec(jm, window_batches=2),
            checkpoint_dir=str(tmp_path_factory.mktemp("j-ck")))
    except BaseException:
        dm.close()
        raise
    try:
        q, jq = dm.register(spec(tm)), j_dm.register(spec(jm))
        reports = []
        for b in bs:
            got, want = dm.append(b), j_dm.append(b)
            got.pop("append_s"), want.pop("append_s")
            assert got == want
            reports.append(got)
        yield t_eng, dm, j_dm, q, jq, reports, bs, n_items, ck
    finally:
        dm.close()
        j_dm.close()


def test_distributed_window_parity_and_standing(windowed_cluster):
    _, dm, j_dm, q, jq, reports, bs, n_items, _ = windowed_cluster
    assert [r["expired"] for r in reports] == [0, 0, 1, 1]
    retained = np.concatenate(bs[-2:])
    res = dm.mine(spec(tm))
    assert_same_result(res, j_dm.mine(spec(jm)), peak=True, service=True)
    want = single_process(jm.MiningEngine(), "w", bs, n_items,
                          stream_kw=dict(window_batches=2))
    assert_same_result(res, want)
    assert res.n_rows == len(retained)
    assert res.itemsets == mine_bruteforce(retained, n_items, res.min_count, max_k=4)
    assert replay_diffs(q.diffs) == q.latest == res.itemsets
    assert [(d.seq, d.cause, d.entered, d.left, d.changed, d.total, d.n_rows)
            for d in q.diffs] == [(d.seq, d.cause, d.entered, d.left, d.changed, d.total,
                                   d.n_rows) for d in jq.diffs]
    assert dm.stats["expired_segments"] == 2
    assert dm.stats["diffs_delivered"] == len(q.diffs)
    assert dm._expired == j_dm._expired
    keep = {k: v for k, v in j_dm.stats.items() if k not in LATENCY}
    assert {k: v for k, v in dm.stats.items() if k not in LATENCY} == keep


def test_distributed_restore_replays_expired_segments(windowed_cluster):
    _, dm, _, _, _, _, _, n_items, ck = windowed_cluster
    before = dm.mine(spec(tm))
    dm2 = tm.MiningEngine(device="cpu").distribute(
        name="w2", n_items=n_items, workers=2, spec=spec(tm),
        stream_spec=stream_spec(tm, window_batches=2), checkpoint_dir=ck)
    try:
        assert dm2._expired == dm._expired
        res = dm2.mine(spec(tm))
        assert res.itemsets == before.itemsets
        assert res.n_rows == before.n_rows
        # the restored rank space matches: digests of live segments agree
        assert dm2._db_digest() == dm._db_digest()
    finally:
        dm2.close()


def test_distributed_empty_batches_age_out_of_the_window(tmp_path):
    # an all-PAD batch creates no segment but its rows join db.n_rows; the
    # append-order ledger must expire them like any other entry — and a
    # restored coordinator must agree
    n_items = 6
    b1 = pad_transactions(
        [[0, 1], [1, 2], [0, 2], [3], [0, 1, 2], [2, 3], [1, 3], [0, 3]], max_len=4)
    b_pad = np.full((6, 4), PAD, np.int32)
    b2 = pad_transactions(
        [[0, 1], [0, 1, 2], [2, 3], [1, 2], [0, 3], [1, 3], [0, 2], [3]], max_len=4)
    b3 = pad_transactions([[0, 1], [1, 2], [0, 1, 2], [2]], max_len=4)
    sspec = stream_spec(tm, window_rows=10)
    dm = tm.MiningEngine(device="cpu").distribute(
        name="we", n_items=n_items, workers=1, spec=spec(tm), stream_spec=sspec,
        checkpoint_dir=str(tmp_path))
    try:
        reports = [dm.append(b) for b in (b1, b_pad, b2, b3)]
        # append 3 expires the 8-row segment; append 4 expires the 6
        # segment-less PAD rows (a rows-only expiry: no segment dropped)
        assert [r["expired"] for r in reports] == [0, 0, 1, 0]
        assert [r["expired_rows"] for r in reports] == [0, 0, 8, 6]
        assert not dm._empty_rows
        retained = np.concatenate([b2, b3])
        res = dm.mine(spec(tm))
        assert res.n_rows == len(retained) == 12
        assert res.itemsets == mine_bruteforce(retained, n_items, res.min_count, max_k=4)
        want = single_process(jm.MiningEngine(), "we", (b1, b_pad, b2, b3), n_items,
                              stream_kw=dict(window_rows=10))
        assert_same_result(res, want)
        dm2 = tm.MiningEngine(device="cpu").distribute(
            name="we2", n_items=n_items, workers=1, spec=spec(tm), stream_spec=sspec,
            checkpoint_dir=str(tmp_path))
        try:
            res2 = dm2.mine(spec(tm))
            assert res2.n_rows == res.n_rows
            assert res2.itemsets == res.itemsets
            assert dm2._db_digest() == dm._db_digest()
        finally:
            dm2.close()
    finally:
        dm.close()


def test_distributed_rejects_decay():
    import multiprocessing

    before = {p.pid for p in multiprocessing.active_children()}
    with pytest.raises(ValueError, match="decay"):
        tm.MiningEngine(device="cpu").distribute(
            name="nope", n_items=8, workers=1, stream_spec=stream_spec(tm, decay=0.5))
    assert {p.pid for p in multiprocessing.active_children()} == before  # refused before spawning


ES = dict(min_sup=0.25, max_k=4)


@pytest.fixture(scope="module")
def es_cluster(tmp_path_factory, wire):
    """A plain (unwindowed) 2-worker cluster with both workers holding
    segments: the early-stop parity and the per-worker histograms."""
    rng = np.random.default_rng(9)
    n_items = 10
    bs = [random_db(rng, n, n_items, 6) for n in (24, 17, 21)]
    eng = tm.MiningEngine(device="cpu", snapshot_dir=str(tmp_path_factory.mktemp("es")))
    dm = eng.distribute(name="es", n_items=n_items, workers=2, spec=spec(tm, **ES),
                        stream_spec=stream_spec(tm))
    try:
        for b in bs:
            dm.append(b)
        yield eng, dm, bs, n_items
    finally:
        dm.close()


def test_distributed_parity_early_stop(es_cluster):
    """RemoteSegmentExecutor path: a 2-worker distributed mine with early
    stopping answers bit-identically to the exact path, the reference's
    single-process miner and the oracle."""
    _, dm, bs, n_items = es_cluster
    want = single_process(jm.MiningEngine(), "es", bs, n_items, **ES)
    on = dm.mine(spec(tm, **ES))
    off = dm.mine(spec(tm, early_stop=False, **ES))
    all_rows = np.concatenate(bs, axis=0)
    oracle = mine_bruteforce(all_rows, n_items, spec(tm, **ES).resolve(len(all_rows)))
    assert_same_result(on, want)
    assert on.itemsets == off.itemsets == oracle


def test_distributed_mine_records_per_worker_wave_histograms(es_cluster):
    eng, dm, bs, _ = es_cluster
    assert {m.worker for m in dm._segments.values()} == {0, 1}
    res = dm.mine(spec(tm, **dict(ES, min_sup=0.15)))
    assert any(len(s) >= 2 for s in res.itemsets)  # waves really ran
    hs = eng.telemetry.snapshot()["histograms"]
    worker_hists = [k for k in hs if k.startswith("dist.es.worker")]
    assert len(worker_hists) == 2  # one wave-RPC histogram per worker
    for k in worker_hists:
        assert k.endswith(".wave_rpc_s") and hs[k]["count"] >= 1
    assert hs["dist.es.append_s"]["count"] == len(bs)
    assert hs["dist.es.query_s"]["count"] >= 1
