"""The port's distributed mining under failures (workers on ``device="cpu"``):
the chaos, heartbeat, RPC retry, respawn and checkpoint cases of
``test_distributed.py``. A worker hard-killed between waves, mid-wave or
during an append, a missed heartbeat, a reply that times out, a spent
restart budget and a coordinator restarted from its checkpoint must all
leave every answer exactly equal (tolerance: none) to the reference's
single-process ``StreamingMiner`` (``backend="jnp"``, one engine for the
module) on the same batches, with re-placed segments restored from the
shared snapshot store. The non-destructive cases share one module-scoped
2-worker cluster; the others start their own."""
import time

import numpy as np
import pytest

from repro_torch.mining.distributed import NoLiveWorkers, choose_worker
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

_names = iter(range(10**6))


@pytest.fixture(scope="module")
def ref_single():
    return jm.MiningEngine()


def expect(ref_single, dm, bs, n_items, **kw):
    """``dm``'s answer, held to the reference's single-process stream."""
    res = dm.mine(spec(tm, **kw))
    assert_same_result(res, single_process(ref_single, f"s{next(_names)}", bs, n_items, **kw))
    return res


def open_db(tmp_path, name, n_items, **kw):
    eng = tm.MiningEngine(device="cpu", snapshot_dir=str(tmp_path))
    return eng.distribute(name=name, n_items=n_items, spec=spec(tm),
                          stream_spec=stream_spec(tm), **kw)


@pytest.fixture(scope="module")
def cluster(tmp_path_factory, wire):
    bs, n_items = batches(21, sizes=(20, 16))
    dm = open_db(tmp_path_factory.mktemp("snap"), "shared", n_items, workers=2,
                 rpc_attempts=3, rpc_backoff_s=0.01)
    try:
        for b in bs:
            dm.append(b)
        yield dm, bs, n_items
    finally:
        dm.close()


def _survivor_prepares(stats_by_wid, wids):
    return sum(stats_by_wid[w]["stats"]["seg_prepares"] for w in wids)


@pytest.mark.parametrize(
    "fault_op,after,when",
    [
        ("wave", 0, "after_reply"),  # dies between waves, reply flushed
        ("wave", 0, "before"),       # dies mid-wave, reply never sent
        ("prep", 0, "before"),       # dies during an append's map step
    ],
    ids=["between-waves", "mid-wave", "during-append"],
)
def test_chaos_worker_death_recovers_from_snapshots(tmp_path, ref_single, fault_op, after,
                                                    when):
    """Kill a worker at each dangerous point; the answer must stay exact and
    every re-placed segment must warm-restore from the shared snapshot
    store — failover recomputes nothing."""
    bs, n_items = batches(3, sizes=(30, 14, 22))
    kw = dict(min_sup=0.08)  # dense enough for 3-itemsets (2 waves)
    dm = open_db(tmp_path, "chaos", n_items, workers=2)
    try:
        for b in bs:
            dm.append(b)
        ref = expect(ref_single, dm, bs, n_items, **kw)
        assert any(len(s) >= 3 for s in ref.itemsets)  # multi-wave query
        if fault_op == "prep":
            # the next append's map step must land on the faulted worker:
            # placement is deterministic (least loaded bytes, then wid)
            victim = choose_worker(dm._loads())
        else:
            victim = min(m.worker for m in dm._segments.values())
        pre = dm.worker_stats()
        dm.inject_fault(victim, fault_op, after=after, when=when)
        if fault_op == "prep":
            extra = random_db(np.random.default_rng(9), 18, n_items, 6)
            dm.append(extra)
            bs = bs + [extra]
        expect(ref_single, dm, bs, n_items, **kw)  # bit-identical after failover

        survivors = {w.wid for w in dm._live()}
        assert victim not in survivors and len(survivors) == 1
        assert dm.stats["workers_lost"] == 1
        assert dm.stats["failovers"] >= 1
        # snapshot-only recovery: re-placed segments restored, not rebuilt
        assert dm.stats["reassigned_segments"] >= 1
        assert dm.stats["reassign_rebuilds"] == 0
        post = dm.worker_stats()
        expected_new_preps = 1 if fault_op == "prep" else 0
        assert (_survivor_prepares(post, survivors)
                - _survivor_prepares(pre, survivors)) == expected_new_preps

        # the database stays serviceable: append + re-query on survivors
        extra2 = random_db(np.random.default_rng(11), 7, n_items, 6)
        dm.append(extra2)
        expect(ref_single, dm, bs + [extra2], n_items, **kw)
    finally:
        dm.close()


def test_wave_fault_mid_query_is_replayed_bit_identically(tmp_path, ref_single):
    """A death armed one wave into a query (``after=1``) aborts it mid-flight;
    the replayed query answers exactly and counts one retry."""
    bs, n_items = batches(4, sizes=(26, 20, 18))
    dm = open_db(tmp_path, "replay", n_items, workers=2)
    try:
        for b in bs:
            dm.append(b)
        victim = min(m.worker for m in dm._segments.values())
        dm.inject_fault(victim, "wave", after=1)
        expect(ref_single, dm, bs, n_items, min_sup=0.08)
        assert dm.stats["query_retries"] == 1 and dm.stats["reassign_rebuilds"] == 0
    finally:
        dm.close()


def test_all_workers_dead_raises_no_live_workers(tmp_path):
    bs, n_items = batches(5, sizes=(20,))
    dm = open_db(tmp_path, "dead", n_items, workers=1)
    try:
        dm.append(bs[0])
        dm.kill_worker(0)
        with pytest.raises(NoLiveWorkers):
            dm.mine(spec(tm))
        with pytest.raises(NoLiveWorkers):
            dm.append(bs[0])
    finally:
        dm.close()


def test_heartbeat_detects_death_without_query_traffic(tmp_path, ref_single):
    """With the monitor on, a hard-killed worker is retired and its segments
    re-placed by the heartbeat alone — the next query pays no retry."""
    bs, n_items = batches(6, sizes=(24, 17))
    dm = open_db(tmp_path, "hb", n_items, workers=2, heartbeat_s=0.2)
    try:
        for b in bs:
            dm.append(b)
        victim = min(w.wid for w in dm._live())
        dm.kill_worker(victim)

        def settled():
            with dm._op_lock:
                return dm.stats["failovers"] >= 1 and all(
                    m.worker != victim for m in dm._segments.values()
                )

        deadline = time.monotonic() + 30
        while not settled() and time.monotonic() < deadline:
            time.sleep(0.05)
        assert settled()  # detected + re-placed with zero queries issued
        assert dm.stats["workers_lost"] == 1
        assert dm.stats["reassign_rebuilds"] == 0
        expect(ref_single, dm, bs, n_items, min_sup=0.2)
        assert dm.stats["query_retries"] == 0  # failover happened off-path
    finally:
        dm.close()


def test_rpc_timeout_retries_and_skips_stale_reply(cluster, ref_single):
    """A reply that times out once is retried under a fresh seq; the late
    duplicate reply of the timed-out send is skipped as a stale frame."""
    from repro_torch.fault.failures import ChaosInjector, installed

    dm, bs, n_items = cluster
    t0, r0 = dm.stats["rpc_timeouts"], dm.stats["rpc_retries"]
    with installed(ChaosInjector().arm("rpc.recv", exc=TimeoutError)):
        stats = dm.worker_stats()
    assert stats[0]["stats"]["preps"] == 1  # correct payload after retry
    assert dm.stats["rpc_timeouts"] == t0 + 1
    assert dm.stats["rpc_retries"] == r0 + 1
    assert len(dm._live()) == 2  # one timeout never retires the worker
    expect(ref_single, dm, bs, n_items, min_sup=0.15)


def test_rpc_retry_exhaustion_fails_over(tmp_path):
    """Every send timing out exhausts rpc_attempts and surfaces as a
    WorkerDied -> failover; with no survivors and no budget, typed
    NoLiveWorkers."""
    from repro_torch.fault.failures import ChaosInjector, installed

    bs, n_items = batches(22, sizes=(18, 12))
    dm = open_db(tmp_path, "exhaust", n_items, workers=1, rpc_attempts=2,
                 rpc_backoff_s=0.01)
    try:
        dm.append(bs[0])
        inj = ChaosInjector().arm("rpc.recv", times=10**9, exc=TimeoutError)
        with installed(inj):
            with pytest.raises(NoLiveWorkers):
                dm.append(bs[1])
        assert dm.stats["rpc_timeouts"] >= 2  # both attempts timed out
        assert dm.stats["rpc_retries"] >= 1
        assert dm.stats["workers_lost"] == 1  # exhaustion ran the failover
    finally:
        dm.close()


def test_respawn_restores_pool_and_answers_exactly(tmp_path, ref_single):
    """With a restart budget, a killed worker is replaced: the pool recovers
    to full size, displaced segments migrate onto the fresh worker
    snapshot-first, and answers stay bit-identical."""
    bs, n_items = batches(23, sizes=(26, 15, 19))
    kw = dict(min_sup=0.15)
    dm = open_db(tmp_path, "respawn", n_items, workers=2, restart_budget=2)
    try:
        for b in bs:
            dm.append(b)
        expect(ref_single, dm, bs, n_items, **kw)
        victim = min(m.worker for m in dm._segments.values())
        dm.kill_worker(victim)
        expect(ref_single, dm, bs, n_items, **kw)  # failover + respawn mid-query
        assert dm.stats["respawns"] == 1
        assert dm.stats["reassign_rebuilds"] == 0  # snapshot-only recovery
        assert len(dm._live()) == 2  # pool is whole again
        live_ids = {w.wid for w in dm._live()}
        assert victim not in live_ids
        owners = {m.worker for m in dm._segments.values()}
        assert owners <= live_ids and max(live_ids) in owners
        fresh = dm._workers[max(live_ids)]
        assert fresh.device == "cpu" and fresh.hello_s > 0
        extra = random_db(np.random.default_rng(31), 12, n_items, 6)
        dm.append(extra)
        expect(ref_single, dm, bs + [extra], n_items, **kw)
    finally:
        dm.close()


def test_respawn_budget_spent_pool_shrinks(tmp_path, ref_single):
    bs, n_items = batches(24, sizes=(20, 14))
    dm = open_db(tmp_path, "budget", n_items, workers=2, restart_budget=1)
    try:
        for b in bs:
            dm.append(b)
        for _ in range(2):
            dm.kill_worker(min(w.wid for w in dm._live()))
            expect(ref_single, dm, bs, n_items, min_sup=0.2)
        assert dm.stats["respawns"] == 1  # second death: budget exhausted
        assert len(dm._live()) == 1  # now the pool has shrunk for good
    finally:
        dm.close()


def test_coordinator_checkpoint_replays_identical_database(tmp_path, ref_single):
    """Restarting the coordinator from its append-log checkpoint yields the
    same SegmentedDB — rank space, row totals, digest, answers — with
    segments restored from snapshots and the recorded placement honored."""
    bs, n_items = batches(25, sizes=(24, 16, 20))
    kw = dict(min_sup=0.15)
    snap, ck = tmp_path / "snap", str(tmp_path / "ck")
    empty = np.full((5, 6), -1, np.int32)  # pad-only batch: rows, no segment
    dm1 = open_db(snap, "ck", n_items, workers=2, checkpoint_dir=ck)
    try:
        for b in bs:
            dm1.append(b)
        dm1.append(empty)
        ref = expect(ref_single, dm1, bs + [empty], n_items, **kw)
        placement1 = {s: m.worker for s, m in dm1._segments.items()}
        digest1, n_rows1 = dm1._db_digest(), dm1.db.n_rows
    finally:
        dm1.close()

    dm2 = open_db(snap, "ck2", n_items, workers=2, checkpoint_dir=ck)
    try:
        assert dm2.stats["restored_appends"] == len(bs) + 1
        assert dm2.db.n_rows == n_rows1 and dm2._db_digest() == digest1
        assert {s: m.worker for s, m in dm2._segments.items()} == placement1
        assert dm2.mine(spec(tm, **kw)).itemsets == ref.itemsets
        ws = dm2.worker_stats()
        assert sum(s["stats"]["seg_snapshot_hits"] for s in ws.values()) == len(bs)
        assert sum(s["stats"]["seg_prepares"] for s in ws.values()) == 0
        extra = random_db(np.random.default_rng(41), 11, n_items, 6)
        dm2.append(extra)
        ref3 = expect(ref_single, dm2, bs + [empty, extra], n_items, **kw)
    finally:
        dm2.close()

    dm3 = open_db(snap, "ck3", n_items, workers=1, checkpoint_dir=ck)
    try:
        assert dm3.mine(spec(tm, **kw)).itemsets == ref3.itemsets
    finally:
        dm3.close()


def test_checkpoint_rejects_mismatched_n_items(tmp_path):
    import multiprocessing

    bs, n_items = batches(26, sizes=(15,))
    ck = str(tmp_path / "ck")
    dm = tm.MiningEngine(device="cpu").distribute(
        name="ckbad", n_items=n_items, workers=1, spec=spec(tm),
        stream_spec=stream_spec(tm), checkpoint_dir=ck)
    try:
        dm.append(bs[0])
    finally:
        dm.close()
    before = {p.pid for p in multiprocessing.active_children()}
    with pytest.raises(ValueError, match="n_items"):
        tm.MiningEngine(device="cpu").distribute(
            name="ckbad2", n_items=n_items + 1, workers=1, spec=spec(tm),
            stream_spec=stream_spec(tm), checkpoint_dir=ck)
    # the refused coordinator stopped the worker it had spawned
    assert {p.pid for p in multiprocessing.active_children()} == before


def test_chaos_wire_frames_hold_numpy_and_scalars_only(cluster, wire):
    assert wire["ops"].get("wave", 0) > 0 and wire["bad"] == []
