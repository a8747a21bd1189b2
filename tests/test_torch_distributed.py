"""The port's distributed mining (``repro_torch.mining.distributed``, workers
on ``device="cpu"``) against the JAX package: placement, the RPC layer, and
the parity cases of ``test_distributed.py``.

Every answer is held, exactly (tolerance: none), to the reference's
single-process ``StreamingMiner`` (``backend="jnp"``, one engine for the
module) on the same seeded batches — itemsets, the ``MineResult`` fields and
the planning counters — and to the port's own ``StreamingMiner`` and
``mine_bruteforce``. One reference ``DistributedMiner`` (two JAX worker
processes) takes the same appends as the port's module cluster, so the
coordinator's ``stats``, each worker's ``stats`` reply (apart from the port's
``launches``), the placement, ``peak_bytes`` and the distributed
``service_stats`` are compared too. Every frame on the port's wire holds
NumPy arrays and scalars only."""
import multiprocessing
import socket

import numpy as np
import pytest
import torch

import repro.mining.distributed as jd
import repro_torch.mining.distributed as td
from repro_torch.core.oracle import mine_bruteforce
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


# ------------------------------------------------------------- placement
def test_choose_worker_picks_least_loaded_deterministically():
    assert td.choose_worker({0: 100, 1: 40, 2: 70}) == 1
    # ties break on worker id, never dict order
    assert td.choose_worker({2: 50, 0: 50, 1: 80}) == 0
    assert td.choose_worker({3: 0}) == 3
    rng = np.random.default_rng(0)
    for _ in range(200):
        loads = {int(w): int(rng.integers(0, 5)) for w in rng.permutation(6)[:4]}
        assert td.choose_worker(dict(loads)) == jd.choose_worker(dict(loads))
    with pytest.raises(ValueError, match="no live workers"):
        td.choose_worker({})


def test_replan_best_fit_decreasing_balances_bytes():
    loads = {1: 100, 2: 300}
    plan = td.replan([(10, 500), (11, 200), (12, 50)], loads)
    # biggest orphan lands on the lightest survivor, then re-balance
    assert plan == {10: 1, 11: 2, 12: 2}
    # loads mutated in place to reflect the plan
    assert loads == {1: 600, 2: 550}
    assert td.replan([], {5: 0}) == {}
    rng = np.random.default_rng(1)
    for _ in range(100):
        lost = [(int(s), int(rng.integers(0, 4))) for s in rng.permutation(20)[:6]]
        loads = {int(w): int(rng.integers(0, 6)) for w in range(3)}
        t_loads, j_loads = dict(loads), dict(loads)
        assert td.replan(lost, t_loads) == jd.replan(lost, j_loads)
        assert t_loads == j_loads


# -------------------------------------------------------------- protocol
def test_protocol_roundtrip_with_arrays():
    from repro.mining.distributed import protocol as jp
    from repro_torch.mining.distributed.protocol import (
        ConnectionClosed, recv_msg, send_msg)

    a, b = socket.socketpair()
    try:
        msg = {
            "op": "wave", "seq": 7,
            "idx": np.arange(3000, dtype=np.int64).reshape(3, 1000),
            "sups": np.array([1, 2, 3], np.int64),
        }
        send_msg(a, msg)
        got = recv_msg(b)
        assert got["op"] == "wave" and got["seq"] == 7
        np.testing.assert_array_equal(got["idx"], msg["idx"])
        np.testing.assert_array_equal(got["sups"], msg["sups"])
        assert got["sups"].dtype == np.int64
        # the framing is the reference's, byte for byte, both ways
        jp.send_msg(a, msg)
        assert recv_msg(b)["seq"] == 7
        send_msg(a, msg)
        assert jp.recv_msg(b)["seq"] == 7
        a.close()
        with pytest.raises(ConnectionClosed):
            recv_msg(b)  # clean EOF is a typed error, not a short read
    finally:
        a.close()
        b.close()


def test_channel_sockets_are_hardened():
    from repro_torch.mining.distributed.transport import Listener, dial

    lst = Listener()
    try:
        peer = dial(lst.address)
        chan = lst.accept(5)
        for c in (peer, chan):
            s = c.sock
            assert s.getsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY) != 0
            assert s.getsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE) != 0
        peer.close()
        chan.close()
    finally:
        lst.close()


def test_channel_half_open_peer_surfaces_as_typed_error():
    """A peer that stops responding trips the bounded recv timeout; a peer
    that dies hard (RST, no clean FIN) surfaces as ConnectionClosed."""
    import struct

    from repro_torch.mining.distributed.protocol import ConnectionClosed
    from repro_torch.mining.distributed.transport import Listener, dial

    lst = Listener()
    try:
        peer = dial(lst.address)
        chan = lst.accept(5)
        with pytest.raises(TimeoutError):
            chan.recv(0.2)
        peer.sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER, struct.pack("ii", 1, 0))
        peer.sock.close()
        with pytest.raises((ConnectionClosed, TimeoutError)):
            chan.recv(5)
        chan.close()
    finally:
        lst.close()


# ---------------------------------------------------------------- parity
@pytest.fixture(scope="module")
def ref_single():
    """The reference's single-process engine, one for the module."""
    return jm.MiningEngine()


@pytest.fixture(scope="module")
def cluster(tmp_path_factory, wire):
    """The port's 2-worker cluster and the reference's, on the same appends."""
    bs, n_items = batches(1, sizes=(25, 18, 31, 12))
    t_eng = tm.MiningEngine(device="cpu", snapshot_dir=str(tmp_path_factory.mktemp("t-snap")))
    j_eng = jm.MiningEngine(snapshot_dir=str(tmp_path_factory.mktemp("j-snap")))
    t_dm = t_eng.distribute(name="t", n_items=n_items, workers=2, spec=spec(tm),
                            stream_spec=stream_spec(tm))
    try:
        j_dm = j_eng.distribute(name="t", n_items=n_items, workers=2, spec=spec(jm),
                                stream_spec=stream_spec(jm))
    except BaseException:
        t_dm.close()
        raise
    try:
        for b in bs:
            got, want = t_dm.append(b), j_dm.append(b)
            got.pop("append_s"), want.pop("append_s")
            assert got == want
        yield t_eng, t_dm, j_dm, bs, n_items
    finally:
        t_dm.close()
        j_dm.close()


@pytest.mark.parametrize("min_sup", [0.5, 0.3, 0.15])
def test_distributed_matches_single_process_and_oracle(cluster, ref_single, min_sup):
    _, dm, j_dm, bs, n_items = cluster
    res = dm.mine(spec(tm, min_sup=min_sup))
    assert_same_result(res, single_process(ref_single, f"p{min_sup}", bs, n_items,
                                           min_sup=min_sup))
    assert_same_result(res, j_dm.mine(spec(jm, min_sup=min_sup)), peak=True, service=True)
    own = single_process(tm.MiningEngine(device="cpu"), "own", bs, n_items, pkg=tm,
                         min_sup=min_sup)
    assert_same_result(res, own)
    allrows = np.concatenate(bs)
    assert res.n_rows == len(allrows)
    assert res.itemsets == mine_bruteforce(allrows, n_items, res.min_count, max_k=4)
    assert res.service_stats["prep_source"] == "distributed"
    assert res.service_stats["workers"] == 2


def test_segments_spread_over_both_workers(cluster):
    _, dm, j_dm, _, _ = cluster
    owners = {m.worker for m in dm._segments.values()}
    assert owners == {0, 1}  # byte-balanced placement used the whole pool
    assert {s: m.worker for s, m in dm._segments.items()} == {
        s: m.worker for s, m in j_dm._segments.items()}
    for s, m in dm._segments.items():
        jm_ = j_dm._segments[s]
        assert (m.nbytes, m.prep_bytes, m.digest, m.seq) == (
            jm_.nbytes, jm_.prep_bytes, jm_.digest, jm_.seq)
        np.testing.assert_array_equal(m.C_block, jm_.C_block)
        np.testing.assert_array_equal(m.local_items, jm_.local_items)
    np.testing.assert_array_equal(dm.db.C, j_dm.db.C)
    np.testing.assert_array_equal(dm.db.counts, j_dm.db.counts)
    assert dm.db.order == j_dm.db.order and dm._db_digest() == j_dm._db_digest()


def test_workers_are_spawned_processes_on_their_devices(cluster):
    _, dm, _, _, _ = cluster
    for w in dm._live():
        assert isinstance(w.proc, multiprocessing.context.SpawnProcess)
        assert w.device == "cpu" and w.pid == w.proc.pid and w.hello_s > 0


def test_stats_and_worker_stats_keys_match_reference(cluster):
    _, dm, j_dm, _, _ = cluster
    assert sorted(dm.stats) == sorted(j_dm.stats)
    t_ws, j_ws = dm.worker_stats(), j_dm.worker_stats()
    assert sorted(t_ws) == sorted(j_ws) == [0, 1]
    for wid in t_ws:
        t, j = dict(t_ws[wid]), j_ws[wid]
        launches = t.pop("launches")  # the port's one addition on the wire
        assert sorted(t) == sorted(j)
        assert sorted(t["stats"]) == sorted(j["stats"])
        for k in ("seg_prepares", "seg_snapshot_hits", "seg_snapshot_misses", "preps"):
            assert t["stats"][k] == j["stats"][k], k
        assert t["segments"] == j["segments"] and t["bytes"] == j["bytes"]
        # the workers run the plain versions on the CPU: no kernel launched
        assert launches == {"nlist_intersect": 0, "nlist_intersect_es": 0,
                            "histogram": 0, "cooccur": 0}


def test_distributed_through_service_future_path(cluster, ref_single):
    eng, dm, j_dm, bs, n_items = cluster
    svc = tm.MiningService(engine=eng)
    try:
        q = spec(tm, min_sup=0.25)
        fut_res = svc.submit_stream(q, stream="t")
        extra = random_db(np.random.default_rng(7), 9, n_items, 6)
        fut_append = svc.append(extra, stream="t")
        assert_same_result(fut_res.result(120),
                           single_process(ref_single, "svc", bs, n_items, min_sup=0.25))
        assert fut_append.result(120)["total_rows"] == dm.db.n_rows
        # the appended batch is part of the database for later queries
        j_dm.append(extra)
        res2 = svc.submit_stream(q, stream="t").result(120)
        assert res2.n_rows == dm.db.n_rows
        assert_same_result(res2, j_dm.mine(spec(jm, min_sup=0.25)), peak=True, service=True)
        counters = svc.stats()["counters"]
        assert counters["retries"] == dm.stats["rpc_retries"] == 0
        assert counters["respawns"] == dm.stats["respawns"] == 0
        assert svc.stats()["streams"]["t"]["appends"] == len(bs) + 1
    finally:
        svc.close()


def test_mixed_device_config_query_rejected(cluster):
    _, dm, _, _, _ = cluster
    with pytest.raises(ValueError, match="device config"):
        dm.mine(spec(tm, candidate_unit=16))
    with pytest.raises(ValueError, match="hprepost"):
        dm.mine(spec(tm, algorithm="apriori"))


def test_wire_frames_hold_numpy_and_scalars_only(cluster, wire):
    from torch_distributed_twin import frame_violations

    # the check itself: a tensor (or any other object) anywhere is caught
    assert frame_violations({"op": "wave", "sups": [np.int64(1), torch.zeros(2)]}) == [
        "frame['sups'][1]: Tensor"]
    _, dm, _, _, _ = cluster
    dm.mine(spec(tm, min_sup=0.15))
    assert wire["ops"].get("wave", 0) > 0 and wire["ops"].get("prep", 0) >= 4
    assert wire["replies"] > wire["ops"]["wave"]
    assert wire["bad"] == []


# ------------------------------------------------------ devices and refusals
def test_worker_devices_round_robin_over_cards(monkeypatch):
    """On a CUDA engine worker ``wid`` binds ``cuda:{wid % cards}``; on any
    other device, the engine's device."""
    from repro_torch.mining.distributed.coordinator import DistributedMiner

    class Stub:
        engine = type("E", (), {"device": torch.device("cuda")})()

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    got = [DistributedMiner._worker_device(Stub, w) for w in range(5)]
    assert got == ["cuda:0", "cuda:1", "cuda:0", "cuda:1", "cuda:0"]
    Stub.engine.device = torch.device("cpu")
    assert DistributedMiner._worker_device(Stub, 3) == "cpu"


def test_coordinator_builds_the_kernels_before_spawning_cuda_workers(monkeypatch):
    from repro_torch.kernels import _cuda
    from repro_torch.mining.distributed import coordinator

    calls = []

    def build_all():
        calls.append("build")
        raise RuntimeError("built first")

    def no_spawn(*a, **k):
        raise AssertionError("a process was started before the kernels were built")

    monkeypatch.setattr(_cuda, "build_all", build_all)
    monkeypatch.setattr(coordinator.mp, "get_context", no_spawn)

    class Stub:
        def _worker_device(self, wid):
            return f"cuda:{wid}"

    with pytest.raises(RuntimeError, match="built first"):
        coordinator.DistributedMiner._spawn_procs(Stub(), [0, 1])
    assert calls == ["build"]


def test_cuda_worker_without_a_card_raises_and_never_runs_on_the_cpu():
    from repro_torch.mining.distributed.worker import worker_main

    if torch.cuda.is_available():
        pytest.skip("checks the refusal where no CUDA device exists")
    before = {p.pid for p in multiprocessing.active_children()}
    # the worker refuses before it dials: nothing listens on this address
    with pytest.raises(RuntimeError, match="no CUDA device"):
        worker_main(("127.0.0.1", 9), 0, "cuda:0", 10, spec(tm), 32, None)
    # the coordinator refuses too, before it spawns anything
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.MiningEngine(device="cuda").distribute(n_items=10, workers=2, spec=spec(tm))
    assert {p.pid for p in multiprocessing.active_children()} == before


def test_worker_that_dies_before_its_hello_fails_the_spawn_at_once(monkeypatch):
    """A worker process that exits before its hello (here: asked for a card
    that does not exist) fails the coordinator's start within seconds, not
    at the spawn deadline, and leaves no process behind."""
    import time

    from repro_torch.kernels import _cuda
    from repro_torch.mining.distributed.coordinator import DistributedMiner

    if torch.cuda.is_available():
        pytest.skip("needs a machine without CUDA, where a CUDA worker cannot start")
    monkeypatch.setattr(_cuda, "build_all", lambda: None)
    monkeypatch.setattr(DistributedMiner, "_worker_device", lambda self, wid: "cuda:0")
    before = {p.pid for p in multiprocessing.active_children()}
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="before its hello"):
        tm.MiningEngine(device="cpu").distribute(n_items=10, workers=2, spec=spec(tm),
                                                 spawn_timeout_s=60)
    assert time.monotonic() - t0 < 30
    assert {p.pid for p in multiprocessing.active_children()} == before


def test_mesh_with_model_groups_is_refused_before_spawning():
    from repro_torch.launch.mesh import make_mesh_from_spec

    before = {p.pid for p in multiprocessing.active_children()}
    eng = tm.MiningEngine(mesh=make_mesh_from_spec("1x2", ["cpu", "cpu"]))
    with pytest.raises(ValueError, match="unpartitioned candidate space"):
        eng.distribute(n_items=10, workers=2, spec=spec(tm))
    assert {p.pid for p in multiprocessing.active_children()} == before


# -------------------------------------------------------------------- CLI
def test_cli_workers_kill_and_respawn_recovers(tmp_path, capsys):
    from repro_torch.launch.mine import main

    results = main([
        "--append", "4", "--workers", "2", "--kill-worker", "--respawn", "1",
        "--snapshot-dir", str(tmp_path), "--dataset", "mushroom", "--scale", "0.05",
        "--sweep", "0.3,0.2", "--device", "cpu", "--stats",
    ])
    out = capsys.readouterr().out
    assert "recovery verified" in out and "segments restored from snapshots only" in out
    assert '"respawns": 1' in out and '"reassign_rebuilds": 0' in out
    assert len(results) == 2


def test_cli_refuses_what_the_reference_refuses(capsys):
    from repro_torch.launch.mine import main

    for argv in (["--workers", "2"], ["--append", "2", "--kill-worker", "--workers", "1"],
                 ["--append", "2", "--respawn", "1"], ["--stats", "--append", "2"],
                 ["--append", "2", "--workers", "2", "--window", "2"]):
        with pytest.raises(SystemExit):
            main(argv + ["--device", "cpu"])
    with pytest.raises(ValueError, match="unpartitioned candidate space"):
        main(["--append", "2", "--workers", "2", "--mesh", "1x2", "--device", "cpu",
              "--dataset", "mushroom", "--scale", "0.02"])
