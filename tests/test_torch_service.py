"""The port's ``MiningService`` and ``GroupScheduler`` (``device="cpu"``)
against the reference's ``repro.mining.service`` on the same seeded
``random_db`` requests: the cases of ``test_service.py``, the service cases
of ``test_chaos.py`` and ``test_telemetry.py::
test_service_stats_report_populated_histograms``, and the port's
``--serve`` CLI.

Each scenario is written once and run on both packages through a
``Side``. Compared with no tolerance: itemsets and every ``MineResult``
field but the clocks (``wall_time_s``, stage times, ``queue_time_s``),
``prep_source``, the class of each typed error, the scheduler, engine and
admission counters, and the ``stats()`` section keys. Where thread timing
decides an outcome (threaded producers, the chaos soak), both sides are
held to what timing cannot move: every answer equals the reference's
clean answer and every accepted Future resolves. Every wait has its own
timeout, so a hang fails the test instead of eating the run's clock.
"""
import dataclasses
import importlib
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

import repro.fault.failures as jfail
import repro.mining as jm
import repro.mining.service as jsvc
import repro_torch.fault.failures as tfail
import repro_torch.mining as tm
import repro_torch.mining.service as tsvc
from repro.data.synth import random_db
from test_torch_engine import assert_same_result

SPEC = dict(algorithm="hprepost", max_k=4, candidate_unit=8, min_sup=0.3, nlist_width=16)
WAIT = 60  # seconds any one Future, drain or thread may take
REPO = Path(__file__).resolve().parents[1]


def _db(seed=0, n_tx=60, n_items=10):
    return random_db(np.random.default_rng(seed), n_tx, n_items, 6), n_items


@dataclasses.dataclass(frozen=True)
class Side:
    """One package's serving surface: the reference or the port on the CPU."""

    name: str
    mining: object
    service: object
    failures: object
    device_kw: tuple

    def spec(self, **kw):
        return self.mining.MineSpec(**kw)

    def hp(self, **kw):  # the shared hprepost spec with overrides
        return self.mining.MineSpec(**{**SPEC, **kw})

    def req(self, rows, n_items, spec):
        return self.mining.MineRequest(rows, n_items, spec)

    def engine(self, **kw):
        return self.mining.MiningEngine(**dict(self.device_kw), **kw)

    def svc(self, **kw):
        return self.service.MiningService(**dict(self.device_kw), **kw)

    def scheduler(self, engine, **kw):
        return self.service.GroupScheduler(engine, **kw)

    def chaos(self, *points, seed=None, **arm):
        inj = self.failures.ChaosInjector(seed=seed)
        for p in points:
            inj.arm(p, **arm)
        return inj


REF = Side("reference", jm, jsvc, jfail, ())
PORT = Side("port", tm, tsvc, tfail, (("device", "cpu"),))


def both(scenario):
    """``(reference's outcome, port's outcome)`` of one scenario."""
    return scenario(REF), scenario(PORT)


def _no_clock(res):
    ss = {k: v for k, v in res.service_stats.items() if k != "queue_time_s"}
    return dataclasses.replace(res, service_stats=ss)


def same(got, want):
    """One slot of a batch: the same typed error, or the same result but
    for the clocks."""
    if isinstance(want, BaseException):
        assert isinstance(got, BaseException), got
        assert type(got).__name__ == type(want).__name__, (got, want)
        return
    assert not isinstance(got, BaseException), got
    assert_same_result(_no_clock(got), _no_clock(want))


def same_all(got, want):
    for g, w in zip(got, want, strict=True):
        same(g, w)


def drain(svc):
    """``svc.drain()`` within ``WAIT`` seconds."""
    t = threading.Thread(target=svc.drain, daemon=True)
    t.start()
    t.join(WAIT)
    assert not t.is_alive(), "drain() hung"


def outcome(fut):
    exc = fut.exception(timeout=WAIT)
    return exc if exc is not None else fut.result()


# ------------------------------------------------------------- scheduler
def test_scheduler_matches_independent_submits_across_groups():
    rows_a, n_items = _db(0)
    rows_b, _ = _db(1)

    def run(s):
        reqs = [
            s.req(rows_a, n_items, s.hp(min_sup=0.4)),
            s.req(rows_a, n_items, s.hp(min_sup=0.25)),
            s.req(rows_b, n_items, s.hp()),
            s.req(rows_a, n_items, s.spec(algorithm="fpgrowth", min_sup=0.3, max_k=4)),
            s.req(rows_b, n_items, s.spec(algorithm="apriori", min_sup=0.3, max_k=4)),
        ]
        eng = s.engine()
        with s.scheduler(eng) as sched:
            out = sched.run(reqs)
        fresh = s.engine()
        for r, res in zip(reqs, out):
            assert res.itemsets == fresh.submit(r.rows, r.n_items, r.spec).itemsets
        return out, dict(sched.stats), dict(eng.stats), eng.cache_info()

    (jo, js, je, jc), (to, ts, te, tc) = both(run)
    same_all(to, jo)
    assert ts == js and te == je and tc == jc
    assert ts["device_groups"] == 2 and ts["host_requests"] == 2 and te["prepares"] == 2


def test_scheduler_overlap_attribution_and_counters():
    rows_a, n_items = _db(2)
    rows_b, _ = _db(3)

    def run(s):
        eng = s.engine()
        reqs = [s.req(rows_a, n_items, s.hp()), s.req(rows_b, n_items, s.hp())]
        with s.scheduler(eng) as sched:
            out = sched.run(reqs)
        with s.scheduler(eng) as sched2:  # cache hits are never overlapped prepares
            out2 = sched2.run(reqs)
        return out, out2, dict(sched.stats), dict(sched2.stats)

    (jo, jo2, js, js2), (to, to2, ts, ts2) = both(run)
    same_all(to, jo)
    same_all(to2, jo2)
    assert ts == js and ts2 == js2
    assert [r.service_stats["prep_overlapped"] for r in to] == [False, True]
    assert ts["overlapped_prepares"] == 1 and ts2["overlapped_prepares"] == 0
    assert all(r.service_stats["prep_source"] == "cache" for r in to2)


def test_scheduler_sequential_mode_matches_overlapped():
    rows_a, n_items = _db(4)
    rows_b, _ = _db(5)

    def run(s):
        reqs = [s.req(rows_a, n_items, s.hp(min_sup=0.25)),
                s.req(rows_b, n_items, s.hp(min_sup=0.25))]
        with s.scheduler(s.engine(), overlap=False) as seq:
            a = seq.run(list(reqs))
        with s.scheduler(s.engine()) as ovl:
            b = ovl.run(list(reqs))
        return a, b, dict(seq.stats), dict(ovl.stats)

    (ja, jb, js, jo), (ta, tb, ts, to) = both(run)
    same_all(ta, ja)
    same_all(tb, jb)
    assert ts == js and to == jo and ts["overlapped_prepares"] == 0
    assert [x.itemsets for x in ta] == [y.itemsets for y in tb]


def test_scheduler_group_guard_degrades_per_request():
    from repro.core.encoding import pad_transactions

    # loose floor trips max_f1 (K=10 > 6); the tight request alone passes
    rows = pad_transactions([[0, 1, 2, 3, 4, 5]] * 8 + [[6, 7, 8, 9]] * 2)

    def run(s):
        spec = s.hp(max_f1=6, nlist_width=None)
        with s.scheduler(s.engine()) as sched:
            out = sched.run([s.req(rows, 10, spec.with_(min_sup=0.5)),
                             s.req(rows, 10, spec.with_(min_sup=0.2))],
                            return_exceptions=True)
        return out, dict(sched.stats)

    (jo, js), (to, ts) = both(run)
    same_all(to, jo)
    assert ts == js and ts["degraded_groups"] == 1
    assert to[0].itemsets and isinstance(to[1], ValueError)


def test_scheduler_error_isolation_as_values_or_raise():
    rows, n_items = _db(6)

    def run(s):
        bad = s.req(rows, n_items, s.spec(algorithm="prepost+", min_sup=0.3, patterns="closed"))
        good = s.req(rows, n_items, s.hp())
        with s.scheduler(s.engine()) as sched:
            out = sched.run([bad, good], return_exceptions=True)
            with pytest.raises(ValueError):
                sched.run([bad, good])
        return out

    jo, to = both(run)
    same_all(to, jo)
    assert isinstance(to[0], ValueError) and to[1].itemsets


# --------------------------------------------------------------- service
def test_service_coalesces_concurrent_submits_into_one_planned_batch():
    rows, n_items = _db(7)

    def run(s):
        with s.svc(batch_window_s=0.05) as svc:
            futs = svc.sweep(rows, n_items, s.hp(), [0.4, 0.3, 0.2])
            drain(svc)
            out = [f.result(timeout=WAIT) for f in futs]
            return out, dict(svc.stats), dict(svc.engine.stats)

    (jo, js, je), (to, ts, te) = both(run)
    same_all(to, jo)
    assert ts == js and te == je
    assert ts["batches"] == 1 and ts["max_batch"] == 3 and te["prepares"] == 1
    assert all(r.service_stats["batch_size"] == 3 and r.service_stats["queue_time_s"] >= 0.0
               for r in to)


def test_service_telemetry_and_mixed_algorithms():
    rows, n_items = _db(8)

    def run(s):
        with s.svc(batch_window_s=0.05) as svc:
            f1 = svc.submit(rows, n_items, s.hp())
            f2 = svc.submit(rows, n_items, s.spec(algorithm="apriori", min_sup=0.3, max_k=4))
            return f1.result(timeout=WAIT), f2.result(timeout=WAIT)

    jo, to = both(run)
    same_all(to, jo)
    r1, r2 = to
    assert r1.itemsets == r2.itemsets and r1.service_stats["prep_source"] == "built"
    assert "prep_overlapped" in r1.service_stats
    assert r2.service_stats["batch_size"] == r1.service_stats["batch_size"]


def test_service_per_request_failure_does_not_poison_the_batch():
    rows, n_items = _db(9)

    def run(s):
        with s.svc(batch_window_s=0.05) as svc:
            bad = svc.submit(rows, n_items,
                             s.spec(algorithm="prepost+", min_sup=0.3, patterns="maximal"))
            good = svc.submit(rows, n_items, s.hp())
            return outcome(bad), outcome(good)

    jo, to = both(run)
    same_all(to, jo)
    assert isinstance(to[0], ValueError) and to[1].itemsets


def test_service_warm_starts_from_snapshot_dir(tmp_path):
    rows, n_items = _db(10)

    def run(s):
        sd = str(tmp_path / s.name)
        with s.svc(snapshot_dir=sd, batch_window_s=0.05) as svc:
            ref = [f.result(timeout=WAIT) for f in svc.sweep(rows, n_items, s.hp(), [0.4, 0.3])]
        with s.svc(snapshot_dir=sd, batch_window_s=0.05) as svc2:
            out = [f.result(timeout=WAIT) for f in svc2.sweep(rows, n_items, s.hp(), [0.4, 0.3])]
            return ref, out, dict(svc2.engine.stats), svc2.engine.cache_info()["snapshot_hits"]

    (jr, jo, je, jh), (tr, to, te, th) = both(run)
    same_all(tr, jr)
    same_all(to, jo)
    assert te == je and th == jh == 1 and te["prepares"] == 0
    assert all(b.service_stats["prep_source"] == "snapshot" for b in to)
    assert [a.itemsets for a in tr] == [b.itemsets for b in to]


def test_service_drain_close_and_submit_after_close():
    rows, n_items = _db(11)

    def run(s):
        svc = s.svc(batch_window_s=0.01)
        futs = [svc.submit(rows, n_items, s.hp(min_sup=m)) for m in (0.4, 0.3)]
        drain(svc)
        assert all(f.done() for f in futs)
        svc.close()
        svc.close()  # idempotent
        with pytest.raises(RuntimeError, match="closed") as ei:
            svc.submit(rows, n_items, s.hp())
        return [f.result(timeout=WAIT) for f in futs], ei.value

    (jo, je), (to, te) = both(run)
    for g, w in zip(to, jo, strict=True):  # two batches or one: timing decides
        assert g.itemsets == w.itemsets
    same(te, je)


def test_service_cancelled_future_neither_kills_worker_nor_blocks_drain():
    rows, n_items = _db(14)

    def run(s):
        with s.svc(batch_window_s=0.3) as svc:
            doomed = svc.submit(rows, n_items, s.hp())
            live = svc.submit(rows, n_items, s.hp(min_sup=0.25))
            assert doomed.cancel()  # still queued: cancellable
            drain(svc)  # must account the cancelled slot, not hang on it
            assert doomed.cancelled()
            res = live.result(timeout=WAIT)
            after = svc.submit(rows, n_items, s.hp()).result(timeout=WAIT)
            return res, after

    (jr, ja), (tr, ta) = both(run)
    same(tr, jr)
    same(ta, ja)
    assert tr.service_stats["batch_size"] == 1 and ta.itemsets


def test_service_threaded_producers_all_resolve():
    rows_a, n_items = _db(12)
    rows_b, _ = _db(13)
    clean = {}
    eng = REF.engine()
    for rows, fracs in ((rows_a, (0.4, 0.3, 0.25)), (rows_b, (0.35, 0.3, 0.25))):
        for m in fracs:
            clean[id(rows), m] = eng.submit(rows, n_items, REF.hp(min_sup=m)).itemsets

    def run(s):
        futs, lock = [], threading.Lock()

        def producer(rows, fracs, svc):
            for m in fracs:
                f = svc.submit(rows, n_items, s.hp(min_sup=m))
                with lock:
                    futs.append((rows, m, f))
                time.sleep(0.002)

        with s.svc(batch_window_s=0.05) as svc:
            threads = [
                threading.Thread(target=producer, args=(rows_a, (0.4, 0.3, 0.25), svc)),
                threading.Thread(target=producer, args=(rows_b, (0.35, 0.3, 0.25), svc)),
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join(WAIT)
                assert not t.is_alive()
            drain(svc)
            assert svc.stats["requests"] == 6
            for rows, m, f in futs:
                assert f.result(timeout=WAIT).itemsets == clean[id(rows), m]
        return len(futs)

    assert both(run) == (6, 6)


def test_close_drains_queued_requests_to_results():
    rows, n_items = _db(14)

    def run(s):
        svc = s.svc(batch_window_s=0.2)
        futs = [svc.submit(rows, n_items, s.hp(min_sup=m)) for m in (0.4, 0.3, 0.25)]
        svc.close()  # default drain=True
        return [f.result(timeout=WAIT) for f in futs]

    jo, to = both(run)
    same_all(to, jo)


def test_close_without_drain_fails_queued_fast():
    rows, n_items = _db(15)

    def run(s):
        svc = s.svc(batch_window_s=0.0)
        # gate the scheduler so the first batch provably sits mid-execution
        # while more requests pile up behind it in the queue
        gate = threading.Event()
        orig_run = svc.scheduler.run

        def gated_run(reqs, **kw):
            gate.wait(WAIT)
            return orig_run(reqs, **kw)

        svc.scheduler.run = gated_run
        first = svc.submit(rows, n_items, s.hp())
        deadline = time.monotonic() + 10
        while svc._q.depth and time.monotonic() < deadline:
            time.sleep(0.01)  # the worker popped `first`, now blocked at the gate
        queued = [svc.submit(rows, n_items, s.hp()) for _ in range(3)]
        closer = threading.Thread(target=lambda: svc.close(drain=False))
        closer.start()
        fast = [f.exception(timeout=10) for f in queued]  # while the batch still runs
        gate.set()
        closer.join(WAIT)
        assert not closer.is_alive()
        return fast, first.result(timeout=WAIT)

    (jf, jr), (tf, tr) = both(run)
    same_all(tf, jf)
    same(tr, jr)
    assert all(isinstance(e, tsvc.ServiceClosed) for e in tf)


# ----------------------------------------------- chaos (service cases)
def _mine_clean(rows, n_items, **kw):
    return REF.engine().submit(rows, n_items, REF.hp(**kw)).itemsets


def test_chaos_enqueue_resolves_future_and_service_survives():
    rows, n_items = _db(0)

    def run(s):
        with s.svc(batch_window_s=0.01) as svc:
            with s.failures.installed(s.chaos("service.enqueue")):
                bad = outcome(svc.submit(rows, n_items, s.hp()))
                ok = svc.submit(rows, n_items, s.hp()).result(timeout=WAIT)
        return bad, ok, svc.stats["requests"]

    (jb, jo, jn), (tb, to, tn) = both(run)
    same(tb, jb)
    same(to, jo)
    assert isinstance(tb, tfail.SimulatedFailure) and tn == jn == 1
    assert to.itemsets == _mine_clean(rows, n_items)


def test_chaos_serve_crash_restarts_worker_and_fails_only_that_batch():
    rows, n_items = _db(0)

    def run(s):
        with s.svc(batch_window_s=0.0) as svc:
            with s.failures.installed(s.chaos("service.serve")):
                bad = outcome(svc.submit(rows, n_items, s.hp()))
                restarts = svc.stats["worker_restarts"]
                ok = svc.submit(rows, n_items, s.hp()).result(timeout=WAIT)
        return bad, restarts, ok

    (jb, jn, jo), (tb, tn, to) = both(run)
    same(tb, jb)
    same(to, jo)
    assert isinstance(tb, tfail.SimulatedFailure) and tn == jn == 1
    assert to.itemsets == _mine_clean(rows, n_items)


def test_chaos_prep_failure_pins_to_its_group_only():
    rows, n_items = _db(0)

    def run(s):
        with s.svc(batch_window_s=0.0) as svc:
            with s.failures.installed(s.chaos("service.prep")):
                bad = outcome(svc.submit(rows, n_items, s.hp()))
                restarts = svc.stats["worker_restarts"]  # the loop did NOT die
                ok = svc.submit(rows, n_items, s.hp()).result(timeout=WAIT)
        return bad, restarts, ok

    (jb, jn, jo), (tb, tn, to) = both(run)
    same(tb, jb)
    same(to, jo)
    assert isinstance(tb, tfail.SimulatedFailure) and tn == jn == 0


def test_chaos_wave_launch_failure_resolves_future():
    rows, n_items = _db(0)

    def run(s):
        # min_sup low enough that mining reaches a k>2 wave launch
        spec = s.hp(min_sup=0.15, max_k=5)
        with s.svc(batch_window_s=0.0) as svc:
            warm = svc.submit(rows, n_items, spec).result(timeout=WAIT)  # prep cached
            with s.failures.installed(s.chaos("mine.wave")):
                bad = outcome(svc.submit(rows, n_items, spec))
            ok = svc.submit(rows, n_items, spec).result(timeout=WAIT)
        return warm, bad, ok

    jo, to = both(run)
    same_all(to, jo)
    assert isinstance(to[1], tfail.SimulatedFailure)
    assert to[2].itemsets == _mine_clean(rows, n_items, min_sup=0.15, max_k=5)


def test_chaos_snapshot_read_degrades_to_rebuild(tmp_path):
    rows, n_items = _db(0)

    def run(s):
        sd = str(tmp_path / s.name)
        with s.svc(snapshot_dir=sd, batch_window_s=0.01) as svc:
            svc.submit(rows, n_items, s.hp()).result(timeout=WAIT)  # build + spill
        inj = s.chaos("snapshot.read", times=10**9)
        with s.svc(snapshot_dir=sd, batch_window_s=0.01) as svc:
            with s.failures.installed(inj):
                res = svc.submit(rows, n_items, s.hp()).result(timeout=WAIT)
        return res, inj.fired["snapshot.read"]

    (jr, jn), (tr, tn) = both(run)
    same(tr, jr)
    assert tn == jn >= 1 and tr.service_stats["prep_source"] == "built"


def test_chaos_snapshot_store_get_raises_at_store_level(tmp_path):
    def run(s):
        store = s.service.SnapshotStore(str(tmp_path / s.name))
        with s.failures.installed(s.chaos("snapshot.read")):
            with pytest.raises(s.failures.SimulatedFailure):
                store.get("any-key")

    both(run)


def test_typed_errors_share_a_catchable_base():
    for s in (REF, PORT):
        for name in ("Overloaded", "DeadlineExceeded", "ServiceClosed"):
            exc = getattr(s.service, name)("x")
            assert isinstance(exc, s.service.ServiceError) and isinstance(exc, RuntimeError)


def test_chaos_mini_soak_every_accepted_future_resolves():
    dbs = [_db(0), _db(1)]
    clean = [_mine_clean(rows, n) for rows, n in dbs]

    def run(s):
        inj = s.failures.ChaosInjector(seed=1234)
        inj.arm("service.serve", times=0, prob=0.15)
        inj.arm("service.prep", times=0, prob=0.15)
        inj.arm("service.enqueue", times=0, prob=0.10)
        inj.arm("mine.wave", times=0, prob=0.05)
        with s.svc(batch_window_s=0.01, max_queue_depth=8) as svc:
            with s.failures.installed(inj):
                futs = []
                for k in range(14):
                    rows, n = dbs[k % len(dbs)]
                    spec = s.hp(priority=k % 3, deadline_s=60.0 if k % 4 == 0 else None)
                    futs.append((k, svc.submit(rows, n, spec)))
            # chaos uninstalled; everything already accepted must still resolve
            outcomes = [(k, outcome(f)) for k, f in futs]
        ok = 0
        for k, out in outcomes:
            if isinstance(out, BaseException):
                assert isinstance(out, (s.service.ServiceError, s.failures.SimulatedFailure)), out
            else:
                assert out.itemsets == clean[k % len(dbs)]  # bit-identical
                ok += 1
        assert ok >= 1 and sum(inj.fired.values()) >= 1
        snap = svc.stats()  # the accounting drained fully
        assert snap["admission"]["depth"] == 0 and snap["admission"]["bytes_in_flight"] == 0
        return len(outcomes)

    assert both(run) == (14, 14)


# ------------------------------------------------------------- telemetry
def test_service_stats_report_populated_histograms():
    rows = random_db(np.random.default_rng(1), 140, 10, 6)

    def run(s):
        tel = importlib.import_module(f"{s.mining.__name__}.telemetry")
        spec = s.spec(algorithm="hprepost", max_k=4, candidate_unit=8, min_sup=0.3)
        rec = tel.TraceRecorder()
        with s.svc(batch_window_s=0.01) as svc, tel.trace.attached(rec):
            futs = svc.sweep(rows, 10, spec, [0.3, 0.2])
            futs.append(svc.submit(rows, 10, spec.with_(algorithm="apriori")))
            drain(svc)
            out = [f.result(timeout=WAIT) for f in futs]
            snap = svc.stats()
        hists = snap["histograms"]
        for key in ("admission.queue_wait_s", "engine.prep_s", "engine.mine_s",
                    "service.request_s", "scheduler.serve_s"):
            h = hists[key]
            assert h["count"] >= 1, key
            assert h["min_s"] <= h["p50_s"] <= h["p95_s"] <= h["p99_s"] <= h["max_s"]
        assert hists["service.request_s"]["count"] == 3
        assert snap["telemetry"]["schema"] == tel.SCHEMA_VERSION
        assert snap["telemetry"]["gauges"]["admission.queue_depth"] == 0
        assert snap["telemetry"]["gauges"]["admission.bytes_in_flight"] == 0
        json.dumps(snap, default=str)
        roots = [r for r in rec.to_json() if r["name"] == "request"]
        assert len(roots) == 3
        for r in roots:
            names = {c["name"] for c in r["children"]}
            assert "admission.wait" in names and "resolve" in names
        return out, snap

    (jo, js), (to, ts) = both(run)
    for g, w in zip(to, jo, strict=True):
        assert g.itemsets == w.itemsets
    assert set(ts) == set(js)
    for section in ("counters", "service", "admission", "scheduler", "telemetry"):
        assert set(ts[section]) == set(js[section]), section
    assert set(ts["engine"]) == set(js["engine"]) and ts["streams"] == {} == js["streams"]
    assert ts["counters"] == js["counters"]


# ------------------------------------------------------------------- CLI
CLI_SWEEP = (0.3, 0.2, 0.15)  # the 0.15 mine keeps the serve past two 0.05 s emitter ticks


def _cli(*args):
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.mine", "--serve", "--device", "cpu",
         "--dataset", "mushroom", "--scale", "0.05", "--sweep", ",".join(map(str, CLI_SWEEP)),
         *args],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=120,
    )
    assert p.returncode == 0, p.stdout + p.stderr
    return p.stdout


def test_cli_serve_observability_then_warm_start(tmp_path):
    from repro.core.prepost import mine_prepost
    from repro.data import synth

    snaps, trace_file = tmp_path / "snaps", tmp_path / "trace.json"
    out = _cli("--stats", "--trace", str(trace_file), "--stats-interval", "0.05",
               "--stats-out", str(tmp_path / "stats.jsonl"), "--expect-obs",
               "--snapshot-dir", str(snaps))
    assert "observability verified" in out and "prepares=1" in out
    assert json.loads(trace_file.read_text())
    # each threshold's count against the reference's host PrePost miner
    rows, n_items = synth.load("mushroom", scale=0.05)
    for frac in CLI_SWEEP:
        mc = jm.MineSpec(min_sup=frac).resolve(len(rows))
        n = len(mine_prepost(rows, n_items, mc, max_k=5).itemsets)  # the CLI's --max-k 5
        assert f"min_sup={frac:g} -> hprepost: {n} frequent itemsets" in out
    warm = _cli("--snapshot-dir", str(snaps), "--expect-warm")
    assert "warm start verified" in warm and "prepares=0" in warm
    assert warm.count("prep=snapshot") == len(CLI_SWEEP)


# ------------------------------------------------------ launch counting
def test_launch_counter_exact_under_threads():
    """The kernel wrappers count launches through ``_cuda.count_launch``;
    the service's prep and serving threads launch at once, so the count
    must not lose an update. More threads than cores, a short switch
    interval, and a plain function object in place of a wrapper."""
    from repro_torch.kernels import _cuda

    def fn():
        pass

    fn.launches = 0
    n_threads, per = 2 * (os.cpu_count() or 4), 5000
    threads = [threading.Thread(target=lambda: [_cuda.count_launch(fn) for _ in range(per)])
               for _ in range(n_threads)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert fn.launches == n_threads * per
