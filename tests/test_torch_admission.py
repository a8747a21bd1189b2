"""Admission control and QoS of the port's service (``device="cpu"``)
against the reference's: the cases of ``test_admission.py``, each run on
both packages through ``test_torch_service.Side``. Compared with no
tolerance: the queue's counters and its shed/admit decisions, the class of
each typed error, the scheduler's QoS counters and the ``stats()``
surface. The overload case's split between served and rejected requests
depends on thread timing; there both sides are held to the invariants
timing cannot move."""
import time

import numpy as np
import pytest

from test_torch_service import PORT, REF, WAIT, _db, both, outcome, same, same_all


class _Item:
    def __init__(self, nbytes=0, deadline_at=None):
        self.nbytes = nbytes
        self.deadline_at = deadline_at


# --------------------------------------------------------- AdmissionQueue
def test_depth_bound_rejects_without_shedding_no_deadlines():
    def run(s):
        q = s.service.AdmissionQueue(max_depth=2)
        assert q.offer(_Item())[0] and q.offer(_Item())[0]
        admitted, shed = q.offer(_Item())
        assert not admitted and shed == []
        return dict(q.counters), q.depth, q.info()

    want, got = both(run)
    assert got == want and got[0] == {"admitted": 2, "rejected": 1, "shed": 0} and got[1] == 2


def test_byte_budget_counts_in_flight_until_release():
    def run(s):
        q = s.service.AdmissionQueue(max_bytes=100)
        a = _Item(nbytes=60)
        steps = [q.offer(a)[0]]
        assert q.get(0.1) is a  # popped off the queue, still in flight
        steps.append(q.offer(_Item(nbytes=60))[0])  # 60 in flight + 60 > 100
        q.release(a.nbytes)
        steps.append(q.offer(_Item(nbytes=60))[0])
        return steps, q.info()

    want, got = both(run)
    assert got == want and got[0] == [True, False, True]


def test_shed_oldest_deadline_first_in_favor_of_later():
    now = time.monotonic()

    def run(s):
        q = s.service.AdmissionQueue(max_depth=2)
        early = _Item(deadline_at=now + 1.0)
        late = _Item(deadline_at=now + 5.0)
        assert q.offer(early)[0] and q.offer(late)[0]
        names = {id(early): "early", id(late): "late"}
        steps = []
        for it in (_Item(deadline_at=now + 9.0), _Item(deadline_at=now + 0.5), _Item()):
            admitted, shed = q.offer(it)
            steps.append((admitted, [names.get(id(x), "new") for x in shed]))
        return steps, dict(q.counters)

    want, got = both(run)
    assert got == want
    # later deadline evicts `early`; the earliest one is rejected; no deadline
    # sheds `late` (queued deadlines are "older" than infinity)
    assert got[0] == [(True, ["early"]), (False, []), (True, ["late"])] and got[1]["shed"] == 2


def test_byte_shedding_reclaims_victim_bytes():
    now = time.monotonic()

    def run(s):
        q = s.service.AdmissionQueue(max_bytes=100)
        victim = _Item(nbytes=80, deadline_at=now + 1.0)
        assert q.offer(victim)[0]
        admitted, shed = q.offer(_Item(nbytes=90, deadline_at=now + 9.0))
        assert admitted and shed == [victim]
        return q.bytes_in_flight, q.info()

    want, got = both(run)
    assert got == want and got[0] == 90


def test_queue_validates_budgets():
    for s in (REF, PORT):
        with pytest.raises(ValueError):
            s.service.AdmissionQueue(max_depth=0)
        with pytest.raises(ValueError):
            s.service.AdmissionQueue(max_bytes=0)


# -------------------------------------------------------------- MineSpec
def test_spec_validates_deadline():
    for s in (REF, PORT):
        with pytest.raises(ValueError):
            s.spec(min_sup=0.3, deadline_s=0.0)
        with pytest.raises(ValueError):
            s.spec(min_sup=0.3, deadline_s=-1.0)
        sp = s.spec(min_sup=0.3, deadline_s=2.5, priority=3)
        assert sp.deadline_s == 2.5 and sp.priority == 3
        assert s.spec(min_sup=0.3).priority == 0 and s.spec(min_sup=0.3).deadline_s is None


def test_qos_fields_do_not_perturb_prep_keys():
    rows, n_items = _db(0)
    for s in (REF, PORT):
        eng = s.engine()
        fe = eng.frontend("hprepost")
        qos = s.hp(priority=9, deadline_s=60.0)
        assert fe._prep_config(s.hp()) == fe._prep_config(qos)
        assert eng._plan_key(s.req(rows, n_items, s.hp())) == eng._plan_key(s.req(rows, n_items, qos))
    cfg = PORT.engine().frontend("hprepost")._device_config(PORT.hp(priority=9, deadline_s=60.0))
    assert cfg.prep_key() == PORT.engine().frontend("hprepost")._device_config(PORT.hp()).prep_key()


# --------------------------------------------------------------- service
def test_service_overload_resolves_future_with_typed_error():
    rows, n_items = _db(0)
    clean = REF.engine().submit(rows, n_items, REF.hp()).itemsets

    def run(s):
        # depth 1 + a batch window: the first submit occupies the queue until
        # the worker collects it; meanwhile flood past the bound
        with s.svc(batch_window_s=0.1, max_queue_depth=1) as svc:
            done = [outcome(f) for f in [svc.submit(rows, n_items, s.hp()) for _ in range(6)]]
        overloads = [r for r in done if isinstance(r, s.service.Overloaded)]
        served = [r for r in done if not isinstance(r, BaseException)]
        assert len(served) >= 1 and len(overloads) >= 1
        assert len(served) + len(overloads) == 6
        assert all(r.itemsets == clean for r in served)
        assert all(e.shed is False for e in overloads)
        assert svc.stats()["admission"]["rejected"] == len(overloads)
        assert svc.stats["requests"] == len(served)  # accepted only
        return sorted(svc.stats()["admission"])

    want, got = both(run)
    assert got == want


def test_service_byte_budget_rejects_big_requests():
    rows, n_items = _db(0)

    def run(s):
        tiny = int(np.asarray(rows).nbytes) - 1
        with s.svc(max_queue_bytes=tiny, batch_window_s=0.01) as svc:
            err = outcome(svc.submit(rows, n_items, s.hp()))
        assert isinstance(err, s.service.Overloaded) and err.shed is False
        return err, svc.stats()["counters"]

    (je, jc), (te, tc) = both(run)
    same(te, je)
    assert tc == jc and tc["rejected"] == 1


def test_service_deadline_exceeded_before_work():
    rows, n_items = _db(0)

    def run(s):
        with s.svc(batch_window_s=0.0) as svc:
            # warm the prep, then submit an already-tight deadline: it expires
            # during the batch window / queue wait
            warm = svc.submit(rows, n_items, s.hp()).result(timeout=WAIT)
            fut = svc.submit(rows, n_items, s.hp(deadline_s=1e-6))
            time.sleep(0.01)
            err = outcome(fut)
        return warm, err, svc.stats()["counters"], dict(svc.scheduler.stats)

    (jw, je, jc, js), (tw, te, tc, ts) = both(run)
    same(tw, jw)
    same(te, je)
    assert isinstance(te, PORT.service.DeadlineExceeded)
    assert tc == jc and tc["deadline_dropped"] == 1 and ts == js


def test_service_priority_orders_groups():
    rows_a, n_items = _db(0)
    rows_b, _ = _db(1)

    def run(s):
        with s.svc(batch_window_s=0.05) as svc:
            futs = [svc.submit(rows_a, n_items, s.hp()),  # priority 0
                    svc.submit(rows_b, n_items, s.hp(priority=5))]
            out = [f.result(timeout=WAIT) for f in futs]
        return out, dict(svc.scheduler.stats)

    (jo, js), (to, ts) = both(run)
    same_all(to, jo)
    assert ts == js and ts["priority_reordered"] >= 1
    # the high-priority group served first, so the other one's prep overlapped
    assert [r.service_stats["prep_overlapped"] for r in to] == [True, False]


def test_priority_order_is_stable_for_equal_priorities():
    rows_a, n_items = _db(0)
    rows_b, _ = _db(1)

    def run(s):
        with s.svc(batch_window_s=0.05) as svc:
            futs = [svc.submit(rows_a, n_items, s.hp()), svc.submit(rows_b, n_items, s.hp())]
            out = [f.result(timeout=WAIT) for f in futs]
        return out, dict(svc.scheduler.stats)

    (jo, js), (to, ts) = both(run)
    same_all(to, jo)
    assert ts == js and ts["priority_reordered"] == 0


def test_stats_is_dict_and_callable_with_issue_counters():
    def run(s):
        with s.svc(batch_window_s=0.01) as svc:
            assert svc.stats["requests"] == 0  # the dict surface
            snap = svc.stats()
        for key in ("admitted", "rejected", "shed", "deadline_dropped", "retries", "respawns"):
            assert key in snap["counters"], key
        for section in ("service", "admission", "scheduler", "engine", "streams"):
            assert section in snap, section
        return snap

    want, got = both(run)
    assert set(got) == set(want)
    for section in ("counters", "service", "admission", "scheduler", "telemetry", "engine"):
        assert set(got[section]) == set(want[section]), section
    assert got["counters"] == want["counters"] and got["streams"] == {} == want["streams"]
    assert got["engine"]["stats"] == want["engine"]["stats"]


def test_submit_after_close_raises_typed_error():
    rows, n_items = _db(0)

    def run(s):
        svc = s.svc(batch_window_s=0.01)
        svc.close()
        with pytest.raises(s.service.ServiceClosed) as ei:
            svc.submit(rows, n_items, s.hp())
        return ei.value

    want, got = both(run)
    same(got, want)
