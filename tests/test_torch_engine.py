"""The port's ``MiningEngine`` (``device="cpu"``) against the reference
``repro.mining.MiningEngine`` on the same request sequences: itemsets and
supports, every ``MineResult`` field but the clocks, ``stats``,
``cache_info()`` counters and the miner's stage counters, with no
tolerance. Cases of ``test_engine_cache.py``, ``test_engine_planning.py``
and ``test_mining_api.py``; the fingerprint memo's mechanics are held on
the port alone."""
import numpy as np
import pytest
import torch

import repro.mining as jm
import repro_torch.mining as tm
from repro.core.encoding import pad_transactions
from repro.data.synth import random_db

SPEC = dict(algorithm="hprepost", max_k=4, candidate_unit=8, min_sup=0.3, nlist_width=16)
RESULT_FIELDS = ("algorithm", "total_count", "n_explicit", "min_count", "n_rows",
                 "peak_bytes", "prep_shared", "service_stats")
PREP_KEYS = ("job1_flist", "job2_ppc_pack", "f2_scan")
PLANNING = ("planned_candidates", "host_pruned_parent", "host_pruned_subset")


def _db(seed=0, n_tx=60, n_items=10):
    return random_db(np.random.default_rng(seed), n_tx, n_items, 6), n_items


def assert_same_result(got, want):
    assert got.itemsets == want.itemsets
    for f in RESULT_FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    if want.flist_items is None:
        assert got.flist_items is None
    else:
        np.testing.assert_array_equal(got.flist_items, want.flist_items)
    assert set(got.stage_times_s) == set(want.stage_times_s)
    for k in PLANNING:
        assert got.stage_times_s.get(k) == want.stage_times_s.get(k), k
    for k in PREP_KEYS:  # paid or zeroed alike
        if k in want.stage_times_s:
            assert (got.stage_times_s[k] == 0.0) == (want.stage_times_s[k] == 0.0), k


class Twin:
    """One reference and one port engine driven by the same requests; every
    answer is compared as it comes back."""

    def __init__(self, **kw):
        self.j = jm.MiningEngine(**kw)
        self.t = tm.MiningEngine(device="cpu", **kw)

    def submit(self, rows, n_items, **spec):
        want = self.j.submit(rows, n_items, jm.MineSpec(**spec))
        got = self.t.submit(rows, n_items, tm.MineSpec(**spec))
        assert_same_result(got, want)
        return got

    def sweep(self, rows, n_items, fracs, **spec):
        want = self.j.sweep(rows, n_items, jm.MineSpec(**spec), fracs)
        got = self.t.sweep(rows, n_items, tm.MineSpec(**spec), fracs)
        for g, w in zip(got, want, strict=True):
            assert_same_result(g, w)
        return got

    def submit_many(self, reqs):
        want = self.j.submit_many([jm.MineRequest(r, n, jm.MineSpec(**s)) for r, n, s in reqs])
        got = self.t.submit_many([tm.MineRequest(r, n, tm.MineSpec(**s)) for r, n, s in reqs])
        for g, w in zip(got, want, strict=True):
            assert_same_result(g, w)
        return got

    def counters(self, **spec):
        """The port miner's stage counters, after holding them, the engine
        stats and the cache counters to the reference's."""
        assert self.t.stats == self.j.stats
        assert self.t.miners_built == self.j.miners_built
        ti, ji = self.t.cache_info(), self.j.cache_info()
        assert ti == ji
        tc = self.t.frontend("hprepost").miner_for(tm.MineSpec(**spec)).stage_counters
        jc = self.j.frontend("hprepost").miner_for(jm.MineSpec(**spec)).stage_counters
        assert tc == jc
        return dict(tc), ti


# ------------------------------------------------- the PreparedDB LRU cache
def test_second_submit_reruns_zero_prep_stages():
    rows, n_items = _db()
    tw = Twin()
    r1 = tw.submit(rows, n_items, **SPEC)
    c1, _ = tw.counters(**SPEC)
    assert c1["job1"] == c1["job2"] == c1["pack"] == c1["f2"] == 1 and not r1.prep_shared
    r2 = tw.submit(rows, n_items, **SPEC)
    c2, info = tw.counters(**SPEC)
    assert all(c2[s] == 1 for s in ("job1", "job2", "pack", "f2"))
    assert info["hits"] == 1 and info["misses"] == 1 and info["entries"] == 1
    assert info["bytes_in_use"] > 0 and r2.prep_shared
    assert all(r2.stage_times_s[k] == 0.0 for k in PREP_KEYS)
    assert r2.itemsets == r1.itemsets


def test_tighter_threshold_served_looser_rebuilds():
    rows, n_items = _db(1)
    tw = Twin()
    tw.submit(rows, n_items, **{**SPEC, "min_sup": 0.2})
    tw.submit(rows, n_items, **{**SPEC, "min_sup": 0.4})  # floor superset: a hit
    c, info = tw.counters(**SPEC)
    assert info["hits"] == 1 and c["job1"] == 1
    tw.submit(rows, n_items, **{**SPEC, "min_sup": 0.1})  # looser: rebuild, replace
    c, info = tw.counters(**SPEC)
    assert info["misses"] == 2 and info["entries"] == 1 and c["job1"] == 2


def test_f1_only_entry_upgrades_then_serves_and_is_never_downgraded():
    rows, n_items = _db(2)
    tw = Twin()
    spec = {**SPEC, "min_sup": 0.15}
    tw.submit(rows, n_items, **{**spec, "max_k": 1})
    assert tw.counters(**spec)[0]["job2"] == 0  # F1-only prep skipped the tree
    res = tw.submit(rows, n_items, **{**spec, "max_k": 3})  # needs waves: rebuild
    assert any(len(s) > 1 for s in res.itemsets)
    tw.submit(rows, n_items, **{**spec, "max_k": 1})  # the full entry serves it
    c, info = tw.counters(**spec)
    assert info["misses"] == 2 and info["hits"] == 1 and c["job2"] == 1
    # a looser max_k=1 build must not replace the waves-capable entry
    tw.submit(rows, n_items, **{**spec, "min_sup": 0.1, "max_k": 1})
    res = tw.submit(rows, n_items, **{**spec, "max_k": 3})
    c, info = tw.counters(**spec)
    assert info["entries"] == 1 and res.prep_shared and c["job2"] == 1


def test_eviction_honors_byte_budget_in_recency_order():
    dbs = [_db(s)[0] for s in (3, 4, 5)]  # same shape + nlist_width: same footprint
    n_items = 10
    probe = Twin()
    probe.submit(dbs[0], n_items, **SPEC)
    one = probe.counters(**SPEC)[1]["bytes_in_use"]
    tw = Twin(prep_cache_bytes=int(one * 2.5))  # fits two, not three
    tw.submit(dbs[0], n_items, **SPEC)
    tw.submit(dbs[1], n_items, **SPEC)
    tw.submit(dbs[0], n_items, **SPEC)  # touch a: b becomes the LRU entry
    tw.submit(dbs[2], n_items, **SPEC)  # evicts b, not a
    tw.submit(dbs[0], n_items, **SPEC)
    _, info = tw.counters(**SPEC)
    assert info["evictions"] == 1 and info["hits"] == 2
    assert info["bytes_in_use"] <= info["byte_budget"]
    tw.submit(dbs[1], n_items, **SPEC)  # the victim misses again
    c, info = tw.counters(**SPEC)
    assert info["misses"] == 4 and c["job1"] == 4


def test_zero_budget_disables_caching():
    rows, n_items = _db(8)
    tw = Twin(prep_cache_bytes=0)
    r1 = tw.submit(rows, n_items, **SPEC)
    r2 = tw.submit(rows, n_items, **SPEC)
    c, info = tw.counters(**SPEC)
    assert info["entries"] == info["hits"] == info["misses"] == 0 and c["job1"] == 2
    assert r1.itemsets == r2.itemsets and not r2.prep_shared


def test_sweep_then_adhoc_submit_hits_group_prep():
    rows, n_items = _db(9)
    tw = Twin()
    tw.sweep(rows, n_items, [0.4, 0.2], **SPEC)
    res = tw.submit(rows, n_items, **{**SPEC, "min_sup": 0.3})
    c, info = tw.counters(**SPEC)
    assert tw.t.stats["prepares"] == 1 and info["hits"] == 1 and c["job1"] == 1
    assert res.prep_shared and res.service_stats["prep_source"] == "cache"


def test_device_config_splits_entries_execution_knobs_share_one():
    rows, n_items = _db(18)
    tw = Twin()
    base = tw.submit(rows, n_items, **SPEC)
    tw.submit(rows, n_items, **{**SPEC, "candidate_unit": 16})  # a prep knob: own entry
    assert tw.counters(**SPEC)[1]["entries"] == 2
    # execution-only knobs: la_block / backend / early_stop / tune hit the warm
    # entry (the reference's backend name is jnp, the port's torch)
    variants = [({"la_block": 128}, {"la_block": 128}), ({"backend": "jnp"}, {"backend": "torch"}),
                ({"early_stop": False}, {"early_stop": False}), ({"tune": True}, {"tune": True})]
    for jv, tv in variants:
        want = tw.j.submit(rows, n_items, jm.MineSpec(**SPEC, **jv))
        got = tw.t.submit(rows, n_items, tm.MineSpec(**SPEC, **tv))
        assert_same_result(got, want)
        assert got.prep_shared and got.itemsets == base.itemsets
    c, info = tw.counters(**SPEC)
    assert info["entries"] == 2 and info["misses"] == 2 and info["hits"] == len(variants)
    assert c["job1"] == 1


def test_cache_info_and_clear_prep_cache():
    rows, n_items = _db(20)
    tw = Twin()
    tw.submit(rows, n_items, **SPEC)
    tw.j.clear_prep_cache()
    tw.t.clear_prep_cache()
    assert tw.counters(**SPEC)[1]["entries"] == 0
    res = tw.submit(rows, n_items, **SPEC)
    assert res.service_stats["prep_source"] == "built"
    assert tw.counters(**SPEC)[1]["misses"] == 2


# ------------------------------------------------------ the fingerprint memo
def test_fingerprint_memoized_per_array_identity(monkeypatch):
    rows, n_items = _db(12)
    eng = tm.MiningEngine(device="cpu")
    digests = []
    real = tm.MiningEngine._digest
    monkeypatch.setattr(tm.MiningEngine, "_digest",
                        staticmethod(lambda arr: digests.append(1) or real(arr)))
    spec = tm.MineSpec(**SPEC)
    eng.submit(rows, n_items, spec)
    eng.submit(rows, n_items, spec.with_(min_sup=0.35))
    eng.sweep(rows, n_items, spec, [0.4, 0.35])
    assert len(digests) == 1  # the resident DB was hashed exactly once
    eng.submit(rows.copy(), n_items, spec)  # same content, new object: re-hashed
    assert len(digests) == 2 and eng.cache_info()["entries"] == 1
    assert eng._fingerprint(rows) == jm.MiningEngine._digest(rows)


def test_fingerprint_memo_invalidation_story():
    rows, n_items = _db(13)
    eng = tm.MiningEngine(device="cpu")
    fp1 = eng._fingerprint(rows)
    assert eng._fingerprint(rows) == fp1 and len(eng._fp_memo) == 1
    assert not rows.flags.writeable  # memoization froze the array
    with pytest.raises(ValueError, match="read-only"):
        rows[0, 0] = (rows[0, 0] + 1) % n_items
    eng.invalidate_fingerprints(rows)  # sanctioned route 1: thaws it
    assert rows.flags.writeable
    rows[0, 0] = (rows[0, 0] + 1) % n_items
    fp2 = eng._fingerprint(rows)
    assert fp2 != fp1
    rows.setflags(write=True)  # sanctioned route 2: unfreeze by hand
    rows[0, 0] = (rows[0, 0] + 1) % n_items
    assert eng._fingerprint(rows) != fp2
    del rows
    other = np.full((3, 2), 1, np.int32)
    assert eng._fingerprint(other)[0] == (3, 2)
    eng.invalidate_fingerprints()
    assert other.flags.writeable and not eng._fp_memo


@pytest.mark.parametrize("route", ["setflags", "preexisting_view"])
def test_mutation_cannot_serve_stale_prep(route):
    rows, n_items = _db(15 if route == "setflags" else 17)
    view = rows[: len(rows) // 2]  # writeable view, taken before the submit
    eng = tm.MiningEngine(device="cpu")
    spec = tm.MineSpec(**SPEC)
    eng.submit(rows, n_items, spec)
    with pytest.raises(ValueError, match="read-only"):
        rows[0, 0] = (rows[0, 0] + 1) % n_items
    if route == "setflags":
        rows.setflags(write=True)
        rows[:] = random_db(np.random.default_rng(16), len(rows), n_items, rows.shape[1])
    else:
        view[0, :] = view[1, :]  # mutates the frozen base, no flag moves
    res = eng.submit(rows, n_items, spec)
    want = jm.MiningEngine().submit(rows.copy(), n_items, jm.MineSpec(**SPEC))
    assert_same_result(res, want)
    assert eng.cache_info()["entries"] == 2  # a second content entry
    eng.invalidate_fingerprints(rows)
    assert rows.flags.writeable  # the memo still remembers it froze the array


# ---------------------------------------------------------- planned sweeps
def test_sweep_runs_prep_once_and_matches_independent_mines():
    rows, n_items = _db()
    spec = {**SPEC, "max_k": 5, "min_sup": 0.5}
    del spec["nlist_width"]
    fracs = [0.4, 0.25, 0.1]
    tw = Twin()
    sweep = tw.sweep(rows, n_items, fracs, **spec)
    c, _ = tw.counters(**spec)
    assert c["job1"] == c["job2"] == c["pack"] == c["f2"] == 1
    assert tw.t.stats["prepares"] == 1 and tw.t.stats["prepared_mines"] == 3
    assert tw.t.miners_built == 1
    payer, shared = sweep[0], sweep[1:]
    assert not payer.prep_shared and sum(payer.stage_times_s[k] for k in PREP_KEYS) > 0
    for res in shared:
        assert res.prep_shared and all(res.stage_times_s[k] == 0.0 for k in PREP_KEYS)
    fresh = tm.MiningEngine(device="cpu")
    for res, frac in zip(sweep, fracs):
        ind = fresh.submit(rows, n_items, tm.MineSpec(**spec).with_(min_sup=frac))
        assert (res.itemsets, res.min_count, res.total_count) == (
            ind.itemsets, ind.min_count, ind.total_count)
    # memory figures follow each threshold's own F-list prefix
    assert 0 < sweep[0].peak_bytes < sweep[2].peak_bytes


def test_submit_many_groups_by_database_content_and_config():
    rows_a, n_items = _db(0)
    rows_b, _ = _db(1)
    spec = {**SPEC, "max_k": 5}
    tw = Twin()
    out = tw.submit_many([
        (rows_a, n_items, {**spec, "min_sup": 0.3}),
        (rows_b, n_items, {**spec, "min_sup": 0.3}),  # other db: no group
        (rows_a, n_items, {"algorithm": "prepost", "min_sup": 0.3}),
        (rows_a, n_items, {**spec, "min_sup": 0.15}),
        (rows_a.copy(), n_items, {**spec, "min_sup": 0.5}),  # same content: grouped
    ])
    tw.counters(**spec)
    assert tw.t.stats["prepares"] == 1 and tw.t.stats["prepared_mines"] == 3
    assert out[2].itemsets == out[0].itemsets
    assert [r.algorithm for r in out] == ["hprepost"] * 2 + ["prepost"] + ["hprepost"] * 2


def test_group_of_max_k_one_requests_skips_tree_build():
    rows, n_items = _db(2)
    spec = {**SPEC, "max_k": 1}
    tw = Twin()
    out = tw.submit_many([(rows, n_items, {**spec, "min_sup": 0.3}),
                          (rows, n_items, {**spec, "min_sup": 0.2})])
    c, _ = tw.counters(**spec)
    assert c["job1"] == 1 and c["job2"] == 0 and c["f2"] == 0
    assert all(r.itemsets and all(len(s) == 1 for s in r.itemsets) and r.peak_bytes > 0
               for r in out)


def test_group_floor_tripping_max_f1_degrades_to_per_request():
    rows = pad_transactions([[0, 1, 2, 3, 4, 5]] * 8 + [[6, 7, 8, 9]] * 2)
    spec = {**SPEC, "max_k": 5, "max_f1": 6}
    tw = Twin()
    ok = tw.submit(rows, 10, **{**spec, "min_sup": 0.5})
    with pytest.raises(ValueError, match="max_f1"):
        tw.t.sweep(rows, 10, tm.MineSpec(**spec), [0.5, 0.2])
    with pytest.raises(ValueError, match="max_f1"):
        tw.j.sweep(rows, 10, jm.MineSpec(**spec), [0.5, 0.2])
    assert tw.t.stats["prepares"] == 0
    j1 = tw.counters(**spec)[0]["job1"]
    swept = tw.sweep(rows, 10, [0.5, 0.6], **spec)  # served from the cached floor
    c, info = tw.counters(**spec)
    assert info["hits"] >= 1 and c["job1"] == j1 and swept[0].itemsets == ok.itemsets


def test_mine_prepared_rejects_looser_threshold_than_floor():
    from repro_torch.core.hprepost import HPrepostConfig, HPrepostMiner

    rows, n_items = _db(3)
    miner = HPrepostMiner("cpu", config=HPrepostConfig(candidate_unit=8))
    prepared = miner.prepare(rows, n_items, 10)
    with pytest.raises(ValueError, match="floor"):
        miner.mine_prepared(prepared, 5)


def test_f2_counter_only_counts_dispatched_scans():
    from repro_torch.core.hprepost import HPrepostConfig, HPrepostMiner

    rows = pad_transactions([[0]] * 9 + [[1]])  # one item survives the floor
    miner = HPrepostMiner("cpu", config=HPrepostConfig(candidate_unit=8))
    miner.prepare(rows, 2, 5)
    assert (miner.stage_counters["job1"], miner.stage_counters["job2"],
            miner.stage_counters["f2"]) == (1, 1, 0)


@pytest.mark.parametrize("algorithm", tm.list_miners())
def test_min_sup_boundary_excluded_across_miners(algorithm):
    rows = pad_transactions([[0, 1], [0, 1], [1]] + [[2]] * 7)
    spec = dict(algorithm=algorithm, min_sup=0.25, candidate_unit=8)
    want = jm.mine(rows, 3, jm.MineSpec(**spec))
    got = tm.mine(rows, 3, tm.MineSpec(**spec), device="cpu")
    assert_same_result(got, want)
    assert got.min_count == 3 and (1,) in got.itemsets and (0,) not in got.itemsets


def test_high_threshold_early_returns_report_real_footprint():
    rows, n_items = _db(5)
    tw = Twin()
    none = tw.submit(rows, n_items, algorithm="hprepost", min_count=len(rows) + 1,
                     candidate_unit=8)
    f1 = tw.submit(rows, n_items, algorithm="hprepost", min_sup=0.2, max_k=1, candidate_unit=8)
    assert none.itemsets == {} and none.peak_bytes > 0
    assert f1.itemsets and all(len(s) == 1 for s in f1.itemsets) and f1.peak_bytes > 0


# ------------------------------------------------------- the session surface
def test_engine_submits_reuse_the_resident_miner(paper_db):
    rows, n_items = paper_db
    tw = Twin()
    spec = dict(algorithm="hprepost", min_count=3, candidate_unit=4)
    r1 = tw.submit(rows, n_items, **spec)
    miner = tw.t.frontend("hprepost").miner_for(tm.MineSpec(**spec))
    tw.submit(rows, n_items, **spec)
    r3 = tw.submit(rows, n_items, **{**spec, "min_count": 2})
    assert tw.t.frontend("hprepost").miner_for(tm.MineSpec(**{**spec, "min_count": 2})) is miner
    tw.counters(**spec)
    assert tw.t.miners_built == 1 and tw.t.stats["submits"] == 3
    assert set(r1.itemsets) <= set(r3.itemsets)


def test_engine_mixed_batch_and_sweep_of_host_miners(paper_db):
    rows, n_items = paper_db
    tw = Twin()
    out = tw.submit_many([(rows, n_items, {"algorithm": "prepost", "min_count": 3}),
                          (rows, n_items, {"algorithm": "fpgrowth", "min_count": 3}),
                          (rows, n_items, {"algorithm": "apriori", "min_count": 3})])
    assert out[0].itemsets == out[1].itemsets == out[2].itemsets
    sweep = tw.sweep(rows, n_items, [0.7, 0.4], algorithm="prepost", min_count=3)
    assert (sweep[0].min_count, sweep[1].min_count) == (5, 3)
    assert tw.t.stats == tw.j.stats and tw.t.cache_info() == tw.j.cache_info()


def test_telemetry_records_every_answer():
    rows, n_items = _db(21)
    eng = tm.MiningEngine(device="cpu")
    eng.sweep(rows, n_items, tm.MineSpec(**SPEC), [0.4, 0.3])
    eng.submit(rows, n_items, tm.MineSpec(**SPEC))
    hists = eng.telemetry.snapshot()["histograms"]
    assert hists["engine.mine_s"]["count"] == 3
    assert hists["engine.prep_s"]["count"] == 1 and hists["engine.cache_hit_s"]["count"] == 1


def test_engine_without_cuda_raises_only_for_the_device_miner(monkeypatch, paper_db):
    rows, n_items = paper_db
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    eng = tm.MiningEngine()
    assert eng.device == torch.device("cuda")
    res = eng.submit(rows, n_items, tm.MineSpec(algorithm="fpgrowth", min_count=3))
    assert res.itemsets == jm.mine(rows, n_items, jm.MineSpec(algorithm="fpgrowth",
                                                              min_count=3)).itemsets
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eng.submit(rows, n_items, tm.MineSpec(min_count=3))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eng.sweep(rows, n_items, tm.MineSpec(min_count=3), [0.5, 0.4])


def test_mine_routes_through_a_default_engine_per_device(paper_db):
    rows, n_items = paper_db
    spec = tm.MineSpec(min_count=3, candidate_unit=4)
    tm.mine(rows, n_items, spec, device="cpu")
    eng = tm._default_engines[torch.device("cpu")]
    hits = eng.cache_info()["hits"]
    res = tm.mine(rows, n_items, spec, device="cpu")
    assert eng.cache_info()["hits"] == hits + 1 and res.prep_shared


def test_core_reexports_the_mining_surface():
    import repro_torch.core as core

    assert core.MineSpec is tm.MineSpec and core.MineResult is tm.MineResult
    assert core.mine is tm.mine and core.MiningEngine is tm.MiningEngine
    assert {"fpgrowth", "apriori"} <= set(tm.list_miners())
