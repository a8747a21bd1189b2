"""The port's ``SnapshotStore`` and snapshot warm starts (``device="cpu"``)
against the reference's on the same requests: a fresh engine on a
populated store prepares nothing and answers identically; corrupt, partial
and tampered entries are misses that heal; the byte-budgeted GC; spill
failures cost the snapshot, never the answer. Cases of
``test_snapshot_store.py``. An entry either package writes is read by the
other's ``get`` and ``PreparedDB.from_host``: the layout is one."""
import json
import os

import numpy as np
import pytest

import repro.mining as jm
import repro_torch.mining as tm
from repro.data.synth import random_db
from repro_torch.mining.service import SnapshotStore

SPEC = dict(algorithm="hprepost", max_k=4, candidate_unit=8, min_sup=0.3, nlist_width=16)
PREP_KEYS = ("job1_flist", "job2_ppc_pack", "f2_scan")
STORE_STATS = ("hits", "misses", "stores", "store_skips", "corrupt", "evictions", "entries",
               "bytes_in_use", "byte_budget")


def _db(seed=0, n_tx=60, n_items=10):
    return random_db(np.random.default_rng(seed), n_tx, n_items, 6), n_items


def _counters(eng, spec):
    return dict(eng.frontend("hprepost").miner_for(spec).stage_counters)


class Twin:
    """A reference and a port engine, each on its own store directory under
    ``root``, driven by the same requests; answers, engine counters and
    store counters are compared as they come back (the two stores hold
    byte-identical entries, under each package's own key)."""

    def __init__(self, root, sub="", **kw):
        def store_kw(tag):
            if "snapshot_store" in kw:
                return {"snapshot_store": kw["snapshot_store"][tag]}
            return {"snapshot_dir": os.path.join(str(root), tag + sub)}

        rest = {k: v for k, v in kw.items() if k != "snapshot_store"}
        self.j = jm.MiningEngine(**store_kw("j"), **rest)
        self.t = tm.MiningEngine(device="cpu", **store_kw("t"), **rest)

    def submit(self, rows, n_items, **spec):
        return self._same(self.j.submit(rows, n_items, jm.MineSpec(**spec)),
                          self.t.submit(rows, n_items, tm.MineSpec(**spec)))

    def sweep(self, rows, n_items, fracs, **spec):
        want = self.j.sweep(rows, n_items, jm.MineSpec(**spec), fracs)
        got = self.t.sweep(rows, n_items, tm.MineSpec(**spec), fracs)
        return [self._same(w, g) for w, g in zip(want, got, strict=True)]

    def _same(self, want, got):
        assert got.itemsets == want.itemsets
        for f in ("total_count", "min_count", "peak_bytes", "prep_shared", "service_stats"):
            assert getattr(got, f) == getattr(want, f), f
        for k in PREP_KEYS:
            assert (got.stage_times_s[k] == 0.0) == (want.stage_times_s[k] == 0.0), k
        self.check()
        return got

    def check(self):
        assert self.t.stats == self.j.stats
        ti, ji = self.t.cache_info(), self.j.cache_info()
        ts, js = ti.pop("snapshot_store", None), ji.pop("snapshot_store", None)
        assert ti == ji
        if js is not None:
            assert {k: ts[k] for k in STORE_STATS} == {k: js[k] for k in STORE_STATS}
        return ti, ts


# ---------------------------------------------------------- warm-start parity
def test_fresh_engine_warm_starts_sweep_with_zero_prep_stages(tmp_path):
    rows, n_items = _db()
    cold = Twin(tmp_path)
    ref = cold.sweep(rows, n_items, [0.4, 0.3, 0.2], **SPEC)
    assert cold.t.snapshot_store.stats["stores"] == 1

    warm = Twin(tmp_path)  # fresh "process"
    out = warm.sweep(rows, n_items, [0.4, 0.3, 0.2], **SPEC)
    assert warm.t.stats["prepares"] == 0
    c = _counters(warm.t, tm.MineSpec(**SPEC))
    assert c["job1"] == c["job2"] == c["pack"] == c["f2"] == 0
    assert warm.t.cache_info()["snapshot_hits"] == 1
    for a, b in zip(ref, out):
        assert (b.itemsets, b.total_count, b.peak_bytes) == (a.itemsets, a.total_count, a.peak_bytes)
        assert b.prep_shared and b.service_stats["prep_source"] == "snapshot"
        assert all(b.stage_times_s[k] == 0.0 for k in PREP_KEYS)


def test_adhoc_submit_warm_starts_and_loads_once(tmp_path):
    rows, n_items = _db(1)
    Twin(tmp_path).submit(rows, n_items, **SPEC)
    warm = Twin(tmp_path)
    r1 = warm.submit(rows, n_items, **SPEC)
    r2 = warm.submit(rows, n_items, **SPEC)
    info, _ = warm.check()
    assert info["snapshot_hits"] == 1 and info["hits"] == 1
    assert (r1.service_stats["prep_source"], r2.service_stats["prep_source"]) == ("snapshot", "cache")
    assert _counters(warm.t, tm.MineSpec(**SPEC))["job1"] == 0


def test_tighter_threshold_served_from_snapshot_looser_rebuilds(tmp_path):
    rows, n_items = _db(2)
    Twin(tmp_path).submit(rows, n_items, **SPEC)
    warm = Twin(tmp_path)
    tight = warm.submit(rows, n_items, **{**SPEC, "min_sup": 0.4})
    loose = warm.submit(rows, n_items, **{**SPEC, "min_sup": 0.15})  # below the stored floor
    assert (tight.service_stats["prep_source"], loose.service_stats["prep_source"]) == (
        "snapshot", "built")
    assert warm.check()[0]["snapshot_misses"] == 1
    third = Twin(tmp_path)  # the re-spill's looser floor serves a third process
    assert third.submit(rows, n_items, **{**SPEC, "min_sup": 0.15}).service_stats[
        "prep_source"] == "snapshot"


def test_snapshot_warm_across_execution_config_change(tmp_path):
    rows, n_items = _db(19)
    Twin(tmp_path).submit(rows, n_items, **SPEC)
    warm = Twin(tmp_path)
    want = warm.j.submit(rows, n_items, jm.MineSpec(**SPEC, la_block=128, backend="jnp",
                                                    early_stop=False))
    got = warm.t.submit(rows, n_items, tm.MineSpec(**SPEC, la_block=128, backend="torch",
                                                   early_stop=False))
    assert got.itemsets == want.itemsets and got.service_stats["prep_source"] == "snapshot"
    info, _ = warm.check()
    assert info["snapshot_hits"] == 1 and info["snapshot_misses"] == 0


def test_spill_policy_keeps_the_better_entry(tmp_path):
    rows, n_items = _db(3)
    first = Twin(tmp_path)
    first.submit(rows, n_items, **SPEC)
    stores = {"j": first.j.snapshot_store, "t": first.t.snapshot_store}
    # a tighter-floor request in another "process" is a snapshot hit: no spill
    other = Twin(tmp_path, snapshot_store=stores)
    other.submit(rows, n_items, **{**SPEC, "min_sup": 0.4})
    assert stores["t"].stats["stores"] == 1
    # an F1-only build at a looser floor never replaces wave state on disk
    fresh = {"j": jm.SnapshotStore(str(tmp_path / "j")), "t": SnapshotStore(str(tmp_path / "t"))}
    third = Twin(tmp_path, snapshot_store=fresh)
    assert third.submit(rows, n_items, **{**SPEC, "max_k": 1, "min_sup": 0.2}).itemsets
    assert fresh["t"].stats["store_skips"] == 1
    (entry,) = fresh["t"].entries()
    assert fresh["t"].peek_meta(os.path.basename(entry))["f1_only"] is False


# ----------------------------------------------------- corruption / partials
def _only_entry(tmp_path, tag):
    (entry,) = SnapshotStore(str(tmp_path / tag)).entries()
    return entry


@pytest.mark.parametrize("damage", ["flip_array_byte", "drop_manifest", "widen_meta"])
def test_damaged_entry_is_a_miss_that_heals(tmp_path, damage):
    rows, n_items = _db({"flip_array_byte": 4, "drop_manifest": 5, "widen_meta": 6}[damage])
    ref = Twin(tmp_path).submit(rows, n_items, **SPEC)
    for tag in ("j", "t"):
        entry = _only_entry(tmp_path, tag)
        if damage == "flip_array_byte":  # the digest catches it
            target = os.path.join(entry, "packed.npy")
            raw = bytearray(open(target, "rb").read())
            raw[-1] ^= 0xFF
            open(target, "wb").write(bytes(raw))
        elif damage == "drop_manifest":  # a partial entry
            os.remove(os.path.join(entry, "manifest.json"))
        else:  # digests pass, the payload no longer matches itself: from_host rejects it
            mpath = os.path.join(entry, "manifest.json")
            manifest = json.load(open(mpath))
            manifest["meta"]["width"] *= 2
            json.dump(manifest, open(mpath, "w"))
    warm = Twin(tmp_path)
    res = warm.submit(rows, n_items, **SPEC)
    assert res.itemsets == ref.itemsets and res.service_stats["prep_source"] == "built"
    info, store = warm.check()
    assert info["snapshot_misses"] == 1
    if damage == "widen_meta":
        # its digests pass, so the store keeps it: the rebuild's spill at the
        # same floor does not improve on it (both packages alike)
        assert store["corrupt"] == 0 and store["store_skips"] == 1
        return
    assert store["corrupt"] == 1 and store["stores"] == 1
    healed = Twin(tmp_path)
    assert healed.submit(rows, n_items, **SPEC).service_stats["prep_source"] == "snapshot"


# ------------------------------------------------------------------ store GC
def test_gc_honors_byte_budget_and_evicts_oldest(tmp_path):
    rows_a, n_items = _db(7)
    rows_b, _ = _db(8)
    probe = Twin(tmp_path, sub="probe")
    probe.submit(rows_a, n_items, **SPEC)
    one = probe.t.snapshot_store.bytes_in_use()
    assert one == probe.j.snapshot_store.bytes_in_use() > 0

    stores = {"j": jm.SnapshotStore(str(tmp_path / "jr"), byte_budget=int(one * 1.5)),
              "t": SnapshotStore(str(tmp_path / "tr"), byte_budget=int(one * 1.5))}
    tw = Twin(tmp_path, snapshot_store=stores)
    tw.submit(rows_a, n_items, **SPEC)
    for s in stores.values():
        os.utime(s.entries()[0], (1, 1))  # age entry a well below entry b
    tw.submit(rows_b, n_items, **SPEC)
    _, store = tw.check()
    assert store["evictions"] == 1 and store["entries"] == 1
    assert store["bytes_in_use"] <= store["byte_budget"]
    assert Twin(tmp_path, snapshot_store=stores).submit(
        rows_b, n_items, **SPEC).service_stats["prep_source"] == "snapshot"
    assert Twin(tmp_path, snapshot_store=stores).submit(
        rows_a, n_items, **SPEC).service_stats["prep_source"] == "built"


def test_zero_budget_store_keeps_nothing(tmp_path):
    rows, n_items = _db(9)
    store = SnapshotStore(str(tmp_path), byte_budget=0)
    tm.MiningEngine(device="cpu", snapshot_store=store).submit(rows, n_items, tm.MineSpec(**SPEC))
    assert store.info()["entries"] == 0 and store.stats["evictions"] == 1


def test_spill_failure_is_best_effort(tmp_path, monkeypatch):
    rows, n_items = _db(14)
    store = SnapshotStore(str(tmp_path))

    def broken_put(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(store, "put", broken_put)
    eng = tm.MiningEngine(device="cpu", snapshot_store=store)
    res = eng.submit(rows, n_items, tm.MineSpec(**SPEC))
    assert res.itemsets and res.service_stats["prep_source"] == "built"
    assert eng.cache_info()["snapshot_spill_failures"] == 1
    assert eng.submit(rows, n_items, tm.MineSpec(**SPEC)).service_stats["prep_source"] == "cache"


# --------------------------------------------- one layout for both packages
def _preps(rows, n_items, floor):
    from repro.compat import make_mesh
    from repro.core.hprepost import HPrepostConfig as JConfig
    from repro.core.hprepost import HPrepostMiner as JMiner
    from repro_torch.core.hprepost import HPrepostConfig, HPrepostMiner

    jminer = JMiner(make_mesh((1, 1), ("data", "model")), config=JConfig(candidate_unit=8))
    tminer = HPrepostMiner("cpu", HPrepostConfig(candidate_unit=8))
    return jminer, tminer, jminer.prepare(rows, n_items, floor), tminer.prepare(rows, n_items, floor)


def _same_payload(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k
        else:
            assert a[k] == b[k], k


def test_entries_cross_packages_both_ways(tmp_path):
    from repro.core.hprepost import PreparedDB as JPreparedDB
    from repro.mining.service import SnapshotStore as JStore
    from repro_torch.core.hprepost import PreparedDB

    rows, n_items = _db(22)
    jminer, tminer, jprep, tprep = _preps(rows, n_items, 12)
    key = "f" * 64  # one key string: the two packages' own keys differ by config
    # the reference writes, the port reads (and the reverse), each through the
    # other's get and PreparedDB.from_host
    JStore(str(tmp_path / "a")).put(key, jprep.to_host())
    got = SnapshotStore(str(tmp_path / "a")).get(key)
    _same_payload(got, tprep.to_host())
    loaded = PreparedDB.from_host(got, tminer)
    assert tminer.mine_prepared(loaded, 15).itemsets == tminer.mine_prepared(tprep, 15).itemsets
    SnapshotStore(str(tmp_path / "b")).put(key, tprep.to_host())
    want = JStore(str(tmp_path / "b")).get(key)
    _same_payload(want, jprep.to_host())
    jloaded = JPreparedDB.from_host(want, jminer)
    assert jminer.mine_prepared(jloaded, 15).itemsets == jminer.mine_prepared(jprep, 15).itemsets
    # the same bytes on disk, file for file
    for name in sorted(os.listdir(tmp_path / "a" / key)):
        assert (tmp_path / "a" / key / name).read_bytes() == (tmp_path / "b" / key / name).read_bytes()


def test_from_host_rejects_shard_count_mismatch():
    from repro_torch.core.hprepost import HPrepostConfig, HPrepostMiner, PreparedDB

    rows, n_items = _db(10)
    miner = HPrepostMiner("cpu", config=HPrepostConfig(candidate_unit=8))
    payload = miner.prepare(rows, n_items, 12).to_host()
    payload["n_shards"] = 2
    with pytest.raises(ValueError, match="shard"):
        PreparedDB.from_host(payload, miner)


def test_store_key_hashes_the_port_prep_config():
    eng = tm.MiningEngine(device="cpu")
    rows, n_items = _db(11)
    spec = tm.MineSpec(**SPEC)
    key = eng._cache_key(rows, n_items, spec)
    miner = eng.frontend("hprepost").miner_for(spec)
    assert eng._store_key(key, miner) == SnapshotStore.key_for(
        "hprepost", key[1], n_items, eng.frontend("hprepost")._prep_config(spec), 1)
    # execution-only knobs leave the key alone
    assert eng._cache_key(rows, n_items, spec.with_(la_block=64, early_stop=False,
                                                    tune=True)) == key
