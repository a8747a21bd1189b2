"""The port's ``KernelTuner`` and per-shape wave plans on the CPU (the
plain versions timed): a cold search persists ``kernel_plans.json`` in the
reference's schema, a warm tuner makes zero trials, keys bucket the shape
and split on backend, device type and early stop, a failed search raises,
and tuned mines — through the miner and through the engine — answer the
same itemsets as untuned ones and as the reference's tuned engine. Cases of
``test_tune.py``."""
import json
import os

import numpy as np
import pytest

import repro.mining as jm
import repro_torch.mining as tm
from repro.data.synth import random_db
from repro.mining.tune import KernelTuner as JTuner
from repro_torch.core.hprepost import HPrepostConfig, HPrepostMiner
from repro_torch.mining import tune
from repro_torch.mining.tune import PLANS_FILENAME, PLANS_SCHEMA, KernelTuner


def test_plans_file_keeps_the_reference_schema():
    from repro.mining import tune as jtune

    assert (PLANS_SCHEMA, PLANS_FILENAME) == (jtune.PLANS_SCHEMA, jtune.PLANS_FILENAME)


def test_tuner_cold_search_then_warm_zero_trials(tmp_path):
    d = str(tmp_path)
    t1 = KernelTuner(plan_dir=d, platform="cpu")
    p1 = t1.plan_for(backend="auto", B=8, W=256, early_stop=True)
    assert p1.source == "tuned" and p1.backend == "torch" and p1.la_block == 128
    # three choices clamp to the CPU fixture's width cap (128): one, timed 3x
    assert t1.stats == {"trials": 3, "tuned": 1, "plan_hits": 0, "loaded_plans": 0}
    with open(os.path.join(d, PLANS_FILENAME)) as f:
        doc = json.load(f)
    assert doc["schema"] == PLANS_SCHEMA and list(doc["plans"]) == ["torch|cpu|es1|W256|B8"]
    assert set(doc["plans"]["torch|cpu|es1|W256|B8"]) == {"la_block", "best_us", "trials"}

    assert t1.plan_for(backend="torch", B=7, W=200, early_stop=True).source == "cached"
    t2 = KernelTuner(plan_dir=d, platform="cpu")
    p2 = t2.plan_for(backend="auto", B=8, W=256, early_stop=True)
    assert t2.stats == {"trials": 0, "tuned": 0, "plan_hits": 1, "loaded_plans": 1}
    assert (p2.la_block, p2.source) == (p1.la_block, "cached")


def test_search_space_is_la_block_clamped_to_the_width_bucket(monkeypatch):
    t = KernelTuner(platform="cpu")
    seen = []
    monkeypatch.setattr(t, "_measure_us", lambda backend, B, W, la, es: seen.append(
        (backend, B, W, la, es)) or float(la))
    t.plan_for(backend="torch", B=300, W=700, early_stop=True)
    assert seen == [("torch", 32, 128, 128, True)]  # the plain versions' fixture cap
    seen.clear()
    cuda = KernelTuner(platform="cuda")
    monkeypatch.setattr(cuda, "_measure_us", lambda backend, B, W, la, es: seen.append(
        (backend, B, W, la, es)) or float(1000 - la))
    plan = cuda.plan_for(backend="auto", B=300, W=700, early_stop=True)
    assert seen == [("cuda", 512, 1024, la, True) for la in (128, 256, 512)]
    assert (plan.backend, plan.la_block) == ("cuda", 512)  # the fastest
    seen.clear()
    cuda.plan_for(backend="auto", B=300, W=20, early_stop=True)  # W bucket 32
    cuda.plan_for(backend="auto", B=300, W=700, early_stop=False)  # B1 reads no tile
    assert seen == [("cuda", 512, 32, 32, True), ("cuda", 512, 1024, 512, False)]


def test_tuner_ignores_foreign_schema(tmp_path):
    with open(os.path.join(str(tmp_path), PLANS_FILENAME), "w") as f:
        json.dump({"schema": PLANS_SCHEMA + 1, "plans": {"x": {}}}, f)
    assert KernelTuner(plan_dir=str(tmp_path)).stats["loaded_plans"] == 0


def test_tuner_keys_split_by_backend_shape_and_early_stop():
    t = KernelTuner(platform="cpu")
    k = t._key("torch", B=100, W=300, early_stop=True)
    assert k == "torch|cpu|es1|W512|B128"
    assert t._key("torch", 100, 300, False) != k
    assert t._key("cuda", 100, 300, True) != k
    assert KernelTuner(platform="cuda")._key("torch", 100, 300, True) != k
    assert t._key("torch", 65, 257, True) == k  # same bucket, same key


def test_one_plans_file_serves_both_packages(tmp_path):
    """A reference tuner and a port tuner on one directory keep each other's
    plans: each loads the other's key and searches only its own."""
    d = str(tmp_path)
    JTuner(plan_dir=d).plan_for(backend="jnp", B=8, W=16, early_stop=True)
    t = KernelTuner(plan_dir=d, platform="cpu")
    assert t.stats["loaded_plans"] == 1
    t.plan_for(backend="torch", B=8, W=16, early_stop=True)
    assert t.stats["tuned"] == 1
    j2 = JTuner(plan_dir=d)
    assert j2.stats["loaded_plans"] == 2
    j2.plan_for(backend="jnp", B=8, W=16, early_stop=True)
    assert j2.stats["trials"] == 0 and j2.stats["plan_hits"] == 1
    assert KernelTuner(plan_dir=d, platform="cpu").plan_for(
        backend="torch", B=8, W=16, early_stop=True).source == "cached"


def test_failed_search_raises(monkeypatch):
    from repro_torch.kernels.nlist_intersect import ops

    def broken(*a, **k):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(ops, "nlist_intersect", broken)
    t = KernelTuner(platform="cpu")
    with pytest.raises(RuntimeError, match="launch failed"):
        t.plan_for(backend="torch", B=8, W=16, early_stop=True)
    assert not t._plans  # nothing persisted, no static plan handed back


def test_miner_resolves_one_plan_per_shape_bucket(paper_db):
    rows, n_items = paper_db
    cfg = HPrepostConfig(candidate_unit=4, la_block=64)
    static = HPrepostMiner("cpu", cfg)
    static.tuner = KernelTuner(platform="cpu")  # attached, but tune is off
    base = static.mine(rows, n_items, 2)
    assert static.tuner.stats["trials"] == 0
    assert {(p.la_block, p.source) for p in static._plan_cache.values()} == {(64, "config")}
    assert static._kernel_plan(5, 20) is static._kernel_plan(8, 32)  # one bucket

    tuned = HPrepostMiner("cpu", HPrepostConfig(candidate_unit=4, tune=True))
    tuned.tuner = KernelTuner(platform="cpu")
    assert tuned.mine(rows, n_items, 2).itemsets == base.itemsets
    assert tuned.tuner.stats["tuned"] == len(tuned._plan_cache) > 0
    assert all(p.source == "tuned" for p in tuned._plan_cache.values())
    tuned_without_tuner = HPrepostMiner("cpu", HPrepostConfig(candidate_unit=4, tune=True))
    assert tuned_without_tuner.mine(rows, n_items, 2).itemsets == base.itemsets


@pytest.mark.parametrize("early_stop", [True, False])
def test_engine_tuned_mines_match_untuned_and_the_reference(tmp_path, early_stop):
    rows = random_db(np.random.default_rng(3), 80, 12, 6)
    spec = dict(algorithm="hprepost", min_count=3, candidate_unit=8, early_stop=early_stop)
    want = jm.MiningEngine().submit(rows, 12, jm.MineSpec(tune=True, **spec))
    cold = tm.MiningEngine(device="cpu", snapshot_dir=str(tmp_path))
    got = cold.submit(rows, 12, tm.MineSpec(tune=True, **spec))
    untuned = tm.MiningEngine(device="cpu").submit(rows, 12, tm.MineSpec(**spec))
    assert got.itemsets == want.itemsets == untuned.itemsets
    assert got.total_count == want.total_count and got.peak_bytes == want.peak_bytes
    assert cold.tuner.stats["trials"] > 0 and cold.tuner.stats["tuned"] > 0
    warm = tm.MiningEngine(device="cpu", snapshot_dir=str(tmp_path))
    again = warm.submit(rows, 12, tm.MineSpec(tune=True, **spec))
    assert again.itemsets == got.itemsets
    assert warm.tuner.stats["trials"] == 0 and warm.tuner.stats["plan_hits"] > 0
    assert warm.tuner.stats["loaded_plans"] == cold.tuner.stats["tuned"]
    assert again.service_stats["prep_source"] == "snapshot"


def test_engine_tuner_keys_on_the_engine_device():
    assert tm.MiningEngine(device="cpu").tuner._platform == "cpu"
    assert tm.MiningEngine().tuner._platform == "cuda"
    assert tune.resolve_backend("auto", tm.MiningEngine(device="cpu").tuner._platform) == "torch"
