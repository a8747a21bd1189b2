"""Port ``HPrepostMiner(device="cpu")`` vs the reference ``HPrepostMiner``
on the 1×1 mesh with ``backend="jnp"``: itemsets, stage counters, the
planning counters and the ``PreparedDB.to_host()`` payload (key by key,
dtype and bytes), with early stop on and off. Tolerance 0."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro.core.hprepost import HPrepostConfig as JConfig
from repro.core.hprepost import HPrepostMiner as JMiner
from repro.core.hprepost import PreparedDB as JPreparedDB
from repro.data.synth import load, random_db
from repro_torch.core.hprepost import HPrepostConfig, HPrepostMiner, PreparedDB
from repro_torch.core.prepost import mine_prepost
from repro_torch.mining import telemetry
from repro_torch.mining.telemetry import trace
from repro_torch.fault import failures

PLANNING = ("planned_candidates", "host_pruned_parent", "host_pruned_subset")


@pytest.fixture(scope="module")
def mesh11():
    from repro.compat import make_mesh

    return make_mesh((1, 1), ("data", "model"))


_JAX_MINERS = {}


def _pair(mesh, **cfg):
    # reference miners are cached per config so their jit caches stay warm
    key = tuple(sorted(cfg.items()))
    jm = _JAX_MINERS.get(key)
    if jm is None:
        jm = _JAX_MINERS[key] = JMiner(mesh, config=JConfig(backend="jnp", **cfg))
    tm = HPrepostMiner("cpu", config=HPrepostConfig(**cfg))
    return jm, tm


def assert_payload_equal(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        va, vb = a[k], b[k]
        if isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype and va.shape == vb.shape, k
            assert va.tobytes() == vb.tobytes(), k
        else:
            assert type(va) is type(vb) and va == vb, k


def check_parity(mesh, rows, n_items, min_count, max_k=None, **cfg):
    jm, tm = _pair(mesh, **cfg)
    j0 = dict(jm.stage_counters)
    assert_payload_equal(tm.prepare(rows, n_items, min_count).to_host(),
                         jm.prepare(rows, n_items, min_count).to_host())
    jr = jm.mine(rows, n_items, min_count, max_k=max_k)
    tr = tm.mine(rows, n_items, min_count, max_k=max_k)
    assert tr.itemsets == jr.itemsets
    assert (tr.n_explicit, tr.total_count, tr.peak_bytes) == (jr.n_explicit, jr.total_count, jr.peak_bytes)
    np.testing.assert_array_equal(tr.flist_items, jr.flist_items)
    assert tm.stage_counters == {k: v - j0[k] for k, v in jm.stage_counters.items()}
    for key in PLANNING:
        assert tm.last_stage_times[key] == jm.last_stage_times[key], key
    assert sorted(tm.last_stage_times) == sorted(jm.last_stage_times)
    return tr


@pytest.mark.parametrize("early_stop", [True, False])
def test_paper_db_parity(mesh11, paper_db, early_stop):
    rows, n_items = paper_db
    res = check_parity(mesh11, rows, n_items, 3, candidate_unit=4, early_stop=early_stop)
    assert res.itemsets == mine_prepost(rows, n_items, 3).itemsets


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("min_count", [1, 3])
@pytest.mark.parametrize("early_stop", [True, False])
def test_random_db_parity(mesh11, seed, min_count, early_stop):
    rows = random_db(np.random.default_rng(seed), 80, 12, 7)
    res = check_parity(mesh11, rows, 12, min_count, candidate_unit=8, early_stop=early_stop)
    assert res.itemsets == mine_prepost(rows, 12, min_count).itemsets


@pytest.mark.parametrize("early_stop", [True, False])
@pytest.mark.parametrize("pipeline", [True, False])
def test_dense_parity(mesh11, early_stop, pipeline):
    """Deep enough for the Apriori-closure prune (widths >= 4)."""
    rows, n_items = load("mushroom", scale=0.03)
    res = check_parity(mesh11, rows, n_items, 45, early_stop=early_stop, pipeline_waves=pipeline)
    assert max(len(s) for s in res.itemsets) >= 4


@pytest.mark.parametrize("max_k", [1, 2])
def test_max_k_and_tiny_paths(mesh11, paper_db, max_k):
    rows, n_items = paper_db
    check_parity(mesh11, rows, n_items, 2, max_k=max_k, candidate_unit=4)
    check_parity(mesh11, rows, n_items, 7, candidate_unit=4)  # F1 only survives


def test_from_host_of_reference_payload(mesh11):
    rows, n_items = load("chess", scale=0.05)
    jm, tm = _pair(mesh11)
    payload = jm.prepare(rows, n_items, 100).to_host()
    prep = PreparedDB.from_host(payload, tm)
    assert_payload_equal(prep.to_host(), JPreparedDB.from_host(payload, jm).to_host())
    for mc in (100, 130):
        assert tm.mine_prepared(prep, mc).itemsets == jm.mine(rows, n_items, mc).itemsets
    with pytest.raises(ValueError, match="data shard"):
        PreparedDB.from_host({**payload, "n_shards": 2}, tm)


def test_prep_key_matches_reference():
    # the port keeps only the reference's fields that it reads; on those the
    # prep keys agree, and every port field is one of the reference's
    t = HPrepostConfig(la_block=64, backend="torch", early_stop=False, max_k=3)
    j = JConfig(la_block=64, backend="jnp", early_stop=False, max_k=3)
    tv, jv = dataclass_values(t.prep_key()), dataclass_values(j.prep_key())
    assert set(tv) <= set(jv)
    assert tv == {k: jv[k] for k in tv}
    assert set(t.EXECUTION_ONLY) <= set(j.EXECUTION_ONLY)


def dataclass_values(cfg):
    import dataclasses

    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def test_wave_spans_and_chaos_point(paper_db):
    rows, n_items = paper_db
    miner = HPrepostMiner("cpu", HPrepostConfig(candidate_unit=4))
    rec = telemetry.TraceRecorder()
    with telemetry.attached(rec):
        miner.mine(rows, n_items, 2)
    names = [s["name"] for s in rec.spans.values()]
    assert names.count("mine.wave") == miner.stage_counters["waves"] > 0
    assert "mine.reduce" in names
    inj = failures.ChaosInjector().arm("mine.wave")
    with failures.installed(inj), pytest.raises(failures.SimulatedFailure):
        miner.mine(rows, n_items, 2)


# a prepared mine's planning counters, waves, peak and itemset count at
# min_count 2 (paper DB) and 35 (the random DB), held from before the
# prepared path ran the one wave loop through an executor
PREPARED_MINE = {
    ("paper", True): ((8, 0, 0), 2, 896, 14),
    ("paper", False): ((8, 0, 0), 2, 896, 14),
    ("random", True): ((239, 18, 10), 6, 32768, 193),
    ("random", False): ((211, 0, 10), 5, 32768, 193),
}


@pytest.mark.parametrize("db, pipeline", list(PREPARED_MINE))
def test_prepared_mine_stage_dict_and_counters(paper_db, db, pipeline):
    """``mine_prepared``'s stage dict keeps its keys (no ``host_pruned_seed``)
    and planning counters, and ``stage_counters`` one count a prep stage and
    a wave and no ``seg_waves``, pipelined or not."""
    rows, n_items, min_count = (*paper_db, 2) if db == "paper" else (
        random_db(np.random.default_rng(5), 200, 8, 8), 8, 35)
    planning, waves, peak, n_sets = PREPARED_MINE[db, pipeline]
    miner = HPrepostMiner("cpu", HPrepostConfig(candidate_unit=4, pipeline_waves=pipeline))
    res = miner.mine_prepared(miner.prepare(rows, n_items, min_count), min_count)
    stages = miner.last_stage_times
    assert list(stages) == ["job1_flist", "job2_ppc_pack", "f2_scan", "mining_waves", *PLANNING]
    assert tuple(stages[k] for k in PLANNING) == planning
    assert stages["mining_waves"] > 0
    assert miner.stage_counters == {"job1": 1, "job2": 1, "pack": 1, "f2": 1, "waves": waves}
    assert (res.peak_bytes, len(res.itemsets)) == (peak, n_sets)


def test_entry_points_raise_without_cuda(monkeypatch, paper_db):
    from repro_torch.mining import MineSpec, mine
    from repro_torch.mining.miners import HPrepostFrontend

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HPrepostMiner()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HPrepostFrontend()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mine(*paper_db, MineSpec(min_count=2))
    assert HPrepostMiner("cpu").backend == "torch"


def test_tune_and_cuda_backend_raise_on_cpu(paper_db):
    """``tune=True`` resolves its wave plans through an attached
    KernelTuner on the CPU (plain versions timed) and mines the same
    itemsets; the ``cuda`` backend still raises on the CPU."""
    from repro_torch.mining.tune import KernelTuner

    rows, n_items = paper_db
    tuned = HPrepostMiner("cpu", HPrepostConfig(tune=True, candidate_unit=4))
    tuned.tuner = KernelTuner(platform="cpu")
    got = tuned.mine(rows, n_items, 2)
    assert got.itemsets == HPrepostMiner("cpu", HPrepostConfig(candidate_unit=4)).mine(
        rows, n_items, 2).itemsets
    assert tuned.tuner.stats["tuned"] > 0 and tuned.tuner.stats["trials"] > 0
    assert {p.source for p in tuned._plan_cache.values()} == {"tuned"}
    with pytest.raises(ValueError, match="not available"):
        HPrepostMiner("cpu", HPrepostConfig(backend="cuda"))


@pytest.mark.parametrize("early_stop", [True, False])
def test_wave_reads_planes_in_place(monkeypatch, early_stop):
    """Each wave hands the kernel the whole (3, K, W) planes and the
    previous wave's state with its index rows — no gathered copies — and
    its padding rows come back zero; the mine stays exact."""
    from repro_torch.core import hprepost

    rows, n_items = load("mushroom", scale=0.03)
    miner = HPrepostMiner("cpu", HPrepostConfig(early_stop=early_stop))
    calls = []
    real = hprepost.nlist_wave

    def spy(planes, prev_state, idx, n_live, **kw):
        out = real(planes, prev_state, idx, n_live, **kw)
        calls.append((planes, prev_state, idx, n_live, kw, out))
        return out

    monkeypatch.setattr(hprepost, "nlist_wave", spy)
    res = miner.mine(rows, n_items, 45)
    assert res.itemsets == mine_prepost(rows, n_items, 45).itemsets
    assert len(calls) == miner.stage_counters["waves"] > 2
    planes = calls[0][0]
    assert planes.shape[0] == 3 and calls[0][1].data_ptr() == planes[2].data_ptr()
    for i, (p, prev, idx, n_live, kw, (new, sup)) in enumerate(calls):
        assert p is planes and idx.dtype == torch.int64 and idx.shape == (3, new.shape[0])
        assert kw["early_stop"] is early_stop and 0 < n_live <= idx.shape[1]
        assert not new[n_live:].any() and not sup[n_live:].any()
        if i:
            assert prev is calls[i - 1][5][0]


def _kept_by_sets(d_ranks, surv_ranks):
    """The subset check, plainly: a row is kept if each drop-one subset
    but the first is a survivor."""
    surv = set(map(tuple, surv_ranks.tolist()))
    return np.array([all(tuple(r[:p] + r[p + 1:]) in surv for p in range(1, len(r)))
                     for r in d_ranks.tolist()], bool)


def _subset_draw(k_items, width, seed=7):
    """Candidates in [0, k_items) with repeated rows and the top rank
    present; survivors hold every drop-one subset of the first third, all
    but one of the second third's, random rows and repeats."""
    rng = np.random.default_rng([seed, k_items, width])
    d = rng.integers(0, k_items, (36, width)).astype(np.int32)
    d[0] = k_items - 1
    d = np.concatenate([d, d[:6]])
    subs = [[np.delete(r, p) for p in range(1, width)] for r in d[:24]]
    surv = [s for r in subs[:12] for s in r] + [s for r in subs[12:] for s in r[:-1]]
    surv = np.array(surv + list(rng.integers(0, k_items, (20, width - 1))), np.int32)
    return d, np.concatenate([surv, surv[::5]])


@pytest.mark.parametrize("width", range(3, 18))
@pytest.mark.parametrize("k_items", [2, 85, 128, 7104])
def test_apriori_kept_integer_keys(k_items, width):
    """The keyed subset check against sets of tuples and against the
    reference's byte-string check, on one- and many-word keys (at K 128 a
    width-10 row is exactly 63 bits, one word; width 11 takes two)."""
    d, surv = _subset_draw(k_items, width)
    got = HPrepostMiner._apriori_kept(d, surv, k_items)
    want = JMiner._apriori_kept(d, surv)
    if width < 4:
        assert got is None and want is None
        return
    np.testing.assert_array_equal(got, _kept_by_sets(d, surv))
    np.testing.assert_array_equal(got, want)
    if k_items > 2:  # the draw keeps some rows and drops others
        assert got[:12].all() and not got[12:24].all()


@pytest.mark.parametrize("case", ["no_survivors", "no_candidates", "all_dropped"])
def test_apriori_kept_edges(case):
    d, surv = _subset_draw(85, 6)
    if case == "no_survivors":
        assert HPrepostMiner._apriori_kept(d, surv[:0], 85) is None
    elif case == "no_candidates":
        assert HPrepostMiner._apriori_kept(d[:0], surv, 85) is None
    else:  # no subset survives: the early exit returns all False
        other = (surv + 1) % 85
        got = HPrepostMiner._apriori_kept(d, other, 85)
        np.testing.assert_array_equal(got, _kept_by_sets(d, other))
        np.testing.assert_array_equal(got, JMiner._apriori_kept(d, other))


def planted_rows(n_filler: int, m: int = 2):
    """Rows on which the Apriori subset check prunes at two widths.

    For a core group G = (x0, ..., x_{g-1}): ``m`` rows of G less x0 (the
    parent), ``m`` rows of G less x_i for i in 1..g-3, and ``g·m`` rows of
    x0 alone, so x0 ranks first. Every pair of G is frequent and so is the
    parent, but G less x_{g-2} and G less x_{g-1} never occur: G is a
    doomed candidate that only the subset check removes. Two groups, of 8
    and 5 items, prune at widths 8 and 5. ``n_filler`` further items occur
    ``m`` times each, alone, which widens the F-list to 13 + ``n_filler``
    ranks (and so the bits a rank) without a frequent pair."""
    from repro.core.encoding import pad_transactions

    tx, base = [], 0
    for g in (8, 5):
        grp = list(range(base, base + g))
        tx += [grp[1:]] * m + [[x for x in grp if x != grp[i]] for i in range(1, g - 2)] * m
        tx += [[grp[0]]] * (g * m)
        base += g
    tx += [[f] for f in range(base, base + n_filler)] * m
    return pad_transactions(tx), base + n_filler


def under_profiler(fn):
    """``fn()`` under a CPU profiler, and the span table it left."""
    trace.reset_profiled()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, trace.profiled()


@pytest.mark.parametrize("pipeline", [True, False])
@pytest.mark.parametrize("n_filler", [0, 600])
def test_planted_subset_prune_parity(mesh11, n_filler, pipeline):
    """``mine_prepared`` on rows where the subset check removes doomed
    candidates at widths 5 and 8, the same count as the reference's: over
    13 ranks every key is one word; over 613 (10 bits a rank) the width-8
    check takes two words, as ``plan.subset_multiword`` shows."""
    rows, n_items = planted_rows(n_filler)
    cfg = dict(candidate_unit=8, pipeline_waves=pipeline)
    res, tab = under_profiler(lambda: check_parity(mesh11, rows, n_items, 2, **cfg))
    assert max(len(s) for s in res.itemsets) == 7
    # check_parity held the port's count to this reference's
    assert _pair(mesh11, **cfg)[0].last_stage_times["host_pruned_subset"] > 0
    assert ("plan.subset_multiword" in tab) == (n_filler > 0)


def _allowed_by_definition(ranks, pair_ok):
    """Each rank row's allowed set, unpacked, from its definition: the ranks
    below its smallest whose pairs with every member are frequent."""
    below = np.arange(pair_ok.shape[0]) < ranks[:, :1]
    return np.logical_and.reduce(pair_ok[ranks], axis=1) & below


def _check_extension_step(ranks, slots, allowed, pair_ok, lower):
    """One ``_extensions`` call against the reference's: identical ranks,
    parents and q in the same order, and every child's carried set equal
    to the one its definition gives. -> (ranks', parents', allowed')."""
    K = pair_ok.shape[0]
    got = HPrepostMiner._extensions(ranks, slots, allowed, lower, K)
    want = JMiner._extensions(ranks, slots, np.packbits(pair_ok, axis=1),
                              np.packbits(np.tri(K, K, -1, dtype=bool), axis=1), K)
    for g, w in zip(got[:3], want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert got[3].dtype == np.uint8 and got[3].shape == (len(got[0]), lower.shape[1])
    np.testing.assert_array_equal(np.unpackbits(got[3], axis=1, count=K).view(bool),
                                  _allowed_by_definition(got[0], pair_ok))
    return got[0], got[1], got[3]


@pytest.mark.parametrize("mode, k_items", [("empty", 85)] + [
    (mode, k) for mode in ("widths", "chain") for k in (1, 7, 8, 63, 64, 65, 85, 130, 292)])
def test_extension_step_carries_allowed_sets(mode, k_items):
    """Candidate generation from carried allowed-sets against the
    reference's k-way AND: random pair tables at K on either side of a
    byte and a word; ``widths`` extends random rows of widths 2–9 seeded
    from the pair table; ``chain`` extends the level-2 rows three levels
    deep, filtering rows and sets between levels as the dead-parent prune
    and the subset check do."""
    rng = np.random.default_rng(k_items)
    pair_ok = np.triu(rng.random((k_items, k_items)) < 0.85, 1)
    pair_ok |= pair_ok.T
    C = np.triu(pair_ok, 1).astype(np.int64)
    lower, ranks, parents, qarr, allowed = HPrepostMiner._level2(C, 1)
    qs, ps = np.nonzero(C >= 1)
    np.testing.assert_array_equal(ranks, np.stack([qs, ps], axis=1))
    np.testing.assert_array_equal(parents, ps)
    np.testing.assert_array_equal(qarr, qs)
    np.testing.assert_array_equal(np.unpackbits(allowed, axis=1, count=k_items).view(bool),
                                  _allowed_by_definition(ranks, pair_ok))
    if mode == "empty":
        for width in (2, 5):
            out = _check_extension_step(np.empty((0, width), np.int32), np.empty(0, np.int64),
                                        allowed[:0], pair_ok, lower)
            assert out[0].shape == (0, width + 1)
        nothing = HPrepostMiner._level2(np.zeros_like(C), 1)
        assert all(len(a) == 0 for a in nothing[1:])
    elif mode == "widths":
        pair_packed = np.packbits(pair_ok, axis=1)
        for width in range(2, min(9, k_items) + 1):
            rows = np.sort(rng.permuted(np.tile(np.arange(k_items, dtype=np.int32), (40, 1)),
                                        axis=1)[:, :width], axis=1)
            sets = HPrepostMiner._seed_sets(rows, pair_packed, lower)
            np.testing.assert_array_equal(np.unpackbits(sets, axis=1, count=k_items).view(bool),
                                          _allowed_by_definition(rows, pair_ok))
            _check_extension_step(rows, rng.permutation(40).astype(np.int64), sets, pair_ok,
                                  lower)
    else:
        for _ in range(3):
            # the dead-parent prune and the subset check drop rows with their
            # sets; the survivors get fresh slots as ``_pack_wave`` gives them
            keep = rng.random(len(ranks)) < min(1.0, 150 / max(len(ranks), 1))
            ranks, allowed = ranks[keep], allowed[keep]
            slots = rng.permutation(len(ranks)).astype(np.int64)
            ranks, _, allowed = _check_extension_step(ranks, slots, allowed, pair_ok, lower)
        if k_items >= 8:
            assert len(ranks) and ranks.shape[1] == 5


# ------------------------------------------- the rows' copy through a staging ring
SLOT = 64  # bytes a slot in these tests: 16 int32 entries


def staged_miner(monkeypatch, shape=(1, 1), fillers=1):
    """A CPU miner whose positions take the staged copy a CUDA position
    takes, through a ring of three ``SLOT``-byte slots."""
    from repro_torch.core import hprepost
    from repro_torch.device import StagingRing
    from repro_torch.launch.mesh import make_mesh

    monkeypatch.setattr(hprepost, "_staged", lambda dev: True)
    miner = HPrepostMiner(mesh=make_mesh(shape, ("data", "model"),
                                         devices=["cpu"] * (shape[0] * shape[1])))
    miner._staging = StagingRing(slot_bytes=SLOT, slots=3, fillers=fillers)
    return miner


def padded_blocks(rows, D):
    """The reference's shard blocks: ``rows`` padded with PAD rows to a
    multiple of D, cut into D blocks."""
    Rs = -(-len(rows) // D)
    pad = np.full((D * Rs - len(rows), rows.shape[1]), -1, np.int32)
    return np.split(np.concatenate([rows, pad]), D)


@pytest.mark.parametrize("fillers", [1, 3])
@pytest.mark.parametrize("R, L", [
    (0, 4),    # empty
    (3, 4),    # smaller than one slot
    (4, 4),    # exactly one slot
    (17, 1),   # one element past a slot
    (37, 4),   # several slots, a ragged tail
    (29, 5),   # L does not divide the slot
], ids=["empty", "under-slot", "one-slot", "slot-plus-one", "ragged", "L-not-dividing"])
def test_staged_block_bit_for_bit(monkeypatch, R, L, fillers):
    """The staged copy lands the rows bit for bit, twice through one ring
    (the second copy reuses every slot), from a read-only source."""
    miner = staged_miner(monkeypatch, fillers=fillers)
    rng = np.random.default_rng(R)
    for _ in range(2):
        rows = rng.integers(-1, 1 << 30, size=(R, L)).astype(np.int32)
        rows.flags.writeable = False
        (block,) = miner._shard_rows(rows)
        assert block.dtype == torch.int32 and block.shape == (R, L)
        assert block.numpy().tobytes() == padded_blocks(rows, 1)[0].tobytes()


def test_staged_mesh_odd_rows_payload(monkeypatch):
    """A D = 2 mesh over an odd row count: the staged blocks are the padded
    source's halves, the tail's last row PAD on the device side, and the
    prepared payload equals the in-place path's."""
    from repro_torch.launch.mesh import make_mesh

    rows, n_items = random_db(np.random.default_rng(5), 101, 12, 6), 12
    plain = HPrepostMiner(mesh=make_mesh((2, 1), ("data", "model"), devices=["cpu", "cpu"]))
    want = plain.prepare(rows, n_items, 3).to_host()
    miner = staged_miner(monkeypatch, (2, 1), fillers=2)
    blocks = miner._shard_rows(rows)
    for got, ref in zip(blocks, padded_blocks(rows, 2)):
        assert got.numpy().tobytes() == ref.tobytes()
    assert (blocks[1][-1] == -1).all() and (blocks[0] != -1).any()
    assert_payload_equal(miner.prepare(rows, n_items, 3).to_host(), want)


@pytest.mark.parametrize("staged", [True, False])
def test_h2d_chunks_counter(monkeypatch, staged):
    """``prep.h2d_chunks`` counts ceil(bytes / slot) for each staged block;
    the in-place CPU path records nothing."""
    from repro_torch.launch.mesh import make_mesh

    rows, n_items = random_db(np.random.default_rng(6), 45, 10, 5), 10
    if staged:
        miner = staged_miner(monkeypatch, (2, 1))
    else:
        miner = HPrepostMiner(mesh=make_mesh((2, 1), ("data", "model"), devices=["cpu", "cpu"]))
    _, tab = under_profiler(lambda: miner.prepare(rows, n_items, 2))
    if staged:
        Rs = -(-len(rows) // 2)
        per_block = [-(-(n * rows.shape[1] * 4) // SLOT) for n in (Rs, len(rows) - Rs)]
        assert tab["prep.h2d_chunks"] == {"count": 2, "total": sum(per_block)}
    else:
        assert "prep.h2d_chunks" not in tab


def test_staging_ring_concurrent_callers():
    """Callers more than the cores copy through one ring at once, with a
    short switch interval: every copy lands its own bytes (callers that
    shared a slot would mix them)."""
    import os
    import sys
    import threading

    from repro_torch.device import StagingRing

    slot = 1 << 18  # large enough that a slot's fill leaves the interpreter lock
    ring = StagingRing(slot_bytes=slot, slots=3, fillers=2)
    n = 2 * (os.cpu_count() or 2) + 1
    srcs = [np.random.default_rng(i).integers(0, 1 << 30, size=(4099, 131)).astype(np.int32)
            for i in range(n)]
    bad = []

    def caller(i):
        for _ in range(5):
            dst = torch.empty((4099, 131), dtype=torch.int32)
            chunks = ring.copy(srcs[i], dst)
            if chunks != -(-srcs[i].nbytes // slot) or not np.array_equal(dst.numpy(), srcs[i]):
                bad.append(i)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=caller, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert bad == []


def test_staging_ring_refuses_what_it_cannot_copy():
    from repro_torch.device import StagingRing

    ring = StagingRing(slot_bytes=SLOT)
    src = np.zeros((6, 4), np.int32)
    with pytest.raises(ValueError, match="bytes"):
        ring.copy(src, torch.empty((5, 4), dtype=torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        ring.copy(src, torch.empty((4, 6), dtype=torch.int32).t())
    with pytest.raises(ValueError, match="contiguous"):
        ring.copy(np.zeros((4, 6), np.int32).T, torch.empty((6, 4), dtype=torch.int32))
    with pytest.raises(ValueError, match="2 slots"):
        StagingRing(slots=1)
