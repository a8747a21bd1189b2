"""The hand-written CUDA kernels against their plain PyTorch versions, and
the miner on the card against the miner on the CPU — on a CUDA device
only (marker ``cuda``; each test skips with a reason where there is none).
This module imports nothing of JAX, so it runs on the GPU machine:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import os

import numpy as np
import pytest
import torch

from repro_torch.core import encoding as enc
from repro_torch.core.hprepost import HPrepostConfig, HPrepostMiner
from repro_torch.core.nlist import INF
from repro_torch.core.ppc import build_ppc
from repro_torch.data.synth import load, random_db
from repro_torch.kernels.cooccur.kernel import cooccur_cuda
from repro_torch.kernels.cooccur.ref import cooccur_ref
from repro_torch.kernels.histogram.kernel import histogram_cuda
from repro_torch.kernels.histogram.ref import histogram_ref
from repro_torch.kernels.nlist_intersect.kernel import (
    nlist_intersect_cuda,
    nlist_intersect_es_cuda,
    nlist_wave_cuda,
)
from repro_torch.kernels.nlist_intersect.ref import (
    nlist_intersect_fused_ref,
    nlist_intersect_masked_ref,
    nlist_wave_ref,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no CPU mode")
    return torch.device("cuda")


def T(x, dev):
    return torch.from_numpy(np.ascontiguousarray(x)).to(dev)


def _nlist_batch(rng, B, La, Ly):
    """Tree-valid PP-code batches (A with its node counts), padded
    pre=INT32_MAX, post=-1, cnt=0."""
    out = [np.full((B, La), INF, np.int32), np.full((B, La), -1, np.int32),
           np.zeros((B, La), np.int32), np.full((B, Ly), INF, np.int32),
           np.full((B, Ly), -1, np.int32), np.zeros((B, Ly), np.int32)]
    for b in range(B):
        n_items = int(rng.integers(2, 16))
        rows = random_db(rng, int(rng.integers(5, 120)), n_items, min(8, n_items))
        fl = enc.build_flist(enc.item_support(rows, n_items), 1)
        if fl.k < 2:
            continue
        urows, w = enc.dedup_rows(enc.rank_encode(rows, fl))
        if not len(urows):
            continue
        nls = build_ppc(urows, w).nlists(fl.k)
        qa, qy = sorted(rng.choice(fl.k, size=2, replace=False))
        A, Y = nls[qa][:La], nls[qy][:Ly]
        for i, (src, col) in enumerate(((A, 0), (A, 1), (A, 2), (Y, 0), (Y, 1), (Y, 2))):
            out[i][b, : len(src)] = src[:, col]
    return out


def _hist_case(case):
    """(rows, weights, n_bins, view) for B3: the four random universes, then
    the cases the main path does not reach. ``view``: the test takes
    ``rows[view:]`` and ``weights[view:]``, a view that is not 16-byte
    aligned (L odd)."""
    if case.isdigit():  # PAD and ids at random, weights 0..4
        n_bins = int(case)
        rng = np.random.default_rng(n_bins)
        rows = rng.integers(-1, n_bins, size=(3000, 20)).astype(np.int32)
        return rows, rng.integers(0, 5, size=3000).astype(np.int32), n_bins, 0
    rng = np.random.default_rng(len(case))
    R, L, n_bins = 20_000, 47, 41_270
    rows = rng.integers(0, n_bins, size=(R, L)).astype(np.int32)
    rows[:, 30:] = -1  # PAD as a suffix, as the main path has it
    w = np.ones(R, np.int32)
    if case == "weights-0-negative-wrapping":
        w = rng.choice(np.array([0, -1, -7, 3, 1 << 30, 2**31 - 1, -2**31]), size=R).astype(np.int32)
    elif case == "repeated-items":
        rows[:, 1] = rows[:, 0]
        rows[::3, 2] = rows[::3, 0]
    elif case == "pad-mid-row":
        rows[rng.random((R, L)) < 0.4] = -1
    elif case == "ids-past-n_bins":
        far = rng.random((R, L)) < 0.05
        rows[far] = n_bins + rng.integers(0, 1 << 20, size=int(far.sum()))
    elif case.startswith("misaligned-view"):
        rows[rng.random((R, L)) < 0.4] = -1
        w = rng.integers(-3, 4, size=R).astype(np.int32)
        return rows, w, (70_000 if case.endswith("70000") else n_bins), 1
    elif case == "short-rows":  # L = 3: a tile spans more rows than a stage holds weights for
        rows = rng.integers(-1, 500, size=(100_003, 3)).astype(np.int32)
        return rows, rng.integers(-3, 4, size=100_003).astype(np.int32), 500, 0
    return rows, w, n_bins, 0


@pytest.mark.parametrize("case", [
    "7", "1000", "41270", "70000", "weights-0-negative-wrapping", "repeated-items",
    "pad-mid-row", "ids-past-n_bins", "misaligned-view", "misaligned-view-70000", "short-rows",
])
def test_histogram_kernel(cuda, case):
    """Bit-exact against the plain version: int32 sums wrap mod 2^32, ids
    outside [0, n_bins) count nothing, a repeated item counts per slot; 70,000
    bins take the kernel's global-memory path."""
    rows, w, n_bins, view = _hist_case(case)
    rows, w = T(rows, cuda)[view:], T(w, cuda)[view:]
    if view:
        assert rows.data_ptr() % 16 != 0
    before = histogram_cuda.launches
    got = histogram_cuda(rows, w, n_bins=n_bins)
    torch.cuda.synchronize()
    assert histogram_cuda.launches == before + 1
    assert torch.equal(got, histogram_ref(rows, w, n_bins=n_bins))


def _cooccur_rows(rng, R, L, K, mode):
    """unique: w = 1 and distinct ranks per row, unsorted (the main path: all
    on the tensor cores); mixed: mostly w = 1 with repeats, zeros and a few
    large weights (both paths in one tile); weighted: weights up to 2^20,
    repeats; zipf: rows drawn as ``launch.dryrun_fim`` draws them (a Zipf
    law over 4K items) and ranked by support, so sorted and skewed like the
    reference's production rows; banded: unique rows whose second row tile
    holds items of the last band only, and, from three bands on, band 1
    with no entries at all; view: unique rows passed as the view rows[1:],
    whose start is not 16-byte aligned."""
    if mode == "zipf":
        from repro_torch.launch.dryrun_fim import top_k_flist, zipf_rows

        raw = zipf_rows(R, L, 4 * K, seed=K)
        fl = top_k_flist(np.bincount(raw[raw >= 0].numpy(), minlength=4 * K), K)
        ranked = enc.rank_encode_torch(raw, torch.from_numpy(fl.rank_lut()), 4 * K)
        return ranked.numpy(), np.ones(R, np.int32)
    if mode in ("unique", "banded", "view"):
        rows = np.stack([rng.permutation(max(K, L))[:L] for _ in range(R)])
        rows = np.where(rows < K, rows, -1)
        rows[rng.random(rows.shape) < 0.3] = -1
        if mode == "banded":
            nb = -(-K // 128)
            lo = (nb - 1) * 128
            for r in range(128, min(256, R)):
                rows[r] = -1
                pick = lo + rng.permutation(K - lo)[:L]
                rows[r, :len(pick)] = pick
            if nb >= 3:
                rows[(rows >= 128) & (rows < 256)] = -1
        return rows.astype(np.int32), np.ones(R, np.int32)
    rows = rng.integers(-1, K, size=(R, L)).astype(np.int32)
    if mode == "mixed":
        w = rng.choice(np.array([0, 1, 1, 1, 1, 1, 1, 5, 1 << 20]), size=R)
    else:
        w = rng.integers(0, (1 << 20) + 1, size=R)
    return rows, w.astype(np.int32)


@pytest.mark.parametrize("mode", ["unique", "mixed", "weighted", "zipf", "banded", "view"])
@pytest.mark.parametrize("K", [1, 60, 127, 300, 1000, 2048, 4096, 7117])
def test_cooccur_kernel(cuda, K, mode):
    """K not a multiple of the 128-item band: a transposed fragment or a
    lost mirror shows off the diagonal tile. R = 2,000 is not a multiple of
    the 128-row tile; the wide cases (K from 2,048: the production K, the
    stream's ``max_f1`` and pumsb's universe) take L = 74, whose rows are
    8-byte aligned only, K = 1,000 takes L = 99, whose row tiles do not fit
    the bucketing pass's shared memory (it reads them from global memory),
    and K <= 128 runs the single-band kernel."""
    rng = np.random.default_rng(K)
    L = 74 if K >= 2048 else 99 if K == 1000 else 17
    rows, w = _cooccur_rows(rng, 2000, L, K, mode)
    rows, w = T(rows, cuda), T(w, cuda)
    if mode == "view":
        rows, w = rows[1:], w[1:]
        assert rows.data_ptr() % 16 != 0
    before = cooccur_cuda.launches
    got = cooccur_cuda(rows, w, n_items=K)
    torch.cuda.synchronize()
    assert cooccur_cuda.launches == before + 1
    assert torch.equal(got, cooccur_ref(rows, w, n_items=K))


@pytest.mark.parametrize("K", [300, 2048])
def test_cooccur_kernel_on_each_card(cuda, K):
    """The wide-K kernels need more than 48 KB of dynamic shared memory,
    an opt-in that holds for one card only: a mesh runs B4 on each of its
    positions' cards, so every card must take the launch, each first
    launched after another card's."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two CUDA devices: one card cannot show a per-card setting")
    rng = np.random.default_rng(K)
    rows, w = _cooccur_rows(rng, 2000, 74, K, "mixed")
    want = cooccur_ref(torch.from_numpy(rows), torch.from_numpy(w), n_items=K)
    for index in [0] + list(range(n - 1, 0, -1)):
        dev = torch.device("cuda", index)
        got = cooccur_cuda(T(rows, dev), T(w, dev), n_items=K)
        assert got.device == dev
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("B,La,Ly", [(1, 1, 1), (5, 40, 70), (7, 130, 257), (3, 20000, 20000)])
def test_nlist_kernels(cuda, B, La, Ly):
    """(3, 20000, 20000) needs more than the shared memory a block may use:
    the kernels' global-memory path."""
    rng = np.random.default_rng(B * La + Ly)
    a_pre, a_post, a_cnt, y_pre, y_post, y_cnt = (T(x, cuda) for x in _nlist_batch(rng, B, La, Ly))
    got = nlist_intersect_cuda(a_pre, a_post, y_pre, y_post, y_cnt)
    want = nlist_intersect_fused_ref(a_pre, a_post, y_pre, y_post, y_cnt)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for stop in (0, 3, 50, 1 << 20):
        for lab in (1, 8, 512):
            got = nlist_intersect_es_cuda(a_pre, a_post, a_cnt, y_pre, y_post, y_cnt, stop, la_block=lab)
            want = nlist_intersect_masked_ref(a_pre, a_post, a_cnt, y_pre, y_post, y_cnt, stop,
                                              la_block=lab)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    torch.cuda.synchronize()


@pytest.fixture(scope="module")
def wave_db():
    rows, n_items = load("kosarak", scale=0.25)
    return rows, n_items, int(np.ceil(0.01 * len(rows)))


@pytest.mark.parametrize("n_cand", ["few", "many"])
@pytest.mark.parametrize("W", [2048, 16384, 20000])
def test_nlist_wave_kernel(cuda, wave_db, W, n_cand):
    """The gather-fused wave at the miner's widths, against its plain
    version: a level-2 wave on singleton states, then a wave on its output
    (sparser counts), with padding slots (n_live < Cpad). "few" candidates
    take 1,024-thread blocks, "many" (>= 4 per SM) 256-thread ones."""
    rows, n_items, mc = wave_db
    miner = HPrepostMiner(cuda, HPrepostConfig(nlist_width=W))
    prep = miner.prepare(rows, n_items, mc)
    planes = prep.packed[0].permute(2, 0, 1).contiguous()
    qs, ps = np.nonzero(prep.C >= mc)
    if n_cand == "few":
        qs, ps = qs[:100], ps[:100]
    else:
        reps = -(-600 // len(qs))
        qs, ps = np.tile(qs, reps), np.tile(ps, reps)
    ranks = np.stack([qs, ps], axis=1).astype(np.int32)
    idx, _, Cpad = miner._pack_wave(ranks, ps.astype(np.int64), qs.astype(np.int32))
    n_live = len(ranks)
    assert n_live < Cpad
    idx = T(idx, cuda)
    prev = planes[2]  # the singleton states, as the miner's level-2 wave reads them
    for level in (2, 3):
        if level == 3:
            # tree-valid level 3: parent slot s = (q, p) extended by q2 < q,
            # base q (the parent's state lies on q's slots); truncated or
            # tiled to the same n_live
            s3, q2 = np.nonzero(np.arange(prep.fl.k)[None, :] < qs[:, None])
            s3, q2 = np.resize(s3, n_live), np.resize(q2, n_live)
            idx = T(np.stack([s3, qs[s3], q2]).astype(np.int64), cuda)
            idx = torch.cat([idx, torch.zeros((3, Cpad - n_live), dtype=torch.int64,
                                              device=cuda)], dim=1)
        for es, stops in ((False, (0,)), (True, (0, mc // 2, mc, 2 * mc, 1 << 30))):
            for stop in stops:
                for lab in ((512,) if not es else (512, 64, 8, 1)):
                    got = nlist_wave_cuda(planes, prev, idx, n_live, early_stop=es,
                                          min_count=stop, la_block=lab)
                    want = nlist_wave_ref(planes, prev, idx, n_live, early_stop=es,
                                          min_count=stop, la_block=lab)
                    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (
                        level, es, stop, lab)
        prev = nlist_wave_cuda(planes, prev, idx, n_live)[0]
    torch.cuda.synchronize()


@pytest.mark.parametrize("n_cand", ["few", "many"])
@pytest.mark.parametrize("W", [512, 2048])
def test_wave_kernel_padding_contract(cuda, wave_db, W, n_cand):
    """The padding contract on the card: parent states with counts on the
    base items' padding slots (pre INT32_MAX) and count planes with counts
    on A's padding slots merge and weigh nothing, in B1 and B2 alike, so
    the kernels equal their plain versions and, where only padding is
    soiled, the in-contract answer. Two widths and both block sizes ("few"
    candidates take 1,024 threads, "many" 256) give four probe strides
    ceil(W / threads), the quantity the answer on such input used to
    depend on."""
    rows, n_items, mc = wave_db
    miner = HPrepostMiner(cuda, HPrepostConfig(nlist_width=W))
    prep = miner.prepare(rows, n_items, mc)
    planes = prep.packed[0].permute(2, 0, 1).contiguous()
    qs, ps = np.nonzero(prep.C >= mc)
    if n_cand == "few":
        qs, ps = qs[:100], ps[:100]
    else:
        reps = -(-600 // len(qs))
        qs, ps = np.tile(qs, reps), np.tile(ps, reps)
    ranks = np.stack([qs, ps], axis=1).astype(np.int32)
    idx, _, _ = miner._pack_wave(ranks, ps.astype(np.int64), qs.astype(np.int32))
    idx, n_live = T(idx, cuda), len(ranks)
    gen = torch.Generator(device=cuda).manual_seed(W)
    pad = planes[0] == INF  # level 2: parent p's state lies on p's slots

    def on_pad(lo, hi, x):
        return torch.where(pad, torch.randint(lo, hi, x.shape, generator=gen, device=cuda,
                                              dtype=torch.int32), x)

    soiled = planes.clone()
    soiled[1], soiled[2] = on_pad(-1, 16, planes[1]), on_pad(1, 1000, planes[2])
    states = {"in-contract": planes[2], "padding-only": on_pad(1, 1000, planes[2]),
              "count+1": planes[2] + 1}
    for kw in ({}, *(dict(early_stop=True, min_count=s, la_block=lab)
                     for s in (mc // 2, mc, 2 * mc) for lab in (128, 512))):
        contract = nlist_wave_ref(planes, planes[2], idx, n_live, **kw)
        for sname, state in states.items():
            for pl in (planes, soiled):
                got = nlist_wave_cuda(pl, state, idx, n_live, **kw)
                want = nlist_wave_ref(pl, state, idx, n_live, **kw)
                assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (sname, kw)
                if sname != "count+1":
                    assert torch.equal(got[0], contract[0]) and torch.equal(got[1], contract[1])
    torch.cuda.synchronize()


def test_wrappers_refuse_bad_tensors(cuda):
    x = torch.zeros((4, 4), dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        histogram_cuda(x, torch.ones(4, dtype=torch.int32, device=cuda), n_bins=3)
    y = torch.zeros((4, 8), dtype=torch.int32, device=cuda)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        cooccur_cuda(y, torch.ones(4, dtype=torch.int32, device=cuda), n_items=3)


@pytest.mark.parametrize("early_stop", [True, False])
def test_miner_on_card_matches_cpu(cuda, early_stop):
    rows, n_items = load("mushroom", scale=0.2)
    gpu = HPrepostMiner(cuda, HPrepostConfig(early_stop=early_stop))
    cpu = HPrepostMiner("cpu", HPrepostConfig(early_stop=early_stop))
    assert gpu.mine(rows, n_items, 300).itemsets == cpu.mine(rows, n_items, 300).itemsets
    assert gpu.stage_counters == cpu.stage_counters
    g, c = gpu.prepare(rows, n_items, 300).to_host(), cpu.prepare(rows, n_items, 300).to_host()
    assert sorted(g) == sorted(c)
    for k in g:
        if isinstance(g[k], np.ndarray):
            assert g[k].dtype == c[k].dtype and g[k].tobytes() == c[k].tobytes(), k
        else:
            assert g[k] == c[k], k


# ------------------------------------------------ the resident engine on the card
def test_engine_sweep_on_card_matches_cpu_one_prepare_per_group(cuda):
    import repro_torch.kernels as kernels
    from repro_torch.mining import MineRequest, MineSpec, MiningEngine

    rows, n_items = load("mushroom", scale=0.3)
    other, _ = load("mushroom", scale=0.2)
    spec = MineSpec(algorithm="hprepost")
    fracs = [0.3, 0.2, 0.15]
    gpu, cpu = MiningEngine(device=cuda), MiningEngine(device="cpu")
    kernels.reset_launches()
    got = gpu.submit_many([MineRequest(r, n_items, spec.with_(min_sup=f))
                           for r in (rows, other) for f in fracs])
    launches = kernels.launches()
    want = cpu.submit_many([MineRequest(r, n_items, spec.with_(min_sup=f))
                            for r in (rows, other) for f in fracs])
    assert [r.itemsets for r in got] == [r.itemsets for r in want]
    assert gpu.stats == cpu.stats and gpu.stats["prepares"] == 2
    # B3 and B4 once per planned group, B2 on every threshold
    assert launches["histogram"] == launches["cooccur"] == 2
    waves = gpu.frontend("hprepost").miner_for(spec).stage_counters["waves"]
    assert launches["nlist_intersect_es"] == waves >= len(got)
    assert all(r.stage_times_s["planned_candidates"] > 0 for r in got)


def test_engine_tuned_and_untuned_mines_identical_on_card(cuda, tmp_path):
    from repro_torch.mining import MineSpec, MiningEngine

    rows, n_items = load("mushroom", scale=0.3)
    for es in (True, False):
        spec = MineSpec(algorithm="hprepost", min_sup=0.15, early_stop=es)
        base = MiningEngine(device=cuda).submit(rows, n_items, spec)
        cold = MiningEngine(device=cuda, snapshot_dir=str(tmp_path))
        tuned = cold.submit(rows, n_items, spec.with_(tune=True))
        assert tuned.itemsets == base.itemsets
        assert cold.tuner.stats["trials"] > 0 and cold.tuner.stats["tuned"] > 0
        warm = MiningEngine(device=cuda, snapshot_dir=str(tmp_path))
        assert warm.submit(rows, n_items, spec.with_(tune=True)).itemsets == base.itemsets
        assert warm.tuner.stats["trials"] == 0 and warm.tuner.stats["plan_hits"] > 0


def test_engine_eviction_frees_device_memory(cuda):
    import gc

    from repro_torch.mining import MineSpec, MiningEngine

    small, n_small = load("mushroom", scale=0.5)
    big, n_big = load("kosarak", scale=0.05)
    spec_small = MineSpec(algorithm="hprepost", min_sup=0.15)
    spec = spec_small.with_(min_sup=0.02)
    gc.collect()
    base = torch.cuda.memory_allocated(cuda)
    ref = MiningEngine(device=cuda)
    ref.submit(big, n_big, spec)
    only_big = torch.cuda.memory_allocated(cuda)
    prep_big = ref.cache_info()["bytes_in_use"]
    del ref
    gc.collect()
    assert abs(torch.cuda.memory_allocated(cuda) - base) <= 1 << 20  # the engine held the prep
    lru = MiningEngine(device=cuda, prep_cache_bytes=prep_big + 1)
    lru.submit(small, n_small, spec_small)
    assert torch.cuda.memory_allocated(cuda) > base
    lru.submit(big, n_big, spec)  # evicts the small prep
    gc.collect()
    info = lru.cache_info()
    assert info["evictions"] == 1 and info["entries"] == 1
    assert abs(torch.cuda.memory_allocated(cuda) - only_big) <= 1 << 20


# ------------------------------------------------ the service on the card
def _serve(dbs, fracs, *, overlap=True, **svc_kw):
    """One batch through a fresh ``MiningService`` on the card: a sweep per
    database, all inside one batch window. -> (results, service)."""
    from repro_torch.mining import MineSpec, MiningService

    spec = MineSpec(algorithm="hprepost")
    svc = MiningService(device="cuda", batch_window_s=0.05, **svc_kw)
    svc.scheduler.overlap = overlap
    try:
        futs = [f for rows, n_items in dbs for f in svc.sweep(rows, n_items, spec, fracs)]
        out = [f.result(timeout=300) for f in futs]
    finally:
        svc.close()
    return out, svc


def _engine_answers(dbs, fracs):
    from repro_torch.mining import MineSpec, MiningEngine

    eng = MiningEngine(device="cpu")
    return [eng.submit(rows, n_items, MineSpec(algorithm="hprepost", min_sup=f)).itemsets
            for rows, n_items in dbs for f in fracs]


def test_service_two_group_batch_on_card_matches_engine(cuda):
    dbs = [load("mushroom", scale=0.3), load("kosarak", scale=0.05)]
    fracs = [0.3, 0.15]
    out, svc = _serve(dbs, fracs)
    assert [r.itemsets for r in out] == _engine_answers(dbs, fracs)
    st = svc.scheduler.stats
    assert svc.stats["batches"] == 1 and svc.engine.stats["prepares"] == 2
    assert st["device_groups"] == 2 and st["overlapped_prepares"] == 1
    assert [r.service_stats["prep_overlapped"] for r in out] == [False, False, True, True]
    assert all(r.service_stats["prep_source"] == "built" for r in out)


def test_service_record_stream_under_eviction(cuda):
    """An LRU smaller than two preps evicts the group being served while the
    next group's prep allocates on the prep stream: the served answers must
    not change (``record_stream`` keeps the evicted block from reuse)."""
    from repro_torch.mining import MineSpec, MiningEngine

    dbs = [load("mushroom", scale=0.3), load("pumsb", scale=0.1),
           load("kosarak", scale=0.05), load("mushroom", scale=0.2)]
    fracs = [0.3, 0.15]
    probe = MiningEngine(device="cpu")
    sizes = []
    for rows, n_items in dbs:
        probe.clear_prep_cache()
        probe.submit(rows, n_items, MineSpec(algorithm="hprepost", min_sup=min(fracs)))
        sizes.append(probe.cache_info()["bytes_in_use"])
    budget = max(sizes) + 1  # fits any one prep, never two
    for _ in range(3):
        out, svc = _serve(dbs, fracs, prep_cache_bytes=budget)
        assert [r.itemsets for r in out] == _engine_answers(dbs, fracs)
        info = svc.engine.cache_info()
        assert info["evictions"] >= len(dbs) - 1 and info["entries"] == 1
        assert svc.scheduler.stats["overlapped_prepares"] == len(dbs) - 1


def test_service_launch_counts_exact_with_overlap(cuda):
    import repro_torch.kernels as kernels
    from repro_torch.mining import MineSpec

    dbs = [load("mushroom", scale=0.3), load("pumsb", scale=0.1), load("kosarak", scale=0.05)]
    fracs = [0.3, 0.2, 0.15]
    counts = {}
    for overlap in (True, False, True):
        kernels.reset_launches()
        out, svc = _serve(dbs, fracs, overlap=overlap)
        got = kernels.launches()
        waves = svc.engine.frontend("hprepost").miner_for(MineSpec()).stage_counters["waves"]
        assert got["histogram"] == got["cooccur"] == len(dbs)
        assert got["nlist_intersect_es"] == waves and got["nlist_intersect"] == 0
        counts.setdefault(overlap, []).append(got)
        assert [r.itemsets for r in out] == _engine_answers(dbs, fracs)
    assert counts[True][0] == counts[True][1] == counts[False][0]


# ------------------------------------------------ the streaming path on the card
def _segment(cuda, seed=3, n_tx=400, n_items=12):
    """One segment as the stream builds it: a prep under an imposed F-list
    of every item present (no histogram launch) and its planes with the
    sentinel row at K. -> (planes, singleton, K)."""
    rows = random_db(np.random.default_rng(seed), n_tx, n_items, 6)
    hist = enc.item_support(rows, n_items)
    items = np.flatnonzero(hist > 0).astype(np.int32)
    fl = enc.FList(items=items, supports=hist[items].astype(np.int64), n_items=n_items,
                   min_count=1)
    miner = HPrepostMiner(cuda, HPrepostConfig())
    prep = miner.prepare(rows, n_items, 1, flist=fl)
    assert not prep.support_ordered
    planes, singleton = miner.extend_with_sentinel(prep)
    return planes, singleton, fl.k


@pytest.mark.parametrize("on_sentinel", ["base", "extension", "both"])
def test_sentinel_row_through_the_wave_kernel(cuda, on_sentinel):
    """Waves over a segment that lacks some of the stream's items, laid out
    as ``LocalSegmentExecutor`` lays them out: every global rank goes
    through ``g2l``, absent ranks to the all-padding sentinel row K. A
    candidate whose base, extension or both items are absent gets a zero
    state row and support 0 from B1, at level 2 and at level 3 (whose
    parent is a level-2 slot), and B1 agrees with its plain version."""
    import repro_torch.kernels as kernels

    planes, singleton, K = _segment(cuda)
    assert planes.shape[1] == K + 1
    sentinel = torch.tensor([INF, -1, 0], dtype=torch.int32)[:, None]
    assert torch.equal(planes[:, K].cpu(), sentinel.expand(3, planes.shape[2]))
    # a global rank space of K + 4 ranks: every third rank is absent here
    G = K + 4
    absent = np.zeros(G, bool)
    absent[::3] = True
    g2l = np.full(G, K, np.int64)
    g2l[~absent] = np.arange(int((~absent).sum())) % K
    miner = HPrepostMiner(cuda, HPrepostConfig(candidate_unit=8))

    def run(ranks, parents, prev, level):
        idx, _, _ = miner._pack_wave(ranks, parents, ranks[:, 0].copy())
        local = np.stack([g2l[idx[0]] if level == 2 else idx[0], g2l[idx[1]], g2l[idx[2]]])
        local_t, n_live = T(local, cuda), len(ranks)
        kernels.reset_launches()
        got = nlist_wave_cuda(planes, prev, local_t, n_live)
        assert kernels.launches()["nlist_intersect"] == 1
        want = nlist_wave_ref(planes, prev, local_t, n_live)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        base_out, ext_out = absent[ranks[:, 1]], absent[ranks[:, 0]]
        case = {"base": base_out & ~ext_out, "extension": ext_out & ~base_out,
                "both": base_out & ext_out}[on_sentinel]
        assert case.any()
        hit = torch.from_numpy(np.flatnonzero(case)).to(cuda)
        assert int(got[1][hit].abs().sum()) == 0 and int(got[0][hit].abs().sum()) == 0
        assert int(got[1][:n_live].sum()) > 0  # the present candidates merged something
        return got[0]

    qs, ps = np.nonzero(np.triu(np.ones((G, G), bool), 1))
    ranks2 = np.stack([qs, ps], axis=1).astype(np.int32)
    state = run(ranks2, ps.astype(np.int64), singleton, 2)
    # level 3: slot s = (q, p) extended by q2 < q; base q, parent slot s
    s3, q2 = np.nonzero(np.arange(G)[None, :] < qs[:, None])
    ranks3 = np.concatenate([q2[:, None], ranks2[s3]], axis=1).astype(np.int32)
    run(ranks3, s3.astype(np.int64), state, 3)
    torch.cuda.synchronize()


def _stream_batches(n=4, scale=0.2):
    rows, n_items = load("mushroom", scale=scale)
    return np.array_split(rows, n), n_items


def test_segment_waves_launch_b1_only(cuda):
    """Stream queries with early stop on run B1 once per segment per wave
    and never B2 (segment supports are partial), appends launch B4 once and
    B3 never, and the answers equal the CPU port's."""
    import repro_torch.kernels as kernels
    from repro_torch.mining import MineSpec, MiningEngine

    batches, n_items = _stream_batches()
    spec = MineSpec(algorithm="hprepost", early_stop=True)
    gpu, cpu = MiningEngine(device=cuda), MiningEngine(device="cpu")
    for b in batches:
        kernels.reset_launches()
        gpu.append(b, n_items, spec=spec)
        assert kernels.launches() == {"nlist_intersect": 0, "nlist_intersect_es": 0,
                                      "histogram": 0, "cooccur": 1}
        cpu.append(b, n_items, spec=spec)
    sm = gpu.stream()
    for f in (0.3, 0.15):
        w0, s0 = sm.miner.stage_counters["waves"], sm.miner.stage_counters.get("seg_waves", 0)
        kernels.reset_launches()
        res = gpu.submit_stream(spec.with_(min_sup=f))
        got = kernels.launches()
        waves = sm.miner.stage_counters["waves"] - w0
        assert waves > 0
        assert got["nlist_intersect"] == sm.miner.stage_counters["seg_waves"] - s0 == waves * 4
        assert got["nlist_intersect_es"] == got["histogram"] == got["cooccur"] == 0
        assert res.itemsets == cpu.submit_stream(spec.with_(min_sup=f)).itemsets


def test_async_compaction_racing_a_served_query(cuda):
    """An async compaction builds its merged segment on its own stream while
    the service serves stream queries on its worker's stream: every answer
    equals the uncompacted one, and the merged segment carries the event
    its queries wait on. Two rounds: the second merges segments appended
    after the first merge, while queries read the first merge's planes."""
    from repro_torch.mining import MineSpec, MiningService
    from repro_torch.mining.stream import StreamSpec

    batches, n_items = _stream_batches(n=16)
    spec = MineSpec(algorithm="hprepost", min_sup=0.15)
    with MiningService(device=cuda, batch_window_s=0.0) as svc:
        sm = svc.engine.stream(n_items=n_items, spec=spec,
                               stream_spec=StreamSpec(compact_async=True, compact_fanin=8,
                                                      max_segments=16))
        for r in range(2):
            for f in [svc.append(b) for b in batches[8 * r:8 * r + 8]]:
                f.result(timeout=120)
            want = svc.submit_stream(spec).result(timeout=120).itemsets
            sm.compact(wait=False)
            racing = [svc.submit_stream(spec) for _ in range(6)]
            assert all(f.result(timeout=120).itemsets == want for f in racing)
            sm.flush()
            assert svc.submit_stream(spec).result(timeout=120).itemsets == want
            assert sm.stats["compactions"] == r + 1 and sm.stats["compact_errors"] == 0
            merged = [s for s in sm.db.segments if s.n_batches > 1]
            assert merged and all((s.ready is not None) == (cuda.type == "cuda") for s in merged)
        sm.close()
    torch.cuda.synchronize()


def test_mesh_on_one_card(cuda):
    """A (2, 2) mesh whose four positions share the card: the mine equals the
    same mesh on the CPU (payload and itemsets) and the host PrePost miner;
    B3 and B4 launch once per data shard, every wave launches B1 once per
    position and B2 never (two shards: supports are partial per launch)."""
    import repro_torch.kernels as kernels
    from repro_torch.core.prepost import mine_prepost
    from repro_torch.launch.mesh import make_mesh

    rows, n_items = load("mushroom", scale=0.2)
    mc = int(np.ceil(0.15 * len(rows)))
    axes = ("data", "model")
    gpu = HPrepostMiner(mesh=make_mesh((2, 2), axes, [cuda] * 4))
    cpu = HPrepostMiner(mesh=make_mesh((2, 2), axes, ["cpu"] * 4))
    assert gpu.devices == [torch.device("cuda", torch.cuda.current_device())]
    kernels.reset_launches()
    prep = gpu.prepare(rows, n_items, mc)
    got = kernels.launches()
    assert got["histogram"] == got["cooccur"] == 2
    want = cpu.prepare(rows, n_items, mc).to_host()
    for k, v in prep.to_host().items():
        w = want[k]
        assert (v.tobytes() == w.tobytes()) if isinstance(v, np.ndarray) else v == w, k
    kernels.reset_launches()
    res = gpu.mine_prepared(prep, mc)
    got = kernels.launches()
    assert got["nlist_intersect"] == 4 * gpu.stage_counters["waves"] > 0
    assert got["nlist_intersect_es"] == 0
    assert res.itemsets == cpu.mine(rows, n_items, mc).itemsets
    assert res.itemsets == mine_prepost(rows, n_items, mc).itemsets
    torch.cuda.synchronize()


def test_mesh_across_cards(cuda):
    """A mesh over distinct cards (the first 4, or 2): the mine with the
    shuffle and with locality dispatch, a service batch (one prep stream per
    card) and a compacting stream (one compaction stream per card) equal the
    same mesh on the CPU and the host PrePost miner."""
    from repro_torch.core.prepost import mine_prepost
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.mining import MineSpec, MiningEngine, MiningService
    from repro_torch.mining.stream import StreamSpec

    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip("needs at least two CUDA devices for a mesh over distinct cards")
    shape = (2, 2) if cards >= 4 else (2, 1)
    axes = ("data", "model")
    mesh = make_mesh(shape, axes)
    assert len(mesh.distinct_devices()) == int(np.prod(shape))
    cpu_mesh = make_mesh(shape, axes, ["cpu"] * int(np.prod(shape)))
    rows, n_items = load("mushroom", scale=0.2)
    mc = int(np.ceil(0.15 * len(rows)))
    want = mine_prepost(rows, n_items, mc).itemsets
    for loc in (True, False):
        gpu = HPrepostMiner(config=HPrepostConfig(locality_dispatch=loc), mesh=mesh)
        cpu = HPrepostMiner(config=HPrepostConfig(locality_dispatch=loc), mesh=cpu_mesh)
        got, ref = gpu.prepare(rows, n_items, mc).to_host(), cpu.prepare(rows, n_items, mc).to_host()
        for k, v in got.items():
            assert (v.tobytes() == ref[k].tobytes()) if isinstance(v, np.ndarray) else v == ref[k], k
        assert gpu.mine(rows, n_items, mc).itemsets == want
    spec = MineSpec(algorithm="hprepost", min_sup=0.15)
    with MiningService(mesh=mesh, batch_window_s=0.05) as svc:
        assert len(svc.scheduler.prep_streams) == len(mesh.distinct_devices())
        futs = svc.sweep(rows, n_items, spec, [0.3, 0.15])
        assert [f.result(timeout=300).itemsets for f in futs][-1] == want
    eng = MiningEngine(mesh=mesh)
    ss = StreamSpec(max_segments=3, compact_fanin=2, compact_async=True)
    for b in np.array_split(rows, 4):
        eng.append(b, n_items, spec=spec, stream_spec=ss)
    eng.stream().flush()
    assert eng.stream_stats()["default"]["compactions"] >= 1
    assert eng.submit_stream(spec).itemsets == want
    eng.stream().close()
    for d in mesh.distinct_devices():
        torch.cuda.synchronize(d)


def _distributed(device, snap, n_workers=2, **kw):
    from repro_torch.mining import MineSpec, MiningEngine

    spec = MineSpec(algorithm="hprepost", min_sup=0.15)
    dm = MiningEngine(device=device, snapshot_dir=str(snap)).distribute(
        n_items=_stream_batches()[1], workers=n_workers, spec=spec, **kw)
    return dm, spec


def _launches_by_worker(dm):
    return {wid: st["launches"] for wid, st in dm.worker_stats().items()}


def test_distributed_workers_on_card_match_cpu_workers(cuda, tmp_path):
    """A 2-worker database on the card (both workers on ``cuda:0`` or spread
    over the cards) answers and spills segment payloads exactly as a
    CPU-worker database on the same appends; each worker launched B4 once
    per segment it built, B1 once per wave per segment it holds, and no B2
    or B3."""
    from repro_torch.mining.service.store import SnapshotStore

    batches, n_items = _stream_batches()
    gpu, spec = _distributed("cuda", tmp_path / "gpu")
    cpu, _ = _distributed("cpu", tmp_path / "cpu")
    try:
        assert [w.device for w in sorted(gpu._live(), key=lambda w: w.wid)] == [
            f"cuda:{w % torch.cuda.device_count()}" for w in range(2)]
        for b in batches:
            assert gpu.append(b)["worker"] == cpu.append(b)["worker"]
        for m in gpu._segments.values():
            c = cpu._segments[m.seg_id]
            assert (m.worker, m.nbytes, m.prep_bytes, m.digest) == (
                c.worker, c.nbytes, c.prep_bytes, c.digest)
            assert np.array_equal(m.C_block, c.C_block)
        gs, cs = SnapshotStore(str(tmp_path / "gpu")), SnapshotStore(str(tmp_path / "cpu"))
        keys = sorted(os.path.basename(p) for p in gs.entries())
        assert keys == sorted(os.path.basename(p) for p in cs.entries()) and len(keys) == 4
        for k in keys:
            got, ref = gs.get(k), cs.get(k)
            for f, v in got.items():
                assert (v.tobytes() == ref[f].tobytes()) if isinstance(v, np.ndarray) else v == ref[f], f
        waves0 = gpu._miner.stage_counters.get("waves", 0)
        for frac in (0.3, 0.15):
            assert gpu.mine(spec.with_(min_sup=frac)).itemsets == cpu.mine(
                spec.with_(min_sup=frac)).itemsets
        waves = gpu._miner.stage_counters["waves"] - waves0
        held = {w: len(st["segments"]) for w, st in gpu.worker_stats().items()}
        for wid, got in _launches_by_worker(gpu).items():
            assert got == {"nlist_intersect": waves * held[wid], "nlist_intersect_es": 0,
                           "histogram": 0, "cooccur": held[wid]}, (wid, got)
    finally:
        gpu.close()
        cpu.close()


def test_distributed_worker_kill_on_card_restores_from_snapshots(cuda, tmp_path):
    batches, _ = _stream_batches()
    dm, spec = _distributed("cuda", tmp_path, restart_budget=1)
    try:
        for b in batches:
            dm.append(b)
        before = dm.mine(spec).itemsets
        pre = dm.worker_stats()
        dm.kill_worker(min(w.wid for w in dm._live()))
        assert dm.mine(spec).itemsets == before
        assert dm.stats["reassign_rebuilds"] == 0 and dm.stats["respawns"] == 1
        # restores and migrations build nothing: no worker prepared a segment
        # since the kill, and B4 ran once per segment a worker built
        for wid, st in dm.worker_stats().items():
            built = st["stats"]["seg_prepares"]
            assert built == (pre[wid]["stats"]["seg_prepares"] if wid in pre else 0)
            assert st["launches"]["cooccur"] == built and st["launches"]["histogram"] == 0
    finally:
        dm.close()


def test_distributed_workers_on_distinct_cards(cuda, tmp_path):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs at least two CUDA devices for workers on distinct cards")
    batches, _ = _stream_batches()
    dm, spec = _distributed("cuda", tmp_path)
    cpu, _ = _distributed("cpu", tmp_path / "cpu")
    try:
        assert {w.device for w in dm._live()} == {"cuda:0", "cuda:1"}
        for b in batches:
            dm.append(b)
            cpu.append(b)
        assert dm.mine(spec).itemsets == cpu.mine(spec).itemsets
        assert all(st["cooccur"] > 0 for st in _launches_by_worker(dm).values())
    finally:
        dm.close()
        cpu.close()


def _lm_state(cfg, device):
    from repro_torch.models.common import init_params
    from repro_torch.models.convert import params_from_reference
    from repro_torch.models.registry import build_model

    gen = torch.Generator(device=device).manual_seed(0)
    return params_from_reference(cfg, init_params(build_model(cfg).param_specs(), gen))


def _lm_requests(cfg):
    from repro_torch.serving.engine import Request

    rng = np.random.default_rng(0)
    return [Request(rng.integers(1, cfg.vocab_size, size=rng.integers(4, 24)).astype(np.int32), max_new=16)
            for _ in range(4)]


def test_lm_serving_on_card(cuda):
    """One full-width TinyLlama wave through the Engine on the card
    (bfloat16, all 22 layers), repeatable; then the one-layer full-width
    model in float32 with the same weights on the card and on the CPU:
    prefill and 4 decode steps within 1e-3 of the logits' scale (float32
    rounding in other GEMM orders; TF32 off), the same greedy tokens."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.serving.engine import Engine

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = get_config("tinyllama_1_1b")
    eng = Engine(cfg, _lm_state(cfg, cuda), batch_size=4, max_seq=128)
    assert eng.device.type == "cuda"
    outs = [r.out for r in eng.generate(_lm_requests(cfg))]
    assert all(len(o) == 16 and all(0 <= t < cfg.padded_vocab for t in o) for o in outs)
    assert [r.out for r in eng.generate(_lm_requests(cfg))] == outs
    del eng

    one = dataclasses.replace(cfg, n_layers=1, dtype="float32")
    state = _lm_state(one, torch.device("cpu"))
    card = Engine(one, state, batch_size=4, max_seq=128, device="cuda")
    host = Engine(one, state, batch_size=4, max_seq=128, device="cpu")
    reqs = _lm_requests(one)
    plen = max(len(r.prompt) for r in reqs)
    toks = np.zeros((4, plen), np.int32)
    for i, r in enumerate(reqs):
        toks[i, plen - len(r.prompt):] = r.prompt
    with torch.inference_mode():
        (lc, cc), (lg, cg) = (e.model.prefill({"tokens": torch.from_numpy(toks).to(e.device)}, e._fresh_cache())
                              for e in (host, card))
        for step in range(5):
            scale = max(1.0, float(lc.abs().max()))
            assert float((lg.cpu() - lc).abs().max()) <= 1e-3 * scale, step
            tc, tg = lc[:, -1].argmax(-1), lg[:, -1].argmax(-1)
            assert torch.equal(tc, tg.cpu()), step
            if step < 4:
                lc, cc = host.model.decode({"token": tc[:, None], "pos": plen + step}, cc)
                lg, cg = card.model.decode({"token": tg[:, None], "pos": plen + step}, cg)


def test_lm_training_on_card(cuda, tmp_path):
    """The training path on the card: a reduced tinyllama through the
    ``Trainer``, a failure at step 13 and a restart equal to an
    uninterrupted run bit for bit (deterministic algorithms), and one step
    of a fewest-layer full-width model in float32 whose loss and gradients
    match the CPU's within 1e-3 of the scale."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.data import corpus
    from repro_torch.fault.failures import FailureInjector
    from repro_torch.models.registry import build_model, materialize_batch
    from repro_torch.training.optim import OptConfig
    from repro_torch.training.step import TrainConfig, make_train_state
    from repro_torch.training.trainer import LoopConfig, Trainer

    cfg = get_config("tinyllama_1_1b").reduced()
    toks = corpus.token_stream(20_000, cfg.vocab_size, seed=0)
    tc = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=2, total_steps=30))
    finals = []
    for name, inj in (("a", FailureInjector(fail_at_steps=(13,))), ("b", None)):
        tr = Trainer(build_model(cfg), tc, LoopConfig(total_steps=24, ckpt_every=8, ckpt_dir=str(tmp_path / name)),
                     lambda: corpus.batches(toks, 2, 32, seed=0), failure_injector=inj)
        assert tr.device.type == "cuda" and tr.train() == 24
        finals.append(tr.ckpt.restore()[0]["params"])
    assert all(torch.equal(finals[0][k], finals[1][k]) for k in finals[1])

    one = dataclasses.replace(get_config("tinyllama_1_1b"), n_layers=1, dtype="float32")
    state = make_train_state(build_model(one), torch.Generator().manual_seed(0), TrainConfig())["params"]
    out = []
    for dev in ("cpu", cuda):
        model = build_model(one)
        model.load_state_dict({k: v.to(dev) for k, v in state.items()}, assign=True)
        leaves = dict(model.named_parameters())
        loss = model.loss(materialize_batch(one, "train_4k", 24, 2, device=dev))
        out.append((loss, dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))))
    (lc, gc), (lg, gg) = out
    assert abs(float(lg) - float(lc)) <= 1e-3 * max(1.0, abs(float(lc)))
    for k, g in gc.items():
        assert float((gg[k].cpu() - g).abs().max()) <= 1e-3 * max(1.0, float(g.abs().max())), k


def test_lm_mesh_training_on_card(cuda):
    """Training over a mesh on the card: a reduced tinyllama's 8x1 ZeRO-1
    step (every position on the card) equal to the one-device step bit for
    bit over 3 steps; ``_moe_sharded`` on (2, 2) and GPipe over 2 stages
    within 1e-5 of the scale of the CPU's; ``compressed_psum`` equal to the
    CPU's bit for bit."""

    from repro_torch.configs.base import get_config
    from repro_torch.launch.mesh import make_mesh, make_mesh_from_spec
    from repro_torch.models.common import init_params
    from repro_torch.models.moe import moe_ffn, moe_specs
    from repro_torch.models.registry import build_model, materialize_batch
    from repro_torch.sharding import MeshRules
    from repro_torch.training.compress import compressed_psum
    from repro_torch.training.optim import OptConfig
    from repro_torch.training.pipeline import gpipe_forward
    from repro_torch.training.step import TrainConfig, make_train_state, make_train_step

    cfg = get_config("tinyllama_1_1b").reduced()
    tc = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=2, total_steps=30))
    batch = materialize_batch(cfg, "train_4k", 32, 8, device=cuda)
    runs = []
    for rules in (None, MeshRules(make_mesh_from_spec("8x1", [cuda] * 8))):
        model = build_model(cfg)
        state = make_train_state(model, torch.Generator(device=cuda).manual_seed(0), tc)
        step = make_train_step(model, tc, rules)
        losses = []
        for _ in range(3):
            state, m = step(state, batch)
            losses.append(m["loss"])
        runs.append((state, losses))
    (one, l1), (mesh, l8) = runs
    assert all(torch.equal(a, b) for a, b in zip(l1, l8))
    for k, p in one["params"].items():
        assert torch.equal(p, mesh["params"][k]), k
        assert torch.equal(one["opt"]["v"][k], mesh["opt"]["v"][k].full()), k

    def close(got, want, what):
        err = float((got.cpu() - want).abs().max())
        assert err <= 1e-5 * max(1.0, float(want.abs().max())), (what, err)

    g = get_config("granite_moe")
    p = init_params(moe_specs(g), torch.Generator().manual_seed(0))
    x = torch.randn((4, 64, g.d_model), generator=torch.Generator().manual_seed(1))
    want = moe_ffn(p, x, g, mesh=make_mesh((2, 2), ("data", "model"), ["cpu"] * 4))
    got = moe_ffn({k: v.to(cuda) for k, v in p.items()}, x.to(cuda), g,
                  mesh=make_mesh((2, 2), ("data", "model"), [cuda] * 4))
    close(got[0], want[0], "moe out")
    close(got[1], want[1], "moe aux")

    ws, bs = torch.randn(8, 64, 64) / 8, torch.randn(8, 64) * 0.1
    xs = torch.randn(6, 4, 64)

    def layer(lp, h):
        return torch.tanh(h @ lp[0] + lp[1])

    want = gpipe_forward(layer, (ws, bs), xs, mesh=make_mesh((2,), ("pipe",), ["cpu"] * 2))
    got = gpipe_forward(layer, (ws.to(cuda), bs.to(cuda)), xs.to(cuda), mesh=make_mesh((2,), ("pipe",), [cuda] * 2))
    close(got, want, "gpipe")

    shards = [torch.randn(256, 8, 16) * s for s in (1.0, 0.5, 2.0, 0.01)]
    noise = [torch.rand(256, 8, 16) - 0.5 for _ in shards]
    want = compressed_psum(shards, noise)
    got = compressed_psum([s.to(cuda) for s in shards], [n.to(cuda) for n in noise])
    assert torch.equal(got.cpu(), want)


def test_dryrun_fim_on_card(cuda, tmp_path, monkeypatch):
    """``launch.dryrun_fim`` at --scale 0.01 on the card: every kernel
    launches, and each stage's outputs equal the same stage run with the
    plain kernel versions on the card."""
    import repro_torch.core.hprepost as hp
    import repro_torch.kernels as K
    from repro_torch.launch import dryrun_fim

    K.reset_launches()
    outputs = {}
    dryrun_fim.run(None, "1x1", R=10_485, C=256, device="cuda", out_dir=str(tmp_path), reps=1,
                   outputs=outputs)
    assert all(n > 0 for n in K.launches().values()), K.launches()

    def ones(r):
        return torch.ones(r.shape[0], dtype=torch.int32, device=r.device)

    monkeypatch.setattr(hp, "item_histogram", lambda r, n_bins, backend=None: histogram_ref(r, ones(r), n_bins=n_bins))
    monkeypatch.setattr(hp, "cooccurrence_matrix",
                        lambda r, n_items, backend=None: cooccur_ref(r, ones(r), n_items=n_items))
    monkeypatch.setattr(hp, "nlist_wave", lambda planes, prev, idx, n_live, backend=None, la_block=512,
                        early_stop=False, min_count=0: nlist_wave_ref(
                            planes, prev, idx, n_live, early_stop=early_stop, min_count=min_count,
                            la_block=la_block))

    def same(got, want):
        if isinstance(got, (list, tuple)):
            return len(got) == len(want) and all(same(g, w) for g, w in zip(got, want))
        return got.dtype == want.dtype and torch.equal(got, want)

    for name in dryrun_fim.STAGES:
        assert same(outputs[name], outputs["stages"][name]()), name


def test_kernel_and_plain_routes_charge_the_same_cost(cuda):
    """A kernel wrapper charges its cost function's count whichever route it
    takes: the card's kernel and the CPU's plain version agree."""
    from repro_torch.launch import cost

    rng = np.random.default_rng(5)
    rows = rng.integers(-1, 300, size=(5000, 24)).astype(np.int32)
    w = np.ones(5000, np.int32)
    for fn, kw in ((histogram_cuda, dict(n_bins=300)), (cooccur_cuda, dict(n_items=300))):
        charged = []
        for dev in ("cuda", "cpu"):
            _, pc = cost.trace(fn, T(rows, dev), T(w, dev), **kw)
            charged.append((pc.hbm_bytes, pc.flops))
        assert charged[0] == charged[1], fn.__name__


# ------------------------------------------------ the rows' staged copy to the card
@pytest.fixture(scope="module")
def kosarak_rows():
    rows, n_items = load("kosarak", scale=1.0)
    return np.require(rows, np.int32, ["C"]), n_items


def _assert_same_payload(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in got:
        if isinstance(got[k], np.ndarray):
            assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes(), k
        else:
            assert got[k] == want[k], k


@pytest.mark.parametrize("shape, n_rows", [((1, 1), 990_002), ((2, 1), 123_751)],
                         ids=["kosarak-1x1", "odd-rows-2x1"])
def test_rows_staged_to_the_card(cuda, kosarak_rows, shape, n_rows):
    """The rows through the miner's staging ring: kosarak's 990,002 x 48
    int32 rows (190 MB) on the 1x1 mesh, and an odd row count on a (2, 1)
    mesh whose positions share the card. Each block equals the padded host
    rows bit for bit; the copy takes no device memory beyond the blocks;
    the prepared payload equals the CPU miner's; and two threads preparing
    on one miner at once each get their own payload."""
    import threading

    from repro_torch.launch.mesh import make_mesh

    rows, n_items = kosarak_rows
    rows = rows[:n_rows]
    assert rows.shape == (n_rows, 48)
    mc = int(np.ceil(0.01 * n_rows))
    D = shape[0]
    Rs = -(-n_rows // D)
    axes = ("data", "model")
    gpu = HPrepostMiner(mesh=make_mesh(shape, axes, [cuda] * D))
    cpu = HPrepostMiner(mesh=make_mesh(shape, axes, ["cpu"] * D))
    padded = np.concatenate([rows, np.full((D * Rs - n_rows, 48), enc.PAD, np.int32)])

    def peak_of(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = fn()
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated() - base

    # the D blocks alone, as the caching allocator rounds them
    plain, want_peak = peak_of(lambda: [torch.empty((Rs, 48), dtype=torch.int32, device=cuda)
                                        for _ in range(D)])
    del plain
    blocks, peak = peak_of(lambda: gpu._shard_rows(rows))
    assert peak == want_peak >= D * Rs * 48 * 4
    for d, b in enumerate(blocks):
        assert b.is_cuda and b.dtype == torch.int32 and b.shape == (Rs, 48)
        assert b.cpu().numpy().tobytes() == padded[d * Rs:(d + 1) * Rs].tobytes(), d
    del blocks

    want = cpu.prepare(rows, n_items, mc).to_host()
    _assert_same_payload(gpu.prepare(rows, n_items, mc).to_host(), want)

    other = np.ascontiguousarray(rows[::-1])
    wants = [want, gpu.prepare(other, n_items, mc).to_host()]
    got = [None, None]

    def prepare(i, r):
        got[i] = gpu.prepare(r, n_items, mc).to_host()

    threads = [threading.Thread(target=prepare, args=(i, r)) for i, r in enumerate((rows, other))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not any(t.is_alive() for t in threads)
    for g, w in zip(got, wants):
        _assert_same_payload(g, w)
    torch.cuda.synchronize()
