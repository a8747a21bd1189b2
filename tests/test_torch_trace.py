"""The port's spans in a ``torch.profiler`` trace and in the span table
(``repro_torch.mining.telemetry.trace``), on the CPU: every span of the
one-shot, engine and window-query paths appears as a range, nested as
the code nests it; the table's counts and self seconds add up; nothing is recorded with
no sink active; and the ``wave.floor_bytes`` counter never exceeds the
bytes ``ops.wave_cost`` counts for the same launch."""
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core.hprepost import HPrepostConfig, HPrepostMiner
from repro_torch.data.synth import random_db
from repro_torch.kernels.nlist_intersect.ops import wave_cost
from repro_torch.mining import MineSpec, MiningEngine, get_miner, telemetry
from repro_torch.mining.telemetry import trace

PREP = ("prep.h2d", "prep.job1", "prep.job2", "prep.pack", "prep.f2")
WAVES = ("mine.plan", "mine.wave", "mine.reduce", "mine.emit")
# span -> the span it opens inside, on the one-shot path
PARENT = {
    **{s: "prep" for s in PREP},
    **{s: "mine.waves" for s in WAVES},
    "prep": "frontend.mine",
    "mine.planes": "frontend.mine",
    "mine.waves": "frontend.mine",
    "frontend.finish": "frontend.mine",
}
# on the engine's path prep runs before the frontend, inside the submit
ENGINE_PARENT = {
    **PARENT,
    "prep": "engine.submit",
    "frontend.mine": "engine.submit",
    "engine.fingerprint": "engine.submit",
    "engine.cache": "engine.submit",
}


@pytest.fixture(autouse=True)
def empty_table():
    trace.reset_profiled()
    yield
    trace.reset_profiled()


@pytest.fixture
def kosarak_like():
    return random_db(np.random.default_rng(3), 300, 24, 9), 24


def one_shot(rows, n_items, min_sup):
    fe = get_miner("hprepost", device="cpu")
    spec = MineSpec(algorithm="hprepost", min_sup=min_sup, candidate_unit=4)
    res = fe.mine(rows, n_items, spec)
    return res, fe.miner_for(spec)


def engine_cold(rows, n_items, min_sup):
    eng = MiningEngine(device="cpu")
    spec = MineSpec(algorithm="hprepost", min_sup=min_sup, candidate_unit=4)
    res = eng.submit(rows, n_items, spec)
    return res, eng.frontend("hprepost").miner_for(spec)


def profiled_events(tmp_path, fn, *args):
    """Run ``fn`` under a CPU profiler -> (its result, the trace's
    complete events of the port's spans)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn(*args)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    names = set(ENGINE_PARENT) | set(ENGINE_PARENT.values())
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("name") in names]
    return out, events


def inside(child, parent):
    c0, p0 = float(child["ts"]), float(parent["ts"])
    return (child["tid"] == parent["tid"] and c0 >= p0
            and c0 + float(child["dur"]) <= p0 + float(parent["dur"]))


@pytest.mark.parametrize("path, parents, root", [
    (one_shot, PARENT, "frontend.mine"),
    (engine_cold, ENGINE_PARENT, "engine.submit"),
], ids=["one_shot", "engine"])
def test_profiled_mine_has_every_span_nested(tmp_path, kosarak_like, path, parents, root):
    (res, miner), events = profiled_events(tmp_path, path, *kosarak_like, 0.05)
    assert miner.stage_counters["waves"] >= 2
    by_name = {}
    for e in events:
        by_name.setdefault(e["name"], []).append(e)
    assert set(by_name) == set(parents) | {root}
    assert len(by_name[root]) == 1
    for e in events:
        if e["name"] != root:
            assert any(inside(e, p) for p in by_name[parents[e["name"]]]), e["name"]
    # ranges of one thread never overlap but by nesting
    for a in events:
        for b in events:
            if a is not b and a["tid"] == b["tid"]:
                a0, a1 = float(a["ts"]), float(a["ts"]) + float(a["dur"])
                b0, b1 = float(b["ts"]), float(b["ts"]) + float(b["dur"])
                assert a1 <= b0 or b1 <= a0 or inside(a, b) or inside(b, a)


@pytest.mark.parametrize("early_stop", [True, False])
def test_profiled_table_counts_waves_and_self_sums_to_the_root(kosarak_like, early_stop):
    rows, n_items = kosarak_like
    fe = get_miner("hprepost", device="cpu")
    spec = MineSpec(algorithm="hprepost", min_sup=0.05, candidate_unit=4, early_stop=early_stop)
    with profile(activities=[ProfilerActivity.CPU]):
        fe.mine(rows, n_items, spec)
    tab = trace.profiled()
    waves = fe.miner_for(spec).stage_counters["waves"]
    assert waves >= 2 and tab["mine.wave"]["count"] == waves
    assert tab["mine.reduce"]["count"] == waves
    assert tab["wave.floor_bytes"]["count"] == waves  # one launch a wave on one device
    spans = {k: v for k, v in tab.items() if "self_s" in v}
    assert sum(v["self_s"] for v in spans.values()) == pytest.approx(
        tab["frontend.mine"]["total_s"], rel=1e-9)
    for name, row in spans.items():
        assert 0 <= row["self_s"] <= row["total_s"], name
    # on the CPU a device-timed span's device seconds are its host seconds
    for name in PREP:
        assert tab[name]["count"] == 1
        assert tab[name]["device_s"] == tab[name]["total_s"] > 0
    assert tab["mine.waves"]["device_s"] == 0.0


def test_no_sink_no_span_and_nothing_in_the_table(kosarak_like):
    assert trace.active() is None
    assert trace.span("x") is trace._NULL
    assert trace.span("prep.h2d", device=torch.device("cpu")) is trace._NULL
    one_shot(*kosarak_like, 0.05)
    trace.count("wave.floor_bytes", 10)
    assert trace.profiled() == {}


def test_reset_profiled_empties_the_table():
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("outer"):
            with trace.span("inner"):
                pass
        trace.count("c", 3)
        trace.count("c", 4)
    tab = trace.profiled()
    assert tab["outer"]["count"] == tab["inner"]["count"] == 1
    assert tab["outer"]["self_s"] == pytest.approx(
        tab["outer"]["total_s"] - tab["inner"]["total_s"])
    assert tab["c"] == {"count": 2, "total": 7}
    trace.reset_profiled()
    assert trace.profiled() == {}


def test_recorder_and_profiler_see_the_same_spans(kosarak_like):
    rec = telemetry.TraceRecorder()
    with telemetry.attached(rec), profile(activities=[ProfilerActivity.CPU]):
        one_shot(*kosarak_like, 0.05)
    names = [s["name"] for s in rec.spans.values()]
    tab = trace.profiled()
    assert {n: names.count(n) for n in names} == {
        n: row["count"] for n, row in tab.items() if "self_s" in row}
    parent = {sid: s["parent"] for sid, s in rec.spans.items()}
    for sid, s in rec.spans.items():
        if s["name"] in PARENT:
            assert rec.spans[parent[sid]]["name"] == PARENT[s["name"]]


@pytest.mark.parametrize("early_stop", [True, False])
@pytest.mark.parametrize("db", ["paper", "random"])
def test_wave_floor_bytes_at_most_wave_cost(paper_db, db, early_stop):
    """Each launch's ``wave.floor_bytes`` against ``ops.wave_cost`` on the
    same inputs: the floor leaves out only what depends on the data."""
    rows, n_items = paper_db if db == "paper" else (
        random_db(np.random.default_rng(5), 400, 20, 8), 20)
    min_count = 2 if db == "paper" else 12
    miner = HPrepostMiner("cpu", HPrepostConfig(candidate_unit=4, early_stop=early_stop))
    launched = miner._wave
    seen = []

    def wave(planes, prev_state, idx, n_live, stop_count, plan=None):
        before = trace.profiled().get("wave.floor_bytes", {"total": 0})["total"]
        out = launched(planes, prev_state, idx, n_live, stop_count, plan)
        floor = trace.profiled()["wave.floor_bytes"]["total"] - before
        plan = plan or miner._kernel_plan(idx.shape[1], planes.shape[2])
        idx_t = idx if isinstance(idx, torch.Tensor) else torch.from_numpy(idx)
        nbytes, _ = wave_cost(planes, prev_state, idx_t, n_live,
                              early_stop=plan.early_stop and stop_count > 0,
                              min_count=stop_count, la_block=plan.la_block)
        seen.append((floor, nbytes, idx_t.shape[1], planes.shape[2], n_live))
        return out

    miner._wave = wave
    with profile(activities=[ProfilerActivity.CPU]):
        miner.mine(rows, n_items, min_count)
    assert len(seen) == miner.stage_counters["waves"] >= 1
    for floor, nbytes, cpad, width, n_live in seen:
        assert floor == cpad * width * 4 + cpad * 4 + 3 * n_live * 8
        assert 0 < floor <= nbytes


def test_subset_check_counters_under_the_profiler_and_off():
    """``plan.subset_rows`` counts the drop-one subsets the check tests
    (up to its early exit), ``plan.subset_multiword`` the calls whose keys
    take more than one word; with no profiler they leave no row."""
    kept = HPrepostMiner._apriori_kept
    # K 85, width 5: one word; every row loses its second subset, so the
    # check stops after two positions of three rows
    d1 = np.array([[0, 1, 2, 3, 4], [0, 1, 2, 3, 5], [0, 1, 2, 3, 6]], np.int32)
    s1 = np.delete(d1, 1, axis=1)
    # K 7,104, width 6: 5 subsets of 13 bits, two words; both rows kept
    d2 = np.array([[10, 200, 3000, 4000, 5000, 7103]] * 2, np.int32)
    s2 = np.stack([np.delete(d2[0], p) for p in range(1, 6)])
    calls = [(d1, s1, 85), (d2, s2, 7104), (d1[:, :3], s1[:, :2], 85)]  # the last: width 3, None
    want = [[False] * 3, [True] * 2, None]

    def run():
        for (d, s, k), w in zip(calls, want):
            got = kept(d, s, k)
            assert (got is None and w is None) or got.tolist() == w

    run()
    assert trace.profiled() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        run()
    tab = trace.profiled()
    assert tab["plan.subset_rows"] == {"count": 2, "total": 3 * 2 + 2 * 5}
    assert tab["plan.subset_multiword"] == {"count": 1, "total": 1}


@pytest.mark.parametrize("path", ["pipelined", "unpipelined", "segmented"])
def test_extension_counters_seed_level_two_only(path):
    """``plan.extend_rows`` counts the rows each ``_extensions`` call extends,
    ``plan.extend_seeded`` the rows whose allowed set was built from the pair
    table: only the level-2 candidates (the frequent pairs, as ``C`` holds
    exact pair supports), once a mine; every deeper row carries its set, on
    both wave loops, pipelined or not. With no profiler they leave no row."""
    from repro_torch.mining.stream import StreamSpec

    # dense rows: width 6 is frequent, and both prunes drop rows with their sets
    rows, n_items = random_db(np.random.default_rng(5), 200, 8, 8), 8
    spec = MineSpec(algorithm="hprepost", min_sup=0.175)
    if path == "segmented":
        eng = MiningEngine(device="cpu")
        for part in np.array_split(rows, 3):
            eng.append(part, n_items, stream="s", stream_spec=StreamSpec(window_batches=3))

        def run():
            return eng.submit_stream(spec, stream="s")
    else:
        miner = HPrepostMiner("cpu", config=HPrepostConfig(
            candidate_unit=4, pipeline_waves=path == "pipelined"))

        def run():
            return miner.mine(rows, n_items, 35)

    run()
    assert trace.profiled() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        res = run()
    tab = trace.profiled()
    pairs = sum(len(s) == 2 for s in res.itemsets)
    assert max(len(s) for s in res.itemsets) >= 4  # rows of width 3 were extended
    assert tab["plan.extend_seeded"] == {"count": 1, "total": pairs}
    assert tab["plan.extend_rows"]["count"] >= 2
    assert tab["plan.extend_rows"]["total"] > pairs


def test_stream_spans_and_counters_under_the_profiler():
    """On a floored stream an append records ``stream.fold`` and, when a
    batch expires, ``stream.expire``; a query that prepares a segment again
    records ``stream.readmit``; the counters ``stream.kept_items`` (Σ K_s of
    every segment built) and ``stream.readmitted_segments`` (at every
    query, 0 included) fill; and the benchmark's four stream metrics read
    them."""
    from types import SimpleNamespace

    from fimbench.metrics import stream_append_ms, stream_fold_ms, stream_query_ms, stream_readmits
    from repro_torch.mining.stream import StreamSpec

    def block(n, items):
        out = np.full((n, 3), -1, np.int32)
        out[:, :len(items)] = items
        return out

    # b's items are below the floor when it arrives (a hollow segment);
    # c lifts 5 and 6 over it, so the next query prepares b again
    a, b, c = block(100, [0, 1]), block(5, [5, 6, 7]), block(50, [5, 6])
    eng = MiningEngine(device="cpu")
    eng.append(a, 8, stream="s", stream_spec=StreamSpec(window_batches=3, min_sup_floor=0.2))
    eng.append(b, stream="s")
    assert trace.profiled() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        for batch in (c, a):  # the second append expires the first a
            eng.append(batch, stream="s")
            eng.submit_stream(MineSpec(algorithm="hprepost", min_sup=0.2), stream="s")
    tab = trace.profiled()
    for name, n in (("stream.append", 2), ("stream.query", 2), ("stream.expire", 1),
                    ("stream.readmit", 1)):
        assert tab[name]["count"] == n, name
    assert tab["stream.fold"]["count"] == 6  # histogram, admission, fold: each append
    assert tab["stream.kept_items"] == {"count": 3, "total": 6}  # c, b again, a: two items each
    assert tab["stream.readmitted_segments"] == {"count": 2, "total": 1}
    run = SimpleNamespace(requests=[None] * 2)
    assert stream_readmits.read(run) == 0.5
    for metric in (stream_append_ms, stream_query_ms, stream_fold_ms):
        assert metric.read(run) > 0
    assert stream_query_ms.read(run) > 1e3 * tab["stream.readmit"]["total_s"] / 2


def test_window_query_opens_the_wave_spans(tmp_path, monkeypatch):
    """A sliding-window query runs the one wave loop: under the profiler
    ``mine.waves`` nests in ``stream.query``, and ``mine.plan``,
    ``mine.wave``, ``mine.reduce`` and ``mine.emit`` nest in ``mine.waves``;
    one ``mine.wave`` (tagged with the segment count) a counted wave, each
    launching B1 once a segment; and ``stage_times_s["mining_waves"]``
    times the region the ``mine.waves`` span holds."""
    from repro_torch.core import hprepost
    from repro_torch.mining.stream import StreamSpec

    rows, n_items = random_db(np.random.default_rng(5), 200, 8, 8), 8
    eng = MiningEngine(device="cpu")
    for part in np.array_split(rows, 4):  # a window of 3: the first batch expires
        eng.append(part, n_items, stream="s", stream_spec=StreamSpec(window_batches=3))
    spec = MineSpec(algorithm="hprepost", min_sup=0.175)
    miner = eng.stream("s")._fe.miner_for(spec)
    early_stop = []
    launch = hprepost.nlist_wave

    def spy(*args, **kw):
        early_stop.append(kw["early_stop"])
        return launch(*args, **kw)

    monkeypatch.setattr(hprepost, "nlist_wave", spy)
    w0 = miner.stage_counters["waves"]
    rec = telemetry.TraceRecorder()
    with telemetry.attached(rec), profile(activities=[ProfilerActivity.CPU]) as prof:
        res = eng.submit_stream(spec, stream="s")
    waves = miner.stage_counters["waves"] - w0
    assert waves >= 3 and max(len(s) for s in res.itemsets) >= 4
    assert early_stop == [False] * (3 * waves)

    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    names = {"stream.query", "mine.waves", *WAVES}
    by_name = {}
    for e in json.loads(path.read_text())["traceEvents"]:
        if e.get("ph") == "X" and e.get("name") in names:
            by_name.setdefault(e["name"], []).append(e)
    assert set(by_name) == names
    assert len(by_name["stream.query"]) == len(by_name["mine.waves"]) == 1
    assert inside(by_name["mine.waves"][0], by_name["stream.query"][0])
    for name in WAVES:
        assert all(inside(e, by_name["mine.waves"][0]) for e in by_name[name]), name

    tab = trace.profiled()
    for name in ("mine.wave", "mine.reduce", "mine.emit"):
        assert tab[name]["count"] == waves, name
    wave_args = [s["args"] for s in rec.spans.values() if s["name"] == "mine.wave"]
    assert [(a["k"], a["segments"]) for a in wave_args] == [
        (k, 3) for k in range(2, 2 + waves)]
    # two clock reads around one region: equal but for the span's own exit
    mining_waves, total = res.stage_times_s["mining_waves"], tab["mine.waves"]["total_s"]
    assert 0 < mining_waves <= total
    assert total == pytest.approx(mining_waves, abs=1e-3)
