"""The sliding-window cell on the CPU, at a size a test run holds: a cut
of ``kosarak_window`` (24,000 rows, window 8) runs through the harness as
``correct`` over requests that slide the window past its set-up, and its
stream metrics read the program's spans and counters."""
import json
from pathlib import Path

import pytest

from fimbench import harness, spans
from fimbench.metrics import stream_append_ms, stream_fold_ms, stream_query_ms, stream_readmits

HERE = Path(__file__).resolve().parents[1]
CELL = "kosarak_window.slide"
N_TX = 24000


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A checkout root whose BENCHMARK.json holds the window cell alone, its
    configuration cut to ``N_TX`` rows."""
    root = tmp_path_factory.mktemp("fimbench_window")
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    bench["configs"] = [c for c in bench["configs"] if c["name"] == "kosarak_window"]
    bench["workloads"] = [w for w in bench["workloads"] if w["name"] == CELL]
    conf = json.loads((HERE.parent / bench["configs"][0]["file"]).read_text())
    conf["dataset"]["n_tx"] = N_TX
    bench["configs"][0]["file"] = "configs/kosarak_window.json"
    (root / "configs").mkdir()
    (root / "configs/kosarak_window.json").write_text(json.dumps(conf))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def test_the_window_cell_is_correct(root):
    """Set-up's warm-up requests already slide the window by a whole
    window's worth of batches; the timed ones slide it on."""
    out = harness.run_cell(CELL, 2**31 + 11, 1.0, False, devices=["cpu"], root=root)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {"mines_per_s", "mine_ms_p95", "setup_s"}


def test_the_window_cell_slides_and_its_metrics_read_the_program(root):
    """Set-up and the warm-up requests replace every batch once; the
    requests then re-prepare nothing, and the four stream metrics read the
    spans and counters the program left in its table."""
    from types import SimpleNamespace

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from fimbench import data, loadgen
    from repro_torch.mining.telemetry import trace

    spec = harness.load_cell(CELL, root)
    config, traffic = spec["config"], spec["traffic"]
    rows = data.generate(config["name"], config["dataset"], 5)
    entry = loadgen.build_entry(traffic, rows, config["dataset"]["n_items"], ["cpu"], config)
    for _ in range(traffic["warmup_rounds"]):
        entry(rows, config["min_sup"])
    stream = entry.engine.stream("clicks")
    assert stream.stats["expired_segments"] == traffic["warmup_rounds"]
    assert {s.n_rows for s in stream.db.segments} == {N_TX // 8}
    trace.reset_profiled()
    with profile(activities=[ProfilerActivity.CPU]):
        answers = [entry(rows, config["min_sup"]) for _ in range(3)]
    run = SimpleNamespace(requests=[None] * 3)
    tab = spans.table()
    assert {"stream.append", "stream.query", "stream.fold", "stream.expire"} <= set(tab)
    assert tab["stream.readmitted_segments"] == {"count": 3, "total": 0}
    assert stream_readmits.read(run) == 0
    for metric in (stream_append_ms, stream_query_ms, stream_fold_ms):
        assert metric.read(run) > 0
    # the window holds the generated rows: each answer is the whole rows'
    assert all(a.n_rows == N_TX and a.itemsets == answers[0].itemsets for a in answers)
    db = stream.db
    assert db.C.shape[0] == db.n_ranked < 200 and max(s.k for s in db.segments) <= db.n_ranked
    assert np.count_nonzero(db.counts) > 10 * db.n_ranked
    trace.reset_profiled()
