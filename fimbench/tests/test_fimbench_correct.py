"""``correct`` on the CPU, at sizes a test run holds: the harness drives the
port's plain paths (``device="cpu"``) through whole runs of small copies of
the cells, and ``correct`` comes out true for the program, false for the
control (the reference with its exactness broken, in the program's place)
and false for each fault these cells can have, planted in the timed path."""
import json
from pathlib import Path
from types import SimpleNamespace

import pytest

from fimbench import control, harness

HERE = Path(__file__).resolve().parents[1]
SIZES = {"kosarak": (5000, 0.02)}
CELLS = ["kosarak.oneshot", "kosarak.resident"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A checkout root whose BENCHMARK.json holds the cells of ``SIZES``'s
    configurations, at those sizes."""
    root = tmp_path_factory.mktemp("fimbench_root")
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    bench["configs"] = [c for c in bench["configs"] if c["name"] in SIZES]
    bench["workloads"] = [w for w in bench["workloads"] if w["config"] in SIZES]
    for c in bench["configs"]:
        conf = json.loads((HERE.parent / c["file"]).read_text())
        conf["dataset"]["n_tx"], conf["min_sup"] = SIZES[c["name"]]
        c["file"] = f"configs/{c['name']}.json"
        (root / "configs").mkdir(exist_ok=True)
        (root / c["file"]).write_text(json.dumps(conf))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def run(root, cell, seed=2**31 + 5, fault=None):
    return harness.run_cell(cell, seed, 0.3, False, devices=["cpu"], root=root, fault=fault)


@pytest.mark.parametrize("cell", CELLS)
def test_the_program_is_correct(root, cell):
    out = run(root, cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    # no device here, so no device memory peak
    assert set(out["metrics"]) == {"mines_per_s", "mine_ms_p95", "setup_s"}


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(root, cell):
    out = run(root, cell, fault=control.sampled(seed=3))
    assert not out["correct"]
    assert out["checks"]["wrong_answers"]["value"] == out["attempted"]
    assert out["checks"]["mismatched_itemsets"]["value"] > 0


def altered(entry):
    """A support altered where the answer is produced."""
    def call(rows, min_sup):
        res = entry(rows, min_sup)
        key = max(res.itemsets, key=len)
        res.itemsets[key] += 1
        return res
    return call


def half_the_rows(entry):
    """Half of the database left out of the mine."""
    return lambda rows, min_sup: entry(rows[: len(rows) // 2], min_sup)


def state_unchanged(entry):
    """The first answer returned again, whatever is asked."""
    first = []

    def call(rows, min_sup):
        if not first:
            first.append(entry(rows, min_sup))
        return SimpleNamespace(itemsets=dict(first[0].itemsets), stage_times_s={})
    return call


def raises_after(n_calls):
    """Answers that never come: every call after set-up's ``n_calls``
    warm-up calls raises."""
    def wrap(entry):
        count = [0]

        def call(rows, min_sup):
            count[0] += 1
            if count[0] > n_calls:
                raise RuntimeError("no answer")
            return entry(rows, min_sup)
        return call
    return wrap


def warmup_calls(cell):
    traffic = json.loads((HERE / "traffic" / f"{cell.split('.')[1]}.json").read_text())
    return traffic["warmup_rounds"] * len(traffic["threshold_scale"])


@pytest.mark.parametrize("cell,fault", [
    (c, f) for c in CELLS for f in (altered, half_the_rows, "raises")
] + [("kosarak.resident", state_unchanged)])
def test_each_fault_is_not_correct(root, cell, fault):
    if fault == "raises":
        fault = raises_after(warmup_calls(cell))
    out = run(root, cell, fault=fault)
    assert not out["correct"], out["checks"]
    assert out["attempted"] >= 1
