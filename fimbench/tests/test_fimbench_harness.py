"""The harness: driven by data, JAX-free, shaped as the benchmark's
format requires, and refusing to run without a card."""
import ast
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from fimbench import devtrace, harness

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
SRC = ROOT / "src"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def imported_top_levels(path: Path) -> set[str]:
    """The top-level name of every module ``path`` imports (absolute
    imports; relative ones stay inside the package)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(HERE.rglob("*.py"))
    assert files
    for f in files:
        bad = imported_top_levels(f) & {"jax", "jaxlib", "flax", "repro"}
        assert not bad, f"{f.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("name", ["reference.py", "data.py"])
def test_yardstick_imports_nothing_of_the_program(name):
    assert "repro_torch" not in imported_top_levels(HERE / name)


def test_forbidden_modules_compares_whole_names():
    assert harness.forbidden_modules(["repro_torch.mining", "numpy", "jaxtyping"]) == []
    assert harness.forbidden_modules(["jax.numpy", "repro.core", "flax", "torch"]) == [
        "flax", "jax", "repro"]


def test_benchmark_json_is_well_formed():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["fimbench"] and bench["command"][1].startswith("fimbench/")
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    runs = 2 + 14 * 24  # a full check with 24 cells fits its time
    assert runs * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    configs = {c["name"]: c for c in bench["configs"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"] and conf["source"] == c["source"]
        assert sorted(conf["reduced"]) == sorted(c["reduced"])
    used = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert w["config"] in configs
        traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
        assert (HERE / "entries" / f"{traffic['entry']}.py").exists()
        assert (HERE / "loops" / f"{traffic['loop']}.py").exists()
        used.add(w["config"])
    assert used == set(configs)
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and m["better"] in ("lower", "higher")
        assert (HERE / "metrics" / f"{m['name']}.py").exists(), m["name"]
        assert set(m.get("workloads", [])) <= cells
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].endswith("_roofline")
    for cell in cells:
        assert any(cell in m.get("workloads", cells) for m in bench["per_layer"])
    assert len(json.dumps(bench)) < 64 * 1024


NEW_ENTRY = """
def build(rows, n_items, devices, config, traffic):
    from repro_torch.mining import mine

    def entry(rows, min_sup):
        return mine(rows, n_items, device=devices[0], algorithm="hprepost", min_sup=min_sup)

    entry.n_items = n_items
    return entry
"""

NEW_LOOP = """
import time

from fimbench.loops import Request, digest


def drive(call, rows, order, seconds, keep, trace, sync, traffic):
    reqs, kept = [], {}
    t_open = time.perf_counter()
    while time.perf_counter() - t_open < seconds:
        time.sleep(max(0.0, t_open + len(reqs) * traffic["interval_s"] - time.perf_counter()))
        min_sup = next(order)
        t0 = time.perf_counter()
        res = call(rows, min_sup)
        reqs.append(Request(min_sup, time.perf_counter() - t0, dict(res.stage_times_s), None,
                            digest(res.itemsets)))
        if keep(len(kept), min_sup):
            kept[len(reqs) - 1] = res.itemsets
    return reqs, kept, time.perf_counter() - t_open
"""


@pytest.mark.parametrize("entry,loop", [("resident", "closed"), ("default_engine", "paced")])
def test_a_new_cell_is_only_new_files(tmp_path, entry, loop):
    """A configuration, a traffic mix, a metric reader, and where the mix
    needs them an entry and a loop, added as files to a copy of the folder
    make a runnable cell; no file there is edited."""
    shutil.copytree(HERE, tmp_path / "fimbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in (tmp_path / "fimbench").rglob("*") if p.is_file()}
    conf = {
        "name": "tiny_basket", "source": "a test's own deployment",
        "dataset": {"kind": "sparse", "n_items": 300, "n_tx": 3000, "avg_len": 6,
                    "max_len": 16, "zipf_a": 1.2},
        "min_sup": 0.02, "guarantee": "exact", "reduced": [], "assumed": {},
    }
    new = {"configs/tiny_basket.json", "traffic/two_step.json", "metrics/requests_seen.py"}
    (tmp_path / "fimbench/configs/tiny_basket.json").write_text(json.dumps(conf))
    (tmp_path / "fimbench/traffic/two_step.json").write_text(json.dumps({
        "entry": entry, "loop": loop, "interval_s": 0.01,
        "threshold_scale": [1, 2], "warmup_rounds": 1}))
    (tmp_path / "fimbench/metrics/requests_seen.py").write_text(
        "def read(run):\n    return float(len(run.requests))\n")
    for kind, name, text in (("entries", entry, NEW_ENTRY), ("loops", loop, NEW_LOOP)):
        path = tmp_path / "fimbench" / kind / f"{name}.py"
        if not path.exists():
            path.write_text(text)
            new.add(f"{kind}/{name}.py")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny_basket", "source": "a test's own deployment",
                             "file": "fimbench/configs/tiny_basket.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": "tiny_basket.two_step", "config": "tiny_basket",
                               "traffic": "two_step", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "requests_seen", "unit": "requests", "better": "higher",
                               "source": "host_clock", "layer": "test", "moves": "mines_per_s",
                               "workloads": ["tiny_basket.two_step"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json, sys; from fimbench import harness; print(json.dumps("
            "harness.run_cell('tiny_basket.two_step', 7, 0.3, True, devices=['cpu'])))")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path), str(SRC)]))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["metrics"]["requests_seen"]["value"] == out["attempted"]
    assert set(out["metrics"]) == {"requests_seen"}  # the traced run's metrics of this cell
    for p, content in before.items():
        assert p.read_bytes() == content
    assert {str(p.relative_to(tmp_path / "fimbench")) for p in (tmp_path / "fimbench").rglob("*")
            if p.is_file() and p not in before and "__pycache__" not in p.parts} == new


def test_run_refuses_without_a_card():
    """The command line never falls back to the CPU: with no CUDA device it
    exits with another code than 0 and prints no result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload", "kosarak.oneshot",
                           "--seed", "1", "--seconds", "1"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_device_trace_reduction():
    """Busy time is the union of device intervals inside the window; each
    idle gap is named by the innermost host event running at its middle."""
    w = {"ph": "X", "cat": "user_annotation", "name": devtrace.WINDOW, "ts": 0, "dur": 100,
         "pid": 1, "tid": 7}
    events = [
        w,
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 10, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 15, "dur": 15},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 50, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "late", "ts": 95, "dur": 20},  # clipped to 5
        {"ph": "X", "cat": "cpu_op", "name": "aten::sort", "ts": 32, "dur": 10, "pid": 1, "tid": 7},
        {"ph": "X", "cat": "cpu_op", "name": "aten::other_thread", "ts": 60, "dur": 30, "pid": 1,
         "tid": 8},
    ]
    out = devtrace.reduce(events)
    assert out["window_s"] == pytest.approx(100e-6)
    assert out["op_s"]["k2"] == pytest.approx(15e-6)
    assert out["busy_s"] == pytest.approx(35e-6)  # [10, 30] + [50, 60] + [95, 100]
    gaps = dict(out["idle_gaps"])
    assert gaps["aten::sort"] == pytest.approx(20e-6)  # the gap [30, 50]
    assert gaps[devtrace.WINDOW] == pytest.approx(45e-6)  # [0, 10] and [60, 95]
    assert dict(out["device_ops"])["late"] == pytest.approx(5e-6)
    assert devtrace.reduce([e for e in events if e is not w]) is None


def test_device_trace_busy_is_the_mean_over_the_cells_devices():
    w = {"ph": "X", "cat": "user_annotation", "name": devtrace.WINDOW, "ts": 0, "dur": 100,
         "pid": 1, "tid": 7}
    events = [
        w,
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 0, "dur": 40, "args": {"device": 0}},
        {"ph": "X", "cat": "kernel", "name": "b", "ts": 20, "dur": 40, "args": {"device": 1}},
        {"ph": "X", "cat": "kernel", "name": "c", "ts": 0, "dur": 90, "args": {"device": 2}},
    ]
    out = devtrace.reduce(events, devices=[0, 1])
    assert out["busy_s"] == pytest.approx(40e-6)  # device 2 is not the cell's
    gaps = dict(out["idle_gaps"])
    assert gaps[devtrace.WINDOW] == pytest.approx(40e-6)  # no device of the cell busy


def test_prep_kernel_roofline_reads_the_traced_kernels():
    """Time from the trace's B3/B4 kernels; work from the requests that
    launched them, counted from the cell's rows."""
    from types import SimpleNamespace

    from fimbench import roofline
    from fimbench.loops import Request
    from fimbench.metrics import prep_kernel_roofline

    rows = np.array([[0, 1, 2, -1], [0, 1, -1, -1], [0, 2, 3, -1], [3, -1, -1, -1]], np.int32)
    launched = {"histogram": 1, "cooccur": 1, "nlist_intersect": 0, "nlist_intersect_es": 2}
    reqs = [Request(0.5, 0.01, {}, launched, 0), Request(0.5, 0.01, {}, launched, 0),
            Request(0.5, 0.01, {}, dict(launched, cooccur=0), 0)]
    trace = {"op_s": {"void (anonymous namespace)::hist_kernel<true>(int const*)": 3e-6,
                      "void (anonymous namespace)::cooc_band_kernel<64>(int const*)": 1e-6,
                      "void (anonymous namespace)::wave_kernel<true, 256, 8>(int)": 9.0}}
    run = SimpleNamespace(trace=trace, rows=rows, n_items=5, requests=reqs)
    b3 = roofline.bound_s(*roofline.histogram_work(4, 4, 5))
    # at min_sup 0.5 (2 rows): items 0, 1, 2 and 3 are frequent
    b4 = roofline.bound_s(*roofline.cooccur_work(4, 4, [3, 2, 3, 1], 4))
    assert prep_kernel_roofline.read(run) == pytest.approx(100 * (3 * b3 + 2 * b4) / 4e-6)
    run.trace = {"op_s": {"void (anonymous namespace)::wave_kernel<true, 256, 8>(int)": 9.0}}
    assert prep_kernel_roofline.read(run) is None
    run.trace = None
    assert prep_kernel_roofline.read(run) is None
