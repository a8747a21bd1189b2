"""One run of one cell: generate the data from the seed, build and warm the
system under test, drive the window, judge every answer against the plain
reference, and assemble the result line.

Everything is found by name: the cell in ``BENCHMARK.json``, its
configuration in ``fimbench/configs/<config>.json``, its traffic in
``fimbench/traffic/<mix>.json`` (whose entry and loop are modules of
``fimbench/entries/`` and ``fimbench/loops/``), and each metric's reader
in ``fimbench/metrics/<metric>.py`` (``read(run) -> float | None``; None
leaves the metric out of the line).
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np

from fimbench import data, loadgen, reference
from fimbench.loops import digest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
SAMPLE_EVERY = 8  # a seeded one in this many answers is also kept whole
SAMPLE_CAP = 16


def load_cell(workload: str, root: Path = ROOT) -> dict:
    """The cell's entry, configuration, traffic and metrics, by name."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[workload]
    conf_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((root / conf_entry["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())

    def applies(m):
        return "workloads" not in m or workload in m["workloads"]

    return {
        "cell": cell, "config": config, "traffic": traffic,
        "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
        "per_layer": [m for m in bench["per_layer"] if applies(m)],
    }


@dataclasses.dataclass
class Run:
    """What a metric reader reads."""

    workload: str
    config: dict
    traffic: dict
    devices: list  # torch.device, one a chip
    rows: np.ndarray
    n_items: int
    floor_count: int  # the configuration's threshold as a count
    setup_s: float
    window_s: float
    requests: list  # loops.Request
    peak_window_bytes: int | None
    trace: dict | None  # devtrace.reduce's


def mismatches(got: dict, want: dict) -> int:
    """Itemsets missing, extra, or with another support."""
    keys = got.keys() | want.keys()
    return sum(got.get(k) != want.get(k) for k in keys)


def judge(reqs, kept, rows, n_items: int, floor_count: int):
    """Hold every answer to the reference. -> the checks, each number with
    its limit."""
    t0 = time.perf_counter()
    found = reference.mine(rows, n_items, floor_count)
    want: dict[float, dict] = {}
    for s in {r.min_sup for r in reqs}:
        want[s] = reference.at_threshold(found, reference.min_count_of(s, len(rows)))
    want_digest = {s: digest(d) for s, d in want.items()}
    print(f"fimbench reference: {time.perf_counter() - t0:.1f} s; itemsets by min_sup "
          + " ".join(f"{s}: {len(want[s])}" for s in sorted(want)), file=sys.stderr)
    wrong = missing = 0
    for r in reqs:
        if r.digest is None:
            missing += 1
        else:
            r.correct = r.digest == want_digest[r.min_sup]
            wrong += not r.correct
    mism = sum(mismatches(dict(got), want[reqs[i].min_sup]) for i, got in kept.items())
    return {
        "wrong_answers": {"value": wrong, "limit": 0},
        "missing_answers": {"value": missing, "limit": 0},
        "mismatched_itemsets": {"value": mism, "limit": 0},
    }


def log_setup(marks, t_start: float, setup_s: float) -> None:
    """Each set-up step's seconds, on standard error."""
    steps, t = [], t_start
    for name, m in marks:
        steps.append(f"{name} {m - t:.3f}")
        t = m
    print(f"fimbench set-up, s: {', '.join(steps)}; total {setup_s:.3f}", file=sys.stderr)


def log_window(reqs, window_s: float) -> None:
    """The window's median latency by quarter and by threshold, on standard
    error: a drift inside the window, or a threshold slower than the rest,
    shows there."""
    lat = [r.latency_s * 1e3 for r in reqs]
    quarters = [statistics.median(lat[i * len(lat) // 4:(i + 1) * len(lat) // 4] or [0.0])
                for i in range(4)]
    by_sup = {s: statistics.median(r.latency_s * 1e3 for r in reqs if r.min_sup == s)
              for s in sorted({r.min_sup for r in reqs})}
    print(f"fimbench window: {len(reqs)} requests in {window_s:.3f} s; median ms by quarter "
          + " ".join(f"{q:.3f}" for q in quarters) + "; by min_sup "
          + " ".join(f"{s}: {m:.3f}" for s, m in by_sup.items()), file=sys.stderr)


class HostWatch:
    """What the host did during the window, for the log: the garbage
    collector's pauses in this process, and the share of the window in
    which this process ran on a CPU."""

    def __enter__(self):
        self.gc_s, self.gc_n, self._t = 0.0, 0, 0.0
        gc.callbacks.append(self._on_gc)
        self.cpu0, self.t0 = time.process_time(), time.perf_counter()
        return self

    def _on_gc(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.gc_s += time.perf_counter() - self._t
            self.gc_n += 1

    def __exit__(self, *exc):
        gc.callbacks.remove(self._on_gc)
        wall = time.perf_counter() - self.t0
        print(f"fimbench host: gc {self.gc_n} collections {self.gc_s:.4f} s; this process on a "
              f"CPU {(time.process_time() - self.cpu0) / wall:.3f} of the window", file=sys.stderr)
        return False


def forbidden_modules(names=None) -> list[str]:
    """The forbidden top-level packages among ``names`` (the loaded
    modules by default), compared by whole top-level name."""
    names = sys.modules if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, devices=None,
             t_start: float | None = None, root: Path = ROOT, fault=None) -> dict:
    """One run of ``workload``; -> the result line's object. ``devices``
    are the cell's devices, by default the first ``chips`` CUDA devices
    (the command line allows nothing else); ``fault`` wraps the entry's
    call, for the tests that break the timed path underneath the
    harness."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    spec = load_cell(workload, root)
    config, traffic = spec["config"], spec["traffic"]
    if devices is None:
        devices = [f"cuda:{i}" for i in range(spec["cell"]["chips"])]
    devs = [torch.device(d) for d in devices]
    cuda = devs[0].type == "cuda"

    def sync():
        for d in devs if cuda else ():
            torch.cuda.synchronize(d)

    marks = [("imports", time.perf_counter())]
    rows = data.generate(config["name"], config["dataset"], seed, device=devs[0])
    n_items = config["dataset"]["n_items"]
    floor_count = reference.min_count_of(config["min_sup"], len(rows))
    marks.append(("data", time.perf_counter()))
    entry = loadgen.build_entry(traffic, rows, n_items, devs, config)
    call = entry if fault is None else fault(entry)
    drive = loadgen.loop_of(traffic)
    marks.append(("entry", time.perf_counter()))
    for _ in range(traffic["warmup_rounds"]):
        for s in loadgen.thresholds(config, traffic):
            call(rows, s)
            sync()
            marks.append(("warm", time.perf_counter()))
    order = loadgen.request_order(config, traffic, seed)
    pick = np.random.default_rng([seed % 2**63, 0x5A4D])
    seen: set = set()

    def keep(n_kept, min_sup):
        """Keep each threshold's first answer whole, and a seeded one in
        ``SAMPLE_EVERY`` of the rest up to ``SAMPLE_CAP``."""
        first = min_sup not in seen
        seen.add(min_sup)
        return first or (n_kept < SAMPLE_CAP and pick.random() * SAMPLE_EVERY < 1)

    peak_setup = max(torch.cuda.max_memory_allocated(d) for d in devs) if cuda else None
    for d in devs if cuda else ():
        torch.cuda.reset_peak_memory_stats(d)
    gc.collect()
    prof = None
    if trace and cuda:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.start()
    setup_s = time.perf_counter() - t_start
    log_setup(marks, t_start, setup_s)
    with HostWatch(), torch.profiler.record_function("fimbench.window"):
        reqs, kept, window_s = drive(call, rows, order, seconds, keep, trace, sync, traffic)
    peak_window = max(torch.cuda.max_memory_allocated(d) for d in devs) if cuda else None
    log_window(reqs, window_s)
    trace_out = None
    if prof is not None:
        prof.stop()
        from fimbench import devtrace

        t_read = time.perf_counter()
        events = devtrace.events_of(prof)
        trace_out = devtrace.reduce(events, [d.index for d in devs])
        print(f"fimbench trace: {len(events)} events read in {time.perf_counter() - t_read:.1f} s",
              file=sys.stderr)
        del events
        del prof
    del entry, call
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    checks = judge(reqs, kept, rows, n_items, floor_count)
    run = Run(workload, config, traffic, devs, rows, n_items, floor_count, setup_s, window_s,
              reqs, peak_window, trace_out)
    metrics = {}
    for m in spec["per_layer"] if trace else spec["end_to_end"]:
        value = importlib.import_module(f"fimbench.metrics.{m['name']}").read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    errors = sum(r.error is not None for r in reqs)
    failed = errors + sum(r.digest is not None and not r.correct for r in reqs)
    correct = bool(reqs) and all(c["value"] <= c["limit"] for c in checks.values())
    out = {"correct": correct, "attempted": len(reqs), "failed": failed, "metrics": metrics}
    if cuda:
        out["device"] = {
            "platform": "gpu", "kind": torch.cuda.get_device_name(devs[0]), "count": len(devs),
            "memory_peak_bytes": int(max(peak_setup, peak_window)),
        }
        if trace_out is not None:
            out["device"].update(busy_s=trace_out["busy_s"], window_s=trace_out["window_s"])
            out["breakdown"] = {"device_ops": trace_out["device_ops"],
                                "idle_gaps": trace_out["idle_gaps"]}
    if errors:
        out["first_error"] = next(r.error for r in reqs if r.error)
    out["checks"] = checks
    return out
