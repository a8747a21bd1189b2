"""Reduction of a ``torch.profiler`` trace of the window to device numbers.

A device's busy time is the union of its kernel, copy and memset
intervals inside the window (the span of the harness's ``fimbench.window``
annotation), averaged over the cell's devices; the idle gaps are the rest
of the window in which no device of the cell was busy, each named by the
innermost host event running on the window's thread at its midpoint.
"""
from __future__ import annotations

import json
import tempfile
from collections import defaultdict
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
WINDOW = "fimbench.window"


def union(spans) -> list[tuple[float, float]]:
    """Merge (start, end) intervals."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def events_of(prof) -> list[dict]:
    """The profiler's Chrome-trace events (written to a temporary file and
    read back; the file is gone when this returns)."""
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "trace.json"
        prof.export_chrome_trace(str(path))
        with open(path) as f:
            tr = json.load(f)
    return tr["traceEvents"] if isinstance(tr, dict) else tr


def _host_name_at(host, mids):
    """For each midpoint (ascending), the innermost host event covering it,
    from ``host``: (start, end, name) of one thread, properly nested."""
    host = sorted(host, key=lambda e: (e[0], -e[1]))
    names, stack, i = [], [], 0
    for m in mids:
        while i < len(host) and host[i][0] <= m:
            while stack and stack[-1][1] < host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < m:
            stack.pop()
        names.append(stack[-1][2] if stack else "host, outside any event")
    return names


def reduce(events: list[dict], devices=(0,), top: int = 10) -> dict | None:
    """-> {busy_s (mean over ``devices``), window_s, device_ops, idle_gaps
    (each the ``top`` longest), op_s (every device operation's seconds)},
    or None when the trace holds no window annotation. Times in seconds."""
    win = [e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if not win:
        return None
    w = win[0]
    lo, hi = float(w["ts"]), float(w["ts"]) + float(w["dur"])
    dev = []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            on = (e.get("args") or {}).get("device", 0)
            a, b = max(float(e["ts"]), lo), min(float(e["ts"]) + float(e.get("dur", 0.0)), hi)
            if b > a and on in devices:
                dev.append((a, b, e["name"], on))
    busy_each = [sum(b - a for a, b in union([(a, b) for a, b, _, o in dev if o == d]))
                 for d in devices]
    busy = union([(a, b) for a, b, _, _ in dev])
    by_op: dict[str, float] = defaultdict(float)
    for a, b, name, _ in dev:
        by_op[name[:160]] += (b - a) / 1e6
    gaps, t = [], lo
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    host = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"][:160])
            for e in events
            if e.get("ph") == "X" and e.get("cat") in HOST_CATS and e.get("tid") == w.get("tid")
            and e.get("pid") == w.get("pid")]
    mids = sorted(((a + b) / 2, b - a) for a, b in gaps)
    by_host: dict[str, float] = defaultdict(float)
    for (m, length), name in zip(mids, _host_name_at(host, [m for m, _ in mids])):
        by_host[name] += length / 1e6
    rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]  # noqa: E731
    return {
        "busy_s": sum(busy_each) / len(devices) / 1e6,
        "window_s": (hi - lo) / 1e6,
        "device_ops": rank(by_op),
        "idle_gaps": rank(by_host),
        "op_s": dict(by_op),
    }
