"""Per-request span trees, and the same spans in any ``torch.profiler``
trace of the port.

One call, ``span(name, **args)``, feeds up to three sinks:

- an attached ``TraceRecorder`` (the CLI attaches one for ``--trace
  out.json``), which builds a span tree per request with
  ``time.monotonic()`` timestamps;
- while ``torch.profiler`` records on the calling thread (torch keeps
  that state per thread), a profiler range of the same name, so the span
  lands in the profiler's trace on its thread and on the device trace's
  clock;
- while the profiler records, a process-wide table by span name
  (``profiled()``, cleared by ``reset_profiled()``): the count, the
  seconds, the self seconds (the seconds less those of the span's direct
  children on the same thread) and, for a span opened with ``device=``,
  its device seconds. ``count(name, n)`` adds counters to the same table.

With no recorder attached and the profiler not recording, ``span(...)``
returns a shared no-op context manager after one global load and one
cheap C call, so the hot wave loop pays next to nothing when tracing is
off. The recorder follows the ``repro.fault.failures`` attach/detach
shape: a module-global ``_active`` recorder that every site reads once.
The spans of a request:

    request                      (opened at submit, closed at resolve)
      admission.wait             (retroactive: submit -> batch start)
      group.classify
      group.prep
        prep                     (HPrepostMiner.prepare; the children
          prep.h2d               are timed on the device by events)
          prep.job1
          prep.job2
          prep.pack
          prep.f2
      group.serve
        frontend.mine
          mine.planes            (planar copy of the N-lists)
          mine.waves             (the wave loop, stage "mining_waves")
            mine.plan            (host candidate generation and packing)
            mine.wave k=2        (device dispatch, per level)
            mine.reduce k=2      (host blocking read of a wave's supports)
            mine.emit            (itemsets from the settled wave)
          frontend.finish
      resolve

A ``MiningEngine.submit`` opens ``engine.submit`` with
``engine.fingerprint`` and ``engine.cache`` inside, then ``prep`` on a
miss and ``frontend.mine``. A stream query runs the same wave loop:

    stream.query                 (StreamingMiner.mine)
      mine.waves                 (mine.plan, mine.wave segments=S,
                                  mine.reduce, mine.emit as above)
      frontend.finish

Parenting is two-mode: explicit (``parent=`` span id, used across
threads — the service carries the request root's id on its ``_Pending``
record into the worker loop) and implicit (a thread-local stack, so
spans opened on one thread nest naturally: wave spans inside the
serving span). The recorder's exports are a plain JSON tree and Chrome
trace-event format (``chrome://tracing`` / Perfetto loads it directly).
"""
from __future__ import annotations

import contextlib
import json
import threading
import time

import torch

# the profiler's per-thread "recording" flag, and its cheapest range
_profiling = torch._C._autograd._profiler_enabled
_Range = torch._C._profiler._RecordFunctionFast


class _NullSpan:
    """Reusable no-op context manager: the fast path with no sink active."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()
_active: "TraceRecorder | None" = None
_tls = threading.local()
# span or counter name -> its row; filled only while the profiler records
_table: dict[str, dict] = {}
_table_lock = threading.Lock()


def active() -> "TraceRecorder | None":
    """The currently attached recorder, or None."""
    return _active


def attach(rec: "TraceRecorder | None") -> "TraceRecorder | None":
    """Install ``rec`` as the global recorder; returns the previous one."""
    global _active
    prev, _active = _active, rec
    return prev


@contextlib.contextmanager
def attached(rec: "TraceRecorder"):
    """Scoped attach — the CLI/test shape: ``with attached(rec): ...``."""
    prev = attach(rec)
    try:
        yield rec
    finally:
        attach(prev)


def span(name: str, *, parent: int | None = None, device: torch.device | None = None, **args):
    """A context manager tracing one span into every active sink (a no-op
    when none is). ``parent`` overrides the thread-local stack of the
    attached recorder. ``device``: while profiling, the span also records
    a timing event at its start and end on that device's current stream
    (on the CPU its device seconds are its host seconds); the table gets
    the elapsed time at the next ``settle_device_times()``."""
    rec, prof = _active, _profiling()
    if rec is None and not prof:
        return _NULL
    return _Span(rec, name, parent, args, device, prof)


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name`` in the table while the profiler
    records on this thread: its row holds the calls (``count``) and the
    sum (``total``)."""
    if _profiling():
        with _table_lock:
            row = _table.get(name)
            if row is None:
                row = _table[name] = {"count": 0, "total": 0}
            row["count"] += 1
            row["total"] += n


def settle_device_times() -> None:
    """Read the elapsed time of every device-timed span this thread closed
    since the last call into the table, waiting for each span's end event
    (the caller calls this where the stream has already been waited for).
    Nothing is pending unless the profiler was recording."""
    pending = getattr(_tls, "pending", None)
    while pending:
        name, ev0, ev1 = pending.pop(0)
        ev1.synchronize()
        _add(name, 0, 0.0, 0.0, ev0.elapsed_time(ev1) / 1e3)


def profiled() -> dict[str, dict]:
    """A copy of the table: span name -> ``{count, total_s, self_s,
    device_s}``, counter name -> ``{count, total}``."""
    with _table_lock:
        return {k: dict(v) for k, v in _table.items()}


def reset_profiled() -> None:
    """Empty the table."""
    with _table_lock:
        _table.clear()


def current_span() -> int | None:
    """Id of the innermost open span on this thread (implicit parent)."""
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


def _local(attr: str) -> list:
    """This thread's list ``attr`` of ``_tls``, made on first use."""
    out = getattr(_tls, attr, None)
    if out is None:
        out = []
        setattr(_tls, attr, out)
    return out


def _add(name: str, calls: int, total_s: float, self_s: float, device_s: float) -> None:
    with _table_lock:
        row = _table.get(name)
        if row is None:
            row = _table[name] = {"count": 0, "total_s": 0.0, "self_s": 0.0, "device_s": 0.0}
        row["count"] += calls
        row["total_s"] += total_s
        row["self_s"] += self_s
        row["device_s"] += device_s


def _event(device: torch.device) -> torch.cuda.Event:
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


class _Span:
    """One span in the sinks it was opened under: the recorder ``rec``
    (None when detached) and, with ``prof``, the profiler's range and the
    table."""

    __slots__ = ("rec", "name", "parent", "args", "device", "prof", "sid", "range", "t0",
                 "child_s", "ev0")

    def __init__(self, rec, name, parent, args, device=None, prof=False):
        self.rec, self.name, self.parent, self.args = rec, name, parent, args
        self.device, self.prof = device, prof
        self.sid = self.ev0 = None
        self.child_s = 0.0

    def __enter__(self):
        if self.rec is not None:
            parent = current_span() if self.parent is None else self.parent
            self.sid = self.rec.open(self.name, parent=parent, **self.args)
            _local("stack").append(self.sid)
        if self.prof:
            self.range = _Range(self.name)
            self.range.__enter__()
            _local("frames").append(self)
            if self.device is not None and self.device.type == "cuda":
                self.ev0 = _event(self.device)
            self.t0 = time.perf_counter()
        return self.sid

    def __exit__(self, *exc):
        if self.prof:
            dur = time.perf_counter() - self.t0
            frames = _local("frames")
            frames.pop()
            if frames:
                frames[-1].child_s += dur
            if self.ev0 is not None:
                _local("pending").append((self.name, self.ev0, _event(self.device)))
            _add(self.name, 1, dur, dur - self.child_s,
                 dur if self.device is not None and self.ev0 is None else 0.0)
            self.range.__exit__(None, None, None)
        if self.rec is not None:
            _local("stack").pop()
            self.rec.close(self.sid)
        return False


class TraceRecorder:
    """Collects spans; thread-safe; exports JSON trees + Chrome events."""

    def __init__(self):
        self._lock = threading.Lock()
        self._next_id = 0
        self.epoch = time.monotonic()
        # id -> {"name", "t0", "t1", "parent", "tid", "args"}; t1 None while open
        self.spans: dict[int, dict] = {}

    # ------------------------------------------------------ span plumbing
    def open(self, name: str, *, t0: float | None = None,
             parent: int | None = None, **args) -> int:
        """Open a span at ``t0`` (now when omitted); returns its id."""
        t0 = time.monotonic() if t0 is None else t0
        with self._lock:
            sid = self._next_id
            self._next_id += 1
            self.spans[sid] = {
                "name": name,
                "t0": t0,
                "t1": None,
                "parent": parent,
                "tid": threading.get_ident(),
                "args": dict(args) if args else {},
            }
        return sid

    def close(self, sid: int, *, t1: float | None = None, **args) -> None:
        t1 = time.monotonic() if t1 is None else t1
        with self._lock:
            s = self.spans.get(sid)
            if s is not None and s["t1"] is None:
                s["t1"] = t1
                if args:
                    s["args"].update(args)

    def add(self, name: str, t0: float, t1: float, *,
            parent: int | None = None, **args) -> int:
        """Record a retroactive span from explicit monotonic timestamps
        (e.g. admission wait: submit time -> batch start time)."""
        sid = self.open(name, t0=t0, parent=parent, **args)
        self.close(sid, t1=max(t1, t0))
        return sid

    def __len__(self) -> int:
        with self._lock:
            return len(self.spans)

    # ----------------------------------------------------------- exports
    def _closed(self) -> list[tuple[int, dict]]:
        """Snapshot of spans, open ones closed at 'now' for export."""
        now = time.monotonic()
        with self._lock:
            out = []
            for sid, s in sorted(self.spans.items()):
                s = dict(s)
                if s["t1"] is None:
                    s["t1"] = now
                    s["args"] = {**s["args"], "open": True}
                out.append((sid, s))
        return out

    def to_json(self) -> list[dict]:
        """Nested span trees (list of roots), times relative to epoch."""
        spans = self._closed()
        nodes = {
            sid: {
                "id": sid,
                "name": s["name"],
                "t_start_s": s["t0"] - self.epoch,
                "dur_s": s["t1"] - s["t0"],
                "args": s["args"],
                "children": [],
            }
            for sid, s in spans
        }
        roots = []
        for sid, s in spans:
            p = s["parent"]
            if p is not None and p in nodes:
                nodes[p]["children"].append(nodes[sid])
            else:
                roots.append(nodes[sid])
        return roots

    def to_chrome(self) -> list[dict]:
        """Chrome trace-event list (``ph: "X"`` complete events, us)."""
        events = []
        for sid, s in self._closed():
            ev = {
                "name": s["name"],
                "ph": "X",
                "ts": (s["t0"] - self.epoch) * 1e6,
                "dur": (s["t1"] - s["t0"]) * 1e6,
                "pid": 0,
                "tid": s["tid"],
                "cat": "mining",
                "args": {**s["args"], "span_id": sid},
            }
            if s["parent"] is not None:
                ev["args"]["parent_id"] = s["parent"]
            events.append(ev)
        return events

    def save_chrome(self, path: str) -> int:
        """Write the Chrome trace-event JSON array; returns event count."""
        events = self.to_chrome()
        with open(path, "w") as f:
            json.dump(events, f, indent=1)
            f.write("\n")
        return len(events)
