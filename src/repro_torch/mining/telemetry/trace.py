"""Per-request span trees with monotonic timestamps.

The recorder follows the ``repro.fault.failures`` attach/detach shape: a
module-global ``_active`` recorder that every instrumentation site reads
once. With nothing attached, ``span(...)`` returns a shared no-op
context manager — one global load and one function call, so the hot wave
loop pays nothing when tracing is off. Attach a ``TraceRecorder`` (the
CLI does this for ``--trace out.json``) and the same sites produce a
span tree per request:

    request                      (opened at submit, closed at resolve)
      admission.wait             (retroactive: submit -> batch start)
      group.classify
      group.prep
      group.serve
        mine.wave k=2            (device dispatch, per level)
        mine.reduce k=2          (host blocking collect + prune)
      resolve

Parenting is two-mode: explicit (``parent=`` span id, used across
threads — the service carries the request root's id on its ``_Pending``
record into the worker loop) and implicit (a thread-local stack, so
spans opened on one thread nest naturally: wave spans inside the
serving span). Timestamps are ``time.monotonic()`` seconds relative to
the recorder's epoch; exports are plain JSON (nested tree) and Chrome
trace-event format (``chrome://tracing`` / Perfetto loads it directly).
"""
from __future__ import annotations

import contextlib
import json
import threading
import time


class _NullSpan:
    """Reusable no-op context manager: the detached fast path."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()
_active: "TraceRecorder | None" = None
_tls = threading.local()


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


def span(name: str, *, parent: int | None = None, **args):
    """A context manager tracing one span under the attached recorder
    (no-op when detached). ``parent`` overrides the thread-local stack."""
    rec = _active
    if rec is None:
        return _NULL
    return rec.span(name, parent=parent, **args)


def current_span() -> int | None:
    """Id of the innermost open span on this thread (implicit parent)."""
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


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

    @contextlib.contextmanager
    def span(self, name: str, *, parent: int | None = None, **args):
        """Scoped span; nests under this thread's innermost open span
        unless ``parent`` is given explicitly."""
        if parent is None:
            parent = current_span()
        sid = self.open(name, parent=parent, **args)
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        stack.append(sid)
        try:
            yield sid
        finally:
            stack.pop()
            self.close(sid)

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

    def save_json(self, path: str) -> int:
        roots = self.to_json()
        with open(path, "w") as f:
            json.dump(roots, f, indent=1)
            f.write("\n")
        return len(roots)
