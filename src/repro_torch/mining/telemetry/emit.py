"""Background periodic stats emitter: registry snapshots to JSON-lines.

``StatsEmitter`` snapshots a callable (typically ``MiningService.stats``
or ``Registry.snapshot``) every ``interval_s`` on a daemon thread and
appends one JSON line per tick to a sink (a path, ``"-"`` for stderr, or
any file-like with ``write``). Each line is an envelope::

    {"schema": 1, "seq": 3, "reason": "interval",
     "uptime_s": 0.61, "wall_time": 1754650000.1, "stats": {...}}

``schema`` is ``hist.SCHEMA_VERSION`` — consumers key parsing off it.

Failure containment is the whole point of the design: the emitter sits
*beside* the request path, never in it. Every tick first fires the
``telemetry.emit`` chaos point (``repro_torch.fault.failures``) and then runs
the snapshot + write inside a try — an injected fault or a sink I/O
error increments ``stats["dropped"]`` / ``stats["errors"]`` and the loop
keeps ticking; nothing ever propagates to a request Future (the chaos
soak asserts exactly this). ``stop()`` emits one final snapshot
(``reason: "final"``) so short runs still land a complete record.
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time

from repro_torch.fault import failures

from .hist import SCHEMA_VERSION


class StatsEmitter:
    """Periodic JSON-lines snapshots of ``snapshot_fn()`` to ``sink``."""

    def __init__(self, snapshot_fn, sink, interval_s: float = 1.0):
        if interval_s <= 0:
            raise ValueError("interval_s must be > 0")
        self._snapshot_fn = snapshot_fn
        self.interval_s = float(interval_s)
        self._own_file = None
        if sink == "-":
            self._sink = sys.stderr
        elif isinstance(sink, (str, os.PathLike)):
            d = os.path.dirname(os.fspath(sink))
            if d:
                os.makedirs(d, exist_ok=True)
            self._own_file = open(sink, "a")
            self._sink = self._own_file
        else:
            self._sink = sink
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()  # serializes emit_once vs stop
        self._t0 = time.monotonic()
        self.stats = {
            "emits": 0,       # lines successfully written (any reason)
            "periodic": 0,    # successful interval ticks
            "dropped": 0,     # chaos-dropped ticks (telemetry.emit fired)
            "errors": 0,      # snapshot/serialize/write failures
        }

    # ---------------------------------------------------------- lifecycle
    def start(self) -> "StatsEmitter":
        if self._thread is not None:
            return self
        self._t0 = time.monotonic()
        self._thread = threading.Thread(
            target=self._loop, name="stats-emitter", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, *, final: bool = True) -> None:
        """Stop the loop; emit one last snapshot unless ``final=False``."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None
        if final:
            self.emit_once(reason="final")
        if self._own_file is not None:
            try:
                self._own_file.close()
            except OSError:
                pass
            self._own_file = None

    def __enter__(self) -> "StatsEmitter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # --------------------------------------------------------------- emit
    def emit_once(self, *, reason: str = "interval") -> bool:
        """One snapshot+write attempt. Never raises: chaos drops and sink
        errors are counted and swallowed — a lost emit is a lost line,
        not a failed request."""
        with self._lock:
            try:
                failures.fire("telemetry.emit")
            except Exception:
                self.stats["dropped"] += 1
                return False
            try:
                snap = self._snapshot_fn()
                line = json.dumps(
                    {
                        "schema": SCHEMA_VERSION,
                        "seq": self.stats["emits"],
                        "reason": reason,
                        "uptime_s": round(time.monotonic() - self._t0, 6),
                        "wall_time": time.time(),
                        "stats": snap,
                    },
                    default=str,
                )
                if self._own_file is not None and self._own_file.closed:
                    raise OSError("emitter sink closed")
                self._sink.write(line + "\n")
                flush = getattr(self._sink, "flush", None)
                if flush is not None:
                    flush()
            except Exception:
                self.stats["errors"] += 1
                return False
            self.stats["emits"] += 1
            if reason == "interval":
                self.stats["periodic"] += 1
            return True

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.emit_once(reason="interval")
