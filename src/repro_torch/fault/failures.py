"""Fault tolerance: failure injection, restart policy, straggler monitor.

On a real cluster the runtime signals (preemption notice, ICI link error,
host heartbeat loss) arrive from the platform; here they are modeled so the
*recovery logic* — which is what this framework owns — is real and tested:

  - ``FailureInjector``: deterministic or probabilistic step failures
    (raises ``SimulatedFailure`` mid-loop) — the training-loop shape.
  - ``ChaosInjector``: the same idea generalized from *steps* to *named
    failure points* threaded through the mining stack (service enqueue,
    prep, wave launch, RPC send/recv, snapshot read, and the continuous
    lane: ``stream.expire`` fires before a sliding-window expiry pass —
    a hit skips the pass, the window self-heals next append — and
    ``stream.diff`` fires before each standing-query refresh — a hit
    leaves that query's delivered state untouched so its diff chain
    stays replayable — and ``telemetry.emit`` fires before each periodic
    stats snapshot (``repro.mining.telemetry.StatsEmitter``) — a hit
    drops that emit line, counted in the emitter's ``dropped`` stat,
    and must never block or fail a request Future). Production code
    calls ``fire(point)`` — a no-op until a test/soak ``install``s an
    injector — and the injector decides, deterministically (nth hit) or
    probabilistically (seeded), whether that hit dies and with what
    exception type. This is how the chaos harness proves the service
    invariant: every accepted Future resolves, whatever we break.
  - ``run_with_restarts``: supervisor that restarts the training loop from
    the latest checkpoint, with bounded retries — the Hadoop-style task
    re-execution the paper gets from MapReduce, at trainer granularity.
  - ``StragglerMonitor``: per-step wall-time EWMA; steps slower than
    ``threshold ×`` the EWMA are flagged, and the data loader can be told
    to skip/redistribute the slow shard (mitigation hook).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import random
import threading
from typing import Callable


class SimulatedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class FailureInjector:
    fail_at_steps: tuple = ()  # deterministic failures (once each)
    fail_prob: float = 0.0  # plus i.i.d. failures
    seed: int = 0

    def __post_init__(self):
        self._fired: set[int] = set()
        self._rng = random.Random(self.seed)

    def maybe_fail(self, step: int):
        if step in self.fail_at_steps and step not in self._fired:
            self._fired.add(step)
            raise SimulatedFailure(f"injected failure at step {step}")
        if self.fail_prob and self._rng.random() < self.fail_prob:
            raise SimulatedFailure(f"random failure at step {step}")


# --------------------------------------------------------- chaos (mining)
@dataclasses.dataclass
class _PointPlan:
    """Firing plan for one named point: skip ``after`` hits, then fail the
    next ``times`` matching hits; plus i.i.d. failures at ``prob``."""

    exc: Callable[[str], BaseException]
    after: int = 0
    times: int = 1
    prob: float = 0.0


class ChaosInjector:
    """Named failure points for the mining stack (service / RPC / store).

    ``arm("service.prep", after=1)`` kills the second prep; ``arm("rpc.recv",
    prob=0.05, times=10**9, exc=TimeoutError)`` makes 5% of coordinator
    receives time out. ``fire(point)`` is what the instrumented code calls;
    deterministic countdowns and the seeded RNG make a chaos run (and its
    failure schedule) exactly reproducible. Counters: ``seen`` every hit,
    ``fired`` the hits that actually raised.
    """

    def __init__(self, seed: int = 0):
        self._plans: dict[str, _PointPlan] = {}
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self.seen: collections.Counter = collections.Counter()
        self.fired: collections.Counter = collections.Counter()

    def arm(self, point: str, *, after: int = 0, times: int = 1,
            prob: float = 0.0, exc: Callable[[str], BaseException] = SimulatedFailure):
        self._plans[point] = _PointPlan(exc=exc, after=after, times=times, prob=prob)
        return self

    def disarm(self, point: str) -> None:
        self._plans.pop(point, None)

    def fire(self, point: str) -> None:
        with self._lock:
            self.seen[point] += 1
            plan = self._plans.get(point)
            if plan is None:
                return
            hit = False
            if plan.after > 0:
                plan.after -= 1
            elif plan.times > 0:
                plan.times -= 1
                hit = True
            if not hit and plan.prob and self._rng.random() < plan.prob:
                hit = True
            if not hit:
                return
            self.fired[point] += 1
            n = self.seen[point]
        raise plan.exc(f"chaos: injected failure at {point} (hit #{n})")


_active: ChaosInjector | None = None


def fire(point: str) -> None:
    """Production-side hook: raise iff an installed injector says so.

    The cost when chaos is off is one module-global read — cheap enough to
    sit on hot paths (wave launches, RPC frames)."""
    inj = _active
    if inj is not None:
        inj.fire(point)


@contextlib.contextmanager
def installed(inj: ChaosInjector):
    """Install ``inj`` as the process's active injector for the block.

    Process-global on purpose: the points worth breaking live on service
    worker threads, scheduler pools, and coordinator RPC paths that the
    test cannot reach by argument-passing."""
    global _active
    prev = _active
    _active = inj
    try:
        yield inj
    finally:
        _active = prev


class StragglerMonitor:
    def __init__(self, threshold: float = 3.0, ewma: float = 0.9):
        self.threshold = threshold
        self.ewma_coef = ewma
        self.mean: float | None = None
        self.flagged: list[int] = []

    def record(self, step: int, dt: float) -> bool:
        """Returns True if this step is a straggler."""
        if self.mean is None:
            self.mean = dt
            return False
        is_straggler = dt > self.threshold * self.mean
        if is_straggler:
            self.flagged.append(step)
        else:  # stragglers don't contaminate the baseline
            self.mean = self.ewma_coef * self.mean + (1 - self.ewma_coef) * dt
        return is_straggler


def run_with_restarts(
    run: Callable[[int], int],
    latest_step: Callable[[], int | None],
    max_restarts: int = 5,
) -> int:
    """Supervisor: call ``run(start_step)``; on failure, resume from the
    latest checkpoint. Returns the final step reached."""
    restarts = 0
    while True:
        start = (latest_step() or -1) + 1
        try:
            return run(start)
        except SimulatedFailure:
            restarts += 1
            if restarts > max_restarts:
                raise
