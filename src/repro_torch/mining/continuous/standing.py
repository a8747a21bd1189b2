"""Standing queries: registered once, answered after every mutation.

``StandingRegistry`` rides inside a ``StreamingMiner`` or
``DistributedMiner`` (duck-typed ``owner``: ``mine(spec, _seed=)``,
``stats`` dict, ``stream_spec``, ``rows_appended`` monotone counter).
After every append/expiry the owner calls ``refresh_all`` — under its
operation lock, so diffs observe exactly the arrival-order stream state —
and each registered query is re-mined incrementally and handed a
``MineDiff`` against its previously delivered answer.

Incrementality is two-fold. Prep is already incremental (segments are
append-time artifacts; a refresh never re-prepares anything). Planning
reuses the previous answer's *settled waves* as a seed: each refresh
records the exact reduced support of every candidate it examined —
frequent or not — and the registry keeps them as per-itemset upper
bounds, inflated by the rows appended since they were recorded (a new
row raises any support by at most 1; expiry only lowers it). On the
next refresh, a candidate whose bound misses the threshold is provably
infrequent and never dispatches — and anti-monotonicity kills its whole
subtree with it (``mine_prepared_segments(seed=...)``). The near-frontier
corpses of wave ``l`` are exactly the candidates a naive re-mine would
re-intersect every append; once examined, they stay pruned until enough
rows arrive to possibly revive them, at which point they are re-examined
and their bound refreshed. The bound only kills provably-infrequent
candidates, so every refresh stays bit-identical to an unseeded mine; it
applies only on the exact integer path (decayed streams re-mine
unseeded).

Pattern post-passes (closed/maximal/top_rank_k) ride ``MineSpec.patterns``
unchanged: the refresh mines with ``patterns="all"`` (the full answer is
what the next seed needs — filtered views are not anti-monotone), then
applies the post-pass to the *delivered* view the diffs are built over.

Replaying a query's diff stream from empty (``replay_diffs``)
reconstructs its latest delivered answer exactly — the invariant the
property tests check.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future

from repro_torch.fault import failures
from repro_torch.mining.spec import MineSpec


@dataclasses.dataclass(frozen=True)
class MineDiff:
    """One incremental answer: what changed vs the previous delivery."""

    seq: int  # 0-based delivery number for this query
    cause: str  # "register" | "append" | "expire"
    entered: dict  # itemset -> support, newly frequent
    left: dict  # itemset -> last delivered support, no longer frequent
    changed: dict  # itemset -> (old_support, new_support), still frequent
    n_rows: int  # stream rows the answer covers
    min_count: object  # resolved threshold (int; float when decayed)
    total: int  # size of the delivered frequent set after this diff
    latency_s: float  # register/refresh wall time for this delivery


def apply_diff(acc: dict, diff: MineDiff) -> dict:
    """Fold one diff into an accumulated answer dict, in place."""
    for t in diff.left:
        acc.pop(t, None)
    acc.update(diff.entered)
    for t, (_, new) in diff.changed.items():
        acc[t] = new
    return acc


def replay_diffs(diffs) -> dict:
    """The answer a subscriber reconstructs from a diff stream alone."""
    acc: dict = {}
    for d in diffs:
        apply_diff(acc, d)
    return acc


class StandingQuery:
    """One registered continuous query. ``latest`` is the last delivered
    answer (post pattern-pass), ``diffs`` the full delivery history, and
    ``next_diff()`` a Future resolving with the next delivery — the
    ``MiningService`` hands these out so subscribers block on arrival
    order, not on polling."""

    def __init__(self, qid: int, spec: MineSpec):
        self.qid = qid
        self.spec = spec
        self.seq = 0
        self.latest: dict | None = None
        self.diffs: list[MineDiff] = []
        self.active = True
        # seed state: per-itemset support upper bounds from previously
        # settled waves, and the owner's rows_appended mark they are
        # current at (refreshes inflate them by the rows since)
        self._bound: dict | None = None
        self._rows_mark = 0
        self._waiters: list[Future] = []
        self._wlock = threading.Lock()

    def next_diff(self) -> Future:
        """A Future resolving with this query's next delivered diff."""
        f: Future = Future()
        with self._wlock:
            self._waiters.append(f)
        return f

    def _deliver(self, d: MineDiff) -> None:
        self.diffs.append(d)
        with self._wlock:
            waiters, self._waiters = self._waiters, []
        for f in waiters:
            if not f.cancelled():
                f.set_result(d)


class StandingRegistry:
    """The owner-embedded registry: register/cancel plus the per-mutation
    refresh fan-out. All methods run under the owner's operation lock."""

    def __init__(self, owner):
        self.owner = owner
        self.queries: dict[int, StandingQuery] = {}
        self._next = 0

    def __len__(self) -> int:
        return len(self.queries)

    def register(self, spec: MineSpec) -> StandingQuery:
        """Register a continuous query and deliver its initial answer
        (``cause="register"`` — ``entered`` is the whole frequent set, so
        a replay from empty starts correct). A spec the owner cannot
        serve raises here and registers nothing."""
        q = StandingQuery(self._next, spec)
        self._refresh(q, "register")  # raises before registration on bad spec
        self._next += 1
        self.queries[q.qid] = q
        self.owner.stats["standing_queries"] = len(self.queries)
        return q

    def cancel(self, q: StandingQuery) -> None:
        q.active = False
        self.queries.pop(q.qid, None)
        self.owner.stats["standing_queries"] = len(self.queries)

    def refresh_all(self, cause: str) -> int:
        """Re-answer every registered query after one mutation; returns
        how many diffs were delivered. A refresh failure (chaos, device)
        is accounted and skipped — the query's delivered state is
        untouched, so its diff chain stays consistent, and the next
        mutation's refresh catches it up."""
        delivered = 0
        for q in list(self.queries.values()):
            try:
                self._refresh(q, cause)
                delivered += 1
            except Exception:
                self.owner.stats["diff_errors"] += 1
        return delivered

    def _refresh(self, q: StandingQuery, cause: str) -> None:
        from repro_torch.mining.miners import _select_patterns

        failures.fire("stream.diff")
        t0 = time.perf_counter()
        owner = self.owner
        spec_full = (
            q.spec if q.spec.patterns == "all" else q.spec.with_(patterns="all")
        )
        seed = None
        exact = owner.stream_spec.decay == 1.0
        if q._bound is not None and exact:
            added = owner.rows_appended - q._rows_mark
            # inflate every recorded bound by the rows appended since it
            # was settled — still a true upper bound (expiry only shrinks)
            seed = {t: s + added for t, s in q._bound.items()}
        seed_out: dict = {}
        res = owner.mine(spec_full, _seed=seed, _seed_out=seed_out if exact else None)
        if exact:
            # carry inflated bounds forward, overwritten wherever this
            # refresh settled an exact support again
            bound = seed if seed is not None else {}
            bound.update(seed_out)
            q._bound = bound
            q._rows_mark = owner.rows_appended
        delivered = (
            res.itemsets if q.spec.patterns == "all"
            else _select_patterns(res.itemsets, q.spec)
        )
        old = q.latest if q.latest is not None else {}
        entered = {t: s for t, s in delivered.items() if t not in old}
        left = {t: s for t, s in old.items() if t not in delivered}
        changed = {
            t: (old[t], s) for t, s in delivered.items()
            if t in old and old[t] != s
        }
        lat = time.perf_counter() - t0
        d = MineDiff(
            seq=q.seq, cause=cause, entered=entered, left=left, changed=changed,
            n_rows=res.n_rows, min_count=res.min_count, total=len(delivered),
            latency_s=lat,
        )
        q.seq += 1
        q.latest = dict(delivered)
        st = owner.stats
        st["diffs_delivered"] += 1
        st["diff_latency_s_total"] += lat
        st["last_diff_latency_s"] = lat
        # distribution view of the same latency (the totals above stay for
        # compatibility): per-stream refresh latency histogram
        engine = getattr(owner, "engine", None)
        if engine is not None:
            engine.telemetry.histogram(
                f"stream.{getattr(owner, 'name', 'default')}.diff_s"
            ).record(lat)
        st["seed_pruned_candidates"] += int(
            res.stage_times_s.get("host_pruned_seed", 0)
        )
        q._deliver(d)
