"""Segment -> worker placement: byte-balanced greedy bin-packing.

The coordinator calls ``choose_worker`` per append (place the new segment
on the least-loaded live worker) and ``replan`` on topology change (a
worker died: redistribute its segments over the survivors, best-fit
decreasing, so the heaviest orphan lands on the emptiest node first).
Pure host arithmetic — no sockets, no device state — so the policy is
unit-testable in isolation.
"""
from __future__ import annotations


def choose_worker(loads: dict[int, int]) -> int:
    """Worker id with the fewest placed bytes (ties: lowest id —
    deterministic placement makes failures replayable)."""
    if not loads:
        raise ValueError("no live workers to place on")
    return min(loads, key=lambda w: (loads[w], w))


def replan(lost: list[tuple[int, int]], loads: dict[int, int]) -> dict[int, int]:
    """Re-home orphaned segments: ``lost`` is ``[(seg_id, nbytes), ...]``,
    ``loads`` the survivors' current placed bytes. Best-fit decreasing:
    heaviest segment first, each onto the currently lightest survivor.
    Returns ``{seg_id: worker_id}``; ``loads`` is updated in place so
    successive calls compose."""
    if not loads:
        raise ValueError("no live workers to replan onto")
    plan: dict[int, int] = {}
    for seg_id, nbytes in sorted(lost, key=lambda t: (-t[1], t[0])):
        w = choose_worker(loads)
        plan[seg_id] = w
        loads[w] += int(nbytes)
    return plan
