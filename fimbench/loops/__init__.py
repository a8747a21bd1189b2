"""The ways of sending a traffic mix's requests, one module each, found by
the mix's ``loop`` name: ``fimbench/loops/<loop>.py`` defines

    drive(call, rows, order, seconds, keep, trace, sync, traffic)
        -> (requests, kept answers {request index: itemsets}, window seconds)

``call(rows, min_sup)`` is the entry, ``order`` an endless iterator of
min_sup values, ``keep(n_kept, min_sup)`` says whether to keep an answer
whole (kept as the tuple of its items, which the garbage collector stops
scanning once it has seen it), ``trace`` whether to read the kernel launch counters around each
call, ``sync`` waits for the devices, ``traffic`` is the mix's file's
object. Every request sent in the window is
a ``Request``; the window closes when the last one has come back."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Request:
    min_sup: float
    latency_s: float
    stages: dict
    launches: dict | None  # kernel launches during the call (traced runs)
    digest: tuple | None  # the answer's ``digest``; None if it raised
    error: str | None = None
    correct: bool = False


def digest(itemsets: dict) -> tuple[int, int]:
    """An order-free digest of an answer: its size and the sum of its
    (itemset, support) pairs' hashes. It keeps no pair alive, so it adds
    nothing for the garbage collector to scan."""
    return len(itemsets), sum(map(hash, itemsets.items())) & (2**64 - 1)


def kernel_launches() -> dict:
    """The program's kernel launch counters, by kernel."""
    from repro_torch import kernels

    return kernels.launches()
