"""A closed loop of one client: each request is sent when the last one has
come back, until ``seconds`` have passed."""
import time

from fimbench.loops import Request, digest, kernel_launches


def drive(call, rows, order, seconds: float, keep, trace: bool, sync, traffic):
    del traffic
    reqs, kept = [], {}
    t_open = time.perf_counter()
    while time.perf_counter() - t_open < seconds:
        min_sup = next(order)
        before = kernel_launches() if trace else None
        t0 = time.perf_counter()
        try:
            res = call(rows, min_sup)
        except Exception as exc:  # a request that fails is counted, not fatal
            sync()
            reqs.append(Request(min_sup, time.perf_counter() - t0, {}, None, None,
                                error=f"{type(exc).__name__}: {exc}"))
            continue
        lat = time.perf_counter() - t0
        launched = None
        if trace:
            after = kernel_launches()
            launched = {k: after[k] - before[k] for k in after}
        reqs.append(Request(min_sup, lat, dict(res.stage_times_s), launched, digest(res.itemsets)))
        if keep(len(kept), min_sup):
            kept[len(reqs) - 1] = tuple(res.itemsets.items())
    return reqs, kept, time.perf_counter() - t_open
