"""The program's own spans and counters over the traced window, for the
metric readers: the table that ``repro_torch.mining.telemetry.trace``
fills while ``torch.profiler`` records, which in a traced run is the
window alone (the profiler starts just before it and stops just after).
A program without that table gives an empty one, so its readers report
nothing."""


def table() -> dict:
    """Span name -> ``{count, total_s, self_s, device_s}``, counter name ->
    ``{count, total}``; empty where the program keeps no such table."""
    from repro_torch.mining.telemetry import trace

    profiled = getattr(trace, "profiled", None)
    return profiled() if profiled is not None else {}


def per_request_ms(run, names, key: str) -> float | None:
    """Σ of ``key`` (seconds) over the spans ``names``, a request of the
    window, in ms; None where the table holds none of them."""
    tab = table()
    found = [tab[n][key] for n in names if n in tab]
    if not found or not run.requests:
        return None
    return 1e3 * sum(found) / len(run.requests)
