"""One reader a metric: ``fimbench/metrics/<name>.py`` defines
``read(run) -> float | None`` over a ``harness.Run``; None leaves the
metric out of the result line."""


def stage_mean(run, of_stages, with_latency: bool = False):
    """Mean over the answered requests of ``of_stages(stage_times_s)`` (plus
    the request's latency, with ``with_latency``), in ms."""
    vals = [of_stages(r.stages) + (r.latency_s if with_latency else 0.0)
            for r in run.requests if r.error is None]
    if not vals:
        return None
    return 1e3 * sum(vals) / len(vals)
