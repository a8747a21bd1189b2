"""Requests answered correctly, over the whole window (host clock)."""


def read(run):
    return sum(r.correct for r in run.requests) / run.window_s
