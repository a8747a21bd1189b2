"""A stream append a request: the seconds of the program's
``stream.append`` spans (the histogram, expiry, admission, the new
segment's prep and the fold of its F2 matrix)."""
from fimbench import spans


def read(run):
    return spans.per_request_ms(run, ("stream.append",), "total_s")
