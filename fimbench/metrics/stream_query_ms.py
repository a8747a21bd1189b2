"""A stream query a request: the seconds of the program's
``stream.query`` spans (segments prepared again, the planning tables, the
cross-segment waves and the answer)."""
from fimbench import spans


def read(run):
    return spans.per_request_ms(run, ("stream.query",), "total_s")
