"""The stream's host bookkeeping a request: the self seconds of the
program's spans ``stream.fold`` (histogram, admission, the F2 fold),
``stream.expire`` (a segment's histogram and F2 matrix subtracted) and
``stream.readmit`` (a segment prepared again, less its prep)."""
from fimbench import spans

NAMES = ("stream.fold", "stream.expire", "stream.readmit")


def read(run):
    return spans.per_request_ms(run, NAMES, "self_s")
