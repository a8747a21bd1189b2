"""The wave loop's waits a request: the seconds of the program's
``mine.reduce`` spans, each a blocking read of one wave's supports."""
from fimbench import spans


def read(run):
    return spans.per_request_ms(run, ("mine.reduce",), "total_s")
