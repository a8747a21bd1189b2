"""The F2 scan a request (the program's ``prep.f2`` span: the B4
co-occurrence kernel, its read to the host and the upper triangle),
timed on the device by events."""
from fimbench import spans


def read(run):
    return spans.per_request_ms(run, ("prep.f2",), "device_s")
