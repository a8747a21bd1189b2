"""Job 1 a request (the program's ``prep.job1`` span: the B3 histogram,
its read to the host and the F-list), timed on the device by events."""
from fimbench import spans


def read(run):
    return spans.per_request_ms(run, ("prep.job1",), "device_s")
