"""The rows' copy to the device a request (the program's ``prep.h2d``
span), timed on the device by events on the reduce position's stream."""
from fimbench import spans


def read(run):
    return spans.per_request_ms(run, ("prep.h2d",), "device_s")
