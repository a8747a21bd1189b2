"""Job 2 and the N-list pack a request (the program's ``prep.job2`` and
``prep.pack`` spans: rank encoding, the PPC-tree, the longest N-list and
the pack), timed on the device by events."""
from fimbench import spans


def read(run):
    return spans.per_request_ms(run, ("prep.job2", "prep.pack"), "device_s")
