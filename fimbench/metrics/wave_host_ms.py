"""The wave loop's host time a request: the self seconds of the
program's ``mine.waves`` span and of its children ``mine.plan`` (candidate
generation and packing), ``mine.wave`` (index copy, launches, the pinned
read-back) and ``mine.emit`` (the itemsets of a settled wave). With
``wave_wait_ms`` it makes up the loop."""
from fimbench import spans

NAMES = ("mine.waves", "mine.plan", "mine.wave", "mine.emit")


def read(run):
    return spans.per_request_ms(run, NAMES, "self_s")
