"""The front door's own host time a request: the self seconds (less
their child spans) of the program's spans ``engine.submit``,
``engine.fingerprint``, ``engine.cache``, ``frontend.mine``, ``frontend.finish``
and ``mine.planes`` over the traced window. Prep and the wave loop are
their own spans, so they are not counted here."""
from fimbench import spans

NAMES = ("engine.submit", "engine.fingerprint", "engine.cache", "frontend.mine",
         "frontend.finish", "mine.planes")


def read(run):
    return spans.per_request_ms(run, NAMES, "self_s")
