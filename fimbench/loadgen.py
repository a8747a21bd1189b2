"""The one general traffic generator.

A traffic mix is a data file, ``fimbench/traffic/<mix>.json``:

- ``entry``: the door of the program the requests go through, a module of
  ``fimbench/entries/`` (``oneshot``: a fresh one-shot mine a request;
  ``resident``: one engine that prepares the database once in set-up, at
  the configuration's threshold, and serves every request from it);
- ``loop``: how the requests are sent, a module of ``fimbench/loops/``
  (``closed``: one client, each request when the last has come back);
- ``threshold_scale``: the thresholds of the requests, as multiples of the
  configuration's ``min_sup``. The requests cycle through them, each cycle
  in an order drawn from the seed, so that every seed sends the same set
  of thresholds;
- ``warmup_rounds``: how many times set-up sends each threshold before the
  window opens.
"""
from __future__ import annotations

import importlib
from fractions import Fraction

import numpy as np


def thresholds(config: dict, traffic: dict) -> list[float]:
    """The mix's distinct min_sup values, as exact decimal products."""
    base = Fraction(str(config["min_sup"]))
    return [float(base * Fraction(str(s))) for s in traffic["threshold_scale"]]


def request_order(config: dict, traffic: dict, seed: int):
    """Endless min_sup values: cycles over ``thresholds``, each cycle in an
    order drawn from ``seed``."""
    values = thresholds(config, traffic)
    rng = np.random.default_rng([seed % 2**63, 0x7EAF])
    while True:
        for i in rng.permutation(len(values)):
            yield values[i]


def build_entry(traffic: dict, rows, n_items: int, devices, config: dict):
    """The mix's entry, built (and prepared, where it prepares) on ``devices``."""
    module = importlib.import_module(f"fimbench.entries.{traffic['entry']}")
    return module.build(rows, n_items, devices, config, traffic)


def loop_of(traffic: dict):
    """The mix's loop's ``drive``."""
    return importlib.import_module(f"fimbench.loops.{traffic['loop']}").drive
