"""The control of ``correct``: the plain reference put in the program's
place with one stated guarantee broken, which has to come out as not
correct.

The configurations state no precision; their guarantee is exactness (every
itemset at or above the threshold, each with its exact support). The
control breaks it the way a sampling miner would: it mines a seeded share
of the rows at the scaled threshold and scales the supports back up. Its
answers are cached by threshold (the reference is deterministic), so a
window sends as many requests as a run does.

    python fimbench/control.py --workload kosarak.oneshot --seeds 11,12,13 --seconds 3

prints, for each seed, the numbers ``correct`` compares and their limits.
Like ``run.py``, it needs the card.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def sampled(share: float = 0.9, seed: int = 0):
    """A fault wrapper for ``harness.run_cell``: every call is answered by
    the reference over a ``share`` of the rows, supports scaled by
    1/``share`` and rounded."""
    from fimbench import reference

    def wrap(entry):
        cache: dict = {}

        def call(rows, min_sup):
            if min_sup not in cache:
                pick = np.random.default_rng(seed).random(len(rows)) < share
                part = rows[pick]
                need = reference.min_count_of(min_sup, len(rows))
                found = reference.mine(part, entry.n_items, max(1, math.floor(need * share)))
                scaled = {k: round(v / share) for k, v in found.items()}
                cache[min_sup] = {k: v for k, v in scaled.items() if v >= need}
            return SimpleNamespace(itemsets=dict(cache[min_sup]), stage_times_s={})

        return call

    return wrap


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from fimbench import harness

    if not torch.cuda.is_available():
        print("fimbench control: needs a CUDA device", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        out = harness.run_cell(args.workload, seed, args.seconds, False, fault=sampled(seed=seed))
        print(json.dumps({"workload": args.workload, "seed": seed, "control": "sampled 0.9",
                          "correct": out["correct"], "attempted": out["attempted"],
                          "checks": out["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
