"""repro_torch.mining.continuous — continuous mining over a ``SegmentedDB``.

Three exact modes layered on ``repro_torch.mining.stream``'s additive-support
segments, all driven by ``StreamSpec`` knobs and served by the same
``StreamingMiner`` / ``MiningEngine`` / ``MiningService`` surfaces:

  - **sliding windows** (``window_rows`` / ``window_batches``): append
    time expires the oldest segments via ``SegmentedDB.drop_segments``,
    the exact inverse of append — a windowed mine is bit-identical to a
    one-shot mine over exactly the retained rows;
  - **time-decayed supports** (``decay < 1``): per-segment geometric
    weights in the cross-segment reduce (float64 accumulation next to
    the exact integer path, threshold post-reduce), checked against the
    ``damped_oracle`` reference;
  - **standing queries** (``register(spec) -> StandingQuery``): every
    append/expiry re-mines incrementally — previous answer as the
    pruning seed — and delivers a ``MineDiff`` whose cumulative replay
    reconstructs the exact frequent set.
"""
from repro_torch.mining.continuous.decay import (
    damped_oracle, resolve_weighted, segment_weights, weighted_state,
)
from repro_torch.mining.continuous.standing import (
    MineDiff, StandingQuery, StandingRegistry, apply_diff, replay_diffs,
)

__all__ = [
    "MineDiff", "StandingQuery", "StandingRegistry",
    "apply_diff", "replay_diffs",
    "damped_oracle", "resolve_weighted", "segment_weights", "weighted_state",
]
