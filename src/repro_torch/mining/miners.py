"""The registered miners: the paper's N-list miners behind one front door.

Host baselines (prepost, prepost+, the brute-force oracle) are thin
adapters over ``repro_torch.core``; ``hprepost`` wraps ``HPrepostMiner`` on
a torch device.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.core import patterns as pat
from repro_torch.device import resolve_device
from repro_torch.mining.registry import register_miner
from repro_torch.mining.result import MineResult
from repro_torch.mining.spec import MineSpec


def _select_patterns(itemsets: dict, spec: MineSpec) -> dict:
    if spec.patterns == "closed":
        return pat.closed_itemsets(itemsets)
    if spec.patterns == "maximal":
        return pat.maximal_itemsets(itemsets)
    if spec.patterns == "top_rank_k":
        return pat.top_rank_k(itemsets, spec.rank_k)
    return itemsets


class _MinerBase:
    """Shared mine() path: resolve threshold, time the backend, apply the
    pattern post-pass, assemble the enriched MineResult."""

    name = "?"
    exhaustive = True

    def __init__(self, device=None):
        # accepted uniformly so every registered miner is built the same
        # way; host miners run on numpy and ignore it
        del device

    def _run(self, rows, n_items, min_count, spec):
        """-> (itemsets, total_count, n_explicit, peak_bytes, stages, flist)."""
        raise NotImplementedError

    def _check_patterns(self, spec: MineSpec):
        if spec.patterns != "all" and not self.exhaustive:
            raise ValueError(
                f"patterns={spec.patterns!r} needs the full frequent collection; "
                f"miner {self.name!r} materializes an implicit (CPE-pruned) subset"
            )

    def _finish(
        self, itemsets, total, n_explicit, peak, stages, flist,
        *, spec, min_count, n_rows, t0,
    ) -> MineResult:
        stages = dict(stages) if stages else {"mine": time.perf_counter() - t0}
        if spec.patterns != "all":
            tp = time.perf_counter()
            itemsets = _select_patterns(itemsets, spec)
            stages["patterns"] = time.perf_counter() - tp
        return MineResult(
            algorithm=self.name,
            itemsets=itemsets,
            total_count=total,
            n_explicit=n_explicit,
            min_count=min_count,
            n_rows=n_rows,
            peak_bytes=int(peak),
            wall_time_s=time.perf_counter() - t0,
            stage_times_s=dict(stages),
            flist_items=flist,
        )

    def mine(self, rows, n_items: int, spec: MineSpec) -> MineResult:
        rows = np.asarray(rows)
        min_count = spec.resolve(len(rows))
        self._check_patterns(spec)
        t0 = time.perf_counter()
        itemsets, total, n_explicit, peak, stages, flist = self._run(
            rows, n_items, min_count, spec
        )
        return self._finish(
            itemsets, total, n_explicit, peak, stages, flist,
            spec=spec, min_count=min_count, n_rows=len(rows), t0=t0,
        )


@register_miner("prepost")
class PrepostFrontend(_MinerBase):
    """Single-shard PrePost (the paper's §3.3 baseline)."""

    _cpe = False
    exhaustive = True

    def _run(self, rows, n_items, min_count, spec):
        from repro_torch.core.prepost import mine_prepost

        res = mine_prepost(
            rows, n_items, min_count,
            cpe=self._cpe, max_k=spec.max_k, max_itemsets=spec.max_itemsets,
        )
        return (res.itemsets, res.total_count, res.n_explicit, res.peak_bytes,
                {}, res.flist_items)


@register_miner("prepost+")
class PrepostPlusFrontend(PrepostFrontend):
    """PrePost+ with Children-Parent-Equivalence pruning: exact
    ``total_count``, explicit ``itemsets`` are a pruned subset."""

    _cpe = True
    exhaustive = False


@register_miner("bruteforce")
class BruteForceFrontend(_MinerBase):
    """Transaction-scan oracle — small DBs only; anchors the parity tests."""

    def _run(self, rows, n_items, min_count, spec):
        from repro_torch.core.oracle import mine_bruteforce

        out = mine_bruteforce(rows, n_items, min_count, max_k=spec.max_k)
        return out, len(out), len(out), rows.nbytes, {}, None


@register_miner("hprepost")
class HPrepostFrontend(_MinerBase):
    """The paper's contribution on one torch device (CUDA by default; raises
    when none is present unless ``device="cpu"`` is passed)."""

    exhaustive = True

    def __init__(self, device=None):
        self.device = resolve_device(device)

    def _device_config(self, spec: MineSpec):
        from repro_torch.core.hprepost import HPrepostConfig

        # max_k deliberately left at its default: it is a per-call
        # knob (passed to mine()), not part of the miner's config.
        return HPrepostConfig(
            nlist_width=spec.nlist_width,
            candidate_unit=spec.candidate_unit,
            la_block=spec.la_block,
            backend=spec.backend,
            max_f1=spec.max_f1,
            max_itemsets=spec.max_itemsets,
            early_stop=spec.early_stop,
            tune=spec.tune,
        )

    def _run(self, rows, n_items, min_count, spec):
        from repro_torch.core.hprepost import HPrepostMiner

        miner = HPrepostMiner(self.device, config=self._device_config(spec))
        res = miner.mine(rows, n_items, min_count, max_k=spec.max_k)
        return (res.itemsets, res.total_count, res.n_explicit, res.peak_bytes,
                dict(miner.last_stage_times), res.flist_items)
