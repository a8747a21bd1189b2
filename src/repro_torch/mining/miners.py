"""The registered miners: every algorithm in the paper's comparison, one
front door.

Host baselines (prepost, prepost+, fpgrowth, apriori, the brute-force
oracle) are thin adapters over ``repro_torch.core``; ``hprepost`` wraps
``HPrepostMiner`` on a mesh of torch devices (the 1×1 mesh on one device
unless a mesh is bound) and keeps one resident instance per device config,
so repeated mines through the same frontend (or a ``MiningEngine``) reuse
it.
"""
from __future__ import annotations

import threading
import time

import numpy as np

from repro_torch.core import patterns as pat
from repro_torch.launch.mesh import make_mesh
from repro_torch.mining.registry import register_miner
from repro_torch.mining.result import MineResult
from repro_torch.mining.spec import MineSpec
from repro_torch.mining.telemetry import trace


def default_mesh(device=None):
    """The 1×1 (data, model) mesh on ``device`` (CUDA when None, raising
    when there is none), used when no mesh is bound explicitly."""
    return make_mesh((1, 1), ("data", "model"), devices=[device])


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

    def __init__(self, device=None, *, mesh=None, data_axis=None, model_axis="model"):
        # accepted uniformly so every registered miner is built the same
        # way; host miners run on numpy and ignore them
        del device, mesh, data_axis, model_axis

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
        *, spec, min_count, n_rows, t0, prep_shared=False,
    ) -> MineResult:
        """Assemble the enriched MineResult (pattern post-pass included) —
        shared by the one-shot ``mine`` and the engine's shared-prep path."""
        with trace.span("frontend.finish"):
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
                prep_shared=prep_shared,
            )

    def mine(self, rows, n_items: int, spec: MineSpec) -> MineResult:
        with trace.span("frontend.mine"):
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


@register_miner("fpgrowth")
class FPGrowthFrontend(_MinerBase):
    """Pointer FP-tree FP-growth (the paper's main comparator)."""

    def _run(self, rows, n_items, min_count, spec):
        from repro_torch.core.fpgrowth import mine_fpgrowth

        out, stats = mine_fpgrowth(
            rows, n_items, min_count, max_itemsets=spec.max_itemsets, max_k=spec.max_k
        )
        return out, len(out), len(out), stats["peak_bytes"], {}, None


@register_miner("apriori")
class AprioriFrontend(_MinerBase):
    """Vertical-bitmap Apriori (the related-work family)."""

    def _run(self, rows, n_items, min_count, spec):
        from repro_torch.core.apriori import mine_apriori

        out, stats = mine_apriori(
            rows, n_items, min_count, max_itemsets=spec.max_itemsets, max_k=spec.max_k
        )
        return out, len(out), len(out), stats["peak_bytes"], {}, None


@register_miner("bruteforce")
class BruteForceFrontend(_MinerBase):
    """Transaction-scan oracle — small DBs only; anchors the parity tests."""

    def _run(self, rows, n_items, min_count, spec):
        from repro_torch.core.oracle import mine_bruteforce

        out = mine_bruteforce(rows, n_items, min_count, max_k=spec.max_k)
        return out, len(out), len(out), rows.nbytes, {}, None


@register_miner("hprepost")
class HPrepostFrontend(_MinerBase):
    """The paper's contribution on a mesh of torch devices: ``mesh``, or the
    1×1 mesh on ``device`` (CUDA by default; raises when none is present
    unless ``device="cpu"`` is passed). ``data_axis=None`` shards rows over
    ``("pod", "data")`` when the mesh has a pod axis, else over ``data``; a
    ``model_axis`` the mesh lacks means one candidate group.

    One ``HPrepostMiner`` is kept per device-level config; specs that
    differ only in threshold / ``max_k`` / patterns reuse it, so a resident
    frontend serves repeated traffic on warm miners.
    """

    exhaustive = True

    def __init__(self, device=None, *, mesh=None, data_axis=None, model_axis="model"):
        if mesh is None:
            mesh = default_mesh(device)
        elif device is not None:
            raise ValueError("pass a device or a mesh, not both")
        self.mesh = mesh
        if data_axis is None:
            data_axis = ("pod", "data") if "pod" in mesh.shape else "data"
        self.data_axis = data_axis
        self.model_axis = model_axis if model_axis in mesh.axis_names else None
        self.device = mesh.devices.flat[0]
        self._miners: dict = {}
        # a serving layer may reach miner_for from a prep thread while the
        # caller thread serves other requests: one lock, one miner per
        # device config
        self._miners_lock = threading.Lock()
        self.miners_built = 0
        # the owning engine attaches its KernelTuner here; miners built by
        # this frontend resolve tuned plans through it (cfg.tune permitting)
        self.tuner = None

    def _device_config(self, spec: MineSpec):
        from repro_torch.core.hprepost import HPrepostConfig

        # max_k deliberately left at its default: it is a per-call
        # knob (passed to mine()), not part of the miner's config.
        return HPrepostConfig(
            nlist_width=spec.nlist_width,
            candidate_unit=spec.candidate_unit,
            la_block=spec.la_block,
            partition_candidates=spec.partition_candidates,
            backend=spec.backend,
            max_f1=spec.max_f1,
            max_itemsets=spec.max_itemsets,
            early_stop=spec.early_stop,
            tune=spec.tune,
        )

    def _prep_config(self, spec: MineSpec):
        """The config subset ``prepare`` actually depends on — what prep
        caches and snapshots key on. Execution-only knobs (``la_block``,
        backend, early_stop, tune) are normalized away: a retune or backend
        switch must keep serving warm preps."""
        return self._device_config(spec).prep_key()

    def miner_for(self, spec: MineSpec):
        from repro_torch.core.hprepost import HPrepostMiner

        cfg = self._device_config(spec)
        with self._miners_lock:
            miner = self._miners.get(cfg)
            if miner is None:
                miner = self._miners[cfg] = HPrepostMiner(
                    config=cfg, mesh=self.mesh, data_axis=self.data_axis,
                    model_axis=self.model_axis,
                )
                self.miners_built += 1
            miner.tuner = self.tuner
        return miner

    def _run(self, rows, n_items, min_count, spec):
        miner = self.miner_for(spec)
        res = miner.mine(rows, n_items, min_count, max_k=spec.max_k)
        return (res.itemsets, res.total_count, res.n_explicit, res.peak_bytes,
                dict(miner.last_stage_times), res.flist_items)

    # -------------------------------------------------- two-phase (planned)
    def prepare(self, rows, n_items: int, min_count_floor: int, spec: MineSpec,
                *, need_waves: bool = True):
        """Run the threshold-floor stages once -> ``(miner, PreparedDB)``.

        ``spec`` selects the device-level config (and so the resident
        miner); its own threshold is irrelevant here — every spec in the
        group whose threshold is at least ``min_count_floor`` can be served
        by ``mine_prepared`` from the returned PreparedDB."""
        miner = self.miner_for(spec)
        return miner, miner.prepare(
            np.asarray(rows), n_items, min_count_floor, need_waves=need_waves
        )

    def mine_prepared(self, miner, prepared, spec: MineSpec, *,
                      prep_stages=None, prep_shared: bool = False,
                      t0: float | None = None) -> MineResult:
        """Serve one spec from a shared ``PreparedDB`` (the k>2 waves only).

        ``prep_stages`` folds the real prep times into this result's
        ``stage_times_s`` — pass it on the one request that paid for prep;
        the others keep 0.0 prep keys and ``prep_shared=True``."""
        with trace.span("frontend.mine"):
            self._check_patterns(spec)
            min_count = spec.resolve(prepared.n_rows)
            if t0 is None:
                t0 = time.perf_counter()
            res = miner.mine_prepared(prepared, min_count, max_k=spec.max_k)
            stages = dict(miner.last_stage_times)
            if prep_stages:
                stages.update(prep_stages)
            return self._finish(
                res.itemsets, res.total_count, res.n_explicit, res.peak_bytes,
                stages, res.flist_items,
                spec=spec, min_count=min_count, n_rows=prepared.n_rows, t0=t0,
                prep_shared=prep_shared,
            )
